"""Graph containers, as ``difformer_tpu/data/graph.py:24-115``.

``GraphData`` is the single graph on the device. Its edges are held as
(senders, receivers) int64 tensors, always stably sorted by receiver: the
reference's ``row`` and ``col``, in CSR order. Unlike the JAX package's,
``from_numpy`` takes no ``sort_edges`` flag and the graph has no
``edges_sorted`` field: every graph is sorted, which is what the JAX
package's default (``sort_edges=True``) gives. :meth:`GraphData.csr_plan`
builds the graph's CSR plan for the GCN branch's kernel once and keeps it.

``TemporalSnapshot`` is one step of a temporal sequence on the host
(``difformer_tpu/data/graph.py:117-124``).

``NodeDataset`` mirrors the reference's ``NCDataset``
(``node classification/dataset.py:25-83``: ``.graph = {edge_index,
node_feat, edge_feat, num_nodes}``, ``.label``, ``get_idx_split``) and holds
numpy on the host; :meth:`NodeDataset.to_graph_data` moves it to the
device once.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from difformer_tpu_torch.ops.graph_ops import CsrPlan, build_csr_plan
from difformer_tpu_torch.utils.device import resolve_device

# the fields the CSR plan is built from: assigning one drops the kept plan
_PLAN_FIELDS = frozenset(
    ("senders", "receivers", "edge_weight", "edge_mask", "num_nodes"))


@dataclasses.dataclass
class GraphData:
    node_feat: torch.Tensor                      # [N, F]
    senders: torch.Tensor                        # int64 [E]
    receivers: torch.Tensor                      # int64 [E]
    edge_weight: Optional[torch.Tensor] = None   # [E]
    edge_mask: Optional[torch.Tensor] = None     # bool [E], False on padding
    node_mask: Optional[torch.Tensor] = None     # bool [N], False on padding
    num_nodes: int = 0
    _csr_plan: Optional[CsrPlan] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    def __setattr__(self, name, value):
        if name in _PLAN_FIELDS:
            object.__setattr__(self, "_csr_plan", None)
        object.__setattr__(self, name, value)

    @property
    def num_edges(self):
        return self.senders.shape[0]

    @property
    def device(self) -> torch.device:
        return self.node_feat.device

    @classmethod
    def from_numpy(cls, node_feat, edge_index, edge_weight=None, *,
                   device=None):
        """Build from an [2, E] edge_index (reference layout) on ``device``
        (the GPU unless told otherwise)."""
        dev = resolve_device(device)
        senders = np.asarray(edge_index[0], dtype=np.int64)
        receivers = np.asarray(edge_index[1], dtype=np.int64)
        if edge_weight is not None:
            edge_weight = np.asarray(edge_weight, dtype=np.float32)
        if senders.size:
            order = np.argsort(receivers, kind="stable")
            senders, receivers = senders[order], receivers[order]
            if edge_weight is not None:
                edge_weight = edge_weight[order]
        node_feat = np.asarray(node_feat)
        return cls(
            node_feat=torch.as_tensor(node_feat, device=dev),
            senders=torch.as_tensor(senders, device=dev),
            receivers=torch.as_tensor(receivers, device=dev),
            edge_weight=(None if edge_weight is None
                         else torch.as_tensor(edge_weight, device=dev)),
            num_nodes=int(node_feat.shape[0]),
        )

    def csr_plan(self) -> CsrPlan:
        """The CSR plan of the edges, with their GCN values (from
        ``edge_weight`` and ``edge_mask``), built at the first call on the
        graph's device and kept until one of those fields is assigned anew
        (a tensor changed in place is not seen)."""
        if self._csr_plan is None:
            self._csr_plan = build_csr_plan(
                self.senders, self.receivers, self.num_nodes,
                self.edge_weight, self.edge_mask)
        return self._csr_plan

    def to(self, device=None) -> "GraphData":
        """A copy with every tensor on ``device`` (the GPU when None); its
        CSR plan is built anew."""
        dev = resolve_device(device)
        moved = {f.name: getattr(self, f.name)
                 for f in dataclasses.fields(self) if f.init}
        for name, value in moved.items():
            if isinstance(value, torch.Tensor):
                moved[name] = value.to(dev)
        return GraphData(**moved)


class NodeDataset:
    """Host-side dataset container (the reference's ``NCDataset``).

    graph: dict with 'edge_index' int [2, E] numpy (None for a set without
    a graph), 'node_feat' [N, F] numpy, 'edge_feat' (optional), 'num_nodes'.
    label: [N] or [N, T].
    """

    def __init__(self, name: str):
        self.name = name
        self.graph: Dict[str, Any] = {
            "edge_index": None,
            "node_feat": None,
            "edge_feat": None,
            "num_nodes": 0,
        }
        self.label = None
        self._fixed_splits = None

    def __len__(self):
        return 1

    def __repr__(self):
        return (f"{self.__class__.__name__}({self.name}, "
                f"N={self.graph['num_nodes']})")

    def get_idx_split(self, split_type="random", train_prop=0.5,
                      valid_prop=0.25, label_num_per_class=20, rng=None):
        """'random': a proportional split that leaves out label -1
        (``data_utils.py:13-42``); 'class': a class-balanced split
        (``data_utils.py:75-107``); 'fixed': the splits the loader read
        (a dict, or a list of dicts)."""
        from difformer_tpu_torch.data import splits as S

        label = np.asarray(self.label)
        if split_type == "random":
            return S.rand_train_test_idx(
                label, train_prop=train_prop, valid_prop=valid_prop, rng=rng)
        if split_type == "class":
            return S.class_rand_splits(
                label, label_num_per_class=label_num_per_class, rng=rng)
        if split_type == "fixed":
            if self._fixed_splits is None:
                raise ValueError(f"{self.name} has no fixed splits loaded")
            return self._fixed_splits
        raise ValueError(split_type)

    def to_graph_data(self, device=None) -> GraphData:
        """The dataset's graph as a :class:`GraphData` on ``device`` (the
        GPU unless told otherwise), its edges sorted by receiver."""
        return GraphData.from_numpy(self.graph["node_feat"],
                                    self.graph["edge_index"], device=device)


@dataclasses.dataclass
class TemporalSnapshot:
    """One timestep of a temporal graph sequence (host numpy), as the JAX
    package's ``TemporalSnapshot``."""

    node_feat: np.ndarray       # [N, F]
    edge_index: np.ndarray      # [2, E]
    edge_weight: Optional[np.ndarray]
    target: np.ndarray          # [N]
