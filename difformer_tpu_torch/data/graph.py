"""The single-graph container, as ``difformer_tpu/data/graph.py:24-60``.

Edges are held as (senders, receivers) int64 tensors, stably sorted by
receiver: the reference's ``row`` and ``col``, in CSR order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from difformer_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class GraphData:
    node_feat: torch.Tensor                      # [N, F]
    senders: torch.Tensor                        # int64 [E]
    receivers: torch.Tensor                      # int64 [E]
    edge_weight: Optional[torch.Tensor] = None   # [E]
    edge_mask: Optional[torch.Tensor] = None     # bool [E], False on padding
    node_mask: Optional[torch.Tensor] = None     # bool [N], False on padding
    num_nodes: int = 0

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

    def to(self, device=None) -> "GraphData":
        """A copy with every tensor on ``device`` (the GPU when None)."""
        dev = resolve_device(device)
        moved = {f.name: getattr(self, f.name)
                 for f in dataclasses.fields(self)}
        for name, value in moved.items():
            if isinstance(value, torch.Tensor):
                moved[name] = value.to(dev)
        return GraphData(**moved)
