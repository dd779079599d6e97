"""Interop: load the reference's PyG processed caches WITHOUT torch_geometric.

A numpy copy of ``difformer_tpu/data/pyg_interop.py``: the same inputs give the
same arrays.

The particle track's datasets ship/produce ``processed/data.pt``:
``torch.save((data, slices, idx_split))`` of a collated PyG
``InMemoryDataset`` (reference ``physical particle/datasets/synmol.py:124-125``,
``plbind.py:233-235``). Rebuilding them from raw needs RDKit/BioPython (not in
this image), but *reading* them only needs torch (cpu, present): we unpickle
with stub classes standing in for every ``torch_geometric.*`` type and
de-collate with numpy. This un-gates SynMol/PLBind for anyone holding the
reference's processed artifacts — no PyG, no RDKit, no network.

Handles both collated layouts: PyG 1.x (tensors directly in ``Data.__dict__``)
and PyG 2.x (``Data._store._mapping``).
"""

from __future__ import annotations

import pickle
from typing import Dict, Tuple

import numpy as np


class _Stub:
    """Stands in for any torch_geometric class during unpickling."""

    def __init__(self, *args, **kwargs):
        pass

    def __new__(cls, *args, **kwargs):  # tolerate __newobj__ with args
        return object.__new__(cls)


_STUBS: Dict[Tuple[str, str], type] = {}


# Only globals from these packages may be resolved while unpickling a cache
# file. The artifact is untrusted third-party content: anything outside this
# list (os.system reducers, subprocess, ...) is refused instead of executed.
_SAFE_TOPLEVEL = ("torch", "numpy", "collections")
_SAFE_BUILTINS = frozenset(
    {"set", "frozenset", "list", "dict", "tuple", "bytearray",
     "complex", "range", "slice", "object"}
)


class _StubUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        top = module.split(".", 1)[0]
        if top == "torch_geometric":
            key = (module, name)
            if key not in _STUBS:
                _STUBS[key] = type(name, (_Stub,), {"__module__": module})
            return _STUBS[key]
        if top in _SAFE_TOPLEVEL or (
            module == "builtins" and name in _SAFE_BUILTINS
        ):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"refusing to unpickle global {module}.{name} from an untrusted "
            f"PyG cache (allowed: torch_geometric stubs, {_SAFE_TOPLEVEL}, "
            f"safe builtins)"
        )


class _PickleModule:
    """Duck-typed ``pickle`` module for ``torch.load(pickle_module=...)``."""

    Unpickler = _StubUnpickler
    UnpicklingError = pickle.UnpicklingError

    @staticmethod
    def load(f, **kwargs):
        return _StubUnpickler(f).load()

    @staticmethod
    def loads(data, **kwargs):
        import io

        return _StubUnpickler(io.BytesIO(data)).load()


def _mapping(obj) -> dict:
    """Attribute dict of a (stub-unpickled) Data/BaseStorage object."""
    if isinstance(obj, dict):
        return obj
    d = dict(getattr(obj, "__dict__", {}) or {})
    if "_store" in d:  # PyG 2.x Data
        store = d["_store"]
        sd = getattr(store, "__dict__", {}) or {}
        return dict(sd.get("_mapping", sd))
    return d


def _to_numpy(v):
    import torch

    if torch.is_tensor(v):
        return v.cpu().numpy()
    return v


def load_pyg_processed(path):
    """Load a collated ``(data, slices, idx_split)`` PyG cache.

    Returns ``(attrs, slices, idx_split)`` as numpy: ``attrs[key]`` is the
    concatenated tensor over all graphs, ``slices[key]`` the [n_graphs+1]
    boundary vector, ``idx_split`` the split-name -> graph-indices dict.
    """
    import torch

    loaded = torch.load(path, map_location="cpu",
                        pickle_module=_PickleModule, weights_only=False)
    data, slices, idx_split = loaded
    attrs = {
        k: _to_numpy(v)
        for k, v in _mapping(data).items()
        if not k.startswith("_") and v is not None
    }
    slices = {k: np.asarray(_to_numpy(v)) for k, v in _mapping(slices).items()}
    idx_split = {
        k: np.asarray(v, dtype=np.int64) for k, v in dict(idx_split).items()
    }
    return attrs, slices, idx_split


def decollate(attrs: dict, slices: dict, i: int, node_key: str = "x") -> dict:
    """Extract graph ``i`` from a collated store. ``edge_index`` is sliced on
    its last dim and de-offset by the graph's node start (PyG collate adds
    cumulative node counts — ``Data.__inc__``)."""
    out = {}
    node_off = int(slices[node_key][i])
    for k, bounds in slices.items():
        if k not in attrs:
            continue
        v = attrs[k]
        s, e = int(bounds[i]), int(bounds[i + 1])
        if k == "edge_index":
            out[k] = np.asarray(v)[:, s:e] - node_off
        elif np.ndim(v) == 0:
            out[k] = v
        else:
            out[k] = np.asarray(v)[s:e]
    return out


def graph_list_from_pyg(name: str, path: str, *, x_dtype=np.float32):
    """Build a :class:`~difformer_tpu_torch.data.particle.GraphListDataset` from a
    reference-processed PyG cache (synmol/plbind layout: per-graph ``x``,
    ``edge_index``, scalar ``y``; extra per-node/per-graph keys land in
    ``extras``)."""
    from difformer_tpu_torch.data.particle import GraphListDataset

    attrs, slices, idx_split = load_pyg_processed(path)
    n_graphs = len(slices["x"]) - 1
    ds = GraphListDataset(name)
    core = ("x", "edge_index", "y")
    for i in range(n_graphs):
        g = decollate(attrs, slices, i)
        x = np.asarray(g["x"], dtype=x_dtype)
        ei = np.asarray(g["edge_index"], dtype=np.int64)
        y = float(np.asarray(g["y"]).reshape(-1)[0])
        ds.graphs.append((x, ei, y))
        ds.extras.append({
            k: np.asarray(v) for k, v in g.items() if k not in core
        })
    ds.idx_split = {k: v for k, v in idx_split.items()}
    return ds
