"""Host-side graph preprocessing (numpy), as
``difformer_tpu/data/transforms.py:20-56``: the reference's canonical prep
(``node classification/main.py:72-76``) of symmetrising, dropping self loops
and adding self loops."""

from __future__ import annotations

import numpy as np


def to_undirected(edge_index):
    """Symmetrise and dedupe: both directions of every edge, unique pairs in
    first-seen order."""
    ei = np.asarray(edge_index)
    both = np.concatenate([ei, ei[::-1]], axis=1)
    flat = both[0].astype(np.int64) * (both.max() + 1) + both[1]
    _, keep = np.unique(flat, return_index=True)
    return both[:, np.sort(keep)]


def remove_self_loops(edge_index, edge_weight=None):
    ei = np.asarray(edge_index)
    mask = ei[0] != ei[1]
    if edge_weight is not None:
        return ei[:, mask], edge_weight[mask]
    return ei[:, mask], None


def add_self_loops(edge_index, num_nodes, edge_weight=None, fill_value=1.0):
    ei = np.asarray(edge_index)
    loops = np.tile(np.arange(num_nodes, dtype=ei.dtype), (2, 1))
    out = np.concatenate([ei, loops], axis=1)
    if edge_weight is not None:
        w = np.concatenate(
            [edge_weight, np.full(num_nodes, fill_value, dtype=edge_weight.dtype)]
        )
        return out, w
    return out, None


def standard_preprocess(edge_index, num_nodes):
    """Symmetrise, drop self loops, add self loops."""
    ei = to_undirected(edge_index)
    ei, _ = remove_self_loops(ei)
    ei, _ = add_self_loops(ei, num_nodes)
    return ei
