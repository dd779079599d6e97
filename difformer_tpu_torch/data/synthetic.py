"""Synthetic graphs for tests and chip runs (no dataset is downloaded).

Numpy copies of ``difformer_tpu/data/synthetic.py``'s ``random_graph``,
``random_small_graphs`` and ``random_temporal_sequence``: the same seed
gives the same arrays in both packages.
"""

from __future__ import annotations

import numpy as np


def random_graph(num_nodes, num_edges, feat_dim, num_classes, *, seed=0,
                 homophily=0.5):
    """A random graph with label-correlated features and partially
    homophilous edges. Returns (x [N, F] f32, edge_index [2, E] int64,
    labels [N] int64)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=num_nodes)
    centers = rng.normal(size=(num_classes, feat_dim)).astype(np.float32)
    x = centers[labels] + 1.2 * rng.normal(size=(num_nodes, feat_dim)).astype(
        np.float32
    )

    src = rng.integers(0, num_nodes, size=num_edges)
    # the homophilous fraction connects within a class
    dst = rng.integers(0, num_nodes, size=num_edges)
    same = rng.random(num_edges) < homophily
    for c in np.unique(labels):
        pool = np.where(labels == c)[0]
        sel = same & (labels[src] == c)
        dst[sel] = pool[rng.integers(0, pool.shape[0], size=int(sel.sum()))]
    edge_index = np.stack([src, dst]).astype(np.int64)
    return x, edge_index, labels.astype(np.int64)


def random_small_graphs(num_graphs, node_range=(8, 24), feat_dim=8, *,
                        seed=0, k=3):
    """Small kNN graphs with a separable graph-level label (the particle
    track's stand-in): a list of (x [n, feat_dim], edge_index, label)."""
    from difformer_tpu_torch.data.transforms import knn_graph

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num_graphs):
        n = int(rng.integers(node_range[0], node_range[1] + 1))
        label = int(rng.integers(0, 2))
        spread = 0.5 if label == 0 else 1.5
        pos = rng.normal(scale=spread, size=(n, 3)).astype(np.float32)
        feat = rng.normal(size=(n, feat_dim - 3)).astype(np.float32)
        x = np.concatenate([feat, pos], axis=1)
        ei = knn_graph(pos, k=min(k, n), include_self=True)
        out.append((x, ei, np.float32(label)))
    return out


def random_temporal_sequence(num_nodes, num_steps, feat_dim, *, seed=0,
                             avg_degree=4):
    """A temporal snapshot sequence (the chickenpox stand-in): one random
    graph for every step, AR(1) node signals, and the next step's first
    feature as the target. Returns a list of ``TemporalSnapshot``."""
    from difformer_tpu_torch.data.graph import TemporalSnapshot

    rng = np.random.default_rng(seed)
    e = num_nodes * avg_degree
    ei = np.stack([
        rng.integers(0, num_nodes, size=e),
        rng.integers(0, num_nodes, size=e),
    ]).astype(np.int64)
    w = rng.random(e).astype(np.float32)
    sig = rng.normal(size=(num_nodes, feat_dim)).astype(np.float32)
    snaps = []
    for _ in range(num_steps):
        nxt = 0.9 * sig + 0.1 * rng.normal(size=sig.shape).astype(np.float32)
        snaps.append(TemporalSnapshot(node_feat=sig.copy(), edge_index=ei,
                                      edge_weight=w, target=nxt[:, 0].copy()))
        sig = nxt
    return snaps
