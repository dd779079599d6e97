"""Synthetic graphs for tests and chip runs (no dataset is downloaded).

A numpy copy of ``difformer_tpu/data/synthetic.py:random_graph``: the same
seed gives the same arrays in both packages.
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
