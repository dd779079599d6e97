"""Batching for graph-level tasks (the DIFFormer-v2 path), a numpy copy of
``difformer_tpu/data/batching.py`` that gives the same arrays.

The reference uses PyG's block-diagonal ``Batch`` plus per-layer pad and
scatter round trips (``physical particle/difformer-v2.py:8-28``). Here a
batch is padded once on the host into a dense ``[B, M, F]`` layout with a
node mask, and the block-diagonal edge list is renumbered into the padded
flat space ``b*M + slot`` and padded to a fixed edge count, so that every
batch of a run has the same shapes (one CUDA graph serves them all).

Three plans for the GCN branch over a batch, which the graph-level trainer
tries in this order (``train/graph_level.py``): :func:`dense_adj`, the
per-graph normalised adjacency [B, M, M] (a batched matmul);
:func:`regular_knn_table`, a gather table for batches where every real
node has the same in-degree k (kNN graphs); and the edge list itself.
The arrays stay numpy here; the trainer copies them to the device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class PaddedGraphBatch:
    """B graphs padded to M nodes each (numpy arrays)."""

    node_feat: Any              # [B, M, F]
    node_mask: Any              # bool [B, M]
    n_nodes: Any                # int32 [B] (0 for padding graphs)
    senders: Any                # int32 [E_pad] in padded-flat coords
    receivers: Any              # int32 [E_pad]
    edge_mask: Any              # bool [E_pad]
    edge_weight: Optional[Any] = None
    labels: Optional[Any] = None        # [B] or [B, T]
    graph_mask: Optional[Any] = None    # bool [B]: False for padding graphs
    dense_adj: Optional[Any] = None     # [B, M, M] block-dense plan, or None
    # True when the receivers never decrease (kNN and radius builders give
    # centre-major edges; padding edges point at the last padded node)
    edges_sorted: bool = False

    @property
    def batch_size(self):
        return self.node_feat.shape[0]

    @property
    def max_nodes(self):
        return self.node_feat.shape[1]


def pad_graph_batch(
    node_feats: Sequence[np.ndarray],
    edge_indices: Sequence[np.ndarray],
    labels: Optional[Sequence[Any]] = None,
    *,
    max_nodes: Optional[int] = None,
    max_edges: Optional[int] = None,
    batch_size: Optional[int] = None,
    edge_weights: Optional[Sequence[np.ndarray]] = None,
) -> PaddedGraphBatch:
    """Assemble host graphs into a :class:`PaddedGraphBatch`.

    ``max_nodes``/``max_edges``/``batch_size`` fix the shapes across
    batches; they default to the batch's own maxima."""
    b_real = len(node_feats)
    B = batch_size or b_real
    M = max_nodes or max(int(f.shape[0]) for f in node_feats)
    total_e = sum(int(e.shape[1]) for e in edge_indices)
    E = max_edges or max(total_e, 1)
    F = int(node_feats[0].shape[1])

    x = np.zeros((B, M, F), dtype=np.float32)
    node_mask = np.zeros((B, M), dtype=bool)
    n_nodes = np.zeros((B,), dtype=np.int32)
    graph_mask = np.zeros((B,), dtype=bool)
    # padding edges point at the LAST padded node (masked out anyway): with
    # centre-major edge builders this keeps the receivers sorted
    senders = np.full((E,), B * M - 1, dtype=np.int32)
    receivers = np.full((E,), B * M - 1, dtype=np.int32)
    edge_mask = np.zeros((E,), dtype=bool)
    ew = None
    if edge_weights is not None:
        ew = np.zeros((E,), dtype=np.float32)

    e_off = 0
    for b in range(b_real):
        n = int(node_feats[b].shape[0])
        if n > M:
            raise ValueError(f"graph {b} has {n} nodes > max_nodes {M}")
        x[b, :n] = node_feats[b]
        node_mask[b, :n] = True
        n_nodes[b] = n
        graph_mask[b] = True
        ei = np.asarray(edge_indices[b])
        e = ei.shape[1]
        if e_off + e > E:
            raise ValueError(f"edge total exceeds max_edges {E}")
        senders[e_off:e_off + e] = ei[0] + b * M
        receivers[e_off:e_off + e] = ei[1] + b * M
        edge_mask[e_off:e_off + e] = True
        if ew is not None:
            ew[e_off:e_off + e] = edge_weights[b]
        e_off += e

    lab = None
    if labels is not None:
        lab = np.asarray(labels, dtype=np.float32)
        if lab.shape[0] < B:
            pad_shape = (B - lab.shape[0],) + lab.shape[1:]
            lab = np.concatenate([lab, np.zeros(pad_shape, lab.dtype)], axis=0)

    return PaddedGraphBatch(
        node_feat=x,
        node_mask=node_mask,
        n_nodes=n_nodes,
        senders=senders,
        receivers=receivers,
        edge_mask=edge_mask,
        edge_weight=ew,
        labels=lab,
        graph_mask=graph_mask,
        edges_sorted=bool(
            np.all(np.diff(receivers.astype(np.int64)) >= 0)),
    )


def batch_iterator(dataset: List, indices, batch_size, *, max_nodes, max_edges,
                   shuffle=False, rng=None, drop_last=False):
    """Yield :class:`PaddedGraphBatch` over ``dataset[i] = (x, edge_index,
    label)``, in the order of ``indices`` (permuted by ``rng`` when
    ``shuffle``)."""
    idx = np.asarray(indices)
    if shuffle:
        rng = rng or np.random.default_rng()
        idx = idx[rng.permutation(idx.shape[0])]
    for start in range(0, idx.shape[0], batch_size):
        sel = idx[start:start + batch_size]
        if drop_last and sel.shape[0] < batch_size:
            return
        graphs = [dataset[i] for i in sel]
        yield pad_graph_batch(
            [g[0] for g in graphs],
            [g[1] for g in graphs],
            [g[2] for g in graphs],
            max_nodes=max_nodes,
            max_edges=max_edges,
            batch_size=batch_size,
        )


def prefetch(iterator, depth: int = 2):
    """Run ``iterator`` in a background thread, keeping up to ``depth``
    items ready in a bounded queue, so that the host's batch assembly
    overlaps the device's steps (the reference's multi-worker PyG
    DataLoader, ``physical particle/utils/get_data_loaders.py:33-38``). An
    exception in the producer is raised again where the items are taken."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()

    def producer():
        try:
            for item in iterator:
                q.put(item)
            q.put(_END)
        except BaseException as e:  # raised again on the consumer side
            q.put(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def regular_knn_table(batch: PaddedGraphBatch, *, max_k: int = 64,
                      max_k_rev: int = 256, k_rev_pad: int = 0):
    """The gather-table plan of a batch where every real node has exactly k
    in-edges (``knn_graph(pos, k, include_self=True)``, the actstrack and
    synmol builders) and the receivers are sorted.

    ``idx[r, j]`` is the j-th sender of padded-flat node r (r itself on
    padding rows) and ``w[r, j]`` its symmetric GCN norm times any edge
    weight (0 on padding), so the conv is ``(x[idx] * w).sum(1)``. The
    transposed table ``ridx[s, j]``/``rw`` (the j-th receiver fed by
    sender s), padded to ``k_rev_pad`` (a dataset-wide width) or else to a
    multiple of 8, gives the backward as a gather too
    (``ops/graph_ops.py:knn_table_conv``).

    Returns ``(idx [B*M, k] int32, w [B*M, k] f32, ridx [B*M, k_rev],
    rw [B*M, k_rev])``, with ``ridx``/``rw`` None when the largest
    out-degree exceeds ``max_k_rev`` or ``k_rev_pad``; or None when the
    batch is not k-in-regular (the edge list is then the plan)."""
    em = np.asarray(batch.edge_mask)
    recv = np.asarray(batch.receivers)[em]
    send = np.asarray(batch.senders)[em]
    B, M = batch.node_feat.shape[:2]
    n_pad = B * M
    if recv.size == 0:
        return None
    deg = np.bincount(recv, minlength=n_pad)
    real = np.asarray(batch.node_mask).reshape(-1)
    k = int(deg[real].max(initial=0))
    if k == 0 or k > max_k:
        return None
    if not (np.all(deg[real] == k) and np.all(deg[~real] == 0)):
        return None
    if np.any(np.diff(recv) < 0):
        return None
    idx = np.arange(n_pad, dtype=np.int32)[:, None].repeat(k, 1)
    w = np.zeros((n_pad, k), np.float32)
    idx[real] = send.reshape(-1, k)
    inv_sqrt = np.zeros(n_pad, np.float32)
    inv_sqrt[deg > 0] = 1.0 / np.sqrt(deg[deg > 0])
    wvals = inv_sqrt[send] * inv_sqrt[recv]
    if batch.edge_weight is not None:
        wvals = wvals * np.asarray(batch.edge_weight)[em].astype(np.float32)
    w[real] = wvals.reshape(-1, k)

    odeg = np.bincount(send, minlength=n_pad)
    k_rev = int(odeg.max(initial=0))
    if k_rev == 0 or k_rev > max_k_rev:
        return idx, w, None, None
    if k_rev_pad:
        if k_rev > k_rev_pad:
            return idx, w, None, None
        k_rev = k_rev_pad
    else:
        k_rev = -(-k_rev // 8) * 8
    order = np.argsort(send, kind="stable")
    rs, rr = send[order], recv[order]
    # slot of each edge within its sender group (senders sorted)
    slot = np.arange(rs.size) - np.searchsorted(rs, rs)
    ridx = np.arange(n_pad, dtype=np.int32)[:, None].repeat(k_rev, 1)
    rw = np.zeros((n_pad, k_rev), np.float32)
    ridx[rs, slot] = rr
    rw[rs, slot] = wvals[order]
    return idx, w, ridx, rw


#: The JAX package's limits of the dense plan, set on a TPU
#: (``difformer_tpu/data/batching.py:263-264``): at most this many nodes a
#: graph, and B·M² entries of at most this many bytes.
DENSE_MAX_M = 512
DENSE_BUDGET_BYTES = 2 * 2 ** 30


def dense_fits(batch_size, max_nodes, *, max_m=DENSE_MAX_M,
               budget_bytes=DENSE_BUDGET_BYTES, dtype=np.float32):
    """Whether :func:`dense_adj` gives a plan for batches of this shape
    (the rule depends on the shape alone)."""
    return (max_nodes <= max_m and batch_size * max_nodes * max_nodes
            * np.dtype(dtype).itemsize <= budget_bytes)


def dense_adj(batch: PaddedGraphBatch, *, max_m: int = DENSE_MAX_M,
              budget_bytes: int = DENSE_BUDGET_BYTES, dtype=np.float32,
              out=None):
    """The per-graph dense normalised adjacency ``A [B, M, M]``:
    ``A[b, r, s]`` is the symmetric GCN norm times the edge weight of edge
    s→r (``gcn_conv``'s values: in-degree over real receivers, duplicate
    edges summed); rows and columns of padded slots are zero. The conv is
    then ``A[b] @ v[b]`` and its backward ``A[b]ᵀ @ dg[b]``.

    Returns None when the plan does not fit (:func:`dense_fits`): ``M >
    max_m`` or ``B·M²·itemsize > budget_bytes``. Both limits are the JAX
    package's, set on a TPU. ``out``, an array of the result's shape and dtype, is
    filled and returned instead of a new array."""
    B, M = batch.node_feat.shape[:2]
    if not dense_fits(B, M, max_m=max_m, budget_bytes=budget_bytes,
                      dtype=dtype):
        return None
    em = np.asarray(batch.edge_mask)
    send = np.asarray(batch.senders)[em]
    recv = np.asarray(batch.receivers)[em]
    n_pad = B * M
    deg = np.bincount(recv, minlength=n_pad)
    inv_sqrt = np.zeros(n_pad, np.float32)
    inv_sqrt[deg > 0] = 1.0 / np.sqrt(deg[deg > 0])
    wvals = inv_sqrt[send] * inv_sqrt[recv]
    if batch.edge_weight is not None:
        wvals = wvals * np.asarray(batch.edge_weight)[em].astype(np.float32)
    if out is not None and out.dtype == np.float32:
        A = out
        A.fill(0.0)
    else:
        A = np.zeros((B, M, M), np.float32)
    # edges never cross graphs (pad_graph_batch offsets each graph by b*M)
    np.add.at(A, (recv // M, recv % M, send % M), wvals)
    if out is None:
        return A.astype(dtype)
    if A is not out:
        out[...] = A
    return out
