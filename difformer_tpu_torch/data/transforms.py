"""Host-side graph preprocessing (numpy), copies of
``difformer_tpu/data/transforms.py`` that give the same arrays:

- the reference's canonical prep (``node classification/main.py:72-76``):
  symmetrise, drop self loops, add self loops;
- CSR order, induced subgraphs and the edge capacities of the
  mini-batch trainer (``sort_edges_by_receiver``, ``subgraph``,
  ``pad_edges``, ``edge_bucket``; the trainer calls the last two, and
  takes its CSR order and induced subgraphs from ``native/``, which gives
  the same arrays in one pass over the edges);
- row feature normalisation (``data_utils.py:229-236``);
- the dense adjacency and the boolean product of two adjacencies
  (``convert_to_adj``, ``adj_mul``; ``data_utils.py:287-299``), utilities
  that no model of either package calls;
- the kNN graph of the set track (``image and text/main.py:51-54``) and
  the radius graph of the particle track (``physical particle/datasets/
  tau3mu.py:95``);
- node reorderings for gather locality (``locality_reorder``,
  ``permute_graph``), with the numpy label propagation behind the
  ``community`` order.

``label_propagation`` dispatches as the JAX function does: to the C++
version of the port's native library (``native/``, bit-equal to the JAX
package's C++ one) where it is loaded, else, or with ``use_native=False``,
to the numpy version, which gives other communities (a random tie
priority instead of a hash).
"""

from __future__ import annotations

import collections

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


def sort_edges_by_receiver(edge_index, edge_weight=None):
    """The edges in CSR order: stably sorted by receiver."""
    ei = np.asarray(edge_index)
    order = np.argsort(ei[1], kind="stable")
    ei = ei[:, order]
    if edge_weight is not None:
        return ei, edge_weight[order]
    return ei, None


def subgraph(node_idx, edge_index, num_nodes, relabel_nodes=True):
    """The subgraph induced by ``node_idx`` (PyG ``subgraph``): the edges
    whose two ends are both in it, in their order, relabelled to positions
    in ``node_idx`` when asked; returns (edges, edge mask). The mini-batch
    trainer's chunks drop cross-chunk edges so (``main-batch.py:131``)."""
    node_idx = np.asarray(node_idx)
    mask = np.zeros(num_nodes, dtype=bool)
    mask[node_idx] = True
    ei = np.asarray(edge_index)
    emask = mask[ei[0]] & mask[ei[1]]
    sub = ei[:, emask]
    if relabel_nodes:
        remap = -np.ones(num_nodes, dtype=np.int64)
        remap[node_idx] = np.arange(node_idx.shape[0])
        sub = remap[sub]
    return sub, emask


def pad_edges(edge_index, edge_weight, target_e, *, pad_index=0):
    """Pad an edge list to ``target_e`` edges; returns (edges, weights,
    mask). Padded edges point at ``pad_index`` and have mask False; more
    than ``target_e`` edges raise."""
    ei = np.asarray(edge_index)
    e = ei.shape[1]
    if e > target_e:
        raise ValueError(f"edge count {e} exceeds bucket {target_e}")
    mask = np.zeros(target_e, dtype=bool)
    mask[:e] = True
    out = np.full((2, target_e), pad_index, dtype=ei.dtype)
    out[:, :e] = ei
    w = None
    if edge_weight is not None:
        w = np.zeros(target_e, dtype=np.float32)
        w[:e] = edge_weight
    return out, w, mask


def edge_bucket(e, buckets=None, *, growth=1.3, minimum=128):
    """The static capacity for ``e`` edges: the first of ``buckets`` that
    holds them, else the first of the geometric ladder ``minimum``,
    ⌈·growth⌉ (in multiples of ``minimum``), ... that does."""
    if buckets is not None:
        for b in buckets:
            if e <= b:
                return b
        raise ValueError(f"{e} edges exceed largest bucket {buckets[-1]}")
    b = minimum
    while b < e:
        b = int(np.ceil(b * growth / minimum) * minimum)
    return b


def convert_to_adj(edge_index, n_node):
    """Dense float32 adjacency [n_node, n_node] with 1 at (src, dst) of
    every edge (``data_utils.py:287-292``)."""
    adj = np.zeros((n_node, n_node), np.float32)
    ei = np.asarray(edge_index)
    adj[ei[0], ei[1]] = 1.0
    return adj


def adj_mul(adj_i, adj, n):
    """The edge_index (int64 [2, E]) of the nonzeros of A_i @ A, for two
    edge lists over ``n`` nodes (``data_utils.py:294-299``: multi-hop
    adjacencies), through scipy's CSR product as the JAX function does."""
    import scipy.sparse as sp

    ai = sp.coo_matrix(
        (np.ones(adj_i.shape[1]), (adj_i[0], adj_i[1])), shape=(n, n)
    ).tocsr()
    a = sp.coo_matrix(
        (np.ones(adj.shape[1]), (adj[0], adj[1])), shape=(n, n)
    ).tocsr()
    prod = (ai @ a).tocoo()
    return np.stack([prod.row, prod.col]).astype(np.int64)


def normalize_feat(feat):
    """Row-normalise features (``data_utils.py:229-236``)."""
    feat = np.asarray(feat, dtype=np.float32)
    rowsum = feat.sum(axis=1, keepdims=True)
    rowsum[rowsum == 0] = 1.0
    return feat / rowsum


def knn_graph(features, k, *, include_self=True, loop=False,
              metric="euclidean"):
    """kNN graph of feature rows (numpy, blocked O(N·B) memory).

    The set track's sklearn ``kneighbors_graph(..., include_self=True)``
    (``image and text/main.py:51-54``). Returns edge_index [2, N·k] with
    edges src = neighbour -> dst = node. ``include_self``: the node itself
    counts as one of its k neighbours; ``loop`` is the same (PyG's name).
    """
    x = np.asarray(features, dtype=np.float32)
    n = x.shape[0]
    include_self = include_self or loop
    kk = min(k, n)
    block = max(1, min(n, int(2**22 // max(n, 1)) or 1))
    nbrs = np.empty((n, kk), dtype=np.int64)
    sq = (x * x).sum(axis=1)
    for start in range(0, n, block):
        stop = min(n, start + block)
        if metric == "euclidean":
            d = sq[start:stop, None] - 2.0 * (x[start:stop] @ x.T) + sq[None, :]
        elif metric == "cosine":
            xn = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
            d = 1.0 - xn[start:stop] @ xn.T
        else:
            raise ValueError(metric)
        if not include_self:
            rows = np.arange(start, stop)
            d[np.arange(stop - start), rows] = np.inf
        part = np.argpartition(d, kk - 1, axis=1)[:, :kk]
        # the k selected, sorted by distance
        order = np.argsort(np.take_along_axis(d, part, axis=1), axis=1)
        nbrs[start:stop] = np.take_along_axis(part, order, axis=1)
    dst = np.repeat(np.arange(n, dtype=np.int64), kk)
    src = nbrs.reshape(-1)
    return np.stack([src, dst], axis=0)


def radius_graph(pos, r, *, loop=True, max_num_neighbors=None):
    """All pairs within radius ``r`` (PyG ``radius_graph``, ``physical
    particle/datasets/tau3mu.py:95``): [2, E] with the neighbours as senders
    and the centres, in increasing order, as receivers; ``loop`` keeps each
    node's self pair; ``max_num_neighbors`` keeps a centre's nearest."""
    x = np.asarray(pos, dtype=np.float32)
    n = x.shape[0]
    sq = (x * x).sum(axis=1)
    d2 = sq[:, None] - 2.0 * (x @ x.T) + sq[None, :]
    mask = d2 <= r * r
    if not loop:
        np.fill_diagonal(mask, False)
    dst, src = np.where(mask)  # row = center, col = neighbor
    if max_num_neighbors is not None:
        keep = []
        for i in range(n):
            sel = np.where(dst == i)[0]
            if sel.shape[0] > max_num_neighbors:
                order = np.argsort(d2[i, src[sel]])[:max_num_neighbors]
                sel = sel[order]
            keep.append(sel)
        keep = np.concatenate(keep)
        src, dst = src[keep], dst[keep]
    return np.stack([src, dst], axis=0)


def locality_reorder(edge_index, num_nodes, method="rcm"):
    """A node permutation that puts connected nodes at nearby ids, so that
    the GCN branch's gathers of neighbour rows hit nearby memory.

    method='rcm'    reverse Cuthill-McKee over the symmetrised adjacency
                    (scipy.sparse.csgraph);
    method='bfs'    BFS order from the largest-degree node;
    method='degree' by total degree, largest first;
    method='community'
                    nodes grouped by label-propagation community, the
                    communities chained by the edges between them.

    Returns ``perm`` with ``new_id = perm[old_id]``; apply it with
    :func:`permute_graph`.
    """
    ei = np.asarray(edge_index)
    if method == "rcm":
        import scipy.sparse as sp
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        a = sp.coo_matrix(
            (np.ones(ei.shape[1], np.float32), (ei[0], ei[1])),
            shape=(num_nodes, num_nodes),
        ).tocsr()
        a = a + a.T
        order = np.asarray(reverse_cuthill_mckee(a, symmetric_mode=True))
    elif method == "bfs":
        deg = np.bincount(ei[0], minlength=num_nodes)
        adj_r, adj_c = ei[0], ei[1]
        srt = np.argsort(adj_r, kind="stable")
        adj_r, adj_c = adj_r[srt], adj_c[srt]
        starts = np.searchsorted(adj_r, np.arange(num_nodes + 1))
        seen = np.zeros(num_nodes, bool)
        order = np.empty(num_nodes, np.int64)
        pos = 0
        for root in np.argsort(-deg):
            if seen[root]:
                continue
            seen[root] = True
            order[pos] = root
            pos += 1
            head = pos - 1
            while head < pos:
                u = order[head]
                head += 1
                nbrs = adj_c[starts[u]:starts[u + 1]]
                new = nbrs[~seen[nbrs]]
                if new.size:
                    new = np.unique(new)
                    seen[new] = True
                    order[pos:pos + new.size] = new
                    pos += new.size
        order = order[:pos]
        rest = np.flatnonzero(~seen)
        order = np.concatenate([order, rest])
    elif method == "degree":
        # total (in + out) degree, so hubs cluster in both SpMM directions
        deg = (np.bincount(ei[0], minlength=num_nodes)
               + np.bincount(ei[1], minlength=num_nodes))
        order = np.argsort(-deg, kind="stable")
    elif method == "community":
        labels = label_propagation(ei, num_nodes)
        order = _community_chain_order(ei, labels, num_nodes)
    else:
        raise ValueError(f"unknown reorder method {method!r}")
    perm = np.empty(num_nodes, np.int64)
    perm[order] = np.arange(num_nodes)
    return perm


def label_propagation(edge_index, num_nodes, iters=10, seed=0,
                      use_native=None):
    """Communities by synchronous label propagation: each pass gives every
    node the most frequent label among its (symmetrised) neighbours, ties
    broken by a fixed priority per label. Returns int64 labels
    [num_nodes], relabelled compactly.

    As the JAX function: the C++ version (``native.label_propagation``, a
    hash for the priority) where the native library is loaded, else the
    numpy version (an O(E log E) lexsort a pass, a priority drawn from
    ``seed``); ``use_native=True`` raises without the library,
    ``use_native=False`` takes the numpy version."""
    ei = np.asarray(edge_index)
    if use_native is not False:
        from difformer_tpu_torch import native

        if use_native or native.available():
            return native.label_propagation(ei[0], ei[1], num_nodes,
                                            iters=iters)
    # symmetrise, so that direction does not bias the propagation
    src = np.concatenate([ei[0], ei[1]])
    dst = np.concatenate([ei[1], ei[0]])
    keep = src != dst
    src, dst = src[keep], dst[keep]
    if src.size == 0:  # no edges but self loops: every node on its own
        return np.arange(num_nodes, dtype=np.int64)
    labels = np.arange(num_nodes, dtype=np.int64)
    rng = np.random.default_rng(seed)
    # a small random priority, so that symmetric ties do not oscillate
    prio = rng.random(num_nodes)
    for _ in range(iters):
        lab_src = labels[src]
        order = np.lexsort((lab_src, dst))
        d, lab = dst[order], lab_src[order]
        # run-length encode the (dst, label) pairs
        new_run = np.empty(d.shape[0], bool)
        new_run[0] = True
        new_run[1:] = (d[1:] != d[:-1]) | (lab[1:] != lab[:-1])
        starts = np.flatnonzero(new_run)
        counts = np.diff(np.append(starts, d.shape[0]))
        run_dst, run_lab = d[starts], lab[starts]
        # per dst, the label of most count (ties by the label's priority)
        score = counts.astype(np.float64) + prio[run_lab] * 0.5
        best = np.zeros(num_nodes, np.float64)
        np.maximum.at(best, run_dst, score)
        is_best = score >= best[run_dst]
        new_labels = labels.copy()
        # later writes win; within a dst the runs are label-sorted
        new_labels[run_dst[is_best]] = run_lab[is_best]
        if np.array_equal(new_labels, labels):
            break
        labels = new_labels
    _, compact = np.unique(labels, return_inverse=True)
    return compact


def _community_chain_order(edge_index, labels, num_nodes):
    """Nodes in community blocks, the communities chained greedily by the
    edges between them (each next block the one most connected to the one
    placed before it)."""
    ei = np.asarray(edge_index)
    c = int(labels.max()) + 1 if num_nodes else 0
    a, b = labels[ei[0]], labels[ei[1]]
    off = a != b
    pair = np.minimum(a[off], b[off]) * c + np.maximum(a[off], b[off])
    uniq, w = np.unique(pair, return_counts=True)
    nbrs = collections.defaultdict(list)
    for p, ww in zip(uniq, w):
        i, j = int(p // c), int(p % c)
        nbrs[i].append((j, int(ww)))
        nbrs[j].append((i, int(ww)))
    sizes = np.bincount(labels, minlength=c)
    placed = np.zeros(c, bool)
    chain = []
    cur = int(np.argmax(sizes))
    while True:
        placed[cur] = True
        chain.append(cur)
        cand = [(ww, j) for j, ww in nbrs[cur] if not placed[j]]
        if cand:
            cur = max(cand)[1]
        else:
            rest = np.flatnonzero(~placed)
            if rest.size == 0:
                break
            cur = int(rest[np.argmax(sizes[rest])])
    rank = np.empty(c, np.int64)
    rank[chain] = np.arange(c)
    return np.argsort(rank[labels], kind="stable")


def permute_graph(perm, edge_index, *arrays):
    """Apply a node permutation: relabel the edges and reorder node-indexed
    arrays (features, labels, masks). Returns ``(edge_index, *arrays)``."""
    perm = np.asarray(perm)
    ei = perm[np.asarray(edge_index)]
    inv = np.argsort(perm)
    out = tuple(np.asarray(a)[inv] for a in arrays)
    return (ei,) + out
