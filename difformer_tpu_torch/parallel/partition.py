"""Host-side graph partitioning for node-sharded execution, as
``difformer_tpu/parallel/partition.py``: every array is the JAX package's
bit for bit.

Nodes are split into ``n_shards`` contiguous blocks of ``nodes_per_shard``
(N_loc) padded positions; each shard owns every edge whose receiver it
owns, so the scatter of the graph branch stays local, with the senders
kept as global padded positions (their rows arrive by a collective,
``parallel/sharded_ops.py``). Per-shard edge lists are padded to a common
length, a multiple of ``edge_pad_multiple``. ``build_halo=True`` adds the
boundary-exchange plan: the rows each shard ships to each other shard, a
sender table into ``[own ‖ halo]`` and the normalised edge values, split
into internal and boundary edges for the overlapped exchange.

:class:`ShardedGraph` holds the stacked ``[S, ...]`` numpy arrays;
:meth:`ShardedGraph.rank_graph` gives one rank's slice as tensors on a
device (:class:`RankGraph`), which is what a rank of the port's sharded
step runs on.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Optional

import numpy as np
import torch

# the overlap split's arrays, in the JAX package's order
_OVERLAP = ("int_senders", "int_receivers", "int_value", "bnd_senders",
            "bnd_receivers", "bnd_value")
# the per-rank arrays that become tensors, and the integer ones among them
_PER_RANK = ("node_feat", "node_mask", "senders", "receivers", "edge_mask",
             "edge_weight", "labels", "label_mask", "senders_table",
             "send_idx", "send_mask", "edge_value") + _OVERLAP


@dataclasses.dataclass(frozen=True)
class ShardedGraph:
    """Stacked per-shard arrays, leading dim = n_shards (the JAX package's
    ``ShardedGraph``, a plain dataclass of numpy arrays here)."""

    node_feat: Any          # [S, N_loc, F]
    node_mask: Any          # bool [S, N_loc]
    senders: Any            # int32 [S, E_loc]: global padded positions
    receivers: Any          # int32 [S, E_loc]: local positions
    edge_mask: Any          # bool [S, E_loc]
    edge_weight: Optional[Any] = None   # [S, E_loc]
    labels: Optional[Any] = None        # [S, N_loc, ...]
    label_mask: Optional[Any] = None    # bool [S, N_loc]
    # the boundary-exchange (halo) plan, with build_halo=True:
    # senders_table [S, E_loc] indices into [own (N_loc) ‖ halo (S·B)];
    # send_idx [S, S, B] the local rows shard s sends to each shard;
    # send_mask [S, S, B] False on padding slots;
    # edge_value [S, E_loc] the normalised conv weights, from the host
    senders_table: Optional[Any] = None
    send_idx: Optional[Any] = None
    send_mask: Optional[Any] = None
    edge_value: Optional[Any] = None
    # the overlap split: internal edges (sender local) and boundary edges
    # (sender in the halo), each padded to a multiple of 128
    int_senders: Optional[Any] = None    # [S, E_int] local sender
    int_receivers: Optional[Any] = None  # [S, E_int]
    int_value: Optional[Any] = None      # [S, E_int]
    bnd_senders: Optional[Any] = None    # [S, E_bnd] index into the halo
    bnd_receivers: Optional[Any] = None  # [S, E_bnd]
    bnd_value: Optional[Any] = None      # [S, E_bnd]
    num_nodes_global: int = 0
    nodes_per_shard: int = 0
    halo_width: int = 0

    @property
    def n_shards(self):
        return self.node_feat.shape[0]

    def replace(self, **changes) -> "ShardedGraph":
        return dataclasses.replace(self, **changes)

    def without_overlap(self) -> "ShardedGraph":
        """The same partition with the overlap split dropped, so that a
        step runs the plain halo exchange (flavour 2 of
        ``__graft_entry__.py:dryrun_multichip``)."""
        return self.replace(**dict.fromkeys(_OVERLAP))

    def rank_graph(self, rank: int, device=None) -> "RankGraph":
        """Shard ``rank``'s arrays as tensors on ``device`` (the rank's
        slice of every stacked array; None stays None)."""
        if not 0 <= rank < self.n_shards:
            raise ValueError(f"rank {rank} outside [0, {self.n_shards})")
        arrays = {}
        for name in _PER_RANK:
            a = getattr(self, name)
            arrays[name] = (None if a is None else torch.as_tensor(
                np.ascontiguousarray(np.asarray(a)[rank]), device=device))
        return RankGraph(**arrays, rank=rank, n_shards=self.n_shards,
                         num_nodes_global=self.num_nodes_global,
                         nodes_per_shard=self.nodes_per_shard,
                         halo_width=self.halo_width)


@dataclasses.dataclass(frozen=True)
class RankGraph:
    """One rank's slice of a :class:`ShardedGraph`, as tensors on one
    device: the arrays without their leading shard dim."""

    node_feat: torch.Tensor
    node_mask: torch.Tensor
    senders: torch.Tensor
    receivers: torch.Tensor
    edge_mask: torch.Tensor
    edge_weight: Optional[torch.Tensor]
    labels: Optional[torch.Tensor]
    label_mask: Optional[torch.Tensor]
    senders_table: Optional[torch.Tensor]
    send_idx: Optional[torch.Tensor]
    send_mask: Optional[torch.Tensor]
    edge_value: Optional[torch.Tensor]
    int_senders: Optional[torch.Tensor]
    int_receivers: Optional[torch.Tensor]
    int_value: Optional[torch.Tensor]
    bnd_senders: Optional[torch.Tensor]
    bnd_receivers: Optional[torch.Tensor]
    bnd_value: Optional[torch.Tensor]
    rank: int
    n_shards: int
    num_nodes_global: int
    nodes_per_shard: int
    halo_width: int

    def senders_and_halo(self):
        """(senders, halo) for the model, as the JAX package's
        ``parallel/api.py:_senders_and_halo``: with the overlap split a
        dict (the overlapped exchange), with a halo plan a tuple
        (send_idx, send_mask, edge_value) and the sender table, else the
        global senders and None (the all-gather)."""
        if self.int_senders is not None:
            return self.senders_table, {
                "send_idx": self.send_idx, "send_mask": self.send_mask,
                **{name: getattr(self, name) for name in _OVERLAP}}
        if self.senders_table is not None:
            return self.senders_table, (self.send_idx, self.send_mask,
                                        self.edge_value)
        return self.senders, None


def edge_balanced_layout(edge_index, num_nodes: int, n_shards: int,
                         node_align: int = 1):
    """Contiguous shard boundaries at equal cumulative receiver degree
    instead of equal node count, so that each shard gets about as many
    edges. Returns ``(node_perm, nodes_per_shard)``: ``node_perm[g]`` is
    node g's position in the padded ``[n_shards * nodes_per_shard]``
    layout (each shard's nodes packed at its block start), node order kept
    inside a shard."""
    ei = np.asarray(edge_index)
    deg = np.bincount(ei[1], minlength=num_nodes).astype(np.int64)
    c = np.cumsum(deg)
    total = max(int(c[-1]), 1)
    targets = (np.arange(1, n_shards) * total) / n_shards
    cuts = np.searchsorted(c, targets, side="left") + 1
    bounds = np.concatenate([[0], np.clip(cuts, 0, num_nodes), [num_nodes]])
    bounds = np.maximum.accumulate(bounds)
    return _packed_layout(bounds, n_shards, node_align)


def _packed_layout(bounds, n_shards, node_align, perm=None):
    """(node_perm, nodes_per_shard) of shard boundaries ``bounds`` over the
    nodes in order (or in the order of ``perm``: new = perm[old])."""
    counts = np.diff(bounds)
    n_loc = max(int(counts.max()), 1)
    n_loc = -(-n_loc // node_align) * node_align
    pos = np.empty(int(bounds[-1]), np.int64)
    for s in range(n_shards):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        pos[lo:hi] = s * n_loc + np.arange(hi - lo)
    return (pos if perm is None else pos[perm]), n_loc


def crossing_counts(edge_index, num_nodes: int):
    """``cross[b]``: the edges crossing a cut between node ``b-1`` and node
    ``b`` of the current order (an edge with end positions lo < hi crosses
    every b in (lo, hi]); O(E + N) by a difference array."""
    ei = np.asarray(edge_index)
    lo = np.minimum(ei[0], ei[1]).astype(np.int64)
    hi = np.maximum(ei[0], ei[1]).astype(np.int64)
    d = np.zeros(num_nodes + 1, np.int64)
    np.add.at(d, lo + 1, 1)
    np.add.at(d, hi + 1, -1)
    return np.cumsum(d)[: num_nodes + 1]


def locality_layout(edge_index, num_nodes: int, n_shards: int, *,
                    method: str = "community", node_align: int = 1,
                    balance_tol: float = 0.05):
    """The locality-aware layout: (1) renumber the nodes by
    ``data.transforms.locality_reorder`` (label-propagation communities by
    default), (2) place cut targets at equal cumulative receiver degree, as
    :func:`edge_balanced_layout`, (3) slide each cut, within the window
    where its shard's edges stay within ``balance_tol`` of the target, to
    the boundary crossed by the fewest edges (:func:`crossing_counts`).
    Where the degree-balanced cuts would give one shard more than twice
    its share of nodes, it warns and falls back to equal-node cuts of the
    reordered graph. Returns ``(node_perm, nodes_per_shard)``."""
    from difformer_tpu_torch.data.transforms import locality_reorder

    ei = np.asarray(edge_index)
    perm0 = locality_reorder(ei, num_nodes, method=method)  # new = perm0[old]
    ei_r = perm0[ei]

    deg = np.bincount(ei_r[1], minlength=num_nodes).astype(np.int64)
    c = np.cumsum(deg)
    total = max(int(c[-1]), 1)
    cross = crossing_counts(ei_r, num_nodes)

    tol = balance_tol * total / n_shards
    cuts = []
    prev = 0
    for k in range(1, n_shards):
        target = k * total / n_shards
        lo = int(np.searchsorted(c, target - tol, side="left")) + 1
        hi = int(np.searchsorted(c, target + tol, side="right")) + 1
        # hubs can push the whole degree mass past the target: clamp so
        # that the window is never empty
        lo = min(max(lo, prev + 1), num_nodes - 1)
        hi = min(max(hi, lo + 1), num_nodes)
        b = lo + int(np.argmin(cross[lo:hi]))
        cuts.append(b)
        prev = b
    bounds = np.concatenate([[0], cuts, [num_nodes]])
    bounds = np.maximum.accumulate(bounds)

    n_loc = max(int(np.diff(bounds).max()), 1)
    if n_loc * n_shards > 2 * num_nodes:
        warnings.warn(
            f"locality_layout: degree-balanced cuts degenerate "
            f"(max shard {n_loc} of {num_nodes} nodes); falling back to "
            f"equal-node cuts on the reordered graph", stacklevel=2)
        base = -(-num_nodes // n_shards)
        n_loc = -(-base // node_align) * node_align
        shard = perm0 // base
        return shard * n_loc + (perm0 - shard * base), n_loc
    return _packed_layout(bounds, n_shards, node_align, perm0)


def boundary_rows(edge_index, node_perm, nodes_per_shard: int) -> int:
    """The (owner, destination)-distinct boundary rows a layout ships a
    layer: the halo payload in rows (``send_mask.sum()`` of the built plan,
    without building it)."""
    ei = np.asarray(node_perm)[np.asarray(edge_index)]
    src_shard = ei[0] // nodes_per_shard
    dst_shard = ei[1] // nodes_per_shard
    remote = src_shard != dst_shard
    pairs = np.stack([ei[0][remote], dst_shard[remote]])
    return int(np.unique(pairs, axis=1).shape[1])


def partition_graph(
    node_feat: np.ndarray,
    edge_index: np.ndarray,
    n_shards: int,
    *,
    edge_weight: Optional[np.ndarray] = None,
    labels: Optional[np.ndarray] = None,
    label_mask: Optional[np.ndarray] = None,
    edge_pad_multiple: int = 128,
    build_halo: bool = False,
    node_align: int = 1,
    node_perm: Optional[np.ndarray] = None,
    nodes_per_shard: Optional[int] = None,
) -> ShardedGraph:
    """Contiguous node partition (or the layout ``node_perm`` with
    ``nodes_per_shard``, e.g. :func:`edge_balanced_layout`'s) and the
    receiver-owned edge partition, each shard's edges sorted by local
    receiver; ``node_align`` rounds N_loc up. ``build_halo=True`` adds the
    boundary-exchange plan (:func:`_build_halo_plan`)."""
    n = int(node_feat.shape[0])
    if node_perm is not None:
        pos = np.asarray(node_perm, np.int64)
        n_loc = int(nodes_per_shard)
    else:
        n_loc = -(-n // n_shards)
        n_loc = -(-n_loc // node_align) * node_align
        pos = np.arange(n, dtype=np.int64)
    n_pad = n_loc * n_shards

    x = np.zeros((n_pad,) + node_feat.shape[1:], dtype=np.float32)
    x[pos] = node_feat
    node_mask = np.zeros(n_pad, dtype=bool)
    node_mask[pos] = True

    ei = pos[np.asarray(edge_index)]
    shard_of_edge = ei[1] // n_loc

    per_shard = []
    max_e = 1
    for s in range(n_shards):
        sel = np.where(shard_of_edge == s)[0]
        sel = sel[np.argsort(ei[1, sel], kind="stable")]
        per_shard.append(sel)
        max_e = max(max_e, sel.shape[0])
    e_loc = -(-max_e // edge_pad_multiple) * edge_pad_multiple

    senders = np.zeros((n_shards, e_loc), dtype=np.int32)
    receivers = np.zeros((n_shards, e_loc), dtype=np.int32)
    edge_mask = np.zeros((n_shards, e_loc), dtype=bool)
    ew = None if edge_weight is None else np.zeros((n_shards, e_loc),
                                                   np.float32)
    for s, sel in enumerate(per_shard):
        e = sel.shape[0]
        senders[s, :e] = ei[0, sel]
        receivers[s, :e] = ei[1, sel] - s * n_loc
        edge_mask[s, :e] = True
        if ew is not None:
            ew[s, :e] = edge_weight[sel]

    def shard_nodes(arr):
        return arr.reshape((n_shards, n_loc) + arr.shape[1:])

    lab = lmask = None
    if labels is not None:
        labels = np.asarray(labels)
        pad_lab = np.zeros((n_pad,) + labels.shape[1:], dtype=labels.dtype)
        pad_lab[pos] = labels
        lab = shard_nodes(pad_lab)
        lm = np.zeros(n_pad, dtype=bool)
        lm[pos] = True if label_mask is None else np.asarray(label_mask)
        lmask = shard_nodes(lm)

    halo = {}
    if build_halo:
        halo = _build_halo_plan(ei, senders, receivers, edge_mask,
                                edge_weight, n_shards, n_loc, n_pad)

    return ShardedGraph(
        node_feat=shard_nodes(x), node_mask=shard_nodes(node_mask),
        senders=senders, receivers=receivers, edge_mask=edge_mask,
        edge_weight=ew, labels=lab, label_mask=lmask, num_nodes_global=n,
        nodes_per_shard=n_loc, **halo)


def _build_halo_plan(ei, senders, receivers, edge_mask, edge_weight,
                     n_shards, n_loc, n_pad):
    """The boundary-exchange plan of :func:`partition_graph`: for each
    ordered pair (owner j, destination s) the sorted global ids of j's rows
    that s's edges read, padded to B (a multiple of 8) slots; the sender
    table (own rows first, then shard j's slots at N_loc + j·B); the
    normalised values ``w · deg[r]^-½ · deg[s]^-½`` over global receiver
    degrees, in float64 rounded once; and the internal/boundary split."""
    deg = np.zeros(n_pad, np.float64)
    np.add.at(deg, ei[1], 1.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.sqrt(1.0 / deg)

    e_loc = senders.shape[1]
    need = [[None] * n_shards for _ in range(n_shards)]
    width = 1
    for s in range(n_shards):
        glob = senders[s][edge_mask[s]].astype(np.int64)
        owners = glob // n_loc
        for j in range(n_shards):
            if j != s:
                need[j][s] = np.unique(glob[owners == j])
                width = max(width, need[j][s].shape[0])
    width = -(-width // 8) * 8

    send_idx = np.zeros((n_shards, n_shards, width), np.int32)
    send_mask = np.zeros((n_shards, n_shards, width), bool)
    for j in range(n_shards):
        for s in range(n_shards):
            ids = need[j][s]
            if ids is not None and ids.shape[0]:
                send_idx[j, s, : ids.shape[0]] = ids - j * n_loc
                send_mask[j, s, : ids.shape[0]] = True

    senders_table = np.zeros((n_shards, e_loc), np.int32)
    edge_value = np.zeros((n_shards, e_loc), np.float32)
    for s in range(n_shards):
        em = edge_mask[s]
        glob = senders[s].astype(np.int64)
        recv_glob = receivers[s].astype(np.int64) + s * n_loc
        owner = glob // n_loc
        own = owner == s
        tab = np.zeros(e_loc, np.int64)
        tab[own] = glob[own] - s * n_loc
        # a remote sender's slot: its rank among the ids s needs from its
        # owner (need[j][s] is sorted), after the owner's block of slots
        for j in range(n_shards):
            sel = np.flatnonzero(em & (owner == j) & ~own)
            if sel.size:
                tab[sel] = (n_loc + j * width
                            + np.searchsorted(need[j][s], glob[sel]))
        senders_table[s] = tab
        w = np.ones(e_loc) if edge_weight is None else edge_weight[s]
        val = w * inv[recv_glob] * inv[glob]
        edge_value[s] = np.where(
            em, np.nan_to_num(val, nan=0.0, posinf=0.0, neginf=0.0), 0.0
        ).astype(np.float32)

    int_lists, bnd_lists = [], []
    for s in range(n_shards):
        em = edge_mask[s]
        own = (senders[s].astype(np.int64) // n_loc) == s
        sel_int = np.where(em & own)[0]
        sel_bnd = np.where(em & ~own)[0]
        int_lists.append((senders_table[s][sel_int], receivers[s][sel_int],
                          edge_value[s][sel_int]))
        bnd_lists.append((senders_table[s][sel_bnd] - n_loc,
                          receivers[s][sel_bnd], edge_value[s][sel_bnd]))

    def pad_split(lists):
        e_pad = -(-max(max(a.shape[0] for a, _, _ in lists), 1) // 128) * 128
        si = np.zeros((n_shards, e_pad), np.int32)
        # padded receivers are the last local node, so the receiver order
        # survives the padding (whose values are 0)
        ri = np.full((n_shards, e_pad), n_loc - 1, np.int32)
        vv = np.zeros((n_shards, e_pad), np.float32)
        for s, (a, b, v) in enumerate(lists):
            e = a.shape[0]
            si[s, :e], ri[s, :e], vv[s, :e] = a, b, v
        return si, ri, vv

    int_s, int_r, int_v = pad_split(int_lists)
    bnd_s, bnd_r, bnd_v = pad_split(bnd_lists)
    return dict(senders_table=senders_table, send_idx=send_idx,
                send_mask=send_mask, edge_value=edge_value,
                int_senders=int_s, int_receivers=int_r, int_value=int_v,
                bnd_senders=bnd_s, bnd_receivers=bnd_r, bnd_value=bnd_v,
                halo_width=width)


def shard_balance_stats(sg: ShardedGraph):
    """The load and padding skew of a partition: every shard runs the
    padded shapes (the largest shard's edges, N_loc nodes), so imbalance
    shows as padding. Returns ``edges_per_shard``, ``edge_skew`` (max over
    mean of the real edges), ``edge_pad_factor`` (S·E_loc over the real
    edges), the same three for nodes and, with a halo plan,
    ``halo_rows_per_shard`` and ``halo_pad_factor``."""
    em = np.asarray(sg.edge_mask)
    nm = np.asarray(sg.node_mask)
    S = em.shape[0]
    e_real = em.sum(axis=1).astype(np.int64)
    n_real = nm.sum(axis=1).astype(np.int64)
    out = {
        "edges_per_shard": e_real.tolist(),
        "edge_skew": float(e_real.max() / max(e_real.mean(), 1.0)),
        "edge_pad_factor": float(S * em.shape[1] / max(e_real.sum(), 1)),
        "nodes_per_shard": n_real.tolist(),
        "node_skew": float(n_real.max() / max(n_real.mean(), 1.0)),
        "node_pad_factor": float(S * nm.shape[1] / max(n_real.sum(), 1)),
    }
    if sg.send_mask is not None:
        sm = np.asarray(sg.send_mask)
        rows = sm.reshape(S, -1).sum(axis=1).astype(np.int64)
        slots = int(np.prod(sm.shape[1:]))
        out["halo_rows_per_shard"] = rows.tolist()
        out["halo_pad_factor"] = float(
            S * slots / max(rows.sum(), 1)) if rows.sum() else None
    return out
