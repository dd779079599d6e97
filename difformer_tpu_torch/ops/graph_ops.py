"""Graph convolution, as ``difformer_tpu/ops/graph_ops.py:23-201, 219-236``.

The reference (``node classification/difformer.py:63-79``) builds the
normalised adjacency transposed, so each edge (s, r) adds
``value · x[s]`` into ``out[r]``, with
``value = w · (1/deg[r]).sqrt() · (1/deg[s]).sqrt()``, ``deg`` counted over
receivers and non-finite values set to 0.

Both products here, :func:`gcn_conv` and :func:`spmm`, run the CSR SpMM K1
(``kernels/spmm.py``) over a :class:`CsrPlan`: the receivers' CSR, the
senders' (transposed) CSR for the backward, the values in both orders, and
each CSR's split schedule of heavy rows. A plan may be rectangular
(:func:`build_value_plan`: rows and columns counted apart, as the
node-sharded products of ``parallel/sharded_ops.py`` need); the others
are square.
:func:`views_plan` builds a plan over arrays the host built (the
mini-batch trainer's chunks, packed at a capacity or exact).
``gcn_conv``'s plan, with the normalised values, depends only on the
graph's indices, ``edge_weight`` and ``edge_mask``, so a caller that runs
many convolutions on one graph builds it once (``GraphData.csr_plan()``)
and passes it; without one, each call builds its own, with a sort and a
degree pass. ``spmm`` takes its values from the caller and sorts its edges
on every call, unless given the plan of :func:`build_spmm_plan`, which a
caller that multiplies by one sparse matrix many times (DConv's hops,
GCNLayer, the baseline zoo's hop loops) builds once. That plan keeps the
two edge orders it sorted by, so a call can give it new per-edge values,
[E] or per head [E, H], in the plan's edge order, without sorting again;
such values get a gradient, K1-dval's (``kernels/spmm.py``), as JAX
differentiates ``spmm``'s values. :class:`EdgeIncidence` gathers node rows
onto a plan's edges and sums edges into nodes, both through K1 (GAT's
attention logits and softmax). :func:`gcn_norm` gives the baseline models'
PyG normalisation with or without self-loops, :func:`gen_normalized_adjs`
the reference's three degree normalisations. Both products run at x's dtype, float32 or
bfloat16 (K1 sums in float32 at either). :func:`knn_table_conv` is the
graph-level track's gather-table conv (``data/batching.py:
regular_knn_table``), a gather and a weighted sum in both directions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from difformer_tpu_torch.kernels import spmm as K1
from difformer_tpu_torch.kernels.spmm import (DVAL_SPLIT_THRESHOLD, CsrSpmm,
                                               RowSplit, row_split)
from difformer_tpu_torch.ops.segment import segment_sum


def degree(index, num_nodes, dtype=torch.float32):
    """Count occurrences of each node id in ``index`` (PyG ``degree``)."""
    return segment_sum(torch.ones(index.shape, dtype=dtype,
                                  device=index.device), index, num_nodes)


def _nan_to_num(x):
    """``torch.nan_to_num(nan=0, posinf=0, neginf=0)``."""
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def gcn_norm_weights(senders, receivers, num_nodes, edge_weight=None):
    """Per-edge symmetric-normalisation weights, as the reference."""
    deg = degree(receivers, num_nodes)
    inv_sqrt = torch.sqrt(1.0 / deg)  # inf where deg == 0, zeroed below
    value = inv_sqrt[receivers] * inv_sqrt[senders]
    if edge_weight is not None:
        value = edge_weight * value
    return _nan_to_num(value)


def gcn_norm_weights_masked(senders, receivers, num_nodes, edge_weight,
                            edge_mask):
    """``gcn_norm_weights`` with padded edges left out of both the degree
    and the value."""
    if edge_mask is None:
        return gcn_norm_weights(senders, receivers, num_nodes, edge_weight)
    ones = edge_mask.to(torch.float32)
    deg = segment_sum(ones, receivers, num_nodes)
    inv_sqrt = torch.sqrt(1.0 / deg)
    value = inv_sqrt[receivers] * inv_sqrt[senders]
    if edge_weight is not None:
        value = edge_weight * value
    return _nan_to_num(value) * ones


@dataclasses.dataclass(frozen=True)
class CsrPlan:
    """The two CSRs of one graph's edges, for K1 and its backward.

    ``row_ptr``/``col`` are the receivers' row pointers and the senders in
    receiver order, ``t_row_ptr``/``t_col`` the senders' row pointers and
    the receivers in sender order (both orders stable); ``val``/``t_val``
    the per-edge values in the two orders; ``split``/``t_split`` the two
    CSRs' schedules of heavy rows for K1 (``kernels/spmm.py``,
    :func:`row_split` at ``SPLIT_THRESHOLD``); ``dval_split``, in the plans
    of :func:`build_spmm_plan` whose values take a gradient, the forward
    CSR's schedule for K1-dval (at ``DVAL_SPLIT_THRESHOLD``).
    ``num_nodes`` counts the rows (receivers) and ``num_cols`` the columns
    (senders, the rows of x), ``num_nodes`` unless given: the product
    takes x [num_cols, ...] to [num_nodes, ...]."""

    num_nodes: int
    row_ptr: torch.Tensor      # int32 [N + 1]
    col: torch.Tensor          # int32 [E]
    val: torch.Tensor          # float32 [E]
    t_row_ptr: torch.Tensor    # int32 [N + 1]
    t_col: torch.Tensor        # int32 [E]
    t_val: torch.Tensor        # float32 [E]
    split: RowSplit
    t_split: RowSplit
    # the edge maps of build_spmm_plan's plans (None elsewhere): the edge
    # (in the order the plan was built from) at each CSR position and at
    # each transposed position, the CSR position of each edge, and the row
    # of each CSR position
    order: Optional[torch.Tensor] = None      # int64 [E]
    t_order: Optional[torch.Tensor] = None    # int64 [E]
    inv_order: Optional[torch.Tensor] = None  # int64 [E]
    rows: Optional[torch.Tensor] = None       # int32 [E]
    dval_split: Optional[RowSplit] = None
    num_cols: Optional[int] = None

    def __post_init__(self):
        if self.num_cols is None:
            object.__setattr__(self, "num_cols", self.num_nodes)

    @property
    def num_edges(self):
        return self.col.numel()

    def maps(self):
        """(order, t_order, inv_order, rows) for ``CsrSpmm``'s values."""
        if self.order is None:
            raise ValueError("this plan keeps no edge order; per-call edge "
                             "values need the plan of build_spmm_plan")
        return self.order, self.t_order, self.inv_order, self.rows


def _row_ptr(index, num_nodes):
    counts = torch.bincount(index, minlength=num_nodes)
    ptr = torch.zeros(num_nodes + 1, dtype=torch.int64, device=index.device)
    ptr[1:] = torch.cumsum(counts, 0)
    return ptr.to(torch.int32)


def _checked_edges(senders, receivers, num_nodes, num_cols=None):
    """(senders, receivers) as int64, after checking that every receiver
    lies in [0, num_nodes), every sender in [0, num_cols) (``num_nodes``
    unless given) and that E < 2³¹ (the kernel's int32 columns and row
    pointers)."""
    num_cols = num_nodes if num_cols is None else num_cols
    e = senders.numel()
    if receivers.shape != senders.shape or senders.dim() != 1:
        raise ValueError(f"senders and receivers must be [E], got "
                         f"{tuple(senders.shape)}, {tuple(receivers.shape)}")
    if e >= 2**31:
        raise ValueError(f"the CSR plan takes fewer than 2**31 edges, got {e}")
    senders, receivers = senders.long(), receivers.long()
    if e and (int(torch.minimum(senders.min(), receivers.min())) < 0
              or int(receivers.max()) >= num_nodes
              or int(senders.max()) >= num_cols):
        raise ValueError(f"edge indices must lie in [0, {num_nodes})"
                         + ("" if num_cols == num_nodes else
                            f" (receivers) and [0, {num_cols}) (senders)"))
    return senders, receivers


def _plan(senders, receivers, num_nodes, value, maps=False,
          value_grad=False, num_cols=None) -> CsrPlan:
    num_cols = num_nodes if num_cols is None else num_cols
    order = torch.argsort(receivers, stable=True)
    t_order = torch.argsort(senders, stable=True)
    row_ptr = _row_ptr(receivers, num_nodes)
    t_row_ptr = _row_ptr(senders, num_cols)
    kept = {}
    if maps:
        e = order.numel()
        inv_order = torch.empty_like(order)
        inv_order[order] = torch.arange(e, device=order.device)
        kept = dict(order=order, t_order=t_order, inv_order=inv_order,
                    rows=receivers[order].to(torch.int32))
        if value_grad:
            kept["dval_split"] = row_split(row_ptr, DVAL_SPLIT_THRESHOLD)
    return CsrPlan(
        num_nodes=num_nodes, row_ptr=row_ptr,
        col=senders[order].to(torch.int32), val=value[order],
        t_row_ptr=t_row_ptr,
        t_col=receivers[t_order].to(torch.int32), t_val=value[t_order],
        split=row_split(row_ptr), t_split=row_split(t_row_ptr),
        num_cols=num_cols, **kept)


def splits_of(v, prefix, counts, threshold=None):
    """The :class:`RowSplit` of the fields ``{prefix}rows``,
    ``{prefix}seg_ptr``, ``{prefix}seg_begin`` and ``{prefix}seg_end`` of
    the views ``v``, at ``threshold`` (K1's ``SPLIT_THRESHOLD`` unless
    given), held at a capacity with ``counts`` (None: exact)."""
    return RowSplit(K1.SPLIT_THRESHOLD if threshold is None else threshold,
                    v[f"{prefix}rows"], v[f"{prefix}seg_ptr"],
                    v[f"{prefix}seg_begin"], v[f"{prefix}seg_end"], counts)


def views_plan(v, num_nodes):
    """The :class:`CsrPlan` of ``num_nodes`` nodes over the views ``v`` of
    a plan built on the host (``row_ptr``, ``col``, ``val``, their ``t_``
    twins and the two split schedules; ``train/minibatch.py`` packs them):
    with ``counts``, a plan packed at a capacity, K1's schedules at
    capacity with their counts in it; without, an exact plan."""
    counts = v.get("counts")
    return CsrPlan(
        num_nodes=num_nodes, row_ptr=v["row_ptr"], col=v["col"],
        val=v["val"], t_row_ptr=v["t_row_ptr"], t_col=v["t_col"],
        t_val=v["t_val"],
        split=splits_of(v, "", None if counts is None else counts[:2]),
        t_split=splits_of(v, "t_", None if counts is None else counts[2:4]))


def build_csr_plan(senders, receivers, num_nodes, edge_weight=None,
                   edge_mask=None) -> CsrPlan:
    """The :class:`CsrPlan` of edges (senders, receivers), in any order, on
    their device, with the GCN values of :func:`gcn_norm_weights_masked`.
    Checks that every index lies in [0, num_nodes) and that E < 2³¹."""
    senders, receivers = _checked_edges(senders, receivers, num_nodes)
    value = gcn_norm_weights_masked(senders, receivers, num_nodes,
                                    edge_weight, edge_mask).float()
    return _plan(senders, receivers, num_nodes, value)


def build_value_plan(values, senders, receivers, num_rows,
                     num_cols=None) -> CsrPlan:
    """The :class:`CsrPlan` of ``out[r] += values[e] · x[s]`` over edges
    (senders, receivers), in any order, with these values (data: no
    gradient) and no edge maps: x [num_cols, ...] (``num_rows`` unless
    given) to out [num_rows, ...]. Checks the indices as
    :func:`build_csr_plan` does."""
    senders, receivers = _checked_edges(senders, receivers, num_rows,
                                        num_cols)
    return _plan(senders, receivers, num_rows, values.detach().float(),
                 num_cols=num_cols)


def _csr_product(x, plan, edge_chunk_size, values=None):
    """K1 over ``plan``, for x of any trailing shape [N, ...] (all heads and
    channels in one product). With ``values`` [E] (in the plan's edge
    order) they replace the plan's own; with per-head ``values`` [E, H] and
    x [N, H, ...], head h's values multiply x[:, h], all heads in one
    autograd Function (one K1 launch a head each way, one K1-dval for all
    heads)."""
    n = x.shape[0]
    if n != plan.num_cols:
        raise ValueError(f"x has {n} rows; the plan has "
                         f"{plan.num_cols} columns")
    fwd = (plan.row_ptr, plan.col, plan.val, plan.split)
    bwd = (plan.t_row_ptr, plan.t_col, plan.t_val, plan.t_split)
    if values is None:
        out = CsrSpmm.apply(x.reshape(n, -1), fwd, bwd, edge_chunk_size)
        return out.reshape((plan.num_nodes,) + tuple(x.shape[1:]))
    maps = plan.maps()
    if values.shape[0] != plan.num_edges or values.dim() not in (1, 2):
        raise ValueError(f"values must be [E] or [E, H] with E = "
                         f"{plan.num_edges}, got {tuple(values.shape)}")
    heads = 1 if values.dim() == 1 else values.shape[1]
    if values.dim() == 2 and (x.dim() < 2 or x.shape[1] != heads):
        raise ValueError(f"per-head values [E, {heads}] need x [N, {heads}, "
                         f"...], got {tuple(x.shape)}")
    out = CsrSpmm.apply(x.reshape(n, heads, -1), fwd, bwd, edge_chunk_size,
                        values, maps, plan.dval_split)
    return out.reshape((plan.num_nodes,) + tuple(x.shape[1:]))


def gcn_conv(x, senders, receivers, edge_weight=None, *, num_nodes=None,
             edge_mask=None, indices_are_sorted=False, edge_chunk_size=None,
             plan: Optional[CsrPlan] = None):
    """``out[r] += value · x[s]`` over every edge, for float32 or bfloat16
    x of any trailing shape (e.g. [N, H, D]: all heads in one product),
    through K1.

    ``edge_mask`` marks real edges; padded edges point at a valid node and
    are zeroed. ``indices_are_sorted`` is accepted as in the JAX package;
    the plan's own sort makes it moot. ``edge_chunk_size`` keeps the JAX
    package's meaning, at most that many [E, ...] messages at once: the
    plain version streams the edges in chunks of it, and the kernel never
    makes the messages at all. ``plan``, the graph's :class:`CsrPlan`
    (``GraphData.csr_plan()``), replaces senders, receivers, edge_weight
    and edge_mask, which are then not read; without it the call builds
    one."""
    del indices_are_sorted
    if plan is None:
        plan = build_csr_plan(senders, receivers,
                              x.shape[0] if num_nodes is None else num_nodes,
                              edge_weight, edge_mask)
    return _csr_product(x, plan, edge_chunk_size)


def build_spmm_plan(values, senders, receivers, num_nodes, *,
                    value_grad=False) -> CsrPlan:
    """The :class:`CsrPlan` of the sparse matrix with ``out[r] +=
    values[e] · x[s]`` over edges (senders, receivers), in any order, for
    :func:`spmm`'s ``plan``, with its edge maps, so that a call can give
    other values in this edge order. The plan's values are data (no
    gradient); ``values`` None gives ones. ``value_grad`` also builds the
    schedule K1-dval walks on the card (``dval_split``, reading the degrees
    back), which a call whose values require a gradient needs there.
    Checks the indices as :func:`build_csr_plan` does."""
    senders, receivers = _checked_edges(senders, receivers, num_nodes)
    if values is None:
        values = torch.ones(senders.shape, device=senders.device)
    return _plan(senders, receivers, num_nodes, values.detach().float(),
                 maps=True, value_grad=value_grad)


def spmm(values, senders, receivers, x, num_nodes=None, *,
         indices_are_sorted=False, plan: Optional[CsrPlan] = None):
    """Generic sparse @ dense: ``out[r] += values[e] · x[s]`` (COO), through
    K1. ``values`` [E], or [E, H] per head for x [N, H, ...], get a
    gradient when they require one (K1-dval in the backward), as the JAX
    package's ``spmm`` does. Without ``plan`` each call sorts the edges into
    the two CSRs it needs; with the plan of :func:`build_spmm_plan` it sorts
    nothing, and ``values`` (in the plan's edge order) replace the plan's
    own, or, when None, the plan's own are taken; senders and receivers are
    then not read."""
    del indices_are_sorted
    if plan is None:
        n = x.shape[0] if num_nodes is None else num_nodes
        plan = build_spmm_plan(values if values.dim() == 1 else None,
                               senders, receivers, n,
                               value_grad=values.requires_grad)
        if values.dim() == 1 and not values.requires_grad:
            values = None
    return _csr_product(x, plan, None, values)


@dataclasses.dataclass(frozen=True)
class EdgeIncidence:
    """The incidence of a plan's edges, in CSR order, with one of their ends:
    :meth:`gather` takes node rows onto the edges, ``a[node(e)]``, and
    :meth:`sum` adds edge rows into their nodes, ``Σ_{e: node(e) = v}
    m[e]``. Each is K1 over one CSR with the other as its backward: the
    edges' CSR (a row an edge, one entry each) and the nodes' (each node's
    edges in order), with unit values. No atomics either way."""

    edge_csr: tuple   # (row_ptr [E + 1], node of each edge, ones, split)
    node_csr: tuple   # (row_ptr [N + 1], edges of each node, ones, split)

    def gather(self, a):
        """[E, ...]: ``a[node(e)]`` for a [N, ...]."""
        out = CsrSpmm.apply(a.reshape(a.shape[0], -1), self.edge_csr,
                            self.node_csr, None)
        return out.reshape((-1,) + tuple(a.shape[1:]))

    def sum(self, m):
        """[N, ...]: the sum of each node's edge rows of m [E, ...]."""
        out = CsrSpmm.apply(m.reshape(m.shape[0], -1), self.node_csr,
                            self.edge_csr, None)
        return out.reshape((-1,) + tuple(m.shape[1:]))


def edge_incidence(plan: CsrPlan, end: str) -> EdgeIncidence:
    """The :class:`EdgeIncidence` of ``plan``'s edges (CSR order) with
    their receivers (``end="receiver"``, each edge's row) or their senders
    (``end="sender"``, its column); the plan must keep its edge maps
    (:func:`build_spmm_plan`)."""
    order, t_order, inv_order, rows = plan.maps()
    e = plan.num_edges
    device = plan.col.device
    ones = torch.ones(e, device=device)
    edge_ptr = torch.arange(e + 1, dtype=torch.int32, device=device)
    edge_split = row_split(edge_ptr)
    if end == "receiver":
        node = rows
        node_csr = (plan.row_ptr, torch.arange(e, dtype=torch.int32,
                                               device=device), ones,
                    plan.split)
    elif end == "sender":
        node = plan.col
        # each sender's edges as CSR positions, in the transposed order
        node_csr = (plan.t_row_ptr,
                    inv_order[t_order].to(torch.int32), ones, plan.t_split)
    else:
        raise ValueError(f"end must be 'receiver' or 'sender', got {end!r}")
    return EdgeIncidence((edge_ptr, node, ones, edge_split), node_csr)


def _degree_host(index, weight, num_nodes):
    """:func:`weighted_degree` as a float32 numpy array."""
    return np.bincount(index.detach().cpu().numpy(),
                       weights=weight.detach().double().cpu().numpy(),
                       minlength=num_nodes).astype(np.float32)


def weighted_degree(index, weight, num_nodes):
    """``segment_sum(weight, index, num_nodes)`` (float32 on ``index``'s
    device), summed on the host in float64 in edge order, so that a plan is
    the same bit for bit at every build: ``index_add_`` on CUDA adds float
    weights with atomics in no fixed order. (Unit weights need no such
    care: their sums are exact integers.) For plan building, once per
    graph."""
    return torch.as_tensor(_degree_host(index, weight, num_nodes),
                           device=index.device)


def gcn_norm(senders, receivers, num_nodes, edge_weight=None, *,
             add_self_loops=True, fill_value=1.0):
    """PyG ``gcn_norm``, as the JAX package's (``graph_ops.py:177-201``):
    (senders, receivers, values) with a self-loop of weight ``fill_value``
    appended on every node (``add_self_loops``), and
    ``value = deg^-1/2[s] · w · deg^-1/2[r]`` with the weighted degrees
    counted over receivers (:func:`weighted_degree`), 0 where a degree is
    0. ``deg^-1/2`` is taken on the host with the degrees, a float square
    root and a float quotient each rounded once, as the CPU's
    ``torch.rsqrt`` gives it (the card's ``rsqrt`` is approximate: on an
    H100 80GB HBM3 at 700 W it differs in the last bits at 35 % of the
    integer degrees up to 2 million), so that
    the values are the same on either device and the mini-batch trainer's
    host plans (``native.chunk_norm_csr``) are them bit for bit. The edges
    are int64 and the values float32 on the edges' device."""
    senders, receivers = senders.long(), receivers.long()
    if edge_weight is None:
        edge_weight = torch.ones(senders.shape, dtype=torch.float32,
                                 device=senders.device)
    edge_weight = edge_weight.float()
    if add_self_loops:
        loop = torch.arange(num_nodes, device=senders.device)
        senders = torch.cat([senders, loop])
        receivers = torch.cat([receivers, loop])
        edge_weight = torch.cat([edge_weight, torch.full(
            (num_nodes,), fill_value, dtype=torch.float32,
            device=senders.device)])
    deg = _degree_host(receivers, edge_weight, num_nodes)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(deg > 0, np.float32(1) / np.sqrt(
            np.maximum(deg, np.float32(1e-30))), np.float32(0))
    inv_sqrt = torch.as_tensor(inv, device=senders.device)
    norm = inv_sqrt[senders] * edge_weight * inv_sqrt[receivers]
    return senders, receivers, norm


def gen_normalized_adjs(senders, receivers, num_nodes, *, mode="DAD"):
    """Degree-normalised per-edge values, as the JAX package's
    (``graph_ops.py:204-221``; reference ``data_utils.py:203-227``, for
    :func:`spmm`): D⁻½AD⁻½ (``"DAD"``, receivers' and senders' degrees),
    D⁻¹A (``"DA"``) or AD⁻¹ (``"AD"``), 0 where a degree is 0. Float32 on
    the edges' device."""
    senders, receivers = senders.long(), receivers.long()
    deg = degree(receivers, num_nodes)
    deg_s = degree(senders, num_nodes)

    def inv(d, f):
        return torch.where(d > 0, f(d.clamp(min=1e-30)), torch.zeros_like(d))

    if mode == "DAD":
        return (inv(deg, torch.rsqrt)[receivers]
                * inv(deg_s, torch.rsqrt)[senders])
    if mode == "DA":
        return inv(deg, torch.reciprocal)[receivers]
    if mode == "AD":
        return inv(deg_s, torch.reciprocal)[senders]
    raise ValueError(mode)


def add_remaining_self_loops_dense(adj):
    """``adj + I`` for a dense [N, N] adjacency (``graph_ops.py:171-174``;
    a utility for dense baselines)."""
    return adj + torch.eye(adj.shape[0], dtype=adj.dtype, device=adj.device)


def _table_gather(x, idx, w):
    """``out[r] = Σ_j w[r, j] · x[idx[r, j]]`` for x [N, ...], idx/w [R, k]."""
    rows = x.index_select(0, idx.reshape(-1)).reshape(idx.shape + x.shape[1:])
    w = w.to(x.dtype).reshape(idx.shape + (1,) * (x.dim() - 1))
    return (rows * w).sum(1)


class KnnTableConv(torch.autograd.Function):
    """The table conv with the transposed table's backward: ``dv[s] =
    Σ_j rw[s, j] · dg[ridx[s, j]]``, a gather and a sum again (no
    scatter). The tables are data: only v gets a gradient."""

    @staticmethod
    def forward(ctx, v, idx, w, ridx, rw):
        ctx.save_for_backward(ridx, rw)
        return _table_gather(v, idx, w)

    @staticmethod
    def backward(ctx, dg):
        ridx, rw = ctx.saved_tensors
        return _table_gather(dg, ridx, rw), None, None, None, None


def knn_table_conv(v, idx, w, ridx=None, rw=None):
    """The conv over a gather table (``regular_knn_table``), as the JAX
    package's custom-VJP ``knn_table_conv`` (``graph_ops.py:129-168``):
    ``out[r] = Σ_j w[r, j] · v[idx[r, j]]`` for v [B·M, H, D]. With the
    transposed table (``ridx``, ``rw``) the backward gathers over it;
    without, it is autograd's through ``index_select`` (a scatter-add, as
    JAX's take-VJP)."""
    if ridx is None:
        return _table_gather(v, idx, w)
    return KnnTableConv.apply(v, idx, w, ridx, rw)
