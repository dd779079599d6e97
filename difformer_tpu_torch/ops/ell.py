"""Degree-bucketed ELL layout of the GCN product, as
``difformer_tpu/ops/ell.py``, run on the card by the ELL SpMM kernel K6
(``kernels/ell.py``).

The JAX package groups the nodes of one direction of the normalised
adjacency into degree buckets (widths at the degree quantiles, no two
neighbouring widths more than 2× apart, so the padding stays under 2× the
edges); each bucket holds a dense [rows, k] table of neighbour indices and
weights (0 on padding), each row sorted by neighbour index, and
``inv_perm`` takes the concatenated bucket outputs back to node order. The
host builders here are the same numpy code and give the same arrays, bit
for bit (:func:`build_ell_gcn`; the bucket fill through the port's native
``ell_fill`` where it loads, else numpy, with the same result).

:class:`EllGraph` keeps the buckets' rows concatenated (``idx``, ``val``,
one row after the other, bucket by bucket), the node of every row
(``rows``, the inverse of ``inv_perm``) and, on the host, each bucket's
first row, width and first slot (``table``): K6 computes every bucket of a
direction in one launch and writes each row straight to its node, so the
inverse-permutation gather of the JAX package is not needed. Built with the
layout on the host, beside those arrays, for K6 alone: each row's run of
padded slots (``pads``), which K6 skips, and the split plan of its hub
buckets (``split``, ``kernels/ell.py`` ``build_split``; another threshold
by :meth:`EllGraph.with_split`).
``nbr_idx`` and ``weight`` give the JAX package's per-bucket tables as
views. :func:`ell_spmm` is an autograd Function whose backward applies the
reverse direction (the values are data and get no gradient, as in JAX);
:func:`gcn_conv_ell` dispatches on the layout, the block-sparse ones of
``ops/bsr.py`` included. The JAX package's gather budget
(``_GATHER_BUDGET_BYTES``, k-chunking under ``lax.scan``) has no counterpart:
K6 never makes the gathered [rows, k, F] tensor.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from difformer_tpu_torch import native
from difformer_tpu_torch.kernels.ell import (EllSplit, build_split,
                                             ell_spmm_rows)


@dataclasses.dataclass(frozen=True)
class EllGraph:
    """One direction of the ELL layout: ``out[rows[r]] = Σ_j val[s_r + j] ·
    x[idx[s_r + j]]`` over the ``k`` slots of each row r of its bucket.

    ``table`` (int64 [B, 3], on the host) holds each bucket's first row,
    width and first slot; a bucket's rows are consecutive, and so are its
    slots, ``width`` a row. A row's slots are sorted by neighbour index, so
    its padding (index 0, weight 0) is one run after its real edges to node
    0: ``pads[r]`` = (its first slot, its length). ``split`` is K6's plan
    for the buckets wider than its threshold."""

    idx: torch.Tensor        # int32 [slots]
    val: torch.Tensor        # float32 [slots]
    rows: torch.Tensor       # int32 [N]: the node of each row
    inv_perm: torch.Tensor   # int32 [N]: the row of each node
    table: np.ndarray        # int64 [B, 3]
    pads: torch.Tensor       # int32 [N, 2]: first pad slot, pads, a row
    split: EllSplit
    num_nodes: int = 0

    @property
    def bucket_sizes(self):
        return tuple(int(k) for k in self.table[:, 1])

    def _buckets(self, flat):
        ends = list(self.table[1:, 0]) + [self.rows.numel()]
        return tuple(
            flat[s:s + (end - r0) * k].view(int(end - r0), int(k))
            for (r0, k, s), end in zip(self.table, ends))

    @property
    def nbr_idx(self):
        """Per bucket, int32 [rows, k] neighbour indices (the JAX layout)."""
        return self._buckets(self.idx)

    @property
    def weight(self):
        """Per bucket, float32 [rows, k] weights, 0 on padding."""
        return self._buckets(self.val)

    @property
    def num_slots(self):
        return self.idx.numel()

    def to(self, device) -> "EllGraph":
        return dataclasses.replace(
            self, idx=self.idx.to(device), val=self.val.to(device),
            rows=self.rows.to(device), inv_perm=self.inv_perm.to(device),
            pads=self.pads.to(device), split=self.split.to(device))

    def with_split(self, threshold) -> "EllGraph":
        """This layout with K6's split plan at ``threshold`` slots."""
        return dataclasses.replace(
            self, split=build_split(self.table, self.rows, threshold))


def _gcn_values(senders, receivers, num_nodes, edge_weight):
    """Reference-parity normalised edge values (``difformer_tpu/ops/ell.py:
    49-57``)."""
    deg = np.zeros(num_nodes, np.float64)
    np.add.at(deg, receivers, 1.0)
    w = np.ones(len(senders)) if edge_weight is None else np.asarray(
        edge_weight)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.sqrt(1.0 / deg)
        val = w * inv[receivers] * inv[senders]  # inf · 0 → nan → 0 below
    return np.nan_to_num(val, nan=0.0, posinf=0.0, neginf=0.0).astype(
        np.float32)


def _adaptive_ks(counts, *, min_bucket=8, max_buckets=6):
    """The bucket widths (``difformer_tpu/ops/ell.py:60-100``): at most
    ``max_buckets`` widths at the degree quantiles, rounded up to
    multiples of 8 (of ``min_bucket`` below 8), the last covering the
    largest degree, then densified so that no two neighbouring widths
    differ by more than 2×."""
    pos = counts[counts > 0]
    if pos.size == 0:
        return [min_bucket]
    mult = 8 if min_bucket >= 8 else max(min_bucket, 1)
    qs = np.linspace(0.0, 1.0, max_buckets + 1)[1:]
    ks = {max(min_bucket, int(np.quantile(pos, q))) for q in qs}
    ks = sorted({-(-k // mult) * mult for k in ks})
    max_deg = int(pos.max())
    if ks[-1] < max_deg:
        ks[-1] = -(-max_deg // mult) * mult
    dense = [ks[0]]
    for k in ks[1:]:
        while k > 2 * dense[-1]:
            dense.append(-(-(2 * dense[-1]) // mult) * mult)
        dense.append(k)
    return sorted(set(dense))


def _build_direction(point_to, owner, values, num_nodes, *,
                     min_bucket=8) -> EllGraph:
    """ELL for ``out[owner] = Σ values · x[point_to]``, grouped by owner
    (``difformer_tpu/ops/ell.py:103-160``)."""
    # the stable order by owner and the owners' CSR offsets
    order, indptr = native.sort_edges_by_receiver(owner, num_nodes)
    point_s = point_to[order].astype(np.int32)
    val_s = values[order].astype(np.float32)
    if point_s.shape[0] == 0:  # edgeless graph
        point_s = np.zeros(1, np.int32)
        val_s = np.zeros(1, np.float32)
    counts = np.diff(indptr)

    ks = _adaptive_ks(counts, min_bucket=min_bucket)
    bucket_of = np.searchsorted(np.asarray(ks), np.maximum(counts, 1))
    idx_parts, w_parts, pad_parts, node_lists, table = [], [], [], [], []
    row = slot = 0
    for bi, kb in enumerate(ks):
        nodes = np.where(bucket_of == bi)[0]
        node_lists.append(nodes)
        table.append((row, kb, slot))
        row += nodes.shape[0]
        slot += nodes.shape[0] * kb
        if nodes.shape[0] == 0:
            continue
        idx, w = native.ell_fill(nodes, kb, indptr, point_s, val_s)
        # each row's neighbours by index, as the JAX package sorts them
        order2 = np.argsort(idx, axis=1, kind="stable")
        idx = np.take_along_axis(idx, order2, axis=1)
        idx_parts.append(idx.reshape(-1))
        w_parts.append(np.take_along_axis(w, order2, axis=1).reshape(-1))
        # the padding (index 0) follows the row's real edges to node 0 in
        # the stable order
        pad = np.maximum(kb - counts[nodes], 0)
        pad_parts.append(np.stack([(idx == 0).sum(1) - pad, pad], 1))

    concat_order = np.concatenate(node_lists).astype(np.int64)
    inv_perm = np.empty(num_nodes, np.int64)
    inv_perm[concat_order] = np.arange(num_nodes)
    flat = lambda parts, dt: torch.from_numpy(  # noqa: E731
        np.concatenate(parts) if parts else np.zeros(0, dt))
    rows = torch.from_numpy(concat_order.astype(np.int32))
    table = np.asarray(table, np.int64).reshape(-1, 3)
    pads = (np.concatenate(pad_parts) if pad_parts
            else np.zeros((0, 2), np.int64))
    return EllGraph(
        idx=flat(idx_parts, np.int32), val=flat(w_parts, np.float32),
        rows=rows, inv_perm=torch.from_numpy(inv_perm.astype(np.int32)),
        table=table, pads=torch.from_numpy(pads.astype(np.int32)),
        split=build_split(table, rows), num_nodes=num_nodes)


def build_ell_gcn(senders, receivers, num_nodes, edge_weight=None):
    """(forward, reverse) :class:`EllGraph`s of the reference-normalised
    GCN adjacency, on the host: the forward owned by the receivers, the
    reverse by the senders (``difformer_tpu/ops/ell.py:163-171``)."""
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    val = _gcn_values(senders, receivers, num_nodes, edge_weight)
    return (_build_direction(senders, receivers, val, num_nodes),
            _build_direction(receivers, senders, val, num_nodes))


class EllSpmm(torch.autograd.Function):
    """``Â @ x`` over the forward direction by K6; the backward applies the
    reverse direction to the cotangent by K6 (its launch named
    ``ell_spmm_transposed``). The layouts are data: no gradient."""

    @staticmethod
    def forward(ctx, x, fwd, rev):
        ctx.rev = rev
        return ell_spmm_rows(x, fwd)

    @staticmethod
    def backward(ctx, g):
        return ell_spmm_rows(g.contiguous(), ctx.rev, transposed=True), \
            None, None


def ell_spmm(ell_fwd: EllGraph, ell_rev: EllGraph, x):
    """``Â @ x`` for x [N, ...] (every trailing dim in one product) through
    K6; the backward applies ``ell_rev``."""
    n = x.shape[0]
    return EllSpmm.apply(x.reshape(n, -1), ell_fwd, ell_rev).reshape(x.shape)


def gcn_conv_ell(x, ell_fwd, ell_rev):
    """``ops.graph_ops.gcn_conv`` on a prebuilt layout: the ELL pair of
    :func:`build_ell_gcn`, or the block-sparse hybrid of ``ops/bsr.py``
    (padded or bucketed); x [N, ...] with heads and channels in the trailing
    dims. A rank's pair of the node-sharded hybrid (``BsrShard``) gives the
    rank's rows from its rows x [rows_per, ...] (``bsr_spmm_sharded``)."""
    from difformer_tpu_torch.ops import bsr

    if isinstance(ell_fwd, EllGraph):
        return ell_spmm(ell_fwd, ell_rev, x)
    if isinstance(ell_fwd, bsr.BsrShard):
        return bsr.bsr_spmm_sharded(ell_fwd, ell_rev, x)
    if isinstance(ell_fwd, (bsr.BsrDirection, bsr.BsrBuckets)):
        return bsr.bsr_spmm(ell_fwd, ell_rev, x)
    raise TypeError(
        f"gcn_conv_ell takes EllGraph, BsrDirection, BsrBuckets or BsrShard "
        f"layouts, got {type(ell_fwd).__name__}")
