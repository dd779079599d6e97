"""Block-sparse (BSR) hybrid of the GCN product, as ``difformer_tpu/ops/
bsr.py`` (its single-device parts), run on the card by the block kernel K7
(``kernels/bsr.py``) and the ELL kernel K6 (``kernels/ell.py``).

Host preprocessing splits the edges of one direction by tile occupancy:
the [T, T] tiles of the adjacency that hold at least ``min_edges`` edges
become dense blocks, the rest stay on a residual ELL layout
(``ops/ell.py``). Two layouts of the blocks, as in the JAX package:

* :class:`BsrDirection`, padded: a tile-level ELL [Ntr, Kb, T, T] with
  ``block_col`` [Ntr, Kb], every row tile padded to the widest
  (:func:`build_bsr_gcn`, with a per-row cap from a byte budget);
* :class:`BsrBuckets`, bucketed: row tiles grouped by their block count
  into the ``_KB_LADDER`` rungs, each bucket [m, kb, T, T] with its row
  tiles, the kept tiles chosen densest-first under a byte budget, and for
  unweighted graphs int8 edge counts with the rank-1 GCN scaling
  ``inv_scale`` (:func:`build_bsr_bucketed_gcn`).

The host builders are the JAX package's numpy code and give the same
blocks, block columns, row tiles, residuals and ``inv_scale``, bit for bit.
On the card one call of a direction is K7 over every row tile (each
written once; the bucketed layout's tiles with no block are written 0),
then, where there is a residual, K6 adding it on the raw x. ``bsr_spmm``
is an autograd Function whose backward applies the reverse direction.

The cost model: ``_EDGE_EQUIV_BYTES`` and ``_BUCKETED_BREAKEVEN_SCALE`` are
this card's (the JAX package's are a TPU v5e's), measured by
``chip_smoke.py`` (phase ell-bsr-kernels) from K1's time per edge and K7's
time per block; ``choose_spmm`` elects a layout with them. The block
budgets and the coverage threshold stay the JAX package's. The JAX
package's gather budget (``_BSR_GATHER_BUDGET_BYTES``) has no counterpart:
K7 never makes the gathered [m, kb, T, F] tensor.

The node-sharded hybrid (``difformer_tpu/ops/bsr.py:657-836``): block rows
cut into S row slices of ``rows_per`` (tile-aligned) rows over the padded
``pad_n = S · rows_per`` columns (:func:`build_bsr_gcn_sharded`, the JAX
package's numpy build, bit-equal, int8 counts on unweighted graphs). The
build holds every rank's :class:`BsrShard` stacked, as the JAX function
returns it; each rank keeps its own (:meth:`BsrShard.rank_shard`, on its
device, with the residual's K1 plan). :func:`bsr_spmm_sharded` all-gathers
x, runs K7 on the rank's rectangular shard (``rows_per`` rows from the
``pad_n`` gathered ones, the column and row scales apart) and adds the
residual by K1 over its rectangular plan; its backward all-gathers the
gradient and applies the reverse shard, scatter-free across ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from difformer_tpu_torch.kernels.bsr import bsr_spmm_blocks
from difformer_tpu_torch.kernels.ell import ell_spmm_rows
from difformer_tpu_torch.kernels.spmm import csr_spmm
from difformer_tpu_torch.ops import comm
from difformer_tpu_torch.ops.ell import EllGraph, _build_direction, _gcn_values
from difformer_tpu_torch.ops.graph_ops import CsrPlan, build_value_plan

# The gather cost of an edge as streaming-equivalent bytes: default_min_edges
# is then the edges at which a [T, T] block costs what their gathers cost.
# Measured by chip_smoke.py (phase ell-bsr-kernels) on an H100 80GB HBM3 at
# 700 W: K1's time per edge at Pokec's size (0.0865 ns at W = 64, float32)
# times the bytes of a 256 x 256 float32 block over K7's time per such block
# (175 ns at W = 64): 146. The JAX package's 6500 is a TPU v5e's (~8 ns an
# edge at ~800 GB/s).
_EDGE_EQUIV_BYTES = 146.0


def default_min_edges(tile: int, feat_bytes: int = 128,
                      block_elem_bytes: int = 4) -> int:
    """Edges a tile must hold before a dense block beats the gathers of its
    edges: the block's bytes (its T² values and a tile of x) over the
    gather-equivalent bytes of an edge."""
    block_bytes = tile * tile * block_elem_bytes + tile * feat_bytes
    return max(8, int(block_bytes / _EDGE_EQUIV_BYTES) + 1)


def _block_dtype(block_dtype) -> torch.dtype:
    """``block_dtype``, checked: the blocks' values are float32 or
    bfloat16."""
    if block_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"block_dtype must be torch.float32 or "
                         f"torch.bfloat16, got {block_dtype!r}")
    return block_dtype


def _blocks(host, dtype):
    """Host blocks (float32 values or int8 counts, numpy) as a tensor of
    ``dtype`` (values; int8 stays int8), rounded to nearest even."""
    t = torch.from_numpy(host)
    return t if t.dtype == torch.int8 else t.to(dtype)


@dataclasses.dataclass(frozen=True)
class BsrDirection:
    """One direction (owner ← point_to) of the padded hybrid."""

    blocks: torch.Tensor               # [Ntr, Kb, T, T]; zero on padding
    block_col: torch.Tensor            # int32 [Ntr, Kb]; 0 on padding
    residual: Optional[EllGraph]       # sparse-tile edges (K6)
    num_nodes: int = 0
    tile: int = 256

    def groups(self):
        """K7's groups: every row tile, in order."""
        return [(self.blocks, self.block_col, None)]

    def to(self, device) -> "BsrDirection":
        return dataclasses.replace(
            self, blocks=self.blocks.to(device),
            block_col=self.block_col.to(device),
            residual=None if self.residual is None
            else self.residual.to(device))


def _dense_tiles(point_to, owner, values, num_rows, num_cols, *, tile,
                 min_edges, max_blocks_per_row=None, fill_ones=False):
    """The tiles with ≥ ``min_edges`` edges as a tile-level ELL: (blocks
    [Ntr, Kb, T, T] numpy float32, or int8 counts with ``fill_ones``,
    block_col [Ntr, Kb], dense-edge mask [E]); ``max_blocks_per_row`` keeps
    each block row's densest tiles (``difformer_tpu/ops/bsr.py:78-168``)."""
    ntr = -(-num_rows // tile)
    ntc = -(-num_cols // tile)
    tr = owner // tile
    tc = point_to // tile
    key = tr.astype(np.int64) * ntc + tc
    nkeys = ntr * ntc
    if nkeys <= (1 << 26):
        counts = np.bincount(key, minlength=nkeys)
        dense_edge = counts[key] >= min_edges
        dkeys = np.flatnonzero(counts >= min_edges).astype(np.int64)
        dcounts = counts[dkeys]
        slot_lookup = np.zeros(nkeys, np.int64)
        edge_key = key
    else:
        uniq, inv, counts = np.unique(key, return_inverse=True,
                                      return_counts=True)
        dense_mask_u = counts >= min_edges
        dense_edge = dense_mask_u[inv]
        dkeys = uniq[dense_mask_u]
        dcounts = counts[dense_mask_u]
        slot_lookup = np.zeros(uniq.size, np.int64)
        edge_key = inv

    dtr = (dkeys // ntc).astype(np.int64)
    if (max_blocks_per_row is not None and dkeys.size
            and np.bincount(dtr, minlength=ntr).max() > max_blocks_per_row):
        order = np.lexsort((-dcounts, dtr))          # rows asc, count desc
        dtr_sorted = dtr[order]
        row_first = np.searchsorted(dtr_sorted, dtr_sorted)
        keep = (np.arange(order.size) - row_first) < max_blocks_per_row
        kept_keys = np.sort(dkeys[order[keep]])
        if nkeys <= (1 << 26):
            kmask = np.zeros(nkeys, bool)
            kmask[kept_keys] = True
            dense_edge = kmask[key]
            dkeys = kept_keys
        else:
            kmask = np.isin(uniq, kept_keys)
            dense_edge = kmask[inv]
            dense_mask_u = kmask
            dkeys = uniq[kmask]
        dtr = (dkeys // ntc).astype(np.int64)

    dtc = (dkeys % ntc).astype(np.int64)
    per_row = np.bincount(dtr, minlength=ntr)
    kb = int(per_row.max()) if dkeys.size else 0
    kb1 = max(kb, 1)
    out_dtype = np.int8 if fill_ones else np.float32
    block_col = np.zeros((ntr, kb1), np.int32)
    if not dkeys.size:
        return np.zeros((ntr, kb1, tile, tile), out_dtype), block_col, \
            dense_edge
    row_start = np.zeros(ntr + 1, np.int64)
    np.add.at(row_start, dtr + 1, 1)
    row_start = np.cumsum(row_start)
    slot = np.arange(dkeys.size) - row_start[dtr]
    block_col[dtr, slot] = dtc.astype(np.int32)
    if nkeys <= (1 << 26):
        slot_lookup[dkeys] = slot
    else:
        slot_lookup[dense_mask_u] = slot
    e = dense_edge
    flat = ((tr[e].astype(np.int64) * kb1 + slot_lookup[edge_key[e]]) * tile
            + owner[e] % tile) * tile + point_to[e] % tile
    blocks = _fill_blocks_flat(
        flat, None if fill_ones else values[e],
        ntr * kb1 * tile * tile, out_dtype,
    ).reshape(ntr, kb1, tile, tile)
    return blocks, block_col, dense_edge


def _build_bsr_direction(point_to, owner, values, num_nodes, *, tile,
                         min_edges, block_dtype=torch.float32,
                         max_blocks_per_row=None):
    """``out[owner] = Σ values · x[point_to]``, owner-tiled
    (``difformer_tpu/ops/bsr.py:171-192``)."""
    blocks, block_col, dense_edge = _dense_tiles(
        point_to, owner, values, num_nodes, num_nodes,
        tile=tile, min_edges=min_edges,
        max_blocks_per_row=max_blocks_per_row)
    r = ~dense_edge
    residual = None
    if r.any():
        residual = _build_direction(point_to[r], owner[r], values[r],
                                    num_nodes, min_bucket=8)
    return BsrDirection(blocks=_blocks(blocks, block_dtype),
                        block_col=torch.from_numpy(block_col),
                        residual=residual, num_nodes=num_nodes, tile=tile)


def build_bsr_gcn(senders, receivers, num_nodes, edge_weight=None, *,
                  tile=256, min_edges=None, block_dtype=torch.float32,
                  block_budget_bytes=1.5 * 2 ** 30):
    """(forward, reverse) padded hybrids of the reference-normalised GCN
    adjacency for :func:`bsr_spmm` (``difformer_tpu/ops/bsr.py:195-249``).
    ``block_dtype`` float32 or bfloat16 (the values summed in float32 and
    rounded once); ``block_budget_bytes`` caps each direction's padded
    block array by a per-row tile cap. The residual ELL's buckets start at
    width 8, as the JAX package's default."""
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    dtype = _block_dtype(block_dtype)
    if min_edges is None:
        min_edges = default_min_edges(tile, block_elem_bytes=dtype.itemsize)
    ntr = -(-num_nodes // tile)
    kb_cap = None
    if block_budget_bytes:
        per_slice = ntr * tile * tile * dtype.itemsize
        kb_cap = max(1, int(block_budget_bytes // per_slice))
    val = _gcn_values(senders, receivers, num_nodes, edge_weight)
    return tuple(
        _build_bsr_direction(p, o, val, num_nodes, tile=tile,
                             min_edges=min_edges, block_dtype=dtype,
                             max_blocks_per_row=kb_cap)
        for p, o in ((senders, receivers), (receivers, senders)))


# block counts of a row tile's bucket rungs (``difformer_tpu/ops/bsr.py:
# 292-301``): each row tile pads its blocks up to the next rung
_KB_LADDER = (4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384,
              512, 768, 1024, 1536, 2048)


class _Int8CountOverflow(Exception):
    """A dense tile held >127 parallel edges: int8 counts would wrap."""


def _fill_blocks_flat(flat, values, size, block_dtype):
    """A fresh [size] numpy array of ``block_dtype`` holding the sums of
    ``values`` (or the edge counts, ``values`` None) at the int64 ``flat``
    indices: a sort, ``add.reduceat`` and one sorted assignment
    (``difformer_tpu/ops/bsr.py:314-340``); raises
    :class:`_Int8CountOverflow` above 127 edges at one index."""
    if flat.size == 0:
        return np.zeros(size, block_dtype)
    order = np.argsort(flat, kind="stable")
    fs = flat[order]
    starts = np.flatnonzero(np.concatenate(([True], fs[1:] != fs[:-1])))
    uniq = fs[starts]
    if values is None:
        sums = np.diff(np.append(starts, fs.size))
        if sums.size and sums.max() > 127:
            raise _Int8CountOverflow(">127 parallel edges in a dense tile")
    else:
        sums = np.add.reduceat(values[order], starts)
    out = np.zeros(size, block_dtype)
    out[uniq] = sums.astype(block_dtype)
    return out


@dataclasses.dataclass(frozen=True)
class BsrBuckets:
    """One direction of the hybrid with Kb-bucketed dense blocks
    (``difformer_tpu/ops/bsr.py:343-374``): per bucket, blocks
    [m_b, kb_b, T, T], ``block_col`` int32 [m_b, kb_b] (0 on padding) and
    the bucket's row tiles ``row_tiles`` int32 [m_b]; ``inv_scale``, the
    [N] float32 inverse square-root in-degrees when the blocks are int8
    edge counts (None when they hold values). ``empty_tiles`` (int32) are
    the row tiles without a block, which K7 writes 0."""

    blocks: tuple
    block_col: tuple
    row_tiles: tuple
    residual: Optional[EllGraph]
    empty_tiles: torch.Tensor
    inv_scale: Optional[torch.Tensor] = None
    num_nodes: int = 0
    tile: int = 256

    def groups(self):
        """K7's groups: each bucket, then the row tiles without a block."""
        groups = list(zip(self.blocks, self.block_col, self.row_tiles))
        if self.empty_tiles.numel():
            groups.append((None, None, self.empty_tiles))
        return groups

    def to(self, device) -> "BsrBuckets":
        move = lambda ts: tuple(t.to(device) for t in ts)  # noqa: E731
        return dataclasses.replace(
            self, blocks=move(self.blocks), block_col=move(self.block_col),
            row_tiles=move(self.row_tiles),
            residual=None if self.residual is None
            else self.residual.to(device),
            empty_tiles=self.empty_tiles.to(device),
            inv_scale=None if self.inv_scale is None
            else self.inv_scale.to(device))


def _build_bucketed_direction(point_to, owner, values, num_nodes, *, tile,
                              min_edges, block_dtype=torch.float32,
                              budget_bytes=None, inv_scale=None):
    """``out[owner] = Σ values · x[point_to]`` with Kb-bucketed dense tiles
    (``difformer_tpu/ops/bsr.py:377-474``); int8 counts with ``inv_scale``.
    Returns (direction, dense-edge mask)."""
    use_int8 = inv_scale is not None
    elem_bytes = 1 if use_int8 else block_dtype.itemsize
    ntr = -(-num_nodes // tile)
    tr = (owner // tile).astype(np.int64)
    tc = (point_to // tile).astype(np.int64)
    key = tr * ntr + tc
    counts = np.bincount(key, minlength=ntr * ntr)
    dkeys = np.flatnonzero(counts >= min_edges).astype(np.int64)
    if budget_bytes is not None and dkeys.size:
        per_tile = tile * tile * elem_bytes
        max_tiles = max(int(budget_bytes // per_tile), 0)
        if dkeys.size > max_tiles:
            keep = np.argsort(-counts[dkeys], kind="stable")[:max_tiles]
            dkeys = np.sort(dkeys[keep])
    kmask = np.zeros(ntr * ntr, bool)
    kmask[dkeys] = True
    dense_edge = kmask[key]

    buckets = []
    covered = np.zeros(ntr, bool)
    if dkeys.size:
        dtr = dkeys // ntr
        dtc = dkeys % ntr
        per_row = np.bincount(dtr, minlength=ntr)
        # the ladder capped at ntr, so every row tile lands on a rung
        ladder = tuple(rung for rung in _KB_LADDER if rung < ntr) + (ntr,)
        rung = np.searchsorted(ladder, per_row, side="left")
        row_start = np.zeros(ntr + 1, np.int64)
        np.add.at(row_start, dtr + 1, 1)
        row_start = np.cumsum(row_start)
        slot_of = np.arange(dkeys.size) - row_start[dtr]
        slot_lookup = np.zeros(ntr * ntr, np.int64)
        slot_lookup[dkeys] = slot_of
        e = np.flatnonzero(dense_edge)
        e_tr = tr[e]
        e_slot = slot_lookup[key[e]]
        for li, kb in enumerate(ladder):
            rows = np.flatnonzero((rung == li) & (per_row > 0))
            if rows.size == 0:
                continue
            covered[rows] = True
            kb = int(min(kb, ntr))
            m = rows.size
            pos_of_row = np.full(ntr, -1, np.int64)
            pos_of_row[rows] = np.arange(m)
            bcol = np.zeros((m, kb), np.int32)
            sel = (rung[dtr] == li)
            bcol[pos_of_row[dtr[sel]], slot_of[sel]] = dtc[sel].astype(
                np.int32)
            esel = rung[e_tr] == li
            eb = e[esel]
            flat = ((pos_of_row[e_tr[esel]].astype(np.int64) * kb
                     + e_slot[esel]) * tile
                    + owner[eb] % tile) * tile + point_to[eb] % tile
            blocks = _fill_blocks_flat(
                flat, None if use_int8 else values[eb],
                m * kb * tile * tile,
                np.int8 if use_int8 else np.float32,
            ).reshape(m, kb, tile, tile)
            buckets.append((_blocks(blocks, block_dtype),
                            torch.from_numpy(bcol),
                            torch.from_numpy(rows.astype(np.int32))))

    r = ~dense_edge
    residual = None
    if r.any():
        residual = _build_direction(point_to[r], owner[r], values[r],
                                    num_nodes, min_bucket=8)
    return BsrBuckets(
        blocks=tuple(b[0] for b in buckets),
        block_col=tuple(b[1] for b in buckets),
        row_tiles=tuple(b[2] for b in buckets),
        residual=residual,
        empty_tiles=torch.from_numpy(
            np.flatnonzero(~covered).astype(np.int32)),
        inv_scale=(torch.from_numpy(np.asarray(inv_scale, np.float32))
                   if use_int8 else None),
        num_nodes=num_nodes,
        tile=tile,
    ), dense_edge


# How far above default_min_edges the bucketed layout's breakeven sits.
# Measured by chip_smoke.py (phase ell-bsr-kernels) on an H100 80GB HBM3 at
# 700 W: K7's time per 256 x 256 int8-count block (128 ns at W = 64) over
# K1's time per edge, divided by default_min_edges(256, block_elem_bytes=1):
# 2.2. The JAX package's 2.5 is a TPU v5e calibration (a min_edges sweep of
# the powerlaw train step).
_BUCKETED_BREAKEVEN_SCALE = 2.2


def bucketed_min_edges(tile: int, block_elem_bytes: int = 4) -> int:
    """The occupancy threshold of the bucketed layout."""
    return int(default_min_edges(tile, block_elem_bytes=block_elem_bytes)
               * _BUCKETED_BREAKEVEN_SCALE)


def build_bsr_bucketed_gcn(senders, receivers, num_nodes, edge_weight=None,
                           *, tile=256, min_edges=None,
                           block_dtype=torch.float32,
                           budget_bytes=2.5 * 2 ** 30, scaled_int8="auto"):
    """(forward, reverse) Kb-bucketed hybrids of the reference-normalised
    GCN adjacency (``difformer_tpu/ops/bsr.py:491-565``). ``scaled_int8``:
    "auto" stores int8 edge counts with the rank-1 scaling on unweighted
    graphs (falling back to value blocks where a tile holds more than 127
    parallel edges), True forces it (raises on a weighted graph), False
    keeps values; ``budget_bytes`` caps each direction's kept blocks."""
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    dtype = _block_dtype(block_dtype)
    if scaled_int8 == "auto":
        scaled_int8 = edge_weight is None
    elif scaled_int8 and edge_weight is not None:
        raise ValueError("scaled_int8 requires an unweighted graph "
                         "(weighted tiles are not rank-1)")
    elem = 1 if scaled_int8 else dtype.itemsize
    if min_edges is None:
        min_edges = bucketed_min_edges(tile, block_elem_bytes=elem)
    val = _gcn_values(senders, receivers, num_nodes, edge_weight)
    inv = None
    if scaled_int8:
        deg = np.bincount(receivers, minlength=num_nodes).astype(np.float64)
        with np.errstate(divide="ignore"):
            inv = np.sqrt(1.0 / deg)
        inv = np.nan_to_num(inv, nan=0.0, posinf=0.0).astype(np.float32)

    def build(p, o):
        nonlocal min_edges
        try:
            return _build_bucketed_direction(
                p, o, val, num_nodes, tile=tile, min_edges=min_edges,
                block_dtype=dtype, budget_bytes=budget_bytes, inv_scale=inv)
        except _Int8CountOverflow:
            # a multigraph: value blocks at the value bytes' threshold
            min_edges = bucketed_min_edges(
                tile, block_elem_bytes=dtype.itemsize)
            return _build_bucketed_direction(
                p, o, val, num_nodes, tile=tile, min_edges=min_edges,
                block_dtype=dtype, budget_bytes=budget_bytes)

    fwd, _ = build(senders, receivers)
    rev, _ = build(receivers, senders)
    return fwd, rev


def bsr_matvec(d, x, *, transposed=False):
    """One direction of a hybrid (:class:`BsrDirection` or
    :class:`BsrBuckets`) applied to x [N, W]: K7 over its row tiles, then K6
    adding the residual on the raw x, in place. ``transposed`` names the
    launches (the backward's direction)."""
    scale = getattr(d, "inv_scale", None)
    out = bsr_spmm_blocks(x, d.groups(), d.tile, scale=scale,
                          transposed=transposed)
    if d.residual is not None:
        out = ell_spmm_rows(x, d.residual, add_to=out,
                            transposed=transposed)
    return out


class BsrSpmm(torch.autograd.Function):
    """``Â @ x`` over the forward hybrid; the backward applies the reverse
    hybrid to the cotangent. The layouts are data: no gradient."""

    @staticmethod
    def forward(ctx, x, fwd, rev):
        ctx.rev = rev
        return bsr_matvec(fwd, x)

    @staticmethod
    def backward(ctx, g):
        return bsr_matvec(ctx.rev, g.contiguous(), transposed=True), \
            None, None


def bsr_spmm(fwd, rev, x):
    """``Â @ x`` for x [N, ...] through the hybrid (padded or bucketed:
    ``bsr_spmm`` and ``bsr_bucketed_spmm`` of the JAX package); the
    backward applies ``rev``."""
    n = x.shape[0]
    return BsrSpmm.apply(x.reshape(n, -1), fwd, rev).reshape(x.shape)


#: The JAX package's name of the bucketed product: the same Function here.
bsr_bucketed_spmm = bsr_spmm


@dataclasses.dataclass(frozen=True)
class BsrShard:
    """One direction of the node-sharded hybrid (``difformer_tpu/ops/bsr.py:
    662-687``). As :func:`build_bsr_gcn_sharded` returns it, every tensor
    has a leading axis of the S shards (host tensors, the JAX package's
    leaves); a rank's own (:meth:`rank_shard`) drops it. A shard owns
    ``num_rows`` (rows_per) output rows; ``block_col`` and ``res_point``
    index the ``num_cols`` (pad_n) columns of the all-gathered operand.

    - ``blocks`` f32 values or int8 counts [Ntr_loc, Kb, T, T], ``block_col``
      int32 [Ntr_loc, Kb] (0 on padding);
    - the residual: ``res_point`` int32 [Er] (0 on padding), ``res_owner``
      int32 [Er] local rows, sorted (rows_per − 1 on padding), ``res_val``
      f32 [Er] (0 on padding);
    - int8 counts: ``inv_rows`` [rows_per], the shard's inverse
      square-root in-degrees, and ``inv_cols`` [pad_n], all of them (the
      JAX package replicates it per shard); both None for value blocks.

    A rank's shard also holds ``axis_name`` (the graph axis's process
    group) and ``plan``, the residual's rectangular K1 plan (rows_per rows
    over pad_n columns) with the padding's zero entries kept, so that a NaN
    in x spreads as in the JAX package."""

    blocks: torch.Tensor
    block_col: torch.Tensor
    res_point: torch.Tensor
    res_owner: torch.Tensor
    res_val: torch.Tensor
    inv_rows: Optional[torch.Tensor] = None
    inv_cols: Optional[torch.Tensor] = None
    num_rows: int = 0
    num_cols: int = 0
    tile: int = 256
    axis_name: object = None
    plan: Optional[CsrPlan] = None

    def rank_shard(self, rank, axis_name, device=None) -> "BsrShard":
        """Shard ``rank``'s own direction on ``device`` (the GPU unless
        told otherwise), with its residual's K1 plan, for the group
        ``axis_name``."""
        from difformer_tpu_torch.utils.device import resolve_device

        dev = resolve_device(device)
        take = lambda t: None if t is None else t[rank].to(dev)  # noqa: E731
        local = dataclasses.replace(
            self, blocks=take(self.blocks), block_col=take(self.block_col),
            res_point=take(self.res_point), res_owner=take(self.res_owner),
            res_val=take(self.res_val), inv_rows=take(self.inv_rows),
            inv_cols=take(self.inv_cols), axis_name=axis_name)
        return dataclasses.replace(local, plan=build_value_plan(
            local.res_val, local.res_point.long(), local.res_owner.long(),
            self.num_rows, self.num_cols))

    def groups(self):
        """K7's groups: every row tile of the shard, in order."""
        return [(self.blocks, self.block_col, None)]


def build_bsr_gcn_sharded(senders, receivers, num_nodes, n_shards, *,
                          tile=256, min_edges=None, edge_weight=None,
                          axis_name=None, scaled_int8="auto"):
    """The hybrid cut into ``n_shards`` row slices (``difformer_tpu/ops/
    bsr.py:690-778``): ``(fwd, rev, rows_per)``, each direction a
    :class:`BsrShard` of host tensors stacked over the shards (each rank
    takes its own with :meth:`BsrShard.rank_shard`). Nodes are padded to
    ``n_shards · rows_per`` (rows_per tile-aligned); features are sharded
    with the same padding. ``scaled_int8``: "auto" stores int8 edge counts
    on unweighted graphs, rebuilding with value blocks where a tile holds
    more than 127 parallel edges."""
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    if scaled_int8 == "auto":
        scaled_int8 = edge_weight is None
    elif scaled_int8 and edge_weight is not None:
        raise ValueError("scaled_int8 requires an unweighted graph")
    if min_edges is None:
        min_edges = default_min_edges(
            tile, block_elem_bytes=1 if scaled_int8 else 4)
    val = _gcn_values(senders, receivers, num_nodes, edge_weight)

    rows_per = -(-num_nodes // (n_shards * tile)) * tile
    pad_n = rows_per * n_shards

    inv_pad = None
    if scaled_int8:
        deg = np.bincount(receivers, minlength=num_nodes).astype(np.float64)
        with np.errstate(divide="ignore"):
            inv = np.sqrt(1.0 / deg)
        inv = np.nan_to_num(inv, nan=0.0, posinf=0.0).astype(np.float32)
        inv_pad = np.zeros(pad_n, np.float32)
        inv_pad[:num_nodes] = inv

    def build_dir(point_to, owner):
        shards, n_res = [], []
        for sh in range(n_shards):
            m = (owner // rows_per) == sh
            blocks, block_col, dense_edge = _dense_tiles(
                point_to[m], owner[m] - sh * rows_per, val[m],
                rows_per, pad_n, tile=tile, min_edges=min_edges,
                fill_ones=scaled_int8)
            r = ~dense_edge
            shards.append((blocks, block_col, point_to[m][r],
                           (owner[m] - sh * rows_per)[r], val[m][r]))
            n_res.append(int(r.sum()))
        kb = max(part[1].shape[1] for part in shards)
        er = max(max(n_res), 1)
        out = []
        for blocks, block_col, rp, ro, rv in shards:
            pk = kb - block_col.shape[1]
            if pk:
                blocks = np.pad(blocks, ((0, 0), (0, pk), (0, 0), (0, 0)))
                block_col = np.pad(block_col, ((0, 0), (0, pk)))
            order = np.argsort(ro, kind="stable")
            rp, ro, rv = rp[order], ro[order], rv[order]
            pe = er - rp.shape[0]
            rp = np.pad(rp.astype(np.int32), (0, pe))
            ro = np.pad(ro.astype(np.int32), (0, pe),
                        constant_values=rows_per - 1)
            rv = np.pad(rv.astype(np.float32), (0, pe))
            out.append((blocks, block_col, rp, ro, rv))
        stack = [torch.from_numpy(np.stack([o[i] for o in out]))
                 for i in range(5)]
        inv_kw = {}
        if scaled_int8:
            inv_kw = dict(
                inv_rows=torch.from_numpy(inv_pad.reshape(n_shards,
                                                          rows_per)),
                inv_cols=torch.from_numpy(
                    np.broadcast_to(inv_pad, (n_shards, pad_n)).copy()))
        return BsrShard(blocks=stack[0], block_col=stack[1],
                        res_point=stack[2], res_owner=stack[3],
                        res_val=stack[4], **inv_kw, num_rows=rows_per,
                        num_cols=pad_n, tile=tile, axis_name=axis_name)

    try:
        fwd = build_dir(senders, receivers)
        rev = build_dir(receivers, senders)
    except _Int8CountOverflow:
        # a multigraph (>127 parallel edges in one tile): value blocks
        return build_bsr_gcn_sharded(
            senders, receivers, num_nodes, n_shards, tile=tile,
            min_edges=None, edge_weight=edge_weight, axis_name=axis_name,
            scaled_int8=False)
    return fwd, rev, rows_per


def bsr_shard_apply(d: BsrShard, x_full, *, transposed=False):
    """A rank's rows [rows_per, W] of one direction applied to the gathered
    operand ``x_full`` [pad_n, W] (``_bsr_shard_apply``): K7 on the
    rectangular shard, then the residual by K1 on the raw operand (its
    values are scaled at build time). ``transposed`` names the launches
    (the backward's direction)."""
    if d.plan is None:
        raise ValueError("a BsrShard of every shard: take the rank's own "
                         "with rank_shard(rank, group, device)")
    out = bsr_spmm_blocks(x_full, d.groups(), d.tile, transposed=transposed,
                          num_rows=d.num_rows, row_scale=d.inv_rows,
                          col_scale=d.inv_cols)
    p = d.plan
    return out + csr_spmm(x_full, p.row_ptr, p.col, p.val, split=p.split,
                          transposed=transposed)


class BsrSpmmSharded(torch.autograd.Function):
    """The rank's rows of ``Â @ x``: x all-gathered, then the forward
    shard; the backward all-gathers the gradient and applies the reverse
    shard (``difformer_tpu/ops/bsr.py:814-836``). The shards are data: no
    gradient."""

    @staticmethod
    def forward(ctx, x, fwd, rev):
        ctx.rev = rev
        return bsr_shard_apply(fwd, comm.gather_raw(x, fwd.axis_name))

    @staticmethod
    def backward(ctx, g):
        rev = ctx.rev
        return bsr_shard_apply(rev, comm.gather_raw(g, rev.axis_name),
                               transposed=True), None, None


def bsr_spmm_sharded(fwd: BsrShard, rev: BsrShard, x):
    """This rank's rows of ``Â @ x`` for its rows x [rows_per, ...] (every
    trailing dim in one product) over the rank's shards ``fwd`` and
    ``rev`` (:meth:`BsrShard.rank_shard`), whose group is the graph axis."""
    n = x.shape[0]
    if n != fwd.num_rows:
        raise ValueError(f"x has {n} rows; the shard owns {fwd.num_rows}")
    return BsrSpmmSharded.apply(x.reshape(n, -1), fwd, rev).reshape(
        x.shape)


def _tile_stats(senders, receivers, num_nodes, *, tile=256, min_edges=None):
    """(edge coverage, qualifying-tile count) of the dense-tile partition
    (``difformer_tpu/ops/bsr.py:839-851``)."""
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    if senders.size == 0:
        return 0.0, 0
    if min_edges is None:
        min_edges = default_min_edges(tile)
    nt = -(-num_nodes // tile)
    key = (receivers // tile).astype(np.int64) * nt + senders // tile
    _, inv, counts = np.unique(key, return_inverse=True, return_counts=True)
    keep = counts >= min_edges
    return float(keep[inv].mean()), int(keep.sum())


def dense_coverage(senders, receivers, num_nodes, *, tile=256,
                   min_edges=None):
    """The share of edges that would land in dense tiles."""
    return _tile_stats(senders, receivers, num_nodes, tile=tile,
                       min_edges=min_edges)[0]


def degree_sorted_order(senders, receivers, num_nodes):
    """The hub-clustering relabelling: ``perm[g]`` is node g's rank by
    descending total degree (``locality_reorder(..., "degree")``)."""
    from difformer_tpu_torch.data.transforms import locality_reorder

    ei = np.stack([np.asarray(senders), np.asarray(receivers)])
    return locality_reorder(ei, num_nodes, method="degree")


def choose_spmm(senders, receivers, num_nodes, *, tile=256,
                coverage_threshold=0.3, try_degree_sort=True,
                budget_bytes=2.5 * 2 ** 30, block_elem_bytes=1):
    """("bsr" | "bsr-sorted" | "ell", coverage), as the JAX package elects
    (``difformer_tpu/ops/bsr.py:881-914``): "bsr" when enough of the graph
    is tile-dense and its tiles fit the budget, "bsr-sorted" when it is so
    only over budget or only after the hub-clustering relabelling, else
    "ell"; with this card's cost model."""
    cov, n_tiles = _tile_stats(senders, receivers, num_nodes, tile=tile)
    blocks_bytes = n_tiles * tile * tile * block_elem_bytes
    if cov >= coverage_threshold:
        if blocks_bytes <= budget_bytes or not try_degree_sort:
            return "bsr", cov
        return "bsr-sorted", cov
    if try_degree_sort:
        perm = degree_sorted_order(senders, receivers, num_nodes)
        cov_sorted, _ = _tile_stats(
            perm[np.asarray(senders)], perm[np.asarray(receivers)],
            num_nodes, tile=tile)
        if cov_sorted >= coverage_threshold:
            return "bsr-sorted", cov_sorted
    return "ell", cov
