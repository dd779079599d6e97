"""CSR SpMM for the GCN branch (K1): the CUDA kernel, its split schedule,
its plain version and the autograd Function around them.

The JAX package has no kernel here: ``gcn_conv`` and ``spmm``
(``difformer_tpu/ops/graph_ops.py:107-112``, ``:233-236``) gather
``x[senders]``, scale by the edge values and ``segment_sum`` into the
receivers, and XLA differentiates the gather into a scatter. On the H100
hand-written kernels in ``csrc/spmm.cu`` compute

    out[r, :] = Σ_{e in row r} val[e] · x[col[e], :]

over a CSR of rows (``row_ptr`` int32 [R + 1], ``col`` int32 [E], ``val``
float32 [E]), with each output written once: no atomics, so it is deterministic
(``index_add_`` on CUDA is not). x and out are float32, or bfloat16 for the
model at ``compute_dtype="bfloat16"``: then the kernel loads bf16 (8 values a
lane), sums in f32 and rounds each output to bf16 once. That differs from the
JAX package, which rounds every message to bf16 and sums in bf16
(``graph_ops.py:107-112``, ``:233-236``): one rounding of the f32 sum is the
more accurate result, and the port keeps it rather than imitate bf16 sums
(ROADMAP.md queue C). The forward runs it over the receivers' CSR and the
backward over the transposed one (the senders' rows), so ``dx[s] = Σ_{e: send_e
= s} val[e] · dout[recv_e]``. Both CSRs, each with its :class:`RowSplit`, come
from a plan built once per graph (``ops/graph_ops.py``, ``build_csr_plan``).
The values are data, unless the caller gives them as a tensor that requires a
gradient (GAT's attention, ``spmm``'s values): then the backward also runs
K1-dval, ``csr_spmm_dval_kernel`` of the same source, ``dval[e, h] =
<dout[row(e), h], x[col[e], h]>`` over the forward CSR for every head in one
launch, row by row as K1 (a group of lanes a row, or a segment of a row of
more than :data:`DVAL_SPLIT_THRESHOLD` edges, for one head; the row's
``dout`` loaded once, each value written once) (:func:`csr_spmm_dval`;
plain twin :func:`csr_spmm_dval_plain`, one gather of each side and a
row-wise sum in f32). It replaces XLA's autodiff of ``values * x[senders]``
(``difformer_tpu/ops/graph_ops.py:233-236``) and of GAT's ``feat[senders] *
att`` (``difformer_tpu/nn/gnns.py:183-184``), and is counted in
:data:`DVAL_LAUNCHES`. Where the values need no gradient (DIFFormer, the
temporal models, GCN) it is not launched.

Rows of very different degree: a group of lanes sums one run of edges, and
a row of more than :data:`SPLIT_THRESHOLD` (T) edges, a hub of a power-law
graph, would keep one group busy long after the rest of the card is done.
:func:`row_split` cuts each such heavy row into contiguous segments of at
most T edges; ``csr_spmm_kernel`` sums the segments into a workspace in its
first blocks and the light rows straight into ``out`` in the rest, and
``csr_spmm_combine`` sums each heavy row's segments in order. A row's sum
is so taken in CSR order within a segment, then over its segments in
order. The combine is launched only when there are heavy rows: on a graph
without them (every citation graph at this T) a call is one launch.

What bounds it on an H100: bytes (see the source's header). The compulsory
traffic is x and out once each, plus col, val and row_ptr; the gathered
rows, E·W·4 bytes, stay in L2 only while x is small, and beyond that set
the time (the gather floor of ``chip_smoke.spmm_gather_floor_ms``).

:func:`csr_spmm` runs the kernel on a CUDA tensor and counts the call in
:data:`LAUNCHES` (``csr_spmm`` for the forward CSR, ``csr_spmm_transposed``
for the transposed one), once per call with or without the combine; on a
CPU tensor it runs :func:`csr_spmm_plain`, the same sum over the same CSR
arrays in plain torch (one gather and one ``index_add_`` in f32, in chunks
of edges if asked, and one rounding to x's dtype), its exact twin at
either dtype. There is no fallback from the card to the plain version.
It reads nothing back from the device when given its schedule: whether and
how much it launches comes from tensor shapes and Python ints, so it can be
captured in a CUDA graph.

A graph replayed for graphs that change between replays (the mini-batch
trainer's chunk steps, ``train/minibatch.py``) needs grids that do not
depend on the data. Such a caller holds each CSR at a fixed edge capacity
(the row pointers end at the real edge count; the columns and values past
it are never read) and its schedule at the capacity of
:func:`split_capacity`, with ``RowSplit.counts``, a device array of the
real heavy-row and segment counts, which the kernel reads: blocks past them
exit. :func:`row_split_host` builds such a schedule on the host, equal to
:func:`row_split`'s, and :func:`padded_split` lays it out at capacity.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from difformer_tpu_torch.kernels.build import load_library
from difformer_tpu_torch.utils.device import on_cuda

#: Kernel launches since the last :func:`reset_launch_counts`, by wrapper
#: and direction.
LAUNCHES = {"csr_spmm": 0, "csr_spmm_transposed": 0}
#: K1-dval's launches since the last :func:`reset_launch_counts` (a count
#: of its own, so that the paths whose values take no gradient keep the
#: two counts above as they were).
DVAL_LAUNCHES = {"csr_spmm_dval": 0}

# the element types of x and out, by the code the C entry takes; the heavy
# rows' workspace and the values are float32 at either
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


#: T: a row of more than T edges is heavy and is summed in segments of at
#: most T edges. Chosen by a sweep on the card of 256, 512, 1024 and 2048
#: at Pokec's size with power-law degrees (``time_kernels.py --kernel spmm
#: --spmm-threshold``): the smallest was the fastest, as a light row of up
#: to T edges that starts in the last wave sets the tail. At least 256, so
#: that a citation graph, whose largest degree is in the tens or low
#: hundreds, never splits.
SPLIT_THRESHOLD = 256


#: K1-dval's T: its rows of more than T edges are walked in segments of at
#: most T edges, each by a group of lanes of its own (a :class:`RowSplit`
#: built with the plans whose values take a gradient,
#: ``CsrPlan.dval_split``). Smaller than K1's, as each of K1-dval's edges
#: ends in a reduction across the group, so a row's edges follow one
#: another (a popular neighbour of cifar10's kNN graph has 1322 edges).
#: From a sweep of T = 8 to 256 on the card at GAT's Cora and cifar10
#: plans, Pokec's power law and a hub graph (``time_kernels.py --kernel
#: dval --dval-threshold``; ``PERF.md`` §6): smaller T served the small
#: graphs, larger the big ones, and 16 was the one T at which no shape but
#: Cora's single head (slower at every T) was slower than the row-per-edge
#: kernel before it.
DVAL_SPLIT_THRESHOLD = 16


def reset_launch_counts():
    for counts in (LAUNCHES, DVAL_LAUNCHES):
        for name in counts:
            counts[name] = 0


@dataclasses.dataclass(frozen=True)
class RowSplit:
    """The split schedule of one CSR: its heavy rows (degree above
    ``threshold``), each cut into contiguous segments of at most
    ``threshold`` edges, in CSR order, of nearly equal length. The segments
    of heavy row ``rows[h]`` are ``seg_ptr[h]`` to ``seg_ptr[h + 1] - 1``;
    segment s covers the edges ``seg_begin[s]`` to ``seg_end[s] - 1``. All
    int32, on the CSR's device.

    With ``counts`` (int32 [2]: the heavy rows and segments in use) the
    arrays are held at a capacity of H and S entries, of which the first
    ``counts[0]`` and ``counts[1]`` count, and ``num_heavy`` and
    ``num_segments`` are the capacities: the kernel's grids are sized from
    them and its blocks read the real counts."""

    threshold: int
    rows: torch.Tensor       # int32 [H]
    seg_ptr: torch.Tensor    # int32 [H + 1]
    seg_begin: torch.Tensor  # int32 [S]
    seg_end: torch.Tensor    # int32 [S]
    counts: Optional[torch.Tensor] = None  # int32 [2], at capacity only

    @property
    def num_heavy(self):
        return self.rows.numel()

    @property
    def num_segments(self):
        return self.seg_begin.numel()

    def tensors(self):
        return self.rows, self.seg_ptr, self.seg_begin, self.seg_end


def row_split(row_ptr, threshold=None) -> RowSplit:
    """The :class:`RowSplit` of the CSR with row pointers ``row_ptr``
    (int32 [R + 1]) at ``threshold`` (default :data:`SPLIT_THRESHOLD`): a
    heavy row of d edges becomes ceil(d / T) segments. Reads the degrees
    back from the device, so it belongs with the plan, built once."""
    t = SPLIT_THRESHOLD if threshold is None else int(threshold)
    if t < 1:
        raise ValueError(f"the split threshold must be at least 1, got {t}")
    ptr = row_ptr.long()
    degrees = ptr[1:] - ptr[:-1]
    rows = torch.nonzero(degrees > t).flatten()
    counts = (degrees[rows] + t - 1) // t
    seg_ptr = torch.zeros(rows.numel() + 1, dtype=torch.int64,
                          device=ptr.device)
    seg_ptr[1:] = torch.cumsum(counts, 0)
    owner = torch.repeat_interleave(
        torch.arange(rows.numel(), device=ptr.device), counts)
    k = torch.arange(owner.numel(), device=ptr.device) - seg_ptr[owner]
    start, d, m = ptr[rows][owner], degrees[rows][owner], counts[owner]
    as32 = lambda a: a.to(torch.int32)  # noqa: E731
    return RowSplit(threshold=t, rows=as32(rows), seg_ptr=as32(seg_ptr),
                    seg_begin=as32(start + k * d // m),
                    seg_end=as32(start + (k + 1) * d // m))


def split_capacity(edges, threshold=None):
    """(H, S): the most heavy rows and segments that a CSR of at most
    ``edges`` edges can have at ``threshold`` (default
    :data:`SPLIT_THRESHOLD`). A heavy row has d > T edges and
    ⌈d/T⌉ < 2·d/T segments, so H ≤ E/(T+1) and S < 2·E/T."""
    t = SPLIT_THRESHOLD if threshold is None else int(threshold)
    return edges // (t + 1), 2 * edges // t + 1


def row_split_host(row_ptr, threshold=None):
    """:func:`row_split` on the host: (rows, seg_ptr, seg_begin, seg_end),
    int32 numpy arrays, for the CSR with row pointers ``row_ptr`` (numpy
    [R + 1]), equal to the device schedule's."""
    t = SPLIT_THRESHOLD if threshold is None else int(threshold)
    if t < 1:
        raise ValueError(f"the split threshold must be at least 1, got {t}")
    ptr = np.asarray(row_ptr, np.int64)
    degrees = ptr[1:] - ptr[:-1]
    rows = np.flatnonzero(degrees > t)
    counts = (degrees[rows] + t - 1) // t
    seg_ptr = np.zeros(rows.size + 1, np.int64)
    np.cumsum(counts, out=seg_ptr[1:])
    owner = np.repeat(np.arange(rows.size), counts)
    k = np.arange(owner.size) - seg_ptr[owner]
    start, d, m = ptr[rows][owner], degrees[rows][owner], counts[owner]
    as32 = lambda a: a.astype(np.int32)  # noqa: E731
    return (as32(rows), as32(seg_ptr), as32(start + k * d // m),
            as32(start + (k + 1) * d // m))


def padded_split(host_split, capacity, out):
    """Lay out a :func:`row_split_host` schedule at ``capacity`` (H, S, as
    :func:`split_capacity` gives) in ``out``, four int32 numpy arrays [H],
    [H + 1], [S], [S], and return its (heavy rows, segments): the values of
    ``RowSplit.counts``. Entries past the counts are left as they are."""
    rows, seg_ptr, begin, end = host_split
    h, s = rows.size, begin.size
    if h > capacity[0] or s > capacity[1]:
        raise ValueError(f"{h} heavy rows and {s} segments exceed the "
                         f"capacity {capacity}")
    for dst, src in zip(out, host_split):
        dst[:src.size] = src
    return h, s


def csr_spmm_plain(x, row_ptr, col, val, *, edge_chunk_size=None):
    """[R, W] of x's dtype: ``out[r] = Σ val[e]·x[col[e]]`` over the edges
    of row r, by a gather and an ``index_add_`` in float32, rounded to x's
    dtype once at the end (K1's rounding at bfloat16); with
    ``edge_chunk_size`` the [E, W] messages are made and summed that many
    edges at a time."""
    rows = row_ptr.numel() - 1
    out = torch.zeros((rows, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    degrees = (row_ptr[1:] - row_ptr[:-1]).long()
    row = torch.repeat_interleave(torch.arange(rows, device=x.device),
                                  degrees)
    e = col.numel()
    step = edge_chunk_size or max(e, 1)
    for lo in range(0, e, step):
        hi = min(e, lo + step)
        msg = x[col[lo:hi].long()].float() * val[lo:hi, None]
        out.index_add_(0, row[lo:hi], msg)
    return out.to(x.dtype)


def csr_spmm_abs(x, row_ptr, col, val, *, edge_chunk_size=None):
    """[R, W] of x's dtype: ``Σ |val[e]·x[col[e]]|`` over the edges of row
    r, the scale of float32's rounding of K1's sums (the "spmm" kind of
    ``kernels/tolerance.py``)."""
    return csr_spmm_plain(x.abs(), row_ptr, col, val.abs(),
                          edge_chunk_size=edge_chunk_size)


def _check(x, row_ptr, col, val):
    if x.dim() != 2:
        raise ValueError(f"x must be [rows, W], got {tuple(x.shape)}")
    if x.dtype not in _DTYPES or val.dtype != torch.float32:
        raise TypeError(f"csr_spmm takes float32 or bfloat16 x and float32 "
                        f"values, got {x.dtype}, {val.dtype}")
    if row_ptr.dtype != torch.int32 or col.dtype != torch.int32:
        raise TypeError(f"csr_spmm takes int32 row_ptr and col, got "
                        f"{row_ptr.dtype}, {col.dtype}")
    if (row_ptr.dim() != 1 or row_ptr.numel() < 1 or col.dim() != 1
            or val.shape != col.shape):
        raise ValueError(f"row_ptr must be [R+1], col and val [E]; got "
                         f"{tuple(row_ptr.shape)}, {tuple(col.shape)}, "
                         f"{tuple(val.shape)}")


def csr_spmm(x, row_ptr, col, val, *, split=None, transposed=False,
             edge_chunk_size=None):
    """K1. x [*, W] float32 or bfloat16 → out [R, W] of x's dtype for the CSR
    (``row_ptr`` [R+1], ``col`` [E], ``val`` [E]), whose columns index rows
    of x (``build_csr_plan`` checks its indices). ``split`` is the CSR's
    :class:`RowSplit` (the plan's ``split`` or ``t_split``); without one,
    a call on the card builds it, reading the degrees back. col and val
    may be longer than ``row_ptr[-1]``, a CSR held at a capacity: the
    entries past it are not read. ``transposed``
    names the launch (the backward's CSR) in :data:`LAUNCHES`;
    ``edge_chunk_size`` applies to the plain version only, as the kernel
    never makes the [E, W] messages."""
    _check(x, row_ptr, col, val)
    schedule = () if split is None else split.tensors()
    if split is not None and split.counts is not None:
        schedule += (split.counts,)
    if not on_cuda("csr_spmm", x, row_ptr, col, val, *schedule):
        end = int(row_ptr[-1])
        return csr_spmm_plain(x, row_ptr, col[:end], val[:end],
                              edge_chunk_size=edge_chunk_size)
    rows, width = row_ptr.numel() - 1, x.shape[1]
    if col.numel() == 0 or rows == 0 or width == 0:
        return torch.zeros((rows, width), dtype=x.dtype, device=x.device)
    if split is None:
        split = row_split(row_ptr)
    x, row_ptr = x.contiguous(), row_ptr.contiguous()
    col, val = col.contiguous(), val.contiguous()
    out = torch.empty((rows, width), dtype=x.dtype, device=x.device)
    ws = torch.empty((split.num_segments, width), dtype=torch.float32,
                     device=x.device)
    rc = load_library().csr_spmm(
        row_ptr.data_ptr(), col.data_ptr(), val.data_ptr(), x.data_ptr(),
        out.data_ptr(), rows, width, _DTYPES[x.dtype], split.threshold,
        *(t.data_ptr() for t in split.tensors()), split.num_heavy,
        split.num_segments,
        None if split.counts is None else split.counts.data_ptr(),
        ws.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"csr_spmm kernel launch failed: CUDA error {rc}")
    LAUNCHES["csr_spmm_transposed" if transposed else "csr_spmm"] += 1
    return out


def csr_spmm_dval_plain(dout, x, rows, col, *, edge_chunk_size=None):
    """float32 [E] for dout [R, W] and x [*, W], or [E, H] for dout
    [R, H, D] and x [*, H, D]: ``dval[e, h] = Σ_c dout[rows[e], h, c] ·
    x[col[e], h, c]``, one gather of each side and a row-wise sum in
    float32 (K1-dval's plain twin); with ``edge_chunk_size`` that many edges
    at a time."""
    e = col.numel()
    out = torch.empty((e,) + tuple(dout.shape[1:-1]), dtype=torch.float32,
                      device=dout.device)
    step = edge_chunk_size or max(e, 1)
    for lo in range(0, e, step):
        hi = min(e, lo + step)
        out[lo:hi] = (dout[rows[lo:hi].long()].float()
                      * x[col[lo:hi].long()].float()).sum(-1)
    return out


def csr_spmm_dval_abs(dout, x, rows, col, *, edge_chunk_size=None):
    """[E] or [E, H]: ``Σ_c |dout[rows[e], h, c] · x[col[e], h, c]|``, the
    scale of float32's rounding of K1-dval's sums (the "spmm" kind of
    ``kernels/tolerance.py``)."""
    return csr_spmm_dval_plain(dout.abs(), x.abs(), rows, col,
                               edge_chunk_size=edge_chunk_size)


def _heads_view(t):
    """t [R, W] or [R, H, D] as a [R, H, D] view whose columns are
    contiguous (a copy only where they are not)."""
    t = t.unsqueeze(1) if t.dim() == 2 else t
    return t if t.stride(2) == 1 else t.contiguous()


def csr_spmm_dval(dout, x, rows, col, *, row_ptr=None, split=None,
                  edge_chunk_size=None):
    """K1-dval: the gradient of K1's output with respect to its values, in
    the CSR's edge order. dout [R, W] and x [*, W] float32 → dval [E] with
    ``dval[e] = <dout[rows[e]], x[col[e]]>``; per head, dout [R, H, D] and
    x [*, H, D] → dval [E, H], every head in one launch, both read in place
    at their row and head strides. ``rows`` and ``col`` (int32 [E]) are the
    edges' rows and columns in CSR order, ``row_ptr`` (int32 [R + 1]) and
    ``split`` the CSR's row pointers and the :class:`RowSplit` its rows
    are walked by (the plan's ``dval_split``), which the kernel needs and
    the plain version does not read. On a CUDA tensor it launches
    ``csr_spmm_dval_kernel`` (one write a value, no atomics, nothing read
    back) and counts it in :data:`DVAL_LAUNCHES`, or raises without
    ``row_ptr`` and ``split``; on the CPU it runs
    :func:`csr_spmm_dval_plain` (``edge_chunk_size`` applies to it only)."""
    if (dout.dim() not in (2, 3) or x.dim() != dout.dim()
            or dout.shape[1:] != x.shape[1:]):
        raise ValueError(f"dout and x must be [rows, W] or [rows, H, D] of "
                         f"one width, got {tuple(dout.shape)}, "
                         f"{tuple(x.shape)}")
    if dout.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"csr_spmm_dval takes float32 dout and x, got "
                        f"{dout.dtype}, {x.dtype}")
    if rows.dtype != torch.int32 or col.dtype != torch.int32:
        raise TypeError(f"csr_spmm_dval takes int32 rows and col, got "
                        f"{rows.dtype}, {col.dtype}")
    if rows.shape != col.shape or col.dim() != 1:
        raise ValueError(f"rows and col must be [E], got "
                         f"{tuple(rows.shape)}, {tuple(col.shape)}")
    schedule = () if split is None else split.tensors()
    if split is not None and split.counts is not None:
        schedule += (split.counts,)
    extra = () if row_ptr is None else (row_ptr,)
    if not on_cuda("csr_spmm_dval", dout, x, rows, col, *extra, *schedule):
        return csr_spmm_dval_plain(dout, x, rows, col,
                                   edge_chunk_size=edge_chunk_size)
    if row_ptr is None or split is None:
        raise ValueError("csr_spmm_dval on the card needs the CSR's row_ptr "
                         "and its RowSplit (a plan's dval_split: "
                         "build_spmm_plan(..., value_grad=True))")
    e = col.numel()
    g3, x3 = _heads_view(dout), _heads_view(x)
    heads, width = g3.shape[1:]
    out = torch.empty((e, heads), dtype=torch.float32, device=x.device)
    if e and width:
        rows, col, row_ptr = (t.contiguous() for t in (rows, col, row_ptr))
        rc = load_library().csr_spmm_dval(
            row_ptr.data_ptr(), rows.data_ptr(), col.data_ptr(),
            g3.data_ptr(), x3.data_ptr(), out.data_ptr(),
            row_ptr.numel() - 1, heads, width, g3.stride(0), g3.stride(1),
            x3.stride(0), x3.stride(1), split.threshold,
            split.seg_begin.data_ptr(), split.seg_end.data_ptr(),
            split.num_segments,
            None if split.counts is None else split.counts.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"csr_spmm_dval kernel launch failed: CUDA "
                               f"error {rc}")
        DVAL_LAUNCHES["csr_spmm_dval"] += 1
    else:
        out.zero_()
    return out if dout.dim() == 3 else out.view(e)


def _stack_heads(outs):
    """[N, H, D] of the heads' [N, D] products (a view for one head)."""
    return outs[0].unsqueeze(1) if len(outs) == 1 else torch.stack(outs, 1)


def _head_values(values, order):
    """Per-call edge values [E] or [E, H], in the caller's edge order, as
    float32 [H, E] in the CSR order ``order``: one gather for all heads,
    each head's row contiguous, as K1 takes its values."""
    v = values.detach().float()
    return v.reshape(v.shape[0], -1).t().index_select(1, order)


class CsrSpmm(torch.autograd.Function):
    """``out = A @ x`` for ``fwd`` = (row_ptr, col, val, split), the CSR of
    A and its :class:`RowSplit`; the backward is ``dx = Aᵀ @ dout`` through
    the same kernel over ``bwd``, the CSR of Aᵀ and its split.

    With ``values`` ([E] or [E, H], in the edge order of the caller's plan),
    x [N, H, D] (H = 1 for [E] values) and ``maps`` = (order, t_order,
    inv_order, rows), the product takes these values instead of the CSRs'
    own, head h's ``values[:, h]`` for ``x[:, h]``: in CSR order
    (``order``) in the forward and in the transposed one (``t_order``) in
    the backward, one K1 launch a head each way. When ``values`` requires a
    gradient the backward also launches K1-dval once, for every head, over
    the forward CSR walked by ``dval_split`` (the plan's), on ``dout`` and
    x in place, and gathers its [E, H] result back to the caller's order by
    ``inv_order`` (a permutation: a gather, not an add); otherwise it
    launches exactly what it launches without values."""

    @staticmethod
    def forward(ctx, x, fwd, bwd, edge_chunk_size, values=None, maps=None,
                dval_split=None):
        ctx.bwd = bwd
        ctx.edge_chunk_size = edge_chunk_size
        ctx.maps = maps
        ctx.dval_split = dval_split
        row_ptr, col, val, split = fwd
        if values is None:
            return csr_spmm(x, row_ptr, col, val, split=split,
                            edge_chunk_size=edge_chunk_size)
        ctx.fwd = fwd
        want_dval = ctx.needs_input_grad[4]
        ctx.save_for_backward(values, x if want_dval else None)
        vals = _head_values(values, maps[0])
        return _stack_heads([
            csr_spmm(x[:, h], row_ptr, col, vals[h], split=split,
                     edge_chunk_size=edge_chunk_size)
            for h in range(x.shape[1])])

    @staticmethod
    def backward(ctx, g):
        row_ptr, col, val, split = ctx.bwd
        g = g.contiguous()
        kw = dict(edge_chunk_size=ctx.edge_chunk_size)
        dx = dval = None
        if ctx.maps is None:
            if ctx.needs_input_grad[0]:
                dx = csr_spmm(g, row_ptr, col, val, split=split,
                              transposed=True, **kw)
            return (dx, None, None, None)[:len(ctx.needs_input_grad)]
        values, x = ctx.saved_tensors
        _, t_order, inv_order, rows = ctx.maps
        if ctx.needs_input_grad[0]:
            vals = _head_values(values, t_order)
            dx = _stack_heads([csr_spmm(g[:, h], row_ptr, col, vals[h],
                                        split=split, transposed=True, **kw)
                               for h in range(g.shape[1])])
        if ctx.needs_input_grad[4]:
            f_row_ptr, f_col = ctx.fwd[:2]
            dval = csr_spmm_dval(g, x, rows, f_col, row_ptr=f_row_ptr,
                                 split=ctx.dval_split, **kw)
            dval = dval.index_select(0, inv_order).view(values.shape).to(
                values.dtype)
        return dx, None, None, None, dval, None, None
