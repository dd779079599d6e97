"""CSR SpMM for the GCN branch (K1): the CUDA kernel, its split schedule,
its plain version and the autograd Function around them.

The JAX package has no kernel here: ``gcn_conv`` and ``spmm``
(``difformer_tpu/ops/graph_ops.py:107-112``, ``:233-236``) gather
``x[senders]``, scale by the edge values and ``segment_sum`` into the
receivers, and XLA differentiates the gather into a scatter. On the H100
hand-written kernels in ``csrc/spmm.cu`` compute

    out[r, :] = Σ_{e in row r} val[e] · x[col[e], :]

over a CSR of rows (``row_ptr`` int32 [R + 1], ``col`` int32 [E],
``val`` float32 [E]), with each output written once: no atomics, so it is
deterministic (``index_add_`` on CUDA is not). The forward runs it over the
receivers' CSR and the backward over the transposed one (the senders'
rows), so ``dx[s] = Σ_{e: send_e = s} val[e] · dout[recv_e]``. Both CSRs,
each with its :class:`RowSplit`, come from a plan built once per graph
(``ops/graph_ops.py``, ``build_csr_plan``). The values are data and get no
gradient.

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
arrays in plain torch (one gather and one ``index_add_``, in chunks of
edges if asked). There is no fallback from the card to the plain version.
It reads nothing back from the device when given its schedule: whether and
how much it launches comes from tensor shapes and Python ints, so it can be
captured in a CUDA graph.
"""

from __future__ import annotations

import dataclasses

import torch

from difformer_tpu_torch.kernels.build import load_library
from difformer_tpu_torch.utils.device import on_cuda

#: Kernel launches since the last :func:`reset_launch_counts`, by wrapper
#: and direction.
LAUNCHES = {"csr_spmm": 0, "csr_spmm_transposed": 0}


#: T: a row of more than T edges is heavy and is summed in segments of at
#: most T edges. Chosen by a sweep on the card of 256, 512, 1024 and 2048
#: at Pokec's size with power-law degrees (``time_kernels.py --kernel spmm
#: --spmm-threshold``): the smallest was the fastest, as a light row of up
#: to T edges that starts in the last wave sets the tail. At least 256, so
#: that a citation graph, whose largest degree is in the tens or low
#: hundreds, never splits.
SPLIT_THRESHOLD = 256


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@dataclasses.dataclass(frozen=True)
class RowSplit:
    """The split schedule of one CSR: its heavy rows (degree above
    ``threshold``), each cut into contiguous segments of at most
    ``threshold`` edges, in CSR order, of nearly equal length. The segments
    of heavy row ``rows[h]`` are ``seg_ptr[h]`` to ``seg_ptr[h + 1] - 1``;
    segment s covers the edges ``seg_begin[s]`` to ``seg_end[s] - 1``. All
    int32, on the CSR's device."""

    threshold: int
    rows: torch.Tensor       # int32 [H]
    seg_ptr: torch.Tensor    # int32 [H + 1]
    seg_begin: torch.Tensor  # int32 [S]
    seg_end: torch.Tensor    # int32 [S]

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


def csr_spmm_plain(x, row_ptr, col, val, *, edge_chunk_size=None):
    """[R, W] float32: ``out[r] = Σ val[e]·x[col[e]]`` over the edges of
    row r, by a gather and an ``index_add_``; with ``edge_chunk_size`` the
    [E, W] messages are made and summed that many edges at a time."""
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
        msg = x[col[lo:hi].long()] * val[lo:hi, None]
        out.index_add_(0, row[lo:hi], msg)
    return out


def csr_spmm_abs(x, row_ptr, col, val, *, edge_chunk_size=None):
    """[R, W] float32: ``Σ |val[e]·x[col[e]]|`` over the edges of row r,
    the scale of float32's rounding of K1's sums (the "spmm" kind of
    ``kernels/tolerance.py``)."""
    return csr_spmm_plain(x.abs(), row_ptr, col, val.abs(),
                          edge_chunk_size=edge_chunk_size)


def _check(x, row_ptr, col, val):
    if x.dim() != 2:
        raise ValueError(f"x must be [rows, W], got {tuple(x.shape)}")
    if x.dtype != torch.float32 or val.dtype != torch.float32:
        raise TypeError(f"csr_spmm takes float32 x and values, got {x.dtype}, "
                        f"{val.dtype}")
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
    """K1. x [*, W] float32 → out [R, W] float32 for the CSR
    (``row_ptr`` [R+1], ``col`` [E], ``val`` [E]), whose columns index rows
    of x (``build_csr_plan`` checks its indices). ``split`` is the CSR's
    :class:`RowSplit` (the plan's ``split`` or ``t_split``); without one,
    a call on the card builds it, reading the degrees back. ``transposed``
    names the launch (the backward's CSR) in :data:`LAUNCHES`;
    ``edge_chunk_size`` applies to the plain version only, as the kernel
    never makes the [E, W] messages."""
    _check(x, row_ptr, col, val)
    schedule = () if split is None else split.tensors()
    if not on_cuda("csr_spmm", x, row_ptr, col, val, *schedule):
        return csr_spmm_plain(x, row_ptr, col, val,
                              edge_chunk_size=edge_chunk_size)
    rows, width = row_ptr.numel() - 1, x.shape[1]
    if col.numel() == 0 or rows == 0 or width == 0:
        return torch.zeros((rows, width), dtype=torch.float32,
                           device=x.device)
    if split is None:
        split = row_split(row_ptr)
    x, row_ptr = x.contiguous(), row_ptr.contiguous()
    col, val = col.contiguous(), val.contiguous()
    out = torch.empty((rows, width), dtype=torch.float32, device=x.device)
    ws = torch.empty((split.num_segments, width), dtype=torch.float32,
                     device=x.device)
    rc = load_library().csr_spmm(
        row_ptr.data_ptr(), col.data_ptr(), val.data_ptr(), x.data_ptr(),
        out.data_ptr(), rows, width, split.threshold,
        *(t.data_ptr() for t in split.tensors()), split.num_heavy,
        split.num_segments, ws.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"csr_spmm kernel launch failed: CUDA error {rc}")
    LAUNCHES["csr_spmm_transposed" if transposed else "csr_spmm"] += 1
    return out


class CsrSpmm(torch.autograd.Function):
    """``out = A @ x`` for ``fwd`` = (row_ptr, col, val, split), the CSR of
    A and its :class:`RowSplit`; the backward is ``dx = Aᵀ @ dout`` through
    the same kernel over ``bwd``, the CSR of Aᵀ and its split. Only x gets a
    gradient."""

    @staticmethod
    def forward(ctx, x, fwd, bwd, edge_chunk_size):
        ctx.bwd = bwd
        ctx.edge_chunk_size = edge_chunk_size
        row_ptr, col, val, split = fwd
        return csr_spmm(x, row_ptr, col, val, split=split,
                        edge_chunk_size=edge_chunk_size)

    @staticmethod
    def backward(ctx, g):
        row_ptr, col, val, split = ctx.bwd
        dx = csr_spmm(g.contiguous(), row_ptr, col, val, split=split,
                      transposed=True, edge_chunk_size=ctx.edge_chunk_size)
        return dx, None, None, None
