"""CSR SpMM for the GCN branch (K1): the CUDA kernel, its plain version and
the autograd Function around them.

The JAX package has no kernel here: ``gcn_conv`` and ``spmm``
(``difformer_tpu/ops/graph_ops.py:107-112``, ``:233-236``) gather
``x[senders]``, scale by the edge values and ``segment_sum`` into the
receivers, and XLA differentiates the gather into a scatter. On the H100 one
hand-written kernel, ``csr_spmm_kernel`` in ``csrc/spmm.cu``, computes

    out[r, :] = Σ_{e in row r} val[e] · x[col[e], :]

over a CSR of rows (``row_ptr`` int32 [R + 1], ``col`` int32 [E],
``val`` float32 [E]), with each row's edges summed in CSR order in f32
registers and each output written once: no atomics, so it is deterministic
(``index_add_`` on CUDA is not). The forward runs it over the receivers'
CSR and the backward over the transposed one (the senders' rows), so
``dx[s] = Σ_{e: send_e = s} val[e] · dout[recv_e]``. Both CSRs come from a
plan built once per graph (``ops/graph_ops.py``, ``build_csr_plan``). The
values are data and get no gradient.

What bounds it on an H100: bytes (see the source's header). The compulsory
traffic is x and out once each, plus col, val and row_ptr; the gathered
rows, E·W·4 bytes, stay in L2 only while x is small.

:func:`csr_spmm` runs the kernel on a CUDA tensor and counts the launch in
:data:`LAUNCHES` (``csr_spmm`` for the forward CSR, ``csr_spmm_transposed``
for the transposed one); on a CPU tensor it runs :func:`csr_spmm_plain`, the
same sum over the same CSR arrays in plain torch (one gather and one
``index_add_``, in chunks of edges if asked). There is no fallback from the
card to the plain version.
"""

from __future__ import annotations

import torch

from difformer_tpu_torch.kernels.build import load_library
from difformer_tpu_torch.utils.device import on_cuda

#: Kernel launches since the last :func:`reset_launch_counts`, by wrapper
#: and direction.
LAUNCHES = {"csr_spmm": 0, "csr_spmm_transposed": 0}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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


def csr_spmm(x, row_ptr, col, val, *, transposed=False, edge_chunk_size=None):
    """K1. x [*, W] float32 → out [R, W] float32 for the CSR
    (``row_ptr`` [R+1], ``col`` [E], ``val`` [E]), whose columns index rows
    of x (``build_csr_plan`` checks its indices). ``transposed`` names the
    launch (the backward's CSR) in :data:`LAUNCHES`; ``edge_chunk_size``
    applies to the plain version only, as the kernel never makes the
    [E, W] messages."""
    _check(x, row_ptr, col, val)
    if not on_cuda("csr_spmm", x, row_ptr, col, val):
        return csr_spmm_plain(x, row_ptr, col, val,
                              edge_chunk_size=edge_chunk_size)
    rows, width = row_ptr.numel() - 1, x.shape[1]
    if col.numel() == 0 or rows == 0 or width == 0:
        return torch.zeros((rows, width), dtype=torch.float32,
                           device=x.device)
    x, row_ptr = x.contiguous(), row_ptr.contiguous()
    col, val = col.contiguous(), val.contiguous()
    out = torch.empty((rows, width), dtype=torch.float32, device=x.device)
    rc = load_library().csr_spmm(
        row_ptr.data_ptr(), col.data_ptr(), val.data_ptr(), x.data_ptr(),
        out.data_ptr(), rows, width,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"csr_spmm kernel launch failed: CUDA error {rc}")
    LAUNCHES["csr_spmm_transposed" if transposed else "csr_spmm"] += 1
    return out


class CsrSpmm(torch.autograd.Function):
    """``out = A @ x`` for the CSR ``fwd`` = (row_ptr, col, val) of A; the
    backward is ``dx = Aᵀ @ dout`` through the same kernel over ``bwd``, the
    CSR of Aᵀ. Only x gets a gradient."""

    @staticmethod
    def forward(ctx, x, fwd, bwd, edge_chunk_size):
        ctx.bwd = bwd
        ctx.edge_chunk_size = edge_chunk_size
        return csr_spmm(x, *fwd, edge_chunk_size=edge_chunk_size)

    @staticmethod
    def backward(ctx, g):
        dx = csr_spmm(g.contiguous(), *ctx.bwd, transposed=True,
                      edge_chunk_size=ctx.edge_chunk_size)
        return dx, None, None, None
