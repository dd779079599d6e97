"""The block-sparse SpMM (K7): the CUDA kernel of the dense-block part of
the block-sparse hybrid (``ops/bsr.py``), its plain version and its launch
count.

The JAX package has no kernel here: ``_bsr_matvec`` and
``_bsr_bucketed_matvec`` (``difformer_tpu/ops/bsr.py:252-264``,
``:568-627``) gather the column tiles of x that each row tile's blocks
point at and contract them with the blocks in an einsum, then add the
residual ELL product. On the H100 ``bsr_spmm_kernel`` (``csrc/bsr.cu``)
computes, for each group of row tiles (the padded layout is one group, the
bucketed layout one a bucket, plus a group of the row tiles without blocks,
written 0),

    out[tiles[i]·T + r, :] = Σ_k Σ_c blocks[i, k, r, c] · x[bcol[i, k]·T + c, :]

in one launch over all groups, every row tile written once, blocks float32,
bfloat16 or int8 edge counts (then with ``scale``, the rank-1 GCN scaling:
x's rows multiplied by it as they are read and out's as they are written),
x and out float32 or bfloat16, f32 sums, one rounding. The residual is
added afterwards by K6 (``ops/bsr.py``).

What bounds it: operations (the source's header); the products run on
the tensor cores in TF32, an f32 operand split in two parts (3 passes).
:func:`bsr_spmm_blocks` launches it on a CUDA tensor and counts the launch
in :data:`LAUNCHES` (``bsr_spmm``, or ``bsr_spmm_transposed`` for the
backward's reverse direction); on a CPU tensor it runs
:func:`bsr_spmm_blocks_plain`. It reads nothing back from the device.
"""

from __future__ import annotations

import numpy as np
import torch

from difformer_tpu_torch.kernels.build import load_library
from difformer_tpu_torch.utils.device import on_cuda

#: Kernel launches since the last :func:`reset_launch_counts`.
LAUNCHES = {"bsr_spmm": 0, "bsr_spmm_transposed": 0}
#: The most groups (padded: 1; bucketed: buckets + 1) a call may have.
MAX_GROUPS = 32

_BLOCK_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_X_TYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def bsr_spmm_blocks_plain(x, groups, tile, scale=None):
    """[N, W] of x's dtype: each group's row tiles (``groups``: (blocks
    [m, kb, T, T] or None, bcol int32 [m, kb], tiles int32 [m] or None)),
    by a gather of x's column tiles and an einsum in float32, with the
    ``scale`` of count blocks applied to x's rows before and to out's rows
    after, rounded to x's dtype once: K7's arithmetic."""
    n, w = x.shape
    ntr = -(-n // tile)
    xs = x.float()
    if scale is not None:
        xs = xs * scale[:, None]
    xt = torch.zeros((ntr * tile, w), dtype=torch.float32, device=x.device)
    xt[:n] = xs
    xt = xt.reshape(ntr, tile, w)
    out = torch.zeros((ntr, tile, w), dtype=torch.float32, device=x.device)
    for blocks, bcol, tiles in groups:
        if blocks is None or bcol.numel() == 0:
            continue
        g = xt.index_select(0, bcol.reshape(-1).long()).reshape(
            bcol.shape + (tile, w))
        ob = torch.einsum("mkrc,mkcw->mrw", blocks.float(), g)
        rows = (torch.arange(bcol.shape[0], device=x.device)
                if tiles is None else tiles.long())
        out.index_copy_(0, rows, ob)
    out = out.reshape(ntr * tile, w)[:n]
    if scale is not None:
        out = out * scale[:, None]
    return out.to(x.dtype)


def bsr_spmm_blocks_abs(x, groups, tile, scale=None):
    """[N, W]: the plain product over |blocks|, |x| and |scale|, the scale
    of float32's rounding of K7's sums (the "spmm" kind of
    ``kernels/tolerance.py``)."""
    return bsr_spmm_blocks_plain(
        x.abs(), [(None if b is None else b.abs(), c, t)
                  for b, c, t in groups], tile,
        None if scale is None else scale.abs())


def _check(x, groups, tile, scale):
    if x.dim() != 2 or x.dtype not in _X_TYPES:
        raise TypeError(f"bsr_spmm takes x [N, W] of float32 or bfloat16, "
                        f"got {x.dtype} {tuple(x.shape)}")
    if not groups or len(groups) > MAX_GROUPS:
        raise ValueError(f"bsr_spmm takes 1 to {MAX_GROUPS} groups, got "
                         f"{len(groups)}")
    types = {b.dtype for b, _, _ in groups if b is not None}
    if len(types) > 1 or not types <= set(_BLOCK_TYPES):
        raise TypeError(f"the blocks of one call must all be float32, "
                        f"bfloat16 or int8, got {sorted(map(str, types))}")
    for blocks, bcol, tiles in groups:
        if blocks is not None and (
                blocks.dim() != 4 or blocks.shape[2:] != (tile, tile)
                or tuple(blocks.shape[:2]) != tuple(bcol.shape)):
            raise ValueError(f"blocks must be [m, kb, {tile}, {tile}] with "
                             f"bcol [m, kb], got {tuple(blocks.shape)}, "
                             f"{tuple(bcol.shape)}")
        if bcol is not None and bcol.dtype != torch.int32:
            raise TypeError("column tiles must be int32")
        if tiles is not None and tiles.dtype != torch.int32:
            raise TypeError("row tiles must be int32")
    if scale is not None and (scale.dtype != torch.float32
                              or scale.shape != (x.shape[0],)):
        raise ValueError("scale must be float32 [N]")


def bsr_spmm_blocks(x, groups, tile, *, scale=None, transposed=False):
    """K7. x [N, W] float32 or bfloat16 → [N, W] of x's dtype: the dense
    blocks of ``groups`` (see :func:`bsr_spmm_blocks_plain`; together their
    row tiles must be every tile of the N rows, once) times x, with
    ``scale`` ([N] float32) for int8 count blocks. ``transposed`` names the
    launch (the backward's direction) in :data:`LAUNCHES`."""
    _check(x, groups, tile, scale)
    tensors = [t for grp in groups for t in grp] + [x, scale]
    if not on_cuda("bsr_spmm", *tensors):
        return bsr_spmm_blocks_plain(x, groups, tile, scale)
    n, width = x.shape
    if n == 0 or width == 0:
        return torch.zeros_like(x)
    x = x.contiguous()
    out = torch.empty_like(x)
    block_type = next((_BLOCK_TYPES[b.dtype] for b, _, _ in groups
                       if b is not None), 0)
    table = np.zeros((len(groups), 5), np.int64)
    for row, (blocks, bcol, tiles) in zip(table, groups):
        for b in (blocks, bcol, tiles):
            if b is not None and not b.is_contiguous():
                raise ValueError("blocks and tiles must be contiguous")
        row[:] = (0 if blocks is None else blocks.data_ptr(),
                  0 if bcol is None else bcol.data_ptr(),
                  0 if tiles is None else tiles.data_ptr(),
                  (bcol if tiles is None else tiles).shape[0],
                  0 if blocks is None else bcol.shape[1])
    rc = load_library().bsr_spmm(
        x.data_ptr(), out.data_ptr(),
        None if scale is None else scale.data_ptr(), n, width, tile,
        block_type, _X_TYPES[x.dtype], table.ctypes.data, len(groups),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bsr_spmm kernel launch failed: CUDA error {rc}")
    LAUNCHES["bsr_spmm_transposed" if transposed else "bsr_spmm"] += 1
    return out
