"""The ELL SpMM (K6): the CUDA kernel of the ELL layout's product, its
plain version and its launch count.

The JAX package has no kernel here: ``_ell_matvec``
(``difformer_tpu/ops/ell.py:180-225``) gathers every bucket's [rows, k, F]
neighbour rows, sums them against the weights, concatenates the buckets and
gathers the result back to node order by ``inv_perm``. On the H100
``ell_spmm_kernel`` (``csrc/ell.cu``) computes, for every row r of every
bucket of one direction (:class:`~difformer_tpu_torch.ops.ell.EllGraph`),

    out[rows[r], :] = Σ_{j < k} val[s_r + j] · x[idx[s_r + j], :]

in one launch, with f32 sums and one rounding to x's dtype (float32 or
bfloat16, as K1), each row written straight to its node: no atomics, no
inverse-permutation gather, deterministic. A row of a bucket wider than
``HEAVY_WIDTH`` slots (a hub) takes a whole block whose groups of lanes sum
contiguous runs of its slots and are combined in a fixed order. With
``add_to`` the rows are added to that tensor's (the block-sparse hybrid's
residual, ``ops/bsr.py``), still one write a node.

What bounds it: bytes, as K1 (the source's header). :func:`ell_spmm_rows`
launches it on a CUDA tensor and counts the launch in :data:`LAUNCHES`
(``ell_spmm``, or ``ell_spmm_transposed`` for the backward's reverse
direction); on a CPU tensor it runs :func:`ell_spmm_plain`, the same sums
in plain torch. It reads nothing back from the device: its launch comes
from tensor shapes and the layout's host table, so it can be captured in a
CUDA graph.
"""

from __future__ import annotations

import dataclasses

import torch

from difformer_tpu_torch.kernels.build import load_library
from difformer_tpu_torch.utils.device import on_cuda

#: Kernel launches since the last :func:`reset_launch_counts`.
LAUNCHES = {"ell_spmm": 0, "ell_spmm_transposed": 0}

#: A bucket wider than this many slots takes a block a row (``csrc/ell.cu``'s
#: ``kHeavyWidth``; the plain version does not depend on it).
HEAVY_WIDTH = 128
#: The most buckets a direction may have (the kernel's table).
MAX_BUCKETS = 48

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def ell_spmm_plain(x, ell, add_to=None):
    """[N, W] of x's dtype: each bucket's rows gathered and summed against
    the weights in float32, written to their nodes, plus ``add_to`` (in
    float32) where given, rounded to x's dtype once: K6's arithmetic."""
    n, w = ell.num_nodes, x.shape[1]
    out = (torch.zeros((n, w), dtype=torch.float32, device=x.device)
           if add_to is None else add_to.float().clone())
    for (r0, k, s), nbr, wt in zip(ell.table, ell.nbr_idx, ell.weight):
        if nbr.shape[0] == 0:
            continue
        g = x.index_select(0, nbr.reshape(-1).long()).float()
        sums = (g.reshape(nbr.shape[0], int(k), w) * wt[..., None]).sum(1)
        node = ell.rows[r0:r0 + nbr.shape[0]].long()
        out.index_add_(0, node, sums)
    return out.to(x.dtype)


def ell_spmm_abs(x, ell):
    """[N, W]: ``Σ |val · x[idx]|`` over each row's slots, the scale of
    float32's rounding of K6's sums (the "spmm" kind of
    ``kernels/tolerance.py``)."""
    return ell_spmm_plain(x.abs(), dataclasses.replace(ell, val=ell.val.abs()))


def _check(x, ell, add_to):
    if x.dim() != 2 or x.shape[0] != ell.num_nodes:
        raise ValueError(f"x must be [{ell.num_nodes}, W], got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"ell_spmm takes float32 or bfloat16 x, got "
                        f"{x.dtype}")
    if (ell.idx.dtype != torch.int32 or ell.val.dtype != torch.float32
            or ell.rows.dtype != torch.int32):
        raise TypeError("the ELL layout must hold int32 idx and rows and "
                        "float32 val")
    if len(ell.table) > MAX_BUCKETS:
        raise ValueError(f"{len(ell.table)} buckets; the kernel takes at "
                         f"most {MAX_BUCKETS}")
    if add_to is not None and (add_to.shape != (ell.num_nodes, x.shape[1])
                               or add_to.dtype != x.dtype):
        raise ValueError(f"add_to must be x's dtype and [{ell.num_nodes}, "
                         f"{x.shape[1]}], got {add_to.dtype} "
                         f"{tuple(add_to.shape)}")


def ell_spmm_rows(x, ell, *, transposed=False, add_to=None):
    """K6. x [N, W] float32 or bfloat16 → [N, W] of x's dtype over the
    :class:`~difformer_tpu_torch.ops.ell.EllGraph` ``ell``; with ``add_to``
    ([N, W], x's dtype) the sums are added to it, in place on the card.
    ``transposed`` names the launch (the backward's direction) in
    :data:`LAUNCHES`."""
    _check(x, ell, add_to)
    if not on_cuda("ell_spmm", x, ell.idx, ell.val, ell.rows, add_to):
        return ell_spmm_plain(x, ell, add_to)
    n, width = x.shape
    if n == 0 or width == 0:
        return (torch.zeros_like(x) if add_to is None else add_to)
    x = x.contiguous()
    out = (torch.empty((n, width), dtype=x.dtype, device=x.device)
           if add_to is None else add_to)
    if not out.is_contiguous():
        raise ValueError("add_to must be contiguous")
    table = ell.table  # host int64 [B, 3], read by the C entry
    rc = load_library().ell_spmm(
        ell.idx.data_ptr(), ell.val.data_ptr(), ell.rows.data_ptr(),
        x.data_ptr(), out.data_ptr(), table.ctypes.data, len(table),
        ell.rows.numel(), width, _DTYPES[x.dtype], int(add_to is not None),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ell_spmm kernel launch failed: CUDA error {rc}")
    LAUNCHES["ell_spmm_transposed" if transposed else "ell_spmm"] += 1
    return out
