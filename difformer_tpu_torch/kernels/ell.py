"""The ELL SpMM (K6): the CUDA kernel of the ELL layout's product, its
split plan, its plain versions and its launch counts.

The JAX package has no kernel here: ``_ell_matvec``
(``difformer_tpu/ops/ell.py:180-225``) gathers every bucket's [rows, k, F]
neighbour rows, sums them against the weights, concatenates the buckets and
gathers the result back to node order by ``inv_perm``. On the H100
``ell_spmm_kernel`` (``csrc/ell.cu``) computes, for every row r of every
bucket of one direction (:class:`~difformer_tpu_torch.ops.ell.EllGraph`),

    out[rows[r], :] = Σ_{j < k} val[s_r + j] · x[idx[s_r + j], :]

in one launch, with f32 sums and one rounding to x's dtype (float32 or
bfloat16, as K1), each row written straight to its node: no atomics, no
inverse-permutation gather, deterministic. A row's padded slots (one run,
``EllGraph.pads``) are skipped, their index, value and ``x[0]`` never read.
A bucket wider than :data:`SPLIT_THRESHOLD` slots (the hubs of a power-law
graph) is cut by :func:`split_plan` into chunks of at most T slots, which
take the first thread blocks and write float32 partial sums to a scratch
buffer; K1's combine kernel (``csrc/spmm.cu`` ``csr_spmm_combine``) then
sums each split row's chunks in chunk order and writes the row once. With
``add_to`` the rows are added to that tensor's (the block-sparse hybrid's
residual, ``ops/bsr.py``), still one write a node.

What bounds it: bytes, as K1 (the source's header). :func:`ell_spmm_rows`
is the entry: on a CUDA tensor it launches :func:`ell_spmm_split` (counted
in :data:`LAUNCHES` as ``ell_spmm``, or ``ell_spmm_transposed`` for the
backward's reverse direction) and, where the plan splits a bucket,
:func:`ell_spmm_combine` (``ell_spmm_combine``); on a CPU tensor it runs
:func:`ell_spmm_plain`, the sums over every slot in plain torch, as the
JAX package takes them. :func:`ell_spmm_split_plain` and
:func:`ell_spmm_combine_plain` repeat the two kernels' arithmetic. A call
reads nothing back from the device: its launches come from tensor shapes,
the layout's host table and its plan, so it can be captured in a CUDA
graph.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from difformer_tpu_torch.kernels.bsr import chunk_ranges
from difformer_tpu_torch.kernels.build import load_library
from difformer_tpu_torch.utils.device import on_cuda

#: Kernel launches since the last :func:`reset_launch_counts`.
LAUNCHES = {"ell_spmm": 0, "ell_spmm_transposed": 0, "ell_spmm_combine": 0}

#: T: a bucket wider than T slots is split, each row into ⌈k / T⌉ chunks.
#: From a sweep on the card (``time_kernels.py --kernel ell
#: --ell-threshold``; ``chip_smoke.py``'s phase ell-bsr-kernels prints it):
#: on bench.py's power-law graph T = 256 and 384 were within 2 % of each
#: other, 384 the faster where they differed, 128 and 512 up to 8 % slower,
#: 1024 40 % slower (its widest chunks trail the product).
SPLIT_THRESHOLD = 384
#: The most buckets a direction may have (the kernel's table).
MAX_BUCKETS = 48

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def split_plan(table, threshold=None):
    """The chunks of each bucket of ``table`` (int64 [B, 3]: first row,
    width, first slot): 1 for a width k up to T (default
    :data:`SPLIT_THRESHOLD`), else ⌈k / T⌉."""
    t = SPLIT_THRESHOLD if threshold is None else int(threshold)
    if t < 1:
        raise ValueError(f"the split threshold must be at least 1, got {t}")
    return tuple(1 if k <= t else -(-int(k) // t) for k in table[:, 1])


@dataclasses.dataclass(frozen=True)
class EllSplit:
    """The split plan of one direction at ``threshold``: ``chunks`` per
    bucket, and what the combine reads: the node of each split row
    (``rows``, int32 [H], bucket by bucket) and the first partial row of
    each, then their total (``seg_ptr``, int32 [H + 1]; a row's chunks are
    consecutive). ``table`` (int64 [B, 5], on the host) is the kernel's:
    each bucket's first row, width, first slot, chunks and first partial
    row (-1 where not split); ``partials`` the rows of float32 scratch a
    call writes (0: nothing is split, one launch)."""

    threshold: int
    chunks: tuple
    rows: torch.Tensor     # int32 [H]
    seg_ptr: torch.Tensor  # int32 [H + 1]
    table: np.ndarray      # int64 [B, 5]
    partials: int

    def to(self, device) -> "EllSplit":
        return dataclasses.replace(self, rows=self.rows.to(device),
                                   seg_ptr=self.seg_ptr.to(device))


def build_split(table, rows, threshold=None) -> EllSplit:
    """The :class:`EllSplit` of a direction with host ``table`` (int64
    [B, 3]) and the node of each row ``rows`` (int32 [R], on any device),
    at ``threshold`` (default :data:`SPLIT_THRESHOLD`): host work, but for
    the split rows' nodes, which are taken from ``rows`` on its device."""
    t = SPLIT_THRESHOLD if threshold is None else int(threshold)
    chunks = split_plan(table, t)
    counts = np.diff(np.append(table[:, 0], rows.numel()))
    kernel = np.zeros((len(table), 5), np.int64)
    kernel[:, :3] = table
    kernel[:, 3] = chunks
    kernel[:, 4] = -1
    nodes, seg, part = [], [np.zeros(1, np.int64)], 0
    for b, (r0, m, c) in enumerate(zip(table[:, 0], counts, chunks)):
        if c == 1:
            continue
        kernel[b, 4] = part
        nodes.append(rows[int(r0):int(r0 + m)])
        seg.append(part + c * np.arange(1, m + 1, dtype=np.int64))
        part += int(m) * c
    split_rows = (torch.cat(nodes) if nodes else
                  torch.zeros(0, dtype=torch.int32, device=rows.device))
    seg_ptr = torch.as_tensor(np.concatenate(seg).astype(np.int32),
                              device=rows.device)
    return EllSplit(threshold=t, chunks=chunks, rows=split_rows,
                    seg_ptr=seg_ptr, table=kernel, partials=part)


def _buckets(ell):
    """(first row, rows, width, first slot, chunks, first partial row) of
    each bucket of ``ell``."""
    counts = np.diff(np.append(ell.table[:, 0], ell.rows.numel()))
    return [(int(r0), int(m), int(k), int(s), int(c), int(p))
            for (r0, k, s, c, p), m in zip(ell.split.table, counts)]


def ell_spmm_plain(x, ell, add_to=None):
    """[N, W] of x's dtype: each bucket's rows gathered and summed against
    the weights in float32 over every slot (pads included, as the JAX
    package sums them), written to their nodes, plus ``add_to`` (in
    float32) where given, rounded to x's dtype once."""
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


def real_slots(ell):
    """Per bucket, bool [rows, k]: the slots that are not padding, from
    ``ell.pads`` (each row's first pad slot and pad count)."""
    masks = []
    for (r0, m, k, _, _, _), nbr in zip(_buckets(ell), ell.nbr_idx):
        first, count = ell.pads[r0:r0 + m].long().unbind(1)
        j = torch.arange(k, device=nbr.device)
        masks.append((j < first[:, None]) | (j >= (first + count)[:, None]))
    return masks


def _products(x, nbr, wt, real):
    """float32 [rows, k, W]: each slot's weight times its gathered row of
    x, 0 on padding (whatever x[0] holds), as the kernel skips the pads."""
    g = x.index_select(0, nbr.reshape(-1).long()).float().reshape(
        nbr.shape + (x.shape[1],))
    return torch.where(real[..., None], g * wt[..., None], 0.0)


def ell_spmm_split_plain(x, ell, add_to=None):
    """(out, partial): K6's kernel under ``ell.split``, in plain torch. out
    [N, W] of x's dtype holds every unsplit bucket's rows, their real slots
    summed in float32 (plus ``add_to`` where given), rounded once; the
    split rows hold ``add_to``'s values (0 without it). partial float32
    [``ell.split.partials``, W] holds each split row's chunk sums
    (:func:`chunk_ranges`), a row's chunks consecutive."""
    n, w = ell.num_nodes, x.shape[1]
    out = (torch.zeros((n, w), dtype=torch.float32, device=x.device)
           if add_to is None else add_to.float().clone())
    partial = torch.zeros((ell.split.partials, w), dtype=torch.float32,
                          device=x.device)
    for (r0, m, k, _, c, p), nbr, wt, real in zip(
            _buckets(ell), ell.nbr_idx, ell.weight, real_slots(ell)):
        if m == 0:
            continue
        prod = _products(x, nbr, wt, real)
        if c == 1:
            out.index_add_(0, ell.rows[r0:r0 + m].long(), prod.sum(1))
            continue
        # a row's chunks as K7's: ⌈k / c⌉ slots each, the last the rest
        sums = torch.stack([prod[:, lo:hi].sum(1)
                            for lo, hi in chunk_ranges(k, c)], 1)
        partial[p:p + m * c] = sums.reshape(m * c, w)
    return out.to(x.dtype), partial


def ell_spmm_combine_plain(partial, out, ell, accumulate=False):
    """A copy of ``out`` [N, W] whose split rows are the sums of their
    chunks' ``partial`` rows in chunk order (``ell.split.seg_ptr``), added
    to out's value in float32 with ``accumulate``, rounded once to out's
    dtype: the combine kernel's arithmetic."""
    res = out.clone()
    split = ell.split
    if split.rows.numel() == 0:
        return res
    seg = split.seg_ptr.long()
    c = seg[1:] - seg[:-1]
    acc = (out[split.rows.long()].float() if accumulate
           else torch.zeros((split.rows.numel(), out.shape[1]),
                            device=out.device))
    total = torch.zeros_like(acc)
    for j in range(int(c.max())):
        live = j < c
        total[live] = total[live] + partial[seg[:-1][live] + j]
    res[split.rows.long()] = (acc + total).to(out.dtype)
    return res


def _check(x, ell, add_to):
    if x.dim() != 2 or x.shape[0] != ell.num_nodes:
        raise ValueError(f"x must be [{ell.num_nodes}, W], got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"ell_spmm takes float32 or bfloat16 x, got "
                        f"{x.dtype}")
    if (ell.idx.dtype != torch.int32 or ell.val.dtype != torch.float32
            or ell.rows.dtype != torch.int32
            or ell.pads.dtype != torch.int32):
        raise TypeError("the ELL layout must hold int32 idx, rows and pads "
                        "and float32 val")
    if ell.pads.shape != (ell.rows.numel(), 2):
        raise ValueError(f"pads must be [{ell.rows.numel()}, 2], got "
                         f"{tuple(ell.pads.shape)}")
    if len(ell.table) > MAX_BUCKETS:
        raise ValueError(f"{len(ell.table)} buckets; the kernel takes at "
                         f"most {MAX_BUCKETS}")
    if not np.array_equal(ell.split.table[:, :3], ell.table):
        raise ValueError("the split plan is not this layout's")
    if add_to is not None and (add_to.shape != (ell.num_nodes, x.shape[1])
                               or add_to.dtype != x.dtype):
        raise ValueError(f"add_to must be x's dtype and [{ell.num_nodes}, "
                         f"{x.shape[1]}], got {add_to.dtype} "
                         f"{tuple(add_to.shape)}")


def _layout_tensors(ell):
    return (ell.idx, ell.val, ell.rows, ell.pads, ell.split.rows,
            ell.split.seg_ptr)


def ell_spmm_split(x, ell, *, transposed=False, add_to=None):
    """K6's kernel under ``ell.split``: (out, partial) as
    :func:`ell_spmm_split_plain`, except that on the card the split rows of
    out are left as they were (unwritten, or ``add_to``'s, in place) and
    partial is None where nothing is split. ``transposed`` names the launch
    in :data:`LAUNCHES`."""
    _check(x, ell, add_to)
    if not on_cuda("ell_spmm", x, add_to, *_layout_tensors(ell)):
        return ell_spmm_split_plain(x, ell, add_to)
    n, width = x.shape
    x = x.contiguous()
    out = (torch.empty((n, width), dtype=x.dtype, device=x.device)
           if add_to is None else add_to)
    if not out.is_contiguous():
        raise ValueError("add_to must be contiguous")
    if n == 0 or width == 0:
        return (out.zero_() if add_to is None else out), None
    split = ell.split
    partial = (torch.empty((split.partials, width), dtype=torch.float32,
                           device=x.device) if split.partials else None)
    if not ell.pads.is_contiguous() or ell.pads.data_ptr() % 8:
        raise ValueError("pads must be contiguous and 8-byte aligned")
    rc = load_library().ell_spmm(
        ell.idx.data_ptr(), ell.val.data_ptr(), ell.rows.data_ptr(),
        ell.pads.data_ptr(), x.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(),
        split.table.ctypes.data, len(split.table), ell.rows.numel(), width,
        _DTYPES[x.dtype], int(add_to is not None),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ell_spmm kernel launch failed: CUDA error {rc}")
    LAUNCHES["ell_spmm_transposed" if transposed else "ell_spmm"] += 1
    return out, partial


def ell_spmm_combine(partial, out, ell, *, accumulate=False):
    """K6's second kernel, K1's combine: the split rows of ``out`` [N, W]
    (in place) from their chunks' ``partial`` sums, as
    :func:`ell_spmm_combine_plain`; returns out."""
    split = ell.split
    if (out.dtype not in _DTYPES or partial.dtype != torch.float32
            or partial.shape != (split.partials, out.shape[1])):
        raise ValueError(f"ell_spmm_combine takes out of float32 or bfloat16 "
                         f"and float32 partials [{split.partials}, "
                         f"{out.shape[1]}], got {out.dtype}, {partial.dtype} "
                         f"{tuple(partial.shape)}")
    if not on_cuda("ell_spmm_combine", partial, out, split.rows,
                   split.seg_ptr):
        return out.copy_(ell_spmm_combine_plain(partial, out, ell,
                                                accumulate))
    if not (out.is_contiguous() and partial.is_contiguous()):
        raise ValueError("out and partial must be contiguous")
    rc = load_library().csr_spmm_combine_rows(
        split.rows.data_ptr(), split.seg_ptr.data_ptr(), partial.data_ptr(),
        out.data_ptr(), split.rows.numel(), out.shape[1],
        _DTYPES[out.dtype], int(accumulate),
        torch.cuda.current_stream(out.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ell_spmm_combine kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES["ell_spmm_combine"] += 1
    return out


def ell_spmm_rows(x, ell, *, transposed=False, add_to=None):
    """K6. x [N, W] float32 or bfloat16 → [N, W] of x's dtype over the
    :class:`~difformer_tpu_torch.ops.ell.EllGraph` ``ell``; with ``add_to``
    ([N, W], x's dtype) the sums are added to it, in place on the card.
    On the card the buckets that ``ell.split`` cuts are finished by
    :func:`ell_spmm_combine`. ``transposed`` names the launch (the
    backward's direction) in :data:`LAUNCHES`."""
    _check(x, ell, add_to)
    if not on_cuda("ell_spmm", x, add_to, *_layout_tensors(ell)):
        return ell_spmm_plain(x, ell, add_to)
    out, partial = ell_spmm_split(x, ell, transposed=transposed,
                                  add_to=add_to)
    if partial is not None:
        ell_spmm_combine(partial, out, ell, accumulate=add_to is not None)
    return out
