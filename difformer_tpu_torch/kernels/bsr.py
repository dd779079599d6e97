"""The block-sparse SpMM (K7): the CUDA kernels of the dense-block part of
the block-sparse hybrid (``ops/bsr.py``), their plain versions, the split
plan and the launch counts.

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

The square call takes x [N, W] to out [N, W] with one ``scale`` [N]. The
rectangular call is a rank's shard of the node-sharded hybrid
(``_bsr_shard_apply``, ``difformer_tpu/ops/bsr.py:781-811``): out
[num_rows, W] from the gathered x [pad_n, W], with ``col_scale`` [pad_n] on
x's rows and ``row_scale`` [num_rows] on out's; the groups' row tiles are
then those of the num_rows rows and their column tiles those of x's pad_n.

A group whose row tiles hold more than :data:`SPLIT_BLOCKS` blocks and
whose thread blocks fill less than a wave of the card is cut along its
blocks into chunks (:func:`split_plan`, from shapes and the SM count
alone); each chunk writes f32 partial sums into scratch, and
``bsr_combine_kernel`` sums them in chunk order, scales and rounds once,
a thread block a band of :func:`combine_rows` rows of a split group's row
tile (:func:`combine_plan`, the host's numbering of those bands).

:func:`bsr_spmm_blocks` is the entry: on a CUDA tensor it launches
:func:`bsr_spmm_split` (counted in :data:`LAUNCHES` as ``bsr_spmm``, or
``bsr_spmm_transposed`` for the backward's reverse direction) and, where
the plan splits, :func:`bsr_spmm_combine` (``bsr_spmm_combine``); on a CPU
tensor it runs :func:`bsr_spmm_blocks_plain`. It reads nothing back from
the device, so a call can be captured in a CUDA graph.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from difformer_tpu_torch.kernels.build import load_library
from difformer_tpu_torch.utils.device import on_cuda

#: Kernel launches since the last :func:`reset_launch_counts`.
LAUNCHES = {"bsr_spmm": 0, "bsr_spmm_transposed": 0, "bsr_spmm_combine": 0}
#: The most groups (padded: 1; bucketed: buckets + 1) a call may have.
MAX_GROUPS = 32
#: Output rows of a thread block, and its most columns (csrc/bsr.cu).
ROWS, MAX_COLS = 128, 80
#: S, the blocks a thread block walks before its group is split: at 3 the
#: hub row tile of bench.py's degree-sorted power-law graph (256 blocks,
#: T = 256, W = 64) is cut into 86 chunks of 2 thread blocks, at least one
#: on each of the H100's 132 SMs; its whole layout takes 0.2203, 0.2086,
#: 0.2078 and 0.2014 ms at S = 2, 4, 8 and 16 and 0.3422 at 32 (chip_smoke.py,
#: phase ell-bsr-kernels, prints the sweep; PERF.md §6).
SPLIT_BLOCKS = 3
#: Thread blocks of K7 an SM holds at once (``__launch_bounds__``).
BLOCKS_PER_SM = 2
#: Threads of a block of the combine kernel (``csrc/bsr.cu``).
COMBINE_THREADS = 128

_BLOCK_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_X_TYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def column_tile(width):
    """Columns of a thread block at width W: W rounded up to 8 up to 80;
    wider W cut into equal tiles of at most 80, each a multiple of 8."""
    nt = -(-width // 8)
    tiles = -(-nt // (MAX_COLS // 8))
    return 8 * -(-nt // tiles)


def group_shapes(groups):
    """(m, kb) of each group: its row tiles and its blocks a row tile (0
    for a group without blocks)."""
    return [((bcol if tiles is None else tiles).shape[0],
             0 if blocks is None else bcol.shape[1])
            for blocks, bcol, tiles in groups]


def split_plan(shapes, tile, width, sms):
    """The chunks of each group ((m, kb) in ``shapes``) along its kb: 1,
    unless kb exceeds :data:`SPLIT_BLOCKS` and the group's thread blocks
    (m · row tiles of 128 · column tiles) fill less than a wave of ``sms``
    SMs; then ⌈kb / SPLIT_BLOCKS⌉, at most as many as fill the wave, every
    chunk holding blocks (:func:`chunk_ranges`)."""
    wave = BLOCKS_PER_SM * sms
    per_tile = -(-tile // ROWS) * -(-width // column_tile(width))
    plan = []
    for m, kb in shapes:
        blocks = m * per_tile
        if kb <= SPLIT_BLOCKS or blocks == 0 or blocks >= wave:
            plan.append(1)
            continue
        chunks = min(-(-kb // SPLIT_BLOCKS), -(-wave // blocks))
        plan.append(-(-kb // -(-kb // chunks)))
    return plan


def chunk_ranges(kb, chunks):
    """The blocks [k0, k1) of each chunk of a row tile's kb, as the kernel
    takes them: ⌈kb / chunks⌉ each, the last one the rest."""
    kc = -(-kb // chunks) if kb else 0
    return [(min(kb, c * kc), min(kb, (c + 1) * kc)) for c in range(chunks)]


def partial_offsets(groups, chunks, tile, width):
    """(the first element of each group's partials, their total): the
    split groups' [chunks, m, T, W] float32 partials one after another."""
    offsets, total = [], 0
    for (m, _), c in zip(group_shapes(groups), chunks):
        offsets.append(total if c > 1 else 0)
        total += c * m * tile * width if c > 1 else 0
    return offsets, total


@functools.lru_cache(maxsize=None)
def sm_count(device):
    """The SMs of a CUDA device (read once a process)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _shape(x, scale, num_rows, row_scale, col_scale):
    """(out's rows, the row scale, the column scale) of a call: the
    square call's ``scale`` is both, its rows x's."""
    if scale is not None:
        if row_scale is not None or col_scale is not None:
            raise ValueError("pass scale (the square call) or row_scale and "
                             "col_scale (a rectangular shard), not both")
        row_scale = col_scale = scale
    return (x.shape[0] if num_rows is None else int(num_rows), row_scale,
            col_scale)


def _padded_x(x, scale, tile):
    """x in float32, its rows scaled, zero-padded to whole tiles: [tiles,
    T, W]."""
    n, w = x.shape
    ntr = -(-n // tile)
    xs = x.float()
    if scale is not None:
        xs = xs * scale[:, None]
    xt = torch.zeros((ntr * tile, w), dtype=torch.float32, device=x.device)
    xt[:n] = xs
    return xt.reshape(ntr, tile, w)


def _group_rows(bcol, tiles, device):
    return (torch.arange(bcol.shape[0], device=device)
            if tiles is None else tiles.long())


def _block_product(blocks, bcol, xt):
    tile, w = xt.shape[1:]
    g = xt.index_select(0, bcol.reshape(-1).long()).reshape(
        bcol.shape + (tile, w))
    return torch.einsum("mkrc,mkcw->mrw", blocks.float(), g)


def _out_tiles(xt, n, tile):
    """A float32 zero output of whole row tiles for ``n`` rows."""
    return xt.new_zeros((-(-n // tile), tile, xt.shape[2]))


def bsr_spmm_blocks_plain(x, groups, tile, scale=None, *, num_rows=None,
                          row_scale=None, col_scale=None):
    """[N, W] of x's dtype: each group's row tiles (``groups``: (blocks
    [m, kb, T, T] or None, bcol int32 [m, kb], tiles int32 [m] or None)),
    by a gather of x's column tiles and an einsum in float32, with the
    ``scale`` of count blocks applied to x's rows before and to out's rows
    after, rounded to x's dtype once: K7's arithmetic. A rectangular shard
    gives [num_rows, W], ``col_scale`` on x's rows and ``row_scale`` on
    out's."""
    n, row_scale, col_scale = _shape(x, scale, num_rows, row_scale,
                                     col_scale)
    w = x.shape[1]
    xt = _padded_x(x, col_scale, tile)
    out = _out_tiles(xt, n, tile)
    for blocks, bcol, tiles in groups:
        if blocks is None or bcol.numel() == 0:
            continue
        out.index_copy_(0, _group_rows(bcol, tiles, x.device),
                        _block_product(blocks, bcol, xt))
    out = out.reshape(-1, w)[:n]
    if row_scale is not None:
        out = out * row_scale[:, None]
    return out.to(x.dtype)


def bsr_spmm_blocks_abs(x, groups, tile, scale=None, *, num_rows=None,
                        row_scale=None, col_scale=None):
    """[N, W]: the plain product over |blocks|, |x| and |scale|, the scale
    of float32's rounding of K7's sums (the "spmm" kind of
    ``kernels/tolerance.py``)."""
    n, row_scale, col_scale = _shape(x, scale, num_rows, row_scale,
                                     col_scale)
    absolute = lambda t: None if t is None else t.abs()  # noqa: E731
    return bsr_spmm_blocks_plain(
        x.abs(), [(absolute(b), c, t) for b, c, t in groups], tile,
        num_rows=n, row_scale=absolute(row_scale),
        col_scale=absolute(col_scale))


def bsr_spmm_split_plain(x, groups, tile, chunks, scale=None, *,
                         num_rows=None, row_scale=None, col_scale=None):
    """(out, partial): K7's first kernel under the plan ``chunks``. out
    [N, W] (a rectangular shard: [num_rows, W]) of x's dtype holds the
    unsplit groups' rows as :func:`bsr_spmm_blocks_plain` (the split
    groups' rows 0); partial the split groups' float32 sums over each
    chunk's blocks (:func:`chunk_ranges`), unscaled, laid out as
    :func:`partial_offsets` says."""
    n, row_scale, col_scale = _shape(x, scale, num_rows, row_scale,
                                     col_scale)
    w = x.shape[1]
    xt = _padded_x(x, col_scale, tile)
    out = _out_tiles(xt, n, tile)
    offsets, size = partial_offsets(groups, chunks, tile, w)
    partial = torch.zeros(size, dtype=torch.float32, device=x.device)
    for (blocks, bcol, tiles), c, off in zip(groups, chunks, offsets):
        if blocks is None:
            continue
        parts = [_block_product(blocks[:, k0:k1], bcol[:, k0:k1], xt)
                 for k0, k1 in chunk_ranges(bcol.shape[1], c)]
        if c == 1:
            out.index_copy_(0, _group_rows(bcol, tiles, x.device), parts[0])
        else:
            partial[off:off + c * parts[0].numel()] = \
                torch.stack(parts).reshape(-1)
    out = out.reshape(-1, w)[:n]
    if row_scale is not None:
        out = out * row_scale[:, None]
    return out.to(x.dtype), partial


def bsr_spmm_combine_plain(partial, out, groups, tile, chunks, scale=None):
    """A copy of ``out`` [N, W] whose split groups' rows are the sums of
    their chunks' partials in chunk order, times ``scale`` of the row (a
    rectangular shard's ``row_scale``), rounded once to out's dtype: the
    combine kernel's arithmetic."""
    n, w = out.shape
    res = out.clone()
    offsets, _ = partial_offsets(groups, chunks, tile, w)
    for (_, bcol, tiles), c, off in zip(groups, chunks, offsets):
        if c < 2:
            continue
        rows = _group_rows(bcol, tiles, out.device)
        p = partial[off:off + c * rows.numel() * tile * w].reshape(
            c, rows.numel() * tile, w)
        s = p[0]
        for i in range(1, c):
            s = s + p[i]
        nodes = (rows[:, None] * tile + torch.arange(
            tile, device=out.device)).reshape(-1)
        keep = nodes < n
        s, nodes = s[keep], nodes[keep]
        if scale is not None:
            s = s * scale[nodes, None]
        res[nodes] = s.to(res.dtype)
    return res


def combine_rows(width):
    """Rows of a band of the combine kernel at width W: 8 where W % 4 == 0
    (16-byte packs), else the rows its :data:`COMBINE_THREADS` threads hold
    at a thread a value, W rounded up to a power of two threads a row (one
    row at least)."""
    if width % 4 == 0:
        return 8
    return COMBINE_THREADS // min(COMBINE_THREADS,
                                  1 << (width - 1).bit_length())


def combine_plan(groups, chunks, tile, width):
    """The combine kernel's work, as the host numbers it: for each split
    group (chunks > 1), in order, (its index in ``groups``, its first
    thread block, m, chunks, its first partial), and the thread blocks in
    all. A thread block takes one band of :func:`combine_rows` rows of one
    row tile: group j's bands are its first block onwards, ⌈T / rows⌉ a
    row tile, row tile after row tile."""
    offsets, _ = partial_offsets(groups, chunks, tile, width)
    bands = -(-tile // combine_rows(width))
    plan, total = [], 0
    for i, ((m, _), c, off) in enumerate(zip(group_shapes(groups), chunks,
                                             offsets)):
        if c > 1:
            plan.append((i, total, m, c, off))
            total += m * bands
    return plan, total


def _check(x, groups, tile, num_rows, row_scale, col_scale):
    if x.dim() != 2 or x.dtype not in _X_TYPES:
        raise TypeError(f"bsr_spmm takes x [N, W] of float32 or bfloat16, "
                        f"got {x.dtype} {tuple(x.shape)}")
    if num_rows < 0:
        raise ValueError(f"num_rows must be >= 0, got {num_rows}")
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
        if tiles is None and bcol is not None and \
                bcol.shape[0] > -(-num_rows // tile):
            raise ValueError(f"a group of {bcol.shape[0]} row tiles for "
                             f"{num_rows} rows of out at T = {tile}")
    for name, sc, rows in (("row_scale", row_scale, num_rows),
                           ("col_scale", col_scale, x.shape[0])):
        if sc is not None and (sc.dtype != torch.float32
                               or sc.shape != (rows,)):
            raise ValueError(f"{name} must be float32 [{rows}], got "
                             f"{sc.dtype} {tuple(sc.shape)} (the square "
                             f"call's scale is both, [N])")


def _check_plan(groups, chunks):
    if len(chunks) != len(groups):
        raise ValueError(f"{len(chunks)} chunks for {len(groups)} groups")
    for (m, kb), c in zip(group_shapes(groups), chunks):
        if not 1 <= c <= max(kb, 1):
            raise ValueError(f"a group of {kb} blocks a row tile cannot be "
                             f"cut into {c} chunks")


def staged_x(x):
    """(x as K7 reads it, its row stride in elements): x itself where its
    rows lie at a 16-byte aligned address a multiple of 16 bytes apart,
    else a copy into a [N, ldx] buffer whose rows are (ldx: W rounded up to
    16 bytes; the columns past W are never read into an output)."""
    n, w = x.shape
    v = 16 // x.element_size()
    ld, whole = x.stride(0), -(-w // v) * v
    if (x.stride(1) == 1 and ld >= w and ld % v == 0
            and x.data_ptr() % 16 == 0
            and (x.storage_offset() + (n - 1) * ld + whole)
            * x.element_size() <= x.untyped_storage().nbytes()):
        return x, ld
    buf = x.new_empty((n, whole))
    buf[:, :w].copy_(x)
    return buf, whole


def _table(groups, chunks, tile, width):
    """The kernels' table (int64 [groups, 7]) and the partials' size."""
    offsets, size = partial_offsets(groups, chunks, tile, width)
    table = np.zeros((len(groups), 7), np.int64)
    for row, (blocks, bcol, tiles), (m, kb), c, off in zip(
            table, groups, group_shapes(groups), chunks, offsets):
        for b in (blocks, bcol, tiles):
            if b is not None and not b.is_contiguous():
                raise ValueError("blocks and tiles must be contiguous")
        row[:] = (0 if blocks is None else blocks.data_ptr(),
                  0 if bcol is None else bcol.data_ptr(),
                  0 if tiles is None else tiles.data_ptr(), m, kb, c, off)
    return table, size


def bsr_spmm_split(x, groups, tile, chunks, *, scale=None,
                   transposed=False, num_rows=None, row_scale=None,
                   col_scale=None):
    """K7's first kernel under the plan ``chunks`` (one a group): (out,
    partial) as :func:`bsr_spmm_split_plain`, except that on the card the
    split groups' rows of out are left unwritten and partial is None where
    nothing splits. ``transposed`` names the launch in :data:`LAUNCHES`."""
    n, row_scale, col_scale = _shape(x, scale, num_rows, row_scale,
                                     col_scale)
    _check(x, groups, tile, n, row_scale, col_scale)
    _check_plan(groups, chunks)
    tensors = [t for grp in groups for t in grp] + [x, row_scale, col_scale]
    if not on_cuda("bsr_spmm", *tensors):
        return bsr_spmm_split_plain(x, groups, tile, chunks, num_rows=n,
                                    row_scale=row_scale, col_scale=col_scale)
    n_x, width = x.shape
    out = torch.empty((n, width), dtype=x.dtype, device=x.device)
    if n == 0 or width == 0:
        return out.zero_(), None
    xs, ldx = staged_x(x)
    table, size = _table(groups, chunks, tile, width)
    partial = (torch.empty(size, dtype=torch.float32, device=x.device)
               if size else None)
    block_type = next((_BLOCK_TYPES[b.dtype] for b, _, _ in groups
                       if b is not None), 0)
    row_scale, col_scale = (None if sc is None else sc.contiguous()
                            for sc in (row_scale, col_scale))
    rc = load_library().bsr_spmm(
        xs.data_ptr(), ldx, out.data_ptr(),
        None if partial is None else partial.data_ptr(), size,
        None if col_scale is None else col_scale.data_ptr(),
        None if row_scale is None else row_scale.data_ptr(), n, n_x, width,
        tile, column_tile(width), block_type, _X_TYPES[x.dtype],
        table.ctypes.data, len(groups),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bsr_spmm kernel launch failed: CUDA error {rc}")
    LAUNCHES["bsr_spmm_transposed" if transposed else "bsr_spmm"] += 1
    return out, partial


def bsr_spmm_combine(partial, out, groups, tile, chunks, *, scale=None):
    """K7's second kernel: the split groups' rows of ``out`` [N, W] (in
    place) from their chunks' ``partial`` sums, as
    :func:`bsr_spmm_combine_plain` (``scale``: out's rows', a rectangular
    shard's ``row_scale``); returns out."""
    _check_plan(groups, chunks)
    n, width = out.shape
    _, size = partial_offsets(groups, chunks, tile, width)
    if out.dtype not in _X_TYPES or partial.numel() != size:
        raise ValueError(f"bsr_spmm_combine takes out of float32 or "
                         f"bfloat16 and {size} partials, got {out.dtype}, "
                         f"{partial.numel()}")
    tensors = [t for grp in groups for t in grp] + [partial, out, scale]
    if not on_cuda("bsr_spmm_combine", *tensors):
        return out.copy_(bsr_spmm_combine_plain(partial, out, groups, tile,
                                                chunks, scale))
    if not (out.is_contiguous() and partial.is_contiguous()):
        raise ValueError("out and partial must be contiguous")
    plan, _ = combine_plan(groups, chunks, tile, width)
    if not plan:
        return out
    table = np.array([(first, 0 if groups[i][2] is None
                       else groups[i][2].data_ptr(), m, c, off)
                      for i, first, m, c, off in plan], np.int64)
    if scale is not None:
        scale = scale.contiguous()
    rc = load_library().bsr_spmm_combine(
        partial.data_ptr(), size,
        None if scale is None else scale.data_ptr(), out.data_ptr(), n,
        width, tile, _X_TYPES[out.dtype], table.ctypes.data, len(plan),
        torch.cuda.current_stream(out.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bsr_spmm_combine kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES["bsr_spmm_combine"] += 1
    return out


def bsr_spmm_blocks(x, groups, tile, *, scale=None, transposed=False,
                    num_rows=None, row_scale=None, col_scale=None):
    """K7. x [N, W] float32 or bfloat16 → [N, W] of x's dtype: the dense
    blocks of ``groups`` (see :func:`bsr_spmm_blocks_plain`; together their
    row tiles must be every tile of the N rows, once) times x, with
    ``scale`` ([N] float32) for int8 count blocks. A rectangular shard
    (``num_rows``) gives [num_rows, W] from x [pad_n, W], its count blocks
    scaled by ``col_scale`` [pad_n] on x's rows and ``row_scale``
    [num_rows] on out's. On the card, the groups :func:`split_plan` cuts
    are finished by :func:`bsr_spmm_combine`. ``transposed`` names the
    launch (the backward's direction) in :data:`LAUNCHES`."""
    n, row_scale, col_scale = _shape(x, scale, num_rows, row_scale,
                                     col_scale)
    _check(x, groups, tile, n, row_scale, col_scale)
    tensors = [t for grp in groups for t in grp] + [x, row_scale, col_scale]
    if not on_cuda("bsr_spmm", *tensors):
        return bsr_spmm_blocks_plain(x, groups, tile, num_rows=n,
                                     row_scale=row_scale,
                                     col_scale=col_scale)
    chunks = split_plan(group_shapes(groups), tile, x.shape[1],
                        sm_count(x.device))
    out, partial = bsr_spmm_split(x, groups, tile, chunks,
                                  transposed=transposed, num_rows=n,
                                  row_scale=row_scale, col_scale=col_scale)
    if partial is not None:
        bsr_spmm_combine(partial, out, groups, tile, chunks, scale=row_scale)
    return out
