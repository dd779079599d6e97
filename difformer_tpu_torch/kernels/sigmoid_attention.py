"""Flash sigmoid attention (DIFFormer-a): CUDA kernels, plain versions and
the autograd Functions around them.

Counterpart of ``difformer_tpu/kernels/pallas_sigmoid_attention.py``. Three
hand-written Hopper kernels in ``csrc/sigmoid_attention.cu`` replace the three
Pallas TPU kernels:

===============================  ===========================================
wrapper here                     TPU kernel it replaces
===============================  ===========================================
:func:`sigmoid_attention_fwd`    ``_fwd_kernel`` via
                                 ``_sigmoid_attention_pallas_fwd_impl`` (K2)
:func:`sigmoid_attention_dq`     ``_bwd_dq_kernel`` via ``_pallas_bwd_kernels``
                                 (K3)
:func:`sigmoid_attention_dkv`    ``_bwd_dkv_kernel`` via
                                 ``_pallas_bwd_kernels`` (K4)
===============================  ===========================================

What bounds them on an H100: multiply-adds. For N queries, L keys, H heads
and widths M, D, K2 does 2·N·L·H·(M+D+1) flops, K3 2·N·L·H·(2M+D) and K4
2·N·L·H·(2M+2D), plus N·L·H sigmoids each, while moving only
O((N+L)·H·(M+D)) bytes. The kernels keep every [N, L] score tile in shared
memory and registers (recomputed in the backward, as the TPU kernels do), so
device memory traffic stays at that floor. The narrow kernels multiply
with FFMA; the wide K2, K3 and K4 on the tensor cores, in split-precision
TF32 at float32 inputs (see the source's header).

Each wrapper runs its kernel on a CUDA tensor and counts the launch in
:data:`LAUNCHES`; on a CPU tensor it runs the plain PyTorch version beside
it, which keeps the kernel's rounding points: s in v's dtype before s·v and
in the denominator, dnum in v's dtype in ds and dv, dl in k's dtype for dq
and in q's dtype for dk, with f32 products and sums otherwise.

``key_mask`` must be binary (0/1): the backward takes the sigmoid derivative
of the masked score, as the TPU kernels do.

The kernels take any widths M and D, as the TPU kernels do. Up to
:data:`NARROW_WIDTH` a block holds whole feature columns of its own tile;
above it (the set track's hidden 300 and 400) each kernel takes its wide
path, which streams the other side's tiles through shared memory 64
features at a time, through a ring of cp.async stages, with the block's own
tiles resident where they fit.
"""

from __future__ import annotations

import functools

import torch

from difformer_tpu_torch.kernels.build import load_library
from difformer_tpu_torch.utils.device import on_cuda

#: Kernel launches since the last :func:`reset_launch_counts`, by wrapper.
LAUNCHES = {
    "sigmoid_attention_fwd": 0,
    "sigmoid_attention_dq": 0,
    "sigmoid_attention_dkv": 0,
}

#: Widest M and D of the kernels' narrow path (kNarrowWidth in the source),
#: whose blocks hold whole feature columns of their own tile in shared
#: memory. Wider problems (the set track's hidden 300 and 400) take the wide
#: path, which streams every tile through shared memory 64 features at a
#: time.
NARROW_WIDTH = 256
#: Output features a block of the wide path holds, by wrapper: K2's and
#: K3's 7 chunks of 64 (kFwdChunks and kDqChunks in the source: 112 f32
#: accumulators a thread in tensor-core fragments), and K4's 7 chunks of dk
#: and 7 of dv side by side (kDkvChunks: one block takes both from one pass
#: over s up to M, D = 448). Wider outputs go to further blocks on the
#: grid's z axis, which compute the same scores again.
WIDE_COLUMNS = {
    "sigmoid_attention_fwd": 448,
    "sigmoid_attention_dq": 448,
    "sigmoid_attention_dkv": 448,
}
#: Rows of the tiles each wide kernel owns: K4's blocks own 32 keys (with
#: 448 features of dk and of dv a block, 64 keys would need 224 f32 a
#: thread), the others 64 rows.
WIDE_OWN_TILE = {
    "sigmoid_attention_fwd": 64,
    "sigmoid_attention_dq": 64,
    "sigmoid_attention_dkv": 32,
}
#: Blocks per SM that each wide kernel's split aims at (loop_splits). One
#: block runs on an SM at a time (156–220 KB of shared memory and up to
#: 235 registers a thread), so the target sets the waves: at N = L = 15000
#: on 132 SMs, K2's and K3's 235 row tiles split 5 ways make 8.9 waves (1.8
#: unsplit) and K4's 469 tiles of 32 keys 17.8 (3.6). Timed on an H100
#: against targets of 1, 4, 8 and 15 (K3 also 6, 10 and 12;
#: ``time_kernels.py --wide --blocks-per-sm``, PERF.md): unsplit, the last
#: wave's idle SMs cost up to 11 %.
WIDE_BLOCKS_PER_SM = {
    "sigmoid_attention_fwd": 8,
    "sigmoid_attention_dq": 8,
    "sigmoid_attention_dkv": 15,
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: Rows of one tile, query rows or keys (kTile in the source): the kernels
#: split their loop axis in chunks of whole tiles.
TILE = 64
#: Blocks per SM that each kernel's split aims at: one wave of the blocks an
#: SM holds at once at M = D = 64 (K2 three, by registers and shared memory;
#: K3 and K4 two, by their 85 and 102 KB of shared memory). Timed on an H100
#: against other targets (``time_kernels.py``, PERF.md).
FWD_BLOCKS_PER_SM = 3
DQ_BLOCKS_PER_SM = 2
DKV_BLOCKS_PER_SM = 2


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Plain versions (CPU path; the card compares the kernels with them)
# ---------------------------------------------------------------------------

def _heads_first(x):
    """[rows, H, C] in any float dtype -> [H, rows, C] float32."""
    return x.float().transpose(0, 1)


def _scores(q, k, key_mask):
    """s = σ(q·kᵀ) × key_mask, [H, N, L] float32."""
    s = torch.sigmoid(_heads_first(q) @ _heads_first(k).transpose(1, 2))
    if key_mask is not None:
        s = s * key_mask.float()
    return s


def _dlogits(q, k, v, key_mask, dnum, dden):
    """(s, dl) with ds = dnum·vᵀ + dden and dl = ds·s·(1−s), [H, N, L]."""
    s = _scores(q, k, key_mask)
    dn = _heads_first(dnum.to(v.dtype))
    ds = dn @ _heads_first(v).transpose(1, 2) + dden.float().t()[..., None]
    return s, ds * s * (1.0 - s)


def sigmoid_attention_fwd_plain(q, k, v, key_mask=None, *, normalize=True):
    s = _scores(q, k, key_mask).to(v.dtype).float()
    num = s @ _heads_first(v)                      # [H, N, D]
    den = s.sum(-1)                                # [H, N]
    out = (num / den[..., None]).to(q.dtype) if normalize else num
    return out.transpose(0, 1).contiguous(), den.t().contiguous()


def sigmoid_attention_dq_plain(q, k, v, key_mask, dnum, dden):
    _, dl = _dlogits(q, k, v, key_mask, dnum, dden)
    dq = dl.to(k.dtype).float() @ _heads_first(k)
    return dq.transpose(0, 1).to(q.dtype).contiguous()


def sigmoid_attention_dkv_plain(q, k, v, key_mask, dnum, dden):
    s, dl = _dlogits(q, k, v, key_mask, dnum, dden)
    dk = dl.to(q.dtype).float().transpose(1, 2) @ _heads_first(q)
    dv = (s.to(v.dtype).float().transpose(1, 2)
          @ _heads_first(dnum.to(v.dtype)))
    return (dk.transpose(0, 1).to(k.dtype).contiguous(),
            dv.transpose(0, 1).to(v.dtype).contiguous())


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check(q, k, v, key_mask):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k, v must be [N, H, M], [L, H, M], [L, H, D]")
    (n, h, m), (l, hk, mk), (lv, hv, d) = q.shape, k.shape, v.shape
    if hk != h or hv != h or mk != m or lv != l:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the kernels take float32 or bfloat16 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if n == 0 or l == 0:
        raise ValueError("sigmoid attention needs at least one query and key")
    if key_mask is not None and key_mask.shape != (l,):
        raise ValueError(f"key_mask must be [L]={l}, got "
                         f"{tuple(key_mask.shape)}")
    devices = {t.device for t in (q, k, v, key_mask) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")


def _args(q, k, v, key_mask):
    """Common leading arguments of the C entry points."""
    mask = None if key_mask is None else key_mask.float().contiguous()
    n, h, m = q.shape
    l, _, d = v.shape
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr()]
    dims = [n, l, h, m, d]
    strides = [*q.stride(), *k.stride(), *v.stride()]
    return mask, ptrs, dims, strides


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _cdiv(a, b):
    return -(-a // b)


def is_wide(m, d):
    """Whether widths M, D take the kernels' wide path."""
    return max(m, d) > NARROW_WIDTH


def loop_splits(own, loop, per_tile, sms, blocks_per_sm, own_tile=TILE):
    """(S, loop tiles per split): the one split rule of K2–K4.

    A kernel launches ``per_tile`` blocks (heads, feature groups) for each
    tile of the ``own`` rows it writes, and each block loops over the tiles
    of the ``loop`` rows on the other side: K2 and K3 own queries and loop
    over keys, K4 the reverse. Split S ways, each block takes a contiguous
    chunk of whole loop tiles, and a second kernel sums the S partials. S
    grows until the grid reaches ``blocks_per_sm`` blocks on each of the
    card's ``sms`` SMs, then is recomputed from the chunk size, so no split
    is empty; S = 1 when the own tiles alone reach that target. Own tiles
    are ``own_tile`` rows (K4's wide path: 32 keys), loop tiles ``TILE``."""
    own_blocks = _cdiv(own, own_tile) * per_tile
    tiles = _cdiv(loop, TILE)
    target = blocks_per_sm * sms
    if own_blocks >= target:
        return 1, tiles
    chunk = _cdiv(tiles, min(tiles, _cdiv(target, own_blocks)))
    return _cdiv(tiles, chunk), chunk


def split_plan(name, n, l, h, m, d, sms):
    """(blocks of one split, S, loop tiles per split) that the wrapper
    ``name`` launches at N queries, L keys, H heads and widths M, D on a card
    of ``sms`` SMs; the grid has S times the first number of blocks."""
    if name == "sigmoid_attention_fwd":
        own, loop, per_tile, per_sm = n, l, h, FWD_BLOCKS_PER_SM
    elif name == "sigmoid_attention_dkv":
        # one block per group of TILE output features of dk and dv
        own, loop, per_sm = l, n, DKV_BLOCKS_PER_SM
        per_tile = h * _cdiv(max(m, d), TILE)
    elif name == "sigmoid_attention_dq":
        # one block per group of TILE features of dq
        own, loop, per_sm = n, l, DQ_BLOCKS_PER_SM
        per_tile = h * _cdiv(m, TILE)
    else:
        raise ValueError(f"no split plan for {name}")
    own_tile = TILE
    if is_wide(m, d):
        # one block per group of WIDE_COLUMNS output features, counted in
        # whole chunks of TILE (K4: of dk and of dv side by side)
        chunks = {"sigmoid_attention_fwd": _cdiv(d, TILE),
                  "sigmoid_attention_dq": _cdiv(m, TILE),
                  "sigmoid_attention_dkv": _cdiv(max(m, d), TILE)}[name]
        per_tile = h * _cdiv(chunks, WIDE_COLUMNS[name] // TILE)
        per_sm, own_tile = WIDE_BLOCKS_PER_SM[name], WIDE_OWN_TILE[name]
    splits, chunk = loop_splits(own, loop, per_tile, sms, per_sm, own_tile)
    return _cdiv(own, own_tile) * per_tile, splits, chunk


@functools.lru_cache(maxsize=None)
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _split(name, q, v, floats):
    """(S, chunk, workspace) for the kernel of wrapper ``name``: with S > 1
    the workspace holds S slabs of ``floats`` raw f32 partials, else it is
    None. The caller holds it until the kernel is launched."""
    n, h, m = q.shape
    l, _, d = v.shape
    _, splits, chunk = split_plan(name, n, l, h, m, d, _sm_count(q.device))
    ws = (torch.empty(splits * floats, device=q.device, dtype=torch.float32)
          if splits > 1 else None)
    return splits, chunk, ws


def _ptr(t):
    return None if t is None else t.data_ptr()


def sigmoid_attention_fwd(q, k, v, key_mask=None, *, normalize=True):
    """K2. q [N,H,M], k [L,H,M], v [L,H,D], key_mask [L] or None →
    (out [N,H,D], den [N,H] f32). ``normalize=False`` returns the raw
    numerator Σσ(q·k)·v in f32 instead of num/den (the form that partial
    results over key shards can be summed in)."""
    _check(q, k, v, key_mask)
    if not on_cuda("sigmoid attention", q, k, v, key_mask):
        return sigmoid_attention_fwd_plain(q, k, v, key_mask,
                                           normalize=normalize)
    n, h, _ = q.shape
    d = v.shape[2]
    out = torch.empty((n, h, d), device=q.device,
                      dtype=q.dtype if normalize else torch.float32)
    den = torch.empty((n, h), device=q.device, dtype=torch.float32)
    # raw f32 partials of the S splits: num [S, N, H, D] then den [S, N, H]
    splits, chunk, ws = _split("sigmoid_attention_fwd", q, v, n * h * (d + 1))
    mask, ptrs, dims, strides = _args(q, k, v, key_mask)
    rc = load_library().sigattn_fwd(
        _DTYPES[q.dtype], int(normalize), *ptrs, out.data_ptr(),
        den.data_ptr(), _ptr(ws), *dims, splits, chunk, *strides, _stream(q))
    _raise_on(rc, "sigmoid_attention_fwd")
    LAUNCHES["sigmoid_attention_fwd"] += 1
    return out, den


def _grads_in(q, dnum, dden):
    n, h, _ = q.shape
    if dnum.shape[:2] != (n, h) or dden.shape != (n, h):
        raise ValueError(f"dnum must be [N,H,D] and dden [N,H] for N={n}, "
                         f"H={h}, got {tuple(dnum.shape)}, {tuple(dden.shape)}")
    return dnum.float().contiguous(), dden.float().contiguous()


def sigmoid_attention_dq(q, k, v, key_mask, dnum, dden):
    """K3. dq [N,H,M] in q's dtype from the cotangents dnum [N,H,D] and
    dden [N,H] of the raw numerator and denominator."""
    _check(q, k, v, key_mask)
    if not on_cuda("sigmoid attention", q, k, v, key_mask, dnum, dden):
        return sigmoid_attention_dq_plain(q, k, v, key_mask, dnum, dden)
    dnum, dden = _grads_in(q, dnum, dden)
    dq = torch.empty(q.shape, device=q.device, dtype=q.dtype)
    # raw f32 partials of the S splits: dq [S, N, H, M]
    splits, chunk, ws = _split("sigmoid_attention_dq", q, v, q.numel())
    mask, ptrs, dims, strides = _args(q, k, v, key_mask)
    rc = load_library().sigattn_dq(
        _DTYPES[q.dtype], *ptrs, dnum.data_ptr(), dden.data_ptr(),
        dq.data_ptr(), _ptr(ws), *dims, splits, chunk, *strides, _stream(q))
    _raise_on(rc, "sigmoid_attention_dq")
    LAUNCHES["sigmoid_attention_dq"] += 1
    return dq


def sigmoid_attention_dkv(q, k, v, key_mask, dnum, dden):
    """K4. (dk [L,H,M], dv [L,H,D]) in k's and v's dtype."""
    _check(q, k, v, key_mask)
    if not on_cuda("sigmoid attention", q, k, v, key_mask, dnum, dden):
        return sigmoid_attention_dkv_plain(q, k, v, key_mask, dnum, dden)
    dnum, dden = _grads_in(q, dnum, dden)
    dk = torch.empty(k.shape, device=k.device, dtype=k.dtype)
    dv = torch.empty(v.shape, device=v.device, dtype=v.dtype)
    # raw f32 partials of the S splits: dk [S, L, H, M] then dv [S, L, H, D]
    splits, chunk, ws = _split("sigmoid_attention_dkv", q, v,
                               k.numel() + v.numel())
    mask, ptrs, dims, strides = _args(q, k, v, key_mask)
    rc = load_library().sigattn_dkv(
        _DTYPES[q.dtype], *ptrs, dnum.data_ptr(), dden.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), _ptr(ws), *dims, splits, chunk,
        *strides, _stream(q))
    _raise_on(rc, "sigmoid_attention_dkv")
    LAUNCHES["sigmoid_attention_dkv"] += 1
    return dk, dv


# ---------------------------------------------------------------------------
# Autograd Functions (the two custom_vjp entry points of the TPU module)
# ---------------------------------------------------------------------------

class SigmoidAttention(torch.autograd.Function):
    """num/den in q's dtype; the backward derives dnum = g/den and
    dden = −Σ_d(g·out)/den in torch, then runs K3 and K4
    (``sigmoid_attention_pallas`` ``_fwd``/``_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask):
        out, den = sigmoid_attention_fwd(q, k, v, key_mask)
        ctx.save_for_backward(q, k, v, key_mask, out, den)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_mask, out, den = ctx.saved_tensors
        g32 = g.float()
        dnum = g32 / den[..., None]
        dden = -(g32 * out.float()).sum(-1) / den
        dq = sigmoid_attention_dq(q, k, v, key_mask, dnum, dden)
        dk, dv = sigmoid_attention_dkv(q, k, v, key_mask, dnum, dden)
        return dq, dk, dv, None


class SigmoidAttentionUnnormalized(torch.autograd.Function):
    """(Σσ(q·k)·v [N,H,D] f32, Σσ(q·k) [N,H] f32); the backward takes the
    two cotangents as dnum and dden directly
    (``sigmoid_attention_pallas_unnormalized``)."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask):
        num, den = sigmoid_attention_fwd(q, k, v, key_mask, normalize=False)
        ctx.save_for_backward(q, k, v, key_mask)
        return num, den

    @staticmethod
    def backward(ctx, g_num, g_den):
        q, k, v, key_mask = ctx.saved_tensors
        n, h, _ = q.shape
        if g_num is None:
            g_num = torch.zeros((n, h, v.shape[2]), device=q.device)
        if g_den is None:
            g_den = torch.zeros((n, h), device=q.device)
        dq = sigmoid_attention_dq(q, k, v, key_mask, g_num, g_den)
        dk, dv = sigmoid_attention_dkv(q, k, v, key_mask, g_num, g_den)
        return dq, dk, dv, None


def sigmoid_attention_flash(q, k, v, key_mask=None):
    """[N,H,M] × [L,H,M] × [L,H,D] (+ binary key mask [L]) → [N,H,D],
    differentiable in q, k, v. Pass ``key_mask=None`` when every key is
    real."""
    return SigmoidAttention.apply(q, k, v, key_mask)


def sigmoid_attention_flash_unnormalized(q, k, v, key_mask=None):
    """Raw (numerator f32, denominator f32), differentiable in q, k, v."""
    return SigmoidAttentionUnnormalized.apply(q, k, v, key_mask)
