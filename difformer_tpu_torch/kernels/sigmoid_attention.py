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
device memory traffic stays at that floor; this first version multiplies
with FFMA, not tensor cores (see the source's header).

Each wrapper runs its kernel on a CUDA tensor and counts the launch in
:data:`LAUNCHES`; on a CPU tensor it runs the plain PyTorch version beside
it, which keeps the kernel's rounding points: s in v's dtype before s·v and
in the denominator, dnum in v's dtype in ds and dv, dl in k's dtype for dq
and in q's dtype for dk, with f32 products and sums otherwise.

``key_mask`` must be binary (0/1): the backward takes the sigmoid derivative
of the masked score, as the TPU kernels do.
"""

from __future__ import annotations

import torch

from difformer_tpu_torch.kernels.build import load_library

#: Kernel launches since the last :func:`reset_launch_counts`, by wrapper.
LAUNCHES = {
    "sigmoid_attention_fwd": 0,
    "sigmoid_attention_dq": 0,
    "sigmoid_attention_dkv": 0,
}

MAX_WIDTH = 256  # largest M and D the kernels take (kMaxWidth in the source)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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

def _on_cuda(*tensors):
    """True for CUDA tensors, False for CPU tensors; raises otherwise."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"sigmoid attention needs all tensors on one CUDA device "
                     f"or all on the CPU, got {sorted(kinds)}")


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
    if m > MAX_WIDTH or d > MAX_WIDTH:
        raise ValueError(f"the kernels take M, D <= {MAX_WIDTH}, got M={m}, "
                         f"D={d}")
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


def sigmoid_attention_fwd(q, k, v, key_mask=None, *, normalize=True):
    """K2. q [N,H,M], k [L,H,M], v [L,H,D], key_mask [L] or None →
    (out [N,H,D], den [N,H] f32). ``normalize=False`` returns the raw
    numerator Σσ(q·k)·v in f32 instead of num/den (the form that partial
    results over key shards can be summed in)."""
    _check(q, k, v, key_mask)
    if not _on_cuda(q, k, v, key_mask):
        return sigmoid_attention_fwd_plain(q, k, v, key_mask,
                                           normalize=normalize)
    n, h, _ = q.shape
    d = v.shape[2]
    out = torch.empty((n, h, d), device=q.device,
                      dtype=q.dtype if normalize else torch.float32)
    den = torch.empty((n, h), device=q.device, dtype=torch.float32)
    mask, ptrs, dims, strides = _args(q, k, v, key_mask)
    rc = load_library().sigattn_fwd(
        _DTYPES[q.dtype], int(normalize), *ptrs, out.data_ptr(),
        den.data_ptr(), *dims, *strides, _stream(q))
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
    if not _on_cuda(q, k, v, key_mask, dnum, dden):
        return sigmoid_attention_dq_plain(q, k, v, key_mask, dnum, dden)
    dnum, dden = _grads_in(q, dnum, dden)
    dq = torch.empty(q.shape, device=q.device, dtype=q.dtype)
    mask, ptrs, dims, strides = _args(q, k, v, key_mask)
    rc = load_library().sigattn_dq(
        _DTYPES[q.dtype], *ptrs, dnum.data_ptr(), dden.data_ptr(),
        dq.data_ptr(), *dims, *strides, _stream(q))
    _raise_on(rc, "sigmoid_attention_dq")
    LAUNCHES["sigmoid_attention_dq"] += 1
    return dq


def sigmoid_attention_dkv(q, k, v, key_mask, dnum, dden):
    """K4. (dk [L,H,M], dv [L,H,D]) in k's and v's dtype."""
    _check(q, k, v, key_mask)
    if not _on_cuda(q, k, v, key_mask, dnum, dden):
        return sigmoid_attention_dkv_plain(q, k, v, key_mask, dnum, dden)
    dnum, dden = _grads_in(q, dnum, dden)
    dk = torch.empty(k.shape, device=k.device, dtype=k.dtype)
    dv = torch.empty(v.shape, device=v.device, dtype=v.dtype)
    mask, ptrs, dims, strides = _args(q, k, v, key_mask)
    rc = load_library().sigattn_dkv(
        _DTYPES[q.dtype], *ptrs, dnum.data_ptr(), dden.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), *dims, *strides, _stream(q))
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
