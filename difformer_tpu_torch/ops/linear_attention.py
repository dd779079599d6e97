"""DIFFormer-s linear global attention ("simple" kernel), as
``difformer_tpu/ops/linear_attention.py:28-268``.

The O(N·d²) form: the N×L attention ``(1 + q·kᵀ) / (N + q·Σk)`` is never
made; only the aggregates ``Σ_l k_l ⊗ v_l`` [H, M, D], ``Σ_l k_l`` [H, M]
and ``Σ_l v_l`` [H, D] are, and each query is rescaled on its own.
Reference semantics: ``node classification/difformer.py:10-43``.

Kept from the reference on purpose: q and k are each divided by one
Frobenius norm over the whole tensor (``torch.norm(qs, p=2)``), and the
numerator adds the raw ``Σv`` and the denominator the query count N.

These are dense contractions with no kernel of their own (the JAX package
leaves them to XLA): ``torch.einsum`` and matmuls in float32, TF32 off.
:func:`simple_attention_padded` is DIFFormer-v2's per-graph form over a
padded batch [B, M, H, D].
Node-sharded (``axis_name``, the process group of the graph axis,
``parallel/mesh.py``): each rank holds some of the rows, and what the JAX
package sums with ``psum`` is summed with the differentiable all-reduce of
``ops/comm.py``, two a call: the two Frobenius sums of squares with the
global key count, then the key aggregates (kv, Σk and Σv, or the factored
form's kx, Σk and Σx) in one flat buffer. ``num_queries`` then defaults to
the global key count, as in the JAX package (queries are keys on every
model path).

Head-sharded (``head_axis``, the process group of the model axis,
``parallel/tensor_parallel.py``; each rank holds H/T of the ``num_heads``
heads): the two Frobenius sums of squares span every head, so they are
summed over the model axis too (before the graph axis's all-reduce); the
per-head aggregates stay on their rank; a head-mean form divides its sum
over the rank's heads by ``num_heads``, and the caller sums the ranks'
parts (``nn/difformer.py``: one all-reduce a layer).
"""

from __future__ import annotations

import torch

from difformer_tpu_torch.ops import comm


def _scalar(value, like):
    """``jnp.asarray(value, dtype=like.dtype)`` on ``like``'s device. A
    Python number is filled in on the device, not copied from the host: a
    host copy would block the stream and cannot be captured in a CUDA
    graph."""
    if isinstance(value, torch.Tensor):
        return value.to(device=like.device, dtype=like.dtype)
    return like.new_full((), value)


def _frobenius_normalize(t, sumsq=None):
    """t / ||t||_F over the entire tensor, the sum of squares in float32
    (``sumsq``, the global one of a sharded tensor, where given)."""
    norm = torch.sqrt(t.float().square().sum() if sumsq is None else sumsq)
    return (t.float() / norm).to(t.dtype)


def _global_stats(qs, ks, count, axis_name, head_axis=None):
    """(Σq², Σk², count): the sums of squares summed over the model axis
    (``head_axis``; the count is the same on each of its ranks), then
    all three over the graph axis in one all-reduce."""
    sq = [qs.float().square().sum(), ks.float().square().sum()]
    if head_axis is not None:
        sq = comm.all_reduce(torch.stack(sq), head_axis).unbind(0)
    if axis_name is None:
        return (*sq, count)
    stats = torch.stack([*sq, count.float()])
    return comm.all_reduce(stats, axis_name).unbind(0)


def _global_sums(axis_name, *tensors):
    """``tensors`` (of one dtype) summed over the graph axis, in one
    all-reduce of a flat buffer."""
    flat = comm.all_reduce(torch.cat([t.reshape(-1) for t in tensors]),
                           axis_name)
    return [part.view(t.shape) for part, t in zip(
        flat.split([t.numel() for t in tensors]), tensors)]


def _key_count(ks, key_mask):
    """The number of real keys, a float32 scalar tensor (filled in on the
    device, as :func:`_scalar`)."""
    if key_mask is not None:
        return key_mask.float().sum()
    return ks.new_full((), float(ks.shape[0]), dtype=torch.float32)


def simple_attention_aggregates(ks, vs, key_mask=None):
    """The global aggregates. ks [L,H,M] (already normalised), vs [L,H,D]
    (or [L,1,D], broadcast over the heads).

    Returns (kv [H,M,D], k_sum [H,M], v_sum [H,D], count []); with a
    ``key_mask`` the padded rows are left out."""
    count = _key_count(ks, key_mask)
    if key_mask is not None:
        m = key_mask.to(ks.dtype)[:, None, None]
        ks = ks * m
        vs = vs * m
    kv = torch.einsum("lhm,lhd->hmd", ks, vs)
    return kv, ks.sum(0), vs.sum(0), count


def _rescale(qs, kv, k_sum, v_sum, num_queries, num_heads=None):
    """The head-averaged output [N, D] (the sum over qs's heads divided by
    ``num_heads``, by default their count): each head divides by its own
    denominator (q is scaled by it), then h and m contract in one matmul."""
    denominator = torch.einsum("nhm,hm->nh", qs, k_sum) + _scalar(
        num_queries, qs)
    inv_den = 1.0 / denominator                       # [N, H]
    q_scaled = qs * inv_den[..., None]
    return (torch.einsum("nhm,hmd->nd", q_scaled, kv)
            + inv_den @ v_sum) / (num_heads or qs.shape[1])


def simple_attention_head_mean_factored(qs, ks, x, w, b, *, key_mask=None,
                                        num_queries=None, axis_name=None,
                                        head_axis=None, num_heads=None):
    """Head-mean DIFFormer-s attention with the value projection factored
    through the key aggregates: ``simple_attention(qs, ks, x @ w + b,
    head_mean=True)`` up to float reassociation, without the [N, H, D] value
    tensor:

        kv[h,m,d] = (Σ_l k[l,h,m]·x[l,f])·w[f,h,d] + k_sum[h,m]·b[h,d]
        Σv[h,d]   = (Σ_l x[l])·w_h + count·b_h

    qs/ks [N, H, M]; x [N, F]; w [F, H, D]; b [H, D] or None → [N, D].
    With ``axis_name`` the sums of squares, kx, Σk, Σx and the key count
    are summed over the graph axis; with ``head_axis`` the sums of squares
    over the model axis, and the output is this rank's part of the mean
    over ``num_heads`` heads (the module's docstring)."""
    count = _key_count(ks, key_mask)
    if key_mask is not None:
        m = key_mask.to(qs.dtype)[:, None, None]
        ks = ks * m
        if qs.shape[0] == ks.shape[0]:
            qs = qs * m
        x = x * key_mask.to(x.dtype)[:, None]
    if axis_name is None and head_axis is None:
        sumsq_q = qs.float().square().sum()
        sumsq_k = ks.float().square().sum()
    else:
        sumsq_q, sumsq_k, count = _global_stats(qs, ks, count, axis_name,
                                                head_axis)
    kx = torch.einsum("lhm,lf->hmf", ks, x)          # [H, M, F]
    k_sum = ks.sum(0)                                 # [H, M]
    x_sum = x.sum(0)                                  # [F]
    if axis_name is not None:
        kx, k_sum, x_sum = _global_sums(axis_name, kx, k_sum, x_sum)
        if num_queries is None:
            num_queries = count
    if num_queries is None:
        num_queries = qs.shape[0]
    inv_scale = torch.rsqrt(sumsq_q) * torch.rsqrt(sumsq_k)

    w = w.to(qs.dtype)
    kv = torch.einsum("hmf,fhd->hmd", kx, w)
    v_sum = torch.einsum("f,fhd->hd", x_sum.to(qs.dtype), w)
    if b is not None:
        b = b.to(qs.dtype)
        kv = kv + k_sum[..., None] * b[:, None, :]
        v_sum = v_sum + count.to(qs.dtype) * b
    kv = (kv.float() * inv_scale).to(qs.dtype)
    k_sum = (k_sum.float() * inv_scale).to(qs.dtype)
    return _rescale(qs, kv, k_sum, v_sum, num_queries, num_heads)


def simple_attention(qs, ks, vs, *, key_mask=None, num_queries=None,
                     output_attn=False, axis_name=None, head_mean=False,
                     head_axis=None, num_heads=None):
    """DIFFormer-s attention. qs [N,H,M], ks [L,H,M], vs [L,H,D] → [N,H,D].

    ``num_queries`` overrides the ``+N`` denominator term. ``key_mask``
    zeroes padded keys (and the queries too when N = L) before the norms,
    so padding does not move them. ``head_mean=True`` returns the
    head-averaged [N, D] directly, with the Frobenius scalars folded onto
    the small aggregates (float reassociation only). ``output_attn`` also
    returns the explicit [N, L, H] attention, divided by the intended
    [N, 1, H] normaliser (the reference's [N, H, 1] fails for H > 1).
    With ``axis_name`` the sums of squares, the aggregates and the key
    count are summed over the graph axis; with ``head_axis`` the sums of
    squares over the model axis, and ``head_mean`` gives this rank's part
    of the mean over ``num_heads`` heads (the module's docstring)."""
    if output_attn and head_axis is not None:
        raise ValueError("output_attn needs every head on one rank")
    if key_mask is not None:
        m = key_mask.to(qs.dtype)[:, None, None]
        ks = ks * m
        if qs.shape[0] == ks.shape[0]:  # queries == keys on every model path
            qs = qs * m
    sumsq_q = sumsq_k = None
    if axis_name is not None or head_axis is not None:
        sumsq_q, sumsq_k, count = _global_stats(
            qs, ks, _key_count(ks, key_mask), axis_name, head_axis)
        if axis_name is not None and num_queries is None:
            num_queries = count
    if num_queries is None:
        num_queries = qs.shape[0]

    def aggregates(ks):
        kv, k_sum, v_sum, _ = simple_attention_aggregates(ks, vs, key_mask)
        if axis_name is None:
            return kv, k_sum, v_sum
        return _global_sums(axis_name, kv, k_sum, v_sum)

    if head_mean and not output_attn:
        if sumsq_q is None:
            sumsq_q = qs.float().square().sum()
            sumsq_k = ks.float().square().sum()
        inv_scale = torch.rsqrt(sumsq_q) * torch.rsqrt(sumsq_k)
        kv, k_sum, v_sum = aggregates(ks)
        kv = (kv.float() * inv_scale).to(qs.dtype)
        k_sum = (k_sum.float() * inv_scale).to(qs.dtype)
        return _rescale(qs, kv, k_sum, v_sum, num_queries, num_heads)
    qs = _frobenius_normalize(qs, sumsq_q)
    ks = _frobenius_normalize(ks, sumsq_k)
    kv, k_sum, v_sum = aggregates(ks)
    denominator = torch.einsum("nhm,hm->nh", qs, k_sum) + _scalar(
        num_queries, qs)
    numerator = torch.einsum("nhm,hmd->nhd", qs, kv) + v_sum[None]
    out = numerator / denominator[..., None]
    if output_attn:
        attn = (torch.einsum("nhm,lhm->nlh", qs, ks)
                / denominator[:, None, :])
        return out, attn
    return out


def simple_attention_padded(q_pad, k_pad, v_pad, node_mask, n_nodes):
    """Per-graph linear attention over a padded batch (DIFFormer-v2
    "simple", ``physical particle/difformer-v2.py:80-111``).

    q_pad/k_pad/v_pad [B, M, H, D]; node_mask bool [B, M]; n_nodes [B].
    q and k are divided by one Frobenius norm over the whole batch (folded
    onto the per-graph aggregates, as the JAX package does), the aggregates
    are each graph's own, and each graph's denominator adds its node
    count. Padded slots and padding graphs give 0. The denominator is made
    safe (1 on padded slots) before the divide: masking only the quotient
    would leave 0/0 in the gradient."""
    mask = node_mask[..., None, None].to(q_pad.dtype)
    q_pad = q_pad * mask
    k_pad = k_pad * mask
    v_pad = v_pad * mask
    inv_q = 1.0 / torch.sqrt(q_pad.float().square().sum())
    inv_k = 1.0 / torch.sqrt(k_pad.float().square().sum())
    scale = (inv_q * inv_k).to(q_pad.dtype)

    kv = torch.einsum("bmhk,bmhd->bhkd", k_pad, v_pad)      # [B, H, K, D]
    k_sum = k_pad.sum(1)                                     # [B, H, K]
    v_sum = v_pad.sum(1)                                     # [B, H, D]

    numerator = torch.einsum("bmhk,bhkd->bmhd", q_pad, kv * scale)
    numerator = numerator + v_sum[:, None, :, :]
    denominator = torch.einsum("bmhk,bhk->bmh", q_pad, k_sum * scale)
    denominator = denominator + n_nodes.to(q_pad.dtype)[:, None, None]
    mask3 = node_mask[..., None]
    denominator = torch.where(mask3, denominator,
                              torch.ones_like(denominator))
    out = numerator / denominator[..., None]
    return torch.where(mask3[..., None], out, torch.zeros_like(out))
