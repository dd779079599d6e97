"""DIFFormer-a sigmoid pairwise attention (O(N²)), as
``difformer_tpu/ops/sigmoid_attention.py:29-232``.

Reference semantics (``node classification/difformer.py:45-56``):
``att = σ(q·k) / row_sum(σ(q·k))``, ``out = att @ v``.

:func:`sigmoid_attention` always takes the flash path: on a CUDA tensor it
launches the hand-written kernels (``kernels/sigmoid_attention.py``) whatever
N is, and on a CPU tensor their plain versions. The JAX package's TPU
dispatch (dense below N = 8192) is not carried over: that threshold was
measured on a TPU; a rule measured on the H100 is later work.
:func:`sigmoid_attention_dense` keeps the explicit [N, L, H] matrix for the
``output_attn`` path.

:func:`sigmoid_attention_padded` and
:func:`sigmoid_attention_padded_crossgraph` are DIFFormer-v2's forms over a
padded batch [B, M, H, D]: dense [B, M, M, H] scores through ``torch``
einsums, as in the JAX package (no Pallas kernel there either; a graph has
about a hundred nodes).

A value tensor with one head ([L, 1, D], DIFFormer with ``use_weight=False``)
is broadcast over the query heads, as the JAX package's einsums do.
"""

from __future__ import annotations

import torch

from difformer_tpu_torch.kernels.sigmoid_attention import (
    sigmoid_attention_flash,
)


def _broadcast_heads(qs, vs):
    if vs.shape[1] != qs.shape[1]:
        return vs.expand(-1, qs.shape[1], -1)
    return vs


def sigmoid_attention_dense(qs, ks, vs, *, key_mask=None, output_attn=False):
    """Explicit [N, L, H] attention. qs [N,H,M], ks [L,H,M], vs [L,H,D]."""
    vs = _broadcast_heads(qs, vs)
    scores = torch.sigmoid(torch.einsum("nhm,lhm->nlh", qs, ks))
    if key_mask is not None:
        scores = scores * key_mask.to(scores.dtype)[None, :, None]
    denom = scores.sum(dim=1, keepdim=True)  # [N, 1, H]
    attn = scores / denom
    out = torch.einsum("nlh,lhd->nhd", attn, vs)
    if output_attn:
        return out, attn
    return out


def sigmoid_attention(qs, ks, vs, *, key_mask=None):
    """Flash sigmoid attention. qs [N,H,M], ks [L,H,M], vs [L,H,D] or
    [L,1,D]; ``key_mask`` an optional binary [L] marking real keys."""
    return sigmoid_attention_flash(qs, ks, _broadcast_heads(qs, vs),
                                   key_mask)


def sigmoid_attention_padded(q_pad, k_pad, v_pad, node_mask, *, eps=1e-9):
    """Within-graph sigmoid attention over a padded batch: each node
    attends to the real nodes of its own graph (the intended DIFFormer-v2
    semantics). q/k/v [B, M, H, D]; node_mask bool [B, M]; padded slots
    give 0."""
    m = node_mask.to(q_pad.dtype)
    scores = torch.sigmoid(torch.einsum("bmhd,bnhd->bmnh", q_pad, k_pad))
    scores = scores * m[:, None, :, None]
    denom = scores.sum(2, keepdim=True) + eps
    attn = scores / denom
    out = torch.einsum("bmnh,bnhd->bmhd", attn, v_pad)
    return torch.where(node_mask[..., None, None], out, torch.zeros_like(out))


def sigmoid_attention_padded_crossgraph(q_pad, k_pad, v_pad, node_mask,
                                        *, eps=1e-9):
    """The reference's DIFFormer-v2 "sigmoid" kernel as it is
    (``physical particle/difformer-v2.py:113-135``, einsum
    "abcd,ebcd->aebc"): slot m of graph a attends to slot m of every graph
    e, padding zeros included (σ(0) = 0.5 enters the normaliser).
    ``node_mask`` is not read, as the reference reads none."""
    del node_mask
    scores = torch.sigmoid(torch.einsum("amhd,emhd->aemh", q_pad, k_pad))
    denom = scores.sum(1, keepdim=True) + eps          # [B, 1, M, H]
    attn = scores / denom
    return torch.einsum("aemh,emhd->amhd", attn, v_pad)
