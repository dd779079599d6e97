"""Shared building blocks, as ``difformer_tpu/nn/common.py:13-95``."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class Linear(nn.Linear):
    """``nn.Linear`` that computes in the input's dtype, as the JAX
    package's ``TorchLinear`` (``x @ kernel.astype(x.dtype) +
    bias.astype(y.dtype)``): the parameters stay float32 and the gradient
    flows through the cast to them. At the parameters' own dtype it is
    ``nn.Linear``'s one fused product."""

    def forward(self, x):
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        y = F.linear(x, self.weight.to(x.dtype))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` (eps 1e-5, affine) with its statistics in f32 and
    its output in the input dtype. The reference's ``use_bn`` flag builds
    this LayerNorm (``node classification/difformer.py:162``)."""

    def __init__(self, normalized_shape, eps=1e-5, **kw):
        super().__init__(normalized_shape, eps=eps, **kw)

    def forward(self, x):
        y = F.layer_norm(x.float(), self.normalized_shape,
                         self.weight.float(), self.bias.float(), self.eps)
        return y.to(x.dtype)


def dropout(x, p: float, training: bool,
            generator: Optional[torch.Generator] = None):
    """Inverted dropout drawing its mask from ``generator`` (on x's device;
    the default generator when None). Identity outside training."""
    if not training or p == 0.0:
        return x
    keep = torch.rand(x.shape, device=x.device, generator=generator) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


class TorchBatchNorm(nn.Module):
    """The baseline zoo's BatchNorm over the node axis, as the JAX package's
    ``TorchBatchNorm`` and ``nn/gnns.py:_BN`` (flax ``nn.BatchNorm``, eps
    1e-5, momentum 0.1 in torch's convention): in training it normalises
    by the batch's mean and biased variance and moves the running
    statistics 0.1 of the way to them; in evaluation it uses the running
    statistics. As flax does, the running variance takes the biased batch
    variance (``nn.BatchNorm1d`` would take the unbiased one). Parameters
    ``weight``/``bias`` and buffers ``running_mean``/``running_var`` carry
    flax's ``scale``/``bias`` and ``batch_stats`` ``mean``/``var``."""

    def __init__(self, num_features, eps=1e-5, momentum=0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def reset_parameters(self):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x):
        if self.training:
            mean = x.mean(0)
            var = (x - mean).square().mean(0)
            with torch.no_grad():
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        scale = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * scale + self.bias


class FeatEncoder(nn.Module):
    """Mixed categorical and scalar node features (reference
    ``FeatEncoder``, ``physical particle/utils/model_utils.py``), as the JAX
    package's: the first ``len(categorical_cardinalities)`` columns are
    category ids, each embedded in ``hidden`` (``embed_{i}``); the rest,
    if any, go through one Linear (``scalar``); the parts are concatenated
    and projected to ``hidden`` (``proj``). ``in_channels`` counts all
    columns. :meth:`reset_parameters` draws the embeddings from N(0, 1),
    torch's ``nn.Embedding`` default, and the Linears as the reference."""

    def __init__(self, in_channels, hidden, categorical_cardinalities=()):
        super().__init__()
        self.cardinalities = tuple(int(c) for c in categorical_cardinalities)
        n_cat = len(self.cardinalities)
        for i, card in enumerate(self.cardinalities):
            setattr(self, f"embed_{i}", nn.Embedding(card, hidden))
        self.scalar = (Linear(in_channels - n_cat, hidden)
                       if in_channels > n_cat else None)
        parts = n_cat + (self.scalar is not None)
        self.proj = Linear(hidden * parts, hidden)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        from difformer_tpu_torch.nn.init import torch_linear_init_

        for i in range(len(self.cardinalities)):
            weight = getattr(self, f"embed_{i}").weight
            weight.copy_(torch.randn(weight.shape, generator=generator))
        if self.scalar is not None:
            torch_linear_init_(self.scalar, generator)
        torch_linear_init_(self.proj, generator)

    def forward(self, x):
        n_cat = len(self.cardinalities)
        parts = [getattr(self, f"embed_{i}")(x[..., i].long())
                 for i in range(n_cat)]
        if self.scalar is not None:
            parts.append(self.scalar(x[..., n_cat:]))
        h = torch.cat(parts, -1) if len(parts) > 1 else parts[0]
        return self.proj(h)
