"""Shared building blocks, as ``difformer_tpu/nn/common.py:13-51``."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


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
