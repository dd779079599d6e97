"""PyTorch ``nn.Linear`` initialisation from an explicit generator, as
``difformer_tpu/nn/init.py``: weight and bias both U(−1/√fan_in, 1/√fan_in)
(the reference's default ``nn.Linear`` init)."""

from __future__ import annotations

import torch
from torch import nn


@torch.no_grad()
def torch_linear_init_(linear: nn.Linear, generator: torch.Generator):
    """Draw ``linear``'s weight, then its bias, from ``generator``.

    The draw happens on the CPU and is copied to the layer's device, so the
    same generator gives the same weights on every device."""
    bound = 1.0 / linear.in_features ** 0.5
    for p in (linear.weight, linear.bias):
        if p is None:
            continue
        cpu = torch.empty(p.shape, dtype=p.dtype)
        nn.init.uniform_(cpu, -bound, bound, generator=generator)
        p.copy_(cpu)
