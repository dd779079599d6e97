"""The optimiser of every reference trainer, as
``difformer_tpu/train/optim.py:15-21``: ``torch.optim.Adam`` with
``weight_decay``, i.e. coupled L2 decay added to the gradient before the
moment updates (the JAX package's ``torch_adam`` reproduces exactly this)."""

from __future__ import annotations

import torch


def torch_adam(params, learning_rate, weight_decay=0.0, b1=0.9, b2=0.999,
               eps=1e-8):
    return torch.optim.Adam(params, lr=learning_rate, betas=(b1, b2),
                            eps=eps, weight_decay=weight_decay)
