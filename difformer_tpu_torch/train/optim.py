"""The optimiser of every reference trainer, as
``difformer_tpu/train/optim.py:15-21``: ``torch.optim.Adam`` with
``weight_decay``, i.e. coupled L2 decay added to the gradient before the
moment updates (the JAX package's ``torch_adam`` reproduces exactly this).

On a CUDA device the Adam is ``capturable`` and ``fused``: its step count
and bias corrections live on the device, so a step reads nothing back from
the host and can be captured in a CUDA graph (the epoch-block fit,
``train/trainer.py``), and one fused kernel updates every parameter in
place of the multi-tensor ops a capturable step would otherwise launch.
Every CUDA path builds this one Adam, so the per-epoch loop and the graph
replays compare like with like. On the CPU it is the plain Adam.
"""

from __future__ import annotations

import torch


def torch_adam(params, learning_rate, weight_decay=0.0, b1=0.9, b2=0.999,
               eps=1e-8):
    params = list(params)
    on_card = any(p.device.type == "cuda" for p in params)
    return torch.optim.Adam(params, lr=learning_rate, betas=(b1, b2),
                            eps=eps, weight_decay=weight_decay,
                            capturable=on_card, fused=on_card or None)
