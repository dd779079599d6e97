"""PyTorch ``nn.Linear`` initialisation from an explicit generator, as
``difformer_tpu/nn/init.py``: weight and bias both U(−1/√fan_in, 1/√fan_in)
(the reference's default ``nn.Linear`` init); and flax's LSTM cell's init
for a ``torch.nn.LSTMCell`` (MPNN-LSTM, the JK nets' LSTM)."""

from __future__ import annotations

import math

import torch
from torch import nn


@torch.no_grad()
def torch_linear_init_(linear: nn.Linear, generator: torch.Generator, *,
                       block=(0, 1)):
    """Draw ``linear``'s weight, then its bias, from ``generator``.

    The draw happens on the CPU and is copied to the layer's device, so the
    same generator gives the same weights on every device. ``block`` =
    (i, n): draw the weight and bias of a layer with n times the output
    rows and keep row block i of n (a head-sharded projection's rows of
    the unsharded layer's draw)."""
    bound = 1.0 / linear.in_features ** 0.5
    index, count = block
    for p in (linear.weight, linear.bias):
        if p is None:
            continue
        rows = p.shape[0]
        cpu = torch.empty((rows * count,) + tuple(p.shape[1:]),
                          dtype=p.dtype)
        nn.init.uniform_(cpu, -bound, bound, generator=generator)
        p.copy_(cpu[index * rows:(index + 1) * rows])


def flax_lstm_init_(cell: nn.LSTMCell, generator: torch.Generator):
    """flax ``OptimizedLSTMCell``'s init, gate by gate (i, f, g, o): the
    input kernels lecun-normal (truncated at 2σ), the recurrent kernels
    orthogonal, the recurrent biases zero; the input bias is zero and
    frozen, as flax's input kernels have none."""
    hid = cell.hidden_size
    std = math.sqrt(1.0 / cell.input_size) / 0.87962566103423978
    w_ih = torch.empty(cell.weight_ih.shape)
    w_hh = torch.empty(cell.weight_hh.shape)
    for g in range(4):
        block = torch.empty(cell.input_size, hid)
        nn.init.trunc_normal_(block, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        w_ih[g * hid:(g + 1) * hid] = block.t()
        rec = torch.empty(hid, hid)
        nn.init.orthogonal_(rec, generator=generator)
        w_hh[g * hid:(g + 1) * hid] = rec.t()
    with torch.no_grad():
        cell.weight_ih.copy_(w_ih)
        cell.weight_hh.copy_(w_hh)
        cell.bias_hh.zero_()
        cell.bias_ih.zero_()
    cell.bias_ih.requires_grad_(False)
