"""Temporal baselines, DCRNN (a diffusion-convolutional GRU) and MPNN-LSTM,
as ``difformer_tpu/nn/temporal.py``.

Reference: ``spatial-temporal/gnns.py:15-362``. The JAX package's
documented deviations are kept (``difformer_tpu/nn/temporal.py:3-15``):

* DConv is the intended DCRNN operator, as torch_geometric_temporal's
  ``DConv``: dual-direction random-walk diffusion, fully sparse (the
  reference densifies the adjacency and indexes the in-degree at the
  forward source, a known misalignment).
* The Chebyshev recurrence is the standard one (the reference never
  advances ``Tx_1``).

DConv's two diffusion matrices, P_fwd and P_rev, are sparse products
through K1 (``kernels/spmm.py``). Their plans, one per direction, depend
only on the graph and its edge weights: :meth:`DConv.build_plan` builds
them once per graph (the temporal trainer does so once per distinct
graph), outside the hop loop, and every hop and every DConv of a DCRNN
runs on them. MPNN-LSTM's two ``GCNLayer``s share one plan of the
normalised adjacency in the same way. Each model's ``build_plan`` gives
the plan its ``forward(..., plan=...)`` takes; without one a forward
builds its own. MPNN-LSTM's LSTMs are ``torch.nn.LSTMCell`` (dense gates,
not a TPU kernel).

Parameters are named so that ``utils/weights.py`` carries the JAX
package's flax params across: DConv ``weight`` [2, K, in, out] and
``bias``; DCRNN ``conv_x_{z,r,h}`` and ``output_linear``; MPNN-LSTM
``conv_{1,2}``, ``bn_{1,2}`` (with their running statistics, flax's
``batch_stats``), ``lstm_{1,2}`` and ``head``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from difformer_tpu_torch.nn.common import Linear, TorchBatchNorm, dropout
from difformer_tpu_torch.nn.gnns import GCNLayer
from difformer_tpu_torch.nn.init import flax_lstm_init_, torch_linear_init_
from difformer_tpu_torch.ops.graph_ops import (
    CsrPlan,
    build_spmm_plan,
    spmm,
    weighted_degree,
)
from difformer_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DConvPlan:
    """The two diffusion matrices of one graph, as K1 plans: ``fwd``,
    ``out[r] += w_e / deg_out[s] · x[s]`` over the edges (s, r), and
    ``rev``, ``out[s] += w_e / deg_in[r] · x[r]``."""

    fwd: CsrPlan
    rev: CsrPlan


def _inverse(d):
    return torch.where(d > 0, 1.0 / d.clamp(min=1e-30), torch.zeros_like(d))


class DConv(nn.Module):
    """Diffusion convolution: Σ_dir Σ_k T_k(P_dir) X W[dir, k], with K
    Chebyshev terms (reference weight shape [2, K, in, out],
    ``gnns.py:32``)."""

    def __init__(self, in_channels, out_channels, K=2, use_bias=True):
        super().__init__()
        self.K = K
        self.weight = nn.Parameter(torch.empty(2, K, in_channels,
                                               out_channels))
        self.bias = (nn.Parameter(torch.zeros(out_channels)) if use_bias
                     else None)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """Glorot uniform as flax's ``xavier_uniform`` over [2, K, in, out]
        (fans of in·2K and out·2K); the bias to zeros."""
        two, k, fin, fout = self.weight.shape
        limit = math.sqrt(6.0 / ((fin + fout) * two * k))
        cpu = torch.empty(self.weight.shape)
        nn.init.uniform_(cpu, -limit, limit, generator=generator)
        self.weight.copy_(cpu)
        if self.bias is not None:
            self.bias.zero_()

    @staticmethod
    def build_plan(senders, receivers, num_nodes, edge_weight=None,
                   edge_mask=None) -> DConvPlan:
        """The :class:`DConvPlan` of a graph: the random-walk values
        ``w / deg_out[s]`` and ``w / deg_in[r]`` (0 where a degree is 0;
        the weighted degrees by ``weighted_degree``, the same at every
        build) and the two plans. Padded edges (``edge_mask`` False) weigh
        0, as the JAX package's padded edges do."""
        s, r = senders.long(), receivers.long()
        w = (torch.ones(s.shape, device=s.device) if edge_weight is None
             else edge_weight.float())
        if edge_mask is not None:
            w = w * edge_mask.float()
        deg_out = weighted_degree(s, w, num_nodes)
        deg_in = weighted_degree(r, w, num_nodes)
        return DConvPlan(
            fwd=build_spmm_plan(w * _inverse(deg_out)[s], s, r, num_nodes),
            rev=build_spmm_plan(w * _inverse(deg_in)[r], r, s, num_nodes))

    def forward(self, x, senders=None, receivers=None, edge_weight=None, *,
                plan: Optional[DConvPlan] = None):
        w = self.weight
        out = x @ w[0, 0] + x @ w[1, 0]
        if self.K > 1:
            if plan is None:
                plan = self.build_plan(senders, receivers, x.shape[0],
                                       edge_weight)
            def p_fwd(h):
                return spmm(None, None, None, h, plan=plan.fwd)

            def p_rev(h):
                return spmm(None, None, None, h, plan=plan.rev)

            tx1_o, tx1_i = p_fwd(x), p_rev(x)
            out = out + tx1_o @ w[0, 1] + tx1_i @ w[1, 1]
            tx0_o = tx0_i = x
            for k in range(2, self.K):
                tx2_o = 2.0 * p_fwd(tx1_o) - tx0_o
                tx2_i = 2.0 * p_rev(tx1_i) - tx0_i
                out = out + tx2_o @ w[0, k] + tx2_i @ w[1, k]
                tx0_o, tx1_o = tx1_o, tx2_o
                tx0_i, tx1_i = tx1_i, tx2_i
        if self.bias is not None:
            out = out + self.bias
        return out


class DCRNN(nn.Module):
    """Diffusion-convolutional GRU cell and output head (reference
    ``DC_RNN``, ``gnns.py:126-247``): gates z, r and h̃ are DConvs over
    [X ‖ H]. The trainer calls it with ``h=None`` (a zero state) on every
    snapshot, as the JAX trainer does."""

    def __init__(self, in_channels, hidden_channels, out_channels, K=2, *,
                 seed=0, device=None):
        super().__init__()
        self.hidden_channels = hidden_channels
        width = in_channels + hidden_channels
        self.conv_x_z = DConv(width, hidden_channels, K)
        self.conv_x_r = DConv(width, hidden_channels, K)
        self.conv_x_h = DConv(width, hidden_channels, K)
        self.output_linear = Linear(hidden_channels, out_channels)
        self.reset_parameters(torch.Generator().manual_seed(seed))
        self.to(resolve_device(device))

    def reset_parameters(self, generator: torch.Generator):
        for conv in (self.conv_x_z, self.conv_x_r, self.conv_x_h):
            conv.reset_parameters(generator)
        torch_linear_init_(self.output_linear, generator)

    build_plan = staticmethod(DConv.build_plan)

    def forward(self, x, senders=None, receivers=None, edge_weight=None,
                h=None, *, edge_mask=None, plan=None, return_state=False,
                **kw):
        """Output [N, out] (and the new state with ``return_state``). ``kw``
        (the trainer's ``generator``) is not read: the model has no
        dropout."""
        if plan is None:
            plan = self.build_plan(senders, receivers, x.shape[0],
                                   edge_weight, edge_mask)
        if h is None:
            h = x.new_zeros((x.shape[0], self.hidden_channels))
        xh = torch.cat([x, h], dim=1)
        z = torch.sigmoid(self.conv_x_z(xh, plan=plan))
        r = torch.sigmoid(self.conv_x_r(xh, plan=plan))
        h_tilde = torch.tanh(self.conv_x_h(torch.cat([x, h * r], dim=1),
                                           plan=plan))
        h_new = z * h + (1 - z) * h_tilde
        out = self.output_linear(h_new)
        if return_state:
            return out, h_new
        return out


class MPNNLSTM(nn.Module):
    """MPNN-LSTM (reference ``MPNN_LSTM``, ``gnns.py:250-362``): the input
    is a window of snapshots stacked on the node axis [window·N, F]; two
    GCN + BatchNorm + dropout blocks, two stacked LSTMs over the window, and
    a head on [h_lstm1 ‖ h_lstm2 ‖ skip] giving one value per node.

    The LSTMs' input biases stay zero and take no gradient (flax's LSTM
    cell has none). BatchNorm keeps running statistics, updated in training
    and used in evaluation (as the reference trains it)."""

    def __init__(self, in_channels, hidden_channels, out_channels, num_nodes,
                 window, dropout=0.5, *, seed=0, device=None):
        super().__init__()
        self.hidden_channels = hidden_channels
        self.num_nodes = num_nodes
        self.window = window
        self.dropout = dropout
        self.conv_1 = GCNLayer(in_channels, hidden_channels)
        self.conv_2 = GCNLayer(hidden_channels, hidden_channels)
        self.bn_1 = TorchBatchNorm(hidden_channels)
        self.bn_2 = TorchBatchNorm(hidden_channels)
        self.lstm_1 = nn.LSTMCell(2 * hidden_channels, hidden_channels)
        self.lstm_2 = nn.LSTMCell(hidden_channels, hidden_channels)
        self.head = Linear(2 * hidden_channels + in_channels + window - 1,
                           out_channels)
        self.reset_parameters(torch.Generator().manual_seed(seed))
        self.to(resolve_device(device))

    def reset_parameters(self, generator: torch.Generator):
        self.conv_1.reset_parameters(generator)
        self.conv_2.reset_parameters(generator)
        self.bn_1.reset_parameters()
        self.bn_2.reset_parameters()
        flax_lstm_init_(self.lstm_1, generator)
        flax_lstm_init_(self.lstm_2, generator)
        torch_linear_init_(self.head, generator)

    build_plan = staticmethod(GCNLayer.build_plan)

    def _lstm(self, cell, seq):
        h = seq.new_zeros((seq.shape[1], self.hidden_channels))
        c = torch.zeros_like(h)
        ys = []
        for t in range(seq.shape[0]):
            h, c = cell(seq[t], (h, c))
            ys.append(h)
        return h, torch.stack(ys, dim=0)

    def forward(self, x, senders=None, receivers=None, edge_weight=None, *,
                edge_mask=None, plan=None,
                generator: Optional[torch.Generator] = None, **kw):
        """[window·N] predictions; dropout masks from ``generator`` in
        training."""
        w, n, fin = self.window, self.num_nodes, x.shape[-1]
        if plan is None:
            plan = self.build_plan(senders, receivers, x.shape[0],
                                   edge_weight, edge_mask)
        # skip connection: step 0's features and the last feature of later
        # steps
        s = x.reshape(w, n, fin).transpose(0, 1)             # [n, W, F]
        skip = torch.cat([s[:, 0, :]] + [s[:, t, fin - 1:fin]
                                         for t in range(1, w)], dim=1)
        h = x
        rs = []
        for conv, bn in ((self.conv_1, self.bn_1), (self.conv_2, self.bn_2)):
            h = torch.relu(conv(h, plan=plan))
            h = bn(h)
            h = dropout(h, self.dropout, self.training, generator)
            rs.append(h)
        seq = torch.cat(rs, dim=1).reshape(w, n, 2 * self.hidden_channels)
        h1, ys1 = self._lstm(self.lstm_1, seq)
        h2, _ = self._lstm(self.lstm_2, ys1)
        return self.head(torch.cat([h1, h2, skip], dim=1)).reshape(-1)
