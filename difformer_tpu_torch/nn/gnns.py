"""The baseline zoo's graph convolution, as ``difformer_tpu/nn/gnns.py``:
``GCNLayer`` only, the piece of the zoo that MPNN-LSTM (``nn/temporal.py``)
is built from. The other models (LINK, MLP, SGC, GCN, GAT, MixHop, the JK
nets, H2GCN, APPNP, GPRGNN) are ROADMAP.md queue A item 8.

Its product runs K1 (``kernels/spmm.py``) over a plan of the normalised
adjacency with self-loops (``ops/graph_ops.py:gcn_norm``), which
:meth:`GCNLayer.build_plan` builds once per graph; a call without a plan
builds one.
"""

from __future__ import annotations

import torch
from torch import nn

from difformer_tpu_torch.nn.common import Linear
from difformer_tpu_torch.nn.init import torch_linear_init_
from difformer_tpu_torch.ops.graph_ops import build_spmm_plan, gcn_norm, spmm


class GCNLayer(nn.Module):
    """One GCNConv (PyG semantics with self-loops): ``Â · (x W) + b`` with
    Â the ``gcn_norm`` of the graph. ``lin`` carries the JAX layer's
    ``TorchLinear_0`` (no bias) and ``bias`` its ``bias`` (zeros at
    init)."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.lin = Linear(in_channels, out_channels, bias=False)
        self.bias = nn.Parameter(torch.zeros(out_channels))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        torch_linear_init_(self.lin, generator)
        self.bias.zero_()

    @staticmethod
    def build_plan(senders, receivers, num_nodes, edge_weight=None,
                   edge_mask=None):
        """The plan of the layer's normalised adjacency for a graph of
        ``num_nodes`` nodes; padded edges (``edge_mask`` False) weigh 0, as
        the JAX package's padded edges do."""
        if edge_mask is not None:
            ones = torch.ones(senders.shape, device=senders.device)
            edge_weight = (ones if edge_weight is None else edge_weight) \
                * edge_mask.float()
        s, r, w = gcn_norm(senders, receivers, num_nodes, edge_weight)
        return build_spmm_plan(w, s, r, num_nodes)

    def forward(self, x, senders=None, receivers=None, edge_weight=None, *,
                plan=None):
        if plan is None:
            plan = self.build_plan(senders, receivers, x.shape[0],
                                   edge_weight)
        return spmm(None, None, None, self.lin(x), plan=plan) + self.bias
