"""DIFFormer (v1) for one graph, as ``difformer_tpu/nn/difformer.py:37-449``.

Reference: ``node classification/difformer.py:81-226``. Per layer:

    q, k, v = Wq(x), Wk(x), Wv(x)          # [N, H, D]
    a = sigmoid_attention(q, k, v)         # DIFFormer-a, O(N²)
    g = gcn_conv(v, edge_index)            # optional graph branch
    h = a + g   |   (1-w)·a + w·g          # graph_weight blend
    h = mean over heads [+ x_0]            # use_source adds layer-0 features
    x = α·h + (1-α)·x_prev                 # residual vs the previous layer
    x = LayerNorm(x); dropout

Kept from the reference: the residual mixes with the previous layer, not x₀;
``use_bn`` means LayerNorm; the input block is Linear → LayerNorm → ReLU →
dropout; the mean over heads is taken after the branch sum. Submodules are
named after the reference's ``state_dict`` (``fcs.{0,1}``, ``bns.{i}``,
``convs.{i}.W{q,k,v}``), so ``utils/weights.py`` carries weights across.

Only ``kernel="sigmoid"`` runs so far; the other options raise
``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from difformer_tpu_torch.nn.common import LayerNorm, dropout
from difformer_tpu_torch.nn.init import torch_linear_init_
from difformer_tpu_torch.ops.graph_ops import gcn_conv
from difformer_tpu_torch.ops.sigmoid_attention import (
    sigmoid_attention,
    sigmoid_attention_dense,
)
from difformer_tpu_torch.utils.device import resolve_device

_NOT_PORTED = {
    "kernel='simple'": "DIFFormer-s, ROADMAP.md queue A item 1",
    "spmm_first": "ROADMAP.md queue A item 1 (DIFFormer-s variants)",
    "fuse_head_mean": "ROADMAP.md queue A item 1 (DIFFormer-s variants)",
    "compute_dtype": "bf16 compute_dtype, ROADMAP.md queue A item 3",
    "remat": "ROADMAP.md queue A item 3",
    "ell": "TPU-shaped sparse layouts, ROADMAP.md queue A item 9 (slice 8)",
    "halo": "the parallel layer, ROADMAP.md queue A item 10 (slice 9)",
    "axis_name": "the parallel layer, ROADMAP.md queue A item 10 (slice 9)",
    "edge_chunk_size": "the rest of the graph ops, ROADMAP.md queue A item 1",
}


def _not_ported(option):
    return NotImplementedError(
        f"{option} is not ported to difformer_tpu_torch yet "
        f"({_NOT_PORTED[option]})")


def _check_kernel(kernel):
    if kernel == "simple":
        raise _not_ported("kernel='simple'")
    if kernel != "sigmoid":
        raise ValueError(f"unknown kernel {kernel!r}")


def _check_options(spmm_first, fuse_head_mean, compute_dtype, remat,
                   axis_name):
    if spmm_first:
        raise _not_ported("spmm_first")
    if fuse_head_mean is True:
        raise _not_ported("fuse_head_mean")
    if compute_dtype is not None:
        raise _not_ported("compute_dtype")
    if remat:
        raise _not_ported("remat")
    if axis_name is not None:
        raise _not_ported("axis_name")


def _check_call(ell, halo, edge_chunk_size):
    for name, value in (("ell", ell), ("halo", halo),
                        ("edge_chunk_size", edge_chunk_size)):
        if value is not None:
            raise _not_ported(name)


class DIFFormerConv(nn.Module):
    """One DIFFormer layer (reference ``DIFFormerConv``,
    difformer.py:81-145)."""

    def __init__(self, in_channels, out_channels, num_heads=1,
                 kernel="simple", use_graph=True, use_weight=True,
                 graph_weight=-1.0, use_source=False):
        super().__init__()
        _check_kernel(kernel)
        self.out_channels = out_channels
        self.num_heads = num_heads
        self.kernel = kernel
        self.use_graph = use_graph
        self.use_weight = use_weight
        self.graph_weight = graph_weight
        self.use_source = use_source
        width = out_channels * num_heads
        self.Wq = nn.Linear(in_channels, width)
        self.Wk = nn.Linear(in_channels, width)
        self.Wv = nn.Linear(in_channels, width) if use_weight else None

    def reset_parameters(self, generator: torch.Generator):
        for lin in (self.Wq, self.Wk, self.Wv):
            if lin is not None:
                torch_linear_init_(lin, generator)

    def forward(self, query_input, source_input, senders=None, receivers=None,
                edge_weight=None, x_0=None, *, node_mask=None, edge_mask=None,
                output_attn=False):
        H, D = self.num_heads, self.out_channels
        query = self.Wq(query_input).reshape(-1, H, D)
        key = self.Wk(source_input).reshape(-1, H, D)
        if self.use_weight:
            value = self.Wv(source_input).reshape(-1, H, D)
        else:
            # reference difformer.py:120: raw features as a single head
            value = source_input.reshape(-1, 1, D)

        attn = None
        if output_attn:
            attention_output, attn = sigmoid_attention_dense(
                query, key, value, key_mask=node_mask, output_attn=True)
        else:
            attention_output = sigmoid_attention(query, key, value,
                                                 key_mask=node_mask)

        if self.use_graph:
            graph_output = gcn_conv(value, senders, receivers, edge_weight,
                                    edge_mask=edge_mask)
            if self.graph_weight > 0:
                final_output = ((1 - self.graph_weight) * attention_output
                                + self.graph_weight * graph_output)
            else:
                final_output = attention_output + graph_output
        else:
            final_output = attention_output

        final_output = final_output.mean(dim=1)
        if self.use_source:
            final_output = final_output + x_0
        if output_attn:
            return final_output, attn
        return final_output


class DIFFormer(nn.Module):
    """Full DIFFormer model (reference ``DIFFormer``, difformer.py:147-226).

    Parameters are drawn from ``torch.Generator().manual_seed(seed)`` and
    placed on ``device`` (the GPU unless told otherwise).
    ``forward(..., generator=g)`` draws the dropout masks from ``g``."""

    def __init__(self, in_channels, hidden_channels, out_channels,
                 num_layers=2, num_heads=1, kernel="simple", alpha=0.5,
                 dropout=0.5, use_bn=True, use_residual=True, use_weight=True,
                 use_graph=True, graph_weight=-1.0, use_source=False,
                 axis_name: Optional[str] = None, compute_dtype=None,
                 remat=False, spmm_first=False, fuse_head_mean="auto", *,
                 seed=0, device=None):
        super().__init__()
        _check_kernel(kernel)
        if spmm_first == "auto":
            # the JAX package's rule (nn/difformer.py:191-199): on when it
            # cuts the gather width at least in half
            spmm_first = (use_graph and use_weight and num_heads
                          * hidden_channels >= 2 * (hidden_channels + 1))
        _check_options(spmm_first, fuse_head_mean, compute_dtype, remat,
                       axis_name)
        dev = resolve_device(device)
        self.num_layers = num_layers
        self.alpha = alpha
        self.dropout = dropout
        self.use_bn = use_bn
        self.use_residual = use_residual
        self.fcs = nn.ModuleList([nn.Linear(in_channels, hidden_channels),
                                  nn.Linear(hidden_channels, out_channels)])
        self.bns = nn.ModuleList(
            [LayerNorm(hidden_channels) for _ in range(num_layers + 1)]
            if use_bn else [])
        self.convs = nn.ModuleList([
            DIFFormerConv(hidden_channels, hidden_channels,
                          num_heads=num_heads, kernel=kernel,
                          use_graph=use_graph, use_weight=use_weight,
                          graph_weight=graph_weight, use_source=use_source)
            for _ in range(num_layers)
        ])
        self.reset_parameters(torch.Generator().manual_seed(seed))
        self.to(dev)

    def reset_parameters(self, generator: torch.Generator):
        """Redraw every Linear from ``generator``; LayerNorms to (1, 0)."""
        torch_linear_init_(self.fcs[0], generator)
        for conv in self.convs:
            conv.reset_parameters(generator)
        torch_linear_init_(self.fcs[1], generator)
        for ln in self.bns:
            ln.reset_parameters()

    def forward(self, x, senders=None, receivers=None, edge_weight=None, *,
                node_mask=None, edge_mask=None, output_attn=False,
                generator: Optional[torch.Generator] = None, ell=None,
                halo=None, edge_chunk_size=None):
        _check_call(ell, halo, edge_chunk_size)
        drop = lambda h: dropout(h, self.dropout, self.training, generator)

        # input block (difformer.py:188-192)
        x = self.fcs[0](x)
        if self.use_bn:
            x = self.bns[0](x)
        x = drop(torch.relu(x))

        x_0 = prev = x
        attentions = []
        for i, conv in enumerate(self.convs):
            out = conv(x, x, senders, receivers, edge_weight, x_0,
                       node_mask=node_mask, edge_mask=edge_mask,
                       output_attn=output_attn)
            if output_attn:
                x, attn = out
                attentions.append(attn)
            else:
                x = out
            if self.use_residual:
                x = self.alpha * x + (1 - self.alpha) * prev
            if self.use_bn:
                x = self.bns[i + 1](x)
            x = drop(x)
            prev = x

        x_out = self.fcs[1](x)
        if output_attn:
            return x_out, torch.stack(attentions, dim=0)
        return x_out
