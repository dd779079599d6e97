"""DIFFormer-v2, the batched-graphs variant (graph-level prediction), as
``difformer_tpu/nn/difformer_v2.py``.

Reference: ``physical particle/difformer-v2.py:48-223`` and the ``GraphGNN``
pooling head (``physical particle/models.py:13-36``). The model runs on a
padded batch ``[B, M, ...]`` (B graphs of at most M nodes, with a node
mask; ``data/batching.py``), so each graph's attention is a batched
contraction, and its GCN branch takes one of three plans of the same
product:

- ``dense_adj`` [B, M, M], the per-graph normalised adjacency: a batched
  matmul, whose backward autograd gives as Aᵀ @ dg;
- ``knn_table`` (idx, w[, ridx, rw]), a gather table for k-in-regular
  batches (``ops/graph_ops.py:knn_table_conv``);
- the edge list in padded-flat coordinates (``b*M + slot``, padded edges
  masked) through ``gcn_conv`` and K1, over ``plan`` (a ``CsrPlan`` of the
  batch's real edges) or, without one, a plan built once per call.

Kept from the reference, as the JAX package keeps them: the extra ReLU
after each layer's LayerNorm (``difformer-v2.py:217``) and the dropout on
the output (``:222``); the "sigmoid" kernel's cross-graph quirk
(``:124``) behind ``crossgraph_quirk``, the within-graph attention
otherwise. Submodules carry the reference's ``state_dict`` names
(``fcs.{0,1}``, ``bns.{i}``, ``convs.{i}.W{q,k,v}``; the head ``encoder``
and ``lin``), so ``utils/weights.py`` carries the JAX package's weights
across. ``compute_dtype="bfloat16"`` runs the activations in bf16 with the
parameters in f32, as DIFFormer does (``nn/difformer.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from difformer_tpu_torch.nn.common import LayerNorm, Linear, dropout
from difformer_tpu_torch.nn.difformer import _check_kernel, _dtype
from difformer_tpu_torch.nn.init import torch_linear_init_
from difformer_tpu_torch.ops.graph_ops import (
    build_csr_plan,
    gcn_conv,
    knn_table_conv,
)
from difformer_tpu_torch.ops.linear_attention import simple_attention_padded
from difformer_tpu_torch.ops.sigmoid_attention import (
    sigmoid_attention_padded,
    sigmoid_attention_padded_crossgraph,
)
from difformer_tpu_torch.utils.device import resolve_device

POOLINGS = ("sum", "mean", "max")


class TransConvV2(nn.Module):
    """One batched DIFFormer layer (reference ``TransConv``,
    difformer-v2.py:48-163): [B, M, F] → [B, M, D], the mean over heads of
    the attention plus the graph branch."""

    def __init__(self, in_channels, out_channels, num_heads=1,
                 kernel="simple", use_graph=True, use_weight=True,
                 graph_weight=-1.0, crossgraph_quirk=False):
        super().__init__()
        _check_kernel(kernel)
        self.out_channels = out_channels
        self.num_heads = num_heads
        self.kernel = kernel
        self.use_graph = use_graph
        self.use_weight = use_weight
        self.graph_weight = graph_weight
        self.crossgraph_quirk = crossgraph_quirk
        width = out_channels * num_heads
        self.Wq = Linear(in_channels, width)
        self.Wk = Linear(in_channels, width)
        self.Wv = Linear(in_channels, width) if use_weight else None

    def reset_parameters(self, generator: torch.Generator):
        for lin in (self.Wq, self.Wk, self.Wv):
            if lin is not None:
                torch_linear_init_(lin, generator)

    def forward(self, x_pad, node_mask, n_nodes, *, knn_table=None,
                dense_adj=None, plan=None):
        B, M = x_pad.shape[:2]
        H, D = self.num_heads, self.out_channels
        query = self.Wq(x_pad).reshape(B, M, H, D)
        key = self.Wk(x_pad).reshape(B, M, H, D)
        if self.use_weight:
            value = self.Wv(x_pad).reshape(B, M, H, D)
        else:
            value = x_pad.reshape(B, M, 1, D)
        mask4 = node_mask[..., None, None].to(x_pad.dtype)
        value = value * mask4

        if self.kernel == "simple":
            attention_output = simple_attention_padded(
                query * mask4, key * mask4, value, node_mask, n_nodes)
        elif self.crossgraph_quirk:
            # the reference's to_pad leaves exact zeros at padded slots
            # (σ(0) = 0.5 enters its normaliser): mask q and k to match
            attention_output = sigmoid_attention_padded_crossgraph(
                query * mask4, key * mask4, value, node_mask)
        else:
            attention_output = sigmoid_attention_padded(query, key, value,
                                                        node_mask)

        if not self.use_graph:
            return attention_output.mean(2)
        if dense_adj is not None:
            graph_output = torch.einsum(
                "bmn,bnhd->bmhd", dense_adj.to(value.dtype), value)
        else:
            v_flat = value.reshape(B * M, value.shape[2], D)
            if knn_table is not None:
                idx, w, ridx, rw = (tuple(knn_table) + (None, None))[:4]
                g_flat = knn_table_conv(v_flat, idx, w, ridx, rw)
            else:
                g_flat = gcn_conv(v_flat, None, None, plan=plan)
            graph_output = g_flat.reshape(B, M, value.shape[2], D)
        if self.graph_weight > 0:
            final_output = ((1 - self.graph_weight) * attention_output
                            + self.graph_weight * graph_output)
        else:
            final_output = attention_output + graph_output
        return final_output.mean(2)  # mean over heads → [B, M, D]


class DIFFormerV2(nn.Module):
    """Batched DIFFormer encoder (reference ``DIFFormer_v2``,
    difformer-v2.py:165-223): padded node embeddings [B, M, out_channels].

    Parameters are drawn from ``torch.Generator().manual_seed(seed)`` and
    placed on ``device`` (the GPU unless told otherwise).
    ``forward(..., generator=g)`` draws the dropout masks from ``g`` in
    training. The graph branch takes ``dense_adj``, else ``knn_table``,
    else the edge list (senders, receivers, edge_weight, edge_mask in
    padded-flat coordinates) over ``plan``, or a plan built once for the
    call."""

    def __init__(self, in_channels, hidden_channels, out_channels,
                 num_layers=2, num_heads=1, kernel="simple", alpha=0.5,
                 dropout=0.5, use_bn=True, use_residual=True, use_weight=True,
                 use_graph=True, graph_weight=-1.0, crossgraph_quirk=False,
                 compute_dtype=None, *, seed=0, device=None):
        super().__init__()
        _check_kernel(kernel)
        dev = resolve_device(device)
        self.compute_dtype = _dtype(compute_dtype)
        self.out_channels = out_channels
        self.num_layers = num_layers
        self.alpha = alpha
        self.dropout = dropout
        self.use_bn = use_bn
        self.use_residual = use_residual
        self.use_graph = use_graph
        self.fcs = nn.ModuleList([Linear(in_channels, hidden_channels),
                                  Linear(hidden_channels, out_channels)])
        self.bns = nn.ModuleList(
            [LayerNorm(hidden_channels) for _ in range(num_layers + 1)]
            if use_bn else [])
        self.convs = nn.ModuleList([
            TransConvV2(hidden_channels, hidden_channels,
                        num_heads=num_heads, kernel=kernel,
                        use_graph=use_graph, use_weight=use_weight,
                        graph_weight=graph_weight,
                        crossgraph_quirk=crossgraph_quirk)
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

    def forward(self, x_pad, node_mask, n_nodes, senders=None, receivers=None,
                edge_weight=None, edge_mask=None, *,
                generator: Optional[torch.Generator] = None,
                indices_are_sorted=False, knn_table=None, dense_adj=None,
                plan=None):
        del indices_are_sorted  # the plan's own sort makes it moot
        drop = lambda h: dropout(h, self.dropout, self.training, generator)
        B, M = x_pad.shape[:2]
        if (self.use_graph and dense_adj is None and knn_table is None
                and plan is None):
            plan = build_csr_plan(senders, receivers, B * M, edge_weight,
                                  edge_mask)
        if self.compute_dtype is not None:
            x_pad = x_pad.to(self.compute_dtype)
        x = self.fcs[0](x_pad)
        if self.use_bn:
            x = self.bns[0](x)
        x = drop(torch.relu(x))

        prev = x
        for i, conv in enumerate(self.convs):
            x = conv(x, node_mask, n_nodes, knn_table=knn_table,
                     dense_adj=dense_adj, plan=plan)
            if self.use_residual:
                x = self.alpha * x + (1 - self.alpha) * prev
            if self.use_bn:
                x = self.bns[i + 1](x)
            x = torch.relu(drop(x))  # v2's extra activation (:217)
            prev = x

        x_out = drop(self.fcs[1](x))  # v2's output dropout (:222)
        if self.compute_dtype is not None:
            x_out = x_out.float()
        return x_out


class GraphLevelModel(nn.Module):
    """Encode, pool over each graph's real nodes, then a Linear (the
    intended ``GraphGNN``, ``physical particle/models.py:13-36``): logits
    [B, out_channels]. ``graph_pooling`` is "sum", "mean" or "max"; max
    fills padded slots with −1e30 (not −inf, which would give NaN
    gradients) and gives 0 for a graph with no node. The Linear ``lin`` is
    drawn after the encoder from ``torch.Generator().manual_seed(seed)``,
    which redraws the encoder too."""

    def __init__(self, encoder: DIFFormerV2, out_channels=1,
                 graph_pooling="mean", *, seed=0, device=None):
        super().__init__()
        if graph_pooling not in POOLINGS:
            raise ValueError(f"unknown graph_pooling {graph_pooling!r}")
        dev = resolve_device(device)
        self.encoder = encoder
        self.graph_pooling = graph_pooling
        self.lin = Linear(encoder.out_channels, out_channels)
        self.reset_parameters(torch.Generator().manual_seed(seed))
        self.to(dev)

    def reset_parameters(self, generator: torch.Generator):
        self.encoder.reset_parameters(generator)
        torch_linear_init_(self.lin, generator)

    def forward(self, x_pad, node_mask, n_nodes, senders=None, receivers=None,
                edge_weight=None, edge_mask=None, *,
                generator: Optional[torch.Generator] = None,
                indices_are_sorted=False, knn_table=None, dense_adj=None,
                plan=None):
        h = self.encoder(x_pad, node_mask, n_nodes, senders, receivers,
                         edge_weight, edge_mask, generator=generator,
                         indices_are_sorted=indices_are_sorted,
                         knn_table=knn_table, dense_adj=dense_adj, plan=plan)
        m = node_mask[..., None].to(h.dtype)
        if self.graph_pooling == "sum":
            pooled = (h * m).sum(1)
        elif self.graph_pooling == "mean":
            pooled = (h * m).sum(1) / m.sum(1).clamp(min=1.0)
        else:
            neg = torch.where(node_mask[..., None], h,
                              h.new_full((), -1e30))
            pooled = neg.amax(1)  # ties share the gradient, as jnp.max
            pooled = torch.where(pooled <= -1e29, torch.zeros_like(pooled),
                                 pooled)
        return self.lin(pooled)
