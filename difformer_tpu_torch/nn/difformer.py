"""DIFFormer (v1) for one graph, as ``difformer_tpu/nn/difformer.py:37-449``.

Reference: ``node classification/difformer.py:81-226``. Per layer:

    q, k, v = Wq(x), Wk(x), Wv(x)          # [N, H, D]
    a = global_attention(q, k, v)          # 'simple' (O(N)) or 'sigmoid' (O(N²))
    g = gcn_conv(v, edge_index)            # optional graph branch (K1)
    h = a + g   |   (1-w)·a + w·g          # graph_weight blend
    h = mean over heads [+ x_0]            # use_source adds layer-0 features
    x = α·h + (1-α)·x_prev                 # residual vs the previous layer
    x = LayerNorm(x); dropout

Kept from the reference: the residual mixes with the previous layer, not x₀;
``use_bn`` means LayerNorm; the input block is Linear → LayerNorm → ReLU →
dropout; the mean over heads is taken after the branch sum. Submodules are
named after the reference's ``state_dict`` (``fcs.{0,1}``, ``bns.{i}``,
``convs.{i}.W{q,k,v}``), so ``utils/weights.py`` carries weights across.

Both kernels run (``simple``, DIFFormer-s, and ``sigmoid``, DIFFormer-a),
with the JAX package's two rewrites that change only the order of float
sums: ``fuse_head_mean`` (the head mean folded into the attention and the
linear graph branch; with a value projection, Wv is factored through the
key aggregates) and ``spmm_first`` (the graph branch as (ÂX)·Wv, gathering
F+1-wide rows instead of H·D). The model's forward takes the graph's CSR
plan (``GraphData.csr_plan()``) and builds one per call without it.

``compute_dtype="bfloat16"`` runs the activations in bf16 with the
parameters in f32, as the JAX package: the input is cast once, every Linear
computes in the activations' dtype (``nn/common.py:Linear``), LayerNorm
keeps f32 statistics, K1 and K2–K4 take bf16 and sum in f32, and the
logits come back as f32. ``remat=True`` recomputes in the backward what the
JAX package wraps in ``jax.checkpoint``: the simple attention (plain and
factored), the ``spmm_first`` branch and the plain graph branch, through
``torch.utils.checkpoint`` (non-reentrant, no RNG state: no random number
is drawn inside them; dropout is outside). A region that keeps no tensor
for its backward (the plain graph branch: K1's backward needs only the
plan) has nothing to recompute. ``ell=`` (a pair of layouts of
``ops/ell.py`` or ``ops/bsr.py``, as the JAX package takes it) runs both
graph branches through ``gcn_conv_ell`` (K6, or K7 and K6) in place of K1,
in the same recompute regions.

Node-sharded (``axis_name``, the process group of the graph axis,
``parallel/mesh.py``; each rank runs the model on its shard of
``parallel/partition.py``): the linear attention sums its aggregates over
the axis, and the graph branch exchanges sender rows as the JAX model
does: ``halo`` None runs ``gcn_conv_sharded`` (all-gather), a tuple
``gcn_conv_halo`` (one ``all_to_all``), a dict ``gcn_conv_halo_overlap``
(``parallel/sharded_ops.py``), each on K1 over the rank's plan (``plan``,
of ``parallel/sharded_ops.py:sharded_plan``, built once; without it each
call builds one). The sigmoid kernel runs the ring attention
(``parallel/sharded_ops.py:sigmoid_attention_sharded``, K2–K4 at every ring
step) with the node mask as its key mask, and ``ell=`` takes the rank's
pair of the node-sharded block-sparse hybrid (``ops/bsr.py:BsrShard``, K7
on the rank's rectangular shard and K1 for the residual). Any other layout
under ``axis_name`` raises ``ValueError``: it would multiply the rank's
rows as if they were the whole graph.

Head-sharded (``head_axis``, the process group of the model axis,
``parallel/tensor_parallel.py``; T ranks, T dividing ``num_heads``): each
rank's Wq, Wk and Wv hold its block of H/T heads, rows [m·H/T·D,
(m+1)·H/T·D) of the unsharded layer's (drawn from the same generator, so
the ranks' blocks make up the unsharded model). The Frobenius sums of
squares are summed over the model axis (``ops/linear_attention.py``); the
per-head key aggregates stay on the rank; every mean over heads, in the
fused and factored forms too (the head-averaged Wv and bias), becomes the
sum over the rank's heads divided by H; and the layer's head-averaged
output [N, D] is summed over the model axis, one all-reduce a layer.
Every rank of the model axis holds the same rows and backpropagates the
whole loss, through Megatron's pair (``ops/comm.py``): the layer's input
enters the rank's heads by ``copy_to_group`` (its gradient all-reduced,
one all-reduce a layer in the backward) and the output leaves by
``reduce_from_group``. The ``auto`` rewrites decide on the whole H, so
every rank takes the unsharded model's path. With ``axis_name`` as well
the layer runs on a graph × model grid: the nodes cut over the graph axis
as above, the heads over the model axis. ``output_attn`` needs every head
and raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import checkpoint

from difformer_tpu_torch.nn.common import LayerNorm, Linear, dropout
from difformer_tpu_torch.nn.init import torch_linear_init_
from difformer_tpu_torch.ops import comm
from difformer_tpu_torch.ops.bsr import BsrShard
from difformer_tpu_torch.ops.ell import gcn_conv_ell
from difformer_tpu_torch.ops.graph_ops import build_csr_plan, gcn_conv
from difformer_tpu_torch.ops.linear_attention import (
    simple_attention,
    simple_attention_head_mean_factored,
)
from difformer_tpu_torch.ops.sigmoid_attention import (
    sigmoid_attention,
    sigmoid_attention_dense,
)
from difformer_tpu_torch.utils.device import resolve_device

def _check_kernel(kernel):
    if kernel not in ("simple", "sigmoid"):
        raise ValueError(f"unknown kernel {kernel!r}")


def _check_options(kernel, axis_name, head_axis=None, num_heads=1):
    _check_kernel(kernel)
    if axis_name is not None:
        comm.check_group(axis_name)
    if head_axis is not None:
        comm.check_group(head_axis)
        parts = dist.get_world_size(head_axis)
        if num_heads % parts:
            raise ValueError(
                f"the model axis has {parts} ranks, which does not divide "
                f"num_heads={num_heads}: each rank holds whole heads")


def _check_layout(ell, axis_name):
    """Raise unless ``ell`` fits the model: a pair of ``BsrShard``s
    exactly when node-sharded."""
    if ell is None:
        return
    sharded = isinstance(ell[0], BsrShard)
    if axis_name is not None and not sharded:
        raise ValueError(
            f"a node-sharded model takes the rank's BsrShard pair as ell= "
            f"(ops/bsr.py:build_bsr_gcn_sharded), not "
            f"{type(ell[0]).__name__}: a whole-graph layout would multiply "
            f"the rank's rows as if they were the graph")
    if axis_name is None and sharded:
        raise ValueError("a BsrShard pair needs a model built with "
                         "axis_name, the graph axis's process group")


def _dtype(compute_dtype):
    """``compute_dtype`` (None, a name as the JAX package takes it, or a
    torch dtype) as a torch dtype or None."""
    if compute_dtype is None or isinstance(compute_dtype, torch.dtype):
        return compute_dtype
    dtype = getattr(torch, str(compute_dtype), None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"unknown compute_dtype {compute_dtype!r}")
    return dtype


def _remat(fn, on):
    """``fn``, recomputed in the backward when ``on`` (the JAX package's
    ``jax.checkpoint``)."""
    if not on:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False,
                                    preserve_rng_state=False)


class DIFFormerConv(nn.Module):
    """One DIFFormer layer (reference ``DIFFormerConv``,
    difformer.py:81-145).

    ``fuse_head_mean`` (False | True | "auto"): emit the layer's mean over
    heads [N, D] without the [N, H, D] branch outputs; "auto" fuses at
    H > 1. It applies to the simple kernel without ``output_attn`` and needs
    ``use_weight`` or H = 1; elsewhere it is ignored, as in the JAX package.
    ``spmm_first`` (False | True | "auto"): the graph branch as
    (ÂX)·Wv + (Â1)·bᵀ over [x, 1] rows of width F+1; "auto" turns it on
    when H·D ≥ 2·(F+1). It needs ``use_graph`` and ``use_weight`` and no
    ``output_attn``. ``remat`` recomputes the JAX package's checkpointed
    regions in the backward (the module's docstring). ``axis_name``, the
    graph axis's process group, runs the layer node-sharded; ``head_axis``,
    the model axis's, head-sharded."""

    def __init__(self, in_channels, out_channels, num_heads=1,
                 kernel="simple", use_graph=True, use_weight=True,
                 graph_weight=-1.0, use_source=False, spmm_first=False,
                 fuse_head_mean="auto", remat=False, axis_name=None,
                 head_axis=None):
        super().__init__()
        _check_options(kernel, axis_name, head_axis, num_heads)
        self.axis_name = axis_name
        self.head_axis = head_axis
        #: (this rank's block, the blocks): the heads it holds
        self.head_block = ((0, 1) if head_axis is None else
                           (dist.get_rank(head_axis),
                            dist.get_world_size(head_axis)))
        self.local_heads = num_heads // self.head_block[1]
        self.out_channels = out_channels
        self.num_heads = num_heads
        self.kernel = kernel
        self.use_graph = use_graph
        self.use_weight = use_weight
        self.graph_weight = graph_weight
        self.use_source = use_source
        self.spmm_first = spmm_first
        self.fuse_head_mean = fuse_head_mean
        self.remat = remat
        width = out_channels * self.local_heads
        self.Wq = Linear(in_channels, width)
        self.Wk = Linear(in_channels, width)
        self.Wv = Linear(in_channels, width) if use_weight else None

    def reset_parameters(self, generator: torch.Generator):
        for lin in (self.Wq, self.Wk, self.Wv):
            if lin is not None:
                torch_linear_init_(lin, generator, block=self.head_block)

    def _head_mean(self, t, dim):
        """The mean over ``dim``'s heads, or with ``head_axis`` this rank's
        part of it (the sum over its heads over all H)."""
        if self.head_axis is None:
            return t.mean(dim)
        return t.sum(dim) / self.num_heads

    def forward(self, query_input, source_input, senders=None, receivers=None,
                edge_weight=None, x_0=None, *, node_mask=None, edge_mask=None,
                num_nodes_global=None, indices_are_sorted=False,
                output_attn=False, edge_chunk_size=None, plan=None,
                ell=None, halo=None):
        H, D = self.num_heads, self.out_channels
        h_loc, heads = self.local_heads, self.head_axis
        axis = self.axis_name
        _check_layout(ell, axis)
        if heads is not None:
            if output_attn:
                raise ValueError("output_attn needs every head on one rank;"
                                 " the model is head-sharded (head_axis)")
            # the replicated input enters this rank's heads; its gradient
            # sums every rank's heads' parts
            shared = query_input is source_input
            source_input = comm.copy_to_group(source_input, heads)
            query_input = (source_input if shared
                           else comm.copy_to_group(query_input, heads))
        fuse_mean = self.fuse_head_mean
        if fuse_mean == "auto":
            fuse_mean = H > 1
        fuse_mean = (bool(fuse_mean) and self.kernel == "simple"
                     and not output_attn and (self.use_weight or H == 1))
        # under fusion with a value projection, Wv is factored through the
        # key aggregates and through the head-averaged graph branch: the
        # [N, H, D] value tensor never exists
        factored = fuse_mean and self.use_weight

        query = self.Wq(query_input).reshape(-1, h_loc, D)
        key = self.Wk(source_input).reshape(-1, h_loc, D)
        value = None
        if not self.use_weight:
            # reference difformer.py:120: raw features as a single head
            value = source_input.reshape(-1, 1, D)
        elif not factored:
            value = self.Wv(source_input).reshape(-1, h_loc, D)
        if fuse_mean and self.use_weight:
            wv_k3 = self.Wv.weight.t().reshape(-1, h_loc, D)    # [F, H, D]
            wv_b2 = self.Wv.bias.reshape(h_loc, D)              # [H, D]
        ckpt = lambda fn: _remat(fn, self.remat)  # noqa: E731
        mean = self._head_mean
        shard = dict(head_axis=heads, num_heads=H)

        attn = None
        if self.kernel == "simple":
            if output_attn:
                attention_output, attn = simple_attention(
                    query, key, value, key_mask=node_mask,
                    num_queries=num_nodes_global, output_attn=True,
                    axis_name=axis)
            elif factored:
                attention_output = ckpt(
                    lambda q, k, xx, w, b: simple_attention_head_mean_factored(
                        q, k, xx, w, b, key_mask=node_mask,
                        num_queries=num_nodes_global, axis_name=axis,
                        **shard))(
                    query, key, source_input, wv_k3, wv_b2)
            else:
                attention_output = ckpt(
                    lambda q, k, v: simple_attention(
                        q, k, v, key_mask=node_mask,
                        num_queries=num_nodes_global,
                        head_mean=fuse_mean, axis_name=axis, **shard))(
                    query, key, value)
        elif output_attn:
            attention_output, attn = sigmoid_attention_dense(
                query, key, value, key_mask=node_mask, output_attn=True)
        elif axis is not None:
            from difformer_tpu_torch.parallel.sharded_ops import (
                sigmoid_attention_sharded)
            attention_output = sigmoid_attention_sharded(
                query, key, value, key_mask=node_mask, axis_name=axis)
        else:
            attention_output = sigmoid_attention(query, key, value,
                                                 key_mask=node_mask)

        spmm_first = self.spmm_first
        if spmm_first == "auto":
            # on when the rewrite cuts the gathered width at least in half
            spmm_first = H * D >= 2 * (source_input.shape[-1] + 1)
        spmm_first = (bool(spmm_first) and self.use_graph and self.use_weight
                      and not output_attn)

        def conv(x):
            if ell is not None:
                return gcn_conv_ell(x, ell[0], ell[1])
            if axis is not None:
                from difformer_tpu_torch.parallel.sharded_ops import (
                    sharded_conv)
                return sharded_conv(x, senders, receivers, edge_weight,
                                    edge_mask=edge_mask, halo=halo,
                                    axis_name=axis, plan=plan)
            return gcn_conv(x, senders, receivers, edge_weight,
                            edge_mask=edge_mask,
                            indices_are_sorted=indices_are_sorted,
                            edge_chunk_size=edge_chunk_size, plan=plan)

        if self.use_graph:
            if spmm_first:
                ones = source_input.new_ones((source_input.shape[0], 1))
                x_aug = torch.cat([source_input, ones], -1)[:, None, :]

                def branch(x_aug, *weights):
                    u = conv(x_aug)[:, 0]
                    u_x, rowsum = u[:, :-1], u[:, -1:]   # ÂX, Â1
                    if fuse_mean:
                        # the head mean folded into the projection:
                        # mean_h((ÂX)W_h + r·b_h) = (ÂX)·W̄ + r·b̄
                        k3, b2 = weights
                        return (u_x @ mean(k3, 1).to(u.dtype)
                                + rowsum * mean(b2, 0).to(u.dtype))
                    # Wv(ÂX) carries +b once; (ÂX)W + (Â1)bᵀ needs (r−1)·b
                    return (self.Wv(u_x) + (rowsum - 1.0)
                            * self.Wv.bias.to(u.dtype)).reshape(
                                -1, h_loc, D)

                weights = (wv_k3, wv_b2) if fuse_mean else ()
                graph_output = ckpt(branch)(x_aug, *weights)
            else:
                # the conv is linear per channel, so the head mean commutes
                # with it: conv the head-averaged value ([N, 1, D])
                if factored:
                    dt = source_input.dtype
                    conv_in = (source_input @ mean(wv_k3, 1).to(dt)
                               + mean(wv_b2, 0).to(dt))[:, None, :]
                elif fuse_mean:
                    conv_in = value.mean(1, keepdim=True)
                else:
                    conv_in = value
                graph_output = ckpt(conv)(conv_in)
                if fuse_mean:
                    graph_output = graph_output[:, 0]           # [N, D]
            if self.graph_weight > 0:
                final_output = ((1 - self.graph_weight) * attention_output
                                + self.graph_weight * graph_output)
            else:
                final_output = attention_output + graph_output
        else:
            final_output = attention_output

        if not fuse_mean:
            final_output = mean(final_output, 1)
        if heads is not None:
            # every rank's part of the mean over heads, summed
            final_output = comm.reduce_from_group(final_output, heads)
        if self.use_source:
            final_output = final_output + x_0
        if output_attn:
            return final_output, attn
        return final_output


class DIFFormer(nn.Module):
    """Full DIFFormer model (reference ``DIFFormer``, difformer.py:147-226).

    Parameters are drawn from ``torch.Generator().manual_seed(seed)`` and
    placed on ``device`` (the GPU unless told otherwise); they stay float32
    under ``compute_dtype`` (the module's docstring).
    ``forward(..., generator=g)`` draws the dropout masks from ``g``;
    ``forward(..., plan=graph.csr_plan())`` runs every layer's graph branch
    on that plan (which replaces senders, receivers, edge_weight and
    edge_mask there); without one, a plan is built once for the call.
    ``forward(..., ell=(fwd, rev))`` runs the graph branch on those
    layouts instead (``ops/ell.py``, ``ops/bsr.py``; node-sharded, the
    rank's ``BsrShard`` pair), with no plan.
    ``axis_name``, the graph axis's process group, runs the model
    node-sharded on one rank's shard: ``forward(..., halo=...)`` picks the
    exchange (the module's docstring) and ``plan`` is then the rank's
    plan of ``parallel/sharded_ops.py:sharded_plan``. ``head_axis``, the
    model axis's process group, runs it head-sharded (the module's
    docstring); ``num_heads`` stays the whole model's."""

    def __init__(self, in_channels, hidden_channels, out_channels,
                 num_layers=2, num_heads=1, kernel="simple", alpha=0.5,
                 dropout=0.5, use_bn=True, use_residual=True, use_weight=True,
                 use_graph=True, graph_weight=-1.0, use_source=False,
                 axis_name: Optional[str] = None, compute_dtype=None,
                 remat=False, spmm_first=False, fuse_head_mean="auto", *,
                 head_axis=None, seed=0, device=None):
        super().__init__()
        _check_options(kernel, axis_name, head_axis, num_heads)
        self.axis_name = axis_name
        self.head_axis = head_axis
        dev = resolve_device(device)
        self.compute_dtype = _dtype(compute_dtype)
        self.remat = remat
        self.num_layers = num_layers
        self.alpha = alpha
        self.dropout = dropout
        self.use_bn = use_bn
        self.use_residual = use_residual
        self.fcs = nn.ModuleList([Linear(in_channels, hidden_channels),
                                  Linear(hidden_channels, out_channels)])
        self.bns = nn.ModuleList(
            [LayerNorm(hidden_channels) for _ in range(num_layers + 1)]
            if use_bn else [])
        self.convs = nn.ModuleList([
            DIFFormerConv(hidden_channels, hidden_channels,
                          num_heads=num_heads, kernel=kernel,
                          use_graph=use_graph, use_weight=use_weight,
                          graph_weight=graph_weight, use_source=use_source,
                          spmm_first=spmm_first,
                          fuse_head_mean=fuse_head_mean, remat=remat,
                          axis_name=axis_name, head_axis=head_axis)
            for _ in range(num_layers)
        ])
        self.reset_parameters(torch.Generator().manual_seed(seed))
        self.to(dev)

    #: The plan a node chunk needs (``train/minibatch.py``): the CSR plan
    #: of :meth:`build_plan`.
    chunk_plan_kind = "csr"

    @staticmethod
    def build_plan(senders, receivers, num_nodes, edge_weight=None,
                   edge_mask=None):
        """The graph's plan for :meth:`forward`'s ``plan``: the CSR plan of
        its GCN branch (``ops/graph_ops.py:build_csr_plan``), built once
        per graph by a caller that runs many forwards on it."""
        return build_csr_plan(senders, receivers, num_nodes, edge_weight,
                              edge_mask)

    def reset_parameters(self, generator: torch.Generator):
        """Redraw every Linear from ``generator``; LayerNorms to (1, 0)."""
        torch_linear_init_(self.fcs[0], generator)
        for conv in self.convs:
            conv.reset_parameters(generator)
        torch_linear_init_(self.fcs[1], generator)
        for ln in self.bns:
            ln.reset_parameters()

    def forward(self, x, senders=None, receivers=None, edge_weight=None, *,
                node_mask=None, edge_mask=None, num_nodes_global=None,
                indices_are_sorted=False, output_attn=False,
                generator: Optional[torch.Generator] = None, ell=None,
                halo=None, edge_chunk_size=None, plan=None):
        drop = lambda h: dropout(h, self.dropout, self.training, generator)
        if (plan is None and ell is None and self.convs
                and self.convs[0].use_graph):
            if self.axis_name is not None:
                from difformer_tpu_torch.parallel.sharded_ops import (
                    sharded_plan)
                plan = sharded_plan(senders, receivers, x.shape[0],
                                    edge_weight, edge_mask=edge_mask,
                                    halo=halo, axis_name=self.axis_name)
            else:
                plan = self.build_plan(senders, receivers, x.shape[0],
                                       edge_weight, edge_mask)
        if self.compute_dtype is not None:
            # bf16 activations; the reductions that need f32 (Frobenius
            # norms, attention denominators, LayerNorm statistics, K1's
            # sums) take it inside
            x = x.to(self.compute_dtype)

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
                       num_nodes_global=num_nodes_global,
                       indices_are_sorted=indices_are_sorted,
                       output_attn=output_attn,
                       edge_chunk_size=edge_chunk_size, plan=plan, ell=ell,
                       halo=halo)
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
        if self.compute_dtype is not None:
            x_out = x_out.float()   # logits and loss in f32
        if output_attn:
            return x_out, torch.stack(attentions, dim=0)
        return x_out
