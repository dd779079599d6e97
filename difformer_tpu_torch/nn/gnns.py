"""The baseline zoo, as ``difformer_tpu/nn/gnns.py:42-491``: LINK, MLP (and
ManiReg, an MLP with a smoothness term in the trainer's loss), SGC, GCN,
GAT, MixHop, GCNJK and GATJK (jumping knowledge by max, cat or a
bidirectional LSTM), H2GCN (the JAX package's own design: the reference
lacks the model), APPNP, GPRGNN, and label propagation (:func:`multi_lp`).

Every graph product runs K1 (``kernels/spmm.py``) over a plan that the
model's ``build_plan(senders, receivers, num_nodes, edge_weight,
edge_mask)`` builds once per graph, outside the hop loops
(``FullBatchTrainer`` calls it): the ``gcn_norm`` adjacency with or without
self-loops (:func:`norm_plan`), LINK's unit adjacency with the ends
swapped, or GAT's structure (:class:`GATPlan`: the edges with self-loops in
receiver order, with both edge orders). With a plan a forward sorts
nothing and reads nothing back from the device, so a step can be captured
in a CUDA graph; without one it builds its own. Padded edges
(``edge_mask`` False) weigh 0 in the normalised plans and are left out of
GAT's; the JAX zoo reads no mask (ROADMAP.md queue C). In node chunks
(``train/minibatch.py``) a model names the plan a chunk needs
(``chunk_plan_kind``: none, ``gcn_norm`` with or without loops, GAT's),
which the host builds (``native/``) and the trainer views on the device
(``views_plan``, :func:`gat_plan_from_views`); LINK refuses.

GAT's attention is a softmax over each receiver's edges. On the card no sum
that feeds the loss goes through ``index_add_`` (atomics in no fixed order):
the logits gather their two ends' scores and the softmax sums each
receiver's edges through K1 (``ops/graph_ops.py:EdgeIncidence``, both
directions), its max (detached: the softmax does not change under a shift)
is ``scatter_reduce``'s exact ``amax``, and the messages are K1 with the
attention as per-head values, whose gradient is K1-dval. Dropout masks come
from the trainer's generator, so they differ from JAX's draws.

Parameters carry the JAX package's names, so ``utils/weights.py``
(:func:`zoo_state_dict_from_params`) maps flax params and ``batch_stats``
across: ``lin_{i}``, ``bn_{i}`` (``TorchBatchNorm``, running statistics
as buffers), ``lin_out``, ``conv_{i}``/``conv_out``, ``final_project``,
GAT's ``lin``/``att_src``/``att_dst``/``bias``, ``temp``, LINK's
``kernel``/``bias``; a module flax names ``TorchLinear_0`` is ``lin`` here,
and ``_JK_0`` is ``jk`` (``lstm_fwd``, ``lstm_bwd``, ``att``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from difformer_tpu_torch.kernels.spmm import (
    DVAL_SPLIT_THRESHOLD,
    SPLIT_THRESHOLD,
    RowSplit,
)
from difformer_tpu_torch.nn.common import Linear, TorchBatchNorm, dropout
from difformer_tpu_torch.nn.init import flax_lstm_init_, torch_linear_init_
from difformer_tpu_torch.ops.graph_ops import (
    CsrPlan,
    EdgeIncidence,
    build_spmm_plan,
    edge_incidence,
    gcn_norm,
    splits_of,
    spmm,
)
from difformer_tpu_torch.ops.segment import segment_max
from difformer_tpu_torch.utils.device import resolve_device


def _masked_weight(senders, edge_weight, edge_mask):
    """``edge_weight`` (ones when None) times the mask, or as given
    without a mask."""
    if edge_mask is None:
        return edge_weight
    ones = torch.ones(senders.shape, device=senders.device)
    return (ones if edge_weight is None else edge_weight.float()) \
        * edge_mask.float()


def norm_plan(senders, receivers, num_nodes, edge_weight=None,
              edge_mask=None, *, add_self_loops=True):
    """The K1 plan of the ``gcn_norm`` adjacency (``ops/graph_ops.py``),
    with a self-loop on every node or without; padded edges weigh 0."""
    w = _masked_weight(senders, edge_weight, edge_mask)
    s, r, v = gcn_norm(senders, receivers, num_nodes, w,
                       add_self_loops=add_self_loops)
    return build_spmm_plan(v, s, r, num_nodes)


def _hop(x, plan):
    return spmm(None, None, None, x, plan=plan)


class _Model(nn.Module):
    """A zoo model's construction: parameters drawn from
    ``torch.Generator().manual_seed(seed)``, placed on ``device`` (the GPU
    unless told otherwise).

    In node chunks (``train/minibatch.py``) a model names the kind of plan
    a chunk needs, ``chunk_plan_kind`` (None: it reads no graph)."""

    chunk_plan_kind = None

    def _finish(self, seed, device):
        dev = resolve_device(device)
        self.reset_parameters(torch.Generator().manual_seed(seed))
        self.to(dev)

    def reset_parameters(self, generator: torch.Generator):
        """Redraw every parameter from ``generator``, in the order the
        modules were made; BatchNorms to (1, 0) with fresh statistics."""
        for module in self.children():
            _reset(module, generator)


def _reset(module, generator):
    if isinstance(module, Linear):
        torch_linear_init_(module, generator)
    elif isinstance(module, TorchBatchNorm):
        module.reset_parameters()
    else:
        module.reset_parameters(generator)


# --------------------------------------------------------------------------
# GCN
# --------------------------------------------------------------------------

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
        ``num_nodes`` nodes (:func:`norm_plan` with self-loops); padded
        edges (``edge_mask`` False) weigh 0, as the JAX package's padded
        edges do."""
        return norm_plan(senders, receivers, num_nodes, edge_weight,
                         edge_mask)

    def forward(self, x, senders=None, receivers=None, edge_weight=None, *,
                plan=None):
        if plan is None:
            plan = self.build_plan(senders, receivers, x.shape[0],
                                   edge_weight)
        return _hop(self.lin(x), plan) + self.bias


class _GraphModel(_Model):
    """A model whose forward runs on the plan of ``build_plan`` (the
    ``gcn_norm`` adjacency with self-loops unless a subclass says
    otherwise)."""

    add_self_loops = True

    def build_plan(self, senders, receivers, num_nodes, edge_weight=None,
                   edge_mask=None):
        return norm_plan(senders, receivers, num_nodes, edge_weight,
                         edge_mask, add_self_loops=self.add_self_loops)

    @property
    def chunk_plan_kind(self):
        """``native.chunk_norm_csr``'s plan, with or without loops."""
        return "norm_loops" if self.add_self_loops else "norm"

    def _plan(self, plan, x, senders, receivers, edge_weight, edge_mask,
              num_nodes=None):
        if plan is not None:
            return plan
        n = x.shape[0] if num_nodes is None else num_nodes
        return self.build_plan(senders, receivers, n, edge_weight, edge_mask)


class LINK(_GraphModel):
    """Logistic regression on adjacency rows (``gnns.py:10-28``): logits =
    A · W + b, row i the sum of W's rows at i's neighbours. The "input" is
    the weight ``kernel`` [num_nodes, C] itself, through K1 with senders and
    receivers swapped (``out[s] += kernel[r]``); x is not read."""

    @property
    def chunk_plan_kind(self):
        """None LINK can train on: the weight has a row per node id of the
        whole graph, which a chunk's edges, relabelled to positions in the
        chunk, cannot address."""
        raise ValueError(
            "LINK cannot train on node chunks: its weight is indexed by the "
            "global node id, which a chunk's edges, relabelled to positions "
            "in the chunk, cannot address")

    def __init__(self, num_nodes, out_channels, *, seed=0, device=None):
        super().__init__()
        self.num_nodes = num_nodes
        self.kernel = nn.Parameter(torch.empty(num_nodes, out_channels))
        self.bias = nn.Parameter(torch.empty(out_channels))
        self._finish(seed, device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        bound = 1.0 / self.num_nodes ** 0.5
        for p in (self.kernel, self.bias):
            cpu = torch.empty(p.shape)
            nn.init.uniform_(cpu, -bound, bound, generator=generator)
            p.copy_(cpu)

    def build_plan(self, senders, receivers, num_nodes, edge_weight=None,
                   edge_mask=None):
        ones = torch.ones(senders.shape, device=senders.device)
        values = _masked_weight(senders, ones, edge_mask)
        return build_spmm_plan(values, receivers, senders, num_nodes)

    def forward(self, x, senders=None, receivers=None, edge_weight=None, *,
                plan=None, edge_mask=None, **kw):
        plan = self._plan(plan, x, senders, receivers, edge_weight,
                          edge_mask, self.num_nodes)
        return _hop(self.kernel, plan) + self.bias


class MLP(_Model):
    """``gnns.py:31-64``: Linear → ReLU → BatchNorm → dropout stack; one
    Linear (``lin``, flax's ``TorchLinear_0``) at ``num_layers=1``. Reads
    no graph (``build_plan`` gives None)."""

    def __init__(self, in_channels, hidden_channels, out_channels,
                 num_layers=2, dropout=0.5, *, seed=0, device=None):
        super().__init__()
        self.num_layers = num_layers
        self.dropout = dropout
        if num_layers == 1:
            self.lin = Linear(in_channels, out_channels)
        else:
            width = in_channels
            for i in range(num_layers - 1):
                setattr(self, f"lin_{i}", Linear(width, hidden_channels))
                setattr(self, f"bn_{i}", TorchBatchNorm(hidden_channels))
                width = hidden_channels
            self.lin_out = Linear(hidden_channels, out_channels)
        self._finish(seed, device)

    @staticmethod
    def build_plan(*args, **kw):
        return None

    def forward(self, x, *args, generator=None, **kw):
        if self.num_layers == 1:
            return self.lin(x)
        for i in range(self.num_layers - 1):
            x = torch.relu(getattr(self, f"lin_{i}")(x))
            x = getattr(self, f"bn_{i}")(x)
            x = dropout(x, self.dropout, self.training, generator)
        return self.lin_out(x)


class SGC(_GraphModel):
    """``gnns.py:66-115`` (the SGCMem form): one Linear (``lin``), then
    ``hops`` products with the ``gcn_norm`` adjacency."""

    def __init__(self, in_channels, out_channels, hops=2,
                 add_self_loops=True, *, seed=0, device=None):
        super().__init__()
        self.hops = hops
        self.add_self_loops = add_self_loops
        self.lin = Linear(in_channels, out_channels)
        self._finish(seed, device)

    def forward(self, x, senders=None, receivers=None, edge_weight=None, *,
                plan=None, edge_mask=None, **kw):
        plan = self._plan(plan, x, senders, receivers, edge_weight,
                          edge_mask)
        x = self.lin(x)
        for _ in range(self.hops):
            x = _hop(x, plan)
        return x


class GCN(_GraphModel):
    """``gnns.py:118-161``: GCNConv → BatchNorm → ReLU → dropout stack."""

    def __init__(self, in_channels, hidden_channels, out_channels,
                 num_layers=2, dropout=0.5, use_bn=True, *, seed=0,
                 device=None):
        super().__init__()
        self.num_layers = num_layers
        self.dropout = dropout
        self.use_bn = use_bn
        width = in_channels
        for i in range(num_layers - 1):
            setattr(self, f"conv_{i}", GCNLayer(width, hidden_channels))
            if use_bn:
                setattr(self, f"bn_{i}", TorchBatchNorm(hidden_channels))
            width = hidden_channels
        self.conv_out = GCNLayer(width, out_channels)
        self._finish(seed, device)

    def forward(self, x, senders=None, receivers=None, edge_weight=None, *,
                plan=None, edge_mask=None, generator=None, **kw):
        plan = self._plan(plan, x, senders, receivers, edge_weight,
                          edge_mask)
        for i in range(self.num_layers - 1):
            x = getattr(self, f"conv_{i}")(x, plan=plan)
            if self.use_bn:
                x = getattr(self, f"bn_{i}")(x)
            x = dropout(torch.relu(x), self.dropout, self.training,
                        generator)
        return self.conv_out(x, plan=plan)


# --------------------------------------------------------------------------
# GAT
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GATPlan:
    """GAT's graph: ``plan``, the K1 plan of the edges with a self-loop on
    every node, in receiver order (so the plan's edge order is its CSR
    order), with both edge orders for per-call values; the incidences of
    those edges with their receivers (``dst``) and senders (``src``); and
    ``rows`` ([E], int64 or int32), each edge's receiver. ``positions``
    (int64 [E]: 0 … E − 1) marks a plan held at a capacity, whose edges
    past ``plan.row_ptr[-1]`` are padding (None: every edge is real)."""

    plan: CsrPlan
    dst: EdgeIncidence
    src: EdgeIncidence
    rows: torch.Tensor
    positions: Optional[torch.Tensor] = None

    def padded(self):
        """[E, 1] bool, True on the padded edges of a plan held at a
        capacity, or None. On the device, with nothing read back."""
        if self.positions is None:
            return None
        return (self.positions >= self.plan.row_ptr[-1])[:, None]


def gat_plan(senders, receivers, num_nodes, edge_mask=None,
             add_self_loops=True) -> GATPlan:
    """The :class:`GATPlan` of a graph; padded edges (``edge_mask`` False)
    are left out. Once per graph (it reads the mask back)."""
    s, r = senders.long(), receivers.long()
    if edge_mask is not None:
        keep = edge_mask.bool()
        s, r = s[keep], r[keep]
    if add_self_loops:
        loop = torch.arange(num_nodes, device=s.device)
        s, r = torch.cat([s, loop]), torch.cat([r, loop])
    order = torch.argsort(r, stable=True)
    s, r = s[order], r[order]
    plan = build_spmm_plan(None, s, r, num_nodes, value_grad=True)
    return GATPlan(plan, edge_incidence(plan, "receiver"),
                   edge_incidence(plan, "sender"), r)


def gat_plan_from_views(v, num_nodes) -> GATPlan:
    """The :class:`GATPlan` of ``num_nodes`` nodes over the views ``v`` of
    the arrays the host built for a chunk (``native.chunk_gat_csr``:
    ``row_ptr``, ``col``, ``edge_row``, ``t_row_ptr``, ``t_col``,
    ``t_pos``; K1's two split schedules and K1-dval's, ``d_``), equal to
    :func:`gat_plan`'s for the chunk's edges. What the views do not hold
    is fixed by their sizes and made here: the unit values, the identity
    edge orders and the edges' one-entry rows (never heavy). With
    ``counts`` the views are held at a capacity and the plan marks its
    padding (``positions``); without, the plan is exact."""
    col = v["col"]
    e, dev = col.numel(), col.device
    counts = v.get("counts")

    def part(i):  # the i-th schedule's counts, at a capacity
        return None if counts is None else counts[2 * i:2 * i + 2]

    ones = torch.ones(e, device=dev)
    order = torch.arange(e, device=dev)
    split, t_split = splits_of(v, "", part(0)), splits_of(v, "t_", part(1))
    plan = CsrPlan(num_nodes=num_nodes, row_ptr=v["row_ptr"], col=col,
                   val=ones, t_row_ptr=v["t_row_ptr"], t_col=v["t_col"],
                   t_val=ones, split=split, t_split=t_split, order=order,
                   t_order=v["t_pos"], inv_order=order, rows=v["edge_row"],
                   dval_split=splits_of(v, "d_", part(2),
                                        DVAL_SPLIT_THRESHOLD))
    edge_ptr = torch.arange(e + 1, dtype=torch.int32, device=dev)
    empty = torch.zeros(0, dtype=torch.int32, device=dev)
    edge_split = RowSplit(SPLIT_THRESHOLD, empty, torch.zeros(
        1, dtype=torch.int32, device=dev), empty, empty)
    dst = EdgeIncidence(
        (edge_ptr, v["edge_row"], ones, edge_split),
        (v["row_ptr"], order.to(torch.int32), ones, split))
    src = EdgeIncidence((edge_ptr, col, ones, edge_split),
                        (v["t_row_ptr"], v["t_pos"], ones, t_split))
    return GATPlan(plan, dst, src, v["edge_row"],
                   None if counts is None else order)


class GATLayer(nn.Module):
    """GATConv (``gnns.py:163-201``, PyG's GATConv): per head, additive
    attention ``LeakyReLU(a_src·f[s] + a_dst·f[r])`` with slope 0.2,
    softmax over each receiver's edges (self-loops included), dropout on
    the attention, messages ``att · f[s]`` summed into the receivers, the
    heads concatenated or averaged, plus ``bias``. ``lin`` has no bias;
    ``att_src``/``att_dst`` are [1, H, D] (glorot-uniform, as flax's)."""

    def __init__(self, in_channels, out_channels, heads=2, concat=True,
                 dropout=0.0, negative_slope=0.2):
        super().__init__()
        self.heads, self.out_channels = heads, out_channels
        self.concat = concat
        self.dropout = dropout
        self.negative_slope = negative_slope
        self.lin = Linear(in_channels, heads * out_channels, bias=False)
        self.att_src = nn.Parameter(torch.empty(1, heads, out_channels))
        self.att_dst = nn.Parameter(torch.empty(1, heads, out_channels))
        self.bias = nn.Parameter(torch.zeros(
            heads * out_channels if concat else out_channels))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        torch_linear_init_(self.lin, generator)
        limit = (6.0 / (self.heads + self.out_channels)) ** 0.5
        for p in (self.att_src, self.att_dst):
            cpu = torch.empty(p.shape)
            nn.init.uniform_(cpu, -limit, limit, generator=generator)
            p.copy_(cpu)
        self.bias.zero_()

    def forward(self, x, plan: GATPlan, generator=None):
        n, h, d = x.shape[0], self.heads, self.out_channels
        feat = self.lin(x).reshape(n, h, d)
        score_src = (feat * self.att_src).sum(-1)           # [N, H]
        score_dst = (feat * self.att_dst).sum(-1)
        e = F.leaky_relu(plan.src.gather(score_src)
                         + plan.dst.gather(score_dst),
                         self.negative_slope)               # [E, H]
        padded = plan.padded()
        if padded is not None:
            # a plan at a capacity: a padded edge (which every sum over the
            # CSRs leaves out) joins no max, weighs exp(-inf) = 0 and takes
            # no gradient, whatever K1-dval leaves in its slot
            e = e.masked_fill(padded, float("-inf"))
        with torch.no_grad():
            top = segment_max(e, plan.rows, n)
            top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
        ex = torch.exp(e - top[plan.rows])
        den = plan.dst.sum(ex).clamp(min=1e-16)             # [N, H]
        att = ex / plan.dst.gather(den)
        att = dropout(att, self.dropout, self.training, generator)
        out = spmm(att, None, None, feat, plan=plan.plan)   # [N, H, D]
        if self.concat:
            return out.reshape(n, h * d) + self.bias
        return out.mean(1) + self.bias


class _GATModel(_Model):
    chunk_plan_kind = "gat"

    def build_plan(self, senders, receivers, num_nodes, edge_weight=None,
                   edge_mask=None):
        """The :class:`GATPlan` of the graph (edge weights are not read, as
        in the JAX package)."""
        return gat_plan(senders, receivers, num_nodes, edge_mask)

    def _gat_plan(self, plan, x, senders, receivers, edge_mask):
        if plan is not None:
            return plan
        return self.build_plan(senders, receivers, x.shape[0],
                               edge_mask=edge_mask)


class GAT(_GATModel):
    """``gnns.py:163-201``: GATConv stack (heads concatenated) with
    optional BatchNorm, ELU and dropout; the last layer averages
    ``out_heads`` heads."""

    def __init__(self, in_channels, hidden_channels, out_channels,
                 num_layers=2, dropout=0.5, use_bn=False, heads=2,
                 out_heads=1, *, seed=0, device=None):
        super().__init__()
        self.num_layers = num_layers
        self.dropout = dropout
        self.use_bn = use_bn
        width = in_channels
        for i in range(num_layers - 1):
            setattr(self, f"conv_{i}", GATLayer(width, hidden_channels,
                                                heads, True, dropout))
            width = hidden_channels * heads
            if use_bn:
                setattr(self, f"bn_{i}", TorchBatchNorm(width))
        self.conv_out = GATLayer(width, out_channels, out_heads, False,
                                 dropout)
        self._finish(seed, device)

    def forward(self, x, senders=None, receivers=None, edge_weight=None, *,
                plan=None, edge_mask=None, generator=None, **kw):
        plan = self._gat_plan(plan, x, senders, receivers, edge_mask)
        for i in range(self.num_layers - 1):
            x = getattr(self, f"conv_{i}")(x, plan, generator)
            if self.use_bn:
                x = getattr(self, f"bn_{i}")(x)
            x = dropout(F.elu(x), self.dropout, self.training, generator)
        return self.conv_out(x, plan, generator)


# --------------------------------------------------------------------------
# label propagation
# --------------------------------------------------------------------------

def lp_targets(label, train_idx, num_nodes, out_channels, mult_bin=False):
    """The seed matrix of label propagation (``gnns.py:221-247``), numpy
    float32: one-hot class rows of the labelled training nodes for
    single-label targets, two columns a task for ``mult_bin``, else the
    training rows of a multilabel target."""
    label = np.asarray(label)
    train_mask = np.zeros(num_nodes, bool)
    train_mask[np.asarray(train_idx)] = True
    if label.ndim == 1 or label.shape[-1] == 1:
        flat = label.reshape(-1).astype(np.int64)
        y = np.zeros((num_nodes, out_channels), np.float32)
        sel = train_mask & (flat >= 0)
        y[sel, flat[sel]] = 1.0
    elif mult_bin:
        t = label.shape[1]
        y = np.zeros((num_nodes, 2 * t), np.float32)
        for task in range(t):
            y[train_mask, 2 * task
              + label[train_mask, task].astype(np.int64)] = 1.0
    else:
        y = np.zeros((num_nodes, out_channels), np.float32)
        y[train_mask] = label[train_mask]
    return y


@torch.no_grad()
def multi_lp(senders, receivers, label, train_idx, num_nodes, out_channels,
             *, alpha=0.9, hops=1, num_iters=50, mult_bin=False,
             edge_weight=None, device=None):
    """Label propagation (``gnns.py:221-259``): ``num_iters`` rounds of
    ``result = α·Â^hops·result + (1−α)·y`` from ``result = y``, Â the
    ``gcn_norm`` adjacency without self-loops, one plan for every product
    (K1). No parameters and no gradient. Edges are numpy or tensors; the
    result is a tensor on ``device`` (the GPU unless told otherwise):
    [N, C], or [N, tasks] (each task's positive column) with
    ``mult_bin``."""
    dev = resolve_device(device)
    s = torch.as_tensor(np.asarray(senders), device=dev)
    r = torch.as_tensor(np.asarray(receivers), device=dev)
    w = None if edge_weight is None else torch.as_tensor(
        np.asarray(edge_weight), dtype=torch.float32, device=dev)
    plan = norm_plan(s, r, num_nodes, w, add_self_loops=False)
    y = torch.as_tensor(lp_targets(label, train_idx, num_nodes,
                                   out_channels, mult_bin), device=dev)
    result = y
    for _ in range(num_iters):
        for _ in range(hops):
            result = _hop(result, plan)
        result = alpha * result + (1 - alpha) * y
    if mult_bin:
        result = result.reshape(num_nodes, -1, 2)[:, :, 1]
    return result


# --------------------------------------------------------------------------
# MixHop, jumping knowledge, H2GCN, APPNP, GPRGNN
# --------------------------------------------------------------------------

class MixHopLayer(nn.Module):
    """``gnns.py:256-278``: ``[x W_0 ‖ Â x W_1 ‖ … ‖ Â^hops x W_hops]``
    (``lin_{j}``)."""

    def __init__(self, in_channels, out_channels, hops=2):
        super().__init__()
        self.hops = hops
        for j in range(hops + 1):
            setattr(self, f"lin_{j}", Linear(in_channels, out_channels))

    def reset_parameters(self, generator: torch.Generator):
        for j in range(self.hops + 1):
            torch_linear_init_(getattr(self, f"lin_{j}"), generator)

    def forward(self, x, plan):
        xs = [self.lin_0(x)]
        for j in range(1, self.hops + 1):
            x_j = getattr(self, f"lin_{j}")(x)
            for _ in range(j):
                x_j = _hop(x_j, plan)
            xs.append(x_j)
        return torch.cat(xs, dim=1)


class MixHop(_GraphModel):
    """``gnns.py:280-341``: MixHop layers over the ``gcn_norm`` adjacency
    without self-loops, BatchNorm, ReLU and dropout, then
    ``final_project``."""

    add_self_loops = False

    def __init__(self, in_channels, hidden_channels, out_channels,
                 num_layers=2, dropout=0.5, hops=2, *, seed=0, device=None):
        super().__init__()
        self.num_layers = num_layers
        self.dropout = dropout
        width = in_channels
        for i in range(num_layers - 1):
            setattr(self, f"conv_{i}", MixHopLayer(width, hidden_channels,
                                                   hops))
            width = hidden_channels * (hops + 1)
            setattr(self, f"bn_{i}", TorchBatchNorm(width))
        self.conv_out = MixHopLayer(width, out_channels, hops)
        self.final_project = Linear(out_channels * (hops + 1), out_channels)
        self._finish(seed, device)

    def forward(self, x, senders=None, receivers=None, edge_weight=None, *,
                plan=None, edge_mask=None, generator=None, **kw):
        plan = self._plan(plan, x, senders, receivers, edge_weight,
                          edge_mask)
        for i in range(self.num_layers - 1):
            x = getattr(self, f"bn_{i}")(getattr(self, f"conv_{i}")(x, plan))
            x = dropout(torch.relu(x), self.dropout, self.training,
                        generator)
        return self.final_project(self.conv_out(x, plan))


class JumpingKnowledge(nn.Module):
    """JumpingKnowledge over the layers' outputs (``gnns.py:308-340``, PyG's):
    their element-wise ``max``, their concatenation (``cat``), or ``lstm``:
    a bidirectional LSTM (flax ``OptimizedLSTMCell`` gates i, f, g, o as
    ``nn.LSTMCell`` with a zero, frozen input bias) over the layer sequence,
    hidden size ``channels``, a scalar score per layer from ``att`` on both
    directions' states, and the softmax-weighted sum over the layers."""

    def __init__(self, mode, channels):
        super().__init__()
        if mode not in ("max", "cat", "lstm"):
            raise NotImplementedError(f"JK mode {mode!r}")
        self.mode = mode
        if mode == "lstm":
            self.lstm_fwd = nn.LSTMCell(channels, channels)
            self.lstm_bwd = nn.LSTMCell(channels, channels)
            self.att = Linear(2 * channels, 1)

    def reset_parameters(self, generator: torch.Generator):
        if self.mode == "lstm":
            flax_lstm_init_(self.lstm_fwd, generator)
            flax_lstm_init_(self.lstm_bwd, generator)
            torch_linear_init_(self.att, generator)

    @staticmethod
    def _run(cell, seq):
        state, ys = None, []
        for t in range(seq.shape[0]):
            state = cell(seq[t], state)
            ys.append(state[0])
        return torch.stack(ys, 0)

    def forward(self, xs):
        if self.mode == "max":
            return torch.stack(xs, 0).amax(0)
        if self.mode == "cat":
            return torch.cat(xs, dim=-1)
        seq = torch.stack(xs, 0)                             # [L, N, C]
        fwd = self._run(self.lstm_fwd, seq)
        bwd = self._run(self.lstm_bwd, seq.flip(0)).flip(0)
        score = self.att(torch.cat([fwd, bwd], -1))[..., 0]  # [L, N]
        alpha = torch.softmax(score, dim=0)
        return (seq * alpha[..., None]).sum(0)


def _jk_width(jk_type, channels, layers):
    return channels * layers if jk_type == "cat" else channels


class GCNJK(_GraphModel):
    """``gnns.py:343-390``: a GCN stack (BatchNorm, ReLU, dropout) whose
    layers' outputs meet in jumping knowledge (``jk``), then
    ``final_project``."""

    def __init__(self, in_channels, hidden_channels, out_channels,
                 num_layers=2, dropout=0.5, jk_type="max", *, seed=0,
                 device=None):
        super().__init__()
        self.num_layers = num_layers
        self.dropout = dropout
        width = in_channels
        for i in range(num_layers - 1):
            setattr(self, f"conv_{i}", GCNLayer(width, hidden_channels))
            setattr(self, f"bn_{i}", TorchBatchNorm(hidden_channels))
            width = hidden_channels
        self.conv_out = GCNLayer(width, hidden_channels)
        self.jk = JumpingKnowledge(jk_type, hidden_channels)
        self.final_project = Linear(
            _jk_width(jk_type, hidden_channels, num_layers), out_channels)
        self._finish(seed, device)

    def forward(self, x, senders=None, receivers=None, edge_weight=None, *,
                plan=None, edge_mask=None, generator=None, **kw):
        plan = self._plan(plan, x, senders, receivers, edge_weight,
                          edge_mask)
        xs = []
        for i in range(self.num_layers - 1):
            x = getattr(self, f"conv_{i}")(x, plan=plan)
            x = torch.relu(getattr(self, f"bn_{i}")(x))
            xs.append(x)
            x = dropout(x, self.dropout, self.training, generator)
        xs.append(self.conv_out(x, plan=plan))
        return self.final_project(self.jk(xs))


class GATJK(_GATModel):
    """``gnns.py:392-443``: a GAT stack (heads concatenated, no attention
    dropout, BatchNorm, ELU, dropout) whose layers' outputs meet in jumping
    knowledge, then ``final_project``."""

    def __init__(self, in_channels, hidden_channels, out_channels,
                 num_layers=2, dropout=0.5, heads=2, jk_type="max", *,
                 seed=0, device=None):
        super().__init__()
        self.num_layers = num_layers
        self.dropout = dropout
        width, hid = in_channels, hidden_channels * heads
        for i in range(num_layers - 1):
            setattr(self, f"conv_{i}", GATLayer(width, hidden_channels,
                                                heads, True))
            setattr(self, f"bn_{i}", TorchBatchNorm(hid))
            width = hid
        self.conv_out = GATLayer(width, hidden_channels, heads, True)
        self.jk = JumpingKnowledge(jk_type, hid)
        self.final_project = Linear(_jk_width(jk_type, hid, num_layers),
                                    out_channels)
        self._finish(seed, device)

    def forward(self, x, senders=None, receivers=None, edge_weight=None, *,
                plan=None, edge_mask=None, generator=None, **kw):
        plan = self._gat_plan(plan, x, senders, receivers, edge_mask)
        xs = []
        for i in range(self.num_layers - 1):
            x = getattr(self, f"conv_{i}")(x, plan, generator)
            x = F.elu(getattr(self, f"bn_{i}")(x))
            xs.append(x)
            x = dropout(x, self.dropout, self.training, generator)
        xs.append(self.conv_out(x, plan, generator))
        return self.final_project(self.jk(xs))


class H2GCN(_GraphModel):
    """The JAX package's H2GCN (``gnns.py:400-429``; the reference defines
    only the conv): ``embed`` with ReLU, then ``num_layers`` rounds of
    ``h ← [Â h ‖ Â² h]`` over the ``gcn_norm`` adjacency without
    self-loops, every round's output concatenated, dropout, then
    ``final_project``."""

    add_self_loops = False

    def __init__(self, in_channels, hidden_channels, out_channels,
                 num_layers=2, dropout=0.5, *, seed=0, device=None):
        super().__init__()
        self.num_layers = num_layers
        self.dropout = dropout
        self.embed = Linear(in_channels, hidden_channels)
        total = hidden_channels * (2 ** (num_layers + 1) - 1)
        self.final_project = Linear(total, out_channels)
        self._finish(seed, device)

    def forward(self, x, senders=None, receivers=None, edge_weight=None, *,
                plan=None, edge_mask=None, generator=None, **kw):
        plan = self._plan(plan, x, senders, receivers, edge_weight,
                          edge_mask)
        h = torch.relu(self.embed(x))
        xs = [h]
        for _ in range(self.num_layers):
            h1 = _hop(h, plan)
            h = torch.cat([h1, _hop(h1, plan)], dim=1)
            xs.append(h)
        out = dropout(torch.cat(xs, dim=1), self.dropout, self.training,
                      generator)
        return self.final_project(out)


def _two_layer_mlp(model, x, generator):
    """APPNP's and GPRGNN's MLP: dropout, ``lin1`` with ReLU, dropout,
    ``lin2``."""
    x = dropout(x, model.dropout, model.training, generator)
    x = torch.relu(model.lin1(x))
    x = dropout(x, model.dropout, model.training, generator)
    return model.lin2(x)


class APPNPNet(_GraphModel):
    """``gnns.py:459-477``: dropout, ``lin1`` with ReLU, dropout, ``lin2``,
    then K rounds of ``x ← (1−α)·Â x + α·x₀`` (PyG's APPNP)."""

    def __init__(self, in_channels, hidden_channels, out_channels,
                 dropout=0.5, K=10, alpha=0.1, *, seed=0, device=None):
        super().__init__()
        self.dropout, self.K, self.alpha = dropout, K, alpha
        self.lin1 = Linear(in_channels, hidden_channels)
        self.lin2 = Linear(hidden_channels, out_channels)
        self._finish(seed, device)

    def forward(self, x, senders=None, receivers=None, edge_weight=None, *,
                plan=None, edge_mask=None, generator=None, **kw):
        plan = self._plan(plan, x, senders, receivers, edge_weight,
                          edge_mask)
        x = x0 = _two_layer_mlp(self, x, generator)
        for _ in range(self.K):
            x = (1 - self.alpha) * _hop(x, plan) + self.alpha * x0
        return x


class GPRGNN(_GraphModel):
    """``gnns.py:479-580``: APPNP's MLP, dropout at ``dprate``, then the
    learned generalized-PageRank filter ``Σ_k temp[k] Â^k x`` over K hops;
    ``temp`` [K + 1] starts at the PPR weights ``α(1−α)^k``, the last
    ``(1−α)^K``, and is a parameter like any other (Adam decays it too)."""

    def __init__(self, in_channels, hidden_channels, out_channels,
                 dropout=0.5, dprate=0.5, K=10, alpha=0.1, *, seed=0,
                 device=None):
        super().__init__()
        self.dropout, self.dprate, self.K, self.alpha = (dropout, dprate, K,
                                                         alpha)
        self.lin1 = Linear(in_channels, hidden_channels)
        self.lin2 = Linear(hidden_channels, out_channels)
        self.temp = nn.Parameter(torch.empty(K + 1))
        self._finish(seed, device)

    def reset_parameters(self, generator: torch.Generator):
        torch_linear_init_(self.lin1, generator)
        torch_linear_init_(self.lin2, generator)
        k = np.arange(self.K + 1)
        temp = self.alpha * (1 - self.alpha) ** k
        temp[-1] = (1 - self.alpha) ** self.K
        with torch.no_grad():
            self.temp.copy_(torch.as_tensor(temp, dtype=torch.float32))

    def forward(self, x, senders=None, receivers=None, edge_weight=None, *,
                plan=None, edge_mask=None, generator=None, **kw):
        plan = self._plan(plan, x, senders, receivers, edge_weight,
                          edge_mask)
        x = _two_layer_mlp(self, x, generator)
        x = dropout(x, self.dprate, self.training, generator)
        hidden = x * self.temp[0]
        for k in range(self.K):
            x = _hop(x, plan)
            hidden = hidden + self.temp[k + 1] * x
        return hidden


#: Every model of the zoo, for ``utils/weights.py``.
ZOO = (LINK, MLP, SGC, GCN, GAT, MixHop, GCNJK, GATJK, H2GCN, APPNPNet,
       GPRGNN)
