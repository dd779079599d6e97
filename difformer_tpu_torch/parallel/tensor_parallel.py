"""Tensor parallelism over attention heads, as
``difformer_tpu/parallel/tensor_parallel.py`` (the Megatron column → row
split).

In ``DIFFormerConv`` the heads are independent until the mean over them
(reference ``node classification/difformer.py:115-130``), so Wq, Wk and Wv
are column-sharded over a model axis (T ranks, each holding H/T whole
heads: rows [m·H/T·D, (m+1)·H/T·D) of each projection's [H·D, in] weight
and bias, which torch stores transposed from flax's [in, H·D]) and the
mean over heads is the layer's one all-reduce. The JAX package annotates
the shardings and lets GSPMD insert the reductions; here the model is
built with the model axis's process group (``DIFFormer(...,
head_axis=...)``, ``nn/difformer.py``), which sums the Frobenius sums of
squares and the head mean over it, the fused and factored forms included.
Every other parameter is replicated. A second axis cuts the nodes:
:class:`~difformer_tpu_torch.parallel.mesh.Grid` (``make_grid``) gives
each rank its graph group and its model group, and with
``node_axis="graph"`` the model also takes the graph group as
``axis_name`` and runs on the rank's shard of ``parallel/partition.py``
through the exchanges of ``parallel/sharded_ops.py``, where the JAX
package lets GSPMD gather over replicated edges. With
``kernel="sigmoid"`` each rank's K2–K4 run on its H/T heads (on the ring,
``sharded_ops.sigmoid_attention_sharded``, when node-sharded).

The gradient rule (:func:`make_tp_train_step`) is Megatron's pair on the
model axis (``ops/comm.py``): the layer's replicated input enters the
rank's heads through ``copy_to_group`` (identity forward, its gradient
all-reduced) and the head mean leaves through ``reduce_from_group``
(all-reduce forward, its gradient as it is), and every rank of a model
group backpropagates the whole loss of its rows. So each rank's head
block gets its whole gradient, and a replicated parameter gets the same
whole gradient on every rank of the group, with no reduction of the
parameters' gradients over the model axis. (The other rule, each rank
backpropagating 1/T of the loss and the replicated gradients summed over
the model group, gives the same gradient with one more all-reduce a step
and each rank's part of dL/dx carried down through every layer.) On the
graph axis the rule is
``parallel/api.py``'s: each graph rank backpropagates its part s / C of
the global mean, and every gradient is summed over the graph group by
``api.make_sharded_train_step``, whose step the grid's is. The optimiser
steps on the rank's own parameters, so Adam's moments live with their
shards. The loss returned is the global mean, the same on every rank.
Ranks of one model group run on the same rows and must draw the same
dropout masks: :func:`tp_generator` seeds each from (seed, graph rank).
The step runs eagerly.

Deviation, documented (ROADMAP.md queue C): T must divide H
(:func:`tp_shard_params` and the model raise ``ValueError``), as the JAX
docstring states; the JAX check only asks that T divide H·D, and so
accepts a split head.

:func:`train_tp` is a rank function for ``launch.run_ranks``.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from difformer_tpu_torch.parallel.api import (launch_counts,
                                              make_sharded_train_step,
                                              nll_sum_count, rank_generator,
                                              rank_plan, reset_launch_counts,
                                              sharded_apply)
from difformer_tpu_torch.parallel.mesh import Grid

#: The projections whose outputs are [N, H·D] (``nn/difformer.py``).
_TP_PROJECTIONS = ("Wq", "Wk", "Wv")


def _is_sharded(key):
    parts = key.split(".")
    return (len(parts) == 4 and parts[0] == "convs"
            and parts[2] in _TP_PROJECTIONS
            and parts[3] in ("weight", "bias"))


def tp_param_specs(state_dict):
    """{key: 0 for the column-sharded keys (``convs.{i}.W{q,k,v}.weight``
    and ``.bias``, split along dim 0), None for every replicated one}."""
    return {k: 0 if _is_sharded(k) else None for k in state_dict}


def tp_shard_params(state_dict, mesh, *, num_heads):
    """This rank's ``state_dict``: each column-sharded entry (numpy array
    or tensor) cut to the rank's block of ``num_heads`` / T heads along
    dim 0 (T and the block from ``mesh``, a model axis or a
    :class:`Grid`), every other entry as it is. Raises ``ValueError``
    unless T divides ``num_heads``."""
    axis = mesh.model if isinstance(mesh, Grid) else mesh
    if num_heads % axis.size:
        raise ValueError(
            f"the model axis has {axis.size} ranks, which does not divide "
            f"num_heads={num_heads}: each rank holds whole heads")
    out = {}
    for key, value in state_dict.items():
        if _is_sharded(key):
            rows = value.shape[0]
            if rows % num_heads:
                raise ValueError(f"{key} has {rows} rows, not a multiple "
                                 f"of num_heads={num_heads}")
            block = rows // axis.size
            value = value[axis.rank * block:(axis.rank + 1) * block]
        out[key] = value
    return out


def load_tp_params(model, params, mesh):
    """Load a JAX params tree (of the unsharded model) into the rank's
    head-sharded ``model``."""
    from difformer_tpu_torch.utils.weights import (
        torch_state_dict_from_params)

    sd = tp_shard_params(torch_state_dict_from_params(params), mesh,
                         num_heads=model.convs[0].num_heads)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()})


def _axes(mesh, node_axis):
    """(model axis, graph axis or None): the graph axis cuts the nodes
    (``node_axis="graph"``); a grid without ``node_axis`` runs on its
    model axis, each graph group holding every row."""
    if node_axis not in (None, "graph"):
        raise ValueError(f"node_axis must be None or 'graph', got "
                         f"{node_axis!r}")
    if node_axis is not None and not isinstance(mesh, Grid):
        raise ValueError("node_axis='graph' needs a graph x model grid "
                         "(parallel/mesh.py:make_grid)")
    if not isinstance(mesh, Grid):
        return mesh, None
    return mesh.model, None if node_axis is None else mesh.graph


def _check_model(model, model_axis, graph_axis):
    if model.head_axis is not model_axis.group:
        raise ValueError("the model must be built with head_axis= the "
                         "model axis's group (Mesh.group, Grid.model.group)")
    want = None if graph_axis is None else graph_axis.group
    if model.axis_name is not want:
        raise ValueError("the model's axis_name must be the grid's graph "
                         "group with node_axis='graph', None without")


def tp_generator(seed, mesh, device, node_axis=None):
    """The dropout generator of this rank, the same on every rank of its
    model group: seeded from (seed, its graph rank) when node-sharded,
    from (seed, 0) otherwise."""
    _, graph_axis = _axes(mesh, node_axis)
    return rank_generator(seed, 0 if graph_axis is None else
                          graph_axis.rank, device)


def tp_apply(model, mesh, node_axis=None):
    """The forward of the head-sharded ``model`` on ``mesh`` (a model axis
    or a :class:`Grid`): without ``node_axis``, ``fn(x, senders,
    receivers, edge_weight=None, *, plan=None, generator=None,
    train=False)`` → the whole graph's logits [N, C] on every rank; with
    ``node_axis="graph"``, ``fn(rank_graph, plan=None, generator=None,
    train=False)`` → this rank's shard's logits [N_loc, C]
    (``api.sharded_apply``; ``plan`` of ``api.rank_plan`` over the graph
    group). The model must take the axes' groups as ``head_axis`` and
    ``axis_name``."""
    model_axis, graph_axis = _axes(mesh, node_axis)
    _check_model(model, model_axis, graph_axis)
    if graph_axis is not None:
        return sharded_apply(model, graph_axis)

    def apply_fn(x, senders, receivers, edge_weight=None, *, plan=None,
                 generator=None, train=False):
        model.train(train)
        with torch.set_grad_enabled(train):
            return model(x, senders, receivers, edge_weight, plan=plan,
                         generator=generator)

    return apply_fn


def make_tp_train_step(model, mesh, optimizer, loss_fn=nll_sum_count,
                       node_axis=None):
    """One head-sharded train step under the module's gradient rule;
    ``loss_fn(logits, labels, mask) -> (sum, count)``. Without
    ``node_axis``: ``step(x, senders, receivers, labels, mask, *,
    edge_weight=None, plan=None, generator=None) -> loss`` on the whole
    graph; with ``node_axis="graph"``: ``step(rank_graph, generator=None,
    plan=None) -> loss`` on the rank's shard (``api.
    make_sharded_train_step`` over the graph group). The loss, a 0-d
    tensor, is the global mean. After it each parameter's ``.grad`` holds
    its gradient: the rank's block of a head-sharded one."""
    model_axis, graph_axis = _axes(mesh, node_axis)
    _check_model(model, model_axis, graph_axis)
    if graph_axis is not None:
        return make_sharded_train_step(model, graph_axis, optimizer, loss_fn)
    apply_fn = tp_apply(model, mesh)

    def step(x, senders, receivers, labels, mask, *, edge_weight=None,
             plan=None, generator=None):
        optimizer.zero_grad(set_to_none=True)
        s, c = loss_fn(apply_fn(x, senders, receivers, edge_weight,
                                plan=plan, generator=generator, train=True),
                       labels, mask)
        loss = s / c.clamp(min=1.0)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def train_tp(mesh, params, model_kw, *, steps, lr=1e-2, weight_decay=5e-4,
             seed=0, graph=None, sg=None):
    """A rank function for ``launch.run_ranks``: this rank's head-sharded
    DIFFormer (``model_kw`` with ``in_channels``, ``hidden_channels`` and
    ``out_channels``; ``num_heads`` the whole model's) loaded with the JAX
    params tree
    ``params`` (:func:`load_tp_params`), then ``steps`` train steps
    (:func:`make_tp_train_step`) with the port's Adam. On a model axis
    (``mesh`` a :class:`Mesh`) the whole graph ``graph`` = (x,
    edge_index, labels, train mask) is every rank's input; on a
    :class:`Grid` (``rank_checks.run_checks`` makes one for a case with
    ``grid``) each rank runs its graph rank's shard of the partition
    ``sg``. Returns a dict:
    ``losses``; ``logits0`` and ``logits`` (eval mode, before and after
    the steps; [N, C], or [N_loc, C] of the shard); ``grads``, every
    parameter's gradient after the first step, and ``params`` after the
    steps, by ``state_dict`` key (the rank's block of the sharded ones);
    ``sharded``, those keys; ``model_rank``, ``graph_rank``;
    ``launches`` (K1's, and K2–K4's where they launched, over the steps);
    ``products``, the K1 products a layer's graph branch runs each way
    (the rank's plans with an entry on a grid, else 1);
    ``step_ms`` (host clock, synchronised, the median of the steps after
    the first), ``setup_s``, ``total_s``, ``jax_loaded``."""
    from difformer_tpu_torch.nn.difformer import DIFFormer
    from difformer_tpu_torch.train.optim import torch_adam

    start = time.perf_counter()
    node_axis = "graph" if isinstance(mesh, Grid) else None
    model_axis, graph_axis = _axes(mesh, node_axis)
    world = mesh.world if isinstance(mesh, Grid) else mesh
    device = mesh.device
    kw = dict(model_kw)
    model = DIFFormer(kw.pop("in_channels"), kw.pop("hidden_channels"),
                      kw.pop("out_channels"), head_axis=model_axis.group,
                      axis_name=None if graph_axis is None
                      else graph_axis.group, device=device, **kw)
    load_tp_params(model, params, mesh)
    generator = tp_generator(seed, mesh, device, node_axis)
    apply_fn = tp_apply(model, mesh, node_axis)
    if graph_axis is None:
        x, ei, y, mask = graph
        x = torch.as_tensor(x, device=device)
        senders, receivers = (torch.as_tensor(a, device=device)
                              for a in ei)
        plan = model.build_plan(senders, receivers, x.shape[0])
        products = 1
        args = (x, senders, receivers, torch.as_tensor(y, device=device),
                torch.as_tensor(mask, device=device))
        forward = lambda: apply_fn(x, senders, receivers,  # noqa: E731
                                   plan=plan)
    else:
        rg = sg.rank_graph(graph_axis.rank, device)
        plan = rank_plan(rg, graph_axis.group)
        products = sum(getattr(plan, f.name).num_edges > 0
                       for f in dataclasses.fields(plan))
        args = (rg,)
        forward = lambda: apply_fn(rg, plan)  # noqa: E731
    logits0 = forward().cpu().numpy()
    optimizer = torch_adam(model.parameters(), lr, weight_decay)
    step = make_tp_train_step(model, mesh, optimizer, node_axis=node_axis)
    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)
    sync()
    setup_s = time.perf_counter() - start
    reset_launch_counts()
    losses, times, grads = [], [], None
    for _ in range(steps):
        sync()
        t0 = time.perf_counter()
        losses.append(step(*args, generator=generator, plan=plan))
        sync()
        times.append(1e3 * (time.perf_counter() - t0))
        if grads is None:
            grads = {k: p.grad.detach().cpu().numpy().copy()
                     for k, p in model.named_parameters() if p.requires_grad}
    launches = launch_counts()
    losses = torch.stack(losses).cpu().numpy() if losses else np.zeros(0)
    every = [None] * world.size
    dist.all_gather_object(every, losses.tobytes(), group=world.group)
    if len(set(every)) != 1:
        raise AssertionError("the ranks' losses differ")
    sd = model.state_dict()
    return dict(
        losses=losses, logits0=logits0, logits=forward().cpu().numpy(),
        grads=grads, params={k: v.detach().cpu().numpy()
                             for k, v in sd.items()},
        sharded=[k for k in sd if _is_sharded(k)],
        model_rank=model_axis.rank,
        graph_rank=0 if graph_axis is None else graph_axis.rank,
        launches=launches, products=products,
        step_ms=float(np.median(times[1:] or times)) if times else 0.0,
        setup_s=setup_s, total_s=time.perf_counter() - start,
        jax_loaded="jax" in sys.modules)
