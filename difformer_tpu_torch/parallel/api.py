"""The node-sharded forward and train step, as
``difformer_tpu/parallel/api.py:82-249``, one rank a process.

The JAX package wraps the model in ``shard_map``: each device gets its
shard, the parameters are replicated, and JAX transposes the collectives,
so the gradients of the replicated parameters come out summed. Here every
rank runs the model (built with ``axis_name=mesh.group``) on its
:class:`~difformer_tpu_torch.parallel.partition.RankGraph`, and the step
says the summing out loud:

- each rank backpropagates ``s_local / C``, its own part of the global
  mean loss, where ``C`` is the global count, all-reduced without a
  gradient (backpropagating the global loss on every rank through a
  differentiable all-reduce would multiply the gradient by the world
  size);
- the replicated parameters' gradients are then summed by one all-reduce
  (not averaged), the optimiser (the port's Adam, ``train/optim.py``)
  steps on every rank alike, and the loss returned is ``Σ s / max(C, 1)``,
  the JAX step's ``psum(s) / max(psum(c), 1)``.

Dropout draws from a generator per rank seeded from (seed, rank)
(:func:`rank_generator`): the JAX step folds the axis index into its key,
whose bits the port cannot match. The K1 plans of the rank's exchange
are built once (:func:`rank_plan`) and passed to every call; with the
block-sparse hybrid the rank's ``BsrShard`` pair (``ops/bsr.py``, its own
shard of ``build_bsr_gcn_sharded``'s, built once) goes to the model as
``ell``, as the JAX functions' ``ell=`` does, and no plan is built. The
step runs eagerly, or, under NCCL, captured as a CUDA graph by the
distributed trainer (``train/distributed.py``), which it allows: its
gradients live in one buffer allocated when the step is made.

:func:`train_sharded` is a rank function for ``launch.run_ranks``: it
builds the model from a JAX params tree (``utils/weights.py``), checks
that every rank holds the same parameters, runs the steps and returns the
losses, the logits and the parameters as numpy arrays.
"""

from __future__ import annotations

import dataclasses
import hashlib
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from difformer_tpu_torch.kernels import bsr as K7
from difformer_tpu_torch.kernels import sigmoid_attention as K2
from difformer_tpu_torch.kernels import spmm as K1
from difformer_tpu_torch.ops import comm
from difformer_tpu_torch.parallel.mesh import Mesh
from difformer_tpu_torch.parallel.partition import RankGraph, ShardedGraph
from difformer_tpu_torch.parallel.sharded_ops import sharded_plan


def nll_sum_count(logits, labels, mask):
    """(Σ −log p(label) over the masked nodes, their count): the JAX tests'
    and ``dryrun_multichip``'s ``loss_fn``, whose global mean is
    Σ sums / Σ counts."""
    ll = F.log_softmax(logits, dim=-1).gather(
        -1, labels.reshape(-1, 1).long())[:, 0]
    m = mask.to(logits.dtype)
    return -(ll * m).sum(), m.sum()


def rank_generator(seed, rank, device):
    """The dropout generator of ``rank``, seeded from (seed, rank)."""
    return torch.Generator(device).manual_seed(int(seed) * 1_000_003
                                               + int(rank))


def rank_plan(rg: RankGraph, group):
    """The K1 plans of the exchange that ``rg``'s arrays pick (the overlap
    split, the halo plan, or neither: the all-gather), built once."""
    senders, halo = rg.senders_and_halo()
    return sharded_plan(senders, rg.receivers, rg.nodes_per_shard,
                        rg.edge_weight, edge_mask=rg.edge_mask, halo=halo,
                        axis_name=group)


def _forward(model, rg, plan, generator, ell):
    senders, halo = rg.senders_and_halo()
    return model(rg.node_feat, senders, rg.receivers, rg.edge_weight,
                 node_mask=rg.node_mask, edge_mask=rg.edge_mask,
                 generator=generator, halo=halo, plan=plan, ell=ell)


def rank_layout(layout, mesh: Mesh):
    """This rank's pair of the node-sharded hybrid, on its device, from the
    pair of every shard that ``ops/bsr.py:build_bsr_gcn_sharded`` returns
    (None stays None)."""
    if layout is None:
        return None
    return tuple(d.rank_shard(mesh.rank, mesh.group, mesh.device)
                 for d in layout)


def sharded_apply(model, mesh: Mesh, ell=None):
    """``fn(rank_graph, plan=None, generator=None, train=False) ->`` this
    rank's logits [N_loc, C]; ``model`` must be built with
    ``axis_name=mesh.group`` and ``plan`` is :func:`rank_plan`'s (the
    model builds it per call without it). ``ell``, the rank's
    ``BsrShard`` pair (:func:`rank_layout`), runs the graph branch on the
    block-sparse hybrid, as the JAX function's ``ell=``. Every rank calls
    it on its own shard."""

    def apply_fn(rg: RankGraph, plan=None, generator=None, train=False):
        model.train(train)
        with torch.set_grad_enabled(train):
            return _forward(model, rg, plan, generator, ell)

    return apply_fn


def flat_gradients(params, device, extra=0):
    """(buffer, views): one zeroed float32 buffer with a slot for every
    entry of ``params`` and ``extra`` more at its end, and each parameter's
    view of its slots (shaped as the parameter). :func:`attach_gradients`
    makes the views the parameters' ``.grad``, so that the backward
    accumulates into the buffer in place and one collective reduces every
    gradient at once."""
    flat = torch.zeros(sum(p.numel() for p in params) + extra,
                       device=device)
    views, offset = [], 0
    for p in params:
        views.append(flat[offset:offset + p.numel()].view_as(p))
        offset += p.numel()
    return flat, views


def attach_gradients(params, views):
    """Set each parameter's ``.grad`` to its view of the flat buffer where
    it is not (set to None or replaced elsewhere)."""
    for p, view in zip(params, views):
        if p.grad is not view:
            p.grad = view


def make_sharded_train_step(model, mesh: Mesh, optimizer,
                            loss_fn=nll_sum_count, ell=None):
    """``step(rank_graph, generator=None, plan=None) -> loss``, one train
    step of this rank (the module's docstring): ``loss_fn(logits, labels,
    mask) -> (sum, count)`` over the rank's nodes; the loss returned, a
    0-d tensor, is the global mean, the same on every rank. ``plan`` is
    :func:`rank_plan`'s (the model builds it per call without it);
    ``ell``, the rank's ``BsrShard`` pair, as :func:`sharded_apply` takes
    it.

    The step can be captured in a CUDA graph under NCCL: one flat buffer,
    allocated here, holds every parameter's gradient (each ``p.grad`` a
    view into it, which the backward accumulates into in place) and, in
    its last slot, the loss sum, so that one all-reduce sums both in place;
    the step allocates nothing that outlives it and reads nothing on the
    host."""
    group = mesh.group
    params = [p for p in model.parameters() if p.requires_grad]
    device = params[0].device if params else mesh.device
    flat, views = flat_gradients(params, device, extra=1)

    def step(rg: RankGraph, generator=None, plan=None):
        model.train()
        attach_gradients(params, views)
        flat.zero_()
        s, c = loss_fn(_forward(model, rg, plan, generator, ell),
                       rg.labels, rg.label_mask)
        count = comm.all_reduce_(c.detach().float().reshape(1).clone(),
                                 group).clamp(min=1.0)
        (s / count[0]).backward()
        # the parameters' gradients and the loss sum, in one all-reduce
        flat[-1:].copy_(s.detach().reshape(1))
        comm.all_reduce_(flat, group)
        optimizer.step()
        return flat[-1] / count[0]

    return step


def reset_launch_counts():
    """Zero the launch counts of K1, K2–K4 and K7."""
    for counters in (K1, K2, K7):
        counters.reset_launch_counts()


def launch_counts():
    """K1's launches since :func:`reset_launch_counts`, and those of K2–K4
    and K7 that launched."""
    others = {**K2.LAUNCHES, **K7.LAUNCHES}
    return {**K1.LAUNCHES, **{k: v for k, v in others.items() if v}}


def _profiled(fn, sync, top=12):
    """(a dict of ``fn()``'s profile, its result): ``device``, its device
    operations as (name, device ms, calls), longest first; ``device_ms``
    their sum; ``host_ms``, the host clock around the call; ``host``, the
    ``top`` host operations by self host time as (name, ms, calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync()
        host_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    device = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                     for e in events if e.device_type == DeviceType.CUDA),
                    key=lambda row: -row[1])
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                   for e in events if e.device_type == DeviceType.CPU),
                  key=lambda row: -row[1])[:top]
    return dict(device=device, device_ms=sum(r[1] for r in device),
                host_ms=host_ms, host=host), out


def parameter_digest(model) -> str:
    """SHA-256 of the model's parameters' bytes, in state_dict order."""
    digest = hashlib.sha256()
    for value in model.state_dict().values():
        digest.update(value.detach().cpu().contiguous().numpy().tobytes())
    return digest.hexdigest()


def check_replicated(model, group):
    """Raise unless every rank's parameters are rank 0's, byte for byte."""
    digests = [None] * dist.get_world_size(group)
    dist.all_gather_object(digests, parameter_digest(model), group=group)
    if len(set(digests)) != 1:
        raise AssertionError(f"the ranks' parameters differ: {digests}")


def train_sharded(mesh: Mesh, sg: ShardedGraph, params, model_kw, *,
                  steps, lr=1e-2, weight_decay=5e-4, seed=0,
                  profile=False, ell=None):
    """A rank function for ``launch.run_ranks``: this rank's DIFFormer
    (``model_kw`` with the graph's feature and class counts as
    ``in_channels`` and ``out_channels``, ``axis_name=mesh.group``, on
    ``mesh.device``) loaded with the JAX params tree ``params``, then
    ``steps`` sharded train steps with the port's Adam on ``sg``'s shard
    ``mesh.rank`` (the exchange its arrays pick, or, with ``ell``, the
    pair of every shard of ``build_bsr_gcn_sharded``, the rank's shard of
    the block-sparse hybrid). Returns a dict of numpy
    arrays and numbers: ``losses``; ``logits`` [N_loc, C] after the steps
    (eval mode) and ``logits0`` before them; ``params`` (the state_dict
    after the steps); ``launches`` (K1's, and K2–K4's and K7's where they
    launched, counted over the steps alone) and ``products`` (the rank's K1 plans with at least
    one entry: K1 launches nothing for an empty one, so a step launches
    ``products`` × layers K1 forward and as many transposed; 0 with
    ``ell``);
    ``step_ms`` (host clock a step, synchronised, the median of the steps
    after the first); ``setup_s`` and ``total_s``, the host seconds of the
    set-up (model, weights, plan, first forward) and of the whole call;
    ``jax_loaded``; with ``profile`` (on a card),
    ``profile``, the last step under torch.profiler: its device
    operations as (name, device ms, calls), its device ms and its host
    ms, and the host's busiest operations as (name, self host ms,
    calls). Every rank must hold the same parameters before and after the
    steps, and the same losses."""
    from difformer_tpu_torch.nn.difformer import DIFFormer
    from difformer_tpu_torch.train.optim import torch_adam
    from difformer_tpu_torch.utils.weights import load_params

    start = time.perf_counter()
    device = mesh.device
    kw = dict(model_kw)
    model = DIFFormer(kw.pop("in_channels"), kw.pop("hidden_channels"),
                      kw.pop("out_channels"), axis_name=mesh.group,
                      device=device, **kw)
    load_params(model, params)
    check_replicated(model, mesh.group)
    rg = sg.rank_graph(mesh.rank, device)
    layout = rank_layout(ell, mesh)
    plan = None if layout is not None else rank_plan(rg, mesh.group)
    apply_fn = sharded_apply(model, mesh, ell=layout)
    logits0 = apply_fn(rg, plan).cpu().numpy()
    optimizer = torch_adam(model.parameters(), lr, weight_decay)
    step = make_sharded_train_step(model, mesh, optimizer, ell=layout)
    generator = rank_generator(seed, mesh.rank, device)

    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)
    setup_s = time.perf_counter() - start
    reset_launch_counts()
    losses, times, profiled = [], [], None
    for i in range(steps):
        sync()
        t0 = time.perf_counter()
        if i == steps - 1 and profile:
            profiled, loss = _profiled(lambda: step(rg, generator, plan),
                                       sync)
        else:
            loss = step(rg, generator, plan)
        sync()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(loss)
    # the first step builds the lazy state (cuBLAS, NCCL), the profiled
    # one pays the profiler
    kept = times[1:len(times) - (1 if profile else 0)] or times
    step_ms = float(np.median(kept)) if kept else 0.0
    launches = launch_counts()
    products = 0 if plan is None else sum(
        getattr(plan, f.name).num_edges > 0
        for f in dataclasses.fields(plan))
    losses = torch.stack(losses).cpu().numpy() if losses else np.zeros(0)
    every = [None] * mesh.size
    dist.all_gather_object(every, losses.tobytes(), group=mesh.group)
    if len(set(every)) != 1:
        raise AssertionError("the ranks' losses differ")
    check_replicated(model, mesh.group)
    return dict(
        losses=losses, logits=apply_fn(rg, plan).cpu().numpy(),
        logits0=logits0,
        params={k: v.detach().cpu().numpy()
                for k, v in model.state_dict().items()},
        launches=launches, products=products, step_ms=step_ms,
        profile=profiled, setup_s=setup_s,
        total_s=time.perf_counter() - start,
        jax_loaded="jax" in sys.modules)
