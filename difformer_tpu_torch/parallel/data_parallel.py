"""Data-parallel training over batches of graphs (the particle track), as
``difformer_tpu/parallel/data_parallel.py``.

The reference trains batches of small graphs on one GPU
(``physical particle/main.py:80-92``). Here the batch is cut across the
ranks of a data axis (a :class:`~difformer_tpu_torch.parallel.mesh.Mesh`,
one process a rank): :func:`shard_batches` stacks S padded batches of b
graphs each, [S, b, ...], as the JAX function does, and rank r takes
shard r onto its device (:func:`rank_shard`, :func:`device_batch`). Each
shard's edges stay within it (every graph is whole on one rank), so the
only collectives are the graph count and the gradients:

- each rank runs ``GraphLevelModel(DIFFormerV2)`` on its b graphs and takes
  the masked BCE sum s over them (``train/graph_level.py:bce_sum_count``,
  its loss before the division);
- the count of real graphs is all-reduced without a gradient, and the
  rank backpropagates s / max(ΣC, 1), its part of the global mean;
- the gradients are summed by one all-reduce of a flat buffer (and the
  loss sum with them, in its last slot), as ``parallel/api.py``'s sharded
  step does, and the optimiser steps on every rank alike;
- the loss returned is Σs / max(ΣC, 1), the JAX step's
  ``psum(s) / max(psum(c), 1)``.

Dropout draws from ``api.rank_generator(seed, rank)``, the counterpart of
the JAX step's ``fold_in(rng, axis_index)`` (whose bits the port cannot
match). Both conv plans of the JAX function run: the edge list, as the
graph-level trainer runs it (the CSR plan of the shard's real edges at the
batch's edge capacity, on K1), and ``dense_plan=True``'s block-dense
adjacency [b, M, M], a batched matmul (the JAX package computes it outside
any Pallas kernel too). The step runs eagerly.

:func:`train_dp` is a rank function for ``launch.run_ranks``: the model
from a JAX params tree, the steps on the rank's shard, and its losses,
first gradients and parameters as numpy arrays.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from difformer_tpu_torch.data.batching import (PaddedGraphBatch, dense_adj,
                                               pad_graph_batch)
from difformer_tpu_torch.ops import comm
from difformer_tpu_torch.parallel.api import (attach_gradients,
                                              check_replicated,
                                              flat_gradients, launch_counts,
                                              rank_generator,
                                              reset_launch_counts)
from difformer_tpu_torch.parallel.mesh import Mesh
from difformer_tpu_torch.train.graph_level import (BatchLayout,
                                                   batch_layout,
                                                   bce_sum_count,
                                                   model_inputs, pack_batch)


def _stack(shards):
    """One :class:`PaddedGraphBatch` whose array fields are the shards'
    stacked [S, ...] (None stays None); ``edges_sorted`` holds where it
    holds for every shard."""
    fields = {}
    for f in dataclasses.fields(PaddedGraphBatch):
        values = [getattr(b, f.name) for b in shards]
        if f.name == "edges_sorted":
            fields[f.name] = all(values)
        elif values[0] is None:
            fields[f.name] = None
        else:
            fields[f.name] = np.stack(values)
    return PaddedGraphBatch(**fields)


def shard_batches(dataset: Sequence, indices, per_device_batch, n_devices, *,
                  max_nodes, max_edges, shuffle=False, rng=None,
                  dense_plan=False):
    """Yield the stacked batches [S, b, ...] (S = ``n_devices``, b =
    ``per_device_batch``) of ``dataset[i] = (x, edge_index, label)`` over
    ``indices`` in order (permuted by the numpy ``rng`` when ``shuffle``),
    shard d of each step the graphs ``d·b:(d+1)·b`` of its S·b, each padded
    by ``data/batching.py:pad_graph_batch`` to ``max_nodes`` and
    ``max_edges``; a last step short of S·b graphs is dropped. With
    ``dense_plan`` each shard carries its block-dense adjacency
    (``dense_adj``, [S, b, M, M] stacked), the JAX function's arrays."""
    idx = np.asarray(indices)
    if shuffle:
        rng = rng or np.random.default_rng()
        idx = idx[rng.permutation(idx.shape[0])]
    step = per_device_batch * n_devices
    for start in range(0, idx.shape[0] - step + 1, step):
        sel = idx[start:start + step]
        shards = []
        for d in range(n_devices):
            ids = sel[d * per_device_batch:(d + 1) * per_device_batch]
            graphs = [dataset[i] for i in ids]
            pb = pad_graph_batch(
                [g[0] for g in graphs], [g[1] for g in graphs],
                [g[2] for g in graphs], max_nodes=max_nodes,
                max_edges=max_edges, batch_size=per_device_batch)
            if dense_plan:
                pb = dataclasses.replace(pb, dense_adj=dense_adj(pb))
            shards.append(pb)
        yield _stack(shards)


def rank_shard(stacked: PaddedGraphBatch, rank) -> PaddedGraphBatch:
    """Shard ``rank`` of a stacked batch of :func:`shard_batches`."""
    return PaddedGraphBatch(**{
        f.name: (getattr(stacked, f.name) if f.name == "edges_sorted"
                 or getattr(stacked, f.name) is None
                 else getattr(stacked, f.name)[rank])
        for f in dataclasses.fields(PaddedGraphBatch)})


@dataclasses.dataclass(frozen=True)
class DeviceBatch:
    """One shard on the device: its layout and the views of its packed
    buffer (``train/graph_level.py:BatchLayout``)."""

    layout: BatchLayout
    views: dict


def device_batch(batch: PaddedGraphBatch, device) -> DeviceBatch:
    """``batch`` packed into one int32 buffer as the graph-level trainer
    packs it (``graph_level.batch_layout``: the dense adjacency where the
    batch carries it, else the edge list at its capacity) and copied to
    ``device`` in one copy."""
    layout = batch_layout(batch, "edges" if batch.dense_adj is None
                          else "dense")
    buf = pack_batch(batch, layout).to(device)
    return DeviceBatch(layout, layout.views(buf))


def dp_forward(model, batch: DeviceBatch, generator=None):
    """The model's logits [b] on a shard (``GraphLevelModel``'s first
    output)."""
    v = batch.views
    kw = model_inputs(batch.layout, v)
    return model(v["node_feat"], kw.pop("node_mask"), kw.pop("n_nodes"),
                 generator=generator, **kw)[:, 0]


def make_dp_train_step(model, mesh: Mesh, optimizer):
    """``step(batch, generator=None) -> loss``, one data-parallel train
    step of this rank on its :class:`DeviceBatch` (the module's
    docstring); the loss returned, a 0-d tensor, is the global mean, the
    same on every rank. After it every parameter's ``.grad`` holds the
    summed gradient."""
    group = mesh.group
    params = [p for p in model.parameters() if p.requires_grad]
    flat, views = flat_gradients(params, mesh.device, extra=1)

    def step(batch: DeviceBatch, generator=None):
        model.train()
        attach_gradients(params, views)
        flat.zero_()
        v = batch.views
        s, c = bce_sum_count(dp_forward(model, batch, generator),
                             v["labels"], v["graph_mask"] != 0)
        count = comm.all_reduce_(c.detach().float().reshape(1).clone(),
                                 group).clamp(min=1.0)
        (s / count[0]).backward()
        flat[-1:].copy_(s.detach().reshape(1))
        comm.all_reduce_(flat, group)
        optimizer.step()
        return flat[-1] / count[0]

    return step


def dp_model(model_kw, device):
    """``GraphLevelModel(DIFFormerV2(...))`` from ``model_kw``: the
    encoder's arguments (``in_channels``, ``hidden_channels``,
    ``out_channels`` and the rest), with ``graph_pooling`` and the head's
    ``head_channels`` (default 1)."""
    from difformer_tpu_torch.nn.difformer_v2 import (DIFFormerV2,
                                                     GraphLevelModel)

    kw = dict(model_kw)
    pooling = kw.pop("graph_pooling", "mean")
    head = kw.pop("head_channels", 1)
    enc = DIFFormerV2(kw.pop("in_channels"), kw.pop("hidden_channels"),
                      kw.pop("out_channels"), device=device, **kw)
    return GraphLevelModel(enc, head, pooling, device=device)


def train_dp(mesh: Mesh, stacked, params, model_kw, *, steps, lr=1e-2,
             weight_decay=0.0, seed=0):
    """A rank function for ``launch.run_ranks``: this rank's
    ``GraphLevelModel`` (:func:`dp_model`, on ``mesh.device``) loaded with
    the JAX params tree ``params``, then ``steps`` data-parallel train
    steps with the port's Adam on shard ``mesh.rank`` of ``stacked`` (a
    batch of :func:`shard_batches`), the same batch every step. Returns a
    dict: ``losses``; ``grads``, the summed gradient of the first step by
    ``state_dict`` key; ``params`` after the steps; ``logits`` [b] of the
    shard after them (eval mode); ``launches`` over the steps (K1's, and
    any other kernel's that launched); ``plan`` ("dense" or "edges");
    ``step_ms`` (host clock, synchronised, the median of the steps after
    the first); ``setup_s``, ``total_s``; ``jax_loaded``. Every rank must
    hold the same parameters before and after, and the same losses."""
    from difformer_tpu_torch.train.optim import torch_adam
    from difformer_tpu_torch.utils.weights import load_params

    start = time.perf_counter()
    device = mesh.device
    model = dp_model(model_kw, device)
    load_params(model, params)
    check_replicated(model, mesh.group)
    batch = device_batch(rank_shard(stacked, mesh.rank), device)
    optimizer = torch_adam(model.parameters(), lr, weight_decay)
    step = make_dp_train_step(model, mesh, optimizer)
    generator = rank_generator(seed, mesh.rank, device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)
    sync()
    setup_s = time.perf_counter() - start
    reset_launch_counts()
    losses, times, grads = [], [], None
    for i in range(steps):
        sync()
        t0 = time.perf_counter()
        losses.append(step(batch, generator))
        sync()
        times.append(1e3 * (time.perf_counter() - t0))
        if grads is None:
            grads = {k: p.grad.detach().cpu().numpy().copy()
                     for k, p in model.named_parameters() if p.requires_grad}
    launches = launch_counts()
    losses = torch.stack(losses).cpu().numpy() if losses else np.zeros(0)
    every = [None] * mesh.size
    dist.all_gather_object(every, losses.tobytes(), group=mesh.group)
    if len(set(every)) != 1:
        raise AssertionError("the ranks' losses differ")
    check_replicated(model, mesh.group)
    model.eval()
    with torch.no_grad():
        logits = dp_forward(model, batch).cpu().numpy()
    return dict(
        losses=losses, grads=grads, logits=logits,
        params={k: v.detach().cpu().numpy()
                for k, v in model.state_dict().items()},
        launches=launches, plan=batch.layout.plan,
        step_ms=float(np.median(times[1:] or times)) if times else 0.0,
        setup_s=setup_s, total_s=time.perf_counter() - start,
        jax_loaded="jax" in sys.modules)
