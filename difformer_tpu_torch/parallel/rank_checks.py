"""Rank functions that run the sharded ops on numpy inputs and return numpy
outputs, for ``launch.run_ranks`` (the port's tests and ``chip_smoke.py``
call them; a spawned rank imports them from here, never from a test).

:func:`run_checks` runs a list of cases in one spawn of the ranks: each
case is ``{"kind": name, **arguments}``, with ``"world": k`` to run on the
first k ranks only (``mesh.sub_mesh``; the others give None),
``"backend": name`` to run on a group of that backend (gloo cases in a
spawn of NCCL ranks) and ``"grid": (G, T)`` to run on the ranks laid out
as a graph × model grid (``mesh.make_grid``, over every rank; the case
gets the :class:`~difformer_tpu_torch.parallel.mesh.Grid`), ``kind`` one
of ``conv``
(:func:`conv_check`: the graph branch's product and its gradient with
respect to x), ``attention`` (:func:`attention_check`: the sharded linear
attention in one of its three forms and its gradients), ``shift``
(:func:`shift_check`: the ring's exchange), ``ring`` (:func:`ring_check`:
the ring sigmoid attention and its gradients), ``bsr``
(:func:`bsr_check`: the node-sharded block-sparse hybrid and its
gradient), ``train`` (``api.train_sharded``, on the halo exchanges or,
with ``ell``, the hybrid), ``dropout`` (:func:`dropout_check`: sharded
training at dropout > 0 over several seeds, and the ranks' dropout
streams), and the distributed trainer's (``train/distributed.py``):
``fit`` (:func:`fit_check`: fits with their launches, final logits and, on
a card, the steady time of replayed epochs), ``eval`` (:func:`eval_check`),
``resume`` (:func:`resume_check`), ``capture_fault``
(:func:`capture_fault_check`) and ``cli`` (:func:`cli_check`: the
command line's rank function), and the data- and tensor-parallel ones:
``dp`` (``data_parallel.train_dp``), ``dp_dropout``
(:func:`dp_dropout_check`), ``dp_fit`` (:func:`dp_fit_check`) and ``tp``
(``tensor_parallel.train_tp``). Global arrays [S·N_loc, ...] come in the
partition's padded node order; each rank takes its N_loc rows. The groups
every case needs are made before the first case, in the same order on
every rank.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from difformer_tpu_torch.kernels import spmm as K1
from difformer_tpu_torch.ops.linear_attention import (
    simple_attention,
    simple_attention_head_mean_factored,
)
from difformer_tpu_torch.parallel.api import (launch_counts, rank_generator,
                                              rank_plan, reset_launch_counts,
                                              train_sharded)
from difformer_tpu_torch.parallel.data_parallel import (device_batch,
                                                        dp_forward, dp_model,
                                                        make_dp_train_step,
                                                        rank_shard,
                                                        shard_batches,
                                                        train_dp)
from difformer_tpu_torch.parallel.mesh import make_grid, sub_mesh
from difformer_tpu_torch.parallel.sharded_ops import sharded_conv
from difformer_tpu_torch.parallel.tensor_parallel import train_tp


def _rows(mesh, a, n_loc, grad=False):
    t = torch.as_tensor(a[mesh.rank * n_loc:(mesh.rank + 1) * n_loc],
                        device=mesh.device).clone()
    return t.requires_grad_(grad)


def _np(t):
    return None if t is None else t.detach().cpu().numpy()


def conv_check(mesh, sg, x, cot):
    """This rank's rows of the sharded GCN product of x [S·N_loc, ...] over
    the exchange that ``sg``'s arrays pick, on the rank's plan, and of the
    gradient of ``Σ out · cot`` with respect to x; with K1's launches of
    the product and its backward."""
    rg = sg.rank_graph(mesh.rank, mesh.device)
    senders, halo = rg.senders_and_halo()
    plan = rank_plan(rg, mesh.group)
    xl = _rows(mesh, x, rg.nodes_per_shard, grad=True)
    K1.reset_launch_counts()
    out = sharded_conv(xl, senders, rg.receivers, rg.edge_weight,
                       edge_mask=rg.edge_mask, halo=halo,
                       axis_name=mesh.group, plan=plan)
    (out * _rows(mesh, cot, rg.nodes_per_shard)).sum().backward()
    return dict(out=_np(out), grad=_np(xl.grad), launches=dict(K1.LAUNCHES))


def attention_check(mesh, form, q, k, v, key_mask, cot, n_loc, w=None,
                    b=None):
    """This rank's rows of the sharded DIFFormer-s attention and the
    gradients of ``Σ out · cot``: ``form`` "plain" (``simple_attention``,
    [N, H, D]), "head_mean" (its head-mean form, [N, D]) or "factored"
    (``simple_attention_head_mean_factored`` of q, k, x = ``v`` [N, F] and
    the replicated ``w`` [F, H, D], ``b`` [H, D], whose gradients are this
    rank's parts: their sum over the ranks is the whole)."""
    ql, kl, vl = (_rows(mesh, a, n_loc, grad=True) for a in (q, k, v))
    mask = _rows(mesh, key_mask, n_loc)
    group = mesh.group
    wt = bt = None
    if form == "factored":
        wt, bt = (torch.as_tensor(a, device=mesh.device).clone()
                  .requires_grad_() for a in (w, b))
        out = simple_attention_head_mean_factored(
            ql, kl, vl, wt, bt, key_mask=mask, axis_name=group)
    else:
        out = simple_attention(ql, kl, vl, key_mask=mask, axis_name=group,
                               head_mean=form == "head_mean")
    (out * _rows(mesh, cot, n_loc)).sum().backward()
    return dict(out=_np(out), dq=_np(ql.grad), dk=_np(kl.grad),
                dv=_np(vl.grad), dw=_np(None if wt is None else wt.grad),
                db=_np(None if bt is None else bt.grad))


def dropout_check(mesh, sg, params, model_kw, seeds, steps, lr=1e-2,
                  weight_decay=5e-4):
    """``api.train_sharded`` at ``model_kw``'s dropout for each seed of
    ``seeds`` (the rank's generator seeded from (seed, rank)): ``losses``
    [seeds, steps]; ``again``, the first seed's run repeated; and the
    dropout masks that the model's dropout draws first on each rank from
    ``seeds[0]``: ``reproducible`` (two generators of the same (seed,
    rank) draw the same mask) and ``masks_differ`` (no two ranks draw the
    same)."""
    from difformer_tpu_torch.nn.common import dropout

    def run(seed):
        return train_sharded(mesh, sg, params, model_kw, steps=steps, lr=lr,
                             weight_decay=weight_decay, seed=seed)["losses"]

    losses = np.stack([run(seed) for seed in seeds])
    ones = torch.ones(256, device=mesh.device)
    masks = [dropout(ones, model_kw["dropout"], True,
                     rank_generator(seeds[0], mesh.rank, mesh.device))
             .cpu().numpy() for _ in range(2)]
    every = [None] * mesh.size
    dist.all_gather_object(every, masks[0].tobytes(), group=mesh.group)
    return dict(losses=losses, again=run(seeds[0]),
                reproducible=bool(np.array_equal(*masks)),
                masks_differ=len(set(every)) == mesh.size,
                kept=float((masks[0] > 0).mean()))


class _Rows:
    """A ``fit`` logger: every eval's (train, valid, test)."""

    def __init__(self):
        self.rows = []

    def add_result(self, run, result):
        self.rows.append(result)


def _trainer(mesh, x, ei, y, split, model_kw, trainer_kw):
    """This rank's DIFFormer (``model_kw`` with ``in_channels``,
    ``hidden_channels`` and ``out_channels``) and its DistributedTrainer
    on the whole graph (``trainer_kw``, the split's training mask)."""
    from difformer_tpu_torch.nn.difformer import DIFFormer
    from difformer_tpu_torch.train.distributed import DistributedTrainer
    from difformer_tpu_torch.train.trainer import idx_to_mask

    kw = dict(model_kw)
    model = DIFFormer(kw.pop("in_channels"), kw.pop("hidden_channels"),
                      kw.pop("out_channels"), axis_name=mesh.group,
                      device=mesh.device, **kw)
    return DistributedTrainer(model, x, ei, y,
                              train_mask=idx_to_mask(split["train"],
                                                     x.shape[0]),
                              mesh=mesh, **(trainer_kw or {}))


def fit_check(mesh, x, ei, y, split, model_kw, fits, trainer_kw=None,
              init_params=None, timing=False, block=10):
    """One trainer's ``fit(split, **kw)`` for each ``kw`` of ``fits``, from
    ``init_params`` (a JAX params tree) when given. For each fit: the
    ``summaries``, the logger's ``rows``, the final weights' ``logits``
    [N_loc, C]; whether its epoch-block runner ``captured`` (under NCCL;
    False for gloo and for the per-epoch loop), the runner's ``graphs``
    (each graph's kernel launches seen at capture and its replays) and the
    ``launches`` of K1, and of K2–K4 and K7 where they launched (captured
    × replays, else the wrappers' count); ``fit_s``
    (host seconds). Also the rank's plan's ``products`` with entries and
    ``jax_loaded``. With ``timing`` (on a card; the last fit's runner):
    ``ms_per_epoch``, the host clock of ``block`` more epochs (a step and
    an eval each), the median of 3, and one more such block under the
    profiler: ``device_ms`` and ``ops`` a epoch, and ``top``, its longest
    device operations as (name, ms a epoch, calls a epoch)."""
    from difformer_tpu_torch.parallel.api import _profiled

    trainer = _trainer(mesh, x, ei, y, split, model_kw, trainer_kw)
    sync = (torch.cuda.synchronize if mesh.device.type == "cuda"
            else (lambda: None))
    out = []
    for kw in fits:
        log = _Rows()
        reset_launch_counts()
        trainer.epoch_runner = None  # set again by an epoch-block fit
        start = time.perf_counter()
        summaries = trainer.fit(split, logger=log, init_params=init_params,
                                **kw)
        sync()
        fit_s = time.perf_counter() - start
        counted = launch_counts()
        runner = trainer.epoch_runner
        captured = runner is not None and runner.captured
        out.append(dict(
            summaries=summaries, rows=np.asarray(log.rows),
            logits=trainer.forward_eval().cpu().numpy(), captured=captured,
            graphs={} if runner is None else {
                name: dict(captured={k: v for k, v in g["captured"].items()
                                     if v}, replays=g["replays"])
                for name, g in runner.graphs.items()},
            launches=({k: v for k, v in runner.launches().items()
                       if k in counted} if captured else counted),
            fit_s=fit_s))
    result = dict(fits=out, products=0 if trainer.plan is None else sum(
        getattr(trainer.plan, f.name).num_edges > 0
        for f in dataclasses.fields(trainer.plan)),
        jax_loaded="jax" in sys.modules)
    if timing:
        runner = trainer.epoch_runner

        def epochs():
            runner.rewind()
            runner.block(block, 1)

        times = []
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            epochs()
            sync()
            times.append(1e3 * (time.perf_counter() - t0) / block)
        prof, _ = _profiled(epochs, sync, top=8)
        result.update(ms_per_epoch=float(np.median(times)),
                      device_ms=prof["device_ms"] / block,
                      ops=sum(n for _, _, n in prof["device"]) / block,
                      top=[(name, ms / block, n / block)
                           for name, ms, n in prof["device"][:8]])
    return result


def eval_check(mesh, x, ei, y, split, model_kw, trainer_kw=None,
               init_params=None):
    """The trainer's ``evaluate`` of run 0's weights (``device``: the
    device path's metrics), this rank's logits [N_loc, C] and the
    layout's node permutation (None for the contiguous one)."""
    trainer = _trainer(mesh, x, ei, y, split, model_kw, trainer_kw)
    state = trainer.init_state(0, init_params)
    return dict(device=trainer.evaluate(state, split),
                logits=trainer.forward_eval(state).cpu().numpy(),
                perm=trainer._node_perm)


def resume_check(mesh, x, ei, y, split, model_kw, ckpt_dir, trainer_kw=None,
                 stop=6, epochs=10, every=3, eval_step=2):
    """An interrupted run (``stop`` epochs, a checkpoint every ``every``
    into ``ckpt_dir``) resumed by a new trainer to ``epochs``, and an
    uninterrupted run to ``epochs`` into ``ckpt_dir + "_whole"``: their
    summaries (``resumed``, ``whole``); the checkpoint files are read by
    the caller. A checkpoint of another world size that cannot be resumed
    gives ``error`` instead."""
    def fit(directory, n, resume):
        trainer = _trainer(mesh, x, ei, y, split, model_kw, trainer_kw)
        return trainer.fit(split, epochs=n, eval_step=eval_step,
                           ckpt_dir=directory, checkpoint_every=every,
                           resume=resume)

    if stop is None:  # resume a checkpoint written at another world size
        try:
            fit(ckpt_dir, epochs, True)
        except ValueError as e:
            return dict(error=str(e))
        return dict(error=None)
    fit(ckpt_dir, stop, False)
    return dict(resumed=fit(ckpt_dir, epochs, True),
                whole=fit(ckpt_dir + "_whole", epochs, False))


def capture_fault_check(mesh, x, ei, y, split, model_kw, trainer_kw=None):
    """A capture that must fail, and fail loudly: under NCCL the trainer's
    step with a barrier in it (which waits on the host, so no CUDA graph
    can record it), under gloo one all-reduce of a card's tensor (gloo
    cannot be recorded). Returns ``raised``, the error's type and message,
    or None if the capture went through; under NCCL also
    ``eager_after``, whether an eager all-reduce still works after."""
    from difformer_tpu_torch.ops import comm
    from difformer_tpu_torch.train.distributed import ShardedEpochRunner

    raised = None
    if mesh.backend == "nccl":
        trainer = _trainer(mesh, x, ei, y, split, model_kw, trainer_kw)
        state = trainer.init_state(0)
        step = trainer.step_fn

        def step_with_barrier(*args, **kwargs):
            dist.barrier(group=mesh.group)
            return step(*args, **kwargs)

        trainer.step_fn = step_with_barrier
        try:
            ShardedEpochRunner(trainer, state, trainer.generator(0),
                               trainer._eval_tables(split), 4)
        except Exception as e:  # reported to the caller, which checks it
            raised = f"{type(e).__name__}: {str(e)[:300]}"
        ones = torch.ones(4, device=mesh.device)
        comm.all_reduce_(ones, mesh.group)
        return dict(raised=raised,
                    eager_after=bool((ones == mesh.size).all()))
    graph = torch.cuda.CUDAGraph()
    tensor = torch.ones(4, device=mesh.device)
    try:
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            comm.all_reduce_(tensor, mesh.group)
    except RuntimeError as e:
        raised = f"{type(e).__name__}: {str(e)[:300]}"
    return dict(raised=raised)


def shift_check(mesh, x, cot, n_loc, captured=False):
    """``comm.ring_shift`` of this rank's rows of x [S·N_loc, ...] and the
    gradient of ``Σ out · cot`` with respect to them. ``captured`` (NCCL on
    a card): the shift and its backward's shift are recorded in a CUDA
    graph first and replayed on the inputs, ``replayed`` then True."""
    from difformer_tpu_torch.ops import comm

    xl = _rows(mesh, x, n_loc, grad=True)
    gl = _rows(mesh, cot, n_loc)
    if not captured:
        out = comm.ring_shift(xl, mesh.group)
        (out * gl).sum().backward()
        return dict(out=_np(out), grad=_np(xl.grad))
    static_x, static_g = torch.zeros_like(xl), torch.zeros_like(gl)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture
        comm.ring_shift(static_x, mesh.group)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = comm.ring_shift(static_x, mesh.group)
        back = comm._shift(static_g, mesh.group, -1)
    static_x.copy_(xl.detach())
    static_g.copy_(gl)
    graph.replay()
    torch.cuda.synchronize()
    return dict(out=_np(out), grad=_np(back), replayed=True)


def ring_check(mesh, q, k, v, cot, n_loc, key_mask=None):
    """This rank's rows of the ring sigmoid attention
    (``sharded_ops.sigmoid_attention_sharded``) of q, k, v [S·N_loc, H,
    ...] with the binary ``key_mask`` [S·N_loc] or none, and the gradients
    of ``Σ out · cot``; with K2–K4's launches."""
    from difformer_tpu_torch.parallel.sharded_ops import (
        sigmoid_attention_sharded)

    ql, kl, vl = (_rows(mesh, a, n_loc, grad=True) for a in (q, k, v))
    mask = None if key_mask is None else _rows(mesh, key_mask, n_loc)
    reset_launch_counts()
    out = sigmoid_attention_sharded(ql, kl, vl, key_mask=mask,
                                    axis_name=mesh.group)
    (out * _rows(mesh, cot, n_loc)).sum().backward()
    return dict(out=_np(out), dq=_np(ql.grad), dk=_np(kl.grad),
                dv=_np(vl.grad), launches=launch_counts())


def bsr_check(mesh, layout, x, cot):
    """This rank's rows of ``ops.bsr.bsr_spmm_sharded`` over its shards of
    ``layout`` (the pair of every shard of ``build_bsr_gcn_sharded``) for
    x [pad_n, ...], and of the gradient of ``Σ out · cot``; with K1's and
    K7's launches."""
    from difformer_tpu_torch.ops.bsr import bsr_spmm_sharded
    from difformer_tpu_torch.parallel.api import rank_layout

    fwd, rev = rank_layout(layout, mesh)
    xl = _rows(mesh, x, fwd.num_rows, grad=True)
    reset_launch_counts()
    out = bsr_spmm_sharded(fwd, rev, xl)
    (out * _rows(mesh, cot, fwd.num_rows)).sum().backward()
    return dict(out=_np(out), grad=_np(xl.grad), launches=launch_counts())


def cli_check(mesh, args):
    """The command line's rank function (``train/distributed.py:
    cli_rank``) on ``args``, what ``cli.run_sharded`` hands it: the runs'
    summaries, and ``jax_loaded``."""
    from difformer_tpu_torch.train.distributed import cli_rank

    return dict(summaries=cli_rank(mesh, *args),
                jax_loaded="jax" in sys.modules)


def dp_dropout_check(mesh, stacked, params, model_kw, *, seed,
                     steps=2, lr=1e-2):
    """``data_parallel``'s step at ``model_kw``'s dropout (> 0):
    ``reproducible``, two runs of ``steps`` steps from the same (seed,
    rank) give the same losses; ``masks_differ``, the model in train mode
    on shard 0 (the same input on every rank) with each rank's generator
    gives a different output on every rank (its dropout masks differ)."""
    first = train_dp(mesh, stacked, params, model_kw, steps=steps, lr=lr,
                     seed=seed)["losses"]
    again = train_dp(mesh, stacked, params, model_kw, steps=steps, lr=lr,
                     seed=seed)["losses"]
    from difformer_tpu_torch.utils.weights import load_params

    model = dp_model(model_kw, mesh.device)
    load_params(model, params)
    model.train()
    batch = device_batch(rank_shard(stacked, 0), mesh.device)
    with torch.no_grad():
        out = dp_forward(model, batch,
                         rank_generator(seed, mesh.rank, mesh.device))
    every = [None] * mesh.size
    dist.all_gather_object(every, out.cpu().numpy().tobytes(),
                           group=mesh.group)
    return dict(losses=first,
                reproducible=bool(np.array_equal(first, again)),
                masks_differ=len(set(every)) == mesh.size)


def dp_fit_check(mesh, dataset, params, model_kw, *, per_device_batch,
                 epochs, lr=1e-2, max_nodes, max_edges, seed=0):
    """``epochs`` epochs of data-parallel steps over every stacked batch
    of ``dataset`` (``shard_batches`` in order, this rank's shard of
    each): every step's loss, as ``tests/test_data_parallel.py``'s
    ``test_dp_training_learns`` trains the JAX step (``data_parallel``'s
    functions)."""
    from difformer_tpu_torch.train.optim import torch_adam
    from difformer_tpu_torch.utils.weights import load_params

    model = dp_model(model_kw, mesh.device)
    load_params(model, params)
    step = make_dp_train_step(model, mesh, torch_adam(model.parameters(),
                                                      lr, 0.0))
    batches = [device_batch(rank_shard(b, mesh.rank), mesh.device)
               for b in shard_batches(dataset, np.arange(len(dataset)),
                                      per_device_batch, mesh.size,
                                      max_nodes=max_nodes,
                                      max_edges=max_edges)]
    generator = rank_generator(seed, mesh.rank, mesh.device)
    losses = [step(b, generator) for _ in range(epochs) for b in batches]
    return dict(losses=torch.stack(losses).cpu().numpy())


CHECKS = {"conv": conv_check, "attention": attention_check,
          "train": train_sharded, "dropout": dropout_check,
          "fit": fit_check, "eval": eval_check, "resume": resume_check,
          "capture_fault": capture_fault_check, "shift": shift_check,
          "ring": ring_check, "bsr": bsr_check, "cli": cli_check,
          "dp": train_dp, "dp_dropout": dp_dropout_check,
          "dp_fit": dp_fit_check, "tp": train_tp}


def run_checks(mesh, cases):
    """[the result of each case] (the module's docstring)."""
    def key(case):
        return case.get("world", mesh.size), case.get("backend", mesh.backend)

    meshes = {k: mesh if k == (mesh.size, mesh.backend) else sub_mesh(mesh, *k)
              for k in sorted({key(case) for case in cases})}
    grids = {g: make_grid(mesh, *g)
             for g in sorted({tuple(c["grid"]) for c in cases if "grid" in c})}
    out = []
    for case in cases:
        on = (grids[tuple(case["grid"])] if "grid" in case
              else meshes[key(case)])
        args = {k: v for k, v in case.items()
                if k not in ("kind", "world", "backend", "grid")}
        out.append(None if on is None else CHECKS[case["kind"]](on, **args))
    return out

