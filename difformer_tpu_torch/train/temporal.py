"""Temporal-snapshot training (the spatial-temporal track), as
``difformer_tpu/train/temporal.py``.

Reference loop: ``spatial-temporal/main.py:87-145``. Two optimisation
modes, as the JAX trainer:

* **cumulative** (every dataset but wikimath): the gradients of all
  snapshots' MSE are summed, divided by the snapshot count, and one Adam
  step is taken per epoch;
* **incremental** (wikimath): one Adam step per snapshot.

Early stopping on the validation cost, and the best state restored for the
test cost (``main.py:127-143``); the best state holds the parameters and
the buffers (MPNN-LSTM's BatchNorm statistics). ``rebuild='knn'|'dense'``
rebuilds each snapshot's graph (``--special_treat``, ``main.py:96-104``).

Each snapshot keeps its own edges; nothing is padded. ``_prep`` moves the
snapshots' features and targets to the device once, stacked [T, N, F] and
[T, N], and builds one plan (``model.build_plan``: the K1 plans of the
model's graph products) per distinct graph: the static-graph datasets
(chickenpox, wikimath, the synthetic stand-in) share one plan, and a
dynamic one (covid, twitter tennis, a rebuilt graph) gets one per graph.

Two ways to run an epoch, with the same steps and the same numbers
(:class:`SnapshotRunner`): the per-snapshot loop (``use_scan=False``, and
every run on the CPU), and, on CUDA with ``use_scan=True`` (the default,
the counterpart of the JAX trainer's one-program epoch), CUDA graphs: each
run captures one train step per distinct graph (and the epoch's Adam step,
in cumulative mode) and one eval per distinct graph, and replays them.
Both read a snapshot's rows through a device cursor, write its cost into a
device record, and take an epoch's mean on the device; the host reads one
number per epoch and set. A failed capture or replay raises; nothing falls
back to eager execution.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Sequence

import numpy as np
import torch

from difformer_tpu_torch.data.graph import TemporalSnapshot
from difformer_tpu_torch.data.transforms import knn_graph
from difformer_tpu_torch.train.optim import torch_adam
from difformer_tpu_torch.train.trainer import (
    WARMUP_STEPS,
    TrainState,
    _capture_stream,
    captured,
    graph_launches,
)
from difformer_tpu_torch.utils.device import resolve_device
from difformer_tpu_torch.utils.weights import load_params


def temporal_signal_split(snapshots: Sequence, train_ratio: float):
    """torch_geometric_temporal's split: a contiguous prefix and suffix."""
    k = int(train_ratio * len(snapshots))
    return list(snapshots[:k]), list(snapshots[k:])


def rebuild_graph(snap: TemporalSnapshot, mode: str) -> TemporalSnapshot:
    """``--special_treat`` (``main.py:96-104``): a cosine kNN graph of the
    snapshot's features (k = 5, self included) or the dense graph, with
    unit weights; any other mode keeps the snapshot."""
    n = snap.node_feat.shape[0]
    if mode == "knn":
        ei = knn_graph(snap.node_feat, k=5, include_self=True,
                       metric="cosine")
    elif mode == "dense":
        ei = np.stack([np.repeat(np.arange(n), n), np.tile(np.arange(n), n)])
    else:
        return snap
    return TemporalSnapshot(snap.node_feat, ei,
                            np.ones(ei.shape[1], np.float32), snap.target)


@dataclasses.dataclass
class SnapshotData:
    """Snapshots on the device: features [T, N, F] and targets [T, N],
    and each snapshot's plan, ``plans[plan_of[t]]``."""

    x: torch.Tensor
    y: torch.Tensor
    plan_of: List[int]
    plans: list

    def __len__(self):
        return len(self.plan_of)


def mse(out, y):
    return ((out.reshape(y.shape) - y) ** 2).mean()


class TemporalTrainer:
    """Train a node-regression model over snapshot sequences.

    ``model(x, plan=p, generator=g)`` gives the predictions [N, 1] or [N]
    of a snapshot's nodes over the graph of ``p`` (the model's
    ``build_plan`` of the snapshot's edges), with the dropout masks from
    ``g`` in training; they are compared with the targets by MSE. The
    constructor takes the JAX trainer's arguments and ``device`` (the GPU
    unless told otherwise)."""

    def __init__(self, model, *, lr=1e-2, weight_decay=5e-4,
                 mode="cumulative", rebuild="none", seed=123, use_scan=True,
                 device=None):
        if mode not in ("cumulative", "incremental"):
            raise ValueError(f"unknown mode {mode!r}")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.lr = lr
        self.weight_decay = weight_decay
        self.mode = mode
        self.rebuild = rebuild
        self.seed = seed
        self.use_scan = use_scan
        self._graphs = []  # (edge_index, edge_weight, plan) built so far
        #: The :class:`SnapshotRunner` of the last ``fit``.
        self.runner = None

    # -- data ----------------------------------------------------------------
    def _plan_index(self, plans, snap):
        """The index in ``plans`` of ``snap``'s graph, building its plan
        when it is new: a graph is the one before if it is the same array
        or equal to the last one built."""
        ei, w = snap.edge_index, snap.edge_weight
        for i, (e0, w0, _) in enumerate(self._graphs):
            same = e0 is ei and w0 is w
            if not same and i == len(self._graphs) - 1:
                same = (e0.shape == ei.shape and np.array_equal(e0, ei)
                        and (w0 is None) == (w is None)
                        and (w is None or np.array_equal(w0, w)))
            if same:
                break
        else:
            t = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
            plan = self.model.build_plan(
                t(np.asarray(ei, np.int64)[0]), t(np.asarray(ei, np.int64)[1]),
                snap.node_feat.shape[0],
                None if w is None else t(np.asarray(w, np.float32)))
            self._graphs.append((ei, w, plan))
            i = len(self._graphs) - 1
        plan = self._graphs[i][2]
        for j, p in enumerate(plans):
            if p is plan:
                return j
        plans.append(plan)
        return len(plans) - 1

    def _prep(self, snaps) -> SnapshotData:
        """The snapshots (after ``rebuild``) on the device, with one plan
        per distinct graph."""
        snaps = [rebuild_graph(s, self.rebuild) for s in snaps]
        plans = []
        plan_of = [self._plan_index(plans, s) for s in snaps]
        x = torch.as_tensor(np.stack([s.node_feat for s in snaps]),
                            dtype=torch.float32, device=self.device)
        y = torch.as_tensor(np.stack([s.target for s in snaps]),
                            dtype=torch.float32, device=self.device)
        return SnapshotData(x, y, plan_of, plans)

    # -- state ---------------------------------------------------------------
    def init_state(self, run: int = 0, init_params=None,
                   init_batch_stats=None) -> TrainState:
        """Fresh weights drawn from ``seed + run`` (or ``init_params``, a
        flax params tree, with MPNN-LSTM's ``init_batch_stats``) written
        into the model in place, and a fresh Adam."""
        if init_params is None:
            self.model.reset_parameters(
                torch.Generator().manual_seed(self.seed + run))
        else:
            load_params(self.model, init_params, init_batch_stats)
        params = [p for p in self.model.parameters() if p.requires_grad]
        return TrainState(self.model,
                          torch_adam(params, self.lr, self.weight_decay), 0)

    def init_params(self, sample: TemporalSnapshot, run=0):
        """The model's initial state for run ``run`` (a CPU copy of its
        ``state_dict``), as the JAX trainer's ``init_params``; ``sample``
        is not needed to size the port's model."""
        del sample
        self.init_state(run)
        return {k: v.detach().cpu().clone()
                for k, v in self.model.state_dict().items()}

    def _generator(self, run):
        return torch.Generator(self.device).manual_seed(1000 + self.seed + run)

    # -- epochs --------------------------------------------------------------
    def epoch_train(self, state: TrainState, data: SnapshotData, generator):
        """One epoch of the per-snapshot loop over ``data``; the mean cost."""
        runner = SnapshotRunner(self, state, generator, data, capture=False)
        return float(runner.train_epoch(0, len(data)))

    def evaluate(self, state: TrainState, data: SnapshotData):
        """The mean cost over ``data`` in eval mode (the loop)."""
        runner = SnapshotRunner(self, state, None, data, capture=False)
        return float(runner.evaluate(0, len(data)))

    def fit(self, train_snaps, val_snaps, test_snaps, *, epochs=100,
            early_stopping=20, run=0, verbose=False, display_step=20,
            init_params=None, init_batch_stats=None):
        """Train with early stopping on the validation cost; the test cost
        of the best state. Returns ``test``, ``valid`` (the best validation
        cost), ``params`` (a CPU copy of the best ``state_dict``),
        ``losses`` and ``val_costs`` (every epoch's)."""
        data = self._prep(list(train_snaps) + list(val_snaps)
                          + list(test_snaps))
        n_tr, n_va = len(train_snaps), len(val_snaps)
        state = self.init_state(run, init_params, init_batch_stats)
        self.runner = None  # frees the previous run's graphs first
        runner = self.runner = SnapshotRunner(
            self, state, self._generator(run), data,
            capture=self.use_scan and self.device.type == "cuda",
            train_span=(0, n_tr))
        best_val = np.inf
        best = self._snapshot_state()
        no_improve = 0
        losses, val_costs = [], []
        for epoch in range(epochs):
            cost_tr = float(runner.train_epoch(0, n_tr))
            cost_val = float(runner.evaluate(n_tr, n_tr + n_va))
            losses.append(cost_tr)
            val_costs.append(cost_val)
            if cost_val < best_val:
                best_val = cost_val
                best = self._snapshot_state()
                no_improve = 0
            else:
                no_improve += 1
                if no_improve >= early_stopping:
                    break
            if verbose and epoch % display_step == 0:
                print(f"epoch {epoch}: train {cost_tr:.4f} val {cost_val:.4f}")
        state.model.load_state_dict(best)  # in place: the graphs' tensors
        cost_te = float(runner.evaluate(n_tr + n_va, len(data)))
        return {"test": cost_te, "valid": best_val,
                "params": {k: v.cpu() for k, v in best.items()},
                "losses": losses, "val_costs": val_costs}

    def _snapshot_state(self):
        return {k: v.detach().clone()
                for k, v in self.model.state_dict().items()}


class SnapshotRunner:
    """The snapshot steps and evals of one run over ``data``.

    A train step runs the snapshot at the device cursor: forward, MSE and
    backward, its gradients added into the parameters' ``.grad`` (zeros at
    the start), its cost written into a device record [T] at the cursor,
    and the cursor advanced; in incremental mode it also takes the Adam
    step and zeroes the gradients. In cumulative mode, after the epoch's
    steps, the update divides the summed gradients by the snapshot count,
    takes the Adam step and zeroes them. An eval writes the snapshot's cost
    in eval mode (no gradient) the same way.

    With ``capture`` (CUDA) the constructor captures, after
    :data:`WARMUP_STEPS` rounds of every step and eval on the capture stream
    whose effect on the weights, the buffers, Adam and the dropout generator is
    undone, one step graph and one eval graph per distinct graph of ``data``
    (``train_span`` says which snapshots train; the evals run on the others)
    and the cumulative update, all in one memory pool with the generator
    registered; the same calls then replay them. Without it they run eagerly
    (the loop). Under graphs the wrappers' ``LAUNCHES`` count a kernel when
    captured: :attr:`graphs` holds each graph's counts at capture and its
    replays, :meth:`launches` their products."""

    def __init__(self, trainer, state, generator, data, *, capture,
                 train_span=None):
        self.trainer = trainer
        self.state = state
        self.generator = generator
        self.data = data
        dev = data.x.device
        self.record = torch.zeros(len(data), device=dev)
        self.cursor = torch.zeros(1, dtype=torch.long, device=dev)
        self.graphs = {}
        #: The captured graphs by name (``step p``, ``update``, ``eval
        #: p``), and the capture's host seconds (warm-up included).
        self.cuda_graphs = {}
        self.capture_s = 0.0
        self._steps, self._evals, self._update = {}, {}, None
        for p in state.model.parameters():
            if p.requires_grad and p.grad is None:
                p.grad = torch.zeros_like(p)
        if capture:
            t0 = time.perf_counter()
            self._capture(train_span or (0, len(data)))
            torch.cuda.synchronize(dev)
            self.capture_s = time.perf_counter() - t0

    # -- the work of one snapshot -------------------------------------------
    def _rows(self):
        return (self.data.x.index_select(0, self.cursor)[0],
                self.data.y.index_select(0, self.cursor)[0])

    def _run_step(self, plan_id):
        model, opt = self.state.model, self.state.optimizer
        model.train()
        x, y = self._rows()
        loss = mse(model(x, plan=self.data.plans[plan_id],
                         generator=self.generator), y)
        loss.backward()
        if self.trainer.mode == "incremental":
            opt.step()
            opt.zero_grad(set_to_none=False)
        self.record.index_copy_(0, self.cursor, loss.detach().reshape(1))
        self.cursor.add_(1)

    def _run_update(self, count):
        opt = self.state.optimizer
        grads = [p.grad for p in self.state.model.parameters()
                 if p.grad is not None]
        torch._foreach_div_(grads, float(count))
        opt.step()
        opt.zero_grad(set_to_none=False)

    @torch.no_grad()
    def _run_eval(self, plan_id):
        model = self.state.model
        model.eval()
        x, y = self._rows()
        cost = mse(model(x, plan=self.data.plans[plan_id]), y)
        self.record.index_copy_(0, self.cursor, cost.reshape(1))
        self.cursor.add_(1)

    # -- capture -------------------------------------------------------------
    def _capture(self, train_span):
        lo, hi = train_span
        first_train, first_eval = {}, {}
        for t, pid in enumerate(self.data.plan_of):
            (first_train if lo <= t < hi else first_eval).setdefault(pid, t)
        model, opt = self.state.model, self.state.optimizer
        weights = {k: v.detach().clone()
                   for k, v in model.state_dict().items()}
        dropout_state = self.generator.get_state()
        dev = self.record.device
        side = _capture_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        cumulative = self.trainer.mode == "cumulative"
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                for pid, t in first_train.items():
                    self.cursor.fill_(t)
                    self._run_step(pid)
                if cumulative:
                    self._run_update(hi - lo)
                for pid, t in first_eval.items():
                    self.cursor.fill_(t)
                    self._run_eval(pid)
        torch.cuda.current_stream(dev).wait_stream(side)
        model.load_state_dict(weights)
        for moments in opt.state.values():
            for value in moments.values():
                value.zero_()
        opt.zero_grad(set_to_none=False)
        self.generator.set_state(dropout_state)
        self.cursor.zero_()
        self.record.zero_()

        pool = None

        def take(name, fn, register):
            # the graph is kept (keep_graph) so that its nodes can be
            # counted (``raw_cuda_graph``), and instantiated at once
            nonlocal pool
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            if register:
                graph.register_generator_state(self.generator)
            self.graphs[name] = captured(graph, fn, side, pool)
            graph.instantiate()
            self.cuda_graphs[name] = graph
            pool = graph.pool() if pool is None else pool
            return graph

        for pid, t in first_train.items():
            self.cursor.fill_(t)
            self._steps[pid] = take(f"step {pid}",
                                    lambda pid=pid: self._run_step(pid), True)
        if cumulative:
            self._update = take("update",
                                lambda: self._run_update(hi - lo), False)
        for pid, t in first_eval.items():
            self.cursor.fill_(t)
            self._evals[pid] = take(f"eval {pid}",
                                    lambda pid=pid: self._run_eval(pid), False)
        self.cursor.zero_()
        self.state.step = 0

    def _replay(self, graphs, name, pid, eager):
        if not self.graphs:
            eager(pid)
            return
        graph = graphs.get(pid)
        if graph is None:
            raise RuntimeError(f"no {name} graph was captured for plan {pid}")
        graph.replay()
        self.graphs[f"{name} {pid}"]["replays"] += 1

    # -- epochs --------------------------------------------------------------
    def train_epoch(self, lo, hi):
        """The train steps of snapshots ``lo`` to ``hi - 1`` (and the update
        in cumulative mode); their mean cost, a 0-d device tensor."""
        self.cursor.fill_(lo)
        for t in range(lo, hi):
            self._replay(self._steps, "step", self.data.plan_of[t],
                         self._run_step)
            self.state.step += self.trainer.mode == "incremental"
        if self.trainer.mode == "cumulative":
            if self._update is None:
                self._run_update(hi - lo)
            else:
                self._update.replay()
                self.graphs["update"]["replays"] += 1
            self.state.step += 1
        return self.record[lo:hi].mean()

    def evaluate(self, lo, hi):
        """The mean eval cost of snapshots ``lo`` to ``hi - 1``, a 0-d
        device tensor."""
        self.cursor.fill_(lo)
        for t in range(lo, hi):
            self._replay(self._evals, "eval", self.data.plan_of[t],
                         self._run_eval)
        return self.record[lo:hi].mean()

    def launches(self):
        """Each kernel's device launches over the replays so far."""
        return graph_launches(self.graphs)
