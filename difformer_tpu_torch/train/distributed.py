"""Node-sharded full-graph training, as
``difformer_tpu/train/distributed.py:DistributedTrainer``.

The multi-device counterpart of ``FullBatchTrainer``. The JAX trainer runs
every shard of one program under ``shard_map``; here each rank is a process
on ``torch.distributed`` (``parallel/``) and builds its own trainer from the
whole graph: the partition is deterministic host code, so every rank cuts
the same shards and keeps its own (``ShardedGraph.rank_graph``), with the K1
plans of its halo exchange built once, before any step.

- **Layouts** (``:70-136``): ``contiguous`` (equal node blocks),
  ``balanced`` (degree-balanced cuts, ``balance_edges=True``) and
  ``locality`` (label-propagation communities, cuts snapped to their
  boundaries); each runs the overlapped halo exchange. ``spmm="bsr"``
  runs the GCN branch on the node-sharded block-sparse hybrid instead
  (``ops/bsr.py``: K7 on the rank's rectangular shard, K1 for its
  residual): uniform shards aligned to ``bsr_tile`` (a balanced or
  locality layout is ignored with the JAX trainer's warning), the rank's
  ``BsrShard`` pair built once, before any step or capture. The layouts
  are data, not state: checkpoints hold none.
- **Steps**: ``parallel/api.py:make_sharded_train_step`` with the port's
  Adam; dropout draws from the rank's generator, seeded from
  (``seed + run``, rank) (``api.rank_generator``): the JAX step folds the
  shard index into its key, whose bits the port cannot match.
- **Evals** (``:199-309``): accuracy from each rank's masked numerators and
  counts, all-reduced; multilabel ROC-AUC on logits all-gathered first (the
  ranking is global); any other metric on the host, on the all-gathered
  logits put back in node order.
- **The epoch-block fit** (``:321-432``, ``fit(epoch_block=N)``, the
  default as in JAX): :class:`ShardedEpochRunner`, driven by
  ``trainer.py:run_epoch_blocks`` as ``FullBatchTrainer``'s runner is.
  Under NCCL its step and its eval are each captured once per run as a
  CUDA graph, collectives included, and replayed on the JAX schedule; a
  capture that fails raises.
  Under gloo (the CPU, or ranks sharing a card) the same runner runs
  eagerly: gloo collectives cannot be recorded in a CUDA graph, so the
  backend decides, not a fallback.
- **The per-epoch loop** (``:434-535``), which also writes and resumes
  checkpoints: rank 0 writes ``{ckpt_dir}/run{run}/{epoch}.pt`` behind a
  barrier, holding the weights, Adam, the best record and every rank's
  dropout generator state; resuming at another world size raises.

:func:`cli_rank` is the rank function of the command line's ``--n_shards``
route (``cli.py``).
"""

from __future__ import annotations

import hashlib
import warnings
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from difformer_tpu_torch.ops import comm
from difformer_tpu_torch.ops.bsr import build_bsr_gcn_sharded
from difformer_tpu_torch.parallel.api import (check_replicated,
                                              make_sharded_train_step,
                                              nll_sum_count, rank_generator,
                                              rank_layout, rank_plan,
                                              sharded_apply)
from difformer_tpu_torch.parallel.mesh import Mesh
from difformer_tpu_torch.parallel.partition import (edge_balanced_layout,
                                                    locality_layout,
                                                    partition_graph)
from difformer_tpu_torch.train.checkpoint import CheckpointManager
from difformer_tpu_torch.train.optim import torch_adam
from difformer_tpu_torch.train.trainer import (EpochRunner, TrainState,
                                               idx_to_mask, run_epoch_blocks)
from difformer_tpu_torch.utils.metrics import METRICS, device_rocauc_tasks
from difformer_tpu_torch.utils.weights import load_params

LAYOUTS = ("contiguous", "balanced", "locality")
#: The GCN branch's exchanges: the halo (``layout``'s) or the hybrid's.
SPMM = ("halo", "bsr")


def bce_sum_count(logits, labels, mask):
    """(Σ over the masked nodes of the mean over tasks of BCE-with-logits,
    their count), the JAX trainer's ``_bce_sum``."""
    per = F.binary_cross_entropy_with_logits(
        logits, labels.to(logits.dtype), reduction="none").mean(-1)
    m = mask.to(logits.dtype)
    return (per * m).sum(), m.sum()


LOSSES = {"nll": nll_sum_count, "bce": bce_sum_count}


def train_labels(labels, loss):
    """The training targets, laid out as the JAX trainer lays them
    (``:55-68``): for BCE on 1-D or single-column labels a float one-hot
    (a negative label marks class 0), for multilabel BCE float as given,
    for NLL the first column's class ids."""
    labels = np.asarray(labels)
    if loss == "bce" and (labels.ndim == 1 or labels.shape[-1] == 1):
        flat = labels.reshape(-1).astype(np.int64)
        onehot = np.zeros((flat.shape[0], int(flat.max()) + 1), np.float32)
        onehot[np.arange(flat.shape[0]), np.clip(flat, 0, None)] = 1.0
        return onehot
    if loss == "bce":
        return labels.astype(np.float32)
    flat = (labels.reshape(labels.shape[0], -1)[:, 0] if labels.ndim > 1
            else labels)
    return flat.astype(np.int64)


class DistributedTrainer:
    """This rank's part of a node-sharded full-graph run (the module's
    docstring). ``model`` is the rank's DIFFormer, built with
    ``axis_name=mesh.group``; ``node_feat``, ``edge_index``, ``labels`` and
    ``train_mask`` describe the whole graph, the same on every rank.
    ``spmm`` is the GCN branch's exchange: "halo" (the layout's overlapped
    halo) or "bsr" (the block-sparse hybrid at ``bsr_tile``). Every rank
    builds its trainer and calls its methods in the same order, since most
    of them run collectives."""

    def __init__(self, model, node_feat, edge_index, labels, *, train_mask,
                 mesh: Mesh, lr=1e-2, weight_decay=5e-4, loss="nll",
                 metric="acc", seed=123, spmm="halo", bsr_tile=256,
                 balance_edges=False, layout=None):
        if layout is None:
            layout = "balanced" if balance_edges else "contiguous"
        elif layout not in LAYOUTS:
            raise ValueError(f"unknown layout {layout!r}: expected "
                             f"'contiguous', 'balanced', or 'locality'")
        if spmm not in SPMM:
            raise ValueError(f"unknown spmm {spmm!r}: expected 'halo' or "
                             f"'bsr'")
        if spmm == "bsr" and layout != "contiguous":
            warnings.warn(
                "balance_edges=True is ignored with spmm='bsr': BSR shards "
                "must stay tile-aligned (node_align=bsr_tile), which is "
                "incompatible with degree-balanced cut points; using uniform "
                "tile-aligned shards instead", stacklevel=2)
            layout = "contiguous"
        group = getattr(mesh, "group", None)
        if group is None or getattr(model, "axis_name", None) is not group:
            raise ValueError("the model must be a DIFFormer built with "
                             "axis_name=mesh.group")
        self.mesh = mesh
        self.device = mesh.device
        self.layout = layout
        labels_np = np.asarray(labels)
        self.labels_eval = labels_np
        edge_index = np.asarray(edge_index)
        n = int(np.asarray(node_feat).shape[0])
        # the halo exchange's partition (its layout's node order), or the
        # hybrid's uniform tile-aligned shards
        part_kw = (dict(build_halo=False, node_align=bsr_tile)
                   if spmm == "bsr" else dict(build_halo=True))
        self._node_perm = None
        if layout != "contiguous":
            make_layout = (locality_layout if layout == "locality"
                           else edge_balanced_layout)
            perm, n_loc = make_layout(edge_index, n, mesh.size)
            part_kw.update(node_perm=perm, nodes_per_shard=n_loc)
            self._node_perm = perm
        self.sg = partition_graph(
            np.asarray(node_feat, np.float32), edge_index, mesh.size,
            labels=train_labels(labels_np, loss), label_mask=train_mask,
            **part_kw)
        self.rg = self.sg.rank_graph(mesh.rank, self.device)
        #: The rank's ``BsrShard`` pair (``spmm="bsr"``), else None; the
        #: rank's K1 plans (the halo exchange's), else None.
        self.ell = self.plan = None
        if spmm == "bsr":
            fwd, rev, rows_per = build_bsr_gcn_sharded(
                edge_index[0], edge_index[1], n, mesh.size, tile=bsr_tile)
            if rows_per != self.sg.nodes_per_shard:
                raise AssertionError(
                    f"the hybrid's {rows_per} rows a shard against the "
                    f"partition's {self.sg.nodes_per_shard}")
            self.ell = rank_layout((fwd, rev), mesh)
        else:
            self.plan = rank_plan(self.rg, mesh.group)
        self.model = model.to(self.device)
        self._apply = sharded_apply(self.model, mesh, ell=self.ell)
        self.lr, self.weight_decay, self.seed = lr, weight_decay, seed
        self.loss_fn = LOSSES[loss]
        self.metric_name = metric
        self.metric_fn = METRICS[metric]
        self._eval_cache = None
        self.step_fn = None
        #: The :class:`ShardedEpochRunner` of the last epoch-block run.
        self.epoch_runner = None

    # -- state ---------------------------------------------------------------
    def init_state(self, run: int = 0, init_params=None) -> TrainState:
        """Fresh weights drawn from ``seed + run`` (then ``init_params``, a
        JAX params tree, where given), the same on every rank (checked),
        and a fresh Adam; the trainer's ``step_fn`` becomes the sharded
        step of that state."""
        self.model.reset_parameters(
            torch.Generator().manual_seed(self.seed + run))
        if init_params is not None:
            load_params(self.model, init_params)
        check_replicated(self.model, self.mesh.group)
        opt = torch_adam(self.model.parameters(), self.lr, self.weight_decay)
        self.step_fn = make_sharded_train_step(self.model, self.mesh, opt,
                                               self.loss_fn, ell=self.ell)
        return TrainState(self.model, opt, 0)

    def generator(self, run: int = 0):
        """This rank's dropout generator of ``run``."""
        return rank_generator(self.seed + run, self.mesh.rank, self.device)

    def train_step(self, state: TrainState, generator):
        """One sharded step; (state, the global mean loss as a 0-d device
        tensor)."""
        loss = self.step_fn(self.rg, generator, self.plan)
        state.step += 1
        return state, loss

    def forward_eval(self, state: Optional[TrainState] = None):
        """This rank's eval-mode logits [N_loc, C] of the current weights
        (``state`` is the model's, which the trainer holds)."""
        return self._apply(self.rg, self.plan)

    # -- evals ---------------------------------------------------------------
    def _device_metric(self):
        """"acc", "rocauc" or None: the device path of the metric on these
        labels (``:199-226``), None for the host path."""
        le = self.labels_eval
        if self.metric_name == "acc" and (le.ndim == 1 or le.shape[-1] == 1):
            return "acc"
        if self.metric_name == "rocauc" and le.ndim == 2 and le.shape[-1] > 1:
            return "rocauc"
        return None

    def _eval_tables(self, split_idx):
        """(split names, split masks [S, N_pad] and labels [N_pad, ...] in
        the padded shard order (through the layout's node permutation), on
        the device, and this rank's rows of both), cached by the splits'
        content hash (``:228-274``)."""
        names = tuple(split_idx.keys())
        key = (names, tuple(
            hashlib.sha1(np.ascontiguousarray(
                np.asarray(v, np.int64)).tobytes()).hexdigest()
            for v in split_idx.values()))
        if self._eval_cache is None or self._eval_cache[0] != key:
            le = self.labels_eval
            n = le.shape[0]
            n_loc = self.sg.nodes_per_shard
            n_pad = n_loc * self.mesh.size
            pos = (self._node_perm if self._node_perm is not None
                   else np.arange(n))
            masks = np.zeros((len(names), n_pad), bool)
            for i, name in enumerate(names):
                masks[i, pos[np.asarray(split_idx[name])]] = True
            if self.metric_name == "acc":
                lp = np.zeros((n_pad,), np.int64)
                lp[pos] = le.reshape(n, -1)[:, 0].astype(np.int64)
            else:
                lp = np.zeros((n_pad, le.shape[1]), np.float32)
                lp[pos] = le.astype(np.float32)
            rows = slice(self.mesh.rank * n_loc, (self.mesh.rank + 1) * n_loc)
            masks_t = torch.as_tensor(masks, device=self.device)
            lp_t = torch.as_tensor(lp, device=self.device)
            self._eval_cache = (key, names, masks_t, lp_t,
                                masks_t[:, rows].contiguous(),
                                lp_t[rows].contiguous())
        return self._eval_cache[1:]

    def device_metrics(self, out, tables):
        """The split metrics [S] of this rank's logits ``out`` on the
        device, the same on every rank: acc from the all-reduced numerators
        and counts, rocauc on the all-gathered logits. No host read."""
        _, masks, labels, masks_local, labels_local = tables
        if self._device_metric() == "acc":
            val = (out.argmax(-1) == labels_local).float()
            m = masks_local.float()
            sums = comm.all_reduce_(torch.cat([m @ val, m.sum(1)]),
                                    self.mesh.group)
            s = m.shape[0]
            return sums[:s] / torch.clamp(sums[s:], min=1.0)
        full = comm.all_gather(out.float().contiguous(), self.mesh.group)
        return torch.stack([device_rocauc_tasks(full, labels, masks[i])
                            for i in range(masks.shape[0])])

    def evaluate(self, state: Optional[TrainState], split_idx):
        """{split: metric} of the current weights, the same on every rank:
        on the device where the metric has a device path, else on the host
        from the all-gathered logits in node order (``:292-309``)."""
        out = self.forward_eval(state)
        if self._device_metric() is not None:
            tables = self._eval_tables(split_idx)
            vals = self.device_metrics(out, tables).cpu().numpy()
            return dict(zip(tables[0], map(float, vals)))
        full = comm.all_gather(out.float().contiguous(), self.mesh.group)
        full = full.cpu().numpy()
        full = (full[self._node_perm] if self._node_perm is not None
                else full[: self.labels_eval.shape[0]])
        return {name: self.metric_fn(self.labels_eval[np.asarray(idx)],
                                     full[np.asarray(idx)])
                for name, idx in split_idx.items()}

    # -- fit -----------------------------------------------------------------
    def _best_taker(self, run, logger, verbose, display_step):
        best = {"valid": -np.inf, "test": 0.0, "train": 0.0, "epoch": -1}
        primary = self.mesh.rank == 0

        def take(epoch, res, loss):
            if logger is not None:
                logger.add_result(run, (res["train"], res["valid"],
                                        res["test"]))
            if res["valid"] > best["valid"]:
                best.clear()
                best.update({**res, "epoch": epoch})
            if verbose and primary and epoch % display_step == 0:
                print(f"run {run} epoch {epoch}: loss {loss:.4f} {res}")

        return best, take

    def _fit_run_blocks(self, run, split_idx, *, epochs, epoch_block,
                        eval_step, logger, verbose, display_step,
                        init_params):
        """One run on the JAX epoch-block schedule (``:370-432``,
        ``trainer.py:run_epoch_blocks``), its record read once a block."""
        state = self.init_state(run, init_params)
        tables = self._eval_tables(split_idx)
        self.epoch_runner = None  # frees the previous run's graphs first
        runner = self.epoch_runner = ShardedEpochRunner(
            self, state, self.generator(run), tables, epochs)
        best, take_res = self._best_taker(run, logger, verbose, display_step)
        names = tables[0]

        def take(epoch, row):
            take_res(epoch, dict(zip(names, map(float, row[1:]))),
                     float(row[0]))

        run_epoch_blocks(runner, take, epochs=epochs, epoch_block=epoch_block,
                         eval_step=eval_step)
        best["losses"] = runner.fetch(0, epochs)[:, 0].tolist()
        return best

    def _checkpoint(self, mgr, epoch, state, generator, best, losses):
        """Rank 0 writes the checkpoint of ``epoch``, with every rank's
        generator state; the others wait for it at a barrier."""
        states = [None] * self.mesh.size
        dist.all_gather_object(states, generator.get_state(),
                               group=self.mesh.group)
        if self.mesh.rank == 0:
            mgr.save(epoch, {
                "model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "generators": states, "world_size": self.mesh.size,
                "best_valid": float(best["valid"]), "best": dict(best),
                "losses": list(losses), "epoch": epoch})
        dist.barrier(group=self.mesh.group)

    def _resume(self, mgr, state, generator):
        """(start epoch, best record, losses) of the latest checkpoint,
        loaded into ``state`` and ``generator``; None without one."""
        dist.barrier(group=self.mesh.group)  # rank 0's last write is done
        last = mgr.latest_step()
        if last is None:
            return None
        saved = mgr.restore(last, map_location=self.device)
        if saved["world_size"] != self.mesh.size:
            raise ValueError(
                f"the checkpoint {mgr.directory}/{last}.pt was written by "
                f"{saved['world_size']} ranks; resuming it takes as many, "
                f"not {self.mesh.size} (each holds its own dropout stream)")
        state.model.load_state_dict(saved["model"])
        state.optimizer.load_state_dict(saved["optimizer"])
        generator.set_state(saved["generators"][self.mesh.rank].cpu())
        state.step = last + 1
        return last + 1, dict(saved["best"]), list(saved["losses"])

    def _fit_run_loop(self, run, split_idx, *, epochs, eval_step, logger,
                      verbose, display_step, ckpt_dir, checkpoint_every,
                      resume, init_params):
        """One run of the per-epoch loop (``:464-535``), with checkpoints
        every ``checkpoint_every`` epochs and resume."""
        state = self.init_state(run, init_params)
        generator = self.generator(run)
        best, take = self._best_taker(run, logger, verbose, display_step)
        losses, start = [], 0
        mgr = None
        if ckpt_dir and checkpoint_every > 0:
            mgr = CheckpointManager(f"{ckpt_dir}/run{run}")
            restored = self._resume(mgr, state, generator) if resume else None
            if restored is not None:
                start, saved_best, losses = restored
                best.clear()
                best.update(saved_best)
        for epoch in range(start, epochs):
            state, loss = self.train_step(state, generator)
            losses.append(float(loss))
            if epoch % eval_step == 0 or epoch == epochs - 1:
                take(epoch, self.evaluate(state, split_idx), losses[-1])
            if mgr is not None and (epoch + 1) % checkpoint_every == 0:
                self._checkpoint(mgr, epoch, state, generator, best, losses)
        best["losses"] = losses
        return best

    def fit(self, split_idx, *, epochs=100, runs=1, eval_step=1,
            verbose=False, display_step=50, logger=None, ckpt_dir="",
            checkpoint_every=0, resume=False, epoch_block=8,
            init_params=None):
        """Train ``runs`` runs of ``epochs`` epochs with best-validation
        selection; one summary a run (``train``/``valid``/``test`` at the
        best epoch, ``epoch``, and ``losses``, every epoch's loss), the
        same on every rank. ``epoch_block > 1`` takes the epoch-block fit
        when no checkpoint is asked for and the metric has a device path
        (the JAX rule, ``:452-455``), else the per-epoch loop runs.
        ``init_params`` (a JAX params tree) replaces every run's drawn
        weights. Only rank 0 prints; ``logger`` gets every eval's
        (train, valid, test) on the ranks that pass one."""
        blocks = (epoch_block and epoch_block > 1
                  and not (ckpt_dir and checkpoint_every > 0)
                  and not resume and self._device_metric() is not None)
        common = dict(epochs=epochs, eval_step=eval_step, logger=logger,
                      verbose=verbose, display_step=display_step,
                      init_params=init_params)
        if blocks:
            return [self._fit_run_blocks(run, split_idx,
                                         epoch_block=epoch_block, **common)
                    for run in range(runs)]
        return [self._fit_run_loop(run, split_idx, ckpt_dir=ckpt_dir,
                                   checkpoint_every=checkpoint_every,
                                   resume=resume, **common)
                for run in range(runs)]


class ShardedEpochRunner(EpochRunner):
    """The steps and device evals of one epoch-block run of a
    :class:`DistributedTrainer`: ``trainer.py``'s :class:`EpochRunner`
    (its record, cursor, schedule and launch counts) over the sharded step
    and eval, whose collectives each rank runs in the same order. A record
    row holds the loss and the metric of each split.

    Under NCCL the step and the eval are captured as CUDA graphs, the
    collectives with them, after :data:`~trainer.WARMUP_STEPS` warm-up
    steps and evals whose effect is undone (the weights copied back,
    Adam's moments zeroed, the rank's dropout generator restored and
    registered with the step graph); the K1 plans exist before. Under gloo
    it runs eagerly, on the CPU or on a card (``captured`` False)."""

    def __init__(self, trainer, state, generator, tables, epochs):
        self.tables = tables
        super().__init__(trainer, state, generator, None, None, epochs,
                         width=1 + len(tables[0]),
                         capture=trainer.mesh.backend == "nccl")

    def _run_step(self):
        _, loss = self.trainer.train_step(self.state, self.generator)
        self.record[:, 0].index_copy_(0, self.cursor, loss.reshape(1))
        self.cursor.add_(1)

    def _run_eval(self):
        out = self.trainer.forward_eval(self.state)
        metrics = self.trainer.device_metrics(out, self.tables)
        self.record[:, 1:].index_copy_(0, self.cursor - 1,
                                       metrics.reshape(1, -1))


def cli_rank(mesh: Mesh, cfg, x, edge_index, labels, n_classes, splits,
             loss):
    """The rank function of the command line's ``--n_shards`` route
    (``difformer_tpu/cli.py:177-199``): for each run's split, this rank's
    DIFFormer of ``cfg`` (``axis_name=mesh.group``, ``n_classes`` outputs)
    and a :class:`DistributedTrainer` of one run, fitted as the JAX command
    line fits it. Returns the runs' summaries (the same on every rank);
    only rank 0 prints and logs."""
    from difformer_tpu_torch.nn.difformer import DIFFormer
    from difformer_tpu_torch.parallel.launch import is_primary
    from difformer_tpu_torch.utils.logger import RunLogger

    logger = RunLogger(cfg.runs) if is_primary() else None
    n = int(x.shape[0])
    res = []
    for split in splits:
        model = DIFFormer(
            x.shape[1], cfg.hidden_channels, n_classes,
            num_layers=cfg.num_layers, num_heads=cfg.num_heads,
            kernel=cfg.kernel, alpha=cfg.alpha, dropout=cfg.dropout,
            use_bn=cfg.use_bn, use_residual=cfg.use_residual,
            use_weight=cfg.use_weight, use_graph=cfg.use_graph,
            graph_weight=cfg.graph_weight, use_source=cfg.use_source,
            axis_name=mesh.group, spmm_first=cfg.spmm_first,
            fuse_head_mean=cfg.fuse_head_mean, seed=cfg.seed,
            device=mesh.device)
        trainer = DistributedTrainer(
            model, x, edge_index, labels,
            train_mask=idx_to_mask(split["train"], n), mesh=mesh, lr=cfg.lr,
            weight_decay=cfg.weight_decay, loss=loss, metric=cfg.metric,
            seed=cfg.seed, spmm="bsr" if cfg.spmm == "bsr" else "halo",
            bsr_tile=cfg.bsr_tile, layout=cfg.layout or None,
            balance_edges=cfg.balance_edges)
        res.extend(trainer.fit(split, epochs=cfg.epochs, runs=1,
                               eval_step=cfg.eval_step, logger=logger,
                               verbose=True, display_step=cfg.display_step))
    return res
