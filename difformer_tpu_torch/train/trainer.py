"""Full-batch training engine (node classification), as
``difformer_tpu/train/trainer.py:FullBatchTrainer``.

Replaces the reference's script loop (``node classification/main.py:104-158``):
seeded runs, a full-graph forward and backward per epoch, an eval every
``eval_step`` epochs with best-validation tracking. The graph stays on the
device for the whole run, and so does its CSR plan, built once for the
GCN branch's kernel: a step does no sort and no degree pass.

Loss selection as the reference (``main.py:119-129``): BCE-with-logits for
the multilabel datasets, else NLL on log-softmax; MSE for regression.

Two ways to fit, with one schedule of evals and one best-epoch rule:

- the per-epoch loop (``fit`` by default): a train step, then on eval
  epochs the logits go to the host for the numpy metric; it also serves
  ``save_best``, ``print_prop`` and checkpointing, which need the host
  every epoch;
- the epoch-block fit (``fit(epoch_block=N)``), the counterpart of the JAX
  package's epoch-scanned fit (``:223-446``): split metrics on the device,
  every step's loss and every eval's metrics written into a device record,
  and the host reading a block's scalars once per block. On the CPU the
  steps and evals run eagerly. On CUDA the train step and the eval (forward
  and metrics) are each captured once per run as a CUDA graph
  (:class:`EpochRunner`) and replayed on the schedule; a failed capture or
  replay raises, and nothing falls back to eager execution.

The JAX trainer's ``extra``, the non-param collections (the baseline zoo's
BatchNorm statistics, ``batch_stats``), are the model's buffers here: they
live in the model, move in its training forwards, are part of its
``state_dict`` (the best state, the checkpoints, the weights an epoch-block
run restores after its warm-up), and ``init_state`` and
``evaluate_params`` take them as the JAX ones do.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from difformer_tpu_torch.data.graph import GraphData
from difformer_tpu_torch.kernels import bsr as _bsr_kernels
from difformer_tpu_torch.kernels import ell as _ell_kernels
from difformer_tpu_torch.kernels import sigmoid_attention as _attention_kernels
from difformer_tpu_torch.kernels import spmm as _spmm_kernels
from difformer_tpu_torch.train.checkpoint import CheckpointManager
from difformer_tpu_torch.train.optim import torch_adam
from difformer_tpu_torch.utils.device import resolve_device
from difformer_tpu_torch.utils.metrics import METRICS, device_rocauc_tasks
from difformer_tpu_torch.utils.weights import load_params

#: Train steps and evals run on a side stream before a run's graphs are
#: captured (PyTorch's recipe: autograd's and Adam's state exist only
#: after a step); their effect on the weights, Adam and the dropout stream
#: is undone before the capture.
WARMUP_STEPS = 2

_SPLITS = ("train", "valid", "test")


@dataclasses.dataclass
class TrainState:
    """The model being trained, its optimiser and the step count."""

    model: torch.nn.Module
    optimizer: Optional[torch.optim.Optimizer]
    step: int = 0


def nll_loss(logits, labels, mask):
    """NLLLoss(log_softmax(out)) over the masked nodes (``main.py:126-129``)."""
    logp = F.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, labels.reshape(-1, 1))[:, 0]
    m = mask.to(logits.dtype)
    return -(ll * m).sum() / torch.clamp(m.sum(), min=1.0)


def bce_with_logits_loss(logits, labels, mask):
    """BCEWithLogitsLoss, the masked mean over nodes of the mean over tasks
    (``main.py:119-125``)."""
    per = F.binary_cross_entropy_with_logits(
        logits, labels.to(logits.dtype), reduction="none").mean(-1)
    m = mask.to(logits.dtype)
    return (per * m).sum() / torch.clamp(m.sum(), min=1.0)


def mse_loss(preds, targets, mask):
    """Masked mean over nodes of the squared error (per node, the mean over
    its target columns)."""
    per = (preds.reshape(targets.shape) - targets) ** 2
    if per.dim() > 1:
        per = per.mean(dim=tuple(range(1, per.dim())))
    m = mask.to(per.dtype)
    return (per * m).sum() / torch.clamp(m.sum(), min=1.0)


LOSSES = {"nll": nll_loss, "bce": bce_with_logits_loss, "mse": mse_loss}


def idx_to_mask(idx, n):
    mask = np.zeros(n, dtype=bool)
    mask[np.asarray(idx)] = True
    return mask


def train_labels(labels, loss, onehot_bce_labels=False):
    """The training targets of ``labels`` (numpy) for ``loss``, as the JAX
    trainer lays them out: float one-hot for BCE on 1-D or single-column
    labels (or when asked; negative labels give a zero row), float as given
    for multilabel BCE and for MSE, int64 class ids (the first column) for
    NLL."""
    labels = np.asarray(labels)
    if loss == "bce":
        if labels.ndim == 1 or labels.shape[-1] == 1 or onehot_bce_labels:
            # the reference's one-hot path (eval.py:20-22)
            flat = labels.reshape(-1).astype(np.int64)
            onehot = np.zeros((flat.shape[0], int(flat.max()) + 1),
                              np.float32)
            onehot[np.arange(flat.shape[0]), np.clip(flat, 0, None)] = 1.0
            onehot[flat < 0] = 0.0
            return onehot
        return labels.astype(np.float32)
    if loss == "mse":
        return labels.astype(np.float32)
    flat = labels.reshape(labels.shape[0], -1)[:, 0] if labels.ndim > 1 \
        else labels
    return flat.astype(np.int64)


def _launch_counts():
    return {**_attention_kernels.LAUNCHES, **_spmm_kernels.LAUNCHES,
            **_ell_kernels.LAUNCHES, **_bsr_kernels.LAUNCHES}


def _dval_count():
    return _spmm_kernels.DVAL_LAUNCHES["csr_spmm_dval"]


def captured(graph, fn, stream, pool=None):
    """Capture ``fn`` into ``graph`` on ``stream`` (in ``pool``, another
    graph's memory pool, when given); returns the graph's record: the
    kernel launches the wrappers counted during the capture
    (``captured``; K1-dval's apart, ``captured_dval``) and its ``replays``
    (0 so far).

    A call that a capture cannot record invalidates it
    (``cudaErrorStreamCaptureInvalidated``), and two such calls came from
    outside ``fn``. The graph-level trainer's packing threads allocate
    pinned host buffers (``cudaHostAlloc``) while its steps are captured
    (``train/graph_level.py``): the capture runs in thread-local mode, where
    only this thread's calls count (PyTorch's default global mode counts
    every thread's). And the garbage collector, which this PyTorch no longer
    runs at the start of a capture, could free an earlier run's graphs
    inside it (a trainer and its runner refer to each other): it runs just
    before the capture and is held off during it."""
    before, dval = _launch_counts(), _dval_count()
    gc.collect()
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            fn()
    finally:
        if collecting:
            gc.enable()
    after = _launch_counts()
    return {"captured": {k: after[k] - before[k] for k in after},
            "captured_dval": _dval_count() - dval, "replays": 0}


def graph_launches(graphs):
    """Each kernel's device launches over the replays of ``graphs`` (records
    of :func:`captured`): captured count × replays, summed."""
    total = dict.fromkeys(_launch_counts(), 0)
    for g in graphs.values():
        for name, count in g["captured"].items():
            total[name] += count * g["replays"]
    return total


def graph_dval_launches(graphs):
    """K1-dval's device launches over the replays of ``graphs``."""
    return sum(g["captured_dval"] * g["replays"] for g in graphs.values())


def device_split_metrics(metric, out, labels, split_masks):
    """The ``metric`` of each split on the device, [S] float32 for bool
    ``split_masks`` [S, N]: acc on int labels or on one-hot targets
    (argmax), mse on dense targets, rocauc on multilabel targets
    (:func:`device_rocauc_tasks`)."""
    if metric == "rocauc":
        return torch.stack([
            device_rocauc_tasks(out.float(), labels, split_masks[s])
            for s in range(split_masks.shape[0])])
    if metric == "acc":
        pred = out.argmax(-1)
        true = labels if labels.dim() == 1 else labels.argmax(-1)
        val = (pred == true).float()
    else:  # mse
        val = (out.reshape(labels.shape).float() - labels.float()) ** 2
        if val.dim() > 1:
            val = val.mean(-1)
    m = split_masks.float()
    return (m @ val) / torch.clamp(m.sum(1), min=1.0)


@functools.lru_cache(maxsize=None)
def _capture_stream(device):
    """The one side stream of ``device`` on which every run's warm-up and
    capture run: cuBLAS keeps a workspace for each stream it has run on,
    for the life of the process, so a new stream per run would hold more
    device memory with every run."""
    return torch.cuda.Stream(device)


class FullBatchTrainer:
    """Train a node-level model on one (full) graph.

    ``model(x, senders, receivers, edge_weight, generator=g, plan=p, **kw)``
    gives the logits; in train mode it draws its dropout masks from ``g``,
    and its graph branch runs on ``p``, the graph's CSR plan. ``kw`` is
    ``model_kwargs`` (its ``indices_are_sorted`` is taken out and passed on
    its own, as the JAX trainer does; the port's graph is always sorted, so
    it defaults to True); its ``ell``, a sparse layout pair of
    ``ops/ell.py`` or ``ops/bsr.py``, replaces the plan. The graph, the
    model and the layout are moved to ``device`` (the GPU unless told
    otherwise), and the plan is built there once.
    ``manireg > 0`` adds the Laplacian smoothness of the logits over the
    edges to the loss (``image and text/main.py:103-112``).
    """

    def __init__(self, model, graph: GraphData, labels, *, lr: float = 1e-2,
                 weight_decay: float = 5e-4, loss: str = "nll",
                 metric: str = "acc", seed: int = 123,
                 onehot_bce_labels: bool = False,
                 model_kwargs: Optional[dict] = None, manireg: float = 0.0,
                 device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.graph = graph.to(self.device)
        self.model_kwargs = dict(model_kwargs or {})
        if self.model_kwargs.get("ell") is not None:
            # a sparse layout of the GCN branch (ops/ell.py, ops/bsr.py),
            # moved to the device once, before any capture
            self.model_kwargs["ell"] = tuple(
                d.to(self.device) for d in self.model_kwargs["ell"])
        self.plan = self._build_plan()
        self.lr = lr
        self.weight_decay = weight_decay
        self.seed = seed
        self.loss_fn = LOSSES[loss]
        self.metric_name = metric
        self.metric_fn = METRICS[metric]
        self.manireg = manireg
        self._sorted = bool(self.model_kwargs.pop("indices_are_sorted", True))
        self.labels_train = torch.as_tensor(
            train_labels(labels, loss, onehot_bce_labels), device=self.device)
        self.labels_eval = np.asarray(labels)  # original layout, for metrics
        #: The :class:`EpochRunner` of the last epoch-block run, with its
        #: graphs and their launch counts (None before one).
        self.epoch_runner = None

    def _build_plan(self):
        """The graph's plan for the model: DIFFormer's GCN plan, kept on
        the graph (``GraphData.csr_plan()``; none where the model runs on a
        sparse layout, ``model_kwargs["ell"]``), or the plan of another
        model's ``build_plan`` (the temporal models on the node task, as
        the JAX command line runs them)."""
        from difformer_tpu_torch.nn.difformer import DIFFormer

        if isinstance(self.model, DIFFormer):
            if self.model_kwargs.get("ell") is not None:
                return None
            return self.graph.csr_plan()
        g = self.graph
        return self.model.build_plan(g.senders, g.receivers, g.num_nodes,
                                     g.edge_weight, g.edge_mask)

    # -- state ---------------------------------------------------------------
    def init_state(self, run: int = 0, init_params=None,
                   init_batch_stats=None) -> TrainState:
        """Fresh weights drawn from ``seed + run`` (then ``init_params``, a
        flax params tree as the JAX package's trainer takes, and
        ``init_batch_stats``, its ``batch_stats``, where given), written
        into the model's parameters and buffers in place, and a fresh Adam.
        Without ``init_batch_stats`` the BatchNorm statistics are fresh,
        as a JAX init gives them."""
        self.model.reset_parameters(
            torch.Generator().manual_seed(self.seed + run))
        if init_params is not None:
            load_params(self.model, init_params, init_batch_stats)
        opt = torch_adam(self.model.parameters(), self.lr, self.weight_decay)
        return TrainState(self.model, opt, 0)

    def _generator(self, run):
        """The run's dropout generator, on the trainer's device."""
        return torch.Generator(self.device).manual_seed(1000 + self.seed + run)

    def _forward(self, generator=None):
        g = self.graph
        return self.model(g.node_feat, g.senders, g.receivers, g.edge_weight,
                          node_mask=g.node_mask, edge_mask=g.edge_mask,
                          generator=generator, plan=self.plan,
                          indices_are_sorted=self._sorted,
                          **self.model_kwargs)

    def _loss(self, out, train_mask):
        loss = self.loss_fn(out, self.labels_train, train_mask)
        if self.manireg > 0:
            # Laplacian smoothness over the edges (image and text/main.py:
            # 103-112); index_select's backward sums with atomics on CUDA
            g = self.graph
            diff = (out.index_select(0, g.senders)
                    - out.index_select(0, g.receivers))
            loss = loss + self.manireg * diff.square().sum(-1).mean()
        return loss

    # -- public API ----------------------------------------------------------
    def train_step(self, state: TrainState, generator, train_mask):
        """One forward, backward and Adam update. Returns (state, loss) with
        the loss as a 0-d tensor on the device."""
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss = self._loss(self._forward(generator), train_mask)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, loss.detach()

    @torch.no_grad()
    def forward_eval(self, state: TrainState):
        """Eval-mode logits [N, C] on the device."""
        state.model.eval()
        return self._forward()

    def evaluate(self, state: TrainState, split_idx):
        """(metric of each split, logits [N, C] as numpy): the host path,
        which copies the logits to the host."""
        out = self.forward_eval(state).float().cpu().numpy()
        res = {}
        for name, idx in split_idx.items():
            idx = np.asarray(idx)
            res[name] = self.metric_fn(self.labels_eval[idx], out[idx])
        return res, out

    def evaluate_params(self, params, split_idx, extra=None):
        """Eval-only path for loaded weights (a flax params tree) and, in
        ``extra``, the JAX trainer's non-param collections (``{"batch_stats":
        ...}``)."""
        state = self.init_state(0, init_params=params,
                                init_batch_stats=(extra or {}).get(
                                    "batch_stats"))
        return self.evaluate(state, split_idx)

    # -- device metrics and the epoch-block fit -----------------------------
    def _device_split_metrics(self, out, labels, split_masks):
        """:func:`device_split_metrics` of the trainer's metric; equal to
        the host metric for the cases :meth:`_scan_eligible` admits."""
        return device_split_metrics(self.metric_name, out, labels,
                                    split_masks)

    def _scan_eligible(self, epoch_block, eval_step, save_best, print_prop,
                       ckpt_dir, checkpoint_every, resume):
        """The JAX package's rule (``:322-341``) for the epoch-block fit: a
        block of more than one epoch, no option that needs the host every
        epoch, and a metric the device computes as the host does."""
        if not epoch_block or epoch_block <= 1:
            return False
        if save_best or print_prop or resume:
            return False
        if ckpt_dir and checkpoint_every > 0:
            return False
        if self.metric_name == "mse":
            return True
        le = self.labels_eval
        if self.metric_name == "rocauc":
            # multilabel targets only; the single-column softmax AUC stays
            # on the host
            return le.ndim == 2 and le.shape[-1] > 1
        if self.metric_name != "acc":
            return False
        return le.ndim == 1 or le.shape[-1] == 1

    def _fit_run_scanned(self, run, split_idx, train_mask, *, epochs,
                         epoch_block, eval_step, logger, verbose,
                         display_step, init_params):
        """One run on the epoch-block schedule of ``_fit_run_scanned``
        (``:343-430``, :func:`run_epoch_blocks`). The host reads a block's
        record once, then picks the best epoch from those scalars."""
        n = self.graph.num_nodes
        split_masks = torch.as_tensor(
            np.stack([idx_to_mask(split_idx[k], n) for k in _SPLITS]),
            device=self.device)
        state = self.init_state(run, init_params=init_params)
        self.epoch_runner = None  # frees the previous run's graphs first
        runner = self.epoch_runner = EpochRunner(
            self, state, self._generator(run), train_mask, split_masks,
            epochs)
        best = {"valid": -np.inf, "test": 0.0, "train": 0.0, "epoch": -1}

        def take(e, row):
            nonlocal best
            res = dict(zip(_SPLITS, map(float, row[1:])))
            if logger is not None:
                logger.add_result(run, (res["train"], res["valid"],
                                        res["test"]))
            if res["valid"] > best["valid"]:
                best = {**res, "epoch": e}
            if verbose and e % display_step == 0:
                print(f"run {run} epoch {e}: loss {row[0]:.4f} "
                      f"train {res['train']:.4f} valid {res['valid']:.4f} "
                      f"test {res['test']:.4f}")

        run_epoch_blocks(runner, take, epochs=epochs, epoch_block=epoch_block,
                         eval_step=eval_step)
        best["losses"] = runner.fetch(0, epochs)[:, 0].tolist()
        return best

    def _fit_run(self, run, split_idx, train_mask, *, epochs, eval_step,
                 logger, verbose, display_step, save_best, ckpt_dir,
                 checkpoint_every, resume, init_params, print_prop):
        """One run of the per-epoch loop (``:506-564``)."""
        state = self.init_state(run, init_params=init_params)
        generator = self._generator(run)
        best = {"valid": -np.inf, "test": 0.0, "train": 0.0, "epoch": -1}
        losses = []
        best_params = None
        start_epoch = 0
        mgr = None
        if ckpt_dir and checkpoint_every > 0:
            mgr = CheckpointManager(f"{ckpt_dir}/run{run}")
            last = mgr.latest_step() if resume else None
            if last is not None:
                saved = mgr.restore(last, map_location=self.device)
                state.model.load_state_dict(saved["model"])
                state.optimizer.load_state_dict(saved["optimizer"])
                generator.set_state(saved["generator"].cpu())
                best, losses = dict(saved["best"]), list(saved["losses"])
                start_epoch = state.step = last + 1
        for epoch in range(start_epoch, epochs):
            state, loss = self.train_step(state, generator, train_mask)
            losses.append(float(loss))
            if epoch % eval_step == 0 or epoch == epochs - 1:
                res, out = self.evaluate(state, split_idx)
                if logger is not None:
                    logger.add_result(run, (res["train"], res["valid"],
                                            res["test"]))
                if res["valid"] > best["valid"]:
                    best = {**res, "epoch": epoch}
                    if save_best:
                        best_params = {
                            k: v.detach().cpu().clone()
                            for k, v in state.model.state_dict().items()}
                if verbose and epoch % display_step == 0:
                    print(f"run {run} epoch {epoch}: loss {losses[-1]:.4f} "
                          f"train {res['train']:.4f} valid "
                          f"{res['valid']:.4f} test {res['test']:.4f}")
                    if print_prop:
                        # reference main.py:149-151 diagnostic
                        pred = out.argmax(axis=-1)
                        _, counts = np.unique(pred, return_counts=True)
                        print("Predicted proportions:",
                              counts / pred.shape[0])
            if mgr is not None and (epoch + 1) % checkpoint_every == 0:
                mgr.save(epoch, {
                    "model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict(),
                    "generator": generator.get_state(),
                    "best_valid": float(best["valid"]),
                    "best": best, "losses": losses, "epoch": epoch})
        if mgr is not None:
            mgr.close()
        if save_best:
            best["params"] = best_params
        best["losses"] = losses
        return best

    def fit(self, split_idx, *, epochs: int = 100, runs: int = 1,
            logger=None, eval_step: int = 1, verbose: bool = False,
            display_step: int = 50, save_best: bool = False,
            ckpt_dir: str = "", checkpoint_every: int = 0,
            resume: bool = False, init_params=None, print_prop: bool = False,
            epoch_block: int = 0):
        """Train ``runs`` runs of ``epochs`` epochs with best-validation
        selection. One summary per run: ``train``/``valid``/``test`` at the
        best epoch, ``epoch``, ``losses`` (every epoch's training loss) and,
        with ``save_best``, ``params``, a CPU copy of the best epoch's
        ``state_dict``.

        ``logger`` is any object with ``add_result(run, (train, valid,
        test))``; ``verbose`` prints every ``display_step``-th eval epoch,
        with the predicted class proportions under ``print_prop``.
        ``ckpt_dir`` with ``checkpoint_every=N`` writes a checkpoint every N
        epochs to ``{ckpt_dir}/run{run}`` (model, Adam, dropout generator,
        best record, losses); ``resume=True`` restarts from the latest one
        and continues the exact dropout stream.

        ``epoch_block > 1`` asks for the epoch-block fit (the module's
        docstring), taken when :meth:`_scan_eligible` allows it, as in the
        JAX package; otherwise the per-epoch loop runs."""
        n = self.graph.num_nodes
        train_mask = torch.as_tensor(idx_to_mask(split_idx["train"], n),
                                     device=self.device)
        common = dict(epochs=epochs, eval_step=eval_step, logger=logger,
                      verbose=verbose, display_step=display_step,
                      init_params=init_params)
        if self._scan_eligible(epoch_block, eval_step, save_best, print_prop,
                               ckpt_dir, checkpoint_every, resume):
            return [self._fit_run_scanned(run, split_idx, train_mask,
                                          epoch_block=epoch_block, **common)
                    for run in range(runs)]
        return [self._fit_run(run, split_idx, train_mask, save_best=save_best,
                              ckpt_dir=ckpt_dir,
                              checkpoint_every=checkpoint_every,
                              resume=resume, print_prop=print_prop, **common)
                for run in range(runs)]


def run_epoch_blocks(runner, take, *, epochs, epoch_block, eval_step):
    """Drive ``runner`` (an :class:`EpochRunner`) through one run of
    ``epochs`` epochs on the JAX package's epoch-block schedule, calling
    ``take(epoch, record row)`` at each eval as the per-epoch loop would:
    blocks of ``groups = max(1, epoch_block // eval_step)`` groups, each a
    step, an eval and ``eval_step - 1`` steps, read once a block; without
    evals inside the run (``eval_step >= epochs``) one step and an eval,
    then steps alone; the remaining epochs one at a time on the per-epoch
    rule; and the final epoch's eval forced where the blocks covered it
    (reference main.py:133)."""
    epoch = 0
    last_eval = -1
    if eval_step < epochs:
        groups = max(1, epoch_block // eval_step)
        length = groups * eval_step
        while epoch + length <= epochs:
            runner.block(groups, eval_step)
            rows = runner.fetch(epoch, epoch + length)
            for gi in range(groups):     # evals at the groups' starts
                take(epoch + gi * eval_step, rows[gi * eval_step])
                last_eval = epoch + gi * eval_step
            epoch += length
    else:
        # evals only at the end, but the per-epoch loop evals at epoch 0
        # too (0 % eval_step == 0): one step and an eval, then steps
        runner.step()
        runner.evaluate()
        take(0, runner.fetch(0, 1)[0])
        last_eval = 0
        for _ in range(1, epochs):
            runner.step()
        epoch = epochs
    while epoch < epochs:
        runner.step()
        if epoch % eval_step == 0 or epoch == epochs - 1:
            runner.evaluate()
            take(epoch, runner.fetch(epoch, epoch + 1)[0])
            last_eval = epoch
        epoch += 1
    if last_eval != epochs - 1 and (epochs - 1) % eval_step != 0:
        runner.evaluate()
        take(epochs - 1, runner.fetch(epochs - 1, epochs)[0])


class EpochRunner:
    """The train steps and device evals of one epoch-block run.

    A step writes its loss, and an eval the split metrics of the state the
    last step left, into one device record [epochs, ``width``] (loss; by
    default train, valid, test), at the row a device cursor holds (the step
    advances it), so the host reads any span of epochs in one copy
    (:meth:`fetch`).

    Without ``capture`` (by default on the CPU) :meth:`step` and
    :meth:`evaluate` run eagerly. With it (by default on CUDA) the
    constructor captures each once as a CUDA graph and they replay it:
    first :data:`WARMUP_STEPS` steps and evals on the device's capture
    stream (one for every run, :func:`_capture_stream`), whose
    effect on the weights (copied back in place), on Adam (its moments and
    step count zeroed in place, as a fresh Adam has them) and on the dropout
    generator (its state restored) is undone; then the step is captured with
    the generator registered with the graph, so every replay draws the next
    masks, exactly as eager steps would; then the eval, in the step graph's
    memory pool. Params, grads and Adam's state stay the tensors the graphs
    recorded; a new run gets a new runner and new graphs.

    Under graphs the kernel wrappers' ``LAUNCHES`` count a kernel once, when
    it is captured: :attr:`graphs` holds, per graph, the counts seen at its
    capture (``captured``) and its ``replays``, whose product is the
    kernel's launches on the device.
    """

    def __init__(self, trainer, state, generator, train_mask, split_masks,
                 epochs, *, width=4, capture=None):
        self.trainer = trainer
        self.state = state
        self.generator = generator
        self.train_mask = train_mask
        self.split_masks = split_masks
        device = trainer.device
        self.record = torch.full((epochs, width), float("nan"),
                                 device=device)
        self.cursor = torch.zeros(1, dtype=torch.long, device=device)
        self.graphs = {}
        self._step_graph = self._eval_graph = None
        self.captured = (device.type == "cuda" if capture is None
                         else capture)
        if self.captured:
            self._capture()

    def _run_step(self):
        _, loss = self.trainer.train_step(self.state, self.generator,
                                          self.train_mask)
        self.record[:, 0].index_copy_(0, self.cursor, loss.reshape(1))
        self.cursor.add_(1)

    def _run_eval(self):
        out = self.trainer.forward_eval(self.state)
        metrics = self.trainer._device_split_metrics(
            out, self.trainer.labels_train, self.split_masks)
        self.record[:, 1:].index_copy_(0, self.cursor - 1,
                                       metrics.reshape(1, -1))

    def _capture(self):
        model, opt = self.state.model, self.state.optimizer
        weights = {k: v.detach().clone()
                   for k, v in model.state_dict().items()}
        dropout_state = self.generator.get_state()
        side = _capture_stream(self.record.device)
        side.wait_stream(torch.cuda.current_stream(self.record.device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self._run_step()
                self._run_eval()
        torch.cuda.current_stream(self.record.device).wait_stream(side)
        model.load_state_dict(weights)
        for moments in opt.state.values():
            for value in moments.values():
                value.zero_()
        self.generator.set_state(dropout_state)
        self.cursor.zero_()
        self.record.fill_(float("nan"))

        self._step_graph = torch.cuda.CUDAGraph()
        self._step_graph.register_generator_state(self.generator)
        self.graphs["step"] = captured(self._step_graph, self._run_step,
                                       side)
        self._eval_graph = torch.cuda.CUDAGraph()
        self.graphs["eval"] = captured(self._eval_graph, self._run_eval,
                                       side, self._step_graph.pool())
        self.state.step = 0  # the warm-up's and the capture's count

    def step(self):
        """One train step (a replay of the step graph on CUDA)."""
        if self._step_graph is None:
            self._run_step()
            return
        self._step_graph.replay()
        self.graphs["step"]["replays"] += 1
        self.state.step += 1

    def evaluate(self):
        """The split metrics of the current weights into the last step's
        row (a replay of the eval graph on CUDA)."""
        if self._eval_graph is None:
            self._run_eval()
            return
        self._eval_graph.replay()
        self.graphs["eval"]["replays"] += 1

    def block(self, groups, eval_step):
        """``groups`` groups of a step, an eval and ``eval_step - 1`` steps,
        with no host sync."""
        for _ in range(groups):
            self.step()
            self.evaluate()
            for _ in range(eval_step - 1):
                self.step()

    def fetch(self, lo, hi):
        """Rows ``lo`` to ``hi - 1`` of the record, as numpy (one copy to the
        host; waits for the device)."""
        return self.record[lo:hi].cpu().numpy()

    def rewind(self):
        """Point the cursor at row 0 again, so that more steps can be
        replayed after the run (for timing them); the weights go on from
        where they are."""
        self.cursor.zero_()

    def launches(self):
        """Each kernel's device launches over the replays so far: captured
        count × replays, summed over the graphs."""
        return graph_launches(self.graphs)

    def dval_launches(self):
        """K1-dval's device launches over the replays so far (GAT's value
        gradient; 0 where the values take none)."""
        return graph_dval_launches(self.graphs)
