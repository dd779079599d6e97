"""Mini-batch training on large graphs, as
``difformer_tpu/train/minibatch.py:MiniBatchTrainer``.

Reference: ``node classification/main-batch.py:109-165``. Each epoch a
random permutation of the nodes is cut into chunks of ``batch_size``; each
chunk trains on its induced subgraph (edges between chunks are dropped by
design, SURVEY.md §7.3 item 5) with one Adam step; evaluation runs on the
full graph. As in the JAX trainer, a chunk's loss covers every node of the
chunk, the permutations come from ``np.random.default_rng(seed + run)``,
and the best epoch is chosen by the validation metric of the evals at
every ``eval_step``-th epoch and the last.

The last chunk, of n − (chunks − 1)·batch_size nodes, runs at its own size,
as the reference runs it. (The JAX trainer pads it to ``batch_size`` with
copies of node 0 and no node mask, so the copies enter its global
attention; ROADMAP.md queue C.)

The model is DIFFormer or a model of the baseline zoo (``nn/gnns.py``) but
LINK, whose weight is indexed by the global node id, which a chunk's
relabelled edges cannot address (the JAX route fails on it too). The JAX
trainer hands any model the chunk; the port does not carry the two faults
that leaves in the zoo (ROADMAP.md queue C): its step applies
``{"params": p}`` alone, so no BatchNorm model trains there (here the
running statistics are the model's buffers, moved by every chunk step and
kept in the best state), and the zoo reads no ``edge_mask``, so the JAX
trainer's padded 0 → 0 edges enter its normalisation (here a chunk's plan
holds its real edges only). ManiReg trains its MLP without the smoothness
term, as the JAX route does.

The host builds each epoch's chunk plans (``native/``): the induced
subgraphs of all chunks in one pass over the edges, then for each chunk
the plan its model names (``chunk_plan_kind``, :data:`PLAN_KINDS`):
DIFFormer's two CSRs with their GCN values, the zoo's ``gcn_norm`` CSRs
with or without a self-loop on every node, or GAT's edges and loops in
receiver order with their transposed positions, each with K1's split
schedules (GAT's also K1-dval's; ``kernels/spmm.py``), bit-equal to the
plans built on the device (``nn/gnns.py:norm_plan``, ``gat_plan``); none
for a model that reads no graph. The device holds the features and labels
and gathers a chunk's rows itself; the plan of the kind is built over
views of the host's arrays (:func:`chunk_plan`). Two ways to run an epoch, with the
same plans and the same numbers:

- ``use_scan=False``, the per-chunk loop: each chunk's plan is copied to
  the device at its exact size and the step runs eagerly.
- ``use_scan=True`` (the default; the counterpart of the JAX trainer's
  one-dispatch scan): each chunk's plan is packed on the host into one
  flat int32 buffer at a fixed capacity (the edge bucket of the JAX rule,
  ``_estimate_chunk_edges``; K1's schedule at ``split_capacity``), a
  worker thread packs the next epoch's plans while the device runs this
  one, and each chunk is one copy from pinned memory into a static device
  buffer and one step. On CUDA, each run captures the step at the full
  chunk size and at the last chunk's size as CUDA graphs
  (:class:`ChunkRunner`), which every chunk replays; on the CPU the same
  loop runs without capture. A failed capture or replay raises; nothing
  falls back to eager execution. GAT's edge tensors there run over the
  capacity: a padded edge joins no sum and no max and takes no gradient
  (``GATPlan.padded``). Its attention dropout draws a value an edge, over
  the chunk's edges in the loop and over the capacity here, so at
  attention dropout above 0 the two paths draw other masks.

A chunk whose induced subgraph has more edges than the capacity raises, as
``pad_edges`` does in the JAX trainer. Losses stay on the device and the
host reads an epoch's chunk losses once.
"""

from __future__ import annotations

import dataclasses
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from difformer_tpu_torch import native
from difformer_tpu_torch.data.transforms import edge_bucket, pad_edges
from difformer_tpu_torch.kernels.spmm import (
    DVAL_SPLIT_THRESHOLD,
    SPLIT_THRESHOLD,
    padded_split,
    row_split_host,
    split_capacity,
)
from difformer_tpu_torch.nn.gnns import gat_plan_from_views
from difformer_tpu_torch.ops.graph_ops import views_plan
from difformer_tpu_torch.train.optim import torch_adam
from difformer_tpu_torch.train.trainer import (
    LOSSES,
    WARMUP_STEPS,
    TrainState,
    _capture_stream,
    captured,
    device_split_metrics,
    graph_launches,
    idx_to_mask,
)
from difformer_tpu_torch.utils.device import resolve_device
from difformer_tpu_torch.utils.metrics import METRICS
from difformer_tpu_torch.utils.weights import load_params

_FLOAT_FIELDS = ("val", "t_val")
_SPLIT_FIELDS = ("rows", "seg_ptr", "seg_begin", "seg_end")
#: The plan arrays of each kind, as its native entry gives them.
_PLAN_FIELDS = {
    "csr": ("row_ptr", "col", "val", "t_row_ptr", "t_col", "t_val"),
    "gat": ("row_ptr", "col", "edge_row", "t_row_ptr", "t_col", "t_pos"),
}
_PLAN_FIELDS["norm"] = _PLAN_FIELDS["norm_loops"] = _PLAN_FIELDS["csr"]
#: The kinds of chunk plan (a model's ``chunk_plan_kind``; DIFFormer's is
#: "csr"): DIFFormer's two CSRs with the reference's GCN values
#: (``native.chunk_csr``); the baseline zoo's ``gcn_norm`` plans without
#: and with a self-loop on every node (``native.chunk_norm_csr``); GAT's
#: (``native.chunk_gat_csr``); None for a model that reads no graph.
PLAN_KINDS = tuple(_PLAN_FIELDS) + (None,)
_LOOPED = ("norm_loops", "gat")
#: The plan of each kind over views of its arrays on the device (the
#: models' ``forward(plan=)``): a :class:`CsrPlan`, or a ``GATPlan``.
_VIEW_PLANS = {"csr": views_plan, "norm": views_plan,
               "norm_loops": views_plan, "gat": gat_plan_from_views,
               None: lambda views, num_nodes: None}


def plan_kind(model):
    """The chunk plan kind that ``model`` names (``chunk_plan_kind``; a
    model that cannot train on node chunks raises there)."""
    kind = model.chunk_plan_kind
    if kind not in PLAN_KINDS:
        raise ValueError(f"{type(model).__name__} names an unknown chunk "
                         f"plan kind {kind!r} (known: {PLAN_KINDS})")
    return kind


def _split_sources(kind):
    """(prefix, row pointers, threshold) of each split schedule of a plan
    of ``kind``: K1's of its two CSRs, and for GAT K1-dval's of the
    receivers' CSR."""
    out = [("", "row_ptr", SPLIT_THRESHOLD),
           ("t_", "t_row_ptr", SPLIT_THRESHOLD)]
    if kind == "gat":
        out.append(("d_", "row_ptr", DVAL_SPLIT_THRESHOLD))
    return out


def _fill(kind, senders, receivers, num_nodes, out=None):
    """The plan arrays of ``kind`` (``_PLAN_FIELDS``) from its native
    entry, into ``out`` where given."""
    if kind == "csr":
        return native.chunk_csr(senders, receivers, num_nodes, out=out)
    if kind == "gat":
        return native.chunk_gat_csr(senders, receivers, num_nodes, out=out)
    return native.chunk_norm_csr(senders, receivers, num_nodes,
                                 kind == "norm_loops", out=out)


@dataclasses.dataclass(frozen=True)
class ChunkLayout:
    """Where each field of a chunk plan of ``nodes`` nodes lies in its flat
    int32 buffer, at ``edges`` edges (the CSRs' capacity, self-loops
    included) and K1's split capacity, for a plan of ``kind``
    (:data:`PLAN_KINDS`; None holds the node ids alone)."""

    nodes: int
    edges: int
    kind: Optional[str] = "csr"

    @property
    def capacity(self):
        return split_capacity(self.edges)

    @property
    def size(self):
        return sum(n for _, n in self._lengths())

    def _lengths(self):
        """The fields in buffer order with their lengths in int32 words; val
        and t_val hold float32 bits."""
        m, e = self.nodes, self.edges
        if self.kind is None:
            return [("nodes", m)]
        a, b, c, d, f, g = _PLAN_FIELDS[self.kind]
        plan = [("nodes", m), (a, m + 1), (b, e), (c, e), (d, m + 1),
                (f, e), (g, e)]
        sources = _split_sources(self.kind)
        split = [(f"{p}{k}", n) for p, _, t in sources
                 for (h, s) in [split_capacity(e, t)] for k, n in (
                     ("rows", h), ("seg_ptr", h + 1), ("seg_begin", s),
                     ("seg_end", s))]
        return plan + split + [("counts", 2 * len(sources))]

    def views(self, buf):
        """{field: view of ``buf``} (a numpy array or a tensor of int32;
        val and t_val viewed as float32)."""
        out, at = {}, 0
        for name, n in self._lengths():
            v = buf[at:at + n]
            if name in _FLOAT_FIELDS:
                v = (v.view(np.float32) if isinstance(v, np.ndarray)
                     else v.view(torch.float32))
            out[name] = v
            at += n
        return out


def chunk_plan(layout, buf):
    """The plan of a packed chunk buffer (a device tensor) of ``layout``,
    over views of it."""
    return _VIEW_PLANS[layout.kind](layout.views(buf), layout.nodes)


def pack_csr(v, senders, receivers, num_nodes, kind="csr"):
    """Write the plan of ``kind`` for the edges (senders, receivers) into
    the numpy views ``v`` of a packed plan: DIFFormer's two CSRs with
    their GCN values (``native.chunk_csr``), or the zoo's (``"norm"``,
    ``"norm_loops"``, ``"gat"``), and each split schedule (K1's two, GAT's
    also K1-dval's) at the capacity of its views with its counts; returns
    (heavy rows, segments) of K1's two CSRs."""
    _fill(kind, senders, receivers, num_nodes,
          out=tuple(v[k] for k in _PLAN_FIELDS[kind]))
    counts = []
    for prefix, ptr, threshold in _split_sources(kind):
        split = tuple(v[prefix + k] for k in _SPLIT_FIELDS)
        counts += padded_split(row_split_host(v[ptr], threshold),
                               (split[0].size, split[2].size), split)
    v["counts"][:] = counts
    return counts[0] + counts[2], counts[1] + counts[3]


def pack_chunk(layout, buf, nodes, sub):
    """Write the plan of the chunk ``nodes`` with induced subgraph ``sub``
    ([2, E] int32, relabelled; None for a plan of kind None) into ``buf``
    (numpy int32 [layout.size]); returns (heavy rows, segments) of its two
    CSRs."""
    v = layout.views(buf)
    v["nodes"][:] = nodes
    if layout.kind is None:
        return 0, 0
    return pack_csr(v, sub[0], sub[1], layout.nodes, layout.kind)


def exact_views(kind, senders, receivers, num_nodes):
    """A chunk's plan of ``kind`` at its exact size: {field: numpy array},
    its split schedules exact (no counts)."""
    v = dict(zip(_PLAN_FIELDS[kind],
                 _fill(kind, senders, receivers, num_nodes)))
    for prefix, ptr, threshold in _split_sources(kind):
        v.update(zip((prefix + k for k in _SPLIT_FIELDS),
                     row_split_host(v[ptr], threshold)))
    return v


def minibatch_labels(labels, loss):
    """The training targets of the JAX trainer (``:56-69``): float one-hot
    for BCE on 1-D or single-column labels (a negative label marks class
    0, as ``np.clip`` makes it there), float as given for multilabel BCE,
    int64 class ids (the first column) otherwise."""
    labels = np.asarray(labels)
    if loss == "bce":
        if labels.ndim == 1 or labels.shape[-1] == 1:
            flat = labels.reshape(-1).astype(np.int64)
            onehot = np.zeros((flat.shape[0], int(flat.max()) + 1),
                              np.float32)
            onehot[np.arange(flat.shape[0]), np.clip(flat, 0, None)] = 1.0
            return onehot
        return labels.astype(np.float32)
    flat = labels.reshape(labels.shape[0], -1)[:, 0] if labels.ndim > 1 \
        else labels
    return flat.astype(np.int64)


class MiniBatchTrainer:
    """Train a node-level model on chunks of a large graph.

    ``model(x, plan=p, generator=g)`` gives the logits of the nodes of
    ``x`` over the graph of plan ``p``: DIFFormer (over a CSR plan, with
    ``edge_chunk_size=c`` in the eval) or a model of the baseline zoo
    (``nn/gnns.py``) but LINK, over the plan its ``chunk_plan_kind`` names
    (:data:`PLAN_KINDS`). ``node_feat`` [N, F], ``edge_index`` [2, E] and
    ``labels`` are numpy; features and labels go to ``device`` (the GPU
    unless told otherwise) once, with the full graph's plan for the eval
    (the model's ``build_plan``). The
    constructor and ``fit`` take the JAX trainer's arguments;
    ``edge_bucket_growth`` sets the growth of the edge capacity's ladder
    (the JAX trainer takes it and keeps 1.3).
    """

    def __init__(self, model, node_feat, edge_index, labels, *,
                 batch_size: int = 10000, lr: float = 1e-2,
                 weight_decay: float = 0.0, loss: str = "nll",
                 metric: str = "acc", seed: int = 123,
                 edge_bucket_growth: float = 1.3, use_scan: bool = True,
                 device=None):
        self.device = resolve_device(device)
        #: The chunk plan kind of the model (:data:`PLAN_KINDS`).
        self.kind = plan_kind(model)
        self.model = model.to(self.device)
        x = np.asarray(node_feat, np.float32)
        ei = np.asarray(edge_index)
        self.n = x.shape[0]
        self.batch_size = min(batch_size, self.n)
        self.n_chunks = -(-self.n // self.batch_size)
        self.last_size = self.n - (self.n_chunks - 1) * self.batch_size
        self.senders = np.ascontiguousarray(ei[0], np.int32)
        self.receivers = np.ascontiguousarray(ei[1], np.int32)
        self.lr, self.weight_decay, self.seed = lr, weight_decay, seed
        self.loss_name = loss
        self.loss_fn = LOSSES[loss]
        self.metric = metric
        self.metric_fn = METRICS[metric]
        self.growth = edge_bucket_growth
        self.use_scan = use_scan
        self.labels_eval = np.asarray(labels)
        self.x_dev = torch.as_tensor(x, device=self.device)
        self.labels_dev = torch.as_tensor(minibatch_labels(labels, loss),
                                          device=self.device)
        #: The edge capacity of a chunk's induced subgraph (the JAX rule).
        self.edge_capacity = self._estimate_chunk_edges()
        # a self-looped plan holds a loop on each of a chunk's m nodes
        self.layouts = {m: ChunkLayout(
            m, self.edge_capacity + (m if self.kind in _LOOPED else 0),
            self.kind) for m in {self.batch_size, self.last_size}}
        self._ones = {m: torch.ones(m, dtype=torch.bool, device=self.device)
                      for m in self.layouts}
        # the full graph, for the eval: its plan is built once
        senders = torch.as_tensor(self.senders, device=self.device)
        receivers = torch.as_tensor(self.receivers, device=self.device)
        self.full_plan = self.model.build_plan(senders, receivers, self.n)
        # the plain version streams the edges as the JAX eval does
        self._eval_edge_chunk = (2 * 1024 * 1024 if edge_bucket(ei.shape[1])
                                 > 8 * 1024 * 1024 else None)
        self._host_sets = None
        #: Per epoch: host seconds of its chunk plans (and of their induced
        #: subgraphs), the chunks with heavy rows, the segments and the
        #: largest chunk's edges; the loop's host seconds hold its steps'.
        self.plan_stats = []
        #: The :class:`ChunkRunner` of the last ``use_scan`` run.
        self.runner = None

    # -- state ---------------------------------------------------------------
    def init_state(self, run: int = 0, init_params=None,
                   init_batch_stats=None) -> TrainState:
        """Fresh weights drawn from ``seed + run`` (then ``init_params``, a
        flax params tree, and ``init_batch_stats``, a zoo model's flax
        ``batch_stats``, where given), written into the model's parameters
        and buffers in place, and a fresh Adam. Without
        ``init_batch_stats`` the BatchNorm statistics are fresh."""
        self.model.reset_parameters(
            torch.Generator().manual_seed(self.seed + run))
        if init_params is not None:
            load_params(self.model, init_params, init_batch_stats)
        opt = torch_adam(self.model.parameters(), self.lr, self.weight_decay)
        return TrainState(self.model, opt, 0)

    def _estimate_chunk_edges(self):
        """The JAX rule (``:344-353``): the most edges among three random
        chunks (``default_rng(0)``), times 1.5, up to the edge bucket."""
        rng = np.random.default_rng(0)
        worst = 1
        for _ in range(3):
            chunk = rng.permutation(self.n)[:self.batch_size]
            sub = native.induced_subgraph(self.senders, self.receivers, chunk,
                                          self.n)
            worst = max(worst, sub.shape[1])
        return edge_bucket(int(worst * 1.5), growth=self.growth)

    # -- the step ------------------------------------------------------------
    def _loss(self, out, labels, mask):
        if self.loss_name == "nll":
            # the JAX loss's take_along_axis reads a negative class id from
            # the end (-1: the last class); gather would fault on it
            labels = torch.where(labels < 0, labels + out.shape[-1], labels)
        return self.loss_fn(out, labels, mask)

    def train_step(self, state, generator, nodes, plan):
        """One Adam step on the chunk of node ids ``nodes`` (a device
        tensor) with CSR plan ``plan``; returns the loss, a 0-d device
        tensor. Reads nothing back from the device."""
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        x = self.x_dev.index_select(0, nodes)
        y = self.labels_dev.index_select(0, nodes)
        out = state.model(x, plan=plan, generator=generator)
        loss = self._loss(out, y, self._ones[nodes.shape[0]])
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return loss.detach()

    # -- chunk plans ---------------------------------------------------------
    def _subgraphs(self, perm):
        """Every chunk's (nodes, induced subgraph) for permutation ``perm``
        (the subgraph None for a model that reads no graph); raises for a
        chunk above the edge capacity."""
        bs = self.batch_size
        if self.kind is None:
            return [(perm[c * bs:(c + 1) * bs], None)
                    for c in range(self.n_chunks)]
        subs = native.chunk_subgraphs(self.senders, self.receivers, perm,
                                      self.batch_size)
        for sub in subs:
            if sub.shape[1] > self.edge_capacity:
                pad_edges(sub, None, self.edge_capacity)  # raises
        return [(perm[c * bs:(c + 1) * bs], sub)
                for c, sub in enumerate(subs)]

    def _exact_plan(self, m, sub):
        """A chunk's plan on the device at its exact size (the loop), from
        the host's arrays, and (heavy rows, segments) of K1's two CSRs."""
        if self.kind is None:
            return None, (0, 0)
        v = {k: torch.as_tensor(a, device=self.device)
             for k, a in exact_views(self.kind, sub[0], sub[1], m).items()}
        stats = (v["rows"].numel() + v["t_rows"].numel(),
                 v["seg_begin"].numel() + v["t_seg_begin"].numel())
        return _VIEW_PLANS[self.kind](v, m), stats

    def _host_buffers(self, slot):
        """The packed plans' host buffers of one of two slots (an epoch uses
        one while the worker fills the other), pinned on CUDA."""
        if self._host_sets is None:
            # zeros: a GAT plan's padded edges, past the real ones, keep the
            # node ids of an earlier chunk of the size, or 0, valid rows
            pin = self.device.type == "cuda"
            self._host_sets = [
                {m: torch.zeros((self.n_chunks if m == self.batch_size else 1,
                                 lay.size), dtype=torch.int32,
                                pin_memory=pin)
                 for m, lay in self.layouts.items()} for _ in range(2)]
        return self._host_sets[slot]

    def pack_epoch(self, perm, slot=0):
        """One epoch's chunk plans packed at capacity into host buffers:
        a list of (chunk size, int32 tensor) in chunk order, and the
        epoch's plan statistics. The chunks are packed by a pool of
        threads, each into its own buffer (the C++ sorts release the
        interpreter lock)."""
        t0 = time.perf_counter()
        bufs = self._host_buffers(slot)
        chunks = self._subgraphs(perm)
        subgraph_s = time.perf_counter() - t0

        def pack(c):
            nodes, sub = chunks[c]
            m = nodes.shape[0]
            host = bufs[m][c if m == self.batch_size else 0]
            return (m, host), pack_chunk(self.layouts[m], host.numpy(),
                                         nodes, sub)

        workers = max(1, min(8, os.cpu_count() or 1, len(chunks)))
        with ThreadPoolExecutor(workers) as pool:
            done = list(pool.map(pack, range(len(chunks))))
        return [p for p, _ in done], dict(
            host_s=time.perf_counter() - t0, subgraph_s=subgraph_s,
            heavy_chunks=sum(h > 0 for _, (h, _) in done),
            segments=sum(s for _, (_, s) in done),
            max_edges=max(0 if sub is None else sub.shape[1]
                          for _, sub in chunks))

    # -- epochs --------------------------------------------------------------
    def _loop_epoch(self, state, generator, perm):
        """The per-chunk loop: each chunk's exact plan, an eager step; the
        chunk losses [chunks] on the device."""
        t0 = time.perf_counter()
        losses, heavy_chunks, segments, most = [], 0, 0, 0
        chunks = self._subgraphs(perm)
        subgraph_s = time.perf_counter() - t0
        for nodes, sub in chunks:
            plan, (heavy, segs) = self._exact_plan(nodes.shape[0], sub)
            heavy_chunks += heavy > 0
            segments += segs
            most = max(most, 0 if sub is None else sub.shape[1])
            nodes = torch.as_tensor(nodes, device=self.device)
            losses.append(self.train_step(state, generator, nodes, plan))
        self.plan_stats.append(dict(host_s=time.perf_counter() - t0,
                                    subgraph_s=subgraph_s,
                                    heavy_chunks=heavy_chunks,
                                    segments=segments, max_edges=most))
        return torch.stack(losses)

    # -- eval ----------------------------------------------------------------
    @torch.no_grad()
    def forward_full(self, state):
        """Eval-mode logits [N, C] of the full graph, on the device."""
        state.model.eval()
        kw = ({"edge_chunk_size": self._eval_edge_chunk}
              if self.kind == "csr" else {})
        return state.model(self.x_dev, plan=self.full_plan, **kw)

    def _device_metric_labels(self):
        """The labels of the device metric, or None where the metric is
        computed on the host (as the JAX trainer chooses, ``:214-260``):
        multilabel ROC-AUC and single-label accuracy."""
        le = self.labels_eval
        if self.metric == "rocauc" and le.ndim == 2 and le.shape[-1] > 1:
            return torch.as_tensor(le.astype(np.float32), device=self.device)
        if self.metric == "acc" and (le.ndim == 1 or le.shape[-1] == 1):
            return torch.as_tensor(le.reshape(-1).astype(np.int64),
                                   device=self.device)
        return None

    def evaluate(self, state, split_idx):
        """(metric of each split, logits as numpy or None) on the full
        graph. Multilabel ROC-AUC and single-label accuracy are computed on
        the device and only the split metrics reach the host (logits None);
        other metrics copy the logits to the host."""
        out = self.forward_full(state)
        labels = self._device_metric_labels()
        names = list(split_idx)
        if labels is not None:
            masks = torch.as_tensor(np.stack([
                idx_to_mask(split_idx[k], self.n) for k in names]),
                device=self.device)
            vals = device_split_metrics(self.metric, out, labels, masks)
            return dict(zip(names, map(float, vals.cpu().numpy()))), None
        out = out.float().cpu().numpy()
        return {k: self.metric_fn(self.labels_eval[np.asarray(v)],
                                  out[np.asarray(v)])
                for k, v in split_idx.items()}, out

    # -- fit -----------------------------------------------------------------
    def fit(self, split_idx, *, epochs: int = 50, runs: int = 1,
            eval_step: int = 9, logger=None, verbose: bool = False,
            init_params=None, init_batch_stats=None):
        """Train ``runs`` runs of ``epochs`` epochs (the JAX trainer's
        schedule, ``:283-342``). One summary per run: ``train``/``valid``/
        ``test`` at the best eval epoch, ``epoch``, ``params`` (a CPU copy
        of that epoch's ``state_dict``, BatchNorm statistics included),
        ``losses`` (each epoch's mean chunk loss) and ``chunk_losses`` (each
        epoch's chunk losses). ``init_params`` (a flax params tree) and
        ``init_batch_stats`` replace the drawn weights and statistics."""
        return [self._fit_run(run, split_idx, epochs, eval_step, logger,
                              verbose, init_params, init_batch_stats)
                for run in range(runs)]

    def _fit_run(self, run, split_idx, epochs, eval_step, logger, verbose,
                 init_params, init_batch_stats):
        state = self.init_state(run, init_params, init_batch_stats)
        generator = torch.Generator(self.device).manual_seed(777 + run)
        rng = np.random.default_rng(self.seed + run)

        def snapshot():
            return {k: v.detach().cpu().clone()
                    for k, v in state.model.state_dict().items()}

        best = {"valid": -np.inf, "test": 0.0, "train": 0.0, "epoch": -1,
                "params": snapshot()}
        losses, chunk_losses = [], []
        pool = runner = future = None
        if self.use_scan:
            self.runner = None  # frees the previous run's graphs first
            runner = self.runner = ChunkRunner(self, state, generator)
            # the next epoch's plans are packed while the device runs this
            # one; the permutations are drawn in order, as the loop draws
            pool = ThreadPoolExecutor(1)
            future = pool.submit(self.pack_epoch, rng.permutation(self.n), 0)
        try:
            for epoch in range(epochs):
                if runner is not None:
                    packed, stats = future.result()
                    self.plan_stats.append(stats)
                    if epoch + 1 < epochs:
                        future = pool.submit(self.pack_epoch,
                                             rng.permutation(self.n),
                                             (epoch + 1) % 2)
                    record = runner.epoch(packed)
                else:
                    record = self._loop_epoch(state, generator,
                                              rng.permutation(self.n))
                # one read of the epoch: its chunk losses and their mean
                read = torch.cat([record, record.mean().reshape(1)]).cpu()
                chunk_losses.append(read[:-1].tolist())
                losses.append(float(read[-1]))
                if epoch % eval_step == 0 or epoch == epochs - 1:
                    res, _ = self.evaluate(state, split_idx)
                    if logger is not None:
                        logger.add_result(run, (res["train"], res["valid"],
                                                res["test"]))
                    if res["valid"] > best["valid"]:
                        best = {**res, "epoch": epoch, "params": snapshot()}
                    if verbose:
                        print(f"run {run} epoch {epoch}: loss "
                              f"{losses[-1]:.4f} {res}")
        finally:
            if pool is not None:
                pool.shutdown(wait=True, cancel_futures=True)
        best["losses"] = losses
        best["chunk_losses"] = chunk_losses
        return best


class ChunkRunner:
    """The chunk steps of one ``use_scan`` run.

    For each chunk size (the full ``batch_size`` and the last chunk's) a
    static device buffer of the packed layout holds the current chunk's
    plan, and its :func:`chunk_plan` views it. A step writes its loss into
    a device record [chunks] at the row a device cursor holds. On CUDA the
    first epoch captures the step of each size as a CUDA graph, after
    :data:`WARMUP_STEPS` steps of each on the capture stream whose effect
    on the weights, Adam and the dropout generator is undone (as
    ``EpochRunner`` does); the two graphs share one memory pool and the
    generator is registered with both. A chunk is then one non-blocking
    copy of its packed plan from pinned memory and one replay. On the CPU
    the same steps run eagerly.

    Under graphs the wrappers' ``LAUNCHES`` count a kernel when it is
    captured: :attr:`graphs` holds each graph's counts at capture and its
    replays, and :meth:`launches` their products.
    """

    def __init__(self, trainer, state, generator):
        self.trainer = trainer
        self.state = state
        self.generator = generator
        dev = trainer.device
        self.record = torch.zeros(trainer.n_chunks, device=dev)
        self.cursor = torch.zeros(1, dtype=torch.long, device=dev)
        self.buffers = {m: torch.zeros(lay.size, dtype=torch.int32,
                                       device=dev)
                        for m, lay in trainer.layouts.items()}
        self.plans = {m: chunk_plan(trainer.layouts[m], buf)
                      for m, buf in self.buffers.items()}
        self.graphs = {}
        self._graphs = {}

    def _name(self, m):
        return "step" if m == self.trainer.batch_size else "last step"

    def _run(self, m):
        nodes = self.trainer.layouts[m].views(self.buffers[m])["nodes"]
        loss = self.trainer.train_step(self.state, self.generator, nodes,
                                       self.plans[m])
        self.record.index_copy_(0, self.cursor, loss.reshape(1))
        self.cursor.add_(1)

    def _capture(self, packed):
        first = {}
        for m, host in packed:
            first.setdefault(m, host)
        for m, host in first.items():
            self.buffers[m].copy_(host.reshape(-1))
        model, opt = self.state.model, self.state.optimizer
        weights = {k: v.detach().clone()
                   for k, v in model.state_dict().items()}
        dropout_state = self.generator.get_state()
        dev = self.record.device
        side = _capture_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                for m in first:
                    self.cursor.zero_()
                    self._run(m)
        torch.cuda.current_stream(dev).wait_stream(side)
        model.load_state_dict(weights)
        for moments in opt.state.values():
            for value in moments.values():
                value.zero_()
        self.generator.set_state(dropout_state)
        self.cursor.zero_()
        self.record.zero_()
        pool = None
        for m in first:
            graph = torch.cuda.CUDAGraph()
            graph.register_generator_state(self.generator)
            self.graphs[self._name(m)] = captured(
                graph, lambda m=m: self._run(m), side, pool)
            pool = graph.pool() if pool is None else pool
            self._graphs[m] = graph
        self.state.step = 0  # the warm-up's and the capture's count

    def epoch(self, packed):
        """The chunk steps of one epoch over ``packed`` (a list of (chunk
        size, packed host plan)); returns the device record of its chunk
        losses. No host sync."""
        if self.record.device.type == "cuda" and not self._graphs:
            self._capture(packed)
        self.cursor.zero_()
        for m, host in packed:
            self.buffers[m].copy_(host.reshape(-1), non_blocking=True)
            graph = self._graphs.get(m)
            if graph is None:
                self._run(m)
                continue
            graph.replay()
            self.graphs[self._name(m)]["replays"] += 1
            self.state.step += 1
        return self.record

    def launches(self):
        """Each kernel's device launches over the replays so far."""
        return graph_launches(self.graphs)
