"""Graph-level training (the particle track), as
``difformer_tpu/train/graph_level.py``.

Reference loop: ``physical particle/main.py:62-139``: batches of small
graphs, BCE with logits on each graph's logit, and an eval of every split
after every epoch. As in the JAX trainer, batches are padded to a fixed
(batch_size, max_nodes, max_edges) shape (``data/batching.py``), padding
graphs are masked out of the loss and the metrics, the train order comes
from ``np.random.default_rng(seed + run)``, and a split's metric pools the
scores of all its batches into one exact AUC.

The GCN branch's plan is chosen batch by batch as the JAX trainer chooses
it (``_to_device``): the block-dense adjacency while the shape allows it
(``dense_fits``, the JAX package's TPU limits), else the gather table while
batches are k-in-regular (the dataset-wide transposed width
``k_rev_pad``), else the edge list. A plan that fails once is not tried
again. The edge-list plan is the CSR plan of the batch's real edges with
their masked GCN values, built on the host and held at the edge capacity
``max_edges`` (``kernels/spmm.py``), with K1's schedule at
``split_capacity`` where a graph of the dataset has a node of more than
``SPLIT_THRESHOLD`` edges, and with none (one launch a product) where, as
on kNN graphs, none has.

Each batch is built and packed on the host, in a background thread
(``prefetch``) with a few threads filling the buffers, into one flat int32
buffer (:class:`BatchLayout`; pinned on CUDA); the device takes it in one non-blocking copy into a static
buffer of its layout. Two ways to run the steps and evals, with the same
numbers (:class:`GraphLevelRunner`): eagerly (``use_graphs=False``, and
every run on the CPU), or, on CUDA with ``use_graphs`` (the default, the
counterpart of the JAX trainer's ``jax.jit``), as CUDA graphs: each run
captures one train step and one eval per layout at its first batch, after
warm-up steps whose effect is undone, and replays them. Losses and eval
logits go into device records that the host reads once per epoch and per
split. A failed capture or replay raises; nothing falls back to eager
execution.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from difformer_tpu_torch.data.batching import (
    batch_iterator,
    dense_adj,
    dense_fits,
    prefetch,
    regular_knn_table,
)
from difformer_tpu_torch.kernels.spmm import SPLIT_THRESHOLD, split_capacity
from difformer_tpu_torch.train.minibatch import pack_csr, views_plan
from difformer_tpu_torch.train.optim import torch_adam
from difformer_tpu_torch.train.trainer import (
    WARMUP_STEPS,
    TrainState,
    _capture_stream,
    captured,
    graph_launches,
)
from difformer_tpu_torch.utils.device import resolve_device
from difformer_tpu_torch.utils.metrics import roc_auc_score
from difformer_tpu_torch.utils.weights import load_params

#: Threads that fill packed batches at once (the probe stays in order).
PACK_WORKERS = max(1, min(4, os.cpu_count() or 1))

_FLOATS = ("node_feat", "labels", "dense_adj", "w", "rw", "val", "t_val")


@dataclasses.dataclass(frozen=True)
class BatchLayout:
    """Where each field of a packed batch lies in its flat int32 buffer:
    the padded batch (features, masks as int32, node counts, labels) and
    the plan of its GCN branch, ``plan`` = "dense" (the [B, M, M]
    adjacency), "table" (``k`` senders a node, and ``k_rev`` receivers a
    node in the transposed table, 0 without one) or "edges" (the two CSRs
    at ``edges`` edges and K1's split schedules at ``heavy`` heavy rows and
    ``segments`` segments)."""

    plan: str
    batch_size: int
    max_nodes: int
    feat_dim: int
    k: int = 0
    k_rev: int = 0
    edges: int = 0
    heavy: int = 0
    segments: int = 0

    def _fields(self):
        """(name, shape) in buffer order; every entry one int32 word."""
        B, M, n = self.batch_size, self.max_nodes, (
            self.batch_size * self.max_nodes)
        fields = [("node_feat", (B, M, self.feat_dim)), ("node_mask", (B, M)),
                  ("n_nodes", (B,)), ("labels", (B,)), ("graph_mask", (B,))]
        if self.plan == "dense":
            return fields + [("dense_adj", (B, M, M))]
        if self.plan == "table":
            fields += [("idx", (n, self.k)), ("w", (n, self.k))]
            if self.k_rev:
                fields += [("ridx", (n, self.k_rev)), ("rw", (n, self.k_rev))]
            return fields
        e, h, s = self.edges, self.heavy, self.segments
        for p in ("", "t_"):
            fields += [(f"{p}row_ptr", (n + 1,)), (f"{p}col", (e,)),
                       (f"{p}val", (e,))]
        for p in ("", "t_"):
            fields += [(f"{p}rows", (h,)), (f"{p}seg_ptr", (h + 1,)),
                       (f"{p}seg_begin", (s,)), (f"{p}seg_end", (s,))]
        return fields + [("counts", (4,))]

    @property
    def size(self):
        return sum(int(np.prod(shape)) for _, shape in self._fields())

    def views(self, buf):
        """{field: shaped view of ``buf``} (a numpy array or a tensor of
        int32 [size]; the float fields viewed as float32)."""
        out, at = {}, 0
        for name, shape in self._fields():
            n = int(np.prod(shape))
            v = buf[at:at + n]
            if name in _FLOATS:
                v = (v.view(np.float32) if isinstance(v, np.ndarray)
                     else v.view(torch.float32))
            out[name] = v.reshape(shape)
            at += n
        return out


def model_inputs(layout, v):
    """The model's keyword inputs from the views ``v`` of a packed batch on
    the device: the node mask as bool, and the plan (``dense_adj``,
    ``knn_table`` or a :class:`CsrPlan` of the views at capacity)."""
    kw = {"node_mask": v["node_mask"] != 0, "n_nodes": v["n_nodes"]}
    if layout.plan == "dense":
        kw["dense_adj"] = v["dense_adj"]
    elif layout.plan == "table":
        kw["knn_table"] = (v["idx"], v["w"], v.get("ridx"), v.get("rw"))
    else:
        kw["plan"] = views_plan(v, layout.batch_size * layout.max_nodes)
    return kw


def pack_edges(v, batch, num_nodes):
    """Write the CSR plan of ``batch``'s real edges (its padded edges
    dropped; GCN values over the real in-degrees, ``gcn_conv``'s masked
    values) into the views ``v`` of an "edges" layout, K1's schedules at
    the layout's capacity with their counts."""
    em = np.asarray(batch.edge_mask)
    senders = np.asarray(batch.senders)[em]
    if senders.size > v["col"].shape[0]:
        raise ValueError(f"{senders.size} edges exceed the capacity "
                         f"{v['col'].shape[0]}")
    pack_csr(v, senders, np.asarray(batch.receivers)[em], num_nodes)


def _most_edges(ends):
    """The largest count of one node among the index arrays ``ends``."""
    return max((int(np.bincount(np.asarray(a)).max()) for a in ends
                if np.asarray(a).size), default=0)


def edge_split(edge_indices, capacity):
    """K1's split schedule (heavy rows, segments) of an edge-list plan held
    at ``capacity`` edges over the edges ``edge_indices`` ([2, e] arrays):
    ``split_capacity(capacity)`` where a node has more than
    ``SPLIT_THRESHOLD`` in- or out-edges, else none (one launch a product,
    as on kNN graphs)."""
    most = _most_edges(a for ei in edge_indices for a in (ei[0], ei[1]))
    return (0, 0) if most <= SPLIT_THRESHOLD else split_capacity(capacity)


def batch_layout(batch, plan, *, table=None, split=None):
    """The :class:`BatchLayout` of ``batch`` (a
    :class:`~difformer_tpu_torch.data.batching.PaddedGraphBatch`) on
    ``plan``: "dense"; "table" at the widths of the gather table ``table``;
    or "edges" at the batch's edge capacity with K1's ``split`` schedule
    (default: :func:`edge_split` of the batch's real edges)."""
    b, m, f = batch.node_feat.shape
    if plan == "dense":
        return BatchLayout("dense", b, m, f)
    if plan == "table":
        k_rev = 0 if table[2] is None else table[2].shape[1]
        return BatchLayout("table", b, m, f, k=table[0].shape[1],
                           k_rev=k_rev)
    edges = int(np.asarray(batch.senders).shape[0])
    if split is None:
        em = np.asarray(batch.edge_mask)
        split = edge_split([(np.asarray(batch.senders)[em],
                             np.asarray(batch.receivers)[em])], edges)
    return BatchLayout("edges", b, m, f, edges=edges, heavy=split[0],
                       segments=split[1])


def pack_batch(batch, layout, table=None, pin=False):
    """The packed int32 host buffer of ``layout`` holding ``batch`` (a
    :class:`~difformer_tpu_torch.data.batching.PaddedGraphBatch`) and its
    plan: the dense adjacency made here, the gather table ``table``, or
    the edge list's CSRs (:func:`pack_edges`); ``pin`` pins it."""
    buf = torch.empty(layout.size, dtype=torch.int32, pin_memory=pin)
    v = layout.views(buf.numpy())
    v["node_feat"][...] = batch.node_feat
    v["node_mask"][...] = batch.node_mask
    v["n_nodes"][...] = batch.n_nodes
    v["labels"][...] = batch.labels
    v["graph_mask"][...] = batch.graph_mask
    if layout.plan == "dense":
        dense_adj(batch, out=v["dense_adj"])
    elif layout.plan == "table":
        for name, a in zip(("idx", "w", "ridx", "rw"), table):
            if a is not None:
                v[name][...] = a
    else:
        pack_edges(v, batch, layout.batch_size * layout.max_nodes)
    return buf


def bce_sum_count(out, labels, graph_mask):
    """(Σ BCE with logits over the real graphs, their count)."""
    per = F.binary_cross_entropy_with_logits(out, labels, reduction="none")
    m = graph_mask.to(out.dtype)
    return (per * m).sum(), m.sum()


def bce_loss(out, labels, graph_mask):
    """The JAX trainer's loss (``:75-80``): BCE with logits, summed over the
    real graphs and divided by their count (at least 1)."""
    total, count = bce_sum_count(out, labels, graph_mask)
    return total / count.clamp(min=1.0)


class GraphLevelTrainer:
    """Train a graph-level model over a list of small graphs.

    ``dataset[i] = (node_feat [n, F], edge_index [2, e], label)``.
    ``model(x_pad, node_mask, n_nodes, generator=g, dense_adj=...,
    knn_table=..., plan=...)`` gives the logits [B, 1] (``nn/difformer_v2.py:
    GraphLevelModel``). The constructor takes the JAX trainer's arguments,
    ``use_graphs`` (CUDA graphs on CUDA) and ``device`` (the GPU unless told
    otherwise)."""

    def __init__(self, model, dataset: Sequence, *, batch_size=32, lr=1e-3,
                 weight_decay=0.0, metric="rocauc", seed=123, max_nodes=None,
                 max_edges=None, use_graphs=True, device=None):
        if metric not in ("rocauc", "acc"):
            raise ValueError(metric)
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.dataset = dataset
        self.batch_size = batch_size
        self.lr = lr
        self.weight_decay = weight_decay
        self.metric = metric
        self.seed = seed
        self.use_graphs = use_graphs
        self.max_nodes = max_nodes or max(g[0].shape[0] for g in dataset)
        self.max_edges = max_edges or batch_size * max(
            g[1].shape[1] for g in dataset)
        self.feat_dim = int(dataset[0][0].shape[1])
        # the dataset-wide largest out-degree, rounded up to a multiple of
        # 8: the transposed table's width, the same for every batch
        k_rev = _most_edges(g[1][0] for g in dataset)
        self._k_rev_pad = -(-k_rev // 8) * 8 if k_rev else 0
        # edges never cross graphs, so the dataset's degrees decide K1's
        # split schedule for every batch
        self._split = edge_split([g[1] for g in dataset], self.max_edges)
        self._knn_mode = None    # probed on the batches (k-in-regular plan)
        self._dense_mode = None  # probed on the batches (block-dense plan)
        #: The :class:`GraphLevelRunner` of the last ``fit``.
        self.runner = None

    # -- batches -------------------------------------------------------------
    def _layout(self, batch):
        """The probe of the JAX trainer's ``_to_device``: the layout of
        ``batch``'s plan, and the gather table when that is the plan."""
        if self._dense_mode is not False:
            self._dense_mode = dense_fits(self.batch_size, self.max_nodes)
            if self._dense_mode:
                return batch_layout(batch, "dense"), None
        if self._knn_mode is not False:
            t = regular_knn_table(batch, k_rev_pad=self._k_rev_pad)
            self._knn_mode = t is not None
            if t is not None:
                return batch_layout(batch, "table", table=t), t
        return batch_layout(batch, "edges", split=self._split), None

    def pack(self, batch):
        """(layout, packed int32 host tensor, graph_mask, labels) of one
        :class:`~difformer_tpu_torch.data.batching.PaddedGraphBatch`; the
        tensor is pinned on CUDA."""
        return self._fill(batch, *self._layout(batch))

    def _fill(self, batch, layout, table):
        buf = pack_batch(batch, layout, table,
                         pin=self.device.type == "cuda")
        return layout, buf, np.asarray(batch.graph_mask), np.asarray(
            batch.labels)

    def _packed(self, batches):
        """:meth:`pack` over ``batches`` in order: the plan probed batch by
        batch, in order, and the buffers filled by a pool of
        :data:`PACK_WORKERS` threads (numpy releases the interpreter lock
        in the dense plan's scatter and the copies)."""
        with ThreadPoolExecutor(PACK_WORKERS) as pool:
            pending = collections.deque()
            for batch in batches:
                pending.append(pool.submit(self._fill, batch,
                                           *self._layout(batch)))
                if len(pending) >= PACK_WORKERS:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()

    def batches(self, indices, *, shuffle=False, rng=None):
        """The packed batches of ``indices`` (:meth:`pack`), built in a
        background thread."""
        it = batch_iterator(self.dataset, indices, self.batch_size,
                            max_nodes=self.max_nodes,
                            max_edges=self.max_edges, shuffle=shuffle,
                            rng=rng)
        return prefetch(self._packed(it))

    # -- state ---------------------------------------------------------------
    def init_state(self, run: int = 0, init_params=None) -> TrainState:
        """Fresh weights drawn from ``seed + run`` (or ``init_params``, the
        JAX package's params tree) written into the model in place, and a
        fresh Adam. Probes the plan on the dataset's first batch, as the JAX
        trainer's ``init_state`` does."""
        first = next(batch_iterator(
            self.dataset, np.arange(min(len(self.dataset), self.batch_size)),
            self.batch_size, max_nodes=self.max_nodes,
            max_edges=self.max_edges))
        self._layout(first)
        if init_params is None:
            self.model.reset_parameters(
                torch.Generator().manual_seed(self.seed + run))
        else:
            load_params(self.model, init_params)
        opt = torch_adam(self.model.parameters(), self.lr, self.weight_decay)
        return TrainState(self.model, opt, 0)

    def _runner(self, state, generator=None, capture=None):
        if capture is None:
            capture = self.use_graphs and self.device.type == "cuda"
        rows = -(-len(self.dataset) // self.batch_size)
        return GraphLevelRunner(self, state, generator, rows, capture)

    def _metric(self, scores, labels):
        if self.metric == "rocauc":
            return roc_auc_score(labels, scores)
        return float(((scores > 0) == (labels > 0.5)).mean())

    def eval_split(self, indices, runner=None):
        """The metric over a split: the eval logits of all its batches
        pooled (an exact AUC; the reference averages per-batch AUCs,
        ``eval.py:42-46``)."""
        runner = runner or self.runner or self._runner(
            TrainState(self.model, None, 0), capture=False)
        masks, labels = [], []
        logits = runner.evaluate(self.batches(indices), masks, labels)
        gm = np.concatenate(masks)
        return self._metric(logits.reshape(-1)[gm],
                            np.concatenate(labels)[gm])

    def fit(self, split_idx, *, epochs=20, runs=1, verbose=False,
            logger=None, init_params=None):
        """Train ``runs`` runs of ``epochs`` epochs, evaluating every split
        of ``split_idx`` after each; a summary per run of the epoch with the
        best validation metric (``train``/``valid``/``test``, ``epoch``,
        ``seconds``) and every epoch's batch ``losses``."""
        summaries = []
        for run in range(runs):
            t0 = time.time()
            state = self.init_state(run, init_params)
            rng_np = np.random.default_rng(self.seed + run)
            generator = torch.Generator(self.device).manual_seed(999 + run)
            self.runner = None  # frees the previous run's graphs first
            runner = self.runner = self._runner(state, generator)
            best = {"valid": -np.inf, "test": 0.0, "train": 0.0, "epoch": -1}
            losses = []
            for epoch in range(epochs):
                n = runner.train_epoch(self.batches(
                    split_idx["train"], shuffle=True, rng=rng_np))
                losses.append(runner.loss_record[:n].tolist())
                res = {name: self.eval_split(idx, runner)
                       for name, idx in split_idx.items()}
                if logger is not None:
                    logger.add_result(
                        run, (res["train"], res["valid"], res["test"]))
                if res["valid"] > best["valid"]:
                    best = {**res, "epoch": epoch}
                if verbose:
                    print(f"run {run} epoch {epoch}: {res}")
            best["seconds"] = time.time() - t0
            best["losses"] = losses
            summaries.append(best)
        return summaries


class GraphLevelRunner:
    """The train steps and evals of one run.

    For each :class:`BatchLayout` met, a static device buffer holds the
    current batch, and the step and the eval read it through its views
    (:func:`model_inputs`). A step writes its loss into a device record at
    a device cursor and advances it; an eval writes its logits [B] the same
    way into another record. With ``capture`` (CUDA) the first batch of a
    layout captures that layout's step (or eval) as a CUDA graph, after
    :data:`WARMUP_STEPS` runs of it on the capture stream whose effect on
    the weights, Adam and the dropout generator is undone (the state is
    copied back in place); all graphs share one memory pool and the
    generator is registered with the step graphs. A batch is then one
    non-blocking copy of its packed buffer and one replay. Without
    ``capture`` the same steps run eagerly. :attr:`graphs` holds each
    graph's launch counts at capture and its replays, :meth:`launches`
    their products, :attr:`cuda_graphs` the graphs and :attr:`capture_s`
    the host seconds of the captures (warm-up included)."""

    def __init__(self, trainer, state, generator, rows, capture):
        self.trainer = trainer
        self.state = state
        self.generator = generator
        self.capture = capture
        dev = trainer.device
        self._losses = torch.zeros(rows, device=dev)
        self._logits = torch.zeros((rows, trainer.batch_size), device=dev)
        self.cursor = torch.zeros(1, dtype=torch.long, device=dev)
        self.buffers, self.inputs = {}, {}
        self.graphs, self.cuda_graphs = {}, {}
        self.capture_s = 0.0
        self._pool = None
        #: The last epoch's losses, read once at its end (numpy).
        self.loss_record = np.zeros(0, np.float32)

    # -- one batch -----------------------------------------------------------
    def load(self, layout, host):
        """Copy a packed batch (``host``, of ``layout``) into the static
        buffer of its layout (non-blocking from pinned memory)."""
        buf = self.buffers.get(layout)
        if buf is None:
            buf = self.buffers[layout] = torch.zeros(
                layout.size, dtype=torch.int32, device=self.cursor.device)
            self.inputs[layout] = layout.views(buf)
        buf.copy_(host, non_blocking=True)

    def forward(self, layout, generator=None):
        """The model on the loaded batch of ``layout``: (logits [B], the
        buffer's views)."""
        v = self.inputs[layout]
        kw = model_inputs(layout, v)
        out = self.state.model(v["node_feat"], kw.pop("node_mask"),
                               kw.pop("n_nodes"), generator=generator, **kw)
        return out[:, 0], v

    def _run_step(self, layout):
        model, opt = self.state.model, self.state.optimizer
        model.train()
        opt.zero_grad(set_to_none=True)
        out, v = self.forward(layout, self.generator)
        loss = bce_loss(out, v["labels"], v["graph_mask"] != 0)
        loss.backward()
        opt.step()
        self._losses.index_copy_(0, self.cursor, loss.detach().reshape(1))
        self.cursor.add_(1)

    @torch.no_grad()
    def _run_eval(self, layout):
        self.state.model.eval()
        out, _ = self.forward(layout)
        self._logits.index_copy_(0, self.cursor, out.reshape(1, -1))
        self.cursor.add_(1)

    # -- capture -------------------------------------------------------------
    def _take(self, name, layout, fn, train):
        """Warm ``fn`` up on the capture stream, undo what it changed, and
        capture it; returns the graph."""
        model, opt = self.state.model, self.state.optimizer
        t0 = time.perf_counter()
        dev = self.cursor.device
        cursor = self.cursor.clone()
        if train:
            weights = {k: v.detach().clone()
                       for k, v in model.state_dict().items()}
            moments = {p: {k: v.clone() for k, v in s.items()}
                       for p, s in opt.state.items()}
            dropout_state = self.generator.get_state()
        side = _capture_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                fn(layout)
        torch.cuda.current_stream(dev).wait_stream(side)
        if train:
            model.load_state_dict(weights)
            for p, s in opt.state.items():
                for k, value in s.items():
                    old = moments.get(p, {}).get(k)
                    value.copy_(old) if old is not None else value.zero_()
            self.generator.set_state(dropout_state)
        self.cursor.copy_(cursor)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        if train:
            graph.register_generator_state(self.generator)
        self.graphs[name] = captured(graph, lambda: fn(layout), side,
                                     self._pool)
        graph.instantiate()
        self._pool = graph.pool() if self._pool is None else self._pool
        self.cursor.copy_(cursor)
        torch.cuda.synchronize(dev)
        self.cuda_graphs[name] = graph
        self.capture_s += time.perf_counter() - t0
        return graph

    def run(self, kind, layout):
        """A train step (``kind`` "step") or an eval ("eval") of the loaded
        batch of ``layout``: a replay where graphs are captured (capturing
        at the layout's first batch), else eagerly."""
        fn = self._run_step if kind == "step" else self._run_eval
        if not self.capture:
            fn(layout)
            return
        name = f"{kind} {layout.plan}"
        graph = self.cuda_graphs.get(name)
        if graph is None:
            graph = self._take(name, layout, fn, kind == "step")
        graph.replay()
        self.graphs[name]["replays"] += 1

    # -- epochs --------------------------------------------------------------
    def train_epoch(self, batches):
        """The train steps over ``batches`` (:meth:`GraphLevelTrainer.
        batches`); reads the losses back once into :attr:`loss_record` and
        returns the batch count."""
        self.cursor.zero_()
        n = 0
        for layout, host, _, _ in batches:
            self.load(layout, host)
            self.run("step", layout)
            self.state.step += 1
            n += 1
        self.loss_record = self._losses[:n].cpu().numpy()
        return n

    def evaluate(self, batches, graph_masks, labels):
        """The eval logits of ``batches``, [batches, B] numpy (one read);
        appends each batch's graph mask and labels to the two lists."""
        self.cursor.zero_()
        n = 0
        for layout, host, gm, lab in batches:
            self.load(layout, host)
            self.run("eval", layout)
            graph_masks.append(gm)
            labels.append(lab)
            n += 1
        return self._logits[:n].cpu().numpy()

    def launches(self):
        """Each kernel's device launches over the replays so far."""
        return graph_launches(self.graphs)
