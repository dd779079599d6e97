"""Command-line entry point of the port, as ``difformer_tpu/cli.py``: one
flag surface for the reference's ``main.py`` scripts, with the same flags,
presets and data path. It runs on the GPU.

Usage:
  python -m difformer_tpu_torch.cli --dataset cora --data_dir data
  python -m difformer_tpu_torch.cli --dataset cifar10 --kernel sigmoid
  python -m difformer_tpu_torch.cli --dataset synthetic-2000-8000-32-4
  python -m difformer_tpu_torch.cli --dataset chickenpox --method dcrnn
  python -m difformer_tpu_torch.cli --dataset actstrack --data_dir data

From Python, ``main(argv, device="cpu")`` runs on the CPU instead (every
kernel as its plain version), as the tests do.

Ported: full-batch node classification and the set track (``--task set``: a kNN
graph of the features) with ``--method difformer``, both kernels,
``--reorder``, the three split modes, ``--save_model`` and ``--eval_only``; and
mini-batch training on large graphs (``--use_minibatch``, which the pokec and
ogbn-proteins presets set) with ``MiniBatchTrainer``, routed as the JAX command
line routes it (its ``--save_model``, ``--eval_only`` and sparse-layout flags
are not read there); and the temporal track (``--task temporal``, which the
chickenpox, covid and wikimath presets set) with ``TemporalTrainer`` and
``--method difformer``, ``dcrnn`` or ``mpnn_lstm``, reading
torch_geometric_temporal's JSON files from ``--data_dir`` (a synthetic
stand-in, with a warning, where the file is missing, as the JAX command line
does); and the graph-level track (``--task graph``, which the actstrack,
tau3mu and synmol presets set) with DIFFormer-v2 and ``GraphLevelTrainer``,
reading a particle dataset's processed cache or raw files from
``--data_dir`` (512 synthetic small graphs, with a warning, where they are
missing, as the JAX command line does). ``--method dcrnn`` and
``mpnn_lstm`` build the temporal models on the node task too, as the JAX
command line does. The baseline zoo (``--method`` mlp, manireg, gcn, gat,
sgc, link, mixhop, gcnjk, gatjk, h2gcn, appnp, gprgnn) trains full-batch with
``FullBatchTrainer`` as DIFFormer does, and ``--method lp``/``multilp``
propagates labels and scores every split, per run, with no trainer.
``--n_shards N`` (N > 1) trains DIFFormer node-sharded over N ranks with
``DistributedTrainer`` (``--layout``, ``--balance_edges``; ``--kernel
sigmoid`` runs the ring attention, ``--spmm bsr`` the sharded block-sparse
hybrid at ``--bsr_tile``, any other ``--spmm`` the halo exchange), as
``difformer_tpu/cli.py:177-199`` does: ranks spawned on this machine (NCCL,
a card each, or the gloo backend asked for with ``main(...,
backend="gloo")``, which ``device="cpu"`` implies), or, where
``DIFFORMER_NUM_PROCESSES`` is set, this process as one rank of a cluster
(``parallel/launch.py:initialize_cluster``); only rank 0 prints. A zoo
method in mini-batch (``--use_minibatch``, which the pokec and
ogbn-proteins presets set) trains in node chunks with ``MiniBatchTrainer``
on the plan its model names, as the JAX command line hands it any model:
manireg there trains its MLP without the smoothness term (the JAX route
passes none), label propagation ignores the flag, and LINK raises
``ValueError`` before any data is read (its weight is indexed by the global
node id, which a chunk's relabelled edges cannot address; the JAX route
fails on it too). DIFFormer's GCN branch on the full-batch node task
takes the JAX command line's sparse layout: ``--spmm`` (or, when it is
empty, ``--use_ell``, on by default) picks the ELL layout (``ell``, the ELL
kernel K6), the padded block-sparse hybrid (``bsr``, at ``--bsr_tile``: the
block kernel K7 and K6), the bucketed hybrid after relabelling the nodes by
degree (``bsr-sorted``), or lets ``choose_spmm`` elect one from the graph
(``auto``); ``coo`` (or ``--use_ell false``) runs the CSR SpMM kernel K1.
Every other model, and the mini-batch route, runs K1. ``--eval_only``
reads a checkpoint the port wrote with ``--save_model``, or a reference
``.pt``/``.pth``/``.pkl`` state_dict; it does not read the JAX package's
orbax checkpoints.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from difformer_tpu_torch.data.graph import GraphData
from difformer_tpu_torch.data.loaders import load_dataset
from difformer_tpu_torch.data.transforms import (
    add_self_loops,
    knn_graph,
    locality_reorder,
    permute_graph,
    remove_self_loops,
    to_undirected,
)
from difformer_tpu_torch.data.particle import load_particle_dataset
from difformer_tpu_torch.data.splits import get_random_idx_split
from difformer_tpu_torch.data.synthetic import random_small_graphs
from difformer_tpu_torch.nn import gnns as Z
from difformer_tpu_torch.nn.difformer import DIFFormer
from difformer_tpu_torch.nn.difformer_v2 import DIFFormerV2, GraphLevelModel
from difformer_tpu_torch.nn.temporal import DCRNN, MPNNLSTM
from difformer_tpu_torch.ops.bsr import (
    build_bsr_bucketed_gcn,
    build_bsr_gcn,
    choose_spmm,
)
from difformer_tpu_torch.ops.ell import build_ell_gcn
from difformer_tpu_torch.parallel.launch import is_primary
from difformer_tpu_torch.train.graph_level import GraphLevelTrainer
from difformer_tpu_torch.train.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)
from difformer_tpu_torch.train.minibatch import MiniBatchTrainer
from difformer_tpu_torch.train.trainer import FullBatchTrainer
from difformer_tpu_torch.utils.config import Config, make_config
from difformer_tpu_torch.utils.logger import RunLogger
from difformer_tpu_torch.utils.metrics import METRICS
from difformer_tpu_torch.utils.weights import load_torch_checkpoint

# the baseline zoo's trained models, and label propagation (no parameters)
_ZOO = ("mlp", "manireg", "gcn", "gat", "sgc", "link", "mixhop", "gcnjk",
        "gatjk", "h2gcn", "appnp", "gprgnn")
_LP = ("lp", "multilp")
_PORTED_METHODS = ("difformer", "dcrnn", "mpnn_lstm") + _ZOO + _LP


def _zoo_model(cfg: Config, m, n_nodes, n_classes, in_channels, device):
    """The zoo model of ``--method m``, as ``difformer_tpu/cli.py:43-81``
    builds it, with the input width the port's modules need."""
    common = dict(hidden_channels=cfg.hidden_channels,
                  out_channels=n_classes, num_layers=cfg.num_layers,
                  dropout=cfg.dropout, seed=cfg.seed, device=device)
    if m in ("mlp", "manireg"):
        # manireg: the smoothness term is the trainer's (run_node_task)
        return Z.MLP(in_channels, **common)
    if m == "gcn":
        return Z.GCN(in_channels, **common, use_bn=cfg.use_bn)
    if m == "gat":
        return Z.GAT(in_channels, **common, use_bn=cfg.use_bn,
                     heads=cfg.gat_heads, out_heads=cfg.out_heads)
    if m == "sgc":
        return Z.SGC(in_channels, n_classes, hops=cfg.hops, seed=cfg.seed,
                     device=device)
    if m == "link":
        return Z.LINK(n_nodes, n_classes, seed=cfg.seed, device=device)
    if m == "mixhop":
        return Z.MixHop(in_channels, **common, hops=cfg.hops)
    if m == "gcnjk":
        return Z.GCNJK(in_channels, **common, jk_type=cfg.jk_type)
    if m == "gatjk":
        return Z.GATJK(in_channels, **common, heads=cfg.gat_heads,
                       jk_type=cfg.jk_type)
    if m == "h2gcn":
        return Z.H2GCN(in_channels, **common)
    if m == "appnp":
        return Z.APPNPNet(in_channels, cfg.hidden_channels, n_classes,
                          dropout=cfg.dropout, K=cfg.appnp_k,
                          alpha=cfg.gpr_alpha, seed=cfg.seed, device=device)
    # gprgnn: K stays the model's default, as the JAX command line leaves it
    return Z.GPRGNN(in_channels, cfg.hidden_channels, n_classes,
                    dropout=cfg.dropout, alpha=cfg.gpr_alpha, seed=cfg.seed,
                    device=device)


def parse_method(cfg: Config, n_nodes: int, n_classes: int,
                 in_channels: int, *, device=None):
    """The model of ``--method`` (``node classification/parse.py:4-10``,
    ``difformer_tpu/cli.py:25-82``): DIFFormer, a model of the baseline zoo,
    DCRNN (``K = --dcrnn_filters``) or MPNN-LSTM (a window of 1), each of
    which needs its input width."""
    m = cfg.method.lower()
    if m not in _PORTED_METHODS or m in _LP:
        raise ValueError(f"unknown method {cfg.method!r}")
    if m in _ZOO:
        return _zoo_model(cfg, m, n_nodes, n_classes, in_channels, device)
    if m == "dcrnn":
        return DCRNN(in_channels, cfg.hidden_channels, n_classes,
                     K=cfg.dcrnn_filters, seed=cfg.seed, device=device)
    if m == "mpnn_lstm":
        return MPNNLSTM(in_channels, cfg.hidden_channels, n_classes,
                        num_nodes=n_nodes, window=1, dropout=cfg.dropout,
                        seed=cfg.seed, device=device)
    return DIFFormer(
        in_channels, cfg.hidden_channels, n_classes,
        num_layers=cfg.num_layers, num_heads=cfg.num_heads,
        kernel=cfg.kernel, alpha=cfg.alpha, dropout=cfg.dropout,
        use_bn=cfg.use_bn, use_residual=cfg.use_residual,
        use_weight=cfg.use_weight, use_graph=cfg.use_graph,
        graph_weight=cfg.graph_weight, use_source=cfg.use_source,
        spmm_first=cfg.spmm_first, fuse_head_mean=cfg.fuse_head_mean,
        seed=cfg.seed, device=device)


BCE_DATASETS = {"yelp-chi", "deezer-europe", "twitch-e", "fb100",
                "ogbn-proteins"}  # main.py:119-125


def _check_ported(cfg: Config):
    """Raise for the routes of ``run_node_task`` that are not ported,
    before any data is read."""
    m = cfg.method.lower()
    if m not in _PORTED_METHODS:
        raise ValueError(f"unknown method {cfg.method!r}")
    if m in _LP:
        return  # the JAX command line reads no other flag on this route
    if cfg.n_shards > 1:
        if m != "difformer":
            # the JAX route hands any model to its DistributedTrainer: the
            # zoo's BatchNorm models and LINK fail there, and the others
            # train each shard on its own rows and halo table as if it were
            # the whole graph (ROADMAP.md queue C)
            raise ValueError(
                f"--n_shards > 1 trains --method difformer only, not "
                f"--method {cfg.method}")
        return
    if cfg.use_minibatch and m == "link":
        # the JAX route fails on it with a broadcast error
        raise ValueError(
            "--method link cannot train with --use_minibatch (the pokec and "
            "ogbn-proteins presets set it): LINK's weight is indexed by the "
            "global node id, which a chunk's edges, relabelled to positions "
            "in the chunk, cannot address")


def _restore(cfg: Config, trainer: FullBatchTrainer, split):
    """Metrics of the weights ``--eval_only`` names on ``split``
    (reference test_large_dataset.py:85-98)."""
    path = cfg.ckpt_path
    if path and os.path.splitext(path)[1] in (".pkl", ".pt", ".pth"):
        # a reference-layout torch state_dict
        res, _ = trainer.evaluate_params(load_torch_checkpoint(path), split)
        return res
    path = path or f"{cfg.model_dir}/{cfg.dataset}-{cfg.method}"
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory, as the JAX package's orbax checkpoints "
            f"are; the port reads only the checkpoint files it writes with "
            f"--save_model and reference .pt/.pth/.pkl state_dicts")
    state = trainer.init_state(0)
    state.model.load_state_dict(
        restore_checkpoint(path, map_location=trainer.device))
    res, _ = trainer.evaluate(state, split)
    return res


def _sparse_layout(cfg: Config, spmm, graph, x, label, ei, perm, device):
    """The GCN branch's layout of ``--spmm`` (``difformer_tpu/cli.py:
    214-254``): "auto" elects one with ``choose_spmm`` and prints it;
    "bsr-sorted" relabels the task by degree (composed with ``perm``, an
    earlier ``--reorder``) and builds the bucketed hybrid; "bsr" the padded
    hybrid at ``--bsr_tile``; anything else the ELL layout. Returns (layout,
    graph, x, label, ei, perm), the last five relabelled for
    "bsr-sorted"."""
    n = graph.num_nodes
    s, r = graph.senders.cpu().numpy(), graph.receivers.cpu().numpy()
    if spmm == "auto":
        spmm, cov = choose_spmm(s, r, n, tile=cfg.bsr_tile)
        print(f"spmm=auto: dense-tile coverage {cov:.2f} -> {spmm}")
    if spmm == "bsr-sorted":
        # hub clustering: the whole task relabelled once on the host
        p2 = locality_reorder(ei, n, method="degree")
        ei, x, label = permute_graph(p2, ei, x, label)
        perm = p2 if perm is None else p2[perm]
        graph = GraphData.from_numpy(x, ei, device=device)
        s, r = graph.senders.cpu().numpy(), graph.receivers.cpu().numpy()
        layout = build_bsr_bucketed_gcn(s, r, n, tile=cfg.bsr_tile)
    elif spmm == "bsr":
        layout = build_bsr_gcn(s, r, n, tile=cfg.bsr_tile)
    else:
        layout = build_ell_gcn(s, r, n)
    return layout, graph, x, label, ei, perm


def _backend(backend, device):
    """The backend of the ``--n_shards`` route: the caller's, else gloo for
    the CPU and NCCL (a card a rank) for the GPU."""
    if backend is not None:
        return backend
    if device is not None and torch.device(device).type == "cpu":
        return "gloo"
    return "nccl"


def run_sharded(cfg: Config, x, ei, label, n_classes, splits, loss,
                device=None, backend=None):
    """The ``--n_shards`` route: ``cfg.runs`` runs of ``DistributedTrainer``
    (``train/distributed.py:cli_rank``) on ``cfg.n_shards`` ranks, spawned
    here, or, where ``DIFFORMER_NUM_PROCESSES`` is set, this process as one
    rank of the cluster it names (which must hold ``cfg.n_shards`` ranks).
    Returns the summaries, which every rank holds alike."""
    from difformer_tpu_torch.parallel.launch import (initialize_cluster,
                                                     run_ranks)
    from difformer_tpu_torch.parallel.mesh import close_mesh
    from difformer_tpu_torch.train.distributed import cli_rank

    backend = _backend(backend, device)
    device = "cuda" if device is None else device
    args = (cfg, x, ei, label, n_classes, splits, loss)
    mesh = initialize_cluster(backend=backend, device=device)
    if mesh is None:
        return run_ranks(cli_rank, cfg.n_shards, backend, device, *args)[0]
    try:
        if mesh.size != cfg.n_shards:
            raise ValueError(f"--n_shards {cfg.n_shards} in a cluster of "
                             f"{mesh.size} processes")
        return cli_rank(mesh, *args)
    finally:
        close_mesh(mesh)


def run_node_task(cfg: Config, device=None, backend=None):
    """Load ``cfg.dataset``, preprocess its graph as the reference does and
    train (or, with ``eval_only``, evaluate) ``--method`` full-batch on
    ``device`` (the GPU unless told otherwise), or in node chunks with
    ``use_minibatch``, or node-sharded over ``--n_shards`` ranks on
    ``backend`` (:func:`run_sharded`); label propagation needs no
    training. Returns one summary per run."""
    _check_ported(cfg)
    ds = load_dataset(cfg.data_dir, cfg.dataset, cfg.sub_dataset)
    x = ds.graph["node_feat"]
    n = ds.graph["num_nodes"]
    label = np.asarray(ds.label)
    n_classes = (
        label.shape[1] if label.ndim > 1 and label.shape[1] > 1
        else int(label.max()) + 1
    )

    if cfg.task == "set" or ds.graph["edge_index"] is None:
        ei = knn_graph(x, cfg.knn_k, include_self=True)  # image-text/main.py:51-54
    else:
        ei = ds.graph["edge_index"]
    # reference main.py:71-76: only the symmetrisation is gated (skipped for
    # --directed and always for ogbn-proteins); self loops are removed and
    # added back in every case
    if not cfg.directed and cfg.dataset != "ogbn-proteins":
        ei = to_undirected(ei)
    ei, _ = remove_self_loops(ei)
    ei, _ = add_self_loops(ei, n)

    perm = None
    if cfg.reorder:
        # renumber the nodes so that neighbours sit close in memory
        perm = locality_reorder(ei, n, method=cfg.reorder)
        ei, x, label = permute_graph(perm, ei, x, label)

    loss = "bce" if cfg.dataset in BCE_DATASETS else "nll"
    method = cfg.method.lower()
    sharded = cfg.n_shards > 1 and method not in _LP
    model = (None if method in _LP or sharded
             else parse_method(cfg, n, n_classes, x.shape[1], device=device))
    logger = RunLogger(cfg.runs)

    def split_for(run):
        if cfg.rand_split_class:
            split = ds.get_idx_split(
                "class", label_num_per_class=cfg.label_num_per_class, rng=run)
        elif cfg.rand_split:
            split = ds.get_idx_split("random", cfg.train_prop,
                                     cfg.valid_prop, rng=run)
        else:
            try:
                fixed = ds.get_idx_split("fixed")
                split = (fixed[run % len(fixed)]
                         if isinstance(fixed, list) else fixed)
            except ValueError:
                split = ds.get_idx_split("random", cfg.train_prop,
                                         cfg.valid_prop, rng=run)
        if perm is not None:
            # the split's indices are in the original numbering
            split = {k: perm[np.asarray(v)] for k, v in split.items()}
        return split

    if method in _LP:
        # label propagation (reference MultiLP, gnns.py:203-253): no
        # parameters, so no trainer; propagate and score each run's split
        metric_fn = METRICS[cfg.metric]
        mult_bin = loss == "bce" and label.ndim > 1 and label.shape[1] > 1
        res = []
        for run in range(cfg.runs):
            split = split_for(run)
            out = Z.multi_lp(ei[0], ei[1], label, split["train"], n,
                             n_classes, alpha=cfg.lp_alpha, hops=cfg.hops,
                             mult_bin=mult_bin, device=device).cpu().numpy()
            r = {name: metric_fn(label[np.asarray(idx)], out[np.asarray(idx)])
                 for name, idx in split.items()}
            logger.add_result(run, (r["train"], r["valid"], r["test"]))
            res.append({**r, "epoch": 0})
        return _final(res)

    if sharded:
        # each rank builds its own model and trainer (train/distributed.py)
        res = run_sharded(cfg, x, ei, label, n_classes,
                          [split_for(run) for run in range(cfg.runs)], loss,
                          device=device, backend=backend)
        return _final(res) if is_primary() else res

    if cfg.use_minibatch:
        trainer = MiniBatchTrainer(
            model, x, ei, label, batch_size=cfg.batch_size, lr=cfg.lr,
            weight_decay=cfg.weight_decay, loss=loss, metric=cfg.metric,
            seed=cfg.seed, device=device)
        res = []
        for run in range(cfg.runs):
            res.extend(trainer.fit(split_for(run), epochs=cfg.epochs, runs=1,
                                   eval_step=cfg.eval_step, logger=logger,
                                   verbose=True))
        return _final(res)

    graph = GraphData.from_numpy(x, ei, device=device)
    ell = None
    spmm = cfg.spmm or ("ell" if cfg.use_ell else "coo")
    if spmm != "coo" and method == "difformer" and cfg.use_graph:
        ell, graph, x, label, ei, perm = _sparse_layout(
            cfg, spmm, graph, x, label, ei, perm, device)
    trainer = FullBatchTrainer(
        model, graph, label, lr=cfg.lr, weight_decay=cfg.weight_decay,
        loss=loss, metric=cfg.metric, seed=cfg.seed,
        model_kwargs={"ell": ell} if ell is not None else None,
        manireg=cfg.manireg if method == "manireg" else 0.0, device=device)
    if cfg.eval_only:
        res = _restore(cfg, trainer, split_for(0))
        print(f"Eval-only: {res}")
        return [res]
    res = []
    for run in range(cfg.runs):
        r = trainer.fit(split_for(run), epochs=cfg.epochs, runs=1,
                        logger=logger, eval_step=cfg.eval_step,
                        verbose=True, display_step=cfg.display_step,
                        print_prop=cfg.print_prop,
                        save_best=cfg.save_model,
                        epoch_block=cfg.epoch_block)
        if cfg.save_model and r[-1].get("params") is not None:
            save_checkpoint(f"{cfg.model_dir}/{cfg.dataset}-{cfg.method}",
                            r[-1].pop("params"))
        res.extend(r)
    return _final(res)


def run_temporal_task(cfg: Config, device=None):
    """The temporal track (``difformer_tpu/cli.py:306-339``): the dataset's
    snapshots (or the synthetic stand-in), split in time, and ``runs``
    runs of ``TemporalTrainer`` on ``device`` (the GPU unless told
    otherwise). Returns the runs' test costs."""
    from difformer_tpu_torch.data.synthetic import random_temporal_sequence
    from difformer_tpu_torch.data.temporal_loaders import (
        load_temporal_dataset,
    )
    from difformer_tpu_torch.train.temporal import (
        TemporalTrainer,
        temporal_signal_split,
    )

    if cfg.method.lower() not in _PORTED_METHODS:
        raise ValueError(f"unknown method {cfg.method!r}")
    if cfg.dataset.startswith("synthetic"):
        snaps = random_temporal_sequence(20, 100, 4, seed=cfg.seed)
    else:
        try:
            snaps = load_temporal_dataset(cfg.dataset, cfg.data_dir)
        except (FileNotFoundError, ValueError) as e:
            print(f"[warn] {e}; using synthetic temporal stand-in")
            snaps = random_temporal_sequence(20, 100, 4, seed=cfg.seed)
    train, vt = temporal_signal_split(snaps, cfg.train_ratio)
    val, test = temporal_signal_split(
        vt, cfg.val_ratio / (1 - cfg.train_ratio))
    mode = ("incremental" if cfg.temporal_mode == "incremental"
            or (cfg.temporal_mode == "auto" and cfg.dataset == "wikimath")
            else "cumulative")
    n, f = snaps[0].node_feat.shape
    model = parse_method(cfg, n, 1, f, device=device)
    costs = []
    for run in range(cfg.runs):
        tr = TemporalTrainer(model, lr=cfg.lr, weight_decay=cfg.weight_decay,
                             mode=mode, rebuild=cfg.special_treat.lower(),
                             seed=cfg.seed, device=device)
        r = tr.fit(train, val, test, epochs=cfg.epochs,
                   early_stopping=cfg.early_stopping, run=run, verbose=True,
                   display_step=cfg.display_step)
        print(f"Test Cost: {r['test']:.4f}")
        costs.append(r["test"])
    costs = np.asarray(costs)
    print(f"Final Test: {costs.mean():.4f} ± {costs.std():.4f}")
    return costs


PARTICLE_DATASETS = ("actstrack", "tau3mu", "synmol", "plbind")


def run_graph_task(cfg: Config, device=None):
    """The graph-level track (``--task graph``, which the actstrack, tau3mu
    and synmol presets set), as the JAX command line runs it
    (``difformer_tpu/cli.py:344-385``): a particle dataset from
    ``<data_dir>/<dataset>`` (its processed cache or raw files) with its
    own split, or, where it is missing (with a ``[warn]`` line) and for any
    other dataset, 512 synthetic small graphs split 70/15/15; DIFFormer-v2
    with the pooling head; ``GraphLevelTrainer`` at a batch of at most 64
    (the JAX command line's clamp). Prints and returns each run's
    summary."""
    split = None
    if cfg.dataset in PARTICLE_DATASETS:
        config_path = os.path.join("configs", f"{cfg.dataset}.yml")
        try:
            ds = load_particle_dataset(
                cfg.dataset, os.path.join(cfg.data_dir, cfg.dataset),
                config_path=(config_path if os.path.exists(config_path)
                             else None),
                seed=cfg.seed)
            graphs = ds.graphs
            split = ds.get_idx_split()
        except (FileNotFoundError, ImportError) as e:
            print(f"[warn] {e}; using synthetic stand-in graphs")
            graphs = random_small_graphs(512, seed=cfg.seed)
    else:
        graphs = random_small_graphs(512, seed=cfg.seed)
    enc = DIFFormerV2(
        graphs[0][0].shape[1], cfg.hidden_channels, cfg.hidden_channels,
        num_layers=cfg.num_layers, kernel=cfg.kernel, alpha=cfg.alpha,
        dropout=cfg.dropout, use_bn=cfg.use_bn,
        use_residual=cfg.use_residual, use_weight=cfg.use_weight,
        use_graph=cfg.use_graph, graph_weight=cfg.graph_weight,
        device=device)
    model = GraphLevelModel(enc, out_channels=1,
                            graph_pooling=cfg.graph_pooling, device=device)
    tr = GraphLevelTrainer(model, graphs, batch_size=min(cfg.batch_size, 64),
                           lr=cfg.lr, weight_decay=cfg.weight_decay,
                           metric=cfg.metric, seed=cfg.seed, device=device)
    if split is None:
        split = get_random_idx_split(len(graphs), 0.7, 0.15, rng=cfg.seed)
    res = tr.fit(split, epochs=cfg.epochs, runs=cfg.runs, verbose=True)
    tests = np.asarray([r["test"] for r in res])
    print(f"Final Test: {tests.mean():.4f} ± {tests.std():.4f}")
    return res


def _final(res):
    """Print the runs' mean and spread of the test metric; returns them."""
    tests = np.asarray([r["test"] for r in res])
    print(f"Final Test: {100 * tests.mean():.2f} ± {100 * tests.std():.2f}")
    return res


def _tri_state(s):
    """'auto' or a bool-like string, for spmm_first and fuse_head_mean."""
    s = s.lower()
    if s == "auto":
        return "auto"
    return s in ("1", "true", "yes")


def build_parser():
    p = argparse.ArgumentParser(
        description="difformer_tpu_torch command line (DIFFormer on the GPU)",
        epilog="--eval_only reads a checkpoint written by --save_model or a "
               "reference .pt/.pth/.pkl state_dict (--ckpt_path); the JAX "
               "package's orbax checkpoints are not read.")
    for f in dataclasses.fields(Config):
        arg = "--" + f.name
        if f.name in ("spmm_first", "fuse_head_mean"):
            p.add_argument(arg, type=_tri_state, default=None)
        elif f.type == "bool" or isinstance(f.default, bool):
            p.add_argument(arg, type=lambda s: s.lower() in ("1", "true", "yes"),
                           default=None)
        elif f.default is None or f.type == "Optional[int]":
            p.add_argument(arg, type=int, default=None)
        elif isinstance(f.default, int):
            p.add_argument(arg, type=int, default=None)
        elif isinstance(f.default, float):
            p.add_argument(arg, type=float, default=None)
        else:
            p.add_argument(arg, type=str, default=None)
    return p


def main(argv=None, *, device=None, backend=None):
    """Parse ``argv`` (the process's arguments when None), apply the
    dataset's preset and run it on ``device`` (the GPU unless told
    otherwise); ``backend`` ("nccl" or "gloo") is the ``--n_shards``
    route's (:func:`run_sharded`)."""
    args = build_parser().parse_args(argv)
    overrides = {k: v for k, v in vars(args).items() if v is not None}
    dataset = overrides.pop("dataset", "cora")
    cfg = make_config(dataset, **overrides)
    if is_primary():
        print(cfg)
    if cfg.task == "temporal":
        return run_temporal_task(cfg, device=device)
    if cfg.task == "graph":
        return run_graph_task(cfg, device=device)
    return run_node_task(cfg, device=device, backend=backend)


if __name__ == "__main__":
    main()
