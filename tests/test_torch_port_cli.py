"""The port's command line (difformer_tpu_torch/cli.py) against the JAX
package's: the same presets and flags, a golden synthetic run with the JAX
test's floor, exactly what each CLI hands its trainer (features, edges,
labels, each run's split and the fit options) on the same files, the
baseline zoo's routes (what a zoo trainer is handed, label propagation's
metrics, every zoo method trained on the CPU), the sparse layouts of the GCN
branch (the layout each CLI hands its trainer, bit for bit), what the
``--n_shards`` route hands its distributed trainer on the ring and the
block-sparse hybrid (``--kernel sigmoid``, ``--spmm bsr``), the zoo in
mini-batch (what its trainer is handed, a run of each chunk plan kind, and
LINK's ``ValueError``, the one route refused), and the
``--save_model``/``--eval_only`` round trip, also from a reference ``.pt``
state_dict.
"""

import dataclasses
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import difformer_tpu.train as jax_train
from difformer_tpu import cli as jax_cli
from difformer_tpu.utils import config as jax_config
from difformer_tpu_torch import DIFFormer, cli
from difformer_tpu_torch.utils import config

import chip_smoke
import torch_port_helpers  # noqa: F401  (sets torch's threads)

CPU = dict(device="cpu")


def test_presets_and_defaults_match_the_jax_package():
    assert set(config.PRESETS) == set(jax_config.PRESETS)
    for name in list(config.PRESETS) + ["synthetic-10-20-3-2"]:
        assert (dataclasses.asdict(config.make_config(name))
                == dataclasses.asdict(jax_config.make_config(name))), name
    cfg = config.make_config("cora", num_layers=2)
    assert cfg.num_layers == 2 and cfg.hidden_channels == 64


def test_parser_takes_the_jax_package_flags():
    ours = {a.dest: a for a in cli.build_parser()._actions}
    theirs = {a.dest: a for a in jax_cli.build_parser()._actions}
    assert set(ours) == set(theirs)
    argv = ["--dataset", "cora", "--epochs", "7", "--lr", "0.5",
            "--use_bn", "false", "--spmm_first", "auto", "--reorder", "rcm",
            "--fuse_head_mean", "yes", "--max_nodes", "9"]
    assert (vars(cli.build_parser().parse_args(argv))
            == vars(jax_cli.build_parser().parse_args(argv)))


def test_help_names_what_eval_only_reads():
    proc = subprocess.run([sys.executable, "-m", "difformer_tpu_torch.cli",
                           "--help"], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "orbax" in proc.stdout and "--eval_only" in proc.stdout


def test_golden_fixed_seed_accuracy():
    """As the JAX package's test_golden_fixed_seed_accuracy, with its
    floor."""
    res = cli.main([
        "--dataset", "synthetic-500-2000-16-3", "--epochs", "40", "--runs",
        "1", "--rand_split", "true", "--hidden_channels", "16", "--seed",
        "123", "--dropout", "0.0", "--display_step", "100",
    ], **CPU)
    assert res[0]["test"] >= 0.9, res


def test_golden_sigmoid_kernel_accuracy():
    """As the JAX package's test_golden_sigmoid_kernel_accuracy, with its
    floor."""
    res = cli.main([
        "--dataset", "synthetic-400-1600-16-3", "--epochs", "40", "--runs",
        "1", "--rand_split", "true", "--kernel", "sigmoid",
        "--hidden_channels", "16", "--seed", "123", "--dropout", "0.0",
        "--display_step", "100",
    ], **CPU)
    assert res[0]["test"] >= 0.85, res


def test_without_device_it_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--dataset", "synthetic-50-100-4-2", "--epochs", "1"])


# --------------------------------------------------------------------------
# what each CLI hands its trainer
# --------------------------------------------------------------------------

class Recorder:
    """A stand-in trainer that keeps what it is given."""

    def __init__(self, model, graph, labels, **kw):
        self.graph, self.labels, self.kw = graph, np.asarray(labels), kw
        self.splits, self.fits = [], []
        self.made.append(self)

    def fit(self, split_idx, **kw):
        self.splits.append({k: np.asarray(v) for k, v in split_idx.items()})
        self.fits.append({k: kw[k] for k in ("epochs", "runs", "eval_step",
                                              "save_best", "epoch_block",
                                              "print_prop")})
        return [{"train": 0.5, "valid": 0.5, "test": 0.5, "epoch": 0}]


def recorders(monkeypatch):
    ours = type("OurRecorder", (Recorder,), {"made": []})
    theirs = type("TheirRecorder", (Recorder,), {"made": []})
    monkeypatch.setattr(cli, "FullBatchTrainer", ours)
    monkeypatch.setattr(jax_train, "FullBatchTrainer", theirs)
    return ours, theirs


def assert_same_hand_over(ours, theirs):
    assert len(ours.made) == len(theirs.made) == 1
    a, b = ours.made[0], theirs.made[0]
    np.testing.assert_array_equal(a.graph.node_feat.numpy(),
                                  np.asarray(b.graph.node_feat))
    np.testing.assert_array_equal(a.graph.senders.numpy(),
                                  np.asarray(b.graph.senders))
    np.testing.assert_array_equal(a.graph.receivers.numpy(),
                                  np.asarray(b.graph.receivers))
    assert a.graph.num_nodes == b.graph.num_nodes
    assert a.labels.dtype == b.labels.dtype
    np.testing.assert_array_equal(a.labels, b.labels)
    for key in ("lr", "weight_decay", "loss", "metric", "seed"):
        assert a.kw[key] == b.kw[key], key
    assert len(a.splits) == len(b.splits) > 0
    for sa, sb in zip(a.splits, b.splits):
        assert set(sa) == set(sb)
        for k in sa:
            np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)
    assert a.fits == b.fits


def run_both(monkeypatch, argv):
    ours, theirs = recorders(monkeypatch)
    res = cli.main(argv, **CPU)
    ref = jax_cli.main(argv)
    assert_same_hand_over(ours, theirs)
    assert len(res) == len(ref)
    return ours.made[0]


@pytest.fixture
def cora_dir(tmp_path):
    chip_smoke.write_planetoid_cora(str(tmp_path), num_nodes=300,
                                    num_edges=900, feat_dim=24)
    return str(tmp_path)


@pytest.mark.parametrize("extra", [
    [], ["--reorder", "rcm"], ["--reorder", "degree"], ["--reorder", "bfs"],
    ["--reorder", "community"], ["--directed", "true"],
    ["--rand_split", "true", "--rand_split_class", "false"],
    ["--rand_split_class", "false"],  # the dataset's fixed split
])
def test_node_task_hands_the_same_data(monkeypatch, cora_dir, extra):
    run_both(monkeypatch, ["--dataset", "cora", "--data_dir", cora_dir,
                           "--runs", "3"] + extra)


def test_fixed_split_lists_cycle_through_runs(monkeypatch, tmp_path):
    n = 40
    rng = np.random.default_rng(8)
    (tmp_path / "heterophilous").mkdir()
    masks = rng.random((3, 10, n)) > 0.5
    np.savez(tmp_path / "heterophilous" / "roman_empire.npz",
             edges=rng.integers(0, n, (120, 2)),
             node_features=rng.random((n, 5)).astype(np.float32),
             node_labels=rng.integers(0, 3, n), train_masks=masks[0],
             val_masks=masks[1], test_masks=masks[2])
    made = run_both(monkeypatch, ["--dataset", "roman-empire", "--data_dir",
                                  str(tmp_path), "--runs", "12",
                                  "--reorder", "rcm"])
    assert len(made.splits) == 12


@pytest.mark.parametrize("extra", [[], ["--reorder", "rcm"]])
def test_set_task_hands_the_same_knn_graph(monkeypatch, tmp_path, extra):
    x, y = chip_smoke.cifar10_embeddings(num=300, dim=16, classes=10)
    chip_smoke.write_cifar10_embeddings(str(tmp_path), x, y)
    made = run_both(monkeypatch, ["--dataset", "cifar10", "--data_dir",
                                  str(tmp_path), "--runs", "2"] + extra)
    assert made.graph.num_edges > 300 * 5  # kNN, symmetrised, self loops


def test_edgeless_dataset_gets_a_knn_graph(monkeypatch, tmp_path):
    rng = np.random.default_rng(2)
    with open(tmp_path / "stl10_embeddings.pkl", "wb") as f:
        pickle.dump((rng.normal(size=(80, 6)), rng.integers(0, 4, 80)), f)
    run_both(monkeypatch, ["--dataset", "stl10", "--data_dir", str(tmp_path),
                           "--task", "node", "--knn_k", "3"])


def test_bce_datasets_use_bce(monkeypatch, tmp_path):
    from scipy.io import savemat
    import scipy.sparse as sp

    n = 30
    rng = np.random.default_rng(3)
    savemat(tmp_path / "YelpChi.mat", {
        "homo": sp.random(n, n, density=0.2, format="csc", random_state=3),
        "features": sp.csr_matrix(rng.random((n, 4))),
        "label": rng.integers(0, 2, (1, n))})
    made = run_both(monkeypatch, ["--dataset", "yelp-chi", "--data_dir",
                                  str(tmp_path), "--rand_split", "true"])
    assert made.kw["loss"] == "bce"


# --------------------------------------------------------------------------
# routes refused
# --------------------------------------------------------------------------

@pytest.mark.parametrize("extra,error,match", [
    # LINK's weight is indexed by global node ids, which a chunk's edges
    # cannot address: refused before the (missing) data is read
    (["--dataset", "pokec", "--method", "link"], ValueError,
     "global node id"),
])
def test_unported_routes_raise_naming_their_item(tmp_path, extra, error,
                                                 match):
    argv = ["--dataset", "synthetic-60-200-4-3", "--epochs", "1",
            "--data_dir", str(tmp_path)] + extra
    with pytest.raises(error, match=match):
        cli.main(argv, **CPU)


class DistRecorder:
    """A stand-in distributed trainer of either package that keeps what it
    is given (the JAX one also gets the axis-free init model)."""

    made = []

    def __init__(self, model, *args, **kw):
        if len(args) == 4:      # the JAX trainer: init model first
            args = args[1:]
        x, ei, labels = args
        self.kernel = getattr(model, "kernel", None)
        self.x, self.ei, self.labels = (np.asarray(a) for a in (x, ei,
                                                                  labels))
        self.kw = kw
        self.made.append(self)

    def fit(self, split_idx, **kw):
        self.split = {k: np.asarray(v) for k, v in split_idx.items()}
        self.fit_kw = {k: kw[k] for k in ("epochs", "runs", "eval_step")}
        return [{"train": 0.5, "valid": 0.5, "test": 0.5, "epoch": 0}]


@pytest.mark.parametrize("extra", [
    ["--kernel", "sigmoid", "--n_shards", "2"],
    ["--spmm", "bsr", "--n_shards", "2"],
    ["--use_minibatch", "true", "--kernel", "sigmoid", "--n_shards", "2"],
    ["--spmm", "bsr", "--n_shards", "4", "--bsr_tile", "32"],
])
def test_sharded_route_hands_the_same_trainer_options(monkeypatch, tmp_path,
                                                      extra):
    """The ``--n_shards`` routes of the ring and the block-sparse hybrid:
    each CLI's distributed trainer gets the same data, split, options and
    fit options, and the same ``spmm``, ``bsr_tile`` and model kernel
    (the port's rank function run in this process on a stand-in mesh,
    with the trainer and the model recorded)."""
    import types

    import difformer_tpu.train.distributed as jax_dist
    from difformer_tpu_torch.nn import difformer as nn_difformer
    from difformer_tpu_torch.train import distributed as dist

    ours = type("OurDist", (DistRecorder,), {"made": []})
    theirs = type("TheirDist", (DistRecorder,), {"made": []})

    def model(*args, **kw):
        return types.SimpleNamespace(kernel=kw["kernel"])

    def run_sharded(cfg, x, ei, label, n_classes, splits, loss, device=None,
                    backend=None):
        mesh = types.SimpleNamespace(group=object(), rank=0, size=2,
                                     device=torch.device("cpu"))
        return dist.cli_rank(mesh, cfg, x, ei, label, n_classes, splits,
                             loss)

    monkeypatch.setattr(dist, "DistributedTrainer", ours)
    monkeypatch.setattr(nn_difformer, "DIFFormer", model)
    monkeypatch.setattr(cli, "run_sharded", run_sharded)
    monkeypatch.setattr(jax_dist, "DistributedTrainer", theirs)
    argv = ["--dataset", "synthetic-60-200-4-3", "--epochs", "1",
            "--data_dir", str(tmp_path), "--runs", "2",
            "--rand_split", "true"] + extra
    cli.main(argv, **CPU)
    jax_cli.main(argv)
    assert len(ours.made) == len(theirs.made) == 2
    for a, b in zip(ours.made, theirs.made):
        for name in ("x", "ei", "labels"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                          err_msg=name)
        for key in ("lr", "weight_decay", "loss", "metric", "seed", "spmm",
                    "bsr_tile", "layout", "balance_edges"):
            assert a.kw[key] == b.kw[key], key
        assert a.kernel == b.kernel == (
            "sigmoid" if "sigmoid" in extra else "simple")
        assert a.kw["spmm"] == ("bsr" if "bsr" in extra else "halo")
        assert set(a.split) == set(b.split)
        for k in a.split:
            np.testing.assert_array_equal(a.split[k], b.split[k], err_msg=k)
        assert a.fit_kw == b.fit_kw


def test_sharded_route_runs_on_the_card_or_asks_for_the_cpu(monkeypatch):
    # --n_shards > 1 never trains on the CPU unasked: without a card it
    # raises naming device='cpu'; NCCL on the CPU raises too
    argv = ["--dataset", "synthetic-60-200-4-3", "--epochs", "1",
            "--n_shards", "2"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(argv)
    with pytest.raises(ValueError, match="CUDA devices"):
        cli.main(argv, device="cpu", backend="nccl")


def test_sharded_route_with_more_nccl_ranks_than_cards_raises(monkeypatch):
    # NCCL takes a card a rank; with fewer cards the route raises naming
    # the gloo backend instead of switching to it
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match='backend="gloo"'):
        cli.main(["--dataset", "synthetic-60-200-4-3", "--epochs", "1",
                  "--n_shards", "2"])


@pytest.mark.parametrize("method", ["gcn", "sgc", "mlp"])
def test_sharded_route_trains_difformer_only(method):
    # the JAX route fails for the zoo's BatchNorm models and trains the
    # others shard by shard as if each were the whole graph
    with pytest.raises(ValueError, match="--method difformer only"):
        cli.main(["--dataset", "synthetic-60-200-4-3", "--epochs", "1",
                  "--method", method, "--n_shards", "2"], **CPU)


# --------------------------------------------------------------------------
# the sparse layouts of the GCN branch (--use_ell, --spmm, --bsr_tile)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("extra,layout", [
    ([], "ell"), (["--use_ell", "true"], "ell"), (["--spmm", "ell"], "ell"),
    (["--spmm", "bsr", "--bsr_tile", "64"], "bsr"),
    (["--spmm", "auto", "--bsr_tile", "64"], "bsr"),
    (["--spmm", "bsr-sorted", "--bsr_tile", "64"], "bsr-bucketed"),
    (["--spmm", "bsr-sorted", "--reorder", "rcm", "--bsr_tile", "64"],
     "bsr-bucketed"),
    (["--spmm", "coo"], None), (["--use_ell", "false"], None),
    (["--method", "gcn", "--spmm", "bsr"], None),
])
def test_sparse_layout_hands_the_same_layout(monkeypatch, cora_dir, extra,
                                             layout):
    """The JAX command line's route (difformer_tpu/cli.py:214-259): each
    CLI hands its trainer the same graph, splits (relabelled by degree for
    bsr-sorted, after any --reorder) and ``model_kwargs["ell"]``, bit for
    bit; the port's cost model set to the JAX package's for --spmm auto."""
    from difformer_tpu.ops import bsr as JB
    from difformer_tpu_torch.ops import bsr as B
    from difformer_tpu_torch.ops.ell import EllGraph
    from test_torch_port_bsr import _assert_same_direction
    from test_torch_port_ell import _assert_same_layout

    monkeypatch.setattr(B, "_EDGE_EQUIV_BYTES", JB._EDGE_EQUIV_BYTES)
    made = run_both(monkeypatch, ["--dataset", "cora", "--data_dir",
                                  cora_dir] + extra)
    theirs = jax_train.FullBatchTrainer.made[0]
    ours = (made.kw.get("model_kwargs") or {}).get("ell")
    ref = (theirs.kw.get("model_kwargs") or {}).get("ell")
    if layout is None:
        assert ours is None and ref is None
        return
    kind = {"ell": EllGraph, "bsr": B.BsrDirection,
            "bsr-bucketed": B.BsrBuckets}[layout]
    assert all(isinstance(d, kind) for d in ours)
    for d, jd in zip(ours, ref):
        if layout == "ell":
            _assert_same_layout(jd, d)
        else:
            _assert_same_direction(jd, d)


@pytest.mark.parametrize("extra", [[], ["--spmm", "bsr", "--bsr_tile", "64"],
                                   ["--spmm", "bsr-sorted", "--bsr_tile",
                                    "64"]])
def test_sparse_layouts_train_on_the_cpu(extra):
    """The default ELL route and the block-sparse ones end to end (the
    JAX test's golden floor)."""
    res = cli.main([
        "--dataset", "synthetic-500-2000-16-3", "--epochs", "40", "--runs",
        "1", "--rand_split", "true", "--hidden_channels", "16", "--seed",
        "123", "--dropout", "0.0", "--display_step", "100"] + extra, **CPU)
    assert res[0]["test"] >= 0.9, res


def test_spmm_auto_prints_its_election(capsys, cora_dir):
    cli.main(["--dataset", "cora", "--data_dir", cora_dir, "--epochs", "2",
              "--runs", "1", "--spmm", "auto"], **CPU)
    assert "spmm=auto: dense-tile coverage" in capsys.readouterr().out


# --------------------------------------------------------------------------
# the baseline zoo and label propagation
# --------------------------------------------------------------------------

ZOO_METHODS = ["mlp", "manireg", "gcn", "gat", "sgc", "link", "mixhop",
               "gcnjk", "gatjk", "h2gcn", "appnp", "gprgnn", "lp",
               "multilp"]


@pytest.mark.parametrize("method", ["gcn", "gat", "manireg"])
def test_zoo_method_hands_the_same_data(monkeypatch, cora_dir, method):
    """A zoo method's trainer gets what the JAX command line hands its own,
    ManiReg's smoothness weight included."""
    made = run_both(monkeypatch, ["--dataset", "cora", "--data_dir",
                                  cora_dir, "--method", method, "--runs",
                                  "2"])
    theirs = jax_train.FullBatchTrainer.made[0]
    assert made.kw["manireg"] == theirs.kw["manireg"]
    assert made.kw["manireg"] == (1.0 if method == "manireg" else 0.0)


@pytest.mark.parametrize("extra", [[], ["--hops", "2", "--lp_alpha",
                                        "0.5"]])
@pytest.mark.parametrize("method", ["lp", "multilp"])
def test_label_propagation_gives_the_jax_metrics(cora_dir, method, extra):
    argv = ["--dataset", "cora", "--data_dir", cora_dir, "--method",
            method, "--runs", "2", "--rand_split", "true"] + extra
    ours, theirs = cli.main(argv, **CPU), jax_cli.main(argv)
    assert len(ours) == len(theirs) == 2
    for a, b in zip(ours, theirs):
        assert a == pytest.approx(b, abs=1e-9)


def test_label_propagation_on_binary_tasks(monkeypatch, tmp_path):
    """A BCE dataset with several binary tasks propagates two columns a
    task (``mult_bin``), as the JAX route does."""
    from difformer_tpu.data.graph import NodeDataset as JNodeDataset
    from difformer_tpu_torch.data.graph import NodeDataset

    rng = np.random.default_rng(6)
    n = 80
    x = rng.normal(size=(n, 5)).astype(np.float32)
    ei = np.stack([rng.integers(0, n, 300), rng.integers(0, n, 300)])
    y = (rng.random((n, 3)) < 0.4).astype(np.int64)

    def fake(loader_cls):
        def load(*a, **k):
            ds = loader_cls("ogbn-proteins")
            ds.graph = {"node_feat": x, "edge_index": ei, "num_nodes": n,
                        "edge_feat": None}
            ds.label = y
            return ds
        return load

    monkeypatch.setattr(cli, "load_dataset", fake(NodeDataset))
    import difformer_tpu.data.loaders as jax_loaders
    monkeypatch.setattr(jax_loaders, "load_dataset", fake(JNodeDataset))
    argv = ["--dataset", "ogbn-proteins", "--method", "lp",
            "--use_minibatch", "false", "--rand_split", "true"]
    ours, theirs = cli.main(argv, **CPU), jax_cli.main(argv)
    for a, b in zip(ours, theirs):
        assert a == pytest.approx(b, abs=1e-9)


@pytest.mark.parametrize("method", ZOO_METHODS)
def test_every_zoo_method_runs_on_the_cpu(method):
    res = cli.main(["--dataset", "synthetic-120-480-8-3", "--method",
                    method, "--epochs", "4", "--runs", "1", "--rand_split",
                    "true", "--hidden_channels", "8", "--display_step",
                    "100"], **CPU)
    assert len(res) == 1 and 0.0 <= res[0]["test"] <= 1.0


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="unknown method"):
        cli.main(["--dataset", "synthetic-60-200-4-3", "--method", "nope"],
                 **CPU)


def test_sweep_runs_zoo_methods(tmp_path):
    from difformer_tpu_torch.sweep import run_sweep

    rows = run_sweep("synthetic-60-200-4-3",
                     {"method": ["sgc", "lp"], "weight_decay": [0.0]},
                     base_overrides={"epochs": 3, "rand_split": True},
                     result_dir=str(tmp_path), **CPU)
    assert [r["method"] for r in rows] == ["sgc", "lp"]
    assert (tmp_path / "synthetic-60-200-4-3" / "sgc.csv").exists()


# --------------------------------------------------------------------------
# save, and evaluate what was saved
# --------------------------------------------------------------------------

COMMON = ["--dataset", "synthetic-120-480-8-3", "--rand_split", "true",
          "--hidden_channels", "8", "--num_layers", "2", "--display_step",
          "100", "--epochs", "6", "--runs", "1"]


def test_save_model_then_eval_only(tmp_path):
    saved = cli.main(COMMON + ["--save_model", "true", "--model_dir",
                               str(tmp_path)], **CPU)
    path = tmp_path / "synthetic-120-480-8-3-difformer"
    assert path.is_file()
    got = cli.main(COMMON + ["--eval_only", "true", "--model_dir",
                             str(tmp_path)], **CPU)
    best = saved[-1]
    assert "params" not in best
    for split in ("train", "valid", "test"):
        assert got[0][split] == best[split], split


@pytest.mark.parametrize("method", ["gcn", "gat"])
def test_save_model_then_eval_only_of_a_zoo_model(tmp_path, method):
    """The saved best state carries GCN's BatchNorm statistics, so
    ``--eval_only`` gives the saved run's metrics (the JAX command line
    saves only the params, ROADMAP.md queue C)."""
    argv = COMMON + ["--method", method, "--model_dir", str(tmp_path)]
    saved = cli.main(argv + ["--save_model", "true"], **CPU)
    got = cli.main(argv + ["--eval_only", "true"], **CPU)
    for split in ("train", "valid", "test"):
        assert got[0][split] == saved[-1][split], split


def test_eval_only_refuses_an_orbax_directory(tmp_path):
    (tmp_path / "synthetic-120-480-8-3-difformer").mkdir()
    with pytest.raises(ValueError, match="orbax"):
        cli.main(COMMON + ["--eval_only", "true", "--model_dir",
                           str(tmp_path)], **CPU)


@pytest.mark.parametrize("suffix", [".pt", ".pkl"])
def test_eval_only_reads_a_reference_state_dict(tmp_path, suffix):
    """A reference-layout state_dict, evaluated by both CLIs: the same
    metrics."""
    model = DIFFormer(8, 8, 3, num_layers=2, seed=5, device="cpu")
    path = str(tmp_path / f"reference{suffix}")
    torch.save(model.state_dict(), path)
    argv = COMMON + ["--eval_only", "true", "--ckpt_path", path]
    got = cli.main(argv, **CPU)[0]
    ref = jax_cli.main(argv)[0]
    assert set(got) == set(ref) == {"train", "valid", "test"}
    for split in got:
        assert got[split] == pytest.approx(float(ref[split]), abs=1e-12)


# --------------------------------------------------------------------------
# --use_minibatch: the pokec and ogbn-proteins presets
# --------------------------------------------------------------------------

class MiniBatchRecorder:
    """A stand-in MiniBatchTrainer that keeps what it is given."""

    def __init__(self, model, node_feat, edge_index, labels, **kw):
        self.model = type(model).__name__
        self.x, self.ei = np.asarray(node_feat), np.asarray(edge_index)
        self.labels, self.kw = np.asarray(labels), kw
        self.splits, self.fits = [], []
        self.made.append(self)

    def fit(self, split_idx, **kw):
        self.splits.append({k: np.asarray(v) for k, v in split_idx.items()})
        # each package's own RunLogger
        assert type(kw.pop("logger")).__name__ == "RunLogger"
        self.fits.append(kw)
        return [{"train": 0.5, "valid": 0.5, "test": 0.5, "epoch": 0}]


def run_both_minibatch(monkeypatch, argv):
    import difformer_tpu.train.minibatch as jax_minibatch

    ours = type("OurMiniBatch", (MiniBatchRecorder,), {"made": []})
    theirs = type("TheirMiniBatch", (MiniBatchRecorder,), {"made": []})
    monkeypatch.setattr(cli, "MiniBatchTrainer", ours)
    monkeypatch.setattr(jax_minibatch, "MiniBatchTrainer", theirs)
    res = cli.main(argv, **CPU)
    ref = jax_cli.main(argv)
    assert len(res) == len(ref)
    assert len(ours.made) == len(theirs.made) == 1
    a, b = ours.made[0], theirs.made[0]
    assert a.model == b.model
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.ei, b.ei)
    assert a.labels.dtype == b.labels.dtype
    np.testing.assert_array_equal(a.labels, b.labels)
    assert a.kw.pop("device") == "cpu"
    assert a.kw == b.kw
    assert a.fits == b.fits
    assert len(a.splits) == len(b.splits) > 0
    for sa, sb in zip(a.splits, b.splits):
        assert set(sa) == set(sb)
        for k in sa:
            np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)
    return a


def _write_pokec(root, n=120, e=600):
    from scipy.io import savemat

    rng = np.random.default_rng(6)
    (root / "pokec").mkdir()
    savemat(root / "pokec" / "pokec.mat", {
        "edge_index": rng.integers(0, n, (2, e)),
        "node_feat": rng.random((n, 5)).astype(np.float32),
        "label": rng.integers(0, 2, (1, n))})


def _write_proteins(root, n=90, e=400, tasks=6):
    """ogbn-proteins in the raw layout of its zip: directed edges with 8
    edge features (the loader adds the inverses and averages the features
    into the nodes), binary task labels, the species split."""
    import gzip

    rng = np.random.default_rng(7)
    raw = root / "ogbn_proteins" / "raw"
    split = root / "ogbn_proteins" / "split" / "species"
    raw.mkdir(parents=True)
    split.mkdir(parents=True)

    def write(path, a, fmt="%d"):
        with gzip.open(path, "wt") as f:
            np.savetxt(f, np.asarray(a).reshape(len(a), -1), fmt=fmt,
                       delimiter=",")

    write(raw / "edge.csv.gz", rng.integers(0, n, (e, 2)))
    write(raw / "edge-feat.csv.gz", rng.random((e, 8)), fmt="%.6f")
    write(raw / "num-node-list.csv.gz", [n])
    write(raw / "num-edge-list.csv.gz", [e])
    write(raw / "node-label.csv.gz", rng.integers(0, 2, (n, tasks)))
    write(raw / "node_species.csv.gz", rng.integers(0, 3, n))
    perm = rng.permutation(n)
    for name, part in zip(("train", "valid", "test"),
                          np.split(perm, [n // 2, 3 * n // 4])):
        write(split / f"{name}.csv.gz", part)


@pytest.mark.parametrize("dataset", ["pokec", "ogbn-proteins", "synthetic",
                                     "pokec-gcn", "pokec-gat"])
def test_use_minibatch_hands_the_same_data(monkeypatch, tmp_path, dataset):
    """The presets that set use_minibatch, and the flag on a synthetic
    graph: both command lines build MiniBatchTrainer with the same model
    (DIFFormer, or the zoo's GCN and GAT on the pokec preset), features,
    edges (proteins: not symmetrised), labels and options, and fit each
    run's split with the same schedule."""
    argv = ["--data_dir", str(tmp_path), "--runs", "2", "--epochs", "3"]
    if dataset.startswith("pokec-"):
        argv += ["--method", dataset.split("-")[1]]
        dataset = "pokec"
    if dataset == "pokec":
        _write_pokec(tmp_path)
        argv += ["--dataset", "pokec", "--batch_size", "50"]
    elif dataset == "ogbn-proteins":
        _write_proteins(tmp_path)
        argv += ["--dataset", "ogbn-proteins", "--batch_size", "40"]
    else:
        argv += ["--dataset", "synthetic-80-300-6-3", "--use_minibatch",
                 "true", "--rand_split", "true", "--spmm", "bsr"]
    made = run_both_minibatch(monkeypatch, argv)
    assert made.model == {"gcn": "GCN", "gat": "GAT"}.get(
        argv[argv.index("--method") + 1] if "--method" in argv else None,
        "DIFFormer")
    assert made.kw["loss"] == ("bce" if dataset == "ogbn-proteins"
                               else "nll")
    assert made.fits == [{"epochs": 3, "runs": 1, "eval_step": (
        1 if dataset == "synthetic" else 9), "verbose": True}] * 2


def test_use_minibatch_trains_on_the_cpu():
    """End to end through the port's command line: the mini-batch trainer
    learns a homophilous synthetic graph (as the JAX package's
    test_minibatch_trainer_learns)."""
    res = cli.main([
        "--dataset", "synthetic-300-1500-10-3", "--use_minibatch", "true",
        "--batch_size", "100", "--epochs", "20", "--eval_step", "5",
        "--runs", "1", "--rand_split", "true", "--hidden_channels", "16",
        "--num_layers", "2", "--lr", "0.01", "--dropout", "0.0"], **CPU)
    assert len(res) == 1 and res[0]["test"] > 0.5, res
    assert len(res[0]["losses"]) == 20


@pytest.mark.parametrize("method,kind", [
    ("mlp", None), ("h2gcn", "norm"), ("gcn", "norm_loops"),
    ("gat", "gat")])
def test_zoo_in_minibatch_trains_on_the_cpu(monkeypatch, method, kind):
    """A zoo model of each chunk plan kind through the port's command line
    in node chunks (the last chunk of 100): it learns the homophilous
    graph, with BatchNorm (GCN, MLP) and GAT's two heads."""
    from difformer_tpu_torch.train import minibatch

    kinds = []
    real = minibatch.MiniBatchTrainer.__init__

    def init(self, *args, **kw):
        real(self, *args, **kw)
        kinds.append(self.kind)

    monkeypatch.setattr(minibatch.MiniBatchTrainer, "__init__", init)
    res = cli.main([
        "--dataset", "synthetic-300-1500-10-3", "--use_minibatch", "true",
        "--batch_size", "200", "--epochs", "12", "--eval_step", "3",
        "--runs", "1", "--rand_split", "true", "--hidden_channels", "16",
        "--num_layers", "2", "--lr", "0.01", "--dropout", "0.0",
        "--method", method], **CPU)
    assert kinds == [kind]
    assert len(res) == 1 and res[0]["test"] > 0.5, res
    assert len(res[0]["losses"]) == 12
