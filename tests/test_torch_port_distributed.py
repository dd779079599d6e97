"""The port's distributed trainer (difformer_tpu_torch/train/distributed.py)
against the JAX package's ``DistributedTrainer``, on the CPU.

The port's ranks are gloo processes started once, 4 of them, by
``launch.run_ranks`` (``parallel/rank_checks.py:run_checks``; the 2-rank
cases run on the first two); the JAX trainer runs on the first 2 or 4 of
the conftest's virtual CPU devices, at the sizes of
tests/test_distributed_trainer.py. Both start from the JAX trainer's
``init_state(0)`` weights, at dropout 0, and are held within rtol 2e-4 /
atol 2e-5 (the port's parity rule):

- each layout's per-epoch losses, every eval's split metrics and the best
  epoch's summary, the port's epoch-block fit against the JAX per-epoch
  loop (which the JAX tests hold to its epoch-scanned fit); also with
  one-hot BCE, with multilabel ROC-AUC (the logits all-gathered
  on the device) and with F1 (the host path, the per-epoch loop);
- the epoch-block fit against the per-epoch loop, and the device eval
  against the host metric of the gathered logits (port alone, as the JAX
  tests hold the JAX trainer);
- a run interrupted and resumed from its checkpoint against an
  uninterrupted one, bit for bit, at dropout 0.3 (every rank's dropout
  stream restored), and a resume at another world size, which raises;
- the command line's ``--n_shards 2`` with ranks spawned, against the same
  run as two processes joined through the ``DIFFORMER_*`` variables: the
  same summaries, and only rank 0 prints;
- the trainer on the ring (``kernel="sigmoid"``) and on the node-sharded
  block-sparse hybrid (``spmm="bsr"`` at ``bsr_tile=8``, flavour 7's), and
  on both, against the JAX trainer with the same options; the command
  line's rank function on ``--kernel sigmoid --spmm bsr --n_shards 2`` and
  ``--spmm bsr --n_shards 4`` in the same spawn; ``spmm="bsr"`` with a
  balanced layout warns as the JAX trainer does.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from difformer_tpu.nn import DIFFormer as JDIFFormer
from difformer_tpu.parallel import make_mesh as jax_make_mesh
from difformer_tpu.train.distributed import DistributedTrainer as JTrainer
from difformer_tpu.train.trainer import idx_to_mask
from difformer_tpu_torch import DIFFormer, cli
from difformer_tpu_torch.data import random_graph, standard_preprocess
from difformer_tpu_torch.data.splits import rand_train_test_idx
from difformer_tpu_torch.parallel import launch
from difformer_tpu_torch.parallel.launch import run_ranks
from difformer_tpu_torch.parallel.rank_checks import run_checks
from difformer_tpu_torch.train.distributed import DistributedTrainer
from difformer_tpu_torch.utils.metrics import METRICS
import torch_port_helpers  # noqa: F401  (sets torch's threads)
from torch_port_helpers import RowLog

TOL = dict(rtol=2e-4, atol=2e-5)
WORLDS = (2, 4)
LAYOUTS = ("contiguous", "balanced", "locality")
N, E, F, C, HIDDEN, LAYERS = 160, 700, 10, 3, 16, 2
LR, WD, SEED = 1e-2, 5e-4, 123
EPOCHS, EVAL_STEP, BLOCK = 8, 2, 4
# the block-vs-loop fits' eval steps (11 epochs, blocks of 4): evals inside
# the run, and none before the end (eval_step >= epochs > epoch_block)
LOOP_EVAL_STEPS = (2, 20)
# (world, layout, loss, metric) of the fits held against the JAX trainer
JAX_CASES = ([(w, layout, "nll", "acc") for w in WORLDS for layout in LAYOUTS]
             + [(2, "contiguous", "bce", "acc"), (2, "balanced", "bce",
                                                  "rocauc"),
                (2, "locality", "nll", "f1")])
# the ring and the hybrid: (world, kernel, spmm) of the fits held against
# the JAX trainer with those options, at flavour 7's tile
BSR_TILE = 8
SLICE_CASES = [(2, "simple", "bsr"), (4, "simple", "bsr"),
               (2, "sigmoid", "halo"), (4, "sigmoid", "bsr")]
# the command line's rank function on the ring and the hybrid
SLICE_ARGV = {2: ["--kernel", "sigmoid", "--spmm", "bsr"],
              4: ["--spmm", "bsr"]}


def graph():
    x, ei, y = random_graph(N, E, F, C, seed=21, homophily=0.85)
    ei = standard_preprocess(ei, N)
    return x, ei, y, rand_train_test_idx(y, 0.5, 0.25, rng=0)


def multilabel(y):
    """Three binary tasks from the classes, for ROC-AUC."""
    rng = np.random.default_rng(5)
    noisy = (rng.random((y.shape[0], 3)) < 0.2)
    return (np.eye(C, dtype=np.float32)[y] + noisy).clip(0, 1).astype(
        np.float32)


def model_kw(out=C, dropout=0.0):
    return dict(in_channels=F, hidden_channels=HIDDEN, out_channels=out,
                num_layers=LAYERS, dropout=dropout)


def jax_run(world, layout, loss, metric, x, ei, y, split, kernel="simple",
            spmm="halo"):
    """The JAX trainer's init params, its fit's logger rows and summary,
    and the per-epoch losses of its own step from the same weights
    (dropout 0: the keys do not matter). The fit is the JAX per-epoch loop,
    which the JAX tests hold to its epoch-scanned fit within rtol 1e-5
    (tests/test_distributed_trainer.py::test_distributed_scanned_fit_\
matches_loop): one compiled step serves both, where the scanned blocks
    would compile again."""
    out = y.shape[1] if y.ndim > 1 else C
    model = JDIFFormer(hidden_channels=HIDDEN, out_channels=out,
                       num_layers=LAYERS, dropout=0.0, kernel=kernel,
                       axis_name="graph")
    init = JDIFFormer(hidden_channels=HIDDEN, out_channels=out,
                      num_layers=LAYERS, dropout=0.0, kernel=kernel)
    tr = JTrainer(model, init, x, ei, y,
                  train_mask=idx_to_mask(split["train"], N),
                  mesh=jax_make_mesh((world,), ("graph",)), lr=LR,
                  weight_decay=WD, loss=loss, metric=metric, seed=SEED,
                  layout=layout, spmm=spmm, bsr_tile=BSR_TILE)
    params, opt = tr.init_state(0)
    params_np = jax.tree_util.tree_map(np.asarray, params)
    losses, rng = [], jax.random.PRNGKey(1000 + SEED)
    for _ in range(EPOCHS):
        rng, sk = jax.random.split(rng)
        params, opt, value = tr._step(params, opt, tr.sg, np.asarray(sk),
                                      tr._ell)
        losses.append(float(value))
    log = RowLog()
    best = tr.fit(split, epochs=EPOCHS, eval_step=EVAL_STEP, epoch_block=0,
                  logger=log)[0]
    return dict(params=params_np, rows=np.asarray(log.rows), best=best,
                losses=np.asarray(losses))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX references and the port's results of every case, from one
    spawn of 4 gloo ranks."""
    x, ei, y, split = graph()
    ym = multilabel(y)
    ckpt = tmp_path_factory.mktemp("ckpt")
    refs, cases, index = {}, [], {}

    def add(key, case):
        index[key] = len(cases)
        cases.append(case)

    common = dict(x=x, ei=ei, split=split)
    for key in JAX_CASES:
        world, layout, loss, metric = key
        labels = ym if metric == "rocauc" else y
        refs[key] = jax_run(world, layout, loss, metric, x, ei, labels, split)
        add(key, dict(kind="fit", world=world, y=labels, **common,
                      model_kw=model_kw(labels.shape[1] if labels.ndim > 1
                                        else C),
                      trainer_kw=dict(lr=LR, weight_decay=WD, loss=loss,
                                      metric=metric, seed=SEED,
                                      layout=layout),
                      init_params=refs[key]["params"],
                      fits=[dict(epochs=EPOCHS, eval_step=EVAL_STEP,
                                 epoch_block=BLOCK)]))
    for world in WORLDS:
        add(("loop", world), dict(
            kind="fit", world=world, y=y, **common, model_kw=model_kw(),
            trainer_kw=dict(lr=LR, seed=SEED + world,
                            layout="locality" if world == 4 else None),
            fits=[dict(epochs=11, eval_step=es, epoch_block=block)
                  for es in LOOP_EVAL_STEPS for block in (4, 0)]))
        for layout in (None, "locality"):
            add(("eval", world, layout), dict(
                kind="eval", world=world, y=y, **common, model_kw=model_kw(),
                trainer_kw=dict(seed=29, layout=layout)))
        add(("resume", world), dict(
            kind="resume", world=world, y=y, **common,
            model_kw=dict(model_kw(dropout=0.3), spmm_first=world == 2),
            trainer_kw=dict(layout="locality" if world == 2 else None),
            ckpt_dir=str(ckpt / f"w{world}")))
    add("other_world", dict(
        kind="resume", world=4, y=y, **common,
        model_kw=dict(model_kw(dropout=0.3), spmm_first=True),
        trainer_kw=dict(layout="locality"), ckpt_dir=str(ckpt / "w2"),
        stop=None))
    for key in SLICE_CASES:
        world, kernel, spmm = key
        refs[key] = jax_run(world, "contiguous", "nll", "acc", x, ei, y,
                            split, kernel=kernel, spmm=spmm)
        add(key, dict(kind="fit", world=world, y=y, **common,
                      model_kw=dict(model_kw(), kernel=kernel),
                      trainer_kw=dict(lr=LR, weight_decay=WD, seed=SEED,
                                      spmm=spmm, bsr_tile=BSR_TILE),
                      init_params=refs[key]["params"],
                      fits=[dict(epochs=EPOCHS, eval_step=EVAL_STEP,
                                 epoch_block=BLOCK)]))
    for world, extra in SLICE_ARGV.items():
        add(("cli", world), dict(kind="cli", world=world,
                                 args=cli_rank_args(world, extra)))
    results = run_ranks(run_checks, max(WORLDS), "gloo", "cpu", cases)

    def ranks(key):
        world = cases[index[key]].get("world", max(WORLDS))
        assert all(r[index[key]] is None for r in results[world:])
        return [r[index[key]] for r in results[:world]]

    return dict(refs=refs, ranks=ranks, ckpt=ckpt, x=x, y=y, split=split)


@pytest.mark.parametrize("key", JAX_CASES, ids=lambda k: "-".join(map(str,
                                                                      k)))
def test_distributed_fit_matches_jax(runs, key):
    ref = runs["refs"][key]
    for rank, out in enumerate(runs["ranks"](key)):
        assert out["jax_loaded"] is False
        fit = out["fits"][0]
        best = fit["summaries"][0]
        np.testing.assert_allclose(best["losses"], ref["losses"],
                                   err_msg=f"rank {rank}", **TOL)
        np.testing.assert_allclose(fit["rows"], ref["rows"],
                                   err_msg=f"rank {rank}", **TOL)
        assert best["epoch"] == ref["best"]["epoch"]
        for k in ("train", "valid", "test"):
            np.testing.assert_allclose(best[k], ref["best"][k], **TOL)


@pytest.mark.parametrize("key", SLICE_CASES,
                         ids=lambda k: "-".join(map(str, k)))
def test_distributed_fit_on_the_ring_and_hybrid_matches_jax(runs, key):
    ref = runs["refs"][key]
    for rank, out in enumerate(runs["ranks"](key)):
        assert out["jax_loaded"] is False
        assert out["products"] == (0 if key[2] == "bsr" else 3)
        fit = out["fits"][0]
        best = fit["summaries"][0]
        np.testing.assert_allclose(best["losses"], ref["losses"],
                                   err_msg=f"rank {rank}", **TOL)
        np.testing.assert_allclose(fit["rows"], ref["rows"],
                                   err_msg=f"rank {rank}", **TOL)
        assert best["epoch"] == ref["best"]["epoch"]
        for k in ("train", "valid", "test"):
            np.testing.assert_allclose(best[k], ref["best"][k], **TOL)
        # the plain versions count no launch
        assert not any(fit["launches"].values())


def cli_rank_args(world, extra):
    """What the command line hands its rank function for
    ``CLI_ARGV``-like flags on ``world`` ranks (``cli.run_sharded``
    replaced by a recorder, so that nothing is spawned)."""
    argv = ["--dataset", "synthetic-160-700-10-3", "--epochs", "4",
            "--runs", "1", "--rand_split", "true", "--n_shards", str(world),
            "--dropout", "0", "--hidden_channels", "16", "--num_layers",
            "2", "--bsr_tile", str(BSR_TILE)] + extra
    seen = []

    def record(cfg, x, ei, label, n_classes, splits, loss, device=None,
               backend=None):
        seen.append((cfg, x, ei, label, n_classes, splits, loss))
        return [dict(train=0.0, valid=0.0, test=0.0, epoch=0)]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "run_sharded", record)
        cli.main(argv, device="cpu")
    (args,) = seen
    return args


@pytest.mark.parametrize("world", sorted(SLICE_ARGV))
def test_cli_rank_runs_the_ring_and_hybrid(runs, world):
    outs = runs["ranks"](("cli", world))
    assert all(o["summaries"] == outs[0]["summaries"] for o in outs)
    for out in outs:
        assert out["jax_loaded"] is False
        (best,) = out["summaries"]
        assert len(best["losses"]) == 4 and np.isfinite(best["losses"]).all()
        assert 0.0 <= best["test"] <= 1.0


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_block_fit_matches_loop(runs, world):
    # the counterpart of test_distributed_scanned_fit_matches_loop: 11
    # epochs in blocks of 4; an eval every 2 (groups, the remainder one
    # epoch at a time, the final epoch's forced eval), and an eval step of
    # 20 (the loop's evals at epochs 0 and 10 only)
    for out in runs["ranks"](("loop", world)):
        fits = out["fits"]
        assert len(fits) == 2 * len(LOOP_EVAL_STEPS)
        for es, blocks, loop in zip(LOOP_EVAL_STEPS, fits[::2], fits[1::2]):
            assert blocks["rows"].shape == loop["rows"].shape, es
            assert loop["rows"].shape[0] == (6 if es == 2 else 2)
            np.testing.assert_allclose(blocks["rows"], loop["rows"],
                                       rtol=1e-5, atol=1e-6)
            a, b = blocks["summaries"][0], loop["summaries"][0]
            np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-5,
                                       atol=1e-6)
            for k in ("train", "valid", "test", "epoch"):
                np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("layout", [None, "locality"])
def test_distributed_device_eval_matches_host(runs, world, layout):
    outs = runs["ranks"](("eval", world, layout))
    logits = np.concatenate([o["logits"] for o in outs])
    perm = outs[0]["perm"]
    logits = logits[perm] if perm is not None else logits[:N]
    y = runs["y"]
    for out in outs:
        for name, idx in runs["split"].items():
            want = METRICS["acc"](y[np.asarray(idx)],
                                  logits[np.asarray(idx)])
            np.testing.assert_allclose(out["device"][name], want, atol=1e-6)


def _checkpoint(path):
    return torch.load(path, map_location="cpu", weights_only=True)


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_resume_is_bit_equal(runs, world):
    # interrupted after 6 epochs (checkpoints after epochs 2 and 5),
    # resumed to 10 (a checkpoint after epoch 8), against 10 uninterrupted
    outs = runs["ranks"](("resume", world))
    for out in outs:
        assert out["resumed"] == out["whole"]
    d = runs["ckpt"] / f"w{world}"
    a = _checkpoint(d / "run0" / "8.pt")
    b = _checkpoint(f"{d}_whole/run0/8.pt")
    assert a["world_size"] == b["world_size"] == world
    assert len(a["generators"]) == world
    for x, y in zip(a["generators"], b["generators"]):
        assert torch.equal(x, y)
    assert len({bytes(g.numpy()) for g in a["generators"]}) == world
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for pa, pb in zip(a["optimizer"]["state"].values(),
                      b["optimizer"]["state"].values()):
        for k in pa:
            assert torch.equal(torch.as_tensor(pa[k]),
                               torch.as_tensor(pb[k])), k
    assert a["losses"] == b["losses"] and a["best"] == b["best"]


def test_resume_at_another_world_size_raises(runs):
    for out in runs["ranks"]("other_world"):
        assert out["error"] is not None and "2 ranks" in out["error"]


def test_unknown_layout_and_bsr_raise_before_any_collective():
    # no mesh at all: each raises before the trainer reaches the group. An
    # unknown layout or spmm is refused; spmm="bsr" with a balanced layout
    # warns as the JAX trainer does (uniform tile-aligned shards instead),
    # and without a mesh the model's group is then refused
    x, ei, y, split = graph()
    mask = idx_to_mask(split["train"], N)
    model = DIFFormer(F, HIDDEN, C, num_layers=LAYERS, device="cpu")
    with pytest.raises(ValueError, match="unknown layout"):
        DistributedTrainer(model, x, ei, y, train_mask=mask, mesh=None,
                           layout="local")
    with pytest.raises(ValueError, match="unknown spmm"):
        DistributedTrainer(model, x, ei, y, train_mask=mask, mesh=None,
                           spmm="ell")
    for kw in (dict(layout="balanced"), dict(balance_edges=True),
               dict(layout="locality")):
        with pytest.warns(UserWarning, match="uniform tile-aligned shards"), \
                pytest.raises(ValueError, match="axis_name=mesh.group"):
            DistributedTrainer(model, x, ei, y, train_mask=mask, mesh=None,
                               spmm="bsr", **kw)


def test_one_process_is_no_cluster(monkeypatch):
    for name in ("DIFFORMER_NUM_PROCESSES", "DIFFORMER_COORDINATOR",
                 "DIFFORMER_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert launch.initialize_cluster(backend="gloo", device="cpu") is None
    monkeypatch.setenv("DIFFORMER_NUM_PROCESSES", "1")
    monkeypatch.setenv("DIFFORMER_COORDINATOR", "localhost:1")
    assert launch.initialize_cluster(backend="gloo", device="cpu") is None
    assert launch.is_primary() and launch.global_device_count() == 1
    # before the group exists (or after it closed) the variables decide
    monkeypatch.setenv("DIFFORMER_NUM_PROCESSES", "2")
    monkeypatch.setenv("DIFFORMER_PROCESS_ID", "1")
    assert launch.cluster_env() == ("localhost:1", 2, 1)
    assert not launch.is_primary()


CLI_ARGV = ["--dataset", "synthetic-160-700-10-3", "--epochs", "6",
            "--runs", "2", "--rand_split", "true", "--n_shards", "2",
            "--dropout", "0", "--hidden_channels", "16", "--num_layers",
            "2", "--eval_step", "2", "--layout", "locality"]

CLUSTER_RANK = """
import json, sys
import torch
from difformer_tpu_torch import cli
from difformer_tpu_torch.parallel.launch import rank_threads
torch.set_num_threads(rank_threads(2))
res = cli.main(json.loads(sys.argv[1]), device="cpu")
print("RESULT " + json.dumps(res))
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_cli_spawned_and_cluster_runs_agree(capfd):
    spawned = cli.main(CLI_ARGV, device="cpu")
    printed = capfd.readouterr().out
    # two runs, each printing its epoch-0 line once: rank 0 alone prints
    assert printed.count("run 0 epoch 0:") == 2, printed
    assert printed.count("Final Test") == 1

    port = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(PYTHONPATH=root, DIFFORMER_NUM_PROCESSES="2",
               DIFFORMER_COORDINATOR=f"localhost:{port}")
    procs = [subprocess.Popen(
        [sys.executable, "-c", CLUSTER_RANK, json.dumps(CLI_ARGV)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**env, "DIFFORMER_PROCESS_ID": str(rank)}, cwd=root)
        for rank in range(2)]
    outs, errs = [], []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            outs.append(out)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    results = []
    for p, out, err in zip(procs, outs, errs):
        assert p.returncode == 0, out + err
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert line, out
        results.append(json.loads(line[-1][len("RESULT "):]))
    assert results[0] == results[1]
    assert len(results[0]) == len(spawned) == 2
    for a, b in zip(results[0], spawned):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=0)
    assert "run 0 epoch 0:" in outs[0] and "Final Test" in outs[0]
    # rank 1 prints nothing of its own: its one line is CLUSTER_RANK's
    assert outs[1].strip().splitlines() == [
        ln for ln in outs[1].strip().splitlines() if ln.startswith("RESULT ")]
