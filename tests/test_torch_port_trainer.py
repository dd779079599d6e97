"""The port's FullBatchTrainer against the JAX package's: 5 Adam steps at
dropout 0 from carried weights give the same per-step losses and the same
final parameters (rtol 2e-4 / atol 2e-5, tests/test_reference_exec.py:334),
and ``fit`` picks the same best epoch, for DIFFormer-a and DIFFormer-s, with
the NLL, BCE and MSE losses and ``manireg``. The epoch-block fit
(``fit(epoch_block=...)``) is held to the port's per-epoch fit (the same
losses, logged metrics at atol 1e-6, the same best epoch, dropout on) and
to the JAX package's scanned fit from carried weights at dropout 0 (the
same best epoch, logged metrics and losses at the tolerance above). The
port runs on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difformer_tpu.data.graph import GraphData as JGraph
from difformer_tpu.data.splits import class_rand_splits
from difformer_tpu.data.synthetic import random_graph
from difformer_tpu.data.transforms import standard_preprocess
from difformer_tpu.nn.difformer import DIFFormer as JDIFFormer
from difformer_tpu.train.trainer import FullBatchTrainer as JTrainer
from difformer_tpu.train.trainer import idx_to_mask
from difformer_tpu.train.trainer import nll_loss as jax_nll
from difformer_tpu_torch import DIFFormer, FullBatchTrainer, GraphData
from difformer_tpu_torch.train.trainer import nll_loss
from difformer_tpu_torch.utils import weights as W
from difformer_tpu_torch.utils.metrics import eval_acc
from torch_port_helpers import RowLog

TOL = dict(rtol=2e-4, atol=2e-5)
N, F, C = 200, 16, 4
LR, WD = 1e-3, 0.01


def _task(task, y):
    """(labels, out_channels, trainer options) of a task on the test graph
    with classes ``y``: the classes with NLL, as one-hot BCE targets, float
    regression targets with MSE, and multilabel BCE with ROC-AUC."""
    rng = np.random.default_rng(4)
    if task == "nll":
        return y, C, {}
    if task == "bce":
        return y, C, dict(loss="bce")
    if task == "mse":
        return (rng.normal(size=N).astype(np.float32) * 0.3, 1,
                dict(loss="mse", metric="mse"))
    return ((rng.random((N, 3)) < 0.4).astype(np.float32), 3,
            dict(loss="bce", metric="rocauc"))


def _setup(task="nll", trainer_kw=None, **kw):
    x, ei, y = random_graph(N, 800, F, C, seed=0, homophily=0.8)
    ei = standard_preprocess(ei, N)
    split = class_rand_splits(y, 10, valid_num=60, test_num=80, rng=0)
    labels, out, opts = _task(task, y)
    opts = dict(opts, **(trainer_kw or {}))
    kw = dict(dict(num_layers=2, dropout=0.0), **kw)
    jm = JDIFFormer(hidden_channels=16, out_channels=out, **kw)
    jt = JTrainer(jm, JGraph.from_numpy(x, ei), labels, lr=LR,
                  weight_decay=WD, **opts)
    params = jax.tree_util.tree_map(np.asarray, jt.init_state(0).params)
    tm = DIFFormer(F, 16, out, device="cpu", **kw)
    tt = FullBatchTrainer(tm, GraphData.from_numpy(x, ei, device="cpu"),
                          labels, lr=LR, weight_decay=WD, device="cpu",
                          **opts)
    return jt, tt, params, split


@pytest.fixture(scope="module")
def setup():
    return _setup(num_heads=2, kernel="sigmoid", graph_weight=0.7)


# DIFFormer-s: the main path's one head, and two heads fused with
# spmm_first (Wv factored through the key aggregates, F+1-wide products)
SIMPLE = {"h1": dict(num_heads=1, kernel="simple"),
          "h2-fused-spmm-first": dict(num_heads=2, kernel="simple",
                                      spmm_first=True)}


@pytest.fixture(scope="module", params=sorted(SIMPLE))
def setup_s(request):
    return _setup(**SIMPLE[request.param])


def test_nll_loss_matches():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(30, 5)).astype(np.float32)
    labels = rng.integers(0, 5, size=30)
    mask = rng.random(30) > 0.5
    a = jax_nll(jnp.asarray(logits), jnp.asarray(labels, jnp.int32),
                jnp.asarray(mask))
    b = nll_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                 torch.from_numpy(mask))
    np.testing.assert_allclose(b.item(), float(a), rtol=1e-6)


def test_adam_trajectory_matches_jax(setup):
    _check_trajectory(*setup)


def test_simple_adam_trajectory_matches_jax(setup_s):
    _check_trajectory(*setup_s)


def _check_trajectory(jt, tt, params, split):
    mask = idx_to_mask(split["train"], N)
    js = jt.init_state(0, init_params=params)
    ts = tt.init_state(0, init_params=params)
    for step in range(5):
        js, jl = jt.train_step(js, jax.random.PRNGKey(step),
                               jnp.asarray(mask))
        ts, tl = tt.train_step(ts, None, torch.from_numpy(mask))
        np.testing.assert_allclose(tl.item(), float(jl), **TOL,
                                   err_msg=f"loss at step {step}")
    final = W.params_from_torch_state_dict(ts.model.state_dict())
    for path, leaf in jax.tree_util.tree_leaves_with_path(js.params):
        got = final
        for key in path:
            got = got[key.key]
        np.testing.assert_allclose(got, np.asarray(leaf), **TOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_fit_picks_the_same_best_epoch(setup):
    _check_fit(*setup)


def test_simple_fit_picks_the_same_best_epoch(setup_s):
    _check_fit(*setup_s)


def _check_fit(jt, tt, params, split):
    jbest = jt.fit(split, epochs=8, init_params=params)[0]
    tbest = tt.fit(split, epochs=8, init_params=params)[0]
    assert tbest["epoch"] == jbest["epoch"]
    for k in ("train", "valid", "test"):
        assert tbest[k] == pytest.approx(jbest[k])
    assert len(tbest["losses"]) == 8
    res, out = tt.evaluate_params(params, split)
    assert out.shape == (N, C) and set(res) == {"train", "valid", "test"}


def test_eval_acc_matches():
    from difformer_tpu.utils.metrics import eval_acc as jax_eval_acc

    rng = np.random.default_rng(1)
    y = rng.integers(0, 4, size=(50,))
    pred = rng.normal(size=(50, 4))
    assert eval_acc(y, pred) == jax_eval_acc(y, pred)


def test_trainer_builds_the_csr_plan_once(monkeypatch):
    """The graph's CSR plan (its sort and degree pass) is built when the
    trainer starts, and no train step or eval builds another."""
    import difformer_tpu_torch.data.graph as data_graph
    import difformer_tpu_torch.nn.difformer as difformer_module
    import difformer_tpu_torch.ops.graph_ops as graph_ops

    built = []
    real = graph_ops.build_csr_plan

    def counting(*args, **kwargs):
        built.append(1)
        return real(*args, **kwargs)

    for module in (graph_ops, data_graph, difformer_module):
        monkeypatch.setattr(module, "build_csr_plan", counting)
    x, ei, y = random_graph(N, 800, F, C, seed=0, homophily=0.8)
    graph = GraphData.from_numpy(x, standard_preprocess(ei, N), device="cpu")
    model = DIFFormer(F, 16, C, num_layers=2, device="cpu")
    trainer = FullBatchTrainer(model, graph, y, device="cpu")
    assert len(built) == 1
    split = class_rand_splits(y, 10, valid_num=60, test_num=80, rng=0)
    trainer.fit(split, epochs=3)
    assert len(built) == 1


@pytest.mark.parametrize("case", ["bce-onehot", "bce-multilabel",
                                  "mse-1d", "mse-2d"])
def test_bce_and_mse_losses_match(case):
    from difformer_tpu.train.trainer import LOSSES as JLOSSES

    from difformer_tpu_torch.train.trainer import LOSSES

    loss = case.split("-")[0]
    rng = np.random.default_rng(5)
    n, c = 30, 4
    mask = rng.random(n) > 0.5
    logits = rng.normal(size=(n, 1 if case == "mse-1d" else c))
    logits = logits.astype(np.float32) * 3
    if case == "bce-onehot":
        labels = np.eye(c, dtype=np.float32)[rng.integers(0, c, n)]
    elif case == "bce-multilabel":
        labels = (rng.random((n, c)) < 0.4).astype(np.float32)
    elif case == "mse-1d":  # [N, 1] predictions against [N] targets
        labels = rng.normal(size=n).astype(np.float32)
    else:
        labels = rng.normal(size=(n, c)).astype(np.float32)
    want = float(JLOSSES[loss](jnp.asarray(logits), jnp.asarray(labels),
                               jnp.asarray(mask)))
    got = LOSSES[loss](torch.from_numpy(logits), torch.from_numpy(labels),
                       torch.from_numpy(mask)).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)


LABEL_CASES = {
    "1d": np.array([0, 2, 1, -1]),
    "column": np.array([[1], [0], [2], [2]]),
    "multilabel": np.array([[1, 0], [0, 1], [1, 1], [0, 0]]),
}


@pytest.mark.parametrize("loss,labels,onehot", [
    (loss, name, False) for loss in ("nll", "bce", "mse")
    for name in sorted(LABEL_CASES)] + [("bce", "multilabel", True)])
def test_train_labels_match_jax_layout(loss, labels, onehot):
    """The three layouts of the JAX trainer's ``labels_train``: one-hot BCE
    targets (1-D, single-column or ``onehot_bce_labels``; a negative label
    gives a zero row), float targets as given, int class ids."""
    from difformer_tpu_torch.train.trainer import train_labels

    labels = LABEL_CASES[labels]
    got = train_labels(labels, loss, onehot)
    assert got.dtype == (np.int64 if loss == "nll" else np.float32)
    np.testing.assert_array_equal(got, _jax_labels_train(labels, loss,
                                                         onehot))


def _jax_labels_train(labels, loss, onehot):
    """The JAX trainer's ``labels_train`` for ``labels``, through its own
    constructor on a one-edge graph."""
    x = np.zeros((labels.shape[0], 2), np.float32)
    g = JGraph.from_numpy(x, np.array([[0], [1]]))
    m = JDIFFormer(hidden_channels=4, out_channels=3, num_layers=1)
    t = JTrainer(m, g, labels, loss=loss, onehot_bce_labels=onehot)
    return np.asarray(t.labels_train)


MANIREG = 0.5


@pytest.mark.parametrize("kernel", ["simple", "sigmoid"])
def test_manireg_trajectory_matches_jax(kernel):
    """The Laplacian smoothness term over the edges (``manireg``) in the
    loss and its gradient: 5 Adam steps against JAX."""
    _check_trajectory(*_setup(kernel=kernel, num_heads=1,
                              trainer_kw=dict(manireg=MANIREG)))


@pytest.mark.parametrize("task", ["bce", "mse", "rocauc"])
def test_bce_mse_trajectory_matches_jax(task):
    _check_trajectory(*_setup(task, num_heads=1))


def test_model_kwargs_reach_the_model():
    """``model_kwargs`` are passed to every forward; ``indices_are_sorted``
    is taken out of them and passed on its own."""
    x, ei, y = random_graph(N, 800, F, C, seed=0, homophily=0.8)
    graph = GraphData.from_numpy(x, standard_preprocess(ei, N), device="cpu")
    tt = FullBatchTrainer(
        DIFFormer(F, 16, C, num_layers=2, device="cpu"), graph, y,
        device="cpu", model_kwargs=dict(edge_chunk_size=64,
                                        indices_are_sorted=False))
    assert tt.model_kwargs == {"edge_chunk_size": 64}
    assert tt._sorted is False
    seen = []
    real = tt.model.forward

    def spy(*args, **kwargs):
        seen.append(kwargs)
        return real(*args, **kwargs)

    tt.model.forward = spy
    tt.fit(class_rand_splits(y, 10, valid_num=60, test_num=80, rng=0),
           epochs=2)
    assert len(seen) == 4  # two train steps, two evals
    assert all(k["edge_chunk_size"] == 64 and k["indices_are_sorted"] is False
               for k in seen)


def _eligible_grid():
    for block in (0, 1, 2, 8):
        for save_best in (False, True):
            for print_prop in (False, True):
                for ckpt, every in (("", 0), ("d", 0), ("", 3), ("d", 3)):
                    for resume in (False, True):
                        yield (block, 1, save_best, print_prop, ckpt, every,
                               resume)


@pytest.mark.parametrize("task", ["nll", "bce", "mse", "rocauc", "f1",
                                  "acc-multilabel"])
def test_scan_eligible_matches_jax(task):
    """The same decision as JAX's ``_scan_eligible`` over the grid of its
    arguments, for each metric and label layout (tests/test_trainer.py:162
    checks some of these points)."""
    if task == "f1":
        jt, tt, _, _ = _setup(trainer_kw=dict(metric="f1"))
    elif task == "acc-multilabel":
        jt, tt, _, _ = _setup("rocauc", trainer_kw=dict(metric="acc"))
    else:
        jt, tt, _, _ = _setup(task)
    decisions = [(args, tt._scan_eligible(*args), jt._scan_eligible(*args))
                 for args in _eligible_grid()]
    assert all(a == b for _, a, b in decisions), decisions
    assert any(a for _, a, _ in decisions) == (task not in ("f1",
                                                            "acc-multilabel"))


# (task, epochs, eval_step, epoch_block): blocks of groups with a
# remainder and the forced final eval; the eval-free branch
# (eval_step >= epochs); and the BCE, MSE and ROC-AUC paths
BLOCK_CASES = {
    "nll": ("nll", 23, 3, 8),
    "nll-eval-free": ("nll", 12, 100, 5),
    "bce": ("bce", 12, 1, 4),
    "mse": ("mse", 12, 1, 8),
    "mse-eval-free": ("mse", 12, 100, 8),
    "rocauc": ("rocauc", 10, 2, 8),
}


def _host_fetches(epochs, eval_step, epoch_block):
    """The epoch-block schedule's host reads: one per block, one per eval
    outside the blocks, and one of every loss at the end."""
    if eval_step >= epochs:
        return 1 + (epochs > 1) + 1
    length = max(1, epoch_block // eval_step) * eval_step
    blocks = epochs // length
    rest = [e for e in range(blocks * length, epochs)
            if e % eval_step == 0 or e == epochs - 1]
    forced = (not rest and (epochs - 1) % eval_step != 0)
    return blocks + len(rest) + forced + 1


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_epoch_block_fit_matches_per_epoch_fit(case, monkeypatch):
    """With dropout on: the same losses, logged metrics at atol 1e-6 (the
    device metric in float32 against the host's float64), the same best
    epoch; the host reads the device once per block."""
    from difformer_tpu_torch.train import trainer as trainer_module

    task, epochs, eval_step, block = BLOCK_CASES[case]
    fetches = []
    real = trainer_module.EpochRunner.fetch
    monkeypatch.setattr(trainer_module.EpochRunner, "fetch",
                        lambda self, lo, hi: fetches.append(1)
                        or real(self, lo, hi))
    results = []
    for epoch_block in (0, block):
        _, tt, _, split = _setup(task, num_heads=1, dropout=0.3)
        log = RowLog()
        best = tt.fit(split, epochs=epochs, eval_step=eval_step,
                      epoch_block=epoch_block, logger=log)[0]
        results.append((best, np.asarray(log.rows)))
    (loop, loop_rows), (blk, blk_rows) = results
    assert len(fetches) == _host_fetches(epochs, eval_step, block)
    assert blk["epoch"] == loop["epoch"]
    assert blk["losses"] == loop["losses"] and len(blk["losses"]) == epochs
    assert blk_rows.shape == loop_rows.shape
    np.testing.assert_allclose(blk_rows, loop_rows, rtol=0, atol=1e-6)
    for k in ("train", "valid", "test"):
        np.testing.assert_allclose(blk[k], loop[k], rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_epoch_block_fit_matches_jax_scanned_fit(case):
    """From carried weights at dropout 0, against the JAX package's scanned
    fit: the same best epoch, logged metrics at the JAX tolerance."""
    task, epochs, eval_step, block = BLOCK_CASES[case]
    jt, tt, params, split = _setup(task, num_heads=1)
    logs = (RowLog(), RowLog())
    jbest = jt.fit(split, epochs=epochs, eval_step=eval_step,
                   epoch_block=block, logger=logs[0], init_params=params)[0]
    tbest = tt.fit(split, epochs=epochs, eval_step=eval_step,
                   epoch_block=block, logger=logs[1], init_params=params)[0]
    assert tt.epoch_runner is not None
    assert tbest["epoch"] == jbest["epoch"]
    np.testing.assert_allclose(np.asarray(logs[1].rows),
                               np.asarray(logs[0].rows), **TOL)
    for k in ("train", "valid", "test"):
        np.testing.assert_allclose(tbest[k], jbest[k], **TOL)


def test_save_best_verbose_and_print_prop(capsys):
    """``save_best`` keeps the best epoch's weights (evaluating them gives
    the best validation metric); ``verbose`` and ``print_prop`` print the
    JAX trainer's lines, with the same values (carried weights, dropout
    0)."""
    import re

    jt, tt, params, split = _setup(num_heads=1)
    opts = dict(epochs=6, eval_step=1, verbose=True, display_step=2,
                print_prop=True, init_params=params, save_best=True)
    jt.fit(split, **opts)
    jlines = capsys.readouterr().out.splitlines()
    best = tt.fit(split, **opts)[0]
    tlines = capsys.readouterr().out.splitlines()
    assert len(tlines) == len(jlines) == 6
    number = r"-?\d+\.\d+(?:e-?\d+)?"
    for t, j in zip(tlines, jlines):
        assert re.sub(number, "#", t) == re.sub(number, "#", j)
        np.testing.assert_allclose(
            [float(v) for v in re.findall(number, t)],
            [float(v) for v in re.findall(number, j)], atol=2e-4)
    res, _ = tt.evaluate_params(
        W.params_from_torch_state_dict(best["params"]), split)
    assert res["valid"] == best["valid"]
