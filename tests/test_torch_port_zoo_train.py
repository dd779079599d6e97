"""The baseline zoo trained by the port's FullBatchTrainer against the JAX
package's trainer, on the CPU.

From the same carried weights at dropout 0, 3 Adam steps give the same
per-step losses, final parameters and BatchNorm running statistics at rtol
2e-4 / atol 2e-5 (tests/test_reference_exec.py:334) for GCN (BatchNorm),
GAT (two heads, K1-dval in the backward) and GPRGNN (its ``temp`` decayed
by the coupled L2 as every parameter is). The trainer builds each model's
plan once; the epoch-block fit gives the per-epoch fit's losses with
dropout on; the best state carries the running statistics, and
``evaluate_params`` takes the JAX trainer's ``extra``. The JAX trainers are
built once for the module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difformer_tpu.data.graph import GraphData as JGraph
from difformer_tpu.data.splits import class_rand_splits
from difformer_tpu.data.synthetic import random_graph
from difformer_tpu.data.transforms import standard_preprocess
from difformer_tpu.nn import gnns as JZ
from difformer_tpu.train.trainer import FullBatchTrainer as JTrainer
from difformer_tpu.train.trainer import idx_to_mask
from difformer_tpu_torch import FullBatchTrainer, GraphData
from difformer_tpu_torch.nn import gnns as Z
from difformer_tpu_torch.utils import weights as W
from torch_port_helpers import RowLog

TOL = dict(rtol=2e-4, atol=2e-5)
N, F, C = 120, 10, 3
LR, WD = 1e-2, 5e-4

MODELS = {
    "gcn": (lambda: JZ.GCN(16, C, dropout=0.0),
            lambda **kw: Z.GCN(F, 16, C, device="cpu", **kw)),
    "gat": (lambda: JZ.GAT(8, C, heads=2, dropout=0.0),
            lambda **kw: Z.GAT(F, 8, C, heads=2, device="cpu", **kw)),
    "gprgnn": (lambda: JZ.GPRGNN(16, C, dropout=0.0, dprate=0.0),
               lambda **kw: Z.GPRGNN(F, 16, C, device="cpu", **kw)),
}


@pytest.fixture(scope="module")
def data():
    x, ei, y = random_graph(N, 480, F, C, seed=3, homophily=0.8)
    ei = standard_preprocess(ei, N)
    split = class_rand_splits(y, 10, valid_num=30, test_num=40, rng=0)
    return x, ei, y, split


@pytest.fixture(scope="module", params=sorted(MODELS))
def setup(request, data):
    x, ei, y, split = data
    make_jax, make_port = MODELS[request.param]
    jt = JTrainer(make_jax(), JGraph.from_numpy(x, ei), y, lr=LR,
                  weight_decay=WD)
    state = jt.init_state(0)
    rng = np.random.default_rng(5)

    def moved(a):
        # off the init by 0.05 to 0.1 each way, so that zero biases and unit
        # scales show; and so that no parameter sits near 0: the gradient of
        # a bias under a BatchNorm is 0 but for rounding, and Adam scales a
        # gradient of rounding noise to a step of lr, with its sign, unless
        # the L2 term (weight_decay · p) outweighs it
        step = rng.normal(0, 0.05, np.shape(a))
        return (np.asarray(a) + np.sign(step) * (0.05 + np.abs(step))
                ).astype(np.float32)

    params = jax.tree_util.tree_map(moved, state.params)
    kw = dict(dprate=0.0) if request.param == "gprgnn" else {}
    tt = FullBatchTrainer(make_port(dropout=0.0, **kw),
                          GraphData.from_numpy(x, ei, device="cpu"), y,
                          lr=LR, weight_decay=WD, device="cpu")
    return request.param, jt, tt, params, split


def test_adam_trajectory_matches_jax(setup):
    name, jt, tt, params, split = setup
    mask = idx_to_mask(split["train"], N)
    js = jt.init_state(0, init_params=params)
    ts = tt.init_state(0, init_params=params)
    for step in range(3):
        js, jl = jt.train_step(js, jax.random.PRNGKey(step),
                               jnp.asarray(mask))
        ts, tl = tt.train_step(ts, None, torch.from_numpy(mask))
        np.testing.assert_allclose(tl.item(), float(jl), **TOL,
                                   err_msg=f"loss at step {step}")
    want = W.zoo_state_dict_from_params(
        jax.tree_util.tree_map(np.asarray, js.params),
        jax.tree_util.tree_map(np.asarray,
                               (js.extra or {}).get("batch_stats")))
    got = ts.model.state_dict()
    assert set(want) == set(got)
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), value, **TOL,
                                   err_msg=key)
    if name == "gcn":
        assert "bn_0.running_mean" in want


def test_eval_with_the_jax_extra_matches(setup):
    """``evaluate_params(params, split, extra)`` as the JAX trainer's, with
    its ``batch_stats``."""
    name, jt, tt, params, split = setup
    js = jt.init_state(0, init_params=params)
    js, _ = jt.train_step(js, jax.random.PRNGKey(0),
                          jnp.asarray(idx_to_mask(split["train"], N)))
    extra = jax.tree_util.tree_map(np.asarray, js.extra)
    p = jax.tree_util.tree_map(np.asarray, js.params)
    ref, ref_out = jt.evaluate_params(p, split, extra=js.extra)
    got, out = tt.evaluate_params(p, split, extra=extra)
    np.testing.assert_allclose(out, np.asarray(ref_out), **TOL)
    assert got == pytest.approx(ref, abs=1e-6)


def test_trainer_builds_the_model_plan_once(data, monkeypatch):
    x, ei, y, split = data
    tt = FullBatchTrainer(Z.GAT(F, 8, C, device="cpu"),
                          GraphData.from_numpy(x, ei, device="cpu"), y,
                          device="cpu")
    built = []
    monkeypatch.setattr(Z, "gat_plan", lambda *a, **k: built.append(1))
    tt.fit(split, epochs=3)
    assert not built and tt.plan.plan.num_edges == ei.shape[1] + N


@pytest.mark.parametrize("name", ["gcn", "gat", "gcnjk"])
def test_epoch_block_fit_matches_the_loop(data, name):
    """With dropout on: the same losses and logged metrics, whether the
    epochs run one at a time or in blocks (on the CPU, eagerly)."""
    x, ei, y, split = data
    make = {"gcn": lambda: Z.GCN(F, 16, C, device="cpu"),
            "gat": lambda: Z.GAT(F, 8, C, device="cpu"),
            "gcnjk": lambda: Z.GCNJK(F, 16, C, jk_type="lstm",
                                     device="cpu")}[name]
    fits = []
    for block in (0, 4):
        tt = FullBatchTrainer(make(), GraphData.from_numpy(x, ei,
                                                           device="cpu"),
                              y, lr=LR, weight_decay=WD, device="cpu")
        log = RowLog()
        res = tt.fit(split, epochs=9, eval_step=2, epoch_block=block,
                     logger=log)[0]
        fits.append((res, log.rows, tt.model.state_dict()))
    (a, rows_a, sd_a), (b, rows_b, sd_b) = fits
    np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-6)
    np.testing.assert_allclose(rows_a, rows_b, atol=1e-6)
    assert a["epoch"] == b["epoch"]
    for key in sd_a:
        torch.testing.assert_close(sd_a[key], sd_b[key], msg=key)


def test_best_state_carries_the_running_statistics(data):
    x, ei, y, split = data
    tt = FullBatchTrainer(Z.MLP(F, 16, C, device="cpu"),
                          GraphData.from_numpy(x, ei, device="cpu"), y,
                          device="cpu", manireg=0.5)
    best = tt.fit(split, epochs=4, save_best=True)[0]
    assert "bn_0.running_mean" in best["params"]
    assert not torch.equal(best["params"]["bn_0.running_var"],
                           torch.ones(16))
