"""The port's FullBatchTrainer against the JAX package's: 5 Adam steps at
dropout 0 from carried weights give the same per-step losses and the same
final parameters (rtol 2e-4 / atol 2e-5, tests/test_reference_exec.py:334),
and ``fit`` picks the same best epoch. The port runs on the CPU."""

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

TOL = dict(rtol=2e-4, atol=2e-5)
N, F, C = 200, 16, 4
LR, WD = 1e-3, 0.01


@pytest.fixture(scope="module")
def setup():
    x, ei, y = random_graph(N, 800, F, C, seed=0, homophily=0.8)
    ei = standard_preprocess(ei, N)
    split = class_rand_splits(y, 10, valid_num=60, test_num=80, rng=0)
    kw = dict(num_layers=2, num_heads=2, kernel="sigmoid", dropout=0.0,
              graph_weight=0.7)
    jm = JDIFFormer(hidden_channels=16, out_channels=C, **kw)
    jt = JTrainer(jm, JGraph.from_numpy(x, ei), y, lr=LR, weight_decay=WD)
    params = jax.tree_util.tree_map(np.asarray, jt.init_state(0).params)
    tm = DIFFormer(F, 16, C, device="cpu", **kw)
    tt = FullBatchTrainer(tm, GraphData.from_numpy(x, ei, device="cpu"), y,
                          lr=LR, weight_decay=WD, device="cpu")
    return jt, tt, params, split


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
    jt, tt, params, split = setup
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
    jt, tt, params, split = setup
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
