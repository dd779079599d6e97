"""The port's metrics against the JAX package's, on seeded numpy inputs.

The host metrics are numpy in both packages and must agree exactly (ties,
NaN labels, a task with one class). ``device_rocauc_tasks`` is float32 in
both and is held to 1e-5 against JAX's and against the float64 host AUC,
as the JAX package holds its own. ``_device_split_metrics`` is held to the
host ``METRICS`` and to JAX's at 1e-6 (acc: exact counts over float32
division), mse at rtol 1e-5, rocauc at 2e-5 (tests/test_trainer.py:125).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difformer_tpu.utils import metrics as jm
from difformer_tpu_torch.utils import metrics as tm
import torch_port_helpers  # noqa: F401  (sets torch's threads)

N, C, T = 90, 5, 4


def _scores(seed, shape, ties=False):
    rng = np.random.default_rng(seed)
    s = rng.normal(size=shape).astype(np.float32)
    if ties:  # a few values only, so most scores tie
        s = np.round(s * 2) / 2
    return s


def _binary(seed, shape, nan=False, single_class_task=False):
    rng = np.random.default_rng(seed)
    y = (rng.random(shape) < 0.4).astype(np.float32)
    if nan:
        y[rng.random(shape) < 0.15] = np.nan
    if single_class_task:
        y[:, 1] = 1.0
    return y


@pytest.mark.parametrize("average", ["micro", "macro"])
@pytest.mark.parametrize("seed", [0, 1])
def test_eval_f1_matches(seed, average):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, C, N)
    pred = _scores(seed + 10, (N, C))
    assert tm.eval_f1(y, pred, average) == jm.eval_f1(y, pred, average)


@pytest.mark.parametrize("ties", [False, True])
def test_roc_auc_score_matches(ties):
    y = _binary(2, (N,))
    s = _scores(3, (N,), ties=ties)
    assert tm.roc_auc_score(y, s) == jm.roc_auc_score(y, s)
    with pytest.raises(ValueError):
        tm.roc_auc_score(np.ones(5), np.arange(5.0))


@pytest.mark.parametrize("case", ["multilabel", "ties", "nan-labels",
                                  "single-class-task", "one-column"])
def test_eval_rocauc_matches(case):
    if case == "one-column":  # softmax probability of class 1
        y = np.random.default_rng(4).integers(0, 2, N)
        pred = _scores(5, (N, 2))
    else:
        y = _binary(6, (N, T), nan=case == "nan-labels",
                    single_class_task=case == "single-class-task")
        pred = _scores(7, (N, T), ties=case == "ties")
    assert tm.eval_rocauc(y, pred) == jm.eval_rocauc(y, pred)


def test_eval_rocauc_without_a_defined_task_raises():
    with pytest.raises(RuntimeError):
        tm.eval_rocauc(np.ones((10, 2)), _scores(8, (10, 2)))


@pytest.mark.parametrize("shape", [(N,), (N, 3)])
def test_eval_mse_matches(shape):
    y, pred = _scores(9, shape), _scores(10, shape)
    assert tm.eval_mse(y, pred) == jm.eval_mse(y, pred)


def test_metrics_registry():
    assert set(tm.METRICS) == set(jm.METRICS)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("single_class_task", [False, True])
def test_device_rocauc_tasks_matches_jax_and_host(ties, single_class_task):
    scores = _scores(11, (N, T), ties=ties)
    labels = _binary(12, (N, T), single_class_task=single_class_task)
    mask = np.random.default_rng(13).random(N) < 0.6
    got = tm.device_rocauc_tasks(torch.from_numpy(scores),
                                 torch.from_numpy(labels),
                                 torch.from_numpy(mask)).item()
    want = float(jm.device_rocauc_tasks(jnp.asarray(scores),
                                        jnp.asarray(labels),
                                        jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    host = jm.eval_rocauc(labels[mask], scores[mask])
    np.testing.assert_allclose(got, host, rtol=0, atol=1e-5)


def test_device_rocauc_midranks_are_exact():
    """A run of tied scores takes the mean of its positions' ranks: with
    every score tied, each task's AUC is exactly 0.5."""
    scores = np.zeros((40, 3), np.float32)
    labels = _binary(14, (40, 3))
    got = tm.device_rocauc_tasks(torch.from_numpy(scores),
                                 torch.from_numpy(labels),
                                 torch.ones(40, dtype=torch.bool))
    assert got.item() == 0.5


def _trainers(metric, loss):
    """A JAX and a port trainer on one small graph, for their
    ``_device_split_metrics`` (which reads only the metric name)."""
    from difformer_tpu.data.graph import GraphData as JGraph
    from difformer_tpu.nn.difformer import DIFFormer as JDIFFormer
    from difformer_tpu.train.trainer import FullBatchTrainer as JTrainer
    from difformer_tpu_torch import DIFFormer, FullBatchTrainer, GraphData

    rng = np.random.default_rng(15)
    x = rng.normal(size=(20, 4)).astype(np.float32)
    ei = np.stack([np.arange(20), (np.arange(20) + 1) % 20])
    y = rng.integers(0, C, 20)
    jt = JTrainer(JDIFFormer(hidden_channels=8, out_channels=C, num_layers=1),
                  JGraph.from_numpy(x, ei), y, metric=metric, loss=loss)
    tt = FullBatchTrainer(DIFFormer(4, 8, C, num_layers=1, device="cpu"),
                          GraphData.from_numpy(x, ei, device="cpu"), y,
                          metric=metric, loss=loss, device="cpu")
    return jt, tt


@pytest.mark.parametrize("case", ["acc-int", "acc-onehot", "mse", "rocauc"])
def test_device_split_metrics_match_host_and_jax(case):
    metric = case.split("-")[0]
    jt, tt = _trainers(metric, {"mse": "mse", "rocauc": "bce"}.get(metric,
                                                                   "nll"))
    rng = np.random.default_rng(16)
    out = rng.normal(size=(N, C if metric != "rocauc" else T))
    out = out.astype(np.float32)
    masks = rng.random((3, N)) < 0.5
    masks[:, 0] = True  # no empty split
    labels_int = rng.integers(0, C, N)
    if case == "acc-int":
        labels, host_labels = labels_int, labels_int
    elif case == "acc-onehot":
        labels, host_labels = np.eye(C, dtype=np.float32)[labels_int], \
            labels_int
    elif case == "mse":
        labels = host_labels = rng.normal(size=(N, C)).astype(np.float32)
    else:
        labels = host_labels = _binary(17, (N, T))
    got = tt._device_split_metrics(torch.from_numpy(out),
                                   torch.from_numpy(labels),
                                   torch.from_numpy(masks)).numpy()
    want_jax = np.asarray(jt._device_split_metrics(
        jnp.asarray(out), jnp.asarray(labels), jnp.asarray(masks)))
    want_host = [tm.METRICS[metric](host_labels[m], out[m]) for m in masks]
    tol = {"acc": dict(rtol=0, atol=1e-6), "mse": dict(rtol=1e-5),
           "rocauc": dict(rtol=0, atol=2e-5)}[metric]
    np.testing.assert_allclose(got, want_host, **tol)
    np.testing.assert_allclose(got, want_jax, **tol)
