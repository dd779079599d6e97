"""The port's host transforms and splits (difformer_tpu_torch/data/
transforms.py, splits.py, graph.py's NodeDataset) against the JAX
package's on the same numpy inputs: exact equality.

``label_propagation`` and ``locality_reorder("community")`` are held
against the JAX functions on both of their paths: the C++ one, which both
packages take by default where their native library is loaded, and the
numpy one (``use_native=False``; switched on in both packages with
monkeypatch for ``locality_reorder``). The two paths give other
communities (tests/test_native.py).
"""

import functools

import numpy as np
import pytest

from difformer_tpu.data import graph as jax_graph
from difformer_tpu.data import splits as jax_splits
from difformer_tpu.data import transforms as jax_T
from difformer_tpu_torch.data import graph, splits
from difformer_tpu_torch.data import transforms as T
from difformer_tpu_torch.data.synthetic import random_graph
import torch_port_helpers  # noqa: F401  (sets torch's threads)


def equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def blocks_graph(seed=0, n=240, blocks=6, inner=900, cross=120):
    """A graph of dense blocks with a few edges between them (community
    structure) and a couple of isolated nodes."""
    rng = np.random.default_rng(seed)
    size = (n - 2) // blocks
    b = rng.integers(0, blocks, inner)
    src = b * size + rng.integers(0, size, inner)
    dst = b * size + rng.integers(0, size, inner)
    cs, cd = rng.integers(0, n - 2, (2, cross))
    ei = np.stack([np.concatenate([src, cs]), np.concatenate([dst, cd])])
    perm = rng.permutation(n)  # hide the blocks behind a random numbering
    return perm[ei].astype(np.int64), n


@pytest.fixture
def numpy_paths(monkeypatch):
    """Both packages' ``label_propagation`` on their numpy paths."""
    for module in (jax_T, T):
        monkeypatch.setattr(module, "label_propagation", functools.partial(
            module.label_propagation, use_native=False))


def test_normalize_feat():
    rng = np.random.default_rng(0)
    x = rng.random((30, 7)).astype(np.float32)
    x[3] = 0.0
    equal(T.normalize_feat(x), jax_T.normalize_feat(x))
    equal(T.normalize_feat(x.astype(np.float64)),
          jax_T.normalize_feat(x.astype(np.float64)))


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("include_self,loop", [(True, False), (False, False),
                                               (False, True)])
@pytest.mark.parametrize("n,k", [(50, 5), (7, 10), (600, 3)])
def test_knn_graph(metric, include_self, loop, n, k):
    x = np.random.default_rng(n).normal(size=(n, 12)).astype(np.float32)
    got = T.knn_graph(x, k, include_self=include_self, loop=loop,
                      metric=metric)
    equal(got, jax_T.knn_graph(x, k, include_self=include_self, loop=loop,
                               metric=metric))
    assert got.shape == (2, n * min(k, n))


def test_knn_graph_rejects_unknown_metric():
    with pytest.raises(ValueError):
        T.knn_graph(np.zeros((4, 2), np.float32), 2, metric="manhattan")


@pytest.mark.parametrize("method", ["rcm", "bfs", "degree", "community"])
@pytest.mark.parametrize("seed", [0, 1])
def test_locality_reorder(method, seed):
    ei, n = blocks_graph(seed)
    perm = T.locality_reorder(ei, n, method=method)
    equal(perm, jax_T.locality_reorder(ei, n, method=method))
    np.testing.assert_array_equal(np.sort(perm), np.arange(n))


@pytest.mark.parametrize("seed", [0, 1])
def test_locality_reorder_community_numpy_path(numpy_paths, seed):
    ei, n = blocks_graph(seed)
    perm = T.locality_reorder(ei, n, method="community")
    equal(perm, jax_T.locality_reorder(ei, n, method="community"))
    np.testing.assert_array_equal(np.sort(perm), np.arange(n))


def test_locality_reorder_on_a_random_graph():
    _, ei, _ = random_graph(500, 2000, 4, 3, seed=9)
    ei = T.standard_preprocess(ei, 500)
    for method in ("rcm", "bfs", "degree", "community"):
        equal(T.locality_reorder(ei, 500, method=method),
              jax_T.locality_reorder(ei, 500, method=method))


def test_locality_reorder_rejects_unknown_method():
    with pytest.raises(ValueError, match="unknown reorder method"):
        T.locality_reorder(np.zeros((2, 1), np.int64), 2, method="metis")


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("iters", [1, 10])
def test_label_propagation_matches_the_numpy_path(seed, iters):
    ei, n = blocks_graph(seed)
    equal(T.label_propagation(ei, n, iters=iters, seed=seed,
                              use_native=False),
          jax_T.label_propagation(ei, n, iters=iters, seed=seed,
                                  use_native=False))


def test_label_propagation_without_edges():
    loops = np.stack([np.arange(5), np.arange(5)])
    for ei in (np.zeros((2, 0), np.int64), loops):
        for use_native in (None, False):
            equal(T.label_propagation(ei, 5, use_native=use_native),
                  jax_T.label_propagation(ei, 5, use_native=use_native))


def test_community_chain_order():
    ei, n = blocks_graph(4)
    labels = jax_T.label_propagation(ei, n, use_native=False)
    equal(T._community_chain_order(ei, labels, n),
          jax_T._community_chain_order(ei, labels, n))


def test_permute_graph():
    ei, n = blocks_graph(5)
    rng = np.random.default_rng(5)
    perm = rng.permutation(n)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    y = rng.integers(0, 4, n)
    for a, b in zip(T.permute_graph(perm, ei, x, y),
                    jax_T.permute_graph(perm, ei, x, y)):
        equal(a, b)


@pytest.mark.parametrize("seed", [0, 1])
def test_rand_train_test_idx(seed):
    label = np.random.default_rng(seed).integers(-1, 4, 101)
    for kw in ({}, {"train_prop": 0.6, "valid_prop": 0.2},
               {"ignore_negative": False}):
        got = splits.rand_train_test_idx(label, rng=seed, **kw)
        expect = jax_splits.rand_train_test_idx(label, rng=seed, **kw)
        assert set(got) == set(expect)
        for k in got:
            equal(got[k], expect[k])
    two_d = np.stack([label, label], 1)
    equal(splits.rand_train_test_idx(two_d, rng=1)["test"],
          jax_splits.rand_train_test_idx(two_d, rng=1)["test"])


@pytest.mark.parametrize("nclasses", [2, 5])
def test_even_quantile_labels(nclasses):
    vals = np.random.default_rng(nclasses).integers(1990, 2020, 200)
    equal(splits.even_quantile_labels(vals, nclasses),
          jax_splits.even_quantile_labels(vals, nclasses))


def test_node_dataset_splits_and_graph():
    x, ei, y = random_graph(120, 400, 6, 3, seed=2)
    port, ref = graph.NodeDataset("toy"), jax_graph.NodeDataset("toy")
    for ds in (port, ref):
        ds.graph = {"edge_index": ei, "node_feat": x, "edge_feat": None,
                    "num_nodes": 120}
        ds.label = y
    assert repr(port) == repr(ref) and len(port) == 1
    for kind, kw in (("random", dict(train_prop=0.4, valid_prop=0.3)),
                     ("class", dict(label_num_per_class=7))):
        a = port.get_idx_split(kind, rng=3, **kw)
        b = ref.get_idx_split(kind, rng=3, **kw)
        for k in ("train", "valid", "test"):
            equal(a[k], b[k])
    with pytest.raises(ValueError, match="no fixed splits"):
        port.get_idx_split("fixed")
    port._fixed_splits = {"train": np.arange(3)}
    assert port.get_idx_split("fixed") is port._fixed_splits
    with pytest.raises(ValueError):
        port.get_idx_split("temporal")

    g = port.to_graph_data(device="cpu")
    jg = ref.to_graph_data()
    np.testing.assert_array_equal(g.senders.numpy(), np.asarray(jg.senders))
    np.testing.assert_array_equal(g.receivers.numpy(),
                                  np.asarray(jg.receivers))
    np.testing.assert_array_equal(g.node_feat.numpy(),
                                  np.asarray(jg.node_feat))
    assert g.num_nodes == jg.num_nodes == 120
