"""The port's host data and graph ops against the JAX package's.

Inputs are made with numpy from a seed and given to both packages; the port
runs on the CPU. Host data must be equal; the graph ops agree to
rtol 1e-5 / atol 1e-6 (float32, same arithmetic, another summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difformer_tpu.data import graph as jgraph
from difformer_tpu.data import splits as jsplits
from difformer_tpu.data import synthetic as jsynth
from difformer_tpu.data import transforms as jtrans
from difformer_tpu.ops import graph_ops as jops
from difformer_tpu.ops import segment as jseg
from difformer_tpu_torch.data import graph as tgraph
from difformer_tpu_torch.data import splits as tsplits
from difformer_tpu_torch.data import synthetic as tsynth
from difformer_tpu_torch.data import transforms as ttrans
from difformer_tpu_torch.ops import graph_ops as tops
from difformer_tpu_torch.ops import segment as tseg

RTOL, ATOL = 1e-5, 1e-6


def _graph(seed=3, n=60, e=240, f=5, c=4):
    x, ei, y = jsynth.random_graph(n, e, f, c, seed=seed, homophily=0.7)
    return x, jtrans.standard_preprocess(ei, n), y


@pytest.mark.parametrize("seed", [0, 42])
def test_random_graph_equal(seed):
    a = jsynth.random_graph(300, 1200, 16, 5, seed=seed, homophily=0.8)
    b = tsynth.random_graph(300, 1200, 16, 5, seed=seed, homophily=0.8)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_preprocess_equal():
    _, ei, _ = jsynth.random_graph(200, 900, 4, 3, seed=1)
    ei[1, :20] = ei[0, :20]  # some self loops to drop
    for fn in ("to_undirected", "remove_self_loops"):
        a, b = getattr(jtrans, fn)(ei), getattr(ttrans, fn)(ei)
        a, b = (a[0], b[0]) if isinstance(a, tuple) else (a, b)
        np.testing.assert_array_equal(a, b)
    w = np.linspace(0.5, 1.5, ei.shape[1]).astype(np.float32)
    for x, y in zip(jtrans.add_self_loops(ei, 200, w),
                    ttrans.add_self_loops(ei, 200, w)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(jtrans.standard_preprocess(ei, 200),
                                  ttrans.standard_preprocess(ei, 200))


@pytest.mark.parametrize("test_rest", [False, True])
def test_class_rand_splits_equal(test_rest):
    _, _, y = jsynth.random_graph(2708, 100, 2, 7, seed=42)
    a = jsplits.class_rand_splits(y, 20, test_rest=test_rest, rng=7)
    b = tsplits.class_rand_splits(y, 20, test_rest=test_rest, rng=7)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("with_weight", [False, True])
def test_graph_data_from_numpy_equal(with_weight):
    x, ei, _ = _graph()
    w = (np.random.default_rng(0).random(ei.shape[1]).astype(np.float32)
         if with_weight else None)
    a = jgraph.GraphData.from_numpy(x, ei, w)
    b = tgraph.GraphData.from_numpy(x, ei, w, device="cpu")
    assert b.num_nodes == a.num_nodes and a.edges_sorted
    assert b.senders.dtype == torch.int64
    for name in ("node_feat", "senders", "receivers", "edge_weight"):
        ja, tb = getattr(a, name), getattr(b, name)
        if ja is None:
            assert tb is None
            continue
        np.testing.assert_array_equal(np.asarray(ja), tb.numpy())
    moved = b.to("cpu")
    assert moved is not b and torch.equal(moved.senders, b.senders)


def test_segment_sum_matches():
    rng = np.random.default_rng(0)
    data = rng.normal(size=(50, 3, 4)).astype(np.float32)
    ids = rng.integers(0, 9, size=50).astype(np.int64)
    a = jseg.segment_sum(jnp.asarray(data), jnp.asarray(ids, jnp.int32), 11)
    b = tseg.segment_sum(torch.from_numpy(data), torch.from_numpy(ids), 11)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=ATOL)


def _edge_inputs(with_weight, with_mask):
    x, ei, _ = _graph(seed=5)
    g = jgraph.GraphData.from_numpy(x, ei)
    e = ei.shape[1]
    rng = np.random.default_rng(1)
    w = rng.random(e).astype(np.float32) if with_weight else None
    mask = (rng.random(e) > 0.2) if with_mask else None
    s, r = np.asarray(g.senders), np.asarray(g.receivers)
    return s, r, w, mask, x.shape[0]


@pytest.mark.parametrize("with_weight", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_gcn_norm_weights_match(with_weight, with_mask):
    s, r, w, mask, n = _edge_inputs(with_weight, with_mask)
    # an isolated receiver (degree 0) exercises the non-finite -> 0 rule
    n = n + 1
    a = jops.gcn_norm_weights_masked(
        jnp.asarray(s), jnp.asarray(r), n,
        None if w is None else jnp.asarray(w),
        None if mask is None else jnp.asarray(mask))
    b = tops.gcn_norm_weights_masked(
        torch.from_numpy(s.astype(np.int64)),
        torch.from_numpy(r.astype(np.int64)), n,
        None if w is None else torch.from_numpy(w),
        None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        tops.degree(torch.from_numpy(r.astype(np.int64)), n).numpy(),
        np.asarray(jops.degree(jnp.asarray(r), n)), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("trailing", [(6,), (2, 5)])
def test_gcn_conv_matches(with_mask, trailing):
    s, r, w, mask, n = _edge_inputs(True, with_mask)
    xv = np.random.default_rng(2).normal(size=(n,) + trailing).astype(
        np.float32)
    a = jops.gcn_conv(jnp.asarray(xv), jnp.asarray(s), jnp.asarray(r),
                      jnp.asarray(w),
                      edge_mask=None if mask is None else jnp.asarray(mask))
    b = tops.gcn_conv(torch.from_numpy(xv),
                      torch.from_numpy(s.astype(np.int64)),
                      torch.from_numpy(r.astype(np.int64)),
                      torch.from_numpy(w),
                      edge_mask=None if mask is None
                      else torch.from_numpy(mask))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=ATOL)
