"""The port's partition (difformer_tpu_torch/parallel/partition.py) and its
C++ label propagation against the JAX package's, bit for bit.

Every array of the ``ShardedGraph`` (the halo plan, its overlap split and
the host-normalised edge values included) must equal the JAX package's, in
dtype and value, on 2, 4 and 8 shards, with and without the halo plan, at
``node_align`` 1 and 8, with a ``node_perm`` and with edge weights and
label masks; so must the layouts (``edge_balanced_layout``,
``locality_layout`` on the community order of both packages' C++ label
propagation), ``crossing_counts``, ``boundary_rows`` and
``shard_balance_stats``. The port's C++ label propagation is held to the
JAX package's C++ one on several graphs and at several thread counts.
"""

import dataclasses
import warnings

import numpy as np
import pytest

from difformer_tpu import native as jax_native
from difformer_tpu.parallel import partition as J
from difformer_tpu_torch import native
from difformer_tpu_torch.parallel import partition as P
import torch_port_helpers  # noqa: F401  (sets torch's threads)

SHARDS = [2, 4, 8]


def equal(a, b, what=""):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


def assert_same_partition(ours, theirs):
    for field in dataclasses.fields(P.ShardedGraph):
        equal(getattr(ours, field.name), getattr(theirs, field.name),
              field.name)


def block_graph(seed, n=240, blocks=12, e=1800, p_in=0.85):
    """Community graph: ``blocks`` groups of n / blocks nodes, a fraction
    p_in of edges inside a group, the node ids shuffled."""
    rng = np.random.default_rng(seed)
    size = n // blocks
    s = rng.integers(0, n, e)
    inside = rng.random(e) < p_in
    r = np.where(inside, (s // size) * size + rng.integers(0, size, e),
                 rng.integers(0, n, e))
    perm = rng.permutation(n)
    return perm[np.stack([s, r])], n


def random_graph(seed, n=150, e=700):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, n, e), rng.integers(0, n, e)]), n


def inputs(seed, n, f=5, c=3):
    rng = np.random.default_rng(100 + seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    y = rng.integers(0, c, n)
    return x, y, rng


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("build_halo", [False, True])
@pytest.mark.parametrize("node_align", [1, 8])
def test_partition_graph(shards, build_halo, node_align):
    ei, n = random_graph(shards + node_align)
    x, y, rng = inputs(shards, n)
    ew = rng.uniform(0.1, 2.0, ei.shape[1]).astype(np.float32)
    mask = rng.random(n) < 0.6
    for kw in ({}, {"labels": y}, {"labels": y, "label_mask": mask,
                                   "edge_weight": ew}):
        args = dict(build_halo=build_halo, node_align=node_align,
                    edge_pad_multiple=128, **kw)
        assert_same_partition(P.partition_graph(x, ei, shards, **args),
                              J.partition_graph(x, ei, shards, **args))


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("layout", ["edge_balanced", "locality"])
def test_partition_graph_with_a_node_perm(shards, layout):
    ei, n = block_graph(shards)
    x, y, rng = inputs(shards, n)
    ew = rng.uniform(0.1, 2.0, ei.shape[1]).astype(np.float32)
    ours = getattr(P, f"{layout}_layout")(ei, n, shards, node_align=8)
    theirs = getattr(J, f"{layout}_layout")(ei, n, shards, node_align=8)
    equal(ours[0], theirs[0], "node_perm")
    assert ours[1] == theirs[1]
    args = dict(labels=y, edge_weight=ew, build_halo=True,
                node_perm=ours[0], nodes_per_shard=ours[1])
    sg = P.partition_graph(x, ei, shards, **args)
    assert_same_partition(sg, J.partition_graph(x, ei, shards, **args))
    assert (P.boundary_rows(ei, ours[0], ours[1])
            == J.boundary_rows(ei, theirs[0], theirs[1])
            == int(sg.send_mask.sum()))
    assert P.shard_balance_stats(sg) == J.shard_balance_stats(
        J.partition_graph(x, ei, shards, **args))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_layouts_and_crossings(seed):
    ei, n = block_graph(seed, n=400, blocks=20, e=3000)
    equal(P.crossing_counts(ei, n), J.crossing_counts(ei, n))
    for shards in SHARDS:
        for align in (1, 8):
            for fn in ("edge_balanced_layout", "locality_layout"):
                ours = getattr(P, fn)(ei, n, shards, node_align=align)
                theirs = getattr(J, fn)(ei, n, shards, node_align=align)
                equal(ours[0], theirs[0], fn)
                assert ours[1] == theirs[1], fn
                assert (P.boundary_rows(ei, *ours)
                        == J.boundary_rows(ei, *theirs))
        for method in ("rcm", "bfs", "degree"):
            ours = P.locality_layout(ei, n, shards, method=method,
                                     balance_tol=0.15)
            theirs = J.locality_layout(ei, n, shards, method=method,
                                       balance_tol=0.15)
            equal(ours[0], theirs[0], method)
            assert ours[1] == theirs[1]


def test_locality_layout_falls_back_on_a_star():
    """A hub that receives every edge degenerates the degree-balanced
    cuts: both packages warn and cut the reordered graph evenly."""
    n = 64
    ei = np.stack([np.arange(1, n), np.zeros(n - 1, np.int64)])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ours = P.locality_layout(ei, n, 4, node_align=8)
        theirs = J.locality_layout(ei, n, 4, node_align=8)
    equal(ours[0], theirs[0])
    assert ours[1] == theirs[1]
    assert sum("degenerate" in str(w.message) for w in caught) == 2


def test_the_locality_layout_cuts_fewer_boundary_rows():
    ei, n = block_graph(7, n=480, blocks=8, e=4000, p_in=0.95)
    contiguous = P.boundary_rows(ei, np.arange(n), n // 4)
    perm, n_loc = P.locality_layout(ei, n, 4)
    assert P.boundary_rows(ei, perm, n_loc) < contiguous / 2


def test_shard_balance_stats():
    ei, n = random_graph(3)
    x, _, _ = inputs(3, n)
    for build_halo in (False, True):
        args = dict(build_halo=build_halo)
        assert (P.shard_balance_stats(P.partition_graph(x, ei, 4, **args))
                == J.shard_balance_stats(J.partition_graph(x, ei, 4,
                                                           **args)))


def test_rank_graph_slices_every_array():
    ei, n = random_graph(4)
    x, y, _ = inputs(4, n)
    sg = P.partition_graph(x, ei, 4, labels=y, build_halo=True)
    for rank in range(4):
        rg = sg.rank_graph(rank, "cpu")
        for name in ("node_feat", "senders", "send_idx", "bnd_value"):
            equal(getattr(rg, name).numpy(), getattr(sg, name)[rank], name)
        senders, halo = rg.senders_and_halo()
        assert isinstance(halo, dict) and senders is rg.senders_table
        _, halo = sg.without_overlap().rank_graph(rank).senders_and_halo()
        assert isinstance(halo, tuple) and len(halo) == 3
    plain = P.partition_graph(x, ei, 4).rank_graph(1)
    assert plain.senders_and_halo() == (plain.senders, None)
    with pytest.raises(ValueError):
        sg.rank_graph(4)


def lp_graphs():
    rng = np.random.default_rng(11)
    yield "empty", np.zeros((2, 0), np.int64), 9
    yield "self loops", np.stack([np.arange(12)] * 2), 12
    ei, n = block_graph(3, n=600, blocks=15, e=5000)
    yield "blocks", ei, n
    yield "random", rng.integers(0, 3000, (2, 12000)), 3000
    yield "chain", np.stack([np.arange(199), np.arange(1, 200)]), 200
    # more nodes than one thread's chunk of 4096
    yield "large", rng.integers(0, 20000, (2, 60000)), 20000


@pytest.mark.parametrize("iters", [1, 10])
def test_native_label_propagation_matches_the_jax_package(iters):
    assert native.available(), native.load_error
    assert jax_native.available()
    for name, ei, n in lp_graphs():
        theirs = jax_native.label_propagation(ei[0], ei[1], n, iters=iters)
        for threads in (1, 2, 5):
            ours = native.label_propagation(ei[0], ei[1], n, iters=iters,
                                            threads=threads)
            equal(ours, theirs, f"{name}, {threads} threads")


def test_native_label_propagation_checks_its_edges():
    with pytest.raises(ValueError, match="lie in"):
        native.label_propagation(np.array([0, 5]), np.array([1, 2]), 5)


@pytest.mark.parametrize("shards", SHARDS)
def test_collective_bytes_per_layer(shards):
    from difformer_tpu.parallel.sharded_ops import (
        collective_bytes_per_layer as jax_bytes)
    from difformer_tpu_torch.parallel.sharded_ops import (
        collective_bytes_per_layer)

    ei, n = block_graph(shards)
    x, _, _ = inputs(shards, n)
    for build_halo in (False, True):
        ours = P.partition_graph(x, ei, shards, build_halo=build_halo)
        theirs = J.partition_graph(x, ei, shards, build_halo=build_halo)
        for kw in ({"feat_dim": 64}, {"feat_dim": 9, "num_heads": 2,
                                      "dtype_bytes": 2}):
            assert (collective_bytes_per_layer(ours, **kw)
                    == jax_bytes(theirs, **kw))
