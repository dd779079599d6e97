"""The node-sharded block-sparse hybrid's host side and K7's rectangular
form against the JAX package and dense products, on the CPU (one process;
the collectives are tests/test_torch_port_sharded.py's).

- ``build_bsr_gcn_sharded`` bit-equal to the JAX package's for int8 count
  blocks (unweighted graphs), value blocks (weighted, or asked for), and
  the rebuild with value blocks of a multigraph whose tile holds more
  than 127 parallel edges; each rank's ``rank_shard`` the JAX shard's
  leaves with the residual's rectangular K1 plan;
- one rank's rows of the sharded product (``bsr_shard_apply`` on the
  gathered operand, K7's plain version and K1's) against a dense product
  of the whole graph's normalised adjacency, and K7's rectangular plain
  version (``num_rows``, ``row_scale``, ``col_scale``) against a dense
  product of its blocks at W = 1, 16 and 65;
- the split plan and the combine on a rectangular shard whose hub row
  tile splits (rows_per ≠ N): split + combine equal to the unsplit plain
  version at W = 64 and 65; the wrappers' checks of the new shapes.
"""

import numpy as np
import pytest
import torch

from difformer_tpu.ops import bsr as JB
from difformer_tpu_torch.kernels import bsr as K7
from difformer_tpu_torch.ops import bsr as B
import torch_port_helpers  # noqa: F401  (sets torch's threads)

H100_SMS = 132
TOL = dict(rtol=1e-5, atol=1e-5)
N, TILE, MIN_EDGES = 512, 32, 6


def _clustered(seed=0, n=N):
    from test_bsr import _clustered as clustered

    return clustered(n, 64, seed=seed, p_in=0.25, n_cross=300)


def _hub(n=N, tile=TILE, seed=4):
    """A graph whose first row tile reads every column tile densely, the
    rest block-diagonal: the hub row tile holds n / tile blocks."""
    rng = np.random.default_rng(seed)
    hub = np.nonzero(rng.random((tile, n)) < 0.5)
    ei = [np.stack([hub[1], hub[0]]), _clustered(seed, n)]
    return np.concatenate(ei, 1)


def _assert_same_shard(jd, d):
    for name in ("blocks", "block_col", "res_point", "res_owner", "res_val",
                 "inv_rows", "inv_cols"):
        a, b = getattr(jd, name), getattr(d, name)
        if a is None:
            assert b is None, name
            continue
        a = np.asarray(a)
        b = b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (d.num_rows, d.num_cols, d.tile) == (jd.num_rows, jd.num_cols,
                                                jd.tile)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", ["int8", "values", "weighted"])
def test_sharded_build_is_bit_equal_to_jax(world, kind):
    ei = _clustered(seed=world)
    kw = dict(tile=TILE, min_edges=MIN_EDGES)
    if kind == "values":
        kw["scaled_int8"] = False
    if kind == "weighted":
        kw["edge_weight"] = np.random.default_rng(world).random(
            ei.shape[1]).astype(np.float32)
    ours = B.build_bsr_gcn_sharded(ei[0], ei[1], N, world, **kw)
    theirs = JB.build_bsr_gcn_sharded(ei[0], ei[1], N, world, **kw)
    assert ours[2] == theirs[2] == -(-N // (world * TILE)) * TILE
    for d, jd in zip(ours[:2], theirs[:2]):
        _assert_same_shard(jd, d)
        assert (d.blocks.dtype == torch.int8) == (kind == "int8")
        assert d.blocks.shape[0] == world and d.plan is None


def test_sharded_build_rebuilds_an_overflowing_multigraph(monkeypatch):
    # > 127 parallel edges in a tile: both packages rebuild with value
    # blocks at the default threshold, which is the cost model's (the JAX
    # package's here, so that the two rebuilds agree)
    monkeypatch.setattr(B, "_EDGE_EQUIV_BYTES", JB._EDGE_EQUIV_BYTES)
    n, tile = 128, 32
    s = np.concatenate([np.repeat(np.arange(32), 4), np.full(300, 5)])
    r = np.concatenate([np.tile(np.arange(4), 32), np.full(300, 2)])
    ours = B.build_bsr_gcn_sharded(s, r, n, 2, tile=tile, min_edges=8)
    theirs = JB.build_bsr_gcn_sharded(s, r, n, 2, tile=tile, min_edges=8)
    for d, jd in zip(ours[:2], theirs[:2]):
        assert d.inv_rows is None and d.blocks.dtype == torch.float32
        _assert_same_shard(jd, d)


def _dense_gcn(ei, n, pad_n):
    """The reference-normalised adjacency [pad_n, pad_n], float64."""
    deg = np.bincount(ei[1], minlength=n).astype(np.float64)
    inv = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1)), 0.0)
    a = np.zeros((pad_n, pad_n))
    np.add.at(a, (ei[1], ei[0]), inv[ei[1]] * inv[ei[0]])
    return a


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("int8", ["auto", False])
def test_rank_shards_give_the_rows_of_the_whole_product(world, int8):
    ei = _clustered(seed=7)
    fwd, rev, rows_per = B.build_bsr_gcn_sharded(
        ei[0], ei[1], N, world, tile=TILE, min_edges=MIN_EDGES,
        scaled_int8=int8)
    pad_n = rows_per * world
    x = np.zeros((pad_n, 16), np.float32)
    x[:N] = np.random.default_rng(world).normal(size=(N, 16))
    a = _dense_gcn(ei, N, pad_n)
    for direction, dense in ((fwd, a), (rev, a.T)):
        want = dense @ x
        for rank in range(world):
            d = direction.rank_shard(rank, None, "cpu")
            assert d.plan.num_nodes == rows_per and d.plan.num_cols == pad_n
            got = B.bsr_shard_apply(d, torch.from_numpy(x)).numpy()
            np.testing.assert_allclose(
                got, want[rank * rows_per:(rank + 1) * rows_per], **TOL)


def _dense_blocks(blocks, bcol, num_rows, num_cols, tile):
    out = np.zeros((num_rows, num_cols))
    for i in range(blocks.shape[0]):
        for k in range(blocks.shape[1]):
            c = int(bcol[i, k]) * tile
            out[i * tile:(i + 1) * tile, c:c + tile] += blocks[i, k]
    return out


@pytest.mark.parametrize("width", [1, 16, 65])
def test_rectangular_plain_version_is_a_dense_product(width):
    gen = torch.Generator().manual_seed(width)
    rows, cols, tile, kb = 96, 160, 32, 3
    blocks = torch.randint(0, 4, (rows // tile, kb, tile, tile),
                           dtype=torch.int8, generator=gen)
    bcol = torch.randint(0, cols // tile, (rows // tile, kb),
                         dtype=torch.int32, generator=gen)
    x = torch.randn((cols, width), generator=gen)
    row_scale = torch.rand(rows, generator=gen)
    col_scale = torch.rand(cols, generator=gen)
    dense = _dense_blocks(blocks.numpy().astype(np.float64), bcol.numpy(),
                          rows, cols, tile)
    want = (row_scale.double().numpy()[:, None] * dense
            * col_scale.double().numpy()[None]) @ x.double().numpy()
    got = K7.bsr_spmm_blocks(x, [(blocks, bcol, None)], tile, num_rows=rows,
                             row_scale=row_scale, col_scale=col_scale)
    assert got.shape == (rows, width) and not any(K7.LAUNCHES.values())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # value blocks need no scale; out's rows may end inside a row tile
    values = torch.randn((rows // tile, kb, tile, tile), generator=gen)
    got = K7.bsr_spmm_blocks(x, [(values, bcol, None)], tile,
                             num_rows=rows - 5)
    dense = _dense_blocks(values.double().numpy(), bcol.numpy(), rows, cols,
                          tile)
    np.testing.assert_allclose(got.numpy(), (dense @ x.double().numpy())[
        :rows - 5], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("width", [64, 65])
@pytest.mark.parametrize("int8", ["auto", False])
def test_split_and_combine_on_a_rectangular_shard(width, int8):
    ei = _hub()
    fwd, _, rows_per = B.build_bsr_gcn_sharded(
        ei[0], ei[1], N, 2, tile=TILE, min_edges=MIN_EDGES, scaled_int8=int8)
    d = fwd.rank_shard(0, None, "cpu")
    groups = d.groups()
    chunks = K7.split_plan(K7.group_shapes(groups), TILE, width, H100_SMS)
    assert rows_per != N and d.blocks.shape[1] > K7.SPLIT_BLOCKS
    assert chunks[0] > 1
    x = torch.randn((rows_per * 2, width),
                    generator=torch.Generator().manual_seed(width))
    kw = dict(num_rows=rows_per, row_scale=d.inv_rows, col_scale=d.inv_cols)
    out, partial = K7.bsr_spmm_split(x, groups, TILE, chunks, **kw)
    assert out.shape == (rows_per, width)
    assert partial.numel() == K7.partial_offsets(groups, chunks, TILE,
                                                 width)[1]
    out = K7.bsr_spmm_combine(partial, out, groups, TILE, chunks,
                              scale=d.inv_rows)
    want = K7.bsr_spmm_blocks_plain(x, groups, TILE, **kw)
    np.testing.assert_allclose(out.numpy(), want.numpy(), **TOL)
    plan, bands = K7.combine_plan(groups, chunks, TILE, width)
    assert bands == (rows_per // TILE) * -(-TILE // K7.combine_rows(width))


def test_wrappers_check_the_rectangular_shapes():
    x = torch.zeros(64, 8)
    bcol = torch.zeros((2, 1), dtype=torch.int32)
    groups = [(torch.zeros((2, 1, 16, 16), dtype=torch.int8), bcol, None)]
    with pytest.raises(ValueError, match="row_scale must be float32 \\[32\\]"):
        K7.bsr_spmm_blocks(x, groups, 16, num_rows=32,
                           row_scale=torch.ones(64), col_scale=torch.ones(64))
    with pytest.raises(ValueError, match="col_scale must be float32 \\[64\\]"):
        K7.bsr_spmm_blocks(x, groups, 16, num_rows=32,
                           row_scale=torch.ones(32), col_scale=torch.ones(32))
    with pytest.raises(ValueError, match="not both"):
        K7.bsr_spmm_blocks(x, groups, 16, scale=torch.ones(64),
                           row_scale=torch.ones(64))
    with pytest.raises(ValueError, match="2 row tiles for 16 rows"):
        K7.bsr_spmm_blocks(x, groups, 16, num_rows=16)
    # the square call: one scale for x's rows and out's
    square = [(torch.ones((4, 1, 16, 16), dtype=torch.int8),
               torch.zeros((4, 1), dtype=torch.int32), None)]
    scale = torch.rand(64)
    np.testing.assert_array_equal(
        K7.bsr_spmm_blocks(x + 1, square, 16, scale=scale).numpy(),
        K7.bsr_spmm_blocks(x + 1, square, 16, num_rows=64, row_scale=scale,
                           col_scale=scale).numpy())
    # a shard of every rank is no rank's
    ei = _clustered()
    fwd, rev, _ = B.build_bsr_gcn_sharded(ei[0], ei[1], N, 2, tile=TILE,
                                          min_edges=MIN_EDGES)
    with pytest.raises(ValueError, match="rank_shard"):
        B.bsr_shard_apply(fwd, torch.zeros(N, 4))
