"""K7's split of hub row tiles and its widths, on the CPU: the host's split
plan (``difformer_tpu_torch/kernels/bsr.py``: ``split_plan``,
``chunk_ranges``, ``column_tile``), the plain versions of the kernel's two
launches (the chunks' partial sums and their combine, in the kernel's
order) and the plain product at the widths the kernel stages or pads,
against the JAX package's ``_bsr_matvec`` and ``_bsr_bucketed_matvec``
(``difformer_tpu/ops/bsr.py``) at rtol 2e-4 / atol 2e-5 (the port's test
tolerance, ROADMAP.md): the same sums in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difformer_tpu.ops import bsr as JB
from difformer_tpu_torch.kernels import bsr as K7
from difformer_tpu_torch.kernels import ell as K6
from difformer_tpu_torch.ops import bsr as B
import torch_port_helpers  # noqa: F401  (sets torch's threads)

TOL = dict(rtol=2e-4, atol=2e-5)
S = K7.SPLIT_BLOCKS
H100_SMS = 132


def _sorted_powerlaw(n=1024, e=20000, seed=3):
    """A degree-sorted power-law graph: its first row tiles are the hubs'."""
    rng = np.random.default_rng(seed)
    w = rng.pareto(2.0, n) + 1.0
    p = w / w.sum()
    s = rng.choice(n, size=e, p=p).astype(np.int32)
    r = rng.choice(n, size=e, p=p).astype(np.int32)
    perm = B.degree_sorted_order(s, r, n)
    return perm[s], perm[r]


def _layouts(kind, scaled_int8=True, n=1024, tile=16, min_edges=4):
    """(the port's forward direction, the JAX package's) of a layout of
    the degree-sorted power-law graph, built from the same edges."""
    s, r = _sorted_powerlaw(n)
    if kind == "padded":
        return (B.build_bsr_gcn(s, r, n, tile=tile, min_edges=min_edges)[0],
                JB.build_bsr_gcn(s, r, n, tile=tile,
                                 min_edges=min_edges)[0])
    return (B.build_bsr_bucketed_gcn(s, r, n, tile=tile, min_edges=min_edges,
                                     scaled_int8=scaled_int8)[0],
            JB.build_bsr_bucketed_gcn(s, r, n, tile=tile,
                                      min_edges=min_edges,
                                      scaled_int8=scaled_int8)[0])


def _jax_matvec(jd, x):
    matvec = (JB._bsr_bucketed_matvec if hasattr(jd, "row_tiles")
              else JB._bsr_matvec)
    return np.asarray(matvec(jd, jnp.asarray(x)))


@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("kb", [1, S - 1, S, S + 1, 3 * S + 2])
def test_split_plan_covers_every_block_once(kb, m):
    """Every (row tile, block) of a group falls in exactly one chunk's
    thread blocks, no chunk is empty, and a group of more than S blocks a
    row tile is cut into ⌈kb / S⌉ chunks while it fills less than a wave."""
    tile, width = 256, 64
    chunks = K7.split_plan([(m, kb)], tile, width, H100_SMS)[0]
    assert chunks == (1 if kb <= S else -(-kb // S))
    ranges = K7.chunk_ranges(kb, chunks)
    assert len(ranges) == chunks and all(k1 > k0 for k0, k1 in ranges)
    # the kernel's grid over the group: row tile, chunk, then its blocks
    seen = [(i, k) for i in range(m) for k0, k1 in ranges
            for k in range(k0, k1)]
    assert sorted(seen) == [(i, k) for i in range(m) for k in range(kb)]


def test_split_plan_leaves_a_full_wave_and_empty_groups_alone():
    """A group whose thread blocks fill a wave (2 an SM) is not split, nor
    is one without blocks; the chunks of a hub stop at a wave."""
    wave_tiles = K7.BLOCKS_PER_SM * H100_SMS // 2  # 2 row blocks at T=256
    assert K7.split_plan([(wave_tiles, 10 * S), (5, 0)], 256, 64,
                         H100_SMS) == [1, 1]
    assert K7.split_plan([(wave_tiles - 1, 10 * S)], 256, 64,
                         H100_SMS) == [2]
    many = K7.split_plan([(1, 1000 * S)], 256, 64, H100_SMS)[0]
    assert many <= K7.BLOCKS_PER_SM * H100_SMS // 2
    assert all(k1 > k0 for k0, k1 in K7.chunk_ranges(1000 * S, many))


@pytest.mark.parametrize("width,cols,tiles", [
    (1, 8, 1), (3, 8, 1), (64, 64, 1), (65, 72, 1), (72, 72, 1), (80, 80, 1),
    (128, 64, 2), (300, 80, 4)])
def test_column_tile_reads_each_block_once_up_to_80(width, cols, tiles):
    """One column tile up to 80 columns (W rounded up to 8, an n8 tile of
    mma), so each block is read once; wider W in equal tiles."""
    assert K7.column_tile(width) == cols
    assert -(-width // cols) == tiles
    assert cols % 8 == 0 and cols * tiles - width < 8 * tiles


@pytest.mark.parametrize("scaled_int8", [True, False])
@pytest.mark.parametrize("width", [1, 3, 65])
def test_split_and_combine_match_jax_bucketed_matvec(width, scaled_int8):
    """The kernel's two launches in plain PyTorch (each chunk's partial
    sums, then their sum in chunk order, scaled and rounded once), plus
    the residual, against the JAX package's bucketed product on a
    degree-sorted power-law graph whose hub buckets hold more than S
    blocks a row tile."""
    d, jd = _layouts("bucketed", scaled_int8)
    groups, scale = d.groups(), d.inv_scale
    assert (scale is not None) == scaled_int8
    chunks = K7.split_plan(K7.group_shapes(groups), d.tile, width, H100_SMS)
    assert max(kb for _, kb in K7.group_shapes(groups)) > S
    assert max(chunks) > 1
    x = np.random.default_rng(width).normal(size=(d.num_nodes, width)) \
        .astype(np.float32)
    xt = torch.from_numpy(x)
    out, partial = K7.bsr_spmm_split(xt, groups, d.tile, chunks,
                                     scale=scale)
    assert partial.numel() == K7.partial_offsets(groups, chunks, d.tile,
                                                 width)[1]
    out = K7.bsr_spmm_combine(partial, out, groups, d.tile, chunks,
                              scale=scale)
    torch.testing.assert_close(
        out, K7.bsr_spmm_blocks_plain(xt, groups, d.tile, scale), **TOL)
    got = K6.ell_spmm_plain(xt, d.residual, add_to=out)
    np.testing.assert_allclose(got.numpy(), _jax_matvec(jd, x), **TOL)


@pytest.mark.parametrize("kind", ["padded", "bucketed"])
@pytest.mark.parametrize("width", [1, 3, 65])
def test_plain_path_matches_jax_at_staged_widths(width, kind):
    """K7's plain version (the CPU's path of ``bsr_spmm_blocks``) and the
    residual against the JAX package at widths the kernel pads to 8
    columns or stages to rows of 16 bytes."""
    d, jd = _layouts(kind)
    x = np.random.default_rng(width + 7).normal(
        size=(d.num_nodes, width)).astype(np.float32)
    np.testing.assert_allclose(
        B.bsr_matvec(d, torch.from_numpy(x)).numpy(), _jax_matvec(jd, x),
        **TOL)


def test_combine_plain_sums_in_chunk_order():
    """The combine's plain version adds the chunks left to right in f32,
    as the kernel does, and scales after the sum; the wrapper takes it on
    the CPU and counts no launch."""
    groups = [(torch.ones((1, 3, 2, 2)),
               torch.zeros((1, 3), dtype=torch.int32), None)]
    # chunks [3, m = 1, T = 2, W = 1]: (1e8 + 1) - 1e8 is 0 in f32
    partial = torch.tensor([1e8, 1e8, 1.0, 1.0, -1e8, -1e8])
    out = torch.full((2, 1), float("nan"))
    scale = torch.tensor([2.0, 0.5])
    got = K7.bsr_spmm_combine_plain(partial, out, groups, 2, [3], scale)
    assert torch.equal(got, torch.zeros((2, 1)))
    K7.reset_launch_counts()
    assert torch.equal(K7.bsr_spmm_combine(partial, out, groups, 2, [3],
                                           scale=scale), got)
    assert torch.equal(out, got) and not any(K7.LAUNCHES.values())


def test_wrappers_check_the_plan_and_staging():
    """The split wrappers refuse a plan that does not fit the groups; x is
    staged to rows of 16 bytes only where its own rows are not."""
    d, _ = _layouts("bucketed")
    groups = d.groups()
    x = torch.zeros((d.num_nodes, 4))
    with pytest.raises(ValueError, match="chunks"):
        K7.bsr_spmm_split(x, groups, d.tile, [1], scale=d.inv_scale)
    with pytest.raises(ValueError, match="cannot be cut"):
        K7.bsr_spmm_split(x, groups, d.tile, [1000] * len(groups),
                          scale=d.inv_scale)
    assert K7.staged_x(x)[0] is x and K7.staged_x(x)[1] == 4
    odd = torch.arange(10 * 65, dtype=torch.float32).reshape(10, 65)
    staged, ld = K7.staged_x(odd)
    assert ld == 68 and staged.shape == (10, 68)
    assert torch.equal(staged[:, :65], odd)
    view = torch.zeros((10, 72))[:, :65]
    got, ld = K7.staged_x(view)
    assert got is view and ld == 72
    bf = torch.zeros((10, 12), dtype=torch.bfloat16)
    assert K7.staged_x(bf)[1] == 16
