"""The work of K7's combine kernel, on the CPU: the host's plan of it
(``difformer_tpu_torch/kernels/bsr.py`` ``combine_plan``: each split
group's row tiles cut into bands of ``combine_rows(W)`` rows, numbered one
thread block each, a prefix a group) covers every row of every split group
once, and that table, walked block by block as the kernel reads it
(``_walk``, a model of the kernel's indexing kept here: each block finds
its group, row tile and band, skips rows past N, sums its chunks' partials
in chunk order, scales and rounds once), gives ``bsr_spmm_combine_plain``'s
result bit for bit on degree-sorted power-law layouts, padded and
bucketed, f32 and bf16 out, with and without the count scale; with the
residual it matches the JAX package's product at rtol 2e-4 / atol 2e-5.
The kernel itself is held to the plain version on the card
(``tests/test_torch_port_cuda.py``, ``-k combine``).
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
H100_SMS = 132
N = 1000  # not a multiple of the tile: the last row tile runs past N


def _layout(kind, scaled_int8=True, n=N, tile=16, min_edges=4):
    """(the port's forward direction, the JAX package's) of a layout of a
    degree-sorted power-law graph whose hub row tiles split."""
    rng = np.random.default_rng(3)
    w = rng.pareto(2.0, n) + 1.0
    p = w / w.sum()
    s = rng.choice(n, size=20000, p=p).astype(np.int32)
    r = rng.choice(n, size=20000, p=p).astype(np.int32)
    perm = B.degree_sorted_order(s, r, n)
    s, r = perm[s], perm[r]
    if kind == "padded":
        return (B.build_bsr_gcn(s, r, n, tile=tile, min_edges=min_edges)[0],
                JB.build_bsr_gcn(s, r, n, tile=tile,
                                 min_edges=min_edges)[0])
    return (B.build_bsr_bucketed_gcn(s, r, n, tile=tile, min_edges=min_edges,
                                     scaled_int8=scaled_int8)[0],
            JB.build_bsr_bucketed_gcn(s, r, n, tile=tile,
                                      min_edges=min_edges,
                                      scaled_int8=scaled_int8)[0])


def _split(d, width, dtype=torch.float32, seed=0):
    groups, scale = d.groups(), getattr(d, "inv_scale", None)
    chunks = K7.split_plan(K7.group_shapes(groups), d.tile, width, H100_SMS)
    assert max(chunks) > 1
    x = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(d.num_nodes, width)).astype(np.float32)).to(dtype)
    out, partial = K7.bsr_spmm_split(x, groups, d.tile, chunks, scale=scale)
    return x, groups, scale, chunks, out, partial


def _walk(partial, out, groups, tile, chunks, scale=None):
    """``out`` with the split groups' rows combined as the kernel walks
    ``combine_plan``'s table, one thread block at a time (small layouts
    only)."""
    n, w = out.shape
    res = out.clone()
    plan, total = K7.combine_plan(groups, chunks, tile, w)
    rows = K7.combine_rows(w)
    bands = -(-tile // rows)
    firsts = [first for _, first, _, _, _ in plan]
    for b in range(total):
        j = max(k for k, first in enumerate(firsts) if first <= b)
        i, first, m, c, off = plan[j]
        mi, band = divmod(b - first, bands)
        tiles = groups[i][2]
        node0 = (mi if tiles is None else int(tiles[mi])) * tile
        r0 = band * rows
        r1 = min(r0 + rows, tile, n - node0)
        if r1 <= r0:
            continue
        p = partial[off:off + c * m * tile * w].reshape(c, m, tile, w)
        s = p[0, mi, r0:r1]
        for k in range(1, c):
            s = s + p[k, mi, r0:r1]
        if scale is not None:
            s = s * scale[node0 + r0:node0 + r1, None]
        res[node0 + r0:node0 + r1] = s.to(res.dtype)
    return res


@pytest.mark.parametrize("kind", ["padded", "bucketed"])
@pytest.mark.parametrize("width", [3, 64, 65, 300])
def test_combine_plan_numbers_every_band_once(kind, width):
    """Split groups only, in order, each one's first block the sum of the
    bands before it; the bands of a group cover its m row tiles' T rows
    once; each group's partials are [chunks, m, T, W] at its offset."""
    d, _ = _layout(kind)
    groups = d.groups()
    chunks = K7.split_plan(K7.group_shapes(groups), d.tile, width, H100_SMS)
    plan, total = K7.combine_plan(groups, chunks, d.tile, width)
    offsets, size = K7.partial_offsets(groups, chunks, d.tile, width)
    shapes = K7.group_shapes(groups)
    assert [i for i, *_ in plan] == [i for i, c in enumerate(chunks)
                                     if c > 1]
    band = K7.combine_rows(width)
    assert band == (8 if width % 4 == 0 else
                    {3: 32, 65: 1}[width])
    bands = -(-d.tile // band)
    first = 0
    for i, start, m, c, off in plan:
        assert (start, m, c, off) == (first, shapes[i][0], chunks[i],
                                      offsets[i])
        rows = sorted(b * band + k for b in range(bands)
                      for k in range(band) if b * band + k < d.tile)
        assert rows == list(range(d.tile))
        first += m * bands
    assert total == first
    assert size == sum(c * m * d.tile * width for _, _, m, c, _ in plan)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scaled_int8", [True, False])
@pytest.mark.parametrize("width", [1, 4, 65, 300])
def test_combine_walk_is_bit_equal_to_plain(width, scaled_int8, dtype):
    """The plan's table walked block by block against the plain
    combine: the same f32 adds in chunk order, one scale and one
    rounding, so bit-equal; rows past N are left as they were."""
    d, _ = _layout("bucketed", scaled_int8)
    x, groups, scale, chunks, out, partial = _split(d, width, dtype, width)
    sentinel = out.clone()
    got = _walk(partial, out, groups, d.tile, chunks, scale)
    want = K7.bsr_spmm_combine_plain(partial, out, groups, d.tile, chunks,
                                     scale)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(out, sentinel)


def test_combine_walk_on_the_padded_layout_matches_jax():
    """The padded layout's one group (row tiles in order, no tile list):
    split, walked combine and residual against the JAX product."""
    d, jd = _layout("padded")
    x, groups, scale, chunks, out, partial = _split(d, 7, seed=11)
    out = _walk(partial, out, groups, d.tile, chunks, scale)
    torch.testing.assert_close(
        out, K7.bsr_spmm_blocks_plain(x, groups, d.tile, scale), **TOL)
    got = K6.ell_spmm_plain(x, d.residual, add_to=out)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(JB._bsr_matvec(jd, jnp.asarray(x.numpy()))),
        **TOL)
