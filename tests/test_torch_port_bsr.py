"""The port's block-sparse hybrid (difformer_tpu_torch/ops/bsr.py and the
plain version of the block kernel K7) against the JAX package's
(difformer_tpu/ops/bsr.py), the single-device cases of tests/test_bsr.py.

The host builders must give the JAX package's arrays bit for bit (blocks,
block columns, row tiles, residual ELL, ``inv_scale``) at the same
``min_edges``; where a test leaves ``min_edges`` to the cost model, the
port's constants are set to the JAX package's (the port's are this card's).
The products agree with the JAX package's at rtol 2e-4 / atol 2e-5 (the
port's test tolerance, ROADMAP.md): the same sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difformer_tpu.ops import bsr as JB
from difformer_tpu.ops import ell as JE
from difformer_tpu.ops.graph_ops import gcn_conv as jax_gcn_conv
from difformer_tpu_torch.kernels import bsr as K7
from difformer_tpu_torch.ops import bsr as B
from difformer_tpu_torch.ops import ell as E
from test_torch_port_ell import _assert_same_layout
from test_torch_port_model import N, _check_logits_and_grads, _graph
import torch_port_helpers  # noqa: F401  (sets torch's threads)

TOL = dict(rtol=2e-4, atol=2e-5)


def _clustered(n, tile, seed=0, p_in=0.5, n_cross=200):
    rng = np.random.default_rng(seed)
    blocks = []
    for c in range(n // tile):
        m = rng.uniform(size=(tile, tile)) < p_in
        r, co = np.nonzero(m)
        blocks.append(np.stack([co + c * tile, r + c * tile]))
    ei = np.concatenate(blocks, axis=1)
    return np.concatenate([ei, rng.integers(0, n, (2, n_cross))], axis=1)


def _powerlaw(n, e, seed=0, alpha=2.0):
    rng = np.random.default_rng(seed)
    w = rng.pareto(alpha, n) + 1.0
    p = w / w.sum()
    return np.stack([rng.choice(n, size=e, p=p).astype(np.int32),
                     rng.choice(n, size=e, p=p).astype(np.int32)])


def _sorted_powerlaw(n, e, seed):
    ei = _powerlaw(n, e, seed=seed)
    perm = B.degree_sorted_order(ei[0], ei[1], n)
    return perm[ei[0]], perm[ei[1]]


def _ref(x, s, r):
    """The JAX package's gcn_conv of x over the edges (s, r)."""
    order = np.argsort(r, kind="stable")
    return np.asarray(jax_gcn_conv(
        jnp.asarray(x), jnp.asarray(s[order], jnp.int32),
        jnp.asarray(r[order], jnp.int32), indices_are_sorted=True))


@pytest.fixture
def jax_cost_model(monkeypatch):
    """The port's cost-model constants set to the JAX package's."""
    monkeypatch.setattr(B, "_EDGE_EQUIV_BYTES", JB._EDGE_EQUIV_BYTES)
    monkeypatch.setattr(B, "_BUCKETED_BREAKEVEN_SCALE",
                        JB._BUCKETED_BREAKEVEN_SCALE)


def _assert_same_direction(jd, d):
    if hasattr(jd, "row_tiles"):
        assert len(jd.blocks) == len(d.blocks)
        for names in ("blocks", "block_col", "row_tiles"):
            for a, b in zip(getattr(jd, names), getattr(d, names)):
                np.testing.assert_array_equal(np.asarray(a), b.numpy())
        if jd.inv_scale is None:
            assert d.inv_scale is None
        else:
            np.testing.assert_array_equal(np.asarray(jd.inv_scale),
                                          d.inv_scale.numpy())
        covered = np.concatenate([t.numpy() for t in d.row_tiles]
                                 + [d.empty_tiles.numpy()])
        ntr = -(-d.num_nodes // d.tile)
        np.testing.assert_array_equal(np.sort(covered), np.arange(ntr))
    else:
        np.testing.assert_array_equal(
            np.asarray(jd.blocks, np.float32), d.blocks.float().numpy())
        np.testing.assert_array_equal(np.asarray(jd.block_col),
                                      d.block_col.numpy())
    assert (jd.residual is None) == (d.residual is None)
    if d.residual is not None:
        _assert_same_layout(jd.residual, d.residual)
    assert (jd.num_nodes, jd.tile) == (d.num_nodes, d.tile)


def _pl():
    return _sorted_powerlaw(512, 6000, 3)


def _cl(n=256, tile=64, **kw):
    ei = _clustered(n, tile, **kw)
    return ei[0], ei[1]


# (builder, edges, n, kwargs): the JAX tests' cases
BUILDS = {
    "padded clustered": ("build_bsr_gcn", lambda: _cl(), 256,
                         dict(tile=64, min_edges=8)),
    "padded sparse": ("build_bsr_gcn", lambda: tuple(np.random.default_rng(
        2).integers(0, 1024, (2, 512))), 1024, dict(tile=64)),
    "padded all dense": ("build_bsr_gcn", lambda: _cl(
        128, 64, p_in=0.9, n_cross=0), 128, dict(tile=64, min_edges=4)),
    "padded bf16 blocks": ("build_bsr_gcn", lambda: _cl(), 256,
                           dict(tile=64, min_edges=8,
                                block_dtype=torch.bfloat16)),
    "padded capped": ("build_bsr_gcn", lambda: _pl(), 512,
                      dict(tile=64, min_edges=8, block_budget_bytes=300_000)),
    "bucketed powerlaw int8": ("build_bsr_bucketed_gcn", _pl, 512,
                               dict(tile=64, min_edges=8)),
    "bucketed values": ("build_bsr_bucketed_gcn", _pl, 512,
                        dict(tile=64, min_edges=8, scaled_int8=False)),
    "bucketed budget": ("build_bsr_bucketed_gcn", _pl, 512,
                        dict(tile=64, min_edges=8, scaled_int8=False,
                             budget_bytes=3 * 64 * 64 * 4)),
    "bucketed no dense tiles": ("build_bsr_bucketed_gcn",
                                lambda: tuple(np.random.default_rng(11)
                                              .integers(0, 512, (2, 800))),
                                512, dict(tile=64, min_edges=50)),
    "bucketed default threshold": ("build_bsr_bucketed_gcn", _pl, 512,
                                   dict(tile=64)),
}


@pytest.mark.parametrize("case", sorted(BUILDS))
def test_host_builders_are_bit_equal_to_jax(jax_cost_model, case):
    name, edges, n, kw = BUILDS[case]
    s, r = edges()
    jkw = dict(kw)
    if kw.get("block_dtype") is torch.bfloat16:
        jkw["block_dtype"] = jnp.bfloat16
    want = getattr(JB, name)(s, r, n, **jkw)
    got = getattr(B, name)(s, r, n, **kw)
    for jd, d in zip(want, got):
        _assert_same_direction(jd, d)
    x = np.random.default_rng(1).normal(size=(n, 8)).astype(np.float32)
    jax_out = (JB.bsr_bucketed_spmm if name.endswith("bucketed_gcn")
               else JB.bsr_spmm)(*want, jnp.asarray(x))
    rtol = 1e-2 if "bf16" in case else TOL["rtol"]
    np.testing.assert_allclose(
        B.bsr_spmm(*got, torch.from_numpy(x)).numpy(), np.asarray(jax_out),
        rtol=rtol, atol=TOL["atol"])


@pytest.mark.parametrize("trailing", [(16,), (2, 8)])
def test_bsr_matches_gcn_conv_clustered(trailing):
    n, tile = 256, 64
    s, r = _cl(n, tile)
    x = np.random.default_rng(1).normal(size=(n,) + trailing).astype(
        np.float32)
    fwd, rev = B.build_bsr_gcn(s, r, n, tile=tile, min_edges=8)
    assert fwd.residual is not None  # cross edges stay sparse
    out = B.bsr_spmm(fwd, rev, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), _ref(x, s, r), **TOL)


def test_bsr_duplicate_edges_accumulate():
    n, tile = 64, 32
    ei = np.concatenate([np.array([[1, 1, 1, 2], [0, 0, 0, 0]]),
                         _clustered(n, tile, p_in=0.8, n_cross=0)], 1)
    x = np.random.default_rng(4).normal(size=(n, 4)).astype(np.float32)
    fwd, rev = B.build_bsr_gcn(ei[0], ei[1], n, tile=tile, min_edges=2)
    np.testing.assert_allclose(
        B.bsr_spmm(fwd, rev, torch.from_numpy(x)).numpy(),
        _ref(x, ei[0], ei[1]), **TOL)


@pytest.mark.parametrize("layout", ["padded", "bucketed int8",
                                    "bucketed values"])
def test_gradient_matches_jax(layout):
    """The backward applies the reverse direction: x's gradient against
    the JAX package's, on a clustered graph with cross edges."""
    n, tile = 192, 64
    s, r = _cl(n, tile, p_in=0.4, n_cross=150)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(n, 12)).astype(np.float32)
    g = rng.normal(size=(n, 12)).astype(np.float32)
    if layout == "padded":
        jf, jr = JB.build_bsr_gcn(s, r, n, tile=tile, min_edges=8)
        fwd, rev = B.build_bsr_gcn(s, r, n, tile=tile, min_edges=8)
        spmm = JB.bsr_spmm
    else:
        kw = dict(tile=tile, min_edges=8,
                  scaled_int8=layout == "bucketed int8")
        jf, jr = JB.build_bsr_bucketed_gcn(s, r, n, **kw)
        fwd, rev = B.build_bsr_bucketed_gcn(s, r, n, **kw)
        spmm = JB.bsr_bucketed_spmm
    want = jax.grad(lambda x: jnp.sum(jnp.sin(spmm(jf, jr, x))))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    torch.sin(B.bsr_spmm(fwd, rev, xt)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), **TOL)
    # a cotangent of its own: the reverse direction applied to it
    xt.grad = None
    (B.bsr_spmm(fwd, rev, xt) * torch.from_numpy(g)).sum().backward()
    want_g = jax.grad(lambda x: jnp.vdot(spmm(jf, jr, x), jnp.asarray(g)))(
        jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g), **TOL)


def test_block_row_cap_spills_to_residual():
    """A binding per-row cap demotes tiles to the residual ELL; the product
    is unchanged."""
    rng = np.random.default_rng(6)
    n, e, tile = 512, 16384, 64
    s = rng.integers(0, n, e)
    r = np.where(rng.random(e) < 0.5, rng.integers(0, tile, e),
                 rng.integers(0, n, e))
    x = np.random.default_rng(7).normal(size=(n, 1, 16)).astype(np.float32)
    fwd, rev = B.build_bsr_gcn(s, r, n, tile=tile, min_edges=32,
                               block_budget_bytes=300_000)
    assert fwd.blocks.shape[1] <= 2
    np.testing.assert_allclose(
        B.bsr_spmm(fwd, rev, torch.from_numpy(x)).numpy(), _ref(x, s, r),
        **TOL)
    full, _ = B.build_bsr_gcn(s, r, n, tile=tile, min_edges=32)
    assert full.blocks.shape[1] > fwd.blocks.shape[1]


@pytest.mark.parametrize("trailing", [(16,), (2, 8)])
def test_bucketed_matches_gcn_conv_powerlaw(trailing):
    n = 512
    s, r = _pl()
    x = np.random.default_rng(1).normal(size=(n,) + trailing).astype(
        np.float32)
    fwd, rev = B.build_bsr_bucketed_gcn(s, r, n, tile=64, min_edges=8)
    assert len(fwd.blocks) >= 1
    np.testing.assert_allclose(
        B.bsr_spmm(fwd, rev, torch.from_numpy(x)).numpy(), _ref(x, s, r),
        **TOL)


def test_bucketed_matches_padded_layout():
    n, tile = 256, 64
    s, r = _cl(n, tile)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(n, 8))
                         .astype(np.float32))
    padded = B.build_bsr_gcn(s, r, n, tile=tile, min_edges=8)
    bucketed = B.build_bsr_bucketed_gcn(s, r, n, tile=tile, min_edges=8)
    torch.testing.assert_close(B.bsr_spmm(*padded, x),
                               B.bsr_bucketed_spmm(*bucketed, x), **TOL)


def test_bucketed_hub_row_wider_than_static_ladder():
    """A row tile with more column tiles than the ladder's top rung keeps
    every block."""
    tile = 8
    ntr = B._KB_LADDER[-1] + 3
    n = ntr * tile
    s = np.arange(0, n, tile, dtype=np.int32)
    r = np.zeros_like(s)
    x = np.random.default_rng(0).normal(size=(n, 4)).astype(np.float32)
    fwd, rev = B.build_bsr_bucketed_gcn(s, r, n, tile=tile, min_edges=1,
                                        budget_bytes=None)
    assert fwd.residual is None
    np.testing.assert_allclose(
        B.bsr_spmm(fwd, rev, torch.from_numpy(x)).numpy(), _ref(x, s, r),
        **TOL)


def test_scaled_int8_matches_values_and_budget_buys_4x_tiles():
    n, tile = 512, 64
    s, r = _pl()
    budget = 3 * tile * tile * 4
    cap_v, _ = B.build_bsr_bucketed_gcn(s, r, n, tile=tile, min_edges=8,
                                        budget_bytes=budget,
                                        scaled_int8=False)
    cap_8, cap_8r = B.build_bsr_bucketed_gcn(s, r, n, tile=tile,
                                             min_edges=8,
                                             budget_bytes=budget)
    assert all(b.dtype == torch.int8 for b in cap_8.blocks)
    n_v = sum(int(np.prod(b.shape[:2])) for b in cap_v.blocks)
    n_8 = sum(int(np.prod(b.shape[:2])) for b in cap_8.blocks)
    assert n_8 >= min(4 * n_v, 12)
    x = np.random.default_rng(1).normal(size=(n, 8)).astype(np.float32)
    np.testing.assert_allclose(
        B.bsr_spmm(cap_8, cap_8r, torch.from_numpy(x)).numpy(),
        _ref(x, s, r), **TOL)


def test_scaled_int8_multigraph_overflow_falls_back():
    """More than 127 parallel edges in a tile: value blocks, as the JAX
    package falls back."""
    n, tile = 128, 64
    s = np.concatenate([np.repeat(np.arange(32, dtype=np.int32), 4),
                        np.full(300, 5, np.int32)])
    r = np.concatenate([np.tile(np.arange(4, dtype=np.int32), 32),
                        np.full(300, 2, np.int32)])
    fwd, rev = B.build_bsr_bucketed_gcn(s, r, n, tile=tile, min_edges=8)
    jf, _ = JB.build_bsr_bucketed_gcn(s, r, n, tile=tile, min_edges=8)
    assert fwd.inv_scale is None and jf.inv_scale is None
    _assert_same_direction(jf, fwd)
    x = np.random.default_rng(0).normal(size=(n, 4)).astype(np.float32)
    np.testing.assert_allclose(
        B.bsr_spmm(fwd, rev, torch.from_numpy(x)).numpy(), _ref(x, s, r),
        rtol=2e-4, atol=2e-4)


def test_scaled_int8_weighted_graph_keeps_values():
    n, tile = 256, 64
    s, r = _cl(n, tile, seed=3)
    w = np.random.default_rng(7).random(s.size).astype(np.float32)
    fwd, _ = B.build_bsr_bucketed_gcn(s, r, n, edge_weight=w, tile=tile,
                                      min_edges=8)
    assert fwd.inv_scale is None
    with pytest.raises(ValueError, match="unweighted"):
        B.build_bsr_bucketed_gcn(s, r, n, edge_weight=w, tile=tile,
                                 min_edges=8, scaled_int8=True)


def test_cost_model_matches_jax_at_its_constants(jax_cost_model):
    for tile in (64, 128, 256):
        for elem in (1, 2, 4):
            assert (B.default_min_edges(tile, block_elem_bytes=elem)
                    == JB.default_min_edges(tile, block_elem_bytes=elem))
            assert (B.bucketed_min_edges(tile, block_elem_bytes=elem)
                    == JB.bucketed_min_edges(tile, block_elem_bytes=elem))


def test_cost_model_grows_with_the_tile():
    assert B.default_min_edges(256) > B.default_min_edges(64) >= 8


def test_choose_spmm_and_coverage_match_jax(jax_cost_model):
    rng = np.random.default_rng(9)
    ei_u = rng.integers(0, 4096, (2, 8192))
    s_c, r_c = _cl(512, 64, p_in=0.5, n_cross=100)
    s_p, r_p = tuple(_powerlaw(8192, 131072, seed=0))
    cases = [(ei_u[0], ei_u[1], 4096, 64), (s_c, r_c, 512, 64),
             (s_p, r_p, 8192, 128)]
    got = [B.choose_spmm(s, r, n, tile=t) for s, r, n, t in cases]
    want = [JB.choose_spmm(s, r, n, tile=t) for s, r, n, t in cases]
    assert [g[0] for g in got] == [w[0] for w in want]
    assert [g[0] for g in got][:2] == ["ell", "bsr"]
    np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want])
    assert B.dense_coverage(np.zeros(0, int), np.zeros(0, int), 16) == 0.0


def test_degree_sorted_order_matches_jax():
    s, r = _powerlaw(2048, 20000, seed=1)
    perm = B.degree_sorted_order(s, r, 2048)
    np.testing.assert_array_equal(perm, JB.degree_sorted_order(s, r, 2048))
    assert sorted(perm) == list(range(2048))
    deg = np.bincount(s, minlength=2048) + np.bincount(r, minlength=2048)
    assert perm[np.argmax(deg)] == 0


def test_via_gcn_conv_ell_dispatch():
    n, tile = 256, 64
    s, r = _cl(n, tile, seed=9)
    x = np.random.default_rng(4).normal(size=(n, 8)).astype(np.float32)
    for build in (B.build_bsr_gcn, B.build_bsr_bucketed_gcn):
        fwd, rev = build(s, r, n, tile=tile, min_edges=8)
        np.testing.assert_allclose(
            E.gcn_conv_ell(torch.from_numpy(x), fwd, rev).numpy(),
            _ref(x, s, r), **TOL)


def test_plain_block_product_rounds_once_at_bf16():
    """K7's plain version at bf16 blocks and bf16 x: the f32 product of
    the blocks as stored, rounded once."""
    n, tile = 256, 64
    s, r = _cl(n, tile)
    fwd, _ = B.build_bsr_gcn(s, r, n, tile=tile, min_edges=8,
                             block_dtype=torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(n, 8))
                         .astype(np.float32)).to(torch.bfloat16)
    got = K7.bsr_spmm_blocks(x, fwd.groups(), tile)
    want = K7.bsr_spmm_blocks_plain(x.float(), [
        (fwd.blocks.float(), fwd.block_col, None)], tile)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))


def test_wrapper_checks_its_inputs():
    n, tile = 128, 64
    s, r = _cl(n, tile)
    fwd, _ = B.build_bsr_gcn(s, r, n, tile=tile, min_edges=8)
    with pytest.raises(ValueError, match="blocks must be"):
        K7.bsr_spmm_blocks(torch.zeros(n, 4), fwd.groups(), 32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K7.bsr_spmm_blocks(torch.zeros(n, 4, dtype=torch.float64),
                           fwd.groups(), tile)


@pytest.mark.parametrize("kernel", ["simple", "sigmoid"])
@pytest.mark.parametrize("layout", ["build_bsr_gcn",
                                    "build_bsr_bucketed_gcn"])
def test_difformer_with_bsr_matches_jax(kernel, layout):
    """DIFFormer with a block-sparse ``ell=`` (the spmm_first branch at 2
    heads) against the JAX package's with the same layout."""
    jg, _, _ = _graph()
    s, r = np.asarray(jg.senders), np.asarray(jg.receivers)
    kw = dict(tile=8, min_edges=2)
    _check_logits_and_grads(2, kernel, {"spmm_first": True},
                            call_t={"ell": getattr(B, layout)(s, r, N, **kw)},
                            ell=getattr(JB, layout)(s, r, N, **kw))


def test_difformer_with_bsr_matches_its_ell(jax_cost_model):
    """The same model on the hybrid and on the ELL layout (the JAX test's
    test_bsr_under_jit_and_model), in the port."""
    from difformer_tpu_torch import DIFFormer

    n, tile = 256, 64
    s, r = _cl(n, tile, p_in=0.3, n_cross=100)
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(n, 16))
                         .astype(np.float32))
    m = DIFFormer(16, 16, 3, num_layers=2, dropout=0.0, device="cpu")
    st, rt = torch.from_numpy(s), torch.from_numpy(r)
    out_b = m(x, st, rt, ell=B.build_bsr_gcn(s, r, n, tile=tile,
                                              min_edges=8))
    out_e = m(x, st, rt, ell=E.build_ell_gcn(s, r, n))
    torch.testing.assert_close(out_b, out_e, rtol=2e-4, atol=1e-5)


def test_jax_layouts_are_what_the_jax_tests_hold():
    """The JAX package's ELL agrees with its own gcn_conv at this file's
    sizes (the reference the comparisons above rest on)."""
    n = 256
    s, r = _cl(n, 64)
    x = np.random.default_rng(8).normal(size=(n, 8)).astype(np.float32)
    jf, jr = JE.build_ell_gcn(s, r, n)
    np.testing.assert_allclose(
        np.asarray(JE.gcn_conv_ell(jnp.asarray(x), jf, jr)), _ref(x, s, r),
        **TOL)
