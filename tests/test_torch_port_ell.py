"""The port's ELL layout (difformer_tpu_torch/ops/ell.py, the native
``ell_fill`` and the plain version of the ELL kernel K6) against the JAX
package's (difformer_tpu/ops/ell.py), as tests/test_ell.py holds the JAX
package's against ``gcn_conv``.

The host builders must give the JAX package's arrays bit for bit: the bucket
widths, each bucket's neighbour indices and weights, and ``inv_perm``. The
products (``gcn_conv_ell``, forward and gradient, and a DIFFormer with
``ell=`` on both graph branches and both kernels, on weights carried over by
``utils/weights.py``) agree with the JAX package's at rtol 2e-4 / atol 2e-5
(the port's test tolerance, ROADMAP.md), the sums being taken in another
order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difformer_tpu import native as jax_native
from difformer_tpu.ops import ell as JE
from difformer_tpu.ops.graph_ops import gcn_conv as jax_gcn_conv
from difformer_tpu_torch import native
from difformer_tpu_torch.kernels import ell as K6
from difformer_tpu_torch.ops import ell as E
from test_torch_port_model import N, _check_logits_and_grads, _graph
import torch_port_helpers  # noqa: F401  (sets torch's threads)

TOL = dict(rtol=2e-4, atol=2e-5)


def _edges(seed, n, e, hub=False):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e)
    r = np.where(rng.random(e) < 0.3, 0, rng.integers(0, n, e)) if hub \
        else rng.integers(0, n, e)
    return s, r


def _assert_same_layout(jax_ell, ell):
    assert jax_ell.bucket_sizes == ell.bucket_sizes
    assert len(jax_ell.nbr_idx) == len(ell.nbr_idx)
    for a, b in zip(jax_ell.nbr_idx, ell.nbr_idx):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert b.dtype == torch.int32
    for a, b in zip(jax_ell.weight, ell.weight):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(np.asarray(jax_ell.inv_perm),
                                  ell.inv_perm.numpy())
    # the node of each row is the inverse of inv_perm
    np.testing.assert_array_equal(ell.rows.numpy()[ell.inv_perm.numpy()],
                                  np.arange(ell.num_nodes))


def _numpy_native(monkeypatch):
    """The port's native entries on their numpy paths."""
    monkeypatch.setattr(native, "get_lib", lambda: None)


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_ell_fill_is_bit_equal_to_jax(monkeypatch, path):
    """The port's ell_fill, on its native and numpy paths, gives the JAX
    package's native ell_fill arrays."""
    rng = np.random.default_rng(0)
    n, e = 200, 1500
    r = np.sort(rng.integers(0, n, e))
    point_s = rng.integers(0, n, e).astype(np.int32)
    val_s = rng.random(e).astype(np.float32)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=n))])
    nodes = rng.permutation(n)[:120]
    want = jax_native.ell_fill(nodes, 16, indptr, point_s, val_s)
    if path == "numpy":
        _numpy_native(monkeypatch)
    else:
        assert native.available(), native.load_error
    got = native.ell_fill(nodes, 16, indptr, point_s, val_s)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["uniform", "hub", "weighted", "edgeless",
                                  "numpy"])
def test_build_ell_gcn_is_bit_equal_to_jax(monkeypatch, case):
    n = 60 if case != "hub" else 40
    s, r = _edges(1, n, 0 if case == "edgeless" else 500, hub=case == "hub")
    w = (np.random.default_rng(2).random(s.size).astype(np.float32)
         if case == "weighted" else None)
    want = JE.build_ell_gcn(s, r, n, w)
    if case == "numpy":
        _numpy_native(monkeypatch)
    got = E.build_ell_gcn(s, r, n, w)
    for a, b in zip(want, got):
        _assert_same_layout(a, b)


def _jax_ref(x, s, r):
    return np.asarray(jax_gcn_conv(jnp.asarray(x), jnp.asarray(s, jnp.int32),
                                   jnp.asarray(r, jnp.int32), None))


@pytest.mark.parametrize("shape", [(1, 4), (2, 8)])
def test_ell_matches_gcn_conv(shape):
    rng = np.random.default_rng(3)
    n, e = 50, 400
    x = rng.normal(size=(n,) + shape).astype(np.float32)
    s, r = rng.integers(0, n, e), rng.integers(0, n, e)
    fwd, rev = E.build_ell_gcn(s, r, n)
    got = E.gcn_conv_ell(torch.from_numpy(x), fwd, rev)
    np.testing.assert_allclose(got.numpy(), _jax_ref(x, s, r), **TOL)
    jf, jr = JE.build_ell_gcn(s, r, n)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(JE.gcn_conv_ell(jnp.asarray(x), jf, jr)),
        **TOL)


def test_ell_skewed_degrees():
    """One hub node with a huge in-degree (a bucket wider than K6's
    SPLIT_THRESHOLD, which K6 splits)."""
    rng = np.random.default_rng(4)
    n = 40
    s = np.concatenate([rng.integers(0, n, 500), rng.integers(0, n, 30)])
    r = np.concatenate([np.zeros(500, np.int64), rng.integers(1, n, 30)])
    x = rng.normal(size=(n, 1, 4)).astype(np.float32)
    fwd, rev = E.build_ell_gcn(s, r, n)
    assert max(fwd.bucket_sizes) > K6.SPLIT_THRESHOLD
    got = E.gcn_conv_ell(torch.from_numpy(x), fwd, rev)
    np.testing.assert_allclose(got.numpy(), _jax_ref(x, s, r), **TOL)


def test_ell_gradient_matches_jax():
    rng = np.random.default_rng(5)
    n, e = 30, 150
    x = rng.normal(size=(n, 1, 4)).astype(np.float32)
    t = rng.normal(size=(n, 1, 4)).astype(np.float32)
    s, r = _edges(6, n, e, hub=True)
    jf, jr = JE.build_ell_gcn(s, r, n)
    want = jax.grad(lambda x: jnp.sum((JE.gcn_conv_ell(x, jf, jr) - t) ** 2))(
        jnp.asarray(x))
    fwd, rev = E.build_ell_gcn(s, r, n)
    xt = torch.from_numpy(x).requires_grad_()
    ((E.gcn_conv_ell(xt, fwd, rev) - torch.from_numpy(t)) ** 2).sum() \
        .backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), **TOL)


def test_ell_edgeless_graph():
    fwd, rev = E.build_ell_gcn(np.zeros(0, np.int64), np.zeros(0, np.int64),
                               10)
    out = E.gcn_conv_ell(torch.ones((10, 1, 3)), fwd, rev)
    assert torch.equal(out, torch.zeros_like(out))


def test_plain_version_rounds_once_at_bf16_and_adds():
    """K6's plain version: f32 sums rounded once to bf16; with ``add_to``
    the sums are added to it in f32 before the one rounding."""
    rng = np.random.default_rng(7)
    n = 80
    s, r = _edges(8, n, 600, hub=True)
    fwd, _ = E.build_ell_gcn(s, r, n)
    x = torch.from_numpy(rng.normal(size=(n, 24)).astype(np.float32))
    xb = x.to(torch.bfloat16)
    f32 = K6.ell_spmm_plain(xb.float(), fwd)
    assert torch.equal(K6.ell_spmm_rows(xb, fwd), f32.to(torch.bfloat16))
    base = torch.from_numpy(rng.normal(size=(n, 24)).astype(np.float32))
    got = K6.ell_spmm_rows(xb, fwd, add_to=base.to(torch.bfloat16))
    want = (base.to(torch.bfloat16).float() + f32).to(torch.bfloat16)
    assert torch.equal(got, want)


def test_wrapper_checks_its_inputs():
    fwd, _ = E.build_ell_gcn(*_edges(9, 20, 50), 20)
    with pytest.raises(ValueError, match="x must be"):
        K6.ell_spmm_rows(torch.zeros(19, 4), fwd)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K6.ell_spmm_rows(torch.zeros(20, 4, dtype=torch.float64), fwd)
    with pytest.raises(ValueError, match="add_to"):
        K6.ell_spmm_rows(torch.zeros(20, 4), fwd, add_to=torch.zeros(20, 3))


def test_unknown_layout_names_the_parallel_layer():
    # the layouts it takes, the parallel layer's BsrShard among them
    with pytest.raises(TypeError, match="BsrShard"):
        E.gcn_conv_ell(torch.zeros(4, 2), object(), object())


def _model_ell(pkg):
    """The model graph's layout pair in ``pkg`` (the JAX package's ops.ell
    or the port's) from the same edges."""
    jg, _, _ = _graph()
    return pkg.build_ell_gcn(np.asarray(jg.senders), np.asarray(jg.receivers),
                             N)


@pytest.mark.parametrize("kernel", ["simple", "sigmoid"])
@pytest.mark.parametrize("heads,flags", [(1, {}), (2, {"spmm_first": True}),
                                         (2, {"fuse_head_mean": False})])
def test_difformer_with_ell_matches_jax(kernel, heads, flags):
    """DIFFormer with ``ell=`` (both graph branches: the plain one and
    spmm_first's [x, 1] rows) against the JAX package's with ``ell=``:
    logits and every parameter's gradient."""
    _check_logits_and_grads(heads, kernel, flags,
                            call_t={"ell": _model_ell(E)},
                            ell=_model_ell(JE))


@pytest.mark.parametrize("heads,flags", [(1, {}), (2, {"spmm_first": True})])
def test_difformer_with_ell_under_remat_is_bit_equal(heads, flags):
    """remat=True recomputes the spmm_first branch with its ELL product and
    gives the logits and gradients of remat=False bit for bit."""
    from difformer_tpu_torch import DIFFormer

    _, tg, _ = _graph()
    ell = _model_ell(E)
    res = []
    for remat in (False, True):
        m = DIFFormer(tg.node_feat.shape[1], 16, 3, num_layers=2,
                      num_heads=heads, dropout=0.0, remat=remat, seed=1,
                      device="cpu", **flags)
        out = m(tg.node_feat, tg.senders, tg.receivers, ell=ell)
        out.square().sum().backward()
        res.append((out.detach(), [p.grad for p in m.parameters()]))
    assert torch.equal(res[0][0], res[1][0])
    for a, b in zip(res[0][1], res[1][1]):
        assert torch.equal(a, b)
