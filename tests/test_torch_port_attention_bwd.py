"""Flash sigmoid attention backward (K3 dq, K4 dk/dv, and the two autograd
Functions around them): the port's plain versions against the JAX package's
Pallas backward in interpret mode. The CUDA kernels are held against the
plain versions in test_torch_port_cuda.py.

Tolerances are the JAX package's own (tests/test_pallas_kernels.py):
float32 gradients rtol 1e-3 / atol 1e-4, bfloat16 0.05 / 0.05, and at
bfloat16 also the rule the CUDA kernels are held to
(difformer_tpu_torch/kernels/tolerance.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difformer_tpu.kernels.pallas_sigmoid_attention import (
    _pallas_bwd_kernels,
    sigmoid_attention_pallas,
    sigmoid_attention_pallas_unnormalized,
)
from difformer_tpu_torch.kernels import sigmoid_attention as K
from difformer_tpu_torch.kernels.tolerance import assert_close
from torch_port_helpers import make_inputs
from torch_port_helpers import to_jax as _j
from torch_port_helpers import to_torch as _t

GRAD = dict(rtol=1e-3, atol=1e-4)
BF16 = dict(rtol=0.05, atol=0.05)


def _cotangents(seed, n, heads, d):
    rng = np.random.default_rng(seed)
    dnum = rng.normal(size=(n, heads, d)).astype(np.float32)
    dden = rng.normal(size=(n, heads)).astype(np.float32)
    return dnum, dden


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("n,l", [(64, 64), (100, 130)])
def test_dq_dkv_plain_match_pallas(n, l, heads, masked):
    """K3 and K4 alone, from the same (dnum, dden)."""
    q, k, v, mask = make_inputs(10, n, l, heads, masked=masked)
    dnum, dden = _cotangents(11, n, heads, v.shape[2])
    dq_e, dk_e, dv_e = _pallas_bwd_kernels(
        _j(q), _j(k), _j(v), _j(mask), _j(dnum), _j(dden), interpret=True)
    args = (_t(q), _t(k), _t(v), _t(mask), _t(dnum), _t(dden))
    dq = K.sigmoid_attention_dq(*args)
    dk, dv = K.sigmoid_attention_dkv(*args)
    np.testing.assert_allclose(dq.numpy(), np.asarray(dq_e), **GRAD)
    np.testing.assert_allclose(dk.numpy(), np.asarray(dk_e), **GRAD)
    np.testing.assert_allclose(dv.numpy(), np.asarray(dv_e), **GRAD)


def _torch_grads(fn, q, k, v, mask):
    qs, ks, vs = (_t(a).requires_grad_() for a in (q, k, v))
    fn(qs, ks, vs, _t(mask)).backward()
    return qs.grad, ks.grad, vs.grad


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n,l,heads", [(64, 64, 1), (100, 130, 2)])
def test_normalized_grads_match_jax_grad(n, l, heads, masked):
    """SigmoidAttention's backward (dnum = g/den, dden = −Σ g·out/den, then
    K3 and K4) against jax.grad of the interpreted Pallas path."""
    q, k, v, mask = make_inputs(12, n, l, heads, masked=masked)
    t = np.random.default_rng(13).normal(size=(n, heads, 16)).astype(
        np.float32)

    def loss_j(q, k, v):
        out = sigmoid_attention_pallas(q, k, v, _j(mask), interpret=True)
        return jnp.sum((out - t) ** 2)

    expect = jax.grad(loss_j, argnums=(0, 1, 2))(_j(q), _j(k), _j(v))
    got = _torch_grads(
        lambda a, b, c, m: ((K.sigmoid_attention_flash(a, b, c, m)
                             - _t(t)) ** 2).sum(), q, k, v, mask)
    for g, e in zip(got, expect):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), **GRAD)


@pytest.mark.parametrize("masked", [False, True])
def test_unnormalized_grads_match_jax_grad(masked):
    q, k, v, mask = make_inputs(14, 100, 130, 2, masked=masked)
    rng = np.random.default_rng(15)
    w_num = rng.normal(size=(100, 2, 16)).astype(np.float32)
    w_den = rng.normal(size=(100, 2)).astype(np.float32)

    def loss_j(q, k, v):
        num, den = sigmoid_attention_pallas_unnormalized(
            q, k, v, _j(mask), interpret=True)
        return jnp.sum(num * w_num) + jnp.sum(den * w_den)

    expect = jax.grad(loss_j, argnums=(0, 1, 2))(_j(q), _j(k), _j(v))

    def loss_t(a, b, c, m):
        num, den = K.sigmoid_attention_flash_unnormalized(a, b, c, m)
        return (num * _t(w_num)).sum() + (den * _t(w_den)).sum()

    got = _torch_grads(loss_t, q, k, v, mask)
    for g, e in zip(got, expect):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), **GRAD)


def test_bf16_grads_match_pallas():
    q, k, v, mask = make_inputs(16, 96, 80, 1, m=16, d=16, masked=True)
    dnum, dden = _cotangents(17, 96, 1, 16)
    bf = [_j(a, jnp.bfloat16) for a in (q, k, v)]
    expect = _pallas_bwd_kernels(*bf, _j(mask), _j(dnum), _j(dden),
                                 interpret=True)
    tb = [_t(a, torch.bfloat16) for a in (q, k, v)]
    args = (*tb, _t(mask), _t(dnum), _t(dden))
    got = (K.sigmoid_attention_dq(*args), *K.sigmoid_attention_dkv(*args))
    for name, g, e in zip(("dq", "dk", "dv"), got, expect):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(e, np.float32), **BF16)
        assert_close(name, g, torch.from_numpy(
            np.asarray(e, np.float32)).to(torch.bfloat16), "grad")


def test_mask_gets_no_gradient():
    q, k, v, mask = make_inputs(18, 10, 12, 1, masked=True)
    m = _t(mask).requires_grad_()
    qs = _t(q).requires_grad_()
    K.sigmoid_attention_flash(qs, _t(k), _t(v), m).sum().backward()
    assert m.grad is None and qs.grad is not None
