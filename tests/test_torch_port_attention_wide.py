"""The flash sigmoid attention at the set track's widths (hidden 300 for
cifar10 and 20news, 400 for stl10, one head: M = D = 300 and 400), which
the kernels take on their wide path: the port's plain version (its CPU
path) against the JAX package's ``sigmoid_attention`` on the same numpy
inputs, forward and the gradients of q, k and v, under ROADMAP.md's rule
for the port (rtol 2e-4 / atol 2e-5). The CUDA kernels' wide path is held
against the plain version in test_torch_port_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difformer_tpu.ops.sigmoid_attention import (
    sigmoid_attention as jax_sigmoid_attention,
)
from difformer_tpu_torch.kernels import sigmoid_attention as K
from difformer_tpu_torch.ops.sigmoid_attention import sigmoid_attention

from torch_port_helpers import make_inputs
from torch_port_helpers import to_jax as _j

TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n,l,heads,width", [(40, 56, 1, 300),
                                             (48, 40, 1, 400),
                                             (24, 30, 2, 300)])
def test_wide_forward_and_grads_match_jax(n, l, heads, width, masked):
    assert K.is_wide(width, width)
    q, k, v, mask = make_inputs(width + n, n, l, heads, m=width, d=width,
                                masked=masked)
    # unit-variance scores, off the sigmoid's flat ends
    q, k = q * width ** -0.25, k * width ** -0.25
    w = np.random.default_rng(1).normal(size=(n, heads, width)).astype(
        np.float32)

    def loss_j(q_, k_, v_):
        out = jax_sigmoid_attention(q_, k_, v_, key_mask=_j(mask))
        return jnp.sum(out * w), out

    (_, out_j), grads_j = jax.value_and_grad(
        loss_j, argnums=(0, 1, 2), has_aux=True)(_j(q), _j(k), _j(v))

    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out_t = sigmoid_attention(qt, kt, vt, key_mask=(
        None if mask is None else torch.from_numpy(mask)))
    (out_t * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               **TOL)
    for name, got, expect in zip("qkv", (qt.grad, kt.grad, vt.grad),
                                 grads_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("m,d,wide", [(256, 256, False), (257, 64, True),
                                      (64, 257, True), (512, 512, True)])
def test_wide_path_threshold(m, d, wide):
    assert K.is_wide(m, d) is wide
