"""Flash sigmoid attention forward (K2): the port's plain version against the
JAX package's Pallas kernel run in interpret mode. The CUDA kernel is held
against the plain version in test_torch_port_cuda.py.

Tolerances are the JAX package's own for this kernel
(tests/test_pallas_kernels.py): float32 forward rtol 1e-4 / atol 1e-5,
bfloat16 0.05 / 0.05, and at bfloat16 also the rule the CUDA kernel is
held to (difformer_tpu_torch/kernels/tolerance.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difformer_tpu.kernels.pallas_sigmoid_attention import (
    sigmoid_attention_pallas,
    sigmoid_attention_pallas_unnormalized,
)
from difformer_tpu.ops.sigmoid_attention import (
    sigmoid_attention_dense as jax_dense,
)
from difformer_tpu_torch.kernels import sigmoid_attention as K
from difformer_tpu_torch.kernels.tolerance import assert_close
from difformer_tpu_torch.ops.sigmoid_attention import (
    sigmoid_attention,
    sigmoid_attention_dense,
)

from torch_port_helpers import make_inputs
from torch_port_helpers import to_jax as _j
from torch_port_helpers import to_torch as _t

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=0.05, atol=0.05)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("n,l", [(64, 64), (100, 130)])
def test_fwd_plain_matches_pallas(n, l, heads, masked):
    q, k, v, mask = make_inputs(0, n, l, heads, masked=masked)
    expect = sigmoid_attention_pallas(_j(q), _j(k), _j(v), _j(mask),
                                      interpret=True)
    num_e, den_e = sigmoid_attention_pallas_unnormalized(
        _j(q), _j(k), _j(v), _j(mask), interpret=True)

    out, den = K.sigmoid_attention_fwd(_t(q), _t(k), _t(v), _t(mask))
    assert out.dtype == torch.float32 and den.shape == (n, heads)
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), **F32)
    np.testing.assert_allclose(den.numpy(), np.asarray(den_e), **F32)

    num, den2 = K.sigmoid_attention_fwd(_t(q), _t(k), _t(v), _t(mask),
                                        normalize=False)
    np.testing.assert_allclose(num.numpy(), np.asarray(num_e), **F32)
    np.testing.assert_allclose(den2.numpy(), np.asarray(den_e), **F32)


def test_fwd_plain_bf16_matches_pallas():
    q, k, v, mask = make_inputs(1, 96, 80, 2, m=16, d=16, masked=True)
    expect = sigmoid_attention_pallas(
        _j(q, jnp.bfloat16), _j(k, jnp.bfloat16), _j(v, jnp.bfloat16),
        _j(mask), interpret=True)
    out, den = K.sigmoid_attention_fwd(
        _t(q, torch.bfloat16), _t(k, torch.bfloat16), _t(v, torch.bfloat16),
        _t(mask))
    assert out.dtype == torch.bfloat16 and den.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(expect, np.float32), **BF16)
    # and the rule the CUDA kernel is held to, relative to the largest value
    assert_close("out", out, torch.from_numpy(
        np.asarray(expect, np.float32)).to(torch.bfloat16), "out")


@pytest.mark.parametrize("masked", [False, True])
def test_dense_output_attn_matches(masked):
    q, k, v, mask = make_inputs(2, 30, 40, 2, masked=masked)
    out_e, attn_e = jax_dense(_j(q), _j(k), _j(v), key_mask=_j(mask),
                              output_attn=True)
    out, attn = sigmoid_attention_dense(_t(q), _t(k), _t(v),
                                        key_mask=_t(mask), output_attn=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_e), **F32)
    np.testing.assert_allclose(attn.numpy(), np.asarray(attn_e), **F32)
    # the flash path computes the same function
    flash = sigmoid_attention(_t(q), _t(k), _t(v), key_mask=_t(mask))
    np.testing.assert_allclose(flash.numpy(), out.numpy(), **F32)


def test_single_value_head_broadcasts():
    """use_weight=False gives v one head; it is shared by every query head."""
    q, k, v, _ = make_inputs(3, 20, 20, 2, d=8)
    v1 = v[:, :1]
    expect = jax_dense(_j(q), _j(k), _j(np.repeat(v1, 2, axis=1)))
    got = sigmoid_attention(_t(q), _t(k), _t(v1))
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **F32)


def test_cpu_path_counts_no_launch():
    K.reset_launch_counts()
    q, k, v, _ = make_inputs(4, 16, 16, 1)
    K.sigmoid_attention_fwd(_t(q), _t(k), _t(v))
    assert all(c == 0 for c in K.LAUNCHES.values())


def test_wrapper_rejects_bad_inputs():
    q, k, v, _ = make_inputs(5, 8, 8, 1, m=4, d=4)
    with pytest.raises(ValueError):
        K.sigmoid_attention_fwd(_t(q), _t(k[:4]), _t(v))
    with pytest.raises(TypeError):
        K.sigmoid_attention_fwd(_t(q, torch.float64), _t(k), _t(v))
    wide = np.zeros((8, 1, K.MAX_WIDTH + 1), np.float32)
    with pytest.raises(ValueError):
        K.sigmoid_attention_fwd(_t(wide), _t(wide), _t(v))
