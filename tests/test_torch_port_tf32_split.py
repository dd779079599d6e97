"""The split-precision TF32 products ("3xTF32") that the wide K2, K3 and
K4 run on the tensor cores at float32 inputs, emulated on the CPU and held
against the JAX package's ``sigmoid_attention`` under
``kernels/tolerance.py``: the forward's output, and dq, dk and dv from the
cotangents that the port's autograd Function derives. It shows that the
tolerance admits the kernels' arithmetic before a card runs it.

The emulation follows the kernels' products: every operand x becomes
hi = x with its low 13 mantissa bits cleared (a TF32 value) and
lo = x - hi cleared the same way, and a·b is lo_a·hi_b + hi_a·lo_b +
hi_a·hi_b, each product exact in float32 and summed in float32. One pass
(hi_a·hi_b alone) is also run, and must fail the rule: that is why the
kernels take three.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difformer_tpu.ops.sigmoid_attention import (
    sigmoid_attention as jax_sigmoid_attention,
)
from difformer_tpu_torch.kernels.tolerance import assert_close

from torch_port_helpers import make_inputs
from torch_port_helpers import to_jax as _j


def _tf32(x):
    """x with its low 13 mantissa bits cleared."""
    return (x.contiguous().view(torch.int32) & -(1 << 13)).view(
        torch.float32)


def _mm(a, b, passes):
    """a @ b as the tensor cores take it: 3 TF32 products, or 1."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _emulated(q, k, v, mask, w, passes):
    """(out, dq, dk, dv) of one head, [N, M] x [L, M] x [L, D], with the
    kernels' products; the cotangents dnum, dden as the autograd Function
    derives them from g = w. dl enters dq in k's dtype and dk in q's, which
    at float32 inputs leaves it as it is."""
    s = torch.sigmoid(_mm(q, k.t(), passes))
    if mask is not None:
        s = s * mask
    num, den = _mm(s, v, passes), s.sum(-1)
    out = num / den[:, None]
    dnum = w / den[:, None]
    dden = -(w * out).sum(-1) / den
    ds = _mm(dnum, v.t(), passes) + dden[:, None]
    dl = ds * s * (1 - s)
    return (out, _mm(dl.to(k.dtype), k, passes),
            _mm(dl.to(q.dtype).t(), q, passes), _mm(s.t(), dnum, passes))


def _case(n, l, width, masked, seed):
    q, k, v, mask = make_inputs(seed, n, l, 1, m=width, d=width,
                                masked=masked)
    q, k = q * width ** -0.25, k * width ** -0.25
    w = np.random.default_rng(seed + 1).normal(size=(n, 1, width)).astype(
        np.float32)

    def loss(q_, k_, v_):
        out = jax_sigmoid_attention(q_, k_, v_, key_mask=_j(mask))
        return jnp.sum(out * w), out

    (_, out_j), grads = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(_j(q), _j(k), _j(v))
    ref = [torch.from_numpy(np.array(a))[:, 0] for a in (out_j, *grads)]
    args = [torch.from_numpy(a)[:, 0] for a in (q, k, v, w)]
    m = None if mask is None else torch.from_numpy(mask)
    return args[:3] + [m, args[3]], ref


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n,l,width", [(48, 56, 300), (56, 48, 400)])
def test_three_tf32_passes_meet_the_float32_rule(n, l, width, masked):
    args, (out_j, _, dk_j, dv_j) = _case(n, l, width, masked, width + n)
    out, _, dk, dv = _emulated(*args, passes=3)
    assert_close("out", out, out_j, "out")
    assert_close("dk", dk, dk_j, "grad")
    assert_close("dv", dv, dv_j, "grad")


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n,l,width", [(48, 56, 300), (56, 48, 400)])
def test_three_tf32_passes_meet_the_float32_rule_for_dq(n, l, width,
                                                        masked):
    """The wide K3's products: s = q·kᵀ and ds = dnum·vᵀ, then dq = dl·k."""
    args, (_, dq_j, _, _) = _case(n, l, width, masked, 2 * width + n)
    _, dq, _, _ = _emulated(*args, passes=3)
    assert_close("dq", dq, dq_j, "grad")


@pytest.mark.parametrize("width", [300, 400])
def test_one_tf32_pass_does_not(width):
    args, (out_j, dq_j, _, _) = _case(48, 56, width, False, width)
    out, dq, _, _ = _emulated(*args, passes=1)
    with pytest.raises(AssertionError):
        assert_close("out", out, out_j, "out")
    with pytest.raises(AssertionError):
        assert_close("dq", dq, dq_j, "grad")
