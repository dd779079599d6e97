"""The rule that holds the kernels to their plain versions
(difformer_tpu_torch/kernels/tolerance.py) must tell a wrong output from a
right one at the sizes the kernels are checked at: an output of zeros, or
one whose rows are each moved one place down, fails; the plain version with
a rounding step's noise passes. Runs on the CPU through the plain versions;
imports no JAX.
"""

import numpy as np
import pytest
import torch

from difformer_tpu_torch.kernels import sigmoid_attention as K
from difformer_tpu_torch.kernels.tolerance import assert_close, limit
from torch_port_helpers import make_inputs
from torch_port_helpers import to_torch as _t

# N = L = 2048: the attention's output and gradients are about 0.02 on
# average, below the fixed 0.05 limit that the rule replaces
N = L = 2048
OUTPUTS = ["out", "den", "num", "dq", "dk", "dv"]
KIND = {"out": "out", "den": "den", "num": "num", "dq": "grad", "dk": "grad",
        "dv": "grad"}


def _outputs(dtype):
    """Every output of K2, K3 and K4 at (N, L, H=1, M=D=64) from the plain
    versions, with the normalized op's own cotangents (so dq and dk are of
    size 1e-3), and the unnormalized denominators."""
    q, k, v, mask = (_t(a, dtype)
                     for a in make_inputs(30, N, L, 1, m=64, d=64))
    out, den = K.sigmoid_attention_fwd_plain(q, k, v, mask)
    num, den_u = K.sigmoid_attention_fwd_plain(q, k, v, mask,
                                               normalize=False)
    g = torch.from_numpy(
        np.random.default_rng(31).normal(size=(N, 1, 64)).astype(np.float32))
    dnum = g / den[..., None]
    dden = -(g * out.float()).sum(-1) / den
    dq = K.sigmoid_attention_dq_plain(q, k, v, mask, dnum, dden)
    dk, dv = K.sigmoid_attention_dkv_plain(q, k, v, mask, dnum, dden)
    return dict(out=out, den=den, num=num, dq=dq, dk=dk, dv=dv), den_u


_CACHE = {}


def outputs(dtype):
    if dtype not in _CACHE:
        _CACHE[dtype] = _outputs(dtype)
    return _CACHE[dtype]


@pytest.mark.parametrize("wrong", ["zeros", "rows moved"])
@pytest.mark.parametrize("name", OUTPUTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rejects_a_wrong_output(dtype, name, wrong):
    refs, den_u = outputs(dtype)
    ref = refs[name]
    bad = torch.zeros_like(ref) if wrong == "zeros" else ref.roll(1, 0)
    with pytest.raises(AssertionError, match="out of the"):
        assert_close(name, bad, ref, KIND[name], den=den_u)


@pytest.mark.parametrize("name", OUTPUTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_accepts_rounding_noise(dtype, name):
    """One rounding step of the output's dtype, up or down at random, on
    every element passes (a bfloat16 step is 2⁻⁸ relative, float32's
    2⁻²⁴)."""
    refs, den_u = outputs(dtype)
    ref = refs[name]
    step = 2.0 ** (-8 if ref.dtype == torch.bfloat16 else -24)
    sign = torch.from_numpy(np.random.default_rng(32).choice(
        [-1.0, 1.0], size=tuple(ref.shape)).astype(np.float32))
    noisy = (ref.float() * (1 + step * sign)).to(ref.dtype)
    assert assert_close(name, noisy, ref, KIND[name], den=den_u) >= 0


def test_numerator_limit_grows_with_its_denominator():
    ref = torch.ones((2, 1, 3))
    den = torch.tensor([[1.0], [1000.0]])
    lim = limit(ref, "num", den)
    assert torch.allclose(lim[0], torch.full((1, 3), 1e-5 + 1e-4))
    assert torch.allclose(lim[1], torch.full((1, 3), 1e-2 + 1e-4))


def test_shape_dtype_and_kind_are_checked():
    ref = torch.ones((4, 1, 2))
    with pytest.raises(AssertionError, match="expected"):
        assert_close("x", ref.to(torch.bfloat16), ref, "out")
    with pytest.raises(AssertionError, match="non-finite"):
        assert_close("x", ref * float("nan"), ref, "out")
    with pytest.raises(ValueError):
        limit(ref, "fwd")
    with pytest.raises(ValueError):
        limit(ref, "num")
