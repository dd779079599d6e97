"""How closely a kernel's output must agree with its plain version.

One rule for every comparison of the flash sigmoid attention kernels with
their plain versions (``chip_smoke.py``, ``tests/test_torch_port_cuda.py``)
and of the plain versions with the JAX package's Pallas kernels: ``got``
passes when ``|got - ref| <= atol·scale + rtol·|ref|`` everywhere.

* float32 outputs take the JAX package's own tolerances for this kernel
  (``tests/test_pallas_kernels.py``): rtol 1e-4 / atol 1e-5 for the
  forward's ``out``, ``num`` and ``den``, rtol 1e-3 / atol 1e-4 for the
  gradients, with scale 1. The unnormalized numerator is the exception: it
  is a raw sum over L keys, which float32 rounds in proportion to L, so its
  scale is its row's denominator. That holds ``num`` to what ``num/den`` is
  held to, per unit of ``den``, at any L.
* bfloat16 outputs (``out`` and the gradients at bfloat16 inputs) take
  rtol 2e-2 and an atol of 1e-2 of the largest ``|ref|``. The plain version
  rounds at the kernel's points, so the two differ by float32 summation
  order and by a bfloat16 step (2⁻⁸ relative) where a sum straddles a
  rounding boundary. An absolute limit would not scale: at N = L = 4096 the
  attention's output, a mean over thousands of values, is about 0.02, and a
  fixed 0.05 passes almost every element of an output of zeros.

``den`` and the unnormalized ``num`` are float32 sums at either input dtype
and keep the float32 rule.
"""

from __future__ import annotations

import torch

#: (rtol, atol) for float32 outputs, by kind of output.
FLOAT32 = {
    "out": (1e-4, 1e-5),
    "num": (1e-4, 1e-5),
    "den": (1e-4, 1e-5),
    "grad": (1e-3, 1e-4),
}
#: (rtol, atol as a share of max |ref|) for bfloat16 outputs.
BFLOAT16 = (2e-2, 1e-2)


def limit(ref, kind, den=None):
    """Largest |got - ref| allowed at each element of ``ref`` (float32).
    ``kind`` is "out", "num", "den" or "grad"; "num" needs its rows'
    denominators ``den`` [..., H]."""
    if kind not in FLOAT32:
        raise ValueError(f"kind must be one of {sorted(FLOAT32)}, got {kind!r}")
    mag = ref.float().abs()
    if ref.dtype == torch.bfloat16:
        rtol, atol = BFLOAT16
        return atol * mag.max() + rtol * mag
    rtol, atol = FLOAT32[kind]
    if kind == "num":
        if den is None:
            raise ValueError("the numerator's limit needs its denominators")
        return atol * den.float()[..., None] + rtol * mag
    return atol + rtol * mag


def assert_close(label, got, ref, kind, den=None):
    """Raise AssertionError unless ``got`` is finite, has ``ref``'s shape and
    dtype, and is within :func:`limit` of it; returns the max abs error."""
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(
            f"{label}: got {got.dtype} {tuple(got.shape)}, expected "
            f"{ref.dtype} {tuple(ref.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{label}: non-finite values")
    err = (got.float() - ref.float()).abs()
    bad = err > limit(ref, kind, den)
    if bad.any():
        raise AssertionError(
            f"{label}: {int(bad.sum())} of {bad.numel()} values out of the "
            f"{kind!r} tolerance for {ref.dtype}; max abs err "
            f"{err.max().item():.3e}")
    return err.max().item()
