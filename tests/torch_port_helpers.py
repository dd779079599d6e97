"""Shared inputs and fixtures of the port's tests (tests/test_torch_port_*).

Inputs are made with numpy from a seed and handed to both packages. This
module imports no JAX at import time, so the GPU tests
(test_torch_port_cuda.py) also run where JAX is not installed.
"""

import numpy as np
import pytest
import torch


def make_inputs(seed, n, l, heads, m=8, d=16, masked=False):
    """q [n,H,m], k [l,H,m], v [l,H,d] float32 and a binary key mask [l]
    (or None)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, heads, m)).astype(np.float32)
    k = rng.normal(size=(l, heads, m)).astype(np.float32)
    v = rng.normal(size=(l, heads, d)).astype(np.float32)
    mask = None
    if masked:
        mask = (rng.random(l) > 0.3).astype(np.float32)
        mask[0] = 1.0
    return q, k, v, mask


def to_torch(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


def to_jax(a, dtype=None):
    import jax.numpy as jnp

    return None if a is None else jnp.asarray(a, dtype or jnp.float32)


@pytest.fixture
def cuda():
    """The GPU, with TF32 off; skips where there is none (the CUDA kernels
    have no CPU mode)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")
