"""DIFFormer-s linear attention in the port against the JAX package's
(``ops/linear_attention.py``): the four functions at H = 1 and 2, with and
without a key mask and ``num_queries``, forward and the gradients of a
random cotangent (``jax.vjp`` against ``backward``). The port runs on the
CPU; tolerance rtol 2e-4 / atol 2e-5 (tests/test_reference_exec.py:334).
"""

import jax
import numpy as np
import pytest
import torch

from difformer_tpu.ops import linear_attention as J
from difformer_tpu_torch.ops import linear_attention as T
from torch_port_helpers import make_inputs, to_jax, to_torch

TOL = dict(rtol=2e-4, atol=2e-5)
N = 30


def _close(got, ref, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL,
                               err_msg=what)


def _vjp_both(jfn, tfn, arrays, seed):
    """Forward outputs and the gradients of every array (numpy inputs) of
    the JAX and the torch function, for the same random cotangents."""
    out_j, vjp = jax.vjp(jfn, *[to_jax(a) for a in arrays])
    leaves_j = out_j if isinstance(out_j, tuple) else (out_j,)
    rng = np.random.default_rng(seed)
    cots = [rng.normal(size=np.shape(o)).astype(np.float32)
            for o in leaves_j]
    grads_j = vjp(tuple(to_jax(c) for c in cots) if isinstance(out_j, tuple)
                  else to_jax(cots[0]))
    ts = [to_torch(a).requires_grad_() for a in arrays]
    out_t = tfn(*ts)
    leaves_t = out_t if isinstance(out_t, tuple) else (out_t,)
    torch.autograd.backward(list(leaves_t), [to_torch(c) for c in cots])
    for i, (a, b) in enumerate(zip(leaves_t, leaves_j)):
        _close(a, b, f"output {i}")
    for i, (t, g) in enumerate(zip(ts, grads_j)):
        _close(t.grad, g, f"gradient of input {i}")


@pytest.mark.parametrize("num_queries", [None, 41])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("head_mean", [False, True])
def test_simple_attention_matches_jax(head_mean, heads, masked, num_queries):
    q, k, v, mask = make_inputs(1, N, N, heads, m=8, d=16, masked=masked)
    kw = dict(num_queries=num_queries, head_mean=head_mean)
    _vjp_both(
        lambda q, k, v: J.simple_attention(q, k, v, key_mask=to_jax(mask),
                                           **kw),
        lambda q, k, v: T.simple_attention(q, k, v, key_mask=to_torch(mask),
                                           **kw),
        (q, k, v), seed=2)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("heads", [1, 2])
def test_simple_attention_output_attn_matches_jax(heads, masked):
    """The explicit [N, L, H] attention, divided by the [N, 1, H]
    normaliser at every H."""
    q, k, v, mask = make_inputs(3, N, N, heads, m=8, d=16, masked=masked)
    _vjp_both(
        lambda q, k, v: J.simple_attention(q, k, v, key_mask=to_jax(mask),
                                           output_attn=True),
        lambda q, k, v: T.simple_attention(q, k, v, key_mask=to_torch(mask),
                                           output_attn=True),
        (q, k, v), seed=4)


def test_single_value_head_broadcasts():
    """use_weight=False feeds [L, 1, D] values to H = 2 query heads."""
    q, k, v, _ = make_inputs(5, N, N, 2, m=8, d=8)
    _vjp_both(J.simple_attention, T.simple_attention,
              (q, k, v[:, :1]), seed=6)


@pytest.mark.parametrize("num_queries", [None, 41])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("with_bias", [False, True])
def test_head_mean_factored_matches_jax(with_bias, heads, masked,
                                        num_queries):
    q, k, _, mask = make_inputs(7, N, N, heads, m=8, d=16, masked=masked)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(N, 12)).astype(np.float32)
    w = (0.3 * rng.normal(size=(12, heads, 8))).astype(np.float32)
    b = rng.normal(size=(heads, 8)).astype(np.float32)
    arrays = (q, k, x, w) + ((b,) if with_bias else ())

    def call(mod, to):
        def fn(q, k, x, w, b=None):
            return mod.simple_attention_head_mean_factored(
                q, k, x, w, b, key_mask=to(mask), num_queries=num_queries)
        return fn

    _vjp_both(call(J, to_jax), call(T, to_torch), arrays, seed=9)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("heads", [1, 2])
def test_aggregates_match_jax(heads, masked):
    _, k, v, mask = make_inputs(10, N, N, heads, m=8, d=16, masked=masked)
    _vjp_both(
        lambda k, v: J.simple_attention_aggregates(k, v, to_jax(mask))[:3],
        lambda k, v: T.simple_attention_aggregates(k, v, to_torch(mask))[:3],
        (k, v), seed=11)
    count_j = J.simple_attention_aggregates(to_jax(k), to_jax(v),
                                            to_jax(mask))[3]
    count_t = T.simple_attention_aggregates(to_torch(k), to_torch(v),
                                            to_torch(mask))[3]
    assert count_t.dtype == torch.float32 and count_t.dim() == 0
    assert float(count_t) == float(count_j)


@pytest.mark.parametrize("heads", [1, 2])
def test_frobenius_normalize_matches_jax(heads):
    q = make_inputs(12, N, N, heads)[0]
    _vjp_both(J._frobenius_normalize, T._frobenius_normalize, (q,), seed=13)


def test_head_mean_equals_mean_after_divide():
    """The scalar-folded head mean is the plain output's mean over heads,
    up to float reassociation."""
    q, k, v, mask = (to_torch(a) for a in make_inputs(14, N, N, 4, m=8, d=16,
                                                      masked=True))
    fused = T.simple_attention(q, k, v, key_mask=mask, head_mean=True)
    plain = T.simple_attention(q, k, v, key_mask=mask).mean(1)
    torch.testing.assert_close(fused, plain, rtol=1e-5, atol=1e-6)


def test_axis_name_raises():
    """An axis_name that is not a process group (the port has no named
    axes) raises; the sharded form itself is held to the JAX package's in
    tests/test_torch_port_sharded.py."""
    q, k, v, _ = (to_torch(a) for a in make_inputs(15, N, N, 1))
    with pytest.raises(TypeError, match="process group"):
        T.simple_attention(q, k, v, axis_name="nodes")
