"""K1-dval for every head at once, on the CPU: ``spmm``'s value gradient
through the port's one autograd Function for all heads
(``difformer_tpu_torch/kernels/spmm.py`` ``CsrSpmm``, one K1 launch a head
each way and one K1-dval for every head) against ``jax.vjp`` of the JAX
package's ``spmm`` (``difformer_tpu/ops/graph_ops.py``) taken head by head,
on a directed graph with a hub row of 700 in-edges, which the plan's
``RowSplit``s cut into segments, at rtol 2e-4 / atol 2e-5 (the port's test
tolerance, ROADMAP.md); the output and the x gradient too. On the CPU the
wrapper runs its plain version, so the count of its calls is what these
tests can see of the launches: one a backward, whatever the heads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difformer_tpu.ops import graph_ops as JG
from difformer_tpu_torch.kernels import spmm as K1
from difformer_tpu_torch.nn import gnns as Z
from difformer_tpu_torch.ops import graph_ops as TG
import torch_port_helpers  # noqa: F401  (sets torch's threads)

TOL = dict(rtol=2e-4, atol=2e-5)
HUB, HUB_EDGES = 5, 700


def _hub_graph(n=400, e=1600, seed=2):
    """Directed edges with distinct values, empty rows, and receiver
    ``HUB`` taking ``HUB_EDGES`` more (a heavy row at K1's threshold)."""
    rng = np.random.default_rng(seed)
    s = np.concatenate([rng.integers(0, n - 3, e),
                        rng.integers(0, n, HUB_EDGES)])
    r = np.concatenate([rng.integers(2, n, e), np.full(HUB_EDGES, HUB)])
    vals = rng.permutation(s.size).astype(np.float32) / s.size + 0.1
    return n, s, r, vals


def _inputs(heads, width, seed=4):
    n, s, r, vals = _hub_graph()
    rng = np.random.default_rng(seed + heads * 1000 + width)
    shape = (n, heads, width) if heads > 1 else (n, width)
    if heads > 1:
        vals = np.stack([vals * (h + 1) - 0.3 * h for h in range(heads)], 1)
    x = rng.normal(size=shape).astype(np.float32)
    cot = rng.normal(size=shape).astype(np.float32)
    return n, s, r, vals, x, cot


def _jax_heads(n, s, r, heads):
    """The JAX package's ``spmm`` a head at a time ([E] values for one
    head, as the port's H = 1 path takes them)."""
    def product(v, xx):
        if heads == 1:
            return JG.spmm(v, jnp.asarray(s), jnp.asarray(r), xx, n)
        return jnp.stack([JG.spmm(v[:, h], jnp.asarray(s), jnp.asarray(r),
                                  xx[:, h], n) for h in range(heads)], 1)
    return product


def _close(got, ref, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL,
                               err_msg=what)


def test_hub_row_is_split():
    n, s, r, _ = _hub_graph()
    plan = TG.build_spmm_plan(None, torch.from_numpy(s),
                              torch.from_numpy(r), n, value_grad=True)
    degree = int((r == HUB).sum())
    assert degree >= 600
    assert plan.split.num_heavy == 1
    assert int(plan.split.rows[0]) == HUB
    assert plan.split.num_segments == -(-degree // K1.SPLIT_THRESHOLD)
    t = K1.DVAL_SPLIT_THRESHOLD
    assert plan.dval_split.threshold == t
    assert TG.build_spmm_plan(None, torch.from_numpy(s), torch.from_numpy(r),
                              n).dval_split is None
    degrees = (plan.row_ptr[1:] - plan.row_ptr[:-1]).long()
    assert plan.dval_split.num_segments == int(
        ((degrees + t - 1) // t)[degrees > t].sum())


@pytest.mark.parametrize("width", [7, 16, 300])
@pytest.mark.parametrize("heads", [1, 2, 3])
def test_value_gradient_matches_jax_per_head(heads, width):
    """The value gradient [E] (one head) or [E, H], the output and the x
    gradient of one Function for all heads against the JAX product a head
    at a time."""
    n, s, r, vals, x, cot = _inputs(heads, width)
    ref, vjp = jax.vjp(_jax_heads(n, s, r, heads), jnp.asarray(vals),
                       jnp.asarray(x))
    g_vals, g_x = vjp(jnp.asarray(cot))
    plan = TG.build_spmm_plan(None, torch.from_numpy(s), torch.from_numpy(r),
                              n, value_grad=True)
    tv = torch.from_numpy(vals).requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    out = TG.spmm(tv, None, None, tx, plan=plan)
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out, ref, "out")
    _close(tv.grad, g_vals, "dvalues")
    _close(tx.grad, g_x, "dx")
    assert tv.grad.shape == tv.shape


def _counting(monkeypatch):
    calls = []
    real = K1.csr_spmm_dval

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(K1, "csr_spmm_dval", counted)
    return calls


@pytest.mark.parametrize("heads", [1, 2, 3])
def test_one_dval_call_per_backward(monkeypatch, heads):
    """One K1-dval call a backward for every head, on dout and x as
    [N, H, D]."""
    calls = _counting(monkeypatch)
    n, s, r, vals, x, cot = _inputs(heads, 16)
    plan = TG.build_spmm_plan(None, torch.from_numpy(s), torch.from_numpy(r),
                              n, value_grad=True)
    tv = torch.from_numpy(vals).requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    for step in range(2):
        (TG.spmm(tv, None, None, tx, plan=plan)
         * torch.from_numpy(cot)).sum().backward()
        assert calls == [(n, heads, 16)] * (step + 1)


def test_gat_layer_takes_one_dval_call(monkeypatch):
    """A GAT layer of 3 heads: one K1-dval call in its backward."""
    calls = _counting(monkeypatch)
    n, s, r, _ = _hub_graph()
    layer = Z.GATLayer(12, 5, heads=3)
    layer.reset_parameters(torch.Generator().manual_seed(0))
    plan = Z.gat_plan(torch.from_numpy(s), torch.from_numpy(r), n)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(n, 12)).astype(np.float32))
    layer(x, plan).square().sum().backward()
    assert calls == [(n, 3, 5)]
    assert layer.att_src.grad is not None


@pytest.mark.parametrize("heads", [1, 3])
def test_dval_reads_head_views_in_place(heads):
    """K1-dval on strided [N, H, D] views (a wider buffer's columns, every
    other head) equals it on contiguous copies, and each head equals the
    one-head call on that head's rows."""
    n, s, r, _ = _hub_graph()
    plan = TG.build_spmm_plan(None, torch.from_numpy(s), torch.from_numpy(r),
                              n, value_grad=True)
    rng = np.random.default_rng(9)
    g_buf = torch.from_numpy(rng.normal(size=(n, 2 * heads, 9)).astype(
        np.float32))
    x_buf = torch.from_numpy(rng.normal(size=(n, heads, 12)).astype(
        np.float32))
    g, x = g_buf[:, ::2, :7], x_buf[:, :, 2:9]
    kw = dict(row_ptr=plan.row_ptr, split=plan.dval_split)
    got = K1.csr_spmm_dval(g, x, plan.rows, plan.col, **kw)
    assert got.shape == (plan.num_edges, heads)
    want = K1.csr_spmm_dval(g.contiguous(), x.contiguous(), plan.rows,
                            plan.col, **kw)
    assert torch.equal(got, want)
    for h in range(heads):
        one = K1.csr_spmm_dval(g[:, h].contiguous(), x[:, h].contiguous(),
                               plan.rows, plan.col, **kw)
        torch.testing.assert_close(got[:, h], one, rtol=1e-6, atol=1e-6)
