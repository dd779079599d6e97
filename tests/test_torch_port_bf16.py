"""The port's bf16 ``compute_dtype`` and ``remat`` against the JAX
package's, on the CPU.

bf16 (as ``tests/test_bf16.py`` runs the JAX model): the same carried
weights and numpy inputs through both packages at
``compute_dtype="bfloat16"``, for DIFFormer-s and DIFFormer-a. The two
round at other places (the JAX package rounds each GCN message and sums in
bf16, K1 sums in f32 and rounds once; the frameworks' bf16 matmuls differ),
so the logits and a 5-step Adam trajectory are held to the bf16 rule of
``kernels/tolerance.py`` (rtol 2e-2, atol 1e-2 of the largest reference
value), and the gradients to the f32 gradients at the scale of the JAX
package's own bf16 error.
The port's bf16 logits stay as close to the f32 logits as the JAX
package's are, and its GCN product at bf16 closer. K1's plain version at
bf16 is the f32 sum of the same bf16 inputs rounded once.

remat: forward and gradients bit-equal to ``remat=False`` in the port, and
equal to the JAX package's ``remat=True`` at rtol 2e-4 / atol 2e-5
(tests/test_reference_exec.py:334). Both fits run both options: the
epoch-block fit and the mini-batch trainer's ``use_scan`` path give the
loop's losses bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difformer_tpu.data.graph import GraphData as JGraph
from difformer_tpu.data.splits import class_rand_splits
from difformer_tpu.data.synthetic import random_graph
from difformer_tpu.data.transforms import standard_preprocess
from difformer_tpu.nn.difformer import DIFFormer as JDIFFormer
from difformer_tpu.ops.graph_ops import gcn_conv as jax_gcn_conv
from difformer_tpu.train.trainer import FullBatchTrainer as JTrainer
from difformer_tpu.train.trainer import idx_to_mask
from difformer_tpu_torch import DIFFormer, FullBatchTrainer, GraphData
from difformer_tpu_torch.kernels import spmm as K1
from difformer_tpu_torch.kernels.tolerance import BFLOAT16
from difformer_tpu_torch.ops import graph_ops
from difformer_tpu_torch.utils import weights as W
import torch_port_helpers  # noqa: F401  (sets torch's threads)

TOL = dict(rtol=2e-4, atol=2e-5)
N, F, C, HIDDEN = 60, 8, 3, 16
BF16 = "bfloat16"

# (kernel, heads, flags): the main path (one head), two heads fused, and
# spmm_first with the head mean fused (Wv factored) and not
VARIANTS = [
    ("simple", 1, {}),
    ("simple", 2, {}),
    ("simple", 4, {"spmm_first": True}),
    ("simple", 2, {"spmm_first": True, "fuse_head_mean": False}),
    ("simple", 1, {"use_weight": False, "graph_weight": 0.7}),
    ("sigmoid", 1, {}),
    ("sigmoid", 2, {"spmm_first": True}),
]
IDS = [f"{k}-h{h}-{'-'.join(f) or 'plain'}" for k, h, f in VARIANTS]


def _graph(n=N, e=4 * N, f=F, seed=4):
    x, ei, y = random_graph(n, e, f, C, seed=seed, homophily=0.7)
    ei = standard_preprocess(ei, n)
    return (x, ei, y, JGraph.from_numpy(x, ei),
            GraphData.from_numpy(x, ei, device="cpu"))


def _pair(kernel, heads, flags, n=N, f=F, layers=2, **options):
    """(JAX model, carried params, JAX graph, port model, port graph)."""
    x, ei, y, jg, tg = _graph(n, 4 * n, f)
    kw = dict(num_layers=layers, num_heads=heads, kernel=kernel, dropout=0.0,
              **flags)
    jm = JDIFFormer(hidden_channels=HIDDEN, out_channels=C, **kw, **options)
    params = JDIFFormer(hidden_channels=HIDDEN, out_channels=C, **kw).init(
        jax.random.PRNGKey(heads), jg.node_feat, jg.senders,
        jg.receivers)["params"]
    tm = DIFFormer(f, HIDDEN, C, device="cpu", **kw, **options)
    W.load_params(tm, params)
    return jm, params, jg, tm, tg


def _assert_bf16_close(got, ref, what):
    """The bf16 rule of kernels/tolerance.py, on f32 results."""
    ref = np.asarray(ref, np.float64)
    rtol, atol = BFLOAT16
    lim = atol * np.abs(ref).max() + rtol * np.abs(ref)
    err = np.abs(np.asarray(got, np.float64) - ref)
    assert np.all(err <= lim), (what, err.max(), (err - lim).max())


def _jax_logits(jm, params, jg):
    """The JAX model's logits, applied as ``tests/test_bf16.py`` applies
    it (op by op: under ``jit`` XLA's CPU fusions keep some bf16
    intermediates in f32)."""
    return np.asarray(jm.apply({"params": params}, jg.node_feat, jg.senders,
                               jg.receivers))


def _port_logits(tm, tg):
    tm.eval()
    with torch.no_grad():
        return tm(tg.node_feat, tg.senders, tg.receivers)


@pytest.mark.parametrize("kernel,heads,flags", VARIANTS, ids=IDS)
def test_bf16_forward_matches_jax(kernel, heads, flags):
    jm, params, jg, tm, tg = _pair(kernel, heads, flags, compute_dtype=BF16)
    out = _port_logits(tm, tg)
    assert out.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    _assert_bf16_close(out.numpy(), _jax_logits(jm, params, jg), "logits")


# the gradients' variants: one head, spmm_first with Wv factored, the raw
# features as values, and DIFFormer-a
GRAD_VARIANTS = [VARIANTS[i] for i in (0, 2, 4, 5)]
GRAD_IDS = [IDS[i] for i in (0, 2, 4, 5)]


@pytest.mark.parametrize("kernel,heads,flags", GRAD_VARIANTS, ids=GRAD_IDS)
def test_bf16_gradients_match_jax(kernel, heads, flags):
    """A gradient is a sum over nodes that can cancel far below its terms
    (the key bias's nearly does), and bf16 rounds the terms, so each bf16
    gradient is held to the f32 gradient: the port's is no further from it
    (Frobenius norm) than twice the JAX package's bf16 gradient is, plus
    the bf16 rtol of its norm."""
    jm, params, jg, tm, tg = _pair(kernel, heads, flags, compute_dtype=BF16)
    j32 = JDIFFormer(hidden_channels=HIDDEN, out_channels=C, num_layers=2,
                     num_heads=heads, kernel=kernel, dropout=0.0, **flags)
    cot = np.random.default_rng(7).normal(size=(N, C)).astype(np.float32)

    def grads(model):
        def loss(p):
            out = model.apply({"params": p}, jg.node_feat, jg.senders,
                              jg.receivers)
            return jnp.sum(out * cot)

        return W.torch_state_dict_from_params(jax.tree_util.tree_map(
            np.asarray, jax.jit(jax.grad(loss))(params)))

    jgrads, jgrads32 = grads(jm), grads(j32)
    tm.eval()
    out = tm(tg.node_feat, tg.senders, tg.receivers)
    (out * torch.from_numpy(cot)).sum().backward()
    def norm(a):
        return float(np.linalg.norm(np.asarray(a, np.float64)))

    for name, p in tm.named_parameters():
        assert p.grad.dtype == torch.float32
        ref = jgrads32[name]
        port, theirs = norm(p.grad.numpy() - ref), norm(jgrads[name] - ref)
        assert port <= 2 * theirs + BFLOAT16[0] * norm(ref), (
            name, port, theirs, norm(ref))


@pytest.mark.parametrize("kernel", ["simple", "sigmoid"])
def test_bf16_adam_trajectory_matches_jax(kernel):
    x, ei, y, jg, tg = _graph(200, 800, 16, seed=0)
    split = class_rand_splits(y, 10, valid_num=60, test_num=80, rng=0)
    kw = dict(num_layers=2, dropout=0.0, kernel=kernel,
              compute_dtype=BF16)
    jt = JTrainer(JDIFFormer(hidden_channels=16, out_channels=C, **kw), jg,
                  y, lr=1e-3, weight_decay=0.01)
    params = jax.tree_util.tree_map(np.asarray, jt.init_state(0).params)
    tt = FullBatchTrainer(DIFFormer(16, 16, C, device="cpu", **kw), tg, y,
                          lr=1e-3, weight_decay=0.01, device="cpu")
    mask = idx_to_mask(split["train"], 200)
    js = jt.init_state(0, init_params=params)
    ts = tt.init_state(0, init_params=params)
    jl, tl = [], []
    for step in range(5):
        js, a = jt.train_step(js, jax.random.PRNGKey(step), jnp.asarray(mask))
        ts, b = tt.train_step(ts, None, torch.from_numpy(mask))
        jl.append(float(a))
        tl.append(b.item())
    _assert_bf16_close(tl, jl, "losses")
    assert tl[-1] < tl[0]
    final = W.torch_state_dict_from_params(
        jax.tree_util.tree_map(np.asarray, js.params))
    for name, p in ts.model.state_dict().items():
        _assert_bf16_close(p.numpy(), final[name], name)


def _rms(a):
    return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))


@pytest.mark.parametrize("kernel,heads,flags", VARIANTS[:3] + VARIANTS[5:],
                         ids=IDS[:3] + IDS[5:])
def test_bf16_logits_as_close_to_f32_as_jax(kernel, heads, flags):
    """At N = 500 and 4 layers, the port's bf16 logits are within 5 % of
    the JAX package's RMS distance from the f32 logits (the two round the
    dense products at other places; the GCN branch is the test below)."""
    jm, params, jg, tm, tg = _pair(kernel, heads, flags, n=500, f=16,
                                   layers=4, compute_dtype=BF16)
    j32 = JDIFFormer(hidden_channels=HIDDEN, out_channels=C, num_layers=4,
                     num_heads=heads, kernel=kernel, dropout=0.0, **flags)
    ref = _jax_logits(j32, params, jg)
    port = _rms(_port_logits(tm, tg).numpy() - ref)
    jax_err = _rms(_jax_logits(jm, params, jg) - ref)
    assert port <= 1.05 * jax_err, (port, jax_err)


@pytest.mark.parametrize("width", [1, 16, 65])
def test_bf16_gcn_conv_rounds_once_and_beats_bf16_sums(width):
    """The GCN product at bf16: the port's is the f32 sum of the bf16
    inputs rounded once, and no further from the exact product than the
    JAX package's bf16 sums, in the worst element and in RMS."""
    x, ei, _, jg, tg = _graph(300, 3000)
    xb = torch.from_numpy(np.random.default_rng(width).normal(
        size=(300, width)).astype(np.float32)).to(torch.bfloat16)
    got = graph_ops.gcn_conv(xb, tg.senders, tg.receivers)
    assert got.dtype == torch.bfloat16
    f32 = graph_ops.gcn_conv(xb.float(), tg.senders, tg.receivers)
    assert torch.equal(got, f32.to(torch.bfloat16))
    plan = tg.csr_plan()
    dense = torch.zeros(300, 300, dtype=torch.float64)
    degrees = (plan.row_ptr[1:] - plan.row_ptr[:-1]).long()
    rows = torch.repeat_interleave(torch.arange(300), degrees)
    dense.index_put_((rows, plan.col.long()), plan.val.double(),
                     accumulate=True)
    exact = dense @ xb.double()
    jx = jax_gcn_conv(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                      jg.senders, jg.receivers)
    j_err = np.abs(np.asarray(jx, np.float64) - exact.numpy())
    p_err = (got.double() - exact).abs().numpy()
    assert p_err.max() <= j_err.max()
    assert _rms(p_err) <= _rms(j_err)


def _hub_csr(capacity=0):
    """A CSR of 200 rows with three hubs of 600 to 900 edges and an empty
    row, its columns and values padded by ``capacity`` entries past
    ``row_ptr[-1]`` (a CSR held at a capacity)."""
    rng = np.random.default_rng(3)
    deg = rng.integers(0, 9, 200)
    deg[[5, 77, 150]] = [600, 750, 900]
    deg[9] = 0
    ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    e = int(ptr[-1])
    col = rng.integers(0, 180, e + capacity).astype(np.int32)
    val = rng.uniform(0.1, 1.0, e + capacity).astype(np.float32)
    return (torch.from_numpy(ptr), torch.from_numpy(col),
            torch.from_numpy(val), e)


@pytest.mark.parametrize("capacity", [0, 500])
@pytest.mark.parametrize("width", [1, 8, 33])
def test_plain_k1_at_bf16_is_the_f32_sum_rounded_once(capacity, width):
    """K1's plain version at bf16, on a CSR with heavy rows (which K1 on
    the card sums in segments) and held at a capacity: the f32 sums of the
    bf16 inputs, rounded to bf16 once; and its schedule splits those
    rows."""
    ptr, col, val, e = _hub_csr(capacity)
    x = torch.from_numpy(np.random.default_rng(width).normal(
        size=(180, width)).astype(np.float32)).to(torch.bfloat16)
    got = K1.csr_spmm(x, ptr, col, val, split=K1.row_split(ptr))
    assert got.dtype == torch.bfloat16
    f32 = K1.csr_spmm_plain(x.float(), ptr, col[:e], val[:e])
    assert torch.equal(got, f32.to(torch.bfloat16))
    exact = torch.zeros(200, width, dtype=torch.float64)
    rows = torch.repeat_interleave(torch.arange(200),
                                   (ptr[1:] - ptr[:-1]).long())
    exact.index_add_(0, rows, x.double()[col[:e].long()]
                     * val[:e, None].double())
    # one rounding: within half a bf16 step of the exact sum, beyond the
    # f32 sum's own error
    step = 2.0 ** -8 * exact.abs()
    assert torch.all((got.double() - exact).abs() <= step + 1e-6)
    split = K1.row_split(ptr)
    assert split.num_heavy == 3 and split.num_segments == 3 + 3 + 4
    assert torch.all(got[9] == 0)


def test_csr_spmm_backward_runs_at_bf16():
    ptr, col, val, e = _hub_csr()
    plan = graph_ops.build_spmm_plan(val, col.long(), torch.repeat_interleave(
        torch.arange(200), (ptr[1:] - ptr[:-1]).long()), 200)
    x = torch.randn(200, 4).to(torch.bfloat16).requires_grad_()
    out = graph_ops.spmm(None, None, None, x, plan=plan)
    assert out.dtype == torch.bfloat16
    g = torch.randn(200, 4).to(torch.bfloat16)
    out.backward(g)
    ref = K1.csr_spmm_plain(g, plan.t_row_ptr, plan.t_col, plan.t_val)
    assert x.grad.dtype == torch.bfloat16 and torch.equal(x.grad, ref)


def test_k1_rejects_other_dtypes():
    ptr, col, val, _ = _hub_csr()
    for dt in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="bfloat16"):
            K1.csr_spmm(torch.zeros(180, 4, dtype=dt), ptr, col, val)


def test_compute_dtype_names():
    for name in ("bfloat16", torch.bfloat16):
        m = DIFFormer(F, HIDDEN, C, compute_dtype=name, device="cpu")
        assert m.compute_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="compute_dtype"):
        DIFFormer(F, HIDDEN, C, compute_dtype="bfloat17", device="cpu")


# --------------------------------------------------------------------------
# remat
# --------------------------------------------------------------------------

def _grads(tm, tg, cot):
    tm.zero_grad(set_to_none=True)
    tm.eval()
    out = tm(tg.node_feat, tg.senders, tg.receivers)
    (out * cot).sum().backward()
    return out.detach(), {k: p.grad.clone() for k, p in tm.named_parameters()}


@pytest.mark.parametrize("kernel,heads,flags", VARIANTS, ids=IDS)
def test_remat_is_bit_equal_to_no_remat(kernel, heads, flags):
    jm, params, jg, tm, tg = _pair(kernel, heads, flags)
    _, _, _, tr, _ = _pair(kernel, heads, flags, remat=True)
    cot = torch.from_numpy(np.random.default_rng(2).normal(
        size=(N, C)).astype(np.float32))
    out, grads = _grads(tm, tg, cot)
    out_r, grads_r = _grads(tr, tg, cot)
    assert torch.equal(out, out_r)
    for name in grads:
        assert torch.equal(grads[name], grads_r[name]), name


@pytest.mark.parametrize("kernel,heads,flags", VARIANTS, ids=IDS)
def test_remat_matches_jax_remat(kernel, heads, flags):
    jm, params, jg, tr, tg = _pair(kernel, heads, flags, remat=True)
    cot = np.random.default_rng(2).normal(size=(N, C)).astype(np.float32)

    def loss(p):
        out = jm.apply({"params": p}, jg.node_feat, jg.senders, jg.receivers)
        return jnp.sum(out * cot), out

    (_, jout), jg_ = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    jgrads = W.torch_state_dict_from_params(
        jax.tree_util.tree_map(np.asarray, jg_))
    out, grads = _grads(tr, tg, torch.from_numpy(cot))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[name], **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("spmm_first,recomputed", [(False, 0), (True, 2)])
def test_remat_reruns_k1_only_where_its_region_keeps_tensors(
        monkeypatch, spmm_first, recomputed):
    """Under remat the backward re-runs a region's forward when it first
    needs a tensor the region kept. The plain graph branch keeps none (K1's
    backward needs only the plan), so K1 runs once a layer forward and once
    backward; the spmm_first branch keeps the product for its matmul, so
    its forward K1 runs again once a layer: the term ``chip_smoke.py``'s
    launch counts add for remat."""
    calls = {"fwd": 0, "bwd": 0}
    real = K1.csr_spmm

    def counting(x, *args, transposed=False, **kw):
        calls["bwd" if transposed else "fwd"] += 1
        return real(x, *args, transposed=transposed, **kw)

    monkeypatch.setattr(K1, "csr_spmm", counting)
    flags = {"spmm_first": spmm_first}
    for remat, extra in ((False, 0), (True, recomputed)):
        _, _, _, tm, tg = _pair("simple", 1, flags, remat=remat)
        calls.update(fwd=0, bwd=0)
        _grads(tm, tg, torch.ones(N, C))
        assert calls == {"fwd": 2 + extra, "bwd": 2}, (remat, calls)


# --------------------------------------------------------------------------
# both options in the fits
# --------------------------------------------------------------------------

OPTIONS = {"bf16": dict(compute_dtype=BF16), "remat": dict(remat=True),
           "bf16-remat": dict(compute_dtype=BF16, remat=True)}


@pytest.mark.parametrize("option", sorted(OPTIONS))
@pytest.mark.parametrize("kernel", ["simple", "sigmoid"])
def test_epoch_block_fit_matches_the_loop(option, kernel):
    x, ei, y, _, tg = _graph(150, 600)
    split = class_rand_splits(y, 10, valid_num=40, test_num=60, rng=0)
    res = []
    for block in (0, 4):
        tm = DIFFormer(F, HIDDEN, C, num_layers=2, kernel=kernel, dropout=0.2,
                       device="cpu", **OPTIONS[option])
        t = FullBatchTrainer(tm, tg, y, device="cpu")
        res.append(t.fit(split, epochs=8, epoch_block=block)[0])
    assert res[0]["losses"] == res[1]["losses"]
    assert res[0]["epoch"] == res[1]["epoch"]
    assert all(np.isfinite(res[0]["losses"]))


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_minibatch_scan_matches_the_loop(option):
    from difformer_tpu_torch.train.minibatch import MiniBatchTrainer

    x, ei, y = random_graph(400, 3000, F, C, seed=2, homophily=0.7)
    ei = standard_preprocess(ei, 400)
    split = class_rand_splits(y, 10, valid_num=60, test_num=80, rng=0)
    res = []
    for scan in (True, False):
        tm = DIFFormer(F, HIDDEN, C, num_layers=2, dropout=0.2, device="cpu",
                       **OPTIONS[option])
        t = MiniBatchTrainer(tm, x, ei, y, batch_size=150, use_scan=scan,
                             device="cpu")
        res.append(t.fit(split, epochs=2)[0])
    assert res[0]["chunk_losses"] == res[1]["chunk_losses"]
    assert all(np.isfinite(v) for v in res[0]["losses"])
