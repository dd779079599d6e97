"""The port's baseline zoo (difformer_tpu_torch/nn/gnns.py) and the graph
ops it needs against the JAX package's, on the CPU.

The same numpy inputs go through both packages, with the JAX weights
carried by ``utils/weights.py``: every entry of tests/test_gnns.py's
``MODELS`` and GCNJK and GATJK with ``jk_type="lstm"`` agree in the forward
(train mode, BatchNorm on the batch's statistics, and eval mode on the
running ones), in the parameters' gradients and in the updated running
statistics, at rtol 2e-4 / atol 2e-5 (tests/test_reference_exec.py:334),
with dropout off (the two packages draw other masks). So do ``spmm``'s
value gradient against ``jax.grad`` through the JAX ``spmm``'s values (on
a directed graph with distinct values, [E] and per head [E, H]), label
propagation (single-label, multilabel and ``mult_bin``), the segment ops,
``gen_normalized_adjs`` in its three modes,
``add_remaining_self_loops_dense`` and ``gcn_norm`` without self-loops;
``convert_to_adj`` and ``adj_mul`` give equal arrays, and the zoo's
weights make the round trip through ``utils/weights.py``. Each JAX model is
initialised once for the module and shared by its cases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difformer_tpu.data import transforms as JT
from difformer_tpu.data.synthetic import random_graph
from difformer_tpu.data.transforms import standard_preprocess
from difformer_tpu.nn import gnns as JZ
from difformer_tpu.ops import graph_ops as JG
from difformer_tpu.ops import segment as JS
from difformer_tpu_torch.data import transforms as TT
from difformer_tpu_torch.kernels import spmm as K1
from difformer_tpu_torch.nn import gnns as Z
from difformer_tpu_torch.ops import graph_ops as TG
from difformer_tpu_torch.ops import segment as TS
from difformer_tpu_torch.utils import weights as W
import torch_port_helpers  # noqa: F401  (sets torch's threads)

TOL = dict(rtol=2e-4, atol=2e-5)
N, E, F, C = 60, 240, 12, 3


def _close(got, ref, what=""):
    got = got.detach().numpy() if hasattr(got, "detach") else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), **TOL,
                               err_msg=what)


@pytest.fixture(scope="module")
def graph():
    """tests/test_gnns.py's graph: (x, senders, receivers, labels)."""
    x, ei, y = random_graph(N, E, F, C, seed=11, homophily=0.8)
    ei = standard_preprocess(ei, N)
    return x, ei[0], ei[1], y


# (JAX model, port model) of tests/test_gnns.py's MODELS and the JK nets
# with an LSTM, dropout off
MODELS = {
    "link": (lambda: JZ.LINK(num_nodes=N, out_channels=C),
             lambda: Z.LINK(N, C, device="cpu")),
    "mlp": (lambda: JZ.MLP(16, C, dropout=0.0),
            lambda: Z.MLP(F, 16, C, dropout=0.0, device="cpu")),
    "mlp1": (lambda: JZ.MLP(16, C, num_layers=1, dropout=0.0),
             lambda: Z.MLP(F, 16, C, num_layers=1, device="cpu")),
    "sgc": (lambda: JZ.SGC(out_channels=C, hops=2),
            lambda: Z.SGC(F, C, hops=2, device="cpu")),
    "gcn": (lambda: JZ.GCN(16, C, dropout=0.0),
            lambda: Z.GCN(F, 16, C, dropout=0.0, device="cpu")),
    "gat": (lambda: JZ.GAT(8, C, heads=2, dropout=0.0),
            lambda: Z.GAT(F, 8, C, heads=2, dropout=0.0, device="cpu")),
    "mixhop": (lambda: JZ.MixHop(8, C, hops=2, dropout=0.0),
               lambda: Z.MixHop(F, 8, C, hops=2, dropout=0.0,
                                device="cpu")),
    "gcnjk_max": (lambda: JZ.GCNJK(16, C, dropout=0.0),
                  lambda: Z.GCNJK(F, 16, C, dropout=0.0, device="cpu")),
    "gcnjk_cat": (lambda: JZ.GCNJK(16, C, jk_type="cat", dropout=0.0),
                  lambda: Z.GCNJK(F, 16, C, jk_type="cat", dropout=0.0,
                                  device="cpu")),
    "gcnjk_lstm": (lambda: JZ.GCNJK(16, C, jk_type="lstm", dropout=0.0),
                   lambda: Z.GCNJK(F, 16, C, jk_type="lstm", dropout=0.0,
                                   device="cpu")),
    "gatjk": (lambda: JZ.GATJK(8, C, dropout=0.0),
              lambda: Z.GATJK(F, 8, C, dropout=0.0, device="cpu")),
    "gatjk_lstm": (lambda: JZ.GATJK(8, C, jk_type="lstm", dropout=0.0),
                   lambda: Z.GATJK(F, 8, C, jk_type="lstm", dropout=0.0,
                                   device="cpu")),
    "h2gcn": (lambda: JZ.H2GCN(8, C, dropout=0.0),
              lambda: Z.H2GCN(F, 8, C, dropout=0.0, device="cpu")),
    "appnp": (lambda: JZ.APPNPNet(16, C, dropout=0.0),
              lambda: Z.APPNPNet(F, 16, C, dropout=0.0, device="cpu")),
    "gprgnn": (lambda: JZ.GPRGNN(16, C, dropout=0.0, dprate=0.0),
               lambda: Z.GPRGNN(F, 16, C, dropout=0.0, dprate=0.0,
                                device="cpu")),
}


def _perturbed(variables, seed):
    """The JAX init with every leaf moved a little (zero biases, unit
    BatchNorm scales and the fresh statistics would hide a swapped or
    misplaced leaf)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.1, np.shape(a))).astype(
            np.float32), variables)


@pytest.fixture(scope="module")
def zoo(graph):
    """Per model: the JAX module, its (perturbed) variables as numpy, and
    the port's model with them loaded."""
    x, s, r, _ = graph
    out = {}
    for i, (name, (make_jax, make_port)) in enumerate(MODELS.items()):
        jm = make_jax()
        v = jm.init(jax.random.PRNGKey(i), jnp.asarray(x), jnp.asarray(s),
                    jnp.asarray(r), train=False)
        v = _perturbed(jax.tree_util.tree_map(np.asarray, dict(v)), 100 + i)
        if "batch_stats" in v:   # running variances stay positive
            v["batch_stats"] = jax.tree_util.tree_map(
                np.abs, v["batch_stats"])
        tm = make_port()
        W.load_params(tm, v["params"], v.get("batch_stats"))
        out[name] = (jm, v, tm)
    return out


def _torch_graph(graph):
    x, s, r, _ = graph
    return torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(r)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_zoo_model_matches_jax_in_training(zoo, graph, name):
    """Train mode: the logits, every parameter's gradient and (BatchNorm)
    the updated running statistics, with the model's plan built once."""
    jm, v, tm = zoo[name]
    x, s, r, _ = graph
    xt, st, rt = _torch_graph(graph)
    cot = np.random.default_rng(7).normal(size=(N, C)).astype(np.float32)
    mutable = [k for k in v if k != "params"]

    def f(p):
        out, upd = jm.apply({**v, "params": p}, jnp.asarray(x),
                            jnp.asarray(s), jnp.asarray(r), train=True,
                            mutable=mutable)
        return out, upd

    ref, vjp, upd = jax.vjp(f, v["params"], has_aux=True)
    tm.train()
    tm.zero_grad()
    plan = tm.build_plan(st, rt, N)
    out = tm(xt, st, rt, plan=plan)
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out, ref, "logits")
    grads = W.zoo_state_dict_from_params(
        jax.tree_util.tree_map(np.asarray, vjp(jnp.asarray(cot))[0]))
    for key, p in tm.named_parameters():
        if p.requires_grad:
            _close(p.grad, grads[key], key)
    stats = W.zoo_state_dict_from_params({}, jax.tree_util.tree_map(
        np.asarray, upd.get("batch_stats", {})))
    buffers = dict(tm.named_buffers())
    assert set(stats) == set(buffers)
    for key, value in stats.items():
        _close(buffers[key], value, key)
    W.load_params(tm, v["params"], v.get("batch_stats"))  # undo the update


@pytest.mark.parametrize("name", sorted(MODELS))
def test_zoo_model_matches_jax_in_eval(zoo, graph, name):
    """Eval mode (BatchNorm on the running statistics), without a plan:
    the forward builds its own."""
    jm, v, tm = zoo[name]
    x, s, r, _ = graph
    ref = jm.apply(v, jnp.asarray(x), jnp.asarray(s), jnp.asarray(r),
                   train=False)
    tm.eval()
    with torch.no_grad():
        _close(tm(*_torch_graph(graph)), ref)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_zoo_weights_round_trip(zoo, name):
    _, v, tm = zoo[name]
    sd = W.zoo_state_dict_from_params(v["params"], v.get("batch_stats"))
    assert set(sd) == set(tm.state_dict())
    for key, value in tm.state_dict().items():
        assert tuple(value.shape) == np.shape(sd[key]), key
    params, stats = W.zoo_params_from_state_dict(tm.state_dict())
    flat = dict(jax.tree_util.tree_leaves_with_path(params))
    want = dict(jax.tree_util.tree_leaves_with_path(v["params"]))
    assert set(map(jax.tree_util.keystr, flat)) == set(
        map(jax.tree_util.keystr, want))
    for path, leaf in jax.tree_util.tree_leaves_with_path(v["params"]):
        got = params
        for key in path:
            got = got[key.key]
        np.testing.assert_array_equal(got, leaf,
                                      err_msg=jax.tree_util.keystr(path))
    assert jax.tree_util.tree_structure(stats) == jax.tree_util.tree_structure(
        v.get("batch_stats", {}))


def test_zoo_runs_its_plan_and_sorts_nothing(graph, monkeypatch):
    """A forward on the model's plan builds no plan: every hop of SGC and
    APPNP, every MixHop power and GAT's products run on the plans of
    ``build_plan``, built once."""
    xt, st, rt = _torch_graph(graph)
    models = [Z.SGC(F, C, hops=3, device="cpu"),
              Z.APPNPNet(F, 8, C, K=4, device="cpu"),
              Z.MixHop(F, 8, C, device="cpu"),
              Z.GAT(F, 8, C, device="cpu")]
    plans = [m.build_plan(st, rt, N) for m in models]
    built = []
    monkeypatch.setattr(TG, "_plan", lambda *a, **k: built.append(1))
    for m, plan in zip(models, plans):
        out = m(xt, st, rt, plan=plan)
        out.sum().backward()
    assert not built


# --------------------------------------------------------------------------
# spmm's value gradient
# --------------------------------------------------------------------------

def _directed(seed=3, n=25, e=90):
    """A directed graph with repeated edges and empty rows in both
    directions, and distinct values."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n - 3, e)
    r = rng.integers(2, n, e)
    vals = rng.permutation(e).astype(np.float32) / e + 0.1
    return n, s, r, vals


@pytest.mark.parametrize("heads", [0, 3])
@pytest.mark.parametrize("with_plan", [False, True])
def test_spmm_value_gradient_matches_jax(heads, with_plan):
    n, s, r, vals = _directed()
    rng = np.random.default_rng(4)
    shape = (n, heads, 5) if heads else (n, 7)
    x = rng.normal(size=shape).astype(np.float32)
    if heads:
        vals = np.stack([vals * (h + 1) - h for h in range(heads)], 1)
    cot = rng.normal(size=shape).astype(np.float32)

    def jax_spmm(v, xx):
        if not heads:
            return JG.spmm(v, jnp.asarray(s), jnp.asarray(r), xx, n)
        return jnp.stack([JG.spmm(v[:, h], jnp.asarray(s), jnp.asarray(r),
                                  xx[:, h], n) for h in range(heads)], 1)

    ref, vjp = jax.vjp(jax_spmm, jnp.asarray(vals), jnp.asarray(x))
    g_vals, g_x = vjp(jnp.asarray(cot))
    tv = torch.from_numpy(vals).requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    ts, tr = torch.from_numpy(s), torch.from_numpy(r)
    if with_plan:
        plan = TG.build_spmm_plan(None, ts, tr, n)
        out = TG.spmm(tv, None, None, tx, plan=plan)
    else:
        out = TG.spmm(tv, ts, tr, tx, n)
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out, ref, "out")
    _close(tv.grad, g_vals, "dvalues")
    _close(tx.grad, g_x, "dx")


def test_spmm_plan_maps_invert_each_other():
    n, s, r, _ = _directed(5)
    plan = TG.build_spmm_plan(None, torch.from_numpy(s), torch.from_numpy(r),
                              n)
    order, t_order, inv_order, rows = plan.maps()
    e = len(s)
    assert torch.equal(order[inv_order], torch.arange(e))
    assert torch.equal(plan.col.long(), torch.from_numpy(s)[order])
    assert torch.equal(rows.long(), torch.from_numpy(r)[order])
    assert torch.equal(plan.t_col.long(), torch.from_numpy(r)[t_order])


def test_values_without_gradient_launch_no_dval(monkeypatch):
    """Values that need no gradient (a plan's own, or a tensor without
    requires_grad) skip K1-dval in the backward."""
    n, s, r, vals = _directed(6)
    called = []
    monkeypatch.setattr(K1, "csr_spmm_dval",
                        lambda *a, **k: called.append(1))
    plan = TG.build_spmm_plan(torch.from_numpy(vals), torch.from_numpy(s),
                              torch.from_numpy(r), n)
    x = torch.randn(n, 4, requires_grad=True)
    TG.spmm(None, None, None, x, plan=plan).sum().backward()
    TG.spmm(torch.from_numpy(vals), None, None, x, plan=plan).sum().backward()
    assert not called and x.grad is not None


def test_dval_plain_version_in_chunks_and_scale():
    n, s, r, _ = _directed(7)
    plan = TG.build_spmm_plan(None, torch.from_numpy(s), torch.from_numpy(r),
                              n)
    rng = np.random.default_rng(8)
    g = torch.from_numpy(rng.normal(size=(n, 6)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(n, 6)).astype(np.float32))
    want = (g[plan.rows.long()] * x[plan.col.long()]).sum(-1)
    for chunk in (None, 7):
        got = K1.csr_spmm_dval(g, x, plan.rows, plan.col,
                               edge_chunk_size=chunk)
        torch.testing.assert_close(got, want)
    scale = K1.csr_spmm_dval_abs(g, x, plan.rows, plan.col)
    assert (scale >= want.abs() - 1e-6).all()
    with pytest.raises(TypeError, match="float32"):
        K1.csr_spmm_dval(g.double(), x, plan.rows, plan.col)


# --------------------------------------------------------------------------
# label propagation
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["single", "multilabel", "mult_bin"])
@pytest.mark.parametrize("hops", [1, 2])
def test_multi_lp_matches_jax(graph, case, hops):
    x, s, r, y = graph
    rng = np.random.default_rng(12)
    label, out_c, mult_bin = y, C, False
    if case != "single":
        label = (rng.random((N, 4)) < 0.4).astype(np.int64)
        out_c, mult_bin = 4, case == "mult_bin"
    train = rng.permutation(N)[:N // 2]
    ref = JZ.multi_lp(s, r, label, train, N, out_c, alpha=0.7, hops=hops,
                      num_iters=12, mult_bin=mult_bin)
    got = Z.multi_lp(s, r, label, train, N, out_c, alpha=0.7, hops=hops,
                     num_iters=12, mult_bin=mult_bin, device="cpu")
    assert got.shape == ref.shape
    _close(got, ref)


# --------------------------------------------------------------------------
# segment ops and graph utilities
# --------------------------------------------------------------------------

def test_segment_ops_match_jax():
    rng = np.random.default_rng(1)
    data = rng.normal(size=(40, 3)).astype(np.float32)
    ids = rng.integers(0, 9, 40)
    ids[ids == 4] = 5                       # segment 4 is empty
    for jf, tf in ((JS.segment_mean, TS.segment_mean),
                   (JS.segment_max, TS.segment_max),
                   (JS.segment_sum, TS.segment_sum)):
        ref = jf(jnp.asarray(data), jnp.asarray(ids), 10)
        got = tf(torch.from_numpy(data), torch.from_numpy(ids), 10)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   err_msg=jf.__name__)
    cot = rng.normal(size=(40, 3)).astype(np.float32)
    ref, vjp = jax.vjp(lambda a: JS.segment_softmax(a, jnp.asarray(ids), 10),
                       jnp.asarray(data))
    t = torch.from_numpy(data).requires_grad_()
    got = TS.segment_softmax(t, torch.from_numpy(ids), 10)
    (got * torch.from_numpy(cot)).sum().backward()
    _close(got, ref)
    _close(t.grad, vjp(jnp.asarray(cot))[0])


@pytest.mark.parametrize("mode", ["DAD", "DA", "AD"])
def test_gen_normalized_adjs_matches_jax(mode):
    n, s, r, _ = _directed(9)
    ref = JG.gen_normalized_adjs(jnp.asarray(s), jnp.asarray(r), n, mode=mode)
    got = TG.gen_normalized_adjs(torch.from_numpy(s), torch.from_numpy(r), n,
                                 mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
    with pytest.raises(ValueError):
        TG.gen_normalized_adjs(torch.from_numpy(s), torch.from_numpy(r), n,
                               mode="XY")


@pytest.mark.parametrize("weighted", [False, True])
def test_gcn_norm_without_self_loops_matches_jax(weighted):
    n, s, r, vals = _directed(10)
    w = vals if weighted else None
    ref = JG.gcn_norm(jnp.asarray(s), jnp.asarray(r), n,
                      None if w is None else jnp.asarray(w),
                      add_self_loops=False)
    got = TG.gcn_norm(torch.from_numpy(s), torch.from_numpy(r), n,
                      None if w is None else torch.from_numpy(w),
                      add_self_loops=False)
    for a, b in zip(got[:2], ref[:2]):   # the same edges, no loop added
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the values to float32's rounding: neither XLA's nor torch's CPU rsqrt
    # rounds correctly, and they differ in the last bit at some degrees
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=1e-6)


def test_dense_self_loops_and_adjacency_utilities_match_jax():
    n, s, r, _ = _directed(11)
    ei = np.stack([s, r])
    adj = TT.convert_to_adj(ei, n)
    ref = JT.convert_to_adj(ei, n)
    assert adj.dtype == ref.dtype
    np.testing.assert_array_equal(adj, ref)
    np.testing.assert_array_equal(
        TG.add_remaining_self_loops_dense(torch.from_numpy(adj)).numpy(),
        np.asarray(JG.add_remaining_self_loops_dense(jnp.asarray(adj))))
    rng = np.random.default_rng(2)
    other = np.stack([rng.integers(0, n, 70), rng.integers(0, n, 70)])
    got, want = TT.adj_mul(ei, other, n), JT.adj_mul(ei, other, n)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
