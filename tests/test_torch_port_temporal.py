"""The port's temporal track against the JAX package's, on the CPU.

The same numpy inputs and carried weights go through both packages:
``random_temporal_sequence`` and every JSON reader give equal arrays; the
graph pieces MPNN-LSTM needs (``gcn_norm``, ``GCNLayer``,
``TorchBatchNorm`` in training, with its running statistics, and in
evaluation) and the models (``DConv`` at K = 1, 2, 3, ``DCRNN`` with a
state, ``MPNNLSTM`` with ``mutable=["batch_stats"]`` on the JAX side) agree
in the forward and the gradients at rtol 2e-4 / atol 2e-5
(tests/test_reference_exec.py:334); ``TemporalTrainer`` gives the JAX
trainer's losses in both modes over 3 epochs at dropout 0; the kNN rebuild
gives the JAX graph; weights make the round trip through
``utils/weights.py``; and the command line's temporal route hands its
trainer what the JAX command line hands its own, and trains.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difformer_tpu.data import temporal_loaders as JL
from difformer_tpu.data.synthetic import random_temporal_sequence as jax_seq
from difformer_tpu.nn.common import TorchBatchNorm as JBatchNorm
from difformer_tpu.nn.difformer import DIFFormer as JDIFFormer
from difformer_tpu.nn.gnns import GCNLayer as JGCNLayer
from difformer_tpu.nn.temporal import DCRNN as JDCRNN
from difformer_tpu.nn.temporal import MPNNLSTM as JMPNNLSTM
from difformer_tpu.nn.temporal import DConv as JDConv
from difformer_tpu.ops.graph_ops import gcn_norm as jax_gcn_norm
from difformer_tpu.train import temporal as JT
from difformer_tpu_torch import DIFFormer
from difformer_tpu_torch.data import temporal_loaders as TL
from difformer_tpu_torch.data.synthetic import random_temporal_sequence
from difformer_tpu_torch.nn import temporal as TM
from difformer_tpu_torch.nn.common import TorchBatchNorm
from difformer_tpu_torch.nn.gnns import GCNLayer
from difformer_tpu_torch.ops.graph_ops import gcn_norm
from difformer_tpu_torch.train import temporal as TT
from difformer_tpu_torch.utils import weights as W

import chip_smoke
import torch_port_helpers  # noqa: F401  (sets torch's threads)

TOL = dict(rtol=2e-4, atol=2e-5)
N, F, E = 30, 5, 90


def _graph(seed=0, weighted=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, F)).astype(np.float32)
    s, r = rng.integers(0, N, E), rng.integers(0, N, E)
    w = rng.uniform(0.2, 2.0, E).astype(np.float32) if weighted else None
    return x, s, r, w


def _j(a, dtype=None):
    return None if a is None else jnp.asarray(a, dtype)


def _t(a):
    return None if a is None else torch.as_tensor(a)


def _close(got, ref, what=""):
    np.testing.assert_allclose(np.asarray(got.detach() if hasattr(
        got, "detach") else got), np.asarray(ref), **TOL, err_msg=what)


def _check_grads(tm, jgrads, sd_of=W.temporal_state_dict_from_params):
    want = sd_of(jax.tree_util.tree_map(np.asarray, jgrads))
    for name, p in tm.named_parameters():
        if p.requires_grad:
            _close(p.grad, want[name], name)


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

def test_random_temporal_sequence_matches_jax():
    ours, theirs = random_temporal_sequence(15, 12, 3, seed=5), jax_seq(
        15, 12, 3, seed=5)
    assert len(ours) == len(theirs) == 12
    for a, b in zip(ours, theirs):
        for field in ("node_feat", "edge_index", "edge_weight", "target"):
            assert np.array_equal(getattr(a, field), getattr(b, field))
    assert ours[0].edge_index is ours[-1].edge_index  # one static graph


def _same_snaps(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        for field in ("node_feat", "edge_index", "edge_weight", "target"):
            x, y = getattr(a, field), getattr(b, field)
            assert x.dtype == y.dtype and np.array_equal(x, y), field


def _write_covid(root, t=12, n=6):
    rng = np.random.default_rng(2)
    data = {"time_periods": t, "y": rng.normal(size=(t, n)).tolist(),
            "edge_mapping": {
                "edge_index": {str(k): [[i, int(rng.integers(0, n))]
                                        for i in range(n)] for k in range(t)},
                "edge_weight": {str(k): rng.random(n).tolist()
                                for k in range(t)}}}
    (root / "england_covid.json").write_text(json.dumps(data))


def _write_tennis(root, event, nested, t=6, n=8):
    rng = np.random.default_rng(3)
    per_t = {}
    for k in range(t):
        per_t[str(k)] = {
            "edges": [[int(rng.integers(0, n)), int(rng.integers(0, n))]
                      for _ in range(2 * n)],
            "weights": rng.random(2 * n).tolist(),
            "X": np.stack([rng.integers(0, 200, n),
                           rng.random(n)], axis=1).tolist(),
            "y": rng.integers(0, 50, n).tolist()}
    data = {"time_periods": t}
    if nested:
        data.update(per_t)
    else:
        for key in ("edges", "weights", "X", "y"):
            data[key] = {k: v[key] for k, v in per_t.items()}
    (root / f"twitter_tennis_{event}.json").write_text(json.dumps(data))


@pytest.mark.parametrize("name", ["chickenpox", "wikimath", "covid",
                                  "twitter_rg", "twitter_uo"])
def test_loaders_match_jax(tmp_path, name):
    if name == "chickenpox":
        chip_smoke.write_chickenpox_json(tmp_path, nodes=9, edges=30,
                                         weeks=40)
    elif name == "wikimath":
        chip_smoke.write_wikimath_json(tmp_path, nodes=12, edges=50,
                                       days=30)
    elif name == "covid":
        _write_covid(tmp_path)
    else:
        _write_tennis(tmp_path, name.replace("twitter_", "") + "17",
                      nested=name == "twitter_rg")
    _same_snaps(TL.load_temporal_dataset(name, str(tmp_path)),
                JL.load_temporal_dataset(name, str(tmp_path)))


def test_loader_lags_and_errors(tmp_path):
    chip_smoke.write_chickenpox_json(tmp_path, nodes=6, edges=12, weeks=20)
    _same_snaps(TL.load_chickenpox(str(tmp_path), lags=2),
                JL.load_chickenpox(str(tmp_path), lags=2))
    with pytest.raises(FileNotFoundError, match="wikimath"):
        TL.load_temporal_dataset("wikimath", str(tmp_path))
    with pytest.raises(ValueError, match="unknown temporal dataset"):
        TL.load_temporal_dataset("nope", str(tmp_path))


def test_standin_files_have_the_published_shapes(tmp_path):
    chip_smoke.write_chickenpox_json(tmp_path)
    snaps = TL.load_chickenpox(str(tmp_path))
    assert snaps[0].node_feat.shape == (20, 4)
    assert snaps[0].edge_index.shape == (2, 102)
    assert len(snaps) == chip_smoke.CHICKENPOX_WEEKS - 5


def test_signal_split_matches_jax():
    snaps = random_temporal_sequence(5, 17, 2, seed=1)
    for ratio in (0.5, 0.3, 0.9):
        a, b = TT.temporal_signal_split(snaps, ratio)
        c, d = JT.temporal_signal_split(snaps, ratio)
        assert (len(a), len(b)) == (len(c), len(d))


@pytest.mark.parametrize("mode", ["knn", "dense", "none"])
def test_rebuild_matches_jax(mode):
    from difformer_tpu.data.graph import TemporalSnapshot as JSnap

    snap = random_temporal_sequence(25, 1, 6, seed=2)[0]
    ours = TT.rebuild_graph(snap, mode)
    theirs = JT.rebuild_graph(JSnap(snap.node_feat, snap.edge_index,
                                    snap.edge_weight, snap.target), mode)
    assert np.array_equal(ours.edge_index, theirs.edge_index)
    assert np.array_equal(ours.edge_weight, theirs.edge_weight)
    assert ours.node_feat is snap.node_feat


# --------------------------------------------------------------------------
# the graph pieces of MPNN-LSTM
# --------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("loops", [False, True])
def test_gcn_norm_matches_jax(weighted, loops):
    _, s, r, w = _graph(1, weighted)
    a = gcn_norm(_t(s), _t(r), N, _t(w), add_self_loops=loops)
    b = jax_gcn_norm(_j(s, jnp.int32), _j(r, jnp.int32), N, _j(w),
                     add_self_loops=loops)
    for x, y in zip(a, b):
        _close(x, y)


@pytest.mark.parametrize("weighted", [False, True])
def test_gcn_layer_matches_jax(weighted):
    x, s, r, w = _graph(2, weighted)
    jm = JGCNLayer(7)
    params = jm.init(jax.random.PRNGKey(0), x, _j(s), _j(r), _j(w))["params"]
    tm = GCNLayer(F, 7)
    tm.load_state_dict({"lin.weight": torch.as_tensor(np.asarray(
        params["TorchLinear_0"]["kernel"]).T.copy()),
        "bias": torch.as_tensor(np.asarray(params["bias"]) + 0.1)})
    params = {**params, "bias": params["bias"] + 0.1}
    cot = np.random.default_rng(3).normal(size=(N, 7)).astype(np.float32)
    plan = tm.build_plan(_t(s), _t(r), N, _t(w))
    for kw in (dict(plan=plan), {}):
        tm.zero_grad()
        out = tm(_t(x), _t(s), _t(r), _t(w), **kw)
        (out * _t(cot)).sum().backward()
        ref, vjp = jax.vjp(lambda p: jm.apply({"params": p}, x, _j(s), _j(r),
                                              _j(w)), params)
        _close(out, ref)
        g = vjp(jnp.asarray(cot))[0]
        _close(tm.lin.weight.grad, np.asarray(g["TorchLinear_0"]["kernel"]).T)
        _close(tm.bias.grad, g["bias"])


def test_batch_norm_matches_jax_in_both_modes():
    rng = np.random.default_rng(4)
    xs = [rng.normal(loc=1.5, scale=2.0, size=(N, 6)).astype(np.float32)
          for _ in range(3)]
    jm = JBatchNorm()
    v = jm.init(jax.random.PRNGKey(0), xs[0], use_running_average=False)
    v = {"params": {"BatchNorm_0": {
        "scale": jnp.linspace(0.5, 1.5, 6), "bias": jnp.linspace(-1, 1, 6)}},
        "batch_stats": v["batch_stats"]}
    tm = TorchBatchNorm(6)
    with torch.no_grad():
        tm.weight.copy_(torch.linspace(0.5, 1.5, 6))
        tm.bias.copy_(torch.linspace(-1, 1, 6))
    tm.train()
    for x in xs:
        ref, upd = jm.apply(v, x, use_running_average=False,
                            mutable=["batch_stats"])
        v = {"params": v["params"], "batch_stats": upd["batch_stats"]}
        _close(tm(_t(x)), ref)
        stats = upd["batch_stats"]["BatchNorm_0"]
        _close(tm.running_mean, stats["mean"])
        _close(tm.running_var, stats["var"])
    tm.eval()
    _close(tm(_t(xs[0])), jm.apply(v, xs[0], use_running_average=True))
    x = _t(xs[1]).requires_grad_()
    tm.train()
    (tm(x) * torch.arange(6.0)).sum().backward()
    g = jax.grad(lambda a: jnp.sum(jm.apply(
        v, a, use_running_average=False, mutable=["batch_stats"])[0]
        * jnp.arange(6.0)))(jnp.asarray(xs[1]))
    _close(x.grad, g)


# --------------------------------------------------------------------------
# the models
# --------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_dconv_matches_jax(k, weighted):
    x, s, r, w = _graph(k, weighted)
    jm = JDConv(6, K=k)
    params = jm.init(jax.random.PRNGKey(k), x, _j(s), _j(r), _j(w))["params"]
    params = {**params, "bias": params["bias"] + 0.3}
    tm = TM.DConv(F, 6, K=k)
    W.load_params(tm, params)
    xt = _t(x).requires_grad_()
    out = tm(xt, _t(s), _t(r), _t(w))
    cot = np.random.default_rng(9).normal(size=(N, 6)).astype(np.float32)
    (out * _t(cot)).sum().backward()
    ref, vjp = jax.vjp(lambda p, a: jm.apply({"params": p}, a, _j(s), _j(r),
                                             _j(w)), params, jnp.asarray(x))
    _close(out, ref)
    gp, gx = vjp(jnp.asarray(cot))
    _close(xt.grad, gx)
    _check_grads(tm, gp)


def test_dconv_runs_its_plans_built_once(monkeypatch):
    """A DCRNN forward on a plan builds none: its three DConvs and every hop
    run on the two plans of ``build_plan``."""
    x, s, r, w = _graph(3)
    tm = TM.DCRNN(F, 4, 1, K=3, device="cpu")
    plan = tm.build_plan(_t(s), _t(r), N, _t(w))
    built, products = [], []
    real = TM.spmm
    monkeypatch.setattr(TM, "build_spmm_plan",
                        lambda *a, **k: built.append(1))
    monkeypatch.setattr(TM, "spmm", lambda *a, plan: (
        products.append(plan), real(*a, plan=plan))[1])
    tm(_t(x), plan=plan)
    assert not built
    assert len(products) == 3 * 2 * 2        # 3 convs x 2 hops x 2 ways
    assert {id(p) for p in products} == {id(plan.fwd), id(plan.rev)}


def test_dcrnn_with_state_matches_jax():
    x, s, r, w = _graph(5)
    jm = JDCRNN(4, 2, K=3)
    params = jm.init(jax.random.PRNGKey(1), x, _j(s), _j(r), _j(w))["params"]
    params = jax.tree_util.tree_map(lambda a: a + 0.05, params)
    h0 = np.random.default_rng(6).normal(size=(N, 4)).astype(np.float32)
    tm = TM.DCRNN(F, 4, 2, K=3, device="cpu")
    W.load_params(tm, params)
    ht = _t(h0).requires_grad_()
    out, h_new = tm(_t(x), _t(s), _t(r), _t(w), ht, return_state=True)
    (out.sum() + (h_new * 2).sum()).backward()

    def f(p, h):
        o, hn = jm.apply({"params": p}, x, _j(s), _j(r), _j(w), h,
                         return_state=True)
        return jnp.sum(o) + jnp.sum(hn * 2), (o, hn)

    (_, (ro, rh)), (gp, gh) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(params, jnp.asarray(h0))
    _close(out, ro)
    _close(h_new, rh)
    _close(ht.grad, gh)
    _check_grads(tm, gp)


def test_mpnn_lstm_matches_jax_with_batch_stats():
    x, s, r, w = _graph(7)
    jm = JMPNNLSTM(4, 1, num_nodes=N, window=1, dropout=0.0)
    v = jm.init(jax.random.PRNGKey(2), x, _j(s), _j(r), _j(w))
    params = jax.tree_util.tree_map(lambda a: a + 0.02, v["params"])
    tm = TM.MPNNLSTM(F, 4, 1, N, 1, dropout=0.0, device="cpu")
    W.load_params(tm, params, v["batch_stats"])

    def f(p):
        out, upd = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                            x, _j(s), _j(r), _j(w), train=True,
                            mutable=["batch_stats"])
        return jnp.sum(out * jnp.arange(N)), (out, upd)

    (_, (ref, upd)), gp = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
    tm.train()
    out = tm(_t(x), _t(s), _t(r), _t(w))
    (out * torch.arange(N)).sum().backward()
    _close(out, ref)
    _check_grads(tm, gp)
    assert tm.lstm_1.bias_ih.grad is None
    assert not tm.lstm_1.bias_ih.any()
    for i in (1, 2):
        stats = upd["batch_stats"][f"bn_{i}"]["BatchNorm_0"]
        _close(getattr(tm, f"bn_{i}").running_mean, stats["mean"])
        _close(getattr(tm, f"bn_{i}").running_var, stats["var"])
    tm.eval()
    with torch.no_grad():
        out = tm(_t(x), _t(s), _t(r), _t(w))
    _close(out, jm.apply({"params": params,
                          "batch_stats": upd["batch_stats"]},
                         x, _j(s), _j(r), _j(w)))


def test_mpnn_lstm_window_matches_jax():
    """A window of 3 snapshots stacked on the node axis: the skip
    connection takes step 0's features and the last feature of the
    later steps."""
    n, win = 10, 3
    rng = np.random.default_rng(8)
    x = rng.normal(size=(win * n, F)).astype(np.float32)
    s, r = rng.integers(0, win * n, 40), rng.integers(0, win * n, 40)
    jm = JMPNNLSTM(4, 2, num_nodes=n, window=win, dropout=0.0)
    v = jm.init(jax.random.PRNGKey(3), x, _j(s), _j(r))
    tm = TM.MPNNLSTM(F, 4, 2, n, win, dropout=0.0, device="cpu")
    W.load_params(tm, v["params"], v["batch_stats"])
    tm.eval()
    with torch.no_grad():
        out = tm(_t(x), _t(s), _t(r))
    _close(out, jm.apply(v, x, _j(s), _j(r)))


# --------------------------------------------------------------------------
# weights
# --------------------------------------------------------------------------

def _jax_variables(name):
    x, s, r, w = _graph(1)
    jm = {"dconv": JDConv(6, K=3), "dcrnn": JDCRNN(4, 1, K=2),
          "mpnn_lstm": JMPNNLSTM(4, 1, num_nodes=N, window=1)}[name]
    return jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(4), x, _j(s), _j(r), _j(w)))


def _port_model(name):
    return {"dconv": lambda: TM.DConv(F, 6, K=3),
            "dcrnn": lambda: TM.DCRNN(F, 4, 1, K=2, device="cpu"),
            "mpnn_lstm": lambda: TM.MPNNLSTM(F, 4, 1, N, 1, device="cpu")
            }[name]()


@pytest.mark.parametrize("name", ["dconv", "dcrnn", "mpnn_lstm"])
def test_weights_round_trip(name):
    v = _jax_variables(name)
    stats = {k: jax.tree_util.tree_map(lambda a: a + 0.5, s)
             for k, s in v.get("batch_stats", {}).items()}
    tm = _port_model(name)
    W.load_params(tm, v["params"], stats or None)
    params, got_stats = W.temporal_params_from_state_dict(tm.state_dict())
    same = jax.tree_util.tree_map(np.array_equal, params, v["params"])
    assert all(jax.tree_util.tree_leaves(same))
    assert (jax.tree_util.tree_structure(params)
            == jax.tree_util.tree_structure(v["params"]))
    if stats:
        assert all(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
            np.array_equal, got_stats, stats)))
    # and back: a port model's own weights through flax's layout
    other = _port_model(name)
    other.reset_parameters(torch.Generator().manual_seed(9))
    W.load_params(tm, *W.temporal_params_from_state_dict(
        other.state_dict()))
    for key, value in other.state_dict().items():
        assert torch.equal(tm.state_dict()[key], value), key


def test_lstm_gates_map_in_torch_order():
    v = _jax_variables("mpnn_lstm")["params"]["lstm_1"]
    sd = W.temporal_state_dict_from_params({"lstm_1": v})
    hid = v["hi"]["kernel"].shape[0]
    for g, gate in enumerate("ifgo"):
        rows = slice(g * hid, (g + 1) * hid)
        assert np.array_equal(sd["lstm_1.weight_ih"][rows],
                              v[f"i{gate}"]["kernel"].T)
        assert np.array_equal(sd["lstm_1.bias_hh"][rows],
                              v[f"h{gate}"]["bias"])
    assert not sd["lstm_1.bias_ih"].any()


# --------------------------------------------------------------------------
# the trainer
# --------------------------------------------------------------------------

def _split(snaps):
    train, vt = TT.temporal_signal_split(snaps, 0.5)
    val, test = TT.temporal_signal_split(vt, 0.5)
    return train, val, test


def _models(name):
    if name == "dcrnn":
        return JDCRNN(4, 1, K=2), TM.DCRNN(4, 4, 1, K=2, device="cpu")
    return (JDIFFormer(hidden_channels=4, out_channels=1, num_layers=2,
                       dropout=0.0),
            DIFFormer(4, 4, 1, num_layers=2, dropout=0.0, device="cpu"))


@pytest.mark.parametrize("name", ["dcrnn", "difformer"])
@pytest.mark.parametrize("mode", ["cumulative", "incremental"])
def test_trainer_losses_match_jax(mode, name):
    snaps = random_temporal_sequence(12, 20, 4, seed=3)
    train, val, test = _split(snaps)
    jm, tm = _models(name)
    jt = JT.TemporalTrainer(jm, lr=0.01, weight_decay=5e-4, mode=mode,
                            use_scan=False)
    params = jt.init_params(train[0])
    opt = jt.tx.init(params)
    d_tr, d_va = jt._prep(train), jt._prep(val)
    losses, vals = [], []
    for _ in range(3):
        params, opt, c = jt.epoch_train(params, opt, d_tr,
                                        jax.random.PRNGKey(0))
        losses.append(c)
        vals.append(jt.evaluate(params, d_va))
    tt = TT.TemporalTrainer(tm, lr=0.01, weight_decay=5e-4, mode=mode,
                            device="cpu")
    res = tt.fit(train, val, test, epochs=3,
                 init_params=jt.init_params(train[0]))
    np.testing.assert_allclose(res["losses"], losses, **TOL)
    np.testing.assert_allclose(res["val_costs"], vals, **TOL)
    best = int(np.argmin(vals))
    assert res["valid"] == res["val_costs"][best]


def test_trainer_builds_one_plan_per_distinct_graph():
    static = random_temporal_sequence(10, 8, 3, seed=1)
    tt = TT.TemporalTrainer(TM.DCRNN(3, 4, 1, device="cpu"), device="cpu")
    data = tt._prep(static)
    assert len(data.plans) == 1 and data.plan_of == [0] * 8
    assert tt._prep(static[:3]).plans[0] is data.plans[0]
    rebuilt = TT.TemporalTrainer(TM.DCRNN(3, 4, 1, device="cpu"),
                                 rebuild="knn", device="cpu")
    data = rebuilt._prep(static)
    assert len(data.plans) == len({s.node_feat.tobytes() for s in static})


def test_mpnn_lstm_trains_with_its_batch_norm_statistics():
    """MPNN-LSTM trains as the reference trains it (the JAX trainer cannot:
    ROADMAP.md queue C): BatchNorm's statistics move in training and the
    best state carries them."""
    snaps = random_temporal_sequence(15, 16, 4, seed=2)
    tm = TM.MPNNLSTM(4, 8, 1, 15, 1, dropout=0.2, device="cpu")
    tt = TT.TemporalTrainer(tm, lr=0.01, device="cpu")
    res = tt.fit(*_split(snaps), epochs=4)
    assert np.all(np.isfinite(res["losses"])) and np.isfinite(res["test"])
    assert res["losses"][-1] < res["losses"][0]
    assert not torch.equal(res["params"]["bn_1.running_var"],
                           torch.ones(8))
    assert set(res["params"]) == set(tm.state_dict())


def test_early_stopping_restores_the_best_state():
    snaps = random_temporal_sequence(12, 20, 4, seed=4)
    tt = TT.TemporalTrainer(TM.DCRNN(4, 4, 1, device="cpu"), lr=0.5,
                            device="cpu")
    res = tt.fit(*_split(snaps), epochs=30, early_stopping=2)
    vals = res["val_costs"]
    best = int(np.argmin(vals))
    assert len(vals) == best + 3 and res["valid"] == vals[best]
    for k, v in res["params"].items():
        assert torch.equal(tt.model.state_dict()[k], v), k


# --------------------------------------------------------------------------
# the command line
# --------------------------------------------------------------------------

class _Recorder:
    """Stands in for a TemporalTrainer: records what it is handed."""

    made = []

    def __init__(self, model, **kw):
        self.kw = kw
        _Recorder.made.append(self)

    def fit(self, train, val, test, **kw):
        self.snaps = (train, val, test)
        self.fit_kw = kw
        return {"test": 0.0}


@pytest.mark.parametrize("argv", [
    ["--dataset", "chickenpox"],
    ["--dataset", "wikimath", "--method", "dcrnn", "--dcrnn_filters", "3"],
    ["--dataset", "synthetic-10-20-3-2", "--task", "temporal",
     "--special_treat", "knn"],
])
def test_cli_hands_the_trainer_what_the_jax_cli_does(monkeypatch, tmp_path,
                                                     argv):
    from difformer_tpu import cli as jax_cli
    from difformer_tpu_torch import cli

    chip_smoke.write_chickenpox_json(tmp_path, nodes=8, edges=20, weeks=30)
    chip_smoke.write_wikimath_json(tmp_path, nodes=10, edges=30, days=40)
    argv = argv + ["--data_dir", str(tmp_path), "--epochs", "2"]
    got = []
    for module, main in ((JT, jax_cli.main), (TT, cli.main)):
        _Recorder.made = []
        monkeypatch.setattr(module, "TemporalTrainer", _Recorder)
        main(argv) if module is JT else main(argv, device="cpu")
        got.append(_Recorder.made)
    theirs, ours = got
    assert len(ours) == len(theirs) == 1
    assert ours[0].kw == {**theirs[0].kw, "device": "cpu"}
    assert ours[0].fit_kw == theirs[0].fit_kw
    for a, b in zip(ours[0].snaps, theirs[0].snaps):
        _same_snaps(a, b)


@pytest.mark.parametrize("method", ["difformer", "dcrnn", "mpnn_lstm"])
def test_cli_trains_the_temporal_track(tmp_path, method, capsys):
    from difformer_tpu_torch import cli

    chip_smoke.write_chickenpox_json(tmp_path, nodes=10, edges=30, weeks=40)
    costs = cli.main(["--dataset", "chickenpox", "--data_dir", str(tmp_path),
                      "--epochs", "3", "--method", method], device="cpu")
    assert costs.shape == (1,) and np.isfinite(costs).all()
    assert "Final Test" in capsys.readouterr().out


def test_cli_stand_in_warns_where_the_file_is_missing(tmp_path, capsys):
    from difformer_tpu_torch import cli

    costs = cli.main(["--dataset", "covid", "--data_dir", str(tmp_path),
                      "--epochs", "2"], device="cpu")
    assert np.isfinite(costs).all()
    assert "[warn]" in capsys.readouterr().out


def test_cli_runs_dcrnn_on_the_node_task():
    """As the JAX command line does, ``--method dcrnn`` trains DCRNN as a
    node classifier on a node task."""
    from difformer_tpu_torch import cli

    res = cli.main(["--dataset", "synthetic-60-200-4-3", "--epochs", "3",
                    "--method", "dcrnn", "--rand_split", "true"],
                   device="cpu")
    assert np.isfinite(res[0]["losses"]).all()
