"""The port's graph-level (particle) track against the JAX package's, on the
CPU.

The same numpy inputs, made from a seed, go through both packages:

- exact equality: the batching functions (``pad_graph_batch``,
  ``batch_iterator``, ``prefetch``, ``regular_knn_table``, ``dense_adj``),
  ``radius_graph``, ``get_random_idx_split`` and ``random_small_graphs``;
- rtol 2e-4, atol 2e-5 (tests/test_reference_exec.py:334): the padded
  attentions, forward and gradients, with the cross-graph quirk and with
  padding graphs; ``knn_table_conv`` with and without the transposed
  table; ``FeatEncoder``; ``GraphLevelModel``'s logits and parameter
  gradients on each conv plan, with both kernels and every pooling; a
  3-step Adam trajectory of ``GraphLevelTrainer`` against the JAX trainer's
  (dropout 0, the same weights), its eval logits and the pooled AUC;
- with dropout on, the distribution of train-mode logits;
- bf16 ``compute_dtype``: logits within 5 % RMS of the f32 logits;
- the packed batch and its edge-list plan against the model's own plan,
  bit for bit; and the command line's ``--task graph`` route, which hands
  its trainer the JAX command line's dataset, split and model, reads a
  processed particle cache, and falls back as the JAX one does.

Sizes: batches of at most 8 graphs of at most 24 nodes, hidden 16, 2
layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difformer_tpu.data import batching as JB
from difformer_tpu.data.splits import get_random_idx_split as jax_split
from difformer_tpu.data.synthetic import random_small_graphs as jax_graphs
from difformer_tpu.data.transforms import radius_graph as jax_radius
from difformer_tpu.nn.common import FeatEncoder as JFeatEncoder
from difformer_tpu.nn.difformer_v2 import DIFFormerV2 as JV2
from difformer_tpu.nn.difformer_v2 import GraphLevelModel as JGL
from difformer_tpu.ops.graph_ops import knn_table_conv as jax_table_conv
from difformer_tpu.ops.linear_attention import (
    simple_attention_padded as jax_simple_padded,
)
from difformer_tpu.ops.sigmoid_attention import (
    sigmoid_attention_padded as jax_sigmoid_padded,
)
from difformer_tpu.ops.sigmoid_attention import (
    sigmoid_attention_padded_crossgraph as jax_crossgraph,
)
from difformer_tpu.train import graph_level as JGT
from difformer_tpu_torch.data import batching as TB
from difformer_tpu_torch.data.splits import get_random_idx_split
from difformer_tpu_torch.data.synthetic import random_small_graphs
from difformer_tpu_torch.data.transforms import radius_graph
from difformer_tpu_torch.nn.common import FeatEncoder
from difformer_tpu_torch.nn.difformer_v2 import DIFFormerV2, GraphLevelModel
from difformer_tpu_torch.ops.graph_ops import build_csr_plan, knn_table_conv
from difformer_tpu_torch.ops.linear_attention import simple_attention_padded
from difformer_tpu_torch.ops.sigmoid_attention import (
    sigmoid_attention_padded,
    sigmoid_attention_padded_crossgraph,
)
from difformer_tpu_torch.train import graph_level as TGT
from difformer_tpu_torch.utils import weights as W

import chip_smoke
import torch_port_helpers  # noqa: F401  (sets torch's threads)

TOL = dict(rtol=2e-4, atol=2e-5)
HIDDEN, FEAT = 16, 8


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a, dtype=None):
    return None if a is None else torch.as_tensor(np.asarray(a), dtype=dtype)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got.detach() if hasattr(
        got, "detach") else got), np.asarray(ref), **TOL)


def _graphs(n=6, seed=1):
    ours, theirs = random_small_graphs(n, seed=seed), jax_graphs(n, seed=seed)
    return ours, theirs


def _batch(mod, graphs, batch_size=8, weights=False, **kw):
    ew = None
    if weights:
        rng = np.random.default_rng(9)
        ew = [rng.uniform(0.5, 2.0, g[1].shape[1]).astype(np.float32)
              for g in graphs]
    return mod.pad_graph_batch([g[0] for g in graphs],
                               [g[1] for g in graphs],
                               [g[2] for g in graphs], batch_size=batch_size,
                               edge_weights=ew, **kw)


def _same_batch(a, b):
    for f in ("node_feat", "node_mask", "n_nodes", "senders", "receivers",
              "edge_mask", "edge_weight", "labels", "graph_mask"):
        x, y = getattr(a, f), getattr(b, f)
        if y is None:
            assert x is None, f
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert a.edges_sorted == b.edges_sorted


# --------------------------------------------------------------------------
# numpy modules: exact equality
# --------------------------------------------------------------------------

@pytest.mark.parametrize("k,node_range", [(3, (8, 24)), (5, (4, 12))])
def test_random_small_graphs_match_jax(k, node_range):
    ours = random_small_graphs(7, node_range, 6, seed=4, k=k)
    theirs = jax_graphs(7, node_range, 6, seed=4, k=k)
    for a, b in zip(ours, theirs):
        for x, y in zip(a, b):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("n,train,valid,seed", [(20, 0.7, 0.15, 0),
                                                (33, 0.5, 0.25, 42)])
def test_random_idx_split_matches_jax(n, train, valid, seed):
    ours = get_random_idx_split(n, train, valid, rng=seed)
    theirs = jax_split(n, train, valid, rng=seed)
    assert set(ours) == set(theirs) == {"train", "valid", "test"}
    for k in ours:
        assert np.array_equal(ours[k], theirs[k])


@pytest.mark.parametrize("loop,most", [(True, None), (False, None),
                                       (True, 3)])
def test_radius_graph_matches_jax(loop, most):
    pos = np.random.default_rng(2).normal(size=(25, 2)).astype(np.float32)
    ours = radius_graph(pos, 0.8, loop=loop, max_num_neighbors=most)
    theirs = jax_radius(pos, 0.8, loop=loop, max_num_neighbors=most)
    assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)


@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("fixed", [False, True])
def test_pad_graph_batch_matches_jax(weights, fixed):
    ours, theirs = _graphs()
    kw = dict(max_nodes=30, max_edges=500) if fixed else {}
    _same_batch(_batch(TB, ours, weights=weights, **kw),
                _batch(JB, theirs, weights=weights, **kw))


def test_pad_graph_batch_raises_as_jax():
    ours, _ = _graphs()
    for mod in (TB, JB):
        with pytest.raises(ValueError, match="max_nodes"):
            _batch(mod, ours, max_nodes=5)
        with pytest.raises(ValueError, match="max_edges"):
            _batch(mod, ours, max_edges=10)


def test_batch_iterator_and_prefetch_match_jax():
    ours, theirs = _graphs(19, seed=2)
    idx = np.arange(3, 19)
    out = []
    for mod, graphs in ((TB, ours), (JB, theirs)):
        it = mod.batch_iterator(graphs, idx, 5, max_nodes=24, max_edges=400,
                                shuffle=True, rng=np.random.default_rng(7))
        out.append(list(mod.prefetch(it)))
    assert len(out[0]) == len(out[1]) == 4
    for a, b in zip(*out):
        _same_batch(a, b)
    dropped = list(TB.batch_iterator(ours, idx, 5, max_nodes=24,
                                     max_edges=400, drop_last=True))
    assert len(dropped) == 3


def test_prefetch_raises_the_producers_error():
    def broken():
        yield 1
        raise KeyError("producer")

    got = []
    with pytest.raises(KeyError, match="producer"):
        for item in TB.prefetch(broken()):
            got.append(item)
    assert got == [1]


@pytest.mark.parametrize("k_rev_pad", [0, 24])
@pytest.mark.parametrize("weights", [False, True])
def test_regular_knn_table_matches_jax(weights, k_rev_pad):
    ours, theirs = _graphs()
    a = TB.regular_knn_table(_batch(TB, ours, weights=weights),
                             k_rev_pad=k_rev_pad)
    b = JB.regular_knn_table(_batch(JB, theirs, weights=weights),
                             k_rev_pad=k_rev_pad)
    assert a is not None and len(a) == len(b) == 4
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_regular_knn_table_refuses_as_jax():
    ours, _ = _graphs()
    ragged = [(x, ei[:, 1:], y) for x, ei, y in ours]  # not k-regular
    for mod in (TB, JB):
        assert mod.regular_knn_table(_batch(mod, ragged)) is None
        t = mod.regular_knn_table(_batch(mod, ours), k_rev_pad=1)
        assert t[2] is None and t[3] is None


@pytest.mark.parametrize("weights", [False, True])
def test_dense_adj_matches_jax(weights):
    ours, theirs = _graphs()
    # duplicate edges are summed
    ours = [(x, np.concatenate([ei, ei[:, :4]], 1), y) for x, ei, y in ours]
    theirs = [(x, np.concatenate([ei, ei[:, :4]], 1), y)
              for x, ei, y in theirs]
    a = TB.dense_adj(_batch(TB, ours, weights=weights))
    b = JB.dense_adj(_batch(JB, theirs, weights=weights))
    assert a.dtype == b.dtype and np.array_equal(a, b)
    out = np.full(a.shape, 7.0, np.float32)
    assert TB.dense_adj(_batch(TB, ours, weights=weights), out=out) is out
    assert np.array_equal(out, a)
    for kw in (dict(max_m=4), dict(budget_bytes=64)):
        assert TB.dense_adj(_batch(TB, ours), **kw) is None
        assert JB.dense_adj(_batch(JB, theirs), **kw) is None


# --------------------------------------------------------------------------
# ops: forward and gradients
# --------------------------------------------------------------------------

def _padded(seed=0, b=5, m=9, h=2, d=4, empty=True):
    """q, k, v [B, M, H, D], node_mask and n_nodes; with ``empty`` the
    last graph is a padding graph (no node)."""
    rng = np.random.default_rng(seed)
    n = rng.integers(2, m + 1, b)
    if empty:
        n[-1] = 0
    mask = np.arange(m)[None, :] < n[:, None]
    qkv = [rng.normal(size=(b, m, h, d)).astype(np.float32) for _ in range(3)]
    return qkv, mask, n.astype(np.int32)


def _grads_of(fn_t, fn_j, qkv, mask, *extra):
    cot = np.random.default_rng(11).normal(
        size=np.asarray(fn_j(*[jnp.asarray(a) for a in qkv], jnp.asarray(mask),
                             *extra)).shape).astype(np.float32)
    ref, vjp = jax.vjp(lambda q, k, v: fn_j(q, k, v, jnp.asarray(mask),
                                            *extra),
                       *[jnp.asarray(a) for a in qkv])
    jg = vjp(jnp.asarray(cot))
    ts = [torch.tensor(a, requires_grad=True) for a in qkv]
    out = fn_t(*ts, torch.as_tensor(mask),
               *[torch.as_tensor(np.asarray(e)) for e in extra])
    (out * torch.as_tensor(cot)).sum().backward()
    return out, ref, [t.grad for t in ts], jg


@pytest.mark.parametrize("empty", [False, True])
@pytest.mark.parametrize("heads", [1, 2])
def test_simple_attention_padded_matches_jax(heads, empty):
    qkv, mask, n = _padded(h=heads, empty=empty)
    out, ref, tg, jg = _grads_of(simple_attention_padded, jax_simple_padded,
                                 qkv, mask, n)
    _close(out, ref)
    for a, b in zip(tg, jg):
        assert torch.isfinite(a).all()
        _close(a, b)


@pytest.mark.parametrize("empty", [False, True])
@pytest.mark.parametrize("crossgraph", [False, True])
def test_sigmoid_attention_padded_matches_jax(crossgraph, empty):
    qkv, mask, _ = _padded(seed=3, empty=empty)
    fns = ((sigmoid_attention_padded_crossgraph, jax_crossgraph) if crossgraph
           else (sigmoid_attention_padded, jax_sigmoid_padded))
    out, ref, tg, jg = _grads_of(*fns, qkv, mask)
    _close(out, ref)
    for a, b in zip(tg, jg):
        assert torch.isfinite(a).all()
        _close(a, b)


@pytest.mark.parametrize("transposed", [True, False])
def test_knn_table_conv_matches_jax(transposed):
    ours, theirs = _graphs()
    idx, w, ridx, rw = TB.regular_knn_table(_batch(TB, ours, weights=True))
    rng = np.random.default_rng(5)
    v = rng.normal(size=(idx.shape[0], 2, 3)).astype(np.float32)
    cot = rng.normal(size=v.shape).astype(np.float32)
    if transposed:
        ref, vjp = jax.vjp(lambda x: jax_table_conv(
            x, _j(idx), _j(w), _j(ridx), _j(rw)), jnp.asarray(v))
        tab = (_t(ridx), _t(rw))
    else:
        ref, vjp = jax.vjp(lambda x: jnp.einsum(
            "rk,rkhd->rhd", _j(w), jnp.take(x, _j(idx), axis=0)),
            jnp.asarray(v))
        tab = (None, None)
    tv = torch.tensor(v, requires_grad=True)
    out = knn_table_conv(tv, _t(idx), _t(w), *tab)
    (out * _t(cot)).sum().backward()
    _close(out, ref)
    _close(tv.grad, vjp(jnp.asarray(cot))[0])


@pytest.mark.parametrize("cards", [(), (5,), (4, 6)])
def test_feat_encoder_matches_jax(cards):
    rng = np.random.default_rng(1)
    n_cat = len(cards)
    x = rng.normal(size=(2, 7, 5)).astype(np.float32)
    for i, c in enumerate(cards):
        x[..., i] = rng.integers(0, c, (2, 7))
    jm = JFeatEncoder(hidden=HIDDEN, categorical_cardinalities=cards)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    tm = FeatEncoder(5, HIDDEN, cards)
    W.load_params(tm, _np_tree(params))
    ref, vjp = jax.vjp(lambda p: jm.apply({"params": p}, jnp.asarray(x)),
                       params)
    cot = rng.normal(size=ref.shape).astype(np.float32)
    out = tm(_t(x))
    (out * _t(cot)).sum().backward()
    _close(out, ref)
    sd = W.feat_encoder_state_dict_from_params(_np_tree(
        vjp(jnp.asarray(cot))[0]))
    grads = dict(tm.named_parameters())
    assert set(sd) == set(grads)
    for name, g in sd.items():
        _close(grads[name].grad, g)
    other = FeatEncoder(5, HIDDEN, cards)
    other.reset_parameters(torch.Generator().manual_seed(0))
    assert n_cat == 0 or not torch.equal(other.embed_0.weight,
                                         tm.embed_0.weight)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

PLANS = ("dense", "table", "edges")


def _plan_kw(batch, plan, to):
    if plan == "dense":
        return {"dense_adj": to(TB.dense_adj(batch))}
    if plan == "table":
        return {"knn_table": tuple(to(a) for a in
                                   TB.regular_knn_table(batch))}
    return {}


@pytest.fixture(scope="module")
def model_batch():
    graphs, _ = _graphs(6, seed=1)
    return _batch(TB, graphs)


def _pair(kernel, pooling, **enc_kw):
    """(JAX model, its params as numpy, the port's model with them)."""
    jm = JGL(encoder=JV2(hidden_channels=HIDDEN, out_channels=HIDDEN,
                         num_layers=2, kernel=kernel, **enc_kw),
             out_channels=1, graph_pooling=pooling)
    tm = GraphLevelModel(DIFFormerV2(FEAT, HIDDEN, HIDDEN, num_layers=2,
                                     kernel=kernel, device="cpu", **enc_kw),
                         1, pooling, device="cpu")
    return jm, tm


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("pooling", ["sum", "mean", "max"])
@pytest.mark.parametrize("kernel", ["simple", "sigmoid"])
def test_graph_level_model_matches_jax(model_batch, kernel, pooling, plan):
    b = model_batch
    jm, tm = _pair(kernel, pooling, dropout=0.0)
    args = [jnp.asarray(a) for a in (b.node_feat, b.node_mask, b.n_nodes,
                                     b.senders, b.receivers)]
    args = args + [None, jnp.asarray(b.edge_mask)]
    jkw = _plan_kw(b, plan, jnp.asarray)
    params = jm.init(jax.random.PRNGKey(2), *args)["params"]
    W.load_params(tm, _np_tree(params))
    cot = np.random.default_rng(3).normal(size=(8, 1)).astype(np.float32)
    ref, vjp = jax.vjp(lambda p: jm.apply({"params": p}, *args, **jkw),
                       params)
    out = tm(_t(b.node_feat), _t(b.node_mask), _t(b.n_nodes),
             _t(b.senders).long(), _t(b.receivers).long(), None,
             _t(b.edge_mask), **_plan_kw(b, plan, _t))
    (out * _t(cot)).sum().backward()
    _close(out, ref)
    grads = W.v2_state_dict_from_params(_np_tree(vjp(jnp.asarray(cot))[0]))
    own = dict(tm.named_parameters())
    assert set(grads) == set(own)
    for name, g in grads.items():
        assert torch.isfinite(own[name].grad).all(), name
        _close(own[name].grad, g)


@pytest.mark.parametrize("options", [
    dict(use_weight=False), dict(use_graph=False), dict(graph_weight=0.3),
    dict(use_bn=False, use_residual=False), dict(num_heads=2),
    dict(kernel="sigmoid", crossgraph_quirk=True)])
def test_graph_level_model_options_match_jax(model_batch, options):
    b = model_batch
    options = dict(options)
    kernel = options.pop("kernel", "simple")
    jm, tm = _pair(kernel, "mean", dropout=0.0, **options)
    args = [jnp.asarray(a) for a in (b.node_feat, b.node_mask, b.n_nodes,
                                     b.senders, b.receivers)]
    args = args + [None, jnp.asarray(b.edge_mask)]
    params = jm.init(jax.random.PRNGKey(5), *args)["params"]
    W.load_params(tm, _np_tree(params))
    out = tm(_t(b.node_feat), _t(b.node_mask), _t(b.n_nodes),
             _t(b.senders).long(), _t(b.receivers).long(), None,
             _t(b.edge_mask))
    _close(out, jm.apply({"params": params}, *args))


def test_weights_round_trip(model_batch):
    _, tm = _pair("simple", "mean")
    params = W.v2_params_from_state_dict(tm.state_dict())
    assert set(params) == {"encoder", "lin"}
    back = W.v2_state_dict_from_params(params)
    for k, v in tm.state_dict().items():
        assert np.array_equal(back[k], v.numpy()), k
    enc = W.v2_params_from_state_dict(tm.encoder.state_dict())
    assert set(enc) >= {"fc_in", "fc_out", "ln_0", "conv_0"}


def test_dropout_distribution_matches_jax(model_batch):
    """Dropout 0.4 in training: the mean and spread of each graph's logit
    over 300 dropout draws agree with the JAX model's over 300 keys
    (within 5 standard errors of the means, and 25 % in the spread)."""
    b = model_batch
    jm, tm = _pair("simple", "mean", dropout=0.4)
    args = [jnp.asarray(a) for a in (b.node_feat, b.node_mask, b.n_nodes,
                                     b.senders, b.receivers)]
    args = args + [None, jnp.asarray(b.edge_mask)]
    params = jm.init(jax.random.PRNGKey(1), *args)["params"]
    W.load_params(tm, _np_tree(params))
    draws = 300
    fwd = jax.jit(jax.vmap(lambda key: jm.apply(
        {"params": params}, *args, train=True, rngs={"dropout": key})))
    theirs = np.asarray(fwd(jax.random.split(jax.random.PRNGKey(0),
                                             draws)))[..., 0]
    tm.train()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        ours = np.stack([tm(_t(b.node_feat), _t(b.node_mask), _t(b.n_nodes),
                            _t(b.senders).long(), _t(b.receivers).long(),
                            None, _t(b.edge_mask), generator=gen)[:, 0].numpy()
                         for _ in range(draws)])
    se = np.sqrt((ours.var(0) + theirs.var(0)) / draws)
    assert np.all(np.abs(ours.mean(0) - theirs.mean(0)) <= 5 * se + 1e-6)
    assert np.allclose(ours.std(0), theirs.std(0), rtol=0.25)
    assert not np.allclose(ours[0], ours[1])


def test_bf16_logits_within_5_percent_of_f32(model_batch):
    b = model_batch
    outs = []
    for dtype in (None, "bfloat16"):
        tm = GraphLevelModel(DIFFormerV2(FEAT, HIDDEN, HIDDEN, dropout=0.0,
                                         compute_dtype=dtype, device="cpu"),
                             1, "mean", seed=4, device="cpu")
        outs.append(tm(_t(b.node_feat), _t(b.node_mask), _t(b.n_nodes),
                       _t(b.senders).long(), _t(b.receivers).long(), None,
                       _t(b.edge_mask)).detach())
    assert outs[1].dtype == torch.float32
    rms = lambda a: float(a.square().mean().sqrt())  # noqa: E731
    assert rms(outs[1] - outs[0]) <= 0.05 * rms(outs[0])
    assert not torch.equal(outs[0], outs[1])


def test_model_builds_one_plan_per_forward(model_batch, monkeypatch):
    """Without a plan the encoder builds the CSR plan once a call, not
    once a layer; with a dense or table plan it builds none."""
    import difformer_tpu_torch.nn.difformer_v2 as V2

    built = []
    real = V2.build_csr_plan
    monkeypatch.setattr(V2, "build_csr_plan",
                        lambda *a: built.append(1) or real(*a))
    b = model_batch
    tm = _pair("simple", "mean")[1]
    base = (_t(b.node_feat), _t(b.node_mask), _t(b.n_nodes),
            _t(b.senders).long(), _t(b.receivers).long(), None,
            _t(b.edge_mask))
    tm(*base)
    assert built == [1]
    tm(*base, **_plan_kw(b, "dense", _t))
    tm(*base, **_plan_kw(b, "table", _t))
    assert built == [1]


# --------------------------------------------------------------------------
# the trainer
# --------------------------------------------------------------------------

SPLIT = {"train": np.arange(0, 12), "valid": np.arange(12, 18),
         "test": np.arange(18, 24)}


@pytest.fixture(scope="module")
def trainer_graphs():
    return jax_graphs(24, seed=3)


def _jax_trajectory(graphs, kernel, plan):
    """The JAX trainer's first epoch step by step (batch 4, 3 steps, dropout
    0): initial params, losses, final params, and each split's metric."""
    jm = JGL(encoder=JV2(hidden_channels=HIDDEN, out_channels=HIDDEN,
                         num_layers=2, kernel=kernel, dropout=0.0),
             out_channels=1)
    jt = JGT.GraphLevelTrainer(jm, graphs, batch_size=4, lr=1e-2,
                               weight_decay=1e-3, seed=7)
    if plan != "dense":
        jt._dense_mode = False
    if plan == "edges":
        jt._knn_mode = False
    params, opt_state = jt.init_state(0)
    p0 = _np_tree(params)
    rng = np.random.default_rng(7)
    losses = []
    for batch in JB.batch_iterator(graphs, SPLIT["train"], 4,
                                   max_nodes=jt.max_nodes,
                                   max_edges=jt.max_edges, shuffle=True,
                                   rng=rng):
        params, opt_state, loss = jt._step(params, opt_state,
                                           jt._to_device(batch),
                                           jax.random.PRNGKey(0))
        losses.append(float(loss))
    metrics = {k: jt.eval_split(params, v) for k, v in SPLIT.items()}
    return p0, losses, _np_tree(params), metrics


@pytest.mark.parametrize("kernel,plan", [("simple", "dense"),
                                         ("sigmoid", "dense"),
                                         ("simple", "table"),
                                         ("simple", "edges")])
def test_trainer_trajectory_matches_jax(trainer_graphs, kernel, plan):
    p0, losses, p3, metrics = _jax_trajectory(trainer_graphs, kernel, plan)
    tm = GraphLevelModel(DIFFormerV2(FEAT, HIDDEN, HIDDEN, kernel=kernel,
                                     dropout=0.0, device="cpu"), 1,
                         device="cpu")
    tr = TGT.GraphLevelTrainer(tm, trainer_graphs, batch_size=4, lr=1e-2,
                               weight_decay=1e-3, seed=7, device="cpu")
    tr._dense_mode = False if plan != "dense" else None
    tr._knn_mode = False if plan == "edges" else None
    res = tr.fit(SPLIT, epochs=1, init_params=p0)[0]
    assert {lay.plan for lay in tr.runner.buffers} == {plan}
    np.testing.assert_allclose(res["losses"][0], losses, **TOL)
    for name, value in W.v2_state_dict_from_params(p3).items():
        _close(tm.state_dict()[name], value)
    for k in SPLIT:
        assert res[k] == pytest.approx(metrics[k], abs=1e-12)


def test_eval_logits_and_pooled_auc_match_jax(trainer_graphs):
    """The eval logits of every batch and the pooled AUC of a split against
    the JAX trainer's, on the same weights (the port's metric is
    ``utils/metrics.roc_auc_score`` of the pooled scores)."""
    from difformer_tpu.utils.metrics import roc_auc_score as jax_auc

    jm = JGL(encoder=JV2(hidden_channels=HIDDEN, out_channels=HIDDEN,
                         num_layers=2), out_channels=1)
    jt = JGT.GraphLevelTrainer(jm, trainer_graphs, batch_size=5, seed=2)
    params, _ = jt.init_state(0)
    tm = GraphLevelModel(DIFFormerV2(FEAT, HIDDEN, HIDDEN, device="cpu"), 1,
                         device="cpu")
    W.load_params(tm, _np_tree(params))
    tr = TGT.GraphLevelTrainer(tm, trainer_graphs, batch_size=5,
                               device="cpu")
    idx = np.arange(24)
    scores, labels = [], []
    for batch in JB.batch_iterator(trainer_graphs, idx, 5,
                                   max_nodes=jt.max_nodes,
                                   max_edges=jt.max_edges):
        gm = np.asarray(batch.graph_mask)
        scores.append(np.asarray(jt._fwd(params, jt._to_device(batch)))[gm])
        labels.append(np.asarray(batch.labels)[gm])
    runner = tr._runner(TGT.TrainState(tm, None, 0), capture=False)
    masks, ours_labels = [], []
    logits = runner.evaluate(tr.batches(idx), masks, ours_labels)
    gm = np.concatenate(masks)
    _close(logits.reshape(-1)[gm], np.concatenate(scores))
    assert np.array_equal(np.concatenate(ours_labels)[gm],
                          np.concatenate(labels))
    assert tr.eval_split(idx) == pytest.approx(
        jax_auc(np.concatenate(labels), np.concatenate(scores)), abs=1e-12)
    assert tr.eval_split(idx) == pytest.approx(jt.eval_split(params, idx),
                                               abs=1e-12)


def test_trainer_probes_plans_as_jax(trainer_graphs):
    """The plan of each batch as the JAX trainer picks it: dense while the
    shape fits; else the table while batches are k-regular, whose first
    refusal turns it off for good; else the edge list."""
    tm = GraphLevelModel(DIFFormerV2(FEAT, HIDDEN, HIDDEN, device="cpu"), 1,
                         device="cpu")
    tr = TGT.GraphLevelTrainer(tm, trainer_graphs, batch_size=4,
                               device="cpu")
    batches = list(JB.batch_iterator(trainer_graphs, np.arange(24), 4,
                                     max_nodes=tr.max_nodes,
                                     max_edges=tr.max_edges))
    assert tr.pack(batches[0])[0].plan == "dense" and tr._dense_mode
    tr._dense_mode = False
    assert tr.pack(batches[0])[0].plan == "table" and tr._knn_mode
    ragged = TB.pad_graph_batch(
        [g[0] for g in trainer_graphs[:4]],
        [g[1][:, 1:] for g in trainer_graphs[:4]], [0.0] * 4,
        max_nodes=tr.max_nodes, max_edges=tr.max_edges, batch_size=4)
    assert tr.pack(ragged)[0].plan == "edges" and tr._knn_mode is False
    assert tr.pack(batches[1])[0].plan == "edges"
    big = TGT.GraphLevelTrainer(tm, trainer_graphs, batch_size=4,
                                max_nodes=600, device="cpu")
    wide = next(JB.batch_iterator(trainer_graphs, np.arange(4), 4,
                                  max_nodes=600, max_edges=big.max_edges))
    assert big.pack(wide)[0].plan == "table"  # M > 512: no dense plan
    assert big._dense_mode is False


def test_packed_edge_plan_equals_the_models_plan(trainer_graphs):
    """The edge-list plan packed on the host (real edges, masked GCN
    values, held at the edge capacity, no split schedule on kNN graphs)
    equals ``build_csr_plan`` of the padded batch bit for bit."""
    tm = GraphLevelModel(DIFFormerV2(FEAT, HIDDEN, HIDDEN, device="cpu"), 1,
                         device="cpu")
    tr = TGT.GraphLevelTrainer(tm, trainer_graphs, batch_size=4,
                               device="cpu")
    tr._dense_mode = tr._knn_mode = False
    batch = next(TB.batch_iterator(trainer_graphs, np.arange(4, 12), 4,
                                   max_nodes=tr.max_nodes,
                                   max_edges=tr.max_edges))
    layout, host, _, _ = tr.pack(batch)
    assert (layout.edges, layout.heavy, layout.segments) == (
        tr.max_edges, 0, 0)
    plan = TGT.model_inputs(layout, layout.views(host))["plan"]
    ref = build_csr_plan(_t(batch.senders).long(), _t(batch.receivers).long(),
                         4 * tr.max_nodes, None, _t(batch.edge_mask))
    e = int(plan.row_ptr[-1])
    assert e == int(batch.edge_mask.sum())
    # the padded edges, which the packed plan drops, join and leave the
    # last padded node, whose rows end the CSRs
    for f in ("row_ptr", "t_row_ptr"):
        assert torch.equal(getattr(plan, f)[:-1], getattr(ref, f)[:-1])
    real = ref.val != 0
    for f, t_f in (("col", "val"), ("t_col", "t_val")):
        assert torch.equal(getattr(plan, f)[:e], getattr(ref, f)[real])
        assert torch.equal(getattr(plan, t_f)[:e], getattr(ref, t_f)[real])


def test_graph_and_loop_paths_agree_on_the_cpu(trainer_graphs):
    """On the CPU both paths run eagerly; dropout on, the same generator:
    the same losses bit for bit (the card's graphs are held to the loop in
    tests/test_torch_port_cuda.py)."""
    res = []
    for use_graphs in (True, False):
        tm = GraphLevelModel(DIFFormerV2(FEAT, HIDDEN, HIDDEN, dropout=0.3,
                                         device="cpu"), 1, device="cpu")
        tr = TGT.GraphLevelTrainer(tm, trainer_graphs, batch_size=5,
                                   use_graphs=use_graphs, device="cpu")
        res.append(tr.fit(SPLIT, epochs=2, runs=2))
    assert res[0] == [{**r, "seconds": res[0][i]["seconds"]}
                      for i, r in enumerate(res[1])]
    assert res[0][0]["losses"] != res[0][1]["losses"]


# --------------------------------------------------------------------------
# the command line
# --------------------------------------------------------------------------

class _Recorder:
    """Stands in for both packages' GraphLevelTrainer: records what the
    command line hands it and returns one summary."""

    made = []

    def __init__(self, model, dataset, **kw):
        self.model, self.dataset, self.kw = model, dataset, kw
        _Recorder.made.append(self)

    def fit(self, split, **kw):
        self.split, self.fit_kw = split, kw
        return [{"test": 0.5, "valid": 0.5, "train": 0.5, "epoch": 0}]


def _record(monkeypatch, argv, data_dir):
    from difformer_tpu import cli as jax_cli
    from difformer_tpu_torch import cli

    monkeypatch.setattr(JGT, "GraphLevelTrainer", _Recorder)
    monkeypatch.setattr(cli, "GraphLevelTrainer", _Recorder)
    monkeypatch.chdir(data_dir)  # no configs/<dataset>.yml there
    got = []
    for run in (jax_cli.main, lambda a: cli.main(a, device="cpu")):
        _Recorder.made = []
        run(argv)
        got.append(_Recorder.made[0])
    return got


@pytest.mark.parametrize("argv", [
    ["--dataset", "synthetic", "--task", "graph"],
    ["--dataset", "synthetic", "--task", "graph", "--kernel", "sigmoid",
     "--graph_pooling", "max", "--batch_size", "32", "--hidden_channels",
     "8"],
    ["--dataset", "actstrack"],
])
def test_cli_hands_the_trainer_what_the_jax_cli_does(monkeypatch, tmp_path,
                                                     argv):
    argv = argv + ["--data_dir", str(tmp_path), "--epochs", "2"]
    theirs, ours = _record(monkeypatch, argv, tmp_path)
    assert ours.kw == {**theirs.kw, "device": "cpu"}
    assert ours.fit_kw == theirs.fit_kw
    assert ours.kw["batch_size"] <= 64
    assert len(ours.dataset) == len(theirs.dataset) == 512
    for a, b in zip(ours.dataset, theirs.dataset):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
    for k in theirs.split:
        assert np.array_equal(ours.split[k], theirs.split[k])
    enc, jenc = ours.model.encoder, theirs.model.encoder
    assert ours.model.graph_pooling == theirs.model.graph_pooling
    assert enc.fcs[0].out_features == jenc.hidden_channels
    assert enc.out_channels == jenc.out_channels
    assert len(enc.convs) == jenc.num_layers
    assert enc.convs[0].kernel == jenc.kernel
    assert enc.dropout == jenc.dropout and enc.alpha == jenc.alpha


def test_cli_reads_a_processed_particle_cache(monkeypatch, tmp_path, capsys):
    """``--dataset actstrack`` reads ``<data_dir>/actstrack/processed/
    actstrack_2T_processed.npz`` (written by ``chip_smoke``'s stand-in
    writer) with its own split, as the JAX command line does."""
    graphs = chip_smoke.actstrack_standin(40, seed=3)
    chip_smoke.write_actstrack_cache(str(tmp_path), graphs)
    argv = ["--dataset", "actstrack", "--data_dir", str(tmp_path),
            "--epochs", "2"]
    theirs, ours = _record(monkeypatch, argv, tmp_path)
    assert len(ours.dataset) == len(theirs.dataset) == 40
    for k in theirs.split:
        assert np.array_equal(ours.split[k], theirs.split[k])
    assert "[warn]" not in capsys.readouterr().out
    for (x, ei, y), (gx, gei, gy) in zip(ours.dataset, graphs):
        assert np.array_equal(x, gx) and np.array_equal(ei, gei) and y == gy


def test_cli_trains_the_graph_task(capsys):
    from difformer_tpu_torch import cli

    res = cli.main(["--dataset", "synthetic", "--task", "graph", "--epochs",
                    "2"], device="cpu")
    out = capsys.readouterr().out
    assert "Final Test" in out and "[warn]" not in out
    assert len(res) == 1 and 0.0 <= res[0]["test"] <= 1.0
    assert np.isfinite(res[0]["losses"]).all()


def test_cli_warns_and_trains_without_the_dataset(tmp_path, capsys):
    from difformer_tpu_torch import cli

    res = cli.main(["--dataset", "tau3mu", "--data_dir", str(tmp_path),
                    "--epochs", "1", "--runs", "1"], device="cpu")
    assert "[warn]" in capsys.readouterr().out
    assert 0.0 <= res[0]["test"] <= 1.0
