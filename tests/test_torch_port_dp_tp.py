"""The port's data and tensor parallelism (difformer_tpu_torch/parallel/
data_parallel.py, tensor_parallel.py, mesh.py's grid) against the JAX
package's ``make_dp_train_step`` and GSPMD ``tp_apply`` /
``make_tp_train_step``, on the CPU; and ``native.knn_neighbors``.

Every rank case runs in one spawn of 4 gloo ranks
(``launch.run_ranks`` with ``rank_checks.run_checks``; the 2-rank cases on
its first two ranks, the graph × model grid over all four); the JAX
references run once per module on the conftest's virtual CPU devices,
while the ranks run (the spawn is waited for in a thread of its own).
Within rtol 2e-4 / atol 2e-5:

- ``shard_batches`` gives the JAX function's arrays, field for field,
  with and without ``dense_plan`` and with a shuffle from one numpy rng;
- the data-parallel step on 2 and 4 ranks, on the edge list and the dense
  plan, against the JAX step on a (2,) and a (4,) "data" mesh: the loss,
  every parameter's summed gradient against ``jax.grad`` of the global
  loss (Adam, being invariant to the scale of a step's gradient, would
  hide a gradient off by a constant factor in the parameters), and the
  parameters after 3 steps of ``torch_adam(1e-2, 5e-4)``; the dense plan
  against the edge list; the JAX ``test_dp_training_learns`` in its port
  form; at dropout 0.5 each rank's stream reproducible from (seed, rank)
  and the ranks' masks different;
- ``tp_param_specs`` and ``tp_shard_params`` name and cut the right keys,
  and a model axis that splits a head raises (where the JAX check passes
  it: a documented deviation);
- the head-sharded forward on a (2,) and a (4,) "model" axis at 4 heads,
  simple and sigmoid, and on the 2 × 2 graph × model grid (the port's
  partition and exchanges on the graph axis) against the JAX
  ``tp_apply(node_axis="graph")``;
- the head-sharded train step on the same three layouts at 4 heads and at
  8 heads with every "auto" rewrite on (head mean fused, Wv factored,
  spmm_first) against ``jax.grad`` of the single-device loss and the JAX
  ``make_tp_train_step``: the loss, the gradients of the head-sharded and
  of the replicated parameters, each checked on its own, and the
  parameters after 2 Adam steps at weight decay 5e-4; DIFFormer-a's
  (sigmoid, 4 heads) first loss and gradients on the three layouts.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import PartitionSpec as P

from difformer_tpu import native as jax_native
from difformer_tpu.data.batching import PaddedGraphBatch as JBatch
from difformer_tpu.nn import DIFFormer as JDIFFormer
from difformer_tpu.nn import DIFFormerV2 as JDIFFormerV2
from difformer_tpu.nn import GraphLevelModel as JGraphLevelModel
from difformer_tpu.parallel import data_parallel as JDP
from difformer_tpu.parallel import make_mesh as jax_make_mesh
from difformer_tpu.parallel import tensor_parallel as JTP
from difformer_tpu.train.optim import torch_adam
from difformer_tpu_torch import native
from difformer_tpu_torch.data.synthetic import random_small_graphs
from difformer_tpu_torch.parallel import data_parallel as DP
from difformer_tpu_torch.parallel import partition_graph
from difformer_tpu_torch.parallel import tensor_parallel as TP
from difformer_tpu_torch.parallel.launch import run_ranks
from difformer_tpu_torch.parallel.mesh import Mesh
from difformer_tpu_torch.parallel.rank_checks import run_checks
from difformer_tpu_torch.utils.weights import (torch_state_dict_from_params,
                                               v2_state_dict_from_params)
import torch_port_helpers  # noqa: F401  (sets torch's threads)

TOL = dict(rtol=2e-4, atol=2e-5)
WORLDS = (2, 4)
# the data-parallel cases: tests/test_data_parallel.py's graphs and model
DP_GRAPHS, DP_FEAT, DP_HIDDEN = 32, 8, 16
DP_STEPS, DP_LR, DP_WD = 3, 1e-2, 5e-4
DP_PLANS = ("edges", "dense")
DP_DROPOUT = 0.5
# the JAX test_dp_training_learns: 256 graphs, 6 epochs of 32 a step
LEARN_GRAPHS, LEARN_EPOCHS, LEARN_BATCH = 256, 6, 32
# the tensor-parallel cases: tests/test_tensor_parallel.py's graph and model
N, E, F, C, HIDDEN, LAYERS = 64, 256, 12, 4, 16, 2
TP_STEPS, TP_LR, TP_WD = 2, 1e-2, 5e-4
# name: (kernel, heads, spmm_first); "simple-h8" has every "auto" rewrite on
TP_MODELS = {"simple-h4": ("simple", 4, False),
             "sigmoid-h4": ("sigmoid", 4, False),
             "simple-h8": ("simple", 8, "auto")}
TP_LAYOUTS = ("model-2", "model-4", "grid-2x2")


# -- inputs -----------------------------------------------------------------

def dp_graphs():
    graphs = random_small_graphs(DP_GRAPHS, seed=11)
    return graphs, max(g[0].shape[0] for g in graphs), \
        DP_GRAPHS * max(g[1].shape[1] for g in graphs)


def dp_model_kw(dropout=0.0):
    return dict(in_channels=DP_FEAT, hidden_channels=DP_HIDDEN,
                out_channels=DP_HIDDEN, num_layers=2, dropout=dropout)


def jax_dp_model(dropout=0.0):
    enc = JDIFFormerV2(hidden_channels=DP_HIDDEN, out_channels=DP_HIDDEN,
                       num_layers=2, dropout=dropout)
    return JGraphLevelModel(encoder=enc, out_channels=1)


def stacked(graphs, world, max_nodes, max_edges, plan, package=DP, **kw):
    return next(iter(package.shard_batches(
        graphs, np.arange(len(graphs)), len(graphs) // world, world,
        max_nodes=max_nodes, max_edges=max_edges,
        dense_plan=plan == "dense", **kw)))


def dp_params(model, batch):
    b0 = jax.tree_util.tree_map(lambda t: jnp.asarray(t[0]), batch)
    return jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(0), b0.node_feat, b0.node_mask, b0.n_nodes,
        b0.senders, b0.receivers, None, b0.edge_mask,
        train=False)["params"])


def tp_graph():
    """tests/test_tensor_parallel.py's _toy graph (numpy), with half the
    nodes in the loss."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N, F)).astype(np.float32)
    ei = np.stack([rng.integers(0, N, E), rng.integers(0, N, E)])
    y = rng.integers(0, C, N)
    mask = np.zeros(N, bool)
    mask[::2] = True
    return x, ei, y, mask


def tp_model_kw(name):
    kernel, heads, spmm_first = TP_MODELS[name]
    return dict(in_channels=F, hidden_channels=HIDDEN, out_channels=C,
                num_layers=LAYERS, num_heads=heads, kernel=kernel,
                dropout=0.0, spmm_first=spmm_first)


def jax_tp_model(name):
    kernel, heads, spmm_first = TP_MODELS[name]
    return JDIFFormer(hidden_channels=HIDDEN, out_channels=C,
                      num_layers=LAYERS, num_heads=heads, kernel=kernel,
                      dropout=0.0, spmm_first=spmm_first)


def tp_params(name, x, ei):
    return jax.tree_util.tree_map(np.asarray, jax_tp_model(name).init(
        jax.random.PRNGKey(TP_MODELS[name][1]), jnp.asarray(x),
        jnp.asarray(ei[0], jnp.int32), jnp.asarray(ei[1], jnp.int32),
        train=False)["params"])


# -- the one spawn ------------------------------------------------------------

@pytest.fixture(scope="module")
def runs():
    """The inputs of every rank case, and the port's results as a future
    of one spawn of 4 gloo ranks (waited for by :func:`ranks_of`, so that
    the JAX references are computed meanwhile)."""
    graphs, max_nodes, max_edges = dp_graphs()
    first = stacked(graphs, 2, max_nodes, max_edges, "edges",
                    package=JDP)
    params = dp_params(jax_dp_model(), first)
    drop_params = dp_params(jax_dp_model(DP_DROPOUT), first)
    cases, index = [], {}

    def add(name, case):
        index[name] = len(cases)
        cases.append(case)

    batches = {}
    for world in WORLDS:
        for plan in DP_PLANS:
            batches[world, plan] = stacked(graphs, world, max_nodes,
                                           max_edges, plan)
            add(("dp", world, plan), dict(
                kind="dp", world=world, stacked=batches[world, plan],
                params=params, model_kw=dp_model_kw(), steps=DP_STEPS,
                lr=DP_LR, weight_decay=DP_WD))
    add("dp_dropout", dict(kind="dp_dropout", world=2,
                           stacked=batches[2, "edges"], params=drop_params,
                           model_kw=dp_model_kw(DP_DROPOUT), seed=5))
    learn = random_small_graphs(LEARN_GRAPHS, seed=7)
    learn_nodes = max(g[0].shape[0] for g in learn)
    learn_edges = (LEARN_BATCH // 4) * max(g[1].shape[1] for g in learn)
    add("dp_fit", dict(kind="dp_fit", dataset=learn,
                       params=dp_params(jax_dp_model(), stacked(
                           learn[:8], 2, learn_nodes, learn_edges, "edges",
                           package=JDP)),
                       model_kw=dp_model_kw(), per_device_batch=LEARN_BATCH
                       // 4, epochs=LEARN_EPOCHS, max_nodes=learn_nodes,
                       max_edges=learn_edges))

    x, ei, y, mask = tp_graph()
    sg = partition_graph(x, ei, 2, labels=y, label_mask=mask,
                         build_halo=True)
    tp = {name: tp_params(name, x, ei) for name in TP_MODELS}
    for name in TP_MODELS:
        common = dict(kind="tp", params=tp[name], model_kw=tp_model_kw(name),
                      steps=TP_STEPS, lr=TP_LR, weight_decay=TP_WD)
        for world in WORLDS:
            add(("tp", name, f"model-{world}"),
                dict(common, world=world, graph=(x, ei, y, mask)))
        add(("tp", name, "grid-2x2"), dict(common, grid=(2, 2), sg=sg))
    with ThreadPoolExecutor(1) as pool:
        results = pool.submit(run_ranks, run_checks, 4, "gloo", "cpu", cases)
        yield dict(results=results, index=index, graphs=graphs,
                   max_nodes=max_nodes, max_edges=max_edges,
                   batches=batches, params=params, tp=tp,
                   graph=(x, ei, y, mask), sg=sg, learn=learn)


def ranks_of(runs, name):
    i = runs["index"][name]
    return [r[i] for r in runs["results"].result() if r[i] is not None]


# -- data parallelism ---------------------------------------------------------

@pytest.mark.parametrize("kind", ["edge_list", "dense_plan", "shuffled"])
def test_shard_batches_gives_the_jax_arrays(kind):
    graphs, max_nodes, max_edges = dp_graphs()
    kw = dict(max_nodes=max_nodes, max_edges=max_edges // 4,
              dense_plan=kind == "dense_plan")
    if kind == "shuffled":
        ours = DP.shard_batches(graphs, np.arange(DP_GRAPHS), 4, 2,
                                shuffle=True,
                                rng=np.random.default_rng(3), **kw)
        theirs = JDP.shard_batches(graphs, np.arange(DP_GRAPHS), 4, 2,
                                   shuffle=True,
                                   rng=np.random.default_rng(3), **kw)
    else:
        ours = DP.shard_batches(graphs, np.arange(DP_GRAPHS), 4, 2, **kw)
        theirs = JDP.shard_batches(graphs, np.arange(DP_GRAPHS), 4, 2, **kw)
    ours, theirs = list(ours), list(theirs)
    assert len(ours) == len(theirs) == DP_GRAPHS // 8
    for a, b in zip(ours, theirs):
        for f in ("node_feat", "node_mask", "n_nodes", "senders",
                  "receivers", "edge_mask", "edge_weight", "labels",
                  "graph_mask", "dense_adj", "edges_sorted"):
            got, want = getattr(a, f), getattr(b, f)
            if want is None:
                assert got is None, f
            else:
                assert np.asarray(got).dtype == np.asarray(want).dtype, f
                np.testing.assert_array_equal(got, want, err_msg=f)
    assert isinstance(theirs[0], JBatch)
    assert (ours[0].dense_adj is not None) == (kind == "dense_plan")


def jax_dp_reference(runs, world, plan):
    """(loss, gradient as a state_dict, params after DP_STEPS steps as a
    state_dict) of the JAX DP step on a (world,) "data" mesh, the gradient
    by jax.grad of the global loss over the shards."""
    model = jax_dp_model()
    batch = stacked(runs["graphs"], world, runs["max_nodes"],
                    runs["max_edges"], plan, package=JDP)
    batch = jax.tree_util.tree_map(jnp.asarray, batch)
    params = jax.tree_util.tree_map(jnp.asarray, runs["params"])

    def global_loss(p):
        total = count = 0.0
        for d in range(world):
            b = jax.tree_util.tree_map(lambda t: t[d], batch)
            out = model.apply({"params": p}, b.node_feat, b.node_mask,
                              b.n_nodes, b.senders, b.receivers, None,
                              b.edge_mask, train=False,
                              indices_are_sorted=b.edges_sorted,
                              dense_adj=b.dense_adj)[:, 0]
            m = b.graph_mask.astype(out.dtype)
            total += jnp.sum(optax.sigmoid_binary_cross_entropy(
                out, b.labels) * m)
            count += jnp.sum(m)
        return total / jnp.maximum(count, 1.0)

    grads = jax.grad(global_loss)(params)
    tx = torch_adam(DP_LR, DP_WD)
    step = JDP.make_dp_train_step(model, jax_make_mesh((world,), ("data",)),
                                  tx, axis="data")
    p = jax.tree_util.tree_map(jnp.array, params)
    opt_state = tx.init(p)
    losses = []
    for i in range(DP_STEPS):
        p, opt_state, loss = step(p, opt_state, batch, jax.random.PRNGKey(i))
        losses.append(float(loss))
    return (np.array(losses), v2_state_dict_from_params(grads),
            v2_state_dict_from_params(p))


@pytest.fixture(scope="module")
def dp_refs(runs):
    return {(w, plan): jax_dp_reference(runs, w, plan) for w in WORLDS
            for plan in DP_PLANS}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("plan", DP_PLANS)
def test_dp_step_loss_matches_jax(runs, dp_refs, world, plan):
    outs = ranks_of(runs, ("dp", world, plan))
    assert len(outs) == world
    assert all(o["plan"] == plan and not o["jax_loaded"] for o in outs)
    for o in outs:  # every rank returns the global mean
        np.testing.assert_allclose(o["losses"], dp_refs[world, plan][0],
                                   **TOL)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("plan", DP_PLANS)
def test_dp_step_summed_gradients_match_jax_grad(runs, dp_refs, world,
                                                 plan):
    want = dp_refs[world, plan][1]
    for o in ranks_of(runs, ("dp", world, plan)):
        assert set(o["grads"]) == set(want)
        for key, g in want.items():
            np.testing.assert_allclose(o["grads"][key], g, err_msg=key,
                                       **TOL)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("plan", DP_PLANS)
def test_dp_step_parameters_after_adam_steps_match_jax(runs, dp_refs, world,
                                                       plan):
    want = dp_refs[world, plan][2]
    for o in ranks_of(runs, ("dp", world, plan)):
        for key, p in want.items():
            np.testing.assert_allclose(o["params"][key], p, err_msg=key,
                                       **TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_dp_dense_plan_equals_the_edge_list(runs, world):
    edges = ranks_of(runs, ("dp", world, "edges"))[0]
    dense = ranks_of(runs, ("dp", world, "dense"))[0]
    np.testing.assert_allclose(dense["losses"], edges["losses"], **TOL)
    for key, p in edges["params"].items():
        np.testing.assert_allclose(dense["params"][key], p, err_msg=key,
                                   **TOL)
    for key, g in edges["grads"].items():
        np.testing.assert_allclose(dense["grads"][key], g, err_msg=key,
                                   **TOL)


def test_dp_training_learns(runs):
    losses = ranks_of(runs, "dp_fit")[0]["losses"]
    assert losses.shape == (LEARN_EPOCHS * LEARN_GRAPHS // LEARN_BATCH,)
    assert losses[-1] < losses[0] * 0.8, (losses[0], losses[-1])


def test_dp_dropout_streams_are_per_rank_and_reproducible(runs):
    outs = ranks_of(runs, "dp_dropout")
    assert len(outs) == 2
    for o in outs:
        assert o["reproducible"] and o["masks_differ"]
        assert np.isfinite(o["losses"]).all()


# -- tensor parallelism -------------------------------------------------------

def _axis(rank, size):
    return Mesh(group=None, rank=rank, size=size, backend="gloo",
                device="cpu")


def test_tp_param_specs_name_the_head_sharded_keys():
    x, ei, _, _ = tp_graph()
    sd = torch_state_dict_from_params(tp_params("simple-h4", x, ei))
    specs = TP.tp_param_specs(sd)
    sharded = {k for k, v in specs.items() if v == 0}
    assert sharded == {f"convs.{i}.W{p}.{w}" for i in range(LAYERS)
                       for p in "qkv" for w in ("weight", "bias")}
    assert all(v is None for k, v in specs.items() if k not in sharded)
    # the JAX specs shard the same modules (flax kernels on their dim 1)
    jspecs = JTP.tp_param_specs(tp_params("simple-h4", x, ei))
    assert jspecs["conv_0"]["Wq"]["kernel"] == P(None, "model")
    assert jspecs["conv_1"]["Wv"]["bias"] == P("model")
    assert jspecs["fc_in"]["kernel"] == P()


def test_tp_shard_params_cuts_each_head_block():
    x, ei, _, _ = tp_graph()
    sd = torch_state_dict_from_params(tp_params("simple-h8", x, ei))
    heads, width = 8, HIDDEN
    for size in (1, 2, 4, 8):
        cut = [TP.tp_shard_params(sd, _axis(m, size), num_heads=heads)
               for m in range(size)]
        for key, value in sd.items():
            if TP.tp_param_specs(sd)[key] == 0:
                rows = heads * width // size
                assert all(c[key].shape[0] == rows for c in cut), key
                np.testing.assert_array_equal(
                    np.concatenate([c[key] for c in cut]), value)
            else:
                assert all(c[key] is value for c in cut), key


def test_tp_rejects_a_model_axis_that_splits_a_head():
    # H = 2 heads of D = 4: 4 ranks divide H·D = 8 but not H. The JAX check
    # passes it (a documented deviation, ROADMAP.md queue C); the port
    # raises, as the JAX docstring's rule says
    jmodel = JDIFFormer(hidden_channels=4, out_channels=C, num_layers=1,
                        num_heads=2, dropout=0.0)
    x, ei, _, _ = tp_graph()
    jparams = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x),
                          jnp.asarray(ei[0], jnp.int32),
                          jnp.asarray(ei[1], jnp.int32),
                          train=False)["params"]
    sharded = JTP.tp_shard_params(jparams, jax_make_mesh((4,), ("model",)))
    assert not sharded["conv_0"]["Wq"]["kernel"].sharding \
        .is_fully_replicated
    sd = torch_state_dict_from_params(jax.tree_util.tree_map(np.asarray,
                                                             jparams))
    with pytest.raises(ValueError, match="does not divide num_heads=2"):
        TP.tp_shard_params(sd, _axis(0, 4), num_heads=2)


def jax_mesh(layout):
    if layout == "grid-2x2":
        return jax_make_mesh((2, 2), ("graph", "model")), "graph"
    return jax_make_mesh((int(layout[-1]),), ("model",)), None


def jax_nll(logits, labels, mask):
    logp = jax.nn.log_softmax(logits, axis=-1)
    ll = jnp.take_along_axis(logp, labels.reshape(-1, 1), axis=-1)[:, 0]
    m = mask.astype(logits.dtype)
    return -jnp.sum(ll * m), jnp.sum(m)


@pytest.fixture(scope="module")
def tp_refs(runs):
    """Per (model, layout): the JAX forward (tp_apply), and per model the
    single-device loss and gradient (jax.grad) and, per layout but for
    DIFFormer-a's, the losses and parameters after make_tp_train_step's
    TP_STEPS steps."""
    x, ei, y, mask = (jnp.asarray(a) for a in runs["graph"])
    s, r = (jnp.asarray(a, jnp.int32) for a in runs["graph"][1])
    y = y.astype(jnp.int32)
    out = {}
    for name in TP_MODELS:
        model = jax_tp_model(name)
        params = jax.tree_util.tree_map(jnp.asarray, runs["tp"][name])

        def objective(p):
            logits = model.apply({"params": p}, x, s, r, train=False)
            total, count = jax_nll(logits, y, mask)
            return total / count

        loss, grads = jax.value_and_grad(objective)(params)
        out[name] = dict(loss=float(loss),
                         grads=torch_state_dict_from_params(grads))
        for layout in TP_LAYOUTS:
            mesh, node_axis = jax_mesh(layout)
            fwd = JTP.tp_apply(model, mesh, node_axis=node_axis)(
                JTP.tp_shard_params(params, mesh), x, s, r)
            out[name, layout] = dict(logits=np.asarray(fwd))
            if TP_MODELS[name][0] == "sigmoid":
                continue
            tx = torch_adam(TP_LR, TP_WD)
            step = JTP.make_tp_train_step(model, mesh, tx, jax_nll,
                                          node_axis=node_axis)
            p = JTP.tp_shard_params(jax.tree_util.tree_map(jnp.array,
                                                           params), mesh)
            opt_state = tx.init(p)
            losses = []
            for i in range(TP_STEPS):
                p, opt_state, l_ = step(p, opt_state, x, s, r, y, mask,
                                        jax.random.PRNGKey(i))
                losses.append(float(l_))
            out[name, layout].update(
                losses=np.array(losses), params=torch_state_dict_from_params(
                    jax.tree_util.tree_map(np.asarray, p)))
    return out


def tp_whole(runs, outs, key, what):
    """The whole array of ``key`` from the ranks' ``what`` dicts: a
    head-sharded key's blocks in model-rank order (of graph rank 0), a
    replicated one rank 0's, held equal on every rank."""
    if key in outs[0]["sharded"]:
        blocks = sorted((o["model_rank"], o[what][key]) for o in outs
                        if o["graph_rank"] == 0)
        return np.concatenate([b for _, b in blocks])
    for o in outs[1:]:
        np.testing.assert_array_equal(o[what][key], outs[0][what][key],
                                      err_msg=key)
    return outs[0][what][key]


def tp_logits(runs, outs, layout, which):
    """The whole graph's logits of a layout's ranks: the model axis gives
    them on every rank; the grid's graph ranks give their shard's rows."""
    if layout != "grid-2x2":
        for o in outs[1:]:
            np.testing.assert_allclose(o[which], outs[0][which], **TOL)
        return outs[0][which]
    rows = np.concatenate([o[which] for o in sorted(
        (o for o in outs if o["model_rank"] == 0),
        key=lambda o: o["graph_rank"])])
    return rows[runs["sg"].node_mask.reshape(-1)]


@pytest.mark.parametrize("name", ["simple-h4", "sigmoid-h4"])
@pytest.mark.parametrize("layout", TP_LAYOUTS)
def test_tp_forward_matches_jax_tp_apply(runs, tp_refs, name, layout):
    outs = ranks_of(runs, ("tp", name, layout))
    assert len(outs) == (2 if layout == "model-2" else 4)
    assert not any(o["jax_loaded"] for o in outs)
    np.testing.assert_allclose(tp_logits(runs, outs, layout, "logits0"),
                               tp_refs[name, layout]["logits"], **TOL)


@pytest.mark.parametrize("name", ["simple-h4", "simple-h8"])
@pytest.mark.parametrize("layout", TP_LAYOUTS)
def test_tp_train_step_loss_matches_jax(runs, tp_refs, name, layout):
    outs = ranks_of(runs, ("tp", name, layout))
    ref = tp_refs[name, layout]["losses"]
    assert abs(ref[0] - tp_refs[name]["loss"]) < 1e-5
    for o in outs:
        np.testing.assert_allclose(o["losses"], ref, **TOL)


@pytest.mark.parametrize("name", ["simple-h4", "simple-h8"])
@pytest.mark.parametrize("layout", TP_LAYOUTS)
@pytest.mark.parametrize("part", ["sharded", "replicated"])
def test_tp_train_step_gradients_match_jax_grad(runs, tp_refs, name, layout,
                                                part):
    outs = ranks_of(runs, ("tp", name, layout))
    want = tp_refs[name]["grads"]
    keys = [k for k in want if (k in outs[0]["sharded"]) == (part ==
                                                             "sharded")]
    assert keys
    for key in keys:
        np.testing.assert_allclose(tp_whole(runs, outs, key, "grads"),
                                   want[key], err_msg=key, **TOL)


@pytest.mark.parametrize("name", ["simple-h4", "simple-h8"])
@pytest.mark.parametrize("layout", TP_LAYOUTS)
def test_tp_train_step_parameters_match_jax(runs, tp_refs, name, layout):
    outs = ranks_of(runs, ("tp", name, layout))
    want = tp_refs[name, layout]["params"]
    for key, p in want.items():
        np.testing.assert_allclose(tp_whole(runs, outs, key, "params"), p,
                                   err_msg=key, **TOL)


def test_tp_sigmoid_train_step_follows_jax_grad(runs, tp_refs):
    # DIFFormer-a's heads on K2-K4's plain versions, on every layout (the
    # grid's nodes on the ring): the first loss, and the gradient of both
    # parts
    want = tp_refs["sigmoid-h4"]["grads"]
    for layout in TP_LAYOUTS:
        outs = ranks_of(runs, ("tp", "sigmoid-h4", layout))
        np.testing.assert_allclose(outs[0]["losses"][0],
                                   tp_refs["sigmoid-h4"]["loss"], **TOL)
        for key in want:
            np.testing.assert_allclose(tp_whole(runs, outs, key, "grads"),
                                       want[key], err_msg=(layout, key),
                                       **TOL)


# -- native kNN ---------------------------------------------------------------

@pytest.mark.parametrize("include_self", [True, False])
@pytest.mark.parametrize("k", [5, 80])
def test_knn_neighbors_is_bit_equal_to_jax(include_self, k):
    rng = np.random.default_rng(k)
    x = rng.normal(size=(60, 3)).astype(np.float32)
    x[7] = x[3]  # an exact tie, broken by the lower index
    want = jax_native.knn_neighbors(x, k, include_self=include_self)
    got = native.knn_neighbors(x, k, include_self=include_self)
    assert got.dtype == want.dtype and got.shape == (60, min(k, 60))
    np.testing.assert_array_equal(got, want)
    if not include_self and k >= 60:  # self comes last
        np.testing.assert_array_equal(got[:, -1], np.arange(60))
