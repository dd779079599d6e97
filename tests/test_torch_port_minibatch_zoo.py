"""The baseline zoo in node chunks: the port's MiniBatchTrainer
(``train/minibatch.py``) with every zoo model but LINK against the JAX
package's models, on the CPU.

The reference is the JAX *model* run on each chunk's unpadded induced
subgraph, one ``torch_adam`` step after another (BatchNorm models with
``mutable=["batch_stats"]``), at dropout 0: n = 250, batch 100 (the last
chunk 50 nodes), hidden 8, 2 layers. The port's chunk losses, final
parameters, running statistics and full-graph metrics agree at rtol 2e-4 /
atol 2e-5 (tests/test_reference_exec.py:334). The JAX package's own
MiniBatchTrainer is not the reference: it applies ``{"params": p}`` alone,
so no BatchNorm model trains there, and it pads each chunk's edges with
0 → 0 edges that the zoo reads as real (no ``edge_mask``), so node 0's
degree, and the values of its row and column, change. The last two tests
show both faults; the port carries neither (ROADMAP.md queue C).

Also: the packed path (``use_scan=True``) against the loop bit for bit for
each plan kind (node dropout on; GAT's attention dropout off, as its masks
are drawn an edge at a time over the capacity or over the chunk's edges);
each host plan against its device counterpart bit for bit (``norm_plan``
with and without loops, ``gat_plan`` with its maps, incidences and
``dval_split``); GAT with the chunk's edges far below capacity, with NaN
planted where K1-dval's padded slots are left unwritten on the card; the
BCE/ROC-AUC layout with GCN; an init from flax params and
``batch_stats``; the best state's running statistics; LINK refused. The
JAX models take the port's drawn weights (``utils/weights.py``), built
once for the module, and each reference step is jitted, compiled once a
chunk shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difformer_tpu.data.synthetic import random_graph
from difformer_tpu.data.transforms import pad_edges, standard_preprocess
from difformer_tpu.nn import gnns as JZ
from difformer_tpu.train.minibatch import MiniBatchTrainer as JTrainer
from difformer_tpu.train.optim import torch_adam
from difformer_tpu.train.trainer import LOSSES as JLOSSES
from difformer_tpu.utils.metrics import METRICS as JMETRICS
from difformer_tpu_torch import native
from difformer_tpu_torch.kernels import spmm as K1
from difformer_tpu_torch.nn import gnns as Z
from difformer_tpu_torch.train import minibatch as M
from difformer_tpu_torch.train.minibatch import MiniBatchTrainer
from difformer_tpu_torch.utils import weights as W
from torch_port_helpers import RowLog

TOL = dict(rtol=2e-4, atol=2e-5)
N, BATCH, F, C, HIDDEN = 250, 100, 10, 3, 8
LR, WD = 1e-2, 5e-4

# (JAX model, port model) of every zoo method but LINK, dropout off
MODELS = {
    "mlp": (lambda: JZ.MLP(HIDDEN, C, dropout=0.0),
            lambda: Z.MLP(F, HIDDEN, C, dropout=0.0, device="cpu")),
    "gcn": (lambda: JZ.GCN(HIDDEN, C, dropout=0.0),
            lambda: Z.GCN(F, HIDDEN, C, dropout=0.0, device="cpu")),
    "gat": (lambda: JZ.GAT(HIDDEN, C, heads=2, dropout=0.0),
            lambda: Z.GAT(F, HIDDEN, C, heads=2, dropout=0.0, device="cpu")),
    "sgc": (lambda: JZ.SGC(out_channels=C, hops=2),
            lambda: Z.SGC(F, C, hops=2, device="cpu")),
    "mixhop": (lambda: JZ.MixHop(HIDDEN, C, hops=2, dropout=0.0),
               lambda: Z.MixHop(F, HIDDEN, C, hops=2, dropout=0.0,
                                device="cpu")),
    "gcnjk": (lambda: JZ.GCNJK(HIDDEN, C, jk_type="cat", dropout=0.0),
              lambda: Z.GCNJK(F, HIDDEN, C, jk_type="cat", dropout=0.0,
                              device="cpu")),
    "gatjk": (lambda: JZ.GATJK(HIDDEN, C, dropout=0.0),
              lambda: Z.GATJK(F, HIDDEN, C, dropout=0.0, device="cpu")),
    "h2gcn": (lambda: JZ.H2GCN(HIDDEN, C, dropout=0.0),
              lambda: Z.H2GCN(F, HIDDEN, C, dropout=0.0, device="cpu")),
    "appnp": (lambda: JZ.APPNPNet(HIDDEN, C, dropout=0.0),
              lambda: Z.APPNPNet(F, HIDDEN, C, dropout=0.0, device="cpu")),
    "gprgnn": (lambda: JZ.GPRGNN(HIDDEN, C, dropout=0.0, dprate=0.0),
               lambda: Z.GPRGNN(F, HIDDEN, C, dropout=0.0, dprate=0.0,
                                device="cpu")),
}
BN_MODELS = ("mlp", "gcn", "mixhop", "gcnjk", "gatjk")
# the models that read the JAX trainer's padded edges as real ones
PAD_READERS = ("sgc", "h2gcn", "appnp", "gprgnn")


@pytest.fixture(scope="module")
def data():
    x, ei, y = random_graph(N, 5 * N, F, C, seed=9, homophily=0.85)
    ei = standard_preprocess(ei, N)
    rng = np.random.default_rng(0)
    perm = rng.permutation(N)
    split = {"train": perm[:125], "valid": perm[125:190],
             "test": perm[190:]}
    return x, ei, y, split


def _moved(tree, seed):
    """Every leaf moved off its init by 0.05 to 0.1 each way (zero biases
    and unit scales would hide a misplaced leaf), and none near 0: a bias
    under a BatchNorm has a gradient of rounding noise, which Adam scales
    to a step of lr unless the decay (``WD`` · p) outweighs it."""
    rng = np.random.default_rng(seed)

    def move(a):
        step = rng.normal(0, 0.05, np.shape(a))
        return (np.asarray(a) + np.sign(step) * (0.05 + np.abs(step))
                ).astype(np.float32)

    return jax.tree_util.tree_map(move, tree)


@pytest.fixture(scope="module")
def jax_models():
    """Per model: the JAX module and its variables (numpy): the port
    model's drawn weights carried across by ``utils/weights.py`` and
    moved, running variances kept positive."""
    out = {}
    for i, (name, (make_jax, make_port)) in enumerate(sorted(MODELS.items())):
        params, stats = W.zoo_params_from_state_dict(
            make_port().state_dict())
        v = {"params": _moved(params, 50 + i)}
        if stats:
            v["batch_stats"] = jax.tree_util.tree_map(
                np.abs, _moved(stats, 80 + i))
        out[name] = (make_jax(), v)
    return out


def _reference_epoch(jm, v, x, ei, y, perm, loss="nll"):
    """One epoch of the JAX model on each unpadded chunk of ``perm``, one
    ``torch_adam`` step after another (a step jitted, compiled once a
    chunk shape): (chunk losses, variables)."""
    tx = torch_adam(LR, WD)

    @jax.jit
    def step(params, stats, opt, x, s, r, labels):
        def loss_fn(p):
            variables = {"params": p} if stats is None else {
                "params": p, "batch_stats": stats}
            out, upd = jm.apply(variables, x, s, r, None, train=True,
                                mutable=["batch_stats"])
            return JLOSSES[loss](out, labels, jnp.ones(x.shape[0], bool)), \
                upd

        (value, upd), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
        updates, opt = tx.update(grads, opt, params)
        params = jax.tree_util.tree_map(lambda a, b: a + b, params, updates)
        return params, upd.get("batch_stats"), opt, value

    params, stats = v["params"], v.get("batch_stats")
    opt = tx.init(params)
    losses = []
    for c in range(-(-N // BATCH)):
        nodes = perm[c * BATCH:(c + 1) * BATCH]
        sub = native.induced_subgraph(ei[0], ei[1], nodes, N)
        params, stats, opt, value = step(
            params, stats, opt, jnp.asarray(x[nodes]), jnp.asarray(sub[0]),
            jnp.asarray(sub[1]), jnp.asarray(y[nodes]))
        losses.append(float(value))
    out = {"params": params}
    if stats is not None:
        out["batch_stats"] = stats
    return losses, jax.tree_util.tree_map(np.asarray, out)


def _port_trainer(name, x, ei, y, **kw):
    return MiniBatchTrainer(MODELS[name][1](), x, ei, y, batch_size=BATCH,
                            lr=LR, weight_decay=WD, device="cpu", **kw)


def _assert_state_matches(model, variables):
    want = W.zoo_state_dict_from_params(variables["params"],
                                        variables.get("batch_stats"))
    got = model.state_dict()
    assert set(want) == set(got)
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), value, **TOL,
                                   err_msg=key)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_chunks_train_as_the_jax_model_on_each_chunk(data, jax_models,
                                                     name):
    """One epoch of three chunks (100, 100, 50 nodes) from the same
    weights: the chunk losses, the final parameters and running
    statistics, and the full graph's metrics in eval mode."""
    x, ei, y, split = data
    jm, v = jax_models[name]
    tt = _port_trainer(name, x, ei, y)
    assert tt.kind == MODELS[name][1]().chunk_plan_kind
    best = tt.fit(split, epochs=1, init_params=v["params"],
                  init_batch_stats=v.get("batch_stats"))[0]
    perm = np.random.default_rng(123).permutation(N)
    want, variables = _reference_epoch(jm, v, x, ei, y, perm)
    np.testing.assert_allclose(best["chunk_losses"][0], want, **TOL)
    _assert_state_matches(tt.model, variables)
    if name in BN_MODELS:
        assert any(k.endswith("running_mean") for k in
                   tt.model.state_dict())
    out = np.asarray(jm.apply(variables, jnp.asarray(x), jnp.asarray(ei[0]),
                              jnp.asarray(ei[1]), None, train=False))
    got, _ = tt.evaluate(M.TrainState(tt.model, None), split)
    for k, idx in split.items():
        np.testing.assert_allclose(got[k], JMETRICS["acc"](y[idx], out[idx]),
                                   **TOL, err_msg=k)


def test_bce_rocauc_layout_with_a_zoo_model(data, jax_models):
    """The ogbn-proteins route: four binary tasks, BCE on the float
    targets and multi-task ROC-AUC, with GCN."""
    x, ei, _, split = data
    rng = np.random.default_rng(4)
    tasks = (rng.random((N, C)) < 0.4).astype(np.float32)
    jm, v = jax_models["gcn"]
    tt = _port_trainer("gcn", x, ei, tasks, loss="bce", metric="rocauc")
    best = tt.fit(split, epochs=1, init_params=v["params"],
                  init_batch_stats=v["batch_stats"])[0]
    perm = np.random.default_rng(123).permutation(N)
    want, variables = _reference_epoch(jm, v, x, ei, tasks, perm,
                                       loss="bce")
    np.testing.assert_allclose(best["chunk_losses"][0], want, **TOL)
    _assert_state_matches(tt.model, variables)
    out = np.asarray(jm.apply(variables, jnp.asarray(x), jnp.asarray(ei[0]),
                              jnp.asarray(ei[1]), None, train=False))
    got, _ = tt.evaluate(M.TrainState(tt.model, None), split)
    for k, idx in split.items():
        np.testing.assert_allclose(
            got[k], JMETRICS["rocauc"](tasks[idx], out[idx]), **TOL,
            err_msg=k)


# --- the two epoch paths --------------------------------------------------------

# one model of each plan kind (GATJK: node dropout, no attention dropout)
KINDS = {None: "mlp", "norm": "mixhop", "norm_loops": "gcnjk",
         "gat": "gatjk"}


def _kind_model(kind, dropout):
    name = KINDS[kind]
    if name == "gatjk":
        return Z.GATJK(F, HIDDEN, C, dropout=dropout, device="cpu")
    return {"mlp": Z.MLP, "mixhop": Z.MixHop, "gcnjk": Z.GCNJK}[name](
        F, HIDDEN, C, dropout=dropout, device="cpu")


@pytest.mark.parametrize("kind", list(KINDS), ids=str)
def test_scan_path_equals_loop_bit_for_bit(data, kind):
    """Packed plans at capacity in static buffers against exact plans
    (the loop), node dropout on: the same chunk losses, logged metrics,
    best epoch, plan statistics and final running statistics."""
    x, ei, y, split = data
    results = []
    for use_scan in (False, True):
        tt = MiniBatchTrainer(_kind_model(kind, 0.3), x, ei, y,
                              batch_size=BATCH, use_scan=use_scan,
                              device="cpu")
        assert tt.kind == kind
        log = RowLog()
        best = tt.fit(split, epochs=3, eval_step=2, logger=log)[0]
        results.append((best, log.rows, tt.plan_stats,
                        {k: b.clone() for k, b in tt.model.named_buffers()}))
    (loop, loop_rows, loop_stats, loop_bufs), (scan, scan_rows, scan_stats,
                                               scan_bufs) = results
    assert scan["chunk_losses"] == loop["chunk_losses"]
    assert scan_rows == loop_rows and scan["epoch"] == loop["epoch"]
    for a, b in zip(scan_stats, loop_stats):
        assert {k: a[k] for k in a if not k.endswith("_s")} == {
            k: b[k] for k in b if not k.endswith("_s")}
    assert set(scan_bufs) == set(loop_bufs)
    for k in scan_bufs:
        assert torch.equal(scan_bufs[k], loop_bufs[k]), k
    for k in scan["params"]:
        assert torch.equal(scan["params"][k], loop["params"][k]), k


def test_best_state_carries_the_running_statistics(data):
    """The best epoch's state holds the BatchNorm statistics of that
    epoch: a fit whose best epoch is not its last against a fit stopped
    at the best epoch."""
    x, ei, y, split = data

    def fit(epochs):
        tt = MiniBatchTrainer(Z.GCN(F, HIDDEN, C, dropout=0.0, device="cpu"),
                              x, ei, y, batch_size=BATCH, lr=0.3,
                              device="cpu")
        return tt, tt.fit(split, epochs=epochs, eval_step=1)[0]

    tt, best = fit(8)
    assert best["epoch"] < 7
    assert not torch.equal(best["params"]["bn_0.running_mean"],
                           tt.model.state_dict()["bn_0.running_mean"])
    tt, _ = fit(best["epoch"] + 1)
    for k, value in tt.model.state_dict().items():
        assert torch.equal(best["params"][k], value), k


def test_init_takes_flax_params_and_batch_stats(data, jax_models):
    """``init_state(run, init_params, init_batch_stats)`` writes both, and
    a second init without statistics starts them fresh."""
    x, ei, y, _ = data
    _, v = jax_models["gcnjk"]
    tt = _port_trainer("gcnjk", x, ei, y)
    tt.init_state(0, v["params"], v["batch_stats"])
    _assert_state_matches(tt.model, v)
    tt.init_state(0, v["params"])
    assert torch.equal(tt.model.bn_0.running_var, torch.ones(HIDDEN))


def test_link_cannot_train_on_chunks(data):
    x, ei, y, _ = data
    with pytest.raises(ValueError, match="global node id"):
        MiniBatchTrainer(Z.LINK(N, C, device="cpu"), x, ei, y,
                         batch_size=BATCH, device="cpu")


# --- the host plans -------------------------------------------------------------

@pytest.fixture(scope="module")
def chunk(data):
    """The first chunk of the trainer's first epoch: (nodes, subgraph)."""
    x, ei, _, _ = data
    perm = np.random.default_rng(123).permutation(N)
    nodes = perm[:BATCH]
    return nodes, native.induced_subgraph(ei[0], ei[1], nodes, N)


def _split_equal(got, want):
    for a, b in zip(got.tensors(), want.tensors()):
        assert torch.equal(a.int(), b.int())


@pytest.mark.parametrize("loops", [True, False])
def test_host_norm_plan_is_norm_plan(chunk, loops, monkeypatch):
    """``chunk_norm_csr`` with K1's schedules (at a low threshold, so that
    rows split) against ``norm_plan`` on the device, bit for bit."""
    monkeypatch.setattr(K1, "SPLIT_THRESHOLD", 4)
    monkeypatch.setattr(M, "SPLIT_THRESHOLD", 4)
    _, sub = chunk
    kind = "norm_loops" if loops else "norm"
    v = {k: torch.from_numpy(a) for k, a in
         M.exact_views(kind, sub[0], sub[1], BATCH).items()}
    got = M.views_plan(v, BATCH)
    want = Z.norm_plan(torch.from_numpy(sub[0]), torch.from_numpy(sub[1]),
                       BATCH, add_self_loops=loops)
    for f in ("row_ptr", "col", "val", "t_row_ptr", "t_col", "t_val"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert got.split.num_segments > 0
    _split_equal(got.split, want.split)
    _split_equal(got.t_split, want.t_split)


def test_host_gat_plan_is_gat_plan(chunk, monkeypatch):
    """``chunk_gat_csr`` with K1's and K1-dval's schedules (low thresholds)
    against ``gat_plan``: the CSRs, the edge maps, the incidences and the
    receivers, bit for bit; and the products over both agree exactly."""
    monkeypatch.setattr(K1, "SPLIT_THRESHOLD", 4)
    monkeypatch.setattr(M, "SPLIT_THRESHOLD", 4)
    monkeypatch.setattr(M, "DVAL_SPLIT_THRESHOLD", 2)
    monkeypatch.setattr(Z, "DVAL_SPLIT_THRESHOLD", 2)
    from difformer_tpu_torch.ops import graph_ops as G

    monkeypatch.setattr(G, "DVAL_SPLIT_THRESHOLD", 2)
    _, sub = chunk
    v = {k: torch.from_numpy(a) for k, a in
         M.exact_views("gat", sub[0], sub[1], BATCH).items()}
    got = Z.gat_plan_from_views(v, BATCH)
    want = Z.gat_plan(torch.from_numpy(sub[0]), torch.from_numpy(sub[1]),
                      BATCH)
    for f in ("row_ptr", "col", "val", "t_row_ptr", "t_col", "t_val"):
        assert torch.equal(getattr(got.plan, f), getattr(want.plan, f)), f
    for a, b in zip(got.plan.maps(), want.plan.maps()):
        assert torch.equal(a.long(), b.long())
    assert torch.equal(got.rows.long(), want.rows)
    for s in ("split", "t_split", "dval_split"):
        _split_equal(getattr(got.plan, s), getattr(want.plan, s))
    assert got.plan.dval_split.threshold == 2
    assert got.plan.dval_split.num_segments > 0
    for end in ("dst", "src"):
        for csr in ("edge_csr", "node_csr"):
            a, b = getattr(getattr(got, end), csr), getattr(
                getattr(want, end), csr)
            for t, u in zip(a[:3], b[:3]):
                assert torch.equal(t, u.to(t.dtype)), (end, csr)
            _split_equal(a[3], b[3])
    assert got.positions is None and got.padded() is None


def test_difformer_chunk_values_are_not_the_zoo_norm(chunk):
    """``chunk_csr``'s values (the reference's: 1/sqrt in double, rounded
    once) are not ``gcn_norm``'s without loops (a float square root and a
    float quotient, rounded twice), so the zoo's plan has an entry of its
    own."""
    _, sub = chunk
    difformer = native.chunk_csr(sub[0], sub[1], BATCH)
    zoo = native.chunk_norm_csr(sub[0], sub[1], BATCH, False)
    for a, b in zip(difformer[:2] + difformer[3:5], zoo[:2] + zoo[3:5]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(difformer[2], zoo[2], rtol=1e-6)
    assert not np.array_equal(difformer[2], zoo[2])


@pytest.mark.parametrize("kind", ["norm", "norm_loops", "gat"])
def test_packed_plan_holds_the_exact_plan(data, kind):
    """A packed chunk (capacity twice the trainer's) holds the exact
    arrays in its first entries and each schedule with its counts."""
    x, ei, y, _ = data
    name = {"norm": "h2gcn", "norm_loops": "sgc", "gat": "gat"}[kind]
    tt = _port_trainer(name, x, ei, y)
    perm = np.random.default_rng(5).permutation(N)
    packed, _ = tt.pack_epoch(perm)
    for (m, host), (nodes, sub) in zip(packed, tt._subgraphs(perm)):
        v = tt.layouts[m].views(host.reshape(-1).numpy())
        exact = M.exact_views(kind, sub[0], sub[1], m)
        np.testing.assert_array_equal(v["nodes"], nodes)
        for k, a in exact.items():
            np.testing.assert_array_equal(v[k][:a.size], a, err_msg=k)
        counts = v["counts"].tolist()
        prefixes = ("", "t_", "d_") if kind == "gat" else ("", "t_")
        for i, p in enumerate(prefixes):
            assert counts[2 * i:2 * i + 2] == [exact[p + "rows"].size,
                                               exact[p + "seg_begin"].size]


def test_gat_padded_edges_are_inert(data, monkeypatch):
    """GAT (2 layers, BatchNorm, attention dropout 0) on a chunk whose
    edges fill a quarter of its capacity: the packed step gives the loop's
    loss, gradients and updated statistics bit for bit, with NaN planted
    in K1-dval's padded slots (on the card they are left unwritten)."""
    x, ei, y, _ = data
    plain = K1.csr_spmm_dval

    def planted(dout, xx, rows, col, *, row_ptr=None, **kw):
        out = plain(dout, xx, rows, col, row_ptr=row_ptr, **kw)
        out[int(row_ptr[-1]):] = float("nan")
        return out

    monkeypatch.setattr(K1, "csr_spmm_dval", planted)
    model = Z.GAT(F, HIDDEN, C, heads=2, dropout=0.0, use_bn=True,
                  device="cpu")
    tt = MiniBatchTrainer(model, x, ei, y, batch_size=BATCH, device="cpu")
    perm = np.random.default_rng(2).permutation(N)
    nodes, sub = tt._subgraphs(perm)[0]
    layout = M.ChunkLayout(BATCH, 4 * (sub.shape[1] + BATCH), "gat")
    buf = np.zeros(layout.size, np.int32)
    M.pack_chunk(layout, buf, nodes, sub)
    packed = M.chunk_plan(layout, torch.from_numpy(buf))
    assert packed.padded().sum() == 3 * (sub.shape[1] + BATCH)
    exact, _ = tt._exact_plan(BATCH, sub)
    idx = torch.from_numpy(nodes)
    results = []
    for plan in (exact, packed):
        state = tt.init_state(0)
        tt.model.train()
        tt.model.zero_grad()
        out = tt.model(tt.x_dev[idx], plan=plan)
        loss = tt._loss(out, tt.labels_dev[idx], tt._ones[BATCH])
        loss.backward()
        results.append((loss.detach(), {k: p.grad.clone() for k, p in
                                        state.model.named_parameters()},
                        {k: b.clone() for k, b in
                         state.model.named_buffers()}))
    (l0, g0, b0), (l1, g1, b1) = results
    assert torch.equal(l0, l1)
    for k in g0:
        assert torch.isfinite(g1[k]).all() and torch.equal(g0[k], g1[k]), k
    for k in b0:
        assert torch.equal(b0[k], b1[k]), k


# --- the JAX trainer's faults, which the port does not carry --------------------

def _jax_trainer(jm, data):
    x, ei, y, _ = data
    return JTrainer(jm, x, ei, y, batch_size=BATCH, use_scan=False)


@pytest.mark.parametrize("name", PAD_READERS)
def test_jax_trainers_padded_edges_move_node_0(data, jax_models, name):
    """The JAX trainer's chunk (edges padded with 0 → 0 to its bucket, the
    mask unread) against the unpadded chunk: node 0's logits differ
    beyond the tolerance; the port's packed chunk gives the unpadded
    logits."""
    x, ei, y, _ = data
    jm, v = jax_models[name]
    jt = _jax_trainer(jm, data)
    perm = np.random.default_rng(123).permutation(N)
    nodes = perm[:BATCH]
    sub = native.induced_subgraph(ei[0], ei[1], nodes, N)
    padded, _, em = pad_edges(sub, None, jt._estimate_chunk_edges())
    assert not em.all()

    def logits(edges, **kw):
        return np.asarray(jm.apply(v, jnp.asarray(x[nodes]),
                                   jnp.asarray(edges[0]),
                                   jnp.asarray(edges[1]), None, train=False,
                                   **kw))

    exact = logits(sub)
    theirs = np.asarray(jt._fwd_impl(v["params"], jnp.asarray(x[nodes]),
                                     jnp.asarray(padded[0]),
                                     jnp.asarray(padded[1]), jnp.asarray(em)))
    gap = np.abs(theirs[0] - exact[0]).max()
    assert gap > 100 * TOL["atol"] + TOL["rtol"] * np.abs(exact[0]).max()
    tt = _port_trainer(name, x, ei, y)
    tt.init_state(0, v["params"])
    layout = tt.layouts[BATCH]
    buf = np.zeros(layout.size, np.int32)
    M.pack_chunk(layout, buf, nodes, sub)
    tt.model.eval()
    with torch.no_grad():
        ours = tt.model(tt.x_dev[torch.from_numpy(nodes)],
                        plan=M.chunk_plan(layout, torch.from_numpy(buf))
                        ).numpy()
    np.testing.assert_allclose(ours, exact, **TOL)


@pytest.mark.parametrize("name", BN_MODELS)
def test_jax_trainer_cannot_train_batchnorm_models(data, jax_models, name):
    """The JAX trainer's step applies ``{"params": p}`` alone: a model with
    a ``batch_stats`` collection raises there (the port's trains, above)."""
    jm, v = jax_models[name]
    x, ei, y, _ = data
    jt = _jax_trainer(jm, data)
    nodes = np.arange(BATCH)
    sub = native.induced_subgraph(ei[0], ei[1], nodes, N)
    with pytest.raises(Exception, match="batch_stats"):
        jt._step_impl(v["params"], jt.tx.init(v["params"]),
                      jnp.asarray(x[nodes]), jnp.asarray(sub[0]),
                      jnp.asarray(sub[1]), jnp.ones(sub.shape[1], bool),
                      jnp.asarray(y[nodes]), jnp.ones(BATCH, bool),
                      jax.random.PRNGKey(0))
