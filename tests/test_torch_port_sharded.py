"""The port's node-sharded DIFFormer-s (difformer_tpu_torch/parallel/)
against the JAX package's ``shard_map`` runs, on the CPU.

The port's ranks are 2 and 4 gloo processes started once per world size
by ``launch.run_ranks`` (``parallel/rank_checks.py:run_checks``, which
takes numpy inputs, so a rank never imports this module or JAX); the JAX
package runs ``shard_map`` over the first 2 or 4 of the conftest's virtual
CPU devices, as tests/test_sharded.py does, on the same partition (the
two packages' partitions are bit-equal, tests/test_torch_port_partition.py)
and the same numpy inputs. Held within rtol 2e-4 / atol 2e-5, the port's
parity rule:

- ``gcn_conv_sharded``, ``gcn_conv_halo`` and ``gcn_conv_halo_overlap``
  and their gradients with respect to x, on K1's plain version, also with
  a NaN in node 0's row (which every shard's edge padding reads, with
  value 0), which must spread as in the JAX package;
- the sharded ``simple_attention``, its head-mean form and
  ``simple_attention_head_mean_factored``, and their gradients;
- ``sharded_apply``'s logits, also against the port's own unsharded model
  on the same weights;
- ``make_sharded_train_step``'s losses and parameters after 3 Adam steps
  with dropout off, for ``dryrun_multichip``'s flavours 1 (all-gather),
  2 (halo) and 2b (the locality layout, spmm_first at 2 heads), and the
  overlapped halo;
- the same step at dropout 0.5 on 2 ranks, over several seeds, held to the
  JAX step's distribution of losses (the two draw their masks from
  different generators, so no step can match), with each rank's dropout
  stream reproducible from (seed, rank) and the ranks' masks different;
- the ring (``comm.ring_shift``, against ``np.roll``, and its gradient);
  the ring sigmoid attention and its q, k and v gradients against the JAX
  ``sigmoid_attention_sharded``, with and without a key mask, within rtol
  1e-4 / atol 1e-5 (gradients 2e-4 / 2e-5, tests/test_sharded.py's);
- ``bsr_spmm_sharded`` of the node-sharded block-sparse hybrid and its
  gradient against the JAX package's, int8 counts and value blocks on
  tests/test_bsr.py's clustered graph (rtol 1e-4 / atol 1e-5), and with a
  NaN in x, which must spread as it does there;
- the train step of DIFFormer-a on the ring, of DIFFormer-s on the hybrid
  (``ell=``, the rank's ``BsrShard`` pair) and of both at once, against
  the JAX ``make_sharded_train_step``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from difformer_tpu.nn import DIFFormer as JDIFFormer
from difformer_tpu.ops import bsr as JB
from difformer_tpu.ops import linear_attention as jla
from difformer_tpu.parallel import make_mesh as jax_make_mesh
from difformer_tpu.parallel import partition as JP
from difformer_tpu.parallel import sharded_ops as jso
from difformer_tpu.parallel.api import (_senders_and_halo,
                                        make_sharded_train_step,
                                        sharded_apply)
from difformer_tpu.train.optim import torch_adam
from difformer_tpu_torch import DIFFormer
from difformer_tpu_torch.data import random_graph, standard_preprocess
from difformer_tpu_torch.ops import bsr as B
from difformer_tpu_torch.parallel import partition as PP
from difformer_tpu_torch.parallel.launch import run_ranks
from difformer_tpu_torch.parallel.rank_checks import run_checks
from difformer_tpu_torch.utils import weights as W
import torch_port_helpers  # noqa: F401  (sets torch's threads)

TOL = dict(rtol=2e-4, atol=2e-5)
WORLDS = (2, 4)
N, E, F, C, HIDDEN, LAYERS = 96, 420, 8, 3, 16, 2
H, D, M = 2, 4, 4          # the ops' heads and widths
STEPS, LR, WD = 3, 1e-2, 5e-4
FLAVOURS = ("gather", "halo", "overlap", "locality")
# the dropout case: 2 ranks on the overlapped halo, DROP_SEEDS seeds of
# DROP_STEPS steps at dropout DROPOUT in each package; the packages' mean
# losses may differ by at most DROP_Z standard errors
DROPOUT, DROP_SEEDS, DROP_STEPS = 0.5, 128, 5
DROP_Z = 4.0
# the ring attention's tolerances (tests/test_sharded.py) and the hybrid's
# graph, tile and threshold (tests/test_bsr.py), its product BSR_W wide
RING_TOL, RING_GRAD_TOL = dict(rtol=1e-4, atol=1e-5), dict(rtol=2e-4,
                                                          atol=2e-5)
BSR_N, BSR_TILE, BSR_MIN_EDGES, BSR_W = 512, 32, 6, 16
# the hybrid under the train step: the model's graph at T = 16, a third of
# its tiles dense at 24 edges (the rest the residual); 4 ranks pad it
TRAIN_TILE, TRAIN_MIN_EDGES = 16, 24
# the train-step flavours of this slice: DIFFormer-a on the ring, -s on
# the hybrid, and both
SLICE_FLAVOURS = ("ring", "bsr", "ring-bsr")


def graph():
    x, ei, y = random_graph(N, E, F, C, seed=3)
    return x, standard_preprocess(ei, N), y


def partitions(package, world, x, ei, y, mask):
    """{flavour: the partition it runs on}, in ``package``
    (the port's or the JAX package's partition module)."""
    kw = dict(labels=y, label_mask=mask)
    halo = package.partition_graph(x, ei, world, build_halo=True, **kw)
    perm, n_loc = package.locality_layout(ei, N, world)
    return {
        "gather": package.partition_graph(x, ei, world, **kw),
        "halo": halo.without_overlap() if package is PP else halo.replace(
            **dict.fromkeys(("int_senders", "int_receivers", "int_value",
                             "bnd_senders", "bnd_receivers", "bnd_value"))),
        "overlap": halo,
        "locality": package.partition_graph(
            x, ei, world, build_halo=True, node_perm=perm,
            nodes_per_shard=n_loc, **kw),
    }, perm


def model_kw(flavour):
    heads = 2 if flavour == "locality" else 1
    kw = dict(in_channels=F, hidden_channels=HIDDEN, out_channels=C,
              num_layers=LAYERS, num_heads=heads, dropout=0.0,
              spmm_first=flavour == "locality")
    if flavour.startswith("ring"):
        kw["kernel"] = "sigmoid"
    return kw


def bsr_graph():
    from test_bsr import _clustered

    return _clustered(BSR_N, 64, p_in=0.25, n_cross=300)


def slice_partition(package, flavour, world, x, ei, y, mask):
    """The partition of a train-step flavour of this slice: the all-gather
    one for the ring, uniform TRAIN_TILE-aligned shards for the hybrid."""
    kw = dict(labels=y, label_mask=mask)
    if "bsr" in flavour:
        kw.update(build_halo=False, node_align=TRAIN_TILE)
    return package.partition_graph(x, ei, world, **kw)


def train_layout(package, flavour, world, ei):
    """The hybrid of a train-step flavour in ``package`` (None for the
    ring alone)."""
    if "bsr" not in flavour:
        return None
    fwd, rev, _ = package.build_bsr_gcn_sharded(
        ei[0], ei[1], N, world, tile=TRAIN_TILE, min_edges=TRAIN_MIN_EDGES)
    return fwd, rev


def jax_params(kw, x, ei):
    init = JDIFFormer(hidden_channels=HIDDEN, out_channels=C,
                      num_layers=LAYERS, num_heads=kw["num_heads"],
                      dropout=0.0)
    return jax.tree_util.tree_map(np.asarray, init.init(
        jax.random.PRNGKey(kw["num_heads"]), jnp.asarray(x),
        jnp.asarray(ei[0], jnp.int32), jnp.asarray(ei[1], jnp.int32),
        train=False)["params"])


def op_inputs(world, n_loc):
    rng = np.random.default_rng(world)
    rows = world * n_loc
    return dict(
        x=rng.normal(size=(rows, H, D)).astype(np.float32),
        cot=rng.normal(size=(rows, H, D)).astype(np.float32),
        x_nan=np.where((np.arange(rows) == 0)[:, None, None],
                       np.float32(np.nan),
                       rng.normal(size=(rows, H, D)).astype(np.float32)),
        q=rng.normal(size=(rows, H, M)).astype(np.float32),
        k=rng.normal(size=(rows, H, M)).astype(np.float32),
        v=rng.normal(size=(rows, H, D)).astype(np.float32),
        feat=rng.normal(size=(rows, F)).astype(np.float32),
        w=rng.normal(size=(F, H, D)).astype(np.float32),
        b=rng.normal(size=(H, D)).astype(np.float32),
        cot_mean=rng.normal(size=(rows, D)).astype(np.float32),
        ring_mask=(rng.random(rows) > 0.25).astype(np.float32),
    )


def bsr_inputs(world):
    """The hybrid's layouts (both packages, int8 counts and value blocks)
    and operands on ``world`` shards, x and its cotangent padded to
    pad_n (``x_nan``: a NaN in row 0)."""
    ei = bsr_graph()
    rng = np.random.default_rng(100 + world)
    out = {}
    for name, int8 in (("int8", "auto"), ("values", False)):
        kw = dict(tile=BSR_TILE, min_edges=BSR_MIN_EDGES, scaled_int8=int8)
        ours = B.build_bsr_gcn_sharded(ei[0], ei[1], BSR_N, world, **kw)
        out[name] = dict(ours=ours[:2], theirs=JB.build_bsr_gcn_sharded(
            ei[0], ei[1], BSR_N, world, **kw)[:2])
    pad_n = ours[2] * world
    x = np.zeros((pad_n, BSR_W), np.float32)
    x[:BSR_N] = rng.normal(size=(BSR_N, BSR_W))
    cot = np.zeros_like(x)
    cot[:BSR_N] = rng.normal(size=(BSR_N, BSR_W))
    x_nan = x.copy()
    x_nan[0, 0] = np.nan
    return dict(out, x=x, cot=cot, x_nan=x_nan, rows_per=ours[2])


@pytest.fixture(scope="module")
def runs():
    """Per world size: the inputs, the partitions of both packages and the
    port's results, from one spawn of the most ranks (the smaller world
    runs on its first ranks, ``run_checks``' "world")."""
    x, ei, y = graph()
    mask = np.zeros(N, bool)
    mask[: N // 2] = True
    out, every = {}, []
    params = {f: jax_params(model_kw(f), x, ei)
              for f in FLAVOURS + SLICE_FLAVOURS}
    for world in WORLDS:
        ours, perm = partitions(PP, world, x, ei, y, mask)
        theirs, _ = partitions(JP, world, x, ei, y, mask)
        n_loc = ours["gather"].nodes_per_shard
        ins = op_inputs(world, n_loc)
        key_mask = ours["gather"].node_mask.reshape(-1)
        cases = [dict(kind="conv", sg=ours[f], x=ins["x"], cot=ins["cot"])
                 for f in ("gather", "halo", "overlap")]
        att = dict(key_mask=key_mask, n_loc=n_loc)
        cases += [
            dict(kind="attention", form="plain", q=ins["q"], k=ins["k"],
                 v=ins["v"], cot=ins["cot"], **att),
            dict(kind="attention", form="head_mean", q=ins["q"],
                 k=ins["k"], v=ins["v"], cot=ins["cot_mean"], **att),
            dict(kind="attention", form="factored", q=ins["q"], k=ins["k"],
                 v=ins["feat"], w=ins["w"], b=ins["b"], cot=ins["cot_mean"],
                 **att),
        ]
        cases += [dict(kind="train", sg=ours[f], params=params[f],
                       model_kw=model_kw(f), steps=STEPS, lr=LR,
                       weight_decay=WD) for f in FLAVOURS]
        cases += [dict(kind="conv", sg=ours[f], x=ins["x_nan"],
                       cot=ins["cot"]) for f in ("gather", "halo", "overlap")]
        # this slice's cases, after the others (whose indices stay)
        index = {}

        def add(name, case):
            index[name] = len(cases)
            cases.append(case)

        add("shift", dict(kind="shift", x=ins["x"], cot=ins["cot"],
                          n_loc=n_loc))
        ring = dict(kind="ring", q=ins["q"], k=ins["k"], v=ins["v"],
                    cot=ins["cot"], n_loc=n_loc)
        add("ring", ring)
        add("ring-masked", dict(ring, key_mask=ins["ring_mask"]))
        bins = bsr_inputs(world)
        for name in ("int8", "values"):
            add(f"bsr-{name}", dict(kind="bsr", layout=bins[name]["ours"],
                                    x=bins["x"], cot=bins["cot"]))
        add("bsr-nan", dict(kind="bsr", layout=bins["int8"]["ours"],
                            x=bins["x_nan"], cot=bins["cot"]))
        slice_sg = {f: (slice_partition(PP, f, world, x, ei, y, mask),
                        slice_partition(JP, f, world, x, ei, y, mask))
                    for f in SLICE_FLAVOURS}
        for f in SLICE_FLAVOURS:
            add(f"train-{f}", dict(
                kind="train", sg=slice_sg[f][0], params=params[f],
                model_kw=model_kw(f), steps=STEPS, lr=LR, weight_decay=WD,
                ell=train_layout(B, f, world, ei)))
        every += [dict(case, world=world) for case in cases]
        out[world] = dict(ins=ins, ours=ours, theirs=theirs, perm=perm,
                          params=params, x=x, ei=ei, y=y, mask=mask,
                          n_loc=n_loc, cases=len(cases), index=index,
                          bsr=bins, slice_sg=slice_sg)
    # sharded dropout on 2 ranks, last
    drop = out[2]
    every.append(dict(kind="dropout", world=2, sg=drop["ours"]["overlap"],
                      params=params["overlap"],
                      model_kw=dict(model_kw("overlap"), dropout=DROPOUT),
                      seeds=list(range(DROP_SEEDS)), steps=DROP_STEPS, lr=LR,
                      weight_decay=WD))
    results = run_ranks(run_checks, max(WORLDS), "gloo", "cpu", every)
    first = 0
    for world in WORLDS:
        n = out[world]["cases"]
        out[world]["results"] = [r[first:first + n]
                                 for r in results[:world]]
        assert all(r[first:first + n] == [None] * n
                   for r in results[world:])
        first += n
    out["dropout"] = [r[first] for r in results[:2]]
    assert all(r[first] is None for r in results[2:])
    return out


def stacked(results, index, key):
    """The ranks' [N_loc, ...] results of case ``index`` as [S·N_loc, ...]."""
    return np.concatenate([r[index][key] for r in results])


def jax_mesh(world):
    return jax_make_mesh((world,), ("graph",))


def shard_specs(tree):
    return P() if tree is None else jax.tree_util.tree_map(
        lambda _: P("graph"), tree)


def jax_conv(sg, x, cot, world):
    senders, halo = _senders_and_halo(sg)
    shape = (world, -1) + x.shape[1:]

    def body(xs, snd, rcv, em, halo):
        xs, snd, rcv, em = xs[0], snd[0], rcv[0], em[0]
        if halo is not None:
            halo = jax.tree_util.tree_map(lambda t: t[0], halo)
        if isinstance(halo, dict):
            out = jso.gcn_conv_halo_overlap(xs, halo, axis_name="graph")
        elif halo is not None:
            send_idx, send_mask, edge_value = halo
            out = jso.gcn_conv_halo(xs, snd, rcv, edge_value, send_idx,
                                    send_mask, axis_name="graph")
        else:
            out = jso.gcn_conv_sharded(xs, snd, rcv, None, edge_mask=em,
                                       axis_name="graph")
        return out[None]

    f = jax.shard_map(body, mesh=jax_mesh(world),
                      in_specs=(P("graph"),) * 4 + (shard_specs(halo),),
                      out_specs=P("graph"))
    args = (senders, sg.receivers, sg.edge_mask, halo)
    xs = jnp.asarray(x.reshape(shape))
    cot = jnp.asarray(cot.reshape(shape))
    out, grad = jax.jit(lambda xs, *args: (f(xs, *args), jax.grad(
        lambda xs: jnp.sum(f(xs, *args) * cot))(xs)))(xs, *args)
    return np.asarray(out).reshape(x.shape), np.asarray(grad).reshape(
        x.shape)


def jax_attention(form, ins, key_mask, world):
    cot = ins["cot_mean"] if form != "plain" else ins["cot"]
    v = ins["feat"] if form == "factored" else ins["v"]

    def body(q, k, v, m, w, b):
        q, k, v, m = q[0], k[0], v[0], m[0]
        if form == "factored":
            out = jla.simple_attention_head_mean_factored(
                q, k, v, w, b, key_mask=m, axis_name="graph")
        else:
            out = jla.simple_attention(q, k, v, key_mask=m,
                                       axis_name="graph",
                                       head_mean=form == "head_mean")
        return out[None]

    f = jax.shard_map(body, mesh=jax_mesh(world),
                      in_specs=(P("graph"),) * 4 + (P(), P()),
                      out_specs=P("graph"))
    def split(a):
        return jnp.asarray(a.reshape((world, -1) + a.shape[1:]))

    args = [split(ins["q"]), split(ins["k"]), split(v),
            split(key_mask.astype(np.float32)), jnp.asarray(ins["w"]),
            jnp.asarray(ins["b"])]
    def loss(q, k, v, w, b):
        return jnp.sum(f(q, k, v, args[3], w, b) * split(cot))

    out, grads = jax.jit(lambda *a: (f(*a), jax.grad(
        loss, argnums=(0, 1, 2, 3, 4))(*a[:3], *a[4:])))(*args)
    out = np.asarray(out).reshape(cot.shape)
    grads = [np.asarray(g) for g in grads]
    return out, [g.reshape((-1,) + g.shape[2:]) for g in grads[:3]] + \
        grads[3:]


def jax_loss_fn(logits, labels, mask):
    logp = jax.nn.log_softmax(logits, axis=-1)
    ll = jnp.take_along_axis(
        logp, labels.reshape(-1, 1).astype(jnp.int32), axis=-1)[:, 0]
    m = mask.astype(logits.dtype)
    return -jnp.sum(ll * m), jnp.sum(m)


def jax_train(flavour, sg, params, world, ell=None):
    kw = model_kw(flavour)
    model = JDIFFormer(hidden_channels=HIDDEN, out_channels=C,
                       num_layers=LAYERS, num_heads=kw["num_heads"],
                       dropout=0.0, spmm_first=kw["spmm_first"],
                       kernel=kw.get("kernel", "simple"), axis_name="graph")
    mesh = jax_mesh(world)
    logits0 = np.asarray(jax.jit(sharded_apply(model, mesh, ell=ell))(
        params, sg))
    tx = torch_adam(LR, WD)
    step = make_sharded_train_step(model, mesh, tx, jax_loss_fn, ell=ell)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(params)
    losses = []
    for i in range(STEPS):
        params, opt_state, loss = step(params, opt_state, sg,
                                       jax.random.PRNGKey(i))
        losses.append(float(loss))
    return logits0.reshape(-1, C), np.array(losses), params


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("index,flavour", enumerate(("gather", "halo",
                                                     "overlap")))
def test_sharded_gcn_conv_and_its_gradient(runs, world, index, flavour):
    run = runs[world]
    ins = run["ins"]
    out, grad = jax_conv(run["theirs"][flavour], ins["x"], ins["cot"],
                         world)
    np.testing.assert_allclose(stacked(run["results"], index, "out"), out,
                               **TOL)
    np.testing.assert_allclose(stacked(run["results"], index, "grad"), grad,
                               **TOL)
    for r in run["results"]:  # the plain version counts no launch
        assert r[index]["launches"] == {"csr_spmm": 0,
                                        "csr_spmm_transposed": 0}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("index,flavour", [(10 + i, f) for i, f in
                                           enumerate(("gather", "halo",
                                                      "overlap"))])
def test_sharded_gcn_conv_spreads_a_nan_as_jax(runs, world, index, flavour):
    # the plans hold the padding's zero-valued entries, so NaN · 0 reaches
    # the rows that the JAX functions' padding reaches (equal_nan: the
    # NaNs must sit where the JAX package's do)
    run = runs[world]
    ins = run["ins"]
    out, grad = jax_conv(run["theirs"][flavour], ins["x_nan"], ins["cot"],
                         world)
    assert np.isnan(out).any()
    np.testing.assert_allclose(stacked(run["results"], index, "out"), out,
                               **TOL)
    np.testing.assert_allclose(stacked(run["results"], index, "grad"), grad,
                               **TOL)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("index,form", [(3, "plain"), (4, "head_mean"),
                                        (5, "factored")])
def test_sharded_linear_attention_and_its_gradients(runs, world, index,
                                                    form):
    run = runs[world]
    key_mask = run["ours"]["gather"].node_mask.reshape(-1)
    out, grads = jax_attention(form, run["ins"], key_mask, world)
    results = run["results"]
    np.testing.assert_allclose(stacked(results, index, "out"), out, **TOL)
    for name, want in zip(("dq", "dk", "dv"), grads[:3]):
        np.testing.assert_allclose(stacked(results, index, name), want,
                                   err_msg=name, **TOL)
    if form == "factored":
        # replicated w and b: the whole gradient is the ranks' parts summed
        for name, want in zip(("dw", "db"), grads[3:]):
            got = sum(r[index][name] for r in results)
            np.testing.assert_allclose(got, want, err_msg=name, **TOL)


def real_rows(run, flavour, stacked_rows):
    """The real nodes' rows of padded [S·N_loc, ...] results, in node
    order."""
    sg = run["ours"][flavour]
    if flavour == "locality":
        return stacked_rows[run["perm"]]
    return stacked_rows[sg.node_mask.reshape(-1)]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("index,flavour", [(6 + i, f)
                                           for i, f in enumerate(FLAVOURS)])
def test_sharded_apply_and_train_step(runs, world, index, flavour):
    run = runs[world]
    results = run["results"]
    logits0, losses, params = jax_train(flavour, run["theirs"][flavour],
                                        run["params"][flavour], world)
    ours0 = stacked(results, index, "logits0")
    np.testing.assert_allclose(ours0, logits0, **TOL)
    for r in results:
        np.testing.assert_allclose(r[index]["losses"], losses, **TOL)
        assert r[index]["jax_loaded"] is False
    want = W.torch_state_dict_from_params(
        jax.tree_util.tree_map(np.asarray, params))
    got = results[0][index]["params"]
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name,
                                   **TOL)

    # the port's sharded logits against its own unsharded model
    kw = dict(model_kw(flavour))
    model = DIFFormer(kw.pop("in_channels"), kw.pop("hidden_channels"),
                      kw.pop("out_channels"), device="cpu", **kw)
    W.load_params(model, run["params"][flavour])
    model.eval()
    with torch.no_grad():
        single = model(torch.from_numpy(run["x"]),
                       torch.from_numpy(run["ei"][0]),
                       torch.from_numpy(run["ei"][1])).numpy()
    np.testing.assert_allclose(real_rows(run, flavour, ours0), single,
                               **TOL)


def jax_dropout_losses(sg, params, world, seeds, steps):
    """[seeds, steps]: the JAX sharded step's losses at dropout DROPOUT
    from ``params``, seed s drawing its keys from PRNGKey(s)."""
    model = JDIFFormer(hidden_channels=HIDDEN, out_channels=C,
                       num_layers=LAYERS, num_heads=1, dropout=DROPOUT,
                       axis_name="graph")
    tx = torch_adam(LR, WD)
    step = make_sharded_train_step(model, jax_mesh(world), tx, jax_loss_fn)
    out = []
    for seed in seeds:
        p = jax.tree_util.tree_map(jnp.asarray, params)
        opt_state = tx.init(p)
        losses = []
        for key in jax.random.split(jax.random.PRNGKey(seed), steps):
            p, opt_state, loss = step(p, opt_state, sg, key)
            losses.append(float(loss))
        out.append(losses)
    return np.asarray(out)


def test_sharded_dropout_is_held_to_the_jax_distribution(runs):
    # The statistic: each seed's mean loss over its DROP_STEPS steps. The
    # two packages' means over the DROP_SEEDS seeds must lie within DROP_Z
    # standard errors of their difference (Welch's z), a distributional
    # comparison as tests/test_reference_convergence.py:173 makes. Readings
    # on the CPU at 128 seeds: z = 1.25 (a gap of 0.0062 on a mean of
    # 1.204, standard error 0.0050); with a mask not rescaled by 1 / (1 - p)
    # in the port's dropout, z = 24.4, and with p = 0.25 for 0.5, z = 16.0.
    run = runs[2]
    ours = runs["dropout"]
    losses = ours[0]["losses"]
    theirs = jax_dropout_losses(run["theirs"]["overlap"],
                                run["params"]["overlap"], 2,
                                range(DROP_SEEDS), DROP_STEPS)
    assert losses.shape == theirs.shape == (DROP_SEEDS, DROP_STEPS)
    per_t, per_j = losses.mean(1), theirs.mean(1)
    se = np.hypot(per_t.std(ddof=1), per_j.std(ddof=1)) / np.sqrt(DROP_SEEDS)
    z = abs(per_t.mean() - per_j.mean()) / se
    assert z <= DROP_Z, (per_t.mean(), per_j.mean(), se)
    # the masks act: the seeds differ, and every loss departs from the
    # dropout-free run's from the same weights
    assert per_t.std() > 0 and per_j.std() > 0
    plain = run["results"][0][6 + FLAVOURS.index("overlap")]["losses"]
    assert not np.allclose(losses[:, :STEPS], plain, rtol=1e-4)
    for r in ours:
        np.testing.assert_array_equal(r["losses"], losses)  # the same mean
        np.testing.assert_array_equal(r["again"], losses[0])  # reproducible
        assert r["reproducible"] and r["masks_differ"]
        assert 0.35 < r["kept"] < 0.65


@pytest.mark.parametrize("world", WORLDS)
def test_ring_shift_and_its_gradient(runs, world):
    # rank r receives rank r-1's rows; the gradient goes back to r-1
    run = runs[world]
    i, n_loc, ins = run["index"]["shift"], run["n_loc"], run["ins"]
    shards = lambda a: a.reshape((world, n_loc) + a.shape[1:])  # noqa: E731
    want = np.roll(shards(ins["x"]), 1, axis=0).reshape(ins["x"].shape)
    grad = np.roll(shards(ins["cot"]), -1, axis=0).reshape(ins["x"].shape)
    np.testing.assert_array_equal(stacked(run["results"], i, "out"), want)
    np.testing.assert_array_equal(stacked(run["results"], i, "grad"), grad)


def jax_ring(ins, world, masked):
    """The JAX ring sigmoid attention under ``shard_map``, and its q, k, v
    gradients of ``Σ out · cot``."""
    def body(q, k, v, m):
        return jso.sigmoid_attention_sharded(
            q[0], k[0], v[0], key_mask=m[0] if masked else None,
            axis_name="graph")[None]

    f = jax.shard_map(body, mesh=jax_mesh(world),
                      in_specs=(P("graph"),) * 4, out_specs=P("graph"))

    def split(a):
        return jnp.asarray(a.reshape((world, -1) + a.shape[1:]))

    q, k, v, m, cot = (split(ins[n]) for n in ("q", "k", "v", "ring_mask",
                                               "cot"))
    out, grads = jax.jit(lambda q, k, v: (f(q, k, v, m), jax.grad(
        lambda *a: jnp.sum(f(*a, m) * cot), argnums=(0, 1, 2))(q, k, v)))(
        q, k, v)
    return (np.asarray(out).reshape(ins["cot"].shape),
            [np.asarray(g).reshape((-1,) + g.shape[2:]) for g in grads])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("form", ["ring", "ring-masked"])
def test_ring_sigmoid_attention_and_its_gradients(runs, world, form):
    run = runs[world]
    i, results = run["index"][form], run["results"]
    out, grads = jax_ring(run["ins"], world, form == "ring-masked")
    np.testing.assert_allclose(stacked(results, i, "out"), out, **RING_TOL)
    for name, want in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(stacked(results, i, name), want,
                                   err_msg=name, **RING_GRAD_TOL)
    for r in results:  # the plain versions count no launch
        assert not any(r[i]["launches"].values())


def jax_bsr(layout, x, cot, world):
    """The JAX ``bsr_spmm_sharded`` under ``shard_map`` and its vjp."""
    def body(fwd, rev, xp, gp):
        sq = lambda t: jax.tree_util.tree_map(lambda a: a[0], t)  # noqa
        fwd, rev = sq(fwd), sq(rev)
        y, pull = jax.vjp(lambda v: JB.bsr_spmm_sharded(fwd, rev, v), xp)
        return y, pull(gp)[0]

    f = jax.shard_map(body, mesh=jax_mesh(world),
                      in_specs=(P("graph"),) * 4,
                      out_specs=(P("graph"), P("graph")))
    out, grad = jax.jit(f)(*layout, jnp.asarray(x), jnp.asarray(cot))
    return np.asarray(out), np.asarray(grad)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ["int8", "values", "nan"])
def test_sharded_hybrid_and_its_gradient(runs, world, case):
    run = runs[world]
    bins = run["bsr"]
    i, results = run["index"][f"bsr-{case}"], run["results"]
    layout = bins["values" if case == "values" else "int8"]["theirs"]
    x = bins["x_nan" if case == "nan" else "x"]
    out, grad = jax_bsr(layout, x, bins["cot"], world)
    if case == "nan":
        # the residual's padding (value 0 on point 0) and the zero blocks
        # that gather tile 0 carry the NaN of row 0 where the JAX package's
        # padding does
        assert np.isnan(out).any() and not np.isnan(out).all()
    np.testing.assert_allclose(stacked(results, i, "out"), out, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(stacked(results, i, "grad"), grad, rtol=1e-4,
                               atol=1e-5)
    for r in results:  # the plain versions count no launch
        assert not any(r[i]["launches"].values())


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("flavour", SLICE_FLAVOURS)
def test_ring_and_hybrid_train_step_matches_jax(runs, world, flavour):
    run = runs[world]
    i, results = run["index"][f"train-{flavour}"], run["results"]
    sg = run["slice_sg"][flavour][1]
    ell = train_layout(JB, flavour, world, run["ei"])
    if ell is not None:
        assert ell[0].blocks.any() and bool((ell[0].res_val != 0).any())
    logits0, losses, params = jax_train(flavour, sg, run["params"][flavour],
                                        world, ell=ell)
    np.testing.assert_allclose(stacked(results, i, "logits0"), logits0,
                               **TOL)
    want = W.torch_state_dict_from_params(
        jax.tree_util.tree_map(np.asarray, params))
    for r in results:
        np.testing.assert_allclose(r[i]["losses"], losses, **TOL)
        assert r[i]["jax_loaded"] is False and r[i]["products"] == (
            0 if ell is not None else 1)
    for name in want:
        np.testing.assert_allclose(results[0][i]["params"][name], want[name],
                                   err_msg=name, **TOL)


def test_unported_sharded_options_raise():
    # what was not ported before the ring and the hybrid now runs; what
    # stays refused is a whole-graph layout under axis_name, which would
    # multiply a rank's rows as if they were the graph, and a rank's shard
    # without the graph axis
    x, ei, _ = graph()
    args = (torch.from_numpy(x), torch.from_numpy(ei[0]),
            torch.from_numpy(ei[1]))
    ell = B.build_bsr_gcn(ei[0], ei[1], N, tile=16)
    with pytest.raises(TypeError, match="process group"):
        DIFFormer(F, HIDDEN, C, kernel="sigmoid", axis_name="graph",
                  device="cpu")
    model = DIFFormer(F, HIDDEN, C, device="cpu")
    model.convs[0].axis_name = object()  # a group, as far as the check goes
    with pytest.raises(ValueError, match="BsrShard pair"):
        model.convs[0](model.fcs[0](args[0]), model.fcs[0](args[0]),
                       *args[1:], ell=ell)
    shard = B.build_bsr_gcn_sharded(ei[0], ei[1], N, 2, tile=16)
    with pytest.raises(ValueError, match="needs a model built with"):
        DIFFormer(F, HIDDEN, C, device="cpu")(*args, ell=shard[:2])


def test_a_failed_rank_fails_the_caller():
    with pytest.raises(RuntimeError, match="ranks failed") as info:
        run_ranks(run_checks, 2, "gloo", "cpu", [dict(kind="nonesuch")])
    assert "KeyError" in str(info.value)


def test_nccl_with_more_ranks_than_cards_raises():
    with pytest.raises((ValueError, RuntimeError), match="card|CUDA"):
        run_ranks(run_checks, 2, "nccl", "cuda", [])
