"""The port's MiniBatchTrainer (``train/minibatch.py``) against the JAX
package's, on the CPU: from carried weights at dropout 0, each epoch's loss,
the final parameters and the full-graph ``evaluate`` agree at rtol 2e-4 /
atol 2e-5 (tests/test_reference_exec.py:334) for NLL with accuracy and for
BCE with multi-task ROC-AUC, on both of the port's epoch paths, and ``fit``
picks the same best epoch with the same logged metrics.

The last chunk: at n = 250 and batch 100 the port trains a 50-node chunk
at its own size, which gives the JAX model's loss on the unpadded chunk and
on the chunk padded with ``node_mask`` and ``num_nodes_global``; the JAX
trainer's own padding, without those, gives another result (a deviation of
the JAX package from the reference that the port does not carry).

Also: the packed (capacity) plans hold the exact plans, ``use_scan=True``
equals ``use_scan=False`` bit for bit (dropout on), a chunk above the edge
capacity raises, and the label layouts are the JAX trainer's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difformer_tpu.data.splits import rand_train_test_idx
from difformer_tpu.data.synthetic import random_graph
from difformer_tpu.data.transforms import pad_edges, standard_preprocess
from difformer_tpu.nn.difformer import DIFFormer as JDIFFormer
from difformer_tpu.train.minibatch import MiniBatchTrainer as JTrainer
from difformer_tpu.train.trainer import LOSSES as JLOSSES
from difformer_tpu_torch import DIFFormer, native
from difformer_tpu_torch.kernels import spmm as K
from difformer_tpu_torch.train import minibatch as M
from difformer_tpu_torch.train.minibatch import MiniBatchTrainer
from difformer_tpu_torch.utils import weights as W
from torch_port_helpers import RowLog

TOL = dict(rtol=2e-4, atol=2e-5)
F, HIDDEN, EPOCHS = 10, 16, 3


def _data(task, n=300, seed=9):
    """(x, edges, labels, out_channels, trainer options) of a task: three
    classes with NLL and accuracy, or four binary tasks with BCE and
    ROC-AUC."""
    x, ei, y = random_graph(n, 5 * n, F, 3, seed=seed, homophily=0.85)
    ei = standard_preprocess(ei, n)
    if task == "nll":
        return x, ei, y, 3, dict(loss="nll", metric="acc")
    rng = np.random.default_rng(seed + 1)
    tasks = (rng.random((n, 4)) < 0.4).astype(np.float32)
    tasks[:, 0] = (y == 0)  # one task the features predict
    return x, ei, tasks, 4, dict(loss="bce", metric="rocauc")


def _pair(task, n=300, batch=100, dropout=0.0, use_scan=True, num_layers=2):
    x, ei, y, out, opts = _data(task, n)
    jt = JTrainer(JDIFFormer(hidden_channels=HIDDEN, out_channels=out,
                             num_layers=num_layers, dropout=dropout),
                  x, ei, y, batch_size=batch, lr=1e-2, use_scan=False,
                  **opts)
    params = jax.tree_util.tree_map(np.asarray, jt.init_state(0)[0])
    tm = DIFFormer(F, HIDDEN, out, num_layers=num_layers, dropout=dropout,
                   device="cpu")
    tt = MiniBatchTrainer(tm, x, ei, y, batch_size=batch, lr=1e-2,
                          use_scan=use_scan, device="cpu", **opts)
    split = rand_train_test_idx(np.asarray(y)[:, 0] if np.ndim(y) > 1 else y,
                                0.5, 0.25, rng=0)
    return jt, tt, params, split


def _jax_epochs(jt, params, epochs):
    """The JAX trainer's per-chunk loop from ``params``: each epoch's loss
    and the final parameters."""
    opt = jt.tx.init(params)
    rng_np, key = np.random.default_rng(jt.seed), jax.random.PRNGKey(777)
    bucket = jt._estimate_chunk_edges()
    losses = []
    for _ in range(epochs):
        params, opt, loss, key = jt._epoch(params, opt, rng_np, key, bucket)
        losses.append(loss)
    return losses, params


def _assert_params_match(model, jparams):
    got = W.params_from_torch_state_dict(model.state_dict())
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        value = got
        for key in path:
            value = value[key.key]
        np.testing.assert_allclose(value, np.asarray(leaf), **TOL,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("use_scan", [False, True])
@pytest.mark.parametrize("task", ["nll", "bce"])
def test_trajectory_matches_jax(task, use_scan):
    """n = 300, batch 100 (three full chunks), 3 epochs: every epoch's loss,
    the final weights and the full-graph evaluate."""
    jt, tt, params, split = _pair(task, use_scan=use_scan)
    assert tt.edge_capacity == jt._estimate_chunk_edges()
    want, jparams = _jax_epochs(jt, params, EPOCHS)
    best = tt.fit(split, epochs=EPOCHS, eval_step=100, init_params=params)[0]
    np.testing.assert_allclose(best["losses"], want, **TOL)
    assert [len(c) for c in best["chunk_losses"]] == [3] * EPOCHS
    _assert_params_match(tt.model, jparams)
    state = M.TrainState(tt.model, None)
    got, logits = tt.evaluate(state, split)
    ref, _ = jt.evaluate(jparams, split)
    assert logits is None  # the device metric: only scalars reach the host
    assert set(got) == set(ref) == {"train", "valid", "test"}
    for k in got:
        np.testing.assert_allclose(got[k], ref[k], **TOL, err_msg=k)


@pytest.mark.parametrize("task", ["nll", "bce"])
def test_fit_picks_the_same_best_epoch(task, monkeypatch, capsys):
    """``fit``'s schedule (evals at every eval_step-th epoch and the last),
    its logger rows and its best epoch, against the JAX fit from the same
    weights; verbose prints a line for each eval."""
    jt, tt, params, split = _pair(task)
    monkeypatch.setattr(jt, "init_state",
                        lambda run=0: (params, jt.tx.init(params)))
    logs = RowLog(), RowLog()
    jbest = jt.fit(split, epochs=7, eval_step=3, logger=logs[0])[0]
    tbest = tt.fit(split, epochs=7, eval_step=3, logger=logs[1],
                   init_params=params, verbose=True)[0]
    lines = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in lines] == [
        "run 0 epoch 0", "run 0 epoch 3", "run 0 epoch 6"]
    assert tbest["epoch"] == jbest["epoch"]
    np.testing.assert_allclose(np.asarray(logs[1].rows),
                               np.asarray(logs[0].rows), **TOL)
    for k in ("train", "valid", "test"):
        np.testing.assert_allclose(tbest[k], jbest[k], **TOL)
    tt.model.load_state_dict(tbest["params"])
    _assert_params_match(tt.model, jbest["params"])


# --- the last chunk -------------------------------------------------------------

def _last_chunk_case():
    """n = 250, batch 100: the JAX model, its weights, and the last chunk
    (50 nodes) of the first epoch's permutation with its induced
    subgraph."""
    n, bs = 250, 100
    x, ei, y, out, _ = _data("nll", n)
    jm = JDIFFormer(hidden_channels=HIDDEN, out_channels=out, num_layers=2,
                    dropout=0.0)
    jt = JTrainer(jm, x, ei, y, batch_size=bs, use_scan=False)
    params = jt.init_state(0)[0]
    perm = np.random.default_rng(123).permutation(n)
    nodes = perm[2 * bs:]
    sub = native.induced_subgraph(ei[0], ei[1], nodes, n)
    return x, ei, y, jm, params, nodes, sub


def _jax_logits(jm, params, x, nodes, sub, pad_to=None, masked=True):
    """The JAX model on the chunk ``nodes`` of the graph's features ``x``:
    unpadded, or padded to ``pad_to`` nodes with copies of node 0 and its
    edges to the trainer's bucket, with or without node_mask and
    num_nodes_global."""
    m = nodes.shape[0]
    kw, ei = {}, sub
    if pad_to is not None:
        nodes = np.concatenate([nodes, np.zeros(pad_to - m, np.int64)])
    x = x[nodes]
    if pad_to is not None:
        ei, _, em = pad_edges(sub, None, 768)  # as the JAX trainer pads
        kw = dict(edge_mask=jnp.asarray(em))
        if masked:
            kw.update(node_mask=jnp.asarray(np.arange(pad_to) < m),
                      num_nodes_global=m)
    out = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(ei[0]),
                   jnp.asarray(ei[1]), None, train=False, **kw)
    return np.asarray(out)[:m]


def test_last_chunk_matches_the_unpadded_and_the_masked_padded_chunk():
    """The port's train step on the 50-node last chunk (its packed plan at
    capacity): the logits and the loss of the JAX model on the unpadded
    chunk, and on the chunk padded to 100 with node_mask and
    num_nodes_global."""
    x, ei, y, jm, params, nodes, sub = _last_chunk_case()
    tm = DIFFormer(F, HIDDEN, 3, num_layers=2, dropout=0.0, device="cpu")
    tt = MiniBatchTrainer(tm, x, ei, y, batch_size=100, device="cpu")
    assert tt.last_size == 50 and tt.n_chunks == 3
    state = tt.init_state(0, jax.tree_util.tree_map(np.asarray, params))
    layout = tt.layouts[50]
    buf = np.zeros(layout.size, np.int32)
    M.pack_chunk(layout, buf, nodes, sub)
    plan = M.chunk_plan(layout, torch.from_numpy(buf))
    idx = torch.from_numpy(nodes)
    with torch.no_grad():
        state.model.eval()
        logits = state.model(tt.x_dev[idx], plan=plan).numpy()
    loss = tt.train_step(state, None, layout.views(torch.from_numpy(buf))[
        "nodes"], plan).item()
    labels = jnp.asarray(y[nodes], jnp.int32)
    for kw in (dict(), dict(pad_to=100)):
        want = _jax_logits(jm, params, x, nodes, sub, **kw)
        np.testing.assert_allclose(logits, want, **TOL, err_msg=str(kw))
        want_loss = JLOSSES["nll"](jnp.asarray(want), labels,
                                   jnp.ones(50, bool))
        np.testing.assert_allclose(loss, float(want_loss), **TOL)


def test_jax_trainers_unmasked_padding_differs():
    """The JAX trainer pads the last chunk with copies of node 0 and calls
    the model without node_mask and num_nodes_global
    (difformer_tpu/train/minibatch.py:93-123): the copies enter the global
    attention, and the real nodes' logits move far beyond any rounding."""
    x, _, _, jm, params, nodes, sub = _last_chunk_case()
    exact = _jax_logits(jm, params, x, nodes, sub)
    padded = _jax_logits(jm, params, x, nodes, sub, pad_to=100,
                         masked=False)
    assert np.abs(padded - exact).max() > 100 * TOL["atol"] + TOL[
        "rtol"] * np.abs(exact).max()


def test_uneven_chunks_train_as_the_jax_model_on_each_chunk():
    """n = 250, batch 100, one epoch: the port's chunk losses are the JAX
    model's losses, one Adam step after another, on the unpadded chunks
    (the last at 50 nodes)."""
    x, ei, y, jm, params, _, _ = _last_chunk_case()
    tm = DIFFormer(F, HIDDEN, 3, num_layers=2, dropout=0.0, device="cpu")
    tt = MiniBatchTrainer(tm, x, ei, y, batch_size=100, lr=1e-2,
                          device="cpu")
    got = tt.fit({"train": np.arange(250), "valid": np.arange(250),
                  "test": np.arange(250)}, epochs=1,
                 init_params=jax.tree_util.tree_map(np.asarray, params))[0]
    from difformer_tpu.train.optim import torch_adam

    tx = torch_adam(1e-2, 0.0)
    opt = tx.init(params)
    perm = np.random.default_rng(123).permutation(250)
    want = []
    for c in range(3):
        nodes = perm[c * 100:(c + 1) * 100]
        sub = native.induced_subgraph(ei[0], ei[1], nodes, 250)

        def loss_fn(p):
            out = jm.apply({"params": p}, jnp.asarray(x[nodes]),
                           jnp.asarray(sub[0]), jnp.asarray(sub[1]), None,
                           train=False)
            return JLOSSES["nll"](out, jnp.asarray(y[nodes], jnp.int32),
                                  jnp.ones(nodes.size, bool))

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt = tx.update(grads, opt, params)
        params = jax.tree_util.tree_map(lambda a, b: a + b, params, updates)
        want.append(float(loss))
    np.testing.assert_allclose(got["chunk_losses"][0], want, **TOL)


# --- the two epoch paths --------------------------------------------------------

@pytest.mark.parametrize("n,batch", [(300, 100), (250, 100), (250, 400)])
@pytest.mark.parametrize("task", ["nll", "bce"])
def test_scan_path_equals_loop_bit_for_bit(task, n, batch):
    """Packed plans at capacity in static buffers (``use_scan=True``)
    against exact plans (the loop), with dropout on: the same chunk
    losses, epoch losses, logged metrics and best epoch, bit for bit."""
    results = []
    for use_scan in (False, True):
        x, ei, y, out, opts = _data(task, n)
        tm = DIFFormer(F, HIDDEN, out, num_layers=2, dropout=0.3,
                       device="cpu")
        tt = MiniBatchTrainer(tm, x, ei, y, batch_size=batch,
                              use_scan=use_scan, device="cpu", **opts)
        log = RowLog()
        split = rand_train_test_idx(np.arange(n) % 3, 0.5, 0.25, rng=1)
        best = tt.fit(split, epochs=4, eval_step=2, logger=log)[0]
        results.append((best, log.rows, tt.plan_stats))
    (loop, loop_rows, loop_stats), (scan, scan_rows, scan_stats) = results
    assert scan["chunk_losses"] == loop["chunk_losses"]
    assert scan["losses"] == loop["losses"] and len(scan["losses"]) == 4
    assert scan_rows == loop_rows and scan["epoch"] == loop["epoch"]
    for a, b in zip(scan_stats, loop_stats):
        assert {k: a[k] for k in a if not k.endswith("_s")} == {
            k: b[k] for k in b if not k.endswith("_s")}


def test_packed_plan_holds_the_exact_plan(monkeypatch):
    """At a low split threshold (so chunks have heavy rows): the packed
    buffer's views give the chunk's exact CSRs in their first E entries,
    the host split schedule at capacity with its counts, and K1's product
    over it equals the exact plan's."""
    monkeypatch.setattr(K, "SPLIT_THRESHOLD", 4)
    monkeypatch.setattr(M, "SPLIT_THRESHOLD", 4)
    x, ei, y, out, opts = _data("nll", 300)
    tt = MiniBatchTrainer(DIFFormer(F, HIDDEN, out, device="cpu"), x, ei, y,
                          batch_size=100, device="cpu")
    perm = np.random.default_rng(3).permutation(300)
    packed, stats = tt.pack_epoch(perm)
    assert stats["heavy_chunks"] == 3 and stats["segments"] > 0
    subs = tt._subgraphs(perm)
    for (m, host), (nodes, sub) in zip(packed, subs):
        layout = tt.layouts[m]
        v = layout.views(host.numpy())
        np.testing.assert_array_equal(v["nodes"], nodes)
        exact, _ = tt._exact_plan(m, sub)
        plan = M.chunk_plan(layout, host.reshape(-1))
        e = sub.shape[1]
        for name in ("row_ptr", "t_row_ptr"):
            np.testing.assert_array_equal(getattr(plan, name),
                                          getattr(exact, name))
        for name in ("col", "val", "t_col", "t_val"):
            np.testing.assert_array_equal(getattr(plan, name)[:e],
                                          getattr(exact, name))
        for cap, ex in ((plan.split, exact.split),
                        (plan.t_split, exact.t_split)):
            heavy, segments = cap.counts.tolist()
            assert (heavy, segments) == (ex.num_heavy, ex.num_segments)
            assert (cap.num_heavy, cap.num_segments) == layout.capacity
            for a, b, k in zip(cap.tensors(), ex.tensors(),
                               (heavy, heavy + 1, segments, segments)):
                np.testing.assert_array_equal(a[:k], b)
        h = torch.randn(m, 5)
        for ptr, col, val, split in (
                (plan.row_ptr, plan.col, plan.val, plan.split),
                (plan.t_row_ptr, plan.t_col, plan.t_val, plan.t_split)):
            np.testing.assert_array_equal(
                K.csr_spmm(h, ptr, col, val, split=split),
                K.csr_spmm_plain(h, ptr, col[:int(ptr[-1])],
                                 val[:int(ptr[-1])]))


def test_chunk_above_the_edge_capacity_raises():
    x, ei, y, out, opts = _data("nll", 300)
    tt = MiniBatchTrainer(DIFFormer(F, HIDDEN, out, device="cpu"), x, ei, y,
                          batch_size=100, device="cpu")
    tt.edge_capacity = 10
    perm = np.random.default_rng(0).permutation(300)
    with pytest.raises(ValueError, match="exceeds bucket 10"):
        tt.pack_epoch(perm)
    with pytest.raises(ValueError, match="exceeds bucket 10"):
        tt._loop_epoch(tt.init_state(0), None, perm)


LABELS = {
    "1d": np.array([0, 2, 1, -1, 1]),
    "column": np.array([[1], [0], [2], [2], [0]]),
    "multilabel": np.array([[1, 0], [0, 1], [1, 1], [0, 0], [1, 0]]),
}


@pytest.mark.parametrize("loss", ["nll", "bce"])
@pytest.mark.parametrize("labels", sorted(LABELS))
def test_labels_are_the_jax_layout(loss, labels):
    """The JAX trainer's ``labels_train``: one-hot BCE targets for 1-D or
    single-column labels (a negative label marks class 0), float
    multilabel targets, int class ids from the first column."""
    labels = LABELS[labels]
    if loss == "nll" and labels.ndim > 1 and labels.shape[1] > 1:
        labels = labels[:, :1]
    x = np.zeros((labels.shape[0], 2), np.float32)
    ei = np.array([[0], [1]])
    jt = JTrainer(JDIFFormer(hidden_channels=4, out_channels=3,
                             num_layers=1), x, ei, labels, batch_size=2,
                  loss=loss)
    got = M.minibatch_labels(labels, loss)
    want = np.asarray(jt.labels_train)
    assert got.dtype == (np.int64 if loss == "nll" else np.float32)
    np.testing.assert_array_equal(got, want)


def test_negative_class_ids_train_as_the_jax_loss_reads_them():
    """A node without a label (-1) in a chunk: the JAX NLL reads it as the
    last class (take_along_axis from the end); the port's loss gives the
    same value, where a bare gather would fault."""
    tt = MiniBatchTrainer(DIFFormer(2, 4, 3, num_layers=1, device="cpu"),
                          np.zeros((4, 2), np.float32),
                          np.array([[0, 1], [1, 0]]), np.array([0, 1, -1, 2]),
                          batch_size=2, device="cpu")
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(4, 3)).astype(np.float32)
    labels = np.array([0, 1, -1, 2])
    mask = np.ones(4, bool)
    got = tt._loss(torch.from_numpy(logits), torch.from_numpy(labels),
                   torch.from_numpy(mask)).item()
    want = float(JLOSSES["nll"](jnp.asarray(logits), jnp.asarray(labels),
                                jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
