"""The GCN branch's CSR SpMM (K1) in the port against the JAX package's
gather and segment_sum (``ops/graph_ops.py`` ``gcn_conv`` and ``spmm``).

The port runs on the CPU, where K1's wrapper runs its plain version over
the same two CSRs the kernel reads, so the plan, the transposed CSR of the
backward and the autograd Function are all checked here. Edges come
unsorted, with empty rows (nodes without in-edges or out-edges), and at
trailing widths 1, 65 (spmm_first's F+1) and [H, D]. Forward and the
gradient of x for a random cotangent agree to rtol 2e-4 / atol 2e-5
(tests/test_reference_exec.py:334).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difformer_tpu.ops import graph_ops as jops
from difformer_tpu_torch import GraphData
from difformer_tpu_torch.kernels import spmm as K
from difformer_tpu_torch.ops import graph_ops as tops
import torch_port_helpers  # noqa: F401  (sets torch's threads)

TOL = dict(rtol=2e-4, atol=2e-5)
N = 40
WIDTHS = [(1,), (65,), (3, 8)]


def _edges(seed, e=150, with_weight=False, with_mask=False):
    """Unsorted edges; nodes N-5.. receive nothing and N-3.. send nothing."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, N - 3, size=e).astype(np.int32)
    r = rng.integers(0, N - 5, size=e).astype(np.int32)
    w = (rng.uniform(0.2, 2.0, size=e).astype(np.float32) if with_weight
         else None)
    mask = (rng.random(e) > 0.25) if with_mask else None
    return s, r, w, mask


def _t(a):
    """numpy → torch, int32 indices widened to int64 as GraphData holds
    them."""
    if a is None:
        return None
    t = torch.from_numpy(np.asarray(a))
    return t.long() if t.dtype == torch.int32 else t


def _j(a):
    return None if a is None else jnp.asarray(a)


def _x(seed, trailing):
    return np.random.default_rng(seed).normal(
        size=(N,) + trailing).astype(np.float32)


def _check_vjp(jfn, tfn, x, seed):
    out_j, vjp = jax.vjp(jfn, jnp.asarray(x))
    cot = np.random.default_rng(seed).normal(size=out_j.shape).astype(
        np.float32)
    (dx_j,) = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_()
    out_t = tfn(xt)
    out_t.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), **TOL)


@pytest.mark.parametrize("trailing", WIDTHS)
@pytest.mark.parametrize("with_weight,with_mask",
                         [(False, False), (True, False), (False, True),
                          (True, True)])
def test_gcn_conv_matches_jax(trailing, with_weight, with_mask):
    s, r, w, mask = _edges(1, with_weight=with_weight, with_mask=with_mask)
    _check_vjp(
        lambda x: jops.gcn_conv(x, _j(s), _j(r), _j(w), edge_mask=_j(mask)),
        lambda x: tops.gcn_conv(x, _t(s), _t(r), _t(w), edge_mask=_t(mask)),
        _x(2, trailing), seed=3)


@pytest.mark.parametrize("trailing", WIDTHS)
def test_gcn_conv_with_a_plan_matches_jax(trailing):
    """A plan built once (as GraphData.csr_plan does) replaces the edges."""
    s, r, w, mask = _edges(4, with_weight=True, with_mask=True)
    plan = tops.build_csr_plan(_t(s), _t(r), N, _t(w), _t(mask))
    _check_vjp(
        lambda x: jops.gcn_conv(x, _j(s), _j(r), _j(w), edge_mask=_j(mask)),
        lambda x: tops.gcn_conv(x, None, None, plan=plan),
        _x(5, trailing), seed=6)


@pytest.mark.parametrize("swapped", [False, True])
@pytest.mark.parametrize("trailing", WIDTHS)
def test_spmm_matches_jax(trailing, swapped):
    """Either orientation of the same edges (callers such as LINK pass
    receivers as senders): spmm sorts whatever it is given."""
    s, r, _, _ = _edges(7)
    if swapped:
        s, r = r, s
    vals = np.random.default_rng(8).normal(size=s.shape).astype(np.float32)
    _check_vjp(lambda x: jops.spmm(_j(vals), _j(s), _j(r), x),
               lambda x: tops.spmm(_t(vals), _t(s), _t(r), x),
               _x(9, trailing), seed=10)


def test_spmm_values_get_no_gradient():
    """Values get no gradient unless they require one; then they get the
    value gradient Σ_c dout[r, c]·x[s, c] of each edge (JAX differentiates
    spmm's values; held against jax.grad in test_torch_port_zoo.py)."""
    s, r, _, _ = _edges(11)
    x = torch.randn(N, 4, requires_grad=True)
    data = torch.rand(s.shape[0])
    tops.spmm(data, _t(s), _t(r), x).sum().backward()
    assert data.grad is None and x.grad is not None
    vals = data.clone().requires_grad_()
    tops.spmm(vals, _t(s), _t(r), x).sum().backward()
    want = x.detach()[_t(s).long()].sum(-1)   # dout is all ones
    torch.testing.assert_close(vals.grad, want)


@pytest.mark.parametrize("fn", ["gcn_conv", "spmm"])
def test_zero_edges_give_zeros(fn):
    empty = np.zeros(0, np.int32)
    x = _x(12, (3, 4))
    if fn == "gcn_conv":
        ref = jops.gcn_conv(jnp.asarray(x), _j(empty), _j(empty))
        call = lambda xt: tops.gcn_conv(xt, _t(empty), _t(empty))
    else:
        vals = np.zeros(0, np.float32)
        ref = jops.spmm(_j(vals), _j(empty), _j(empty), jnp.asarray(x))
        call = lambda xt: tops.spmm(_t(vals), _t(empty), _t(empty), xt)
    xt = torch.from_numpy(x).requires_grad_()
    out = call(xt)
    out.sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    assert not out.detach().any() and not xt.grad.any()


@pytest.mark.parametrize("chunk", [1, 7, 64, 1000])
def test_edge_chunk_size_matches_jax_and_unchunked(chunk):
    s, r, w, mask = _edges(13, with_weight=True, with_mask=True)
    x = _x(14, (2, 5))
    _check_vjp(
        lambda x: jops.gcn_conv(x, _j(s), _j(r), _j(w), edge_mask=_j(mask),
                                edge_chunk_size=chunk),
        lambda x: tops.gcn_conv(x, _t(s), _t(r), _t(w), edge_mask=_t(mask),
                                edge_chunk_size=chunk),
        x, seed=15)
    xt = torch.from_numpy(x)
    whole = tops.gcn_conv(xt, _t(s), _t(r), _t(w), edge_mask=_t(mask))
    torch.testing.assert_close(
        tops.gcn_conv(xt, _t(s), _t(r), _t(w), edge_mask=_t(mask),
                      edge_chunk_size=chunk), whole, rtol=1e-6, atol=1e-7)


def test_plan_holds_both_csrs():
    """row_ptr/col are the receivers' CSR of the edges, t_row_ptr/t_col
    the senders' (the transpose), each in stable order, with the GCN
    values permuted alike."""
    s, r, w, mask = _edges(16, with_weight=True, with_mask=True)
    plan = tops.build_csr_plan(_t(s), _t(r), N, _t(w), _t(mask))
    value = tops.gcn_norm_weights_masked(_t(s), _t(r), N, _t(w), _t(mask))
    for ptr, col, val, rows, cols in (
            (plan.row_ptr, plan.col, plan.val, r, s),
            (plan.t_row_ptr, plan.t_col, plan.t_val, s, r)):
        assert ptr.dtype == col.dtype == torch.int32
        want = np.argsort(rows, kind="stable")
        np.testing.assert_array_equal(col.numpy(), cols[want])
        np.testing.assert_array_equal(val.numpy(), value.numpy()[want])
        np.testing.assert_array_equal(
            np.diff(ptr.numpy()), np.bincount(rows, minlength=N))
    assert plan.num_edges == s.shape[0] and plan.num_nodes == N


def test_plan_checks_indices():
    s, r, _, _ = _edges(17)
    with pytest.raises(ValueError, match="lie in"):
        tops.build_csr_plan(_t(s), _t(r), N - 10)
    with pytest.raises(ValueError, match=r"\[E\]"):
        tops.build_csr_plan(_t(s), _t(r)[:-1], N)


def test_graph_data_keeps_its_plan():
    s, r, w, _ = _edges(18, with_weight=True)
    g = GraphData.from_numpy(np.zeros((N, 3), np.float32), np.stack([s, r]),
                             w, device="cpu")
    plan = g.csr_plan()
    assert g.csr_plan() is plan
    moved = g.to("cpu")
    assert moved.csr_plan() is not plan
    torch.testing.assert_close(moved.csr_plan().val, plan.val)


@pytest.mark.parametrize("field", ["edge_mask", "edge_weight", "senders"])
def test_graph_data_drops_its_plan_when_the_edges_change(field):
    s, r, w, mask = _edges(23, with_weight=True, with_mask=True)
    g = GraphData.from_numpy(np.zeros((N, 3), np.float32), np.stack([s, r]),
                             w, device="cpu")
    plan = g.csr_plan()
    new = {"edge_mask": torch.from_numpy(mask),
           "edge_weight": g.edge_weight * 2.0,
           "senders": g.senders.flip(0)}[field]
    setattr(g, field, new)
    fresh = g.csr_plan()
    assert fresh is not plan
    want = tops.build_csr_plan(g.senders, g.receivers, N, g.edge_weight,
                               g.edge_mask)
    for name in ("col", "val", "t_col", "t_val"):
        torch.testing.assert_close(getattr(fresh, name), getattr(want, name))
    assert not torch.equal(fresh.val, plan.val)


def test_plain_version_is_the_dense_product():
    s, r, _, _ = _edges(19)
    vals = np.random.default_rng(20).normal(size=s.shape).astype(np.float32)
    dense = np.zeros((N, N), np.float32)
    np.add.at(dense, (r, s), vals)
    x = _x(21, (6,))
    plan = tops.build_csr_plan(_t(s), _t(r), N)
    for ptr, col, rows, a in ((plan.row_ptr, plan.col, r, dense),
                              (plan.t_row_ptr, plan.t_col, s, dense.T)):
        order = np.argsort(rows, kind="stable")
        out = K.csr_spmm_plain(torch.from_numpy(x), ptr, col,
                               torch.from_numpy(vals[order]))
        np.testing.assert_allclose(out.numpy(), a @ x, rtol=1e-5, atol=1e-5)


def test_wrapper_checks_and_counts_no_launch_on_the_cpu():
    s, r, _, _ = _edges(22)
    plan = tops.build_csr_plan(_t(s), _t(r), N)
    x = torch.randn(N, 4)
    K.reset_launch_counts()
    K.csr_spmm(x, plan.row_ptr, plan.col, plan.val)
    assert K.LAUNCHES == {"csr_spmm": 0, "csr_spmm_transposed": 0}
    with pytest.raises(TypeError, match="float32"):
        K.csr_spmm(x.double(), plan.row_ptr, plan.col, plan.val)
    with pytest.raises(TypeError, match="int32"):
        K.csr_spmm(x, plan.row_ptr.long(), plan.col, plan.val)
    with pytest.raises(ValueError, match="rows, W"):
        K.csr_spmm(x[None], plan.row_ptr, plan.col, plan.val)
    with pytest.raises(ValueError, match="one CUDA device"):
        K.csr_spmm(x.to("meta"), plan.row_ptr, plan.col, plan.val)


# --- K1's split schedule: heavy rows cut into segments -----------------------

def _power_law_edges(seed, n=300, e=4000, isolated=20):
    """Unsorted edges whose senders and receivers are drawn as rank
    floor(m·u²) of a uniform u, m = n - isolated, over shuffled ids (as
    chip_smoke.py's power-law graph): hubs of a few hundred edges in both
    directions, and ``isolated`` ids that no edge of a direction uses."""
    rng = np.random.default_rng(seed)
    m = n - isolated

    def nodes():
        rank = np.minimum((m * rng.random(e) ** 2).astype(np.int64), m - 1)
        return rng.permutation(n)[rank]

    return nodes(), nodes(), n


def _csrs(plan):
    return ((plan.row_ptr, plan.col, plan.val, plan.split),
            (plan.t_row_ptr, plan.t_col, plan.t_val, plan.t_split))


@pytest.mark.parametrize("threshold", [4, 16, 64])
@pytest.mark.parametrize("transposed", [False, True])
def test_plan_splits_heavy_rows_into_segments(monkeypatch, threshold,
                                              transposed):
    """At a low T, every edge of a heavy row lies in exactly one segment of
    at most T edges, the segments run in CSR order, and the light rows are
    exactly the rows of degree <= T."""
    monkeypatch.setattr(K, "SPLIT_THRESHOLD", threshold)
    s, r, n = _power_law_edges(30)
    ptr, _, _, split = _csrs(tops.build_csr_plan(_t(s), _t(r), n))[
        int(transposed)]
    degrees = np.diff(ptr.numpy())
    assert degrees.max() > 3 * threshold and (degrees == 0).any()
    assert split.threshold == threshold
    for a in split.tensors():
        assert a.dtype == torch.int32
    rows, seg_ptr = split.rows.numpy(), split.seg_ptr.numpy()
    begin, end = split.seg_begin.numpy(), split.seg_end.numpy()
    np.testing.assert_array_equal(rows, np.flatnonzero(degrees > threshold))
    assert split.num_heavy == rows.size > 0
    assert seg_ptr[0] == 0 and seg_ptr[-1] == split.num_segments == begin.size
    assert ((end - begin >= 1) & (end - begin <= threshold)).all()
    covered = np.zeros(int(ptr[-1]), np.int64)
    for h, row in enumerate(rows):
        segs = np.arange(seg_ptr[h], seg_ptr[h + 1])
        assert segs.size == -(-degrees[row] // threshold)
        np.testing.assert_array_equal(begin[segs[1:]], end[segs[:-1]])
        assert begin[segs[0]] == ptr[row] and end[segs[-1]] == ptr[row + 1]
        for b, e in zip(begin[segs], end[segs]):
            covered[b:e] += 1
    heavy_edges = np.repeat(degrees > threshold, degrees)
    np.testing.assert_array_equal(covered, heavy_edges.astype(np.int64))


def test_citation_graphs_have_no_heavy_rows():
    """At the package's T the slices' synthetic Cora and PubMed graphs
    split no row, so K1 is one launch there."""
    from difformer_tpu_torch.data import random_graph, standard_preprocess

    assert K.SPLIT_THRESHOLD >= 256
    for n, e, f, c, seed in ((2708, 10556, 1433, 7, 42),
                             (19717, 44324, 500, 3, 7)):
        _, ei, _ = random_graph(n, e, f, c, seed=seed, homophily=0.8)
        ei = standard_preprocess(ei, n)
        plan = tops.build_csr_plan(_t(ei[0]), _t(ei[1]), n)
        for split in (plan.split, plan.t_split):
            assert split.threshold == K.SPLIT_THRESHOLD
            assert split.num_heavy == split.num_segments == 0


def _split_product(x, row_ptr, col, val, split):
    """K1's order in plain torch: the light rows as the plain version sums
    them, each segment summed edge by edge in CSR order, then each heavy
    row's segment sums added in segment order."""
    out = K.csr_spmm_plain(x, row_ptr, col, val)
    rows, seg_ptr, begin, end = (a.tolist() for a in split.tensors())
    for h, row in enumerate(rows):
        total = torch.zeros(x.shape[1])
        for s in range(seg_ptr[h], seg_ptr[h + 1]):
            part = torch.zeros(x.shape[1])
            for e in range(begin[s], end[s]):
                part = part + val[e] * x[col[e]]
            total = total + part
        out[row] = total
    return out


@pytest.mark.parametrize("threshold", [4, 16, 64])
@pytest.mark.parametrize("width", [1, 6, 65])
def test_segment_sums_combined_in_order_match_plain(monkeypatch, threshold,
                                                    width):
    """The split order of summation agrees with the plain version under
    the unchanged "spmm" kind, which still rejects zeros and moved rows."""
    from difformer_tpu_torch.kernels.tolerance import assert_close

    monkeypatch.setattr(K, "SPLIT_THRESHOLD", threshold)
    s, r, n = _power_law_edges(31)
    vals = np.random.default_rng(32).normal(size=s.shape).astype(np.float32)
    plan = tops._plan(_t(s), _t(r), n, torch.from_numpy(vals))
    x = torch.from_numpy(np.random.default_rng(33).normal(
        size=(n, width)).astype(np.float32))
    for row_ptr, col, val, split in _csrs(plan):
        ref = K.csr_spmm_plain(x, row_ptr, col, val)
        scale = K.csr_spmm_abs(x, row_ptr, col, val)
        assert_close("split", _split_product(x, row_ptr, col, val, split),
                     ref, "spmm", scale=scale)
        for wrong in (torch.zeros_like(ref), ref.roll(1, 0)):
            with pytest.raises(AssertionError):
                assert_close("wrong", wrong, ref, "spmm", scale=scale)


def test_row_split_checks_its_threshold():
    ptr = torch.tensor([0, 3, 3, 10], dtype=torch.int32)
    with pytest.raises(ValueError, match="at least 1"):
        K.row_split(ptr, 0)
    split = K.row_split(ptr, 3)
    assert split.rows.tolist() == [2]
    assert list(zip(split.seg_begin.tolist(), split.seg_end.tolist())) == [
        (3, 5), (5, 7), (7, 10)]
