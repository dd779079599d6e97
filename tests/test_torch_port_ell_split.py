"""K6's split of hub buckets and its skipped padding, on the CPU: the host's
split plan (``difformer_tpu_torch/kernels/ell.py``: ``split_plan``,
``build_split``; the chunks of a row are K7's ``chunk_ranges``), each row's
run of padding
(``EllGraph.pads``) against the JAX package's tables, and the plain
versions of K6's two launches (the chunks' partial sums over the real
slots, then their combine in chunk order) against the JAX package's
``_ell_matvec`` (``difformer_tpu/ops/ell.py``).

The products are held to the port's "spmm" rule of
``kernels/tolerance.py`` (rtol 1e-4, atol 1e-5 of each element's sum of
|w·x|): the same sums in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difformer_tpu.ops import ell as JE
from difformer_tpu_torch.kernels import bsr as K7
from difformer_tpu_torch.kernels import ell as K6
from difformer_tpu_torch.kernels.tolerance import assert_close
from difformer_tpu_torch.ops import ell as E
import torch_port_helpers  # noqa: F401  (sets torch's threads)

N = 300


def _hub_edges(n=N, e=4000, seed=0):
    """(senders, receivers) with power-law ends and one hub of ~600
    in-edges; node 7 has one real edge from node 0, node 9 two (a repeated
    edge), so both rows hold real index-0 slots in front of their
    padding."""
    rng = np.random.default_rng(seed)
    w = rng.pareto(2.0, n) + 1.0
    p = w / w.sum()
    s = rng.choice(n, size=e, p=p)
    r = rng.choice(n, size=e, p=p)
    s = np.concatenate([s, rng.integers(1, n, 600)])
    r = np.concatenate([r, np.full(600, 5)])
    keep = s != 0  # node 0 sends only these three edges
    return (np.concatenate([s[keep], [0, 0, 0]]),
            np.concatenate([r[keep], [7, 9, 9]]))


def _layouts(seed=0):
    s, r = _hub_edges(seed=seed)
    return E.build_ell_gcn(s, r, N), JE.build_ell_gcn(s, r, N)


def _jax_product(jax_ell, x):
    return torch.from_numpy(np.array(JE._ell_matvec(jax_ell, jnp.asarray(
        x.numpy()))))


def _split_then_combine(x, ell, add_to=None):
    out, partial = K6.ell_spmm_split_plain(x, ell, add_to)
    return K6.ell_spmm_combine_plain(partial, out, ell,
                                     accumulate=add_to is not None)


@pytest.mark.parametrize("threshold", [1, 8, 24, 64, 256, 10 ** 6])
def test_split_plan_covers_every_slot_once(threshold):
    """Every slot of every split row lies in exactly one chunk, the chunks
    in slot order and at most T slots each; no bucket of width <= T is
    split; the combine's rows and offsets name each split row's node and
    its consecutive partial rows."""
    for ell in _layouts()[0]:
        split = ell.with_split(threshold).split
        counts = np.diff(np.append(ell.table[:, 0], ell.rows.numel()))
        assert split.threshold == threshold
        assert np.array_equal(split.table[:, :3], ell.table)
        assert tuple(split.table[:, 3]) == split.chunks
        nodes, seg, part = [], [0], 0
        for (r0, k, _), m, c, p in zip(ell.table, counts, split.chunks,
                                        split.table[:, 4]):
            if k <= threshold:
                assert c == 1 and p == -1
                continue
            assert c == -(-k // threshold) and p == part
            ranges = K7.chunk_ranges(int(k), c)
            assert ranges[0][0] == 0 and ranges[-1][1] == k
            for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
                assert hi == lo2
            assert all(0 < hi - lo <= threshold for lo, hi in ranges)
            nodes.append(ell.rows[r0:r0 + m])
            seg += [part + c * (i + 1) for i in range(m)]
            part += m * c
        assert split.partials == part
        assert torch.equal(split.seg_ptr, torch.tensor(seg, dtype=torch.int32))
        want = torch.cat(nodes) if nodes else torch.zeros(0, dtype=torch.int32)
        assert torch.equal(split.rows, want)


def test_split_plan_depends_only_on_the_table_and_threshold():
    """The plan is a function of the bucket table and T: two graphs with
    other edges but the same table get the same chunks and kernel table,
    and the layout's own plan is the one at SPLIT_THRESHOLD. The hub graph
    splits at that T; a table of narrow buckets never does."""
    fwd, rev = _layouts()[0]
    assert max(fwd.bucket_sizes) > K6.SPLIT_THRESHOLD
    assert fwd.split.chunks == K6.split_plan(fwd.table)
    assert fwd.split.threshold == K6.SPLIT_THRESHOLD
    assert fwd.split.partials > 0
    rows = torch.arange(fwd.rows.numel(), dtype=torch.int32).flip(0)
    for t in (16, 100, 600):
        a = K6.build_split(fwd.table, fwd.rows, t)
        b = K6.build_split(fwd.table.copy(), rows, t)
        assert a.chunks == b.chunks == K6.split_plan(fwd.table, t)
        assert np.array_equal(a.table, b.table)
        assert torch.equal(a.seg_ptr, b.seg_ptr)
    narrow = np.array([[0, 8, 0], [10, 16, 80], [20, 32, 240]], np.int64)
    assert K6.split_plan(narrow) == (1, 1, 1)
    with pytest.raises(ValueError, match="at least 1"):
        K6.split_plan(narrow, 0)


@pytest.mark.parametrize("direction", [0, 1])
def test_pads_are_the_jax_tables_padding(direction):
    """Each row's (first pad slot, pads) marks exactly the slots of the JAX
    package's tables beyond the node's degree: index 0 and weight 0, one
    run behind the row's real edges to node 0 (node 7's row starts it at
    slot 1, node 9's, with a repeated edge from 0, at slot 2)."""
    ell = _layouts()[0][direction]
    jax_ell = _layouts()[1][direction]
    s, r = _hub_edges()
    owner = r if direction == 0 else s
    degree = np.bincount(owner, minlength=N)
    counts = np.diff(np.append(ell.table[:, 0], ell.rows.numel()))
    for (r0, k, _), m, nbr, wt in zip(ell.table, counts, jax_ell.nbr_idx,
                                      jax_ell.weight):
        nbr, wt = np.asarray(nbr), np.asarray(wt)
        nodes = ell.rows[r0:r0 + m].numpy()
        first, pads = ell.pads[r0:r0 + m].numpy().T
        np.testing.assert_array_equal(pads, k - degree[nodes])
        j = np.arange(k)
        run = (j >= first[:, None]) & (j < (first + pads)[:, None])
        assert (nbr[run] == 0).all() and (wt[run] == 0).all()
        # outside the run, the node's own neighbours
        for i, node in enumerate(nodes):
            want = np.sort((s if direction == 0 else r)[owner == node])
            np.testing.assert_array_equal(np.sort(nbr[i][~run[i]]), want)
    if direction == 0:
        row = ell.inv_perm.numpy()
        assert tuple(ell.pads[row[7]].tolist())[0] == 1
        assert tuple(ell.pads[row[9]].tolist())[0] == 2


@pytest.mark.parametrize("add", [False, True])
@pytest.mark.parametrize("threshold", [8, 64, 256])
@pytest.mark.parametrize("direction", [0, 1])
def test_split_then_combine_matches_jax(direction, threshold, add):
    """The plain versions of K6's kernel (unsplit rows and the chunks'
    partial sums, over the real slots) and of the combine (chunks in
    order, added to ``add_to``'s value), against the JAX package's
    ``_ell_matvec`` (plus ``add_to``) under the "spmm" rule."""
    ell, jax_ell = (p[direction] for p in _layouts())
    ell = ell.with_split(threshold)
    assert ell.split.partials > 0
    rng = np.random.default_rng(threshold)
    x = torch.from_numpy(rng.normal(size=(N, 24)).astype(np.float32))
    base = (torch.from_numpy(rng.normal(size=(N, 24)).astype(np.float32))
            if add else None)
    got = _split_then_combine(x, ell, None if base is None else base.clone())
    want = _jax_product(jax_ell, x)
    scale = K6.ell_spmm_abs(x, ell)
    if base is not None:
        want, scale = want + base, scale + base.abs()
    assert_close("K6 split + combine", got, want, "spmm", scale=scale)


def test_split_partials_sum_each_chunk_in_slot_order():
    """A split row's partial rows are its chunks' sums over the real slots,
    and their sum in order is the row: checked against the slots summed
    one by one on the JAX tables."""
    ell, jax_ell = (p[0] for p in _layouts())
    ell = ell.with_split(50)
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(N, 4)).astype(np.float32))
    _, partial = K6.ell_spmm_split_plain(x, ell)
    hub = int(np.argmax(ell.table[:, 1]))
    r0, k, _ = ell.table[hub]
    c = ell.split.chunks[hub]
    p0 = ell.split.table[hub, 4]
    nbr = np.asarray(jax_ell.nbr_idx[hub])[0]
    wt = np.asarray(jax_ell.weight[hub])[0]
    for j, (lo, hi) in enumerate(K7.chunk_ranges(int(k), c)):
        want = (x.numpy()[nbr[lo:hi]] * wt[lo:hi, None]).sum(0)
        np.testing.assert_allclose(partial[p0 + j].numpy(), want,
                                   rtol=1e-5, atol=1e-6)


def test_skipped_pads_do_not_carry_nan_from_node_0():
    """The documented difference (ROADMAP.md queue C): a NaN in x[0]
    reaches every row with padding in the JAX package's sum, which gathers
    x[0] for each pad; K6 skips the pads, so only the rows with a real edge
    to node 0 see it."""
    ell, jax_ell = (p[0] for p in _layouts())
    x = torch.ones((N, 3))
    x[0] = float("nan")
    ell = ell.with_split(64)
    got = _split_then_combine(x, ell)
    want = _jax_product(jax_ell, x)
    real_zero = torch.zeros(N, dtype=torch.bool)
    for (r0, k, _), nbr, real in zip(ell.table, ell.nbr_idx,
                                     K6.real_slots(ell)):
        hit = ((nbr == 0) & real).any(1)
        real_zero[ell.rows[r0:r0 + nbr.shape[0]].long()] = hit
    assert real_zero[7] and real_zero[9]
    assert torch.isnan(got[real_zero]).all()
    assert torch.isfinite(got[~real_zero]).all()
    assert torch.isnan(want).any(1).sum() > real_zero.sum()


def test_combine_rounds_once_at_bf16():
    """At bfloat16 the combine adds the chunks in float32, adds out's value
    under accumulate, and rounds once."""
    ell = _layouts()[0][0].with_split(32)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(N, 16)).astype(np.float32))
    base = torch.from_numpy(rng.normal(size=(N, 16)).astype(
        np.float32)).to(torch.bfloat16)
    out, partial = K6.ell_spmm_split_plain(x.to(torch.bfloat16), ell,
                                           base.clone())
    got = K6.ell_spmm_combine_plain(partial, out, ell, accumulate=True)
    rows, seg = ell.split.rows.long(), ell.split.seg_ptr.long()
    for h in range(rows.numel()):
        total = torch.zeros(16)
        for p in range(int(seg[h]), int(seg[h + 1])):
            total = total + partial[p]
        want = (base[rows[h]].float() + total).to(torch.bfloat16)
        assert torch.equal(got[rows[h]], want)
