"""The port's host-side graph preparation against the JAX package's: the four
transforms of ``data/transforms.py`` the mini-batch trainer uses, and the
native library (``difformer_tpu_torch/native``) on both of its paths (C++
and numpy), on random and power-law graphs. Integer results are exactly
equal. The GCN values equal the JAX package's C++ values exactly; its numpy
path computes them in float64 and differs from its own C++ path by up to
one float32 rounding, which is the tolerance against it. Also: the one-pass
chunk subgraphs equal the per-chunk ones, the chunk CSRs equal the sorts
and values they replace, the baseline zoo's chunk plans (``gcn_norm`` with
and without self-loops, GAT's) equal the port's plans built on the device
bit for bit, K1's host split schedule equals the device one, and the
library is built once by processes that start together.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from difformer_tpu import native as jax_native
from difformer_tpu.data import transforms as jax_T
from difformer_tpu.ops.ell import _gcn_values as jax_gcn_values_numpy
from difformer_tpu_torch import native
from difformer_tpu_torch.data import transforms as T
from difformer_tpu_torch.kernels import spmm as K
import torch_port_helpers  # noqa: F401  (sets torch's threads)

ROOT = Path(__file__).resolve().parent.parent


def _graph(kind, seed=0, n=400, e=5000):
    """(senders, receivers, n) int64: uniform ids, or ids drawn as rank
    floor(n·u²) over shuffled ids (hubs of a few hundred edges)."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, n, e), rng.integers(0, n, e), n

    def nodes():
        rank = np.minimum((n * rng.random(e) ** 2).astype(np.int64), n - 1)
        return rng.permutation(n)[rank]

    return nodes(), nodes(), n


GRAPHS = ["random", "power-law"]


@pytest.fixture(params=["native", "numpy"])
def path(request, monkeypatch):
    """Each of the port's two paths: the C++ library, or numpy as on a
    machine without a compiler."""
    if request.param == "native":
        assert native.available(), native.load_error
    else:
        monkeypatch.setattr(native, "get_lib", lambda: None)
    return request.param


# --- the four transforms ------------------------------------------------------

@pytest.mark.parametrize("kind", GRAPHS)
@pytest.mark.parametrize("weighted", [False, True])
def test_sort_edges_by_receiver_matches_jax(kind, weighted):
    s, r, n = _graph(kind)
    w = np.random.default_rng(1).random(s.size).astype(np.float32) \
        if weighted else None
    got, got_w = T.sort_edges_by_receiver(np.stack([s, r]), w)
    want, want_w = jax_T.sort_edges_by_receiver(np.stack([s, r]), w)
    np.testing.assert_array_equal(got, want)
    if weighted:
        np.testing.assert_array_equal(got_w, want_w)
    else:
        assert got_w is None and want_w is None


@pytest.mark.parametrize("kind", GRAPHS)
@pytest.mark.parametrize("relabel", [False, True])
def test_subgraph_matches_jax(kind, relabel):
    s, r, n = _graph(kind)
    chunk = np.random.default_rng(2).permutation(n)[:130]
    got = T.subgraph(chunk, np.stack([s, r]), n, relabel_nodes=relabel)
    want = jax_T.subgraph(chunk, np.stack([s, r]), n, relabel_nodes=relabel)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("weighted", [False, True])
def test_pad_edges_matches_jax(weighted):
    s, r, _ = _graph("random", e=300)
    ei = np.stack([s, r])
    w = np.linspace(0.1, 1.0, 300).astype(np.float32) if weighted else None
    for target in (300, 512):
        got = T.pad_edges(ei, w, target, pad_index=3)
        want = jax_T.pad_edges(ei, w, target, pad_index=3)
        for a, b in zip(got, want):
            if b is None:
                assert a is None
            else:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="exceeds bucket 299"):
        T.pad_edges(ei, w, 299)


def test_edge_bucket_matches_jax():
    for e in [0, 1, 127, 128, 129, 1000, 54321, 3_000_000]:
        for growth in (1.3, 2.0):
            assert T.edge_bucket(e, growth=growth) == jax_T.edge_bucket(
                e, growth=growth)
        assert (T.edge_bucket(e, minimum=64)
                == jax_T.edge_bucket(e, minimum=64))
    assert T.edge_bucket(70, [64, 128, 256]) == 128
    with pytest.raises(ValueError, match="largest bucket 256"):
        T.edge_bucket(300, [64, 128, 256])


# --- the native entries ---------------------------------------------------------

@pytest.mark.parametrize("kind", GRAPHS)
def test_sort_by_receiver_entry_matches_jax(path, kind):
    s, r, n = _graph(kind)
    order, indptr = native.sort_edges_by_receiver(r, n)
    for jax_path in ("native", "numpy"):
        want = _jax_native(jax_path, "sort_edges_by_receiver", r, n)
        np.testing.assert_array_equal(order, want[0])
        np.testing.assert_array_equal(indptr, want[1])
        assert order.dtype == indptr.dtype == np.int64


@pytest.mark.parametrize("kind", GRAPHS)
@pytest.mark.parametrize("weighted", [False, True])
def test_gcn_values_entry_matches_jax(path, kind, weighted):
    """Nodes without in-edges (ids above the drawn range) get 0 values on
    their out-edges; a zero weight gives 0."""
    s, r, n = _graph(kind)
    r = np.where(r > n - 20, 0, r)  # nodes n-19.. receive nothing
    w = None
    if weighted:
        w = np.random.default_rng(3).uniform(0.0, 2.0, s.size)
        w = w.astype(np.float32)
        w[::7] = 0.0
    got = native.gcn_norm_values(s, r, n, w)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(
        got, _jax_native("native", "gcn_norm_values", s, r, n, w))
    ref = jax_gcn_values_numpy(s, r, n, w)
    np.testing.assert_allclose(got, ref, rtol=2.4e-7, atol=0)
    assert (got[s > n - 20] == 0).all()


@pytest.mark.parametrize("kind", GRAPHS)
def test_induced_subgraph_entry_matches_jax(path, kind):
    s, r, n = _graph(kind)
    chunk = np.random.default_rng(4).permutation(n)[:150]
    got = native.induced_subgraph(s, r, chunk, n)
    assert got.dtype == np.int32
    for jax_path in ("native", "numpy"):
        np.testing.assert_array_equal(
            got, _jax_native(jax_path, "induced_subgraph", s, r, chunk, n))


def _jax_native(jax_path, name, *args):
    """The JAX package's native entry ``name`` on its C++ or numpy path."""
    if jax_path == "native":
        assert jax_native.available()
        return getattr(jax_native, name)(*args)
    real = jax_native.get_lib
    jax_native.get_lib = lambda: None
    try:
        return getattr(jax_native, name)(*args)
    finally:
        jax_native.get_lib = real


@pytest.mark.parametrize("kind", GRAPHS)
@pytest.mark.parametrize("batch", [1, 7, 100, 128, 400, 999])
def test_chunk_subgraphs_equal_per_chunk_subgraphs(path, kind, batch,
                                                   monkeypatch):
    """The one pass gives every chunk the edge list of its own
    ``induced_subgraph``, whatever the number of threads."""
    s, r, n = _graph(kind)
    perm = np.random.default_rng(5).permutation(n)
    results = []
    for threads in (1, 3, 8):
        monkeypatch.setattr(native, "_threads", lambda e, t=threads: t)
        results.append(native.chunk_subgraphs(s, r, perm, batch))
    chunks = -(-n // batch)
    for subs in results:
        assert len(subs) == chunks
        for c, sub in enumerate(subs):
            want = jax_native.induced_subgraph(
                s, r, perm[c * batch:(c + 1) * batch], n)
            assert sub.dtype == np.int32
            np.testing.assert_array_equal(sub, want, err_msg=f"chunk {c}")


@pytest.mark.parametrize("kind", GRAPHS)
def test_chunk_csr_equals_sorts_and_values(path, kind):
    """A chunk's two CSRs: the stable counting sorts by receiver and by
    sender, with the GCN values permuted alike; written into longer arrays
    (a plan at capacity), the first E entries."""
    s, r, n = _graph(kind)
    sub = native.induced_subgraph(s, r, np.arange(0, n, 2), n)
    m, e = n // 2, sub.shape[1]
    val = native.gcn_norm_values(sub[0], sub[1], m)
    outs = [native.chunk_csr(sub[0], sub[1], m)]
    room = [np.full(m + 1, -9, np.int32), np.full(e + 5, -9, np.int32),
            np.full(e + 5, -9.0, np.float32)]
    outs.append(native.chunk_csr(sub[0], sub[1], m, out=tuple(
        a.copy() for a in room + room)))
    for out in outs:
        for key, other, (ptr, col, v) in ((sub[1], sub[0], out[:3]),
                                          (sub[0], sub[1], out[3:])):
            order, indptr = jax_native.sort_edges_by_receiver(key, m)
            np.testing.assert_array_equal(ptr, indptr)
            np.testing.assert_array_equal(col[:e], other[order])
            np.testing.assert_array_equal(v[:e], val[order])
            assert ptr.dtype == col.dtype == np.int32 and v.dtype == np.float32
    assert (outs[1][1][e:] == -9).all()


def _chunk(kind):
    s, r, n = _graph(kind)
    sub = native.induced_subgraph(s, r, np.arange(0, n, 2), n)
    return sub, n // 2


@pytest.mark.parametrize("kind", GRAPHS)
@pytest.mark.parametrize("loops", [True, False])
def test_chunk_norm_csr_is_norm_plan(path, kind, loops):
    """The zoo's ``gcn_norm`` plan of a chunk, with self-loops (GCN, SGC,
    GCNJK, APPNP, GPRGNN) and without (MixHop, H2GCN): the arrays of
    ``nn/gnns.py:norm_plan`` on the CPU, bit for bit; written into longer
    arrays, the first E entries."""
    from difformer_tpu_torch.nn.gnns import norm_plan

    sub, m = _chunk(kind)
    e = sub.shape[1] + (m if loops else 0)
    plan = norm_plan(torch.from_numpy(sub[0]), torch.from_numpy(sub[1]), m,
                     add_self_loops=loops)
    want = [getattr(plan, f).numpy() for f in (
        "row_ptr", "col", "val", "t_row_ptr", "t_col", "t_val")]
    room = [np.full(m + 1, -9, np.int32), np.full(e + 5, -9, np.int32),
            np.full(e + 5, -9.0, np.float32)]
    for out in (native.chunk_norm_csr(sub[0], sub[1], m, loops),
                native.chunk_norm_csr(sub[0], sub[1], m, loops, out=tuple(
                    a.copy() for a in room + room))):
        for got, ref in zip(out, want):
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got[:ref.size], ref)
        assert (out[1][e:] == -9).all() or out[1].size == e


@pytest.mark.parametrize("kind", GRAPHS)
def test_chunk_gat_csr_is_gat_plan(path, kind):
    """GAT's plan of a chunk (its edges and a self-loop on every node):
    ``nn/gnns.py:gat_plan``'s CSRs, receivers and transposed order on the
    CPU, bit for bit, also written into longer arrays."""
    from difformer_tpu_torch.nn.gnns import gat_plan

    sub, m = _chunk(kind)
    e = sub.shape[1] + m
    plan = gat_plan(torch.from_numpy(sub[0]), torch.from_numpy(sub[1]),
                    m).plan
    want = [t.numpy() for t in (plan.row_ptr, plan.col, plan.rows,
                                plan.t_row_ptr, plan.t_col, plan.t_order)]
    room = [np.full(m + 1, -9, np.int32)] + [np.full(e + 5, -9, np.int32)] * 2
    for out in (native.chunk_gat_csr(sub[0], sub[1], m),
                native.chunk_gat_csr(sub[0], sub[1], m, out=tuple(
                    a.copy() for a in room + room))):
        for got, ref in zip(out, want):
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got[:ref.size], ref)


# --- K1's host split schedule ---------------------------------------------------

@pytest.mark.parametrize("kind", GRAPHS)
@pytest.mark.parametrize("threshold", [1, 4, 16, 64, 256])
def test_host_row_split_equals_device_row_split(kind, threshold):
    s, r, n = _graph(kind)
    for key in (s, r):
        ptr = np.zeros(n + 1, np.int32)
        np.cumsum(np.bincount(key, minlength=n), out=ptr[1:])
        host = K.row_split_host(ptr, threshold)
        device = K.row_split(torch.from_numpy(ptr), threshold)
        for a, b in zip(host, device.tensors()):
            assert a.dtype == np.int32
            np.testing.assert_array_equal(a, b.numpy())
        heavy, segments = split_cap = K.split_capacity(s.size, threshold)
        assert host[0].size <= heavy and host[2].size <= segments
        out = tuple(np.full(k, -1, np.int32) for k in (
            heavy, heavy + 1, segments, segments))
        assert K.padded_split(host, split_cap, out) == (host[0].size,
                                                        host[2].size)
        for a, b in zip(out, host):
            np.testing.assert_array_equal(a[:b.size], b)
    with pytest.raises(ValueError, match="at least 1"):
        K.row_split_host(ptr, 0)


def test_padded_split_refuses_more_than_its_capacity():
    ptr = np.array([0, 10, 10, 30], np.int32)
    host = K.row_split_host(ptr, 4)
    out = tuple(np.zeros(k, np.int32) for k in (1, 2, 3, 3))
    with pytest.raises(ValueError, match="exceed the capacity"):
        K.padded_split(host, (1, 3), out)


# --- the build ------------------------------------------------------------------

def test_library_builds_once_for_processes_that_start_together(tmp_path):
    """Three processes that load the library at once into an empty build
    directory: one compiles, under the lock, the others load its result;
    no temporary file is left."""
    code = (
        "import sys; from pathlib import Path\n"
        "import difformer_tpu_torch.native as N\n"
        "N.BUILD_DIR = Path(sys.argv[1])\n"
        "assert N.available(), N.load_error\n"
        "print(N.library_path().name)\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    names = {out.strip() for out, _ in outs}
    assert len(names) == 1
    built = sorted(f.name for f in tmp_path.iterdir())
    assert built == sorted([names.pop(), "graphprep.lock"])


def test_without_a_compiler_the_numpy_path_runs(monkeypatch):
    def fail():
        raise subprocess.CalledProcessError(1, ["g++"], stderr="no g++")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "load_error", None)
    monkeypatch.setattr(native, "build", fail)
    assert not native.available()
    assert "CalledProcessError" in native.load_error
    assert "no g++" in native.load_error
    s, r, n = _graph("random")
    np.testing.assert_array_equal(
        native.induced_subgraph(s, r, np.arange(50), n),
        jax_native.induced_subgraph(s, r, np.arange(50), n))
