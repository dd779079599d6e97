"""ctypes bindings of the port's native graph preparation (``graphprep.cpp``),
the host side of the mini-batch trainer (induced subgraphs, counting-sort
CSRs and GCN values) and of the ELL layout's builder (:func:`ell_fill`,
``ops/ell.py``).

The mini-batch trainer calls :func:`induced_subgraph` (its edge capacity),
:func:`chunk_subgraphs` and, for every epoch's chunk plans, :func:`chunk_csr`
(DIFFormer's), :func:`chunk_norm_csr` (the baseline zoo's ``gcn_norm``
plans, with or without self-loops) or :func:`chunk_gat_csr` (GAT's).
:func:`sort_edges_by_receiver` and :func:`ell_fill` build the ELL layout
(``ops/ell.py``). :func:`label_propagation` finds the communities behind
``data/transforms.py``'s ``label_propagation``, so behind
``locality_reorder(method="community")`` and ``parallel/partition.py``'s
``locality_layout``. :func:`knn_neighbors` is the JAX package's brute-force
kNN, bit for bit (no module of either package calls it; ``knn_graph`` is
numpy in both). :func:`gcn_norm_values` is the JAX package's other native
entry with its signature: nothing in the port calls it; it keeps the port's
native API the JAX package's (``chunk_csr`` gives its values), and
``tests/test_torch_port_native.py`` holds the entries equal to the JAX ones.

The library is compiled with ``g++`` at first use into
``difformer_tpu_torch/_build/`` (listed in ``.gitignore``), under a name
that carries a hash of the source and the flags; the compiler writes a
temporary file that is renamed into place under a file lock, so processes
that start together (test workers) build it once and never load a partial
file. Every entry but :func:`label_propagation` and
:func:`knn_neighbors` has a numpy path that
gives the same arrays, taken where the library cannot be built or loaded
(no compiler): :func:`available` says
which, and :data:`load_error` why. This is host code, not a device kernel.
Nothing is built when the module is imported.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "graphprep.cpp"
BUILD_DIR = SOURCE.parent.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib = None
_tried = False
#: Why the library is not loaded (None while it is, or before a try).
load_error = None

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_F32P = ctypes.POINTER(ctypes.c_float)
_I64 = ctypes.c_int64
_SIGNATURES = {
    "sort_edges_by_receiver": ([_I32P, _I64, _I64, _I64P, _I64P], None),
    "gcn_norm_values": ([_I32P, _I32P, _F32P, _I64, _I64, _F32P], None),
    "induced_subgraph": ([_I32P, _I32P, _I64, _I64P, _I32P, _I32P], _I64),
    "chunk_subgraphs": ([_I32P, _I32P, _I64, _I64P, _I64, _I64, _I64,
                         ctypes.c_int, _I64P, _I32P, _I32P], _I64),
    "chunk_csr": ([_I32P, _I32P, _I64, _I64, _I32P, _I32P, _F32P, _I32P,
                   _I32P, _F32P], None),
    "chunk_norm_csr": ([_I32P, _I32P, _I64, _I64, ctypes.c_int, _I32P,
                        _I32P, _F32P, _I32P, _I32P, _F32P], None),
    "chunk_gat_csr": ([_I32P, _I32P, _I64, _I64, _I32P, _I32P, _I32P,
                       _I32P, _I32P, _I32P], None),
    "ell_fill": ([_I64P, _I64, _I64, _I64P, _I32P, _F32P, _I32P, _F32P],
                 None),
    "label_propagation": ([_I32P, _I32P, _I64, _I64, ctypes.c_int32,
                           ctypes.c_int, _I64P], None),
    "knn_graph": ([_F32P, _I64, _I64, _I64, ctypes.c_int, _I64P], None),
}


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libgraphprep_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless a build of the same source and flags is
    there; returns its path."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "graphprep.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not target.exists():  # another process may have built it
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            try:
                subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o",
                                str(tmp)], check=True, capture_output=True,
                               text=True)
                os.replace(tmp, target)
            finally:
                tmp.unlink(missing_ok=True)
    return target


def get_lib():
    """The loaded library (building it at the first call), or None where it
    cannot be built or loaded."""
    global _lib, _tried, load_error
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, subprocess.CalledProcessError) as err:
            detail = getattr(err, "stderr", "") or ""
            load_error = f"{type(err).__name__}: {err} {detail}".strip()
            return None
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def _p(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _i32(a):
    return np.ascontiguousarray(a, np.int32)


def sort_edges_by_receiver(receivers, num_nodes):
    """(order [E] int64, indptr [N + 1] int64): the stable order of the
    edges by receiver, and the receivers' CSR offsets."""
    lib = get_lib()
    receivers = _i32(receivers)
    e = receivers.shape[0]
    if lib is None:
        order = np.argsort(receivers, kind="stable").astype(np.int64)
        counts = np.zeros(num_nodes + 1, np.int64)
        np.add.at(counts, receivers + 1, 1)
        return order, np.cumsum(counts)
    order = np.empty(e, np.int64)
    indptr = np.empty(num_nodes + 1, np.int64)
    lib.sort_edges_by_receiver(_p(receivers, ctypes.c_int32), e, num_nodes,
                               _p(order, ctypes.c_int64),
                               _p(indptr, ctypes.c_int64))
    return order, indptr


def _gcn_values_numpy(senders, receivers, num_nodes, edge_weight):
    """The C++ arithmetic in numpy: degrees in float64, 1/sqrt(deg) rounded
    to float32, then w·inv[r]·inv[s] in float32, left to right."""
    deg = np.bincount(receivers, minlength=num_nodes).astype(np.float64)
    with np.errstate(divide="ignore"):
        inv = np.where(deg > 0, 1.0 / np.sqrt(deg), 0.0).astype(np.float32)
    w = (np.ones(senders.shape[0], np.float32) if edge_weight is None
         else np.asarray(edge_weight, np.float32))
    with np.errstate(over="ignore", invalid="ignore"):
        val = w * inv[receivers] * inv[senders]
    return np.where(np.isfinite(val), val, np.float32(0))


def gcn_norm_values(senders, receivers, num_nodes, edge_weight=None):
    """[E] float32: ``w · deg[r]^-½ · deg[s]^-½`` over in-degrees, the
    reference's normalised values, with non-finite values set to 0."""
    lib = get_lib()
    senders, receivers = _i32(senders), _i32(receivers)
    if lib is None:
        return _gcn_values_numpy(senders, receivers, num_nodes, edge_weight)
    out = np.empty(senders.shape[0], np.float32)
    ew = (None if edge_weight is None
          else np.ascontiguousarray(edge_weight, np.float32))
    lib.gcn_norm_values(
        _p(senders, ctypes.c_int32), _p(receivers, ctypes.c_int32),
        None if ew is None else _p(ew, ctypes.c_float), senders.shape[0],
        num_nodes, _p(out, ctypes.c_float))
    return out


def induced_subgraph(senders, receivers, chunk, num_nodes):
    """[2, kept] int32: the edges whose two ends are in ``chunk``, in
    their order, relabelled to positions in ``chunk``."""
    lib = get_lib()
    senders, receivers = _i32(senders), _i32(receivers)
    remap = -np.ones(num_nodes, np.int64)
    remap[np.asarray(chunk)] = np.arange(len(chunk))
    if lib is None:
        keep = (remap[senders] >= 0) & (remap[receivers] >= 0)
        return np.stack([remap[senders[keep]],
                         remap[receivers[keep]]]).astype(np.int32)
    e = senders.shape[0]
    out_s = np.empty(e, np.int32)
    out_r = np.empty(e, np.int32)
    kept = lib.induced_subgraph(
        _p(senders, ctypes.c_int32), _p(receivers, ctypes.c_int32), e,
        _p(remap, ctypes.c_int64), _p(out_s, ctypes.c_int32),
        _p(out_r, ctypes.c_int32))
    return np.stack([out_s[:kept], out_r[:kept]])


def _threads(e):
    """Threads for a pass over e edges: one per 2²⁰ edges, at most 8 and
    at most the CPUs there are."""
    return max(1, min(8, os.cpu_count() or 1, e >> 20))


def chunk_subgraphs(senders, receivers, perm, batch_size):
    """The induced subgraph of every chunk of ``perm`` (chunk c: the nodes
    ``perm[c·batch_size:(c + 1)·batch_size]``), in one pass over the
    edges: a list of [2, kept_c] int32 arrays, each equal to
    :func:`induced_subgraph` of its chunk."""
    senders, receivers = _i32(senders), _i32(receivers)
    perm = np.ascontiguousarray(perm, np.int64)
    n = perm.shape[0]
    n_chunks = -(-n // batch_size)
    lib = get_lib()
    if lib is None:
        chunk_of = np.empty(n, np.int64)
        chunk_of[perm] = np.arange(n) // batch_size
        local = np.empty(n, np.int32)
        local[perm] = np.arange(n) % batch_size
        cs = chunk_of[senders]
        keep = np.flatnonzero(cs == chunk_of[receivers])
        order = keep[np.argsort(cs[keep], kind="stable")]
        bounds = np.searchsorted(cs[order], np.arange(n_chunks + 1))
        both = np.stack([local[senders[order]], local[receivers[order]]])
        return [both[:, bounds[c]:bounds[c + 1]] for c in range(n_chunks)]
    e = senders.shape[0]
    offsets = np.empty(n_chunks + 1, np.int64)
    out = np.empty((2, e), np.int32)
    lib.chunk_subgraphs(
        _p(senders, ctypes.c_int32), _p(receivers, ctypes.c_int32), e,
        _p(perm, ctypes.c_int64), n, batch_size, n_chunks, _threads(e),
        _p(offsets, ctypes.c_int64), _p(out[0], ctypes.c_int32),
        _p(out[1], ctypes.c_int32))
    return [out[:, offsets[c]:offsets[c + 1]] for c in range(n_chunks)]


def chunk_csr(senders, receivers, num_nodes, out=None):
    """A chunk's two CSRs with their GCN values (unit weights), as
    ``(row_ptr, col, val, t_row_ptr, t_col, t_val)``: int32 row pointers
    [N + 1] and columns [E], float32 values [E]; the receivers' CSR (the
    senders as columns) and the senders' (the receivers as columns), both
    stable, with the values of :func:`gcn_norm_values`. ``out``, six
    arrays of those shapes (E may be larger; the first E entries are
    written), receives them in place of new arrays."""
    senders, receivers = _i32(senders), _i32(receivers)
    e = senders.shape[0]
    if out is None:
        ptrs = [np.empty(num_nodes + 1, np.int32) for _ in range(2)]
        out = (ptrs[0], np.empty(e, np.int32), np.empty(e, np.float32),
               ptrs[1], np.empty(e, np.int32), np.empty(e, np.float32))
    lib = get_lib()
    if lib is None:
        val = _gcn_values_numpy(senders, receivers, num_nodes, None)
        for (ptr, col, v), key, other in zip(
                (out[:3], out[3:]), (receivers, senders),
                (senders, receivers)):
            order = np.argsort(key, kind="stable")
            ptr[0] = 0
            np.cumsum(np.bincount(key, minlength=num_nodes), out=ptr[1:])
            col[:e], v[:e] = other[order], val[order]
        return out
    row_ptr, col, val, t_row_ptr, t_col, t_val = out
    for a in out:
        if not a.flags.c_contiguous:
            raise ValueError("chunk_csr writes into contiguous arrays only")
    lib.chunk_csr(
        _p(senders, ctypes.c_int32), _p(receivers, ctypes.c_int32), e,
        num_nodes, _p(row_ptr, ctypes.c_int32), _p(col, ctypes.c_int32),
        _p(val, ctypes.c_float), _p(t_row_ptr, ctypes.c_int32),
        _p(t_col, ctypes.c_int32), _p(t_val, ctypes.c_float))
    return out


def _new_csr(num_nodes, e, float_values=True):
    """Six arrays of a CSR pair: row pointers [N + 1], columns [E] and
    values [E] (float32, or int32 without ``float_values``), twice."""
    def one():
        return (np.empty(num_nodes + 1, np.int32), np.empty(e, np.int32),
                np.empty(e, np.float32 if float_values else np.int32))
    return one() + one()


def _check_out(out):
    for a in out:
        if not a.flags.c_contiguous:
            raise ValueError("the chunk plans are written into contiguous "
                             "arrays only")


def _with_loops(senders, receivers, num_nodes):
    loop = np.arange(num_nodes, dtype=np.int32)
    return np.concatenate([senders, loop]), np.concatenate([receivers, loop])


def _csr_numpy(key, other, num_nodes, out):
    """The stable CSR of ``other`` by ``key`` into ``out`` (row pointers,
    columns); returns the order."""
    order = np.argsort(key, kind="stable")
    out[0][0] = 0
    np.cumsum(np.bincount(key, minlength=num_nodes), out=out[0][1:])
    out[1][:order.size] = other[order]
    return order


def chunk_norm_csr(senders, receivers, num_nodes, self_loops, out=None):
    """A chunk's plan of the baseline zoo's ``gcn_norm`` adjacency, as
    ``nn/gnns.py:norm_plan`` builds it on the device (on the CPU: bit for
    bit), as ``(row_ptr, col, val, t_row_ptr, t_col, t_val)``: with
    ``self_loops``, a loop of weight 1 appended on every node (so each
    row's loop comes after its edges in both stable orders); the values
    ``inv[s]·inv[r]`` with ``inv`` ``gcn_norm``'s float32 ``deg^-1/2`` of
    the weighted in-degree (the loop counted), a float square root and a
    float quotient, which round twice where :func:`chunk_csr`'s values
    round once, so the two differ in the last bit at some degrees. E
    counts the loops; ``out`` as :func:`chunk_csr`'s."""
    senders, receivers = _i32(senders), _i32(receivers)
    e = senders.shape[0] + (num_nodes if self_loops else 0)
    out = _new_csr(num_nodes, e) if out is None else out
    lib = get_lib()
    if lib is None:
        s, r = (_with_loops(senders, receivers, num_nodes) if self_loops
                else (senders, receivers))
        deg = np.bincount(r, minlength=num_nodes).astype(np.float32)
        with np.errstate(divide="ignore"):
            inv = np.where(deg > 0, np.float32(1) / np.sqrt(deg),
                           np.float32(0)).astype(np.float32)
        val = inv[s] * inv[r]
        for part, key, other in ((out[:3], r, s), (out[3:], s, r)):
            order = _csr_numpy(key, other, num_nodes, part)
            part[2][:e] = val[order]
        return out
    _check_out(out)
    lib.chunk_norm_csr(
        _p(senders, ctypes.c_int32), _p(receivers, ctypes.c_int32),
        senders.shape[0], num_nodes, int(bool(self_loops)),
        *(_p(a, ctypes.c_float if a.dtype == np.float32 else ctypes.c_int32)
          for a in out))
    return out


def chunk_gat_csr(senders, receivers, num_nodes, out=None):
    """A chunk's GAT plan, as ``nn/gnns.py:gat_plan`` builds it on the
    device, bit for bit, as ``(row_ptr, col, rows, t_row_ptr, t_col,
    t_pos)``, int32: the edges and a self-loop on every node (appended)
    stably sorted by receiver (``col`` the senders, ``rows`` the
    receivers, [E + N]), and that list's transposed CSR, stable by sender
    (``t_col`` the receivers, ``t_pos`` each entry's receiver-order
    position: the plan's ``t_order``). ``out`` as :func:`chunk_csr`'s."""
    senders, receivers = _i32(senders), _i32(receivers)
    e = senders.shape[0] + num_nodes
    out = _new_csr(num_nodes, e, float_values=False) if out is None else out
    lib = get_lib()
    if lib is None:
        s, r = _with_loops(senders, receivers, num_nodes)
        order = _csr_numpy(r, s, num_nodes, out[:2])
        out[2][:e] = r[order]
        t_order = _csr_numpy(out[1][:e], out[2][:e], num_nodes, out[3:5])
        out[5][:e] = t_order
        return out
    _check_out(out)
    lib.chunk_gat_csr(_p(senders, ctypes.c_int32),
                      _p(receivers, ctypes.c_int32), senders.shape[0],
                      num_nodes, *(_p(a, ctypes.c_int32) for a in out))
    return out


def ell_fill(nodes, k, indptr, point_s, val_s):
    """One bucket of the ELL layout: (idx int32 [nb, k], w float32 [nb, k])
    whose row i holds the first k entries of node ``nodes[i]``'s CSR range
    ``indptr[node]:indptr[node + 1]`` of ``point_s`` and ``val_s`` (not
    empty), zero-padded (the JAX package's ``native.ell_fill``)."""
    nodes = np.ascontiguousarray(nodes, np.int64)
    indptr = np.ascontiguousarray(indptr, np.int64)
    point_s = _i32(point_s)
    val_s = np.ascontiguousarray(val_s, np.float32)
    nb = nodes.shape[0]
    lib = get_lib()
    if lib is None:
        starts = indptr[nodes]
        lens = indptr[nodes + 1] - starts
        cols = np.arange(k)[None, :]
        mask = cols < lens[:, None]
        pos = np.minimum(starts[:, None] + cols, point_s.shape[0] - 1)
        return (np.where(mask, point_s[pos], 0).astype(np.int32),
                np.where(mask, val_s[pos], 0.0).astype(np.float32))
    idx = np.empty((nb, k), np.int32)
    w = np.empty((nb, k), np.float32)
    lib.ell_fill(_p(nodes, ctypes.c_int64), nb, k,
                 _p(indptr, ctypes.c_int64), _p(point_s, ctypes.c_int32),
                 _p(val_s, ctypes.c_float), _p(idx, ctypes.c_int32),
                 _p(w, ctypes.c_float))
    return idx, w


def label_propagation(senders, receivers, num_nodes, iters=10, threads=None):
    """int64 labels [num_nodes], compacted to [0, communities): synchronous
    label propagation over the symmetrised edges, as the JAX package's
    ``native.label_propagation``, bit for bit. ``threads`` (default: every
    CPU) share each pass; the labels do not depend on their number. Raises
    where the library is not loaded: ``data/transforms.py`` then takes its
    numpy version."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"the native library is not loaded: {load_error}")
    senders, receivers = _i32(senders), _i32(receivers)
    if senders.shape != receivers.shape or senders.ndim != 1:
        raise ValueError(f"senders and receivers must be [E], got "
                         f"{senders.shape}, {receivers.shape}")
    if senders.size and (min(senders.min(), receivers.min()) < 0
                         or max(senders.max(), receivers.max())
                         >= num_nodes):
        raise ValueError(f"edge indices must lie in [0, {num_nodes})")
    labels = np.empty(num_nodes, np.int64)
    lib.label_propagation(
        _p(senders, ctypes.c_int32), _p(receivers, ctypes.c_int32),
        senders.shape[0], num_nodes, int(iters),
        (os.cpu_count() or 1) if threads is None else int(threads),
        _p(labels, ctypes.c_int64))
    return labels


def knn_neighbors(x, k, *, include_self=True):
    """int64 [N, min(k, N)]: the k nearest rows of each row of x [N, d]
    (cast to float32) by Euclidean distance, nearest first, as the JAX
    package's ``native.knn_neighbors``, bit for bit: float64 distances as
    |a|² − 2a·b + |b|², ties to the lower index, and with
    ``include_self=False`` the row itself at distance 1e300, so that it
    comes last (and is kept when k ≥ N). Every hardware thread takes rows.
    Raises where the library is not loaded."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"the native library is not loaded: {load_error}")
    x = np.ascontiguousarray(x, np.float32)
    if x.ndim != 2:
        raise ValueError(f"x must be [N, d], got {x.shape}")
    n, d = x.shape
    kk = min(int(k), n)
    nbr = np.empty((n, kk), np.int64)
    lib.knn_graph(_p(x, ctypes.c_float), n, d, kk, int(include_self),
                  _p(nbr, ctypes.c_int64))
    return nbr
