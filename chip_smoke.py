"""Smoke run of difformer_tpu_torch on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases, each printing its results on lines of its own; any failure exits
non-zero before the last line:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 off for matmul and cuDNN.
2. build: compile the CUDA kernels from ``difformer_tpu_torch/csrc``, one
   ``nvcc`` for each source, all at once.
3. kernels: every kernel against its plain PyTorch version on the card,
   under the one tolerance rule of
   ``difformer_tpu_torch/kernels/tolerance.py``, which is shown to fail an
   output of zeros or of misplaced rows: the flash sigmoid attention of
   DIFFormer-a (forward with and without normalisation, dq, dk/dv) at four
   shapes, with the split S of each kernel's loop axis and the blocks it
   launches; and the GCN branch's CSR SpMM K1, forward and transposed, at
   seven shapes from Cora's to Pokec's size (at Pokec's, with uniform and
   with power-law degrees), with its split schedule of heavy rows, its
   device kernels a call, two calls bit-equal, and cuSPARSE's time for the
   same product beside it. Each with its time, its bound and (K1) the
   gather floor.
4. slice: the cora preset as DIFFormer-a (hidden 64, 8 layers, 1 head) on a
   synthetic graph of Cora's size, trained with ``FullBatchTrainer.fit``;
   checks the losses, that every kernel ran as often as the path needs, and
   the logits against the same model through the plain versions; times a
   train step and an eval forward, and breaks the train step's device time
   down by operation with torch.profiler.
5. slice-s: the same for the main path, the cora preset as DIFFormer-s
   (``kernel="simple"``), whose one kernel is K1; the step's profile must
   show no sort and no ``index_add_``.
6. slice-s-h8: the cora preset at 8 heads, where every "auto" rewrite is
   on (head mean fused, Wv factored, spmm_first with K1 at width 65), for
   a few steps, with the logits against the plain version.

Then one JSON line with every kernel's numbers, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``. It needs a CUDA device and
the repository around it; it imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import unittest.mock

import numpy as np
import torch

import difformer_tpu_torch  # noqa: F401  (fails before any output outside the repository)

# Published peaks of one H100 SXM (dense): FP32 outside the tensor cores and
# bf16 tensor-core rate, in operations per second; HBM3 bytes per second.
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12

# (N, L, H, M, D, dtype, masked): the slice's shape, ragged edges with a key
# mask, bf16 with four heads, and pubmed's size
SHAPES = [
    (2708, 2708, 1, 64, 64, torch.float32, False),
    (1000, 1300, 2, 32, 48, torch.float32, True),
    (4096, 4096, 4, 64, 64, torch.bfloat16, False),
    (19717, 19717, 1, 64, 64, torch.float32, False),
]
SOURCE = "difformer_tpu_torch/csrc/sigmoid_attention.cu"
PALLAS = "difformer_tpu/kernels/pallas_sigmoid_attention.py"
REPLACES = {
    "sigmoid_attention_fwd": f"{PALLAS}:154",
    "sigmoid_attention_dq": f"{PALLAS}:340",
    "sigmoid_attention_dkv": f"{PALLAS}:359",
}
# K1, the CSR SpMM of the GCN branch: one kernel, launched over the forward
# CSR and over the transposed one (the backward), counted apart
SPMM_SOURCE = "difformer_tpu_torch/csrc/spmm.cu"
SPMM_REPLACES = "difformer_tpu/ops/graph_ops.py:107"
SPMM_NAMES = ("csr_spmm", "csr_spmm_transposed")
# the K1 shapes of the JSON line, by label, with the suffix of their names
SPMM_JSON = {"cora": "", "pokec": " pokec",
             "pokec power-law": " pokec power-law"}
# Pokec's size (the pokec preset's graph, 1,632,803 nodes and 30,622,564
# edges) at its hidden width
POKEC_NODES, POKEC_EDGES = 1_632_803, 30_622_564
# the power-law graph of Pokec's size: node ids drawn as floor(N·u^2) of a
# uniform u, so a node's degree falls as its rank^(-1/2)
POWER_LAW_EXPONENT = 2
PLAIN_EDGE_CHUNK = 1 << 22  # the plain version's messages at Pokec's size
EPOCHS = 20
H8_STEPS = 3
# device launches per train step of the slices with K1 before its split
# schedule (commit 17d4e95), for comparison
UNSPLIT_LAUNCHES = {"slice": 498, "slice-s": 938}


def say(*parts):
    print(*parts, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, target_ms=100.0, max_iters=50):
    """Mean device time of ``fn`` in ms from CUDA events, after warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    end.synchronize()
    iters = max(3, min(max_iters, int(target_ms / max(
        start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, calls=20):
    """(device ms, device operations) of one call of ``fn``: the time of the
    device's own kernels, copies and sets over ``calls`` calls
    (torch.profiler), and their number, each divided by ``calls``. Unlike
    :func:`cuda_ms` the time leaves out the device's idle gaps, which set the
    event time of a call whose kernels take a few microseconds and whose host
    side takes tens. A session that records fewer device operations than
    calls lost some (the profiler now and then returns none at all) and is
    run again, up to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
        count = sum(e.count for e in events)
        if count >= calls:
            return (sum(e.self_device_time_total for e in events) / 1e3
                    / calls, count / calls)
    raise RuntimeError(f"the profiler recorded fewer than {calls} device "
                       f"operations in each of three sessions")


def device_ms(fn, calls=20):
    """Device time in ms of one call of ``fn`` (:func:`device_profile`)."""
    return device_profile(fn, calls)[0]


def bound_ms(name, n, l, h, m, d, dtype):
    """(least time for the work in ms, "bytes" or "operations"): the larger
    of bytes over the HBM rate and flops over the peak rate for the dtype.
    Each input is read once and each output written once; the N·L·H
    sigmoids are not counted."""
    e = torch.tensor([], dtype=dtype).element_size()
    qkv = (n * m + l * m + l * d) * h * e
    grads_in = (n * d + n) * h * 4
    if name == "sigmoid_attention_fwd":
        flops = 2 * n * l * h * (m + d + 1)
        nbytes = qkv + n * h * d * e + n * h * 4
    elif name == "sigmoid_attention_dq":
        flops = 2 * n * l * h * (2 * m + d)
        nbytes = qkv + grads_in + n * h * m * e
    else:
        flops = 2 * n * l * h * (2 * m + 2 * d)
        nbytes = qkv + grads_in + l * h * (m + d) * e
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_OPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                        else "operations")


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    smi = nvidia_smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"phase device: {smi} | torch {torch.__version__} | CUDA "
        f"{torch.version.cuda} | devices {torch.cuda.device_count()}")
    say(f"phase device: allow_tf32 matmul="
        f"{torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return smi


def phase_build():
    from difformer_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.load_library()
    info = build.build_info
    say(f"phase build: {', '.join(info['paths'])} built in "
        f"{info['seconds']:.1f} s (cached={info['cached']}, load "
        f"{time.perf_counter() - t0:.1f} s)")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            say(f"  ptxas: {line.split(':', 1)[-1].strip()}")


def attention_case(n, l, h, m, d, dtype, masked, seed):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((n, h, m), generator=g).to("cuda", dtype)
    k = torch.randn((l, h, m), generator=g).to("cuda", dtype)
    v = torch.randn((l, h, d), generator=g).to("cuda", dtype)
    mask = None
    if masked:
        mask = (torch.rand(l, generator=g) > 0.3).float()
        mask[0] = 1.0
        mask = mask.cuda()
    cot = torch.randn((n, h, d), generator=g).cuda()
    return q, k, v, mask, cot


def assert_rejects(label, ref, kind, den=None, scale=None):
    """The comparison must fail an output of zeros and one whose rows are
    each moved one place down: a check that passes either cannot tell a
    wrong kernel from a right one at this shape."""
    from difformer_tpu_torch.kernels.tolerance import assert_close

    for wrong, what in ((torch.zeros_like(ref), "zeros"),
                        (ref.roll(1, 0), "rows moved one place")):
        try:
            assert_close(label, wrong, ref, kind, den, scale)
        except AssertionError:
            continue
        raise AssertionError(f"{label}: the tolerance passes {what}")


def phase_kernels():
    """Each kernel against its plain version under the rule of
    ``kernels/tolerance.py``: float32 at the JAX package's tolerances, the
    unnormalized numerator per unit of its row's denominator, bfloat16
    relative to the largest reference value. Each comparison is shown to
    fail a wrong output of the same shape. Times from CUDA events at every
    shape, and at the slice's shape also the device time
    (:func:`device_ms`), which the JSON line reports for every kernel."""
    from difformer_tpu_torch.kernels import sigmoid_attention as K
    from difformer_tpu_torch.kernels.tolerance import assert_close

    rows = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for idx, (n, l, h, m, d, dtype, masked) in enumerate(SHAPES):
        q, k, v, mask, g = attention_case(n, l, h, m, d, dtype, masked, idx)
        label = (f"N={n} L={l} H={h} M={m} D={d} "
                 f"{str(dtype).split('.')[-1]}{' mask' if masked else ''}")

        out, den = K.sigmoid_attention_fwd(q, k, v, mask)
        r_out, r_den = K.sigmoid_attention_fwd_plain(q, k, v, mask)
        e_fwd = max(assert_close(f"fwd out {label}", out, r_out, "out"),
                    assert_close(f"fwd den {label}", den, r_den, "den"))
        num, den_u = K.sigmoid_attention_fwd(q, k, v, mask, normalize=False)
        r_num, r_den_u = K.sigmoid_attention_fwd_plain(q, k, v, mask,
                                                       normalize=False)
        e_unnorm = max(
            assert_close(f"fwd num {label}", num, r_num, "num", den=r_den_u),
            assert_close(f"fwd den (unnormalized) {label}", den_u, r_den_u,
                         "den"))

        # cotangents as the normalized op's backward derives them
        dnum = g / den[..., None]
        dden = -(g * out.float()).sum(-1) / den
        dq = K.sigmoid_attention_dq(q, k, v, mask, dnum, dden)
        r_dq = K.sigmoid_attention_dq_plain(q, k, v, mask, dnum, dden)
        e_dq = assert_close(f"dq {label}", dq, r_dq, "grad")
        dk, dv = K.sigmoid_attention_dkv(q, k, v, mask, dnum, dden)
        r_dk, r_dv = K.sigmoid_attention_dkv_plain(q, k, v, mask, dnum, dden)
        e_dkv = max(assert_close(f"dk {label}", dk, r_dk, "grad"),
                    assert_close(f"dv {label}", dv, r_dv, "grad"))
        for name, ref, kind, den_ref in (
                ("out", r_out, "out", None), ("den", r_den, "den", None),
                ("num", r_num, "num", r_den_u), ("dq", r_dq, "grad", None),
                ("dk", r_dk, "grad", None), ("dv", r_dv, "grad", None)):
            assert_rejects(f"{name} {label}", ref, kind, den_ref)
        torch.cuda.synchronize()

        cases = {
            "sigmoid_attention_fwd": (
                e_fwd, lambda: K.sigmoid_attention_fwd(q, k, v, mask),
                lambda: K.sigmoid_attention_fwd_plain(q, k, v, mask)),
            "sigmoid_attention_dq": (
                e_dq,
                lambda: K.sigmoid_attention_dq(q, k, v, mask, dnum, dden),
                lambda: K.sigmoid_attention_dq_plain(q, k, v, mask, dnum,
                                                     dden)),
            "sigmoid_attention_dkv": (
                e_dkv,
                lambda: K.sigmoid_attention_dkv(q, k, v, mask, dnum, dden),
                lambda: K.sigmoid_attention_dkv_plain(q, k, v, mask, dnum,
                                                      dden)),
        }
        unnorm_ms = cuda_ms(
            lambda: K.sigmoid_attention_fwd(q, k, v, mask, normalize=False))
        grids = {}
        for name in cases:
            per_split, splits, chunk = K.split_plan(name, n, l, h, m, d, sms)
            grids[name] = (f" | S={splits} ({chunk} loop tiles each), "
                           f"{per_split * splits} blocks")
        for name, (err, kernel, plain) in cases.items():
            ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
            bound, bound_by = bound_ms(name, n, l, h, m, d, dtype)
            device = ""
            if idx == 0:
                # the JSON line's times are device times, as K1's
                dev_ms, dev_plain_ms = device_ms(kernel), device_ms(plain)
                rows[name] = dict(max_abs_err=err, ms=dev_ms,
                                  plain_ms=dev_plain_ms, bound_ms=bound,
                                  bound_by=bound_by)
                device = (f" | device {dev_ms:.4f} ms, plain "
                          f"{dev_plain_ms:.4f} ms")
            say(f"phase kernels: {name:22s} {label:40s} max_abs_err "
                f"{err:.3e} | kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | "
                f"bound {bound:.4f} ms by {bound_by} "
                f"({100 * bound / ms:.1f}% of the kernel's time)"
                f"{device}{grids[name]}")
        say(f"phase kernels: sigmoid_attention_fwd normalize=False "
            f"{label:40s} max_abs_err {e_unnorm:.3e} | kernel "
            f"{unnorm_ms:.4f} ms{grids['sigmoid_attention_fwd']}")
        del q, k, v, mask, g, out, den, num, den_u, dq, dk, dv
        del r_out, r_den, r_num, r_den_u, r_dq, r_dk, r_dv
        torch.cuda.empty_cache()
    return rows


def spmm_bound_ms(n, e, w):
    """(least time in ms, "bytes" or "operations", compulsory bytes) of one
    K1 product: x and out once each, int32 columns, float32 values and
    int32 row pointers; 2·E·W flops."""
    nbytes = (2 * n * w + 2 * e + n + 1) * 4
    t_bytes, t_ops = nbytes / PEAK_BYTES, 2 * e * w / PEAK_OPS[torch.float32]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes > t_ops else "operations", nbytes)


def spmm_gather_floor_ms(n, e, w):
    """The gather floor of one K1 product in ms, a diagnostic beside its
    bound: every gathered row x[col[e]] (E·W floats), out, col, val and
    row_ptr, each moved once from HBM with no reuse in L2. K1 can beat it
    only where L2 holds rows that many edges gather."""
    return 1e3 * (e * w + n * w + 2 * e + n + 1) * 4 / PEAK_BYTES


def cora_graph(f=1433):
    """The slice's synthetic graph of Cora's size (numpy)."""
    from difformer_tpu_torch.data import random_graph, standard_preprocess

    x, ei, y = random_graph(2708, 10556, f, 7, seed=42, homophily=0.8)
    return x, standard_preprocess(ei, 2708), y


def spmm_shapes():
    """(label, plan, W, plain edge chunk) at K1's seven shapes, one at a
    time: the slice's graph at the widths the model gives K1 (64; 65 under
    spmm_first; 8 heads of 64 unfused), a ragged graph (unsorted edges,
    edge_mask, edge_weight, empty rows of both CSRs), a graph of PubMed's
    size, and two of Pokec's, whose edges are drawn on the card: one with
    uniform senders and receivers (every row near the mean degree, 18.8)
    and one with power-law in- and out-degrees, where one group of lanes
    walks a row of tens of thousands of edges."""
    from difformer_tpu_torch.data import random_graph, standard_preprocess
    from difformer_tpu_torch.ops.graph_ops import build_csr_plan

    def plan_of(ei, n, weight=None, mask=None):
        t = lambda a: None if a is None else torch.as_tensor(a, device="cuda")
        return build_csr_plan(t(ei[0]), t(ei[1]), n, t(weight), t(mask))

    _, ei, _ = cora_graph()
    cora = plan_of(ei, 2708)
    yield "cora", cora, 64, None
    yield "cora spmm_first", cora, 65, None
    yield "cora H=8 unfused", cora, 8 * 64, None
    del cora
    rng = np.random.default_rng(5)
    n, e = 1000, 6000
    ei = np.stack([rng.integers(0, 950, e), rng.integers(0, 900, e)])
    yield ("ragged", plan_of(ei, n, rng.uniform(0.2, 2.0, e).astype(
        np.float32), rng.random(e) > 0.2), 48, None)
    _, ei, _ = random_graph(19717, 44324, 500, 3, seed=7, homophily=0.8)
    yield "pubmed", plan_of(standard_preprocess(ei, 19717), 19717), 64, None
    g = torch.Generator("cuda").manual_seed(11)
    n, e = POKEC_NODES, POKEC_EDGES
    senders = torch.randint(0, n, (e,), device="cuda", generator=g)
    receivers = torch.randint(0, n, (e,), device="cuda", generator=g)
    receivers = receivers.sort().values
    plan = build_csr_plan(senders, receivers, n)
    del senders, receivers
    yield "pokec", plan, 128, PLAIN_EDGE_CHUNK
    del plan
    senders = power_law_nodes(n, e, g)
    receivers = power_law_nodes(n, e, g).sort().values
    plan = build_csr_plan(senders, receivers, n)
    del senders, receivers
    yield "pokec power-law", plan, 128, PLAIN_EDGE_CHUNK


def power_law_nodes(n, e, g):
    """``e`` node ids on the card, rank ``floor(n·u^2)`` of a uniform u, so
    the rank-i node is drawn with probability √(i+1) − √i ≈ 1/(2√i); the
    ranks are shuffled over the ids."""
    u = torch.rand(e, device="cuda", generator=g, dtype=torch.float64)
    rank = (n * u.pow_(POWER_LAW_EXPONENT)).long().clamp_(max=n - 1)
    return torch.randperm(n, device="cuda", generator=g)[rank]


def library_spmm(row_ptr, col, val, n):
    """cuSPARSE's CSR SpMM through one PyTorch call, for its time."""
    a = torch.sparse_csr_tensor(row_ptr, col, val, size=(n, n))
    return lambda x: torch.sparse.mm(a, x)


def phase_spmm_kernels():
    """K1 forward (the receivers' CSR) and transposed (the senders' CSR,
    the backward) against its plain version at every shape, each
    comparison shown to fail a wrong output and two calls shown bit-equal;
    the split schedule (T, heavy rows, segments) and the device kernels a
    call, which must be one without heavy rows and two with them (the
    segments' combine); kernel, plain and cuSPARSE device times
    (:func:`device_profile`) beside the bound and the gather floor, and the
    kernel's event time (:func:`cuda_ms`, which the host's launch rate sets
    at the small shapes). Returns the JSON rows of the shapes in
    ``SPMM_JSON``."""
    from difformer_tpu_torch.kernels import spmm as K1
    from difformer_tpu_torch.kernels.tolerance import assert_close

    rows = {}
    for idx, (label, plan, w, chunk) in enumerate(spmm_shapes()):
        n, e = plan.num_nodes, plan.num_edges
        g = torch.Generator("cuda").manual_seed(100 + idx)
        x = torch.randn((n, w), device="cuda", generator=g)
        bound, bound_by, nbytes = spmm_bound_ms(n, e, w)
        floor = spmm_gather_floor_ms(n, e, w)
        for name, (ptr, col, val), split in zip(SPMM_NAMES, (
                (plan.row_ptr, plan.col, plan.val),
                (plan.t_row_ptr, plan.t_col, plan.t_val)),
                (plan.split, plan.t_split)):
            transposed = name == "csr_spmm_transposed"
            kernel = lambda: K1.csr_spmm(x, ptr, col, val, split=split,
                                         transposed=transposed)
            plain = lambda: K1.csr_spmm_plain(x, ptr, col, val,
                                              edge_chunk_size=chunk)
            library = library_spmm(ptr, col, val, n)
            out, ref = kernel(), plain()
            scale = K1.csr_spmm_abs(x, ptr, col, val, edge_chunk_size=chunk)
            tag = f"{name} {label} N={n} E={e} W={w}"
            err = assert_close(tag, out, ref, "spmm", scale=scale)
            assert_rejects(tag, ref, "spmm", scale=scale)
            if not torch.equal(out, kernel()):
                raise AssertionError(f"{tag}: two calls differ")
            lib_err = (library(x) - ref).abs().max().item()
            most = int((ptr[1:] - ptr[:-1]).max())
            del out, ref, scale
            torch.cuda.synchronize()
            event_ms = cuda_ms(kernel)
            ms, kernels = device_profile(kernel)
            plain_ms = device_ms(plain)
            library_ms = device_ms(lambda: library(x))
            expect = 2 if split.num_heavy else 1
            say(f"phase kernels: {tag:52s} max_abs_err {err:.3e}, two calls "
                f"bit-equal | largest degree {most}, T={split.threshold}: "
                f"{split.num_heavy} heavy rows, {split.num_segments} "
                f"segments | kernel {ms:.4f} ms in {kernels:g} device "
                f"kernels a call (events {event_ms:.4f} ms) | plain "
                f"{plain_ms:.4f} ms | cuSPARSE {library_ms:.4f} ms "
                f"(max_abs_err {lib_err:.3e}) | bound {bound:.4f} ms by "
                f"{bound_by} ({nbytes / 1e6:.2f} MB; {100 * bound / ms:.1f}% "
                f"of the kernel's time) | gather floor {floor:.4f} ms "
                f"({e * w * 4 / 1e9:.4f} GB of gathered rows; "
                f"{100 * floor / ms:.1f}% of the kernel's time)")
            if kernels != expect:
                raise AssertionError(f"{tag}: {kernels:g} device kernels a "
                                     f"call, expected {expect}")
            if label in SPMM_JSON:
                rows[f"{name}{SPMM_JSON[label]}"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound, bound_by=bound_by,
                    library_ms=library_ms)
        del plan, x
        torch.cuda.empty_cache()
    return rows


class PlainSpmm:
    """K1's autograd Function with the plain version in its place, for a
    reference forward on the card."""

    @staticmethod
    def apply(x, fwd, bwd, edge_chunk_size):
        from difformer_tpu_torch.kernels.spmm import csr_spmm_plain

        return csr_spmm_plain(x, *fwd[:3], edge_chunk_size=edge_chunk_size)


def plain_attention(qs, ks, vs, *, key_mask=None):
    """The model's attention through the plain version (forward only)."""
    from difformer_tpu_torch.kernels import sigmoid_attention as K

    if vs.shape[1] != qs.shape[1]:
        vs = vs.expand(-1, qs.shape[1], -1)
    return K.sigmoid_attention_fwd_plain(qs, ks, vs, key_mask)[0]


def launch_counts():
    """Every kernel's launches since the last reset, by wrapper name."""
    from difformer_tpu_torch.kernels import sigmoid_attention as K
    from difformer_tpu_torch.kernels import spmm as K1

    return {**K.LAUNCHES, **K1.LAUNCHES}


def reset_launch_counts():
    from difformer_tpu_torch.kernels import sigmoid_attention as K
    from difformer_tpu_torch.kernels import spmm as K1

    K.reset_launch_counts()
    K1.reset_launch_counts()


def through_plain_versions():
    """A context in which the model runs every kernel's plain version."""
    import contextlib

    import difformer_tpu_torch.nn.difformer as difformer_module
    from difformer_tpu_torch.ops import graph_ops

    stack = contextlib.ExitStack()
    stack.enter_context(unittest.mock.patch.object(
        difformer_module, "sigmoid_attention", plain_attention))
    stack.enter_context(unittest.mock.patch.object(
        graph_ops, "CsrSpmm", PlainSpmm))
    return stack


def make_slice(cfg):
    """(trainer, split, N, C) of the cora preset ``cfg`` on the slice's
    synthetic graph of Cora's size, at full width and depth."""
    from difformer_tpu_torch import DIFFormer, FullBatchTrainer, GraphData
    from difformer_tpu_torch.data import class_rand_splits

    x, ei, y = cora_graph()
    (n, f), c = x.shape, int(y.max()) + 1
    split = class_rand_splits(y, cfg.label_num_per_class, rng=cfg.seed)
    graph = GraphData.from_numpy(x, ei, device="cuda")
    model = DIFFormer(
        f, cfg.hidden_channels, c, num_layers=cfg.num_layers,
        num_heads=cfg.num_heads, kernel=cfg.kernel, alpha=cfg.alpha,
        dropout=cfg.dropout, use_bn=cfg.use_bn,
        use_residual=cfg.use_residual, use_weight=cfg.use_weight,
        use_graph=cfg.use_graph, graph_weight=cfg.graph_weight,
        use_source=cfg.use_source, spmm_first=cfg.spmm_first,
        fuse_head_mean=cfg.fuse_head_mean, seed=cfg.seed, device="cuda")
    trainer = FullBatchTrainer(model, graph, y, lr=cfg.lr,
                               weight_decay=cfg.weight_decay, seed=cfg.seed,
                               device="cuda")
    say(f"phase {cfg.kernel} slice: cora preset: N={n} "
        f"E={graph.num_edges} F={f} C={c} kernel={cfg.kernel} "
        f"hidden={cfg.hidden_channels} layers={cfg.num_layers} "
        f"heads={cfg.num_heads} dropout={cfg.dropout} lr={cfg.lr} "
        f"wd={cfg.weight_decay} spmm_first={cfg.spmm_first} "
        f"fuse_head_mean={cfg.fuse_head_mean}")
    return trainer, split, n, c


def check_logits(phase, trainer, state, n, c):
    """Logits through the kernels against the same model through the plain
    versions, on the card."""
    logits = trainer.forward_eval(state)
    with through_plain_versions():
        ref = trainer.forward_eval(state)
    if logits.shape != (n, c):
        raise AssertionError(f"logits shape {tuple(logits.shape)}")
    torch.testing.assert_close(logits, ref, rtol=1e-3, atol=1e-4)
    say(f"phase {phase}: logits kernel vs plain max_abs_err "
        f"{(logits - ref).abs().max().item():.3e}")


def time_steps(phase, trainer, state, split, n, steps=20):
    """Host-clock ms of a train step and an eval forward (synchronised),
    and peak memory while training; then the step's device time by
    kernel. Returns the profile's rows."""
    train_mask = torch.as_tensor(
        np.isin(np.arange(n), split["train"]), device="cuda")
    gen = torch.Generator("cuda").manual_seed(0)
    for _ in range(3):
        trainer.train_step(state, gen, train_mask)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        trainer.train_step(state, gen, train_mask)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / steps
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    t0 = time.perf_counter()
    for _ in range(steps):
        trainer.forward_eval(state)
    torch.cuda.synchronize()
    eval_ms = 1e3 * (time.perf_counter() - t0) / steps
    say(f"phase {phase}: train step {step_ms:.3f} ms | eval forward "
        f"{eval_ms:.3f} ms | peak memory {peak_mib:.1f} MiB (train)")
    return profile_steps(lambda: trainer.train_step(state, gen, train_mask),
                         step_ms, phase)


def run_slice(phase, cfg, expect):
    """Drive the path: ``FullBatchTrainer.fit`` for EPOCHS epochs with the
    launch counts set to 0 just before and read just after; check the
    losses, the launches and the logits; time and profile the step.
    Returns (launches, profile rows)."""
    trainer, split, n, c = make_slice(cfg)
    reset_launch_counts()
    t0 = time.perf_counter()
    best = trainer.fit(split, epochs=EPOCHS, eval_step=1)[0]
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = launch_counts()

    losses = best["losses"]
    say(f"phase {phase}: fit {EPOCHS} epochs in {fit_s:.2f} s; losses "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; best epoch {best['epoch']} "
        f"train {best['train']:.4f} valid {best['valid']:.4f} "
        f"test {best['test']:.4f}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    say(f"phase {phase}: launches {launches} (expected {expect})")
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")

    state = trainer.init_state(0)
    check_logits(phase, trainer, state, n, c)
    return launches, time_steps(phase, trainer, state, split, n)


def expected_launches(layers, attention):
    """Launches of a 20-epoch fit: each layer runs its attention and its
    graph branch forward in every train step and every eval, and their
    backward in every train step."""
    fwd, bwd = 2 * layers * EPOCHS, layers * EPOCHS
    sig = fwd if attention else 0
    return {"sigmoid_attention_fwd": sig,
            "sigmoid_attention_dq": sig // 2,
            "sigmoid_attention_dkv": sig // 2,
            "csr_spmm": fwd, "csr_spmm_transposed": bwd}


def phase_slice():
    """DIFFormer-a: K2–K4 in the attention, K1 in the GCN branch."""
    from difformer_tpu_torch.utils.config import make_config

    cfg = make_config("cora", kernel="sigmoid")
    return run_slice("slice", cfg, expected_launches(cfg.num_layers, True))[0]


def phase_slice_s():
    """DIFFormer-s, the main path: K1 in the GCN branch, the linear
    attention in torch matmuls. The step must do no sort and no
    ``index_add_`` (the plan is built once, at the trainer's start)."""
    from difformer_tpu_torch.utils.config import make_config

    cfg = make_config("cora")
    launches, rows = run_slice("slice-s", cfg,
                               expected_launches(cfg.num_layers, False))
    found = [key for _, _, key in rows
             if "sort" in key.lower() or "indexfunc" in key.lower()]
    say(f"phase slice-s: sort or index_add_ kernels in the step: "
        f"{found or 'none'}")
    if found:
        raise AssertionError(f"the step sorts or scatters: {found}")
    return launches


def phase_slice_s_h8():
    """The cora preset at 8 heads: fused head mean, Wv factored through the
    key aggregates, spmm_first (K1 at F+1 = 65). A few train steps, then
    the logits against the plain versions."""
    from difformer_tpu_torch.ops import graph_ops
    from difformer_tpu_torch.utils.config import make_config

    cfg = make_config("cora", num_heads=8)
    trainer, split, n, c = make_slice(cfg)
    state = trainer.init_state(0)
    train_mask = torch.as_tensor(
        np.isin(np.arange(n), split["train"]), device="cuda")
    gen = torch.Generator("cuda").manual_seed(0)
    widths = []
    real = graph_ops.CsrSpmm

    def recording(x, fwd, bwd, edge_chunk_size):
        widths.append(x.shape[1])
        return real.apply(x, fwd, bwd, edge_chunk_size)

    reset_launch_counts()
    with unittest.mock.patch.object(
            graph_ops, "CsrSpmm", unittest.mock.Mock(apply=recording)):
        losses = [trainer.train_step(state, gen, train_mask)[1].item()
                  for _ in range(H8_STEPS)]
    torch.cuda.synchronize()
    launches = launch_counts()
    layers = cfg.num_layers
    expect = dict(expected_launches(layers, False),
                  csr_spmm=layers * H8_STEPS,
                  csr_spmm_transposed=layers * H8_STEPS)
    say(f"phase slice-s-h8: {H8_STEPS} steps, losses {losses}; K1 widths "
        f"{sorted(set(widths))}; launches {launches} (expected {expect})")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if launches != expect or set(widths) != {cfg.hidden_channels + 1}:
        raise AssertionError("the spmm_first path did not run through K1")
    check_logits("slice-s-h8", trainer, state, n, c)
    time_steps("slice-s-h8", trainer, state, split, n, steps=5)


def profile_steps(step, step_ms, phase, steps=5, top=12):
    """Device time by kernel over ``steps`` train steps (torch.profiler),
    and its share of ``step_ms``, the step's time measured without the
    profiler. Only the device's own kernels and copies are summed: the
    CPU-side ranges of the autograd Functions also carry the ctypes-launched
    kernels' time as theirs, and the optimizer's range is mirrored on the
    device as an annotation spanning its kernels. Returns the rows
    (ms per step, launches per step, kernel name), longest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total / 1e3 / steps, e.count // steps,
                    e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and e.self_device_time_total > 0), reverse=True)
    if not rows:
        say(f"phase {phase} profile: the profiler saw no device time (not "
            f"measured)")
        return rows
    busy = sum(r[0] for r in rows)
    before = (f" ({UNSPLIT_LAUNCHES[phase]} before K1's split schedule)"
              if phase in UNSPLIT_LAUNCHES else "")
    say(f"phase {phase} profile: device time {busy:.4f} ms per train step "
        f"over {steps} steps = {100 * busy / step_ms:.1f}% of the "
        f"{step_ms:.3f} ms step (idle {100 * (1 - busy / step_ms):.1f}%), "
        f"{sum(r[1] for r in rows)} launches per step{before}")
    for ms, count, key in rows[:top]:
        say(f"phase {phase} profile: {ms:9.4f} ms/step "
            f"{100 * ms / busy:5.1f}% x{count:<3d} {key[:100]}")
    return rows


def main():
    t0 = time.perf_counter()
    smi = phase_device()
    phase_build()
    rows = phase_kernels()
    spmm_rows = phase_spmm_kernels()
    say(f"phase kernels: done at {time.perf_counter() - t0:.1f} s")
    launches = phase_slice()
    launches_s = phase_slice_s()
    phase_slice_s_h8()
    say(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    # every ms, plain_ms and library_ms is a device time (device_ms) at the
    # slice's shape (K1 also at Pokec's)
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": row["max_abs_err"], "ms": row["ms"],
         "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
         "bound_by": row["bound_by"], "library_ms": None}
        for name, row in rows.items()
    ] + [
        # K1 on the main path, DIFFormer-s, at the slice's graph and at
        # Pokec's size; launches are the main path's
        {"name": name, "route": "cuda", "source": SPMM_SOURCE,
         "replaces": SPMM_REPLACES, "launches": launches_s[name.split()[0]],
         **row}
        for name, row in spmm_rows.items()
    ]
    say(json.dumps({"kernels": kernels}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
