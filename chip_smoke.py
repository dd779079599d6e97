"""Smoke run of difformer_tpu_torch on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases, each printing its results on lines of its own; any failure exits
non-zero before the last line:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 off for matmul and cuDNN.
2. build: compile the CUDA kernels from ``difformer_tpu_torch/csrc``.
3. kernels: every kernel of the DIFFormer-a path (flash sigmoid attention
   forward with and without normalisation, dq, dk/dv) against its plain
   PyTorch version on the card, at four shapes, under the one tolerance
   rule of ``difformer_tpu_torch/kernels/tolerance.py``, which is shown to
   fail an output of zeros or of misplaced rows; with times.
4. slice: the cora preset as DIFFormer-a (hidden 64, 8 layers, 1 head) on a
   synthetic graph of Cora's size, trained with ``FullBatchTrainer.fit``;
   checks the losses, that every kernel ran as often as the path needs, and
   the logits against the same model through the plain versions; times a
   train step and an eval forward, and breaks the train step's device time
   down by operation with torch.profiler.

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
EPOCHS = 20


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
    say(f"phase build: {info['path']} built in {info['seconds']:.1f} s "
        f"(cached={info['cached']}, load {time.perf_counter() - t0:.1f} s)")
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


def assert_rejects(label, ref, kind, den=None):
    """The comparison must fail an output of zeros and one whose rows are
    each moved one place down: a check that passes either cannot tell a
    wrong kernel from a right one at this shape."""
    from difformer_tpu_torch.kernels.tolerance import assert_close

    for wrong, what in ((torch.zeros_like(ref), "zeros"),
                        (ref.roll(1, 0), "rows moved one place")):
        try:
            assert_close(label, wrong, ref, kind, den)
        except AssertionError:
            continue
        raise AssertionError(f"{label}: the tolerance passes {what}")


def phase_kernels():
    """Each kernel against its plain version under the rule of
    ``kernels/tolerance.py``: float32 at the JAX package's tolerances, the
    unnormalized numerator per unit of its row's denominator, bfloat16
    relative to the largest reference value. Each comparison is shown to
    fail a wrong output of the same shape."""
    from difformer_tpu_torch.kernels import sigmoid_attention as K
    from difformer_tpu_torch.kernels.tolerance import assert_close

    rows = {}
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
        for name, (err, kernel, plain) in cases.items():
            ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
            bound, bound_by = bound_ms(name, n, l, h, m, d, dtype)
            say(f"phase kernels: {name:22s} {label:40s} max_abs_err "
                f"{err:.3e} | kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | "
                f"bound {bound:.4f} ms by {bound_by} "
                f"({100 * bound / ms:.1f}% of the kernel's time)")
            if idx == 0:
                rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound, bound_by=bound_by)
        say(f"phase kernels: sigmoid_attention_fwd normalize=False "
            f"{label:40s} max_abs_err {e_unnorm:.3e} | kernel "
            f"{unnorm_ms:.4f} ms")
        del q, k, v, mask, g, out, den, num, den_u, dq, dk, dv
        del r_out, r_den, r_num, r_den_u, r_dq, r_dk, r_dv
        torch.cuda.empty_cache()
    return rows


def plain_attention(qs, ks, vs, *, key_mask=None):
    """The model's attention through the plain version (forward only)."""
    from difformer_tpu_torch.kernels import sigmoid_attention as K

    if vs.shape[1] != qs.shape[1]:
        vs = vs.expand(-1, qs.shape[1], -1)
    return K.sigmoid_attention_fwd_plain(qs, ks, vs, key_mask)[0]


def phase_slice():
    import difformer_tpu_torch.nn.difformer as difformer_module
    from difformer_tpu_torch import DIFFormer, FullBatchTrainer, GraphData
    from difformer_tpu_torch.data import (
        class_rand_splits,
        random_graph,
        standard_preprocess,
    )
    from difformer_tpu_torch.kernels import sigmoid_attention as K
    from difformer_tpu_torch.utils.config import make_config

    cfg = make_config("cora", kernel="sigmoid")
    n, e, f, c = 2708, 10556, 1433, 7
    x, ei, y = random_graph(n, e, f, c, seed=42, homophily=0.8)
    ei = standard_preprocess(ei, n)
    split = class_rand_splits(y, cfg.label_num_per_class, rng=cfg.seed)
    graph = GraphData.from_numpy(x, ei, device="cuda")
    model = DIFFormer(
        f, cfg.hidden_channels, c, num_layers=cfg.num_layers,
        num_heads=cfg.num_heads, kernel=cfg.kernel, alpha=cfg.alpha,
        dropout=cfg.dropout, use_bn=cfg.use_bn,
        use_residual=cfg.use_residual, use_weight=cfg.use_weight,
        use_graph=cfg.use_graph, graph_weight=cfg.graph_weight,
        use_source=cfg.use_source, seed=cfg.seed, device="cuda")
    trainer = FullBatchTrainer(model, graph, y, lr=cfg.lr,
                               weight_decay=cfg.weight_decay, seed=cfg.seed,
                               device="cuda")
    say(f"phase slice: cora preset as DIFFormer-a: N={n} E={graph.num_edges} "
        f"F={f} C={c} hidden={cfg.hidden_channels} layers={cfg.num_layers} "
        f"heads={cfg.num_heads} dropout={cfg.dropout} lr={cfg.lr} "
        f"wd={cfg.weight_decay}")

    # the main path: counts set to 0 just before, read just after
    K.reset_launch_counts()
    t0 = time.perf_counter()
    best = trainer.fit(split, epochs=EPOCHS, eval_step=1)[0]
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)

    losses = best["losses"]
    say(f"phase slice: fit {EPOCHS} epochs in {fit_s:.2f} s; losses "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; best epoch {best['epoch']} "
        f"train {best['train']:.4f} valid {best['valid']:.4f} "
        f"test {best['test']:.4f}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    layers = cfg.num_layers
    expect = {"sigmoid_attention_fwd": 2 * layers * EPOCHS,
              "sigmoid_attention_dq": layers * EPOCHS,
              "sigmoid_attention_dkv": layers * EPOCHS}
    say(f"phase slice: launches {launches} (expected {expect})")
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")

    # logits through the kernels against the same model through the plain
    # versions, on the card
    state = trainer.init_state(0)
    logits = trainer.forward_eval(state)
    with unittest.mock.patch.object(difformer_module, "sigmoid_attention",
                                    plain_attention):
        ref = trainer.forward_eval(state)
    if logits.shape != (n, c):
        raise AssertionError(f"logits shape {tuple(logits.shape)}")
    torch.testing.assert_close(logits, ref, rtol=1e-3, atol=1e-4)
    logit_err = (logits - ref).abs().max().item()
    say(f"phase slice: logits kernel vs plain max_abs_err {logit_err:.3e}")

    # times: host clock around synchronised work
    train_mask = torch.as_tensor(
        np.isin(np.arange(n), split["train"]), device="cuda")
    gen = torch.Generator("cuda").manual_seed(0)
    for _ in range(3):
        trainer.train_step(state, gen, train_mask)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = 20
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
    say(f"phase slice: train step {step_ms:.3f} ms | eval forward "
        f"{eval_ms:.3f} ms | peak memory {peak_mib:.1f} MiB (train)")
    profile_steps(lambda: trainer.train_step(state, gen, train_mask),
                  step_ms)
    return launches


def profile_steps(step, step_ms, steps=5, top=12):
    """Device time by kernel over ``steps`` train steps (torch.profiler),
    and its share of ``step_ms``, the step's time measured without the
    profiler. Only the device's own kernels and copies are summed: the
    CPU-side ranges of the autograd Functions also carry the ctypes-launched
    kernels' time as theirs, and the optimizer's range is mirrored on the
    device as an annotation spanning its kernels."""
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
        say("phase profile: the profiler saw no device time (not measured)")
        return
    busy = sum(r[0] for r in rows)
    say(f"phase profile: device time {busy:.4f} ms per train step over "
        f"{steps} steps = {100 * busy / step_ms:.1f}% of the "
        f"{step_ms:.3f} ms step (idle {100 * (1 - busy / step_ms):.1f}%)")
    for ms, count, key in rows[:top]:
        say(f"phase profile: {ms:9.4f} ms/step {100 * ms / busy:5.1f}% "
            f"x{count:<3d} {key[:100]}")


def main():
    smi = phase_device()
    phase_build()
    rows = phase_kernels()
    launches = phase_slice()
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": row["max_abs_err"], "ms": row["ms"],
         "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
         "bound_by": row["bound_by"], "library_ms": None}
        for name, row in rows.items()
    ]
    say(json.dumps({"kernels": kernels}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
