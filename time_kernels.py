"""Time the port's kernels alone on one GPU: the flash sigmoid attention
(K2 fwd, K3 dq, K4 dkv), the CSR SpMM (K1, spmm), its value gradient
(K1-dval, dval), the ELL SpMM (K6, ell) and the block-sparse SpMM's
combine (K7's, bsr_combine).

    python3 time_kernels.py [--kernel fwd dq dkv spmm dval ell bsr_combine]
                            [--blocks-per-sm 1 2 4]
                            [--wide] [--root DIR]
    python3 time_kernels.py --kernel spmm --reorder rcm degree
    python3 time_kernels.py --kernel ell [--ell-threshold 256 384 0]
                            [--ell-pads]
    python3 time_kernels.py --kernel dval [--dval-threshold 8 12 32 256]
    python3 time_kernels.py --builds [ROUNDS]

Builds the kernels, prints the compiler's register and spill report, then
at each shape of ``chip_smoke.SHAPES`` and for each attention kernel chosen
(all three by default): checks it against its plain version under
``difformer_tpu_torch/kernels/tolerance.py`` and prints its time and its
plain version's from CUDA events beside its FP32 bound, with the split S of
its loop axis and the blocks launched, once for each target of blocks per
SM given (applied to the chosen kernel's split rule; the default is the
package's own). ``--wide`` does the same at ``chip_smoke.WIDE_SHAPES``, the
set track's widths, where K2-K4 take their wide path (q and k scaled for
unit-variance scores, as chip_smoke's phase kernels-wide does), and adds
each kernel's bound at the tensor-core rate of the instructions it runs
(``chip_smoke.tensor_bound_ms``). With
``spmm`` chosen, K1 forward and transposed at each shape of
``chip_smoke.spmm_shapes()``: checked against its plain version, its device
time (torch.profiler, ``chip_smoke.device_ms``) and device kernels per call
(``chip_smoke.graph_kernels``, from the CUDA graph of one call)
beside cuSPARSE's device time for the same product, its byte bound and the
gather floor. With ``--reorder``, K1 instead at Pokec's size with
power-law degrees only, in the order its nodes were drawn and renumbered
by each ``locality_reorder`` method given (on the host, timed), at hidden
128: whether a node order that puts neighbours close lets the gathers hit
L2, against the gather floor and the byte bound. With ``dval`` chosen,
K1-dval at ``chip_smoke.dval_shapes()`` (every head of a shape in one call
where the package takes [N, H, D]; a package from before, e.g. with
``--root``, a call a head on that head's slice, as its autograd Function
made them): checked against the package's plain version a head at a time,
two calls bit-equal, its device kernels a call, its time by CUDA-graph
replay beside its bound and its x-gather floor; then at each split
threshold T of ``--dval-threshold`` (bit-equal to the plan's split: each
edge's sum does not depend on its item). With ``bsr_combine``
chosen, K7's combine kernel alone on the partials of the degree-sorted
power-law hub layout (``chip_smoke.hub_layout``) at W = 64, 65 and 300
and at bf16, as ``chip_smoke.check_combine`` holds it (bit-equal to the
plain version, its time by replay, ``torch.sum``'s and the bound).
With ``ell`` chosen, K6 forward and transposed on
bench.py's three graphs (``chip_smoke.bench_graph``, W = 64, f32 and
bf16): checked against its plain version under the "spmm" rule, its device
time by CUDA-graph replay (``chip_smoke.replay_ms``) and device kernels a
call beside cuSPARSE's CSR product, its byte bound and its gather floor;
at f32, each split threshold T of ``--ell-threshold`` (0: none) and,
with ``--ell-pads``, the padded slots summed as real ones, each a variant
of the package's own layout (a package without split or pads, e.g. with
``--root``, times its own kernel only).
``--root`` times the package of another checkout instead (one
without a split, or with K2's only, times its own grid; shapes, bounds and
timers stay this checkout's), so two versions can be compared on one card
in one call. Last, two yardsticks: the SM clock and power that
``nvidia-smi`` reads while the last kernel chosen runs at the last shape,
and (with an attention kernel chosen) the rate of cuBLAS's FP32 GEMM (TF32
off) at 8192 x 8192 x 8192. Imports nothing of JAX.

``--builds`` times instead how long the CUDA sources take to compile, cold,
by two designs, in ROUNDS rounds (default 2) of one then the other: every
``csrc/*.cu`` in one ``nvcc`` into one library, and one ``nvcc`` for each
source, all at once (``kernels/build.py``'s); and each source alone (what
the second design recompiles after that source changes, where the first
recompiles everything). It builds into a scratch directory under
``difformer_tpu_torch/_build/`` and removes it.
"""

from __future__ import annotations

import argparse
import importlib.util
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

KERNELS = {"fwd": "sigmoid_attention_fwd", "dq": "sigmoid_attention_dq",
           "dkv": "sigmoid_attention_dkv", "spmm": "csr_spmm",
           "dval": "csr_spmm_dval", "ell": "ell_spmm",
           "bsr_combine": "bsr_spmm_combine"}
# the module constant each kernel's split rule reads (the wide path's is
# WIDE_BLOCKS_PER_SM, one number for all three before it became a dict by
# wrapper)
TARGETS = {"fwd": "FWD_BLOCKS_PER_SM", "dq": "DQ_BLOCKS_PER_SM",
           "dkv": "DKV_BLOCKS_PER_SM"}


def target(K, short, wide):
    """(get, set) of the split target that kernel ``short`` reads in
    package ``K``, or None where it has none."""
    name = KERNELS[short]
    if not hasattr(K, "split_plan"):
        return None
    if not wide:
        attr = TARGETS[short]
        if not hasattr(K, attr):
            return None
        return (lambda: getattr(K, attr),
                lambda x: setattr(K, attr, x))
    if not hasattr(K, "WIDE_BLOCKS_PER_SM"):
        return None
    if isinstance(K.WIDE_BLOCKS_PER_SM, dict):
        return (lambda: K.WIDE_BLOCKS_PER_SM[name],
                lambda x: K.WIDE_BLOCKS_PER_SM.__setitem__(name, x))
    return (lambda: K.WIDE_BLOCKS_PER_SM,
            lambda x: setattr(K, "WIDE_BLOCKS_PER_SM", x))


def sample_clocks(fn, seconds=2.0):
    """Median SM clock (MHz) and power draw (W) that nvidia-smi reads every
    100 ms while ``fn`` runs back to back for ``seconds``."""
    import torch

    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    try:
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out = proc.communicate(timeout=30)[0]
    # the first two samples may predate the load
    rows = [line.split(",") for line in out.strip().splitlines()[2:]]
    if not rows:
        return None, None
    return (statistics.median(float(r[0]) for r in rows),
            statistics.median(float(r[1]) for r in rows))


def grid(K, name, n, l, h, m, d, sms):
    """(blocks launched, S) of kernel ``name`` in package ``K``."""
    if hasattr(K, "split_plan"):
        per_split, splits, _ = K.split_plan(name, n, l, h, m, d, sms)
        return per_split * splits, splits
    # a package from before the backward split: K2 may split its keys; K3
    # and K4 own 64-row tiles (32 past a width of 128) and do not split
    if name == "sigmoid_attention_fwd":
        splits = K.fwd_key_splits(n, l, h, sms)[0]
        return -(-n // 64) * h * splits, splits
    rows = l if name == "sigmoid_attention_dkv" else n
    return -(-rows // (64 if max(m, d) <= 128 else 32)) * h, 1


def cases(K, q, k, v, mask, g):
    """name -> (kernel call, plain call, plain references as (tensor, kind,
    den))."""
    r_out, r_den = K.sigmoid_attention_fwd_plain(q, k, v, mask)
    dnum = g / r_den[..., None]
    dden = -(g * r_out.float()).sum(-1) / r_den
    fwd = (q, k, v, mask)
    bwd = (q, k, v, mask, dnum, dden)
    return {
        "sigmoid_attention_fwd": (
            lambda: K.sigmoid_attention_fwd(*fwd),
            lambda: K.sigmoid_attention_fwd_plain(*fwd),
            [(r_out, "out", None), (r_den, "den", None)]),
        "sigmoid_attention_dq": (
            lambda: (K.sigmoid_attention_dq(*bwd),),
            lambda: K.sigmoid_attention_dq_plain(*bwd),
            [(K.sigmoid_attention_dq_plain(*bwd), "grad", None)]),
        "sigmoid_attention_dkv": (
            lambda: K.sigmoid_attention_dkv(*bwd),
            lambda: K.sigmoid_attention_dkv_plain(*bwd),
            [(r, "grad", None) for r in K.sigmoid_attention_dkv_plain(*bwd)]),
    }


def nvcc_seconds(*jobs):
    """Wall seconds of ``jobs`` [(library, sources)], one ``nvcc`` each, all
    started together."""
    from difformer_tpu_torch.kernels import build

    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
         *map(str, srcs)], stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True) for lib, srcs in jobs]
    try:
        for proc in procs:
            err = proc.communicate()[1]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {err}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return time.perf_counter() - t0


def time_builds(cs, rounds):
    from difformer_tpu_torch.kernels import build

    smi = cs.nvidia_smi_line()
    sources = sorted(build.SOURCE_DIR.glob("*.cu"))
    scratch = build.BUILD_DIR / f"timing.{time.time_ns()}"
    scratch.mkdir(parents=True)
    try:
        designs = {
            "one nvcc, one library": [(scratch / "all.so", sources)],
            "one nvcc per source, at once": [
                (scratch / f"{src.stem}.so", [src]) for src in sources],
        }
        for r in range(rounds):
            for name, jobs in (designs.items() if r % 2 == 0
                               else reversed(designs.items())):
                cs.say(f"time_kernels: cold build, {name}: "
                       f"{nvcc_seconds(*jobs):.2f} s (round {r + 1})")
        for src in sources:
            cs.say(f"time_kernels: {src.name} alone: "
                   f"{nvcc_seconds((scratch / 'one.so', [src])):.2f} s")
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    cs.say(smi)


def tree_smoke():
    """This checkout's ``chip_smoke.py`` (its shapes, bounds and timers),
    loaded by path, so that with ``--root`` it drives the other checkout's
    package, which comes first on ``sys.path``."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().with_name("chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = module
    spec.loader.exec_module(module)
    return module


def time_attention(cs, shorts, blocks_per_sm, wide=False):
    """K2-K4 at every shape of ``cs.SHAPES`` (``cs.WIDE_SHAPES`` with
    ``wide``); returns the last call timed."""
    import torch

    from difformer_tpu_torch.kernels import sigmoid_attention as K
    from difformer_tpu_torch.kernels.tolerance import assert_close

    cs.say(f"time_kernels: package {Path(K.__file__).resolve()}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for idx, (n, l, h, m, d, dtype, masked) in enumerate(
            cs.WIDE_SHAPES if wide else cs.SHAPES):
        q, k, v, mask, g = cs.attention_case(
            n, l, h, m, d, dtype, masked, idx,
            scale=m ** -0.25 if wide else 1.0)
        label = (f"N={n} L={l} H={h} M={m} D={d} "
                 f"{str(dtype).split('.')[-1]}{' mask' if masked else ''}")
        calls = cases(K, q, k, v, mask, g)
        for short in shorts:
            name = KERNELS[short]
            call, plain, refs = calls[name]
            bound, _ = cs.bound_ms(name, n, l, h, m, d, dtype)
            tc = ""
            if wide:
                tc_ms, instr = cs.tensor_bound_ms(name, n, l, h, m, d, dtype)
                tc = f" | tensor-core bound {tc_ms:.4f} ms ({instr})"
            plain_ms = cs.cuda_ms(plain)
            knob = target(K, short, wide)
            own = knob[0]() if knob else None
            for per_sm in (blocks_per_sm if knob else []) or [None]:
                if per_sm is not None:
                    knob[1](per_sm)
                err = max(assert_close(f"{short} {label}", got, ref, kind,
                                       den_ref)
                          for got, (ref, kind, den_ref) in zip(call(), refs))
                ms = cs.cuda_ms(call)
                blocks, splits = grid(K, name, n, l, h, m, d, sms)
                cs.say(f"time_kernels: {short:3s} {label:40s} blocks/SM "
                       f"target {per_sm or own} | S={splits}, {blocks} "
                       f"blocks | {ms:.4f} ms | plain {plain_ms:.4f} ms | "
                       f"bound {bound:.4f} ms ({100 * bound / ms:.1f}%)"
                       f"{tc} | max_abs_err {err:.3e}")
            if knob:
                knob[1](own)
        del q, k, v, mask, g, calls
        torch.cuda.empty_cache()
    return f"{shorts[-1]} {label}", call


def spmm_call(K1, x, csr, transposed, split):
    """K1 over ``csr`` = (row_ptr, col, val), with its split schedule where
    the package has one."""
    kw = {} if split is None else {"split": split}
    return lambda: K1.csr_spmm(x, *csr, transposed=transposed, **kw)


def reordered_shapes(cs, methods):
    """(label, plan, W, plain edge chunk) of a graph of Pokec's size with
    power-law degrees (``cs.power_law_nodes``), first in the order its
    nodes were drawn, then renumbered by each ``locality_reorder`` method
    (``permute_graph``'s relabelling), at hidden 128."""
    import numpy as np
    import torch

    from difformer_tpu_torch.data.transforms import locality_reorder
    from difformer_tpu_torch.ops.graph_ops import build_csr_plan

    n, e = cs.POKEC_NODES, cs.POKEC_EDGES
    g = torch.Generator("cuda").manual_seed(11)
    senders = cs.power_law_nodes(n, e, g)
    receivers = cs.power_law_nodes(n, e, g)
    yield ("pokec power-law", build_csr_plan(senders, receivers, n), 128,
           cs.PLAIN_EDGE_CHUNK)
    edges = torch.stack([senders, receivers]).cpu().numpy()
    del senders, receivers
    for method in methods:
        t0 = time.perf_counter()
        perm = locality_reorder(edges, n, method=method)
        seconds = time.perf_counter() - t0
        renumbered = torch.as_tensor(perm, device="cuda")[
            torch.as_tensor(edges, device="cuda")]
        band = np.abs(perm[edges[0]] - perm[edges[1]])
        cs.say(f"time_kernels: locality_reorder {method!r} of N={n} "
               f"E={e}: {seconds:.1f} s on the host; median |new id of "
               f"sender - of receiver| {int(np.median(band))} (drawn order "
               f"{int(np.median(np.abs(edges[0] - edges[1])))})")
        plan = build_csr_plan(renumbered[0], renumbered[1], n)
        del renumbered
        yield f"pokec power-law {method}", plan, 128, cs.PLAIN_EDGE_CHUNK
        del plan


def time_spmm(cs, thresholds, shapes=None):
    """K1 forward and transposed at every shape of ``shapes`` (by default
    ``cs.spmm_shapes()``), once for each split threshold T given (a package
    from before the split has none and times its own kernel); returns the
    last call timed at the package's own T."""
    import torch

    from difformer_tpu_torch.kernels import spmm as K1
    from difformer_tpu_torch.kernels.tolerance import assert_close

    cs.say(f"time_kernels: package {Path(K1.__file__).resolve()}")
    sweep = thresholds if hasattr(K1, "row_split") else []
    shapes = cs.spmm_shapes() if shapes is None else shapes
    for idx, (label, plan, w, chunk) in enumerate(shapes):
        n, e = plan.num_nodes, plan.num_edges
        x = torch.randn((n, w), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(idx))
        bound = cs.spmm_bound_ms(n, e, w)[0]
        floor = cs.spmm_gather_floor_ms(n, e, w)
        for name, csr, own in (
                ("csr_spmm", (plan.row_ptr, plan.col, plan.val),
                 getattr(plan, "split", None)),
                ("csr_spmm_transposed",
                 (plan.t_row_ptr, plan.t_col, plan.t_val),
                 getattr(plan, "t_split", None))):
            transposed = name == "csr_spmm_transposed"
            tag = f"{name} {label} N={n} E={e} W={w}"
            ref = K1.csr_spmm_plain(x, *csr, edge_chunk_size=chunk)
            scale = K1.csr_spmm_abs(x, *csr, edge_chunk_size=chunk)
            library = cs.library_spmm(*csr, n)
            library_ms = cs.device_ms(lambda: library(x))
            for t in sweep or [None]:
                split = own if t is None else K1.row_split(csr[0], t)
                call = spmm_call(K1, x, csr, transposed, split)
                err = assert_close(tag, call(), ref, "spmm", scale=scale)
                ms = cs.device_ms(call)
                kernels = cs.graph_kernels(call)[0]
                shape = ("no split" if split is None else
                         f"T={split.threshold}: {split.num_heavy} heavy rows,"
                         f" {split.num_segments} segments")
                cs.say(f"time_kernels: {tag:60s} {shape} | {ms:.4f} ms, "
                       f"{kernels} device kernels a call | cuSPARSE "
                       f"{library_ms:.4f} ms | bound {bound:.4f} ms "
                       f"({100 * bound / ms:.1f}%) | gather floor "
                       f"{floor:.4f} ms ({100 * floor / ms:.1f}%) | "
                       f"max_abs_err {err:.3e}")
            last = tag, spmm_call(K1, x, csr, transposed, own)
            del ref, scale, library
        del plan, x
        torch.cuda.empty_cache()
    return last


def ell_variants(ell, thresholds, pads):
    """(label, layout) of each K6 variant to time: the package's own, then
    each split threshold T (0: no split) and, with ``pads``, the padding
    summed as real slots, where the package's layout has them."""
    import dataclasses

    import torch

    yield "own", ell
    if hasattr(ell, "with_split"):
        for t in thresholds:
            yield (f"T={t or 'none'}",
                   ell.with_split(t or int(ell.table[:, 1].max())))
    if pads and hasattr(ell, "pads"):
        # no row pads: every slot summed, the padding's x[0] times 0
        yield "pads summed", dataclasses.replace(
            ell, pads=torch.zeros_like(ell.pads))


def time_ell(cs, thresholds, pads):
    """K6 forward and transposed on bench.py's three graphs at W = 64, f32
    (with the variants of :func:`ell_variants`) and bf16; returns the last
    call timed."""
    import torch

    from difformer_tpu_torch.kernels import ell as K6
    from difformer_tpu_torch.kernels.tolerance import assert_close
    from difformer_tpu_torch.ops.ell import build_ell_gcn
    from difformer_tpu_torch.ops.graph_ops import build_csr_plan

    cs.say(f"time_kernels: package {Path(K6.__file__).resolve()}")
    n = cs.BENCH_NODES
    for kind in cs.BENCH_GRAPHS:
        x32, s, r = cs.bench_graph(kind)
        fwd, rev = (d.to("cuda") for d in build_ell_gcn(s, r, n))
        plan = build_csr_plan(torch.as_tensor(s, device="cuda"),
                              torch.as_tensor(r, device="cuda"), n)
        csrs = ((plan.row_ptr, plan.col, plan.val),
                (plan.t_row_ptr, plan.t_col, plan.t_val))
        e = s.size
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.as_tensor(x32, device="cuda").to(dtype)
            w, elem = x.shape[1], x.element_size()
            bound = cs.ell_bound_ms(n, e, w, elem)[0]
            floor = cs.ell_gather_floor_ms(n, e, w, elem)
            for name, ell, csr in zip(cs.ELL_PATH, (fwd, rev), csrs):
                transposed = name.endswith("transposed")
                tag = f"{name} {kind} W={w} {str(dtype).split('.')[-1]}"
                ref, scale = K6.ell_spmm_plain(x, ell), K6.ell_spmm_abs(x,
                                                                        ell)
                library = cs.library_spmm(*csr, n, dtype)
                library_ms = cs.device_ms(lambda: library(x))
                variants = (ell_variants(ell, thresholds, pads)
                            if dtype == torch.float32 else [("own", ell)])
                for label, layout in variants:
                    call = lambda: K6.ell_spmm_rows(  # noqa: E731
                        x, layout, transposed=transposed)
                    err = assert_close(f"{tag} {label}", call(), ref,
                                       "spmm", scale=scale)
                    ms = cs.replay_ms(call)
                    kernels = cs.graph_kernels(call)[0]
                    split = getattr(layout, "split", None)
                    shape = ("" if split is None else
                             f"T={split.threshold}, {split.partials} "
                             f"partial rows, ")
                    cs.say(f"time_kernels: {tag:40s} {label:12s} | {shape}"
                           f"{ms:.4f} ms, {kernels} device kernels a call | "
                           f"cuSPARSE {library_ms:.4f} ms | bound "
                           f"{bound:.4f} ms ({100 * bound / ms:.1f}%) | "
                           f"gather floor {floor:.4f} ms "
                           f"({100 * floor / ms:.1f}%) | max_abs_err "
                           f"{err:.3e}")
                last = tag, lambda: K6.ell_spmm_rows(x, ell,
                                                     transposed=transposed)
                del ref, scale, library
        del fwd, rev, plan
        torch.cuda.empty_cache()
    return last


def time_dval(cs, thresholds):
    """K1-dval at every shape of ``cs.dval_shapes()``, at the plan's split
    and then at each split threshold T of ``thresholds`` (a package from
    before K1-dval's split has none and times its own); returns the last
    call timed at the plan's split."""
    import inspect

    import torch

    from difformer_tpu_torch.kernels import spmm as K1
    from difformer_tpu_torch.kernels.tolerance import assert_close

    cs.say(f"time_kernels: package {Path(K1.__file__).resolve()}")
    heads_at_once = "split" in inspect.signature(K1.csr_spmm_dval).parameters
    for idx, (label, plan, heads, d, chunk) in enumerate(cs.dval_shapes()):
        n, e = plan.num_nodes, plan.num_edges
        g, x = cs.dval_inputs(n, heads, d, 200 + idx)
        g3, x3 = (g, x) if heads > 1 else (g[:, None], x[:, None])
        if heads_at_once:
            call = lambda: K1.csr_spmm_dval(  # noqa: E731
                g, x, plan.rows, plan.col, row_ptr=plan.row_ptr,
                split=plan.dval_split)
        else:
            # the per-head launches of the package's Function, each on its
            # head's slice (copied to contiguous rows by the wrapper)
            call = lambda: torch.stack([  # noqa: E731
                K1.csr_spmm_dval(g3[:, h], x3[:, h], plan.rows, plan.col)
                for h in range(heads)], -1).view(
                    (e, heads) if heads > 1 else (e,))
        tag = f"dval {label} N={n} E={e} H={heads} D={d}"
        got = call()
        for h in range(heads):
            args = (g3[:, h].contiguous(), x3[:, h].contiguous(), plan.rows,
                    plan.col)
            ref = K1.csr_spmm_dval_plain(*args, edge_chunk_size=chunk)
            scale = K1.csr_spmm_dval_abs(*args, edge_chunk_size=chunk)
            err = assert_close(f"{tag} head {h}", got.view(e, heads)[:, h],
                               ref, "spmm", scale=scale)
            del ref, scale
        if not torch.equal(got, call()):
            raise AssertionError(f"{tag}: two calls differ")
        del got
        kernels = cs.graph_kernels(call)[0]
        ms = cs.replay_ms(call)
        bound = cs.dval_bound_ms(n, e, heads, d)[0]
        floor = cs.dval_gather_floor_ms(e, heads, d)
        cs.say(f"time_kernels: {tag:58s} | {ms:.4f} ms, {kernels} device "
               f"kernels a call | bound {bound:.4f} ms "
               f"({100 * bound / ms:.1f}%) | x-gather floor {floor:.4f} ms "
               f"({100 * floor / ms:.1f}%) | max_abs_err {err:.3e}")
        last = tag, call
        for t in thresholds if heads_at_once else []:
            split = K1.row_split(plan.row_ptr, t)
            swept = lambda: K1.csr_spmm_dval(  # noqa: E731
                g, x, plan.rows, plan.col, row_ptr=plan.row_ptr,
                split=split)
            if not torch.equal(swept(), call()):
                raise AssertionError(f"{tag}: T={t} differs from the "
                                     f"plan's split")
            cs.say(f"time_kernels: {tag:58s} | T={t} ({split.num_segments} "
                   f"segments) {cs.replay_ms(swept):.4f} ms")
        torch.cuda.empty_cache()
    return last


def time_bsr_combine(cs):
    """K7's combine on the power-law hub layout's partials at W = 64, 65,
    300 and bf16 (``cs.check_combine``); returns the last call timed."""
    import torch

    from difformer_tpu_torch.kernels import bsr as K7

    cs.say(f"time_kernels: package {Path(K7.__file__).resolve()}")
    d = cs.hub_layout()
    n = d.num_nodes
    g = torch.Generator("cuda").manual_seed(13)
    for label, x in (("W=64", torch.randn((n, 64), device="cuda",
                                          generator=g)),
                     ("W=65", torch.randn((n, 65), device="cuda",
                                          generator=g)),
                     ("W=300", torch.randn((n, 300), device="cuda",
                                           generator=g)),
                     ("bf16", torch.randn((n, 64), device="cuda",
                                          generator=g).bfloat16())):
        groups, scale = d.groups(), d.inv_scale
        chunks = K7.split_plan(K7.group_shapes(groups), d.tile, x.shape[1],
                               K7.sm_count(x.device))
        cs.check_combine(f"bsr_spmm hub int8 {label}", x, d, chunks, False)
        out, partial = K7.bsr_spmm_split(x, groups, d.tile, chunks,
                                         scale=scale)
        last = (f"bsr_combine {label}", lambda: K7.bsr_spmm_combine(
            partial, out, groups, d.tile, chunks, scale=scale))
    return last


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernel", nargs="+", choices=sorted(KERNELS),
                        default=list(KERNELS))
    parser.add_argument("--blocks-per-sm", type=int, nargs="*", default=[])
    parser.add_argument("--spmm-threshold", type=int, nargs="*", default=[])
    parser.add_argument("--ell-threshold", type=int, nargs="*", default=[],
                        help="K6 split thresholds to time (0: no split)")
    parser.add_argument("--ell-pads", action="store_true",
                        help="also time K6 with the padding summed")
    parser.add_argument("--dval-threshold", type=int, nargs="*", default=[],
                        help="K1-dval split thresholds to time")
    parser.add_argument("--reorder", nargs="+", default=[],
                        choices=("rcm", "bfs", "degree", "community"))
    parser.add_argument("--wide", action="store_true")
    parser.add_argument("--root", type=Path, default=None)
    parser.add_argument("--builds", type=int, nargs="?", const=2,
                        metavar="ROUNDS")
    args = parser.parse_args()
    if args.root is not None:
        sys.path.insert(0, str(args.root.resolve()))
    cs = tree_smoke()
    if args.builds is not None:
        return time_builds(cs, args.builds)

    import torch

    smi = cs.phase_device()
    cs.phase_build()
    attention = [k for k in args.kernel
                 if k not in ("spmm", "dval", "ell", "bsr_combine")]
    call = None
    if attention:
        label, call = time_attention(cs, attention, args.blocks_per_sm,
                                     args.wide)
    if "spmm" in args.kernel:
        shapes = (reordered_shapes(cs, args.reorder) if args.reorder
                  else None)
        label, call = time_spmm(cs, args.spmm_threshold, shapes)
    if "dval" in args.kernel:
        label, call = time_dval(cs, args.dval_threshold)
    if "ell" in args.kernel:
        label, call = time_ell(cs, args.ell_threshold, args.ell_pads)
    if "bsr_combine" in args.kernel:
        label, call = time_bsr_combine(cs)
    if call is not None:
        mhz, watts = sample_clocks(call)
        cs.say(f"time_kernels: {label} under load: SM clock {mhz} MHz, "
               f"power {watts} W (median of nvidia-smi samples)")
    del call
    torch.cuda.empty_cache()
    if attention:
        a = torch.randn(8192, 8192, device="cuda")
        ms = cs.cuda_ms(lambda: a @ a)
        cs.say(f"time_kernels: cuBLAS FP32 GEMM 8192^3 {ms:.4f} ms = "
               f"{2 * 8192 ** 3 / ms / 1e9:.2f} TFLOP/s")
    cs.say(smi)


if __name__ == "__main__":
    main()
