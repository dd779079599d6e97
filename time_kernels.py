"""Time the flash sigmoid attention kernels (K2 fwd, K3 dq, K4 dkv) alone on
one GPU.

    python3 time_kernels.py [--kernel fwd dq dkv] [--blocks-per-sm 1 2 4]
                            [--root DIR]
    python3 time_kernels.py --builds [ROUNDS]

Builds the kernels, prints the compiler's register and spill report, then
at each shape of ``chip_smoke.SHAPES`` and for each kernel chosen (all three
by default): checks it against its plain version under
``difformer_tpu_torch/kernels/tolerance.py`` and prints its time from CUDA
events beside its bound, with the split S of its loop axis and the blocks
launched, once for each target of blocks per SM given (applied to the
chosen kernel's split rule; the default is the package's own). ``--root``
times the package of another checkout instead (one without a split, or
with K2's only, times its own grid), so two versions can be compared on one
card in one call. Last, two yardsticks for the FP32 rate: the SM clock and
power that ``nvidia-smi`` reads while the last kernel chosen runs at the
last shape, and the rate of cuBLAS's FP32 GEMM (TF32 off) at 8192 x 8192 x
8192. Imports nothing of JAX.

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
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

KERNELS = {"fwd": "sigmoid_attention_fwd", "dq": "sigmoid_attention_dq",
           "dkv": "sigmoid_attention_dkv"}
# the module constant each kernel's split rule reads
TARGETS = {"fwd": "FWD_BLOCKS_PER_SM", "dq": "DQ_BLOCKS_PER_SM",
           "dkv": "DKV_BLOCKS_PER_SM"}


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
    """name -> (kernel call, plain references as (tensor, kind, den))."""
    r_out, r_den = K.sigmoid_attention_fwd_plain(q, k, v, mask)
    dnum = g / r_den[..., None]
    dden = -(g * r_out.float()).sum(-1) / r_den
    bwd = (q, k, v, mask, dnum, dden)
    return {
        "sigmoid_attention_fwd": (
            lambda: K.sigmoid_attention_fwd(q, k, v, mask),
            [(r_out, "out", None), (r_den, "den", None)]),
        "sigmoid_attention_dq": (
            lambda: (K.sigmoid_attention_dq(*bwd),),
            [(K.sigmoid_attention_dq_plain(*bwd), "grad", None)]),
        "sigmoid_attention_dkv": (
            lambda: K.sigmoid_attention_dkv(*bwd),
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


def time_builds(rounds):
    import chip_smoke as cs
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


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernel", nargs="+", choices=sorted(KERNELS),
                        default=list(KERNELS))
    parser.add_argument("--blocks-per-sm", type=int, nargs="*", default=[])
    parser.add_argument("--root", type=Path, default=None)
    parser.add_argument("--builds", type=int, nargs="?", const=2,
                        metavar="ROUNDS")
    args = parser.parse_args()
    if args.root is not None:
        sys.path.insert(0, str(args.root.resolve()))
    if args.builds is not None:
        return time_builds(args.builds)

    import torch

    import chip_smoke as cs
    from difformer_tpu_torch.kernels import sigmoid_attention as K
    from difformer_tpu_torch.kernels.tolerance import assert_close

    smi = cs.phase_device()
    cs.phase_build()
    cs.say(f"time_kernels: package {Path(K.__file__).resolve()}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for idx, (n, l, h, m, d, dtype, masked) in enumerate(cs.SHAPES):
        q, k, v, mask, g = cs.attention_case(n, l, h, m, d, dtype, masked,
                                             idx)
        label = (f"N={n} L={l} H={h} M={m} D={d} "
                 f"{str(dtype).split('.')[-1]}{' mask' if masked else ''}")
        calls = cases(K, q, k, v, mask, g)
        for short in args.kernel:
            name, attr = KERNELS[short], TARGETS[short]
            call, refs = calls[name]
            bound, _ = cs.bound_ms(name, n, l, h, m, d, dtype)
            sweep = hasattr(K, "split_plan") and hasattr(K, attr)
            own = getattr(K, attr) if sweep else None
            for per_sm in (args.blocks_per_sm if sweep else []) or [None]:
                if per_sm is not None:
                    setattr(K, attr, per_sm)
                err = max(assert_close(f"{short} {label}", got, ref, kind,
                                       den_ref)
                          for got, (ref, kind, den_ref) in zip(call(), refs))
                ms = cs.cuda_ms(call)
                blocks, splits = grid(K, name, n, l, h, m, d, sms)
                cs.say(f"time_kernels: {short:3s} {label:40s} blocks/SM "
                       f"target {per_sm or own} | S={splits}, {blocks} "
                       f"blocks | {ms:.4f} ms | bound {bound:.4f} ms "
                       f"({100 * bound / ms:.1f}%) | max_abs_err {err:.3e}")
            if sweep:
                setattr(K, attr, own)
            if idx == len(cs.SHAPES) - 1 and short == args.kernel[-1]:
                mhz, watts = sample_clocks(call)
                cs.say(f"time_kernels: {short} {label} under load: SM clock "
                       f"{mhz} MHz, power {watts} W (median of nvidia-smi "
                       f"samples)")
        del q, k, v, mask, g, calls
        torch.cuda.empty_cache()
    a = torch.randn(8192, 8192, device="cuda")
    ms = cs.cuda_ms(lambda: a @ a)
    cs.say(f"time_kernels: cuBLAS FP32 GEMM 8192^3 {ms:.4f} ms = "
           f"{2 * 8192 ** 3 / ms / 1e9:.2f} TFLOP/s")
    cs.say(smi)


if __name__ == "__main__":
    main()
