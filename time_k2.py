"""Time the flash sigmoid attention forward kernel (K2) alone on one GPU.

    python3 time_k2.py [--blocks-per-sm 1 2 4] [--root DIR]

Builds the kernels, prints the compiler's register and spill report, then
at each shape of ``chip_smoke.SHAPES``: checks K2 (normalized and not)
against its plain version under ``difformer_tpu_torch/kernels/tolerance.py``
and prints its time from CUDA events beside its bound, with the key split S
and the blocks launched, once for each target of blocks per SM given (the
default is the package's own). ``--root`` times the package of another
checkout instead (one without the key split times its single grid), so two
versions can be compared on one card in one call. Last, two yardsticks for
the FP32 rate: the SM clock and power that ``nvidia-smi`` reads while K2
runs at the last shape, and the rate of cuBLAS's FP32 GEMM (TF32 off) at
8192 x 8192 x 8192. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path


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


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--blocks-per-sm", type=int, nargs="*", default=[])
    parser.add_argument("--root", type=Path, default=None)
    args = parser.parse_args()
    if args.root is not None:
        sys.path.insert(0, str(args.root.resolve()))

    import torch

    import chip_smoke as cs
    from difformer_tpu_torch.kernels import sigmoid_attention as K
    from difformer_tpu_torch.kernels.tolerance import assert_close

    smi = cs.phase_device()
    cs.phase_build()
    cs.say(f"time_k2: package {Path(K.__file__).resolve()}")
    splitting = hasattr(K, "fwd_key_splits")
    targets = args.blocks_per_sm or [None]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for idx, (n, l, h, m, d, dtype, masked) in enumerate(cs.SHAPES):
        q, k, v, mask, _ = cs.attention_case(n, l, h, m, d, dtype, masked,
                                             idx)
        label = (f"N={n} L={l} H={h} M={m} D={d} "
                 f"{str(dtype).split('.')[-1]}{' mask' if masked else ''}")
        r_out, r_den = K.sigmoid_attention_fwd_plain(q, k, v, mask)
        r_num = K.sigmoid_attention_fwd_plain(q, k, v, mask,
                                              normalize=False)[0]
        bound, _ = cs.bound_ms("sigmoid_attention_fwd", n, l, h, m, d, dtype)
        rule = K.fwd_key_splits if splitting else None
        for per_sm in targets:
            if per_sm is not None and splitting:
                K.fwd_key_splits = (lambda *a, _p=per_sm, **_:
                                    rule(*a, blocks_per_sm=_p))
            out, den = K.sigmoid_attention_fwd(q, k, v, mask)
            err = max(assert_close(f"out {label}", out, r_out, "out"),
                      assert_close(f"den {label}", den, r_den, "den"))
            num = K.sigmoid_attention_fwd(q, k, v, mask, normalize=False)[0]
            err = max(err, assert_close(f"num {label}", num, r_num, "num",
                                        den=r_den))
            ms = cs.cuda_ms(lambda: K.sigmoid_attention_fwd(q, k, v, mask))
            ms_u = cs.cuda_ms(lambda: K.sigmoid_attention_fwd(
                q, k, v, mask, normalize=False))
            splits = K.fwd_key_splits(n, l, h, sms)[0] if splitting else 1
            cs.say(f"time_k2: {label:40s} blocks/SM target {per_sm} | S="
                   f"{splits}, {-(-n // 64) * h * splits} blocks | "
                   f"{ms:.4f} ms (normalize=False {ms_u:.4f}) | bound "
                   f"{bound:.4f} ms ({100 * bound / ms:.1f}%) | max_abs_err "
                   f"{err:.3e}")
            if splitting:
                K.fwd_key_splits = rule
        if idx == len(cs.SHAPES) - 1:
            mhz, watts = sample_clocks(
                lambda: K.sigmoid_attention_fwd(q, k, v, mask))
            cs.say(f"time_k2: {label} under load: SM clock {mhz} MHz, "
                   f"power {watts} W (median of nvidia-smi samples)")
        del q, k, v, mask, r_out, r_den, r_num, out, den, num
        torch.cuda.empty_cache()
    a = torch.randn(8192, 8192, device="cuda")
    ms = cs.cuda_ms(lambda: a @ a)
    cs.say(f"time_k2: cuBLAS FP32 GEMM 8192^3 {ms:.4f} ms = "
           f"{2 * 8192 ** 3 / ms / 1e9:.2f} TFLOP/s")
    cs.say(smi)


if __name__ == "__main__":
    main()
