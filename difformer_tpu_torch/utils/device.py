"""Device selection for the port's entry points.

Entry points default to the GPU. Without one they raise instead of running
on the CPU: a caller who wants the CPU (the tests do) says so with
``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`, ``cuda`` when None."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def on_cuda(what, *tensors) -> bool:
    """Where a kernel wrapper runs: True when every tensor (None skipped)
    lies on one CUDA device, so the wrapper launches its kernel; False when
    all lie on the CPU, so it runs its plain version. Anything else raises:
    there is no fallback from the card to the plain version."""
    devices = {t.device for t in tensors if t is not None}
    kinds = {d.type for d in devices}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len(devices) == 1:
        return True
    raise ValueError(f"{what} needs all tensors on one CUDA device or all on "
                     f"the CPU, got {sorted(map(str, devices))}")
