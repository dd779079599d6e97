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
