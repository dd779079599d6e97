"""Profiling and observability, as ``difformer_tpu/utils/profiling.py``:
a device trace around a block (``torch.profiler``, written as a Chrome
trace), an edges-per-second counter for training loops, the caching
allocator's memory statistics per GPU, and the reference's parameter count
(``node classification/data_utils.py:339-340``).
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the CPU and (where there is one) the GPU around a block and
    write the trace to ``log_dir/trace.json`` (Chrome's trace format, read
    by Perfetto or chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class ThroughputMeter:
    """edges/s (and steps/s) counter for training loops."""

    def __init__(self, edges_per_step: int, layers: int = 1):
        self.edges_per_step = edges_per_step * layers
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._steps = 0

    def step(self, n: int = 1):
        self._steps += n

    @property
    def seconds(self):
        return time.perf_counter() - self._t0

    def summary(self) -> dict:
        dt = max(self.seconds, 1e-9)
        return {
            "steps": self._steps,
            "seconds": round(dt, 3),
            "steps_per_s": round(self._steps / dt, 3),
            "edges_per_s": round(self._steps * self.edges_per_step / dt, 1),
        }

    def report(self) -> str:
        return json.dumps(self.summary())


def device_memory_stats() -> dict:
    """``torch.cuda.memory_stats`` of every GPU, by device name ("cuda:0",
    ...); empty without a GPU."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}


def count_parameters(params) -> int:
    """The number of parameter elements of a module, or of a params dict
    (a ``state_dict`` or a nested dict of arrays, such as the JAX
    package's params tree)."""
    if isinstance(params, torch.nn.Module):
        return sum(p.numel() for p in params.parameters())
    if isinstance(params, dict):
        return sum(count_parameters(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_parameters(v) for v in params)
    if isinstance(params, torch.Tensor):
        return params.numel()
    return int(getattr(params, "size", 1))
