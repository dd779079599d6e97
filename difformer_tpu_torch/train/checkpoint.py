"""Checkpoint and resume, as ``difformer_tpu/train/checkpoint.py:22-90``.

The JAX package writes orbax checkpoints of its train state; here a
checkpoint is one ``torch.save`` file of a dict of tensors and Python
values: for ``FullBatchTrainer.fit`` the model's and the optimizer's
``state_dict``, the run's dropout generator state
(``Generator.get_state()``, which plays the part of JAX's rng key, so a
resumed run continues the exact dropout stream), the best validation
record and the epoch. Each file is written under a temporary name and then
renamed over its final one, so a crash leaves the last complete checkpoint
and never a half-written file.

:class:`CheckpointManager` keeps the last ``max_to_keep`` step files of a
directory, ``{step}.pt``, and a ``best.pt`` slot written only when a
metric improves (the reference's save-best-only pattern).
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional

import torch

_STEP_FILE = re.compile(r"^(\d+)\.pt$")


def save_checkpoint(path: str, state: Any):
    """Write ``state`` to the file ``path`` atomically (temporary file, then
    rename)."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def restore_checkpoint(path: str, map_location=None) -> Any:
    """Read a checkpoint written by :func:`save_checkpoint`, its tensors on
    ``map_location`` (where they were saved when None). Only tensors and
    plain Python containers and values are unpickled."""
    return torch.load(os.path.abspath(path), map_location=map_location,
                      weights_only=True)


class CheckpointManager:
    """Step-indexed checkpoints in ``directory`` with retention and a best
    slot."""

    def __init__(self, directory: str, *, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._best_metric = -float("inf")

    def _path(self, name):
        return os.path.join(self.directory, f"{name}.pt")

    def steps(self) -> list:
        """The steps held, oldest first."""
        found = (_STEP_FILE.match(f) for f in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, step: int, state: Any, *, metrics: Optional[dict] = None):
        """Write the checkpoint of ``step`` and drop the oldest beyond
        ``max_to_keep``. ``metrics`` is stored beside the state."""
        if metrics is not None:
            state = {**state, "metrics": metrics}
        save_checkpoint(self._path(step), state)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def save_if_best(self, step: int, state: Any, metric: float) -> bool:
        """Write the best slot when ``metric`` beats every earlier one of
        this manager."""
        if metric > self._best_metric:
            self._best_metric = metric
            save_checkpoint(self._path("best"), state)
            return True
        return False

    def restore_best(self, map_location=None):
        return restore_checkpoint(self._path("best"), map_location)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: int, map_location=None):
        return restore_checkpoint(self._path(step), map_location)

    def close(self):
        """Every write is finished when ``save`` returns: nothing to
        flush."""
