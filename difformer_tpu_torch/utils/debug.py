"""Numerical debugging, as ``difformer_tpu/utils/debug.py``.

It replaces the reference's global
``torch.autograd.set_detect_anomaly(True)`` (``spatial-temporal/
gnns.py:13``) with a scoped one, wraps a step so that it reports its first
non-finite output instead of raising (the counterpart of the JAX package's
checkify-wrapped step), and checks every leaf of a nested structure on the
host.
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator, Tuple

import numpy as np
import torch


@contextlib.contextmanager
def detect_anomaly():
    """Anomaly detection for the enclosed block: a backward that produces
    NaN raises and names the forward operation it came from."""
    with torch.autograd.detect_anomaly():
        yield


def _leaves(tree, path="") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of every leaf of nested dicts, lists and tuples; a
    module gives its ``state_dict``. Paths read as JAX's ``keystr``:
    ``['a'][0]``."""
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _is_finite(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return (not leaf.is_floating_point()
                or bool(torch.isfinite(leaf).all()))
    arr = np.asarray(leaf)
    return arr.dtype.kind != "f" or bool(np.isfinite(arr).all())


def checkify_step(step_fn):
    """Wrap ``step_fn`` so that it returns ``(error, out)``: ``error`` is
    None when every floating leaf of ``out`` is finite, else a message
    naming the first that is not."""

    def checked(*args, **kwargs):
        out = step_fn(*args, **kwargs)
        for path, leaf in _leaves(out):
            if not _is_finite(leaf):
                return f"non-finite value in output{path}", out
        return None, out

    return checked


def assert_all_finite(tree, name="tree"):
    """Raise ``FloatingPointError`` naming the first leaf of ``tree``
    (tensors, arrays, dicts, lists, a module or a ``state_dict``) that holds
    a non-finite value."""
    for path, leaf in _leaves(tree):
        if not _is_finite(leaf):
            raise FloatingPointError(f"non-finite values in {name}{path}")
