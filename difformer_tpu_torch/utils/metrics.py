"""Evaluation metrics (numpy), as ``difformer_tpu/utils/metrics.py``.

Parity with the reference's ``node classification/data_utils.py:249-259``:
``y_true`` [N] or [N, T] labels, ``y_pred`` [N, C] raw scores.
"""

from __future__ import annotations

import numpy as np


def eval_acc(y_true, y_pred):
    """Per-column accuracy, averaged over label columns. NaN labels are
    skipped per column."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred).argmax(axis=-1)
    if y_true.ndim == 1:
        y_true = y_true[:, None]
    acc_list = []
    for i in range(y_true.shape[1]):
        is_labeled = y_true[:, i] == y_true[:, i]
        correct = y_true[is_labeled, i] == y_pred[is_labeled]
        acc_list.append(float(np.sum(correct)) / max(len(correct), 1))
    return sum(acc_list) / len(acc_list)

