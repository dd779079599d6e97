"""Evaluation metrics, as ``difformer_tpu/utils/metrics.py``.

The host metrics are numpy, with the reference's calling convention
(``node classification/data_utils.py:238-285``): ``y_true`` [N] or [N, T]
labels, ``y_pred`` [N, C] raw scores (argmax'd for acc and f1, scores for
AUC). :func:`device_rocauc_tasks` is the torch counterpart of the JAX
package's on-device AUC, for the epoch-block fit.
"""

from __future__ import annotations

import numpy as np
import torch


def _softmax(x, axis=-1):
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


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


def eval_f1(y_true, y_pred, average="micro"):
    """Micro-averaged F1 (``data_utils.py:238-247``); on single-label
    multi-class targets it equals the accuracy. ``average="macro"`` takes
    the mean of the per-class F1."""
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).argmax(axis=-1).reshape(-1)
    classes = np.unique(np.concatenate([y_true, y_pred]))
    tp = np.array([np.sum((y_pred == c) & (y_true == c)) for c in classes],
                  dtype=np.float64)
    fp = np.array([np.sum((y_pred == c) & (y_true != c)) for c in classes],
                  dtype=np.float64)
    fn = np.array([np.sum((y_pred != c) & (y_true == c)) for c in classes],
                  dtype=np.float64)
    if average == "micro":
        denom = 2 * tp.sum() + fp.sum() + fn.sum()
        return float(2 * tp.sum() / denom) if denom else 0.0
    prec = tp / np.maximum(tp + fp, 1)
    rec = tp / np.maximum(tp + fn, 1)
    f1 = 2 * prec * rec / np.maximum(prec + rec, 1e-12)
    return float(f1.mean())


def roc_auc_score(y_true, y_score):
    """Binary AUC by the rank statistic, tied scores taking their midrank."""
    y_true = np.asarray(y_true).astype(np.float64).reshape(-1)
    y_score = np.asarray(y_score).astype(np.float64).reshape(-1)
    n_pos = float(np.sum(y_true == 1))
    n_neg = float(np.sum(y_true == 0))
    if n_pos == 0 or n_neg == 0:
        raise ValueError("AUC undefined without both classes")
    order = np.argsort(y_score, kind="mergesort")
    sorted_scores = y_score[order]
    ranks = np.empty(len(y_score), dtype=np.float64)
    r = np.arange(1, len(y_score) + 1, dtype=np.float64)
    i = 0
    while i < len(sorted_scores):
        j = i
        while (j + 1 < len(sorted_scores)
               and sorted_scores[j + 1] == sorted_scores[i]):
            j += 1
        ranks[order[i:j + 1]] = r[i:j + 1].mean()
        i = j + 1
    pos_rank_sum = ranks[y_true == 1].sum()
    return float((pos_rank_sum - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def eval_rocauc(y_true, y_pred):
    """OGB-style multi-task ROC-AUC (``data_utils.py:262-285``): with one
    label column the score is the softmax probability of class 1, else each
    column scores its task. A task without both classes is skipped, NaN
    labels within a task are left out, and the defined tasks are
    averaged."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    if y_true.ndim == 1:
        y_true = y_true[:, None]
    if y_true.shape[1] == 1:
        y_score = _softmax(y_pred, axis=-1)[:, 1][:, None]
    else:
        y_score = y_pred
    aucs = []
    for i in range(y_true.shape[1]):
        col = y_true[:, i]
        if np.sum(col == 1) > 0 and np.sum(col == 0) > 0:
            is_labeled = col == col
            aucs.append(roc_auc_score(col[is_labeled], y_score[is_labeled, i]))
    if not aucs:
        raise RuntimeError("No positively labeled data available.")
    return sum(aucs) / len(aucs)


def eval_mse(y_true, y_pred):
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).reshape(-1)
    return float(np.mean((y_true - y_pred) ** 2))


METRICS = {
    "acc": eval_acc,
    "f1": eval_f1,
    "rocauc": eval_rocauc,
    "mse": eval_mse,
}


def device_rocauc_tasks(scores, labels, mask):
    """Multi-task ROC-AUC on the scores' device, a 0-d float32 tensor:
    midranks for ties as :func:`roc_auc_score`, tasks without both classes
    skipped as :func:`eval_rocauc`. scores, labels [N, T]; mask bool [N],
    the split's rows. Labels are binary 0/1 (no NaN labels).

    Each task's scores are sorted with the rows outside the mask moved past
    the real ones (their ranks never enter the statistic). A run of tied
    scores at sorted positions a..b gets the midrank (a + b)/2 + 1, found
    from the run's first and last positions by a running max and a reversed
    running min: no segment sum, so the midranks are exact in float32 (for
    N < 2²³) and computed without atomics in any order. The only sums are
    the positives' rank sum and the class counts, float32 reductions over
    N. The host's float64 statistic agrees to ~1e-5.
    """
    n = scores.shape[0]
    scores = scores.float()
    big = scores.abs().amax(dim=0, keepdim=True) * 2 + 1e6      # [1, T]
    key = torch.where(mask[:, None], scores, big)                 # [N, T]
    s_sorted, order = torch.sort(key, dim=0, stable=True)
    pos = torch.arange(n, device=scores.device)[:, None].expand_as(key)
    new_run = torch.ones_like(key, dtype=torch.bool)
    new_run[1:] = s_sorted[1:] != s_sorted[:-1]
    run_end = torch.ones_like(key, dtype=torch.bool)
    run_end[:-1] = new_run[1:]
    first = torch.cummax(torch.where(new_run, pos, 0), dim=0).values
    last = torch.where(run_end, pos, n - 1).flip(0)
    last = last.cummin(dim=0).values.flip(0)
    mid_sorted = (first + last).float() / 2 + 1
    ranks = torch.empty_like(mid_sorted).scatter_(0, order, mid_sorted)
    m = mask[:, None]
    positive = ((labels == 1) & m).float()
    n_pos = positive.sum(0)
    n_neg = ((labels == 0) & m).float().sum(0)
    pos_rank_sum = (ranks * positive).sum(0)
    auc = ((pos_rank_sum - n_pos * (n_pos + 1) / 2.0)
           / torch.clamp(n_pos * n_neg, min=1.0))
    valid = ((n_pos > 0) & (n_neg > 0)).float()
    return (auc * valid).sum() / torch.clamp(valid.sum(), min=1.0)
