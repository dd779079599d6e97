"""Split generators (numpy), as ``difformer_tpu/data/splits.py:15-99``
(reference ``node classification/data_utils.py:13-132``; the graph-level
split ``physical particle/utils/utils.py:113-124``)."""

from __future__ import annotations

from typing import Dict

import numpy as np


def _rng(rng):
    if rng is None:
        return np.random.default_rng()
    if isinstance(rng, (int, np.integer)):
        return np.random.default_rng(rng)
    return rng


def rand_train_test_idx(label, train_prop=0.5, valid_prop=0.25,
                        ignore_negative=True, rng=None) -> Dict[str, np.ndarray]:
    """Random proportional split, ignoring label -1
    (``data_utils.py:13-37``)."""
    label = np.asarray(label)
    flat = label.reshape(label.shape[0], -1)[:, 0] if label.ndim > 1 else label
    rng = _rng(rng)
    if ignore_negative:
        labeled_nodes = np.where(flat != -1)[0]
    else:
        labeled_nodes = np.arange(label.shape[0])
    n = labeled_nodes.shape[0]
    train_num = int(n * train_prop)
    valid_num = int(n * valid_prop)
    perm = rng.permutation(n)
    return {
        "train": labeled_nodes[perm[:train_num]],
        "valid": labeled_nodes[perm[train_num:train_num + valid_num]],
        "test": labeled_nodes[perm[train_num + valid_num:]],
    }


def class_rand_splits(label, label_num_per_class, valid_num=500,
                      test_num=1000, test_rest=False, rng=None):
    """Class-balanced split: ``label_num_per_class`` train nodes per class,
    then ``valid_num`` validation and ``test_num`` test nodes from the rest
    (``test_rest=True``: all remaining nodes are test)."""
    label = np.asarray(label).squeeze()
    rng = _rng(rng)
    train_idx, non_train_idx = [], []
    for c in np.unique(label):
        idx_c = np.where(label == c)[0]
        perm = rng.permutation(idx_c.shape[0])
        idx_c = idx_c[perm]
        train_idx.extend(idx_c[:label_num_per_class].tolist())
        non_train_idx.extend(idx_c[label_num_per_class:].tolist())
    non_train_idx = np.asarray(non_train_idx)
    non_train_idx = non_train_idx[rng.permutation(non_train_idx.shape[0])]
    valid_idx = non_train_idx[:valid_num]
    if test_rest:
        test_idx = non_train_idx[valid_num:]
    else:
        test_idx = non_train_idx[valid_num:valid_num + test_num]
    return {
        "train": np.asarray(train_idx),
        "valid": valid_idx,
        "test": test_idx,
    }


def even_quantile_labels(vals, nclasses):
    """Quantile-bucketed class labels (the arxiv-year and snap-patents
    targets, ``data_utils.py:109-132``)."""
    vals = np.asarray(vals)
    label = -1 * np.ones(vals.shape[0], dtype=np.int64)
    lower = -np.inf
    for k in range(nclasses - 1):
        upper = np.quantile(vals, (k + 1) / nclasses)
        label[(vals >= lower) & (vals < upper)] = k
        lower = upper
    label[vals >= lower] = nclasses - 1
    return label


def get_random_idx_split(n, train_prop=0.7, valid_prop=0.15, rng=None):
    """Graph-level random split (``physical particle/utils/utils.py:
    113-124``): one permutation of ``n`` graphs cut into train, valid and
    test."""
    rng = _rng(rng)
    perm = rng.permutation(n)
    n_train = int(n * train_prop)
    n_valid = int(n * valid_prop)
    return {
        "train": perm[:n_train],
        "valid": perm[n_train:n_train + n_valid],
        "test": perm[n_train + n_valid:],
    }
