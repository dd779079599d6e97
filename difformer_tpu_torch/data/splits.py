"""Split generators (numpy), as ``difformer_tpu/data/splits.py:15-74``
(reference ``node classification/data_utils.py:91-107``)."""

from __future__ import annotations

import numpy as np


def _rng(rng):
    if rng is None:
        return np.random.default_rng()
    if isinstance(rng, (int, np.integer)):
        return np.random.default_rng(rng)
    return rng


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
