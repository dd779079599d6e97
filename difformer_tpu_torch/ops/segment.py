"""Segment reductions, as ``difformer_tpu/ops/segment.py:18``.

The JAX package uses XLA's scatter-add (``jax.ops.segment_sum``); here it is
``index_add_``. It counts degrees when a graph's CSR plan is built; the GCN
branch itself runs the CSR SpMM K1 (``kernels/spmm.py``).
"""

from __future__ import annotations

import torch


def segment_sum(data, segment_ids, num_segments):
    """Sum ``data`` rows into ``num_segments`` buckets by ``segment_ids``."""
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, segment_ids, data)
