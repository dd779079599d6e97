"""Segment reductions, as ``difformer_tpu/ops/segment.py:18-68``.

The JAX package uses XLA's scatters (``jax.ops.segment_sum``,
``segment_max``); here they are ``index_add_`` and ``scatter_reduce_``.
They count degrees when a graph's plan is built and serve callers off the
training path. The models' sums that feed a loss run K1 over a plan instead
(``kernels/spmm.py``): ``index_add_`` on CUDA adds floats with atomics in no
fixed order. The baseline zoo's GAT takes its softmax over each receiver's
edges that way (``nn/gnns.py``); :func:`segment_softmax` is the JAX
package's function over unsorted segment ids.
"""

from __future__ import annotations

import torch


def segment_sum(data, segment_ids, num_segments):
    """Sum ``data`` rows into ``num_segments`` buckets by ``segment_ids``."""
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, segment_ids, data)


def segment_mean(data, segment_ids, num_segments):
    """Mean of ``data`` rows per segment; an empty segment gives 0."""
    totals = segment_sum(data, segment_ids, num_segments)
    counts = segment_sum(torch.ones(data.shape[0], dtype=data.dtype,
                                    device=data.device),
                         segment_ids, num_segments).clamp(min=1)
    return totals / counts.reshape((-1,) + (1,) * (data.dim() - 1))


def segment_max(data, segment_ids, num_segments):
    """Max of ``data`` rows per segment. An empty segment gives -inf, the
    identity of max, as ``jax.ops.segment_max`` does for a float type (the
    smallest value of the extended type). Its gradient goes to the maxima,
    as ``scatter_reduce``'s."""
    out = torch.full((num_segments,) + tuple(data.shape[1:]), float("-inf"),
                     dtype=data.dtype, device=data.device)
    index = segment_ids.long().reshape(
        (-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce(0, index, data, "amax", include_self=True)


def segment_softmax(logits, segment_ids, num_segments):
    """Softmax of ``logits`` [E, ...] within each segment: shifted by the
    segment's max (0 for a segment whose max is not finite), exponentiated
    and divided by the segment's sum, at least 1e-16 (the JAX package's
    ``segment_softmax``, GAT's attention in PyG)."""
    seg_max = segment_max(logits, segment_ids, num_segments)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                          torch.zeros_like(seg_max))
    exp = torch.exp(logits - seg_max[segment_ids])
    denom = segment_sum(exp, segment_ids, num_segments)
    return exp / denom.clamp(min=1e-16)[segment_ids]
