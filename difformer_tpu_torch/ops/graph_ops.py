"""Graph convolution, as ``difformer_tpu/ops/graph_ops.py:23-125``.

The reference (``node classification/difformer.py:63-79``) builds the
normalised adjacency transposed, so each edge (s, r) adds
``value · x[s]`` into ``out[r]``, with
``value = w · (1/deg[r]).sqrt() · (1/deg[s]).sqrt()``, ``deg`` counted over
receivers and non-finite values set to 0.
"""

from __future__ import annotations

import torch

from difformer_tpu_torch.ops.segment import segment_sum


def degree(index, num_nodes, dtype=torch.float32):
    """Count occurrences of each node id in ``index`` (PyG ``degree``)."""
    return segment_sum(torch.ones(index.shape, dtype=dtype,
                                  device=index.device), index, num_nodes)


def _nan_to_num(x):
    """``torch.nan_to_num(nan=0, posinf=0, neginf=0)``."""
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def gcn_norm_weights(senders, receivers, num_nodes, edge_weight=None):
    """Per-edge symmetric-normalisation weights, as the reference."""
    deg = degree(receivers, num_nodes)
    inv_sqrt = torch.sqrt(1.0 / deg)  # inf where deg == 0, zeroed below
    value = inv_sqrt[receivers] * inv_sqrt[senders]
    if edge_weight is not None:
        value = edge_weight * value
    return _nan_to_num(value)


def gcn_norm_weights_masked(senders, receivers, num_nodes, edge_weight,
                            edge_mask):
    """``gcn_norm_weights`` with padded edges left out of both the degree
    and the value."""
    if edge_mask is None:
        return gcn_norm_weights(senders, receivers, num_nodes, edge_weight)
    ones = edge_mask.to(torch.float32)
    deg = segment_sum(ones, receivers, num_nodes)
    inv_sqrt = torch.sqrt(1.0 / deg)
    value = inv_sqrt[receivers] * inv_sqrt[senders]
    if edge_weight is not None:
        value = edge_weight * value
    return _nan_to_num(value) * ones


def gcn_conv(x, senders, receivers, edge_weight=None, *, num_nodes=None,
             edge_mask=None):
    """``out[r] += value · x[s]`` over every edge, for x of any trailing
    shape (e.g. [N, H, D]: all heads in one gather and one scatter).
    ``edge_mask`` marks real edges; padded edges point at a valid node and
    are zeroed."""
    if num_nodes is None:
        num_nodes = x.shape[0]
    value = gcn_norm_weights_masked(senders, receivers, num_nodes,
                                    edge_weight, edge_mask)
    msg = x[senders] * value.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)
    return segment_sum(msg, receivers, num_nodes)
