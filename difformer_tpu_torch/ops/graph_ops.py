"""Graph convolution, as ``difformer_tpu/ops/graph_ops.py:23-125, 224-236``.

The reference (``node classification/difformer.py:63-79``) builds the
normalised adjacency transposed, so each edge (s, r) adds
``value · x[s]`` into ``out[r]``, with
``value = w · (1/deg[r]).sqrt() · (1/deg[s]).sqrt()``, ``deg`` counted over
receivers and non-finite values set to 0.

Both products here, :func:`gcn_conv` and :func:`spmm`, run the CSR SpMM K1
(``kernels/spmm.py``) over a :class:`CsrPlan`: the receivers' CSR, the
senders' (transposed) CSR for the backward, the values in both orders, and
each CSR's split schedule of heavy rows.
``gcn_conv``'s plan, with the normalised values, depends only on the
graph's indices, ``edge_weight`` and ``edge_mask``, so a caller that runs
many convolutions on one graph builds it once (``GraphData.csr_plan()``)
and passes it; without one, each call builds its own, with a sort and a
degree pass. ``spmm`` takes its values from the caller and sorts its edges
on every call.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from difformer_tpu_torch.kernels.spmm import CsrSpmm, RowSplit, row_split
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


@dataclasses.dataclass(frozen=True)
class CsrPlan:
    """The two CSRs of one graph's edges, for K1 and its backward.

    ``row_ptr``/``col`` are the receivers' row pointers and the senders in
    receiver order, ``t_row_ptr``/``t_col`` the senders' row pointers and
    the receivers in sender order (both orders stable); ``val``/``t_val``
    the per-edge values in the two orders; ``split``/``t_split`` the two
    CSRs' schedules of heavy rows for K1 (``kernels/spmm.py``,
    :func:`row_split` at ``SPLIT_THRESHOLD``)."""

    num_nodes: int
    row_ptr: torch.Tensor      # int32 [N + 1]
    col: torch.Tensor          # int32 [E]
    val: torch.Tensor          # float32 [E]
    t_row_ptr: torch.Tensor    # int32 [N + 1]
    t_col: torch.Tensor        # int32 [E]
    t_val: torch.Tensor        # float32 [E]
    split: RowSplit
    t_split: RowSplit

    @property
    def num_edges(self):
        return self.col.numel()


def _row_ptr(index, num_nodes):
    counts = torch.bincount(index, minlength=num_nodes)
    ptr = torch.zeros(num_nodes + 1, dtype=torch.int64, device=index.device)
    ptr[1:] = torch.cumsum(counts, 0)
    return ptr.to(torch.int32)


def _checked_edges(senders, receivers, num_nodes):
    """(senders, receivers) as int64, after checking that every index lies
    in [0, num_nodes) and that E < 2³¹ (the kernel's int32 columns and row
    pointers)."""
    e = senders.numel()
    if receivers.shape != senders.shape or senders.dim() != 1:
        raise ValueError(f"senders and receivers must be [E], got "
                         f"{tuple(senders.shape)}, {tuple(receivers.shape)}")
    if e >= 2**31:
        raise ValueError(f"the CSR plan takes fewer than 2**31 edges, got {e}")
    senders, receivers = senders.long(), receivers.long()
    if e and (int(torch.minimum(senders.min(), receivers.min())) < 0
              or int(torch.maximum(senders.max(), receivers.max()))
              >= num_nodes):
        raise ValueError(f"edge indices must lie in [0, {num_nodes})")
    return senders, receivers


def _plan(senders, receivers, num_nodes, value) -> CsrPlan:
    order = torch.argsort(receivers, stable=True)
    t_order = torch.argsort(senders, stable=True)
    row_ptr = _row_ptr(receivers, num_nodes)
    t_row_ptr = _row_ptr(senders, num_nodes)
    return CsrPlan(
        num_nodes=num_nodes, row_ptr=row_ptr,
        col=senders[order].to(torch.int32), val=value[order],
        t_row_ptr=t_row_ptr,
        t_col=receivers[t_order].to(torch.int32), t_val=value[t_order],
        split=row_split(row_ptr), t_split=row_split(t_row_ptr))


def build_csr_plan(senders, receivers, num_nodes, edge_weight=None,
                   edge_mask=None) -> CsrPlan:
    """The :class:`CsrPlan` of edges (senders, receivers), in any order, on
    their device, with the GCN values of :func:`gcn_norm_weights_masked`.
    Checks that every index lies in [0, num_nodes) and that E < 2³¹."""
    senders, receivers = _checked_edges(senders, receivers, num_nodes)
    value = gcn_norm_weights_masked(senders, receivers, num_nodes,
                                    edge_weight, edge_mask).float()
    return _plan(senders, receivers, num_nodes, value)


def _csr_product(x, plan, edge_chunk_size):
    """K1 over ``plan``, for x of any trailing shape [N, ...] (all heads and
    channels in one product)."""
    if x.shape[0] != plan.num_nodes:
        raise ValueError(f"x has {x.shape[0]} rows; the plan has "
                         f"{plan.num_nodes} nodes")
    flat = x.reshape(x.shape[0], -1)
    out = CsrSpmm.apply(
        flat, (plan.row_ptr, plan.col, plan.val, plan.split),
        (plan.t_row_ptr, plan.t_col, plan.t_val, plan.t_split),
        edge_chunk_size)
    return out.reshape(x.shape)


def gcn_conv(x, senders, receivers, edge_weight=None, *, num_nodes=None,
             edge_mask=None, indices_are_sorted=False, edge_chunk_size=None,
             plan: Optional[CsrPlan] = None):
    """``out[r] += value · x[s]`` over every edge, for float32 x of any
    trailing shape (e.g. [N, H, D]: all heads in one product), through K1.

    ``edge_mask`` marks real edges; padded edges point at a valid node and
    are zeroed. ``indices_are_sorted`` is accepted as in the JAX package;
    the plan's own sort makes it moot. ``edge_chunk_size`` keeps the JAX
    package's meaning, at most that many [E, ...] messages at once: the
    plain version streams the edges in chunks of it, and the kernel never
    makes the messages at all. ``plan``, the graph's :class:`CsrPlan`
    (``GraphData.csr_plan()``), replaces senders, receivers, edge_weight
    and edge_mask, which are then not read; without it the call builds
    one."""
    del indices_are_sorted
    if plan is None:
        plan = build_csr_plan(senders, receivers,
                              x.shape[0] if num_nodes is None else num_nodes,
                              edge_weight, edge_mask)
    return _csr_product(x, plan, edge_chunk_size)


def spmm(values, senders, receivers, x, num_nodes=None, *,
         indices_are_sorted=False):
    """Generic sparse @ dense: ``out[r] += values[e] · x[s]`` (COO), through
    K1 with the caller's values, which get no gradient. Each call sorts the
    edges into the two CSRs it needs."""
    del indices_are_sorted
    n = x.shape[0] if num_nodes is None else num_nodes
    senders, receivers = _checked_edges(senders, receivers, n)
    plan = _plan(senders, receivers, n, values.detach().float())
    return _csr_product(x, plan, None)
