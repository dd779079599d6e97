"""The graph branch and the ring sigmoid attention of a node-sharded
DIFFormer, as ``difformer_tpu/parallel/sharded_ops.py:31-271``, every local
product on K1 (``kernels/spmm.py``) and every attention block on K2–K4
(``kernels/sigmoid_attention.py``).

Each rank holds N_loc nodes and the edges whose receivers it owns
(``parallel/partition.py``). The three exchanges of sender rows:

- :func:`gcn_conv_sharded`: x is all-gathered to [N_glob, W] and K1 runs
  over a plan of this rank's N_loc rows and the N_glob global columns;
  its backward reduce-scatters K1's transposed product;
- :func:`gcn_conv_halo`: each rank packs the rows its peers read into
  [S·B, W] (K1 over a 0/1 plan: slot j·B + b takes row ``send_idx[j, b]``),
  one ``all_to_all`` swaps the packs, and K1 runs over the
  ``[own ‖ halo]`` table (N_loc + S·B columns) with the host's normalised
  values; the pack's backward is K1 over the transposed 0/1 plan, so a row
  sent to several peers sums their gradients without an ``index_add_``;
- :func:`gcn_conv_halo_overlap`: the same exchange, with K1 over the
  internal edges (senders this rank owns) running while the ``all_to_all``
  is in flight, then K1 over the boundary edges; the backward overlaps the
  same way.

The K1 plans (:class:`GatherPlan`, :class:`HaloPlan`, :class:`OverlapPlan`)
are built once per rank and graph, before the first step, and passed to
every call: a call without one builds its own (with a sort, and for the
all-gather one collective). :func:`gather_plan` all-gathers the degree
vector once, where the JAX function all-gathers it on every call: the graph
is fixed, so the values are the same. A plan holds every entry of the JAX
function's arrays, the padding's zeros included, so that a NaN or Inf in x
spreads as it does there.

:func:`sigmoid_attention_sharded` is DIFFormer-a's attention across ranks:
each rank's queries meet every rank's keys in S ring steps, each step K2's
raw (numerator, denominator) of the local queries against the (k, v, mask)
shard in hand, summed in float32, then the shard shifted on to the next
rank (``comm.ring_shift``). k, v and the key mask travel as one packed
tensor, one exchange a step. The backward is autograd's through the loop:
K3 and K4 at every step, dq summed over the steps, and dk, dv carried home
by the shifts' transposes. The JAX package's rule that runs its Pallas
kernels only on a TPU at N_loc ≥ 4096 is a TPU's: on a CUDA tensor every
ring step launches K2 (K3, K4 in the backward), on a CPU tensor the same
Functions run their plain versions.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from difformer_tpu_torch.kernels.sigmoid_attention import (
    sigmoid_attention_flash_unnormalized)
from difformer_tpu_torch.kernels.spmm import csr_spmm
from difformer_tpu_torch.ops import comm
from difformer_tpu_torch.ops.graph_ops import (CsrPlan, _csr_product,
                                               build_value_plan)
from difformer_tpu_torch.ops.segment import segment_sum


@dataclasses.dataclass(frozen=True)
class GatherPlan:
    """K1's plan of :func:`gcn_conv_sharded`: this rank's N_loc receivers
    over the N_glob = S·N_loc global senders."""

    conv: CsrPlan


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """K1's plans of :func:`gcn_conv_halo`: the pack (S·B slots over the
    N_loc own rows, values 1) and the conv (N_loc receivers over the
    N_loc + S·B rows of ``[own ‖ halo]``)."""

    pack: CsrPlan
    conv: CsrPlan


@dataclasses.dataclass(frozen=True)
class OverlapPlan:
    """K1's plans of :func:`gcn_conv_halo_overlap`: the pack, the internal
    edges (N_loc over N_loc) and the boundary edges (N_loc over the S·B
    halo rows)."""

    pack: CsrPlan
    internal: CsrPlan
    boundary: CsrPlan


def gather_plan(senders_global, receivers_local, num_nodes,
                edge_weight=None, *, edge_mask=None, group) -> GatherPlan:
    """The :class:`GatherPlan` of this rank's edges (global senders,
    local receivers, ``num_nodes`` = N_loc): the receivers' degrees counted
    over the real edges (``edge_mask``), all-gathered once to the global
    degree vector, and ``w · deg[r]^-½ · deg[s]^-½`` as the JAX function
    computes it (float32, non-finite values 0)."""
    size = dist.get_world_size(group)
    ones = (torch.ones(senders_global.shape, device=senders_global.device)
            if edge_mask is None else edge_mask.float())
    receivers_local = receivers_local.long()
    senders_global = senders_global.long()
    deg_local = segment_sum(ones, receivers_local, num_nodes)
    with torch.no_grad():
        deg_full = comm.all_gather(deg_local, group)            # [N_glob]
    recv_global = receivers_local + dist.get_rank(group) * num_nodes
    inv_sqrt = torch.sqrt(1.0 / deg_full)
    value = inv_sqrt[recv_global] * inv_sqrt[senders_global]
    if edge_weight is not None:
        value = edge_weight * value
    value = torch.where(torch.isfinite(value), value,
                        torch.zeros_like(value)) * ones
    return GatherPlan(build_value_plan(value, senders_global, receivers_local,
                                    num_nodes, size * num_nodes))


def _pack_plan(send_idx, send_mask, num_nodes) -> CsrPlan:
    """The 0/1 plan that packs the rows ``send_idx`` [S, B] (slot j·B + b
    takes own row ``send_idx[j, b]`` where ``send_mask``) into [S·B, W]."""
    slots = send_idx.numel()
    return build_value_plan(
        send_mask.reshape(-1).float(), send_idx.reshape(-1).long(),
        torch.arange(slots, device=send_idx.device), slots, num_nodes)


def halo_plan(senders_table, receivers_local, edge_value, send_idx,
              send_mask, num_nodes) -> HaloPlan:
    """The :class:`HaloPlan` of this rank's halo arrays
    (``ShardedGraph.rank_graph``'s ``senders_table``, ``receivers``,
    ``edge_value``, ``send_idx``, ``send_mask``; ``num_nodes`` = N_loc)."""
    slots = send_idx.numel()
    return HaloPlan(
        pack=_pack_plan(send_idx, send_mask, num_nodes),
        conv=build_value_plan(edge_value.float(), senders_table.long(),
                           receivers_local.long(), num_nodes,
                           num_nodes + slots))


def overlap_plan(halo: dict, num_nodes) -> OverlapPlan:
    """The :class:`OverlapPlan` of this rank's overlap split (the dict of
    ``RankGraph.senders_and_halo``; ``num_nodes`` = N_loc)."""
    slots = halo["send_idx"].numel()
    return OverlapPlan(
        pack=_pack_plan(halo["send_idx"], halo["send_mask"], num_nodes),
        internal=build_value_plan(halo["int_value"].float(),
                               halo["int_senders"].long(),
                               halo["int_receivers"].long(), num_nodes,
                               num_nodes),
        boundary=build_value_plan(halo["bnd_value"].float(),
                               halo["bnd_senders"].long(),
                               halo["bnd_receivers"].long(), num_nodes,
                               slots))


def _flat(x):
    return x.reshape(x.shape[0], -1)


def gcn_conv_sharded(x, senders_global, receivers_local, edge_weight=None,
                     *, edge_mask=None, axis_name, plan=None):
    """The GCN conv over the whole graph for this rank's receivers: x
    [N_loc, ...] all-gathered, then K1 over ``plan`` (a
    :class:`GatherPlan`; built here, with its collective, without one).
    ``axis_name`` is the graph axis's process group."""
    if plan is None:
        plan = gather_plan(senders_global, receivers_local, x.shape[0],
                           edge_weight, edge_mask=edge_mask, group=axis_name)
    full = comm.all_gather(_flat(x), axis_name)
    return _csr_product(full, plan.conv, None).reshape(x.shape)


def gcn_conv_halo(x, senders_table, receivers_local, edge_value, send_idx,
                  send_mask, *, axis_name, plan=None):
    """The boundary-only conv: the packed rows through one ``all_to_all``,
    then K1 over ``[own ‖ halo]`` with the host's values (``plan`` a
    :class:`HaloPlan`, built here without one)."""
    n = x.shape[0]
    if plan is None:
        plan = halo_plan(senders_table, receivers_local, edge_value,
                         send_idx, send_mask, n)
    xf = _flat(x)
    recv = comm.all_to_all(_csr_product(xf, plan.pack, None), axis_name)
    table = torch.cat([xf, recv])
    return _csr_product(table, plan.conv, None).reshape(x.shape)


def _k1(x, plan, transposed=False):
    """K1 over ``plan``'s CSR (``transposed``: its transposed CSR)."""
    if transposed:
        return csr_spmm(x, plan.t_row_ptr, plan.t_col, plan.t_val,
                        split=plan.t_split, transposed=True)
    return csr_spmm(x, plan.row_ptr, plan.col, plan.val, split=plan.split)


class _OverlapConv(torch.autograd.Function):
    """internal + boundary, the ``all_to_all`` in flight while K1 runs on
    the internal edges, in the forward and the backward alike."""

    @staticmethod
    def forward(ctx, x, plan, group):
        ctx.plan, ctx.group = plan, group
        pending = comm.all_to_all_start(_k1(x, plan.pack), group)
        internal = _k1(x, plan.internal)
        boundary = _k1(pending.wait(), plan.boundary)
        return internal + boundary

    @staticmethod
    def backward(ctx, grad):
        plan, group = ctx.plan, ctx.group
        grad = grad.contiguous()
        pending = comm.all_to_all_start(
            _k1(grad, plan.boundary, transposed=True), group)
        internal = _k1(grad, plan.internal, transposed=True)
        packed = _k1(pending.wait(), plan.pack, transposed=True)
        return internal + packed, None, None


def gcn_conv_halo_overlap(x, halo, *, axis_name, plan=None):
    """The halo conv with the exchange overlapped by the internal edges'
    product. ``halo`` is the overlap split (the dict of
    ``RankGraph.senders_and_halo``), ``plan`` its :class:`OverlapPlan`
    (built here without one)."""
    if plan is None:
        plan = overlap_plan(halo, x.shape[0])
    return _OverlapConv.apply(_flat(x), plan, axis_name).reshape(x.shape)


def sharded_plan(senders, receivers, num_nodes, edge_weight=None, *,
                 edge_mask=None, halo=None, axis_name):
    """The rank's plan for the exchange that ``halo`` picks, as the model
    passes its arguments (``RankGraph.senders_and_halo``): a dict gives an
    :class:`OverlapPlan`, a tuple (send_idx, send_mask, edge_value) with
    the sender table as ``senders`` a :class:`HaloPlan`, None a
    :class:`GatherPlan` (one collective)."""
    if isinstance(halo, dict):
        return overlap_plan(halo, num_nodes)
    if halo is not None:
        send_idx, send_mask, edge_value = halo
        return halo_plan(senders, receivers, edge_value, send_idx, send_mask,
                         num_nodes)
    return gather_plan(senders, receivers, num_nodes, edge_weight,
                       edge_mask=edge_mask, group=axis_name)


def sharded_conv(x, senders, receivers, edge_weight=None, *, edge_mask=None,
                 halo=None, axis_name, plan=None):
    """The graph branch's product on one rank, by ``halo``'s type as the
    JAX model dispatches (a dict: :func:`gcn_conv_halo_overlap`, a tuple:
    :func:`gcn_conv_halo`, None: :func:`gcn_conv_sharded`), over ``plan``
    (:func:`sharded_plan`'s, which must be of that exchange)."""
    if isinstance(halo, dict):
        return gcn_conv_halo_overlap(x, halo, axis_name=axis_name,
                                     plan=_checked(plan, OverlapPlan))
    if halo is not None:
        send_idx, send_mask, edge_value = halo
        return gcn_conv_halo(x, senders, receivers, edge_value, send_idx,
                             send_mask, axis_name=axis_name,
                             plan=_checked(plan, HaloPlan))
    return gcn_conv_sharded(x, senders, receivers, edge_weight,
                            edge_mask=edge_mask, axis_name=axis_name,
                            plan=_checked(plan, GatherPlan))


def _checked(plan, kind):
    if plan is not None and not isinstance(plan, kind):
        raise TypeError(f"the exchange that halo picks runs on a "
                        f"{kind.__name__}, got {type(plan).__name__}")
    return plan


def _pack_width(width, dtype):
    """``width`` rounded up to whole 16-byte granules of ``dtype``."""
    per = 16 // dtype.itemsize
    return -(-width // per) * per


def sigmoid_attention_sharded(qs, ks, vs, *, key_mask=None, axis_name):
    """The ring sigmoid attention (the module's docstring): qs [N_loc, H,
    M], ks [N_loc, H, M], vs [N_loc, H, D] (or [N_loc, 1, D], broadcast
    over the heads) this rank's shards, ``key_mask`` [N_loc] its binary
    key mask or None; returns this rank's rows of the attention over the
    whole graph, [N_loc, H, D] in q's dtype. ``axis_name`` is the graph
    axis's process group."""
    comm.check_group(axis_name)
    size = dist.get_world_size(axis_name)
    if vs.shape[1] != qs.shape[1]:
        vs = vs.expand(-1, qs.shape[1], -1)
    rows, heads, m = ks.shape
    d = vs.shape[2]
    # [k | v | mask | 0] a row, each part at a 16-byte boundary
    kw, vw = _pack_width(heads * m, ks.dtype), _pack_width(heads * d,
                                                            ks.dtype)
    width = _pack_width(kw + vw + (key_mask is not None), ks.dtype)
    parts = [ks.reshape(rows, -1), ks.new_zeros((rows, kw - heads * m)),
             vs.reshape(rows, -1).to(ks.dtype),
             ks.new_zeros((rows, vw - heads * d))]
    if key_mask is not None:
        parts.append(key_mask.to(ks.dtype).reshape(rows, 1))
    parts.append(ks.new_zeros((rows, width - kw - vw
                               - (key_mask is not None))))
    shard = torch.cat(parts, 1)
    num = den = None
    for _ in range(size):
        k = shard[:, :heads * m].reshape(rows, heads, m)
        v = shard[:, kw:kw + heads * d].reshape(rows, heads, d)
        mask = None if key_mask is None else shard[:, kw + vw]
        num_p, den_p = sigmoid_attention_flash_unnormalized(qs, k, v, mask)
        num = num_p if num is None else num + num_p
        den = den_p if den is None else den + den_p
        # every step shifts, the last one too, as the JAX package's scan
        shard = comm.ring_shift(shard, axis_name)
    return (num / den[..., None]).to(qs.dtype)


def collective_bytes_per_layer(sg, *, feat_dim, num_heads=1, dtype_bytes=4):
    """The collective traffic of one DIFFormer layer's forward on the
    partition ``sg``, whole axis, in bytes, from the plan's shapes (the JAX
    package's function): ``halo_wire`` the ``all_to_all`` buffers
    (padded slots × row), ``halo_real`` the real boundary rows in them,
    ``allgather`` the all-gather's rows to every other rank, ``attn_psum``
    the attention's two reductions (independent of N)."""
    width = int(feat_dim) * int(num_heads)
    shards = int(sg.node_feat.shape[0])
    n_loc = int(sg.node_feat.shape[1])
    out = {}
    if sg.send_idx is not None:
        send_slots = int(np.prod(np.asarray(sg.send_idx).shape[1:]))
        out["halo_wire"] = send_slots * (shards - 1) * width * dtype_bytes
        out["halo_real"] = (int(np.asarray(sg.send_mask).sum()) * width
                            * dtype_bytes)
    out["allgather"] = shards * (shards - 1) * n_loc * width * dtype_bytes
    out["attn_psum"] = (2 * (num_heads * feat_dim
                             + num_heads * feat_dim * feat_dim)
                        * dtype_bytes * 2 * max(shards - 1, 0))
    return out
