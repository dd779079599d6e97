"""Differentiable collectives over the graph axis.

The JAX package has no such module: under ``shard_map``, JAX transposes
``psum``, ``all_gather`` and ``all_to_all`` itself. Here each is a
``torch.autograd.Function`` whose backward is the transposed collective:

- :func:`all_reduce` of a partial sum: the backward all-reduces the
  gradient (each rank backpropagates its own part of the loss, and the
  value it reduced fed every rank's part);
- :func:`all_gather` along dim 0: the backward reduce-scatters (sums) the
  gradient and keeps this rank's rows;
- :func:`all_to_all` of equal splits along dim 0: the backward is the same
  exchange, which is its own inverse;
- :func:`ring_shift`, JAX's ``ppermute`` with ``perm=[(i, i+1 mod S)]``
  (the ring attention's exchange): the backward shifts the gradient the
  other way, the transpose of a permutation.

Over the model axis of tensor parallelism, where every rank holds the
same rows and backpropagates the whole loss, Megatron's pair:
:func:`copy_to_group` (identity forward, the gradient all-reduced: a
replicated input entering the rank's heads) and :func:`reduce_from_group`
(all-reduce forward, the gradient as it is: the heads' parts of the
layer's output summed).

:func:`all_to_all_start` starts the exchange and returns a handle whose
``wait()`` gives the result, so that a caller can compute meanwhile (the
overlapped halo exchange, ``parallel/sharded_ops.py``).

Every collective takes the tensors where they lie: under NCCL on the card,
under gloo on the CPU or on the card (gloo runs all of these
collectives on CUDA tensors in the torch of the H100 machine, copying
through the host itself, as ``chip_smoke.py``'s phase sharded-s shows by
running them there). A collective that fails raises; nothing is retried
another way.

Under NCCL every one of them can be recorded in a CUDA graph (the
distributed trainer's captured step and eval, ``train/distributed.py``):
the collective's stream joins the capture, and :meth:`Pending.wait`
records the join back. Gloo cannot be recorded (it moves CUDA tensors
through the host), so a gloo collective called while the current stream
is capturing raises instead of running once outside the graph; gloo steps
stay eager, which the trainer chooses by the backend.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# torch 2.13 renamed the tensor forms; older versions have the old names
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def check_group(group):
    """Raise unless ``group`` is a process group (the port has no named
    axes: an ``axis_name`` is the graph axis's group, ``Mesh.group``)."""
    if not isinstance(group, dist.ProcessGroup):
        raise TypeError(f"axis_name must be the process group of the graph "
                        f"axis (parallel/mesh.py: Mesh.group), got "
                        f"{group!r}")


def _check_capture(group):
    """Raise when the current stream is capturing a CUDA graph and
    ``group``'s backend cannot be recorded in one (every backend but
    NCCL)."""
    if (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing()
            and dist.get_backend(group) != "nccl"):
        raise RuntimeError(
            f"a {dist.get_backend(group)} collective cannot be recorded in a "
            f"CUDA graph: only NCCL's can (capture under NCCL, or run the "
            f"step eagerly)")


def all_reduce_(tensor, group):
    """Sum ``tensor`` over the group in place (no gradient)."""
    check_group(group)
    _check_capture(group)
    dist.all_reduce(tensor, group=group)
    return tensor


def _gather(tensor, group, size):
    _check_capture(group)
    tensor = tensor.contiguous()
    out = tensor.new_empty((size * tensor.shape[0],) + tuple(tensor.shape[1:]))
    _ALL_GATHER(out, tensor, group=group)
    return out


def _scatter(tensor, group, size):
    _check_capture(group)
    tensor = tensor.contiguous()
    out = tensor.new_empty((tensor.shape[0] // size,)
                           + tuple(tensor.shape[1:]))
    _REDUCE_SCATTER(out, tensor, group=group)
    return out


def _exchange(tensor, group):
    _check_capture(group)
    tensor = tensor.contiguous()
    out = torch.empty_like(tensor)
    dist.all_to_all_single(out, tensor, group=group)
    return out


def _shift(tensor, group, offset):
    """This rank's ``tensor`` sent to rank r + ``offset`` (mod S), rank
    r − ``offset``'s returned: one ``all_to_all_single`` whose splits are
    zero but for those two neighbours (at S = 1 the rank itself, at S = 2
    the same peer both ways)."""
    _check_capture(group)
    tensor = tensor.contiguous()
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    rows = tensor.shape[0]
    send, recv = [0] * size, [0] * size
    send[(rank + offset) % size] = rows
    recv[(rank - offset) % size] = rows
    out = torch.empty_like(tensor)
    dist.all_to_all_single(out, tensor, output_split_sizes=recv,
                           input_split_sizes=send, group=group)
    return out


def gather_raw(tensor, group):
    """[S·n, ...]: every rank's ``tensor`` [n, ...] in rank order, with no
    gradient (for a Function that states its own backward)."""
    check_group(group)
    return _gather(tensor, group, dist.get_world_size(group))


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        return all_reduce_(tensor.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        ctx.size = dist.get_world_size(group)
        return _gather(tensor, group, ctx.size)

    @staticmethod
    def backward(ctx, grad):
        return _scatter(grad, ctx.group, ctx.size), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        return _exchange(tensor, group)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.group), None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        return _shift(tensor, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, -1), None


def all_reduce(tensor, group):
    """The sum of ``tensor`` over the group; its gradient is the sum of the
    ranks' gradients."""
    check_group(group)
    return _AllReduce.apply(tensor, group)


def all_gather(tensor, group):
    """[S·n, ...]: every rank's ``tensor`` [n, ...] in rank order; the
    gradient of this rank's rows is the sum of every rank's gradient of
    them."""
    check_group(group)
    return _AllGather.apply(tensor, group)


def all_to_all(tensor, group):
    """[S·b, ...]: block j of the result is rank j's block for this rank,
    of ``tensor`` [S·b, ...] cut into S blocks (block j for rank j)."""
    check_group(group)
    return _AllToAll.apply(tensor, group)


def ring_shift(tensor, group):
    """Rank r − 1's ``tensor`` [n, ...] (mod S), this rank's sent on to
    rank r + 1, every rank's of the same shape; the gradient goes back
    the other way."""
    check_group(group)
    return _RingShift.apply(tensor, group)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        return tensor.view_as(tensor)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, group):
        return all_reduce_(tensor.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_group(tensor, group):
    """``tensor`` as it is; its gradient is the sum of the ranks'
    gradients (every rank holds the same ``tensor``)."""
    check_group(group)
    return _CopyToGroup.apply(tensor, group)


def reduce_from_group(tensor, group):
    """The sum of ``tensor`` over the group; its gradient is the output's
    gradient as it is (every rank holds the same one)."""
    check_group(group)
    return _ReduceFromGroup.apply(tensor, group)


class Pending:
    """An exchange in flight: :meth:`wait` gives its result."""

    def __init__(self, work, out, tensor):
        # the input stays alive until the exchange has read it
        self._work, self._out, self._tensor = work, out, tensor

    def wait(self):
        self._work.wait()
        self._tensor = None
        return self._out


def all_to_all_start(tensor, group) -> Pending:
    """Start :func:`all_to_all` of ``tensor`` (no gradient) and return the
    :class:`Pending` exchange; under NCCL ``wait()`` makes the current
    stream wait for it."""
    check_group(group)
    _check_capture(group)
    tensor = tensor.contiguous()
    out = torch.empty_like(tensor)
    work = dist.all_to_all_single(out, tensor, group=group, async_op=True)
    return Pending(work, out, tensor)
