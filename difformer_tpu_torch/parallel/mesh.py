"""Process groups for node-sharded execution, the port's counterpart of
``difformer_tpu/parallel/mesh.py``.

The JAX package names a mesh axis (``"graph"``) and lets ``shard_map`` put
one shard on each device. The port runs one process a shard instead, each
joined to a ``torch.distributed`` process group: :func:`make_mesh` starts
this process's membership (world size, rank, an explicit backend, a file
store for the rendezvous) and returns a :class:`Mesh` with the group of the
graph axis, which the model and the sharded ops take as ``axis_name``.

:func:`make_grid` lays a run's ranks out as the JAX package's 2-D
``make_mesh((G, T), ("graph", "model"))``: rank g·T + m is row g of the
model axis and column m of the graph axis, and gets a :class:`Grid` of its
graph group (the G ranks of its column: its node shard g of G) and its
model group (the T ranks of its row: heads block m of T), each a
:class:`Mesh`.

Backends: ``nccl`` puts one rank on each card, so asking for more NCCL
ranks than there are cards raises; ``gloo`` runs on the CPU, and on a card
where several ranks share one (every rank on ``cuda:0``). A backend is
never switched behind the caller's back.
"""

from __future__ import annotations

import dataclasses
import datetime

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
#: How long a rank waits for the others in a collective before it fails.
TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the 1-D graph axis: its process group, its rank
    and the axis size, the backend and the device its shard lives on."""

    group: object
    rank: int
    size: int
    backend: str
    device: torch.device


def rank_device(backend, device, rank) -> torch.device:
    """The device of ``rank``: under NCCL card ``rank``
    (:func:`check_world` checks that there is one), under gloo ``device``
    as asked (``"cuda"``: card 0, shared by every rank)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    dev = torch.device(device)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"the nccl backend runs on CUDA devices, got "
                             f"{dev}")
        return torch.device("cuda", rank)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", 0)
    return dev


def _require_card(dev):
    """``dev``, or raise where it is a card and there is none."""
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(with the gloo backend) to run on the CPU")
    return dev


def check_world(backend, device, world_size):
    """Raise unless ``world_size`` ranks of ``backend`` fit the machine:
    NCCL takes one card a rank (it does not put two ranks on one card)."""
    if world_size < 1:
        raise ValueError(f"world_size must be at least 1, got {world_size}")
    _require_card(rank_device(backend, device, 0))
    if backend == "nccl" and world_size > torch.cuda.device_count():
        raise ValueError(
            f"nccl puts one rank on a card: {world_size} ranks need "
            f"{world_size} cards, this machine has "
            f"{torch.cuda.device_count()}; ask for the gloo backend "
            f"(backend=\"gloo\") to put several ranks on one card")


def make_mesh(world_size, rank, *, backend, init_method,
              device="cuda") -> Mesh:
    """Join this process to the graph axis as ``rank`` of ``world_size``
    ranks that all run on this machine (:func:`check_world` first), through
    :func:`join_mesh`. Under NCCL the process's current card becomes card
    ``rank``. :func:`close_mesh` leaves the group."""
    check_world(backend, device, world_size)
    return join_mesh(world_size, rank, backend=backend,
                     init_method=init_method, device=device)


def join_mesh(world_size, rank, *, backend, init_method, device="cuda",
              card=None) -> Mesh:
    """``torch.distributed.init_process_group`` with ``backend`` and the
    rendezvous ``init_method`` (a ``file://`` path that every rank of the
    run shares and no other run uses, or rank 0's ``tcp://`` address), and
    the :class:`Mesh` of the group. Under NCCL the rank runs on card
    ``card`` (``rank`` when None), which becomes the process's current
    card."""
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside [0, {world_size})")
    dev = _require_card(rank_device(backend, device,
                                    rank if card is None else card))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    group = dist.group.WORLD
    return Mesh(group=group, rank=dist.get_rank(group),
                size=dist.get_world_size(group), backend=backend, device=dev)


def sub_mesh(mesh: Mesh, size: int, backend=None):
    """The graph axis of the first ``size`` ranks of ``mesh`` (a new group
    on ``backend``, by default the same one), for those ranks, and None for
    the others. Every rank of ``mesh`` must call it, in the same order."""
    if not 1 <= size <= mesh.size:
        raise ValueError(f"a sub-axis of {size} ranks of {mesh.size}")
    backend = backend or mesh.backend
    group = dist.new_group(list(range(size)), backend=backend)
    if mesh.rank >= size:
        return None
    return Mesh(group=group, rank=dist.get_rank(group), size=size,
                backend=backend, device=mesh.device)


@dataclasses.dataclass(frozen=True)
class Grid:
    """One rank's view of a graph × model grid: ``graph``, the group of
    its column (the ranks of its heads block, one a node shard, ``graph.
    rank`` = g), ``model``, the group of its row (the ranks of its node
    shard, one a heads block, ``model.rank`` = m), and ``world``, every
    rank of the run (rank g·T + m)."""

    graph: Mesh
    model: Mesh
    world: Mesh

    @property
    def device(self):
        return self.world.device


def make_grid(mesh: Mesh, graph: int, model: int) -> Grid:
    """This rank's :class:`Grid` of ``graph`` × ``model`` ranks over
    ``mesh``, which must be the whole run (every rank of the default
    group, ``graph · model`` of them). Every rank calls it: each makes the
    group of every column, then of every row, in that order (a rank that
    made fewer would leave the others waiting)."""
    if graph < 1 or model < 1 or graph * model != mesh.size:
        raise ValueError(f"a grid of {graph} x {model} ranks needs "
                         f"{graph * model} ranks, the mesh has {mesh.size}")
    if mesh.size != dist.get_world_size():
        raise ValueError(f"a grid spans the whole run: the mesh has "
                         f"{mesh.size} of its {dist.get_world_size()} ranks")
    g, m = divmod(mesh.rank, model)
    columns = [dist.new_group([r * model + c for r in range(graph)],
                              backend=mesh.backend) for c in range(model)]
    rows = [dist.new_group([r * model + c for c in range(model)],
                           backend=mesh.backend) for r in range(graph)]

    def axis(group, rank, size):
        return Mesh(group=group, rank=rank, size=size, backend=mesh.backend,
                    device=mesh.device)

    return Grid(graph=axis(columns[m], g, graph),
                model=axis(rows[g], m, model), world=mesh)


def close_mesh(mesh: Mesh) -> None:
    """Leave the process group of ``mesh``."""
    if dist.is_initialized():
        dist.destroy_process_group()
