"""Starting the ranks of a sharded run on one machine.

:func:`run_ranks` spawns one process a rank with ``torch.multiprocessing``
(the ``spawn`` method: each child starts from a fresh interpreter and
imports only what unpickling ``fn`` needs, so a child never imports the
caller's test module, nor JAX), joins each to the graph axis
(``parallel/mesh.py``: an explicit backend, a file store in a directory of
its own) and calls ``fn(mesh, *args)`` there. ``fn`` must be importable by
name (a module-level function of the port's package) and its arguments and
results picklable: numpy arrays, numbers and dicts of them.

:func:`initialize_cluster` is the other way in, the counterpart of
``difformer_tpu/parallel/launch.py:16-53``: a process started by the user
(one a host, or several) joins a group of ranks that it names itself, from
its arguments or from the JAX package's variables ``DIFFORMER_NUM_PROCESSES``,
``DIFFORMER_COORDINATOR`` and ``DIFFORMER_PROCESS_ID`` (:func:`cluster_env`
reads them); :func:`is_primary` and :func:`global_device_count` answer as
the JAX functions do.
"""

from __future__ import annotations

import os
import queue as queue_module
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from difformer_tpu_torch.parallel.mesh import (Mesh, check_world,
                                               close_mesh, join_mesh,
                                               make_mesh)


def rank_threads(world):
    """torch's intra-op threads for each of ``world`` ranks: the CPUs over
    the ranks, and over the pytest-xdist workers when there are any (each
    runs its own ranks)."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, (os.cpu_count() or 1) // (workers * world))


def _rank_main(fn, rank, world, backend, device, init_method, threads, args,
               kwargs, results):
    try:
        torch.set_num_threads(threads)
        mesh = make_mesh(world, rank, backend=backend,
                         init_method=init_method, device=device)
        try:
            out = fn(mesh, *args, **kwargs)
        finally:
            close_mesh(mesh)
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn, world, backend, device, *args, timeout_s=900.0, **kwargs):
    """``[fn(mesh, *args, **kwargs) of rank 0, ..., of rank world - 1]``,
    each in a
    process of its own, joined to a group of ``world`` ranks on
    ``backend`` (``"nccl"``: card r for rank r; ``"gloo"``: every rank on
    ``device``, the CPU or one shared card). A rank that fails, or a run
    that outlasts ``timeout_s``, stops every rank and raises here with the
    failed ranks' tracebacks."""
    check_world(backend, device, world)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store = tempfile.mkdtemp(prefix="difformer_ranks_")
    init_method = "file://" + os.path.join(store, "store")
    threads = rank_threads(world)
    procs = [ctx.Process(target=_rank_main, name=f"rank-{rank}",
                         args=(fn, rank, world, backend, device, init_method,
                               threads, args, kwargs, results))
             for rank in range(world)]
    outs, errors = [None] * world, {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        done = 0
        while done < world and not errors:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue_module.Empty:
                dead = [p for p in procs
                        if p.exitcode not in (None, 0)]
                if dead:  # killed before it could report
                    errors.update({int(p.name.split("-")[1]):
                                   f"exited with code {p.exitcode}"
                                   for p in dead})
                elif time.monotonic() > deadline:
                    errors[-1] = f"timed out after {timeout_s:.0f} s"
                continue
            done += 1
            if ok:
                outs[rank] = payload
            else:
                errors[rank] = payload
    finally:
        for p in procs:
            if p.is_alive() and errors:
                p.terminate()
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(store, ignore_errors=True)
    if errors:
        detail = "\n".join(f"--- rank {r} ---\n{e}"
                           for r, e in sorted(errors.items()))
        raise RuntimeError(f"{len(errors)} of {world} ranks failed "
                           f"({backend} on {device}):\n{detail}")
    return outs


def cluster_env():
    """(coordinator address, process count, process id) from the JAX
    package's variables ``DIFFORMER_COORDINATOR``,
    ``DIFFORMER_NUM_PROCESSES`` and ``DIFFORMER_PROCESS_ID`` (default 0),
    or None where no count is set: the process is not one of a cluster."""
    env_procs = os.environ.get("DIFFORMER_NUM_PROCESSES")
    if env_procs is None:
        return None
    return (os.environ.get("DIFFORMER_COORDINATOR"), int(env_procs),
            int(os.environ.get("DIFFORMER_PROCESS_ID", 0)))


def initialize_cluster(coordinator_address=None, num_processes=None,
                       process_id=None, *, backend, device) -> Mesh | None:
    """Join this process to a group of ``num_processes`` ranks as rank
    ``process_id``, meeting the others at ``coordinator_address``
    (``host:port``, rank 0's; ``tcp://`` is added), on ``backend``, which
    is always the caller's choice. With no address and no count they come
    from the JAX package's variables (:func:`cluster_env`).
    Returns the :class:`~difformer_tpu_torch.parallel.mesh.Mesh` of the
    group, or None for one process (no variable, or a count of 1), as the
    JAX function returns False.

    Under NCCL rank r takes card ``r % cards`` of its host (a cluster of
    hosts with as many cards each, ranks numbered host by host); two ranks
    on one card fail in NCCL. Under gloo every rank takes ``device``."""
    if num_processes is None and coordinator_address is None:
        env = cluster_env()
        if env is None:
            return None  # one process
        coordinator_address, num_processes, process_id = env
    if not num_processes or num_processes <= 1:
        return None
    if coordinator_address is None or process_id is None:
        raise ValueError("a cluster of several processes needs the "
                         "coordinator's address and this process's id")
    address = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
    card = None
    if backend == "nccl" and torch.cuda.is_available():
        card = process_id % torch.cuda.device_count()
    return join_mesh(num_processes, process_id, backend=backend,
                     init_method=address, device=device, card=card)


def is_primary() -> bool:
    """True on rank 0 of the process group; where there is none (before
    :func:`initialize_cluster` or after the group closed), on process 0 of
    the cluster that :func:`cluster_env` names, and on a process of its
    own."""
    if dist.is_initialized():
        return dist.get_rank() == 0
    env = cluster_env()
    return env is None or env[1] <= 1 or env[2] == 0


def global_device_count() -> int:
    """The ranks of the process group (one device each), 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1
