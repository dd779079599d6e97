"""Starting the ranks of a sharded run on one machine.

:func:`run_ranks` spawns one process a rank with ``torch.multiprocessing``
(the ``spawn`` method: each child starts from a fresh interpreter and
imports only what unpickling ``fn`` needs, so a child never imports the
caller's test module, nor JAX), joins each to the graph axis
(``parallel/mesh.py``: an explicit backend, a file store in a directory of
its own) and calls ``fn(mesh, *args)`` there. ``fn`` must be importable by
name (a module-level function of the port's package) and its arguments and
results picklable: numpy arrays, numbers and dicts of them. The JAX
package's ``initialize_cluster`` (several hosts) is not ported here.
"""

from __future__ import annotations

import os
import queue as queue_module
import shutil
import tempfile
import time
import traceback

import torch
import torch.multiprocessing as mp

from difformer_tpu_torch.parallel.mesh import (check_world, close_mesh,
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
