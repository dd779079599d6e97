"""Node-sharded execution on ``torch.distributed``, the port of
``difformer_tpu/parallel/``: the host partition (``partition.py``), the
graph axis as a process group (``mesh.py``), the sharded graph branch on K1
and the ring sigmoid attention on K2–K4 (``sharded_ops.py``, over the
differentiable collectives of ``ops/comm.py``; the sharded block-sparse
hybrid is in ``ops/bsr.py``), the sharded forward and train step
(``api.py``) and the ranks' launchers (``launch.py``: spawned ranks, or a
cluster joined from the ``DIFFORMER_*`` variables). The distributed trainer
on top of them is ``train/distributed.py``. The data- and tensor-parallel
modules are not ported yet (ROADMAP.md queue A item 10c)."""

from difformer_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    close_mesh,
    make_mesh,
)
from difformer_tpu_torch.parallel.partition import (  # noqa: F401
    RankGraph,
    ShardedGraph,
    boundary_rows,
    crossing_counts,
    edge_balanced_layout,
    locality_layout,
    partition_graph,
    shard_balance_stats,
)
