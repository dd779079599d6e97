"""Sharded execution on ``torch.distributed``, the port of
``difformer_tpu/parallel/``: the host partition (``partition.py``), the
graph axis as a process group and the graph × model grid (``mesh.py``),
the sharded graph branch on K1 and the ring sigmoid attention on K2–K4
(``sharded_ops.py``, over the differentiable collectives of
``ops/comm.py``; the sharded block-sparse hybrid is in ``ops/bsr.py``),
the sharded forward and train step (``api.py``), data parallelism over
batches of graphs (``data_parallel.py``), tensor parallelism over heads on
a model axis or a graph × model grid (``tensor_parallel.py``) and the
ranks' launchers (``launch.py``: spawned ranks, or a cluster joined from
the ``DIFFORMER_*`` variables). The distributed trainer on top of them is
``train/distributed.py``."""

from difformer_tpu_torch.parallel.mesh import (  # noqa: F401
    Grid,
    Mesh,
    close_mesh,
    make_grid,
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
from difformer_tpu_torch.parallel.tensor_parallel import (  # noqa: F401
    make_tp_train_step,
    tp_apply,
    tp_param_specs,
    tp_shard_params,
)
