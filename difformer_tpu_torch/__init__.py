"""difformer_tpu_torch: the PyTorch and CUDA port of difformer_tpu for one
NVIDIA H100.

It mirrors the JAX package's layout (``data/``, ``ops/``, ``kernels/``,
``nn/``, ``train/``, ``utils/``) and imports nothing of it, nor JAX. Each
Pallas TPU kernel becomes a hand-written Hopper kernel (``csrc/``), built at
first use and bound with ctypes. Entry points run on the GPU unless given
``device="cpu"``; on the CPU every kernel runs as its plain PyTorch version.

Ported so far: full-batch and mini-batch node classification and the set
track with DIFFormer-s (``kernel="simple"``, the main path) and DIFFormer-a
(``kernel="sigmoid"``), at f32 or bf16 and with ``remat``; the temporal
track (DCRNN, MPNN-LSTM, ``TemporalTrainer``); the graph-level (particle)
track (DIFFormer-v2, ``GraphLevelTrainer``, the particle datasets); the
sparse layouts of the GCN branch (``ops/ell.py``, ``ops/bsr.py``); all
started from the command line (``python -m difformer_tpu_torch.cli``,
``cli.py``) with the dataset readers, transforms, loggers and
``sweep.py``. ROADMAP.md lists what is still to port.
"""

__version__ = "0.1.0"

from difformer_tpu_torch.data.graph import GraphData  # noqa: F401
from difformer_tpu_torch.nn.difformer import DIFFormer, DIFFormerConv  # noqa: F401
from difformer_tpu_torch.ops.graph_ops import (  # noqa: F401
    CsrPlan,
    build_csr_plan,
    degree,
    gcn_conv,
    gcn_norm_weights,
    spmm,
)
from difformer_tpu_torch.ops.linear_attention import (  # noqa: F401
    simple_attention,
    simple_attention_aggregates,
    simple_attention_head_mean_factored,
)
from difformer_tpu_torch.ops.segment import segment_sum  # noqa: F401
from difformer_tpu_torch.ops.sigmoid_attention import (  # noqa: F401
    sigmoid_attention,
    sigmoid_attention_dense,
)
from difformer_tpu_torch.train.trainer import FullBatchTrainer  # noqa: F401
