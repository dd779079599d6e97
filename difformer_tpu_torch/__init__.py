"""difformer_tpu_torch: the PyTorch and CUDA port of difformer_tpu for one
NVIDIA H100.

It mirrors the JAX package's layout (``data/``, ``ops/``, ``kernels/``,
``nn/``, ``train/``, ``utils/``) and imports nothing of it, nor JAX. Each
Pallas TPU kernel becomes a hand-written Hopper kernel (``csrc/``), built at
first use and bound with ctypes. Entry points run on the GPU unless given
``device="cpu"``; on the CPU every kernel runs as its plain PyTorch version.

Ported so far: full-batch node classification with DIFFormer-a
(``kernel="sigmoid"``). ROADMAP.md lists what is still to port.
"""

__version__ = "0.1.0"

from difformer_tpu_torch.data.graph import GraphData  # noqa: F401
from difformer_tpu_torch.nn.difformer import DIFFormer, DIFFormerConv  # noqa: F401
from difformer_tpu_torch.ops.graph_ops import (  # noqa: F401
    degree,
    gcn_conv,
    gcn_norm_weights,
)
from difformer_tpu_torch.ops.segment import segment_sum  # noqa: F401
from difformer_tpu_torch.ops.sigmoid_attention import (  # noqa: F401
    sigmoid_attention,
    sigmoid_attention_dense,
)
from difformer_tpu_torch.train.trainer import FullBatchTrainer  # noqa: F401
