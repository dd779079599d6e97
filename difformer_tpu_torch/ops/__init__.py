from difformer_tpu_torch.ops.graph_ops import gcn_conv  # noqa: F401
from difformer_tpu_torch.ops.segment import segment_sum  # noqa: F401
from difformer_tpu_torch.ops.sigmoid_attention import (  # noqa: F401
    sigmoid_attention,
    sigmoid_attention_dense,
)
