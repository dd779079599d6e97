from difformer_tpu_torch.ops.graph_ops import (  # noqa: F401
    CsrPlan,
    build_csr_plan,
    build_spmm_plan,
    gcn_conv,
    gcn_norm,
    gen_normalized_adjs,
    spmm,
)
from difformer_tpu_torch.ops.linear_attention import (  # noqa: F401
    simple_attention,
    simple_attention_aggregates,
    simple_attention_head_mean_factored,
)
from difformer_tpu_torch.ops.segment import (  # noqa: F401
    segment_max,
    segment_mean,
    segment_softmax,
    segment_sum,
)
from difformer_tpu_torch.ops.sigmoid_attention import (  # noqa: F401
    sigmoid_attention,
    sigmoid_attention_dense,
)
from difformer_tpu_torch.ops.ell import (  # noqa: F401
    build_ell_gcn,
    ell_spmm,
    gcn_conv_ell,
)
from difformer_tpu_torch.ops.bsr import (  # noqa: F401
    bsr_bucketed_spmm,
    bsr_spmm,
    build_bsr_bucketed_gcn,
    build_bsr_gcn,
    choose_spmm,
)
