"""Hand-written Hopper kernels (sources in ``csrc/``) with their plain
PyTorch versions and launch counts."""

from difformer_tpu_torch.kernels.sigmoid_attention import (  # noqa: F401
    LAUNCHES,
    reset_launch_counts,
    sigmoid_attention_flash,
    sigmoid_attention_flash_unnormalized,
)
from difformer_tpu_torch.kernels.spmm import (  # noqa: F401
    CsrSpmm,
    csr_spmm,
    csr_spmm_plain,
)
from difformer_tpu_torch.kernels.ell import ell_spmm_rows  # noqa: F401
from difformer_tpu_torch.kernels.bsr import bsr_spmm_blocks  # noqa: F401
