"""Hand-written Hopper kernels (sources in ``csrc/``) with their plain
PyTorch versions and launch counts."""

from difformer_tpu_torch.kernels.sigmoid_attention import (  # noqa: F401
    LAUNCHES,
    reset_launch_counts,
    sigmoid_attention_flash,
    sigmoid_attention_flash_unnormalized,
)
