from difformer_tpu_torch.train.optim import torch_adam  # noqa: F401
from difformer_tpu_torch.train.trainer import (  # noqa: F401
    FullBatchTrainer,
    TrainState,
    nll_loss,
)
