from difformer_tpu_torch.utils.device import resolve_device  # noqa: F401
from difformer_tpu_torch.utils.metrics import eval_acc  # noqa: F401
