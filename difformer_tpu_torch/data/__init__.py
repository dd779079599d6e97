from difformer_tpu_torch.data.graph import GraphData  # noqa: F401
from difformer_tpu_torch.data.splits import class_rand_splits  # noqa: F401
from difformer_tpu_torch.data.synthetic import random_graph  # noqa: F401
from difformer_tpu_torch.data.transforms import standard_preprocess  # noqa: F401
