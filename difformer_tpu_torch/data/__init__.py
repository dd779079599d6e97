from difformer_tpu_torch.data.graph import GraphData, NodeDataset  # noqa: F401
from difformer_tpu_torch.data.splits import (  # noqa: F401
    class_rand_splits,
    even_quantile_labels,
    rand_train_test_idx,
)
from difformer_tpu_torch.data.synthetic import random_graph  # noqa: F401
from difformer_tpu_torch.data.transforms import standard_preprocess  # noqa: F401
