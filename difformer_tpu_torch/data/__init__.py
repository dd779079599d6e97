from difformer_tpu_torch.data.graph import (  # noqa: F401
    GraphData,
    NodeDataset,
    TemporalSnapshot,
)
from difformer_tpu_torch.data.splits import (  # noqa: F401
    class_rand_splits,
    even_quantile_labels,
    rand_train_test_idx,
)
from difformer_tpu_torch.data.synthetic import (  # noqa: F401
    random_graph,
    random_temporal_sequence,
)
from difformer_tpu_torch.data.transforms import standard_preprocess  # noqa: F401
