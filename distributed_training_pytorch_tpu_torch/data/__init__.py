"""Data sources and the rank-sharded loader."""

from distributed_training_pytorch_tpu_torch.data.dataset import ArrayDataSource
from distributed_training_pytorch_tpu_torch.data.loader import ShardedLoader

__all__ = ["ArrayDataSource", "ShardedLoader"]
