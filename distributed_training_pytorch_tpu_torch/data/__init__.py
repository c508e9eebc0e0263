"""Data sources, the rank-sharded loader, the native host runtime and device prefetch."""

from distributed_training_pytorch_tpu_torch.data import native
from distributed_training_pytorch_tpu_torch.data.dataset import ArrayDataSource
from distributed_training_pytorch_tpu_torch.data.loader import ShardedLoader
from distributed_training_pytorch_tpu_torch.data.prefetch import device_prefetch

__all__ = ["ArrayDataSource", "ShardedLoader", "device_prefetch", "native"]
