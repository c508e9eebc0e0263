"""Data sources, the rank-sharded loader, the native host runtime and device prefetch."""

from distributed_training_pytorch_tpu_torch.data import native
from distributed_training_pytorch_tpu_torch.data.dataset import (
    ArrayDataSource,
    ImageFolderDataSource,
    NativeImageFolderSource,
)
from distributed_training_pytorch_tpu_torch.data.loader import ShardedLoader
from distributed_training_pytorch_tpu_torch.data.prefetch import device_prefetch
from distributed_training_pytorch_tpu_torch.data.transforms import eval_transform, train_transform

__all__ = [
    "ArrayDataSource",
    "ImageFolderDataSource",
    "NativeImageFolderSource",
    "ShardedLoader",
    "device_prefetch",
    "eval_transform",
    "native",
    "train_transform",
]
