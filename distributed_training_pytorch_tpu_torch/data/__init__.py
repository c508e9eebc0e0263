"""Data sources, record files, the rank-sharded loader, the native host runtime and device
prefetch."""

from distributed_training_pytorch_tpu_torch.data import native
from distributed_training_pytorch_tpu_torch.data.dataset import (
    ArrayDataSource,
    ImageFolderDataSource,
    NativeImageFolderSource,
)
from distributed_training_pytorch_tpu_torch.data.loader import ShardedLoader
from distributed_training_pytorch_tpu_torch.data.prefetch import device_prefetch
from distributed_training_pytorch_tpu_torch.data.records import (
    CorruptRecordError,
    NativeRecordFileSource,
    NativeRecordTrainSource,
    RecordFileSource,
    RecordFileWriter,
    decode_image_bytes,
    pack_image_folder,
    write_shards,
)
from distributed_training_pytorch_tpu_torch.data.transforms import eval_transform, train_transform

__all__ = [
    "ArrayDataSource",
    "CorruptRecordError",
    "ImageFolderDataSource",
    "NativeImageFolderSource",
    "NativeRecordFileSource",
    "NativeRecordTrainSource",
    "RecordFileSource",
    "RecordFileWriter",
    "ShardedLoader",
    "decode_image_bytes",
    "device_prefetch",
    "eval_transform",
    "native",
    "pack_image_folder",
    "train_transform",
    "write_shards",
]
