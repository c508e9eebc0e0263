"""Device memory: live allocator fields (``live``). The memory preflight and the
sharding-layout analysis of the JAX package come with later slices."""

from distributed_training_pytorch_tpu_torch.memory.live import window_memory_fields

__all__ = ["window_memory_fields"]
