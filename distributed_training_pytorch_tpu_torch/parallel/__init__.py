"""Parallelism over ``torch.distributed``: the data and seq mesh (``mesh``) and ring
attention over the seq axis (``ring_attention``)."""

from distributed_training_pytorch_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    SEQ_AXIS,
    Mesh,
    MeshConfig,
    mesh_config_from_spec,
    mesh_from_env,
)
from distributed_training_pytorch_tpu_torch.parallel.ring_attention import ring_attention  # noqa: F401
