"""Parallelism over ``torch.distributed``: the mesh (``mesh``: the data, fsdp, pipe,
expert, tensor and seq axes), ring and Ulysses attention over the seq axis
(``ring_attention``), pipeline parallelism over the pipe axis (``pipeline``), the
Mixture-of-Experts layer and its expert exchanges (``moe``), the sharding rules
(``sharding``), the sharded layout that carries them out (``layout``) and the elastic
re-plan (``elastic``)."""

from distributed_training_pytorch_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_ORDER,
    DATA_AXIS,
    FSDP_AXIS,
    PIPE_AXIS,
    SEQ_AXIS,
    TENSOR_AXIS,
    Mesh,
    MeshConfig,
    batch_shard_extent,
    mesh_config_from_spec,
    mesh_from_env,
)
from distributed_training_pytorch_tpu_torch.parallel.pipeline import (  # noqa: F401
    bubble_fraction,
    pipeline_apply,
    schedule_stats,
    stack_stage_params,
)
from distributed_training_pytorch_tpu_torch.parallel.ring_attention import (  # noqa: F401
    ring_attention,
    ulysses_attention,
)
from distributed_training_pytorch_tpu_torch.parallel.sharding import (  # noqa: F401
    default_sharding_rules,
    transformer_tp_rules,
)
