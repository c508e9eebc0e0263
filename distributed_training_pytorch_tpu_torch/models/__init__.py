from distributed_training_pytorch_tpu_torch.models.convert import params_from_jax  # noqa: F401
from distributed_training_pytorch_tpu_torch.models.transformer_lm import (  # noqa: F401
    DecoderBlock,
    GPTSmall,
    LMTiny,
    TransformerLM,
)
