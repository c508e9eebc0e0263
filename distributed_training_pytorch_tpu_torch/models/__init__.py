from distributed_training_pytorch_tpu_torch.models.convert import (  # noqa: F401
    convnext_params_from_jax,
    params_from_jax,
    resnet_params_from_jax,
    vgg_params_from_jax,
    vit_params_from_jax,
)
from distributed_training_pytorch_tpu_torch.models.convnext import (  # noqa: F401
    ConvNeXt,
    ConvNeXtL,
    ConvNeXtTiny,
)
from distributed_training_pytorch_tpu_torch.models.resnet import (  # noqa: F401
    BottleneckBlock,
    ResNet,
    ResNet18Slim,
    ResNet50,
)
from distributed_training_pytorch_tpu_torch.models.transformer_lm import (  # noqa: F401
    DecoderBlock,
    GPTSmall,
    LMTiny,
    TransformerLM,
)
from distributed_training_pytorch_tpu_torch.models.vgg import VGG16, ConvBlock  # noqa: F401
from distributed_training_pytorch_tpu_torch.models.vit import ViT, ViTB16, ViTTiny  # noqa: F401
from distributed_training_pytorch_tpu_torch.models.wrappers import InputNormalizer  # noqa: F401

# The zoo's names of each model, as the JAX package's ``create_model`` reads them.
_FACTORIES = {
    ("vgg16", "vgg"): VGG16,
    ("resnet50", "resnet"): ResNet50,
    ("vit", "vit-b/16", "vit_b16", "vitb16"): ViTB16,
    ("convnext-l", "convnext_l", "convnextl", "convnext"): ConvNeXtL,
    ("convnext-tiny", "convnext_tiny"): ConvNeXtTiny,
    ("resnet18_slim", "resnet18-slim"): ResNet18Slim,
    ("vit_tiny", "vit-tiny"): ViTTiny,
}
VIT_NAMES = ("vit", "vit-b/16", "vit_b16", "vitb16", "vit_tiny", "vit-tiny")  # models that take image_size


def create_model(name: str, num_classes: int, **kwargs):
    """Model-zoo factory (the JAX package's ``models.create_model``), by the same names.
    Every model takes the ``pallas=`` knob; VGG16 has no fused-kernel coverage, so there it
    is consumed and its plain resolution recorded (``ops.dispatch.vgg16_policy``). The ViTs
    (:data:`VIT_NAMES`) also take ``image_size``, which sizes their position embedding."""
    name = name.lower()
    for names, factory in _FACTORIES.items():
        if name in names:
            if factory is VGG16:
                from distributed_training_pytorch_tpu_torch.ops import dispatch

                dispatch.vgg16_policy(kwargs.pop("pallas", None))
            return factory(num_classes=num_classes, **kwargs)
    raise ValueError(f"unknown model {name!r}")
