from distributed_training_pytorch_tpu_torch.models.convert import (  # noqa: F401
    params_from_jax,
    resnet_params_from_jax,
    vgg_params_from_jax,
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
from distributed_training_pytorch_tpu_torch.models.wrappers import InputNormalizer  # noqa: F401

# Names of the JAX package's model zoo that later slices of the port bring.
_LATER = {
    ("vit", "vit-b/16", "vit_b16", "vitb16", "vit_tiny", "vit-tiny"): "ViT comes with the ViT slice of the port",
    ("convnext-l", "convnext_l", "convnextl", "convnext", "convnext-tiny", "convnext_tiny"):
        "ConvNeXt comes with the ConvNeXt slice of the port",
}


def create_model(name: str, num_classes: int, **kwargs):
    """Model-zoo factory (the JAX package's ``models.create_model``): ``vgg16``,
    ``resnet50`` and ``resnet18_slim`` so far; the zoo's other names raise
    ``NotImplementedError`` naming the slice that brings them. Every model takes the
    ``pallas=`` knob; VGG16 has no fused-kernel coverage, so there it is consumed and its
    plain resolution recorded (``ops.dispatch.vgg16_policy``)."""
    name = name.lower()
    if name in ("vgg16", "vgg"):
        from distributed_training_pytorch_tpu_torch.ops import dispatch

        dispatch.vgg16_policy(kwargs.pop("pallas", None))
        return VGG16(num_classes=num_classes, **kwargs)
    if name in ("resnet50", "resnet"):
        return ResNet50(num_classes=num_classes, **kwargs)
    if name in ("resnet18_slim", "resnet18-slim"):
        return ResNet18Slim(num_classes=num_classes, **kwargs)
    for names, why in _LATER.items():
        if name in names:
            raise NotImplementedError(f"model {name!r}: {why}")
    raise ValueError(f"unknown model {name!r}")
