"""Carry flax parameter trees over to the port's ``state_dict``.

The input is a tree of ``Model.init(...)`` variables with every leaf already a numpy
array (``jax.tree.map(np.asarray, variables)``), so this module imports no JAX.

* :func:`params_from_jax` — ``TransformerLM``. The layouts it maps are those
  ``models/transformer_lm.py`` lists: flax ``Dense`` kernels are ``[in, out]`` where
  ``nn.Linear`` holds ``[out, in]``; ``qkv/kernel`` is ``[d, 3, H, Dh]`` with bias
  ``[3, H, Dh]``; ``attn_out/kernel`` is ``[H, Dh, d]``; an MoE block's ``moe`` sub-tree
  through :func:`moe_params_from_jax`. :func:`block_params_from_jax` maps one
  ``DecoderBlock``.
* :func:`stage_params_from_jax` — the stacked stage parameters of ``pipeline_apply``:
  a JAX stacked pytree unstacked along dimension 0, each stage converted (by
  :func:`block_params_from_jax` for a ``DecoderBlock`` stage, or as it is), and restacked.
* :func:`resnet_params_from_jax` — ``ResNet`` (optionally under ``InputNormalizer``), from
  ``params`` and ``batch_stats``: conv kernels HWIO -> OIHW, the head's ``[in, out]`` ->
  ``[out, in]``, BN ``scale``/``bias``/``mean``/``var`` -> ``weight``/``bias``/
  ``running_mean``/``running_var``.
* :func:`vgg_params_from_jax` — ``VGG16`` (optionally under ``InputNormalizer``): conv
  kernels HWIO -> OIHW, dense kernels ``[in, out]`` -> ``[out, in]``, and the first
  classifier weight's columns from the flax model's (h, w, c) flatten order to the port's
  (c, h, w).
* :func:`vit_params_from_jax` — ``ViT`` (optionally under ``InputNormalizer``): the patch
  embedding HWIO -> OIHW, ``qkv`` ``[D, 3, H, Dh]`` -> ``[3 D, D]``, ``out`` ``[H, Dh, D]``
  -> ``[D, D]``, Dense ``[in, out]`` -> ``[out, in]``; ``cls_token`` and ``pos_embed`` as
  they are.
* :func:`convnext_params_from_jax` — ``ConvNeXt`` (optionally under ``InputNormalizer``):
  convs HWIO -> OIHW (the depthwise ``[7, 7, 1, C]`` -> ``[C, 1, 7, 7]``), Dense ``[in,
  out]`` -> ``[out, in]``, ``layer_scale`` as it is; flax's ``PallasDenseAct`` is named
  ``Dense_0`` like the plain Dense, so one mapping serves both values of the knob.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = [
    "block_params_from_jax",
    "convnext_params_from_jax",
    "moe_params_from_jax",
    "params_from_jax",
    "resnet_params_from_jax",
    "stage_params_from_jax",
    "vgg_params_from_jax",
    "vit_params_from_jax",
]


def _t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x), dtype=torch.float32)  # a copy: jax-backed arrays are read-only


def _dense(p: Mapping, prefix: str) -> dict:
    kernel = np.asarray(p["kernel"])
    d_out = int(np.prod(kernel.shape[1:])) if kernel.ndim == 4 else kernel.shape[-1]
    w = kernel.reshape(-1, d_out)  # [in, out]; attn_out's [H, Dh, d] flattens its heads
    return {f"{prefix}.weight": _t(w.T), f"{prefix}.bias": _t(np.asarray(p["bias"]).reshape(-1))}


def _ln(p: Mapping, prefix: str) -> dict:
    return {f"{prefix}.weight": _t(p["scale"]), f"{prefix}.bias": _t(p["bias"])}


def params_from_jax(params: Mapping) -> "dict[str, torch.Tensor]":
    """``state_dict`` for the port's ``TransformerLM`` from flax params as numpy."""
    blocks = sorted(
        (k for k in params if k.startswith("DecoderBlock_")), key=lambda k: int(k.split("_")[1])
    )
    out = {
        "embed.weight": _t(params["embed"]["embedding"]),
        "pos_embed": _t(params["pos_embed"]),
        **_ln(params["LayerNorm_0"], "ln_f"),
    }
    for i, name in enumerate(blocks):
        out.update(block_params_from_jax(params[name], f"blocks.{i}"))
    return out


def block_params_from_jax(blk: Mapping, prefix: str = "") -> "dict[str, torch.Tensor]":
    """One ``DecoderBlock``'s params (its ``state_dict`` names under ``prefix``)."""
    dot = f"{prefix}." if prefix else ""
    out = {}
    out.update(_ln(blk["LayerNorm_0"], f"{dot}ln1"))
    out.update(_dense(blk["qkv"], f"{dot}qkv"))
    out.update(_dense(blk["attn_out"], f"{dot}attn_out"))
    out.update(_ln(blk["LayerNorm_1"], f"{dot}ln2"))
    if "moe" in blk:
        out.update(moe_params_from_jax(blk["moe"], f"{dot}moe"))
    else:
        out.update(_dense(blk["mlp_in"], f"{dot}mlp_in"))
        out.update(_dense(blk["mlp_out"], f"{dot}mlp_out"))
    return out


def _unstack(tree, i: int):
    if isinstance(tree, Mapping):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def stage_params_from_jax(stacked: Mapping, convert=None) -> "dict[str, torch.Tensor]":
    """``pipeline_apply``'s stacked ``{name: [S * v, ...]}`` from a JAX stacked pytree (as
    numpy, every leaf leading with ``[S * v, ...]``): unstacked along dimension 0, each
    stage's tree converted by ``convert`` (``block_params_from_jax`` for a ``DecoderBlock``
    stage; None keeps a flat ``{name: leaf}`` stage such as ``{w1, w2}`` as it is), and
    restacked."""
    leaf = stacked
    while isinstance(leaf, Mapping):
        leaf = next(iter(leaf.values()))
    stages = []
    for i in range(len(leaf)):
        tree = _unstack(stacked, i)
        stages.append(convert(tree) if convert is not None else {k: _t(v) for k, v in tree.items()})
    return {name: torch.stack([st[name] for st in stages]) for name in stages[0]}



def moe_params_from_jax(p: Mapping, prefix: str = "") -> "dict[str, torch.Tensor]":
    """``MoEMlp``'s params: the router ``Dense`` (``kernel`` ``[d, E]`` -> ``[E, d]``,
    ``bias`` ``[E]``) and the experts' ``w_in`` ``[E, d, h]`` and ``w_out`` ``[E, h, d]``
    as they are (no expert biases)."""
    dot = f"{prefix}." if prefix else ""
    return {
        **_dense(p["router"], f"{dot}router"),
        f"{dot}w_in": _t(p["w_in"]),
        f"{dot}w_out": _t(p["w_out"]),
    }


def _bn(p: Mapping, stats: Mapping, prefix: str) -> dict:
    return {
        f"{prefix}.weight": _t(p["scale"]),
        f"{prefix}.bias": _t(p["bias"]),
        f"{prefix}.running_mean": _t(stats["mean"]),
        f"{prefix}.running_var": _t(stats["var"]),
        f"{prefix}.num_batches_tracked": torch.tensor(0, dtype=torch.long),
    }


def _conv(p: Mapping) -> torch.Tensor:
    return _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))  # HWIO -> OIHW


def _numbered(tree: Mapping, kind: str) -> list:
    return sorted((k for k in tree if k.startswith(kind + "_")), key=lambda k: int(k.rsplit("_", 1)[1]))


def _block(params: Mapping, stats: Mapping, prefix: str) -> dict:
    """One ``BottleneckBlock``. flax numbers its convolutions in creation order, reduce,
    3x3, expand, projection, and counts ``PallasConv1x1_n`` (the 1x1s the kernel gate
    took) apart from ``Conv_n``. The gate takes a 1x1 by its input's height: the reduce
    and the projection see the block's input, the expand the 3x3's output, so a block's
    kernel 1x1s are none, reduce + projection, or all of them."""
    has_proj = "BatchNorm_3" in params
    slots = ["conv1", "conv2", "conv3"] + (["proj"] if has_proj else [])
    n_kernel = len(_numbered(params, "PallasConv1x1"))
    n_1x1 = len(slots) - 1
    if n_kernel == 0:
        kernel_slots = set()
    elif n_kernel == n_1x1:
        kernel_slots = {"conv1", "conv3", "proj"}
    elif n_kernel == n_1x1 - 1:
        kernel_slots = {"conv1", "proj"}
    else:
        raise ValueError(f"{prefix}: {n_kernel} PallasConv1x1 modules in a block of {n_1x1} 1x1 convolutions")
    names = {"Conv": iter(_numbered(params, "Conv")), "PallasConv1x1": iter(_numbered(params, "PallasConv1x1"))}
    out = {}
    for slot in slots:
        name = next(names["PallasConv1x1" if slot in kernel_slots else "Conv"])
        out[f"{prefix}.{slot}.weight"] = _conv(params[name])
    for i, bn in enumerate(("bn1", "bn2", "bn3", "proj_bn")[: len(slots)]):
        out.update(_bn(params[f"BatchNorm_{i}"], stats[f"BatchNorm_{i}"], f"{prefix}.{bn}"))
    return out


def resnet_params_from_jax(variables: Mapping) -> "dict[str, torch.Tensor]":
    """``state_dict`` for the port's ``ResNet`` from flax ``{"params", "batch_stats"}`` as
    numpy, with the knob on (``PallasConv1x1_n`` names) or off. Under ``InputNormalizer``
    (an ``inner`` scope) the keys get the port wrapper's ``inner.`` prefix."""
    params, stats = variables["params"], variables["batch_stats"]
    prefix = ""
    if "inner" in params:
        params, stats, prefix = params["inner"], stats["inner"], "inner."
    dense = params["Dense_0"]
    out = {
        "stem.weight": _conv(params["Conv_0"]),
        **_bn(params["BatchNorm_0"], stats["BatchNorm_0"], "bn_stem"),
        "head.weight": _t(np.asarray(dense["kernel"]).T),
        "head.bias": _t(dense["bias"]),
    }
    for i, name in enumerate(_numbered(params, "BottleneckBlock")):
        out.update(_block(params[name], stats[name], f"blocks.{i}"))
    return {prefix + k: v for k, v in out.items()}


def vgg_params_from_jax(params: Mapping) -> "dict[str, torch.Tensor]":
    """``state_dict`` for the port's ``VGG16`` from flax ``params`` as numpy. Under
    ``InputNormalizer`` (an ``inner`` scope) the keys get the wrapper's ``inner.`` prefix."""
    prefix = ""
    if "inner" in params:
        params, prefix = params["inner"], "inner."
    out = {}
    channels = 3
    for i, block in enumerate(_numbered(params, "ConvBlock")):
        for j, conv in enumerate(_numbered(params[block], "Conv")):
            p = params[block][conv]
            out[f"blocks.{i}.convs.{j}.weight"] = _conv(p)
            out[f"blocks.{i}.convs.{j}.bias"] = _t(p["bias"])
            channels = np.asarray(p["kernel"]).shape[-1]
    dense = _numbered(params, "Dense")
    names = [f"classifier.{k}" for k in range(len(dense) - 1)] + ["head"]
    for k, (name, target) in enumerate(zip(dense, names, strict=True)):
        kernel = np.asarray(params[name]["kernel"])
        if k == 0:  # rows (h, w, c) of the NHWC flatten -> (c, h, w) of the NCHW one
            hw = kernel.shape[0] // channels
            side = int(round(hw**0.5))
            kernel = kernel.reshape(side, side, channels, -1).transpose(2, 0, 1, 3).reshape(kernel.shape)
        out[f"{target}.weight"] = _t(kernel.T)
        out[f"{target}.bias"] = _t(params[name]["bias"])
    return {prefix + k: v for k, v in out.items()}


def _unwrap(params: Mapping) -> "tuple[Mapping, str]":
    """The model's params and the port's key prefix: ``inner.`` under ``InputNormalizer``.
    A ``{"params": ...}`` variables dict is taken as well as the ``params`` tree."""
    if set(params) == {"params"}:
        params = params["params"]
    if "inner" in params:
        return params["inner"], "inner."
    return params, ""


def _conv_bias(p: Mapping, prefix: str) -> dict:
    return {f"{prefix}.weight": _conv(p), f"{prefix}.bias": _t(p["bias"])}


def vit_params_from_jax(params: Mapping) -> "dict[str, torch.Tensor]":
    """``state_dict`` for the port's ``ViT`` from flax ``params`` as numpy, bare or under
    ``InputNormalizer`` (an ``inner`` scope, the port wrapper's ``inner.`` prefix)."""
    params, prefix = _unwrap(params)
    out = {
        **_conv_bias(params["patch_embed"], "patch_embed"),
        "cls_token": _t(params["cls_token"]),
        "pos_embed": _t(params["pos_embed"]),
        **_ln(params["LayerNorm_0"], "norm"),
        **_dense(params["Dense_0"], "head"),
    }
    for i, name in enumerate(_numbered(params, "EncoderBlock")):
        blk = params[name]
        out.update(_ln(blk["LayerNorm_0"], f"blocks.{i}.ln1"))
        out.update(_dense(blk["MultiHeadAttention_0"]["qkv"], f"blocks.{i}.attn.qkv"))
        out.update(_dense(blk["MultiHeadAttention_0"]["out"], f"blocks.{i}.attn.out"))
        out.update(_ln(blk["LayerNorm_1"], f"blocks.{i}.ln2"))
        out.update(_dense(blk["MlpBlock_0"]["Dense_0"], f"blocks.{i}.mlp.dense_in"))
        out.update(_dense(blk["MlpBlock_0"]["Dense_1"], f"blocks.{i}.mlp.dense_out"))
    return {prefix + k: v for k, v in out.items()}


def convnext_params_from_jax(params: Mapping) -> "dict[str, torch.Tensor]":
    """``state_dict`` for the port's ``ConvNeXt`` from flax ``params`` as numpy, bare or
    under ``InputNormalizer``. flax numbers the model's convs and LayerNorms in creation
    order: ``Conv_0`` and ``LayerNorm_0`` the stem, then per later stage ``LayerNorm_s`` and
    ``Conv_s`` the downsampling, and the last ``LayerNorm`` the head's."""
    params, prefix = _unwrap(params)
    convs, norms = _numbered(params, "Conv"), _numbered(params, "LayerNorm")
    out = {
        **_conv_bias(params[convs[0]], "stem"),
        **_ln(params[norms[0]], "stem_norm"),
        **_ln(params[norms[-1]], "norm"),
        **_dense(params["Dense_0"], "head"),
    }
    for s, (conv, norm) in enumerate(zip(convs[1:], norms[1:-1], strict=True)):
        out.update(_ln(params[norm], f"downsample.{s}.norm"))
        out.update(_conv_bias(params[conv], f"downsample.{s}.conv"))
    for i, name in enumerate(_numbered(params, "ConvNeXtBlock")):
        blk = params[name]
        out.update(_conv_bias(blk["Conv_0"], f"blocks.{i}.dwconv"))
        out.update(_ln(blk["LayerNorm_0"], f"blocks.{i}.norm"))
        out.update(_dense(blk["Dense_0"], f"blocks.{i}.expand"))
        out.update(_dense(blk["Dense_1"], f"blocks.{i}.project"))
        out[f"blocks.{i}.layer_scale"] = _t(blk["layer_scale"])
    return {prefix + k: v for k, v in out.items()}
