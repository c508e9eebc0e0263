"""Carry a flax ``TransformerLM`` parameter tree over to the port's ``state_dict``.

The input is the tree of ``TransformerLM.init(...)["params"]`` with every leaf already a
numpy array (``jax.tree.map(np.asarray, params)``), so this module imports no JAX. The
layouts it maps are those ``models/transformer_lm.py`` lists: flax ``Dense`` kernels are
``[in, out]`` where ``nn.Linear`` holds ``[out, in]``; ``qkv/kernel`` is ``[d, 3, H, Dh]``
with bias ``[3, H, Dh]``; ``attn_out/kernel`` is ``[H, Dh, d]``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["params_from_jax"]


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
        blk = params[name]
        if "moe" in blk:
            raise NotImplementedError("MoE blocks come with the expert-parallel slice of the port")
        prefix = f"blocks.{i}"
        out.update(_ln(blk["LayerNorm_0"], f"{prefix}.ln1"))
        out.update(_dense(blk["qkv"], f"{prefix}.qkv"))
        out.update(_dense(blk["attn_out"], f"{prefix}.attn_out"))
        out.update(_ln(blk["LayerNorm_1"], f"{prefix}.ln2"))
        out.update(_dense(blk["mlp_in"], f"{prefix}.mlp_in"))
        out.update(_dense(blk["mlp_out"], f"{prefix}.mlp_out"))
    return out
