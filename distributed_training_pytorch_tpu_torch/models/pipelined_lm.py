"""A decoder-only LM whose trunk runs through ``parallel.pipeline_apply``.

The JAX package pipelines a model by hand in its tests (``tests/test_pipeline.py``: an
embedding as ``first``, ``DecoderBlock`` stages, a head as ``last``); this is that
composition for the port's :class:`TransformerLM`. :class:`PipelinedLM` holds an LM's
weights laid out for the pipeline: the token and position embedding (``first``), the
blocks' parameters stacked ``[S * n_virtual, ...]`` (each virtual stage ``depth / (S *
n_virtual)`` consecutive blocks, run by ``torch.func.functional_call`` of one template
stage on the meta device), and the final LayerNorm with the tied f32 head (``last``). Its
forward splits the batch into ``n_micro`` micro-batches and returns the same f32 logits
as the LM's forward; its attention is the LM's (``"auto"``: the flash kernels K1–K3 on
CUDA tensors). :func:`lm_logits_loss` is the engine's loss over those logits (the LM's
own too), and :meth:`PipelinedLM.lm_state_dict` maps a state (or its gradients) back to
the LM's names.
"""

from __future__ import annotations

import copy

import torch
import torch.nn.functional as F
from torch import nn

from distributed_training_pytorch_tpu_torch.models.transformer_lm import LN_EPS, TransformerLM
from distributed_training_pytorch_tpu_torch.parallel.mesh import PIPE_AXIS
from distributed_training_pytorch_tpu_torch.parallel.pipeline import pipeline_apply

__all__ = ["PipelinedLM", "lm_logits_loss"]


class PipelinedLM(nn.Module):
    """``lm``'s weights (copied) laid out over ``mesh``'s pipe axis: ``n_micro``
    micro-batches a forward, ``n_virtual`` chunks a shard, ``remat`` each stage under
    ``torch.utils.checkpoint``. A dense LM only (an MoE block's auxiliary losses do not
    ride the pipeline)."""

    def __init__(self, lm: TransformerLM, mesh, *, n_micro: int, n_virtual: int = 1, remat: bool = False):
        super().__init__()
        if lm.moe_every:
            raise NotImplementedError("PipelinedLM takes a dense LM: MoE blocks' auxiliary losses do not ride "
                                      "pipeline_apply")
        depth = len(lm.blocks)
        stages = int(mesh.shape.get(PIPE_AXIS, 1)) * n_virtual
        if depth % stages:
            raise ValueError(f"{depth} blocks do not split into {stages} virtual stages")
        self.mesh, self.n_micro, self.n_virtual, self.remat = mesh, int(n_micro), int(n_virtual), bool(remat)
        self.dtype, self.vocab_size, self.hidden_dim = lm.dtype, lm.vocab_size, lm.hidden_dim
        self.per_stage = depth // stages
        self.embed = copy.deepcopy(lm.embed)
        self.pos_embed = nn.Parameter(lm.pos_embed.detach().clone())
        self.ln_f = copy.deepcopy(lm.ln_f)
        template = nn.Sequential(*lm.blocks[: self.per_stage])
        self.stage_names = [name for name, _ in template.named_parameters()]
        blocks = [nn.Sequential(*lm.blocks[k * self.per_stage:(k + 1) * self.per_stage]) for k in range(stages)]
        per_block = [dict(b.named_parameters()) for b in blocks]
        self.stages = nn.ParameterList(
            nn.Parameter(torch.stack([p[name].detach() for p in per_block])) for name in self.stage_names
        )
        # Out of the module tree: its parameters are the stacked ones, swapped in per call.
        self._template = (copy.deepcopy(template).to("meta"),)

    def _stage(self, params, x):
        return torch.func.functional_call(self._template[0], params, (x,))

    def _first(self, p, ids):
        t = ids.shape[-1]
        x = F.embedding(ids.long(), p["embed"]).to(self.dtype)
        return x + p["pos"][:, :t].to(self.dtype)

    def _last(self, p, x):
        h = F.layer_norm(x.float(), (self.hidden_dim,), p["ln_w"], p["ln_b"], LN_EPS).to(self.dtype)
        return h.float() @ p["embed"].float().T  # the tied f32 logits

    def forward(self, tokens):
        """``tokens`` ``[B, T]`` -> f32 logits ``[B, T, V]``, ``B`` split into ``n_micro``
        micro-batches."""
        b, t = tokens.shape
        if b % self.n_micro:
            raise ValueError(f"batch {b} does not split into {self.n_micro} micro-batches")
        table = self.embed.weight
        out = pipeline_apply(
            dict(zip(self.stage_names, self.stages, strict=True)),
            tokens.reshape(self.n_micro, b // self.n_micro, t),
            self._stage,
            self.mesh,
            n_virtual=self.n_virtual,
            first=({"embed": table, "pos": self.pos_embed}, self._first),
            last=({"ln_w": self.ln_f.weight, "ln_b": self.ln_f.bias, "embed": table}, self._last),
            remat=self.remat,
        )
        return out.reshape(b, t, self.vocab_size)

    def lm_state_dict(self, tensors: "dict[str, torch.Tensor]") -> "dict[str, torch.Tensor]":
        """``tensors`` under this module's parameter names (its ``state_dict``, or their
        gradients) under the ``TransformerLM``'s names, the stacked stages unstacked into
        ``blocks.<i>``."""
        out = {"embed.weight": tensors["embed.weight"], "pos_embed": tensors["pos_embed"],
               "ln_f.weight": tensors["ln_f.weight"], "ln_f.bias": tensors["ln_f.bias"]}
        for j, name in enumerate(self.stage_names):
            within, rest = name.split(".", 1)
            for k, value in enumerate(tensors[f"stages.{j}"]):
                out[f"blocks.{k * self.per_stage + int(within)}.{rest}"] = value
        return out


def lm_logits_loss(net, batch, train: bool):
    """Engine ``LossFn``: the mean next-token cross-entropy of ``net``'s f32 logits
    (``image`` = input tokens, ``label`` = next tokens), for a :class:`PipelinedLM` or a
    ``TransformerLM``; metrics ``loss``, ``nll``, ``ppl``."""
    logits = net(batch["image"])
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), batch["label"].reshape(-1).long())
    return loss, {"loss": loss, "nll": loss, "ppl": torch.exp(loss)}
