"""The FLOPs of one train step, counted from its shapes.

Counterpart of ``distributed_training_pytorch_tpu/utils/hlo_flops.py``'s role in
telemetry: the JAX engine's ``step_cost_analysis`` and ``executed_matmul_flops`` count
the matmul and convolution FLOPs of one compiled train step. The port counts the same
work with ``torch.utils.flop_counter.FlopCounterMode`` over one forward and backward of
the engine's loss.

The count runs on the ``meta`` device: the model's parameters and buffers are swapped
for meta tensors of the same shapes (``torch.func.functional_call``), and the batch is
made of meta tensors too. Nothing is computed and nothing on the card is touched, and the
count depends on shapes alone, so the CPU and the card give the same number for the same
shapes. On meta tensors the hand kernels' wrappers (K1 to K4, ``ctypes`` launches the
counter could not see) take their plain versions, so the counter sees the products those
kernels compute.

Conventions, as in the JAX count:

* a matmul of ``[m, k] x [k, n]`` is ``2 m n k`` FLOPs, a convolution ``2 x`` its
  output's elements ``x`` its reduction; elementwise work (activations, norms, the
  optimizer update) is not counted;
* causal attention is counted in full, as the plain version computes it (``Q K^T`` and
  ``P V`` over every key, and the four products of its backward), although K1 to K3 skip
  the masked blocks;
* recomputation is not counted (model FLOPs): on meta tensors the attention takes the
  plain version through autograd, not the flash backward that recomputes ``Q K^T``, and
  the fused tied cross-entropy does not checkpoint its vocabulary chunks, whose backward
  recomputes the logits. XLA keeps neither recomputation in the JAX step;
* a gradient that autograd does not need (the first layer's input) is not computed and not
  counted, as XLA removes it from the JAX step;
* with ``accum_steps`` micro-batches the count is for the whole batch at once: the same
  products.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch

__all__ = ["step_flops"]


class _LossCall(torch.nn.Module):
    def __init__(self, model: torch.nn.Module, loss_fn: Callable):
        super().__init__()
        self.model = model
        self._loss_fn = loss_fn

    def forward(self, batch):
        loss, _ = self._loss_fn(self.model, batch, True)
        return loss


def _meta(t: torch.Tensor, requires_grad: bool = False) -> torch.Tensor:
    out = torch.empty_like(t, device="meta")
    return out.requires_grad_(requires_grad)


def step_flops(model: torch.nn.Module, loss_fn: Callable, batch: Mapping[str, torch.Tensor]) -> float:
    """The matmul and convolution FLOPs of one train step of ``loss_fn(model, batch,
    True)``: forward and backward on the meta device (see the module docstring).
    ``batch`` holds tensors of one step's shapes (their values are not read)."""
    from torch.utils.flop_counter import FlopCounterMode

    from distributed_training_pytorch_tpu_torch.train.state import unwrap

    net = unwrap(model)
    call = _LossCall(net, loss_fn)
    state = {f"model.{k}": _meta(p, p.requires_grad) for k, p in net.named_parameters()}
    state.update({f"model.{k}": _meta(b) for k, b in net.named_buffers()})
    meta_batch = {k: _meta(v) for k, v in batch.items()}
    was_training = net.training
    net.train()
    try:
        with FlopCounterMode(display=False) as counter:
            loss = torch.func.functional_call(call, state, (meta_batch,), strict=False)
            loss.backward()
    finally:
        net.train(was_training)
    return float(counter.get_total_flops())
