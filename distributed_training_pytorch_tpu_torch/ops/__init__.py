"""Kernels, their dispatch policy, losses, metrics and schedules.

* :mod:`.flash_attention` — flash attention forward and backward: the CUDA kernels'
  wrappers, their plain PyTorch versions, the differentiable ``flash_attention``, and the
  LM's plain causal path.
* :mod:`.conv1x1` — the fused 1x1-conv GEMM + BN affine + activation: the CUDA kernel's
  wrapper, its plain version, and the differentiable ``conv1x1_bn_act_diff``.
* :mod:`.dispatch` — the kernel-or-plain policy and its ``kernel_dispatch`` records.
* :mod:`._build` — builds ``csrc/*.cu`` with ``nvcc`` at first use and loads the library.
* :mod:`.losses` — cross-entropy, its weighted mean, and the tied-embedding LM loss.
* :mod:`.metrics` — accuracy, top-k accuracy and the correct count.
* :mod:`.schedules` — learning-rate schedules as functions of the step.
"""
