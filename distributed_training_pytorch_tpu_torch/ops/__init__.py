"""Kernels, their dispatch policy, losses and schedules.

* :mod:`.flash_attention` — flash attention forward and backward: the CUDA kernels'
  wrappers, their plain PyTorch versions, the differentiable ``flash_attention``, and the
  LM's plain causal path.
* :mod:`.dispatch` — the kernel-or-plain policy and its ``kernel_dispatch`` records.
* :mod:`._build` — builds ``csrc/*.cu`` with ``nvcc`` at first use and loads the library.
* :mod:`.losses` — cross-entropy, its weighted mean, and the tied-embedding LM loss.
* :mod:`.schedules` — learning-rate schedules as functions of the step.
"""
