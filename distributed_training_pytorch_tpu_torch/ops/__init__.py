"""Kernels and their dispatch policy.

* :mod:`.flash_attention` — flash-attention forward: the CUDA kernel's wrapper, its plain
  PyTorch version, and the LM's plain causal path.
* :mod:`.dispatch` — the kernel-or-plain policy and its ``kernel_dispatch`` records.
* :mod:`._build` — builds ``csrc/*.cu`` with ``nvcc`` at first use and loads the library.
"""
