"""PyTorch/CUDA port of ``distributed_training_pytorch_tpu``, for NVIDIA Hopper.

The JAX package stays the reference; this package keeps its module names so each
counterpart is easy to find, and imports nothing of it (nor JAX). Entry points run on the
card unless the caller passes ``device="cpu"``. Ported so far: causal-LM serving —
``models.transformer_lm`` with flash-attention forward as a hand-written CUDA kernel
(``ops.flash_attention``, ``csrc/flash_fwd.cu``), behind ``serving.InferEngine`` and
``serving.InferenceServer``.

Importing the package initialises no CUDA context and builds nothing: the kernels build
at their first launch (``ops/_build.py``).
"""
