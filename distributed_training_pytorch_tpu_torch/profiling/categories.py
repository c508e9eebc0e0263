"""The one device-op categorizer.

Counterpart of ``distributed_training_pytorch_tpu/profiling/categories.py``: the same
:data:`CATEGORIES` and :data:`IDLE`, with :func:`categorize` mapping the names of CUDA
kernels and of Kineto's device events. A kernel lands where the JAX trace of the same work
lands:

* the port's hand kernels K1 to K4 (``flash_fwd*``, ``flash_bwd_dq*``, ``flash_bwd_dkv*``,
  ``conv1x1_bn_act*``) are ``matmul``, as a Pallas custom call is; K4's backward dz pass
  (``conv1x1_bwd_dz*``) is ``fusion(elementwise)``;
* cuDNN's convolutions (``fprop``, ``dgrad``, ``wgrad``, implicit-GEMM and Winograd
  kernels) are ``convolution``, matched before the GEMM names they contain;
* cuBLAS, cuBLASLt (``nvjet``), CUTLASS and ``xmma`` GEMMs are ``matmul``;
* NCCL kernels are ``collective``;
* ``Memcpy HtoD`` (and ``DtoH``, the outfeed) are ``infeed``; ``Memcpy DtoD``, memsets and
  transposes are ``copy/transpose``;
* pooling kernels go to ``pool-forward`` or, with ``backward``/``grad`` in the name,
  ``pool-backward``;
* BatchNorm, LayerNorm, softmax and ``reduce_kernel`` are ``reduce(stats)``;
* ``elementwise_kernel``, ``vectorized``/``unrolled`` elementwise templates and
  ``multi_tensor_apply`` (the fused optimizers) are ``fusion(elementwise)``;
* an HLO instruction name (``dot.3``, ``%all-reduce.1``) takes the JAX rules as they are,
  and so does a name none of the rules above matches (then ``other``).
"""

from __future__ import annotations

import re

__all__ = ["CATEGORIES", "IDLE", "categorize"]

CATEGORIES = (
    "matmul",
    "convolution",
    "fusion(elementwise)",
    "copy/transpose",
    "collective",
    "infeed",
    "pool-forward",
    "pool-backward",
    "reduce(stats)",
    "other",
)

# Device wall with no kernel, copy or set running (see report.analyze_trace).
IDLE = "idle"

# An HLO instruction name ("dot.3", "%all-reduce.1"): the JAX rules apply as they are.
_HLO_NAME = re.compile(r"^%?[\w\-]+(\.\d+)+$")
_HAND_MATMUL = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "conv1x1_bn_act", "fmha", "flash_attn")
_CONV = ("fprop", "dgrad", "wgrad", "implicit_convolve", "implicit_gemm", "winograd", "convolve", "conv2d",
         "conv_depthwise", "depthwise")
_GEMM = ("gemm", "gemv", "nvjet", "xmma", "cutlass", "sm90_", "sm80_", "cublas", "ampere_", "hopper_")
_STATS = ("batch_norm", "batchnorm", "bn_fw", "bn_bw", "layer_norm", "layernorm", "gammabeta", "softmax",
          "reduce_kernel", "reduce")
_ELEMENTWISE = ("elementwise", "vectorized", "unrolled", "multi_tensor")


def _hlo(head: str) -> str:
    """The JAX package's rules on an HLO instruction head."""
    if "convolution" in head:
        return "convolution"
    if "select_and_scatter" in head or "select-and-scatter" in head:
        return "pool-backward"
    if "reduce_window" in head or "reduce-window" in head:
        return "pool-forward"
    if any(s in head for s in ("all-reduce", "all-gather", "reduce-scatter", "collective-permute", "all-to-all")):
        return "collective"
    if "infeed" in head or "outfeed" in head:
        return "infeed"
    if "copy" in head or "transpose" in head or "bitcast" in head:
        return "copy/transpose"
    if "reduce" in head:
        return "reduce(stats)"
    if "fusion" in head:
        return "fusion(elementwise)"
    if "dot" in head or "custom-call" in head:
        return "matmul"
    return "other"


def categorize(name: str) -> str:
    """The category of a device event's name (a CUDA kernel, a Kineto memcpy/memset, or
    an HLO op name)."""
    head = name.split(" = ")[0]
    if _HLO_NAME.match(head.strip()):
        return _hlo(head)
    low = head.lower()
    if "conv1x1_bwd_dz" in low:
        return "fusion(elementwise)"
    if any(s in low for s in _HAND_MATMUL):
        return "matmul"
    if "nccl" in low:
        return "collective"
    if low.startswith("memcpy"):
        return "infeed" if ("htod" in low or "dtoh" in low) else "copy/transpose"
    if low.startswith("memset"):
        return "copy/transpose"
    if "pool" in low and "multi_tensor" not in low:
        return "pool-backward" if ("backward" in low or "grad" in low or "_bw" in low) else "pool-forward"
    if any(s in low for s in _CONV):
        return "convolution"
    if any(s in low for s in _GEMM):
        return "matmul"
    if "transpose" in low:
        return "copy/transpose"
    if any(s in low for s in _STATS):
        return "reduce(stats)"
    if any(s in low for s in _ELEMENTWISE):
        return "fusion(elementwise)"
    return _hlo(head)
