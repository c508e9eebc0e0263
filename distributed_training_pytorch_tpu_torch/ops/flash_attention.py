"""Flash-attention forward: the hand-written Hopper kernel and its plain PyTorch version.

Counterpart of ``distributed_training_pytorch_tpu/ops/pallas.py`` (``flash_attention``,
``flash_block_fwd``, ``_fwd_kernel`` and ``_causal_plain``). Tensors are ``[B, T, H, D]``
at every public function, as in the JAX package.

* :func:`flash_attention` — ``o`` only, square ``q``/``k``/``v``, with the JAX package's
  guards.
* :func:`flash_attention_fwd` — the lower function: ``(o, lse)`` with ``lse`` ``[B, H, Tq]``
  f32 (what a backward pass and a blockwise merge need), and ``Tq`` and ``Tk`` apart.
* :func:`flash_attention_plain` — the same function in plain PyTorch; the CPU path, and the
  reference the kernel is held against on the card.
* :func:`causal_attention_plain` — counterpart of ``_causal_plain``: the LM's plain path.

A CPU tensor goes to the plain version. A CUDA tensor goes to the kernel
(``csrc/flash_fwd.cu``), which is built at the first launch; if the kernel cannot take the
input or does not launch, the call raises: there is no fallback. ``launches`` counts the
kernel's launches in this process.
"""

from __future__ import annotations

import threading

import torch

__all__ = [
    "NEG_INF",
    "causal_attention_plain",
    "flash_attention",
    "flash_attention_fwd",
    "flash_attention_plain",
    "launches",
]

NEG_INF = -1e30  # the masked logit of the JAX kernel (f32-safe, unlike -inf: no NaN rows)

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (8, 16, 32, 64, 128)

launches = 0
_launch_lock = threading.Lock()


def _check_shapes(q, k, v, valid_len):
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"expected [B,T,H,D] q and matching k/v, got {q.shape}/{k.shape}/{v.shape}")
    b, _, h, d = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} differ in B, H or D")
    if valid_len is not None and not 0 < valid_len <= k.shape[1]:
        raise ValueError(f"valid_len {valid_len} out of range for T={k.shape[1]}")


def flash_attention_plain(q, k, v, *, causal: bool = False, valid_len: "int | None" = None):
    """``(o, lse)`` in plain PyTorch: scores in f32, the kernel's ``-1e30`` mask (keys at
    or past ``valid_len``/``Tk``; when ``causal``, keys after the query by absolute index),
    the ``l = 0`` guard, ``o`` in the input dtype and ``lse`` ``[B, H, Tq]`` f32."""
    _check_shapes(q, k, v, valid_len)
    tq, tk, d = q.shape[1], k.shape[1], q.shape[3]
    t_k = tk if valid_len is None else valid_len
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d**-0.5
    q_idx = torch.arange(tq, device=q.device)[:, None]
    k_idx = torch.arange(tk, device=q.device)[None, :]
    mask = k_idx < t_k
    if causal:
        mask = mask & (q_idx >= k_idx)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = torch.matmul(p, v.float().transpose(1, 2)) / l_safe  # [B, H, Tq, D]
    lse = (m + torch.log(l_safe)).squeeze(-1)
    return o.transpose(1, 2).to(q.dtype), lse


def causal_attention_plain(q, k, v):
    """Counterpart of ``pallas.py::_causal_plain``: logits in the input dtype, softmax in
    f32, weights cast back to the input dtype."""
    t = q.shape[1]
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    idx = torch.arange(t, device=q.device)
    logits = torch.where(idx[:, None] >= idx[None, :], logits, NEG_INF)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def _launch_kernel(q, k, v, causal: bool, seq_len: int):
    global launches
    from distributed_training_pytorch_tpu_torch.ops import _build

    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}/{k.device}/{v.device}")
    if q.dtype not in KERNEL_DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash kernel takes float32 or bfloat16 q/k/v, got {q.dtype}/{k.dtype}/{v.dtype}")
    b, tq, h, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel takes head dims {KERNEL_HEAD_DIMS}, got {d}")
    if b > 65535 or h > 65535:
        raise ValueError(f"flash kernel grid takes B, H <= 65535, got B={b}, H={h}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(f"flash kernel reads {name} with a unit D stride, got strides {x.stride()}")
    o = torch.empty((b, tq, h, d), device=q.device, dtype=q.dtype)
    lse = torch.empty((b, h, tq), device=q.device, dtype=torch.float32)
    if tq == 0:
        return o, lse
    lib = _build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.dtp_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            KERNEL_DTYPES[q.dtype], b, h, tq, seq_len, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            int(causal), float(d**-0.5), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash kernel launch failed: CUDA error {err}")
    with _launch_lock:
        launches += 1
    return o, lse


def flash_attention_fwd(q, k, v, *, causal: bool = False, valid_len: "int | None" = None):
    """``(o, lse)`` for ``q`` ``[B, Tq, H, D]`` against ``k``/``v`` ``[B, Tk, H, D]``.

    Keys at or past ``valid_len`` (default ``Tk``) are masked; ``causal`` masks keys after
    the query by absolute index, as the JAX kernel does. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    _check_shapes(q, k, v, valid_len)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, valid_len=valid_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda tensors, got {q.device}")
    seq_len = k.shape[1] if valid_len is None else int(valid_len)
    return _launch_kernel(q, k, v, causal, seq_len)


def flash_attention(q, k, v, *, causal: bool = False, valid_len: "int | None" = None):
    """Fused attention on ``[B, T, H, D]`` tensors (scale ``D**-0.5``); ``valid_len`` masks
    key positions at or past it, for caller-padded sequences (non-causal only)."""
    if q.ndim != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"expected matching [B,T,H,D] q/k/v, got {q.shape}/{k.shape}/{v.shape}")
    if valid_len is not None:
        if causal:
            raise ValueError("valid_len composes with non-causal attention only")
        if not 0 < valid_len <= q.shape[1]:
            raise ValueError(f"valid_len {valid_len} out of range for T={q.shape[1]}")
    return flash_attention_fwd(q, k, v, causal=causal, valid_len=valid_len)[0]
