"""Flash attention, forward and backward: the hand-written Hopper kernels and their plain
PyTorch versions, and the ring path's block entry points over them.

Counterpart of ``distributed_training_pytorch_tpu/ops/pallas.py`` (``flash_attention``,
the custom VJP ``_flash``/``_flash_fwd``/``_flash_bwd``, ``flash_block_fwd``/
``flash_block_bwd``, the kernels ``_fwd_kernel``, ``_bwd_dq_kernel``, ``_bwd_dkv_kernel``,
and ``_causal_plain``). Tensors are ``[B, T, H, D]`` at every public function, as in the
JAX package; ``lse`` and ``delta`` are ``[B, H, Tq]`` f32.

* :func:`flash_attention` — ``o`` only, square ``q``/``k``/``v``, with the JAX package's
  guards; differentiable (a ``torch.autograd.Function`` whose backward is the two
  backward kernels).
* :func:`flash_attention_fwd` — the lower forward: ``(o, lse)``, ``Tq`` and ``Tk`` apart
  (what a backward pass and a blockwise merge need). Not differentiable.
* :func:`flash_attention_bwd` — the lower backward: ``(dq, dk, dv)`` from ``q, k, v, o,
  lse, do``, ``Tq`` and ``Tk`` apart, with ``delta = rowsum(dO * O)`` computed here or
  passed in.
* :func:`flash_block_fwd` / :func:`flash_block_bwd` — K5, the block entry points that ring
  attention (``parallel/ring_attention.py``) runs once per (q shard x visiting k/v block):
  the forward's block-normalised ``o`` and block ``lse``, and the block's ``(dq, dk, dv)``
  given the *global* ``lse``/``delta`` of the resident q shard. Not differentiable: the
  ring owns the gradient. They launch K1 and K2 + K3 on CUDA tensors and run the plain
  versions on CPU tensors.
* :func:`flash_attention_plain` / :func:`flash_attention_bwd_plain` — the same functions
  in plain PyTorch; the CPU path, and the references the kernels are held against on the
  card.
* :func:`causal_attention_plain` — counterpart of ``_causal_plain``: the LM's plain path.

A CPU tensor goes to the plain version. A CUDA tensor goes to the kernels, built at the
first launch, in one of two variants that :func:`kernel_variant` picks by one rule for the
forward and the backward alike: ``"wgmma"`` (``csrc/flash_fwd_wgmma.cu``,
``csrc/flash_bwd_wgmma.cu``) or ``"cuda_core"`` (``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu``). If a kernel cannot take the input or does not launch, the call
raises: there is no fallback. ``launches`` counts each kernel's launches in this process
(``fwd``, ``bwd_dq``, ``bwd_dkv``); K5's launches count under those names, since each K5
call launches K1, or K2 and K3, once. ``launches_by_variant`` counts them again by the
path they took, ``("fwd", "wgmma")`` and so on. :func:`reset_launches` sets all to 0.
"""

from __future__ import annotations

import threading

import torch

from distributed_training_pytorch_tpu_torch.ops.dispatch import allocation_route_active, plain_route

__all__ = [
    "NEG_INF",
    "causal_attention_plain",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_plain",
    "flash_attention_fwd",
    "flash_attention_plain",
    "flash_block_bwd",
    "flash_block_fwd",
    "kernel_variant",
    "launch_bwd_dkv",
    "launch_bwd_dq",
    "launches",
    "launches_by_variant",
    "reset_launches",
    "tma_operand",
]

NEG_INF = -1e30  # the masked logit of the JAX kernel (f32-safe, unlike -inf: no NaN rows)

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (8, 16, 32, 64, 128)
WGMMA_HEAD_DIMS = (64, 128)
VARIANTS = ("wgmma", "cuda_core")

launches = {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}
launches_by_variant = {(name, variant): 0 for name in launches for variant in VARIANTS}
_launch_lock = threading.Lock()


def reset_launches() -> None:
    """Set every kernel's launch count, and every count by variant, to 0."""
    with _launch_lock:
        for name in launches:
            launches[name] = 0
        for key in launches_by_variant:
            launches_by_variant[key] = 0


def _count(name: str, variant: str) -> None:
    with _launch_lock:
        launches[name] += 1
        launches_by_variant[(name, variant)] += 1


def kernel_variant(dtype: torch.dtype, head_dim: int) -> str:
    """Which kernels (K1, and K2/K3) run for inputs of this dtype and head dim, by one rule
    for the forward and the backward: ``"wgmma"`` (``csrc/flash_fwd_wgmma.cu``,
    ``csrc/flash_bwd_wgmma.cu``: tensor-core products fed by TMA) for bf16 at D = 64 or
    128, else ``"cuda_core"`` (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``: f32 products on
    the CUDA cores) for f32, whose parity bound the tensor cores' TF32 would miss, and for
    bf16 at D = 8, 16, 32, below the wgmma tiles' 64-column rows."""
    return "wgmma" if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS else "cuda_core"


def tma_operand(x: torch.Tensor) -> torch.Tensor:
    """The bf16 ``x`` itself when TMA can read it in place, else a contiguous copy. TMA
    needs a 16-byte-aligned base and byte strides that are multiples of 16: here, b, t and
    h element strides that are positive multiples of 8 (a size-1 dimension's stride is
    never used). The LM's q, k, v views of its fused ``[B, T, 3, H, D]`` projection qualify."""
    aligned = x.data_ptr() % 16 == 0 and all(
        size == 1 or (stride > 0 and stride % 8 == 0) for size, stride in zip(x.shape[:3], x.stride()[:3])
    )
    return x if aligned else x.contiguous()


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
    ``p`` rounded to the input dtype before the ``P V`` product while ``l`` sums the f32
    ``p`` (``_fwd_kernel``'s ``p.astype(v.dtype)``), the ``l = 0`` guard, ``o`` in the
    input dtype and ``lse`` ``[B, H, Tq]`` f32."""
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
    o = torch.matmul(p.to(q.dtype).float(), v.float().transpose(1, 2)) / l_safe  # [B, H, Tq, D]
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


def _check_kernel_inputs(tensors):
    """What every kernel wrapper checks before a launch: one CUDA device, one dtype the
    kernels take, a head dim they are built for, a grid that fits, and a unit D stride
    (every other stride is read as given)."""
    dev, dtype = tensors[0][1].device, tensors[0][1].dtype
    if any(x.dtype == torch.float16 for _, x in tensors):
        raise NotImplementedError(
            "float16 on the flash-attention kernels (K1 forward, K2 dq, K3 dk/dv): they are built for float32 and "
            "bfloat16 only; an fp16 model runs attention with PALLAS=0 (the plain softmax), or in bf16"
        )
    if any(x.device != dev for _, x in tensors):
        raise ValueError(f"flash kernel inputs on different devices: {[str(x.device) for _, x in tensors]}")
    if dtype not in KERNEL_DTYPES or any(x.dtype != dtype for _, x in tensors):
        raise TypeError(
            f"flash kernel takes float32 or bfloat16 tensors of one dtype, got {[x.dtype for _, x in tensors]}"
        )
    b, _, h, d = tensors[0][1].shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel takes head dims {KERNEL_HEAD_DIMS}, got {d}")
    if b > 65535 or h > 65535:
        raise ValueError(f"flash kernel grid takes B, H <= 65535, got B={b}, H={h}")
    for name, x in tensors:
        if x.stride(3) != 1:
            raise ValueError(f"flash kernel reads {name} with a unit D stride, got strides {x.stride()}")


def _launch_kernel(q, k, v, causal: bool, seq_len: int):
    """K1 on CUDA tensors, the kernel that :func:`kernel_variant` names; the wgmma variant
    reads q, k and v by TMA, so an input that TMA cannot read in place is copied to a
    contiguous tensor first (:func:`tma_operand`)."""
    from distributed_training_pytorch_tpu_torch.ops import _build

    _check_kernel_inputs((("q", q), ("k", k), ("v", v)))
    b, tq, h, d = q.shape
    o = torch.empty((b, tq, h, d), device=q.device, dtype=q.dtype)
    lse = torch.empty((b, h, tq), device=q.device, dtype=torch.float32)
    if tq == 0:
        return o, lse
    variant = kernel_variant(q.dtype, d)
    if variant == "wgmma":
        q, k, v = (tma_operand(x) for x in (q, k, v))
    if q.device.type == "meta":  # the allocation twin: everything up to the launch
        return o, lse
    lib = _build.library()
    fn = lib.dtp_flash_fwd_wgmma if variant == "wgmma" else lib.dtp_flash_fwd
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            KERNEL_DTYPES[q.dtype], b, h, tq, seq_len, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            int(causal), float(d**-0.5), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash kernel ({variant}) launch failed: CUDA error {err}")
    _count("fwd", variant)
    return o, lse


def flash_attention_fwd(q, k, v, *, causal: bool = False, valid_len: "int | None" = None):
    """``(o, lse)`` for ``q`` ``[B, Tq, H, D]`` against ``k``/``v`` ``[B, Tk, H, D]``.

    Keys at or past ``valid_len`` (default ``Tk``) are masked; ``causal`` masks keys after
    the query by absolute index, as the JAX kernel does. CPU tensors (and meta tensors
    outside ``ops.dispatch.allocation_route``) take the plain version; CUDA tensors launch
    the kernel."""
    _check_shapes(q, k, v, valid_len)
    if plain_route(q.device):
        return flash_attention_plain(q, k, v, causal=causal, valid_len=valid_len)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash attention runs on cpu or cuda tensors, got {q.device}")
    seq_len = k.shape[1] if valid_len is None else int(valid_len)
    return _launch_kernel(q, k, v, causal, seq_len)


def _attention_delta(o, do):
    """``delta = rowsum(dO * O)`` in f32, ``[B, H, Tq]``: the JAX package computes it in
    plain XLA outside its kernels (``pallas.py:357``), and so does the port."""
    return (do.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()


def _check_bwd_shapes(q, k, v, o, lse, do, delta, valid_len):
    _check_shapes(q, k, v, valid_len)
    b, tq, h, _ = q.shape
    if o is None and delta is None:
        raise ValueError("the backward needs o, or delta = rowsum(do * o)")
    if (o is not None and o.shape != q.shape) or do.shape != q.shape:
        shapes = f"o {None if o is None else tuple(o.shape)} and do {tuple(do.shape)}"
        raise ValueError(f"{shapes} must match q {tuple(q.shape)}")
    for name, x in (("lse", lse), ("delta", delta)):
        if x is not None and (tuple(x.shape) != (b, h, tq) or x.dtype != torch.float32):
            raise ValueError(f"{name} must be f32 [B, H, Tq] = {(b, h, tq)}, got {x.dtype} {tuple(x.shape)}")


def flash_attention_bwd_plain(
    q, k, v, o, lse, do, *, causal: bool = False, valid_len: "int | None" = None, delta=None
):
    """``(dq, dk, dv)`` in plain PyTorch, as ``_bwd_dq_kernel``/``_bwd_dkv_kernel``
    compute them: ``p = exp(s - lse)`` recomputed from f32 scores under the forward's
    ``-1e30`` masks, ``dp = dO V^T`` and ``ds = p (dp - delta)`` in f32, then ``ds`` and
    ``p`` rounded to the input dtype before the ``dq``/``dk`` and ``dv`` products (f32
    accumulation); ``dq`` and ``dk`` carry the ``D**-0.5`` scale. Grads come back in the
    input dtype."""
    _check_bwd_shapes(q, k, v, o, lse, do, delta, valid_len)
    tq, tk, d = q.shape[1], k.shape[1], q.shape[3]
    t_k = tk if valid_len is None else valid_len
    scale = d**-0.5
    if delta is None:
        delta = _attention_delta(o, do)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    q_idx = torch.arange(tq, device=q.device)[:, None]
    k_idx = torch.arange(tk, device=q.device)[None, :]
    mask = k_idx < t_k
    if causal:
        mask = mask & (q_idx >= k_idx)
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - lse[..., None])  # [B, H, Tq, Tk]
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_launch_args(q, k, v, do, lse, delta, seq_len: int):
    """Checks shared by the two backward kernels; their variant (:func:`kernel_variant`), the
    inputs as that variant reads them (made contiguous where TMA could not read them in
    place, see :func:`tma_operand`), and their common C arguments (the f32 ``lse``/``delta``
    made contiguous, then sizes and strides)."""
    from distributed_training_pytorch_tpu_torch.ops import _build

    _check_kernel_inputs((("q", q), ("k", k), ("v", v), ("do", do)))
    if lse.device != q.device or delta.device != q.device:
        raise ValueError(f"lse/delta on {lse.device}/{delta.device}, q on {q.device}")
    b, tq, h, d = q.shape
    variant = kernel_variant(q.dtype, d)
    if variant == "wgmma":
        q, k, v, do = (tma_operand(x) for x in (q, k, v, do))
    sizes_strides = (
        KERNEL_DTYPES[q.dtype], b, h, tq, k.shape[1], seq_len, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
    )
    inputs = (q, k, v, do, lse.contiguous(), delta.contiguous())
    if q.device.type == "meta":  # the allocation twin: no library, no stream
        return None, None, variant, inputs, sizes_strides
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return _build.library(), stream, variant, inputs, sizes_strides


def launch_bwd_dq(q, k, v, do, lse, delta, *, causal: bool, seq_len: int):
    """K2 on CUDA tensors: ``dq`` from q, k, v, dO and the f32 ``lse``/``delta``
    ``[B, H, Tq]``; keys at or past ``seq_len`` are masked. The kernel is the one
    :func:`kernel_variant` names; the wgmma variant reads q, k, v and dO by TMA, so an input
    that TMA cannot read in place is copied to a contiguous tensor first
    (:func:`tma_operand`)."""
    # ``inputs`` holds any contiguous copies alive until the launch is queued.
    lib, stream, variant, inputs, sizes_strides = _bwd_launch_args(q, k, v, do, lse, delta, seq_len)
    dq = torch.empty(q.shape, device=q.device, dtype=q.dtype)
    if q.shape[1] == 0 or lib is None:
        return dq
    fn = lib.dtp_flash_bwd_dq_wgmma if variant == "wgmma" else lib.dtp_flash_bwd_dq
    with torch.cuda.device(q.device):
        err = fn(
            *(x.data_ptr() for x in inputs), dq.data_ptr(), *sizes_strides, *dq.stride()[:3],
            int(causal), float(q.shape[3] ** -0.5), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash dq kernel ({variant}) launch failed: CUDA error {err}")
    _count("bwd_dq", variant)
    return dq


def launch_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool, seq_len: int):
    """K3 on CUDA tensors: ``(dk, dv)``, the same inputs and the same choice of kernel as
    :func:`launch_bwd_dq`."""
    lib, stream, variant, inputs, sizes_strides = _bwd_launch_args(q, k, v, do, lse, delta, seq_len)
    dk = torch.empty(k.shape, device=q.device, dtype=q.dtype)
    dv = torch.empty(k.shape, device=q.device, dtype=q.dtype)
    if k.shape[1] == 0 or lib is None:
        return dk, dv
    fn = lib.dtp_flash_bwd_dkv_wgmma if variant == "wgmma" else lib.dtp_flash_bwd_dkv
    with torch.cuda.device(q.device):
        err = fn(
            *(x.data_ptr() for x in inputs), dk.data_ptr(), dv.data_ptr(), *sizes_strides,
            *dk.stride()[:3], *dv.stride()[:3], int(causal), float(q.shape[3] ** -0.5), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash dk/dv kernel ({variant}) launch failed: CUDA error {err}")
    _count("bwd_dkv", variant)
    return dk, dv


def flash_attention_bwd(
    q, k, v, o, lse, do, *, causal: bool = False, valid_len: "int | None" = None, delta=None
):
    """``(dq, dk, dv)`` for the forward ``(o, lse) = flash_attention_fwd(q, k, v, ...)``
    and the output gradient ``do``; ``Tq`` and ``Tk`` may differ. ``lse`` (and ``delta``,
    when given) are ``[B, H, Tq]`` f32 and may come from outside, as the ring path's global
    statistics do; ``delta`` defaults to ``rowsum(do * o)``, and ``o`` may be None when
    ``delta`` is given. CPU tensors (and meta tensors outside the allocation route) take the
    plain version; CUDA tensors launch the dq kernel and the dk/dv kernel."""
    _check_bwd_shapes(q, k, v, o, lse, do, delta, valid_len)
    if plain_route(q.device):
        return flash_attention_bwd_plain(
            q, k, v, o, lse, do, causal=causal, valid_len=valid_len, delta=delta
        )
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash attention runs on cpu or cuda tensors, got {q.device}")
    if delta is None:
        delta = _attention_delta(o, do)
    if do.stride(3) != 1:
        do = do.contiguous()
    seq_len = k.shape[1] if valid_len is None else int(valid_len)
    dq = launch_bwd_dq(q, k, v, do, lse, delta, causal=causal, seq_len=seq_len)
    dk, dv = launch_bwd_dkv(q, k, v, do, lse, delta, causal=causal, seq_len=seq_len)
    return dq, dk, dv


# K5: the block entry points of ring attention (``pallas.py:399-436``). The JAX versions
# pad q and k/v to block multiples (``_ring_pad``) because its kernels are correct only on
# padded blocks; the port's kernels mask by index instead (keys at or past ``seq_len``, q
# rows past ``Tq``), so nothing is padded here and no output is sliced back: keep it so.


def flash_block_fwd(q, k, v, *, causal: bool = False):
    """One (q shard x k/v block) forward -> ``(o, lse)``: ``o`` normalised within the
    block (``[B, Tq, H, D]``, the input dtype), ``lse`` the log-sum-exp of the block's
    logits per q row (``[B, H, Tq]`` f32), what the ring's cross-block merge takes.
    ``causal`` masks keys after the query by index within the block (the ring's diagonal
    block). K1 on CUDA tensors, its plain version on CPU tensors."""
    return flash_attention_fwd(q, k, v, causal=causal)


def flash_block_bwd(q, k, v, do, lse, delta, *, causal: bool = False):
    """One block's ``(dq, dk, dv)`` given the global ``lse`` and ``delta`` (``[B, H, Tq]``
    f32) of the resident q shard: the flash decomposition of the whole row's gradient,
    restricted to this block's keys. K2 and K3 on CUDA tensors, their plain version on
    CPU tensors."""
    return flash_attention_bwd(q, k, v, None, lse, do, causal=causal, delta=delta)


class _FlashAttention(torch.autograd.Function):
    """``o = attention(q, k, v)`` whose backward is the flash backward: the counterpart of
    ``pallas.py::_flash`` with its custom VJP (``_flash_fwd`` saves ``q, k, v, o, lse``;
    ``_flash_bwd`` computes ``delta`` and runs the dq and dk/dv kernels)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, valid_len):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, valid_len=valid_len)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        ctx.valid_len = valid_len
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, o, lse, do, causal=ctx.causal, valid_len=ctx.valid_len
        )
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = False, valid_len: "int | None" = None):
    """Fused attention on ``[B, T, H, D]`` tensors (scale ``D**-0.5``); ``valid_len`` masks
    key positions at or past it, for caller-padded sequences (non-causal only).
    Differentiable: the backward runs the flash backward kernels on CUDA tensors and
    their plain version on CPU tensors. Meta tensors (the FLOP count of
    ``utils/flops.py``) take the plain version through autograd, whose backward does not
    recompute the scores as the flash backward does; under ``ops.dispatch.allocation_route``
    they take the kernels' allocation twins instead (the memory trace)."""
    if q.ndim != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"expected matching [B,T,H,D] q/k/v, got {q.shape}/{k.shape}/{v.shape}")
    if valid_len is not None:
        if causal:
            raise ValueError("valid_len composes with non-causal attention only")
        if not 0 < valid_len <= q.shape[1]:
            raise ValueError(f"valid_len {valid_len} out of range for T={q.shape[1]}")
    if q.device.type == "meta" and not allocation_route_active():
        return flash_attention_plain(q, k, v, causal=causal, valid_len=valid_len)[0]
    return _FlashAttention.apply(q, k, v, causal, valid_len)
