"""The fused 1x1-conv GEMM + folded-BatchNorm affine + activation: the hand-written Hopper
kernel, its plain PyTorch version, and its differentiable form.

Counterpart of ``distributed_training_pytorch_tpu/ops/pallas.py``'s ``conv1x1_bn_act``
(kernel ``_conv1x1_kernel``) and ``conv1x1_bn_act_diff`` with its custom VJP
(``_conv1x1_fwd``/``_conv1x1_bwd``). The epilogue is named by ``act`` alone; the JAX
functions' older ``relu`` bool is not carried over. The function is
``act((x @ w^T) * scale + bias)`` with f32 sums, the affine in f32, ``act`` one of None,
``"relu"`` or ``"gelu"`` (tanh approximation) of the f32 pre-activation, and a cast to
``out_dtype`` (default: x's).

One layout differs from the JAX package on purpose: ``w`` is ``[Cout, Cin]``, the torch
layout of a 1x1 conv's weight (``weight.reshape(Cout, Cin)``), so each output channel's
weights are contiguous along the reduction; the JAX function takes ``[Cin, Cout]``.
``x`` is ``[..., Cin]``; its leading dims are the GEMM's rows.

* :func:`conv1x1_bn_act` — the forward. A CPU tensor takes the plain version; a CUDA
  tensor launches the kernel (``csrc/conv1x1_bn_act.cu``), built at the first launch,
  reading x through its strides (a channels-last NHWC view, or its ``[:, ::2, ::2]``
  subsample, needs no copy). A kernel that cannot take the input or does not launch
  raises: there is no fallback.
* :func:`conv1x1_bn_act_plain` — the same function in plain PyTorch: the CPU path, and
  the reference the kernel is held against on the card.
* :func:`conv1x1_bn_act_diff` — differentiable; its backward is ``_conv1x1_bwd`` line for
  line, in plain GEMMs (the JAX package runs it in XLA dots, outside any Pallas kernel).

``launches["conv1x1_bn_act"]`` counts the kernel's launches in this process;
:func:`reset_launches` sets it to 0.
"""

from __future__ import annotations

import threading

import torch

__all__ = [
    "conv1x1_bn_act",
    "conv1x1_bn_act_diff",
    "conv1x1_bn_act_plain",
    "launches",
    "reset_launches",
]

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACT_CODES = {None: 0, "relu": 1, "gelu": 2}
_SQRT_2_OVER_PI = 0.7978845608028654
_GELU_C = 0.044715

launches = {"conv1x1_bn_act": 0}
_launch_lock = threading.Lock()


def reset_launches() -> None:
    """Set the kernel's launch count to 0."""
    with _launch_lock:
        for name in launches:
            launches[name] = 0


def _check(x, w, scale, bias, act):
    if act not in _ACT_CODES:
        raise ValueError(f"act must be None, 'relu', or 'gelu' (got {act!r})")
    cin = x.shape[-1]
    if w.ndim != 2 or w.shape[1] != cin:
        raise ValueError(f"w {tuple(w.shape)} must be [Cout, Cin] with Cin = x's last dim {cin}")
    cout = w.shape[0]
    if tuple(scale.shape) != (cout,) or tuple(bias.shape) != (cout,):
        raise ValueError(f"scale {tuple(scale.shape)} and bias {tuple(bias.shape)} must be [{cout}]")


def _gelu_tanh(u):
    return 0.5 * u * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (u + _GELU_C * u * u * u)))


def conv1x1_bn_act_plain(x, w, scale, bias, *, act: "str | None" = None, out_dtype=None):
    """``act((x @ w^T) * scale + bias)`` in plain PyTorch: x and w rounded to x's dtype,
    then products and sums in f32 (the kernel's f32 accumulation), the affine and the
    epilogue in f32, then a cast to ``out_dtype`` (default x's)."""
    _check(x, w, scale, bias, act)
    cin, cout = x.shape[-1], w.shape[0]
    z = torch.matmul(x.reshape(-1, cin).float(), w.to(x.dtype).float().T)
    y = z * scale.float() + bias.float()
    if act == "relu":
        y = torch.clamp(y, min=0.0)
    elif act == "gelu":
        y = _gelu_tanh(y)
    return y.to(out_dtype or x.dtype).reshape(*x.shape[:-1], cout)


def _as_nhwc(x):
    """x as a 4-D ``[B, H, W, Cin]`` view with a unit channel stride (a copy only when
    x's channels are not contiguous, or x has more than 4 dims and cannot be viewed)."""
    if x.stride(-1) != 1:
        x = x.contiguous()
    if x.ndim > 4:
        x = x.reshape(-1, *x.shape[-3:])
    while x.ndim < 4:
        x = x.unsqueeze(1)  # size-1 dims: their strides never enter an offset
    return x


def _launch_kernel(x, w, scale, bias, act: "str | None", out_dtype):
    from distributed_training_pytorch_tpu_torch.ops import _build

    if x.dtype not in KERNEL_DTYPES or out_dtype not in KERNEL_DTYPES:
        raise TypeError(f"conv1x1 kernel takes float32 or bfloat16 in and out, got {x.dtype} -> {out_dtype}")
    for name, t in (("w", w), ("scale", scale), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"conv1x1 kernel inputs on different devices: x on {x.device}, {name} on {t.device}")
    cin, cout = x.shape[-1], w.shape[0]
    lead = x.shape[:-1]
    x4 = _as_nhwc(x)
    b, h, wd, _ = x4.shape
    n = b * h * wd
    if n >= 2**31 or cin >= 2**31 or cout >= 2**31:
        raise ValueError(f"conv1x1 kernel takes fewer than 2^31 rows and channels, got {n} x {cin} -> {cout}")
    out = torch.empty((n, cout), device=x.device, dtype=out_dtype)
    if n == 0:
        return out.reshape(*lead, cout)
    wk = w.to(x.dtype).contiguous()  # once per call, as resnet.py casts the kernel
    sk = scale.float().contiguous()
    bk = bias.float().contiguous()
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.dtp_conv1x1_bn_act(
            x4.data_ptr(), wk.data_ptr(), sk.data_ptr(), bk.data_ptr(), out.data_ptr(),
            KERNEL_DTYPES[x.dtype], KERNEL_DTYPES[out_dtype], n, h, wd, cin, cout,
            *x4.stride()[:3], _ACT_CODES[act], stream,
        )
    if err != 0:
        raise RuntimeError(f"conv1x1 kernel launch failed: CUDA error {err}")
    with _launch_lock:
        launches["conv1x1_bn_act"] += 1
    return out.reshape(*lead, cout)


def conv1x1_bn_act(x, w, scale, bias, *, act: "str | None" = None, out_dtype=None):
    """``act((x @ w^T) * scale + bias)`` for x ``[..., Cin]``, w ``[Cout, Cin]``,
    scale/bias ``[Cout]`` (the folded BN apply; identity: ones/zeros); output
    ``[..., Cout]`` in ``out_dtype`` (default x's), contiguous. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    _check(x, w, scale, bias, act)
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return conv1x1_bn_act_plain(x, w, scale, bias, act=act, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"conv1x1_bn_act runs on cpu or cuda tensors, got {x.device}")
    return _launch_kernel(x, w, scale, bias, act, out_dtype)


class _Conv1x1BnAct(torch.autograd.Function):
    """``pallas.py::_conv1x1_diff``: the forward is :func:`conv1x1_bn_act` (the kernel on
    the card); the backward is ``_conv1x1_bwd``, saving only the inputs and the output."""

    @staticmethod
    def forward(ctx, x, w, scale, bias, act, out_dtype, affine_grads):
        y = conv1x1_bn_act(x, w, scale, bias, act=act, out_dtype=out_dtype)
        ctx.save_for_backward(x, w, scale, bias, y)
        ctx.act = act
        ctx.affine_grads = affine_grads
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, scale, bias, y = ctx.saved_tensors
        act = ctx.act
        cout, cin = w.shape
        lead = x.shape[:-1]
        g2 = g.reshape(-1, cout).float()
        x2 = x.reshape(-1, cin)
        wx = w.to(x.dtype)
        z = None
        if act == "gelu":
            # gelu' needs the pre-activation u = z * scale + bias: z is recomputed as x @ w
            # (inverting the epilogue from y would divide by scale, which may be 0).
            z = torch.matmul(x2.float(), wx.float().T)
            u = z * scale.float() + bias.float()
            t = torch.tanh(_SQRT_2_OVER_PI * (u + _GELU_C * u * u * u))
            dgelu = 0.5 * (1.0 + t) + 0.5 * u * (1.0 - t * t) * _SQRT_2_OVER_PI * (1.0 + 3.0 * _GELU_C * u * u)
            gz = g2 * dgelu
        elif act == "relu":
            gz = torch.where(y.reshape(-1, cout).float() > 0, g2, 0.0)  # the live mask from y
        else:
            gz = g2
        if ctx.affine_grads:
            dbias = gz.sum(dim=0)
            if z is None:
                z = torch.matmul(x2.float(), wx.float().T)
            dscale = (gz * z).sum(dim=0)
        else:
            # Epilogue declared constant (identity): skip the z recompute.
            dbias = torch.zeros_like(bias)
            dscale = torch.zeros_like(scale)
        dz = (gz * scale.float()).to(x.dtype)  # [N, Cout]
        dx = torch.matmul(dz, wx).reshape(*lead, cin)
        if w.dtype == x.dtype:  # the model's case: f32 sums rounded once to w's dtype
            dw = torch.matmul(dz.T, x2)  # [Cout, Cin]
        else:  # a wider w keeps the f32 sums
            dw = torch.matmul(dz.T.float(), x2.float()).to(w.dtype)
        return dx.to(x.dtype), dw, dscale.to(scale.dtype), dbias.to(bias.dtype), None, None, None


def conv1x1_bn_act_diff(x, w, scale, bias, *, act: "str | None" = None, out_dtype=None, affine_grads: bool = True):
    """Differentiable :func:`conv1x1_bn_act`: the kernel forward on the card, plain-GEMM
    backward. ``affine_grads=False`` declares scale/bias constants (the identity epilogue
    of ``PallasConv1x1``): their gradients are zeros and the backward skips the z
    recompute (gelu recomputes z for its derivative regardless)."""
    _check(x, w, scale, bias, act)
    return _Conv1x1BnAct.apply(x, w, scale, bias, act, out_dtype or x.dtype, affine_grads)
