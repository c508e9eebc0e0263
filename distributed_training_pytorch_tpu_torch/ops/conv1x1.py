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
  tensor launches the kernel that :func:`conv1x1_variant` names, built at the first
  launch: ``"wgmma"`` (``csrc/conv1x1_wgmma.cu``: tensor-core products fed by TMA, a
  persistent grid, the epilogue on the accumulators) for bf16 in and out with Cin a
  multiple of 64 up to 512 and Cout a multiple of 64, else ``"cuda_cores"``
  (``csrc/conv1x1_bn_act.cu``). Both read x through its strides: a channels-last NHWC
  view, and its ``[:, ::2, ::2]`` subsample, need no copy (:func:`tma_rows`). A kernel
  that cannot take the input or does not launch raises: there is no fallback.
* :func:`conv1x1_bn_act_plain` — the same function in plain PyTorch: the CPU path, and
  the reference the kernels are held against on the card.
* :func:`conv1x1_bn_act_diff` — differentiable; its backward is ``_conv1x1_bwd``, with
  the GEMMs in ``torch.matmul`` (the JAX package runs them in XLA dots, outside any Pallas
  kernel). On ResNet's route (``act`` None or relu, ``affine_grads=False``) the
  elementwise part is one pass, :func:`conv1x1_bwd_dz` (``csrc/conv1x1_bwd_dz.cu`` on the
  card); gelu and ``affine_grads=True`` need the f32 ``gz`` and keep the plain ops.

``launches["conv1x1_bn_act"]`` and ``launches["conv1x1_bwd_dz"]`` count the kernels'
launches in this process, ``launches_by_variant[("conv1x1_bn_act", "wgmma")]`` and
``[("conv1x1_bn_act", "cuda_cores")]`` the forward's again by the kernel that ran;
:func:`reset_launches` sets all to 0.
"""

from __future__ import annotations

import threading

import torch

__all__ = [
    "conv1x1_bn_act",
    "conv1x1_bn_act_diff",
    "conv1x1_bn_act_plain",
    "conv1x1_bwd_dz",
    "conv1x1_bwd_dz_plain",
    "conv1x1_variant",
    "launches",
    "launches_by_variant",
    "reset_launches",
    "tma_rows",
]

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACT_CODES = {None: 0, "relu": 1, "gelu": 2}
_SQRT_2_OVER_PI = 0.7978845608028654
_GELU_C = 0.044715
VARIANTS = ("wgmma", "cuda_cores")
WGMMA_MAX_CIN = 512  # the weight column tile, the x ring and the staging fit in 227 KB up to here

launches = {"conv1x1_bn_act": 0, "conv1x1_bwd_dz": 0}
launches_by_variant = {("conv1x1_bn_act", variant): 0 for variant in VARIANTS}
_launch_lock = threading.Lock()


def reset_launches() -> None:
    """Set every kernel's launch count, and every count by variant, to 0."""
    with _launch_lock:
        for name in launches:
            launches[name] = 0
        for key in launches_by_variant:
            launches_by_variant[key] = 0


def _count(name: str, variant: "str | None" = None) -> None:
    with _launch_lock:
        launches[name] += 1
        if variant is not None:
            launches_by_variant[(name, variant)] += 1


def conv1x1_variant(x: torch.Tensor, cout: int, out_dtype=None) -> str:
    """Which forward kernel runs for x ``[..., Cin]`` -> ``cout`` channels in ``out_dtype``
    (default x's): ``"wgmma"`` (``csrc/conv1x1_wgmma.cu``) for bf16 in and out with Cin a
    multiple of 64 up to 512 and Cout a multiple of 64, whatever x's strides (a view TMA
    cannot read is copied, see :func:`tma_rows`); else ``"cuda_cores"``
    (``csrc/conv1x1_bn_act.cu``): f32, whose 1e-5 bound the tensor cores' TF32 would miss,
    bf16 -> f32, and channel counts off the 64-channel regions."""
    cin = x.shape[-1]
    bf16 = x.dtype == torch.bfloat16 and (out_dtype or x.dtype) == torch.bfloat16
    channels = cin % 64 == 0 and 64 <= cin <= WGMMA_MAX_CIN and cout % 64 == 0 and cout >= 64
    return "wgmma" if bf16 and channels else "cuda_cores"


def tma_rows(x4: torch.Tensor) -> "tuple[int, int, int, int, int, int] | None":
    """How the wgmma kernel's TMA map walks the rows of the NHWC ``x4`` (unit channel
    stride): ``(rows_w, rows_bh, stride_w, stride_bh, box_w, box_bh)``, output row
    ``bh * rows_w + w`` being x at ``(w, bh)``, read in boxes of ``box_w x box_bh`` rows; or
    None when TMA cannot read x4 in place (the wrapper then copies it).

    Rows one stride apart (a contiguous or channels-last activation) are ``(N, 1, s, s, 64,
    1)``. Where only b and h flatten, as in the stride-2 view ``x[:, ::2, ::2]`` of a
    channels-last activation, and W <= 64, the rows are ``(W, B * H, s_w, s_bh, W, 64 // W)``:
    boxes of whole image rows (28 x 2 = 56 at ResNet-50's 28 x 28). TMA needs a 16-byte
    aligned base and strides that are positive multiples of 8 elements."""
    b, h, w, _ = x4.shape
    sb, sh, sw, _ = x4.stride()
    if x4.data_ptr() % 16:
        return None
    dims = [(size, stride) for size, stride in ((b, sb), (h, sh), (w, sw)) if size > 1]
    if not dims:
        return (1, 1, 64, 64, 64, 1)
    if all(outer[1] == inner[0] * inner[1] for outer, inner in zip(dims, dims[1:])):
        s = dims[-1][1]  # every row one stride apart
        geometry = (b * h * w, 1, s, s, 64, 1)
    elif w > 1 and w <= 64 and (b == 1 or h == 1 or sb == h * sh):
        s_bh = sh if h > 1 else sb
        geometry = (w, b * h, sw, s_bh, w, 64 // w)
    else:
        return None
    if geometry[2] <= 0 or geometry[2] % 8 or geometry[3] <= 0 or geometry[3] % 8:
        return None
    return geometry


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


def _refuse_half(name: str, *dtypes) -> None:
    """K4 has no float16 variant: an fp16 path that would launch it raises, naming it,
    rather than running the plain version unseen."""
    if torch.float16 in dtypes:
        raise NotImplementedError(
            f"float16 on K4 ({name}, the fused 1x1 conv): it is built for float32 and bfloat16 only; an fp16 "
            "ResNet or ConvNeXt runs with PALLAS=0 (cuDNN / cuBLAS), or in bf16"
        )


def _launch_kernel(x, w, scale, bias, act: "str | None", out_dtype):
    """K4 on CUDA tensors, the kernel that :func:`conv1x1_variant` names; the wgmma variant
    reads x by TMA, so a view that TMA cannot read in place is copied first (:func:`tma_rows`)."""
    from distributed_training_pytorch_tpu_torch.ops import _build

    _refuse_half("conv1x1_bn_act", x.dtype, out_dtype)
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
    variant = conv1x1_variant(x, cout, out_dtype)
    wk = w.to(x.dtype).contiguous()  # once per call, as resnet.py casts the kernel
    sk = scale.float().contiguous()
    bk = bias.float().contiguous()
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if variant == "wgmma":
            geometry = tma_rows(x4)
            if geometry is None:
                x4 = x4.contiguous()
                geometry = tma_rows(x4)
            err = lib.dtp_conv1x1_bn_act_wgmma(
                x4.data_ptr(), wk.data_ptr(), sk.data_ptr(), bk.data_ptr(), out.data_ptr(),
                cin, cout, *geometry, _ACT_CODES[act], stream,
            )
        else:
            err = lib.dtp_conv1x1_bn_act(
                x4.data_ptr(), wk.data_ptr(), sk.data_ptr(), bk.data_ptr(), out.data_ptr(),
                KERNEL_DTYPES[x.dtype], KERNEL_DTYPES[out_dtype], n, h, wd, cin, cout,
                *x4.stride()[:3], _ACT_CODES[act], stream,
            )
    if err != 0:
        raise RuntimeError(f"conv1x1 kernel ({variant}) launch failed: CUDA error {err}")
    _count("conv1x1_bn_act", variant)
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


def conv1x1_bwd_dz_plain(g, y, scale, *, act: "str | None" = None, out_dtype=None):
    """The elementwise part of ``_conv1x1_bwd`` for ``act`` None or relu in plain PyTorch,
    as three passes over ``[N, Cout]``: g to f32, the live mask ``y > 0`` (relu), times
    ``scale`` in f32, rounded once to ``out_dtype`` (default g's): the CPU path, and the
    reference the kernel is held against, bit for bit, on the card."""
    g2 = g.float()
    gz = torch.where(y.float() > 0, g2, 0.0) if act == "relu" else g2
    return (gz * scale.float()).to(out_dtype or g.dtype)


def _launch_bwd_dz(g, y, scale, act: "str | None", out_dtype):
    from distributed_training_pytorch_tpu_torch.ops import _build

    _refuse_half("conv1x1_bwd_dz", g.dtype, out_dtype)
    if g.dtype not in KERNEL_DTYPES or out_dtype not in KERNEL_DTYPES or (act == "relu" and y.dtype != g.dtype):
        raise TypeError(f"conv1x1_bwd_dz kernel takes float32 or bfloat16 g (y of g's dtype), got {g.dtype} -> {out_dtype}")
    if not g.is_contiguous() or (act == "relu" and not y.is_contiguous()):
        raise ValueError("conv1x1_bwd_dz kernel takes contiguous g and y")
    rows, cout = g.shape
    dz = torch.empty((rows, cout), device=g.device, dtype=out_dtype)
    if rows == 0:
        return dz
    sk = scale.to(device=g.device, dtype=torch.float32).contiguous()
    lib = _build.library()
    with torch.cuda.device(g.device):
        err = lib.dtp_conv1x1_bwd_dz(
            g.data_ptr(), y.data_ptr() if act == "relu" else None, sk.data_ptr(), dz.data_ptr(),
            KERNEL_DTYPES[g.dtype], KERNEL_DTYPES[out_dtype], rows, cout, _ACT_CODES[act],
            torch.cuda.current_stream(g.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"conv1x1_bwd_dz kernel launch failed: CUDA error {err}")
    _count("conv1x1_bwd_dz")
    return dz


def conv1x1_bwd_dz(g, y, scale, *, act: "str | None" = None, out_dtype=None):
    """``dz = mask * f32(g) * scale`` rounded once to ``out_dtype`` (default g's), for g and
    y (the forward's output, read for relu only) ``[N, Cout]`` and scale ``[Cout]``: the
    backward's elementwise part on ResNet's route. CPU tensors take
    :func:`conv1x1_bwd_dz_plain`; CUDA tensors launch ``csrc/conv1x1_bwd_dz.cu``, one pass
    that reads g (and y) once and writes dz once. gelu is not taken here: its derivative
    needs the recomputed pre-activation, and it keeps the plain ops in the backward."""
    if act not in (None, "relu"):
        raise ValueError(f"conv1x1_bwd_dz takes act None or 'relu' (got {act!r})")
    out_dtype = out_dtype or g.dtype
    if g.ndim != 2 or tuple(scale.shape) != (g.shape[1],) or (act == "relu" and y.shape != g.shape):
        raise ValueError(f"g {tuple(g.shape)} must be [N, Cout], y the same, scale [Cout] (got {tuple(scale.shape)})")
    if g.device.type == "cpu":
        return conv1x1_bwd_dz_plain(g, y, scale, act=act, out_dtype=out_dtype)
    if g.device.type != "cuda":
        raise ValueError(f"conv1x1_bwd_dz runs on cpu or cuda tensors, got {g.device}")
    return _launch_bwd_dz(g, y, scale, act, out_dtype)


def _dz_affine_grads_plain(x2, wx, scale, bias, y2, g2, act, affine_grads):
    """``_conv1x1_bwd``'s elementwise part and epilogue gradients in plain ops, for gelu
    (whose derivative needs the pre-activation u = z * scale + bias, z recomputed as x @ w:
    inverting the epilogue from y would divide by scale, which may be 0) and for
    ``affine_grads=True`` (dscale needs z and the f32 gz): ``(dz, dscale, dbias)``."""
    g2 = g2.float()
    z = None
    if act == "gelu":
        z = torch.matmul(x2.float(), wx.float().T)
        u = z * scale.float() + bias.float()
        t = torch.tanh(_SQRT_2_OVER_PI * (u + _GELU_C * u * u * u))
        dgelu = 0.5 * (1.0 + t) + 0.5 * u * (1.0 - t * t) * _SQRT_2_OVER_PI * (1.0 + 3.0 * _GELU_C * u * u)
        gz = g2 * dgelu
    elif act == "relu":
        gz = torch.where(y2.float() > 0, g2, 0.0)  # the live mask from y
    else:
        gz = g2
    if affine_grads:
        dbias = gz.sum(dim=0)
        if z is None:
            z = torch.matmul(x2.float(), wx.float().T)
        dscale = (gz * z).sum(dim=0)
    else:
        dbias = torch.zeros_like(bias)
        dscale = torch.zeros_like(scale)
    return (gz * scale.float()).to(x2.dtype), dscale, dbias


def _f32_sums(a, b):
    """``a @ b`` as f32 sums, as the reference's ``jnp.dot(..., preferred_element_type=f32)``.
    On the card a bf16 product goes through ``torch.mm(..., out_dtype=torch.float32)``: a
    bf16 ``torch.matmul`` may reduce cuBLAS's split-K partials in bf16 (PyTorch's default
    ``allow_bf16_reduced_precision_reduction``), which the weight gradient's reduction over
    every pixel triggers (F5)."""
    if a.device.type == "cuda" and a.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


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
        g2 = g.reshape(-1, cout)
        y2 = y.reshape(-1, cout)
        x2 = x.reshape(-1, cin)
        wx = w.to(x.dtype)
        if act == "gelu" or ctx.affine_grads:
            dz, dscale, dbias = _dz_affine_grads_plain(x2, wx, scale, bias, y2, g2, act, ctx.affine_grads)
        else:
            # ResNet's route: the epilogue is declared constant (zero gradients, no z
            # recompute), and dz is one pass over g (the kernel on the card).
            dz = conv1x1_bwd_dz(g2.contiguous(), y2, scale, act=act, out_dtype=x.dtype)  # [N, Cout]
            dscale = torch.zeros_like(scale)
            dbias = torch.zeros_like(bias)
        dx = torch.matmul(dz, wx).reshape(*lead, cin)
        dw = _f32_sums(dz.T, x2).to(w.dtype)  # [Cout, Cin], rounded once
        return dx.to(x.dtype), dw, dscale.to(scale.dtype), dbias.to(bias.dtype), None, None, None


def conv1x1_bn_act_diff(x, w, scale, bias, *, act: "str | None" = None, out_dtype=None, affine_grads: bool = True):
    """Differentiable :func:`conv1x1_bn_act`: the kernel forward on the card, plain-GEMM
    backward. ``affine_grads=False`` declares scale/bias constants (the identity epilogue
    of ``PallasConv1x1``): their gradients are zeros and the backward skips the z
    recompute (gelu recomputes z for its derivative regardless)."""
    _check(x, w, scale, bias, act)
    return _Conv1x1BnAct.apply(x, w, scale, bias, act, out_dtype or x.dtype, affine_grads)
