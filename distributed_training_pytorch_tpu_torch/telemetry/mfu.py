"""MFU from a step's FLOP count and its measured time.

Counterpart of ``distributed_training_pytorch_tpu/telemetry/mfu.py``: model-FLOPs
utilization is ``flops_per_step / step_time / peak``. The peak table is the card's,
keyed by a substring of ``torch.cuda.get_device_name()``; the FLOP count comes from
``utils/flops.py::step_flops`` (the counterpart of the JAX engine's
``step_cost_analysis`` probe), or from the caller.

The peaks are dense bf16 tensor-core FLOP/s from NVIDIA's H100 Tensor Core GPU data
sheet: 989.4e12 for the SXM5 part (``"NVIDIA H100 80GB HBM3"``), 756e12 for the PCIe
part (``"NVIDIA H100 PCIe"``). ``"cpu"`` is a nominal 1e12 so that CPU runs report a
finite, plainly synthetic figure. A card that is not in the table gets no MFU: the
report leaves the field out rather than guess.
"""

from __future__ import annotations

__all__ = ["PEAK_FLOPS", "device_peak_flops", "mfu_value", "window_report"]

# Dense bf16 FLOP/s by device-name substring, most specific first.
PEAK_FLOPS = {
    "H100 PCIe": 756e12,
    "H100 80GB HBM3": 989.4e12,
    "H100 SXM": 989.4e12,
    "cpu": 1e12,  # nominal, for CPU runs
}


def device_peak_flops(device=None) -> "float | None":
    """Peak bf16 FLOP/s of ``device`` (a ``torch.device`` or its name); the nominal 1e12
    for the CPU, None for a card not in :data:`PEAK_FLOPS`."""
    import torch

    if isinstance(device, str) and not device.startswith(("cuda", "cpu")):
        name = device
    else:
        dev = torch.device(device if device is not None else "cpu")
        if dev.type != "cuda":
            return PEAK_FLOPS["cpu"]
        name = torch.cuda.get_device_name(dev)
    for key, val in PEAK_FLOPS.items():
        if key != "cpu" and key in name:
            return val
    return None


def mfu_value(flops_per_step: "float | None", step_time_s: "float | None", peak_flops: "float | None") -> "float | None":
    """``flops / dt / peak``, or None when any of the three is unknown or zero."""
    if not flops_per_step or not step_time_s or not peak_flops:
        return None
    return float(flops_per_step) / float(step_time_s) / float(peak_flops)


def window_report(steps: int, window_time_s: float, *, flops_per_step: "float | None",
                  peak_flops: "float | None") -> dict:
    """``steps``, ``step_ms`` and, when the FLOPs and the peak are known, ``mfu`` for a
    timed interval of whole steps (whole windows under chaining)."""
    steps = max(int(steps), 1)
    step_s = window_time_s / steps
    out = {"steps": steps, "step_ms": step_s * 1e3}
    mfu = mfu_value(flops_per_step, step_s, peak_flops)
    if mfu is not None:
        out["mfu"] = mfu
    return out
