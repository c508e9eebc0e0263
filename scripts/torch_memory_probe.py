#!/usr/bin/env python
"""The memory prediction of the PyTorch port, held against counts it does not make itself.

On a small digits model (``Flatten``, ``Linear(64, 64)``, ReLU, ``Linear(64, 10)``, batch
128 of 8x8x1, SGD with momentum) the preflight's prediction (``memory/analysis.py``, a
trace on meta tensors) is checked three ways:

* **the allocator's own count**: one real step after a warm-up step, from the state with
  no gradients. Its transient bytes (the peak less the params, the optimizer's state and
  the batch, which are there before it) are the CPU allocator's ``Total Allocated`` high
  point in a ``torch.profiler`` memory trace (exact bytes; the prediction counts them with
  ``block_bytes=1``), or on the card ``max_memory_allocated`` less ``memory_allocated``
  before the step (the caching allocator's 512-byte blocks). They must be equal to the
  byte;
* **on the card, a chained window** (2 steps, one CUDA graph): the measured peak beside
  the prediction, printed, not gated: at this size cuBLAS's workspaces (32 MiB for each
  stream that runs a GEMM, the capture stream and the graph's pool included), which the
  prediction leaves out, are most of the window's memory;
* **the attribution**: the classes sum to the peak, none is negative, the largest-buffer
  table is filled, and a huge capacity fits.

``--inject-oversize``: a capacity midway between the predicted peaks of the smallest batch
and the full one (headroom 0) must fail the preflight with a recommended batch whose
predicted peak fits.

Usage::

    python scripts/torch_memory_probe.py [--device cpu|cuda] [--inject-oversize]

It imports the port alone. Exit codes: 0 every check passed, 1 a check failed.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402
from torch import nn  # noqa: E402

from distributed_training_pytorch_tpu_torch.memory import (  # noqa: E402
    BUFFER_CLASSES,
    Preflight,
    PreflightOOMError,
    analyze_step_memory,
    run_preflight,
)
from distributed_training_pytorch_tpu_torch.memory.preflight import _batch_shard, _resize_batch  # noqa: E402
from distributed_training_pytorch_tpu_torch.ops.losses import cross_entropy_loss  # noqa: E402
from distributed_training_pytorch_tpu_torch.train import TrainEngine, TrainState  # noqa: E402

BATCH = 128
CHAIN = 2
_STANDING = ("params", "optimizer_state", "input_batch")  # there before the step starts


def build(device):
    torch.manual_seed(0)
    net = nn.Sequential(nn.Flatten(), nn.Linear(64, 64), nn.ReLU(), nn.Linear(64, 10)).to(device)
    opt = torch.optim.SGD(net.parameters(), lr=0.1, momentum=0.9)

    def loss_fn(model, batch, train):
        loss = cross_entropy_loss(model(batch["image"]), batch["label"])
        return loss, {"loss": loss}

    engine = TrainEngine(loss_fn, schedule=lambda step: 0.1)
    state = TrainState(model=net, optimizer=opt)
    gen = torch.Generator().manual_seed(0)
    batch = {"image": torch.randn(BATCH, 8, 8, 1, generator=gen).to(device),
             "label": torch.randint(0, 10, (BATCH,), generator=gen).to(device)}
    return engine, state, batch


def standing_bytes(profile) -> int:
    return int(sum(profile.bytes_by_class[c] for c in _STANDING))


def measured_transient(engine, state, batch, device) -> int:
    """The bytes one real step allocates beyond what stands before it, by the allocator's
    own count, after a warm-up step and with the gradients freed (as the step frees them)."""
    engine.train_step(state, batch)
    state.optimizer.zero_grad(set_to_none=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        engine.train_step(state, batch)
        torch.cuda.synchronize(device)
        return int(torch.cuda.max_memory_allocated(device) - base)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as prof:
        engine.train_step(state, batch)
    tmp = tempfile.mkdtemp(prefix="torch_memory_probe_")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    totals = [e["args"]["Total Allocated"] for e in events if e.get("name") == "[memory]"]
    return int(max(totals, default=0))


def measured_window(engine, state, batch, device) -> int:
    """The peak of the first chained window on the card (warm steps and the capture),
    less what stood before it."""
    stacked = {k: torch.stack([v] * CHAIN) for k, v in batch.items()}
    state.optimizer.zero_grad(set_to_none=True)
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device) - sum(v.numel() * v.element_size() for v in stacked.values())
    torch.cuda.reset_peak_memory_stats(device)
    engine.train_steps_chained(state, stacked, CHAIN)
    torch.cuda.synchronize(device)
    return int(torch.cuda.max_memory_allocated(device) - base)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="cuda (the default where there is a card) or cpu")
    parser.add_argument("--inject-oversize", action="store_true",
                        help="a capacity the batch cannot fit must fail with a recommendation that fits")
    args = parser.parse_args()
    device = torch.device(args.device or ("cuda" if torch.cuda.is_available() else "cpu"))
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    engine, state, batch = build(device)
    errors = []

    if args.inject_oversize:
        shard = _batch_shard(engine)
        floor_peak = analyze_step_memory(engine, state, _resize_batch(batch, shard), top_k=0).peak_bytes
        full_peak = analyze_step_memory(engine, state, batch, top_k=0).peak_bytes
        config = Preflight(capacity_bytes=(floor_peak + full_peak) // 2, headroom=0.0)
        try:
            run_preflight(engine, state, batch, config)
            errors.append(f"the preflight let an oversized batch through (capacity {config.capacity_bytes} < "
                          f"predicted {full_peak})")
        except PreflightOOMError as e:
            report = e.report
            if report.recommended_batch is None:
                errors.append("the oversized batch failed without a batch recommendation")
            else:
                rec = analyze_step_memory(engine, state, _resize_batch(batch, report.recommended_batch),
                                          top_k=0).peak_bytes
                if rec > report.usable_bytes:
                    errors.append(f"recommended batch {report.recommended_batch} does not fit: {rec} > "
                                  f"{report.usable_bytes}")
                else:
                    print(f"torch_memory_probe: the oversized batch {BATCH} failed with recommended batch "
                          f"{report.recommended_batch} (predicted {rec} <= usable {report.usable_bytes}, "
                          f"{report.trials} traces), accum {report.recommended_accum}")
    else:
        for chain in (None, CHAIN):
            label = f"chained x{chain}" if chain else "single step"
            report = run_preflight(engine, state, batch, Preflight(capacity_bytes=1 << 62), chain_length=chain)
            profile = report.profile
            if abs(sum(profile.fractions().values()) - 1.0) > 1e-9:
                errors.append(f"{label}: the class fractions sum to {sum(profile.fractions().values())!r}")
            if set(profile.bytes_by_class) != set(BUFFER_CLASSES) or min(profile.bytes_by_class.values()) < 0:
                errors.append(f"{label}: classes {profile.bytes_by_class}")
            if not profile.top_buffers or report.fits is not True:
                errors.append(f"{label}: top buffers {profile.top_buffers}, fits {report.fits}")
            print(f"torch_memory_probe {label}: predicted peak {report.predicted_peak_bytes} B, by class "
                  f"{ {k: int(v) for k, v in profile.bytes_by_class.items()} }")
        exact = analyze_step_memory(engine, state, batch, block_bytes=1 if device.type == "cpu" else 512)
        predicted = exact.peak_bytes - standing_bytes(exact)
        measured = measured_transient(engine, state, batch, device)
        counter = "the CPU allocator's Total Allocated" if device.type == "cpu" else "max_memory_allocated"
        print(f"torch_memory_probe single step on {device.type}: predicted transient {predicted} B, {counter} "
              f"{measured} B")
        if predicted != measured:
            errors.append(f"single step: predicted transient {predicted} B != measured {measured} B")
        if device.type == "cuda":
            window = analyze_step_memory(engine, state, batch, chain_length=CHAIN)
            predicted_w = window.peak_bytes - window.bytes_by_class["params"] - window.bytes_by_class["optimizer_state"]
            measured_w = measured_window(engine, state, batch, device)
            print(f"torch_memory_probe chained x{CHAIN} on the card: predicted {int(predicted_w)} B beyond the state, "
                  f"measured {measured_w} B (not gated: cuBLAS's workspaces, outside the prediction)")
    if errors:
        print("TORCH MEMORY PROBE FAILED:", file=sys.stderr)
        for err in errors:
            print(f"  - {err}", file=sys.stderr)
        return 1
    print("torch_memory_probe OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
