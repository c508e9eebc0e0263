#!/usr/bin/env python3
"""Where one training step of the PyTorch/CUDA port's ImageNet entry spends its time on the
card, for each ``PALLAS`` setting of a model: ResNet-50 (the default) with the fused 1x1
kernel (``PALLAS=1``) and with cuDNN's 1x1 convolutions (``PALLAS=0``); ViT-B/16 with the
flash kernels (``PALLAS`` unset) and with ``dot_product_attention`` (``PALLAS=0``);
ConvNeXt-L with K4's gelu epilogue (``PALLAS=1``) and with cuBLAS's Dense + GELU
(``PALLAS=0``).

    python3 scripts/torch_resnet_profile.py [--model resnet50|vit_b16|convnext_l] [--batch 256] [--steps 3]

Builds the port's ImageNet entry (``distributed_training_pytorch_tpu_torch/examples/
train_imagenet.py``: the model's recipe, 224x224, bf16 compute, f32 params, uint8 images
normalised on the card; ConvNeXt-L in the recipe's 4 micro-batches a step) once for each
setting from the same weights, and for each, on two batches already on the card, takes 2
warm-up steps through the trainer's ``train_step`` hook, then:

* ``step_ms``: the median of 5 steps, with CUDA events;
* ``--steps`` steps under ``torch.profiler``: device time per step summed over the
  categories of ``profiling/categories.py`` (K1-K4 are ``matmul``, K4's dz pass
  ``fusion(elementwise)``, cuDNN's convolutions ``convolution``, BatchNorm, LayerNorm and
  softmax ``reduce(stats)``, the optimizers' multi-tensor kernels ``fusion(elementwise)``),
  the top kernels, the top kernels of ``fusion(elementwise)`` alone, the operators and
  kernels with the most device time of their own (with their calls a step), and the
  device's busy share of the profiled wall time (the union of its kernel, copy and set
  intervals, ``profiling/report.py``).

The host's data path (random-resized-crop on the CPU) is outside these steps;
``chip_smoke.py`` phase B measures the entry's whole loop. Prints one JSON line a
setting, tagged with the card's name and power limit. Needs a CUDA card; exits non-zero
without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# The PALLAS settings profiled for each model, the kernel path first ("": unset, auto).
KNOBS = {"resnet50": ("1", "0"), "vit_b16": ("", "0"), "convnext_l": ("1", "0")}


def _top_ops(prof, steps: int, n: int = 20) -> list:
    """The entries of the profile (operators such as ``aten::copy_``, and kernels) with the
    most device time of their own per step, with their calls a step: which calls the kernel
    families come from."""
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us:
            rows.append([e.key, us / 1e3 / steps, e.count // steps])
    return sorted(rows, key=lambda r: -r[1])[:n]


def _profile(trainer, batches, steps: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from distributed_training_pytorch_tpu_torch.profiling import busy_us, categorize, profile_events

    state = trainer.state
    for batch in batches[:2]:
        state, _ = trainer.train_step(state, batch)
    times = []
    for i in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, _ = trainer.train_step(state, batches[i % len(batches)])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            state, _ = trainer.train_step(state, batches[i % len(batches)])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = profile_events(prof)
    groups: dict = {}
    by_name: dict = {}
    for name, _, us in kernels:
        groups[categorize(name)] = groups.get(categorize(name), 0.0) + us
        by_name[name] = by_name.get(name, 0.0) + us
    busy = busy_us(kernels)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:25]
    elementwise = sorted(((n, us) for n, us in by_name.items() if categorize(n) == "fusion(elementwise)"),
                         key=lambda kv: -kv[1])
    return {
        "step_ms_p50": statistics.median(times),
        "step_ms_all": times,
        "profiled_steps": steps,
        "profiled_wall_ms_per_step": wall_us / 1e3 / steps,
        "device_ms_per_step": {k: v / 1e3 / steps for k, v in sorted(groups.items())} if kernels else "not measured",
        "device_busy_share": busy / wall_us if kernels else "not measured",
        "kernels_per_step": len(kernels) / steps,
        "top_kernels_ms_per_step": [[name[:90], us / 1e3 / steps] for name, us in top],
        "top_elementwise_ms_per_step": [[name[:200], us / 1e3 / steps] for name, us in elementwise[:12]],
        "top_ops_self_device_ms_per_step": _top_ops(prof, steps),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=sorted(KNOBS), default="resnet50")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_resnet_profile: torch sees no CUDA device", file=sys.stderr)
        return 2
    from distributed_training_pytorch_tpu_torch.examples import train_imagenet

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    build = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build")
    os.makedirs(build, exist_ok=True)
    weights = None
    for knob in KNOBS[args.model]:
        with tempfile.TemporaryDirectory(dir=build) as run_dir:
            os.environ.update(MODEL=args.model, IMAGE_SIZE="224", BATCH=str(args.batch), EPOCHS="1", PALLAS=knob,
                              SHIP_UINT8="1", SAVE_DIR=run_dir)
            for k in ("DTYPE", "STEPS_PER_EPOCH", "SNAPSHOT", "ACCUM", "NUM_CLASSES"):
                os.environ.pop(k, None)
            trainer = train_imagenet.build_trainer(
                "cuda", synthetic_records=2 * args.batch, synthetic_val_records=args.batch
            )
            if weights is None:
                weights = {k: v.clone() for k, v in trainer.model.state_dict().items()}
            trainer.model.load_state_dict(weights)
            batches = [trainer.to_device(b) for b in trainer.train_dataloader]
            torch.cuda.reset_peak_memory_stats()
            result = _profile(trainer, batches, args.steps)
            result.update(
                card=card, model=args.model, pallas=knob or "unset", batch=args.batch,
                images_per_s=args.batch / result["step_ms_p50"] * 1e3,
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
            )
            print(json.dumps(result), flush=True)
            del trainer, batches
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
