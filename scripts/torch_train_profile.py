#!/usr/bin/env python3
"""Where one training step of the PyTorch/CUDA port's byte-level GPT-2-small spends its
time on the card.

    python3 scripts/torch_train_profile.py [--batch 64] [--seq 1024] [--steps 3] [--seq-shards 1]

Builds the port's LM entry (``distributed_training_pytorch_tpu_torch/examples/
train_lm.py``: GPT-2-small, vocab 256, bf16 compute, f32 params, fused tied CE, AdamW)
on the card, as ``chip_smoke.py`` trains it; with ``--seq-shards S`` above 1, its ring
configuration: ``MESH=spS`` with all S shards on the card and the entry's
``RingLMTrainer`` (ring attention, K5 on the flash kernels; for example
``--batch 16 --seq 4096 --seq-shards 4``). It takes 2 warm-up steps through the trainer's
``train_step`` hook, then:

* ``step_ms``: the median of 5 steps, with CUDA events;
* ``--steps`` steps under ``torch.profiler``: device time per step summed over the
  categories of ``profiling/categories.py`` (the port's K1-K3 are ``matmul`` with the
  GEMMs; each kernel's own time is in the top kernels), the top kernels, and the device's
  busy share of the profiled wall time (the union of its kernel, copy and set intervals,
  ``profiling/report.py``).

Prints one JSON line tagged with the card's name and power limit. Needs a CUDA card; exits
non-zero without one.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seq-shards", type=int, default=1)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from distributed_training_pytorch_tpu_torch.profiling import busy_us, categorize, profile_events

    if not torch.cuda.is_available():
        print("torch_train_profile: torch sees no CUDA device", file=sys.stderr)
        return 2
    from distributed_training_pytorch_tpu_torch.examples import train_lm

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    build = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as run_dir:
        os.environ.update(LM_SIZE="small", SEQ_LEN=str(args.seq), BATCH=str(args.batch), DTYPE="bf16",
                          EPOCHS="1", SAVE_DIR=run_dir)
        os.environ.pop("LM_CORPUS", None)
        trainer_cls = train_lm.LMTrainer
        if args.seq_shards > 1:
            os.environ["MESH"] = f"sp{args.seq_shards}"
            trainer_cls = train_lm.RingLMTrainer
        trainer = train_lm.build_trainer("cuda", trainer_cls=trainer_cls)
        loaded = [trainer.to_device(b) for b in trainer.train_dataloader]
        batches = [loaded[i % len(loaded)] for i in range(2 + 5 + args.steps)]
        state = trainer.state
        for batch in batches[:2]:
            state, _ = trainer.train_step(state, batch)
        times = []
        for batch in batches[2:7]:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            state, _ = trainer.train_step(state, batch)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for batch in batches[7:]:
                state, _ = trainer.train_step(state, batch)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    kernels = profile_events(prof)
    groups: dict = {}
    by_name: dict = {}
    for name, _, us in kernels:
        groups[categorize(name)] = groups.get(categorize(name), 0.0) + us
        by_name[name] = by_name.get(name, 0.0) + us
    busy = busy_us(kernels)
    n = len(batches[7:])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    print(json.dumps({
        "card": card,
        "batch": args.batch,
        "seq": args.seq,
        "seq_shards": args.seq_shards,
        "step_ms_p50": statistics.median(times),
        "step_ms_all": times,
        "tokens_per_s": args.batch * args.seq / statistics.median(times) * 1e3,
        "profiled_steps": n,
        "profiled_wall_ms_per_step": wall_us / 1e3 / n,
        "device_ms_per_step": {k: v / 1e3 / n for k, v in sorted(groups.items())} if kernels else "not measured",
        "device_busy_share": busy / wall_us if kernels else "not measured",
        "kernels_per_step": len(kernels) / n,
        "top_kernels_ms_per_step": [[name[:90], us / 1e3 / n] for name, us in top],
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
