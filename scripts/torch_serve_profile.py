#!/usr/bin/env python3
"""Where one served GPT-2-small forward of the PyTorch/CUDA port spends its time.

    python3 scripts/torch_serve_profile.py [--batches 1 4 8] [--seed 0]

Builds ``GPTSmall`` (bf16 compute, seeded random weights) behind ``InferEngine`` on the
card, as ``chip_smoke.py`` serves it, and for each batch size of 1024-token rows:

* ``predict_ms``: the engine's ``predict`` (host rows in, f32 next-token logits out),
  median of 10 after warm-up, on the host clock (it ends in a device-to-host copy);
* one ``predict`` under ``torch.profiler``: device time summed over the categories of
  ``profiling/categories.py`` (K1 is ``matmul`` with the GEMMs), the top kernels, and the
  device's busy share of that predict's wall time (the union of its kernel, copy and set
  intervals, ``profiling/report.py``);
* ``json_ms``: the host time to encode one answer's logits as the server does (median
  of 5).

Prints one JSON line per batch size, each tagged with the card's name and power limit.
Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

VOCAB, SEQ = 50257, 1024


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 4, 8])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from distributed_training_pytorch_tpu_torch.profiling import busy_us, categorize, profile_events

    if not torch.cuda.is_available():
        print("torch_serve_profile: torch sees no CUDA device", file=sys.stderr)
        return 2
    from distributed_training_pytorch_tpu_torch.models import GPTSmall
    from distributed_training_pytorch_tpu_torch.serving import InferEngine

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    model = GPTSmall(dtype=torch.bfloat16, device="cuda", generator=gen).eval()

    def next_token_logits(params, tokens):
        hidden = torch.func.functional_call(model, params, (tokens,), {"return_hidden": True})
        return hidden[:, -1].float() @ params["embed.weight"].float().T

    engine = InferEngine(next_token_logits, device="cuda", buckets=tuple(sorted(args.batches)))
    engine.swap_params(model.state_dict(), version=f"seed{args.seed}")
    engine.warmup(np.zeros((SEQ,), np.int32))
    rng = np.random.default_rng(args.seed)
    for b in args.batches:
        rows = rng.integers(0, VOCAB, size=(b, SEQ)).astype(np.int32)
        engine.predict(rows)
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            out, _ = engine.predict(rows)
            times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.predict(rows)
            wall_us = (time.perf_counter() - t0) * 1e6
        kernels = profile_events(prof)
        groups: dict = {}
        by_name: dict = {}
        for name, _, us in kernels:
            groups[categorize(name)] = groups.get(categorize(name), 0.0) + us
            by_name[name] = by_name.get(name, 0.0) + us
        busy = busy_us(kernels)
        encode = []
        for _ in range(5):
            t0 = time.perf_counter()
            json.dumps({"outputs": [np.asarray(out[0]).tolist()], "params_version": "v"})
            encode.append((time.perf_counter() - t0) * 1e3)
        json_ms = statistics.median(encode)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        print(json.dumps({
            "card": card,
            "batch": b,
            "seq": SEQ,
            "predict_ms_p50": statistics.median(times),
            "profiled_wall_ms": wall_us / 1e3,
            "device_ms": {k: v / 1e3 for k, v in sorted(groups.items())} if kernels else "not measured",
            "device_busy_share": busy / wall_us if kernels else "not measured",
            "kernels": len(kernels),
            "top_kernels_ms": [[name[:80], us / 1e3] for name, us in top],
            "json_ms": json_ms,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
