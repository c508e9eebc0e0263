#!/usr/bin/env python3
"""Times of the PyTorch/CUDA port's flash-attention forward (K1) beside PyTorch's
``scaled_dot_product_attention`` on the card.

    python3 scripts/torch_flash_fwd_times.py [--iters 20]

For bf16 ``[B, T, H, D]`` inputs at the training shape (B=64, T=1024, H=12, D=64), a ring
block's (B=16), the served batches (B=8, B=1) and D=128, causal and not: the mean time of
one ``flash_attention_fwd`` launch over ``--iters`` back-to-back launches after 3 of
warm-up, with CUDA events (below about B=8 this is the wrapper's host cost, not the
kernel's), the same for SDPA on the same values in its ``[B, H, T, D]`` layout, and the
kernel variant that ran. Prints one JSON line per shape, each tagged with the card's name
and power limit. Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SHAPES = [(64, 1024, 12, 64), (16, 1024, 12, 64), (8, 1024, 12, 64), (1, 1024, 12, 64), (16, 1024, 12, 128)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_flash_fwd_times: torch sees no CUDA device", file=sys.stderr)
        return 2
    from distributed_training_pytorch_tpu_torch.ops import flash_attention as fa

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]

    def time_ms(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / args.iters

    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, t, h, d in SHAPES:
        q, k, v = (torch.randn(b, t, h, d, device="cuda", generator=gen).to(torch.bfloat16) for _ in range(3))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        row = {"card": card, "shape": [b, t, h, d], "dtype": "bfloat16", "variant": fa.kernel_variant(q.dtype, d)}
        for causal in (True, False):
            tag = "causal" if causal else "full"
            row[f"k1_{tag}_ms"] = time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=causal))
            row[f"sdpa_{tag}_ms"] = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal))
        print(json.dumps(row), flush=True)
        del q, k, v, qt, kt, vt
    return 0


if __name__ == "__main__":
    sys.exit(main())
