#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``distributed_training_pytorch_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which fails the run (exit code 1, no final line) when it fails:

1. device: a CUDA card, its name and power limit (``nvidia-smi``), ``torch.version.cuda``,
   and a build of every kernel from the sources in this checkout, with ``-Xptxas -v``'s
   register and shared-memory report;
2. kernel vs plain: flash-attention forward (``csrc/flash_fwd.cu``) against its plain
   PyTorch version on the card, over causal/non-causal, ``valid_len``, ragged T,
   Tq != Tk, D 8/64/128, f32 and bf16, and the served shapes;
3. the slice: GPT-2-small at full width (bf16, seeded random weights) behind
   ``InferEngine`` + ``InferenceServer``, 16 ``/predict`` requests of 1024 tokens from 4
   concurrent clients; every answer 200, finite, and close to the plain-attention model's;
   the kernel's launch count over that run is 12 per forward;
4. times at the served shapes, with CUDA events: the kernel, its plain version,
   ``scaled_dot_product_attention`` as a yardstick (the port never calls it), the
   kernel's bound, and the served requests' p50/p99.

It prints a ``{"kernels": [...]}`` line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``. It exits non-zero without a card, and outside a
checkout of the repository.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.request

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): tensor-core bf16, f32 on the CUDA cores,
# device memory.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12

SERVED_SHAPES = [(1, 1024, 12, 64), (8, 1024, 12, 64)]  # B, T, H, D of GPT-2-small
VOCAB, SEQ, DEPTH = 50257, 1024, 12
N_CLIENTS, REQUESTS_PER_CLIENT = 4, 4


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, *, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(b, tq, tk, h, d, causal, dtype_name, itemsize):
    """Least time for the forward on this card: the larger of its FLOPs over the peak of
    its type and its bytes (q, k, v and o once, lse once) over the memory rate. FLOPs
    count the (query, key) pairs these inputs need: 2*D for QK^T and 2*D for PV."""
    if causal:
        pairs = sum(min(i + 1, tk) for i in range(tq))
    else:
        pairs = tq * tk
    flops = 4.0 * b * h * pairs * d
    nbytes = (2 * b * tq * h * d + 2 * b * tk * h * d) * itemsize + 4 * b * h * tq
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), flops, nbytes


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch sees no CUDA device")
    from distributed_training_pytorch_tpu_torch.ops import _build

    card = card_line()
    log(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    lib = _build.library(rebuild=True)
    log(f"[device] built {_build.LIBRARY} from {[s.name for s in _build.SOURCES]} "
        f"in {time.perf_counter() - t0:.1f} s")
    # -Xptxas -v: each entry function, then its registers, spills and static shared memory.
    kernel = ""
    for line in _build.build_log.splitlines():
        entry = re.search(r"Compiling entry function '\S*?(flash_fwd_kernel)I(f|13__nv_bfloat16)Li(\d+)E", line)
        if entry:
            dtype = "float32" if entry.group(2) == "f" else "bfloat16"
            d = int(entry.group(3))
            kernel = (f"{entry.group(1)}<{dtype}, D={d}> "
                      f"(dynamic smem {lib.dtp_flash_fwd_smem_bytes(d)} B/block)")
        elif "registers" in line or "spill stores" in line:
            report = re.sub(r"^ptxas info\s*:\s*", "", line.strip())
            log(f"[device] {kernel}: {report}")
    return card


# (B, Tq, Tk, H, D, causal, valid_len, dtype)
KERNEL_CASES = [
    (2, 197, 197, 3, 64, False, None, "float32"),  # ragged T, non-causal
    (2, 1000, 1000, 2, 128, True, None, "float32"),  # ragged T, causal, D=128
    (2, 1000, 1000, 4, 8, False, None, "float32"),  # D=8 (LMTiny's head dim)
    (1, 130, 130, 4, 8, True, None, "bfloat16"),
    (2, 197, 197, 2, 64, False, 150, "bfloat16"),  # valid_len
    (2, 197, 197, 2, 128, False, 100, "float32"),  # valid_len, D=128
    (1, 96, 40, 2, 16, True, None, "float32"),  # Tq > Tk
    (1, 50, 130, 2, 32, False, None, "bfloat16"),  # Tq < Tk
    (1, 1024, 1024, 12, 64, True, None, "bfloat16"),  # served, B=1
    (8, 1024, 1024, 12, 64, True, None, "bfloat16"),  # served, B=8
    (8, 1024, 1024, 12, 64, True, None, "float32"),
]
# f32: kernel and plain both sum in f32, in other orders over up to 1024 keys.
# bf16: the same f32 arithmetic on the same bf16 inputs, then o rounded to bf16 on each
# side, which may land one bf16 ulp (2^-7 relative) apart. lse is f32 on both sides.
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)}
LSE_TOL = (1e-4, 1e-5)


def phase_kernels():
    import torch

    from distributed_training_pytorch_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1234)
    served_err = 0.0
    for b, tq, tk, h, d, causal, valid_len, dtype_name in KERNEL_CASES:
        dtype = getattr(torch, dtype_name)
        q = torch.randn(b, tq, h, d, device="cuda", generator=gen).to(dtype)
        k = torch.randn(b, tk, h, d, device="cuda", generator=gen).to(dtype)
        v = torch.randn(b, tk, h, d, device="cuda", generator=gen).to(dtype)
        before = fa.launches
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, valid_len=valid_len)
        torch.cuda.synchronize()
        if fa.launches != before + 1:
            raise RuntimeError("the kernel wrapper did not launch its kernel")
        o_ref, lse_ref = fa.flash_attention_plain(q, k, v, causal=causal, valid_len=valid_len)
        err = (o.float() - o_ref.float()).abs().max().item()
        lse_err = (lse - lse_ref).abs().max().item()
        atol, rtol = TOL[dtype_name]
        ok_o = torch.allclose(o.float(), o_ref.float(), atol=atol, rtol=rtol)
        ok_lse = torch.allclose(lse, lse_ref, atol=LSE_TOL[0], rtol=LSE_TOL[1])
        finite = bool(torch.isfinite(o.float()).all() and torch.isfinite(lse).all())
        log(f"[kernel] B={b} Tq={tq} Tk={tk} H={h} D={d} causal={causal} valid_len={valid_len} "
            f"{dtype_name}: max|o-plain|={err:.3e} (atol {atol}, rtol {rtol}) "
            f"max|lse-plain|={lse_err:.3e} -> {'ok' if ok_o and ok_lse and finite else 'FAIL'}")
        if not (ok_o and ok_lse and finite):
            raise RuntimeError("flash kernel disagrees with its plain version")
        if (b, tq, h, d, causal, dtype_name) == (8, 1024, 12, 64, True, "bfloat16"):
            served_err = err
    return served_err


def phase_slice(run_dir: str):
    import torch

    from distributed_training_pytorch_tpu_torch.models import GPTSmall
    from distributed_training_pytorch_tpu_torch.ops import flash_attention as fa
    from distributed_training_pytorch_tpu_torch.serving import (
        InferEngine,
        InferenceServer,
        MicroBatcher,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    model = GPTSmall(dtype=torch.bfloat16, device="cuda", generator=gen).eval()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[slice] GPTSmall: {n_params} params, vocab {VOCAB}, {DEPTH}x768, bf16 compute, f32 params")

    def next_token_logits(params, tokens):
        hidden = torch.func.functional_call(model, params, (tokens,), {"return_hidden": True})
        return hidden[:, -1].float() @ params["embed.weight"].float().T  # [n, V] f32

    engine = InferEngine(next_token_logits, device="cuda", buckets=(1, 2, 4, 8))
    engine.swap_params(model.state_dict(), version="seed0")
    log(f"[slice] warmup of buckets {engine.buckets}: {engine.warmup(np.zeros((SEQ,), np.int32)):.2f} s")

    rng = np.random.default_rng(2024)
    rows = rng.integers(0, VOCAB, size=(N_CLIENTS * REQUESTS_PER_CLIENT, SEQ)).astype(np.int32)
    server = InferenceServer(
        engine,
        batcher=MicroBatcher(buckets=engine.buckets, max_delay_s=0.01),
        run_dir=run_dir,
        input_dtype="int32",
        pulse_every_s=0.5,
        process_index=0,
    )
    results: dict = {}
    failures: list = []
    latencies: list = []

    def client(ci: int) -> None:
        for j in range(REQUESTS_PER_CLIENT):
            idx = ci * REQUESTS_PER_CLIENT + j
            body = json.dumps({"tenant": f"c{ci}", "inputs": [rows[idx].tolist()]}).encode()
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.port}/predict", data=body,
                headers={"Content-Type": "application/json"},
            )
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(req, timeout=120) as resp:
                    status, payload = resp.status, json.loads(resp.read())
            except Exception as e:  # noqa: BLE001 — every failure is reported and fails the phase
                failures.append(f"request {idx}: {type(e).__name__}: {e}")
                continue
            latencies.append((time.perf_counter() - t0) * 1e3)
            if status != 200:
                failures.append(f"request {idx}: HTTP {status}")
            results[idx] = payload

    server.start()
    if not server.enabled:
        raise RuntimeError("inference server did not start")
    try:
        batches_before = server.batcher.batches
        fa.launches = 0  # count only the main path's launches from here
        threads = [threading.Thread(target=client, args=(ci,), daemon=True) for ci in range(N_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = fa.launches
        forwards = server.batcher.batches - batches_before
        if any(t.is_alive() for t in threads):
            raise RuntimeError("a client did not finish")
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/status", timeout=30) as r:
            status = json.loads(r.read())
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/metrics", timeout=30) as r:
            metrics = r.read().decode()
    finally:
        server.close()
    if failures:
        raise RuntimeError(f"{len(failures)} requests failed: {failures[:4]}")
    if len(results) != len(rows):
        raise RuntimeError(f"{len(results)} of {len(rows)} requests answered")
    log(f"[slice] {len(rows)} requests, all HTTP 200, in {wall:.2f} s over {forwards} forwards; "
        f"kernel launches {launches} (12 per forward: {12 * forwards})")
    if forwards < 1 or launches != DEPTH * forwards:
        raise RuntimeError(f"expected {DEPTH} kernel launches per forward, got {launches} over {forwards}")
    if status.get("requests_total") != len(rows) or "tpu_serve_up 1" not in metrics:
        raise RuntimeError(f"/status or /metrics wrong: {status}")
    log(f"[slice] /status: requests_total={status['requests_total']} batches={status['batches']} "
        f"p50_ms={status['p50_ms']} p99_ms={status['p99_ms']} trace_counts={status['trace_counts']}")

    served = np.stack([np.asarray(results[i]["outputs"][0], np.float32) for i in range(len(rows))])
    if served.shape != (len(rows), VOCAB) or not np.isfinite(served).all():
        raise RuntimeError(f"served logits not finite of shape {(len(rows), VOCAB)}: {served.shape}")
    plain = GPTSmall(dtype=torch.bfloat16, attention_impl="plain", device="cuda", generator=gen).eval()
    plain.load_state_dict(model.state_dict())
    refs = []
    with torch.inference_mode():
        for i in range(0, len(rows), 4):
            tokens = torch.from_numpy(rows[i : i + 4]).to("cuda")
            refs.append(plain.logits(plain(tokens, return_hidden=True)[:, -1]).cpu().numpy())
    ref = np.concatenate(refs)
    err = float(np.abs(served - ref).max())
    agree = float((served.argmax(-1) == ref.argmax(-1)).mean())
    scale = float(np.abs(ref).max())
    # Both models compute in bf16 but round at other places: the kernel keeps the
    # attention weights and P.V in f32, the plain path rounds logits and weights to bf16;
    # 12 residual layers carry that difference to the logits (here of magnitude ~1).
    atol = 0.1
    log(f"[slice] served vs plain-attention model: max|diff|={err:.4f} (atol {atol}; max|logit|={scale:.3f}), "
        f"argmax agreement {agree:.3f}")
    if err > atol:
        raise RuntimeError("served logits disagree with the plain-attention model")
    lat = sorted(latencies)
    p50 = lat[len(lat) // 2]
    p99 = lat[min(len(lat) - 1, int(0.99 * len(lat)))]
    return launches, {"p50_ms": p50, "p99_ms": p99, "n": len(lat), "server": status}


def phase_times(card: str):
    import torch
    import torch.nn.functional as F

    from distributed_training_pytorch_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(99)
    rows = []
    for b, t, h, d in SERVED_SHAPES:
        q, k, v = (torch.randn(b, t, h, d, device="cuda", generator=gen).to(torch.bfloat16) for _ in range(3))
        ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=True))
        plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
        bound_ms, bound_by, flops, nbytes = attention_bound(b, t, t, h, d, True, "bfloat16", 2)
        rows.append({"shape": [b, t, h, d], "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by})
        log(f"[times] {card} | flash_fwd B={b} T={t} H={h} D={d} bf16 causal: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB), "
            f"{bound_ms / ms:.4f} of the bound")
    return rows


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        import distributed_training_pytorch_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from a checkout of the repository (the port package is missing)",
              file=sys.stderr)
        return 2
    try:
        card = phase_device()
        served_err = phase_kernels()
        run_root = os.path.join(REPO, "build")
        os.makedirs(run_root, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=run_root) as run_dir:
            launches, serve = phase_slice(run_dir)
        times = phase_times(card)
        log(f"[times] {card} | served requests: p50 {serve['p50_ms']:.2f} ms, p99 {serve['p99_ms']:.2f} ms "
            f"over {serve['n']} requests (client clock, HTTP included; p99 is the slowest of so few)")
    except Exception:  # noqa: BLE001 — any failed phase fails the run
        traceback.print_exc()
        return 1
    b8 = times[-1]
    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "distributed_training_pytorch_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "distributed_training_pytorch_tpu/ops/pallas.py:81",
        "launches": launches,
        "max_abs_err": served_err,
        "ms": b8["ms"],
        "plain_ms": b8["plain_ms"],
        "bound_ms": b8["bound_ms"],
        "bound_by": b8["bound_by"],
        "library_ms": b8["library_ms"],
        "shape": b8["shape"],
        "dtype": "bfloat16",
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
