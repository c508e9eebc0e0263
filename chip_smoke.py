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
3. backward kernels vs plain: the dq and dk/dv kernels (``csrc/flash_bwd.cu``) against
   ``flash_attention_bwd_plain`` over the same kinds of cases, Tq != Tk with external
   lse/delta, and the training shape; then ``flash_attention``'s autograd path against
   autograd through the plain version;
4. serving: GPT-2-small at full width (bf16, seeded random weights) behind
   ``InferEngine`` + ``InferenceServer``, 16 ``/predict`` requests of 1024 tokens from 4
   concurrent clients; every answer 200, finite, and close to the plain-attention model's;
   the forward kernel's launch count over that run is 12 per forward;
5. training: the port's LM entry (``examples/train_lm.py``) on byte-level GPT-2-small at
   full width and depth, T=1024, global batch 64, bf16, on the synthetic byte stream: 2
   epochs, then a resume from ``last`` for a third; every loss finite, the last epoch's
   train loss below the first's, ``best``/``last`` valid, the resume continuing the step
   and epoch, and exactly 12 launches of each kernel per step (plus 12 forward launches
   per validation forward); the step time (median, CUDA events), tokens/s and peak memory;
6. times, with CUDA events: each kernel, its plain version, its bound, and the PyTorch
   call that computes the same function as a yardstick (``scaled_dot_product_attention``
   forward, and its backward as fwd+bwd minus fwd; the port never calls it), at the
   training shape and at B=8; and the served requests' p50/p99;
7. (A) the fused 1x1-conv kernel (``csrc/conv1x1_bn_act.cu``) against its plain version
   on the card: f32 (TF32 off) and bf16, identity/relu/gelu epilogues, random scale and
   bias with zero scales, row counts off the tile, Cin -> Cout from 24 -> 16 to
   768 -> 3072, ResNet-50's nine shapes at batch 256, a strided channels-last view, and
   the autograd backward against autograd through the plain version;
8. (B) ResNet-50 training: the port's ImageNet entry (``examples/train_imagenet.py``) at
   224x224, 1000 classes, global batch 256, bf16 model with f32 params, ``PALLAS=1``, on a
   synthetic set capped to 3 steps an epoch: 2 epochs, then a resume from ``last`` for a
   third; every loss finite, the running statistics moved, the resume continuing the step
   and epoch, exactly 9 kernel launches per train step and per val forward, and the
   trained model's logits finite and close to the same weights through cuDNN's 1x1
   convolutions; the step time (median, CUDA events), images/s, peak memory and the
   device's busy share of the resumed epoch; then the same steps timed with ``PALLAS=1``
   and ``PALLAS=0`` in turns;
9. times of the 1x1 kernel at ResNet-50's nine shapes: kernel, plain, bound, and the
   faster of ``torch.matmul`` and a channels-last 1x1 ``F.conv2d`` as the yardstick;
10. (K5) the ring's block entry points ``flash_block_fwd``/``flash_block_bwd`` (wrappers
    over the three attention kernels) against their plain versions at the ring's block
    shape (B=16, Tq=Tk=1024, H=12, D=64), bf16 and f32, on a diagonal (causal) and a
    visible block, the backward given the q shard's merged global lse and delta;
11. (ring) one attention layer of the ring configuration (16 x 4096, 12 heads, bf16) with
    all 4 sequence shards on the card: the ring against ``flash_attention`` over the whole
    T, forward and gradients (elementwise and as a share of the norm), exactly 10
    launches of each kernel for the ring and 1 for the dense; times of the ring, of ``flash_attention``, of SDPA, and of K5's 10 blocks
    each way beside their plain versions and their bound;
12. (ring training) byte-level GPT-2-small at T=4096, global batch 16, ``MESH=sp4``,
    through the LM entry's trainer with a ring ``build_model`` (``RingLMTrainer``): the
    first batch's loss and first layer's attention output against the same weights
    through flash attention, then 2 epochs
    and a resume from ``last``; every loss finite, the train loss falling, the padded val
    batch run once a validation, exactly 120 launches of each kernel (12 layers x 10
    blocks) per train step and per val forward; step time, tokens/s, peak memory.

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
TRAIN_SHAPE = (64, 1024, 12, 64)  # byte-level GPT-2-small at global batch 64
VOCAB, SEQ, DEPTH = 50257, 1024, 12
N_CLIENTS, REQUESTS_PER_CLIENT = 4, 4
TRAIN_ENV = {"LM_SIZE": "small", "SEQ_LEN": "1024", "BATCH": "64", "DTYPE": "bf16", "BASE_LR": "3e-4"}
TRAIN_EPOCHS = 2  # then one resumed epoch


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


# Products over the (query, key) pairs, and the [B, T, H, D] tensors and the f32 [B, H, Tq]
# rows read or written once, of each function: fwd reads q, k, v, writes o and lse; dq reads
# q, k, v, dO, lse, delta, writes dq; dk/dv reads the same and writes dk, dv. bwd is the
# whole backward as one function (K5's flash_block_bwd, returning dq, dk and dv): it needs
# QK^T, dO V^T, P^T dO, dS K and dS^T Q once each, not the two that dq and dk/dv each redo.
KERNEL_WORK = {
    "fwd": {"products": 2, "q_side": 2, "k_side": 2, "rows": 1},
    "dq": {"products": 3, "q_side": 3, "k_side": 2, "rows": 2},
    "dkv": {"products": 4, "q_side": 2, "k_side": 4, "rows": 2},
    "bwd": {"products": 5, "q_side": 3, "k_side": 4, "rows": 2},
}

# ResNet-50's 1x1 convolutions that the kernel takes at 224x224 (input at least 56 high),
# at global batch 256: (name, Cin, Cout, stride) on a [256, Cin, 56, 56] input.
RESNET_BATCH = 256
RESNET_K4_SHAPES = [
    ("s1b0_reduce", 64, 64, 1),
    ("s1b0_expand", 64, 256, 1),
    ("s1b0_shortcut", 64, 256, 1),
    ("s1b1_reduce", 256, 64, 1),
    ("s1b1_expand", 64, 256, 1),
    ("s1b2_reduce", 256, 64, 1),
    ("s1b2_expand", 64, 256, 1),
    ("s2b0_reduce", 256, 128, 1),
    ("s2b0_shortcut", 256, 512, 2),
]
RESNET_ENV = {"MODEL": "resnet50", "IMAGE_SIZE": "224", "BATCH": str(RESNET_BATCH), "PALLAS": "1",
              "STEPS_PER_EPOCH": "3", "SHIP_UINT8": "1"}
RESNET_RECORDS, RESNET_VAL_RECORDS = 3 * RESNET_BATCH, RESNET_BATCH  # 3 steps, 1 val batch
RESNET_EPOCHS = 2  # then one resumed epoch


def conv1x1_bound(rows, cin, cout, dtype_name="bfloat16", itemsize=2):
    """Least time for one 1x1 launch: the larger of its FLOPs (2 N Cin Cout) over the peak
    of its type and its bytes (x read once, the output written once, w, scale and bias)
    over the memory rate."""
    flops = 2.0 * rows * cin * cout
    nbytes = (rows * cin + rows * cout + cin * cout) * itemsize + 2 * cout * 4
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), flops, nbytes


def attention_bound(b, tq, tk, h, d, causal, dtype_name, itemsize, kind="fwd"):
    """Least time for one kernel on this card: the larger of its FLOPs over the peak of
    its type and its bytes (each input read once, each output written once) over the
    memory rate. FLOPs count the (query, key) pairs these inputs need, 2*D a product:
    QK^T and PV forward; QK^T, dO V^T and dS K for dq; QK^T, dO V^T, P^T dO and dS^T Q
    for dk/dv; the five distinct ones for the whole backward (``kind="bwd"``)."""
    work = KERNEL_WORK[kind]
    if causal:
        pairs = sum(min(i + 1, tk) for i in range(tq))
    else:
        pairs = tq * tk
    flops = 2.0 * work["products"] * b * h * pairs * d
    nbytes = (work["q_side"] * b * tq * h * d + work["k_side"] * b * tk * h * d) * itemsize
    nbytes += 4 * work["rows"] * b * h * tq
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
    smem = {
        "flash_fwd_kernel": lib.dtp_flash_fwd_smem_bytes,
        "flash_bwd_dq_kernel": lib.dtp_flash_bwd_dq_smem_bytes,
        "flash_bwd_dkv_kernel": lib.dtp_flash_bwd_dkv_smem_bytes,
    }
    kernel = ""
    for line in _build.build_log.splitlines():
        entry = re.search(
            r"Compiling entry function '\S*?(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel)I(f|13__nv_bfloat16)Li(\d+)E", line
        )
        conv = re.search(
            r"Compiling entry function '\S*?conv1x1_bn_act_kernelI(f|13__nv_bfloat16)(f|13__nv_bfloat16|S\d*_)Lb([01])E", line
        )
        if conv:
            names = {"f": "float32", "13__nv_bfloat16": "bfloat16"}
            out_type = names.get(conv.group(2), names[conv.group(1)])  # S<n>_: the input type again
            kernel = (f"conv1x1_bn_act_kernel<{names[conv.group(1)]} -> {out_type}, "
                      f"16-byte loads={conv.group(3) == '1'}>")
        elif entry:
            dtype = "float32" if entry.group(2) == "f" else "bfloat16"
            d = int(entry.group(3))
            kernel = (f"{entry.group(1)}<{dtype}, D={d}> "
                      f"(dynamic smem {smem[entry.group(1)](d)} B/block)")
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
    (64, 1024, 1024, 12, 64, True, None, "bfloat16"),  # training
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
    train_err = 0.0
    for b, tq, tk, h, d, causal, valid_len, dtype_name in KERNEL_CASES:
        dtype = getattr(torch, dtype_name)
        q = torch.randn(b, tq, h, d, device="cuda", generator=gen).to(dtype)
        k = torch.randn(b, tk, h, d, device="cuda", generator=gen).to(dtype)
        v = torch.randn(b, tk, h, d, device="cuda", generator=gen).to(dtype)
        before = fa.launches["fwd"]
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, valid_len=valid_len)
        torch.cuda.synchronize()
        if fa.launches["fwd"] != before + 1:
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
        if (b, tq, h, d, causal, dtype_name) == (*TRAIN_SHAPE[:2], *TRAIN_SHAPE[2:], True, "bfloat16"):
            train_err = err
    return train_err


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
        fa.reset_launches()  # count only this path's launches from here
        threads = [threading.Thread(target=client, args=(ci,), daemon=True) for ci in range(N_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = fa.launches["fwd"]
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


# (B, Tq, Tk, H, D, causal, valid_len, dtype, external lse/delta)
BWD_CASES = [
    (2, 197, 197, 3, 64, False, None, "float32", False),  # ragged T, non-causal
    (2, 1000, 1000, 2, 128, True, None, "float32", False),  # ragged T, causal, D=128
    (2, 1000, 1000, 4, 8, False, None, "float32", False),  # D=8
    (1, 130, 130, 4, 8, True, None, "bfloat16", False),
    (2, 197, 197, 2, 64, False, 150, "bfloat16", False),  # valid_len
    (2, 197, 197, 2, 128, False, 100, "float32", False),  # valid_len, D=128
    (1, 96, 40, 2, 16, True, None, "float32", True),  # Tq > Tk, external lse/delta
    (1, 50, 130, 2, 32, False, None, "bfloat16", True),  # Tq < Tk, external lse/delta
    (8, 1024, 1024, 12, 64, True, None, "float32", False),
    (8, 1024, 1024, 12, 64, True, None, "bfloat16", False),
    (*TRAIN_SHAPE[:2], TRAIN_SHAPE[1], *TRAIN_SHAPE[2:], True, None, "bfloat16", False),  # training
]
# f32: kernel and plain both sum in f32, in other orders, over up to 1000 keys or queries.
# bf16: the same f32 arithmetic on the same bf16 inputs, but ds and p are rounded to bf16
# before their products on each side and may round one ulp (2^-7 relative) apart, and each
# grad is rounded to bf16 at the end: held to 2e-2 of the grad's largest magnitude.
BWD_ATOL_F32 = 2e-4
BWD_REL_BF16 = 2e-2


def _grad_err(g, ref):
    """(max |g - ref|, bound, ok) under the dtype's tolerance."""
    import torch

    err = (g.float() - ref.float()).abs().max().item()
    bound = BWD_ATOL_F32 if g.dtype == torch.float32 else BWD_REL_BF16 * ref.float().abs().max().item()
    return err, bound, bool(torch.isfinite(g.float()).all()) and err <= bound


def _rel_err(g, ref):
    """||g - ref|| / ||ref||, in f32; inf when g is not finite."""
    import torch

    g, ref = g.float(), ref.float()
    if not bool(torch.isfinite(g).all()):
        return float("inf")
    return ((g - ref).norm() / ref.norm()).item()


def phase_bwd_kernels():
    """K2/K3 against the plain backward, then the autograd path; returns the training
    shape's errors ``{"dq": x, "dkv": x}``."""
    import torch

    from distributed_training_pytorch_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(4321)
    train_err = {}
    for b, tq, tk, h, d, causal, valid_len, dtype_name, external in BWD_CASES:
        dtype = getattr(torch, dtype_name)
        q = torch.randn(b, tq, h, d, device="cuda", generator=gen).to(dtype)
        k = torch.randn(b, tk, h, d, device="cuda", generator=gen).to(dtype)
        v = torch.randn(b, tk, h, d, device="cuda", generator=gen).to(dtype)
        do = torch.randn(b, tq, h, d, device="cuda", generator=gen).to(dtype)
        o, lse = fa.flash_attention_plain(q, k, v, causal=causal, valid_len=valid_len)
        delta = None
        if external:  # a q shard's global statistics, as the ring path passes them
            lse = lse + 0.5
            delta = 0.1 * torch.randn(b, h, tq, device="cuda", generator=gen)
        before = dict(fa.launches)
        grads = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, valid_len=valid_len, delta=delta)
        torch.cuda.synchronize()
        if (fa.launches["bwd_dq"], fa.launches["bwd_dkv"]) != (before["bwd_dq"] + 1, before["bwd_dkv"] + 1):
            raise RuntimeError("the backward wrappers did not launch their kernels")
        refs = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal, valid_len=valid_len, delta=delta)
        results = [_grad_err(g, r) for g, r in zip(grads, refs, strict=True)]
        ok = all(r[2] for r in results)
        errs = " ".join(f"d{n}={e:.3e}/{bd:.1e}" for n, (e, bd, _) in zip("qkv", results, strict=True))
        log(f"[bwd] B={b} Tq={tq} Tk={tk} H={h} D={d} causal={causal} valid_len={valid_len} "
            f"external={external} {dtype_name}: max|grad-plain|/bound {errs} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError("flash backward kernels disagree with their plain version")
        if (b, tq, h, d, causal, dtype_name) == (*TRAIN_SHAPE[:2], *TRAIN_SHAPE[2:], True, "bfloat16"):
            train_err = {"dq": results[0][0], "dkv": max(results[1][0], results[2][0])}
        del q, k, v, do, o, lse, grads, refs
    torch.cuda.empty_cache()

    # The autograd path: flash_attention forward + backward through the kernels against
    # autograd through the plain version, on strided views as the LM makes them.
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        qkv = torch.randn(2, 300, 3, 4, 64, device="cuda", generator=gen).to(dtype)
        do = torch.randn(2, 300, 4, 64, device="cuda", generator=gen).to(dtype)
        grads = []
        for use_kernel in (True, False):
            leaf = qkv.clone().requires_grad_()
            q, k, v = leaf[:, :, 0], leaf[:, :, 1], leaf[:, :, 2]
            o = fa.flash_attention(q, k, v, causal=True) if use_kernel else fa.flash_attention_plain(q, k, v, causal=True)[0]
            o.backward(do)
            grads.append(leaf.grad)
        err, bound, ok = _grad_err(grads[0], grads[1])
        log(f"[bwd] autograd flash_attention vs autograd through plain, B=2 T=300 H=4 D=64 causal {dtype_name}: "
            f"max|grad diff| {err:.3e} (bound {bound:.1e}) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError("flash_attention's autograd path disagrees with autograd through plain attention")
    return train_err


def _instrument(trainer, step_ms, counts, epoch_metrics, val_metrics):
    """Wrap a trainer's hooks: CUDA events around each train step (into ``step_ms``),
    counts of train steps and validation forwards, and each epoch's train and val
    metrics."""
    import torch

    train_step, validate_step = trainer.train_step, trainer.validate_step
    train_epoch, validate = trainer.train_epoch, trainer.validate

    def timed_step(state, batch):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = train_step(state, batch)
        end.record()
        step_ms.append((start, end))
        counts["steps"] += 1
        return out

    def counted_validate_step(state, batch):
        counts["evals"] += 1
        return validate_step(state, batch)

    def recorded_train_epoch(epoch):
        epoch_metrics.append(train_epoch(epoch))
        return epoch_metrics[-1]

    def recorded_validate():
        val_metrics.append(validate())
        return val_metrics[-1]

    trainer.train_step, trainer.validate_step = timed_step, counted_validate_step
    trainer.train_epoch, trainer.validate = recorded_train_epoch, recorded_validate
    return trainer


def phase_train(run_dir: str):
    """The LM entry at full size: 2 epochs, then a resumed epoch; returns the launch counts
    of the phase and the step-time figures."""
    import torch

    from distributed_training_pytorch_tpu_torch.checkpoint import CheckpointManager
    from distributed_training_pytorch_tpu_torch.examples import train_lm
    from distributed_training_pytorch_tpu_torch.ops import flash_attention as fa

    torch.cuda.empty_cache()
    saved_env = {k: os.environ.get(k) for k in (*TRAIN_ENV, "EPOCHS", "SAVE_DIR", "SNAPSHOT", "LM_CORPUS")}
    os.environ.update(TRAIN_ENV, SAVE_DIR=run_dir)
    os.environ.pop("LM_CORPUS", None)
    step_ms, epoch_metrics, val_metrics = [], [], []
    counts = {"steps": 0, "evals": 0}

    def instrument(trainer):
        return _instrument(trainer, step_ms, counts, epoch_metrics, val_metrics)

    try:
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()  # count only this path's launches from here
        t0 = time.perf_counter()
        os.environ.update(EPOCHS=str(TRAIN_EPOCHS))
        os.environ.pop("SNAPSHOT", None)
        first = instrument(train_lm.build_trainer("cuda"))
        first.train()
        first_steps, first_epoch = first.state.step, first.cur_epoch
        del first
        os.environ.update(EPOCHS=str(TRAIN_EPOCHS + 1), SNAPSHOT="last")
        resumed = instrument(train_lm.build_trainer("cuda"))
        resumed_at = (resumed.state.step, resumed.cur_epoch)
        resumed.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(fa.launches)
        final_step = resumed.state.step
        steps_per_epoch = len(resumed.train_dataloader)
        n_val = len(resumed.val_dataloader)
        del resumed
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    times = [s.elapsed_time(e) for s, e in step_ms]
    steady = sorted(times[1:])  # the first step pays cuBLAS and allocator warm-up
    median_ms = steady[len(steady) // 2]
    b, t = int(TRAIN_ENV["BATCH"]), int(TRAIN_ENV["SEQ_LEN"])
    log(f"[train] byte-level GPTSmall (12 x 768, vocab 256), T={t}, global batch {b}, bf16 compute, f32 params, "
        f"AdamW(0.9, 0.95, wd 0.1), warmup-cosine; {steps_per_epoch} steps/epoch, {n_val} val batch(es)")
    for i, (m, vm) in enumerate(zip(epoch_metrics, val_metrics, strict=True)):
        log(f"[train] epoch {i}: val (before training) nll {vm['nll']:.4f}; train loss {m['loss']:.4f} "
            f"ppl {m['ppl']:.3f}")
    log(f"[train] {counts['steps']} steps, {counts['evals']} validation forwards in {wall:.1f} s (saves included); "
        f"step time median {median_ms:.2f} ms (min {steady[0]:.2f}, max {steady[-1]:.2f}, first {times[0]:.2f}); "
        f"{b * t / median_ms * 1e3:.0f} tokens/s; peak memory {peak_gb:.2f} GB")
    log(f"[train] launches {launches} over {counts['steps']} steps and {counts['evals']} validation forwards")

    losses = [m["loss"] for m in epoch_metrics] + [m["nll"] for m in val_metrics]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite losses: {losses}")
    if not epoch_metrics[-1]["loss"] < epoch_metrics[0]["loss"]:
        raise RuntimeError(f"train loss did not fall: {[m['loss'] for m in epoch_metrics]}")
    expected = {"fwd": DEPTH * (counts["steps"] + counts["evals"]), "bwd_dq": DEPTH * counts["steps"],
                "bwd_dkv": DEPTH * counts["steps"]}
    if launches != expected:
        raise RuntimeError(f"expected launches {expected} (12 per layer pass), got {launches}")
    if (first_steps, first_epoch) != (TRAIN_EPOCHS * steps_per_epoch, TRAIN_EPOCHS - 1):
        raise RuntimeError(f"first run ended at step {first_steps}, epoch {first_epoch}")
    if resumed_at != (TRAIN_EPOCHS * steps_per_epoch, TRAIN_EPOCHS) or final_step != (TRAIN_EPOCHS + 1) * steps_per_epoch:
        raise RuntimeError(f"resume at (step, epoch) {resumed_at}, ended at step {final_step}")
    manager = CheckpointManager(os.path.join(run_dir, "weights"))
    for name in ("best", "last"):
        manager.validate(name)  # raises on a missing manifest or a hash mismatch
    meta = manager.read_meta("last")
    if (meta["epoch"], meta["step"]) != (TRAIN_EPOCHS + 1, final_step):
        raise RuntimeError(f"last checkpoint meta {meta}")
    log(f"[train] best and last valid (SHA-256 manifests); resumed at step {resumed_at[0]}, epoch {resumed_at[1]}; "
        f"last = epoch {meta['epoch']}, step {meta['step']}")
    return launches, {"step_ms": median_ms, "tokens_per_s": b * t / median_ms * 1e3, "peak_gb": peak_gb}


def phase_times(card: str):
    """Kernel, plain and library times with CUDA events, and each kernel's bound, at the
    training shape and the served/B=8 shapes; returns the training shape's rows."""
    import torch
    import torch.nn.functional as F

    from distributed_training_pytorch_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(99)
    rows = {}
    shapes = [TRAIN_SHAPE] + SERVED_SHAPES[::-1]
    for b, t, h, d in shapes:
        q, k, v, do = (torch.randn(b, t, h, d, device="cuda", generator=gen).to(torch.bfloat16) for _ in range(4))
        o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
        sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
        row = {}
        if b != 1:  # the backward at the training shape and at B=8
            lq, lk, lv = (x.detach().requires_grad_() for x in (qt, kt, vt))

            def sdpa_fwd_bwd():
                out = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True)
                torch.autograd.grad(out, (lq, lk, lv), dot)

            def sdpa_fwd_grad():
                F.scaled_dot_product_attention(lq, lk, lv, is_causal=True)

            sdpa_bwd = time_ms(sdpa_fwd_bwd) - time_ms(sdpa_fwd_grad)
            plain_bwd = time_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True, delta=delta),
                                iters=5)
            row["dq"] = {
                "ms": time_ms(lambda: fa.launch_bwd_dq(q, k, v, do, lse, delta, causal=True, seq_len=t)),
                "plain_ms": plain_bwd, "library_ms": sdpa_bwd,
            }
            row["dkv"] = {
                "ms": time_ms(lambda: fa.launch_bwd_dkv(q, k, v, do, lse, delta, causal=True, seq_len=t)),
                "plain_ms": plain_bwd, "library_ms": sdpa_bwd,
            }
        row["fwd"] = {
            "ms": time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=True)),
            "plain_ms": time_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True), iters=5),
            "library_ms": sdpa_fwd,
        }
        for kind, r in row.items():
            bound_ms, bound_by, flops, nbytes = attention_bound(b, t, t, h, d, True, "bfloat16", 2, kind=kind)
            r.update(bound_ms=bound_ms, bound_by=bound_by, shape=[b, t, h, d])
            library = "sdpa backward (dq+dk+dv; fwd+bwd minus fwd)" if kind != "fwd" else "sdpa forward"
            plain = "plain backward (dq+dk+dv)" if kind != "fwd" else "plain forward"
            log(f"[times] {card} | flash_{kind if kind == 'fwd' else 'bwd_' + kind} B={b} T={t} H={h} D={d} "
                f"bf16 causal: kernel {r['ms']:.4f} ms, {plain} {r['plain_ms']:.4f} ms, {library} "
                f"{r['library_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; {flops / 1e9:.2f} GFLOP, "
                f"{nbytes / 1e6:.2f} MB), {bound_ms / r['ms']:.4f} of the bound")
        rows[(b, t, h, d)] = row
        del q, k, v, do, o, lse, delta, qt, kt, vt, dot
        torch.cuda.empty_cache()
    return rows[TRAIN_SHAPE]


# (rows, Cin, Cout, act, dtype): rows off the 128-row tile (70, 6,275), Cin and Cout off
# the 32/64 tiles and the 16-byte loads (24 -> 16, 20 -> 10), ResNet's and ConvNeXt-L's
# expand (768 -> 3072, gelu) channel counts.
CONV1X1_CASES = [
    (70, 24, 16, "relu", "float32"),
    (6275, 64, 256, None, "float32"),
    (6275, 256, 64, "gelu", "float32"),
    (6275, 256, 128, "relu", "float32"),
    (6275, 768, 3072, "gelu", "float32"),
    (70, 24, 16, None, "bfloat16"),
    (1001, 20, 10, "relu", "bfloat16"),
    (6275, 64, 256, "gelu", "bfloat16"),
    (6275, 256, 128, "relu", "bfloat16"),
    (6275, 768, 3072, "gelu", "bfloat16"),
]
# f32: both sides sum at most 768 products of O(1) terms in f32 (the plain version on
# cuBLAS with TF32 off), in other orders: 1e-5, the JAX package's bound
# (tests/test_pallas.py). bf16: the same f32 sums of the same bf16 products, then one
# rounding to bf16 on each side, which may land one bf16 ulp (2^-7 relative) apart: 2e-2
# of the output's largest magnitude. Gradients: f32 2e-4 (tests/test_pallas.py), bf16 2e-2
# of the largest magnitude (dx and dw are bf16 GEMM outputs on both sides).
CONV1X1_ATOL_F32 = 1e-5
CONV1X1_GRAD_ATOL_F32 = 2e-4
CONV1X1_REL_BF16 = 2e-2


def _conv1x1_inputs(gen, rows, cin, cout, dtype, zero_scale=True):
    """x ~ N(0, 1), w ~ N(0, 1/Cin) (so the products sum to O(1)), scale in [0.5, 1.5) with
    every third channel 0 (a zero-init BN gamma folds to a zero scale), bias ~ N(0, 1)."""
    import torch

    x = torch.randn(rows, cin, device="cuda", generator=gen).to(dtype)
    w = (torch.randn(cout, cin, device="cuda", generator=gen) * cin**-0.5).to(dtype)
    scale = torch.rand(cout, device="cuda", generator=gen) + 0.5
    if zero_scale:
        scale[::3] = 0.0
    bias = torch.randn(cout, device="cuda", generator=gen)
    return x, w, scale, bias


def _err_bound(got, ref, atol_f32):
    """(max |got - ref|, its bound): ``atol_f32`` for f32, else a share of ref's largest
    magnitude."""
    import torch

    err = (got.float() - ref.float()).abs().max().item()
    bound = atol_f32 if got.dtype == torch.float32 else CONV1X1_REL_BF16 * ref.float().abs().max().item()
    return err, bound


def phase_conv1x1():
    """Phase A: K4 against its plain version on the card; returns the largest error over
    ResNet-50's nine bf16 shapes at batch 256."""
    import torch

    from distributed_training_pytorch_tpu_torch.ops import conv1x1 as k4

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(2468)

    def check(label, x, w, scale, bias, act):
        before = k4.launches["conv1x1_bn_act"]
        y = k4.conv1x1_bn_act(x, w, scale, bias, act=act)
        torch.cuda.synchronize()
        if k4.launches["conv1x1_bn_act"] != before + 1:
            raise RuntimeError("the conv1x1 wrapper did not launch its kernel")
        ref = k4.conv1x1_bn_act_plain(x, w, scale, bias, act=act)
        err, bound = _err_bound(y, ref, CONV1X1_ATOL_F32)
        ok = err <= bound and bool(torch.isfinite(y.float()).all()) and y.shape == ref.shape and y.dtype == ref.dtype
        log(f"[conv1x1] {label}: max|y-plain|={err:.3e} (bound {bound:.1e}) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError("conv1x1 kernel disagrees with its plain version")
        return err

    for rows, cin, cout, act, dtype_name in CONV1X1_CASES:
        x, w, scale, bias = _conv1x1_inputs(gen, rows, cin, cout, getattr(torch, dtype_name))
        check(f"N={rows} {cin}->{cout} act={act} {dtype_name}", x, w, scale, bias, act)

    # ResNet-50's nine shapes at batch 256, identity epilogue, on channels-last NHWC views:
    # the stride-2 shortcut reads x[:, :, ::2, ::2] of its input in place.
    worst = 0.0
    for name, cin, cout, stride in RESNET_K4_SHAPES:
        full = torch.randn(RESNET_BATCH, cin, 56, 56, device="cuda", generator=gen).to(torch.bfloat16)
        full = full.contiguous(memory_format=torch.channels_last)
        x = full[:, :, ::stride, ::stride].permute(0, 2, 3, 1)
        w = (torch.randn(cout, cin, device="cuda", generator=gen) * cin**-0.5).to(torch.bfloat16)
        ones, zeros = torch.ones(cout, device="cuda"), torch.zeros(cout, device="cuda")
        label = f"resnet50 {name} [{RESNET_BATCH}, {56 // stride}, {56 // stride}, {cin}] -> {cout} bf16"
        worst = max(worst, check(label + (" (strided view)" if stride > 1 else ""), x, w, ones, zeros, None))
        del full, x
        torch.cuda.empty_cache()

    # The autograd path: conv1x1_bn_act_diff through the kernel against autograd through
    # the plain version, on a strided channels-last view, every epilogue, both affine modes.
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for act in (None, "relu", "gelu"):
            for affine_grads in (False, True):
                full = torch.randn(4, 64, 30, 30, device="cuda", generator=gen).to(dtype)
                full = full.contiguous(memory_format=torch.channels_last)
                _, w, scale, bias = _conv1x1_inputs(gen, 1, 64, 96, dtype)
                g = torch.randn(4, 15, 15, 96, device="cuda", generator=gen).to(dtype)
                grads = []
                for use_kernel in (True, False):
                    leaves = [t.clone().requires_grad_() for t in (full, w, scale, bias)]
                    x = leaves[0][:, :, ::2, ::2].permute(0, 2, 3, 1)
                    if use_kernel:
                        y = k4.conv1x1_bn_act_diff(x, *leaves[1:], act=act, affine_grads=affine_grads)
                    else:
                        y = k4.conv1x1_bn_act_plain(x, *leaves[1:], act=act)
                    y.backward(g)
                    grads.append([t.grad for t in leaves])
                results = []
                for name, got, ref in zip(("x", "w", "scale", "bias"), *grads, strict=True):
                    if name in ("scale", "bias") and not affine_grads:
                        results.append((name, float(got.abs().max()), 0.0))  # declared constant: zeros
                        continue
                    results.append((name, *_err_bound(got, ref, CONV1X1_GRAD_ATOL_F32)))
                ok = all(e <= b for _, e, b in results)
                errs = " ".join(f"d{n}={e:.2e}/{b:.1e}" for n, e, b in results)
                log(f"[conv1x1] autograd vs plain, [4, 15, 15, 64] strided -> 96 act={act} affine_grads={affine_grads} "
                    f"{dtype_name}: {errs} -> {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise RuntimeError("conv1x1_bn_act_diff's backward disagrees with autograd through the plain version")
    return worst


def _images_per_s(batch, ms):
    return batch / ms * 1e3


def phase_resnet(run_dir: str):
    """Phase B: ResNet-50 through the port's ImageNet entry with PALLAS=1: 2 epochs, then a
    resumed epoch under the profiler; returns the kernel's launches and the figures."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from distributed_training_pytorch_tpu_torch.checkpoint import CheckpointManager
    from distributed_training_pytorch_tpu_torch.examples import train_imagenet
    from distributed_training_pytorch_tpu_torch.models import ResNet50
    from distributed_training_pytorch_tpu_torch.ops import conv1x1 as k4

    torch.backends.cudnn.allow_tf32 = True  # the entry's own settings: bf16 convolutions
    torch.cuda.empty_cache()
    keys = (*RESNET_ENV, "EPOCHS", "SAVE_DIR", "SNAPSHOT", "DTYPE", "NUM_CLASSES", "IMAGENET_RECORDS", "VAL_RECORDS")
    saved_env = {k: os.environ.get(k) for k in keys}
    os.environ.update(RESNET_ENV, SAVE_DIR=run_dir)
    for k in ("DTYPE", "NUM_CLASSES", "IMAGENET_RECORDS", "VAL_RECORDS"):
        os.environ.pop(k, None)
    step_ms, epoch_metrics, val_metrics = [], [], []
    counts = {"steps": 0, "evals": 0}

    def build():
        trainer = train_imagenet.build_trainer(
            "cuda", synthetic_records=RESNET_RECORDS, synthetic_val_records=RESNET_VAL_RECORDS
        )
        return _instrument(trainer, step_ms, counts, epoch_metrics, val_metrics)

    try:
        os.environ.update(EPOCHS=str(RESNET_EPOCHS))
        os.environ.pop("SNAPSHOT", None)
        first = build()
        stats_before = {k: v.clone() for k, v in first.model.state_dict().items() if "running_" in k}
        torch.cuda.reset_peak_memory_stats()
        k4.reset_launches()  # count only this path's launches from here
        t0 = time.perf_counter()
        first.train()
        first_steps, first_epoch = first.state.step, first.cur_epoch
        stats_moved = sum(
            int(not torch.equal(v, stats_before[k])) for k, v in first.model.state_dict().items() if k in stats_before
        )
        del first
        os.environ.update(EPOCHS=str(RESNET_EPOCHS + 1), SNAPSHOT="last")
        resumed = build()
        resumed_at = (resumed.state.step, resumed.cur_epoch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t_epoch = time.perf_counter()
            resumed.train()
            torch.cuda.synchronize()
            epoch_wall_us = (time.perf_counter() - t_epoch) * 1e6
        wall = time.perf_counter() - t0
        launches = k4.launches["conv1x1_bn_act"]
        final_step = resumed.state.step
        steps_per_epoch = len(resumed.train_dataloader)
        n_val = len(resumed.val_dataloader)
        model = resumed.model
        val_batch = next(iter(resumed.val_dataloader))
        images = resumed.to_device(val_batch)["image"].permute(0, 3, 1, 2)[:32]
        del resumed
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    kernel_us = sum(e.time_range.elapsed_us() for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy = kernel_us / epoch_wall_us if kernel_us else None
    times = [s.elapsed_time(e) for s, e in step_ms]
    # The first step of each epoch follows validation and a save: cold caches and allocator.
    steady = sorted(t for i, t in enumerate(times) if i % steps_per_epoch)
    median_ms = steady[len(steady) // 2]
    log(f"[resnet] ResNet-50 (25.6 M params), 224x224, 1000 classes, global batch {RESNET_BATCH}, bf16 compute, "
        f"f32 params, SGD(0.9, wd 1e-4), warmup-cosine, PALLAS=1; {steps_per_epoch} steps/epoch, {n_val} val batch(es)")
    for i, (m, vm) in enumerate(zip(epoch_metrics, val_metrics, strict=True)):
        log(f"[resnet] epoch {i}: val (before training) ce {vm['ce_loss']:.4f} acc {vm['accuracy']:.4f}; "
            f"train ce {m['ce_loss']:.4f} acc {m['accuracy']:.4f}")
    log(f"[resnet] {counts['steps']} steps, {counts['evals']} validation forwards in {wall:.1f} s (data and saves "
        f"included); step time median {median_ms:.2f} ms (min {steady[0]:.2f}, max {steady[-1]:.2f}; all "
        f"{[round(t, 2) for t in times]}); {_images_per_s(RESNET_BATCH, median_ms):.0f} images/s; peak memory "
        f"{peak_gb:.2f} GB")
    log(f"[resnet] resumed epoch ({steps_per_epoch} steps, 1 val forward, host data and the save included): wall "
        f"{epoch_wall_us / 1e3:.1f} ms, kernel time {kernel_us / 1e3:.1f} ms, device busy share "
        f"{'not measured' if busy is None else f'{busy:.4f}'}")
    log(f"[resnet] conv1x1 launches {launches} over {counts['steps']} steps and {counts['evals']} validation forwards")

    losses = [m["ce_loss"] for m in epoch_metrics] + [m["ce_loss"] for m in val_metrics]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite losses: {losses}")
    if stats_moved == 0:
        raise RuntimeError("no BatchNorm running statistic moved in training")
    if launches != len(RESNET_K4_SHAPES) * (counts["steps"] + counts["evals"]):
        raise RuntimeError(f"expected {len(RESNET_K4_SHAPES)} conv1x1 launches per train step and val forward, "
                           f"got {launches} over {counts['steps']} + {counts['evals']}")
    if (first_steps, first_epoch) != (RESNET_EPOCHS * steps_per_epoch, RESNET_EPOCHS - 1):
        raise RuntimeError(f"first run ended at step {first_steps}, epoch {first_epoch}")
    if resumed_at != (RESNET_EPOCHS * steps_per_epoch, RESNET_EPOCHS) or final_step != (RESNET_EPOCHS + 1) * steps_per_epoch:
        raise RuntimeError(f"resume at (step, epoch) {resumed_at}, ended at step {final_step}")
    manager = CheckpointManager(os.path.join(run_dir, "weights"))
    for name in ("best", "last"):
        manager.validate(name)
    meta = manager.read_meta("last")
    if (meta["epoch"], meta["step"]) != (RESNET_EPOCHS + 1, final_step):
        raise RuntimeError(f"last checkpoint meta {meta}")
    log(f"[resnet] {stats_moved} running statistics moved; best and last valid; resumed at step {resumed_at[0]}, "
        f"epoch {resumed_at[1]}; last = epoch {meta['epoch']}, step {meta['step']}")

    # The trained weights through cuDNN's 1x1 convolutions (PALLAS=0) as the reference.
    model.eval()
    plain = ResNet50(1000, dtype=torch.bfloat16, pallas=False, device="cuda").eval()
    plain.load_state_dict(model.inner.state_dict())
    with torch.no_grad():
        got, ref = model(images), plain(images)
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    # Both run the same bf16 network and round each layer's output to bf16; the 1x1s sum
    # in other orders (the kernel, cuDNN), so a layer's output may differ by a bf16 ulp,
    # which ~50 layers carry to the logits: held to 5e-2 of their largest magnitude.
    bound = 5e-2 * scale
    ok = got.shape == (images.shape[0], 1000) and bool(torch.isfinite(got).all()) and err <= bound
    log(f"[resnet] trained model, {images.shape[0]} val images, PALLAS=1 vs the same weights through cuDNN: max|diff| {err:.4f} "
        f"(bound {bound:.4f}; max|logit| {scale:.3f}), argmax agreement {agree:.3f} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("the kernel path's logits disagree with the cuDNN path's")
    del model, plain
    torch.cuda.empty_cache()
    return launches, {"step_ms": median_ms, "images_per_s": _images_per_s(RESNET_BATCH, median_ms),
                      "peak_gb": peak_gb, "busy": busy}


def phase_resnet_pallas_ab(run_dir: str, n_steps: int = 5):
    """The same ResNet-50 train steps with PALLAS=1 (the kernel) and PALLAS=0 (cuDNN), on
    batches already on the card, in turns (on, off, off, on): median step ms of each."""
    import torch

    from distributed_training_pytorch_tpu_torch.examples import train_imagenet

    keys = (*RESNET_ENV, "EPOCHS", "SAVE_DIR", "SNAPSHOT", "DTYPE")
    saved_env = {k: os.environ.get(k) for k in keys}
    trainers = {}
    try:
        os.environ.update(RESNET_ENV, SAVE_DIR=run_dir, EPOCHS="1")
        for k in ("SNAPSHOT", "DTYPE"):
            os.environ.pop(k, None)
        for knob in ("1", "0"):
            os.environ["PALLAS"] = knob
            trainers[knob] = train_imagenet.build_trainer(
                "cuda", synthetic_records=2 * RESNET_BATCH, synthetic_val_records=RESNET_BATCH
            )
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    trainers["0"].model.load_state_dict(trainers["1"].model.state_dict())
    batches = [trainers["1"].to_device(b) for b in trainers["1"].train_dataloader]
    times = {"1": [], "0": []}

    def run(knob, record):
        tr = trainers[knob]
        for i in range(n_steps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            tr.state, _ = tr.train_step(tr.state, batches[i % len(batches)])
            end.record()
            end.synchronize()
            if record:
                times[knob].append(start.elapsed_time(end))

    for knob in ("1", "0"):
        run(knob, record=False)  # warm-up: cuDNN's algorithm choice, the allocator
    for knob in ("1", "0", "0", "1"):
        run(knob, record=True)
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    log(f"[resnet-ab] train step (batch {RESNET_BATCH}, 224x224, bf16), {2 * n_steps} steps each, in turns: "
        f"PALLAS=1 median {med['1']:.2f} ms ({_images_per_s(RESNET_BATCH, med['1']):.0f} images/s), "
        f"PALLAS=0 median {med['0']:.2f} ms ({_images_per_s(RESNET_BATCH, med['0']):.0f} images/s); "
        f"all {{'1': {[round(t, 2) for t in times['1']]}, '0': {[round(t, 2) for t in times['0']]}}}")
    del trainers, batches
    torch.cuda.empty_cache()
    return med


def phase_conv1x1_times(card: str):
    """K4 at ResNet-50's nine shapes (batch 256, bf16, identity epilogue): kernel, plain,
    bound and the faster of torch.matmul and a channels-last 1x1 F.conv2d; returns the rows."""
    import torch
    import torch.nn.functional as F

    from distributed_training_pytorch_tpu_torch.ops import conv1x1 as k4

    torch.backends.cudnn.allow_tf32 = True
    gen = torch.Generator(device="cuda").manual_seed(1357)
    rows = []
    for name, cin, cout, stride in RESNET_K4_SHAPES:
        full = torch.randn(RESNET_BATCH, cin, 56, 56, device="cuda", generator=gen).to(torch.bfloat16)
        full = full.contiguous(memory_format=torch.channels_last)
        x = full[:, :, ::stride, ::stride].permute(0, 2, 3, 1)
        w = (torch.randn(cout, cin, device="cuda", generator=gen) * cin**-0.5).to(torch.bfloat16)
        w4 = w.view(cout, cin, 1, 1).contiguous(memory_format=torch.channels_last)
        ones, zeros = torch.ones(cout, device="cuda"), torch.zeros(cout, device="cuda")
        n = x.shape[0] * x.shape[1] * x.shape[2]
        before = k4.launches["conv1x1_bn_act"]
        ms = time_ms(lambda: k4.conv1x1_bn_act(x, w, ones, zeros))
        k4.launches["conv1x1_bn_act"] = before  # timing launches are not the main path's
        plain_ms = time_ms(lambda: k4.conv1x1_bn_act_plain(x, w, ones, zeros), iters=5)
        wt = w.T
        matmul_ms = time_ms(lambda: torch.matmul(x.reshape(n, cin), wt))
        conv_ms = time_ms(lambda: F.conv2d(full, w4, stride=stride))
        bound_ms, bound_by, flops, nbytes = conv1x1_bound(n, cin, cout)
        library_ms = min(matmul_ms, conv_ms)
        log(f"[times] {card} | conv1x1 {name} N={n} {cin}->{cout} bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"torch.matmul {matmul_ms:.4f} ms, F.conv2d 1x1 {conv_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
            f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB), {bound_ms / ms:.4f} of the bound")
        rows.append({"name": name, "shape": [n, cin, cout], "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                     "matmul_ms": matmul_ms, "conv2d_ms": conv_ms, "bound_ms": bound_ms, "bound_by": bound_by})
        del full, x
        torch.cuda.empty_cache()
    total = {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    log(f"[times] {card} | conv1x1, the nine launches of one ResNet-50 forward at batch {RESNET_BATCH}: kernel "
        f"{total['ms']:.4f} ms, plain {total['plain_ms']:.4f} ms, library {total['library_ms']:.4f} ms, bound "
        f"{total['bound_ms']:.4f} ms")
    return rows, total


# The ring-training configuration: byte-level GPT-2-small at T=4096, global batch 16 (the
# 65,536 tokens of the T=1024 configuration's step), over a seq axis of 4 held by this
# process on the one card: each ring block is the Tq = Tk = 1024 shape of K1–K3 above.
RING_SHARDS = 4
RING_SHAPE = (16, 4096, 12, 64)  # B, T, H, D of one attention layer
RING_BLOCKS = RING_SHARDS * (RING_SHARDS + 1) // 2  # causal: 10 blocks a layer, each way
RING_ENV = {"LM_SIZE": "small", "SEQ_LEN": "4096", "BATCH": "16", "DTYPE": "bf16", "BASE_LR": "3e-4",
            "MESH": f"sp{RING_SHARDS}"}
RING_EPOCHS = 2  # then one resumed epoch
# Ring against flash attention on the same weights, the first batch's loss (about 5.5):
# both compute in bf16 with f32 softmax statistics; the ring merges its blocks in f32 and
# rounds o once, as the kernel does, so each layer's attention may land one bf16 ulp away,
# which 12 layers carry to a mean over 65,536 tokens' losses.
# 2.0e-5 measured on an H100; 1e-3 leaves room for the order of the bf16 sums and no more.
RING_LOSS_ATOL = 1e-3
# Ring against flash attention over the whole sequence, bf16, as ||got - ref|| / ||ref||:
# both round each output once from f32 sums of the same products, so they part by an ulp
# (2^-8 relative) at some elements, a few 1e-3 of the norm. A block dropped or merged
# with the wrong weight moves a quarter of the rows or more by O(1) of their size, a
# tenth of the norm or more; the elementwise bound (2% of the largest |ref|) alone would
# let that through, |o| being small at T=4096.
RING_REL = 1e-2


def _ring_blocks(t_local):
    """The (q shard, k/v shard, causal) blocks a causal ring of RING_SHARDS visits, as row
    slices: the diagonal ones causal, the earlier ones fully visible, the later ones
    skipped."""
    rows = [slice(j * t_local, (j + 1) * t_local) for j in range(RING_SHARDS)]
    return [(rows[i], rows[j], i == j) for i in range(RING_SHARDS) for j in range(i + 1)]


def phase_k5():
    """K5 (``flash_block_fwd``/``flash_block_bwd``) against its plain version at the ring's
    block shape, bf16 and f32, on a diagonal (causal) and a visible block, the backward
    given the q shard's merged global lse and delta; returns the bf16 errors."""
    import torch

    from distributed_training_pytorch_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(5150)
    b, t, h, d = RING_SHAPE
    tl = t // RING_SHARDS
    errs = {}
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        q, k_own, v_own, k_vis, v_vis, do = (
            torch.randn(b, tl, h, d, device="cuda", generator=gen).to(dtype) for _ in range(6)
        )
        # The q shard's global statistics: its two blocks merged as the ring merges them.
        o_d, lse_d = fa.flash_attention_plain(q, k_own, v_own, causal=True)
        o_v, lse_v = fa.flash_attention_plain(q, k_vis, v_vis, causal=False)
        lse = torch.logaddexp(lse_d, lse_v)
        o = (o_d.float() * torch.exp(lse_d - lse).transpose(1, 2)[..., None]
             + o_v.float() * torch.exp(lse_v - lse).transpose(1, 2)[..., None]).to(dtype)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        fwd_err = bwd_err = 0.0
        for kind, k, v, causal, o_ref, lse_ref in (("diagonal", k_own, v_own, True, o_d, lse_d),
                                                  ("visible", k_vis, v_vis, False, o_v, lse_v)):
            before = dict(fa.launches)
            o_b, lse_b = fa.flash_block_fwd(q, k, v, causal=causal)
            grads = fa.flash_block_bwd(q, k, v, do, lse, delta, causal=causal)
            torch.cuda.synchronize()
            if dict(fa.launches) != {k: n + 1 for k, n in before.items()}:  # K5 counts under K1-K3's names
                raise RuntimeError("the K5 wrappers did not launch their kernels")
            err = (o_b.float() - o_ref.float()).abs().max().item()
            lse_err = (lse_b - lse_ref).abs().max().item()
            atol, rtol = TOL[dtype_name]
            ok = (torch.allclose(o_b.float(), o_ref.float(), atol=atol, rtol=rtol)
                  and torch.allclose(lse_b, lse_ref, atol=LSE_TOL[0], rtol=LSE_TOL[1])
                  and bool(torch.isfinite(o_b.float()).all()))
            refs = fa.flash_attention_bwd_plain(q, k, v, None, lse, do, causal=causal, delta=delta)
            results = [_grad_err(g, r) for g, r in zip(grads, refs, strict=True)]
            ok = ok and all(r[2] for r in results)
            errs_txt = " ".join(f"d{n}={e:.3e}/{bd:.1e}" for n, (e, bd, _) in zip("qkv", results, strict=True))
            log(f"[k5] {kind} block B={b} Tq=Tk={tl} H={h} D={d} causal={causal} {dtype_name}, global lse/delta: "
                f"max|o-plain|={err:.3e} (atol {atol}, rtol {rtol}) max|lse-plain|={lse_err:.3e}; "
                f"max|grad-plain|/bound {errs_txt} -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError("K5 disagrees with its plain version")
            fwd_err, bwd_err = max(fwd_err, err), max([bwd_err] + [r[0] for r in results])
            del grads, refs
        errs[dtype_name] = {"fwd": fwd_err, "bwd": bwd_err}
        del q, k_own, v_own, k_vis, v_vis, do, o_d, o_v, o
        torch.cuda.empty_cache()
    return errs["bfloat16"]


def phase_ring(card: str):
    """One attention layer of the ring-training configuration, all shards on the card:
    the ring (auto: K5 on the kernels) against flash_attention over the whole sequence,
    forward and gradients, with exact launch counts; then times of the ring, of K5's
    blocks alone, of their plain versions and of SDPA, and K5's bound."""
    import torch
    import torch.nn.functional as F

    from distributed_training_pytorch_tpu_torch.ops import flash_attention as fa
    from distributed_training_pytorch_tpu_torch.parallel import MeshConfig, ring_attention

    gen = torch.Generator(device="cuda").manual_seed(6061)
    b, t, h, d = RING_SHAPE
    mesh = MeshConfig(seq=RING_SHARDS).build()
    q, k, v, do = (torch.randn(b, t, h, d, device="cuda", generator=gen).to(torch.bfloat16) for _ in range(4))

    def ring(q, k, v):
        return ring_attention(q, k, v, mesh, causal=True)

    def flash(q, k, v):
        return fa.flash_attention(q, k, v, causal=True)

    def run(attention):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        fa.reset_launches()
        o = attention(*leaves)
        o.backward(do)
        torch.cuda.synchronize()
        return [o.detach()] + [x.grad for x in leaves], dict(fa.launches)

    got, ring_launches = run(ring)
    want, flash_launches = run(flash)
    n = RING_BLOCKS
    if ring_launches != {"fwd": n, "bwd_dq": n, "bwd_dkv": n}:
        raise RuntimeError(f"expected {n} K5 launches each way for a causal ring of {RING_SHARDS}, got {ring_launches}")
    if flash_launches != {"fwd": 1, "bwd_dq": 1, "bwd_dkv": 1}:
        raise RuntimeError(f"expected K1-K3 once each for flash attention, got {flash_launches}")
    results = [_grad_err(g, r) for g, r in zip(got, want, strict=True)]
    rels = [_rel_err(g, r) for g, r in zip(got, want, strict=True)]
    names = ("o", "dq", "dk", "dv")
    errs = " ".join(f"{n}={e:.3e}/{bd:.1e}" for n, (e, bd, _) in zip(names, results, strict=True))
    rel_txt = " ".join(f"{n}={x:.3e}" for n, x in zip(names, rels, strict=True))
    ok = all(r[2] for r in results) and all(x <= RING_REL for x in rels)
    log(f"[ring] one layer B={b} T={t} H={h} D={d} bf16 causal, {RING_SHARDS} shards on one card: ring vs "
        f"flash_attention max|diff|/bound {errs}; ||diff||/||ref|| {rel_txt} (bound {RING_REL}); launches ring "
        f"{ring_launches}, flash {flash_launches} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("the ring disagrees with flash attention over the whole sequence")
    del got, want

    # Times. The ring and flash attention: forward alone, and forward + backward.
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]

    def fwd_bwd(attention):
        def step():
            torch.autograd.grad(attention(*leaves), leaves, do)
        return step

    def fwd_only(attention):
        return lambda: attention(*leaves)

    times = {}
    for name, attention in (("ring", ring), ("flash", flash)):
        fwd = time_ms(fwd_only(attention), iters=10)
        times[name] = {"fwd": fwd, "bwd": time_ms(fwd_bwd(attention), iters=10) - fwd}
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    lq, lk, lv = (x.detach().requires_grad_() for x in (qt, kt, vt))
    sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(lq, lk, lv, is_causal=True), iters=10)
    sdpa_fwd_bwd = time_ms(
        lambda: torch.autograd.grad(F.scaled_dot_product_attention(lq, lk, lv, is_causal=True), (lq, lk, lv), dot),
        iters=10,
    )
    times["sdpa"] = {"fwd": sdpa_fwd, "bwd": sdpa_fwd_bwd - sdpa_fwd}
    del qt, kt, vt, dot, lq, lk, lv

    # K5 alone: the 10 block launches of one layer each way, the backward given the q
    # shards' global lse/delta (from the whole sequence's forward); their plain versions;
    # their bound, summed over the blocks.
    tl = t // RING_SHARDS
    blocks = _ring_blocks(tl)
    with torch.no_grad():
        o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    shards = {r.start: (q[:, r], do[:, r], lse[:, :, r].contiguous(), delta[:, :, r].contiguous())
              for r, _, _ in blocks}
    kv = {r.start: (k[:, r], v[:, r]) for _, r, _ in blocks}

    def k5_fwd(block_fwd):
        return lambda: [block_fwd(shards[qr.start][0], *kv[kr.start], causal=c) for qr, kr, c in blocks]

    def k5_bwd(block_bwd):
        return lambda: [block_bwd(shards[qr.start][0], *kv[kr.start], shards[qr.start][1], shards[qr.start][2],
                                  shards[qr.start][3], causal=c) for qr, kr, c in blocks]

    def plain_bwd(qq, kk, vv, dd, ll, de, *, causal):
        return fa.flash_attention_bwd_plain(qq, kk, vv, None, ll, dd, causal=causal, delta=de)

    def plain_fwd(qq, kk, vv, *, causal):
        return fa.flash_attention_plain(qq, kk, vv, causal=causal)

    k5 = {
        "fwd": {"ms": time_ms(k5_fwd(fa.flash_block_fwd), iters=10),
                "plain_ms": time_ms(k5_fwd(plain_fwd), iters=3, warmup=1),
                "library_ms": times["sdpa"]["fwd"]},
        "bwd": {"ms": time_ms(k5_bwd(fa.flash_block_bwd), iters=10),
                "plain_ms": time_ms(k5_bwd(plain_bwd), iters=3, warmup=1),
                "library_ms": times["sdpa"]["bwd"]},
    }
    for kind in ("fwd", "bwd"):
        bounds = [attention_bound(b, tl, tl, h, d, c, "bfloat16", 2, kind=kind) for _, _, c in blocks]
        t_ops = sum(x[2] for x in bounds) / PEAK_FLOPS["bfloat16"] * 1e3
        t_bytes = sum(x[3] for x in bounds) / PEAK_BYTES_PER_S * 1e3
        k5[kind].update(bound_ms=max(t_ops, t_bytes), bound_by="bytes" if t_bytes >= t_ops else "operations",
                        gflop=sum(x[2] for x in bounds) / 1e9, mb=sum(x[3] for x in bounds) / 1e6,
                        shape=[b, tl, h, d], blocks=len(blocks))
        r = k5[kind]
        log(f"[times] {card} | K5 flash_block_{kind}, the {len(blocks)} blocks of one causal ring layer "
            f"(B={b}, Tq=Tk={tl}, H={h}, D={d}, bf16): kernels {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"SDPA at T={t} {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}; "
            f"{r['gflop']:.2f} GFLOP, {r['mb']:.2f} MB), {r['bound_ms'] / r['ms']:.4f} of the bound")
    log(f"[times] {card} | one attention layer B={b} T={t} H={h} D={d} bf16 causal: ring of {RING_SHARDS} "
        f"fwd {times['ring']['fwd']:.4f} ms, bwd {times['ring']['bwd']:.4f} ms; flash_attention (K1-K3 over T) "
        f"fwd {times['flash']['fwd']:.4f} ms, bwd {times['flash']['bwd']:.4f} ms; SDPA fwd {times['sdpa']['fwd']:.4f} "
        f"ms, bwd (fwd+bwd minus fwd) {times['sdpa']['bwd']:.4f} ms")
    fa.reset_launches()  # the timing launches are not a path's
    del q, k, v, do, o, lse, delta, shards, kv, leaves
    torch.cuda.empty_cache()
    return {"err": max(r[0] for r in results), "times": times, "k5": k5}


def phase_ring_train(run_dir: str):
    """The ring-training configuration through the port's Trainer (the LM entry's trainer
    with a ring ``build_model``): 2 epochs, then a resumed epoch; returns the launch counts
    of the phase and the step-time figures."""
    import torch

    from distributed_training_pytorch_tpu_torch.checkpoint import CheckpointManager
    from distributed_training_pytorch_tpu_torch.examples import train_lm
    from distributed_training_pytorch_tpu_torch.models import GPTSmall
    from distributed_training_pytorch_tpu_torch.ops import flash_attention as fa

    torch.cuda.empty_cache()
    saved_env = {k: os.environ.get(k) for k in (*RING_ENV, "EPOCHS", "SAVE_DIR", "SNAPSHOT", "LM_CORPUS", "PALLAS")}
    os.environ.update(RING_ENV, SAVE_DIR=run_dir)
    for k in ("LM_CORPUS", "PALLAS"):
        os.environ.pop(k, None)
    step_ms, epoch_metrics, val_metrics = [], [], []
    counts = {"steps": 0, "evals": 0}
    cls = train_lm.RingLMTrainer

    def build():
        return _instrument(train_lm.build_trainer("cuda", trainer_cls=cls), step_ms, counts, epoch_metrics, val_metrics)

    try:
        os.environ.update(EPOCHS=str(RING_EPOCHS))
        os.environ.pop("SNAPSHOT", None)
        first = build()
        if first.mesh.shape != {"data": 1, "seq": RING_SHARDS} or not first.mesh.seq_local:
            raise RuntimeError(f"expected all {RING_SHARDS} seq shards in this process, got {first.mesh}")
        # The first batch through the ring and through flash attention, same weights: the
        # loss, and the first layer's attention output (its q, k, v are the same in both).
        batch = first.to_device(next(iter(first.train_dataloader)))
        flash_model = GPTSmall(vocab_size=256, dtype=torch.bfloat16, max_len=first.seq_len, attention_impl="flash",
                               device="cuda")
        flash_model.load_state_dict(first.model.state_dict())
        first_attn = {}

        def capture(model, name):
            attn = model.blocks[0].attn

            def wrapped(q, k, v):
                first_attn[name] = y = attn(q, k, v)
                return y

            model.blocks[0].attn = wrapped
            return attn

        ring_attn, _ = capture(first.model, "ring"), capture(flash_model, "flash")
        try:
            with torch.no_grad():
                ring_loss = float(first.engine.loss_fn(first.model, batch, False)[0])
                flash_loss = float(first.engine.loss_fn(flash_model, batch, False)[0])
        finally:
            first.model.blocks[0].attn = ring_attn
        attn_rel = _rel_err(first_attn["ring"], first_attn["flash"])
        del flash_model, batch, first_attn
        log(f"[ring-train] first batch, same weights: loss ring {ring_loss:.6f}, flash attention {flash_loss:.6f}, "
            f"|diff| {abs(ring_loss - flash_loss):.3e} (atol {RING_LOSS_ATOL}); first layer's attention output "
            f"||ring - flash||/||flash|| {attn_rel:.3e} (bound {RING_REL})")
        if not (np.isfinite(ring_loss) and abs(ring_loss - flash_loss) <= RING_LOSS_ATOL and attn_rel <= RING_REL):
            raise RuntimeError("the ring model disagrees with the flash-attention model")
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()  # count only this path's launches from here
        t0 = time.perf_counter()
        first.train()
        first_steps, first_epoch = first.state.step, first.cur_epoch
        del first
        os.environ.update(EPOCHS=str(RING_EPOCHS + 1), SNAPSHOT="last")
        resumed = build()
        resumed_at = (resumed.state.step, resumed.cur_epoch)
        resumed.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(fa.launches)
        final_step = resumed.state.step
        steps_per_epoch = len(resumed.train_dataloader)
        n_val = len(resumed.val_dataloader)
        val_real = resumed.val_dataloader.global_real_count(0)
        del resumed
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    times = [s.elapsed_time(e) for s, e in step_ms]
    steady = sorted(x for i, x in enumerate(times) if i % steps_per_epoch)  # each epoch's first follows val + save
    median_ms = steady[len(steady) // 2]
    b, t = int(RING_ENV["BATCH"]), int(RING_ENV["SEQ_LEN"])
    log(f"[ring-train] byte-level GPTSmall (12 x 768, vocab 256), T={t}, global batch {b}, ring attention over "
        f"seq={RING_SHARDS} (all shards on this card), bf16 compute, f32 params, AdamW(0.9, 0.95, wd 0.1), "
        f"warmup-cosine; {steps_per_epoch} steps/epoch, {n_val} val batch(es) of which {val_real} rows real")
    for i, (m, vm) in enumerate(zip(epoch_metrics, val_metrics, strict=True)):
        log(f"[ring-train] epoch {i}: val (before training) nll {vm['nll']:.4f}; train loss {m['loss']:.4f} "
            f"ppl {m['ppl']:.3f}")
    log(f"[ring-train] {counts['steps']} steps, {counts['evals']} validation forwards in {wall:.1f} s (saves "
        f"included); step time median {median_ms:.2f} ms (min {steady[0]:.2f}, max {steady[-1]:.2f}; all "
        f"{[round(x, 2) for x in times]}); {b * t / median_ms * 1e3:.0f} tokens/s; peak memory {peak_gb:.2f} GB")
    log(f"[ring-train] launches {launches} over {counts['steps']} steps and {counts['evals']} validation forwards")

    losses = [m["loss"] for m in epoch_metrics] + [m["nll"] for m in val_metrics]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite losses: {losses}")
    if not epoch_metrics[-1]["loss"] < epoch_metrics[0]["loss"]:
        raise RuntimeError(f"train loss did not fall: {[m['loss'] for m in epoch_metrics]}")
    # The val split (7 windows of 4097 bytes) is one batch padded to 16 rows with a mask:
    # one val forward per validation, 3 validations.
    if (n_val, counts["evals"], len(val_metrics)) != (1, RING_EPOCHS + 1, RING_EPOCHS + 1) or not 0 < val_real < b:
        raise RuntimeError(f"expected one padded val batch per validation: {n_val} batches, {val_real} real rows, "
                           f"{counts['evals']} val forwards over {len(val_metrics)} validations")
    per_pass = DEPTH * RING_BLOCKS  # 120: 12 layers x 10 blocks
    fwd = per_pass * (counts["steps"] + counts["evals"])
    bwd = per_pass * counts["steps"]
    # K5's launches count under K1-K3's names; the ring is the model's only attention path,
    # so every one of them is a block's.
    expected = {"fwd": fwd, "bwd_dq": bwd, "bwd_dkv": bwd}
    if launches != expected:
        raise RuntimeError(f"expected launches {expected} ({per_pass} per layer pass), got {launches}")
    if (first_steps, first_epoch) != (RING_EPOCHS * steps_per_epoch, RING_EPOCHS - 1):
        raise RuntimeError(f"first run ended at step {first_steps}, epoch {first_epoch}")
    if resumed_at != (RING_EPOCHS * steps_per_epoch, RING_EPOCHS) or final_step != (RING_EPOCHS + 1) * steps_per_epoch:
        raise RuntimeError(f"resume at (step, epoch) {resumed_at}, ended at step {final_step}")
    manager = CheckpointManager(os.path.join(run_dir, "weights"))
    for name in ("best", "last"):
        manager.validate(name)
    meta = manager.read_meta("last")
    if (meta["epoch"], meta["step"]) != (RING_EPOCHS + 1, final_step):
        raise RuntimeError(f"last checkpoint meta {meta}")
    log(f"[ring-train] best and last valid; resumed at step {resumed_at[0]}, epoch {resumed_at[1]}; last = epoch "
        f"{meta['epoch']}, step {meta['step']}")
    return launches, {"step_ms": median_ms, "tokens_per_s": b * t / median_ms * 1e3, "peak_gb": peak_gb,
                      "losses": [m["loss"] for m in epoch_metrics], "ring_loss": ring_loss, "flash_loss": flash_loss}


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
        t_start = time.perf_counter()
        card = phase_device()
        fwd_err = phase_kernels()
        bwd_err = phase_bwd_kernels()
        k5_err = phase_k5()
        ring = phase_ring(card)
        conv_err = phase_conv1x1()
        run_root = os.path.join(REPO, "build")
        os.makedirs(run_root, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=run_root) as run_dir:
            serve_launches, serve = phase_slice(run_dir)
        with tempfile.TemporaryDirectory(dir=run_root) as run_dir:
            train_launches, train = phase_train(run_dir)
        with tempfile.TemporaryDirectory(dir=run_root) as run_dir:
            ring_launches, ring_train = phase_ring_train(run_dir)
        with tempfile.TemporaryDirectory(dir=run_root) as run_dir:
            resnet_launches, resnet = phase_resnet(run_dir)
        with tempfile.TemporaryDirectory(dir=run_root) as run_dir:
            resnet_ab = phase_resnet_pallas_ab(run_dir)
        times = phase_times(card)
        conv_times, conv_total = phase_conv1x1_times(card)
        log(f"[times] {card} | served requests: p50 {serve['p50_ms']:.2f} ms, p99 {serve['p99_ms']:.2f} ms "
            f"over {serve['n']} requests (client clock, HTTP included; p99 is the slowest of so few)")
        log(f"[times] {card} | training step (B=64, T=1024, bf16): median {train['step_ms']:.2f} ms, "
            f"{train['tokens_per_s']:.0f} tokens/s, peak memory {train['peak_gb']:.2f} GB")
        log(f"[times] {card} | ring training step (B={RING_SHAPE[0]}, T={RING_SHAPE[1]}, bf16, seq={RING_SHARDS} on "
            f"one card): median {ring_train['step_ms']:.2f} ms, {ring_train['tokens_per_s']:.0f} tokens/s, peak memory "
            f"{ring_train['peak_gb']:.2f} GB")
        busy = "not measured" if resnet["busy"] is None else f"{resnet['busy']:.4f}"
        log(f"[times] {card} | ResNet-50 training step (B=256, 224x224, bf16, PALLAS=1, through the entry): median "
            f"{resnet['step_ms']:.2f} ms, {resnet['images_per_s']:.0f} images/s, peak memory {resnet['peak_gb']:.2f} GB, "
            f"device busy share of the resumed epoch {busy}; on batches already on the card: PALLAS=1 "
            f"{resnet_ab['1']:.2f} ms, PALLAS=0 {resnet_ab['0']:.2f} ms")
        log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    except Exception:  # noqa: BLE001 — any failed phase fails the run
        traceback.print_exc()
        return 1
    kernels = []
    for name, kind, launch_key, replaces, err in (
        ("flash_fwd", "fwd", "fwd", ":81", fwd_err),
        ("flash_bwd_dq", "dq", "bwd_dq", ":135", bwd_err["dq"]),
        ("flash_bwd_dkv", "dkv", "bwd_dkv", ":174", bwd_err["dkv"]),
    ):
        r = times[kind]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"distributed_training_pytorch_tpu_torch/csrc/{'flash_fwd.cu' if kind == 'fwd' else 'flash_bwd.cu'}",
            "replaces": f"distributed_training_pytorch_tpu/ops/pallas.py{replaces}",
            "launches": train_launches[launch_key],
            "launches_by_path": {"train": train_launches[launch_key], "train_ring": ring_launches[launch_key],
                                 "train_resnet50": 0, "serve": serve_launches if kind == "fwd" else 0},
            "max_abs_err": err,
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "shape": r["shape"],
            "dtype": "bfloat16",
        })
    kernels.append({
        "name": "conv1x1_bn_act",
        "route": "cuda",
        "source": "distributed_training_pytorch_tpu_torch/csrc/conv1x1_bn_act.cu",
        "replaces": "distributed_training_pytorch_tpu/ops/pallas.py:550",
        "launches": resnet_launches,
        "launches_by_path": {"train_resnet50": resnet_launches, "train": 0, "train_ring": 0, "serve": 0},
        "max_abs_err": conv_err,
        # The nine launches of one ResNet-50 forward at batch 256, summed; per shape below.
        "ms": conv_total["ms"],
        "plain_ms": conv_total["plain_ms"],
        "bound_ms": conv_total["bound_ms"],
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in conv_times) else "operations",
        "library_ms": conv_total["library_ms"],
        "shapes": conv_times,
        "dtype": "bfloat16",
    })
    for kind, launch_key, replaces, source in (("fwd", "fwd", ":399", "flash_fwd.cu"),
                                               ("bwd", "bwd_dq", ":415", "flash_bwd.cu")):
        r = ring["k5"][kind]
        kernels.append({
            "name": f"flash_block_{kind}",
            "route": "cuda",
            # K5 is a wrapper (ops/flash_attention.py) over the hand-written K1 or K2 + K3.
            "source": f"distributed_training_pytorch_tpu_torch/csrc/{source}",
            "wrapper": f"distributed_training_pytorch_tpu_torch/ops/flash_attention.py::flash_block_{kind}",
            "replaces": f"distributed_training_pytorch_tpu/ops/pallas.py{replaces}",
            "launches": ring_launches[launch_key],
            "launches_by_path": {"train_ring": ring_launches[launch_key], "train": 0, "train_resnet50": 0, "serve": 0},
            "max_abs_err": k5_err[kind],
            # The 10 block launches of one causal ring layer (16 x 4096, 12 heads, 4 shards), summed.
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],  # SDPA, causal, over the whole T=4096
            "shape": r["shape"],
            "blocks": r["blocks"],
            "dtype": "bfloat16",
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
