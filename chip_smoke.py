#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``distributed_training_pytorch_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which fails the run (exit code 1, no final line) when it fails:

1. device: a CUDA card, its name and power limit (``nvidia-smi``), ``torch.version.cuda``,
   and a build of every kernel from the sources in this checkout, with ``-Xptxas -v``'s
   register, spill and shared-memory report (a spill in a 1x1-conv kernel fails the run);
   ``cuobjdump --dump-sass`` of the library must show ``HGMMA`` (wgmma) instructions in
   each of the tensor-core kernels (forward, dq, dk/dv, at D 64 and 128, and the fused
   1x1 conv's four column-tile widths);
2. kernel vs plain: flash-attention forward against its plain PyTorch version on the
   card, each case on the variant that ``kernel_variant`` names (``csrc/flash_fwd_wgmma.cu``
   for bf16 at D 64/128, ``csrc/flash_fwd.cu`` otherwise), over causal/non-causal,
   ``valid_len``, ragged T, Tq != Tk, T below one 64-row TMA box, D 8/64/128, f32 and bf16,
   and the served and training shapes;
3. backward kernels vs plain: the dq and dk/dv kernels against
   ``flash_attention_bwd_plain`` over the same kinds of cases, Tq != Tk with external
   lse/delta, and the training shape, each on the variant that ``kernel_variant`` names
   (``csrc/flash_bwd_wgmma.cu`` for bf16 at D 64/128, ``csrc/flash_bwd.cu`` otherwise); the
   wgmma pair on the q, k, v views of a fused qkv projection, read in place; then
   ``flash_attention``'s autograd path against autograd through the plain version;
4. serving: GPT-2-small at full width (bf16, seeded random weights) behind
   ``InferEngine`` + ``InferenceServer``, 16 ``/predict`` requests of 1024 tokens from 4
   concurrent clients; every answer 200, finite, and close to the plain-attention model's;
   the forward kernel's launch count over that run is 12 per forward, all on the wgmma
   variant;
5. training: the port's LM entry (``examples/train_lm.py``) on byte-level GPT-2-small at
   full width and depth, T=1024, global batch 64, bf16, on the synthetic byte stream: 2
   epochs, then a resume from ``last`` for a third; every loss finite, the last epoch's
   train loss below the first's, ``best``/``last`` valid, the resume continuing the step
   and epoch, and exactly 12 launches of each kernel per step (plus 12 forward launches
   per validation forward), every launch on the wgmma variant; the step time
   (median, CUDA events), tokens/s and peak memory;
6. times, with CUDA events: each kernel, its plain version, its bound, and the PyTorch
   call that computes the same function as a yardstick (``scaled_dot_product_attention``
   forward, and its backward as fwd+bwd minus fwd; the port never calls it), at the
   training shape and at B=8; and the served requests' p50/p99;
7. (A) the fused 1x1-conv kernel against its plain version on the card, each case on the
   variant that ``conv1x1_variant`` names (``csrc/conv1x1_wgmma.cu`` for bf16 with Cin and
   Cout multiples of 64, ``csrc/conv1x1_bn_act.cu`` otherwise): f32 (TF32 off) and bf16,
   bf16 -> f32, identity/relu/gelu epilogues, random scale and bias with zero scales, row
   counts off the tile (a prime near 1000, and below 64), Cin -> Cout from 24 -> 16 to
   768 -> 3072 (wgmma: Cin 64/128/256 by Cout 64/192/256/512), ResNet-50's nine shapes at
   batch 256 on the wgmma variant, stride-2 channels-last views read in place or copied;
   the backward's dz pass (``csrc/conv1x1_bwd_dz.cu``) bit-equal to its plain version;
   the weight gradient over ResNet-50's pixels against the f32 sums rounded once (F5);
   and the autograd backward against autograd through the plain version, the dz kernel
   launched on ResNet's route only;
8. (B) ResNet-50 training: the port's ImageNet entry (``examples/train_imagenet.py``) at
   224x224, 1000 classes, global batch 256, bf16 model with f32 params, ``PALLAS=1``, on a
   synthetic set capped to 3 steps an epoch: 2 epochs, then a resume from ``last`` for a
   third; every loss finite, the running statistics moved, the resume continuing the step
   and epoch, exactly 9 kernel launches per train step and per val forward, all on the
   wgmma variant, and 9 launches of the backward's dz pass per train step, and the
   trained model's logits finite and close to the same weights through cuDNN's 1x1
   convolutions; the step time (median, CUDA events), images/s, peak memory and the
   device's busy share of the resumed epoch; then the same steps timed with ``PALLAS=1``
   and ``PALLAS=0`` in turns;
9. times of the 1x1 kernel at ResNet-50's nine shapes: kernel, plain, bound, and the
   faster of ``torch.matmul`` and a channels-last 1x1 ``F.conv2d`` as the yardstick (the
   stride-2 shortcut also through a contiguous copy of its view); and of the backward's
   dz pass at the nine gradients: kernel, the three plain passes, bound, and one
   ``torch.mul`` into a bf16 ``out`` as the yardstick;
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
    blocks) per train step and per val forward, every launch on the wgmma variant;
    step time, tokens/s, peak memory;
13. (vgg) VGG16 on CIFAR-10 through the port's default entry (``examples/train_cifar10.py``)
    at its defaults but the lr (``VGG_ENV``): global batch 1024, a bf16 model with f32
    params (134,301,514), the synthetic set (no pickles are in the repository), the
    native crop/flip built with g++ (``data/native.py``; the phase fails unless it built)
    on 8 loader workers with uint8 batches normalised on the device, and ``device_prefetch``'s pinned side-stream copies:
    2 epochs, then a resume from ``last`` for a third; every loss finite, the train loss
    falling, the resume continuing the step and epoch, the train batches reaching the
    model as uint8, and no launch of any hand kernel in the phase (VGG16 runs none); the
    step time (median, CUDA events), images/s, peak memory, and the device's busy share
    of the resumed train epoch beside the parent's host path (no workers, a ``to_device``
    copy before each step): its first steps with the per-record Python transform, and the
    whole epoch in turns with the new path on one warm trainer, both with the native
    crop/flip. The ResNet phase (8) runs the same in-turns comparison;
14. (vit) ViT-B/16 through the ImageNet entry (``MODEL=vit_b16``, ``PALLAS`` unset: auto
    runs K1–K3 at T=197, non-causal): 224x224, 1000 classes, global batch 256, a bf16 model
    with f32 params, AdamW, the synthetic set capped to 3 steps an epoch: 2 epochs, then a
    resume from ``last`` for a third; every loss finite, the resume continuing the step and
    epoch, exactly 12 launches each of K1, K2, K3 a train step and 12 of K1 a val forward,
    all on the wgmma variant; the trained weights through ``PALLAS=0``
    (``dot_product_attention``) and through ``pad_seq_to=256`` (K1–K3 with 197 valid keys of
    256: logits and every parameter's gradient against the unpadded model); step time,
    images/s, peak memory, the saves' snapshot and flush times; the same steps with
    ``PALLAS`` unset and ``PALLAS=0`` in turns. Phases 2, 3 and 6 hold and time K1–K3 at its attention shape
    (``[256, 197, 12, 64]``, and 256 with 197 valid), on the q, k, v views of its fused qkv
    projection, with SDPA non-causal as the yardstick;
15. (convnext) ConvNeXt-L through the same entry (``MODEL=convnext_l``, ``PALLAS=1``: K4's
    gelu epilogue in every block's expand Dense): 21,841 classes, global batch 256 in 4
    micro-batches of 64 (``ACCUM=4``), otherwise as phase 14; exactly 36 K4 launches a
    micro-batch forward (6 on the wgmma variant, 30 on the CUDA cores), so 144 a train step
    and 36 a val forward, and no dz pass; the trained weights through ``PALLAS=0``; step
    time, images/s, peak memory, the saves' snapshot and flush times; ``PALLAS=1`` and
    ``PALLAS=0`` in turns.
    Phase 7 holds K4 at its four expand shapes with gelu (and one row fewer) and its autograd
    route against the plain version's; the last phase times K4 there beside ``F.linear``
    then ``F.gelu(approximate="tanh")``;
16. (digits) VGG16 on the digits corpus through ``examples/train_digits.py``'s ``main`` (the
    tree written from ``digits_8x8.npz``, f32, batch 128): 3 epochs, then a resumed fourth,
    each ending in ``eval.evaluate`` of ``best`` and ``last``; the split 1,438/359, every
    loss finite, the train CE below the first epoch's, top-1 and top-2 in [0, 1], no hand
    kernel; the step time and the busy share of the resumed epoch;
17. (records) ResNet18Slim on the digits packed into 4 + 2 record shards through
    ``examples/train_records.py``'s ``main`` (decoded on the codec-free route where the
    library has no libpng), as phase 16; then one epoch over a copy of the shards with one
    payload overwritten by garbage under ``skip_corrupt_records=True``: exactly 1 skipped;
18. (records_resnet50) ResNet-50 through the ImageNet entry on record shards of seeded JPEG
    images (baseline 4:2:0, quality 90, from the port's encoder) of ImageNet's usual sizes
    (``IMAGENET_RECORDS``/``VAL_RECORDS``, ``PALLAS=1``,
    batch 256, 3 steps an epoch, 2 epochs and a resumed third): 9 K4 launches a step and a
    val forward, all wgmma, 9 dz a step; the resumed epoch on records and on the synthetic
    set in turns on one trainer;
19. (fp16) the digits entry with ``DTYPE=fp16``: 2 epochs at a loss scale of 2^15, then a
    step forced to overflow (skipped, params and buffers bit-equal, the scale halved, one
    skip counted) and the scale and counter through a save and a restore;
20. (jpeg, run after phase 7) the port's own JPEG decoder on this machine's build of the
    native library: the committed fixtures (``tests/data/jpeg/``) bit-equal to what ``cv2``
    gave (their SHA-256 in ``manifest.json``), without and with the EXIF orientation; the
    decode's host ms for a 375x500 quality-90 4:2:0 image on one thread and the fused batch
    entry's images/s on 8 threads;
21. (lm_eval, run after phase 5 on its ``last`` checkpoint) LM evaluation and generation
    through ``examples/eval_lm.py``: a 2 MB corpus from ``examples/make_lm_corpus.py`` (its
    byte count and SHA-256: this machine has no jax, so its bytes differ from a host with
    it); ``evaluate`` at ``EVAL_BATCH=64``, T=1024 (the NLL finite, exactly 12 K1 launches a
    batch, all wgmma, no other kernel; the perplexity and window count); ``sample``, greedy
    and t=0.8, each with the prompt as its prefix; ``decode_benchmark`` at batches 1, 8, 32
    and 128 on the CUDA graph and the eager loop in turns (tok/s, tok/s a stream, new tok/s,
    ms a step), with no hand-kernel launch on the decode path, and the device operations of
    one eager decode step by the profiler; in f32 at full width with
    TF32 off, 64 greedy steps from 2 prompts: the graph's tokens equal the eager loop's and
    the full forward's argmax at each step; a hot swap: ``last`` served through
    ``InferEngine.restore_params`` behind the server's watcher, a new ``best`` committed,
    ``/predict`` answering under the new version with bodies equal to a fresh engine's on
    those weights, one ``hot_swap`` event; and K1 held and timed at eval_lm's default shape
    ``[64, 256, 12, 64]`` on the LM's qkv views beside SDPA.

22. (chained, run after phase 19) chained steps, one captured CUDA graph a window
    (``TrainEngine.train_steps_chained``): GPT-2-small (bf16, B=64, T=1024) 8 steps in
    windows of 4 against 8 eager steps from the same weights and batches, under
    deterministic algorithms (params and losses bit-equal), and the same in f32 with TF32
    off at 2 blocks (bit-equal); ms a step chained and eager in turns; K1–K3
    12 each a step in a profile of one replay; ResNet-50 with ``PALLAS=1`` chained, K4 and
    its dz pass 9 each a step in a profile of one replay; VGG16/CIFAR-10 through its entry
    (batch 1024) with ``chain_steps`` 2 and 1 in turns on one warm trainer: each epoch's
    busy share. A failed capture fails the phase;
23. (resilience) ``scripts/torch_chaos_soak.py`` on the card: the digits entry with
    ``CHAIN_STEPS=2`` and background saves, killed by a graceful SIGTERM, a SIGKILL
    mid-commit, a SIGKILL mid-window and a hung step past ``step_timeout``, each resumed
    from ``latest_valid`` with a valid checkpoint left; the final params bit-exact against
    an uninterrupted run; the async save's stall against the sync save's wall on
    GPT-2-small's state (below 0.25).

The vit and convnext phases (14, 15) save in the background (the ``Trainer``'s default
``async_checkpoint``): they print each save's snapshot time and the flushes that wait for
the commits.

The image-folder phase (``phase_folder``, run between 15 and 16: ``ExampleTrainer``'s
ten-step train chain, a resume and ``eval.evaluate``) reads PNG, BMP and JPEG files, the
JPEG ones from the port's encoder (4:2:0 at qualities 90 and 60, 4:4:4, grey, and one with
an EXIF orientation of 6) and decoded by the port's own decoder.

``launches_by_path`` in the kernels line has one key a path, ``eval_lm`` and ``decode``
included, for every kernel entry; ``train_lm_chained`` and ``train_resnet50_chained`` are
the launches in the profile of one replay (4 and 2 steps): the Python counters count a
graph's launches once, at its capture.

It prints a ``{"kernels": [...]}`` line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``. It exits non-zero without a card, and outside a
checkout of the repository.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import json
import os
import re
import shutil
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

# ViT-B/16 (BASELINE config 4) and ConvNeXt-L (config 5) through the ImageNet entry at
# 224x224, global batch 256 (the entry's default is 1024), ENTRY_STEPS steps an epoch of
# the synthetic set: 2 epochs, then a resume from last for a third.
ENTRY_STEPS = 3
ENTRY_EPOCHS = 2  # then one resumed epoch
VIT_BATCH = 256
VIT_ENV = {"MODEL": "vit_b16", "IMAGE_SIZE": "224", "BATCH": str(VIT_BATCH), "STEPS_PER_EPOCH": str(ENTRY_STEPS),
           "SHIP_UINT8": "1"}  # PALLAS unset: auto, the flash kernels on the card
VIT_SHAPE = (VIT_BATCH, 197, 12, 64)  # B, T, H, D of its attention: 196 patches and the class token
VIT_DEPTH = 12
VIT_PAD = 256  # pad_seq_to: 197 valid of 256
# Forward FLOPs of one 224x224 image (torch.utils.flop_counter on the port's models: GEMMs,
# convolutions and the attention products, 2 a multiply-add), three times that trained.
VIT_FLOP_PER_IMAGE = 3 * 35.127656448e9
CONVNEXT_BATCH, CONVNEXT_ACCUM = 256, 4  # 4 micro-batches of 64 a step (the recipe's ACCUM)
CONVNEXT_ENV = {"MODEL": "convnext_l", "IMAGE_SIZE": "224", "BATCH": str(CONVNEXT_BATCH),
                "STEPS_PER_EPOCH": str(ENTRY_STEPS), "SHIP_UINT8": "1", "PALLAS": "1"}
CONVNEXT_FLOP_PER_IMAGE = 3 * 68.786890752e9  # with the 21,841-class head
# ConvNeXt-L's expand Dense + GELU (K4 with the gelu epilogue, Cin -> 4 Cin) at micro-batch
# 64: (stage, rows, Cin, Cout, blocks). Stages 1-2 take the wgmma variant; 3-4 exceed
# WGMMA_MAX_CIN and take the CUDA cores.
CONVNEXT_K4_SHAPES = [
    ("stage1", 64 * 56 * 56, 192, 768, 3),
    ("stage2", 64 * 28 * 28, 384, 1536, 3),
    ("stage3", 64 * 14 * 14, 768, 3072, 27),
    ("stage4", 64 * 7 * 7, 1536, 6144, 3),
]
CONVNEXT_BLOCKS = sum(s[4] for s in CONVNEXT_K4_SHAPES)  # 36 K4 launches a forward
CONVNEXT_WGMMA_BLOCKS = sum(s[4] for s in CONVNEXT_K4_SHAPES if s[2] <= 512)  # 6 of them on wgmma


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
        "flash_fwd_wgmma_kernel": lib.dtp_flash_fwd_wgmma_smem_bytes,
        "flash_bwd_dq_kernel": lib.dtp_flash_bwd_dq_smem_bytes,
        "flash_bwd_dkv_kernel": lib.dtp_flash_bwd_dkv_smem_bytes,
        "flash_bwd_dq_wgmma_kernel": lib.dtp_flash_bwd_dq_wgmma_smem_bytes,
        "flash_bwd_dkv_wgmma_kernel": lib.dtp_flash_bwd_dkv_wgmma_smem_bytes,
    }
    kernel = ""
    injected = {}
    for line in _build.build_log.splitlines():
        entry = re.search(
            r"Compiling entry function '\S*?(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel)I(f|13__nv_bfloat16)Li(\d+)E", line
        )
        wgmma = re.search(r"Compiling entry function '\S*?(flash_(?:fwd|bwd_dq|bwd_dkv)_wgmma_kernel)ILi(\d+)E", line)
        conv = re.search(
            r"Compiling entry function '\S*?(conv1x1_bn_act|conv1x1_bwd_dz)_kernelI(f|13__nv_bfloat16)(f|13__nv_bfloat16|S\d*_)"
            r"Lb([01])E", line
        )
        conv_wgmma = re.search(r"Compiling entry function '\S*?conv1x1_bn_act_wgmma_kernelILi(\d+)E", line)
        if conv:
            names = {"f": "float32", "13__nv_bfloat16": "bfloat16"}
            out_type = names.get(conv.group(3), names[conv.group(2)])  # S<n>_: the input type again
            kernel = (f"{conv.group(1)}_kernel<{names[conv.group(2)]} -> {out_type}, "
                      f"16-byte {'loads' if conv.group(1) == 'conv1x1_bn_act' else 'vectors'}={conv.group(4) == '1'}>")
        elif conv_wgmma:
            kernel = f"conv1x1_bn_act_wgmma_kernel<NR={conv_wgmma.group(1)}> ({64 * int(conv_wgmma.group(1))} output channels a block)"
        elif entry:
            dtype = "float32" if entry.group(2) == "f" else "bfloat16"
            d = int(entry.group(3))
            kernel = (f"{entry.group(1)}<{dtype}, D={d}> "
                      f"(dynamic smem {smem[entry.group(1)](d)} B/block)")
        elif wgmma:
            d = int(wgmma.group(2))
            kernel = f"{wgmma.group(1)}<bfloat16, D={d}> (dynamic smem {smem[wgmma.group(1)](d)} B/block)"
        elif "C7519" in line:  # ptxas placing a warpgroup.arrive before a wgmma: counted by kernel below
            named = re.search(r"((?:conv1x1_bn_act|flash_(?:fwd|bwd_dq|bwd_dkv))_wgmma_kernel)I", line)
            key = named.group(1) if named else "other"
            injected[key] = injected.get(key, 0) + 1
        elif "Used" in line and "registers" in line or "spill stores" in line:
            report = re.sub(r"^ptxas info\s*:\s*", "", line.strip())
            log(f"[device] {kernel}: {report}")
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if kernel.startswith("conv1x1_") and spills and spills.groups() != ("0", "0"):
                raise RuntimeError(f"{kernel} spills registers: {report}")
        elif "warning" in line.lower():  # e.g. ptxas serialising wgmma
            log(f"[device] {line.strip()}")
    if injected:
        log(f"[device] ptxas notes C7519 (a warpgroup.arrive it inserted before a wgmma), by kernel: {injected}")
    for name, n in sass_hgmma_counts(_build.LIBRARY).items():
        log(f"[device] SASS of {name}: {n} HGMMA instructions")
    for name, cin, cout, _ in RESNET_K4_SHAPES:
        log(f"[device] conv1x1_bn_act_wgmma_kernel at {name} ({cin} -> {cout}): dynamic smem "
            f"{lib.dtp_conv1x1_bn_act_wgmma_smem_bytes(cin, cout)} B/block")
    return card


WGMMA_KERNELS = [f"flash_{k}_wgmma_kernel<D={d}>" for k in ("fwd", "bwd_dq", "bwd_dkv") for d in (64, 128)] + [
    f"conv1x1_bn_act_wgmma_kernel<NR={nr}>" for nr in (1, 2, 3, 4)
]


def sass_hgmma_counts(library) -> dict:
    """The number of ``HGMMA`` (wgmma) instructions in the SASS of each tensor-core
    kernel of the built library, from ``cuobjdump --dump-sass``; raises when the
    tool is missing or a kernel has none, since then nothing shows that the products run on
    the tensor cores."""
    tool = shutil.which("cuobjdump") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        raise RuntimeError("cuobjdump not found: the HGMMA check of the wgmma kernels cannot run")
    sass = subprocess.run([tool, "--dump-sass", str(library)], capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts = {}
    for chunk in re.split(r"\n\s*Function : ", sass)[1:]:
        head = chunk.split("\n", 1)[0]
        found = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_wgmma_kernel)ILi(\d+)E", head)
        conv = re.search(r"conv1x1_bn_act_wgmma_kernelILi(\d+)E", head)
        if found:
            counts[f"{found.group(1)}<D={found.group(2)}>"] = chunk.count("HGMMA")
        elif conv:
            counts[f"conv1x1_bn_act_wgmma_kernel<NR={conv.group(1)}>"] = chunk.count("HGMMA")
    missing = [name for name in WGMMA_KERNELS if not counts.get(name)]
    if missing:
        raise RuntimeError(f"no HGMMA instruction in the SASS of {missing} (found {counts})")
    return counts


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
    # The wgmma variant (bf16, D 64 and 128): ragged causal T, valid_len, Tq != Tk causal
    # and not, T below one 64-row TMA box, both below a box with B = H = 1.
    (2, 1000, 1000, 2, 64, True, None, "bfloat16"),
    (2, 1000, 1000, 2, 128, True, None, "bfloat16"),
    (2, 197, 197, 2, 128, False, 100, "bfloat16"),  # valid_len, D=128
    (1, 300, 130, 2, 64, True, None, "bfloat16"),  # Tq > Tk
    (1, 300, 130, 2, 128, False, None, "bfloat16"),
    (1, 130, 300, 2, 128, True, None, "bfloat16"),  # Tq < Tk
    (1, 96, 1000, 2, 64, False, None, "bfloat16"),
    (3, 40, 40, 2, 64, True, None, "bfloat16"),  # T below one box
    (1, 17, 50, 1, 128, False, None, "bfloat16"),  # both below a box, B = H = 1
    (*VIT_SHAPE[:2], VIT_SHAPE[1], *VIT_SHAPE[2:], False, None, "bfloat16"),  # ViT-B/16: a 5-row tail
    (VIT_BATCH, VIT_PAD, VIT_PAD, 12, 64, False, VIT_SHAPE[1], "bfloat16"),  # ViT-B/16 under pad_seq_to=256
]
# f32: kernel and plain both sum in f32, in other orders over up to 1024 keys.
# bf16: the same f32 softmax statistics on the same bf16 inputs, p rounded to bf16 before
# P V on each side (against the running max in the kernels, the final one in the plain
# version, so it may round one ulp apart), then o rounded to bf16 on each side, which may
# land one bf16 ulp (2^-7 relative) apart. lse is f32 on both sides.
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)}
LSE_TOL = (1e-4, 1e-5)


def phase_kernels():
    import torch

    from distributed_training_pytorch_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1234)
    train_err = vit_err = 0.0
    for b, tq, tk, h, d, causal, valid_len, dtype_name in KERNEL_CASES:
        dtype = getattr(torch, dtype_name)
        q = torch.randn(b, tq, h, d, device="cuda", generator=gen).to(dtype)
        k = torch.randn(b, tk, h, d, device="cuda", generator=gen).to(dtype)
        v = torch.randn(b, tk, h, d, device="cuda", generator=gen).to(dtype)
        variant = fa.kernel_variant(dtype, d)
        before, before_variant = fa.launches["fwd"], fa.launches_by_variant[("fwd", variant)]
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, valid_len=valid_len)
        torch.cuda.synchronize()
        if (fa.launches["fwd"], fa.launches_by_variant[("fwd", variant)]) != (before + 1, before_variant + 1):
            raise RuntimeError(f"the kernel wrapper did not launch its {variant} kernel")
        o_ref, lse_ref = fa.flash_attention_plain(q, k, v, causal=causal, valid_len=valid_len)
        err = (o.float() - o_ref.float()).abs().max().item()
        lse_err = (lse - lse_ref).abs().max().item()
        atol, rtol = TOL[dtype_name]
        ok_o = torch.allclose(o.float(), o_ref.float(), atol=atol, rtol=rtol)
        ok_lse = torch.allclose(lse, lse_ref, atol=LSE_TOL[0], rtol=LSE_TOL[1])
        finite = bool(torch.isfinite(o.float()).all() and torch.isfinite(lse).all())
        log(f"[kernel] B={b} Tq={tq} Tk={tk} H={h} D={d} causal={causal} valid_len={valid_len} "
            f"{dtype_name} ({variant}): max|o-plain|={err:.3e} (atol {atol}, rtol {rtol}) "
            f"max|lse-plain|={lse_err:.3e} -> {'ok' if ok_o and ok_lse and finite else 'FAIL'}")
        if not (ok_o and ok_lse and finite):
            raise RuntimeError("flash kernel disagrees with its plain version")
        if (b, tq, h, d, causal, dtype_name) == (*TRAIN_SHAPE[:2], *TRAIN_SHAPE[2:], True, "bfloat16"):
            train_err = err
        if (b, tq, h, d, causal, valid_len) == (*VIT_SHAPE[:2], *VIT_SHAPE[2:], False, None):
            vit_err = err
        del q, k, v, o, lse, o_ref, lse_ref
    torch.cuda.empty_cache()

    # The wgmma forward on q, k, v views of a fused [B, T, 3, H, D] projection, as the LM
    # makes them: TMA reads them in place (t stride 3 H D), and o equals contiguous copies'.
    for d in (64, 128):
        qkv = torch.randn(2, 1000, 3, 4, d, device="cuda", generator=gen).to(torch.bfloat16)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        before = fa.launches_by_variant[("fwd", "wgmma")]
        o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
        o_copy, lse_copy = fa.flash_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
        torch.cuda.synchronize()
        in_place = all(fa.tma_operand(x) is x for x in (q, k, v))
        ran = fa.launches_by_variant[("fwd", "wgmma")] == before + 2
        same = torch.equal(o, o_copy) and torch.equal(lse, lse_copy)
        o_ref, lse_ref = fa.flash_attention_plain(q, k, v, causal=True)
        atol, rtol = TOL["bfloat16"]
        ok = (in_place and ran and same and torch.allclose(o.float(), o_ref.float(), atol=atol, rtol=rtol)
              and torch.allclose(lse, lse_ref, atol=LSE_TOL[0], rtol=LSE_TOL[1]))
        log(f"[kernel] qkv views B=2 T=1000 H=4 D={d} causal bfloat16 (wgmma, read in place: {in_place}, equal to "
            f"contiguous copies: {same}): max|o-plain|={(o.float() - o_ref.float()).abs().max().item():.3e} "
            f"-> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError("the wgmma forward disagrees on strided qkv views, or copied or skipped them")
        del qkv, q, k, v, o, lse, o_copy, lse_copy, o_ref, lse_ref

    # ViT-B/16's attention as its model makes it: the q, k, v views of a fused [B, T, 3, 12,
    # 64] projection, non-causal, at T=197 and at 256 with 197 valid (pad_seq_to=256).
    for t, valid_len in ((VIT_SHAPE[1], None), (VIT_PAD, VIT_SHAPE[1])):
        qkv = torch.randn(VIT_BATCH, t, 3, 12, 64, device="cuda", generator=gen).to(torch.bfloat16)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        before = fa.launches_by_variant[("fwd", "wgmma")]
        o, lse = fa.flash_attention_fwd(q, k, v, valid_len=valid_len)
        torch.cuda.synchronize()
        in_place = all(fa.tma_operand(x) is x for x in (q, k, v))
        ran = fa.launches_by_variant[("fwd", "wgmma")] == before + 1
        o_ref, lse_ref = fa.flash_attention_plain(q, k, v, valid_len=valid_len)
        atol, rtol = TOL["bfloat16"]
        ok = (in_place and ran and torch.allclose(o.float(), o_ref.float(), atol=atol, rtol=rtol)
              and torch.allclose(lse, lse_ref, atol=LSE_TOL[0], rtol=LSE_TOL[1]))
        log(f"[kernel] ViT-B/16 qkv views B={VIT_BATCH} T={t} H=12 D=64 valid_len={valid_len} bfloat16 (wgmma, read in "
            f"place: {in_place}): max|o-plain|={(o.float() - o_ref.float()).abs().max().item():.3e} "
            f"-> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError("the wgmma forward disagrees on ViT's qkv views, or copied or skipped them")
        del qkv, q, k, v, o, lse, o_ref, lse_ref
    torch.cuda.empty_cache()
    return train_err, vit_err


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
        launches, wgmma_launches = fa.launches["fwd"], fa.launches_by_variant[("fwd", "wgmma")]
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
        f"kernel launches {launches} (12 per forward: {12 * forwards}), {wgmma_launches} on the wgmma variant")
    if forwards < 1 or launches != DEPTH * forwards:
        raise RuntimeError(f"expected {DEPTH} kernel launches per forward, got {launches} over {forwards}")
    if wgmma_launches != launches:
        raise RuntimeError(f"expected all {launches} forward launches on the wgmma variant, got {wgmma_launches}")
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
    # Both models compute in bf16 but round at other places: the kernel keeps the logits
    # and the softmax statistics in f32 and rounds p once, the plain path rounds logits and
    # weights to bf16;
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
    # The wgmma variant (bf16, D 64 and 128): ragged causal T, valid_len, Tq != Tk with
    # external lse/delta.
    (2, 1000, 1000, 2, 64, True, None, "bfloat16", False),
    (2, 1000, 1000, 2, 128, True, None, "bfloat16", False),
    (2, 197, 197, 2, 128, False, 100, "bfloat16", False),  # valid_len, D=128
    (1, 300, 130, 2, 64, True, None, "bfloat16", True),  # Tq > Tk
    (1, 130, 300, 2, 128, False, None, "bfloat16", True),  # Tq < Tk
    (1, 96, 1000, 2, 64, True, None, "bfloat16", True),  # Tq < Tk, causal
    (3, 40, 40, 2, 64, True, None, "bfloat16", False),  # T below one 64-row TMA box
    (1, 17, 50, 1, 128, False, None, "bfloat16", True),  # both below a box, B = H = 1
    (*TRAIN_SHAPE[:2], TRAIN_SHAPE[1], *TRAIN_SHAPE[2:], True, None, "bfloat16", False),  # training
    (*VIT_SHAPE[:2], VIT_SHAPE[1], *VIT_SHAPE[2:], False, None, "bfloat16", False),  # ViT-B/16
    (VIT_BATCH, VIT_PAD, VIT_PAD, 12, 64, False, VIT_SHAPE[1], "bfloat16", False),  # ViT-B/16, padded
]
# f32: kernel and plain both sum in f32, in other orders, over up to 1000 keys or queries.
# bf16: the same f32 arithmetic on the same bf16 inputs, but ds and p are rounded to bf16
# before their products on each side and may round one ulp (2^-7 relative) apart, and each
# grad is rounded to bf16 at the end: held to 2e-2 of the grad's largest magnitude.
BWD_ATOL_F32 = 2e-4
BWD_REL_BF16 = 2e-2
# What the main path's K1, K2 and K3 are (bf16, D=64: the wgmma variant); the f32 and
# small-D variant is csrc/flash_fwd.cu / csrc/flash_bwd.cu on the CUDA cores.
DESIGN = {
    "conv1x1_bn_act": "wgmma m64n64k16 (both operands in shared memory), one commit group per 64-channel chunk so "
                      "a chunk's epilogue overlaps the next chunks' products, the weight's column tile of up to "
                      "256 channels resident, x row tiles by TMA (128B swizzle) through a 2-4 stage mbarrier ring, "
                      "a persistent grid, the affine and act on the accumulator fragment, 16-byte stores from a "
                      "swizzled staging tile; the stride-2 shortcut read in place as whole image rows",
    "conv1x1_bwd_dz": "one elementwise pass: g (and y for relu) read once in 16-byte vectors, dz written once; "
                      "the elementwise part of _conv1x1_bwd (pallas.py:629), whose dots stay torch.matmul",
    "fwd": "wgmma m64n64k16 (S from shared memory; P V with P from registers, bf16), TMA 128B-swizzled "
           "K/V tiles in a 2-stage mbarrier ring, Q resident, online softmax on the accumulator fragment; "
           "one warpgroup per 64 query rows",
    "dq": "wgmma m64n64k16 (S, dP from shared memory; dS K with dS from registers), TMA 128B-swizzled "
          "K/V tiles in a 2-stage mbarrier ring, Q/dO resident; one warpgroup per 64 query rows",
    "dkv": "wgmma m64n64k16 (S^T, dP^T from shared memory; P^T dO and dS^T Q from registers), TMA "
           "128B-swizzled Q/dO tiles in a 2-stage mbarrier ring, K/V resident; one warpgroup per 64 key rows",
}


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
    train_err, vit_err = {}, {}
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
        before, before_variant = dict(fa.launches), dict(fa.launches_by_variant)
        grads = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, valid_len=valid_len, delta=delta)
        torch.cuda.synchronize()
        if (fa.launches["bwd_dq"], fa.launches["bwd_dkv"]) != (before["bwd_dq"] + 1, before["bwd_dkv"] + 1):
            raise RuntimeError("the backward wrappers did not launch their kernels")
        variant = fa.kernel_variant(dtype, d)
        if any(fa.launches_by_variant[(name, variant)] != before_variant[(name, variant)] + 1
               for name in ("bwd_dq", "bwd_dkv")):
            raise RuntimeError(f"the backward did not run on the {variant} variant")
        refs = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal, valid_len=valid_len, delta=delta)
        results = [_grad_err(g, r) for g, r in zip(grads, refs, strict=True)]
        ok = all(r[2] for r in results)
        errs = " ".join(f"d{n}={e:.3e}/{bd:.1e}" for n, (e, bd, _) in zip("qkv", results, strict=True))
        log(f"[bwd] B={b} Tq={tq} Tk={tk} H={h} D={d} causal={causal} valid_len={valid_len} "
            f"external={external} {dtype_name} ({variant}): max|grad-plain|/bound {errs} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError("flash backward kernels disagree with their plain version")
        if (b, tq, h, d, causal, dtype_name) == (*TRAIN_SHAPE[:2], *TRAIN_SHAPE[2:], True, "bfloat16"):
            train_err = {"dq": results[0][0], "dkv": max(results[1][0], results[2][0])}
        if (b, tq, h, d, causal, valid_len) == (*VIT_SHAPE[:2], *VIT_SHAPE[2:], False, None):
            vit_err = {"dq": results[0][0], "dkv": max(results[1][0], results[2][0])}
        del q, k, v, do, o, lse, grads, refs
    torch.cuda.empty_cache()

    # The wgmma pair on q, k, v views of a fused [B, T, 3, H, D] projection, as the LM makes
    # them: TMA reads them in place (t stride 3 H D), no copy.
    for d in (64, 128):
        qkv = torch.randn(2, 1000, 3, 4, d, device="cuda", generator=gen).to(torch.bfloat16)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        do = torch.randn(2, 1000, 4, d, device="cuda", generator=gen).to(torch.bfloat16)
        o, lse = fa.flash_attention_plain(q, k, v, causal=True)
        before = dict(fa.launches_by_variant)
        grads = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
        torch.cuda.synchronize()
        in_place = all(fa.tma_operand(x) is x for x in (q, k, v))
        ran = all(fa.launches_by_variant[(n, "wgmma")] == before[(n, "wgmma")] + 1 for n in ("bwd_dq", "bwd_dkv"))
        refs = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True)
        results = [_grad_err(g, r) for g, r in zip(grads, refs, strict=True)]
        ok = in_place and ran and all(r[2] for r in results)
        errs = " ".join(f"d{n}={e:.3e}/{bd:.1e}" for n, (e, bd, _) in zip("qkv", results, strict=True))
        log(f"[bwd] qkv views B=2 T=1000 H=4 D={d} causal bfloat16 (wgmma, read in place: {in_place}): "
            f"max|grad-plain|/bound {errs} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError("the wgmma backward disagrees on strided qkv views, or copied or skipped them")
        del qkv, q, k, v, do, o, lse, grads, refs

    # The same at ViT-B/16's attention, non-causal: T=197, and 256 with 197 valid.
    for t, valid_len in ((VIT_SHAPE[1], None), (VIT_PAD, VIT_SHAPE[1])):
        qkv = torch.randn(VIT_BATCH, t, 3, 12, 64, device="cuda", generator=gen).to(torch.bfloat16)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        do = torch.randn(VIT_BATCH, t, 12, 64, device="cuda", generator=gen).to(torch.bfloat16)
        o, lse = fa.flash_attention_plain(q, k, v, valid_len=valid_len)
        before = dict(fa.launches_by_variant)
        grads = fa.flash_attention_bwd(q, k, v, o, lse, do, valid_len=valid_len)
        torch.cuda.synchronize()
        in_place = all(fa.tma_operand(x) is x for x in (q, k, v))
        ran = all(fa.launches_by_variant[(n, "wgmma")] == before[(n, "wgmma")] + 1 for n in ("bwd_dq", "bwd_dkv"))
        refs = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, valid_len=valid_len)
        results = [_grad_err(g, r) for g, r in zip(grads, refs, strict=True)]
        ok = in_place and ran and all(r[2] for r in results)
        errs = " ".join(f"d{n}={e:.3e}/{bd:.1e}" for n, (e, bd, _) in zip("qkv", results, strict=True))
        log(f"[bwd] ViT-B/16 qkv views B={VIT_BATCH} T={t} H=12 D=64 valid_len={valid_len} bfloat16 (wgmma, read in "
            f"place: {in_place}): max|grad-plain|/bound {errs} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError("the wgmma backward disagrees on ViT's qkv views, or copied or skipped them")
        del qkv, q, k, v, do, o, lse, grads, refs
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
    return train_err, vit_err


def _instrument(trainer, step_ms, counts, epoch_metrics, val_metrics):
    """Wrap a trainer's hooks: CUDA events around each train step (into ``step_ms``), the
    host's time to issue each step (into ``counts["host_ms"]``), counts of train steps and
    validation forwards, and each epoch's train and val metrics."""
    import torch

    train_step, validate_step = trainer.train_step, trainer.validate_step
    train_epoch, validate = trainer.train_epoch, trainer.validate

    def timed_step(state, batch):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = train_step(state, batch)
        end.record()
        counts.setdefault("host_ms", []).append((time.perf_counter() - t0) * 1e3)
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


def _check_wgmma_launches(launches, by_variant, tag):
    """Every forward and backward launch of a training phase ran the wgmma variant (bf16,
    D=64)."""
    log(f"{tag} launches by variant {({f'{n}/{v}': c for (n, v), c in by_variant.items()})}")
    for name in ("fwd", "bwd_dq", "bwd_dkv"):
        if by_variant[(name, "wgmma")] != launches[name] or by_variant[(name, "cuda_core")] != 0:
            raise RuntimeError(f"expected all {launches[name]} {name} launches on the wgmma variant, got {by_variant}")


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
        launches, by_variant = dict(fa.launches), dict(fa.launches_by_variant)
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
    _check_wgmma_launches(launches, by_variant, "[train]")
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


def _attention_times(card, b, t, h, d, causal, gen, label=""):
    """K1, K2 and K3 at one [B, T, H, D] bf16 shape with CUDA events: kernel, plain version,
    bound, and SDPA as the yardstick (its backward as fwd+bwd minus fwd); the backward is
    timed for B > 1 only."""
    import torch
    import torch.nn.functional as F

    from distributed_training_pytorch_tpu_torch.ops import flash_attention as fa

    q, k, v, do = (torch.randn(b, t, h, d, device="cuda", generator=gen).to(torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal))
    row = {}
    if b != 1:
        lq, lk, lv = (x.detach().requires_grad_() for x in (qt, kt, vt))

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal)
            torch.autograd.grad(out, (lq, lk, lv), dot)

        def sdpa_fwd_grad():
            F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal)

        sdpa_bwd = time_ms(sdpa_fwd_bwd) - time_ms(sdpa_fwd_grad)
        plain_bwd = time_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal, delta=delta),
                            iters=5)
        row["dq"] = {
            "ms": time_ms(lambda: fa.launch_bwd_dq(q, k, v, do, lse, delta, causal=causal, seq_len=t)),
            "plain_ms": plain_bwd, "library_ms": sdpa_bwd,
        }
        row["dkv"] = {
            "ms": time_ms(lambda: fa.launch_bwd_dkv(q, k, v, do, lse, delta, causal=causal, seq_len=t)),
            "plain_ms": plain_bwd, "library_ms": sdpa_bwd,
        }
    row["fwd"] = {
        "ms": time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=causal)),
        "plain_ms": time_ms(lambda: fa.flash_attention_plain(q, k, v, causal=causal), iters=5),
        "library_ms": sdpa_fwd,
    }
    for kind, r in row.items():
        bound_ms, bound_by, flops, nbytes = attention_bound(b, t, t, h, d, causal, "bfloat16", 2, kind=kind)
        r.update(bound_ms=bound_ms, bound_by=bound_by, shape=[b, t, h, d], causal=causal)
        library = "sdpa backward (dq+dk+dv; fwd+bwd minus fwd)" if kind != "fwd" else "sdpa forward"
        plain = "plain backward (dq+dk+dv)" if kind != "fwd" else "plain forward"
        log(f"[times] {card} | {label}flash_{kind if kind == 'fwd' else 'bwd_' + kind} B={b} T={t} H={h} D={d} "
            f"bf16 {'causal' if causal else 'non-causal'}: kernel {r['ms']:.4f} ms, {plain} {r['plain_ms']:.4f} ms, "
            f"{library} {r['library_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; {flops / 1e9:.2f} GFLOP, "
            f"{nbytes / 1e6:.2f} MB), {bound_ms / r['ms']:.4f} of the bound")
    del q, k, v, do, o, lse, delta, qt, kt, vt, dot
    torch.cuda.empty_cache()
    return row


def phase_times(card: str):
    """Kernel, plain and library times with CUDA events, and each kernel's bound, at the
    LM's training shape and the served/B=8 shapes (causal), and at ViT-B/16's (non-causal);
    returns the LM training shape's rows and ViT's."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(99)
    rows = {shape: _attention_times(card, *shape, True, gen) for shape in [TRAIN_SHAPE] + SERVED_SHAPES[::-1]}
    return rows[TRAIN_SHAPE], _attention_times(card, *VIT_SHAPE, False, gen, "ViT-B/16 ")


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
# The wgmma variant (bf16, 64-channel multiples): ragged N (a prime near 1000, and below one
# 64-row tile), Cin 64/128/256 by Cout 64/192/256/512, every epilogue, scales with zeros.
CONV1X1_WGMMA_CASES = [
    (997 if i % 2 else 37, cin, cout, (None, "relu", "gelu")[i % 3], "bfloat16")
    for i, (cin, cout) in enumerate((cin, cout) for cin in (64, 128, 256) for cout in (64, 192, 256, 512))
]
# The backward's dz pass against its plain version, bit for bit: (rows, Cout, g dtype, dz
# dtype, act); Cout 10 takes the element-at-a-time path.
CONV1X1_DZ_CASES = [
    (802816, 256, "bfloat16", "bfloat16", None),
    (802816, 64, "bfloat16", "bfloat16", "relu"),
    (997, 10, "bfloat16", "bfloat16", "relu"),
    (6275, 64, "float32", "bfloat16", "relu"),
    (6275, 96, "float32", "float32", None),
]
# F5: dw and dx over ResNet-50's 802,816 pixels (256 -> 64) against the f32 sums rounded
# once; f32 sums in other orders may round an element one ulp apart.
CONV1X1_DW_DIFFER_MAX = 0.05


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
    """Phase A: K4 and the backward's dz pass against their plain versions on the card;
    returns K4's largest error over ResNet-50's nine bf16 shapes at batch 256, the dz
    pass's largest error over its cases (0 when bit-equal), and K4's largest error over
    ConvNeXt-L's four expand shapes with gelu."""
    import torch

    from distributed_training_pytorch_tpu_torch.ops import conv1x1 as k4

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(2468)

    def check(label, x, w, scale, bias, act, out_dtype=None):
        variant = k4.conv1x1_variant(x, w.shape[0], out_dtype)
        before = (k4.launches["conv1x1_bn_act"], k4.launches_by_variant[("conv1x1_bn_act", variant)])
        y = k4.conv1x1_bn_act(x, w, scale, bias, act=act, out_dtype=out_dtype)
        torch.cuda.synchronize()
        if (k4.launches["conv1x1_bn_act"], k4.launches_by_variant[("conv1x1_bn_act", variant)]) != (
                before[0] + 1, before[1] + 1):
            raise RuntimeError(f"the conv1x1 wrapper did not launch its {variant} kernel")
        ref = k4.conv1x1_bn_act_plain(x, w, scale, bias, act=act, out_dtype=out_dtype)
        err, bound = _err_bound(y, ref, CONV1X1_ATOL_F32)
        ok = err <= bound and bool(torch.isfinite(y.float()).all()) and y.shape == ref.shape and y.dtype == ref.dtype
        log(f"[conv1x1] {label} [{variant}]: max|y-plain|={err:.3e} (bound {bound:.1e}) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError("conv1x1 kernel disagrees with its plain version")
        return err

    for rows, cin, cout, act, dtype_name in CONV1X1_CASES + CONV1X1_WGMMA_CASES:
        x, w, scale, bias = _conv1x1_inputs(gen, rows, cin, cout, getattr(torch, dtype_name))
        check(f"N={rows} {cin}->{cout} act={act} {dtype_name}", x, w, scale, bias, act)
    x, w, scale, bias = _conv1x1_inputs(gen, 997, 64, 256, torch.bfloat16)
    check("N=997 64->256 act=gelu bfloat16 -> float32", x, w, scale, bias, "gelu", torch.float32)
    # Stride-2 views of channels-last activations: read in place where (b, h) flatten (an
    # even H), copied first where they do not, or where an image row is wider than a box.
    for batch, size in ((3, 56), (3, 57), (2, 140)):
        full = torch.randn(batch, 64, size, size, device="cuda", generator=gen).to(torch.bfloat16)
        x = full.contiguous(memory_format=torch.channels_last)[:, :, ::2, ::2].permute(0, 2, 3, 1)
        _, w, scale, bias = _conv1x1_inputs(gen, 1, 64, 256, torch.bfloat16)
        how = "in place" if k4.tma_rows(x) is not None else "copied"
        check(f"stride-2 view [{batch}, {x.shape[1]}, {x.shape[2]}, 64] ({how}) -> 256 act=relu", x, w, scale, bias, "relu")

    # ResNet-50's nine shapes at batch 256, identity epilogue, on channels-last NHWC views,
    # each on the wgmma variant: the stride-2 shortcut reads x[:, :, ::2, ::2] of its input in
    # place, as whole image rows.
    worst = 0.0
    for name, cin, cout, stride in RESNET_K4_SHAPES:
        full = torch.randn(RESNET_BATCH, cin, 56, 56, device="cuda", generator=gen).to(torch.bfloat16)
        full = full.contiguous(memory_format=torch.channels_last)
        x = full[:, :, ::stride, ::stride].permute(0, 2, 3, 1)
        w = (torch.randn(cout, cin, device="cuda", generator=gen) * cin**-0.5).to(torch.bfloat16)
        ones, zeros = torch.ones(cout, device="cuda"), torch.zeros(cout, device="cuda")
        geometry = k4.tma_rows(x)
        if k4.conv1x1_variant(x, cout) != "wgmma" or geometry is None:
            raise RuntimeError(f"resnet50 {name} would not be read in place by the wgmma variant")
        label = f"resnet50 {name} [{RESNET_BATCH}, {56 // stride}, {56 // stride}, {cin}] -> {cout} bf16"
        label += f" (TMA rows {geometry})" if stride > 1 else ""
        worst = max(worst, check(label, x, w, ones, zeros, None))
        del full, x
        torch.cuda.empty_cache()

    # The backward's dz pass: bit-equal to its plain version.
    dz_worst = 0.0
    for rows, cout, g_name, dz_name, act in CONV1X1_DZ_CASES:
        g_dtype, dz_dtype = getattr(torch, g_name), getattr(torch, dz_name)
        g = torch.randn(rows, cout, device="cuda", generator=gen).to(g_dtype)
        y = torch.randn(rows, cout, device="cuda", generator=gen).to(g_dtype)
        scale = torch.rand(cout, device="cuda", generator=gen) + 0.5
        scale[::3] = 0.0
        before = k4.launches["conv1x1_bwd_dz"]
        dz = k4.conv1x1_bwd_dz(g, y, scale, act=act, out_dtype=dz_dtype)
        torch.cuda.synchronize()
        ref = k4.conv1x1_bwd_dz_plain(g, y, scale, act=act, out_dtype=dz_dtype)
        bits = torch.int16 if dz_dtype == torch.bfloat16 else torch.int32
        ok = k4.launches["conv1x1_bwd_dz"] == before + 1 and torch.equal(dz.view(bits), ref.view(bits))
        dz_worst = max(dz_worst, (dz.float() - ref.float()).abs().max().item())
        log(f"[conv1x1] bwd dz [{rows}, {cout}] {g_name} -> {dz_name} act={act}: bit-equal to plain -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError("conv1x1_bwd_dz disagrees with its plain version")
        del g, y, dz, ref

    # F5: the weight gradient over ResNet-50's pixels is the f32 sums rounded once; dx too.
    x = torch.randn(RESNET_BATCH * 56 * 56, 256, device="cuda", generator=gen).to(torch.bfloat16).requires_grad_()
    w = (torch.randn(64, 256, device="cuda", generator=gen) / 16).to(torch.bfloat16).requires_grad_()
    g = (torch.randn(x.shape[0], 64, device="cuda", generator=gen) * 0.01).to(torch.bfloat16)
    k4.conv1x1_bn_act_diff(x, w, torch.ones(64, device="cuda"), torch.zeros(64, device="cuda"),
                           act=None, affine_grads=False).backward(g)
    with torch.no_grad():  # dz = g * 1 on this route
        differ = {"dw": (w.grad != (g.T.float() @ x.float()).to(torch.bfloat16)).float().mean().item(),
                  "dx": (x.grad != (g.float() @ w.float()).to(torch.bfloat16)).float().mean().item()}
    ok = max(differ.values()) <= CONV1X1_DW_DIFFER_MAX
    log(f"[conv1x1] gradients over [{x.shape[0]}, 256] -> 64 bf16: " + ", ".join(
        f"{k} {v:.4%}" for k, v in differ.items()) + f" of elements differ from the f32 sums rounded once (bound "
        f"{CONV1X1_DW_DIFFER_MAX:.0%}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("a weight or input gradient is not the f32 sums rounded once (F5)")
    del x, w, g
    torch.cuda.empty_cache()

    # The autograd path: conv1x1_bn_act_diff through the kernel against autograd through
    # the plain version, on a strided channels-last view, every epilogue, both affine modes;
    # bf16 at Cout 96 (the CUDA-core forward) and 128 (the wgmma forward and, on ResNet's
    # route, the dz pass).
    for dtype_name, cout in (("float32", 96), ("bfloat16", 96), ("bfloat16", 128)):
        dtype = getattr(torch, dtype_name)
        for act in (None, "relu", "gelu"):
            for affine_grads in (False, True):
                full = torch.randn(4, 64, 30, 30, device="cuda", generator=gen).to(dtype)
                full = full.contiguous(memory_format=torch.channels_last)
                _, w, scale, bias = _conv1x1_inputs(gen, 1, 64, cout, dtype)
                g = torch.randn(4, 15, 15, cout, device="cuda", generator=gen).to(dtype)
                grads = []
                dz_before = k4.launches["conv1x1_bwd_dz"]
                for use_kernel in (True, False):
                    leaves = [t.clone().requires_grad_() for t in (full, w, scale, bias)]
                    x = leaves[0][:, :, ::2, ::2].permute(0, 2, 3, 1)
                    if use_kernel:
                        y = k4.conv1x1_bn_act_diff(x, *leaves[1:], act=act, affine_grads=affine_grads)
                    else:
                        y = k4.conv1x1_bn_act_plain(x, *leaves[1:], act=act)
                    y.backward(g)
                    grads.append([t.grad for t in leaves])
                one_pass = act != "gelu" and not affine_grads  # ResNet's route: the dz kernel
                if k4.launches["conv1x1_bwd_dz"] - dz_before != int(one_pass):
                    raise RuntimeError(f"the backward launched the dz kernel {k4.launches['conv1x1_bwd_dz'] - dz_before} "
                                       f"times (act={act}, affine_grads={affine_grads})")
                results = []
                for name, got, ref in zip(("x", "w", "scale", "bias"), *grads, strict=True):
                    if name in ("scale", "bias") and not affine_grads:
                        results.append((name, float(got.abs().max()), 0.0))  # declared constant: zeros
                        continue
                    results.append((name, *_err_bound(got, ref, CONV1X1_GRAD_ATOL_F32)))
                ok = all(e <= b for _, e, b in results)
                errs = " ".join(f"d{n}={e:.2e}/{b:.1e}" for n, e, b in results)
                log(f"[conv1x1] autograd vs plain, [4, 15, 15, 64] strided -> {cout} act={act} "
                    f"affine_grads={affine_grads} {dtype_name}: {errs} -> {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise RuntimeError("conv1x1_bn_act_diff's backward disagrees with autograd through the plain version")

    # ConvNeXt-L's four expand Dense + GELU shapes at micro-batch 64 (a unit scale, an f32
    # bias), each on the variant conv1x1_variant names (wgmma for Cin 192 and 384, the CUDA
    # cores above WGMMA_MAX_CIN), and again with one row fewer, off every row tile.
    convnext_worst = 0.0
    for name, rows, cin, cout, _ in CONVNEXT_K4_SHAPES:
        for n in (rows, rows - 1):
            x = torch.randn(n, cin, device="cuda", generator=gen).to(torch.bfloat16)
            w = (torch.randn(cout, cin, device="cuda", generator=gen) * cin**-0.5).to(torch.bfloat16)
            ones, bias = torch.ones(cout, device="cuda"), 0.1 * torch.randn(cout, device="cuda", generator=gen)
            want = "wgmma" if cin <= k4.WGMMA_MAX_CIN else "cuda_cores"
            if k4.conv1x1_variant(x, cout) != want:
                raise RuntimeError(f"convnext_l {name} would take the {k4.conv1x1_variant(x, cout)} variant, not {want}")
            err = check(f"convnext_l {name} N={n} {cin}->{cout} act=gelu bfloat16", x, w, ones, bias, "gelu")
            convnext_worst = max(convnext_worst, err) if n == rows else convnext_worst
            del x, w
    # PallasDenseAct's autograd route (gelu, affine_grads=True, a constant unit scale; the
    # backward keeps the plain ops and launches no dz pass) against autograd through the
    # plain version, at stage 1 (wgmma forward) and stage 3 (CUDA-core forward). bf16 dx and
    # dw within 2e-2 of their largest magnitude; the f32 bias gradient, sums over every row
    # in other orders, within 1e-4 of its largest magnitude.
    for name, rows, cin, cout, _ in (CONVNEXT_K4_SHAPES[0], CONVNEXT_K4_SHAPES[2]):
        x = torch.randn(rows, cin, device="cuda", generator=gen).to(torch.bfloat16)
        w = (torch.randn(cout, cin, device="cuda", generator=gen) * cin**-0.5).to(torch.bfloat16)
        bias, ones = 0.1 * torch.randn(cout, device="cuda", generator=gen), torch.ones(cout, device="cuda")
        g = (0.01 * torch.randn(rows, cout, device="cuda", generator=gen)).to(torch.bfloat16)
        dz_before = k4.launches["conv1x1_bwd_dz"]
        grads = []
        for use_kernel in (True, False):
            leaves = [t.clone().requires_grad_() for t in (x, w, bias)]
            fn = k4.conv1x1_bn_act_diff if use_kernel else k4.conv1x1_bn_act_plain
            kw = {"affine_grads": True} if use_kernel else {}
            fn(leaves[0], leaves[1], ones, leaves[2], act="gelu", **kw).backward(g)
            grads.append([t.grad for t in leaves])
        results = [(n, *_err_bound(got, ref, 0.0)) for n, got, ref in zip(("x", "w"), grads[0][:2], grads[1][:2])]
        db_err = (grads[0][2] - grads[1][2]).abs().max().item()
        results.append(("bias", db_err, 1e-4 * grads[1][2].abs().max().item()))
        ok = all(e <= b for _, e, b in results) and k4.launches["conv1x1_bwd_dz"] == dz_before
        errs = " ".join(f"d{n}={e:.2e}/{b:.1e}" for n, e, b in results)
        log(f"[conv1x1] autograd vs plain, convnext_l {name} [{rows}, {cin}] -> {cout} act=gelu affine_grads=True "
            f"bfloat16: {errs}; dz launches {k4.launches['conv1x1_bwd_dz'] - dz_before} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError("conv1x1_bn_act_diff's gelu route disagrees with autograd through the plain version")
        del x, w, g, grads
        torch.cuda.empty_cache()
    return worst, dz_worst, convnext_worst


def _images_per_s(batch, ms):
    return batch / ms * 1e3


def phase_resnet(run_dir: str):
    """Phase B: ResNet-50 through the port's ImageNet entry with PALLAS=1: 2 epochs, then a
    resumed epoch under the profiler; returns the kernel's launches and the figures."""
    import torch
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
        wgmma_launches = k4.launches_by_variant[("conv1x1_bn_act", "wgmma")]
        dz_launches = k4.launches["conv1x1_bwd_dz"]
        final_step = resumed.state.step
        steps_per_epoch = len(resumed.train_dataloader)
        n_val = len(resumed.val_dataloader)
        model = resumed.model
        val_batch = next(iter(resumed.val_dataloader))
        images = resumed.to_device(val_batch)["image"].permute(0, 3, 1, 2)[:32]
        turns = _host_paths_in_turns(resumed, RESNET_EPOCHS)
        del resumed
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    busy_us, busy = _busy_share(prof, epoch_wall_us)
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
        f"{epoch_wall_us / 1e3:.1f} ms, device busy time {busy_us / 1e3:.1f} ms, busy share "
        f"{'not measured' if busy is None else f'{busy:.4f}'}")
    log(f"[resnet] the resumed train epoch again on the warm trainer, in turns: {_turns_line(turns)}")
    log(f"[resnet] conv1x1 launches {launches} ({wgmma_launches} on the wgmma variant), backward dz launches "
        f"{dz_launches}, over {counts['steps']} steps and {counts['evals']} validation forwards")

    losses = [m["ce_loss"] for m in epoch_metrics] + [m["ce_loss"] for m in val_metrics]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite losses: {losses}")
    if stats_moved == 0:
        raise RuntimeError("no BatchNorm running statistic moved in training")
    if launches != len(RESNET_K4_SHAPES) * (counts["steps"] + counts["evals"]) or wgmma_launches != launches:
        raise RuntimeError(f"expected {len(RESNET_K4_SHAPES)} conv1x1 launches per train step and val forward, all on "
                           f"the wgmma variant, got {launches} ({wgmma_launches} wgmma) over {counts['steps']} + "
                           f"{counts['evals']}")
    if dz_launches != len(RESNET_K4_SHAPES) * counts["steps"]:
        raise RuntimeError(f"expected {len(RESNET_K4_SHAPES)} conv1x1_bwd_dz launches per train step, got {dz_launches} "
                           f"over {counts['steps']} steps")
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
    return {"conv1x1_bn_act": launches, "conv1x1_bwd_dz": dz_launches}, {
        "step_ms": median_ms, "images_per_s": _images_per_s(RESNET_BATCH, median_ms), "peak_gb": peak_gb, "busy": busy,
        "turns": turns}


VGG_BATCH = 1024
# The entry's defaults but BASE_LR: its 0.1 (lr 0.4 at batch 1024, the JAX entry's recipe)
# takes VGG16, which has no BatchNorm, to a non-finite loss within its first 2 epochs on
# the synthetic set, in bf16 and in f32 (PERF.md, section 6). The JAX entry does the same at
# that lr: tests/test_torch_trainer_cifar10.py holds both entries at lr 0.4 on the CPU, where
# a VGG16 of a quarter of the widths turns non-finite on both sides in the same epoch. At
# 0.005 (lr 0.02 at the end of these 3 warmup epochs) the train loss falls.
VGG_ENV = {"BATCH": str(VGG_BATCH), "BASE_LR": "0.005"}
VGG_EPOCHS = 2  # then one resumed epoch
VGG_PARENT_PYTHON_STEPS = 8  # the per-record Python path takes about 0.3 s a step
# VGG16 on 32x32: 433 M multiply-adds per image forward (313 M in the convolutions, 120 M
# in the classifier), three times that for forward and backward.
VGG_FLOP_PER_IMAGE = 3 * 2 * 433e6


def _busy_share(prof, wall_us):
    """The device's busy time in a profiled window (the union of its kernels', copies'
    and sets' intervals, so a copy on the side stream under a kernel counts once) and
    that time over the window's wall time (the device's busy share)."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, covered = 0, None
    for start, end in spans:
        if covered is None or start > covered:
            busy_us += end - start
            covered = end
        elif end > covered:
            busy_us += end - covered
            covered = end
    return busy_us, (busy_us / wall_us if busy_us else None)


def _profiled_epoch(trainer, epoch):
    """One train epoch of ``trainer`` under the profiler: its wall (ms), the device's busy
    time (ms) and busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    trainer.train_dataloader.set_epoch(epoch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        metrics = trainer.train_epoch(epoch)  # ends in one read-back of the epoch's metrics
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us, busy = _busy_share(prof, wall_us)
    return metrics, {"wall_ms": wall_us / 1e3, "busy_ms": busy_us / 1e3, "busy": busy}


def _fmt_busy(busy):
    return "not measured" if busy is None else f"{busy:.4f}"


def _host_paths_in_turns(trainer, epoch, order=("parent", "new", "new", "parent")):
    """The same train epoch of one warm trainer through the parent's host path (no loader
    workers, each batch copied by ``to_device`` on the step's thread) and the new one
    (the trainer's own: workers and ``device_prefetch``), in turns; returns each path's
    figures per run. The trainer's instrumented hooks are dropped first, so these steps
    are not counted as the phase's."""
    for hook in ("train_step", "validate_step", "train_epoch", "validate"):
        trainer.__dict__.pop(hook, None)
    workers = trainer.train_dataloader.num_workers
    runs = {"parent": [], "new": []}
    for path in order:
        if path == "parent":
            trainer.train_dataloader.num_workers = 0
            trainer.device_batches = lambda loader: (trainer.to_device(trainer.preprocess_batch(b)) for b in loader)
        else:
            trainer.train_dataloader.num_workers = workers
            trainer.__dict__.pop("device_batches", None)
        runs[path].append(_profiled_epoch(trainer, epoch)[1])
    trainer.train_dataloader.num_workers = workers
    trainer.__dict__.pop("device_batches", None)
    return runs


def _turns_line(runs):
    parts = []
    for path, rs in runs.items():
        busy = ", ".join(_fmt_busy(r["busy"]) for r in rs)
        walls = ", ".join(f"{r['wall_ms']:.1f}" for r in rs)
        parts.append(f"{path} host path: busy {busy} (wall {walls} ms)")
    return "; ".join(parts)


def phase_vgg(run_dir: str):
    """VGG16 on CIFAR-10 through the port's default entry (``examples/train_cifar10.py``)
    at its defaults (batch 1024, a bf16 model with f32 params, the synthetic set, the
    native crop/flip with uint8 batches normalised on the device, 8 loader workers and
    device prefetch): 2 epochs, then a resumed third whose train epoch is profiled; then
    its first steps from the same checkpoint through the parent's host path (the
    per-record Python transform, no workers, each batch copied on the step's thread), and
    the epoch on the warm trainer through the new and the parent host path in turns (both
    with the native crop/flip). Returns the figures; raises unless the losses are finite,
    the train loss falls, the resume continues the step and epoch, the native path ran
    with uint8 batches, and no hand kernel launched."""
    import torch

    from distributed_training_pytorch_tpu_torch.checkpoint import CheckpointManager
    from distributed_training_pytorch_tpu_torch.data import native
    from distributed_training_pytorch_tpu_torch.examples import train_cifar10
    from distributed_training_pytorch_tpu_torch.ops import conv1x1 as k4
    from distributed_training_pytorch_tpu_torch.ops import flash_attention as fa

    if not native.available():
        raise RuntimeError(f"the native data runtime did not build: {native.build_error()}")
    log(f"[vgg] native data runtime built (codecs: {native.codecs_available()}) at {native.LIBRARY}")
    torch.cuda.empty_cache()
    keys = ("BATCH", "EPOCHS", "SAVE_DIR", "SNAPSHOT", "DTYPE", "CIFAR10_DIR", "PALLAS", "BASE_LR", "MESH",
            "CHAIN_STEPS", "TUNED", "TELEMETRY")
    saved_env = {k: os.environ.get(k) for k in keys}
    for k in keys:
        os.environ.pop(k, None)
    # No CIFAR pickles are in the repository: the entry's synthetic set, drawn once here
    # and handed to each trainer of the phase (the draw is set-up, not the host path).
    os.environ.update(VGG_ENV, SAVE_DIR=run_dir, CIFAR10_DIR=os.path.join(run_dir, "no-pickles"))
    real_load = train_cifar10.load_cifar10
    data = real_load(os.environ["CIFAR10_DIR"])
    train_cifar10.load_cifar10 = lambda data_dir: data
    step_ms, epoch_metrics, val_metrics = [], [], []
    counts = {"steps": 0, "evals": 0}
    image_dtypes = set()

    def build():
        trainer = _instrument(train_cifar10.build_trainer("cuda"), step_ms, counts, epoch_metrics, val_metrics)
        timed_step = trainer.train_step

        def dtype_recorded_step(state, batch):
            image_dtypes.add(batch["image"].dtype)
            return timed_step(state, batch)

        trainer.train_step = dtype_recorded_step
        return trainer

    fa_before, k4_before = dict(fa.launches), dict(k4.launches)
    try:
        os.environ.update(EPOCHS=str(VGG_EPOCHS))
        first = build()
        n_params = sum(p.numel() for p in first.model.parameters())
        param_dtypes = {p.dtype for p in first.model.parameters()}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        first.train()
        first_steps, first_epoch = first.state.step, first.cur_epoch
        del first
        torch.cuda.empty_cache()

        # The parent's host path over the epoch the resume will train, from the same
        # checkpoint, for its first VGG_PARENT_PYTHON_STEPS steps: the per-record Python
        # transform (the parent port had no native library) on the step's thread, each
        # batch copied by ``to_device`` just before its step. The native crop/flip without
        # workers is the in-turns comparison's parent path, on the warm trainer below.
        last = os.path.join(run_dir, "weights", "last")
        os.environ.update(EPOCHS=str(VGG_EPOCHS + 1), SAVE_DIR=os.path.join(run_dir, "parent"), SNAPSHOT=last)
        tr = train_cifar10.build_trainer("cuda")
        tr.train_dataloader.num_workers = 0
        tr.device_batches = lambda loader: (
            tr.to_device(tr.preprocess_batch(b)) for b in itertools.islice(loader, VGG_PARENT_PYTHON_STEPS))
        # InputNormalizer passes the host-normalised floats through.
        tr.train_dataloader.transform = train_cifar10.Cifar10Transform(seed=tr.seed, train=True)
        if tr.train_dataloader._batch_fast_path() is not None:
            raise RuntimeError("the parent path is not on the loader's per-record path")
        parent = _profiled_epoch(tr, VGG_EPOCHS)[1]
        parent["steps"] = VGG_PARENT_PYTHON_STEPS
        del tr
        torch.cuda.empty_cache()

        os.environ.update(EPOCHS=str(VGG_EPOCHS + 1), SAVE_DIR=run_dir, SNAPSHOT="last")
        resumed = build()
        resumed_at = (resumed.state.step, resumed.cur_epoch)
        train_epoch = resumed.train_epoch
        new_path = {}

        def profiled_train_epoch(epoch):
            resumed.train_epoch = train_epoch
            metrics, new_path["figures"] = _profiled_epoch(resumed, epoch)
            return metrics

        resumed.train_epoch = profiled_train_epoch
        torch.cuda.synchronize()
        t_resume = time.perf_counter()
        resumed.train()
        torch.cuda.synchronize()
        resume_wall_ms = (time.perf_counter() - t_resume) * 1e3
        wall = time.perf_counter() - t0
        final_step = resumed.state.step
        steps_per_epoch = len(resumed.train_dataloader)
        n_val = len(resumed.val_dataloader)
        fa_after, k4_after = dict(fa.launches), dict(k4.launches)
        turns = _host_paths_in_turns(resumed, VGG_EPOCHS)
        del resumed
        torch.cuda.empty_cache()
    finally:
        train_cifar10.load_cifar10 = real_load
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    times = [s.elapsed_time(e) for s, e in step_ms]
    steady = sorted(t for i, t in enumerate(times) if i % steps_per_epoch)  # epoch starts follow val/saves
    median_ms = steady[len(steady) // 2]
    new = new_path["figures"]
    host = sorted(counts["host_ms"][i] for i in range(len(times)) if i % steps_per_epoch)
    host_ms = host[len(host) // 2]
    log(f"[vgg] VGG16 ({n_params:,} params, {sorted(str(d) for d in param_dtypes)}), CIFAR-10 synthetic set, global "
        f"batch {VGG_BATCH}, bf16 compute (DTYPE unset), SGD(0.9, wd 5e-4), warmup-cosine; {steps_per_epoch} "
        f"steps/epoch, {n_val} val batches; train images reached the model as {sorted(str(d) for d in image_dtypes)}")
    for i, m in enumerate(epoch_metrics):
        log(f"[vgg] epoch {i}: train ce {m['ce_loss']:.4f} acc {m['accuracy']:.4f}")
    for i, vm in enumerate(val_metrics):
        log(f"[vgg] validation {i} (before training epoch 0): ce {vm['ce_loss']:.4f} acc {vm['accuracy']:.4f}")
    log(f"[vgg] {counts['steps']} steps, {counts['evals']} validation forwards in {wall:.1f} s (data, saves and the "
        f"parent-path epochs included); step time median {median_ms:.2f} ms (min {steady[0]:.2f}, max "
        f"{steady[-1]:.2f}, first {times[0]:.2f}); {_images_per_s(VGG_BATCH, median_ms):.0f} images/s; "
        f"{VGG_FLOP_PER_IMAGE * VGG_BATCH / median_ms / 1e9:.1f} TFLOP/s; peak memory {peak_gb:.2f} GB; the host "
        f"takes {host_ms:.2f} ms (median) to issue a step")
    log(f"[vgg] resumed train epoch ({steps_per_epoch} steps), new host path (native crop/flip on 8 loader workers, "
        f"2 batches ahead; pinned copies on a side stream): wall {new['wall_ms']:.1f} ms, device busy time "
        f"{new['busy_ms']:.1f} ms, busy share {_fmt_busy(new['busy'])}; the whole resumed run (its epoch "
        f"and the save of last): {resume_wall_ms:.1f} ms")
    log(f"[vgg] the resumed train epoch again on the warm trainer, native crop/flip, in turns: {_turns_line(turns)}")
    log(f"[vgg] the same epoch ({parent['steps']} steps) through the parent's host path (per-record Python "
        f"transform, no workers, per-batch to_device): wall {parent['wall_ms']:.1f} ms, device busy time "
        f"{parent['busy_ms']:.1f} ms, busy share {_fmt_busy(parent['busy'])}")

    losses = [m["ce_loss"] for m in epoch_metrics] + [m["ce_loss"] for m in val_metrics]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite losses: {losses}")
    if not epoch_metrics[-1]["ce_loss"] < epoch_metrics[0]["ce_loss"]:
        raise RuntimeError(f"train loss did not fall: {[m['ce_loss'] for m in epoch_metrics]}")
    if image_dtypes != {torch.uint8}:
        raise RuntimeError(f"expected uint8 train batches (the native path), got {image_dtypes}")
    if n_params != 134_301_514 or param_dtypes != {torch.float32}:
        raise RuntimeError(f"expected VGG16's 134,301,514 f32 params, got {n_params} {param_dtypes}")
    if fa_after != fa_before or k4_after != k4_before:
        raise RuntimeError(f"hand kernels launched in the VGG phase: {fa_before} -> {fa_after}, {k4_before} -> {k4_after}")
    if (first_steps, first_epoch) != (VGG_EPOCHS * steps_per_epoch, VGG_EPOCHS - 1):
        raise RuntimeError(f"first run ended at step {first_steps}, epoch {first_epoch}")
    if resumed_at != (VGG_EPOCHS * steps_per_epoch, VGG_EPOCHS) or final_step != (VGG_EPOCHS + 1) * steps_per_epoch:
        raise RuntimeError(f"resume at (step, epoch) {resumed_at}, ended at step {final_step}")
    manager = CheckpointManager(os.path.join(run_dir, "weights"))
    for name in ("best", "last"):
        manager.validate(name)
    meta = manager.read_meta("last")
    if (meta["epoch"], meta["step"]) != (VGG_EPOCHS + 1, final_step):
        raise RuntimeError(f"last checkpoint meta {meta}")
    log(f"[vgg] best and last valid; resumed at step {resumed_at[0]}, epoch {resumed_at[1]}; last = epoch "
        f"{meta['epoch']}, step {meta['step']}; hand-kernel launches in the phase: 0")
    return {"step_ms": median_ms, "images_per_s": _images_per_s(VGG_BATCH, median_ms), "peak_gb": peak_gb,
            "host_ms": host_ms, "new": new, "parent": parent, "turns": turns}


def conv1x1_dz_bound(rows, cout, itemsize=2):
    """Least time for the backward's dz pass on ResNet's route (identity): g read once, dz
    written once (4 bytes an element in bf16) and scale, against one f32 multiply an
    element."""
    nbytes = 2 * rows * cout * itemsize + 4 * cout
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = rows * cout / PEAK_FLOPS["float32"]
    return max(t_ops, t_bytes) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes


def phase_conv1x1_times(card: str):
    """K4 at ResNet-50's nine shapes (batch 256, bf16, identity epilogue): kernel, plain,
    bound and the faster of torch.matmul and a channels-last 1x1 F.conv2d; the shortcut's
    view also through a contiguous copy; then the backward's dz pass at the nine [N, Cout]
    gradients: kernel, the three plain passes, bound and one ``torch.mul`` with a bf16
    ``out``. Returns the rows and totals of each."""
    import torch
    import torch.nn.functional as F

    from distributed_training_pytorch_tpu_torch.ops import conv1x1 as k4

    torch.backends.cudnn.allow_tf32 = True
    gen = torch.Generator(device="cuda").manual_seed(1357)
    counts = (dict(k4.launches), dict(k4.launches_by_variant))  # timing launches are not the main path's
    rows, dz_rows = [], []
    for name, cin, cout, stride in RESNET_K4_SHAPES:
        full = torch.randn(RESNET_BATCH, cin, 56, 56, device="cuda", generator=gen).to(torch.bfloat16)
        full = full.contiguous(memory_format=torch.channels_last)
        x = full[:, :, ::stride, ::stride].permute(0, 2, 3, 1)
        w = (torch.randn(cout, cin, device="cuda", generator=gen) * cin**-0.5).to(torch.bfloat16)
        w4 = w.view(cout, cin, 1, 1).contiguous(memory_format=torch.channels_last)
        ones, zeros = torch.ones(cout, device="cuda"), torch.zeros(cout, device="cuda")
        n = x.shape[0] * x.shape[1] * x.shape[2]
        ms = time_ms(lambda: k4.conv1x1_bn_act(x, w, ones, zeros))
        plain_ms = time_ms(lambda: k4.conv1x1_bn_act_plain(x, w, ones, zeros), iters=5)
        wt = w.T
        matmul_ms = time_ms(lambda: torch.matmul(x.reshape(n, cin), wt))
        conv_ms = time_ms(lambda: F.conv2d(full, w4, stride=stride))
        bound_ms, bound_by, flops, nbytes = conv1x1_bound(n, cin, cout)
        library_ms = min(matmul_ms, conv_ms)
        extra = ""
        if not x.is_contiguous():
            copy_ms = time_ms(lambda: k4.conv1x1_bn_act(x.contiguous(), w, ones, zeros))
            extra = f"; through a contiguous copy of the view {copy_ms:.4f} ms"
        log(f"[times] {card} | conv1x1 {name} N={n} {cin}->{cout} bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"torch.matmul {matmul_ms:.4f} ms, F.conv2d 1x1 {conv_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
            f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB), {bound_ms / ms:.4f} of the bound{extra}")
        rows.append({"name": name, "shape": [n, cin, cout], "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                     "matmul_ms": matmul_ms, "conv2d_ms": conv_ms, "bound_ms": bound_ms, "bound_by": bound_by})
        del full, x

        g = torch.randn(n, cout, device="cuda", generator=gen).to(torch.bfloat16)
        scale = torch.rand(cout, device="cuda", generator=gen) + 0.5
        out = torch.empty_like(g)
        dz_ms = time_ms(lambda: k4.conv1x1_bwd_dz(g, None, scale, out_dtype=torch.bfloat16))
        dz_plain_ms = time_ms(lambda: k4.conv1x1_bwd_dz_plain(g, None, scale, out_dtype=torch.bfloat16), iters=5)
        dz_library_ms = time_ms(lambda: torch.mul(g, scale, out=out))
        same = torch.equal(out, k4.conv1x1_bwd_dz_plain(g, None, scale, out_dtype=torch.bfloat16))
        dz_bound_ms, dz_bound_by, dz_bytes = conv1x1_dz_bound(n, cout)
        log(f"[times] {card} | conv1x1_bwd_dz {name} [{n}, {cout}] bf16: kernel {dz_ms:.4f} ms, the three plain passes "
            f"{dz_plain_ms:.4f} ms, torch.mul(out=bf16) {dz_library_ms:.4f} ms (same values: {same}), bound "
            f"{dz_bound_ms:.4f} ms ({dz_bound_by}; {dz_bytes / 1e6:.2f} MB), {dz_bound_ms / dz_ms:.4f} of the bound")
        dz_rows.append({"name": name, "shape": [n, cout], "ms": dz_ms, "plain_ms": dz_plain_ms,
                        "library_ms": dz_library_ms, "bound_ms": dz_bound_ms, "bound_by": dz_bound_by})
        del g, out
        torch.cuda.empty_cache()
    k4.launches.update(counts[0])
    k4.launches_by_variant.update(counts[1])
    totals = []
    for label, table in (("conv1x1", rows), ("conv1x1_bwd_dz", dz_rows)):
        total = {k: sum(r[k] for r in table) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        total["bound_by"] = "bytes" if all(r["bound_by"] == "bytes" for r in table) else "operations"
        log(f"[times] {card} | {label}, the nine launches of one ResNet-50 step at batch {RESNET_BATCH}: kernel "
            f"{total['ms']:.4f} ms, plain {total['plain_ms']:.4f} ms, library {total['library_ms']:.4f} ms, bound "
            f"{total['bound_ms']:.4f} ms ({total['bound_ms'] / total['ms']:.4f} of it)")
        totals.append(total)
    return rows, totals[0], dz_rows, totals[1]


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
        launches, by_variant = dict(fa.launches), dict(fa.launches_by_variant)
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
    _check_wgmma_launches(launches, by_variant, "[ring-train]")
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


ENTRY_KEYS = ("MODEL", "IMAGE_SIZE", "BATCH", "STEPS_PER_EPOCH", "SHIP_UINT8", "PALLAS", "EPOCHS", "SAVE_DIR",
              "SNAPSHOT", "DTYPE", "NUM_CLASSES", "ACCUM", "BASE_LR", "IMAGENET_RECORDS", "VAL_RECORDS", "MESH",
              "CHAIN_STEPS")


@contextlib.contextmanager
def _entry_env(env, **extra):
    """The ImageNet entry's knobs set to ``env`` and ``extra`` (every other knob unset) for
    the block, restored after it."""
    saved = {k: os.environ.get(k) for k in (*ENTRY_KEYS, *env, *extra)}
    for k in saved:
        os.environ.pop(k, None)
    os.environ.update(env, **extra)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _entry_run(tag, env, run_dir, batch):
    """The ImageNet entry on ``env``: ENTRY_EPOCHS epochs, then a resume from ``last`` for
    one more, every kernel count set to 0 just before the first epoch and read after the
    resumed one. Raises unless every loss is finite, the resume continues the step and the
    epoch, and ``best``/``last`` are valid; returns the run's figures, its launches, the
    trained model and a val batch on the card."""
    import torch

    from distributed_training_pytorch_tpu_torch.checkpoint import CheckpointManager
    from distributed_training_pytorch_tpu_torch.examples import train_imagenet
    from distributed_training_pytorch_tpu_torch.ops import conv1x1 as k4
    from distributed_training_pytorch_tpu_torch.ops import flash_attention as fa

    step_ms, epoch_metrics, val_metrics, saves, flushes = [], [], [], [], []
    counts = {"steps": 0, "evals": 0}

    def build():
        trainer = train_imagenet.build_trainer(
            "cuda", synthetic_records=ENTRY_STEPS * batch, synthetic_val_records=batch
        )
        # Saves are background saves (async_checkpoint): the loop pays each one's host
        # snapshot, timed after a sync; the commits are waited for at the saver's flushes.
        save_async, flush = trainer.saver.save_async, trainer.saver.flush

        def timed_snapshot(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = save_async(*args, **kw)
            saves.append(time.perf_counter() - t0)
            return out

        def timed_flush(*args, **kw):
            t0 = time.perf_counter()
            out = flush(*args, **kw)
            flushes.append(time.perf_counter() - t0)
            return out

        trainer.saver.save_async, trainer.saver.flush = timed_snapshot, timed_flush
        return _instrument(trainer, step_ms, counts, epoch_metrics, val_metrics)

    torch.cuda.empty_cache()
    with _entry_env(env, SAVE_DIR=run_dir, EPOCHS=str(ENTRY_EPOCHS)):
        first = build()
        n_params = sum(p.numel() for p in first.model.parameters())
        accum = first.engine.accum_steps
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()  # count only this path's launches from here
        k4.reset_launches()
        t0 = time.perf_counter()
        first.train()
        first_at = (first.state.step, first.cur_epoch)
        del first
        os.environ.update(EPOCHS=str(ENTRY_EPOCHS + 1), SNAPSHOT="last")
        resumed = build()
        resumed_at = (resumed.state.step, resumed.cur_epoch)
        resumed.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"fa": dict(fa.launches), "fa_variant": dict(fa.launches_by_variant), "k4": dict(k4.launches),
                    "k4_variant": dict(k4.launches_by_variant)}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        final_step = resumed.state.step
        steps_per_epoch = len(resumed.train_dataloader)
        n_val = len(resumed.val_dataloader)
        val_batch = resumed.to_device(next(iter(resumed.val_dataloader)))
        model = resumed.model
        del resumed
    times = [s.elapsed_time(e) for s, e in step_ms]
    # The first step of each epoch follows validation and a save: cold caches and allocator.
    steady = sorted(t for i, t in enumerate(times) if i % steps_per_epoch)
    median_ms = steady[len(steady) // 2]
    log(f"{tag} {n_params:,} params; global batch {batch} in {accum} micro-batch(es); {steps_per_epoch} steps/epoch, "
        f"{n_val} val batch(es)")
    for i, (m, vm) in enumerate(zip(epoch_metrics, val_metrics, strict=True)):
        log(f"{tag} epoch {i}: val (before training) ce {vm['ce_loss']:.4f} acc {vm['accuracy']:.4f}; "
            f"train ce {m['ce_loss']:.4f} acc {m['accuracy']:.4f} lr {m['lr']:.3e}")
    log(f"{tag} {counts['steps']} steps, {counts['evals']} validation forwards in {wall:.1f} s (data, validation and "
        f"saves included); step time median {median_ms:.2f} ms (min {steady[0]:.2f}, max {steady[-1]:.2f}; all "
        f"{[round(t, 2) for t in times]}); {_images_per_s(batch, median_ms):.0f} images/s; peak memory {peak_gb:.2f} GB; "
        f"{len(saves)} checkpoint snapshots took {sum(saves):.1f} s ({', '.join(f'{t:.2f}' for t in saves)} s), the "
        f"flushes of their background commits {sum(flushes):.1f} s ({', '.join(f'{t:.2f}' for t in flushes)} s)")

    losses = [m["ce_loss"] for m in epoch_metrics] + [m["ce_loss"] for m in val_metrics]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite losses: {losses}")
    if first_at != (ENTRY_EPOCHS * steps_per_epoch, ENTRY_EPOCHS - 1):
        raise RuntimeError(f"first run ended at (step, epoch) {first_at}")
    if resumed_at != (ENTRY_EPOCHS * steps_per_epoch, ENTRY_EPOCHS) or final_step != (ENTRY_EPOCHS + 1) * steps_per_epoch:
        raise RuntimeError(f"resume at (step, epoch) {resumed_at}, ended at step {final_step}")
    manager = CheckpointManager(os.path.join(run_dir, "weights"))
    for name in ("best", "last"):
        manager.validate(name)
    meta = manager.read_meta("last")
    if (meta["epoch"], meta["step"]) != (ENTRY_EPOCHS + 1, final_step):
        raise RuntimeError(f"last checkpoint meta {meta}")
    log(f"{tag} best and last valid; resumed at step {resumed_at[0]}, epoch {resumed_at[1]}; last = epoch "
        f"{meta['epoch']}, step {meta['step']}")
    figures = {"step_ms": median_ms, "images_per_s": _images_per_s(batch, median_ms), "peak_gb": peak_gb,
               "wall_s": wall, "save_s": sum(saves), "flush_s": sum(flushes), "saves": len(saves), "n_params": n_params}
    return figures, launches, counts, model, val_batch


def _normalised(model, val_batch, n=32):
    """The first ``n`` val images as the model's inner network sees them (NCHW f32,
    normalised on the card by the entry's ``InputNormalizer``) and their labels."""
    images = val_batch["image"].permute(0, 3, 1, 2)[:n]
    return (images.float() / 255.0 - model.mean) / model.std, val_batch["label"][:n].long()


def _agreement(tag, label, got, ref, rel):
    """Raises unless ``got`` is finite and within ``rel`` of ``ref``'s largest magnitude."""
    import torch

    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    ok = bool(torch.isfinite(got).all()) and got.shape == ref.shape and err <= rel * scale
    log(f"{tag} {label}: max|diff| {err:.4g} (bound {rel * scale:.4g}; max|ref| {scale:.4g}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{label} disagree")
    return err / scale if scale else 0.0


def _knobs_in_turns(tag, env, run_dir, batch, knobs, n_steps):
    """The same train steps of the entry's model with each ``PALLAS`` value in ``knobs``
    ("" = unset), on batches already on the card, in turns (first, second, second, first)
    after a warm-up of each: median step ms of each."""
    import torch

    from distributed_training_pytorch_tpu_torch.examples import train_imagenet

    trainers = {}
    for knob in knobs:
        with _entry_env(env, SAVE_DIR=run_dir, EPOCHS="1", PALLAS=knob):
            trainers[knob] = train_imagenet.build_trainer("cuda", synthetic_records=2 * batch, synthetic_val_records=batch)
    first, second = knobs
    trainers[second].model.load_state_dict(trainers[first].model.state_dict())
    batches = [trainers[first].to_device(b) for b in trainers[first].train_dataloader]
    times = {knob: [] for knob in knobs}

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

    for knob in knobs:
        run(knob, record=False)  # warm-up: cuDNN's and cuBLAS's choices, the allocator
    for knob in (first, second, second, first):
        run(knob, record=True)
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    name = {"": "PALLAS unset", "0": "PALLAS=0", "1": "PALLAS=1"}
    log(f"{tag} train step (batch {batch}, 224x224, bf16), {2 * n_steps} steps each, in turns on batches on the card: "
        + ", ".join(f"{name[k]} median {med[k]:.2f} ms ({_images_per_s(batch, med[k]):.0f} images/s)" for k in knobs)
        + f"; all {({name[k]: [round(t, 2) for t in v] for k, v in times.items()})}")
    del trainers, batches
    torch.cuda.empty_cache()
    return {name[k]: med[k] for k in knobs}


# The trained ViT through PALLAS=0 (dot_product_attention: bf16 logits, f32 softmax) against
# the flash kernels (f32 logits, p rounded once): each layer's attention may part by a bf16
# ulp or two, which 12 layers carry to the class token; held to 5e-2 of the largest
# magnitude, as the ResNet phase holds its kernel path against cuDNN's. The padded stream
# against the unpadded one runs the same kernels on the same valid keys, but its GEMMs have
# other row counts (cuBLAS may sum in other orders): logits within 5e-2 of their largest
# magnitude and each parameter's gradient within 5e-2 of its norm.
VIT_PLAIN_REL = 5e-2
VIT_PAD_REL = 5e-2


def phase_vit(run_dir: str):
    """ViT-B/16 through the port's ImageNet entry (``MODEL=vit_b16``, PALLAS unset: the
    flash kernels): 2 epochs and a resumed third; exactly 12 launches each of K1, K2, K3 a
    train step and 12 of K1 a val forward, all on the wgmma variant; the trained weights
    through PALLAS=0 and through ``pad_seq_to=256``; then the same steps with PALLAS unset
    and PALLAS=0 in turns. Returns the launches and the figures."""
    import torch

    from distributed_training_pytorch_tpu_torch.models import ViTB16
    from distributed_training_pytorch_tpu_torch.ops import flash_attention as fa
    from distributed_training_pytorch_tpu_torch.ops.losses import cross_entropy_loss

    torch.backends.cudnn.allow_tf32 = True  # the entry's own settings
    figures, launches, counts, model, val_batch = _entry_run("[vit]", VIT_ENV, run_dir, VIT_BATCH)
    steps, evals = counts["steps"], counts["evals"]
    fl = launches["fa"]
    log(f"[vit] ViT-B/16, 224x224, 1000 classes, bf16 compute, f32 params, AdamW(0.9, 0.999, wd 0.05), warmup-cosine, "
        f"PALLAS unset; {VIT_FLOP_PER_IMAGE * VIT_BATCH / figures['step_ms'] / 1e9:.1f} TFLOP/s; flash launches {fl} "
        f"over {steps} steps and {evals} validation forwards; conv1x1 launches {launches['k4']}")
    expected = {"fwd": VIT_DEPTH * (steps + evals), "bwd_dq": VIT_DEPTH * steps, "bwd_dkv": VIT_DEPTH * steps}
    if fl != expected:
        raise RuntimeError(f"expected flash launches {expected} (12 per layer pass), got {fl}")
    _check_wgmma_launches(fl, launches["fa_variant"], "[vit]")
    if any(launches["k4"].values()):
        raise RuntimeError(f"conv1x1 kernels launched on the ViT path: {launches['k4']}")
    if model.inner.attention_fn is None or model.inner.pos_embed.shape[1] != VIT_SHAPE[1]:
        raise RuntimeError("the entry's ViT-B/16 is not on the flash route at T=197")

    model.eval()
    x, labels = _normalised(model, val_batch)
    features = {}

    def run(net, name, backward=False):
        hook = net.norm.register_forward_hook(lambda mod, inp, out: features.__setitem__(name, out[:, 0].detach()))
        try:
            logits = net(x)
        finally:
            hook.remove()
        if backward:
            cross_entropy_loss(logits, labels).backward()
        return logits.detach()

    with torch.no_grad():
        plain = ViTB16(1000, dtype=torch.bfloat16, pallas=False, device="cuda").eval()
        plain.load_state_dict(model.inner.state_dict())
        got, ref = run(model.inner, "kernel"), run(plain, "plain")
    plain_rel = _agreement("[vit]", "trained model, 32 val images, flash kernels vs PALLAS=0 (dot_product_attention): "
                           "logits", got, ref, VIT_PLAIN_REL)
    _agreement("[vit]", "the same, class-token features", features["kernel"], features["plain"], VIT_PLAIN_REL)
    del plain

    padded = ViTB16(1000, dtype=torch.bfloat16, pad_seq_to=VIT_PAD, device="cuda").eval()
    padded.load_state_dict(model.inner.state_dict())
    before = dict(fa.launches_by_variant)
    got = run(padded, "padded", backward=True)
    pad_launches = {n: fa.launches_by_variant[(n, "wgmma")] - before[(n, "wgmma")] for n in ("fwd", "bwd_dq", "bwd_dkv")}
    model.inner.zero_grad(set_to_none=True)
    ref = run(model.inner, "unpadded", backward=True)
    pad_rel = _agreement("[vit]", f"pad_seq_to={VIT_PAD} (197 valid) vs unpadded, the same weights: logits", got, ref,
                         VIT_PAD_REL)
    worst, worst_name = 0.0, ""
    for (name, p), q in zip(model.inner.named_parameters(), padded.parameters(), strict=True):
        rel = _rel_err(q.grad, p.grad)
        if rel > worst:
            worst, worst_name = rel, name
    ok = worst <= VIT_PAD_REL and pad_launches == {"fwd": VIT_DEPTH, "bwd_dq": VIT_DEPTH, "bwd_dkv": VIT_DEPTH}
    log(f"[vit] pad_seq_to={VIT_PAD}: every parameter's gradient of the CE on 32 val images within "
        f"{worst:.4g} of its norm (worst {worst_name}; bound {VIT_PAD_REL}); wgmma launches of the padded pass "
        f"{pad_launches} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("the padded stream disagrees with the unpadded one")
    del padded, model
    torch.cuda.empty_cache()
    figures["plain_rel"], figures["pad_rel"], figures["pad_grad_rel"] = plain_rel, pad_rel, worst
    figures["turns"] = _knobs_in_turns("[vit-ab]", VIT_ENV, run_dir, VIT_BATCH, ("", "0"), n_steps=3)
    return {k: fl[k] for k in ("fwd", "bwd_dq", "bwd_dkv")}, figures


# The trained ConvNeXt through PALLAS=0 (cuBLAS's Dense, then the tanh GELU on the bf16
# output) against K4 (f32 sums, the GELU on the f32 pre-activation, one rounding): 36 blocks
# carry the per-block rounding differences to the logits; held to 5e-2 of their largest
# magnitude, as the ResNet phase holds its kernel path against cuDNN's.
CONVNEXT_PLAIN_REL = 5e-2


def phase_convnext(run_dir: str):
    """ConvNeXt-L through the port's ImageNet entry (``MODEL=convnext_l``, PALLAS=1: K4's
    gelu epilogue; ACCUM=4, 21,841 classes): 2 epochs and a resumed third; exactly 36 K4
    launches a micro-batch forward (6 wgmma, 30 CUDA cores), so 144 a train step and 36 a
    val forward, and no dz pass; the trained weights through PALLAS=0; then the same steps
    with PALLAS=1 and PALLAS=0 in turns. Returns the launches and the figures."""
    import torch

    from distributed_training_pytorch_tpu_torch.models import ConvNeXtL

    torch.backends.cudnn.allow_tf32 = True
    figures, launches, counts, model, val_batch = _entry_run("[convnext]", CONVNEXT_ENV, run_dir, CONVNEXT_BATCH)
    steps, evals = counts["steps"], counts["evals"]
    k4l, by_variant = launches["k4"], launches["k4_variant"]
    log(f"[convnext] ConvNeXt-L, 224x224, 21841 classes, bf16 compute, f32 params, AdamW(0.9, 0.999, wd 0.05), "
        f"warmup-cosine, ACCUM={CONVNEXT_ACCUM}, PALLAS=1; "
        f"{CONVNEXT_FLOP_PER_IMAGE * CONVNEXT_BATCH / figures['step_ms'] / 1e9:.1f} TFLOP/s; conv1x1 launches {k4l} "
        f"by variant {({v: c for (_, v), c in by_variant.items()})} over {steps} steps and {evals} validation "
        f"forwards; flash launches {launches['fa']}")
    forwards = CONVNEXT_ACCUM * steps + evals
    want = {"conv1x1_bn_act": CONVNEXT_BLOCKS * forwards, "wgmma": CONVNEXT_WGMMA_BLOCKS * forwards,
            "cuda_cores": (CONVNEXT_BLOCKS - CONVNEXT_WGMMA_BLOCKS) * forwards, "conv1x1_bwd_dz": 0}
    launched = {"conv1x1_bn_act": k4l["conv1x1_bn_act"], "wgmma": by_variant[("conv1x1_bn_act", "wgmma")],
                "cuda_cores": by_variant[("conv1x1_bn_act", "cuda_cores")], "conv1x1_bwd_dz": k4l["conv1x1_bwd_dz"]}
    if launched != want:
        raise RuntimeError(f"expected conv1x1 launches {want} (36 a micro-batch forward: 6 wgmma, 30 CUDA cores), "
                           f"got {launched}")
    if any(launches["fa"].values()):
        raise RuntimeError(f"flash kernels launched on the ConvNeXt path: {launches['fa']}")

    model.eval()
    x, _ = _normalised(model, val_batch)
    with torch.no_grad():
        plain = ConvNeXtL(21841, dtype=torch.bfloat16, pallas=False, device="cuda").eval()
        plain.load_state_dict(model.inner.state_dict())
        got, ref = model.inner(x), plain(x)
    plain_rel = _agreement("[convnext]", "trained model, 32 val images, K4's gelu epilogue vs PALLAS=0: logits", got, ref,
                           CONVNEXT_PLAIN_REL)
    del plain, model
    torch.cuda.empty_cache()
    figures["plain_rel"] = plain_rel
    figures["turns"] = _knobs_in_turns("[convnext-ab]", CONVNEXT_ENV, run_dir, CONVNEXT_BATCH, ("1", "0"), n_steps=3)
    return launched, figures


FOLDER_LABELS = ["cat", "dog", "snake"]
FOLDER_COUNTS = {"train": 32, "val": 8, "test": 8}  # per label: 6 train steps an epoch at batch 16
FOLDER_BATCH = 16
FOLDER_SIZE = 224
FOLDER_EPOCHS = 2  # then one resumed epoch
FOLDER_SHAPES = [(180, 240), (256, 256), (333, 200)]  # (height, width): the resize does work
# VGG16 at 224x224: 15.47 G multiply-adds per image forward, three times that for forward
# and backward.
FOLDER_FLOP_PER_IMAGE = 3 * 2 * 15.47e9


def bmp_bytes(rgb) -> bytes:
    """A 24-bit bottom-up BMP of an RGB image."""
    import struct

    h, w, _ = rgb.shape
    stride = (w * 3 + 3) // 4 * 4
    pixels = np.zeros((h, stride), np.uint8)
    pixels[:, : w * 3] = rgb[::-1, :, ::-1].reshape(h, w * 3)
    header = struct.pack("<2sIHHI", b"BM", 54 + pixels.size, 0, 0, 54)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, pixels.size, 2835, 2835, 0, 0)
    return header + info + pixels.tobytes()


def image_file(rgb, kind: str) -> bytes:
    """``rgb`` as a file of ``kind``: ``png0`` (gray), ``png2`` (RGB), ``png3`` (a 3-3-2
    palette), ``png6`` (RGBA), ``bmp`` (24-bit), or a baseline JPEG from the port's encoder:
    ``jpg90``/``jpg60`` (4:2:0 at quality 90/60), ``jpg444`` (4:4:4 at 85), ``jpggrey``
    (grey at 90)."""
    from distributed_training_pytorch_tpu_torch.data import native
    from distributed_training_pytorch_tpu_torch.data.png import png_bytes

    h, w, _ = rgb.shape
    if kind == "bmp":
        return bmp_bytes(rgb)
    if kind in ("jpg90", "jpg60"):
        return native.jpeg_encode(rgb, int(kind[3:]))
    if kind == "jpg444":
        return native.jpeg_encode(rgb, 85, subsampling="4:4:4")
    if kind == "jpggrey":
        return native.jpeg_encode(rgb.mean(axis=2).astype(np.uint8), 90)
    if kind == "png0":
        return png_bytes(rgb.mean(axis=2).astype(np.uint8), 0)
    if kind == "png2":
        return png_bytes(rgb.reshape(h, w * 3), 2)
    if kind == "png3":
        index = (rgb[..., 0] >> 5 << 5) | (rgb[..., 1] >> 5 << 2) | (rgb[..., 2] >> 6)
        levels = np.arange(256)
        palette = np.stack([(levels >> 5) * 36, ((levels >> 2) & 7) * 36, (levels & 3) * 85], 1).astype(np.uint8)
        return png_bytes(index.astype(np.uint8), 3, palette.tobytes())
    alpha = np.full((h, w, 1), 200, np.uint8)
    return png_bytes(np.concatenate([rgb, alpha], 2).reshape(h, w * 4), 6)


FOLDER_KINDS = ["png2", "png0", "png3", "png6", "bmp", "jpg90", "jpg60", "jpg444", "jpggrey"]


def write_folder_tree(root: str, seed: int = 0) -> dict:
    """``train``/``val``/``test`` x ``FOLDER_LABELS``: class-coloured images with a smooth
    pattern and noise, in every file kind of ``FOLDER_KINDS`` and every shape of
    ``FOLDER_SHAPES``, the first ``jpg90`` file of the first train label with an EXIF
    orientation of 6 (``jpg90_exif6``); returns the count of files by kind."""
    from distributed_training_pytorch_tpu_torch.data import jpeg

    rng = np.random.default_rng(seed)
    kinds = dict.fromkeys(FOLDER_KINDS + ["jpg90_exif6"], 0)
    for split, n in FOLDER_COUNTS.items():
        for li, label in enumerate(FOLDER_LABELS):
            os.makedirs(os.path.join(root, split, label))
            for i in range(n):
                h, w = FOLDER_SHAPES[i % len(FOLDER_SHAPES)]
                yy, xx = np.mgrid[0:h, 0:w]
                base = np.array([70 + 60 * li, 190 - 60 * li, 100 + 30 * li], np.float32)
                wave = 30 * np.sin(xx / (9 + 4 * li) + yy / 13)[..., None]
                img = np.clip(base + wave + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)
                kind = FOLDER_KINDS[(i + li) % len(FOLDER_KINDS)]
                data = image_file(img, kind)
                if kind == "jpg90" and split == "train" and li == 0 and not kinds["jpg90_exif6"]:
                    data, kind = jpeg.with_orientation(data, 6), "jpg90_exif6"
                kinds[kind] += 1
                with open(os.path.join(root, split, label, f"{i:03d}.{kind[:3]}"), "wb") as f:
                    f.write(data)
    return kinds


def _host_ms(fn, reps: int = 20) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def folder_host_times(root: str) -> dict:
    """Host ms per 224x224 image of each of the ten train transforms (each made to fire,
    at its largest kernel, on one thread of the calling process) and of the decoders (a
    file of each kind, 256x200)."""
    from distributed_training_pytorch_tpu_torch.data import dataset
    from distributed_training_pytorch_tpu_torch.data import transforms as T

    rng = np.random.default_rng(1)
    src = np.clip(rng.normal(128, 40, (333, 200, 3)), 0, 255).astype(np.uint8)
    img = T.resize(FOLDER_SIZE, FOLDER_SIZE)(src, None)
    gen = np.random.default_rng(2)
    made = {
        "resize": lambda: T.resize(FOLDER_SIZE, FOLDER_SIZE)(src, gen),
        "random_rotate90": lambda: np.ascontiguousarray(T.random_rotate90(1.0)(img, gen)),
        "horizontal_flip": lambda: np.ascontiguousarray(T.horizontal_flip(1.0)(img, gen)),
        "vertical_flip": lambda: np.ascontiguousarray(T.vertical_flip(1.0)(img, gen)),
        "blur": lambda: T.blur(1.0, max_kernel=7)(img, gen),
        "median_blur": lambda: T.median_blur(1.0, max_kernel=5)(img, gen),
        "clahe": lambda: T.clahe(1.0)(img, gen),
        "random_brightness_contrast": lambda: T.random_brightness_contrast(1.0)(img, gen),
        "random_gamma": lambda: T.random_gamma(1.0)(img, gen),
        "image_compression": lambda: T.image_compression(1.0)(img, gen),
        "normalize": lambda: T.normalize()(img, gen),
    }
    times = {name: _host_ms(fn) for name, fn in made.items()}
    decoders = {}
    for kind in FOLDER_KINDS:
        path = os.path.join(root, f"decode.{kind}")
        with open(path, "wb") as f:
            f.write(image_file(np.ascontiguousarray(src[:256]), kind))
        decoders[kind] = _host_ms(lambda path=path: dataset.decode_image(path))
    return {"transforms": times, "decoders": decoders}


def phase_folder(run_dir: str):
    """The image-folder entry (``examples/example_trainer.py``'s ``ExampleTrainer``, the
    configuration of ``examples/main.py`` but for the epochs and the save period) at
    224x224, full-width VGG16 (3 classes, f32), global batch 16 on the card, over a tree of
    PNG (color types 0, 2, 3, 6, every filter type), 24-bit BMP and JPEG files (the port's
    encoder: 4:2:0 at qualities 90 and 60, 4:4:4, grey, one with an EXIF orientation of 6;
    decoded by the port's own decoder) of three shapes,
    through the ten-step train chain on 8 loader workers: 2 epochs, then a resume from
    ``last`` for a third whose train epoch is profiled; then ``eval.evaluate`` on ``last``
    and the test folder. Raises unless every loss is finite, the JPEG re-encoding, CLAHE,
    blur and median blur each fired, no hand kernel launched, the resume continued the step
    and epoch, and top-1 and top-2 lie in [0, 1]."""
    import torch

    from distributed_training_pytorch_tpu_torch.checkpoint import CheckpointManager
    from distributed_training_pytorch_tpu_torch.data import native
    from distributed_training_pytorch_tpu_torch.data import transforms as T
    from distributed_training_pytorch_tpu_torch.examples import eval as folder_eval
    from distributed_training_pytorch_tpu_torch.examples import main as folder_main
    from distributed_training_pytorch_tpu_torch.ops import conv1x1 as k4
    from distributed_training_pytorch_tpu_torch.ops import flash_attention as fa

    if not native.available():
        raise RuntimeError(f"the native data runtime did not build: {native.build_error()}")
    log(f"[folder] native data runtime built (codecs: {native.codecs_available()}) at {native.LIBRARY}")
    torch.cuda.empty_cache()
    data_root = os.path.join(run_dir, "data")
    t_tree = time.perf_counter()
    kinds = write_folder_tree(data_root)
    log(f"[folder] wrote the tree in {time.perf_counter() - t_tree:.1f} s: {FOLDER_COUNTS} files a label, by kind "
        f"{kinds}, shapes {FOLDER_SHAPES}")
    if not all(kinds.values()):
        raise RuntimeError(f"a file kind is missing from the tree: {kinds}")
    step_ms, epoch_metrics, val_metrics = [], [], []
    counts = {"steps": 0, "evals": 0}
    fired_before = dict(T.FIRED)
    fa_before, k4_before = dict(fa.launches), dict(k4.launches)

    def build(max_epoch, snapshot):
        trainer = folder_main.build_trainer(
            "cuda", train_path=os.path.join(data_root, "train"), val_path=os.path.join(data_root, "val"),
            max_epoch=max_epoch, save_period=1, save_folder=run_dir, snapshot_path=snapshot)
        return _instrument(trainer, step_ms, counts, epoch_metrics, val_metrics)

    first = build(FOLDER_EPOCHS, None)
    n_params = sum(p.numel() for p in first.model.parameters())
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first.train()
    first_steps, first_epoch = first.state.step, first.cur_epoch
    steps_per_epoch = len(first.train_dataloader)
    del first
    torch.cuda.empty_cache()
    resumed = build(FOLDER_EPOCHS + 1, "last")
    resumed_at = (resumed.state.step, resumed.cur_epoch)
    train_epoch = resumed.train_epoch
    profiled = {}

    def profiled_train_epoch(epoch):
        resumed.train_epoch = train_epoch
        metrics, profiled["figures"] = _profiled_epoch(resumed, epoch)
        return metrics

    resumed.train_epoch = profiled_train_epoch
    resumed.train()
    final_step = resumed.state.step
    wall = time.perf_counter() - t0
    fa_after, k4_after = dict(fa.launches), dict(k4.launches)
    fired = {k: T.FIRED[k] - fired_before.get(k, 0) for k in T.FIRED}
    del resumed
    torch.cuda.empty_cache()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    t_eval = time.perf_counter()
    scores = folder_eval.evaluate(os.path.join(run_dir, "weights", "last"), os.path.join(data_root, "test"),
                                  FOLDER_LABELS, device="cuda")
    eval_s = time.perf_counter() - t_eval
    host = folder_host_times(run_dir)

    times = [s.elapsed_time(e) for s, e in step_ms]
    steady = sorted(t for i, t in enumerate(times) if i % steps_per_epoch)  # epoch starts follow val/saves
    median_ms = steady[len(steady) // 2]
    host_issue = sorted(counts["host_ms"][i] for i in range(len(times)) if i % steps_per_epoch)
    new = profiled["figures"]
    log(f"[folder] VGG16 ({n_params:,} params, f32), {FOLDER_SIZE}x{FOLDER_SIZE}, global batch {FOLDER_BATCH}, "
        f"{steps_per_epoch} steps/epoch; {counts['steps']} steps and {counts['evals']} validation forwards in "
        f"{wall:.1f} s (decoding, the train chain, validation and saves included)")
    for i, m in enumerate(epoch_metrics):
        log(f"[folder] epoch {i}: train ce {m['ce_loss']:.4f} acc {m['accuracy']:.4f} lr {m['lr']:.4g}")
    for i, vm in enumerate(val_metrics):
        log(f"[folder] validation {i}: ce {vm['ce_loss']:.4f} acc {vm['accuracy']:.4f}")
    log(f"[folder] transforms fired in the phase (the train chain, on 8 loader workers): {dict(sorted(fired.items()))}")
    log(f"[folder] step time median {median_ms:.2f} ms (min {steady[0]:.2f}, max {steady[-1]:.2f}, first "
        f"{times[0]:.2f}); {_images_per_s(FOLDER_BATCH, median_ms):.0f} images/s; "
        f"{FOLDER_FLOP_PER_IMAGE * FOLDER_BATCH / median_ms / 1e9:.1f} TFLOP/s; peak memory {peak_gb:.2f} GB; the host "
        f"takes {host_issue[len(host_issue) // 2]:.2f} ms (median) to issue a step")
    log(f"[folder] resumed train epoch ({steps_per_epoch} steps): wall {new['wall_ms']:.1f} ms, device busy time "
        f"{new['busy_ms']:.1f} ms, busy share {_fmt_busy(new['busy'])}")
    log(f"[folder] host ms per {FOLDER_SIZE}x{FOLDER_SIZE} image, one thread: "
        + ", ".join(f"{k} {v:.3f}" for k, v in host["transforms"].items())
        + "; decode a 256x200 file: " + ", ".join(f"{k} {v:.3f}" for k, v in host["decoders"].items()))
    log(f"[folder] eval.evaluate on last, test folder ({FOLDER_COUNTS['test'] * len(FOLDER_LABELS)} images): top-1 "
        f"{scores['top1']:.4f}, top-2 {scores['top2']:.4f} in {eval_s:.1f} s")

    losses = [m["ce_loss"] for m in epoch_metrics] + [m["ce_loss"] for m in val_metrics]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite losses: {losses}")
    missing = [k for k in ("image_compression", "clahe", "blur", "median_blur") if fired.get(k, 0) < 1]
    if missing:
        raise RuntimeError(f"transforms that never fired in the phase: {missing} (fired: {fired})")
    if fa_after != fa_before or k4_after != k4_before:
        raise RuntimeError(f"hand kernels launched in the folder phase: {fa_before} -> {fa_after}, {k4_before} -> {k4_after}")
    if n_params != 134_272_835:
        raise RuntimeError(f"expected VGG16's 134,272,835 params at 3 classes, got {n_params}")
    if (first_steps, first_epoch) != (FOLDER_EPOCHS * steps_per_epoch, FOLDER_EPOCHS - 1):
        raise RuntimeError(f"first run ended at step {first_steps}, epoch {first_epoch}")
    if resumed_at != (FOLDER_EPOCHS * steps_per_epoch, FOLDER_EPOCHS) or final_step != (FOLDER_EPOCHS + 1) * steps_per_epoch:
        raise RuntimeError(f"resume at (step, epoch) {resumed_at}, ended at step {final_step}")
    manager = CheckpointManager(os.path.join(run_dir, "weights"))
    meta = manager.read_meta("last")
    if (meta["epoch"], meta["step"]) != (FOLDER_EPOCHS + 1, final_step):
        raise RuntimeError(f"last checkpoint meta {meta}")
    if not (0.0 <= scores["top1"] <= scores["top2"] <= 1.0):
        raise RuntimeError(f"eval scores out of range: {scores}")
    log(f"[folder] resumed at step {resumed_at[0]}, epoch {resumed_at[1]}; last = epoch {meta['epoch']}, step "
        f"{meta['step']}; hand-kernel launches in the phase: 0")
    return {"step_ms": median_ms, "images_per_s": _images_per_s(FOLDER_BATCH, median_ms), "peak_gb": peak_gb,
            "new": new, "host": host, "fired": fired, "scores": scores}


def phase_convnext_times(card: str):
    """K4 with the gelu epilogue at ConvNeXt-L's four expand shapes (micro-batch 64, bf16,
    a unit scale, an f32 bias): kernel, plain, bound, and ``F.linear`` then
    ``F.gelu(approximate="tanh")`` as the yardstick; returns the rows and the sums over one
    micro-batch forward (each shape times its blocks)."""
    import torch
    import torch.nn.functional as F

    from distributed_training_pytorch_tpu_torch.ops import conv1x1 as k4

    gen = torch.Generator(device="cuda").manual_seed(2024)
    counts = (dict(k4.launches), dict(k4.launches_by_variant))  # timing launches are not the main path's
    rows = []
    for name, n, cin, cout, blocks in CONVNEXT_K4_SHAPES:
        x = torch.randn(n, cin, device="cuda", generator=gen).to(torch.bfloat16)
        w = (torch.randn(cout, cin, device="cuda", generator=gen) * cin**-0.5).to(torch.bfloat16)
        ones, bias = torch.ones(cout, device="cuda"), 0.1 * torch.randn(cout, device="cuda", generator=gen)
        bias16 = bias.to(torch.bfloat16)
        variant = k4.conv1x1_variant(x, cout)
        ms = time_ms(lambda: k4.conv1x1_bn_act(x, w, ones, bias, act="gelu"))
        plain_ms = time_ms(lambda: k4.conv1x1_bn_act_plain(x, w, ones, bias, act="gelu"), iters=5)
        library_ms = time_ms(lambda: F.gelu(F.linear(x, w, bias16), approximate="tanh"))
        bound_ms, bound_by, flops, nbytes = conv1x1_bound(n, cin, cout)
        log(f"[times] {card} | conv1x1 gelu convnext_l {name} N={n} {cin}->{cout} bf16 ({variant}, {blocks} blocks): "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, F.linear + F.gelu(tanh) {library_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB), {bound_ms / ms:.4f} of "
            f"the bound, {ms / library_ms:.2f}x the library")
        rows.append({"name": name, "shape": [n, cin, cout], "variant": variant, "blocks": blocks, "ms": ms,
                     "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by})
        del x, w
        torch.cuda.empty_cache()
    k4.launches.update(counts[0])
    k4.launches_by_variant.update(counts[1])
    total = {k: sum(r[k] * r["blocks"] for r in rows) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    total["bound_by"] = "operations" if all(r["bound_by"] == "operations" for r in rows) else "bytes"
    log(f"[times] {card} | conv1x1 gelu, the 36 launches of one ConvNeXt-L micro-batch forward (64 images): kernel "
        f"{total['ms']:.4f} ms, plain {total['plain_ms']:.4f} ms, library {total['library_ms']:.4f} ms, bound "
        f"{total['bound_ms']:.4f} ms ({total['bound_ms'] / total['ms']:.4f} of it); x{CONVNEXT_ACCUM} a train step")
    return rows, total


# Real data: the digits corpus (1,438 train, 359 test 32x32 images) through the digits entry
# (VGG16) and, packed into record shards, through the records entry (ResNet18Slim); then
# ResNet-50 through the ImageNet entry on record shards of ImageNet-sized PNG images.
DIGITS_BATCH = 128
DIGITS_EPOCHS = 3  # then one resumed epoch
DIGITS_SPLIT = {"train": 1438, "test": 359}
FP16_EPOCHS = 2
DIGITS_VGG16_PARAMS = 134_301_514  # 10 classes
DATA_KEYS = ("DIGITS_DIR", "RECORDS_DIR", "SAVE_DIR", "EPOCHS", "BATCH", "DIGITS_LR", "RECORDS_LR", "SAVE_PERIOD",
             "SNAPSHOT", "DTYPE", "PALLAS", "MESH", "CHAIN_STEPS", "TELEMETRY", "DEVICE")
R50_LABELS = 16  # class folders of the synthetic tree; the model keeps ImageNet's 1000 outputs
R50_SHAPES = [(375, 500), (500, 375), (333, 500), (500, 500)]  # (height, width): ImageNet's usual sizes
R50_JPEG_QUALITY = 90  # baseline 4:2:0, as ImageNet's JPEG files are written


@contextlib.contextmanager
def _knobs(**values):
    """The data entries' knobs (``DATA_KEYS``) unset but for ``values`` for the block,
    restored after it."""
    saved = {k: os.environ.get(k) for k in (*DATA_KEYS, *values)}
    for k in saved:
        os.environ.pop(k, None)
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _hand_kernel_counts():
    from distributed_training_pytorch_tpu_torch.ops import conv1x1 as k4
    from distributed_training_pytorch_tpu_torch.ops import flash_attention as fa

    return dict(fa.launches), dict(k4.launches)


def _run_main(entry, step_ms, counts, epoch_metrics, val_metrics, profile=False):
    """``entry.main("cuda")`` (materialise, train, evaluate the saved checkpoints, write the
    summary) with the trainer it builds instrumented (``_instrument``); with ``profile`` the
    trainer's first train epoch runs under the profiler. Returns the trainer, the summary
    and the profiled epoch's figures (None without ``profile``)."""
    build = entry.build_trainer
    profiled = {}

    def instrumented(*args, **kw):
        trainer = _instrument(build(*args, **kw), step_ms, counts, epoch_metrics, val_metrics)
        if profile:
            recorded = trainer.train_epoch

            def profiled_epoch(epoch):
                trainer.train_epoch = recorded
                metrics, profiled["figures"] = _profiled_epoch(trainer, epoch)
                return metrics

            trainer.train_epoch = profiled_epoch
        return trainer

    entry.build_trainer = instrumented
    try:
        trainer, summary = entry.main("cuda")
    finally:
        entry.build_trainer = build
    return trainer, summary, profiled.get("figures")


def _data_entry_run(tag, entry, run_dir, epochs):
    """``entry`` (``train_digits`` or ``train_records``) through its ``main``: ``epochs``
    epochs, then a resume from ``last`` for one more whose train epoch is profiled. Raises
    unless the split is the corpus's, every loss is finite, the train CE falls below the
    first epoch's, the resume
    continues the step and the epoch, each saved checkpoint's top-1 and top-2 lie in [0, 1]
    and no hand kernel launched; returns the figures and the resumed trainer."""
    import torch

    step_ms, epoch_metrics, val_metrics = [], [], []
    counts = {"steps": 0, "evals": 0}
    before = _hand_kernel_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    digits = os.path.join(run_dir, "digits")
    with _knobs(DIGITS_DIR=digits, SAVE_DIR=os.path.join(run_dir, "run"), EPOCHS=str(epochs),
                BATCH=str(DIGITS_BATCH)):
        first, summary, _ = _run_main(entry, step_ms, counts, epoch_metrics, val_metrics)
        first_at = (first.state.step, first.cur_epoch)
        steps_per_epoch = len(first.train_dataloader)
        del first
        torch.cuda.empty_cache()
        os.environ.update(EPOCHS=str(epochs + 1), SNAPSHOT="last")
        resumed, resumed_summary, busy = _run_main(entry, step_ms, counts, epoch_metrics, val_metrics, profile=True)
    wall = time.perf_counter() - t0
    after = _hand_kernel_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    times = [s.elapsed_time(e) for s, e in step_ms]
    steady = sorted(t for i, t in enumerate(times) if i % steps_per_epoch)  # epoch starts follow val/saves
    median_ms = steady[len(steady) // 2]
    host_issue = sorted(counts["host_ms"][i] for i in range(len(times)) if i % steps_per_epoch)
    for i, m in enumerate(epoch_metrics):
        extra = f" loss scale {m['loss_scale']:.0f}" if "loss_scale" in m else ""
        log(f"{tag} epoch {i}: train ce {m['ce_loss']:.4f} acc {m['accuracy']:.4f} lr {m['lr']:.4g}{extra}")
    for i, vm in enumerate(val_metrics):
        log(f"{tag} validation {i}: ce {vm['ce_loss']:.4f} acc {vm['accuracy']:.4f}")
    log(f"{tag} corpus {summary['train_images']} train / {summary['test_images']} test images; {counts['steps']} steps "
        f"and {counts['evals']} validation forwards in {wall:.1f} s (two runs of the entry: materialising, packing, "
        f"saves and the evaluations included); step time median {median_ms:.2f} ms (min {steady[0]:.2f}, max "
        f"{steady[-1]:.2f}); {_images_per_s(DIGITS_BATCH, median_ms):.0f} images/s; the host takes "
        f"{host_issue[len(host_issue) // 2]:.2f} ms (median) to issue a step; peak memory {peak_gb:.2f} GB")
    log(f"{tag} resumed train epoch ({steps_per_epoch} steps): wall {busy['wall_ms']:.1f} ms, device busy time "
        f"{busy['busy_ms']:.1f} ms, busy share {_fmt_busy(busy['busy'])}")
    for name, scores in resumed_summary["results"].items():
        log(f"{tag} eval.evaluate on {name}: top-1 {scores['top1']:.4f}, top-2 {scores['top2']:.4f}")

    if {"train": summary["train_images"], "test": summary["test_images"]} != DIGITS_SPLIT:
        raise RuntimeError(f"the digits split is {summary['train_images']}/{summary['test_images']}")
    losses = [m["ce_loss"] for m in epoch_metrics] + [m["ce_loss"] for m in val_metrics]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite losses: {losses}")
    # VGG16, which has no BatchNorm, sits near ln 10 for its first epochs at the recipe's lr
    # (the JAX record's curve: 2.303, 2.273, 2.301, 2.298), so the check is that a later
    # epoch's train CE lies below the first's, not the last's
    if not min(m["ce_loss"] for m in epoch_metrics[1:]) < epoch_metrics[0]["ce_loss"]:
        raise RuntimeError(f"the train CE did not fall: {[m['ce_loss'] for m in epoch_metrics]}")
    if first_at != (epochs * steps_per_epoch, epochs - 1):
        raise RuntimeError(f"first run ended at (step, epoch) {first_at}")
    if (resumed.state.step, resumed.cur_epoch) != ((epochs + 1) * steps_per_epoch, epochs):
        raise RuntimeError(f"the resumed run ended at (step, epoch) {(resumed.state.step, resumed.cur_epoch)}")
    if set(resumed_summary["results"]) != {"best", "last"} or not all(
            0.0 <= r["top1"] <= r["top2"] <= 1.0 for r in resumed_summary["results"].values()):
        raise RuntimeError(f"eval scores: {resumed_summary['results']}")
    if after != before:
        raise RuntimeError(f"hand kernels launched in the phase: {before} -> {after}")
    log(f"{tag} resumed at step {epochs * steps_per_epoch}, epoch {epochs}; hand-kernel launches in the phase: 0")
    figures = {"step_ms": median_ms, "images_per_s": _images_per_s(DIGITS_BATCH, median_ms), "peak_gb": peak_gb,
               "busy": busy, "results": resumed_summary["results"], "wall_s": wall,
               "curve": [m["ce_loss"] for m in epoch_metrics]}
    return figures, resumed


def phase_digits(run_dir: str):
    """VGG16 on the digits corpus through the digits entry (``examples/train_digits.py``'s
    ``main``: the tree materialised from ``digits_8x8.npz`` with the port's PNG writer, the
    digits train chain on 8 loader workers, f32, global batch 128): 3 epochs, then a
    resumed fourth whose train epoch is profiled, each run ending in ``eval.evaluate`` of
    ``best`` and ``last``."""
    from distributed_training_pytorch_tpu_torch.examples import train_digits

    figures, trainer = _data_entry_run("[digits]", train_digits, run_dir, DIGITS_EPOCHS)
    if sum(p.numel() for p in trainer.model.parameters()) != DIGITS_VGG16_PARAMS:
        raise RuntimeError(f"expected VGG16's {DIGITS_VGG16_PARAMS:,} params at 10 classes")
    return figures


def _corrupt_one_payload(pattern, index):
    """Overwrite record ``index``'s payload in its shard with seeded garbage."""
    from distributed_training_pytorch_tpu_torch.data import RecordFileSource

    src = RecordFileSource(pattern)
    shard, local = src._locate(index)
    payload, _ = src.read_record(index)
    with open(src.paths[shard], "r+b") as f:
        f.seek(int(src._shard_offsets[shard][local]) + 16)
        f.write(np.random.default_rng(index).integers(0, 256, len(payload), dtype=np.uint8).tobytes())


def phase_records(run_dir: str):
    """ResNet18Slim on the digits corpus through record shards (``examples/
    train_records.py``'s ``main``: the tree packed into 4 + 2 shards, decoded on the
    codec-free route where the library has no libpng, cropped natively, uint8 to the card,
    global batch 128): 3 epochs, then a resumed fourth whose train epoch is profiled, each
    run ending in ``eval.evaluate`` through the image-folder path; then one epoch on a copy
    of the shards with one payload overwritten by garbage under ``skip_corrupt_records=True``,
    which must skip exactly that record."""
    from distributed_training_pytorch_tpu_torch.data import native
    from distributed_training_pytorch_tpu_torch.examples import train_records

    figures, trainer = _data_entry_run("[records]", train_records, run_dir, DIGITS_EPOCHS)
    log(f"[records] the library was built {'with' if native.codecs_available() else 'without'} codecs: the "
        f"{'fused decode entries' if native.codecs_available() else 'codec-free route (zlib, the unfilter, the uint8 entries)'}"
        " decoded the shards")
    records = os.path.join(run_dir, "digits", "records")
    corrupt = os.path.join(run_dir, "corrupt")
    shutil.copytree(records, corrupt)
    patterns = {split: os.path.join(corrupt, f"{split}-*.rec") for split in ("train", "test")}
    with _knobs(BATCH=str(DIGITS_BATCH)):
        tolerant = train_records.build_trainer(patterns, os.path.join(run_dir, "tolerant"), "cuda", max_epoch=1,
                                               skip_corrupt_records=True, have_validate=False)
    loader = tolerant.train_dataloader
    loader.set_epoch(0)
    victim = int(loader._global_order()[0])  # a record of the epoch's first batch
    _corrupt_one_payload(patterns["train"], victim)
    before = _hand_kernel_counts()
    tolerant.train()
    if loader.corrupt_skipped != 1 or _hand_kernel_counts() != before:
        raise RuntimeError(f"expected the one corrupt record skipped, got {loader.corrupt_skipped}")
    log(f"[records] one epoch over shards with record {victim}'s payload overwritten, skip_corrupt_records=True: "
        f"{loader.corrupt_skipped} record skipped, train step {tolerant.state.step}")
    del trainer, tolerant
    return figures


def write_r50_tree(root: str, n_train: int, n_val: int, seed: int = 0) -> int:
    """``train``/``val`` x ``R50_LABELS`` classes of smooth class-coloured RGB images of
    ``R50_SHAPES`` with a little noise, as baseline 4:2:0 JPEG files at quality 90 (what
    ImageNet's shards hold; the port's encoder), made from ``seed`` on a pool of threads;
    returns the bytes written."""
    import concurrent.futures as cf

    from distributed_training_pytorch_tpu_torch.data import native

    rng = np.random.default_rng(seed)
    jobs = []
    for split, n in (("train", n_train), ("val", n_val)):
        for label in range(R50_LABELS):
            os.makedirs(os.path.join(root, split, f"{label:02d}"))
        for i in range(n):
            label = i % R50_LABELS
            jobs.append((os.path.join(root, split, f"{label:02d}", f"{i:05d}.jpg"), label, i,
                         rng.uniform(9, 31, 3), rng.uniform(0, 6.3, 3)))

    def one(job):
        path, label, i, periods, phases = job
        h, w = R50_SHAPES[i % len(R50_SHAPES)]
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        base = 60 + 8 * label
        img = np.stack([base + 50 * np.sin(xx / periods[0] + yy / 29 + phases[0]),
                        200 - base // 2 + 40 * np.cos(yy / periods[1] + phases[1]),
                        120 + 45 * np.sin((xx + yy) / periods[2] + phases[2])], -1)
        img += np.random.default_rng(i).normal(0, 6, img.shape).astype(np.float32)
        data = native.jpeg_encode(np.clip(img, 0, 255).astype(np.uint8), R50_JPEG_QUALITY)
        with open(path, "wb") as f:
            f.write(data)
        return len(data)

    with cf.ThreadPoolExecutor(8) as pool:
        return sum(pool.map(one, jobs))


def _data_paths_in_turns(trainer, epoch, paths, order=("records", "synthetic", "synthetic", "records")):
    """The same train epoch of one warm trainer over each loader of ``paths`` in turns;
    returns each path's profiled figures per run. The trainer's instrumented hooks are
    dropped first, so these steps are not counted as the phase's."""
    for hook in ("train_step", "validate_step", "train_epoch", "validate"):
        trainer.__dict__.pop(hook, None)
    own = trainer.train_dataloader
    runs = {name: [] for name in paths}
    try:
        for name in order:
            trainer.train_dataloader = paths[name]
            runs[name].append(_profiled_epoch(trainer, epoch)[1])
    finally:
        trainer.train_dataloader = own
    return runs


def phase_records_resnet50(run_dir: str):
    """ResNet-50 through the ImageNet entry on record shards (``MODEL=resnet50 PALLAS=1``,
    ``IMAGENET_RECORDS``/``VAL_RECORDS``): a seeded tree of smooth JPEG images (4:2:0,
    quality 90) of ImageNet's usual sizes packed into 8 + 2 shards, global batch 256, 3 steps
    an epoch, 2 epochs and a resumed third (the port's own JPEG decoder + random-resized crop
    + flip in one native call a batch on 8 loader workers, uint8 to the card). Raises unless
    the payloads are JPEG, every loss is finite and K4 launched exactly 9 times a train step
    and a val forward, all on the wgmma variant, and its dz pass 9 times a step; then the
    resumed train epoch on one warm trainer over the records and over the synthetic set, in
    turns."""
    import torch

    from distributed_training_pytorch_tpu_torch.data import native, pack_image_folder
    from distributed_training_pytorch_tpu_torch.examples import train_imagenet

    torch.backends.cudnn.allow_tf32 = True  # the entry's own settings: bf16 convolutions
    tree = os.path.join(run_dir, "tree")
    t0 = time.perf_counter()
    nbytes = write_r50_tree(tree, 3 * RESNET_BATCH, RESNET_BATCH)
    t_tree = time.perf_counter() - t0
    labels = [f"{i:02d}" for i in range(R50_LABELS)]
    shards = os.path.join(run_dir, "shards")
    pack_image_folder(os.path.join(tree, "train"), labels, os.path.join(shards, "train"), num_shards=8)
    pack_image_folder(os.path.join(tree, "val"), labels, os.path.join(shards, "val"), num_shards=2)
    from distributed_training_pytorch_tpu_torch.data import RecordFileSource

    first = RecordFileSource(os.path.join(shards, "train-*.rec")).read_record(0)[0]
    if first[:2] != b"\xff\xd8":
        raise RuntimeError(f"expected JPEG payloads in the shards, got {first[:8]!r}")
    log(f"[records_resnet50] wrote {4 * RESNET_BATCH} JPEG images (4:2:0, quality {R50_JPEG_QUALITY}; "
        f"{nbytes / 1e6:.1f} MB; {R50_SHAPES}) in {t_tree:.1f} s "
        f"and packed them in {time.perf_counter() - t0 - t_tree:.1f} s; library codecs: {native.codecs_available()}")
    env = dict(RESNET_ENV, IMAGENET_RECORDS=os.path.join(shards, "train-*.rec"),
               VAL_RECORDS=os.path.join(shards, "val-*.rec"))
    figures, launches, counts, model, _ = _entry_run("[records_resnet50]", env, os.path.join(run_dir, "run"),
                                                     RESNET_BATCH)
    del model
    k4_n, k4_wgmma, dz_n = (launches["k4"]["conv1x1_bn_act"], launches["k4_variant"][("conv1x1_bn_act", "wgmma")],
                            launches["k4"]["conv1x1_bwd_dz"])
    log(f"[records_resnet50] conv1x1 launches {k4_n} ({k4_wgmma} on the wgmma variant), backward dz launches {dz_n}, "
        f"over {counts['steps']} steps and {counts['evals']} validation forwards")
    if k4_n != len(RESNET_K4_SHAPES) * (counts["steps"] + counts["evals"]) or k4_wgmma != k4_n:
        raise RuntimeError(f"expected {len(RESNET_K4_SHAPES)} conv1x1 launches per train step and val forward, all on "
                           f"the wgmma variant, got {k4_n} ({k4_wgmma} wgmma)")
    if dz_n != len(RESNET_K4_SHAPES) * counts["steps"]:
        raise RuntimeError(f"expected {len(RESNET_K4_SHAPES)} dz launches per train step, got {dz_n}")
    torch.cuda.empty_cache()

    with _entry_env(env, SAVE_DIR=os.path.join(run_dir, "run"), EPOCHS=str(ENTRY_EPOCHS + 1), SNAPSHOT="last"):
        trainer = train_imagenet.build_trainer("cuda")
    size = trainer.image_size
    synthetic = train_imagenet.synthetic_source(
        len(trainer.train_dataloader) * RESNET_BATCH, size, trainer.num_classes,
        train_imagenet.train_transform(size, seed=trainer.seed), seed=0)
    paths = {"records": trainer.train_dataloader, "synthetic": trainer.build_dataloader(synthetic, phase="train")}
    _profiled_epoch(trainer, ENTRY_EPOCHS)  # warm: cuDNN's choices, the allocator, the workers' first decode
    turns = _data_paths_in_turns(trainer, ENTRY_EPOCHS, paths)
    log(f"[records_resnet50] the resumed train epoch ({len(trainer.train_dataloader)} steps) on one warm trainer, "
        f"in turns: {_turns_line(turns)}")
    del trainer, paths, synthetic
    torch.cuda.empty_cache()
    return {**figures, "turns": turns}, {"conv1x1_bn_act": k4_n, "conv1x1_bwd_dz": dz_n}


JPEG_FIXTURES = os.path.join(REPO, "tests", "data", "jpeg")
JPEG_TIMED_SHAPE = (375, 500)  # ImageNet's most common size
JPEG_BATCH, JPEG_THREADS = 256, 8  # a ResNet-50 step's images, on the loader's 8 threads


def phase_jpeg(card: str):
    """The port's own JPEG decoder on the card's machine (which has no OpenCV, libjpeg or
    libpng): each committed fixture (``tests/data/jpeg/``, written by OpenCV: progressive,
    the five samplings, restart intervals, optimised tables, grey, a quality-100 noise image,
    an EXIF orientation) decoded by the library this machine built, its RGB bytes' SHA-256
    equal to what ``cv2`` gave (``manifest.json``, recomputed by ``tests/test_torch_jpeg.py``),
    without and with the EXIF orientation; then host times: ``native.jpeg_decode`` of a
    375x500 quality-90 4:2:0 image on one thread, and the fused batch entry
    (``decode_rrc_flip_u8_bytes``, the ResNet-50 train route) over 256 such payloads on 8
    threads. Raises on any hash that differs."""
    import hashlib

    from distributed_training_pytorch_tpu_torch.data import dataset, native

    if not native.available():
        raise RuntimeError(f"the native data runtime did not build: {native.build_error()}")
    with open(os.path.join(JPEG_FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)["files"]
    bad = []
    for name, entry in sorted(manifest.items()):
        path = os.path.join(JPEG_FIXTURES, name)
        with open(path, "rb") as f:
            data = f.read()
        plain = hashlib.sha256(native.jpeg_decode(data, name).tobytes()).hexdigest()
        turned = hashlib.sha256(dataset.decode_image(path).tobytes()).hexdigest()
        if (plain, turned) != (entry["sha256"], entry["sha256_oriented"]):
            bad.append(name)
    log(f"[jpeg] {len(manifest) - len(bad)} of {len(manifest)} fixtures decode to cv2's bytes (library built "
        f"{'with' if native.codecs_available() else 'without'} libpng: -DDTP_NO_CODECS "
        f"{'off' if native.codecs_available() else 'on'})")
    if bad:
        raise RuntimeError(f"fixtures whose decoded bytes differ from the manifest: {bad}")
    h, w = JPEG_TIMED_SHAPE
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 90 * np.sin(xx / 23 + yy / 41), 120 + 70 * np.cos(yy / 17), 60 + xx * 0.3], -1)
    img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.uint8)
    payload = native.jpeg_encode(img, 90)
    one_ms = _host_ms(lambda: native.jpeg_decode(payload), reps=50)
    payloads = [payload] * JPEG_BATCH
    idx = np.arange(JPEG_BATCH)
    batch_ms = _host_ms(lambda: native.decode_rrc_flip_u8_bytes(payloads, 224, 224, idx, seed=0, epoch=0,
                                                                threads=JPEG_THREADS), reps=5)
    rate = JPEG_BATCH / batch_ms * 1e3
    log(f"[jpeg] {card} | host times on the card's machine (its CPU, not the card): decode of a {h}x{w} quality-90 "
        f"4:2:0 JPEG ({len(payload)} bytes) {one_ms:.3f} ms on one thread; the fused decode + random-resized crop + "
        f"flip entry over {JPEG_BATCH} of them on {JPEG_THREADS} threads {batch_ms:.1f} ms, {rate:.0f} images/s")
    return {"fixtures": len(manifest), "decode_ms": one_ms, "batch_ms": batch_ms, "images_per_s": rate}


def phase_fp16(run_dir: str):
    """VGG16 on the digits corpus through the digits entry with ``DTYPE=fp16`` (f32
    params, fp16 compute, dynamic loss scaling from 2^15): 2 epochs; then one step on an
    input forced past fp16's range, which must be skipped with params and buffers
    bit-equal, the scale halved and one skip counted; then a clean step, a save of
    ``last`` and a new trainer resumed from it, which must carry the scale, the counter
    and the skip count."""
    import torch

    from distributed_training_pytorch_tpu_torch.examples import train_digits

    step_ms, epoch_metrics, val_metrics = [], [], []
    counts = {"steps": 0, "evals": 0}
    before = _hand_kernel_counts()
    digits, save = os.path.join(run_dir, "digits"), os.path.join(run_dir, "run")
    with _knobs(DIGITS_DIR=digits, SAVE_DIR=save, EPOCHS=str(FP16_EPOCHS), BATCH=str(DIGITS_BATCH), DTYPE="fp16"):
        trainer, summary, _ = _run_main(train_digits, step_ms, counts, epoch_metrics, val_metrics)
        for hook in ("train_step", "validate_step", "train_epoch", "validate"):
            trainer.__dict__.pop(hook, None)
        params = dict(trainer.model.named_parameters())
        if trainer.precision.name != "fp16" or any(p.dtype != torch.float32 for p in params.values()):
            raise RuntimeError("expected the fp16 policy over f32 params")
        batches = trainer.device_batches(trainer.train_dataloader)
        batch = next(batches)
        batches.close()
        state_before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        scale_before = trainer.state.loss_scale
        huge = dict(batch, image=torch.full_like(batch["image"], 7e4))  # past fp16's 65504
        trainer.state, m = trainer.train_step(trainer.state, huge)
        skipped = {"nonfinite": float(m["nonfinite"]), "used": float(m["loss_scale"])}
        s = trainer.state.loss_scale
        after = (float(s.scale), int(s.growth_counter), int(s.skipped_steps))
        unchanged = all(torch.equal(v, state_before[k]) for k, v in trainer.model.state_dict().items())
        trainer.state, m = trainer.train_step(trainer.state, batch)
        s = trainer.state.loss_scale
        saved = (float(s.scale), int(s.growth_counter), int(s.skipped_steps))
        trainer.checkpoints.save("last", trainer.state, FP16_EPOCHS)
        os.environ.update(SNAPSHOT="last")
        restored = train_digits.build_trainer(digits, save, "cuda").state.loss_scale
        restored = (float(restored.scale), int(restored.growth_counter), int(restored.skipped_steps))
    for i, em in enumerate(epoch_metrics):
        log(f"[fp16] epoch {i}: train ce {em['ce_loss']:.4f} acc {em['accuracy']:.4f} loss scale "
            f"{em.get('loss_scale', float('nan')):.0f} skipped steps {em.get('nonfinite', float('nan')):.0f}")
    times = [a.elapsed_time(b) for a, b in step_ms]
    steady = sorted(times[1:])
    log(f"[fp16] {counts['steps']} steps, step time median {steady[len(steady) // 2]:.2f} ms; scale before the "
        f"overflow step {float(scale_before.scale):.0f} (counter {int(scale_before.growth_counter)}); the overflow step: "
        f"{skipped}, then (scale, counter, skips) {after}, params and buffers unchanged: {unchanged}; after a clean "
        f"step {saved}; restored from last {restored}; eval {summary['results']}")
    losses = [em["ce_loss"] for em in epoch_metrics] + [vm["ce_loss"] for vm in val_metrics]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite losses: {losses}")
    if [em["loss_scale"] for em in epoch_metrics] != [2.0**15] * FP16_EPOCHS:
        raise RuntimeError(f"loss scale reported {[em.get('loss_scale') for em in epoch_metrics]}, expected 2^15")
    if skipped != {"nonfinite": 1.0, "used": 2.0**15} or after != (2.0**14, 0, 1) or not unchanged:
        raise RuntimeError(f"the overflow step: {skipped}, state {after}, unchanged {unchanged}")
    if saved != (2.0**14, 1, 1) or restored != saved:
        raise RuntimeError(f"the scale saved {saved} came back as {restored}")
    if _hand_kernel_counts() != before:
        raise RuntimeError("a hand kernel launched in the fp16 phase")
    del trainer
    torch.cuda.empty_cache()
    return {"step_ms": steady[len(steady) // 2], "after": after, "restored": restored,
            "curve": [em["ce_loss"] for em in epoch_metrics]}


# The chained phase: training steps as one captured CUDA graph a window
# (TrainEngine.train_steps_chained).
CHAIN_WINDOW = 4  # GPT-2-small's window
CHAIN_STEPS_COMPARED = 8  # chained against eager from the same state and batches
CHAIN_F32_DEPTH = 2  # the f32 check at GPT-2's width, 2 blocks
CHAIN_F32_BATCH = 8
CHAIN_TURN_WINDOWS = 3  # windows a turn in the LM's timing
CHAIN_RESNET_BATCH, CHAIN_RESNET_WINDOW = 128, 2
CHAIN_VGG_STEPS = 2  # CHAIN_STEPS of the CIFAR entry (its log_every of 50 is a multiple)
# The chained params and losses against eager after 8 steps are bit-equal in bf16 as in
# f32, both sides under deterministic algorithms: a replay runs the kernels the eager
# steps ran, on the same inputs. (Without deterministic algorithms two eager runs differ
# already: the embedding's backward adds with atomics, 7e-9 on the first step.)
# A kernel's launches in a profile of one replay, by the names of its two variants.
PROFILED_KERNELS = {
    "fwd": ("flash_fwd_wgmma_kernel", "flash_fwd_kernel"),
    "bwd_dq": ("flash_bwd_dq_wgmma_kernel", "flash_bwd_dq_kernel"),
    "bwd_dkv": ("flash_bwd_dkv_wgmma_kernel", "flash_bwd_dkv_kernel"),
    "conv1x1_bn_act": ("conv1x1_bn_act_wgmma_kernel", "conv1x1_bn_act_kernel"),
    "conv1x1_bwd_dz": ("conv1x1_bwd_dz_kernel",),
}


def _profiled_kernels(fn):
    """Run ``fn`` twice under the profiler, the first call a warm-up cycle whose events are
    dropped (the trace missed the first 31 or so kernels after it started in a run of the
    whole script); the launches of each hand kernel in the second (by the kernel's name on
    the device) and all its device kernels, or None when the profiler saw no device kernel
    at all."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    counts = {k: sum(1 for n in names if any(v in n for v in variants)) for k, variants in PROFILED_KERNELS.items()}
    counts["all"] = len(names)
    return counts if names else None


@contextlib.contextmanager
def _deterministic_algorithms():
    """``torch.use_deterministic_algorithms(True)`` (with ``CUBLAS_WORKSPACE_CONFIG``) and
    cuDNN's deterministic mode for the block, restored after it."""
    import torch

    saved = (os.environ.get("CUBLAS_WORKSPACE_CONFIG"), torch.are_deterministic_algorithms_enabled(),
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        if saved[0] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        torch.use_deterministic_algorithms(saved[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[2], saved[3]


def _lm_windows(n_steps, batch, seq, seed):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(0, 256, (n_steps, batch, seq + 1), device="cuda", generator=gen)
    return {"image": tokens[..., :-1].contiguous(), "label": tokens[..., 1:].contiguous()}


def _lm_chained_against_eager(make_model, batches, window, tag, eager_first=True):
    """The same initial weights and batches through ``train_step`` one at a time and
    through ``train_steps_chained`` a window at a time (the first window runs eagerly on
    the capture stream, then the graph is captured and replayed); the largest difference
    of any parameter and of any step's loss, and the chained side's engine and state.
    ``eager_first=False`` runs the chained side alone (the differences are None)."""
    import torch

    from distributed_training_pytorch_tpu_torch.models.transformer_lm import make_fused_lm_loss
    from distributed_training_pytorch_tpu_torch.ops.schedules import warmup_cosine_lr
    from distributed_training_pytorch_tpu_torch.train import TrainEngine, TrainState

    n = next(iter(batches.values())).shape[0]
    schedule = warmup_cosine_lr(3e-4, 1, 64, warmup_epochs=0)

    def build():
        model = make_model()
        opt = torch.optim.AdamW(model.parameters(), lr=schedule(0), betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1)
        return TrainEngine(make_fused_lm_loss(model), schedule=schedule), TrainState(model=model, optimizer=opt)

    eager, metrics_e = None, []
    if eager_first:
        engine, state = build()
        for i in range(n):
            state, m = engine.train_step(state, {k: v[i] for k, v in batches.items()})
            metrics_e.append(m["loss"])
        eager = {k: v.detach().float().cpu() for k, v in state.model.state_dict().items()}
        del engine, state
        torch.cuda.empty_cache()
    engine, state = build()
    metrics_c = []
    for w in range(n // window):
        state, m = engine.train_steps_chained(state, {k: v[w * window:(w + 1) * window] for k, v in batches.items()},
                                              window)
        metrics_c.extend(m["loss"].unbind(0))
    torch.cuda.synchronize()
    diff = loss_diff = None
    if eager is not None:
        diff = max(float((v.detach().float().cpu() - eager[k]).abs().max()) for k, v in state.model.state_dict().items())
        loss_diff = max(abs(float(a) - float(b)) for a, b in zip(metrics_c, metrics_e, strict=True))
    if engine.captures != 1:
        raise RuntimeError(f"{tag} expected one capture, got {engine.captures}")
    return diff, loss_diff, engine, state


def phase_chained(run_dir: str, card: str) -> dict:
    """Chained steps on the card: GPT-2-small (bf16, B=64, T=1024) 8 steps in windows of 4
    against 8 eager steps, and the same in f32 with TF32 off at 2 blocks (bit-equal); ms a
    step chained against eager in turns; K1–K3's launches a step from a profile of one
    replay; ResNet-50 with ``PALLAS=1`` chained (K4 and its dz pass from a profile of one
    replay); VGG16/CIFAR-10 through its entry at batch 1024, the busy share of a train
    epoch with ``chain_steps`` 2 and 1 in turns on one warm trainer."""
    import torch

    from distributed_training_pytorch_tpu_torch.examples import train_cifar10
    from distributed_training_pytorch_tpu_torch.models import GPTSmall, TransformerLM, create_model
    from distributed_training_pytorch_tpu_torch.ops.losses import cross_entropy_loss
    from distributed_training_pytorch_tpu_torch.train import TrainEngine, TrainState

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    b, t = TRAIN_SHAPE[0], TRAIN_SHAPE[1]
    batches = _lm_windows(CHAIN_STEPS_COMPARED, b, t, seed=1)

    def gpt2():
        return GPTSmall(vocab_size=256, dtype=torch.bfloat16, max_len=SEQ, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(0))

    # Parity, under deterministic algorithms (two eager runs differ without them).
    with _deterministic_algorithms():
        bf16_diff, bf16_loss_diff, engine, state = _lm_chained_against_eager(gpt2, batches, CHAIN_WINDOW,
                                                                             "[chained]")
    log(f"[chained] GPT-2-small bf16, B={b}, T={t}, deterministic algorithms: {CHAIN_STEPS_COMPARED} steps in "
        f"windows of {CHAIN_WINDOW} (one capture) against {CHAIN_STEPS_COMPARED} eager steps from the same weights "
        f"and batches: params differ by at most {bf16_diff!r}, losses by {bf16_loss_diff!r} (must be 0)")
    del engine, state
    gc.collect()
    torch.cuda.empty_cache()

    # f32, TF32 off, GPT-2's width at 2 blocks: bit-equal.
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        def gpt2_f32():
            return TransformerLM(256, hidden_dim=768, depth=CHAIN_F32_DEPTH, num_heads=12, mlp_dim=3072, max_len=SEQ,
                                 dtype=torch.float32, device="cuda",
                                 generator=torch.Generator(device="cuda").manual_seed(0))

        with _deterministic_algorithms():
            f32_diff, f32_loss_diff, engine, state = _lm_chained_against_eager(
                gpt2_f32, _lm_windows(CHAIN_STEPS_COMPARED, CHAIN_F32_BATCH, t, seed=3), CHAIN_WINDOW,
                "[chained f32]")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    log(f"[chained] f32, TF32 off, deterministic algorithms, GPT-2 width at {CHAIN_F32_DEPTH} blocks, "
        f"B={CHAIN_F32_BATCH}: chained against eager params differ by {f32_diff!r}, losses by {f32_loss_diff!r} "
        f"(must be 0)")
    if f32_diff != 0.0 or f32_loss_diff != 0.0:
        raise RuntimeError(f"f32 chained steps are not bit-equal to eager: params {f32_diff}, losses {f32_loss_diff}")
    if bf16_diff != 0.0 or bf16_loss_diff != 0.0:
        raise RuntimeError(f"bf16 chained steps are not bit-equal to eager: params {bf16_diff}, losses {bf16_loss_diff}")
    del engine, state
    gc.collect()
    torch.cuda.empty_cache()

    # Timing and the profile, as the trainer runs (no deterministic algorithms): a fresh
    # model, its first window real, then the capture.
    engine, state = _lm_chained_against_eager(gpt2, _lm_windows(CHAIN_WINDOW, b, t, seed=5), CHAIN_WINDOW,
                                              "[chained timing]", eager_first=False)[2:]
    # ms a step, chained against eager, in turns on the chained side's state.
    turn_batches = _lm_windows(CHAIN_WINDOW * CHAIN_TURN_WINDOWS, b, t, seed=2)

    def windows():
        for w in range(CHAIN_TURN_WINDOWS):
            yield {k: v[w * CHAIN_WINDOW:(w + 1) * CHAIN_WINDOW] for k, v in turn_batches.items()}

    def run(chained):
        nonlocal state
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for win in windows():
            if chained:
                state, _ = engine.train_steps_chained(state, win, CHAIN_WINDOW)
            else:
                for i in range(CHAIN_WINDOW):
                    state, _ = engine.train_step(state, {k: v[i] for k, v in win.items()})
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / (CHAIN_WINDOW * CHAIN_TURN_WINDOWS)

    lm_turns = {"eager": [], "chained": []}
    for mode in ("eager", "chained", "chained", "eager"):
        lm_turns[mode].append(run(mode == "chained"))
    replay = _profiled_kernels(lambda: engine.train_steps_chained(state, next(windows()), CHAIN_WINDOW))
    eager_ops = _profiled_kernels(lambda: engine.train_step(state, {k: v[0] for k, v in next(windows()).items()}))
    if engine.captures != 1:
        raise RuntimeError(f"the timing and profile captured again: {engine.captures} captures")
    lm_per_step = None if replay is None else {k: replay[k] / CHAIN_WINDOW for k in ("fwd", "bwd_dq", "bwd_dkv")}
    log(f"[chained] {card} | GPT-2-small ms a step (CUDA events, {CHAIN_TURN_WINDOWS} windows of {CHAIN_WINDOW} a "
        f"turn), in turns: eager {', '.join(f'{x:.2f}' for x in lm_turns['eager'])}; chained "
        f"{', '.join(f'{x:.2f}' for x in lm_turns['chained'])}")
    log(f"[chained] profile of one replay ({CHAIN_WINDOW} steps): {replay}; of one eager step: {eager_ops}; "
        f"K1-K3 a step on the chained path: {lm_per_step}")
    if lm_per_step != {"fwd": DEPTH, "bwd_dq": DEPTH, "bwd_dkv": DEPTH}:
        raise RuntimeError(f"expected {DEPTH} launches of each of K1-K3 a step in the replay, got {replay}")
    del engine, state, batches, turn_batches
    gc.collect()
    torch.cuda.empty_cache()

    # ResNet-50, PALLAS=1: K4 and its dz pass inside the graph.
    model = create_model("resnet50", num_classes=1000, dtype=torch.bfloat16, pallas=True, device="cuda")
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9, weight_decay=5e-5)

    def resnet_loss(net, batch, train):
        loss = cross_entropy_loss(net(batch["image"].permute(0, 3, 1, 2)), batch["label"])
        return loss, {"ce_loss": loss}

    r_engine, r_state = TrainEngine(resnet_loss, schedule=lambda step: 0.1), TrainState(model=model, optimizer=opt)
    gen = torch.Generator(device="cuda").manual_seed(4)
    w, rb = CHAIN_RESNET_WINDOW, CHAIN_RESNET_BATCH
    r_window = {"image": torch.randn(w, rb, 224, 224, 3, device="cuda", generator=gen),
                "label": torch.randint(0, 1000, (w, rb), device="cuda", generator=gen)}
    r_state, m = r_engine.train_steps_chained(r_state, r_window, w)  # real steps, then the capture
    r_replay = _profiled_kernels(lambda: r_engine.train_steps_chained(r_state, r_window, w))
    if r_engine.captures != 1:
        raise RuntimeError(f"ResNet-50's replays captured again: {r_engine.captures} captures")
    resnet_per_step = None if r_replay is None else {k: r_replay[k] / w for k in ("conv1x1_bn_act", "conv1x1_bwd_dz")}
    log(f"[chained] ResNet-50 PALLAS=1, B={rb}, windows of {w}: losses {[round(float(x), 4) for x in m['ce_loss']]}; "
        f"profile of one replay: {r_replay}; K4 and dz a step: {resnet_per_step}")
    if resnet_per_step != {"conv1x1_bn_act": 9, "conv1x1_bwd_dz": 9} or not torch.isfinite(m["ce_loss"]).all():
        raise RuntimeError(f"expected 9 K4 and 9 dz launches a step in the replay and finite losses, got {r_replay}")
    del r_engine, r_state, model, opt, r_window
    gc.collect()
    torch.cuda.empty_cache()

    # VGG16/CIFAR-10 through the entry: busy share of a train epoch, chained against not.
    keys = ("BATCH", "EPOCHS", "SAVE_DIR", "SNAPSHOT", "DTYPE", "CIFAR10_DIR", "PALLAS", "BASE_LR", "MESH",
            "CHAIN_STEPS", "TUNED", "TELEMETRY")
    saved_env = {k: os.environ.pop(k, None) for k in keys}
    os.environ.update(VGG_ENV, SAVE_DIR=os.path.join(run_dir, "vgg"), CIFAR10_DIR=os.path.join(run_dir, "none"),
                      EPOCHS="1", CHAIN_STEPS=str(CHAIN_VGG_STEPS))
    real_load = train_cifar10.load_cifar10
    try:
        data = real_load(os.environ["CIFAR10_DIR"])
        train_cifar10.load_cifar10 = lambda data_dir: data
        trainer = train_cifar10.build_trainer("cuda")
    finally:
        train_cifar10.load_cifar10 = real_load
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    trainer.chain_steps = CHAIN_VGG_STEPS
    _profiled_epoch(trainer, 0)  # warm: the first window's real steps and the capture
    vgg_turns = {"chained": [], "eager": []}
    for mode in ("eager", "chained", "chained", "eager"):
        trainer.chain_steps = CHAIN_VGG_STEPS if mode == "chained" else 1
        metrics, fig = _profiled_epoch(trainer, 0)
        fig["ce_loss"] = metrics["ce_loss"]
        vgg_turns[mode].append(fig)
    steps = len(trainer.train_dataloader)
    captures = trainer.engine.captures
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    for mode, runs in vgg_turns.items():
        log(f"[chained] {card} | VGG16/CIFAR-10 (B={VGG_BATCH}, {steps} steps an epoch, the entry's host path), "
            f"chain_steps {CHAIN_VGG_STEPS if mode == 'chained' else 1}: busy "
            + ", ".join(f"{_fmt_busy(r['busy'])} (wall {r['wall_ms']:.1f} ms, {r['wall_ms'] / steps:.2f} ms a step, "
                        f"device {r['busy_ms']:.1f} ms)" for r in runs))
    if captures != 1 or not all(np.isfinite(r["ce_loss"]) for rs in vgg_turns.values() for r in rs):
        raise RuntimeError(f"VGG16 chained: {captures} captures, losses {vgg_turns}")
    wall = time.perf_counter() - t_phase
    log(f"[chained] phase wall {wall:.1f} s")
    return {"bf16_diff": bf16_diff, "f32_diff": f32_diff, "lm_turns": lm_turns, "lm_replay": replay,
            "lm_per_step": lm_per_step, "resnet_replay": r_replay, "resnet_per_step": resnet_per_step,
            "vgg_turns": vgg_turns, "wall_s": wall}


def phase_resilience(run_dir: str) -> dict:
    """The port's chaos soak (``scripts/torch_chaos_soak.py``) on the card: digits through
    the entry with ``CHAIN_STEPS=2`` and background saves, killed by a graceful SIGTERM, a
    SIGKILL mid-commit, a SIGKILL mid-window and a hung step past ``step_timeout``, each
    resumed from ``latest_valid``; the final params bit-exact against an uninterrupted run;
    the async save's stall against the sync save's wall on GPT-2-small's state."""
    import torch

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    done = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "torch_chaos_soak.py"), "--device", "cuda",
                           "--workdir", os.path.join(run_dir, "soak")], capture_output=True, text=True, timeout=900,
                          cwd=REPO)
    wall = time.perf_counter() - t0
    lines = done.stdout.strip().splitlines()
    for line in lines[:-1]:
        log(f"[resilience] {line}")
    result = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else {"ok": False}
    if done.returncode != 0 or not result.get("ok"):
        raise RuntimeError(f"the chaos soak failed (exit {done.returncode}): {done.stdout[-3000:]} {done.stderr[-3000:]}")
    st = result["stall"]
    log(f"[resilience] kills: {[(k['kill'], k['rc'], k['valid']) for k in result['kills']]}; hung step at "
        f"{result['hang']}; final params SHA-256 {result['params_sha256']['soak'][:16]}… equal to the uninterrupted "
        f"run's; soak wall {result['wall_s']:.1f} s ({wall:.1f} s with the script's start); seconds from each "
        f"child's go to its resume and to its end (its start-up overlapped the child before): "
        f"{[(k['kill'], k['resumed_s'], k['wall_s']) for k in result['kills']]}, finish {result['finish']}")
    log(f"[resilience] save stall on {st['model']}'s state ({st['state_bytes'] / 1e9:.2f} GB: f32 params and AdamW "
        f"moments): synchronous save {st['sync_ms']:.1f} ms; async snapshot {st['stall_ms']:.1f} ms until its copies "
        f"landed ({st['stall_ratio']:.4f} of the sync wall; bound 0.25); its background commit {st['commit_ms']:.1f} ms")
    return {**result, "script_wall_s": wall}


# The lm_eval phase (21): eval_lm and make_lm_corpus on phase 5's checkpoint.
LM_EVAL_BATCH = 64  # EVAL_BATCH
LM_EVAL_CORPUS_MB = 2.0
LM_EVAL_SHAPE = (64, 256, 12, 64)  # K1 at eval_lm's defaults (SEQ_LEN=256, EVAL_BATCH=64)
DECODE_BATCHES = (1, 8, 32, 128)
DECODE_PROMPT, DECODE_GEN = 32, 128  # decode_benchmark's window: 159 single-token steps
SAMPLE_PROMPT, SAMPLE_STEPS = b"def ", 64
F32_PROMPTS, F32_STEPS = 2, 64
SWAP_ROWS = 4


def _launch_counts() -> dict:
    """Every hand kernel's launch count so far: K1-K3 and K4's two entries."""
    fa_counts, k4_counts = _hand_kernel_counts()
    return {**fa_counts, **k4_counts}


def _reset_launch_counts() -> None:
    from distributed_training_pytorch_tpu_torch.ops import conv1x1 as k4
    from distributed_training_pytorch_tpu_torch.ops import flash_attention as fa

    fa.reset_launches()
    k4.reset_launches()


def _k1_on_qkv_views(gen, b, t, h, d):
    """K1 on the q, k, v views of a fused [B, T, 3, H, D] bf16 projection (the LM's), causal:
    the wgmma variant read in place, against the plain version; returns max|o - plain|."""
    import torch

    from distributed_training_pytorch_tpu_torch.ops import flash_attention as fa

    qkv = torch.randn(b, t, 3, h, d, device="cuda", generator=gen).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    before = fa.launches_by_variant[("fwd", "wgmma")]
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    in_place = all(fa.tma_operand(x) is x for x in (q, k, v))
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, causal=True)
    err = (o.float() - o_ref.float()).abs().max().item()
    atol, rtol = TOL["bfloat16"]
    ok = (in_place and fa.launches_by_variant[("fwd", "wgmma")] == before + 1
          and torch.allclose(o.float(), o_ref.float(), atol=atol, rtol=rtol)
          and torch.allclose(lse, lse_ref, atol=LSE_TOL[0], rtol=LSE_TOL[1]))
    log(f"[lm_eval] K1 on qkv views B={b} T={t} H={h} D={d} causal bfloat16 (wgmma, read in place: {in_place}): "
        f"max|o-plain|={err:.3e} (atol {atol}, rtol {rtol}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("K1 disagrees with its plain version at the eval_lm shape, or copied or skipped its views")
    return err


def _decode_step_ops(model) -> "int | None":
    """Device operations (kernels, copies, fills) of one eager decode step at B=1, by the
    profiler: a 2-step ``generate`` less a 1-step one. None when the profiler sees none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from distributed_training_pytorch_tpu_torch.models.transformer_lm import generate

    prompt = torch.full((1, 1), 32, dtype=torch.long, device="cuda")
    counts = []
    for steps in (1, 2):
        generate(model, prompt, steps, graph=False)  # warm
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            generate(model, prompt, steps, graph=False)
            torch.cuda.synchronize()
        counts.append(sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA))
    return counts[1] - counts[0] if counts[0] else None


def _post_json(port: int, payload: dict) -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        if resp.status != 200:
            raise RuntimeError(f"/predict answered HTTP {resp.status}")
        return json.loads(resp.read())


def _lm_hot_swap(run_dir: str, model, seq: int) -> dict:
    """Serve phase 5's ``last`` with the hot-swap watcher following ``best`` (pinned: the
    newest-valid fallback would hash ``last``'s 0.5 GB on every poll), commit a new ``best``
    (the same weights moved by seeded noise), and read ``/predict`` until it answers under
    the new version; its bodies against a fresh engine on the new weights."""
    import torch

    from distributed_training_pytorch_tpu_torch.checkpoint import CheckpointManager
    from distributed_training_pytorch_tpu_torch.examples import eval_lm
    from distributed_training_pytorch_tpu_torch.serving import InferEngine, InferenceServer, MicroBatcher
    from distributed_training_pytorch_tpu_torch.telemetry.events import resolve_events_path
    from distributed_training_pytorch_tpu_torch.train import TrainState

    serve_dir = os.path.join(run_dir, "serve")
    shutil.copytree(os.path.join(run_dir, "weights", "last"), os.path.join(serve_dir, "last"))
    manager = CheckpointManager(serve_dir)
    served = eval_lm.build_model("small", seq).eval()

    def next_token_logits(params, tokens):
        hidden = torch.func.functional_call(served, params, (tokens,), {"return_hidden": True})
        return hidden[:, -1].float() @ params["embed.weight"].float().T

    def state_of(m):
        return TrainState(model=m, optimizer=torch.optim.SGD(m.parameters(), lr=0.0))

    target = state_of(eval_lm.build_model("small", seq))
    engine = InferEngine(next_token_logits, device="cuda", buckets=(1, 2, 4, 8))
    v0 = engine.restore_params(manager, target, name="last")
    engine.warmup(np.zeros((seq,), np.int32))
    rows = np.random.default_rng(21).integers(0, 256, size=(SWAP_ROWS, seq)).astype(np.int32)
    server = InferenceServer(engine, batcher=MicroBatcher(buckets=engine.buckets, max_delay_s=0.005),
                             run_dir=os.path.join(serve_dir, "run"), manager=manager, target_state=target,
                             serve_name="best", swap_poll_s=0.1, input_dtype="int32", process_index=0).start()
    if not server.enabled:
        raise RuntimeError("inference server did not start")
    try:
        before = [_post_json(server.port, {"inputs": [r.tolist()]}) for r in rows]
        moved = eval_lm.build_model("small", seq).eval()
        moved.load_state_dict(model.state_dict())
        gen = torch.Generator(device="cuda").manual_seed(22)
        with torch.no_grad():
            for p in moved.parameters():
                p.add_(torch.randn(p.shape, device="cuda", generator=gen), alpha=0.02)
        t0 = time.perf_counter()
        manager.save("best", state_of(moved), epoch=TRAIN_EPOCHS + 2)
        v1 = f"best@e{TRAIN_EPOCHS + 2}"
        seen = None
        while time.perf_counter() - t0 < 60:
            seen = _post_json(server.port, {"inputs": [rows[0].tolist()]})["params_version"]
            if seen == v1:
                break
            time.sleep(0.05)
        swap_s = time.perf_counter() - t0
        after = [_post_json(server.port, {"inputs": [r.tolist()]}) for r in rows]
    finally:
        server.close()
    if seen != v1 or any(b["params_version"] != v0 for b in before) or any(a["params_version"] != v1 for a in after):
        raise RuntimeError(f"hot swap: versions before {[b['params_version'] for b in before]}, after "
                           f"{[a['params_version'] for a in after]}, expected {v0} then {v1}")
    fresh = InferEngine(next_token_logits, device="cuda", buckets=(1,))
    fresh.swap_params(moved.state_dict(), version="fresh")
    got = np.stack([np.asarray(a["outputs"][0], np.float32) for a in after])
    ref = np.stack([fresh.predict(r[None])[0][0] for r in rows])
    old = np.stack([np.asarray(b["outputs"][0], np.float32) for b in before])
    err, moved_by = float(np.abs(got - ref).max()), float(np.abs(got - old).max())
    with open(resolve_events_path(os.path.join(serve_dir, "run"))) as f:
        swaps = [r for r in map(json.loads, f) if r["event"] == "hot_swap"]
    log(f"[lm_eval] hot swap: served {v0}, committed best; /predict answered {v1} {swap_s:.2f} s after the commit "
        f"(watcher poll 0.1 s); {len(swaps)} hot_swap event(s); bodies vs a fresh engine on the new weights "
        f"max|diff|={err:.3e}; the answers moved by up to {moved_by:.3f}")
    if err > 1e-3 or not np.isfinite(got).all() or moved_by == 0.0 or len(swaps) != 1:
        raise RuntimeError("hot swap: bodies disagree with a fresh engine, did not change, or not one hot_swap event")
    return {"from": v0, "to": v1, "swap_s": swap_s, "max_abs_err": err}


def phase_lm_eval(run_dir: str, card: str) -> dict:
    """Phase 21 on phase 5's checkpoint in ``run_dir``: see the module doc."""
    import torch

    from distributed_training_pytorch_tpu_torch.examples import eval_lm, make_lm_corpus, train_lm
    from distributed_training_pytorch_tpu_torch.models.transformer_lm import generate
    from distributed_training_pytorch_tpu_torch.ops import flash_attention as fa

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    found_gb = torch.cuda.memory_allocated() / 1e9
    seq = int(TRAIN_ENV["SEQ_LEN"])
    corpus_path = os.path.join(run_dir, "lm_corpus.txt")
    t0 = time.perf_counter()
    corpus = make_lm_corpus.main([corpus_path, str(LM_EVAL_CORPUS_MB)])
    roots = [os.path.basename(r) for r, _ in make_lm_corpus._roots()]
    log(f"[lm_eval] make_lm_corpus: {corpus['bytes']:,} bytes, sha256 {corpus['sha256']} in "
        f"{time.perf_counter() - t0:.2f} s (roots on this machine: {roots})")
    ckpt = os.path.join(run_dir, "weights", "last")
    loaded = eval_lm.load_params(ckpt, "small", seq)
    model = loaded[0]

    # evaluate: the full forward, K1 once a layer a batch, all wgmma.
    _reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    val = eval_lm.evaluate(ckpt, corpus_path, size="small", seq_len=seq, batch=LM_EVAL_BATCH, loaded=loaded)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_launches, wgmma = _launch_counts(), fa.launches_by_variant[("fwd", "wgmma")]
    n_batches = -(-val["n_windows"] // LM_EVAL_BATCH)
    log(f"[lm_eval] evaluate (GPT-2-small from phase 5's last, SEQ_LEN={seq}, EVAL_BATCH={LM_EVAL_BATCH}): "
        f"nll {val['nll']:.4f}, ppl {val['ppl']:.2f} over {val['n_windows']} windows in {n_batches} batches, "
        f"{eval_s:.2f} s; launches {eval_launches}, {wgmma} fwd on wgmma")
    expected = {"fwd": DEPTH * n_batches, "bwd_dq": 0, "bwd_dkv": 0, "conv1x1_bn_act": 0, "conv1x1_bwd_dz": 0}
    if not np.isfinite(val["nll"]) or eval_launches != expected or wgmma != DEPTH * n_batches:
        raise RuntimeError(f"evaluate: nll {val['nll']}, launches {eval_launches} (expected {expected}), wgmma {wgmma}")

    # sample and decode_benchmark: the decode path, through no hand kernel.
    _reset_launch_counts()
    timings: dict = {}
    texts = eval_lm.sample(ckpt, SAMPLE_PROMPT, size="small", seq_len=seq, gen_steps=SAMPLE_STEPS, temperature=0.8,
                           loaded=loaded, timings=timings)
    for name, text in texts.items():
        log(f"[lm_eval] --- {name} --- {text!r}")
        if not text.startswith(SAMPLE_PROMPT) or len(text) != len(SAMPLE_PROMPT) + SAMPLE_STEPS:
            raise RuntimeError(f"sample {name}: the prompt is not its prefix, or it is not {SAMPLE_STEPS} longer")
    if set(texts) != {"greedy", "t=0.8"}:
        raise RuntimeError(f"sample gave {sorted(texts)}")
    log(f"[lm_eval] DECODE: {timings['decode_tok_per_s']:.1f} tok/s (greedy, batch 1, {timings['decode_steps']} "
        f"single-token steps); DECODE_NEW: {timings['new_tok_per_s']:.1f} tok/s ({timings['gen_steps']} generated)")
    rows = []
    for b in DECODE_BATCHES:
        for graph in (True, False, False, True):  # in turns
            row = eval_lm.decode_benchmark(model, prompt_len=DECODE_PROMPT, gen_steps=DECODE_GEN, batches=(b,),
                                           graph=graph)[0]
            rows.append(row)
            log(f"[lm_eval] DECODE_BATCH {b:4d} {'graph' if graph else 'eager'}: {row['tok_per_s']:9.1f} tok/s "
                f"aggregate, {row['tok_per_s_per_stream']:7.1f} tok/s/stream, {row['new_tok_per_s']:9.1f} new tok/s, "
                f"{row['step_ms']:.3f} ms/step")
    decode_launches = _launch_counts()
    if any(decode_launches.values()):
        raise RuntimeError(f"the decode path launched hand kernels: {decode_launches}")
    step_ops = _decode_step_ops(model)
    log(f"[lm_eval] device operations in one decode step at B=1 (the profiler's count, 2 steps less 1): "
        f"{'not measured' if step_ops is None else step_ops}")

    # f32 at full width, TF32 off: the graph's greedy tokens equal the eager loop's and the
    # full forward's argmax at each step.
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        f32 = eval_lm.build_model("small", seq, dtype=torch.float32).eval()
        f32.load_state_dict(model.state_dict())
        windows = train_lm.load_windows(seq, path=corpus_path)
        prompt = torch.from_numpy(windows[-F32_PROMPTS:, :DECODE_PROMPT]).to("cuda")
        graph_out = generate(f32, prompt, F32_STEPS)
        eager_out = generate(f32, prompt, F32_STEPS, graph=False)
        with torch.no_grad():
            full = f32(graph_out[:, :-1])[:, DECODE_PROMPT - 1 :]
        top2 = full.topk(2, dim=-1).values
        margin = float((top2[..., 0] - top2[..., 1]).min())
        same_eager = torch.equal(graph_out, eager_out)
        same_full = torch.equal(full.argmax(-1), graph_out[:, DECODE_PROMPT:])
        del f32, full
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    log(f"[lm_eval] f32, TF32 off, {F32_PROMPTS} prompts of {DECODE_PROMPT} + {F32_STEPS} greedy steps: graph == eager "
        f"{same_eager}, graph == full-forward argmax {same_full} (smallest top-2 margin {margin:.3e})")
    if not (same_eager and same_full):
        raise RuntimeError("f32 greedy decode: the graph, the eager loop and the full forward's argmax disagree")

    swap = _lm_hot_swap(run_dir, model, seq)
    gen = torch.Generator(device="cuda").manual_seed(2121)
    k1_err = _k1_on_qkv_views(gen, *LM_EVAL_SHAPE)
    k1_row = _attention_times(card, *LM_EVAL_SHAPE, True, gen, "eval_lm ")["fwd"]
    # The phases after this one read their peak memory: leave no more allocated than was
    # found. The graphs' static caches go with the model (4.8 GB at B=128); the hot swap's
    # stopped server keeps its engine and models in reference cycles until a collection.
    del loaded, model
    gc.collect()
    torch.cuda.empty_cache()
    left_gb = torch.cuda.memory_allocated() / 1e9
    wall = time.perf_counter() - t_phase
    log(f"[lm_eval] phase wall {wall:.1f} s; device memory allocated {found_gb:.2f} GB before the phase, "
        f"{left_gb:.2f} GB after it")
    if left_gb > found_gb + 0.25:
        raise RuntimeError(f"lm_eval left {left_gb - found_gb:.2f} GB allocated for the phases after it")
    return {"val": val, "eval_s": eval_s, "launches": eval_launches["fwd"], "decode_launches": decode_launches,
            "step_ops": step_ops,
            "timings": timings, "texts": texts, "decode": rows, "margin": margin, "swap": swap,
            "k1": {**k1_row, "max_abs_err": k1_err}, "corpus": corpus, "wall_s": wall}


def run_only(names) -> int:
    """Development runs: the device phase, then only the named phases (``jpeg``, ``folder``,
    ``vgg``, ``chained``, ``resilience``, ...; ``lm`` is phase 5 then the lm_eval phase on its
    checkpoint), each run phase
    in its own temporary directory; no kernels line and no final line."""
    phases = {"folder": phase_folder, "vgg": phase_vgg, "digits": phase_digits, "records": phase_records,
              "records_resnet50": phase_records_resnet50, "fp16": phase_fp16, "resilience": phase_resilience}
    try:
        card = phase_device()
        if "jpeg" in names:
            phase_jpeg(card)
            names = [n for n in names if n != "jpeg"]
        run_root = os.path.join(REPO, "build")
        os.makedirs(run_root, exist_ok=True)
        for name in names:
            with tempfile.TemporaryDirectory(dir=run_root) as run_dir:
                if name == "lm":
                    phase_train(run_dir)
                    phase_lm_eval(run_dir, card)
                elif name == "chained":
                    phase_chained(run_dir, card)
                else:
                    phases[name](run_dir)
    except Exception:  # noqa: BLE001 — any failed phase fails the run
        traceback.print_exc()
        return 1
    return 0


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
    if "--only" in sys.argv:
        return run_only(sys.argv[sys.argv.index("--only") + 1].split(","))
    try:
        t_start = time.perf_counter()
        card = phase_device()
        fwd_err, vit_fwd_err = phase_kernels()
        bwd_err, vit_bwd_err = phase_bwd_kernels()
        k5_err = phase_k5()
        ring = phase_ring(card)
        conv_err, dz_err, convnext_err = phase_conv1x1()
        jpeg = phase_jpeg(card)
        run_root = os.path.join(REPO, "build")
        os.makedirs(run_root, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=run_root) as run_dir:
            serve_launches, serve = phase_slice(run_dir)
        with tempfile.TemporaryDirectory(dir=run_root) as run_dir:
            train_launches, train = phase_train(run_dir)
            lm_eval = phase_lm_eval(run_dir, card)  # on phase 5's checkpoint
        with tempfile.TemporaryDirectory(dir=run_root) as run_dir:
            ring_launches, ring_train = phase_ring_train(run_dir)
        with tempfile.TemporaryDirectory(dir=run_root) as run_dir:
            resnet_launches, resnet = phase_resnet(run_dir)
        with tempfile.TemporaryDirectory(dir=run_root) as run_dir:
            resnet_ab = _knobs_in_turns("[resnet-ab]", RESNET_ENV, run_dir, RESNET_BATCH, ("1", "0"), n_steps=5)
        with tempfile.TemporaryDirectory(dir=run_root) as run_dir:
            vgg = phase_vgg(run_dir)
        with tempfile.TemporaryDirectory(dir=run_root) as run_dir:
            vit_launches, vit = phase_vit(run_dir)
        with tempfile.TemporaryDirectory(dir=run_root) as run_dir:
            convnext_launches, convnext = phase_convnext(run_dir)
        with tempfile.TemporaryDirectory(dir=run_root) as run_dir:
            folder = phase_folder(run_dir)
        with tempfile.TemporaryDirectory(dir=run_root) as run_dir:
            digits = phase_digits(run_dir)
        with tempfile.TemporaryDirectory(dir=run_root) as run_dir:
            records = phase_records(run_dir)
        with tempfile.TemporaryDirectory(dir=run_root) as run_dir:
            r50, r50_launches = phase_records_resnet50(run_dir)
        with tempfile.TemporaryDirectory(dir=run_root) as run_dir:
            fp16 = phase_fp16(run_dir)
        with tempfile.TemporaryDirectory(dir=run_root) as run_dir:
            chained = phase_chained(run_dir, card)
        with tempfile.TemporaryDirectory(dir=run_root) as run_dir:
            resilience = phase_resilience(run_dir)
        times, vit_times = phase_times(card)
        conv_times, conv_total, dz_times, dz_total = phase_conv1x1_times(card)
        convnext_times, convnext_total = phase_convnext_times(card)
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
            f"{resnet_ab['PALLAS=1']:.2f} ms, PALLAS=0 {resnet_ab['PALLAS=0']:.2f} ms; its resumed train epoch on the warm trainer: "
            f"{_turns_line(resnet['turns'])}")
        log(f"[times] {card} | VGG16 training step (CIFAR-10, B={VGG_BATCH}, 32x32, bf16 model, f32 params, through "
            f"the entry): median {vgg['step_ms']:.2f} ms (the host issues it in {vgg['host_ms']:.2f} ms), "
            f"{vgg['images_per_s']:.0f} images/s, peak memory "
            f"{vgg['peak_gb']:.2f} GB; device busy share of the resumed train epoch {_fmt_busy(vgg['new']['busy'])} "
            f"(wall {vgg['new']['wall_ms']:.1f} ms) against the parent's host path "
            f"{_fmt_busy(vgg['parent']['busy'])} (per-record Python transform; wall "
            f"{vgg['parent']['wall_ms']:.1f} ms over {vgg['parent']['steps']} steps); on the warm trainer, native "
            f"crop/flip, in turns: {_turns_line(vgg['turns'])}")
        for label, fig in (("ViT-B/16 (B=256, PALLAS unset: the flash kernels)", vit),
                           (f"ConvNeXt-L (B=256 in {CONVNEXT_ACCUM} micro-batches, PALLAS=1: K4's gelu epilogue)",
                            convnext)):
            log(f"[times] {card} | {label} training step through the entry: median {fig['step_ms']:.2f} ms, "
                f"{fig['images_per_s']:.0f} images/s, peak memory {fig['peak_gb']:.2f} GB; the phase's "
                f"{fig['saves']} checkpoint snapshots {fig['save_s']:.1f} s and the flushes of their background commits "
                f"{fig['flush_s']:.1f} s of its {fig['wall_s']:.1f} s; on batches on the "
                f"card, in turns: " + ", ".join(f"{k} {v:.2f} ms" for k, v in fig["turns"].items()))
        log(f"[times] {card} | VGG16 training step (image folders, B={FOLDER_BATCH}, {FOLDER_SIZE}x{FOLDER_SIZE}, f32, "
            f"the ten-step train chain on 8 loader workers, through ExampleTrainer): median {folder['step_ms']:.2f} ms, "
            f"{folder['images_per_s']:.0f} images/s, peak memory {folder['peak_gb']:.2f} GB, device busy share of "
            f"the resumed train epoch {_fmt_busy(folder['new']['busy'])} (wall {folder['new']['wall_ms']:.1f} ms); "
            f"host ms per image: " + ", ".join(f"{k} {v:.3f}" for k, v in folder["host"]["transforms"].items())
            + "; decoders: " + ", ".join(f"{k} {v:.3f}" for k, v in folder["host"]["decoders"].items()))
        for label, fig in (("VGG16 on the digits corpus (B=128, 32x32, f32, through train_digits)", digits),
                           ("ResNet18Slim on the digits record shards (B=128, 32x32, bf16, through train_records)",
                            records)):
            log(f"[times] {card} | {label}: step median {fig['step_ms']:.2f} ms, {fig['images_per_s']:.0f} images/s, "
                f"device busy share of the resumed train epoch {_fmt_busy(fig['busy']['busy'])} (wall "
                f"{fig['busy']['wall_ms']:.1f} ms); eval " + ", ".join(
                    f"{k} top-1 {v['top1']:.4f} top-2 {v['top2']:.4f}" for k, v in fig["results"].items()))
        log(f"[times] {card} | ResNet-50 on record shards (B=256, 224x224, bf16, PALLAS=1, through the entry): median "
            f"{r50['step_ms']:.2f} ms, {r50['images_per_s']:.0f} images/s, peak memory {r50['peak_gb']:.2f} GB; its "
            f"resumed train epoch on the warm trainer, in turns: {_turns_line(r50['turns'])}")
        log(f"[times] {card} | JPEG decode on the card's machine's CPU: {jpeg['decode_ms']:.3f} ms per {JPEG_TIMED_SHAPE[0]}x"
            f"{JPEG_TIMED_SHAPE[1]} quality-90 4:2:0 image on one thread, {jpeg['images_per_s']:.0f} images/s through the "
            f"fused decode + crop entry on {JPEG_THREADS} threads; {jpeg['fixtures']} fixtures bit-equal to cv2")
        log(f"[times] {card} | VGG16 on the digits corpus, DTYPE=fp16 with dynamic loss scaling: step median "
            f"{fp16['step_ms']:.2f} ms")
        val, dec = lm_eval["val"], {(r["batch"], r["graph"]): r for r in lm_eval["decode"]}
        log(f"[times] {card} | eval_lm on phase 5's last (GPT-2-small, T={SEQ}, batch {LM_EVAL_BATCH}, bf16): nll "
            f"{val['nll']:.4f}, ppl {val['ppl']:.2f} over {val['n_windows']} windows in {lm_eval['eval_s']:.2f} s, "
            f"{lm_eval['launches']} K1 launches; decode tok/s (graph / eager, the later of each pair): " + ", ".join(
                f"B={b} {dec[(b, True)]['tok_per_s']:.0f} / {dec[(b, False)]['tok_per_s']:.0f}" for b in DECODE_BATCHES)
            + f"; hot swap answered {lm_eval['swap']['swap_s']:.2f} s after the commit; phase wall "
            f"{lm_eval['wall_s']:.1f} s")
        lm_t, vgg_t = chained["lm_turns"], chained["vgg_turns"]
        log(f"[times] {card} | chained steps (one CUDA graph a window): GPT-2-small (B=64, T=1024, bf16, windows of "
            f"{CHAIN_WINDOW}) ms a step in turns, eager {', '.join(f'{x:.2f}' for x in lm_t['eager'])}, chained "
            f"{', '.join(f'{x:.2f}' for x in lm_t['chained'])}; params after 8 steps chained vs eager: bf16 "
            f"{chained['bf16_diff']:.3e}, f32 (TF32 off) {chained['f32_diff']!r}; VGG16/CIFAR-10 busy share of an "
            f"epoch in turns, chain 1: {', '.join(_fmt_busy(r['busy']) for r in vgg_t['eager'])}, chain "
            f"{CHAIN_VGG_STEPS}: {', '.join(_fmt_busy(r['busy']) for r in vgg_t['chained'])}")
        st = resilience["stall"]
        log(f"[times] {card} | chaos soak: 4 kills resumed bit-exact in {resilience['wall_s']:.1f} s; save of "
            f"{st['model']}'s state ({st['state_bytes'] / 1e9:.2f} GB): sync wall {st['sync_ms']:.1f} ms, async stall "
            f"{st['stall_ms']:.1f} ms ({st['stall_ratio']:.4f})")
        log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    except Exception:  # noqa: BLE001 — any failed phase fails the run
        traceback.print_exc()
        return 1
    kernels = []
    for name, kind, launch_key, replaces, err, vit_err, source in (
        ("flash_fwd", "fwd", "fwd", ":81", fwd_err, vit_fwd_err, "flash_fwd_wgmma.cu"),
        ("flash_bwd_dq", "dq", "bwd_dq", ":135", bwd_err["dq"], vit_bwd_err["dq"], "flash_bwd_wgmma.cu"),
        ("flash_bwd_dkv", "dkv", "bwd_dkv", ":174", bwd_err["dkv"], vit_bwd_err["dkv"], "flash_bwd_wgmma.cu"),
    ):
        r = times[kind]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"distributed_training_pytorch_tpu_torch/csrc/{source}",
            "replaces": f"distributed_training_pytorch_tpu/ops/pallas.py{replaces}",
            "launches": train_launches[launch_key],
            "launches_by_path": {"train": train_launches[launch_key], "train_ring": ring_launches[launch_key],
                                 "train_resnet50": 0, "train_vgg16": 0,
                                 "serve": serve_launches if kind == "fwd" else 0,
                                 "train_vit_b16": vit_launches[launch_key], "train_convnext_l": 0,
                                 "train_folder": 0, "train_digits": 0, "train_records": 0,
                                 "train_records_resnet50": 0, "train_digits_fp16": 0,
                                 "eval_lm": lm_eval["launches"] if kind == "fwd" else 0,
                                 "decode": lm_eval["decode_launches"][launch_key],
                                 "train_lm_chained": chained["lm_replay"][launch_key],
                                 "train_resnet50_chained": 0},
            "max_abs_err": err,
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "shape": r["shape"],
            "dtype": "bfloat16",
            "design": DESIGN[kind],
            # ViT-B/16's attention, non-causal, at the phase's batch: the same keys.
            "vit_b16": {**{k: vit_times[kind][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                                          "shape")}, "max_abs_err": vit_err},
        })
        if kind == "fwd":
            # eval_lm's forward at its defaults (SEQ_LEN=256, EVAL_BATCH=64), causal, the same keys.
            kernels[-1]["eval_lm"] = {k: lm_eval["k1"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                                     "library_ms", "shape", "max_abs_err")}
    for name, source, replaces, err, total, shapes in (
        ("conv1x1_bn_act", "conv1x1_wgmma.cu", ":550", conv_err, conv_total, conv_times),
        ("conv1x1_bwd_dz", "conv1x1_bwd_dz.cu", ":629", dz_err, dz_total, dz_times),
    ):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"distributed_training_pytorch_tpu_torch/csrc/{source}",
            "replaces": f"distributed_training_pytorch_tpu/ops/pallas.py{replaces}",
            "launches": resnet_launches[name],
            "launches_by_path": {"train_resnet50": resnet_launches[name], "train": 0, "train_ring": 0,
                                 "train_vgg16": 0, "serve": 0, "train_vit_b16": 0,
                                 "train_convnext_l": convnext_launches[name], "train_folder": 0,
                                 "train_digits": 0, "train_records": 0,
                                 "train_records_resnet50": r50_launches[name], "train_digits_fp16": 0,
                                 "eval_lm": 0, "decode": lm_eval["decode_launches"][name],
                                 "train_lm_chained": 0, "train_resnet50_chained": chained["resnet_replay"][name]},
            # conv1x1_bn_act: the largest error against plain over the nine bf16 shapes;
            # conv1x1_bwd_dz: over its phase A cases, where it must be bit-equal.
            "max_abs_err": err,
            # The nine launches of one ResNet-50 step at batch 256, summed; per shape below.
            "ms": total["ms"],
            "plain_ms": total["plain_ms"],
            "bound_ms": total["bound_ms"],
            "bound_by": total["bound_by"],
            "library_ms": total["library_ms"],
            "shapes": shapes,
            "dtype": "bfloat16",
            "design": DESIGN[name],
        })
        if name == "conv1x1_bn_act":
            # ConvNeXt-L's expand + gelu: the 36 launches of a micro-batch forward, summed
            # (each shape times its blocks), and each shape alone; by variant on the path.
            kernels[-1]["convnext_l"] = {**convnext_total, "max_abs_err": convnext_err, "shapes": convnext_times,
                                         "launches_by_variant": {v: convnext_launches[v] for v in ("wgmma", "cuda_cores")},
                                         "source_by_variant": {"wgmma": "distributed_training_pytorch_tpu_torch/csrc/conv1x1_wgmma.cu",
                                                               "cuda_cores": "distributed_training_pytorch_tpu_torch/csrc/conv1x1_bn_act.cu"}}
    for kind, launch_key, replaces, source in (("fwd", "fwd", ":399", "flash_fwd_wgmma.cu"),
                                               ("bwd", "bwd_dq", ":415", "flash_bwd_wgmma.cu")):
        r = ring["k5"][kind]
        kernels.append({
            "name": f"flash_block_{kind}",
            "route": "cuda",
            # K5 is a wrapper (ops/flash_attention.py) over the hand-written K1 or K2 + K3.
            "source": f"distributed_training_pytorch_tpu_torch/csrc/{source}",
            "wrapper": f"distributed_training_pytorch_tpu_torch/ops/flash_attention.py::flash_block_{kind}",
            "replaces": f"distributed_training_pytorch_tpu/ops/pallas.py{replaces}",
            "launches": ring_launches[launch_key],
            "launches_by_path": {"train_ring": ring_launches[launch_key], "train": 0, "train_resnet50": 0,
                                 "train_vgg16": 0, "serve": 0, "train_vit_b16": 0, "train_convnext_l": 0,
                                 "train_folder": 0, "train_digits": 0, "train_records": 0,
                                 "train_records_resnet50": 0, "train_digits_fp16": 0, "eval_lm": 0,
                                 "decode": lm_eval["decode_launches"][launch_key],
                                 "train_lm_chained": 0, "train_resnet50_chained": 0},
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
