"""Offline LM evaluation and sampling of a checkpoint of the port's LM entry.

Counterpart of the repository's ``examples/eval_lm.py``: restores a ``train_lm.py``
checkpoint (the params alone, through the port's ``CheckpointManager``), reports the
byte-level NLL and perplexity over a corpus, prints greedy and sampled continuations of a
prompt through the KV-cache decode path (``models.transformer_lm.generate``: a CUDA graph a
step on the card), and times that decode. Run:

    python -m distributed_training_pytorch_tpu_torch.examples.eval_lm [checkpoint_dir] [corpus_file]

Defaults ``./runs/lm/weights/last`` and ``LM_CORPUS`` (no corpus: no validation). Env
knobs, as the JAX entry reads them: ``SEQ_LEN`` (256; must match training), ``LM_SIZE``
(``tiny`` | ``small``), ``EVAL_BATCH`` (64), ``PROMPT`` (default ``"the "``), ``GEN_STEPS``
(64), ``TEMPERATURE`` (0.8; 0 = greedy only), ``MOE_EVERY`` (0; must match training: an MoE
model evaluates with capacity routing and generates with the capacity-free decode, as in the
JAX entry), ``DECODE_BATCHES`` (e.g. ``1,8,32,128``: batched decode rates) and
``DECODE_GEN_STEPS`` (128). The port adds ``DEVICE`` (``cuda`` unless set to ``cpu``).

It prints the JAX entry's lines: ``VALIDATION:``, ``--- name ---`` before each text,
``DECODE:`` (batch 1, greedy, counting every single-token step, the prompt's ``P - 1``
prefill steps included, as the JAX entry does) and ``DECODE_BATCH`` rows. The port adds
``DECODE_NEW:``, the rate of generated tokens alone: the prefill steps take their time but
are not counted as tokens (``examples/eval_lm.py:146`` counts them; ``ROADMAP.md`` R3).

An Orbax checkpoint of the JAX package is not read here: that comes with the Orbax
importer (``ROADMAP.md`` Queue 1 item 7), and ``load_params`` raises
``NotImplementedError`` naming it.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from distributed_training_pytorch_tpu_torch.checkpoint import CheckpointManager
from distributed_training_pytorch_tpu_torch.checkpoint.manager import STATE_NAME
from distributed_training_pytorch_tpu_torch.examples.train_lm import load_windows
from distributed_training_pytorch_tpu_torch.models import GPTSmall, LMTiny
from distributed_training_pytorch_tpu_torch.models.transformer_lm import generate
from distributed_training_pytorch_tpu_torch.train import TrainState

__all__ = ["build_model", "decode_benchmark", "evaluate", "load_params", "main", "sample"]


def build_model(size: str, seq_len: int, moe_every: int = 0, *, device="cuda", dtype=torch.bfloat16):
    """The entry's model: byte-level (vocab 256), bf16 compute, ``max_len`` at least 128."""
    factory = {"tiny": LMTiny, "small": GPTSmall}[size]
    return factory(vocab_size=256, dtype=dtype, max_len=max(seq_len, 128), moe_every=moe_every, device=device)


def load_params(checkpoint_dir: str, size: str, seq_len: int, moe_every: int = 0, *, device="cuda"):
    """``(model, params)`` from a ``train_lm`` checkpoint: the model in eval mode with the
    checkpoint's weights in it, and its state dict. ``moe_every`` must match training."""
    path = os.path.abspath(checkpoint_dir.rstrip("/"))
    if os.path.isdir(os.path.join(path, "params")) and not os.path.isfile(os.path.join(path, STATE_NAME)):
        raise NotImplementedError(
            f"{path} is an Orbax checkpoint of the JAX package; reading one comes with the Orbax importer "
            "(ROADMAP.md Queue 1 item 7)"
        )
    model = build_model(size, seq_len, moe_every, device=device)
    state = TrainState(model=model, optimizer=torch.optim.SGD(model.parameters(), lr=0.0))
    CheckpointManager(os.path.dirname(path)).restore(path, state, params_only=True)
    return model.eval(), model.state_dict()


def evaluate(checkpoint_dir: str, corpus: str, *, size="small", seq_len=256, batch=64, moe_every=0, loaded=None,
             device="cuda") -> dict:
    """``{"nll": mean byte NLL, "ppl": perplexity, "n_windows": N}`` over every window of
    ``corpus``, the tail batch included. On the card the forward runs the flash-attention
    kernel, once a layer a batch."""
    windows = load_windows(seq_len, path=corpus)
    model, _ = loaded or load_params(checkpoint_dir, size, seq_len, moe_every, device=device)
    dev = model.embed.weight.device
    total, count, n_windows = 0.0, 0, 0
    # Full batches, then the tail: dropping it, or scoring an empty corpus as nll 0,
    # would fabricate a result.
    with torch.no_grad():
        for i in range(0, len(windows), batch):
            chunk = torch.from_numpy(windows[i : i + batch]).to(dev).long()
            logp = torch.log_softmax(model(chunk[:, :-1]), dim=-1)
            nll = -torch.gather(logp, -1, chunk[:, 1:, None])[..., 0]
            total += float(nll.sum())
            count += nll.numel()
            n_windows += len(chunk)
    if count == 0:
        raise ValueError(f"no evaluation windows (corpus too short for SEQ_LEN={seq_len})")
    nll = total / count
    return {"nll": nll, "ppl": float(np.exp(nll)), "n_windows": n_windows}


def _timed_generate(model, prompt, gen_steps, *, graph=True) -> "tuple[torch.Tensor, float]":
    """A greedy ``generate`` and its wall seconds; the copy to the host is the sync."""
    if prompt.device.type == "cuda":
        torch.cuda.synchronize(prompt.device)
    t0 = time.perf_counter()
    out = generate(model, prompt, gen_steps, graph=graph).cpu()
    return out, time.perf_counter() - t0


def sample(checkpoint_dir: str, prompt_text: bytes, *, size="small", seq_len=256, gen_steps=64, temperature=0.8,
           moe_every=0, loaded=None, timings: "dict | None" = None, device="cuda") -> dict:
    """``{"greedy": bytes, "t=<temperature>": bytes}``, each the prompt and its
    continuation. With ``timings``, a second greedy call is timed (the first pays the
    graph's capture) and its rates stored there."""
    model, _ = loaded or load_params(checkpoint_dir, size, seq_len, moe_every, device=device)
    dev = model.embed.weight.device
    prompt = torch.from_numpy(np.frombuffer(prompt_text, np.uint8).astype(np.int64)[None, :]).to(dev)
    greedy, _ = _timed_generate(model, prompt, gen_steps)
    if timings is not None:
        greedy, dt = _timed_generate(model, prompt, gen_steps)
        # The loop runs P - 1 prompt (prefill) steps and gen_steps generation steps, each
        # one single-token cached decode.
        decode_steps = prompt.shape[1] - 1 + gen_steps
        timings.update(decode_tok_per_s=decode_steps / dt, decode_steps=decode_steps,
                       new_tok_per_s=gen_steps / dt, gen_steps=gen_steps, seconds=dt)
    out = {"greedy": bytes(greedy[0].numpy().astype(np.uint8))}
    if temperature > 0:
        gen = torch.Generator(device=dev).manual_seed(1)
        sampled = generate(model, prompt, gen_steps, gen, temperature=temperature)
        out[f"t={temperature}"] = bytes(sampled[0].cpu().numpy().astype(np.uint8))
    return out


def decode_benchmark(model, *, prompt_len=32, gen_steps=128, batches=(1, 8, 32, 128), graph=True) -> "list[dict]":
    """Batched KV-cache decode rates: greedy ``generate`` at each batch size, the second
    of two calls timed (the first captures the graph). ``tok_per_s`` counts every step's
    token, prefill included, as the JAX entry does; ``new_tok_per_s`` counts generated
    tokens alone. ``graph=False`` times the eager loop."""
    dev = model.embed.weight.device
    base = torch.arange(prompt_len, dtype=torch.long, device=dev)[None, :] % 200 + 32
    rows = []
    for b in batches:
        prompt = base.expand(b, prompt_len)
        _timed_generate(model, prompt, gen_steps, graph=graph)
        _, dt = _timed_generate(model, prompt, gen_steps, graph=graph)
        steps = prompt_len - 1 + gen_steps  # prefill + generation, all cached
        rows.append({
            "batch": b,
            "graph": bool(graph and dev.type == "cuda"),
            "tok_per_s": b * steps / dt,
            "tok_per_s_per_stream": steps / dt,
            "new_tok_per_s": b * gen_steps / dt,
            "step_ms": dt / steps * 1e3,
        })
    return rows


def main(argv: "list[str] | None" = None, device: "str | None" = None) -> dict:
    """The entry: validation when a corpus is given, the samples, the decode rates."""
    argv = sys.argv[1:] if argv is None else argv
    ckpt = argv[0] if argv else "./runs/lm/weights/last"
    corpus = argv[1] if len(argv) > 1 else os.environ.get("LM_CORPUS", "")
    size = os.environ.get("LM_SIZE", "small")
    seq_len = int(os.environ.get("SEQ_LEN", "256"))
    moe_every = int(os.environ.get("MOE_EVERY", "0"))  # must match training
    device = device or os.environ.get("DEVICE", "cuda")
    loaded = load_params(ckpt, size, seq_len, moe_every, device=device)  # restore once
    report: dict = {}
    if corpus:
        results = evaluate(ckpt, corpus, size=size, seq_len=seq_len, batch=int(os.environ.get("EVAL_BATCH", "64")),
                           loaded=loaded)
        print(f"VALIDATION: nll={results['nll']:.4f} ppl={results['ppl']:.2f} ({results['n_windows']} windows)")
        report["validation"] = results
    prompt = os.environ.get("PROMPT", "").encode() or b"the "
    timings: dict = {}
    texts = sample(ckpt, prompt, size=size, seq_len=seq_len, gen_steps=int(os.environ.get("GEN_STEPS", "64")),
                   temperature=float(os.environ.get("TEMPERATURE", "0.8")), loaded=loaded, timings=timings)
    for name, text in texts.items():
        print(f"--- {name} ---")
        print(text.decode("utf-8", errors="replace"))
    print(f"DECODE: {timings['decode_tok_per_s']:.1f} tok/s "
          f"(greedy, batch 1, {timings['decode_steps']} single-token steps)")
    print(f"DECODE_NEW: {timings['new_tok_per_s']:.1f} tok/s "
          f"(greedy, batch 1, {timings['gen_steps']} generated tokens; the prefill steps' time counted, their tokens not)")
    report.update(samples={k: v.decode("utf-8", errors="replace") for k, v in texts.items()}, timings=timings)
    if os.environ.get("DECODE_BATCHES"):
        batches = tuple(int(x) for x in os.environ["DECODE_BATCHES"].split(","))
        rows = decode_benchmark(loaded[0], gen_steps=int(os.environ.get("DECODE_GEN_STEPS", "128")), batches=batches)
        for row in rows:
            print(
                f"DECODE_BATCH {row['batch']:4d}: {row['tok_per_s']:9.1f} tok/s "
                f"aggregate, {row['tok_per_s_per_stream']:7.1f} tok/s/stream, "
                f"{row['step_ms']:.2f} ms/step"
            )
        report["decode_batches"] = rows
    return report


if __name__ == "__main__":
    main()
