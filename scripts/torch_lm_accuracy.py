#!/usr/bin/env python3
"""The port's LM train-to-accuracy run on real text, on one card: the recipe of
``docs/lm_ppl.json`` through the port's entries. Run from the repository's root:

    python3 scripts/torch_lm_accuracy.py [OUT]        (default OUT: runs/accuracy)

1. ``examples/make_lm_corpus.py``: 24 MB of the text installed with the interpreter, into
   ``build/acc/lm_corpus.txt`` (its byte count and SHA-256 are recorded: a machine without
   jax builds other bytes than one with it);
2. ``examples/train_lm.py`` with ``LM_CORPUS`` set, ``LM_SIZE=small SEQ_LEN=256 BATCH=256
   EPOCHS=6 SAVE_PERIOD=2 LAST_SAVE_PERIOD=100`` (validation before epochs 0, 2 and 4, as
   the JAX record's), checkpoints under ``build/acc/lm_run``; each epoch's train NLL and
   each validation's NLL;
3. ``examples/eval_lm.py`` on ``best``: the held-out tail (the windows of the trainer's 5 %
   validation split, written to a file of their own), the whole corpus, greedy and t=0.8
   continuations of ``"the "``, and the batch-1 decode rates.

Writes ``OUT/torch_lm_ppl.json`` (with the card's name and power limit and the walls) and
prints it. ``DEVICE=cpu`` (the port's knob) runs it on the CPU, which only a cut-down
``RECIPE`` makes sensible.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = {"LM_SIZE": "small", "SEQ_LEN": "256", "BATCH": "256", "EPOCHS": "6", "SAVE_PERIOD": "2",
          "LAST_SAVE_PERIOD": "100"}
CORPUS_MB = 24.0


def card() -> str:
    if os.environ.get("DEVICE") == "cpu":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def main() -> int:
    out_dir = sys.argv[1] if len(sys.argv) > 1 else "runs/accuracy"
    sys.path.insert(0, REPO)
    import numpy as np

    from distributed_training_pytorch_tpu_torch.examples import eval_lm, make_lm_corpus, train_lm

    work = os.path.join(REPO, "build", "acc")
    os.makedirs(work, exist_ok=True)
    os.makedirs(out_dir, exist_ok=True)
    corpus_path = os.path.join(work, "lm_corpus.txt")
    t0 = time.perf_counter()
    corpus = make_lm_corpus.main([corpus_path, str(CORPUS_MB)])
    save_dir = os.path.join(work, "lm_run")
    os.environ.update(RECIPE, LM_CORPUS=corpus_path, SAVE_DIR=save_dir)
    train_metrics, val_metrics = [], []
    device = os.environ.get("DEVICE", "cuda")
    trainer = train_lm.build_trainer(device)
    train_epoch, validate = trainer.train_epoch, trainer.validate

    def recorded_train_epoch(epoch):
        train_metrics.append({k: float(v) for k, v in train_epoch(epoch).items()})
        return train_metrics[-1]

    def recorded_validate():
        val_metrics.append({"epoch": trainer.cur_epoch, **{k: float(v) for k, v in validate().items()}})
        return val_metrics[-1]

    trainer.train_epoch, trainer.validate = recorded_train_epoch, recorded_validate
    t_train = time.perf_counter()
    trainer.train()
    train_s = time.perf_counter() - t_train
    n_windows = len(trainer.windows)
    del trainer

    seq = int(RECIPE["SEQ_LEN"])
    best = os.path.join(save_dir, "weights", "best")
    best_meta = json.load(open(os.path.join(best, "meta.json")))
    # The trainer's validation split: windows [int(0.95 N):], which start at byte seq * that.
    tail_path = os.path.join(work, "lm_corpus_tail.txt")
    with open(corpus_path, "rb") as f:
        data = f.read()
    with open(tail_path, "wb") as f:
        f.write(data[seq * int(n_windows * 0.95) :])
    t_eval = time.perf_counter()
    loaded = eval_lm.load_params(best, RECIPE["LM_SIZE"], seq, device=device)
    held_out = eval_lm.evaluate(best, tail_path, seq_len=seq, loaded=loaded)
    full = eval_lm.evaluate(best, corpus_path, seq_len=seq, loaded=loaded)
    timings: dict = {}
    texts = eval_lm.sample(best, b"the ", seq_len=seq, gen_steps=64, temperature=0.8, loaded=loaded,
                           timings=timings)
    eval_s = time.perf_counter() - t_eval
    record = {
        "description": "The port's LM train-to-accuracy run (PyTorch/CUDA, one H100): GPT-2-small byte-level LM "
                       "trained on real in-env text through examples/train_lm.py, evaluated offline from the saved "
                       "best checkpoint through examples/eval_lm.py; the counterpart of docs/lm_ppl.json.",
        "card": card(),
        "command": "python3 scripts/torch_lm_accuracy.py (scripts/torch_accuracy_runs.sh, leg lm)",
        "config": {**RECIPE, "model": "GPTSmall (12 x 768, 12 heads, vocab 256 bytes), bf16 compute, f32 params, "
                                      "fused tied CE, K1-K3 on the card",
                   "recipe": "AdamW wd 0.1 b2 0.95, warmup-cosine base_lr 3e-4, global batch 256",
                   "windows": n_windows, "split": "first 95 % train, last 5 % validation"},
        "corpus": {"bytes": corpus["bytes"], "sha256": corpus["sha256"],
                   "roots": [root for root, _ in make_lm_corpus._roots()], "python": sys.version.split()[0],
                   "note": "make_lm_corpus reads the text installed with the interpreter (these roots, walked in "
                           "order until 24 MB), so its bytes depend on the machine's Python, numpy and jax; "
                           "docs/lm_ppl.json's 24,000,000 bytes came from another machine and carry no SHA-256, "
                           "so its perplexity 2.64 is comparable with these as a run on like text, not on equal bytes"},
        "curve": {"train_nll_per_epoch": [m["nll"] for m in train_metrics],
                  "train_ppl_per_epoch": [m["ppl"] for m in train_metrics],
                  "val_nll_at_epoch": {str(m["epoch"]): m["nll"] for m in val_metrics},
                  "val_ppl_at_epoch": {str(m["epoch"]): float(np.exp(m["nll"])) for m in val_metrics}},
        "offline_eval_of_saved_checkpoint": {
            "checkpoint": f"best (epoch {best_meta['epoch']}, step {best_meta['step']})",
            "held_out_tail_nll": held_out["nll"], "held_out_tail_ppl": held_out["ppl"],
            "held_out_windows": held_out["n_windows"],
            "full_corpus_nll": full["nll"], "full_corpus_ppl": full["ppl"], "full_corpus_windows": full["n_windows"],
        },
        "generation_sample": {"prompt": "the ", "greedy": texts["greedy"].decode("utf-8", errors="replace"),
                              "sampled_t0.8": texts["t=0.8"].decode("utf-8", errors="replace")},
        "decode_batch1": timings,
        "wall_s": {"corpus": round(t_train - t0, 1), "train": round(train_s, 1), "eval": round(eval_s, 1),
                   "total": round(time.perf_counter() - t0, 1)},
    }
    with open(os.path.join(out_dir, "torch_lm_ppl.json"), "w") as f:
        json.dump(record, f, indent=2)
    print(json.dumps(record, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
