"""Train a pipelined LM through the port's LM entry as 4 ranks of a ``torch.distributed``
world on the CPU (gloo) under ``MESH=pp4``: one pipeline stage a rank. The producer of the
pipeline check on the card.

Usage:

    python3 scripts/torch_pipe_ranks.py --workdir DIR

Every rank builds the entry's trainer (``examples/train_lm.py::build_trainer`` with ``ENV``:
vocab 256, T=64, batch 8, f32, ``DEVICE=cpu``, ``MESH=pp4``) through ``PipeLM``, the
entry's trainer whose model is a ``models.pipelined_lm.PipelinedLM`` of an LM at LMTiny's
width with ``DEPTH`` blocks (one a stage), ``N_MICRO`` micro-batches a step, trained by
plain SGD at a constant ``LR`` (an update with no Adam normalisation, which would turn
float noise in a near-zero gradient into a step of the learning rate's size). Each rank
takes one ``train_step`` on the entry's first ``BATCH`` training windows (the pipe axis
does not split the batch): :func:`entry_step`, which
``tests/test_torch_pipeline_distributed.py`` also runs under ``MESH=dp2pp2``. Rank 0 writes
``DIR/before.pt`` (the params before the step), ``DIR/after.pt`` (after it) and
``DIR/batch.pt``. The script starts the ranks itself (``tcp://localhost:<free port>``),
waits for them, and prints one JSON line: the mesh, the step's metrics, the model's
settings and the wall. Exit 0 when every rank finished.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 4
ENV = {"LM_SIZE": "tiny", "SEQ_LEN": "64", "BATCH": "8", "DTYPE": "fp32", "EPOCHS": "1", "MESH": "pp4",
       "SAVE_PERIOD": "0"}
DEPTH, N_MICRO = 4, 4  # LMTiny's width (32, 4 heads, mlp 64) at 4 blocks: one a stage
LR = 0.1
THREADS = 1  # intra-op threads of each rank
TIMEOUT_S = 600.0


def pipelined_lm(mesh, device):
    """The script's model: ``PipelinedLM`` of an f32 ``TransformerLM`` at LMTiny's width with
    ``DEPTH`` blocks over ``mesh`` (what the card's step rebuilds, on ``device``)."""
    from distributed_training_pytorch_tpu_torch.models import TransformerLM
    from distributed_training_pytorch_tpu_torch.models.pipelined_lm import PipelinedLM

    lm = TransformerLM(256, hidden_dim=32, depth=DEPTH, num_heads=4, mlp_dim=64, max_len=128, device=device)
    return PipelinedLM(lm, mesh, n_micro=N_MICRO)


def entry_step(spec: str, save_dir: str):
    """One ``train_step`` of the LM entry's trainer (``ENV``, ``MESH=spec``, ``DEVICE=cpu``)
    through ``PipeLM`` on this process's rows of the entry's first ``BATCH`` training
    windows: its data shard's block of them, in order (all of them with one data shard).
    Returns ``(trainer, batch, params before, params after, metrics)``. Under a data axis
    above 1 the trainer wraps the model in DDP over the data group, and the metrics are
    averaged over it."""
    import numpy as np
    import torch

    from distributed_training_pytorch_tpu_torch.examples import train_lm
    from distributed_training_pytorch_tpu_torch.models.pipelined_lm import lm_logits_loss

    class PipeLM(train_lm.LMTrainer):
        def build_model(self):
            return pipelined_lm(self.mesh, self.device)

        def build_loss_fn(self):
            return lm_logits_loss

        def build_scheduler(self):
            return lambda step: LR

        def build_optimizer(self, schedule):
            return torch.optim.SGD(self.model.parameters(), lr=LR)

    knobs = (*ENV, "SAVE_DIR", "SNAPSHOT", "LM_CORPUS", "TELEMETRY")
    saved = {k: os.environ.get(k) for k in knobs}
    os.environ.update(ENV, MESH=spec, SAVE_DIR=save_dir)
    for knob in ("SNAPSHOT", "LM_CORPUS", "TELEMETRY"):
        os.environ.pop(knob, None)
    try:
        trainer = train_lm.build_trainer(device="cpu", trainer_cls=PipeLM)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    mesh = trainer.mesh
    rows = int(ENV["BATCH"]) // mesh.shape["data"]
    lo = mesh.data_index * rows
    batch = {k: torch.from_numpy(np.ascontiguousarray(v[lo:lo + rows])) for k, v in trainer.train_dataset.arrays.items()}
    before = {k: v.clone() for k, v in trainer.state.params.items()}
    trainer.state, metrics = trainer.train_step(trainer.state, batch)
    return trainer, batch, before, trainer.state.params, metrics


def worker(workdir: str, rank: int, init: str) -> None:
    import torch

    sys.path.insert(0, REPO)
    from distributed_training_pytorch_tpu_torch.parallel import mesh as mesh_lib

    torch.set_num_threads(THREADS)
    mesh_lib.setup_distributed(init, world_size=RANKS, rank=rank, backend="gloo")
    t0 = time.perf_counter()
    trainer, batch, before, after, metrics = entry_step(ENV["MESH"], os.path.join(workdir, "run"))
    mesh = trainer.mesh
    if rank == 0:
        torch.save(before, os.path.join(workdir, "before.pt"))
        torch.save(after, os.path.join(workdir, "after.pt"))
        torch.save(batch, os.path.join(workdir, "batch.pt"))
        with open(os.path.join(workdir, "ranks.json"), "w") as f:
            json.dump({"mesh": mesh_lib.mesh_axes(mesh), "pipe_ranks": list(mesh.pipe_ranks),
                       "metrics": {k: float(v) for k, v in metrics.items()}, "lr": LR, "depth": DEPTH,
                       "n_micro": N_MICRO, "rank_wall_s": time.perf_counter() - t0}, f)
    mesh_lib.shutdown_distributed()


def launch(workdir: str) -> int:
    os.makedirs(workdir, exist_ok=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS=str(THREADS))
    for knob in ("RANK", "WORLD_SIZE", "MESH", "SNAPSHOT"):
        env.pop(knob, None)
    base = [sys.executable, os.path.abspath(__file__), "--workdir", workdir, "--init", f"tcp://localhost:{port}"]
    t0 = time.perf_counter()
    logs = [open(os.path.join(workdir, f"rank{r}.log"), "w") for r in range(RANKS)]
    procs = [subprocess.Popen(base + ["--rank", str(r)], stdout=logs[r], stderr=subprocess.STDOUT, env=env, cwd=REPO)
             for r in range(RANKS)]
    try:
        codes = [p.wait(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    wall = time.perf_counter() - t0
    if codes != [0] * RANKS:
        for r in range(RANKS):
            with open(os.path.join(workdir, f"rank{r}.log")) as f:
                print(f"--- rank {r} (exit {codes[r]}):\n{f.read()[-4000:]}", file=sys.stderr)
        print(json.dumps({"ok": False, "codes": codes, "wall_s": wall}))
        return 1
    with open(os.path.join(workdir, "ranks.json")) as f:
        result = json.load(f)
    print(json.dumps({"ok": True, "ranks": RANKS, "env": ENV, **result, "workdir": workdir, "wall_s": wall}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        worker(args.workdir, args.rank, args.init)
        return 0
    return launch(args.workdir)


if __name__ == "__main__":
    sys.exit(main())
