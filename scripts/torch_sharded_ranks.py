"""Train the port's LM entry as 4 ranks of a ``torch.distributed`` world on the CPU (gloo),
under sharded meshes, and save a checkpoint of each: the producer of an elastic resume.

Usage:

    python3 scripts/torch_sharded_ranks.py --workdir DIR

Each run of ``RUNS`` (``MESH``, steps, save after) builds the entry's trainer
(``examples/train_lm.py::build_trainer``: GPT-2-small, vocab 256, ``SEQ_LEN`` 256, f32,
``DEVICE=cpu``, ``MESH``) on every rank, takes its steps of the trainer's ``train_step`` on
global batch ``i`` = windows ``[i * BATCH, (i + 1) * BATCH)`` of the entry's training
windows (each batch shard its rows), and saves ``last`` under ``DIR/MESH/weights`` when
its save step is done, and ``after`` when it took steps past that save (the params a
resume of ``last`` should reach). The script starts the ranks itself
(``tcp://localhost:<free port>``), waits for them, and prints one JSON line: for each run
the mesh, the sharding record, the per-step losses and the checkpoints' paths, and the
wall, and ``ENV``. Exit 0 when every rank finished. Runs share the ranks, in ``RUNS``' order.
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
ENV = {"LM_SIZE": "small", "SEQ_LEN": "256", "BATCH": "8", "DTYPE": "fp32", "EPOCHS": "1"}
RUNS = (("fsdp4", 3, 2), ("fsdp2tp2", 1, 1))  # MESH, steps, save `last` after this many
THREADS = 2  # intra-op threads of each rank
TIMEOUT_S = 900.0
AFTER = "after"


def worker(workdir: str, rank: int, init: str) -> None:
    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    from distributed_training_pytorch_tpu_torch.checkpoint import LAST
    from distributed_training_pytorch_tpu_torch.examples import train_lm
    from distributed_training_pytorch_tpu_torch.parallel import mesh as mesh_lib

    torch.set_num_threads(THREADS)
    mesh_lib.setup_distributed(init, world_size=RANKS, rank=rank, backend="gloo")
    batch_size = int(ENV["BATCH"])
    result = {}
    for mesh_spec, steps, save_at in RUNS:
        t0 = time.perf_counter()
        folder = os.path.join(workdir, mesh_spec)
        os.environ.update(ENV, MESH=mesh_spec, SAVE_DIR=folder)
        os.environ.pop("SNAPSHOT", None)
        trainer = train_lm.build_trainer(device="cpu")
        mesh = trainer.mesh
        rows = trainer.train_dataset.arrays
        n = batch_size // mesh.batch_extent
        losses = []
        for step in range(steps):
            if step == save_at:
                trainer.checkpoints.save(LAST, trainer.state, 1)
            lo = step * batch_size + mesh.batch_index * n
            batch = {k: torch.from_numpy(np.ascontiguousarray(v[lo:lo + n])) for k, v in rows.items()}
            trainer.state, metrics = trainer.train_step(trainer.state, batch)
            losses.append(float(metrics["loss"]))
            trainer.log(f"{mesh_spec} step {step + 1}: loss {losses[-1]!r}")
        trainer.checkpoints.save(LAST if save_at == steps else AFTER, trainer.state, 1)
        weights = os.path.join(folder, "weights")
        result[mesh_spec] = {"mesh": mesh_lib.mesh_axes(mesh), "record": trainer.state.sharding, "losses": losses,
                             "checkpoint": os.path.join(weights, LAST), "saved_after": save_at,
                             "after": os.path.join(weights, AFTER) if save_at < steps else None,
                             "wall_s": time.perf_counter() - t0, "layout": trainer.state.layout.describe()
                             if trainer.state.layout is not None else None}
        del trainer
    if rank == 0:
        with open(os.path.join(workdir, "ranks.json"), "w") as f:
            json.dump(result, f)
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
        runs = json.load(f)
    print(json.dumps({"ok": True, "ranks": RANKS, "env": ENV, "runs": runs, "wall_s": wall}))
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
