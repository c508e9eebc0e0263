"""Train the port's LM entry with Mixture-of-Experts blocks as 2 ranks of a
``torch.distributed`` world on the CPU (gloo) under ``MESH=ep2``: the experts of each MoE
layer split over the expert group. The producer of the expert-parallel check on the card.

Usage:

    python3 scripts/torch_expert_ranks.py --workdir DIR

Both ranks build the entry's trainer (``examples/train_lm.py::build_trainer`` with
``ENV``: LMTiny, ``MOE_EVERY=2``, 8 experts, vocab 256, f32, ``DEVICE=cpu``,
``MESH=ep2``) through ``SGDLM``, the entry's trainer with plain SGD at a constant ``LR``
(an update with no Adam normalisation, which would turn float noise in a near-zero
gradient into a step of the learning rate's size), and take one ``train_step`` on the
entry's first ``BATCH`` training windows (both ranks hold the one batch shard). Rank 0
writes ``DIR/before.pt`` (the global params before the step), ``DIR/after.pt`` (after it)
and ``DIR/batch.pt``. The script starts the ranks itself (``tcp://localhost:<free
port>``), waits for them, and prints one JSON line: the mesh, the sharding record, the
step's metrics, the layout and the wall. Exit 0 when both ranks finished.
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
RANKS = 2
ENV = {"LM_SIZE": "tiny", "SEQ_LEN": "64", "BATCH": "8", "DTYPE": "fp32", "EPOCHS": "1", "MOE_EVERY": "2",
       "MESH": "ep2", "SAVE_PERIOD": "0"}
LR = 0.1
THREADS = 1  # intra-op threads of each rank
TIMEOUT_S = 600.0


def worker(workdir: str, rank: int, init: str) -> None:
    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    from distributed_training_pytorch_tpu_torch.examples import train_lm
    from distributed_training_pytorch_tpu_torch.parallel import mesh as mesh_lib

    class SGDLM(train_lm.LMTrainer):
        def build_scheduler(self):
            return lambda step: LR

        def build_optimizer(self, schedule):
            return torch.optim.SGD(self.model.parameters(), lr=LR)

    torch.set_num_threads(THREADS)
    mesh_lib.setup_distributed(init, world_size=RANKS, rank=rank, backend="gloo")
    t0 = time.perf_counter()
    os.environ.update(ENV, SAVE_DIR=os.path.join(workdir, "run"))
    for knob in ("SNAPSHOT", "LM_CORPUS", "TELEMETRY"):
        os.environ.pop(knob, None)
    trainer = train_lm.build_trainer(device="cpu", trainer_cls=SGDLM)
    mesh = trainer.mesh
    rows = trainer.train_dataset.arrays
    batch_size = int(ENV["BATCH"])
    n = batch_size // mesh.batch_extent
    lo = mesh.batch_index * n
    batch = {k: torch.from_numpy(np.ascontiguousarray(v[lo:lo + n])) for k, v in rows.items()}
    before = {k: v.clone() for k, v in trainer.state.params.items()}  # collective; the live tensors step on
    trainer.state, metrics = trainer.train_step(trainer.state, batch)
    after = trainer.state.params
    if rank == 0:
        torch.save(before, os.path.join(workdir, "before.pt"))
        torch.save(after, os.path.join(workdir, "after.pt"))
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v[:batch_size])) for k, v in rows.items()},
                   os.path.join(workdir, "batch.pt"))
        with open(os.path.join(workdir, "ranks.json"), "w") as f:
            json.dump({"mesh": mesh_lib.mesh_axes(mesh), "record": trainer.state.sharding,
                       "metrics": {k: float(v) for k, v in metrics.items()}, "layout": trainer.state.layout.describe(),
                       "local_w_in": list(trainer.model.blocks[1].moe.w_in.shape), "lr": LR,
                       "rank_wall_s": time.perf_counter() - t0}, f)
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
