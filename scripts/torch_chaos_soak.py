#!/usr/bin/env python3
"""Kill and resume the port's digits training, and check that nothing is lost.

    python3 scripts/torch_chaos_soak.py                      # on the card
    python3 scripts/torch_chaos_soak.py --device cpu --narrow --batch 64 --epochs 2 --no-stall   # on a CPU

The port's leg of the chaos soak (the JAX package's is ``scripts/chaos_soak.py``). Every
child runs the port's digits entry (``examples/train_digits.py::build_trainer``: VGG16,
SGD with momentum, the digits corpus) with ``chain_steps=2``, background saves
(``async_checkpoint``), validation and ``best``/``last`` every epoch, and
``snapshot_path="latest_valid"``, for ``--epochs`` (1; every kill lands in epoch 0, and
2 also crosses an epoch boundary after the resumes). The soaked run is killed four times
in a row, each child resuming from the newest valid checkpoint the one before left. The
two children after the running one are started early: each imports torch and the port,
warms CUDA, cuBLAS and cuDNN, and then waits at a gate until the ones before it have ended
and the parent has checked what they left.

1. a graceful SIGTERM mid-epoch (the preemption handler, the emergency save of ``last``
   with its ``step_in_epoch``, exit code 3);
2. a SIGKILL mid-commit: the saver's ``commit_delay_s`` holds each background commit for
   a second before it touches the filesystem, and the kill comes as soon as the child
   has queued one;
3. a SIGKILL mid-window: right after a chained window has been dispatched (on the card,
   a CUDA graph replay still running on the device);
4. a hung step: a ``hang`` fault sleeps ``HANG_S`` past ``STEP_TIMEOUT_S``, the watchdog
   sends the SIGTERM, the child saves and exits 3;

then a fifth child runs to the end. An uninterrupted child runs the same configuration
beside them. The checks:

* after every kill at least one checkpoint is valid against its manifest (a stdlib
  re-hash of ``manifest.dtp.json``, sharing no code with the manager:
  ``scripts/torch_ckpt_validate.py``), and the graceful
  and watchdog saves of ``last`` record the step they stopped at;
* every resume succeeds, and the soaked run's final params are bit-exact against the
  uninterrupted run's (SHA-256 over every parameter's bytes). Both runs' children set
  ``torch.backends.cudnn.deterministic``, ``torch.use_deterministic_algorithms(True)``
  and ``CUBLAS_WORKSPACE_CONFIG``, so no atomics reorder a sum;
* the background save's hot-loop stall against the synchronous save's wall
  (``resilience.measure_save_stall``, best of 2) on GPT-2-small's training state, f32
  params and AdamW moments after one step, below ``STALL_BOUND`` (0.25, the JAX soak's
  bound).

The last line of standard output is one JSON object with the results; the exit code is
0 when every check passed. Work goes under ``--workdir``, which is kept; without it, a
new temporary directory under ``build/``, removed when every check passed.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_ckpt_validate import valid_checkpoints  # noqa: E402  (the soaks' shared check)

MARK = "CHAOS "
EXIT_PREEMPTED = 3
CHILD_TIMEOUT_S = 300.0
DIGITS_TRAIN = 1438  # the digits entry's train split
SIGTERM_AFTER = 4  # the graceful SIGTERM comes after the window that reaches this step
STEP_TIMEOUT_S = 2.0  # the hung child's step_timeout (the watchdog waits it x chain_steps)
HANG_S = 5.0  # how long the hung step sleeps
STALL_BOUND = 0.25  # the async save's stall over the sync save's wall (the JAX soak's bound)


# ---------------------------------------------------------------------------
# Children (import torch and the port).


def _say(*fields) -> None:
    print(MARK + " ".join(str(f) for f in fields), flush=True)


def _await_gate(gate: str, device: str) -> dict:
    """Set deterministic algorithms, warm CUDA, cuBLAS and cuDNN on the card, and wait
    for the parent to write ``gate``; its JSON is the child's settings."""
    import torch

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True)
    if device == "cuda":
        x = torch.zeros(1, 3, 8, 8, device="cuda")
        y = torch.nn.functional.conv2d(x, torch.zeros(4, 3, 3, 3, device="cuda"))
        (y.flatten(1) @ torch.zeros(y.flatten(1).shape[1], 4, device="cuda")).sum().item()
    _say("ready")
    deadline = time.monotonic() + CHILD_TIMEOUT_S
    while not os.path.exists(gate):
        if time.monotonic() > deadline:
            raise SystemExit(f"no go at {gate} within {CHILD_TIMEOUT_S} s")
        time.sleep(0.02)
    with open(gate, encoding="utf-8") as f:
        return json.load(f)


def child_train(args) -> int:
    import torch

    sys.path.insert(0, REPO)
    from distributed_training_pytorch_tpu_torch.examples import digits_data, train_digits
    from distributed_training_pytorch_tpu_torch.fault import FaultPlan
    from distributed_training_pytorch_tpu_torch.models import VGG16

    settings = _await_gate(args.gate, args.device)
    digits_data.materialize(args.data)
    overrides = dict(max_epoch=args.epochs, batch_size=args.batch, chain_steps=2, log_every=2,
                     save_period=1, last_save_period=1, snapshot_path="latest_valid", async_checkpoint=True,
                     logger=_Quiet())
    if settings.get("hang_at"):
        epoch, step = settings["hang_at"]
        overrides["fault_plan"] = FaultPlan().add("hang", epoch=epoch, step=step, payload=HANG_S)
        overrides["step_timeout"] = STEP_TIMEOUT_S
    if args.narrow:  # a CPU run: VGG16 at narrow widths, the entry otherwise unchanged
        def build_model(self):
            return VGG16(num_classes=len(self.labels), dtype=self.precision.compute_dtype, device=self.device,
                         stage_features=(8, 8, 16, 16, 16), classifier_widths=(32, 32))

        train_digits.DigitsTrainer.build_model = build_model
    trainer = train_digits.build_trainer(args.data, args.run, args.device, **overrides)
    trainer.saver.commit_delay_s = settings.get("commit_delay", 0.0)
    _say("resumed", trainer.cur_epoch, trainer._resume_step_in_epoch, trainer.state.step)

    chained, save_async = trainer.engine.train_steps_chained, trainer.saver.save_async
    epoch_of = {"epoch": trainer.cur_epoch}
    train_epoch = trainer.train_epoch

    def epoch_marked(epoch):
        epoch_of["epoch"] = epoch
        return train_epoch(epoch)

    def window_marked(state, batch, n):
        out = chained(state, batch, n)
        _say("window", epoch_of["epoch"], state.step)
        return out

    def save_marked(name, state, epoch, **kw):
        stall = save_async(name, state, epoch, **kw)
        _say("queued", name, epoch)
        return stall

    trainer.train_epoch, trainer.engine.train_steps_chained = epoch_marked, window_marked
    trainer.saver.save_async = save_marked
    trainer.train()
    if trainer.preempted:
        _say("preempted", trainer.cur_epoch, trainer._interrupted_at_step)
        return EXIT_PREEMPTED
    digest = hashlib.sha256()
    for name, value in sorted(trainer.model.state_dict().items()):
        digest.update(name.encode())
        digest.update(value.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    _say("params", digest.hexdigest(), trainer.state.step)
    return 0


class _Quiet:
    def log(self, msg, log_type="info"):
        if log_type != "info":
            print(f"{log_type.upper()}: {msg}", flush=True)


def child_stall(args) -> int:
    """GPT-2-small with AdamW after one step: the sync save's wall against the async save's
    stall."""
    import torch

    sys.path.insert(0, REPO)
    from distributed_training_pytorch_tpu_torch.checkpoint import CheckpointManager
    from distributed_training_pytorch_tpu_torch.models import GPTSmall
    from distributed_training_pytorch_tpu_torch.models.transformer_lm import make_fused_lm_loss
    from distributed_training_pytorch_tpu_torch.resilience import measure_save_stall
    from distributed_training_pytorch_tpu_torch.train import TrainEngine, TrainState

    dtype = torch.bfloat16 if args.device == "cuda" else torch.float32
    model = GPTSmall(vocab_size=256, dtype=dtype, max_len=1024, device=args.device)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, betas=(0.9, 0.95), weight_decay=0.1)
    engine = TrainEngine(make_fused_lm_loss(model))
    gen = torch.Generator(device=args.device).manual_seed(0)
    tokens = torch.randint(0, 256, (4, 257), device=args.device, generator=gen)
    state, _ = engine.train_step(TrainState(model=model, optimizer=opt),
                                 {"image": tokens[:, :-1], "label": tokens[:, 1:]})
    n_bytes = sum(t.numel() * t.element_size() for t in model.state_dict().values())
    n_bytes += sum(v.numel() * v.element_size() for s in opt.state.values() for v in s.values() if torch.is_tensor(v))
    out = measure_save_stall(CheckpointManager(args.run), state, repeats=2)
    out.update(model="GPTSmall", state_bytes=n_bytes)
    _say("stall", json.dumps(out))
    return 0


# ---------------------------------------------------------------------------
# The parent (standard library only).


def read_meta(weights: str, name: str) -> dict:
    with open(os.path.join(weights, name, "meta.json"), encoding="utf-8") as f:
        return json.load(f)


class Child:
    """One child process, started at once; a training child is held at its gate until
    :meth:`go`. Its marked lines are read on a thread, the rest kept for the log."""

    def __init__(self, argv, log_path, env, gated=True):
        self.t0 = time.perf_counter()
        self.t_go = None if gated else self.t0
        self.t_end = None
        self.gate = log_path + ".go"
        self.log = open(log_path, "w")
        gate = ["--gate", self.gate] if gated else []
        self.proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), *argv, *gate],
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
        self.marks: "list[list[str]]" = []
        self.mark_s: "list[float]" = []  # seconds from the start to each mark
        self.cond = threading.Condition()
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def go(self, **settings) -> "Child":
        """Open the gate with the child's settings (written whole, then renamed)."""
        with open(self.gate + ".tmp", "w", encoding="utf-8") as f:
            json.dump(settings, f)
        os.replace(self.gate + ".tmp", self.gate)
        self.t_go = time.perf_counter()
        return self

    def _read(self):
        for line in self.proc.stdout:
            self.log.write(line)
            if line.startswith(MARK):
                with self.cond:
                    self.marks.append(line[len(MARK):].split())
                    self.mark_s.append(time.perf_counter() - self.t0)
                    self.cond.notify_all()
        with self.cond:
            self.cond.notify_all()

    def wait_mark(self, predicate, timeout=CHILD_TIMEOUT_S):
        """The first mark (index, fields) after the ones seen that satisfies
        ``predicate``; None when the child ended or the time ran out."""
        deadline = time.monotonic() + timeout
        seen = 0
        with self.cond:
            while True:
                for i in range(seen, len(self.marks)):
                    if predicate(self.marks[i]):
                        return self.marks[i]
                seen = len(self.marks)
                left = deadline - time.monotonic()
                if left <= 0 or (self.proc.poll() is not None and not self.reader.is_alive()):
                    return None
                self.cond.wait(timeout=min(left, 0.5))

    def finish(self, timeout=CHILD_TIMEOUT_S) -> int:
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            rc = self.proc.wait()
        self.t_end = time.perf_counter()
        self.reader.join(timeout=10)
        self.log.close()
        return rc

    def mark(self, kind):
        return [m for m in self.marks if m[0] == kind]

    def timeline(self) -> dict:
        """Seconds from the start to the child's gate (imports and warm-up done), from the
        go to its resume (the restore included) and to its first window, and from the go
        to its end."""
        first = {}
        for fields, t in zip(self.marks, self.mark_s):
            first.setdefault(fields[0], t)
        since_go = (lambda t: None if t is None or self.t_go is None else round(t - (self.t_go - self.t0), 2))
        ready = first.get("ready")
        return {"ready_s": None if ready is None else round(ready, 2), "resumed_s": since_go(first.get("resumed")),
                "first_window_s": since_go(first.get("window")),
                "wall_s": since_go(self.t_end - self.t0)}


def run(args) -> dict:
    work = args.workdir or tempfile.mkdtemp(prefix="torch_chaos_", dir=os.path.join(REPO, "build"))
    os.makedirs(work, exist_ok=True)
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8", PYTHONUNBUFFERED="1")
    common = ["--device", args.device, "--epochs", str(args.epochs), "--batch", str(args.batch)]
    if args.narrow:
        common.append("--narrow")
    t0 = time.perf_counter()
    result = {"checks": {}, "kills": [], "workdir": work}
    checks = result["checks"]
    started: "list[Child]" = []

    def child(tag, run_dir, data):
        argv = ["--child", *common, "--run", run_dir, "--data", data]
        started.append(Child(argv, os.path.join(work, f"{tag}.log"), env))
        return started[-1]

    ref_dir, soak_dir = os.path.join(work, "ref"), os.path.join(work, "soak")
    weights = os.path.join(soak_dir, "weights")
    data = os.path.join(work, "data_soak")
    try:
        ref = child("ref", ref_dir, os.path.join(work, "data_ref")).go()
        stall = None
        if not args.no_stall:
            stall = Child(["--stall-child", "--device", args.device, "--run", os.path.join(work, "stall")],
                          os.path.join(work, "stall.log"), env, gated=False)
            started.append(stall)
        pending = iter(("1_sigterm", "2_kill_commit", "3_kill_window", "4_hang", "5_finish"))
        ahead: "list[Child]" = []

        def next_child(**settings) -> Child:
            """The next soak child, let through its gate; the two after it start now and
            wait at theirs (two, so that one short child does not expose the next's start)."""
            for tag in pending:
                ahead.append(child(tag, soak_dir, data))
                if len(ahead) == 3:
                    break
            return ahead.pop(0).go(**settings)

        def after_kill(tag, proc, rc):
            valid = valid_checkpoints(weights)
            result["kills"].append({"kill": tag, "rc": rc, "valid": valid, **proc.timeline()})
            checks[f"{tag}: a valid checkpoint remains"] = bool(valid)
            return valid

        # 1. a graceful SIGTERM mid-epoch, after the window that reaches SIGTERM_AFTER steps
        c = next_child()
        m = c.wait_mark(lambda f: f[0] == "window" and int(f[2]) >= SIGTERM_AFTER)
        if m is not None:
            c.proc.send_signal(signal.SIGTERM)
        rc = c.finish()
        after_kill("sigterm", c, rc)
        pre = c.mark("preempted")
        checks["sigterm: exit 3 after a preemption save"] = rc == EXIT_PREEMPTED and bool(pre)
        if pre:
            meta = read_meta(weights, "last")
            checks["sigterm: last records its step"] = meta.get("loop") == {"step_in_epoch": int(pre[0][2])}

        # 2. SIGKILL mid-commit: the first background save queued after the resume
        c = next_child(commit_delay=1.0)
        m = c.wait_mark(lambda f: f[0] == "queued")
        if m is not None:
            c.proc.kill()
        rc = c.finish()
        after_kill("sigkill mid-commit", c, rc)
        checks["sigkill mid-commit: killed after a queued save"] = m is not None and rc == -signal.SIGKILL
        resumed = c.mark("resumed")
        checks["sigkill mid-commit: it resumed"] = bool(resumed)

        # 3. SIGKILL mid-window: right after a window is dispatched, one window past the resume
        c = next_child()
        r = c.wait_mark(lambda f: f[0] == "resumed")
        resumed_at = int(r[3]) if r else 0
        m = c.wait_mark(lambda f: f[0] == "window" and int(f[2]) >= resumed_at + 4)
        if m is not None:
            c.proc.kill()
        rc = c.finish()
        after_kill("sigkill mid-window", c, rc)
        checks["sigkill mid-window: killed after a window"] = m is not None and rc == -signal.SIGKILL

        # 4. a hung step 3 steps past where the next child resumes: the watchdog's SIGTERM
        valid = valid_checkpoints(weights)
        names = sorted(valid, key=lambda n: os.path.getmtime(os.path.join(weights, n)), reverse=True)
        meta = read_meta(weights, names[0]) if names else {}
        hang_epoch, hang_step = int(meta.get("epoch", 0)), int((meta.get("loop") or {}).get("step_in_epoch", 0)) + 3
        if hang_step >= DIGITS_TRAIN // args.batch:
            hang_epoch, hang_step = hang_epoch + 1, 3
        c = next_child(hang_at=[hang_epoch, hang_step])
        rc = c.finish()
        after_kill("watchdog", c, rc)
        pre = c.mark("preempted")
        result["hang"] = {"epoch": hang_epoch, "step": hang_step}
        checks["watchdog: exit 3 after a preemption save"] = rc == EXIT_PREEMPTED and bool(pre)
        if pre:
            last = read_meta(weights, "last")
            checks["watchdog: last records the hung step"] = (last.get("epoch"), last.get("loop")) == (
                hang_epoch, {"step_in_epoch": hang_step})

        # 5. the rest of the run
        c = next_child()
        rc = c.finish()
        result["finish"] = c.timeline()
        soak_params = c.mark("params")
        checks["finish: the resumed run completes"] = rc == 0 and bool(soak_params)
        rc_ref = ref.finish()
        result["ref"] = ref.timeline()
        ref_params = ref.mark("params")
        checks["reference: completes"] = rc_ref == 0 and bool(ref_params)
        if soak_params and ref_params:
            result["params_sha256"] = {"soak": soak_params[0][1], "ref": ref_params[0][1]}
            checks["final params bit-exact against the uninterrupted run"] = soak_params[0][1:] == ref_params[0][1:]
        if stall is not None:
            rc_stall = stall.finish()
            got = stall.mark("stall")
            checks["stall: measured"] = rc_stall == 0 and bool(got)
            if got:
                result["stall"] = json.loads(" ".join(got[0][1:]))
                checks[f"stall: async stall below {STALL_BOUND} of the sync wall"] = (
                    result["stall"]["stall_ratio"] < STALL_BOUND)
    finally:
        for c in started:  # none is left running, whatever failed
            if c.proc.poll() is None:
                c.proc.kill()
                c.finish()
    result["wall_s"] = time.perf_counter() - t0
    result["ok"] = all(checks.values())
    if not result["ok"]:
        result["logs"] = {name: open(os.path.join(work, name)).read()[-3000:]
                          for name in sorted(os.listdir(work)) if name.endswith(".log")}
    elif args.workdir is None:
        shutil.rmtree(work, ignore_errors=True)
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--narrow", action="store_true", help="a narrow VGG16 (for a CPU run)")
    p.add_argument("--workdir", default=None, help="where the work goes, kept (default: a temporary directory)")
    p.add_argument("--no-stall", action="store_true", help="skip the save-stall measurement")
    # the child modes, which the script passes to itself
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--stall-child", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--run", help=argparse.SUPPRESS)
    p.add_argument("--data", help=argparse.SUPPRESS)
    p.add_argument("--gate", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:
        return child_train(args)
    if args.stall_child:
        return child_stall(args)
    result = run(args)
    for name, ok in result["checks"].items():
        print(f"{'PASS' if ok else 'FAIL'}  {name}")
    if result.get("logs"):
        for name, text in result["logs"].items():
            print(f"--- {name} (tail) ---\n{text}")
    result.pop("logs", None)
    print(json.dumps(result))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
