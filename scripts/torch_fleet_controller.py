#!/usr/bin/env python3
"""The port's fleet controller: doctor verdicts turned into remediation, with no human.

Counterpart of the JAX package's ``scripts/fleet_controller.py``, over the port's
``telemetry/controller.py`` (the policy) and ``telemetry/monitor.py`` (the doctor, live).
It supervises run directories, each a trainer subprocess it spawned (or a run it only
adopted), polls each through a ``RunMonitor``, feeds the statuses to a ``RunPolicy`` and
executes what it decides:

* ``dead`` (an abnormal exit, or a silent or hung log): **restart**, the trainer resumes
  from ``snapshot_path="latest_valid"`` on its own;
* a persistent ``straggler`` verdict naming a chip (a batch rank's index):
  **restart_excluding**, the mesh re-planned onto the survivors through
  ``parallel.elastic.replan_excluding`` and respawned on them;
* a persistent ``data_bound`` / ``checkpoint_stall`` alert: **tune**, one bounded knob
  change, then an A/B verdict through ``torch_run_compare.steady_diff``: **keep** or
  **revert**;
* a chip that ``restart_excluding`` freed is offered to a serving replica of the fleet
  (``offer_chip``): with the replica's admin ``port``, offer -> accept -> drain and re-plan
  (``/admin/offer``, ``/admin/replan``) -> A/B judge, or a ``revert`` with the replica's
  typed reason, re-armed; never a respawn of the replica.

Every decision is debounced, budgeted (``--max-restarts``, exponential backoff, one action
in flight a run) and audited: one ``controller_action`` record per action in the
controller's own event log (``--events``), with the evidence rows that justified it.

A child is started in a session of its own and stopped as a whole process group
(``os.killpg``): a two-rank child leaves no rank behind to hold the rendezvous, and each
attempt takes a fresh ``MASTER_PORT``. The exit code 3 is a preemption (a SIGTERM or the
step watchdog's save): abnormal, so the controller restarts the run.

Usage::

    # supervise runs; {run_dir} in --cmd is substituted per run
    python3 scripts/torch_fleet_controller.py RUN_DIR... \\
        --cmd 'env SAVE_DIR={run_dir} TELEMETRY=1 SNAPSHOT=latest_valid python3 -m \\
               distributed_training_pytorch_tpu_torch.examples.train_lm' --events ops.jsonl
    # adopt only (no --cmd): decisions are recorded, not executed
    python3 scripts/torch_fleet_controller.py RUN_DIR... --once
    # the closed-loop soak: a digits MLP fleet SIGKILL'd and loader-starved, hung, and with
    # a degraded rank; every run restored to completion, final params within ELASTIC_TOL
    # of uninterrupted twins (--device cpu on a machine without a card)
    python3 scripts/torch_fleet_controller.py --soak --quick [--device cpu]
    # the teeth: a zero-budget controller must refuse and exit non-zero
    python3 scripts/torch_fleet_controller.py --soak --quick --max-restarts 0
    # the LM entry under the controller (GPT-2-small, T=256, batch 32, bf16, 2 epochs; on a
    # CPU LMTiny at T=64), SIGKILL'd once a checkpoint past its first epoch has committed,
    # against an uninterrupted twin
    python3 scripts/torch_fleet_controller.py --lm [--device cpu]

The soak's legs (the JAX soak's): *killed* (SIGKILL'd once a valid checkpoint exists, and
loader-starved with ``--load-delay 0.02`` on 8 workers at prefetch 1: restart, then the
prefetch tune, A/B-judged), *hung* (a 6 s ``hang`` at epoch 1, step 4, under a 2 s
``step_timeout``: the watchdog's save and exit 3, then a restart) and *straggler*
(``fsdp2`` over two gloo ranks on the CPU, rank 1 slowed by 60 ms at every sync:
``restart_excluding`` chip 1, then the survivor resumes the fsdp2 checkpoint alone with
``accum_steps=2``). ``--serve-port``/``--serve-run-dir`` add a serving replica that the
freed chip is offered to. The soak's last line of standard output is one JSON object with
each run's actions, the final params' distance to its twin, each leg's time to recover, the
controller's poll cost and the wall.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shlex
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(_HERE)
sys.path.insert(0, REPO)
sys.path.insert(0, _HERE)
from torch_ckpt_validate import MANIFEST, valid_checkpoints  # noqa: E402  (the soaks' shared check)

EXIT_OK = 0
EXIT_PREEMPTED = 3  # a SIGTERM (or the watchdog's) stopped the run after a resumable save
GRACE_S = 30.0  # SIGTERM -> wait -> SIGKILL when stopping a child
CHILD_TIMEOUT_S = 300.0  # bound on each twin
SOAK_TIMEOUT_S = 480.0  # bound on the whole supervised fleet
# A change of topology at the same global batch re-associates float sums (about 1 ULP a
# step): the JAX soak's tolerance.
ELASTIC_TOL = 1e-4
SLOW_CHIP = "1:60"  # the straggler leg's degraded rank and its delay (ms) at every sync
RANK_THREADS = 2  # intra-op threads of each gloo rank

# Mesh axis -> the mesh grammar's token (parallel.mesh.mesh_config_from_spec).
_SPEC_TOKEN = {"data": "dp", "fsdp": "fsdp", "tensor": "tp"}


def _http_get_json(url: str, timeout: float = 5.0):
    """``(status, parsed body)`` of a GET: the offer's probe transport (stdlib only)."""
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read().decode() or "{}")


def _http_post_json(url: str, payload: dict, timeout: float = 30.0):
    """``(status, parsed body)`` of a JSON POST. 4xx/5xx are data here (a replica's typed
    refusal has a body the handshake reads); only a transport failure raises."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read().decode() or "{}")
    except urllib.error.HTTPError as e:
        body = e.read().decode()
        try:
            return e.code, json.loads(body or "{}")
        except ValueError:
            return e.code, {"raw": body}


def axes_to_spec(axes: dict) -> str:
    """A re-planned axes dict in the mesh grammar the child parses
    (``{"data": 2, "fsdp": 2}`` -> ``"dp2fsdp2"``)."""
    parts = [f"{_SPEC_TOKEN[k]}{int(v)}" for k, v in axes.items() if k in _SPEC_TOKEN and int(v) > 1]
    if not parts:
        return f"dp{int(axes.get('data', 1) or 1)}"
    return "".join(parts)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# The soak's child: the training job (imports torch; a subprocess).


def launch_ranks(args) -> int:
    """``--devices N`` (N > 1): start N ranks of this child on ``tcp://localhost:
    $MASTER_PORT`` (a free port when unset), wait for them, and return 0 when all finished,
    3 when they stopped on a preemption, else the first other code. A SIGTERM to the
    process group reaches the ranks themselves, so this launcher lets it pass; a rank
    that dies takes the others with it after a grace."""
    port = int(os.environ.get("MASTER_PORT") or free_port())
    env = dict(os.environ, OMP_NUM_THREADS=str(RANK_THREADS), PYTHONUNBUFFERED="1")
    if args.device == "cpu":
        env["CUDA_VISIBLE_DEVICES"] = ""
    argv = [a for a in sys.argv[1:]]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), *argv, "--rank", str(r),
                               "--init", f"tcp://localhost:{port}"], env=env)
             for r in range(args.devices)]
    signal.signal(signal.SIGTERM, lambda *_: None)
    died_at = None
    while True:
        codes = [p.poll() for p in procs]
        if all(c is not None for c in codes):
            break
        if died_at is None and any(c not in (None, 0, EXIT_PREEMPTED) for c in codes):
            died_at = time.monotonic()
        if died_at is not None and time.monotonic() - died_at > 10.0:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        time.sleep(0.1)
    if all(c == 0 for c in codes):
        return EXIT_OK
    if all(c in (0, EXIT_PREEMPTED) for c in codes):
        return EXIT_PREEMPTED
    return next(c for c in codes if c not in (0, EXIT_PREEMPTED))


def child_main(args) -> int:
    if args.devices > 1 and args.rank is None:
        return launch_ranks(args)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # cuBLAS's deterministic workspaces
    import numpy as np
    import torch

    from distributed_training_pytorch_tpu_torch.data import ArrayDataSource
    from distributed_training_pytorch_tpu_torch.examples.digits_data import load_digits
    from distributed_training_pytorch_tpu_torch.fault import FaultPlan
    from distributed_training_pytorch_tpu_torch.ops.losses import cross_entropy_loss
    from distributed_training_pytorch_tpu_torch.parallel import mesh as mesh_lib
    from distributed_training_pytorch_tpu_torch.telemetry import Telemetry
    from distributed_training_pytorch_tpu_torch.trainer import Trainer

    # As the chaos soak's children: no atomics reorder a sum, so a resume is bit-exact.
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True)
    if args.device == "cpu":
        # A few intra-op threads a process: OpenMP teams as wide as the machine, one per
        # child and rank, would thrash the cores the children share.
        torch.set_num_threads(RANK_THREADS)
    if args.rank is not None:
        mesh_lib.setup_distributed(args.init, world_size=args.devices, rank=args.rank,
                                   backend="gloo" if args.device == "cpu" else "nccl")

    class BatchArraySource(ArrayDataSource):
        """``load_batch``: a whole batch in one worker call, so the loader's fast path pays
        ``load_delay_s`` inside the pool, where the prefetch depth governs how many batches
        are produced at once (the per-record path pays it on the consumer)."""

        def load_batch(self, rows, epoch):
            return {k: v[rows] for k, v in self.arrays.items()}

    load_delay_s = float(args.load_delay)

    class FleetTrainer(Trainer):
        def build_train_dataset(self):
            images, targets = load_digits()
            images = (images / 16.0).astype(np.float32)[..., None]
            labels = targets.astype(np.int64)
            # Tiled so that each epoch is long enough for the faults to land mid-epoch and
            # for the per-epoch save to stay a small steady fraction (~14 * tile steps).
            return BatchArraySource(image=np.concatenate([images] * args.tile),
                                    label=np.concatenate([labels] * args.tile))

        def build_model(self):
            # The JAX child's width, chosen so that a deeper prefetch can cure the
            # starvation where the step lies between the batch's parallel and serial
            # production times.
            return torch.nn.Sequential(torch.nn.Flatten(), torch.nn.Linear(64, 2048), torch.nn.ReLU(),
                                       torch.nn.Linear(2048, 10))

        def build_criterion(self):
            def criterion(logits, batch):
                loss = cross_entropy_loss(logits, batch["label"])
                return loss, {"loss": loss}

            return criterion

        def build_optimizer(self, schedule):
            return torch.optim.SGD(self.model.parameters(), lr=0.1, momentum=0.9)

        def build_scheduler(self):
            return 0.1

        def build_dataloader(self, dataset, phase="train"):
            loader = super().build_dataloader(dataset, phase)
            loader.load_delay_s = load_delay_s  # the data-starvation seam
            return loader

    # The fault plan from argv: a restart rebuilds it, so the hang is pinned to one
    # (epoch, step), and the watchdog's save lands past it.
    plan = FaultPlan()
    if args.hang_payload > 0:
        plan.add("hang", epoch=args.hang_epoch, step=args.hang_step, payload=args.hang_payload)
    if args.slow_chip:
        dev, _, ms = args.slow_chip.partition(":")
        plan.add("slow_chip", count=args.slow_chip_count, payload={"device": int(dev), "delay_ms": float(ms or 0.0)})

    mesh = mesh_lib.mesh_config_from_spec(args.mesh).build() if args.mesh else None
    sharded = mesh is not None and mesh.sharded
    trainer = FleetTrainer(
        max_epoch=args.max_epoch,
        batch_size=128,
        save_folder=args.run_dir,
        snapshot_path="latest_valid",  # a cold start on the first attempt
        have_validate=False,
        save_period=1,
        async_checkpoint=True,
        chain_steps=2,
        log_every=4,
        preemption_check_every=2,
        # One disease a leg: no anomaly detector. The health stats are off on a sharded
        # state, where the port does not compute them (ROADMAP.md Queue 1 item 6).
        telemetry=Telemetry(anomaly=None, heartbeat_every_s=args.heartbeat_every, stats=not sharded),
        num_workers=args.num_workers,
        prefetch_batches=args.prefetch,
        step_timeout=args.step_timeout or None,
        fault_plan=plan if plan.events else None,
        seed=args.seed,
        mesh=mesh,
        accum_steps=args.accum,
        fsdp_min_size=256,  # the MLP's weights are small: shard them, so checkpoints carry a record
        device=args.device,
    )
    if args.commit_delay > 0:
        trainer.saver.commit_delay_s = args.commit_delay  # the checkpoint-stall seam
    trainer.train()
    if trainer.preempted:
        return EXIT_PREEMPTED
    params = trainer.state.params  # collective under a layout: every rank takes it
    if args.final and trainer.rank == 0:
        np.savez(args.final, **{k: v.detach().float().cpu().numpy() for k, v in sorted(params.items())})
    mesh_lib.shutdown_distributed()
    return EXIT_OK


# ---------------------------------------------------------------------------
# The parent: the supervising controller (the mechanism around telemetry.controller).


@dataclasses.dataclass
class RunSpec:
    """One supervised run: where it lives and how to (re)spawn it.

    ``cmd`` set: generic mode (a fixed argv; with ``adopt`` and no ``cmd``, record only).
    Unset: the soak's digits child, rebuilt from the mutable topology and knob fields at
    every spawn, so tunes and exclusions carry into the next attempt. ``kind="serve"`` is a
    serving replica; its ``port`` (the admin surface) turns the chip offer from an advisory
    record into the actuated handshake."""

    name: str
    run_dir: str
    kind: str = "train"  # "train" | "serve"
    port: int = 0
    cmd: "list | None" = None
    adopt: bool = False  # no spawn: supervise whatever writes the log
    final: str = ""
    max_epoch: int = 4
    devices: int = 0  # >1: that many gloo or NCCL ranks (one device each)
    device_ids: tuple = ()
    mesh: str = ""
    accum: int = 1
    tile: int = 3  # the dataset's tiling (the epoch's length)
    batch_size: int = 128
    device: str = "cuda"
    knobs: dict = dataclasses.field(default_factory=dict)
    extra: tuple = ()  # the child's further argv (the injection seams)

    def child_cmd(self) -> list:
        if self.cmd is not None:
            return list(self.cmd)
        return [
            sys.executable, os.path.abspath(__file__), "--child",
            "--run-dir", self.run_dir,
            "--final", self.final,
            "--max-epoch", str(self.max_epoch),
            "--devices", str(self.devices),
            "--mesh", self.mesh,
            "--accum", str(self.accum),
            "--tile", str(self.tile),
            "--device", self.device,
            "--prefetch", str(self.knobs.get("prefetch_batches", 2)),
            "--commit-delay", str(self.knobs.get("commit_delay_s", 0.0)),
            *self.extra,
        ]


class SupervisedRun:
    """A spec and its live supervision state (monitor, policy, process)."""

    def __init__(self, spec: RunSpec, monitor, policy, log_path: str):
        self.spec = spec
        self.monitor = monitor
        self.policy = policy
        self.log_path = log_path
        self.proc: "subprocess.Popen | None" = None
        self.last_status = None
        self.actions: list = []  # every executed Action, in order


def _popen_group(cmd, log_path: str) -> subprocess.Popen:
    """A child in a session (and process group) of its own, with a fresh ``MASTER_PORT``
    for its ranks' rendezvous."""
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(free_port()), PYTHONUNBUFFERED="1")
    with open(log_path, "a") as log:
        return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env=env, start_new_session=True)


def _kill_group(proc: subprocess.Popen, sig: int) -> None:
    try:
        os.killpg(proc.pid, sig)
    except ProcessLookupError:
        pass


class FleetController:
    """Supervise runs: poll -> decide -> execute -> audit (the module docstring).
    ``event_log`` is the controller's own ``EventLog``: the children write their runs' logs,
    and two writers on one JSONL file would interleave."""

    def __init__(self, specs, *, config, monitor_config, event_log, interval: float = 2.0, steady_diff=None,
                 clock=time.monotonic):
        from distributed_training_pytorch_tpu_torch.telemetry import monitor as monitor_lib
        from distributed_training_pytorch_tpu_torch.telemetry.controller import RunPolicy

        self.config = config
        self.events = event_log
        self.interval = float(interval)
        self._clock = clock
        # The offer's seams, attributes so that a test drives the handshake without
        # sockets or sleeps.
        self._steady_diff = steady_diff
        self._sleep = time.sleep
        self._http_get = _http_get_json
        self._http_post = _http_post_json
        self.poll_s: "list[float]" = []  # each sweep's monitor polls and decisions, without the actions
        self.runs: "dict[str, SupervisedRun]" = {}
        for spec in specs:
            mon = monitor_lib.RunMonitor(spec.run_dir, monitor_config, alert_log=event_log)
            pol = RunPolicy(config, knobs=dict(spec.knobs), steady_diff=steady_diff)
            log_path = os.path.join(os.path.dirname(spec.run_dir) or ".", f"{spec.name}.log")
            self.runs[spec.name] = SupervisedRun(spec, mon, pol, log_path)

    # -- process plumbing --------------------------------------------------

    def _spawn(self, run: SupervisedRun) -> None:
        run.proc = _popen_group(run.spec.child_cmd(), run.log_path)

    def _stop(self, run: SupervisedRun, *, graceful: bool) -> None:
        """End the child's whole process group: a SIGTERM first when ``graceful`` (the
        preemption save, so a tune or an exclusion loses no epoch), a SIGKILL after
        ``GRACE_S`` or at once."""
        proc = run.proc
        if proc is None or proc.poll() is not None:
            return
        if graceful:
            _kill_group(proc, signal.SIGTERM)
            try:
                proc.wait(timeout=GRACE_S)
            except subprocess.TimeoutExpired:
                pass
        _kill_group(proc, signal.SIGKILL)  # whatever of the group is left
        proc.wait()

    def start(self) -> None:
        for run in self.runs.values():
            if not run.spec.adopt:
                self._spawn(run)

    # -- action execution --------------------------------------------------

    def _execute(self, run: SupervisedRun, action, status, now: float) -> None:
        spec = run.spec
        can_spawn = spec.cmd is not None or not spec.adopt
        if action.kind == "restart" and can_spawn:
            self._stop(run, graceful=False)
            # What will the resume find? The stdlib manifest check, on the record.
            action.params["valid_checkpoints"] = valid_checkpoints(os.path.join(spec.run_dir, "weights"))
            self._spawn(run)
        elif action.kind == "restart_excluding" and can_spawn:
            self._replan_spec(spec, action)
            self._stop(run, graceful=True)
            self._spawn(run)
            self._offer_freed_chip(run, action, status)
        elif action.kind in ("tune", "revert") and can_spawn:
            spec.knobs[action.params["knob"]] = action.params["to"]
            self._stop(run, graceful=True)
            self._spawn(run)
        elif action.kind in ("keep", "give_up", "refuse"):
            pass  # the record says it all
        else:
            action.message += " [adopted run: recorded, not executed]"
        run.policy.note_applied(action, now=self._clock())
        run.actions.append(action)
        self.events.emit("controller_action", run=spec.name, run_dir=spec.run_dir, attempt=status.attempt,
                         status=status.status, verdict=status.verdict, restarts_used=run.policy.restarts_used,
                         max_restarts=self.config.max_restarts, **action.event_fields())

    def _emit_serve_action(self, srv: SupervisedRun, act) -> None:
        """One serving-side action of the handshake, appended to the replica's ledger and
        recorded; not through the replica's policy, since an offer never respawns the
        server (no budget consumed, no backoff)."""
        srv.actions.append(act)
        st = srv.last_status
        self.events.emit("controller_action", run=srv.spec.name, run_dir=srv.spec.run_dir,
                         attempt=st.attempt if st is not None else None,
                         status=st.status if st is not None else "unknown",
                         verdict=st.verdict if st is not None else "unknown",
                         restarts_used=srv.policy.restarts_used, max_restarts=self.config.max_restarts,
                         **act.event_fields())

    def _offer_freed_chip(self, run: SupervisedRun, action, status) -> None:
        """Offer the chip a trainer's ``restart_excluding`` dropped to each serving replica
        of the fleet: the actuated handshake for a replica with an admin ``port``, an
        advisory record for one without. A chip too slow for a lockstep collective may
        serve latency-bound requests well."""
        from distributed_training_pytorch_tpu_torch.telemetry.controller import Action

        chip = action.params.get("exclude_chip")
        if chip is None:
            return
        for srv in [r for r in self.runs.values() if r.spec.kind == "serve" and r.spec.name != run.spec.name]:
            if srv.spec.port:
                self._actuate_offer(run, srv, int(chip), action)
                continue
            self._emit_serve_action(srv, Action(
                kind="offer_chip", reason=action.reason,
                message=(f"chip {chip} freed from {run.spec.name}'s mesh by restart_excluding; offered to serving "
                         f"replica {srv.spec.name}"),
                params={"chip": int(chip), "from_run": run.spec.name, "to_run": srv.spec.name},
                evidence=list(action.evidence)))

    def _replan_back(self, base: str, old_ids: list) -> bool:
        """Best-effort restore of the device set before the offer (the revert's physical
        half). A replica checks a re-plan before it stops admission, so one that cannot be
        reached is dead (its monitor says so) or still serves a valid plan."""
        try:
            code, _ = self._http_post(base + "/admin/replan", {"device_ids": list(old_ids), "deadline_s": 10.0},
                                      timeout=60.0)
            return code == 200
        except Exception:  # noqa: BLE001 — tolerated by design (see above)
            return False

    def _actuate_offer(self, run: SupervisedRun, srv: SupervisedRun, chip: int, action) -> None:
        """One actuated offer, end to end, around ``OfferHandshake``: every ending leaves a
        record on the serving run, ``offer_chip`` then ``keep`` (absorbed and judged no
        worse) or ``revert`` (judged against, refused by the replica, or timed out; the
        last two re-armed). The replica's own log has the matching ``offer_accept`` /
        ``offer_decline`` / ``drain_start`` / ``replan_done`` records."""
        from distributed_training_pytorch_tpu_torch.telemetry.controller import Action, OfferHandshake

        base = f"http://127.0.0.1:{srv.spec.port}"
        cfg = self.config
        try:
            _, before = self._http_get(base + "/status", timeout=5.0)
        except Exception as e:  # noqa: BLE001 — the probe's failure is evidence
            before = {"probe_error": f"{type(e).__name__}: {e}"}
        hs = OfferHandshake(chip, before=before, now=self._clock(), timeout_s=float(cfg.offer_timeout_s),
                            settle_s=float(cfg.offer_settle_s))
        self._emit_serve_action(srv, Action(
            kind="offer_chip", reason=action.reason,
            message=(f"chip {chip} freed from {run.spec.name}'s mesh by restart_excluding; offered to serving "
                     f"replica {srv.spec.name} for actuation"),
            params={"chip": int(chip), "from_run": run.spec.name, "to_run": srv.spec.name,
                    "port": int(srv.spec.port), "actuated": True},
            evidence=list(action.evidence)))

        def fail(reason: str, detail: str, *, rearm: bool = True, evidence=()) -> None:
            self._emit_serve_action(srv, Action(
                kind="revert", reason=reason,
                message=f"offer of chip {chip} to {srv.spec.name}: {detail}" + (" — re-armed" if rearm else ""),
                params={"chip": int(chip), "to_run": srv.spec.name, "rearmed": bool(rearm),
                        "handshake_state": hs.state},
                evidence=list(evidence)))

        # 1) offer -> the replica's accept or decline (its own SLO call)
        try:
            code, body = self._http_post(base + "/admin/offer", {"chip": int(chip)}, timeout=10.0)
        except Exception as e:  # noqa: BLE001
            fail("offer_timeout", f"offer transport failed ({type(e).__name__}: {e})")
            return
        if code != 200 or body.get("decision") not in ("accept", "decline"):
            fail("offer_timeout", f"offer answered {code}: {body}")
            return
        hs.note_decision(body["decision"], body.get("reason", ""))
        if hs.state == "declined":
            return  # the replica's offer_decline record holds its evidence; nothing was actuated
        # 2) actuate: drain and re-plan onto the grown device set
        old_ids = sorted(int(d) for d in (before.get("device_ids") or []))
        if not old_ids:
            fail("replan_failed", "replica reported no device_ids to grow from")
            return
        new_ids = sorted(set(old_ids) | {int(chip)})
        wall_left = max(1.0, hs.deadline - self._clock())
        try:
            code, summary = self._http_post(base + "/admin/replan",
                                            {"device_ids": new_ids, "deadline_s": min(10.0, wall_left)},
                                            timeout=wall_left)
        except Exception as e:  # noqa: BLE001 — the replica may or may not have re-planned
            self._replan_back(base, old_ids)
            fail("offer_timeout", f"replan transport failed ({type(e).__name__}: {e})")
            return
        if code != 200:
            # The replica checks before it stops admission: it serves the old plan.
            fail("replan_failed", f"replica refused the re-plan ({code}: {summary})",
                 evidence=[{"metric": "replan_status", "value": code, "detail": summary}])
            return
        hs.note_actuated(summary, now=self._clock())
        # 3) settle, then judge on the after-side probe
        while not hs.ready_to_judge(self._clock()):
            if hs.expired(self._clock()):
                self._replan_back(base, old_ids)
                fail("offer_timeout", hs.reason)
                return
            self._sleep(0.05)
        try:
            _, after = self._http_get(base + "/status", timeout=5.0)
        except Exception as e:  # noqa: BLE001
            self._replan_back(base, old_ids)
            fail("offer_timeout", f"after-probe failed ({type(e).__name__}: {e})")
            return
        verdict, evidence = hs.judge(after, noise_floor=float(cfg.ab_noise_floor), steady_diff=self._steady_diff)
        if verdict == "keep":
            self._emit_serve_action(srv, Action(
                kind="keep", reason="offer_chip",
                message=f"chip {chip} absorbed by {srv.spec.name} and kept: {hs.reason}",
                params={"chip": int(chip), "to_run": srv.spec.name, "device_ids": new_ids}, evidence=evidence))
            return
        self._replan_back(base, old_ids)
        fail("offer_chip", f"A/B judged against the absorb: {hs.reason}", rearm=False, evidence=evidence)

    def _replan_spec(self, spec: RunSpec, action) -> None:
        """Fold the exclusion into the spawn spec through the elastic planner: the
        controller invents no topology."""
        from distributed_training_pytorch_tpu_torch.parallel import elastic
        from distributed_training_pytorch_tpu_torch.parallel.mesh import mesh_config_from_spec

        chip = int(action.params["exclude_chip"])
        if not spec.device_ids:
            action.message += " [no known topology: plain restart]"
            return
        axes = {"data": len(spec.device_ids)}
        if spec.mesh:
            mc = mesh_config_from_spec(spec.mesh)
            axes = {"data": max(1, int(mc.data)),
                    **{name: int(getattr(mc, name)) for name in ("fsdp", "pipe", "expert", "seq", "tensor")
                       if int(getattr(mc, name)) != 1}}
        plan = elastic.replan_excluding(axes, spec.device_ids, [chip], batch_size=spec.batch_size,
                                        accum_steps=spec.accum)
        survivors = tuple(d for d in spec.device_ids if int(d) != chip)
        spec.device_ids = survivors
        spec.devices = len(survivors)
        spec.mesh = axes_to_spec(plan.new_axes)
        spec.accum = int(plan.accum_steps)
        action.params.update(new_axes=dict(plan.new_axes), accum_steps=int(plan.accum_steps), devices=spec.devices,
                             plan_reason=plan.reason)

    # -- the loop ----------------------------------------------------------

    def poll_once(self) -> None:
        now = self._clock()
        decided = []
        t0 = time.perf_counter()
        for run in self.runs.values():
            status = run.monitor.poll()
            run.last_status = status
            rc = run.proc.poll() if run.proc is not None else None
            proc_running = run.proc is not None and rc is None
            action = run.policy.decide(status, proc_running=proc_running, exit_code=rc, now=now)
            if action is not None:
                decided.append((run, action, status))
        self.poll_s.append(time.perf_counter() - t0)
        for run, action, status in decided:
            self._execute(run, action, status, now)

    def _terminal(self, run: SupervisedRun) -> bool:
        rc = run.proc.poll() if run.proc is not None else None
        if run.proc is not None and rc is None:
            return False  # still running
        if run.policy.gave_up:
            return True  # surfaced to a human: nothing more will happen
        st = run.last_status
        return rc == 0 and st is not None and st.status == "finished"

    def run_loop(self, *, timeout: float, hook=None, wait_for=None) -> bool:
        """Poll until the runs named in ``wait_for`` (default: all) are terminal, or
        ``timeout``; ``hook`` (the soak's chaos hand) is called once a sweep with the
        controller. True when they went terminal in time."""
        names = list(self.runs) if wait_for is None else list(wait_for)
        deadline = self._clock() + timeout
        while True:
            self.poll_once()
            if hook is not None:
                hook(self)
            if all(self._terminal(self.runs[n]) for n in names):
                return True
            if self._clock() >= deadline:
                return False
            time.sleep(self.interval)

    def shutdown(self) -> None:
        for run in self.runs.values():
            self._stop(run, graceful=False)

    def summary(self) -> dict:
        out = {}
        for name, run in self.runs.items():
            st = run.last_status
            rc = run.proc.poll() if run.proc is not None else None
            out[name] = {
                "status": st.status if st else "unknown",
                "verdict": st.verdict if st else "unknown",
                "attempt": st.attempt if st else None,
                "exit_code": rc,
                "gave_up": run.policy.gave_up,
                "restarts_used": run.policy.restarts_used,
                "actions": [a.kind for a in run.actions],
                "ok": rc == 0 and st is not None and st.status == "finished" and not run.policy.gave_up,
            }
        return out

    def poll_cost(self) -> dict:
        """The sweeps' wall (monitor polls and decisions, actions excluded), in ms."""
        ms = sorted(s * 1e3 for s in self.poll_s)
        if not ms:
            return {"sweeps": 0}
        return {"sweeps": len(ms), "median_ms": statistics.median(ms), "max_ms": ms[-1],
                "runs": len(self.runs)}


# ---------------------------------------------------------------------------
# Reading the runs' logs after the fact.


def _events(run_dir: str) -> "list[dict]":
    from distributed_training_pytorch_tpu_torch.telemetry.events import load_run_events

    try:
        return load_run_events(run_dir)
    except FileNotFoundError:
        return []


def recovery(run_dir: str, t_fault: "float | None") -> dict:
    """Seconds from ``t_fault`` (wall clock) to the next attempt's ``run_start`` and to
    its first ``window`` record (its first ``log_every`` sync), with that window's steps
    and step time."""
    if t_fault is None:
        return {}
    recs = _events(run_dir)
    start = next((i for i, r in enumerate(recs) if r.get("event") == "run_start" and r["t_wall"] > t_fault), None)
    if start is None:
        return {}
    out = {"to_run_start_s": recs[start]["t_wall"] - t_fault, "attempt": recs[start].get("attempt")}
    win = next((r for r in recs[start:] if r.get("event") == "window"), None)
    if win is not None:
        out.update(to_first_window_s=win["t_wall"] - t_fault, window_steps=win.get("steps"),
                   window_step_ms=win.get("step_ms"))
    return out


def _first_event(run_dir: str, event: str, **match) -> "dict | None":
    return next((r for r in _events(run_dir) if r.get("event") == event
                 and all(r.get(k) == v for k, v in match.items())), None)


def _compare_finals(name: str, a_path: str, b_path: str, failures: list) -> dict:
    import numpy as np

    if not (os.path.exists(a_path) and os.path.exists(b_path)):
        failures.append(f"{name}: missing final params ({a_path} / {b_path})")
        return {}
    a, b = np.load(a_path), np.load(b_path)
    if sorted(a.files) != sorted(b.files):
        failures.append(f"{name}: final params name different tensors ({sorted(a.files)} / {sorted(b.files)})")
        return {}
    worst = max(float(np.max(np.abs(a[k] - b[k]))) for k in a.files)
    bit_equal = all(np.array_equal(a[k], b[k]) for k in a.files)
    print(f"  {name}: final params vs uninterrupted twin: max|d| = {worst:.2e} (tolerance {ELASTIC_TOL}), "
          f"bit-equal {bit_equal}")
    if not (worst <= ELASTIC_TOL):
        failures.append(f"{name}: final params diverged from the twin (max|d| {worst:.2e} > {ELASTIC_TOL})")
    return {"max_abs_diff": worst, "bit_equal": bit_equal}


# ---------------------------------------------------------------------------
# The soak: three diseased runs and their uninterrupted twins.


def run_soak(args) -> int:
    import torch_run_compare

    from distributed_training_pytorch_tpu_torch.telemetry import monitor as monitor_lib
    from distributed_training_pytorch_tpu_torch.telemetry.controller import ControllerConfig
    from distributed_training_pytorch_tpu_torch.telemetry.events import EventLog, peek_attempt, read_events

    t_soak = time.perf_counter()
    workdir = args.workdir or tempfile.mkdtemp(prefix="torch_fleet_soak_", dir=os.path.join(REPO, "build"))
    os.makedirs(workdir, exist_ok=True)
    epochs = 5 if args.quick else 7
    tile = 8  # ~112 steps an epoch: the verdicts' fractions get honest denominators
    hb = ("--heartbeat-every", "0.5")
    zero_budget = args.max_restarts <= 0

    def spec(name, **kw):
        kw.setdefault("device", args.device)
        return RunSpec(name=name, run_dir=os.path.join(workdir, name), final=os.path.join(workdir, f"{name}_final.npz"),
                       **kw)

    # The straggler leg's two ranks are gloo ranks on the CPU: one card holds one rank.
    strag_device = "cpu" if args.device == "cuda" and _card_count() < 2 else args.device
    if zero_budget:
        # One SIGKILL'd run: a zero-budget controller must refuse, and this process exit
        # non-zero.
        specs = [spec("killed", max_epoch=3, tile=tile, extra=hb)]
    else:
        specs = [
            # SIGKILL'd and loader-starved: restart from latest_valid, then the bounded
            # prefetch tune, A/B-judged.
            spec("killed", max_epoch=epochs, tile=tile, knobs={"prefetch_batches": 1, "commit_delay_s": 0.0},
                 extra=("--load-delay", "0.02", "--num-workers", "8", *hb)),
            # Hung mid-epoch: the watchdog's SIGTERM and resumable save, exit 3; the
            # controller respawns past the pinned hang step.
            spec("hung", max_epoch=3, tile=tile,
                 extra=("--step-timeout", "2", "--hang-epoch", "1", "--hang-step", "4", "--hang-payload", "6", *hb)),
            # A degraded rank of an fsdp2 mesh: the straggler verdict names chip 1, the
            # controller re-plans onto the survivor (the slow-chip flag stays: the chip is
            # still bad, just out of the mesh).
            spec("straggler", max_epoch=3, tile=tile, devices=2, device_ids=(0, 1), mesh="fsdp2", device=strag_device,
                 extra=("--slow-chip", args.slow_chip or SLOW_CHIP, "--slow-chip-count", "1000", *hb)),
        ]
    trainers = [s.name for s in specs]
    if args.serve_port and not zero_budget:
        # A serving replica someone else runs: adopted, offered the freed chip.
        specs.append(RunSpec(name="replica", run_dir=args.serve_run_dir, kind="serve", port=args.serve_port,
                             adopt=True))

    controller_events = os.path.join(workdir, "controller", "events.jsonl")
    os.makedirs(os.path.dirname(controller_events), exist_ok=True)
    config = ControllerConfig(
        max_restarts=args.max_restarts, backoff_s=2.0, backoff_factor=2.0, confirm_polls=2,
        # The A/B waits for this much of the tuned attempt's steady wall: the first window
        # after warm-up has too small a denominator to decide a revert.
        ab_min_steady_s=1.5)
    # High liveness ceilings: the exit code is the definitive death signal here; the
    # log-silence rules are for adopted runs and must not read a slow start as a death.
    monitor_config = monitor_lib.AlertConfig(stale_after_s=60.0, dead_after_s=180.0, min_steady_s=1.0)
    fleet = FleetController(specs, config=config, monitor_config=monitor_config,
                            event_log=EventLog(controller_events, process_index=0), interval=0.3,
                            steady_diff=torch_run_compare.steady_diff)

    # Twins: the same global batch, epochs, seed and starting topology, no injection.
    twins, twin_procs = {}, {}
    if not zero_budget:
        twins = {
            "killed": spec("killed_twin", max_epoch=epochs, tile=tile),
            "hung": spec("hung_twin", max_epoch=3, tile=tile),
            "straggler": spec("straggler_twin", max_epoch=3, tile=tile, devices=2, mesh="fsdp2", device=strag_device),
        }
        twin_procs = {name: _popen_group(t.child_cmd(), os.path.join(workdir, f"{t.name}.log"))
                      for name, t in twins.items()}

    # The chaos hand: one SIGKILL on "killed", once a valid checkpoint exists (a SIGKILL
    # must find something restorable on disk).
    state = {"killed": False, "kill_t": None}

    def chaos_hook(ctl: FleetController) -> None:
        if state["killed"]:
            return
        run = ctl.runs["killed"]
        if run.proc is None or run.proc.poll() is not None:
            return
        survivors = valid_checkpoints(os.path.join(run.spec.run_dir, "weights"))
        if survivors:
            print(f"  chaos: SIGKILL killed/ with {len(survivors)} valid checkpoint(s) on disk", flush=True)
            state["kill_t"] = time.time()
            _kill_group(run.proc, signal.SIGKILL)
            state["killed"] = True

    print(f"fleet soak: workdir {workdir} (max_restarts={args.max_restarts}, device {args.device}, straggler leg on "
          f"{strag_device})", flush=True)
    fleet.start()
    try:
        converged = fleet.run_loop(timeout=SOAK_TIMEOUT_S, hook=chaos_hook, wait_for=trainers)
    finally:
        fleet.shutdown()
    summary = fleet.summary()
    for name, row in summary.items():
        print(f"  {name}: {row['status']}/{row['verdict']} exit={row['exit_code']} attempt={row['attempt']} "
              f"restarts={row['restarts_used']} actions={row['actions']}{' GAVE UP' if row['gave_up'] else ''}")
    actions = [r for r in read_events(controller_events) if r.get("event") == "controller_action"]
    result = {"workdir": workdir, "device": args.device, "straggler_device": strag_device,
              "max_restarts": args.max_restarts, "runs": summary, "poll": fleet.poll_cost(),
              "actions": [{k: a.get(k) for k in ("run", "action", "reason", "params", "evidence", "attempt",
                                                 "restarts_used", "max_restarts", "t_wall")} for a in actions]}

    if zero_budget:
        failures = []
        if not state["killed"]:
            failures.append("the SIGKILL was never delivered")
        if any(a["action"] in ("restart", "restart_excluding", "tune", "revert") for a in actions):
            failures.append("a zero-budget controller executed a respawn")
        if not any(a["action"] == "refuse" for a in actions):
            failures.append("no `refuse` controller_action was recorded")
        att = peek_attempt(specs[0].run_dir)
        if att != 1:
            failures.append(f"run respawned: attempt counter is {att}, not 1")
        result.update(refused=not failures, failures=failures, wall_s=time.perf_counter() - t_soak)
        for f in failures:
            print(f"FLEET SOAK BUG: {f}")
        if not failures:
            print("fleet soak (zero budget): the controller refused to act and the run stays dead: exiting non-zero "
                  "as designed")
            if not args.keep:
                shutil.rmtree(workdir, ignore_errors=True)
        print(json.dumps(result, default=str))
        return 2 if failures else 1

    failures: "list[str]" = []
    if not converged:
        failures.append(f"fleet did not converge within {SOAK_TIMEOUT_S:.0f}s")
    by_run = {name: [a for a in actions if a.get("run") == name] for name in summary}
    kinds_killed = [a["action"] for a in by_run.get("killed", ())]
    # The tune's outcome: kept, or reverted by the judge's numbers (then the disease's
    # recurrence may end in give_up, and the run finishes data-bound).
    outcome = "keep" if "keep" in kinds_killed else "revert" if "revert" in kinds_killed else None
    result["tune_outcome"] = outcome
    for name in trainers:
        row = summary[name]
        finished = row["exit_code"] == 0 and row["status"] == "finished"
        if name == "killed" and outcome == "revert":
            late = [a for a in by_run["killed"] if a["action"] == "give_up"]
            if not finished or any(a["reason"] != "data_bound" or a["params"].get("state") != "reverted"
                                   for a in late):
                failures.append(f"killed: not restored to completion after the revert ({row})")
        elif not row["ok"]:
            failures.append(f"{name}: not restored to completion ({row})")
        elif row["verdict"] != "healthy":
            failures.append(f"{name}: final verdict {row['verdict']}, not healthy")
    if "restart" not in kinds_killed:
        failures.append("killed: no `restart` action recorded")
    if "tune" not in kinds_killed or outcome is None:
        failures.append(f"killed: expected tune, then keep or revert, got {kinds_killed}")
    if not any(a["action"] == "restart" for a in by_run.get("hung", ())):
        failures.append("hung: no `restart` action recorded")
    strag_actions = [a for a in by_run.get("straggler", ()) if a["action"] == "restart_excluding"]
    if not strag_actions:
        failures.append("straggler: no `restart_excluding` action recorded")
    elif strag_actions[0]["params"].get("exclude_chip") != 1:
        failures.append(f"straggler: excluded chip {strag_actions[0]['params']} != 1")
    elif strag_actions[0]["params"].get("accum_steps") != 2:
        failures.append(f"straggler: the survivor's plan is not accum 2 ({strag_actions[0]['params']})")
    if "replica" in summary:
        offers = [a["action"] for a in by_run["replica"]]
        result["offer"] = by_run["replica"]
        if not offers or offers[0] != "offer_chip" or not ({"keep", "revert"} & set(offers[1:])):
            failures.append(f"replica: the freed chip's offer did not end in keep or revert ({offers})")
        if any(a in ("restart", "restart_excluding", "tune") for a in offers):
            failures.append(f"replica: the offer respawned the replica ({offers})")
    for a in actions:
        if not a.get("evidence"):
            failures.append(f"action without evidence: {a['action']} on {a['run']}")
        if a.get("max_restarts") != args.max_restarts:
            failures.append(f"action missing budget fields: {a}")
    # Attempt counters moved and never outran the respawns (a child killed in its start-up,
    # before train() claims an attempt, leaves a gap).
    for name in trainers:
        row = summary[name]
        att = peek_attempt(fleet.runs[name].spec.run_dir)
        lo = 2 if row["restarts_used"] else 1
        if not (lo <= att <= 1 + row["restarts_used"]):
            failures.append(f"{name}: attempt counter {att} outside [{lo}, 1 + {row['restarts_used']} respawns]")

    # Each leg's time to recover, from the fault to the next attempt's first window.
    rec = {"killed": recovery(fleet.runs["killed"].spec.run_dir, state["kill_t"])}
    hung = _first_event(fleet.runs["hung"].spec.run_dir, "hung_step")
    rec["hung"] = recovery(fleet.runs["hung"].spec.run_dir,
                           None if hung is None else hung["t_wall"] - float(hung.get("timeout_s") or 0.0))
    slow = _first_event(fleet.runs["straggler"].spec.run_dir, "fault_injection", kind="slow_chip")
    rec["straggler"] = recovery(fleet.runs["straggler"].spec.run_dir, None if slow is None else slow["t_wall"])
    if strag_actions and slow is not None:
        rec["straggler"]["detect_s"] = strag_actions[0]["t_wall"] - slow["t_wall"]
    result["recovery"] = rec
    result["tune"] = _tune_numbers(fleet.runs["killed"].spec.run_dir, by_run.get("killed", ()),
                                   twins["killed"].run_dir)

    # The final params against the uninterrupted twins.
    finals = {}
    for name, twin in twins.items():
        try:
            rc = twin_procs[name].wait(timeout=CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            _kill_group(twin_procs[name], signal.SIGKILL)
            rc = twin_procs[name].wait()
        if rc != 0:
            failures.append(f"{twin.name}: twin exited {rc}")
            continue
        finals[name] = _compare_finals(name, fleet.runs[name].spec.final, twin.final, failures)
    result["finals"] = finals
    result.update(failures=failures, ok=not failures, wall_s=time.perf_counter() - t_soak)
    for f in failures:
        print(f"FLEET SOAK BUG: {f}")
    if failures:
        print(f"fleet soak FAILED ({len(failures)} finding(s)); kept {workdir}")
        for log in sorted(os.listdir(workdir)):
            if log.endswith(".log"):
                with open(os.path.join(workdir, log), errors="replace") as f:
                    print(f"--- {log} (tail) ---\n{f.read()[-2500:]}")
    else:
        print(f"fleet soak OK: SIGKILL, hang, degraded rank and loader starvation across a {len(trainers)}-run fleet, "
              f"all remediated to completion; {len(actions)} controller_action record(s), each with its evidence; "
              "final params within tolerance of the uninterrupted twins")
        if not args.keep:
            shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps(result, default=str))
    return 1 if failures else 0


def _card_count() -> int:
    import torch

    return torch.cuda.device_count()


def _step_ms_by_attempt(run_dir: str) -> dict:
    attempts, cur = {}, None
    for r in _events(run_dir):
        if r.get("event") == "run_start":
            cur = r.get("attempt")
        elif r.get("event") == "window" and cur is not None and r.get("step_ms") is not None:
            attempts.setdefault(cur, []).append(float(r["step_ms"]))
    return {k: statistics.median(v) for k, v in attempts.items()}


def _tune_numbers(run_dir: str, actions, twin_dir: str) -> dict:
    """The killed leg's numbers around the tune: each attempt's median window wall a step
    (at prefetch 1 the loader's serial production of a batch paces it), the twin's (the
    step when nothing starves it), the tune and the judge's first evidence row."""
    judged = [a for a in actions if a["action"] in ("keep", "revert")]
    return {"step_ms_by_attempt": _step_ms_by_attempt(run_dir), "twin_step_ms": _step_ms_by_attempt(twin_dir),
            "tune": next((a["params"] for a in actions if a["action"] == "tune"), None),
            "judge": None if not judged else {"action": judged[0]["action"], "evidence": judged[0]["evidence"][:3]}}


# ---------------------------------------------------------------------------
# The LM entry under the controller.

_LM_WRAPPER = """
import atexit, json, os, runpy, torch
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
torch.use_deterministic_algorithms(True)
from distributed_training_pytorch_tpu_torch.ops import flash_attention as fa
def dump():
    path = os.path.join(os.environ["SAVE_DIR"], "launches.%d.json" % os.getpid())
    with open(path, "w") as f:
        json.dump(dict(("%s/%s" % k, n) for k, n in fa.launches_by_variant.items()), f)
atexit.register(dump)
runpy.run_module("distributed_training_pytorch_tpu_torch.examples.train_lm", run_name="__main__")
"""


def lm_settings(device: str) -> dict:
    """The LM leg's entry settings: GPT-2-small at T=256, batch 32, bf16 on the card; LMTiny
    at T=64 in f32 on a CPU."""
    card = device == "cuda"
    return {"LM_SIZE": "small" if card else "tiny", "SEQ_LEN": "256" if card else "64", "BATCH": "32",
            "EPOCHS": "2", "DTYPE": "bf16" if card else "fp32"}


def lm_command(save_dir: str, device: str) -> list:
    """The LM entry as a user runs it, with deterministic algorithms, and its kernels'
    launch counts written at exit (``SAVE_DIR/launches.<pid>.json``)."""
    env = {"SAVE_DIR": save_dir, **lm_settings(device), "TELEMETRY": "1", "SNAPSHOT": "latest_valid",
           "SAVE_PERIOD": "1", "LAST_SAVE_PERIOD": "1", "DEVICE": device, "CUBLAS_WORKSPACE_CONFIG": ":4096:8",
           "PYTHONPATH": REPO}
    return ["env", *(f"{k}={v}" for k, v in env.items()), sys.executable, "-c", _LM_WRAPPER]


def _committed_after_training(weights: str) -> bool:
    """Whether a checkpoint past the first epoch has committed (its manifest written; the
    entry's ``best`` of the untrained model, at the top of epoch 0, does not count)."""
    if not os.path.isdir(weights):
        return False
    for name in os.listdir(weights):
        path = os.path.join(weights, name)
        if name.startswith(".") or not os.path.isfile(os.path.join(path, MANIFEST)):
            continue
        try:
            with open(os.path.join(path, "meta.json"), encoding="utf-8") as f:
                if int(json.load(f).get("epoch", 0)) >= 1:
                    return True
        except (OSError, ValueError):
            continue
    return False


def run_lm(args) -> int:
    """The LM entry supervised through the ``--cmd`` mode's mechanism: SIGKILL'd once a
    checkpoint past its first epoch has committed, restarted by the controller (resuming
    from ``latest_valid``), run to its end; an uninterrupted twin beside it; their final
    ``last`` params compared."""
    import torch

    import torch_run_compare

    from distributed_training_pytorch_tpu_torch.telemetry import monitor as monitor_lib
    from distributed_training_pytorch_tpu_torch.telemetry.controller import ControllerConfig
    from distributed_training_pytorch_tpu_torch.telemetry.events import EventLog, read_events

    t0 = time.perf_counter()
    workdir = args.workdir or tempfile.mkdtemp(prefix="torch_fleet_lm_", dir=os.path.join(REPO, "build"))
    os.makedirs(workdir, exist_ok=True)
    run_dir, twin_dir = os.path.join(workdir, "lm"), os.path.join(workdir, "lm_twin")
    events = os.path.join(workdir, "controller", "events.jsonl")
    fleet = FleetController([RunSpec(name="lm", run_dir=run_dir, cmd=lm_command(run_dir, args.device))],
                            config=ControllerConfig(max_restarts=args.max_restarts),
                            monitor_config=monitor_lib.AlertConfig(stale_after_s=120.0, dead_after_s=360.0),
                            event_log=EventLog(events, process_index=0), interval=0.3,
                            steady_diff=torch_run_compare.steady_diff)
    state = {"kill_t": None}

    def chaos_hook(ctl: FleetController) -> None:
        run = ctl.runs["lm"]
        if state["kill_t"] is None and run.proc is not None and run.proc.poll() is None \
                and _committed_after_training(os.path.join(run_dir, "weights")):
            state["kill_t"] = time.time()
            _kill_group(run.proc, signal.SIGKILL)
            print("  chaos: SIGKILL lm/ once a checkpoint past its first epoch has committed", flush=True)

    twin = _popen_group(lm_command(twin_dir, args.device), os.path.join(workdir, "lm_twin.log"))
    fleet.start()
    try:
        converged = fleet.run_loop(timeout=args.timeout, hook=chaos_hook)
    finally:
        fleet.shutdown()
    try:
        twin_rc = twin.wait(timeout=args.timeout)
    except subprocess.TimeoutExpired:
        _kill_group(twin, signal.SIGKILL)
        twin_rc = twin.wait()
    summary = fleet.summary()["lm"]
    actions = [r for r in read_events(events) if r.get("event") == "controller_action"]
    failures = []
    if not converged or not summary["ok"]:
        failures.append(f"lm: not restored to completion ({summary})")
    if state["kill_t"] is None:
        failures.append("lm: the SIGKILL was never delivered")
    restarts = [a for a in actions if a["action"] == "restart"]
    if len(restarts) != 1 or not restarts[0]["params"].get("valid_checkpoints"):
        failures.append(f"lm: expected one restart onto a valid checkpoint, got {[a['action'] for a in actions]}")
    if twin_rc != 0:
        failures.append(f"lm twin exited {twin_rc}")
    finals = {}
    paths = [os.path.join(d, "weights", "last", "state.pt") for d in (run_dir, twin_dir)]
    if all(os.path.exists(p) for p in paths):
        a, b = (torch.load(p, map_location="cpu", weights_only=True)["params"] for p in paths)
        worst = max(float((a[k].float() - b[k].float()).abs().max()) for k in a)
        finals = {"max_abs_diff": worst, "bit_equal": all(torch.equal(a[k], b[k]) for k in a),
                  "tensors": len(a)}
        if sorted(a) != sorted(b) or not worst <= ELASTIC_TOL:
            failures.append(f"lm: final params vs the twin's: max|d| {worst:.3e} > {ELASTIC_TOL}")
    else:
        failures.append(f"lm: missing final params {paths}")
    launches = {}
    for tag, d in (("resumed", run_dir), ("twin", twin_dir)):
        dumps = sorted(n for n in os.listdir(d) if n.startswith("launches.")) if os.path.isdir(d) else []
        if len(dumps) != 1:
            failures.append(f"lm {tag}: expected one launch-count dump, found {dumps}")
            continue
        with open(os.path.join(d, dumps[0])) as f:
            launches[tag] = json.load(f)
        got = launches[tag]
        if args.device == "cuda" and (not got["fwd/wgmma"] or not got["bwd_dq/wgmma"]
                                      or got["bwd_dq/wgmma"] != got["bwd_dkv/wgmma"]
                                      or any(got[f"{k}/cuda_core"] for k in ("fwd", "bwd_dq", "bwd_dkv"))):
            failures.append(f"lm {tag}: K1-K3 not all launched on the wgmma variant ({got})")
    restart_t = restarts[0]["t_wall"] if restarts else None
    result = {"workdir": workdir, "device": args.device, "run": summary, "twin_exit": twin_rc, "finals": finals,
              "launches": launches, "actions": [{k: a.get(k) for k in ("action", "reason", "params", "evidence")}
                                                for a in actions],
              "recovery": {"from_kill": recovery(run_dir, state["kill_t"]),
                           "from_restart": recovery(run_dir, restart_t)},
              "poll": fleet.poll_cost(), "lm": lm_settings(args.device),
              "failures": failures, "ok": not failures, "wall_s": time.perf_counter() - t0}
    for f in failures:
        print(f"FLEET LM BUG: {f}")
    if failures:
        for log in ("lm.log", "lm_twin.log"):
            path = os.path.join(workdir, log)
            if os.path.exists(path):
                with open(path, errors="replace") as f:
                    print(f"--- {log} (tail) ---\n{f.read()[-3000:]}")
    elif not args.keep:
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps(result, default=str))
    return 1 if failures else 0


# ---------------------------------------------------------------------------
# Generic supervision.


def run_fleet(args) -> int:
    import torch_run_compare

    from distributed_training_pytorch_tpu_torch.telemetry import monitor as monitor_lib
    from distributed_training_pytorch_tpu_torch.telemetry.controller import ControllerConfig
    from distributed_training_pytorch_tpu_torch.telemetry.events import EventLog

    specs = []
    for d in args.run_dirs:
        name = os.path.basename(os.path.normpath(d)) or d
        cmd = shlex.split(args.cmd.format(run_dir=d)) if args.cmd else None
        specs.append(RunSpec(name=name, run_dir=d, cmd=cmd, adopt=cmd is None))
    fleet = FleetController(specs, config=ControllerConfig(max_restarts=args.max_restarts),
                            monitor_config=monitor_lib.AlertConfig(), event_log=EventLog(args.events, process_index=0),
                            interval=args.interval, steady_diff=torch_run_compare.steady_diff)
    fleet.start()
    try:
        if args.once:
            fleet.poll_once()
        else:
            fleet.run_loop(timeout=args.timeout)
    except KeyboardInterrupt:
        pass
    finally:
        if args.cmd:  # adopted runs are not ours to kill
            fleet.shutdown()
    summary = fleet.summary()
    print(json.dumps(summary, indent=2, default=str))
    return 0 if all(r["ok"] or args.once for r in summary.values()) else 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("run_dirs", nargs="*", help="run directories to supervise")
    parser.add_argument("--cmd", help="respawn command template; {run_dir} is substituted per run. Without it runs "
                        "are adopted: decisions are recorded, not executed")
    parser.add_argument("--interval", type=float, default=2.0, help="poll cadence (s)")
    parser.add_argument("--max-restarts", dest="max_restarts", type=int, default=3,
                        help="respawn budget per run (0 = the controller must refuse to act)")
    parser.add_argument("--events", default="controller_events.jsonl",
                        help="the controller_action/monitor_alert JSONL audit log")
    parser.add_argument("--once", action="store_true", help="one poll, then exit")
    parser.add_argument("--timeout", type=float, default=SOAK_TIMEOUT_S, help="supervision wall-clock bound (s)")
    parser.add_argument("--soak", action="store_true", help="run the closed-loop soak (see the module docstring)")
    parser.add_argument("--quick", action="store_true", help="the shorter soak (5 epochs on the killed leg)")
    parser.add_argument("--lm", action="store_true", help="the LM entry under the controller (module docstring)")
    parser.add_argument("--keep", action="store_true", help="keep the soak's work directory")
    parser.add_argument("--workdir", default=None, help="where the soak's runs go (default: a new directory "
                        "under build/)")
    parser.add_argument("--device", default="cuda", help="the children's device (cuda unless cpu)")
    parser.add_argument("--serve-port", dest="serve_port", type=int, default=0,
                        help="a serving replica's admin port: the soak offers it the freed chip")
    parser.add_argument("--serve-run-dir", dest="serve_run_dir", default="", help="that replica's run directory")
    # the soak child's flags, which the script passes to itself
    parser.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--init", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--run-dir", dest="run_dir", help=argparse.SUPPRESS)
    parser.add_argument("--final", default="", help=argparse.SUPPRESS)
    parser.add_argument("--max-epoch", dest="max_epoch", type=int, default=4, help=argparse.SUPPRESS)
    parser.add_argument("--devices", type=int, default=0, help=argparse.SUPPRESS)
    parser.add_argument("--mesh", default="", help=argparse.SUPPRESS)
    parser.add_argument("--accum", type=int, default=1, help=argparse.SUPPRESS)
    parser.add_argument("--tile", type=int, default=3, help=argparse.SUPPRESS)
    parser.add_argument("--prefetch", type=int, default=2, help=argparse.SUPPRESS)
    parser.add_argument("--num-workers", dest="num_workers", type=int, default=0, help=argparse.SUPPRESS)
    parser.add_argument("--load-delay", dest="load_delay", type=float, default=0.0, help=argparse.SUPPRESS)
    parser.add_argument("--commit-delay", dest="commit_delay", type=float, default=0.0, help=argparse.SUPPRESS)
    parser.add_argument("--heartbeat-every", dest="heartbeat_every", type=float, default=2.0, help=argparse.SUPPRESS)
    parser.add_argument("--step-timeout", dest="step_timeout", type=float, default=0.0, help=argparse.SUPPRESS)
    parser.add_argument("--hang-epoch", dest="hang_epoch", type=int, default=1, help=argparse.SUPPRESS)
    parser.add_argument("--hang-step", dest="hang_step", type=int, default=4, help=argparse.SUPPRESS)
    parser.add_argument("--hang-payload", dest="hang_payload", type=float, default=0.0, help=argparse.SUPPRESS)
    parser.add_argument("--slow-chip", dest="slow_chip", default="",
                        help=f"RANK:MS, the soak's degraded rank and its delay at each sync ({SLOW_CHIP})")
    parser.add_argument("--slow-chip-count", dest="slow_chip_count", type=int, default=1000, help=argparse.SUPPRESS)
    parser.add_argument("--seed", type=int, default=0, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)

    if args.child:
        return child_main(args)
    if args.soak:
        return run_soak(args)
    if args.lm:
        return run_lm(args)
    if not args.run_dirs:
        parser.error("run_dirs required (or --soak, or --lm)")
    return run_fleet(args)


if __name__ == "__main__":
    sys.exit(main())
