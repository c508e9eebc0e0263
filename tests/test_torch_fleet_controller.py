"""The port's fleet controller's mechanism on the CPU (``scripts/torch_fleet_controller.py``).

* A child that dies once is restarted and finishes: a stand-in trainer (standard library
  only) writes the event log a trainer writes, claims its attempt, and dies on its first
  attempt; the controller restarts it, the second attempt finishes, and the summary, the
  policy's budget and the ``controller_action`` record say so.
* A two-rank child is stopped as a whole process group: a launcher that lets a SIGTERM
  pass (as the soak's does) and its two ranks, which ignore it, leave no process behind.
* The zero-budget controller refuses (one ``refuse`` record, no respawn) and exits 1.
* ``controller_action`` records carry the JAX field names: the same record-only action
  executed by the JAX package's ``FleetController`` and by the port's gives the same
  fields, and both packages' doctors read the controller's log.
* The actuated chip offer: the port's ``_actuate_offer`` and the JAX package's, through
  the same stubbed transport and fake clock, give the same action sequences on a replica
  whose re-plan succeeds (keep), declines, refuses the re-plan (400: revert, re-armed),
  or stalls (the handshake expires: revert, re-plan back); then the keep path over real
  sockets against a stub replica (a standard-library HTTP server). The port's replica on
  the CPU has one device and cannot grow, so the keep path is held by the mechanism
  against the stub and by ``OfferHandshake.judge`` in ``test_torch_controller.py``.
"""

import json
import os
import signal
import sys
import threading
import time
import types
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from distributed_training_pytorch_tpu.telemetry import doctor as jax_doctor
from distributed_training_pytorch_tpu.telemetry import events as jax_events
from distributed_training_pytorch_tpu.telemetry import monitor as jax_monitor
from distributed_training_pytorch_tpu.telemetry.controller import Action as JaxAction
from distributed_training_pytorch_tpu.telemetry.controller import ControllerConfig as JaxConfig
from distributed_training_pytorch_tpu_torch.telemetry import doctor as port_doctor
from distributed_training_pytorch_tpu_torch.telemetry import events as port_events
from distributed_training_pytorch_tpu_torch.telemetry import monitor as port_monitor
from distributed_training_pytorch_tpu_torch.telemetry.controller import Action, ControllerConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import fleet_controller as jax_fc  # noqa: E402
import torch_fleet_controller as fc  # noqa: E402

# A stand-in trainer: the records a trainer writes (run_start with its attempt, a window, a
# heartbeat, run_end), standard library only. Its first attempt dies with exit code 1.
FAKE_TRAINER = r"""
import json, os, sys, time
run = sys.argv[1]
tele = os.path.join(run, "telemetry")
os.makedirs(tele, exist_ok=True)
side = os.path.join(tele, "attempt")
attempt = (int(open(side).read() or 0) if os.path.exists(side) else 0) + 1
open(side, "w").write(str(attempt))
def emit(event, **kw):
    with open(os.path.join(tele, "events.jsonl"), "a") as f:
        f.write(json.dumps(dict(event=event, t_wall=time.time(), t_mono=time.monotonic(), **kw)) + "\n")
emit("run_start", attempt=attempt, epoch=0)
emit("window", epoch=0, step_in_epoch=4, steps=4, step_ms=1.0)
emit("heartbeat", attempt=attempt, source="loop", epoch=0, step_in_epoch=4, units=2,
     goodput_seconds={"productive_step": 0.01})
if attempt == 1 or sys.argv[2] == "always":
    sys.exit(1)
emit("run_end", epoch=0)
"""

# A launcher that lets a SIGTERM pass and two "ranks" that ignore it: only the group's
# SIGKILL ends them.
FAKE_RANKS = r"""
import os, signal, subprocess, sys, time
signal.signal(signal.SIGTERM, signal.SIG_IGN)
code = "import signal, time; signal.signal(signal.SIGTERM, signal.SIG_IGN); time.sleep(120)"
ranks = [subprocess.Popen([sys.executable, "-c", code]) for _ in range(2)]
with open(sys.argv[1], "w") as f:
    f.write(" ".join(str(p.pid) for p in ranks))
time.sleep(120)
"""


def _fleet(module, specs, events_path, **cfg):
    ev_module = jax_events if module is jax_fc else port_events
    mon = jax_monitor if module is jax_fc else port_monitor
    conf = (JaxConfig if module is jax_fc else ControllerConfig)(**cfg)
    return module.FleetController(specs, config=conf, monitor_config=mon.AlertConfig(),
                                  event_log=ev_module.EventLog(events_path, process_index=0), interval=0.05)


def _actions(path):
    return [r for r in port_events.read_events(path) if r.get("event") == "controller_action"]


def test_child_that_dies_once_is_restarted_and_finishes(tmp_path):
    run = str(tmp_path / "run")
    spec = fc.RunSpec(name="run", run_dir=run, cmd=[sys.executable, "-c", FAKE_TRAINER, run, "once"])
    events = str(tmp_path / "ops.jsonl")
    fleet = _fleet(fc, [spec], events, backoff_s=0.0, confirm_polls=1)
    fleet.start()
    try:
        assert fleet.run_loop(timeout=60.0)
    finally:
        fleet.shutdown()
    row = fleet.summary()["run"]
    assert row["ok"] and row["actions"] == ["restart"] and row["restarts_used"] == 1 and row["attempt"] == 2
    (rec,) = _actions(events)
    assert rec["action"] == "restart" and rec["reason"] == "dead" and rec["evidence"][0] == {"metric": "exit_code",
                                                                                          "value": 1}
    assert rec["restarts_used"] == 1 and rec["max_restarts"] == 3 and rec["run_dir"] == run
    assert fleet.poll_cost()["sweeps"] >= 2


def test_two_rank_child_is_stopped_as_a_process_group(tmp_path, monkeypatch):
    monkeypatch.setattr(fc, "GRACE_S", 0.5)
    pids = str(tmp_path / "pids")
    spec = fc.RunSpec(name="ranks", run_dir=str(tmp_path / "ranks"), cmd=[sys.executable, "-c", FAKE_RANKS, pids])
    fleet = _fleet(fc, [spec], str(tmp_path / "ops.jsonl"))
    fleet.start()
    run = fleet.runs["ranks"]
    deadline = time.monotonic() + 30
    while not (os.path.exists(pids) and open(pids).read().strip()) and time.monotonic() < deadline:
        time.sleep(0.05)
    ranks = [int(p) for p in open(pids).read().split()]
    assert os.getpgid(ranks[0]) == run.proc.pid  # the ranks are in the child's group
    fleet._stop(run, graceful=True)  # SIGTERM (ignored by all three), then the group's SIGKILL

    def gone(pid):
        try:
            with open(f"/proc/{pid}/stat") as f:
                return f.read().split(")")[-1].split()[0] == "Z"  # a zombie no one has reaped yet
        except FileNotFoundError:
            return True

    deadline = time.monotonic() + 10
    while not all(gone(p) for p in ranks) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert run.proc.poll() == -signal.SIGKILL
    assert all(gone(p) for p in ranks)


def test_zero_budget_controller_refuses_and_exits_nonzero(tmp_path):
    run, events, script = str(tmp_path / "run"), str(tmp_path / "ops.jsonl"), tmp_path / "trainer.py"
    script.write_text(FAKE_TRAINER)
    cmd = f"{sys.executable} {script} {{run_dir}} always"
    rc = fc.main([run, "--cmd", cmd, "--max-restarts", "0", "--events", events, "--interval", "0.05",
                  "--timeout", "60"])
    assert rc == 1
    recs = _actions(events)
    assert [r["action"] for r in recs] == ["refuse"] and recs[0]["max_restarts"] == 0
    assert port_events.peek_attempt(run) == 1  # no respawn


def test_controller_action_records_match_jax_and_both_doctors_read_them(tmp_path):
    """The same record-only action through both packages' ``_execute`` (an adopted run, so
    nothing is spawned): the same record fields and values; then both doctors read the
    controller's log."""
    recs = {}
    for name, module, act in (("port", fc, Action), ("jax", jax_fc, JaxAction)):
        run = str(tmp_path / name / "run")
        events = str(tmp_path / name / "ops.jsonl")
        fleet = _fleet(module, [module.RunSpec(name="run", run_dir=run, adopt=True)], events)
        status = types.SimpleNamespace(attempt=2, status="training", verdict="data_bound")
        action = act("keep", "data_bound", message="prefetch_batches=8 kept", params={"knob": "prefetch_batches",
                                                                                     "value": 8},
                     evidence=[{"metric": "data_wait_frac_steady", "before": 0.6, "after": 0.05}])
        fleet._execute(fleet.runs["run"], action, status, 0.0)
        fleet.events.close()
        (rec,) = _actions(events)
        recs[name] = {k: v for k, v in rec.items() if k not in ("t_wall", "t_mono", "pid", "host", "chips", "run_dir")}
        port = port_doctor.diagnose(port_events.load_run_events(events))
        jax = jax_doctor.diagnose(jax_events.load_run_events(events))
        assert port.to_dict() == jax.to_dict() and port.verdict == "healthy"
    assert recs["port"] == recs["jax"]
    assert {"run", "attempt", "status", "verdict", "action", "reason", "message", "params", "evidence",
            "restarts_used", "max_restarts"} <= set(recs["port"])


# ---------------------------------------------------------------------------
# The actuated offer.


class _Replica:
    """A stubbed replica's transport: ``/status``, ``/admin/offer`` and ``/admin/replan``
    answers by case, every call recorded."""

    def __init__(self, case, clock):
        self.case, self.clock, self.calls = case, clock, []
        self.device_ids = [0]

    def get(self, url, timeout=5.0):
        self.calls.append(("GET", url.rsplit("/", 1)[-1]))
        n = len(self.device_ids)
        return 200, {"qps_per_chip": 100.0 / n, "p99_ms": 5.0, "slo_ok": True, "chips": n,
                     "device_ids": list(self.device_ids)}

    def post(self, url, payload, timeout=30.0):
        route = url.split("/admin/")[-1]
        self.calls.append(("POST", route, json.loads(json.dumps(payload))))
        if route == "offer":
            if self.case == "decline":
                return 200, {"decision": "decline", "chip": payload["chip"], "reason": "under SLO pressure"}
            return 200, {"decision": "accept", "chip": payload["chip"], "reason": "healthy and serving"}
        if self.case == "refuse":
            return 400, {"error": "replan_failed", "detail": "ValueError: one device a process", "state": "serving"}
        if self.case == "stall" and payload["device_ids"] != [0]:
            self.clock.t += 120.0  # the re-plan took past the handshake's deadline
        self.device_ids = list(payload["device_ids"])
        return 200, {"state": "serving", "device_ids": list(payload["device_ids"]), "shed": 0}


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.t += s


def _offer_run(module, tmp_path, case):
    clock = _Clock()
    replica = _Replica(case, clock)
    trainer = module.RunSpec(name="trainer", run_dir=str(tmp_path / "trainer"), adopt=True, device_ids=(0, 1),
                             mesh="fsdp2")
    server = module.RunSpec(name="replica", run_dir=str(tmp_path / "replica"), kind="serve", port=8999, adopt=True)
    events = str(tmp_path / "ops.jsonl")
    fleet = _fleet(module, [trainer, server], events)
    fleet._clock = clock
    fleet._sleep, fleet._http_get, fleet._http_post = clock.sleep, replica.get, replica.post
    if case == "stall":  # the settle window outlasts the deadline: the handshake expires
        fleet.config.offer_settle_s = 1e9
    act = (JaxAction if module is jax_fc else Action)(
        kind="restart_excluding", reason="straggler", params={"exclude_chip": 1},
        evidence=[{"metric": "straggler_ratio", "value": 3.2, "chip": 1}])
    fleet._offer_freed_chip(fleet.runs["trainer"], act, types.SimpleNamespace(attempt=2, status="training",
                                                                               verdict="straggler"))
    fleet.events.close()
    recs = [{k: r[k] for k in ("run", "action", "reason", "message", "params", "evidence")} for r in _actions(events)]
    return recs, replica.calls, [a.kind for a in fleet.runs["replica"].actions]


@pytest.mark.parametrize("case", ["keep", "decline", "refuse", "stall"])
def test_actuated_offer_matches_jax(case, tmp_path):
    port = _offer_run(fc, tmp_path / "port", case)
    jax = _offer_run(jax_fc, tmp_path / "jax", case)
    recs, calls, kinds = port
    if case == "refuse":
        # The port's one addition: the refused re-plan's status and body as the revert's
        # evidence row (the JAX record has none).
        assert recs[-1]["evidence"] == [{"metric": "replan_status", "value": 400, "detail": {
            "error": "replan_failed", "detail": "ValueError: one device a process", "state": "serving"}}]
        assert jax[0][-1]["evidence"] == []
        recs[-1]["evidence"] = []
    assert json.dumps(port, sort_keys=True) == json.dumps(jax, sort_keys=True)
    assert recs[0]["action"] == "offer_chip" and recs[0]["params"]["actuated"] is True
    if case == "keep":
        assert kinds == ["offer_chip", "keep"] and recs[-1]["params"]["device_ids"] == [0, 1]
    elif case == "decline":
        assert kinds == ["offer_chip"] and [c[1] for c in calls] == ["status", "offer"]
    elif case == "refuse":
        assert kinds == ["offer_chip", "revert"] and recs[-1]["reason"] == "replan_failed"
        assert recs[-1]["params"]["rearmed"] is True and "400" in recs[-1]["message"]
        assert [c[1] for c in calls] == ["status", "offer", "replan"]  # no re-plan back: nothing changed
    else:
        assert kinds == ["offer_chip", "revert"] and recs[-1]["reason"] == "offer_timeout"
        assert recs[-1]["params"]["rearmed"] is True and calls[-1] == ("POST", "replan", {"device_ids": [0],
                                                                                         "deadline_s": 10.0})


class _StubReplicaHandler(BaseHTTPRequestHandler):
    device_ids = [0]
    posts = []

    def _send(self, code, body):
        data = json.dumps(body).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):  # noqa: N802
        n = len(self.device_ids)
        self._send(200, {"qps_per_chip": 50.0 / n, "p99_ms": 3.0, "slo_ok": True, "chips": n,
                         "device_ids": list(self.device_ids)})

    def do_POST(self):  # noqa: N802
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        type(self).posts.append((self.path, body))
        if self.path == "/admin/offer":
            self._send(200, {"decision": "accept", "chip": body["chip"], "reason": "healthy and serving"})
        else:
            type(self).device_ids = list(body["device_ids"])
            self._send(200, {"state": "serving", "device_ids": body["device_ids"], "shed": 0})

    def log_message(self, *args):
        pass


def test_actuated_offer_keep_over_sockets(tmp_path):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _StubReplicaHandler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        trainer = fc.RunSpec(name="trainer", run_dir=str(tmp_path / "trainer"), adopt=True, device_ids=(0, 1),
                             mesh="fsdp2")
        server = fc.RunSpec(name="replica", run_dir=str(tmp_path / "replica"), kind="serve",
                            port=httpd.server_address[1], adopt=True)
        events = str(tmp_path / "ops.jsonl")
        fleet = _fleet(fc, [trainer, server], events, offer_settle_s=0.05)
        act = Action(kind="restart_excluding", reason="straggler", params={"exclude_chip": 1},
                     evidence=[{"metric": "straggler_ratio", "value": 3.2}])
        fleet._offer_freed_chip(fleet.runs["trainer"], act, types.SimpleNamespace(attempt=2, status="training",
                                                                                 verdict="straggler"))
        fleet.events.close()
    finally:
        httpd.shutdown()
        httpd.server_close()
    recs = _actions(events)
    assert [r["action"] for r in recs] == ["offer_chip", "keep"] and recs[1]["params"]["device_ids"] == [0, 1]
    assert [p for p, _ in _StubReplicaHandler.posts] == ["/admin/offer", "/admin/replan"]
