"""The port's fleet-controller policy held to the JAX package's, and the degraded-chip seam.

``distributed_training_pytorch_tpu_torch/telemetry/controller.py`` against
``distributed_training_pytorch_tpu/telemetry/controller.py``: each scenario of the JAX
``tests/test_controller.py`` (the action catalog, the budgets, backoff, debounce, the
respawn gate, the bounded tune and its A/B judge) and of ``tests/test_serving_drain.py``'s
``OfferHandshake`` cases is driven through both on the same synthetic status stream and
fake clock, and the two must give the same sequence of ``Action``\\ s (kind, reason,
message, params, evidence), the same policy state after each step (budget, knobs,
exclusions) and the same calls of the injected judge; the JAX tests' own assertions are
then checked on the port's trace. The rest of that file's scenarios (the attempt sidecar,
``FaultPlan.slow_chip``, ``replan_excluding``, the doctor's warm-up compiles) are held the
same way against the port's counterparts.

The seam: the soak's digits child (``scripts/torch_fleet_controller.py --child``) as 2 gloo
ranks at ``fsdp2`` on the CPU with rank 1 slowed; the port's doctor names ``straggler`` on
chip 1 from its event log, and the ``fault_injection`` records carry ``kind="slow_chip"``.
"""

import json
import os
import subprocess
import sys
import types

import pytest
from _torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

from distributed_training_pytorch_tpu.fault import inject as jax_inject
from distributed_training_pytorch_tpu.parallel import elastic as jax_elastic
from distributed_training_pytorch_tpu.telemetry import controller as jax_ctl
from distributed_training_pytorch_tpu.telemetry import doctor as jax_doctor
from distributed_training_pytorch_tpu.telemetry import events as jax_events
from distributed_training_pytorch_tpu_torch.fault import inject as port_inject
from distributed_training_pytorch_tpu_torch.parallel import elastic as port_elastic
from distributed_training_pytorch_tpu_torch.telemetry import controller as port_ctl
from distributed_training_pytorch_tpu_torch.telemetry import doctor as port_doctor
from distributed_training_pytorch_tpu_torch.telemetry import events as port_events

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# Synthetic statuses (duck-typed, as the JAX tests build them: the policy reads
# attributes, never isinstance).


def _diag(verdicts=(), slowest_chip=None, goodput=None):
    return types.SimpleNamespace(
        verdicts=list(verdicts),
        signals=types.SimpleNamespace(slowest_chip=slowest_chip,
                                      goodput_seconds=dict(goodput or {"productive_step": 10.0})),
    )


def _verdict(kind, score, evidence=()):
    return types.SimpleNamespace(kind=kind, score=score, evidence=list(evidence))


def _status(status="training", verdict="healthy", attempt=1, fractions=None, active=(), alerts=(), diagnosis=None,
            last_event_age_s=1.0):
    return types.SimpleNamespace(
        run_dir="/run", status=status, verdict=verdict, diagnosis=diagnosis if diagnosis is not None else _diag(),
        steady_fractions=dict(fractions or {}), last_event_age_s=last_event_age_s, progress_age_s=None, headline={},
        alerts=list(alerts), active_alerts=tuple(active), attempt=attempt,
    )


def _straggler_status(attempt=1, chip=3):
    rows = [{"metric": "straggler_ratio", "value": 2.1, "threshold": 1.5}]
    return _status(verdict="straggler", attempt=attempt,
                   diagnosis=_diag([_verdict("straggler", 1.4, rows)], slowest_chip=chip))


def _data_bound_status(attempt=1, frac=0.6, active=True, steady=5.0, status="training"):
    return _status(
        status=status, verdict="data_bound" if active else "healthy", attempt=attempt,
        fractions={"productive_step": 1.0 - frac, "data_wait": frac}, active=("data_bound",) if active else (),
        alerts=[{"rule": "data_bound", "value": frac, "threshold": 0.2}] if active else [],
        diagnosis=_diag(goodput={"productive_step": steady}),
    )


class _Run:
    """One scenario's runner over one controller module: every decision and application,
    with the policy's state after it, lands in ``trace``."""

    def __init__(self, m, config=None, **kw):
        self.m = m
        self.calls = []
        if kw.pop("stub_diff", False):
            def steady_diff(before, after, *, noise_floor=0.10):
                self.calls.append((dict(before), dict(after), noise_floor))
                return {"rows": [], "max_delta": 0.0, "clean": True, "fractions": {}}

            kw["steady_diff"] = steady_diff
        self.pol = m.RunPolicy(m.ControllerConfig(**(config or {})), **kw)
        self.trace = []

    def _state(self):
        p = self.pol
        return {"restarts_used": p.restarts_used, "gave_up": p.gave_up, "knobs": dict(p.knobs),
                "excluded": list(p.excluded_chips)}

    def decide(self, status, *, running=True, rc=None, now):
        act = self.pol.decide(status, proc_running=running, exit_code=rc, now=now)
        self.trace.append(("decide", now, None if act is None else _action(act), self._state()))
        return act

    def apply(self, act, *, now):
        self.pol.note_applied(act, now=now)
        self.trace.append(("applied", now, act.kind, self._state()))


def _action(act):
    return {"kind": act.kind, "reason": act.reason, "message": act.message, "params": act.params,
            "evidence": act.evidence, "respawns": act.respawns, "fields": act.event_fields()}


# ---------------------------------------------------------------------------
# The JAX tests' scenarios, each a function of the controller module.


def sc_proc_exit_restarts(m):
    r = _Run(m, {"confirm_polls": 5})
    r.decide(_status(), running=False, rc=137, now=0.0)
    return r


def sc_log_silence_debounced(m):
    r = _Run(m, {"confirm_polls": 2})
    dead = dict(status="dead", verdict="dead", last_event_age_s=240.0)
    r.decide(_status(**dead), now=0.0)
    r.decide(_status(), now=1.0)
    r.decide(_status(**dead), now=2.0)
    r.decide(_status(**dead), now=3.0)
    return r


def sc_pending_blocks_second(m):
    r = _Run(m)
    act = r.decide(_status(), running=False, rc=1, now=0.0)
    r.decide(_status(), running=False, rc=1, now=0.1)
    r.apply(act, now=0.2)
    return r


def sc_backoff_budget_give_up(m):
    r = _Run(m, {"max_restarts": 3, "backoff_s": 5.0, "backoff_factor": 2.0, "confirm_polls": 1})
    for now, apply in ((0.0, True), (3.0, False), (6.0, True), (10.0, False), (17.0, True), (100.0, True),
                       (200.0, False)):
        act = r.decide(_status(), running=False, rc=1, now=now)
        if apply and act is not None:
            r.apply(act, now=now)
    return r


def sc_zero_budget_refuses(m):
    r = _Run(m, {"max_restarts": 0})
    act = r.decide(_status(), running=False, rc=1, now=0.0)
    r.apply(act, now=0.0)
    r.decide(_status(), running=False, rc=1, now=1.0)
    return r


def sc_straggler_persistence(m):
    r = _Run(m, {"confirm_polls": 2})
    r.decide(_straggler_status(), now=0.0)
    anon = _status(verdict="straggler", diagnosis=_diag([_verdict("straggler", 1.4)], slowest_chip=None))
    r.decide(anon, now=1.0)
    r.decide(_straggler_status(), now=2.0)
    act = r.decide(_straggler_status(), now=3.0)
    r.apply(act, now=3.0)
    return r


def sc_respawn_gate(m):
    r = _Run(m, {"confirm_polls": 2, "backoff_s": 1.0})
    for now in (0.0, 1.0):
        act = r.decide(_straggler_status(), now=now)
    r.apply(act, now=1.0)
    for now in (5.0, 6.0, 7.0, 8.0):
        r.decide(_straggler_status(attempt=1), now=now)
    r.decide(_straggler_status(attempt=2), now=9.0)
    r.decide(_straggler_status(attempt=2), now=10.0)
    return r


def sc_proc_death_bypasses_gate(m):
    r = _Run(m, {"confirm_polls": 1, "backoff_s": 1.0})
    a1 = r.decide(_status(attempt=1), running=False, rc=1, now=0.0)
    r.apply(a1, now=0.0)
    r.decide(_status(attempt=1), running=False, rc=1, now=2.0)
    return r


def sc_tune_keep(m):
    r = _Run(m, {"confirm_polls": 2, "backoff_s": 1.0, "max_prefetch": 8, "ab_min_steady_s": 0.5},
             knobs={"prefetch_batches": 1, "commit_delay_s": 0.0}, stub_diff=True)
    r.decide(_data_bound_status(), now=0.0)
    tune = r.decide(_data_bound_status(), now=1.0)
    r.apply(tune, now=1.0)
    keep = r.decide(_data_bound_status(attempt=2, frac=0.05, active=False), now=5.0)
    r.apply(keep, now=5.0)
    return r


def sc_ab_waits(m):
    r = _Run(m, {"confirm_polls": 1, "backoff_s": 0.5, "ab_min_steady_s": 2.0}, knobs={"prefetch_batches": 1},
             stub_diff=True)
    tune = r.decide(_data_bound_status(), now=0.0)
    r.apply(tune, now=0.0)
    r.decide(_data_bound_status(attempt=1, frac=0.05, active=False), now=2.0)
    r.decide(_data_bound_status(attempt=2, frac=0.05, active=False, steady=0.5), now=3.0)
    r.decide(_data_bound_status(attempt=2, frac=0.05, active=False, steady=5.0), now=4.0)
    return r


def sc_ab_revert_give_up(m):
    r = _Run(m, {"confirm_polls": 1, "backoff_s": 0.5, "ab_min_steady_s": 0.5}, knobs={"prefetch_batches": 1},
             stub_diff=True)
    tune = r.decide(_data_bound_status(), now=0.0)
    r.apply(tune, now=0.0)
    rev = r.decide(_data_bound_status(attempt=2, frac=0.7), now=2.0)
    r.apply(rev, now=2.0)
    r.decide(_data_bound_status(attempt=3), now=10.0)
    return r


def sc_finished_judges_final(m):
    r = _Run(m, {"confirm_polls": 1, "backoff_s": 0.5, "ab_min_steady_s": 0.5}, knobs={"prefetch_batches": 1},
             stub_diff=True)
    tune = r.decide(_data_bound_status(), now=0.0)
    r.apply(tune, now=0.0)
    r.decide(_data_bound_status(attempt=2, frac=0.7, status="finished"), running=False, rc=0, now=2.0)
    return r


class _Hs:
    """An ``OfferHandshake`` scenario's runner: every call and the state after it."""

    def __init__(self, m, *args, **kw):
        self.hs = m.OfferHandshake(*args, **kw)
        self.trace = [("new", self._state())]
        self.calls = []

    def _state(self):
        h = self.hs
        return {"state": h.state, "reason": h.reason, "deadline": h.deadline, "settle_until": h.settle_until,
                "actuation": h.actuation, "done": h.done}

    def do(self, name, *args, **kw):
        try:
            out = getattr(self.hs, name)(*args, **kw)
        except Exception as e:  # noqa: BLE001 — the refusal is part of the trace
            out = f"{type(e).__name__}: {e}"
        self.trace.append((name, out, self._state()))
        return out


def sc_offer_keep_chip_scaled(m):
    h = _Hs(m, 1, before={"qps_per_chip": 100.0, "p99_ms": 5.0, "slo_ok": True, "chips": 1}, now=0.0, timeout_s=60.0,
            settle_s=2.0)
    h.do("note_decision", "accept", "healthy")
    h.do("note_actuated", {"shed": 0}, now=1.0)
    h.do("ready_to_judge", 2.0)
    h.do("ready_to_judge", 3.0)
    h.do("judge", {"qps_per_chip": 48.0, "p99_ms": 4.0, "slo_ok": True, "chips": 2})
    return h


def sc_offer_revert_slo_or_qps(m):
    traces = []
    for after in ({"qps_per_chip": 60.0, "chips": 2, "slo_ok": False}, {"qps_per_chip": 30.0, "chips": 2,
                                                                         "slo_ok": True}):
        h = _Hs(m, 1, before={"qps_per_chip": 100.0, "chips": 1, "slo_ok": True}, now=0.0, settle_s=0.0)
        h.do("note_decision", "accept")
        h.do("note_actuated", {}, now=0.0)
        h.do("judge", after)
        traces.append(h)
    out = _Hs(m, 0, before={}, now=0.0)
    out.trace = [t for h in traces for t in h.trace]
    return out


def sc_offer_decline_expiry(m):
    h = _Hs(m, 2, before={}, now=0.0, timeout_s=10.0)
    h.do("note_decision", "decline", "under SLO pressure")
    h.do("expired", 100.0)
    h.do("note_actuated", {}, now=1.0)
    h2 = _Hs(m, 2, before={}, now=0.0, timeout_s=10.0)
    h2.do("expired", 9.9)
    h2.do("expired", 10.0)
    h2.do("note_decision", "accept")
    h.trace += h2.trace
    return h


def sc_offer_judge_with_steady_diff(m):
    """The judge's optional evidence from an injected ``steady_diff`` (both sides carry
    window fractions)."""
    h = _Hs(m, 1, before={"qps_per_chip": 10.0, "chips": 1, "steady_fractions": {"productive_step": 0.9}},
            now=0.0, settle_s=0.0)
    h.do("note_decision", "accept")
    h.do("note_actuated", {}, now=0.0)

    def steady_diff(before, after, *, noise_floor):
        h.calls.append((before, after, noise_floor))
        return {"rows": [{"key": "productive_step", "before": before["productive_step"],
                          "after": after["productive_step"]}]}

    h.do("judge", {"qps_per_chip": 5.0, "chips": 2, "steady_fractions": {"productive_step": 0.8}}, noise_floor=0.2,
         steady_diff=steady_diff)
    return h


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_proc_exit_restarts, sc_log_silence_debounced, sc_pending_blocks_second, sc_backoff_budget_give_up,
    sc_zero_budget_refuses, sc_straggler_persistence, sc_respawn_gate, sc_proc_death_bypasses_gate, sc_tune_keep,
    sc_ab_waits, sc_ab_revert_give_up, sc_finished_judges_final, sc_offer_keep_chip_scaled,
    sc_offer_revert_slo_or_qps, sc_offer_decline_expiry, sc_offer_judge_with_steady_diff)}


def _actions(run):
    return [t[2] for t in run.trace if t[0] == "decide" and t[2] is not None]


# The JAX tests' assertions, on the port's trace.
CHECKS = {
    "proc_exit_restarts": lambda r: _actions(r)[0]["kind"] == "restart" and _actions(r)[0]["reason"] == "dead"
    and {"metric": "exit_code", "value": 137} in _actions(r)[0]["evidence"],
    "log_silence_debounced": lambda r: [t[2] and t[2]["kind"] for t in r.trace] == [None, None, None, "restart"]
    and _actions(r)[0]["evidence"][0]["metric"] == "last_event_age_s",
    "pending_blocks_second": lambda r: r.trace[1][2] is None and r.trace[-1][3]["restarts_used"] == 1,
    "backoff_budget_give_up": lambda r: [t[2] and t[2]["kind"] for t in r.trace if t[0] == "decide"]
    == ["restart", None, "restart", None, "restart", "give_up", None]
    and _actions(r)[-1]["params"] == {"restarts_used": 3, "max_restarts": 3},
    "zero_budget_refuses": lambda r: _actions(r)[0]["kind"] == "refuse" and r.trace[-1][2] is None
    and r.trace[-1][3]["gave_up"] and r.trace[-1][3]["restarts_used"] == 0,
    "straggler_persistence": lambda r: [a["kind"] for a in _actions(r)] == ["restart_excluding"]
    and _actions(r)[0]["params"]["exclude_chip"] == 3 and r.trace[-1][3]["excluded"] == [3],
    "respawn_gate": lambda r: [t[2] and t[2]["kind"] for t in r.trace if t[0] == "decide"][2:]
    == [None, None, None, None, None, "restart_excluding"],
    "proc_death_bypasses_gate": lambda r: [a["kind"] for a in _actions(r)] == ["restart", "restart"],
    "tune_keep": lambda r: [a["kind"] for a in _actions(r)] == ["tune", "keep"]
    and _actions(r)[0]["params"] == {"knob": "prefetch_batches", "from": 1, "to": 8, "bucket": "data_wait"}
    and _actions(r)[1]["params"]["value"] == 8 and r.trace[-1][3]["restarts_used"] == 1 and r.calls,
    "ab_waits": lambda r: [t[2] and t[2]["kind"] for t in r.trace if t[0] == "decide"] == ["tune", None, None, "keep"],
    "ab_revert_give_up": lambda r: [a["kind"] for a in _actions(r)] == ["tune", "revert", "give_up"]
    and _actions(r)[-1]["params"] == {"knob": "prefetch_batches", "state": "reverted"},
    "finished_judges_final": lambda r: _actions(r)[-1]["kind"] == "give_up" and "moot" in _actions(r)[-1]["message"]
    and r.trace[-1][3]["knobs"]["prefetch_batches"] == 8,
    "offer_keep_chip_scaled": lambda h: h.trace[-1][1][0] == "keep" and h.trace[-1][2]["state"] == "kept"
    and h.trace[-1][1][1][0]["expected_floor"] == pytest.approx(45.0),
    "offer_revert_slo_or_qps": lambda h: [t[1][0] for t in h.trace if t[0] == "judge"] == ["revert", "revert"],
    "offer_decline_expiry": lambda h: [t[-1]["state"] for t in h.trace]
    == ["offered", "declined", "declined", "declined", "offered", "offered", "expired", "expired"]
    and h.trace[3][1].startswith("RuntimeError") and h.trace[-1][1].startswith("RuntimeError"),
    "offer_judge_with_steady_diff": lambda h: h.trace[-1][1][0] == "keep" and len(h.trace[-1][1][1]) == 4
    and h.calls[0][2] == 0.2,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_policy_actions_match_jax(name):
    port, jax = SCENARIOS[name](port_ctl), SCENARIOS[name](jax_ctl)
    assert json.dumps(port.trace, sort_keys=True, default=repr) == json.dumps(jax.trace, sort_keys=True, default=repr)
    assert json.dumps(port.calls, sort_keys=True) == json.dumps(jax.calls, sort_keys=True)
    assert CHECKS[name](port)


def test_action_catalog_and_config_match_jax():
    import dataclasses

    assert port_ctl.ACTION_KINDS == jax_ctl.ACTION_KINDS
    assert port_ctl._RESPAWN_KINDS == jax_ctl._RESPAWN_KINDS and port_ctl._TUNES == jax_ctl._TUNES
    assert dataclasses.asdict(port_ctl.ControllerConfig()) == dataclasses.asdict(jax_ctl.ControllerConfig())
    assert not port_ctl.Action(kind="offer_chip", reason="straggler").respawns
    assert port_ctl.OfferHandshake.TERMINAL == jax_ctl.OfferHandshake.TERMINAL


# ---------------------------------------------------------------------------
# The rest of the JAX file's scenarios, against the port's counterparts.


def _attempts(events, root):
    run = os.path.join(root, "run")
    out = [events.peek_attempt(run), events.claim_attempt(run), events.peek_attempt(run), events.peek_attempt(run),
           events.claim_attempt(run), events.claim_attempt(run), events.peek_attempt(run)]
    with open(os.path.join(run, "telemetry", "attempt"), "w") as f:
        f.write("garbage")
    return out + [events.peek_attempt(run), events.claim_attempt(run)]


def _slow_chip(inject):
    plan = inject.FaultPlan().add("slow_chip", count=1, payload={"device": 1, "delay_ms": 60.0})
    out = [plan.slow_chip([0, 2]), plan.slow_chip([0, 2]), plan.slow_chip([0, 1]), plan.slow_chip([0, 1]), plan.fired]
    plan = inject.FaultPlan().add("slow_chip", epoch=2, count=5, payload={"device": 0, "delay_ms": 10.0})
    return out + [plan.slow_chip([0, 1], epoch=1), plan.slow_chip([0, 1], epoch=2)]


def _replan(elastic):
    out = []
    for args, kw in ((({"data": 1, "fsdp": 2}, [0, 1], [1]), {"batch_size": 128, "accum_steps": 1}),
                     (({"data": 4}, [0, 1, 2, 3], [7]), {"batch_size": 64}),
                     (({"data": 2}, [0, 1], [0, 1]), {})):
        try:
            p = elastic.replan_excluding(*args, **kw)
            out.append([p.old_axes, p.new_axes, p.accum_steps, p.old_accum_steps, p.reason])
        except elastic.ElasticReplanError as e:
            out.append(["ElasticReplanError", str(e)])
    return out


def _warmup_compiles(doctor):
    out = []
    for recs in ([{"event": "run_start", "attempt": 2, "epoch": 3}, {"event": "compile", "epoch": 3, "seconds": 2.0},
                  {"event": "compile", "epoch": 4, "seconds": 2.0}],
                 [{"event": "run_start", "epoch": 0}, {"event": "compile", "epoch": 0, "seconds": 2.0},
                  {"event": "compile", "epoch": 1, "seconds": 2.0},
                  {"event": "compile", "epoch": 2, "kind": "mfu_probe", "seconds": 1.0}]):
        sig = doctor.Signals()
        for r in recs:
            doctor.update_signals(sig, r)
            out.append([sig.start_epoch, sig.late_compiles])
    return out


@pytest.mark.parametrize("name", ["attempt_sidecar", "slow_chip_plan", "replan_excluding", "warmup_compiles"])
def test_support_matches_jax(name, tmp_path):
    if name == "attempt_sidecar":
        port, jax = _attempts(port_events, str(tmp_path / "p")), _attempts(jax_events, str(tmp_path / "j"))
        assert port == [0, 1, 1, 1, 2, 3, 3, 0, 1]
    elif name == "slow_chip_plan":
        port, jax = _slow_chip(port_inject), _slow_chip(jax_inject)
        assert port[2] == (1, pytest.approx(0.06)) and port[3] is None
    elif name == "replan_excluding":
        port, jax = _replan(port_elastic), _replan(jax_elastic)
        assert port[0][1] == {"data": 1} and port[0][2] == 2 and "excluding" in port[0][4]
        assert port[2][0] == "ElasticReplanError"
    else:
        port, jax = _warmup_compiles(port_doctor), _warmup_compiles(jax_doctor)
        assert port == [[3, 0], [3, 0], [3, 1], [0, 0], [0, 0], [0, 1], [0, 1]]
    assert json.dumps(port, default=repr) == json.dumps(jax, default=repr)


# ---------------------------------------------------------------------------
# The degraded-chip seam in the port's Trainer.


def test_slow_chip_seam_names_the_slowed_rank(tmp_path):
    """2 gloo ranks at fsdp2 (the fleet soak's child, one short epoch), rank 1 slowed at every
    sync: each window's straggler fields name rank 1, and the port's doctor (and the JAX
    one, on the same log) gives the ``straggler`` verdict on chip 1."""
    run = str(tmp_path / "run")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "torch_fleet_controller.py"), "--child", "--run-dir", run,
         "--max-epoch", "1", "--tile", "1", "--device", "cpu", "--devices", "2", "--mesh", "fsdp2",
         "--slow-chip", "1:600", "--heartbeat-every", "0.5"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    recs = port_events.load_run_events(run)
    faults = [r for r in recs if r["event"] == "fault_injection"]
    assert faults and all(r["kind"] == "slow_chip" and r["device"] == 1 and r["delay_ms"] == pytest.approx(600.0)
                          and {"epoch", "step_in_epoch"} <= set(r) for r in faults)
    windows = [r for r in recs if r["event"] == "window" and r.get("slowest_chip") is not None]
    # The first of them attributes the epoch's first window, which also holds the ranks'
    # start-up skew; each later one names the slowed rank.
    assert len(windows) >= 2 and all(r["slowest_chip"] == 1 and r["chips_sampled"] == 2 for r in windows[1:])
    port = port_doctor.diagnose(recs)
    jax = jax_doctor.diagnose(jax_events.load_run_events(run))
    assert port.verdict == "straggler" and port.signals.slowest_chip == 1
    assert json.dumps(port.to_dict(), sort_keys=True) == json.dumps(jax.to_dict(), sort_keys=True)
