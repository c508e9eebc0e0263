"""The fleet controller's policy: doctor verdicts to remediation actions.

Counterpart of ``distributed_training_pytorch_tpu/telemetry/controller.py``, kept as its own
copy (the port imports nothing of the JAX package): the same action catalog, budgets,
debounce, A/B judge and chip-offer handshake, so the CPU tests hold the two to identical
action sequences on the same status streams and clocks. It is pure and its clock is
injected: :class:`RunPolicy` turns one run's :class:`~.monitor.MonitorStatus` stream (and
its subprocess's liveness) into bounded :class:`Action`\\ s, and
``scripts/torch_fleet_controller.py`` owns the mechanism (spawning and stopping trainers,
re-planning meshes, emitting the ``controller_action`` records).

The fields it reads are the port monitor's and doctor's, under the JAX names:
``MonitorStatus.status``, ``attempt``, ``steady_fractions``, ``active_alerts``,
``alerts``, ``last_event_age_s`` and ``diagnosis``; ``Diagnosis.verdicts`` (each
``kind``, ``score``, ``evidence``) and ``Diagnosis.signals`` (``slowest_chip``, a batch
rank's index in the port, and ``goodput_seconds``); the doctor's ``_EXCLUDED`` buckets.

Action catalog:

=====================  ====================================================
``restart``            the run is ``dead`` (log silent, or the process exited
                       abnormally) or ``stale_heartbeat`` (hung past the
                       watchdog): kill what remains and respawn; the trainer
                       resumes from ``latest_valid`` on its own.
``restart_excluding``  a persistent ``straggler`` verdict names a chip
                       (``Signals.slowest_chip``): respawn onto the surviving
                       devices through ``parallel.elastic.replan_excluding``.
``tune``               a persistent ``data_bound`` / ``checkpoint_stall``
                       alert: one bounded knob change (prefetch depth up to a
                       cap, ``commit_delay_s`` down to a floor), applied by
                       respawn.
``keep`` / ``revert``  the tune's A/B verdict: once the tuned attempt accrued
                       steady wall, its fractions are diffed against the
                       pre-tune attempt's through the injected
                       ``steady_diff`` (``scripts/torch_run_compare.py``'s):
                       improved and under the ceiling gives ``keep`` (record
                       only), else ``revert`` (respawn with the old value).
``give_up``            the max-restarts budget is spent, or a reverted
                       disease recurs: stop acting, the run surfaces as dead
                       or degraded for a human.
``refuse``             ``max_restarts == 0``: the controller may not act at
                       all; recorded once, then silence.
``offer_chip``         a chip that ``restart_excluding`` freed is offered to a
                       serving replica of the fleet (advisory without an
                       admin port, actuated with one: :class:`OfferHandshake`);
                       never a respawn of the replica.
=====================  ====================================================

Rate limits: every status-based trigger must hold for ``confirm_polls`` consecutive polls;
a subprocess exit is definitive and acts at once; after every executed action the policy
is silent for an exponentially growing backoff; at most one action is in flight per run
(``decide`` returns nothing until :meth:`RunPolicy.note_applied`); every respawn consumes
one unit of ``max_restarts``. Every :class:`Action` carries the verdict or alert evidence
rows that justified it, copied onto its ``controller_action`` record.
"""

from __future__ import annotations

import dataclasses

__all__ = [
    "Action",
    "ACTION_KINDS",
    "ControllerConfig",
    "OfferHandshake",
    "RunPolicy",
]

ACTION_KINDS = (
    "restart",
    "restart_excluding",
    "tune",
    "keep",
    "revert",
    "give_up",
    "refuse",
    # Mixed fleet: when restart_excluding frees a chip from a trainer's
    # mesh, the fleet controller offers it to a serving replica: advisory
    # without the replica's admin port, actuated with it (the replica
    # accepts or declines over its /admin surface, an accepted offer drains,
    # re-plans onto the freed chip, and is A/B-judged on before/after
    # QPS-per-chip + p99, :class:`OfferHandshake`); a handshake that times
    # out reverts and re-arms. Never a respawn of the serving replica's
    # process.
    "offer_chip",
)

# Actions that respawn the trainer subprocess (and therefore consume one
# unit of the max-restarts budget and start a backoff window).
_RESPAWN_KINDS = ("restart", "restart_excluding", "tune", "revert")

# Knob bounds per tunable disease: the ONE bounded change the policy may
# apply, and the steady-fraction bucket whose movement judges it.
_TUNES = {
    "data_bound": {"knob": "prefetch_batches", "bucket": "data_wait"},
    "checkpoint_stall": {"knob": "commit_delay_s", "bucket": "checkpoint"},
}


@dataclasses.dataclass
class ControllerConfig:
    """The policy's budgets and ceilings (see module doc).

    * ``max_restarts`` — total respawns allowed per run dir across the
      controller's lifetime. 0 = the controller must refuse to act.
    * ``backoff_s`` / ``backoff_factor`` — silence window after each
      executed action, growing exponentially (5s, 10s, 20s, ... by
      default): a remediation must get time to prove itself before the
      next one, and a flapping run burns wall clock, not the fleet.
    * ``confirm_polls`` — consecutive polls a status-based trigger must
      hold before acting (a subprocess exit is definitive and exempt).
    * ``max_prefetch`` — cap for the ``data_bound`` prefetch bump;
      ``commit_delay_to`` — floor for the ``checkpoint_stall`` tune
      (0.0 = drop the injected commit delay entirely).
    * ``ab_noise_floor`` — the steady-fraction noise floor the tune's A/B
      verdict uses (``torch_run_compare.steady_diff``'s default).
    * ``ab_min_steady_s`` — steady wall the tuned attempt must accrue
      before it is judged (the first post-warmup sync's tiny denominator
      must not decide a revert).
    * ``offer_timeout_s`` — wall budget for the whole actuated chip
      offer: offer -> accept -> drain/re-plan -> serving
      again. Past it the handshake reverts (the replica re-plans back,
      or was never touched) and re-arms.
    * ``offer_settle_s`` — post-re-plan settle window before the offer's
      A/B judge reads the after-side probe (the first seconds after a
      re-plan are warmup + queue flush, not steady state).
    """

    max_restarts: int = 3
    backoff_s: float = 5.0
    backoff_factor: float = 2.0
    confirm_polls: int = 2
    max_prefetch: int = 8
    commit_delay_to: float = 0.0
    ab_noise_floor: float = 0.10
    ab_min_steady_s: float = 0.5
    offer_timeout_s: float = 60.0
    offer_settle_s: float = 2.0


@dataclasses.dataclass
class Action:
    """One decided remediation. ``params`` is the mechanism's input (knob
    name/values, the excluded chip); ``evidence`` the verdict/alert rows
    that justified the decision — copied onto the ``controller_action``
    record verbatim."""

    kind: str  # one of ACTION_KINDS
    reason: str  # triggering verdict/rule ("dead", "straggler", ...)
    message: str = ""
    params: dict = dataclasses.field(default_factory=dict)
    evidence: list = dataclasses.field(default_factory=list)

    @property
    def respawns(self) -> bool:
        return self.kind in _RESPAWN_KINDS

    def event_fields(self) -> dict:
        """The ``controller_action`` record's action-specific payload."""
        return {
            "action": self.kind,
            "reason": self.reason,
            "message": self.message,
            "params": dict(self.params),
            "evidence": list(self.evidence),
        }


class OfferHandshake:
    """The actuated chip offer's pure state machine.

    Policy only, clock-injected, no sockets: ``scripts/torch_fleet_
    controller.py`` owns the transport (the replica's ``/admin/offer`` +
    ``/admin/replan`` routes and ``/status`` probes) and drives this
    object through it, exactly as :class:`RunPolicy` is driven by the
    spawn/kill mechanism. States::

        offered --decline--> declined                      (terminal)
        offered --accept--> accepted --actuate--> settling
        settling --judge--> kept | reverted                (terminal)
        any non-terminal --deadline--> expired             (terminal,
                                                 revert + re-arm)

    The judge compares before/after ``/status`` probes on the two
    serving metrics — QPS-per-chip and p99 — with the
    chip-count correction that makes the comparison honest: absorbing a
    chip under a fixed-rate open-loop load *halves* per-chip QPS by
    construction, so the keep floor is the before-side throughput scaled
    by ``before_chips / after_chips`` (what the same offered load yields
    spread over more chips), noise-floored like every other A/B in the
    controller. SLO health is primary: an after-side ``slo_ok=False``
    reverts regardless of throughput arithmetic. Optional
    ``steady_diff`` rows (``torch_run_compare``'s, the tune's judge) ride
    along as evidence when window fractions are available on both sides.
    """

    TERMINAL = ("declined", "kept", "reverted", "expired")

    def __init__(
        self,
        chip: int,
        *,
        before: dict,
        now: float,
        timeout_s: float = 60.0,
        settle_s: float = 2.0,
    ):
        self.chip = int(chip)
        self.before = dict(before or {})
        self.deadline = float(now) + float(timeout_s)
        self.settle_s = float(settle_s)
        self.state = "offered"
        self.reason = ""
        self.settle_until: "float | None" = None
        self.actuation: dict = {}

    @property
    def done(self) -> bool:
        return self.state in self.TERMINAL

    def expired(self, now: float) -> bool:
        """True (and the state flips to ``expired``) when the bounded
        handshake wall ran out before a terminal state: the mechanism
        must revert whatever was actuated and re-arm the offer."""
        if not self.done and float(now) >= self.deadline:
            self.reason = (
                f"handshake timed out in state {self.state!r} before "
                "completing — reverting and re-arming"
            )
            self.state = "expired"
            return True
        return False

    def note_decision(self, decision: str, reason: str = "") -> None:
        """Fold the replica's ``/admin/offer`` answer in."""
        if self.state != "offered":
            raise RuntimeError(f"decision arrived in state {self.state!r}")
        if decision == "accept":
            self.state = "accepted"
        elif decision == "decline":
            self.state = "declined"
        else:
            raise ValueError(f"unknown offer decision {decision!r}")
        self.reason = reason

    def note_actuated(self, summary: dict, *, now: float) -> None:
        """The replica drained, re-planned and resumed (``/admin/replan``
        returned 200): start the settle window the judge waits out."""
        if self.state != "accepted":
            raise RuntimeError(f"actuation arrived in state {self.state!r}")
        self.state = "settling"
        self.actuation = dict(summary or {})
        self.settle_until = float(now) + self.settle_s

    def ready_to_judge(self, now: float) -> bool:
        return (
            self.state == "settling"
            and self.settle_until is not None
            and float(now) >= self.settle_until
        )

    def judge(
        self, after: dict, *, noise_floor: float = 0.10, steady_diff=None
    ) -> "tuple[str, list]":
        """The offer's A/B verdict from before/after ``/status`` probes.
        Returns ``("keep"|"revert", evidence_rows)`` and moves to the
        matching terminal state. See the class doc for the chip-scaled
        throughput floor; ``steady_diff(before_fractions, after_fractions,
        noise_floor=...)`` contributes evidence rows when both probes
        carry window fractions (same injection seam as RunPolicy's)."""
        if self.state != "settling":
            raise RuntimeError(f"judge called in state {self.state!r}")
        after = dict(after or {})
        before_qpc = float(self.before.get("qps_per_chip") or 0.0)
        after_qpc = float(after.get("qps_per_chip") or 0.0)
        before_chips = max(1, int(self.before.get("chips") or 1))
        after_chips = max(1, int(after.get("chips") or before_chips))
        # The same offered load spread over the grown device set: the
        # honest floor a fixed-rate client leaves an absorbing replica.
        expected = before_qpc * (before_chips / after_chips)
        floor = expected * (1.0 - float(noise_floor))
        slo_bad = after.get("slo_ok") is False
        evidence = [
            {
                "metric": "qps_per_chip",
                "before": round(before_qpc, 3),
                "after": round(after_qpc, 3),
                "expected_floor": round(floor, 3),
                "chips": [before_chips, after_chips],
            },
            {
                "metric": "p99_ms",
                "before": self.before.get("p99_ms"),
                "after": after.get("p99_ms"),
            },
            {
                "metric": "slo_ok",
                "before": self.before.get("slo_ok"),
                "after": after.get("slo_ok"),
            },
        ]
        if steady_diff is not None:
            bf = self.before.get("steady_fractions")
            af = after.get("steady_fractions")
            if bf and af:
                diff = steady_diff(bf, af, noise_floor=noise_floor)
                evidence += [
                    r.to_dict() if hasattr(r, "to_dict") else dict(r)
                    for r in (diff.get("rows") or [])[:4]
                ]
        keep = not slo_bad and after_qpc >= floor
        if keep:
            self.state = "kept"
            self.reason = (
                f"qps/chip {after_qpc:.3f} >= floor {floor:.3f} "
                f"({before_chips}->{after_chips} chips) and SLO healthy"
            )
            return "keep", evidence
        self.state = "reverted"
        self.reason = (
            "SLO breached after absorb"
            if slo_bad
            else f"qps/chip {after_qpc:.3f} < floor {floor:.3f} "
            f"({before_chips}->{after_chips} chips)"
        )
        return "revert", evidence


def _steady_seconds(fractions_or_seconds: dict | None) -> float:
    from distributed_training_pytorch_tpu_torch.telemetry import doctor as doctor_lib

    if not fractions_or_seconds:
        return 0.0
    return sum(
        float(v)
        for b, v in fractions_or_seconds.items()
        if b not in doctor_lib._EXCLUDED
    )


class RunPolicy:
    """The per-run decision state machine (see module doc).

    ``knobs`` seeds the current tunable-knob values (the spawn spec's
    ``prefetch_batches`` / ``commit_delay_s``); ``steady_diff`` is the A/B
    judge — ``scripts/torch_fleet_controller.py`` passes ``torch_run_
    compare.steady_diff`` so the controller's verdict is computed by literally the
    operator's comparison code; tests may pass a stub. It is called as
    ``steady_diff(before_fractions, after_fractions, noise_floor=...)``
    (steady fractions are a fixed point of ``steady_fractions``, so
    fraction dicts feed the seconds-shaped signature unchanged).

    Protocol per poll::

        action = policy.decide(status, proc_running=..., exit_code=...,
                               now=...)
        if action:  # execute it (kill/respawn/emit), then:
            policy.note_applied(action, now=...)

    ``decide`` never returns a second action while one awaits
    ``note_applied`` (the never-two-concurrent-actions rule).
    """

    def __init__(
        self,
        config: ControllerConfig | None = None,
        *,
        knobs: dict | None = None,
        steady_diff=None,
    ):
        self.config = config or ControllerConfig()
        self.knobs = dict(knobs or {})
        self._steady_diff = steady_diff
        self.restarts_used = 0
        self.gave_up = False
        self._pending: Action | None = None
        self._next_allowed = 0.0  # monotonic gate: backoff between actions
        self._backoff = float(self.config.backoff_s)
        self._confirm: dict[str, int] = {}
        # One tune per disease kind; a reverted kind that recurs => give_up.
        self._tuned: dict[str, str] = {}  # reason -> "applied"|"kept"|"reverted"
        self._ab: dict | None = None  # in-flight A/B: knob, bucket, before, ...
        self.excluded_chips: list[int] = []
        self._acted_attempt: int | None = None  # attempt id at decision time
        self._ab_before: dict | None = None  # newest pre-tune steady fractions
        # Attempt id the last RESPAWN acted on: verdict-driven actions
        # (straggler exclusion, knob tunes) stay gated until the monitor
        # reports an attempt PAST it — the stale status between the kill
        # and the new attempt's run_start must not re-fire the same
        # disease and burn the budget on one incident.
        self._respawn_attempt: int | None = None

    # -- helpers -----------------------------------------------------------

    def _confirmed(self, key: str, firing: bool) -> bool:
        """Debounce: ``key``'s condition must hold ``confirm_polls``
        consecutive decide() calls. Counters for quiet keys reset, so an
        intermittent blip never accumulates to a trigger."""
        if not firing:
            self._confirm[key] = 0
            return False
        self._confirm[key] = self._confirm.get(key, 0) + 1
        return self._confirm[key] >= max(1, int(self.config.confirm_polls))

    def _budgeted(self, reason: str, evidence: list, build) -> Action:
        """Gate a respawn through the max-restarts budget: a zero budget
        refuses, an exhausted one gives up — each recorded once, then the
        policy is silent (the run surfaces as dead/degraded)."""
        cfg = self.config
        if cfg.max_restarts <= 0:
            self.gave_up = True
            return Action(
                "refuse",
                reason,
                message="max_restarts=0: controller is forbidden to act",
                params={"restarts_used": self.restarts_used,
                        "max_restarts": cfg.max_restarts},
                evidence=evidence,
            )
        if self.restarts_used >= cfg.max_restarts:
            self.gave_up = True
            return Action(
                "give_up",
                reason,
                message=(
                    f"restart budget exhausted "
                    f"({self.restarts_used}/{cfg.max_restarts}) — surfacing "
                    "to a human"
                ),
                params={"restarts_used": self.restarts_used,
                        "max_restarts": cfg.max_restarts},
                evidence=evidence,
            )
        return build()

    @staticmethod
    def _verdict_evidence(status, kind: str) -> list:
        diag = getattr(status, "diagnosis", None)
        if diag is None:
            return []
        for v in diag.verdicts:
            if v.kind == kind:
                return [dict(r) for r in v.evidence]
        return []

    @staticmethod
    def _alert_evidence(status, rule: str) -> list:
        """The debounced alert's own row (it carries measured value vs
        threshold) — the firing poll's record if present, else a synthetic
        row from the current fractions."""
        for a in getattr(status, "alerts", None) or []:
            if a.get("rule") == rule:
                return [dict(a)]
        return []

    # -- the decision ------------------------------------------------------

    def decide(
        self,
        status,
        *,
        proc_running: bool,
        exit_code: int | None,
        now: float,
    ) -> Action | None:
        """One poll's decision for one run. ``status`` is the monitor's
        :class:`~.monitor.MonitorStatus`; ``proc_running``/``exit_code``
        describe the supervised subprocess (``exit_code`` None while
        running or when the run is adopted); ``now`` is the controller's
        monotonic clock. A returned action is marked in flight — decide()
        stays silent until :meth:`note_applied` releases it."""
        self.note_status(status)
        action = self._decide(
            status, proc_running=proc_running, exit_code=exit_code, now=now
        )
        if action is not None:
            self._pending = action
        return action

    def _decide(
        self,
        status,
        *,
        proc_running: bool,
        exit_code: int | None,
        now: float,
    ) -> Action | None:
        if self.gave_up:
            return None
        if self._pending is not None:
            return None  # never two concurrent actions on one run
        finished_clean = (
            status.status == "finished"
            and not proc_running
            and (exit_code in (None, 0))
        )
        if finished_clean:
            return self._judge_ab(status, now, final=True)
        if now < self._next_allowed:
            return None  # backoff: the last action is still proving itself

        # 1) Dead: the process exited abnormally (definitive — no debounce)
        #    or the log went silent / the main thread hung past the
        #    monitor's ceilings (debounced).
        proc_dead = not proc_running and exit_code not in (None, 0)
        if proc_dead or self._confirmed(
            "dead", status.status in ("dead", "stale_heartbeat")
        ):
            reason = "dead" if proc_dead or status.status == "dead" else (
                "stale_heartbeat"
            )
            evidence = [
                {
                    "metric": "exit_code" if proc_dead else "last_event_age_s",
                    "value": exit_code if proc_dead else status.last_event_age_s,
                }
            ]
            evidence += self._alert_evidence(status, reason)
            return self._budgeted(
                reason,
                evidence,
                lambda: Action(
                    "restart",
                    reason,
                    message="respawning; trainer resumes from latest_valid",
                    evidence=evidence,
                ),
            )

        # A respawn's remediation is unproven until the NEW attempt
        # reports: everything below keys off verdicts/alerts, and the
        # status in hand may still describe the attempt we just replaced.
        if (
            self._respawn_attempt is not None
            and (getattr(status, "attempt", None) or 0) <= self._respawn_attempt
        ):
            return None

        # 2) In-flight A/B verdict (before any new tune/exclude is weighed).
        ab_action = self._judge_ab(status, now, final=False)
        if ab_action is not None:
            return ab_action

        # 3) Persistent straggler WITH a named chip -> exclude-and-replan.
        diag = getattr(status, "diagnosis", None)
        strag = None
        if diag is not None:
            for v in diag.verdicts:
                if v.kind == "straggler" and v.score >= 1.0:
                    strag = v
                    break
        chip = getattr(diag.signals, "slowest_chip", None) if diag else None
        if self._confirmed("straggler", strag is not None and chip is not None):
            evidence = [dict(r) for r in strag.evidence]
            chip = int(chip)

            def build():
                return Action(
                    "restart_excluding",
                    "straggler",
                    message=f"excluding degraded chip {chip} and re-planning "
                    "onto the survivors",
                    params={"exclude_chip": chip,
                            "excluded_chips": self.excluded_chips + [chip]},
                    evidence=evidence,
                )

            return self._budgeted("straggler", evidence, build)

        # 4) Persistent tunable-fraction alerts -> ONE bounded knob change.
        active = set(getattr(status, "active_alerts", None) or ())
        for reason, spec in _TUNES.items():
            if not self._confirmed(reason, reason in active):
                continue
            if self._ab is not None:
                continue  # one knob experiment at a time
            state = self._tuned.get(reason)
            evidence = self._alert_evidence(status, reason) or [
                {
                    "metric": f"{spec['bucket']}_frac_steady",
                    "value": (status.steady_fractions or {}).get(
                        spec["bucket"]
                    ),
                }
            ]
            if state in ("reverted", "kept"):
                # The one bounded change was already tried: a reverted
                # disease recurring has no further automatic cure; a kept
                # one recurring means the cure did not hold. Either way —
                # a human's turn.
                self.gave_up = True
                return Action(
                    "give_up",
                    reason,
                    message=f"knob {spec['knob']} already {state} — no "
                    "further automatic remediation",
                    params={"knob": spec["knob"], "state": state},
                    evidence=evidence,
                )
            change = self._plan_tune(reason, spec)
            if change is None:
                continue  # knob unknown or already at its bound

            def build_tune(change=change, reason=reason, evidence=evidence):
                return Action(
                    "tune",
                    reason,
                    message=f"{change['knob']} {change['from']} -> "
                    f"{change['to']} (bounded; A/B-judged before keeping)",
                    params=change,
                    evidence=evidence,
                )

            return self._budgeted(reason, evidence, build_tune)
        return None

    def _plan_tune(self, reason: str, spec: dict) -> dict | None:
        cfg = self.config
        knob = spec["knob"]
        if knob not in self.knobs:
            return None
        cur = self.knobs[knob]
        if knob == "prefetch_batches":
            to = int(cfg.max_prefetch)
            if int(cur) >= to:
                return None  # already at the bound — nothing left to try
        else:  # commit_delay_s
            to = float(cfg.commit_delay_to)
            if float(cur) <= to:
                return None
        return {"knob": knob, "from": cur, "to": to, "bucket": spec["bucket"]}

    def _judge_ab(self, status, now: float, *, final: bool) -> Action | None:
        """The tune's A/B verdict: once the tuned attempt accrued enough
        steady wall (or the run finished), diff its steady fractions
        against the pre-tune attempt's through the injected
        ``steady_diff`` (torch_run_compare's). Improved and under the noise
        floor-adjusted ceiling => keep; else revert (one respawn)."""
        ab = self._ab
        if ab is None:
            return None
        attempt = getattr(status, "attempt", None)
        if attempt is not None and attempt <= ab["since_attempt"] and not final:
            return None  # the monitor has not seen the tuned attempt yet
        after = dict(status.steady_fractions or {})
        if not final:
            diag = getattr(status, "diagnosis", None)
            sig = getattr(diag, "signals", None) if diag else None
            accrued = _steady_seconds(getattr(sig, "goodput_seconds", None))
            if accrued < self.config.ab_min_steady_s:
                return None  # too little evidence to judge yet
        bucket = ab["bucket"]
        diff = None
        if self._steady_diff is not None and any(after.values()):
            diff = self._steady_diff(
                ab["before"], after, noise_floor=self.config.ab_noise_floor
            )
        before_frac = float(ab["before"].get(bucket, 0.0))
        after_frac = float(after.get(bucket, 0.0))
        improved = after_frac < before_frac and ab["reason"] not in set(
            getattr(status, "active_alerts", None) or ()
        )
        evidence = [
            {
                "metric": f"{bucket}_frac_steady",
                "before": round(before_frac, 4),
                "after": round(after_frac, 4),
            }
        ]
        if diff is not None:
            evidence += [
                r.to_dict() if hasattr(r, "to_dict") else dict(r)
                for r in diff["rows"][:4]
            ]
        reason = ab["reason"]
        knob = ab["knob"]
        self._ab = None
        if improved:
            self._tuned[reason] = "kept"
            return Action(
                "keep",
                reason,
                message=f"{knob}={self.knobs.get(knob)!r} kept: steady "
                f"{bucket} {before_frac:.0%} -> {after_frac:.0%}",
                params={"knob": knob, "value": self.knobs.get(knob)},
                evidence=evidence,
            )
        self._tuned[reason] = "reverted"
        if final:
            # The run already finished; respawning to revert would redo
            # completed work. Record the failed experiment only.
            return Action(
                "give_up",
                reason,
                message=f"{knob} tune did not improve steady {bucket} and "
                "the run finished — reverting is moot",
                params={"knob": knob, "from": self.knobs.get(knob),
                        "to": ab["old"]},
                evidence=evidence,
            )

        def build():
            return Action(
                "revert",
                reason,
                message=f"{knob} tune did not improve steady {bucket} "
                f"({before_frac:.0%} -> {after_frac:.0%}) — reverting to "
                f"{ab['old']!r}",
                params={"knob": knob, "from": self.knobs.get(knob),
                        "to": ab["old"], "bucket": bucket},
                evidence=evidence,
            )

        return self._budgeted(reason, evidence, build)

    # -- bookkeeping -------------------------------------------------------

    def note_decided(self, action: Action) -> None:
        """Mark ``action`` in flight (decide() returned it; the mechanism
        is about to execute). Called implicitly by decide() — split out
        only for tests that construct actions by hand."""
        self._pending = action

    def note_applied(self, action: Action, *, now: float) -> None:
        """The mechanism executed ``action``: consume budget, start the
        backoff window, update knob/exclusion state, reset debounce
        counters (the new attempt's recurrence must re-confirm from
        scratch)."""
        if self._pending is action or self._pending is None:
            self._pending = None
        if action.respawns:
            self.restarts_used += 1
            self._next_allowed = now + self._backoff
            self._backoff *= max(1.0, float(self.config.backoff_factor))
            self._respawn_attempt = self._acted_attempt
        self._confirm.clear()
        if action.kind == "tune":
            p = action.params
            self._ab = {
                "knob": p["knob"],
                "bucket": p["bucket"],
                "old": p["from"],
                "before": dict(getattr(self, "_ab_before", None) or {}),
                "reason": action.reason,
                "since_attempt": self._acted_attempt,
            }
            self._tuned[action.reason] = "applied"
            self.knobs[p["knob"]] = p["to"]
        elif action.kind == "revert":
            self.knobs[action.params["knob"]] = action.params["to"]
        elif action.kind == "restart_excluding":
            chip = int(action.params["exclude_chip"])
            if chip not in self.excluded_chips:
                self.excluded_chips.append(chip)

    def note_status(self, status) -> None:
        """Record the poll context actions will need (the acting attempt
        id and the pre-action steady fractions for the A/B's 'before'
        side). decide() calls this itself on every poll."""
        attempt = getattr(status, "attempt", None)
        if attempt is not None:
            self._acted_attempt = attempt
        if self._ab is None and any((status.steady_fractions or {}).values()):
            self._ab_before = dict(status.steady_fractions)
