"""HTTP inference server: one replica on one card.

Counterpart of ``distributed_training_pytorch_tpu/serving/server.py``: a stdlib
``ThreadingHTTPServer`` on daemon threads serving

* ``POST /predict`` — admit a request into the continuous micro-batcher
  (:mod:`.batcher`), block the handler thread until its batch completes, answer with
  the outputs and the params version they were computed on. A full tenant queue answers
  HTTP 429 with the typed overload facts and a ``Retry-After`` header; malformed input
  400; a failed batch 500; a request that outlives ``request_timeout_s`` 504.
* ``GET /status``  — one JSON snapshot: p50/p99 latency, QPS and QPS/chip, params
  version, swap/reject/batch counters, SLO verdict.
* ``GET /metrics`` — the same snapshot as Prometheus text (``tpu_serve_`` prefix, the
  JAX server's names, so one scrape config reads both).
* ``POST /admin/offer`` — the replica's half of the fleet controller's chip offer: accept
  unless draining or under SLO pressure.
* ``POST /admin/replan`` — :meth:`InferenceServer.drain_and_replan` onto
  ``{"device_ids": [...]}``: 200 with its summary; 409 while a drain is in progress; 400
  ``replan_failed`` for a target the replica cannot hold (an unknown device id, more
  devices than one process serves), refused before admission stops, the replica serving
  on.

Hot swap: with ``manager`` and ``target_state``, a watcher thread polls the checkpoint
directory every ``swap_poll_s``; when the followed name (``serve_name``, else ``best`` when
it exists, else the newest valid) commits a new manifest, it restores the params off the
request path (``InferEngine.restore_params``, which validates the manifest, so a torn
commit is never served) and flips them in. In-flight batches finish on the params they
started with.

Drain: a three-state admission machine, ``serving -> draining -> replanning -> serving``.
:meth:`InferenceServer.drain` stops admitting (a typed 503 with ``Retry-After``), flushes
the queue under a bounded deadline, and answers whatever is still queued past it with the
same 503; :meth:`InferenceServer.resume` re-opens admission. The watcher sits out every
state but ``serving``.

The server claims an attempt id and writes ``serve_start``, ``request_batch`` (a ~1 Hz
summary pulse that doubles as the liveness heartbeat, stamped with the admission state),
``admission_reject``, ``hot_swap``, ``drain_start``, ``replan_done``,
``offer_accept``/``offer_decline`` and ``run_end`` into ``<run_dir>/telemetry/events.jsonl``, with the JAX package's field
names.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from distributed_training_pytorch_tpu_torch.checkpoint.manager import MANIFEST_NAME
from distributed_training_pytorch_tpu_torch.serving.batcher import MicroBatcher, OverloadRejected
from distributed_training_pytorch_tpu_torch.telemetry.events import (
    EventLog,
    _jsonable,
    _process_index,
    claim_attempt,
    resolve_events_path,
)
from distributed_training_pytorch_tpu_torch.telemetry.exporter import prometheus_text

__all__ = ["InferenceServer", "LatencyWindow"]


class LatencyWindow:
    """Trailing-window latency/throughput accounting: completion times and
    per-request latencies over the last ``window_s`` seconds. p50/p99 by
    nearest-rank quantile on the live window."""

    def __init__(self, window_s: float = 30.0, clock=time.monotonic):
        self.window_s = float(window_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._done: list = []  # (t_done, latency_ms), trimmed on insert

    def add(self, t_done: float, latency_ms: float) -> None:
        with self._lock:
            self._done.append((t_done, latency_ms))
            cutoff = t_done - self.window_s
            if self._done and self._done[0][0] < cutoff:
                self._done = [d for d in self._done if d[0] >= cutoff]

    def snapshot(self, now: "float | None" = None) -> dict:
        now = self._clock() if now is None else now
        cutoff = now - self.window_s
        with self._lock:
            live = [d for d in self._done if d[0] >= cutoff]
        if not live:
            return {"qps": 0.0, "p50_ms": None, "p99_ms": None, "window_n": 0}
        lat = sorted(d[1] for d in live)
        span = min(self.window_s, max(now - live[0][0], 1e-6))

        def q(p: float) -> float:
            return lat[min(len(lat) - 1, int(p * len(lat)))]

        return {
            "qps": round(len(live) / span, 2),
            "p50_ms": round(q(0.50), 3),
            "p99_ms": round(q(0.99), 3),
            "window_n": len(lat),
        }


class InferenceServer:
    """One serving replica (see module doc).

    ``engine`` is a params-loaded :class:`~.engine.InferEngine`; ``manager`` (the port's
    ``CheckpointManager``) and ``target_state`` (a ``TrainState`` of the served model) arm
    the hot-swap watcher, and ``serve_name`` pins the name it follows. ``slo_p99_ms`` arms
    the SLO verdict on ``/status`` and the ``request_batch`` pulse. ``port=0`` binds an
    ephemeral port; read it back from :attr:`port`.
    """

    def __init__(
        self,
        engine,
        *,
        batcher: "MicroBatcher | None" = None,
        port: int = 0,
        host: str = "127.0.0.1",
        run_dir: "str | None" = None,
        manager=None,
        target_state=None,
        serve_name: "str | None" = None,
        swap_poll_s: float = 0.5,
        slo_p99_ms: "float | None" = None,
        window_s: float = 30.0,
        pulse_every_s: float = 1.0,
        request_timeout_s: float = 30.0,
        input_dtype: str = "float32",
        process_index: "int | None" = None,
        clock=time.monotonic,
        log=print,
    ):
        self.engine = engine
        # The default batcher shares the server's clock: Request.arrival and the
        # latency math in _dispatch_loop must read the same timebase.
        self.batcher = batcher if batcher is not None else MicroBatcher(
            buckets=engine.buckets, clock=clock
        )
        self._requested_port = int(port)
        self.host = host
        self.run_dir = run_dir
        self.manager = manager
        self.target_state = target_state
        self.serve_name = serve_name
        self.swap_poll_s = float(swap_poll_s)
        self.slo_p99_ms = slo_p99_ms
        self.pulse_every_s = float(pulse_every_s)
        self.request_timeout_s = float(request_timeout_s)
        self.input_dtype = np.dtype(input_dtype)
        self._clock = clock
        self._log = log
        self.window = LatencyWindow(window_s, clock=clock)
        self.port: "int | None" = None
        self.enabled = False
        self.attempt: "int | None" = None
        self._stop = threading.Event()
        self._threads: list = []
        self._server: "ThreadingHTTPServer | None" = None
        self._started = 0.0
        self.requests_total = 0
        # Admission state machine: "serving" admits; "draining" refuses while queued
        # batches flush under a bounded deadline; "replanning" refuses with dispatch
        # quiesced. Transitions happen under _lock; a stale read costs one extra 503.
        self.state = "serving"
        self._drain_deadline: "float | None" = None
        self._inflight = 0  # micro-batches executing in dispatch
        self.drain_count = 0
        self.shed_total = 0  # requests answered a drain-window 503
        self._swap_identity = None  # (name, manifest mtime) the engine serves
        self._warm_row = None  # the first served row: the post-replan warmup's signature
        self.swap_polls = 0  # the watcher's completed reads of the checkpoint directory
        self._reject_debounce: dict = {}  # tenant -> (last_emit_t, count_since)
        self._pulse_state = {"t": 0.0, "requests": 0, "batches": 0}
        self._lock = threading.Lock()
        self.process_index = int(_process_index() if process_index is None else process_index)
        self.events = None
        if run_dir is not None and self.process_index == 0:
            self.events = EventLog(resolve_events_path(run_dir), process_index=0)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "InferenceServer":
        """Bind, start the dispatch and HTTP threads, emit ``serve_start``. Only
        process 0 serves; other processes no-op with ``enabled=False``."""
        if self.process_index != 0:
            return self
        if self.run_dir is not None:
            self.attempt = claim_attempt(self.run_dir)
        server = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # noqa: D102 — silence stdlib logging
                pass

            def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
                route = self.path.split("?", 1)[0].rstrip("/") or "/status"
                snapshot = server.snapshot()
                if route in ("/status", "/"):
                    self._respond(200, "application/json", json.dumps(_jsonable(snapshot)) + "\n")
                elif route == "/metrics":
                    self._respond(
                        200,
                        "text/plain; version=0.0.4; charset=utf-8",
                        prometheus_text(
                            {k: v for k, v in snapshot.items() if v is not None},
                            prefix="tpu_serve",
                        ),
                    )
                else:
                    self._respond(404, "text/plain", "try /predict, /status or /metrics\n")

            def do_POST(self):  # noqa: N802 — BaseHTTPRequestHandler contract
                route = self.path.split("?", 1)[0].rstrip("/")
                handlers = {"/admin/offer": server.handle_offer, "/admin/replan": server.handle_replan}
                if route != "/predict" and route not in handlers:
                    self._respond(404, "text/plain", "POST /predict, /admin/offer or /admin/replan\n")
                    return
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    body = json.loads(self.rfile.read(length) or b"{}")
                    if route == "/predict":
                        tenant = str(body.get("tenant", "default"))
                        inputs = np.asarray(body["inputs"], dtype=server.input_dtype)
                    elif not isinstance(body, dict):
                        raise TypeError("the body must be a JSON object")
                except (AttributeError, KeyError, TypeError, ValueError) as e:
                    self._respond(
                        400, "application/json",
                        json.dumps({"error": "bad_request", "detail": str(e)}) + "\n",
                    )
                    return
                if route == "/predict":
                    code, payload, headers = server.handle_predict(tenant, inputs)
                else:
                    code, payload, headers = handlers[route](body)
                self._respond(code, "application/json", payload, headers)

            def _respond(self, code: int, ctype: str, body: str, headers=None):
                try:
                    payload = body.encode("utf-8")
                    self.send_response(code)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(payload)))
                    for key, value in (headers or {}).items():
                        self.send_header(key, str(value))
                    self.end_headers()
                    self.wfile.write(payload)
                except OSError:
                    pass  # client went away mid-response: its problem

        try:
            self._server = ThreadingHTTPServer((self.host, self._requested_port), _Handler)
        except OSError as e:
            # A taken port disables serving with one message: a port clash must be
            # diagnosable, not a crash loop.
            self._log(
                f"inference server disabled — could not bind "
                f"{self.host}:{self._requested_port} ({e})"
            )
            return self
        self._server.daemon_threads = True
        self.port = int(self._server.server_address[1])
        self._started = self._clock()
        self._pulse_state["t"] = self._started
        loops = [("serve-dispatch", self._dispatch_loop), ("serve-http", self._server.serve_forever)]
        if self.manager is not None and self.target_state is not None:
            # An engine already serving the candidate checkpoint (version "<name>@e<epoch>"
            # from restore_params) adopts its identity, so the watcher's first poll does
            # not restore it again and emit a hot_swap for params already served.
            if self._swap_identity is None and self.engine.params_version is not None:
                try:
                    cand = self._swap_candidate()
                except Exception:  # noqa: BLE001 — a racing commit: the watcher decides
                    cand = None
                if cand is not None and str(self.engine.params_version).startswith(f"{cand[0]}@"):
                    self._swap_identity = cand
            loops.append(("serve-hotswap", self._swap_loop))
        for name, fn in loops:
            t = threading.Thread(target=fn, name=name, daemon=True)
            t.start()
            self._threads.append(t)
        self.enabled = True
        if self.events is not None:
            self.events.emit(
                "serve_start",
                attempt=self.attempt,
                port=self.port,
                buckets=list(self.engine.buckets),
                max_delay_s=self.batcher.max_delay_s,
                max_queue_depth=self.batcher.max_queue_depth,
                slo_p99_ms=self.slo_p99_ms,
                params_version=self.engine.params_version,
                mesh_axes={"data": self.engine.chips},
            )
        return self

    def close(self) -> None:
        """Stop: shut the HTTP server, answer whatever is queued, join the threads,
        emit ``run_end``. Idempotent."""
        if self._stop.is_set():
            return
        self._stop.set()
        if self._server is not None:
            try:
                self._server.shutdown()
                self._server.server_close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=5.0)
        if self.events is not None and self.enabled:
            self.events.emit("run_end", attempt=self.attempt, kind="serve")
            self.events.close()
        self.enabled = False

    def __enter__(self) -> "InferenceServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- request path ------------------------------------------------------

    def retry_after_s(self) -> int:
        """Advisory seconds before a refused caller should retry (the ``Retry-After``
        on a 429 or 503), from live queue depth: pending rows over the largest bucket
        estimate the batches ahead, each costing about one admission window plus the
        trailing p50 service time. Mid-drain the drain's remaining time floors it."""
        depth = self.batcher.pending()
        win = self.window.snapshot()
        per_batch_s = self.batcher.max_delay_s + ((win["p50_ms"] or 0.0) / 1e3)
        est = ((depth // self.batcher.buckets[-1]) + 1) * per_batch_s
        dl = self._drain_deadline
        if self.state != "serving" and dl is not None:
            est = max(est, dl - self._clock())
        return max(1, math.ceil(est))

    def handle_predict(self, tenant: str, inputs: np.ndarray) -> "tuple[int, str, dict | None]":
        """Admit -> wait -> answer. Returns (HTTP code, JSON body, extra headers or
        None). The response body is a pure function of (inputs, served params): no
        timestamps or latencies in it. While the server drains, admission answers a typed
        503 with ``Retry-After``."""
        if inputs.ndim == 0 or inputs.shape[0] == 0:
            return 400, json.dumps({"error": "bad_request", "detail": "empty inputs"}) + "\n", None
        state = self.state
        if state != "serving":
            ra = self.retry_after_s()
            with self._lock:
                self.shed_total += 1
            self._note_reject(tenant, depth=self.batcher.pending(), bound=self.batcher.max_queue_depth,
                              reason=state, retry_after_s=ra)
            return 503, json.dumps(
                {"error": "draining", "state": state, "retry_after_s": ra}
            ) + "\n", {"Retry-After": str(ra)}
        try:
            # One request row per payload so the batcher's fairness applies per row,
            # admitted atomically: a 429 on a multi-row POST leaves no orphan rows.
            reqs = self.batcher.submit_many(tenant, list(inputs))
        except OverloadRejected as e:
            ra = self.retry_after_s()
            self._note_reject(e.tenant, depth=e.depth, bound=e.bound, reason="overload", retry_after_s=ra)
            return 429, json.dumps(
                {"error": "overload", "tenant": e.tenant, "depth": e.depth, "bound": e.bound}
            ) + "\n", {"Retry-After": str(ra)}
        deadline = self._clock() + self.request_timeout_s
        for req in reqs:
            if not req.wait(max(0.0, deadline - self._clock())):
                return 504, json.dumps({"error": "timeout"}) + "\n", None
            if req.error is not None:
                if req.error_code == 503:  # shed by a drain's deadline: typed, retryable
                    ra = self.retry_after_s()
                    return 503, json.dumps(
                        {"error": "draining", "state": self.state, "detail": req.error, "retry_after_s": ra}
                    ) + "\n", {"Retry-After": str(ra)}
                return 500, json.dumps(
                    {"error": "inference_failed", "detail": req.error}
                ) + "\n", None
        return 200, json.dumps(
            {
                "outputs": [np.asarray(r.result).tolist() for r in reqs],
                "params_version": reqs[-1].params_version,
            }
        ) + "\n", None

    def _note_reject(self, tenant: str, *, depth: int, bound: int, reason: str, retry_after_s: int) -> None:
        """``admission_reject`` events, debounced to one per tenant per second; the
        per-tenant counter in /status stays exact. ``reason`` is ``"overload"`` (429) or
        the admission state (503)."""
        if self.events is None:
            return
        now = self._clock()
        # Handler threads race here: the (last_emit_t, count) read-modify-write must be
        # atomic or debounced counts drop rejects.
        with self._lock:
            last_t, pent = self._reject_debounce.get(tenant, (0.0, 0))
            pent += 1
            emit = now - last_t >= 1.0
            self._reject_debounce[tenant] = (now, 0) if emit else (last_t, pent)
        if emit:
            self.events.emit(
                "admission_reject",
                attempt=self.attempt,
                tenant=tenant,
                depth=depth,
                bound=bound,
                reason=reason,
                retry_after_s=int(retry_after_s),
                rejects=pent,
                rejected_total=int(sum(self.batcher.rejected.values())),
            )

    # -- drain and the admin routes -----------------------------------------

    def drain(self, *, deadline_s: float = 10.0) -> dict:
        """Stop admitting and flush queued micro-batches under a bounded deadline. New
        requests get the typed 503 once the state flips; queued ones keep dispatching
        (partial batches flush at once while draining); whatever is still queued at the
        deadline is answered the same 503: shed, never dropped or hung. A batch already
        executing at the deadline completes (its rows answer 200). Leaves the server in
        ``"replanning"`` with dispatch quiesced until :meth:`resume`."""
        deadline_s = float(deadline_s)
        with self._lock:
            if self.state != "serving":
                raise RuntimeError(f"drain requested while already {self.state}")
            self.state = "draining"
            self._drain_deadline = self._clock() + deadline_s
            self.drain_count += 1
        t0 = self._clock()
        deadline = self._drain_deadline
        pending0 = self.batcher.pending()
        if self.events is not None:
            self.events.emit("drain_start", attempt=self.attempt, deadline_s=deadline_s, pending=pending0,
                             params_version=self.engine.params_version)
        while self._clock() < deadline:  # the dispatch loop empties the queue
            if self.batcher.pending() == 0 and self._inflight == 0:
                break
            self._stop.wait(0.001)
        with self._lock:
            self.state = "replanning"  # dispatch takes no more batches
        while self._inflight > 0 and not self._stop.is_set():  # a batch already taken finishes
            self._stop.wait(0.001)
        shed = 0
        batch = self.batcher.next_batch(drain=True)
        while batch is not None:
            for req in batch.requests:
                req.error = "drain deadline exceeded; replica re-planning"
                req.error_code = 503
                req.done.set()
                shed += 1
            batch = self.batcher.next_batch(drain=True)
        with self._lock:
            self.shed_total += shed
        return {"pending_at_drain": pending0, "shed": shed, "drain_ms": round((self._clock() - t0) * 1e3, 2)}

    def resume(self) -> None:
        """Re-open admission (state back to ``"serving"``). Idempotent."""
        with self._lock:
            self.state = "serving"
            self._drain_deadline = None

    def drain_and_replan(self, device_ids, *, deadline_s: float = 10.0) -> dict:
        """Solve the plan for ``device_ids`` (``parallel.elastic.replan``), drain under
        ``deadline_s``, rebind the engine (``InferEngine.replan_onto``), warm the buckets,
        resume and emit ``replan_done`` (JAX ``server.py:572-640``). Feasibility is
        checked before admission stops: an unknown device id, or more devices than this one
        process serves, raises ``ValueError`` with the replica serving its old plan
        untouched. On a failure after the drain the replica resumes on the old plan."""
        from distributed_training_pytorch_tpu_torch.parallel import elastic

        ids = sorted({int(d) for d in device_ids})
        if not ids:
            raise ValueError("replan target names no devices")
        visible = self.engine.visible_device_ids()
        unknown = [d for d in ids if d not in visible]
        if unknown:
            raise ValueError(f"replan target names unknown device id(s) {unknown} (this process sees {visible})")
        if len(ids) > 1:
            raise ValueError(f"replan target names {len(ids)} devices {ids}: one process of the port serves one "
                             "device (a replica a device)")
        old_axes = dict(self.engine.mesh_axes)
        plan = elastic.replan(old_axes, len(ids))  # {"data": 1} onto one device; its reason is JAX's plan_reason
        import torch

        kind = torch.device(self.engine.device).type
        device = torch.device(kind, ids[0]) if kind == "cuda" else torch.device(kind)
        t0 = self._clock()
        summary = self.drain(deadline_s=deadline_s)
        try:
            self.engine.replan_onto(device)
            if self._warm_row is not None:
                self.engine.warmup(self._warm_row)  # the first request after it pays nothing
        finally:
            self.resume()  # success or failure: a failed rebind left the old plan serving
        summary.update(state=self.state, device_ids=ids, mesh_axes=dict(plan.new_axes),
                       params_version=self.engine.params_version,
                       replan_ms=round((self._clock() - t0) * 1e3, 2), plan_reason=plan.reason)
        if self.events is not None:
            self.events.emit("replan_done", attempt=self.attempt, from_mesh=old_axes, to_mesh=summary["mesh_axes"],
                             device_ids=ids, shed=summary["shed"], replan_ms=summary["replan_ms"],
                             params_version=self.engine.params_version, replans=self.engine.replan_count,
                             plan_reason=plan.reason)
        return summary

    def handle_offer(self, body: dict) -> "tuple[int, str, dict | None]":
        """The replica's half of the chip-offer handshake: accept unless already draining
        or under SLO pressure (a replica breaching its p99 must not take a drain and a
        rebuild on top). The decision is emitted (``offer_accept`` / ``offer_decline``);
        accepting commits to nothing."""
        chip = body.get("chip")
        if not isinstance(chip, (int, float)):
            return 400, json.dumps({"error": "bad_request", "detail": "no chip in offer"}) + "\n", None
        chip = int(chip)
        win = self.window.snapshot()
        slo_ok = self._slo_ok(win)
        state = self.state
        if state != "serving":
            decision, reason = "decline", f"replica is {state}"
        elif slo_ok is False:
            decision, reason = "decline", f"under SLO pressure: p99 {win['p99_ms']}ms > {self.slo_p99_ms}ms"
        else:
            decision, reason = "accept", "healthy and serving"
        if self.events is not None:
            self.events.emit(
                "offer_accept" if decision == "accept" else "offer_decline",
                attempt=self.attempt, chip=chip, reason=reason, state=state, slo_ok=slo_ok,
                p99_ms=win["p99_ms"], pending=self.batcher.pending(),
            )
        return 200, json.dumps({"decision": decision, "chip": chip, "reason": reason}) + "\n", None

    def handle_replan(self, body: dict) -> "tuple[int, str, dict | None]":
        """``POST /admin/replan``: drain and re-plan onto ``body["device_ids"]``: 200 with
        the summary; 409 while a drain is in progress; 400 ``replan_failed`` (still serving
        the old plan) for an infeasible target."""
        device_ids = body.get("device_ids")
        if not isinstance(device_ids, (list, tuple)) or not device_ids:
            return 400, json.dumps({"error": "bad_request", "detail": "device_ids required"}) + "\n", None
        if self.state != "serving":
            ra = self.retry_after_s()
            return 409, json.dumps(
                {"error": "busy", "state": self.state, "retry_after_s": ra}
            ) + "\n", {"Retry-After": str(ra)}
        try:
            summary = self.drain_and_replan(device_ids, deadline_s=float(body.get("deadline_s", 10.0)))
        except Exception as e:  # noqa: BLE001 — a typed refusal, the old plan serving
            return 400, json.dumps(
                {"error": "replan_failed", "detail": f"{type(e).__name__}: {e}", "state": self.state}
            ) + "\n", None
        return 200, json.dumps(_jsonable(summary)) + "\n", None

    # -- dispatch loop -----------------------------------------------------

    def _dispatch_loop(self) -> None:
        while not self._stop.is_set():
            state = self.state
            if state == "replanning":
                # Quiesced: the drain owns the queue. Keep pulsing, so a monitor sees a
                # live replica.
                self._maybe_pulse()
                self._stop.wait(0.002)
                continue
            # While draining, flush partial batches at once: waiting out max_delay_s
            # inside a bounded drain window wastes it.
            batch = self.batcher.next_batch(drain=(state == "draining"))
            if batch is None:
                self._maybe_pulse()
                # Sleep to the earlier of the oldest request's flush deadline or a
                # 2 ms poll tick.
                dl = self.batcher.next_deadline()
                bound = 0.002 if dl is None else max(0.0, min(dl - self._clock(), 0.002))
                self._stop.wait(bound)
                continue
            with self._lock:
                self._inflight += 1
            # One batch can mix row shapes (two tenants posting different feature
            # lengths): group by row signature and run each group on its own, so the
            # stack cannot throw outside a try and kill this thread, and well-shaped rows
            # never fail for a neighbour's bad shape.
            groups: dict = {}
            for req in batch.requests:
                row = np.asarray(req.payload)
                groups.setdefault((row.shape, str(row.dtype)), []).append(req)
                if self._warm_row is None:
                    self._warm_row = row
            n_done = 0
            try:
                for reqs in groups.values():
                    try:
                        payloads = np.stack([np.asarray(r.payload) for r in reqs])
                        out, version = self.engine.predict(payloads)
                    except Exception as e:  # noqa: BLE001 — answered as 500s, server survives
                        for req in reqs:
                            req.error = f"{type(e).__name__}: {e}"
                            req.done.set()
                        self._log(f"inference batch failed: {type(e).__name__}: {e}")
                        continue
                    t_out = self._clock()
                    for i, req in enumerate(reqs):
                        req.result = out[i]
                        req.params_version = version
                        req.completed = t_out
                        self.window.add(t_out, (t_out - req.arrival) * 1e3)
                        req.done.set()
                    n_done += len(reqs)
            finally:
                with self._lock:
                    self._inflight -= 1
                    self.requests_total += n_done
                    self._pulse_state["requests"] += n_done
                    self._pulse_state["batches"] += 1
            self._maybe_pulse()
        # On shutdown, answer whatever is queued so no handler thread is left blocked
        # on a request that will never run.
        batch = self.batcher.next_batch(drain=True)
        while batch is not None:
            for req in batch.requests:
                req.error = "server shutting down"
                req.done.set()
            batch = self.batcher.next_batch(drain=True)

    def _maybe_pulse(self) -> None:
        """The ~1 Hz ``request_batch`` summary record: throughput/latency since the last
        pulse plus the trailing-window quantiles. Emitted even when idle: it doubles as
        the server's liveness heartbeat."""
        if self.events is None:
            return
        now = self._clock()
        with self._lock:
            if now - self._pulse_state["t"] < self.pulse_every_s:
                return
            since = now - self._pulse_state["t"]
            requests, batches = self._pulse_state["requests"], self._pulse_state["batches"]
            self._pulse_state.update(t=now, requests=0, batches=0)
        win = self.window.snapshot(now)
        chips = self.engine.chips
        self.events.emit(
            "request_batch",
            attempt=self.attempt,
            requests=requests,
            batches=batches,
            interval_s=round(since, 3),
            qps=win["qps"],
            qps_per_chip=round(win["qps"] / chips, 3),
            mesh_chips=chips,
            p50_ms=win["p50_ms"],
            p99_ms=win["p99_ms"],
            slo_p99_ms=self.slo_p99_ms,
            slo_ok=self._slo_ok(win),
            state=self.state,
            params_version=self.engine.params_version,
            rejected_total=int(sum(self.batcher.rejected.values())),
            shed_total=self.shed_total,
        )

    def _slo_ok(self, win: dict) -> "bool | None":
        if self.slo_p99_ms is None:
            return None
        if win["p99_ms"] is None:
            return True  # no traffic in the window: nothing breached
        return bool(win["p99_ms"] <= self.slo_p99_ms)

    # -- hot-swap watcher --------------------------------------------------

    def _swap_candidate(self) -> "tuple[str, float] | None":
        """(name, manifest mtime) of the checkpoint this replica should serve: the pinned
        ``serve_name``, else ``best`` when it exists, else the newest valid. The mtime is
        the commit's identity: the rename that publishes a checkpoint brings a new
        manifest."""
        name = self.serve_name
        if name is None:
            name = "best" if self.manager.exists("best") else self.manager.latest_valid_name()
        if name is None or not self.manager.exists(name):
            return None
        try:
            mtime = os.path.getmtime(os.path.join(self.manager.path(name), MANIFEST_NAME))
        except OSError:
            return None
        return (name, mtime)

    def _swap_loop(self) -> None:
        while not self._stop.wait(self.swap_poll_s):
            if self.state != "serving":
                # A commit landing mid-drain must not flip params; the candidate is read
                # from disk again on the first poll after resume, so nothing is missed.
                continue
            try:
                cand = self._swap_candidate()
            except Exception:  # noqa: BLE001 — a racing commit: retried next poll
                cand = None
            self.swap_polls += 1
            if cand is None or cand == self._swap_identity:
                continue
            before = self.engine.params_version
            t0 = self._clock()
            try:
                version = self.engine.restore_params(self.manager, self.target_state, name=cand[0])
            except Exception as e:  # noqa: BLE001 — serve the old params, retry next poll
                self._log(f"hot-swap restore failed (serving old params): {type(e).__name__}: {e}")
                continue
            with self._lock:
                self._swap_identity = cand
            if self.events is not None:
                self.events.emit(
                    "hot_swap", attempt=self.attempt, checkpoint=cand[0], from_version=before, to_version=version,
                    swap_ms=round((self._clock() - t0) * 1e3, 2), swaps=self.engine.swap_count,
                    pending_requests=self.batcher.pending(),
                )

    # -- status ------------------------------------------------------------

    def snapshot(self) -> dict:
        now = self._clock()
        win = self.window.snapshot(now)
        stats = self.batcher.stats()
        chips = self.engine.chips
        return {
            "kind": "server",
            "port": self.port,
            "attempt": self.attempt,
            "state": self.state,
            "uptime_s": round(now - self._started, 1) if self._started else 0.0,
            "params_version": self.engine.params_version,
            "swaps": self.engine.swap_count,
            "replans": self.engine.replan_count,
            "drains": self.drain_count,
            "shed_total": self.shed_total,
            "chips": chips,
            "device_ids": list(self.engine.device_ids),
            "device": str(self.engine.device),
            "requests_total": self.requests_total,
            "pending": stats["pending"],
            "rejected": stats["rejected"],
            "rejected_total": stats["rejected_total"],
            "batches": stats["batches"],
            "pad_frac": round(stats["pad_frac"], 4),
            "flushes": stats["flushes"],
            "qps": win["qps"],
            "qps_per_chip": round(win["qps"] / chips, 3),
            "p50_ms": win["p50_ms"],
            "p99_ms": win["p99_ms"],
            "slo_p99_ms": self.slo_p99_ms,
            "slo_ok": self._slo_ok(win),
            "trace_counts": dict(self.engine.trace_counts),
            "buckets": list(self.engine.buckets),
        }
