"""Backpressure-aware retry client for the serving fleet.

A copy of ``distributed_training_pytorch_tpu/serving/client.py`` (the port imports
nothing of the JAX package).

The degradation contract on the server side is *typed* refusal: an
overloaded tenant gets 429, a draining/re-planning replica gets 503, and
both carry a ``Retry-After`` header derived from live queue depth and
the drain deadline (``InferenceServer.retry_after_s``). This module is
the caller's half of that contract — the part that makes a degraded
window *survivable* instead of merely observable:

* **Honor ``Retry-After`` first.** When the server says when to come
  back, believe it: the delay for that attempt is
  ``max(Retry-After, backoff)``. The server computed it from queue depth
  and the remaining drain deadline; the client's exponential guess is a
  fallback, not an override.
* **Jittered exponential backoff** otherwise: ``base * 2**attempt``
  capped at ``max_delay_s``, multiplied by a uniform jitter in
  ``[1 - jitter, 1 + jitter]`` so a fleet of callers released by the
  same drain does not re-stampede the replica in lockstep (the classic
  thundering-herd failure the drain itself just avoided).
* **Bounded attempts, typed give-up.** After ``max_attempts`` the
  client raises :class:`RetriesExhausted` carrying every attempt's
  status/delay — a caller distinguishes "the fleet is degraded, here is
  the evidence" from a silent hang or an untyped stack trace.
* **Only retry what retrying can fix**: 429/503 (admission pushback)
  and transport-level connection errors (replica mid-restart). A 400 is
  the caller's bug and a 500 is the server's; both surface immediately.

Pure stdlib (urllib), injectable transport/sleep/rng/clock — the policy
is unit-testable without a socket (tests/test_torch_serving.py).
"""

from __future__ import annotations

import json
import random
import time
import urllib.error
import urllib.request

__all__ = ["RetriesExhausted", "RetryClient"]

# HTTP statuses that mean "come back later", not "you are wrong": the
# bounded-queue 429 and the draining/re-planning 503. Everything else is
# terminal for the request as submitted.
RETRYABLE_STATUSES = (429, 503)


class RetriesExhausted(RuntimeError):
    """Every bounded attempt was refused: the typed give-up. ``attempts``
    is a list of ``{"status", "retry_after_s", "slept_s", "error"}`` dicts,
    one per try in order — the evidence a caller
    needs to tell a correctly-degraded fleet from a broken one."""

    def __init__(self, url: str, attempts: "list[dict]"):
        statuses = [a.get("status") or a.get("error") for a in attempts]
        super().__init__(
            f"{len(attempts)} attempts to {url} all refused ({statuses}): "
            "giving up"
        )
        self.url = url
        self.attempts = attempts


class RetryClient:
    """POST JSON with jittered-exponential retry honoring ``Retry-After``
    (see module doc). ``transport(url, body_bytes, timeout) -> (status,
    body_bytes, headers_dict)`` is injectable for tests; the default uses
    urllib and maps ``HTTPError`` into the same triple so 4xx/5xx are
    *data* here, not exceptions."""

    def __init__(
        self,
        *,
        max_attempts: int = 6,
        base_delay_s: float = 0.05,
        max_delay_s: float = 2.0,
        jitter: float = 0.25,
        timeout_s: float = 10.0,
        transport=None,
        sleep=time.sleep,
        rng: "random.Random | None" = None,
    ):
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        if not (0.0 <= jitter < 1.0):
            raise ValueError(f"jitter must be in [0, 1), got {jitter}")
        self.max_attempts = int(max_attempts)
        self.base_delay_s = float(base_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.jitter = float(jitter)
        self.timeout_s = float(timeout_s)
        self._transport = transport or self._urllib_transport
        self._sleep = sleep
        self._rng = rng or random.Random()
        # -- counters ----------------------------------------------------
        self.requests = 0  # logical requests (post_json calls)
        self.attempts_total = 0  # physical HTTP attempts
        self.retries = 0  # attempts beyond the first
        self.gave_up = 0  # RetriesExhausted raised

    # -- transport ---------------------------------------------------------

    def _urllib_transport(self, url: str, body: bytes, timeout: float):
        req = urllib.request.Request(
            url, data=body, headers={"Content-Type": "application/json"}
        )
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return resp.status, resp.read(), dict(resp.headers)
        except urllib.error.HTTPError as e:
            # 4xx/5xx carry a body and headers we need (Retry-After!):
            # surface them as data, same shape as a 200.
            return e.code, e.read(), dict(e.headers)

    # -- policy ------------------------------------------------------------

    def _backoff_s(self, attempt: int) -> float:
        raw = min(self.max_delay_s, self.base_delay_s * (2.0 ** attempt))
        if self.jitter:
            raw *= 1.0 + self._rng.uniform(-self.jitter, self.jitter)
        return max(0.0, raw)

    @staticmethod
    def _retry_after(headers: dict) -> "float | None":
        for key, value in (headers or {}).items():
            if str(key).lower() == "retry-after":
                try:
                    return max(0.0, float(value))
                except (TypeError, ValueError):
                    return None
        return None

    # -- the call ----------------------------------------------------------

    def post_json(self, url: str, payload: dict) -> "tuple[int, dict]":
        """POST ``payload`` as JSON, retrying 429/503 and connection
        errors per the module-doc policy. Returns ``(status, body_dict)``
        for any non-retryable outcome (including 400/500 — the caller
        decides what those mean); raises :class:`RetriesExhausted` when
        every bounded attempt was refused."""
        body = json.dumps(payload).encode()
        self.requests += 1
        attempts: "list[dict]" = []
        for attempt in range(self.max_attempts):
            self.attempts_total += 1
            if attempt:
                self.retries += 1
            try:
                status, raw, headers = self._transport(url, body, self.timeout_s)
            except (urllib.error.URLError, ConnectionError, OSError) as e:
                # Replica mid-restart / socket refused: retryable, but
                # there is no server-supplied Retry-After to honor.
                delay = self._backoff_s(attempt)
                attempts.append(
                    {
                        "status": None,
                        "error": f"{type(e).__name__}: {e}",
                        "retry_after_s": None,
                        "slept_s": round(delay, 4),
                    }
                )
                if attempt + 1 < self.max_attempts:
                    self._sleep(delay)
                continue
            if status not in RETRYABLE_STATUSES:
                try:
                    parsed = json.loads(raw.decode() or "{}")
                except (ValueError, UnicodeDecodeError):
                    parsed = {"raw": raw.decode(errors="replace")}
                return status, parsed
            retry_after = self._retry_after(headers)
            delay = self._backoff_s(attempt)
            if retry_after is not None:
                delay = max(delay, retry_after)
            attempts.append(
                {
                    "status": int(status),
                    "error": None,
                    "retry_after_s": retry_after,
                    "slept_s": round(delay, 4),
                }
            )
            if attempt + 1 < self.max_attempts:
                self._sleep(delay)
        self.gave_up += 1
        raise RetriesExhausted(url, attempts)
