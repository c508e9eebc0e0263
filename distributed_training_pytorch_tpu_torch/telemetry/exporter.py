"""In-process status exporter: ``/status`` JSON and ``/metrics`` Prometheus text.

Counterpart of ``distributed_training_pytorch_tpu/telemetry/exporter.py``, with the same
rendering rules and routes. ``Trainer(telemetry=Telemetry(export_port=...))`` starts one
:class:`StatusExporter` on rank 0; the server renders its own ``/metrics`` with
:func:`prometheus_text`.

* The loop is never blocked: the trainer builds a fresh snapshot dict at its existing
  sync points and swaps the reference; the HTTP threads only read the dict it points at.
* A taken port is a warning, not an error: the exporter disables itself and training
  goes on.
* The exporter reads host floats the telemetry already has, so a run with it is
  bit-equal to one without.

``port=0`` binds a free port; :attr:`StatusExporter.port` reads it back.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

from distributed_training_pytorch_tpu_torch.telemetry.events import _jsonable

__all__ = ["StatusExporter", "prometheus_text"]

# Prometheus metric-name charset ([a-zA-Z_:][a-zA-Z0-9_:]*); label names drop the colon.
_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_OK = re.compile(r"[^a-zA-Z0-9_]")

# The label name of each known dict-valued field (others take "key").
_DICT_LABELS = {
    "goodput_seconds": "bucket",
    "goodput_fractions": "bucket",
    "steady_fractions": "bucket",
    "anomaly_counts": "kind",
    "doctor_scores": "verdict",
}


def _metric_name(prefix: str, key: str) -> str:
    return f"{prefix}_{_NAME_OK.sub('_', str(key))}"


def _fmt(value) -> str:
    # Prometheus floats: repr round-trips exactly; bools become 0/1.
    if isinstance(value, bool):
        return "1" if value else "0"
    return repr(float(value))


def _escape(value: str) -> str:
    # Prometheus label-value escaping: backslash first, then quotes.
    return str(value).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def prometheus_text(snapshot: dict, *, prefix: str = "tpu_trainer") -> str:
    """Render a status snapshot as Prometheus exposition text (v0.0.4).

    Numeric scalars become ``<prefix>_<key>`` gauges; dicts of numerics become one gauge
    per entry, labelled by ``_DICT_LABELS`` (``key`` for a field not in it); string fields collapse into ONE ``<prefix>_info`` gauge
    carrying them as labels. Other leaves are skipped, so an unknown field never fails
    a scrape."""
    lines: list[str] = []
    info_labels: list[tuple[str, str]] = []
    for key in sorted(snapshot):
        value = snapshot[key]
        if isinstance(value, str):
            info_labels.append((_LABEL_OK.sub("_", key), value))
            continue
        if isinstance(value, bool) or isinstance(value, (int, float)):
            name = _metric_name(prefix, key)
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {_fmt(value)}")
            continue
        if isinstance(value, dict):
            label = _DICT_LABELS.get(key, "key")
            name = _metric_name(prefix, key)
            samples = []
            for k in sorted(value, key=str):
                v = value[k]
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    samples.append(f'{name}{{{label}="{_escape(k)}"}} {_fmt(v)}')
            if samples:
                lines.append(f"# TYPE {name} gauge")
                lines.extend(samples)
    if info_labels:
        name = f"{prefix}_info"
        rendered = ",".join(f'{k}="{_escape(v)}"' for k, v in info_labels)
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name}{{{rendered}}} 1")
    up = f"{prefix}_up"
    lines.append(f"# TYPE {up} gauge")
    lines.append(f"{up} 1")
    return "\n".join(lines) + "\n"


class StatusExporter:
    """Serve ``snapshot_fn()`` over HTTP from a daemon thread: ``GET /status`` (and ``/``)
    as JSON, ``GET /metrics`` as Prometheus text, anything else 404. ``snapshot_fn`` is
    called on the HTTP thread and must be cheap and read-only; an exception in it is a
    500, never a crash of the server."""

    def __init__(self, snapshot_fn: Callable[[], dict], port: int, *, host: str = "0.0.0.0",
                 prefix: str = "tpu_trainer", log=None):
        self.enabled = False
        self._server: "ThreadingHTTPServer | None" = None
        self._thread: "threading.Thread | None" = None
        self.port = None
        self._prefix = prefix
        exporter = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # noqa: D102 - a scraper must not spam the console
                pass

            def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler's name
                route = self.path.split("?", 1)[0].rstrip("/") or "/status"
                try:
                    snapshot = snapshot_fn() or {}
                except Exception as e:  # noqa: BLE001 - a snapshot bug is a 500
                    self._respond(500, "text/plain", f"snapshot failed: {e}\n")
                    return
                if route in ("/status", "/"):
                    self._respond(200, "application/json", json.dumps(_jsonable(snapshot)) + "\n")
                elif route == "/metrics":
                    self._respond(200, "text/plain; version=0.0.4; charset=utf-8",
                                  prometheus_text(snapshot, prefix=exporter._prefix))
                else:
                    self._respond(404, "text/plain", "try /status or /metrics\n")

            def _respond(self, code: int, ctype: str, body: str):
                try:
                    payload = body.encode("utf-8")
                    self.send_response(code)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                except OSError:
                    pass  # the client went away

        warn = log if log is not None else _default_warn
        try:
            self._server = ThreadingHTTPServer((host, int(port)), _Handler)
        except OSError as e:
            warn(f"status exporter disabled — could not bind {host}:{port} ({e}); training continues without /status")
            return
        self._server.daemon_threads = True
        self.port = int(self._server.server_address[1])
        self._thread = threading.Thread(target=self._server.serve_forever, name="status-exporter", daemon=True)
        self._thread.start()
        self.enabled = True

    def close(self) -> None:
        """Stop serving and release the port (idempotent)."""
        if self._server is not None:
            try:
                self._server.shutdown()
                self._server.server_close()
            except OSError:
                pass
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self.enabled = False

    def __enter__(self) -> "StatusExporter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _default_warn(msg: str) -> None:
    import warnings

    warnings.warn(msg)
