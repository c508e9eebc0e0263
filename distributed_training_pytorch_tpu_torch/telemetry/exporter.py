"""Prometheus exposition text of a status snapshot (the server's ``/metrics``).

Counterpart of ``prometheus_text`` in ``distributed_training_pytorch_tpu/telemetry/
exporter.py``, with the same rendering rules; the trainer's ``StatusExporter`` comes with
the trainer slice of the port.
"""

from __future__ import annotations

import re

__all__ = ["prometheus_text"]

# Prometheus metric-name charset ([a-zA-Z_:][a-zA-Z0-9_:]*); label names drop the colon.
_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_OK = re.compile(r"[^a-zA-Z0-9_]")


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
    per entry, labelled ``key``; string fields collapse into ONE ``<prefix>_info`` gauge
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
            name = _metric_name(prefix, key)
            samples = []
            for k in sorted(value, key=str):
                v = value[k]
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    samples.append(f'{name}{{key="{_escape(k)}"}} {_fmt(v)}')
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
