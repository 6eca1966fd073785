"""Exporters: Chrome trace-event JSON for spans, flat JSON for metrics.

``chrome_trace(tracer)`` renders the recorded spans in the Chrome
trace-event format (which Perfetto and ``chrome://tracing`` load): one
``"ph": "X"`` complete event per span with microsecond ``ts``/``dur``
relative to the tracer origin, process and thread ``"M"`` metadata
events, and ``"ph": "i"`` events for instants.  Each event's ``args``
carry the span's ``id``, ``parent`` and ``root`` beside its attributes.

``write_metrics(path)`` dumps one flat ``{name: scalar}`` snapshot of the
registry (:meth:`MetricsRegistry.snapshot`), so the file diffs cleanly
across runs.
"""

from __future__ import annotations

import json

from .metrics import MetricsRegistry, get_registry
from .trace import Tracer, get_tracer

__all__ = [
    "chrome_trace",
    "write_chrome_trace",
    "write_metrics",
]

_PID = 1  # single-process system; one process row in the UI


def chrome_trace(tracer: Tracer | None = None) -> dict:
    """The trace as a JSON-ready dict (Chrome trace-event format)."""
    tracer = tracer if tracer is not None else get_tracer()
    tids: dict[int, int] = {}
    events: list[dict] = [
        {
            "ph": "M",
            "pid": _PID,
            "tid": 0,
            "name": "process_name",
            "args": {"name": "repro_torch"},
        }
    ]
    for rec in tracer.sorted_events():
        tid = tids.get(rec.tid)
        if tid is None:
            tid = tids[rec.tid] = len(tids)
            events.append(
                {
                    "ph": "M",
                    "pid": _PID,
                    "tid": tid,
                    "name": "thread_name",
                    "args": {"name": f"host-{tid}"},
                }
            )
        ts_us = (rec.start_ns - tracer.origin_ns) / 1e3
        ev = {
            "name": rec.name,
            "cat": rec.name.split(".", 1)[0],
            "pid": _PID,
            "tid": tid,
            "ts": ts_us,
        }
        if rec.dur_ns < 0:
            ev["ph"] = "i"
            ev["s"] = "t"  # thread-scoped instant
        else:
            ev["ph"] = "X"
            ev["dur"] = rec.dur_ns / 1e3
        ev["args"] = dict(rec.args, id=rec.id, parent=rec.parent, root=rec.root)
        events.append(ev)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "origin_unix_s": tracer.origin_unix_s,
            "dropped_events": tracer.dropped,
            "misnested_spans": tracer.misnested,
        },
    }


def write_chrome_trace(path: str, tracer: Tracer | None = None) -> int:
    """Write the trace JSON; returns the number of span/instant events
    (metadata events excluded)."""
    doc = chrome_trace(tracer)
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return sum(1 for e in doc["traceEvents"] if e["ph"] != "M")


def write_metrics(
    path: str,
    registry: MetricsRegistry | None = None,
    prefix: str = "",
) -> dict:
    """Write (and return) a flat metrics snapshot as JSON."""
    registry = registry if registry is not None else get_registry()
    snap = registry.snapshot(prefix)
    with open(path, "w") as fh:
        json.dump(snap, fh, indent=2, sort_keys=True, default=float)
        fh.write("\n")
    return snap
