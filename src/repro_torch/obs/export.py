"""Chrome/Perfetto ``trace_event`` JSON export (DESIGN.md §Telemetry).

A copy of ``repro/obs/export.py``, which needs no JAX: importing it would run the JAX
package's ``__init__``, so the port keeps its own.

Renders the tracer's drained event list into the JSON trace-event
format both ``chrome://tracing`` and https://ui.perfetto.dev open
directly.  Actors become processes (``pid`` + ``process_name``
metadata), tracks become threads (``tid`` + ``thread_name`` metadata),
so the async overlap the system is built around — engine step spans on
the rollout lane running *under* trainer step spans on the trainer
lane — is visible as overlapping slices on adjacent tracks.

Timestamps: the tracer records in its installed clock's units
(seconds, virtual seconds, or gateway ticks — DESIGN.md §Clock
domains); export scales uniformly to microseconds, so a tick-clock
trace reads as "1 tick == 1 µs" rather than being remapped to wall
time.

Validated by ``tools/trace_check.py`` (well-formed JSON, balanced
spans, per-track timestamp monotonicity) in the benchmark-smoke CI
lane.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from repro_torch.obs import trace as _trace

__all__ = ["to_trace_events", "chrome_trace", "write_trace"]

_US = 1_000_000.0  # tracer clock units (seconds) -> microseconds


def to_trace_events(events: List[list],
                    time_scale: float = _US) -> List[Dict[str, Any]]:
    """Convert drained tracer events to ``traceEvents`` dicts.

    ``events`` is the ``Tracer.drain()`` list:
    ``[ph, name, ts, dur_or_value, actor, track, args]``.
    """
    # stable sort by start time: per-thread buffers are individually
    # monotone, but two threads may share a track name — a global sort
    # makes per-(pid,tid) timestamp monotonicity unconditional.
    events = sorted(events, key=lambda e: e[2])
    pids: Dict[str, int] = {}
    tids: Dict[tuple, int] = {}
    out: List[Dict[str, Any]] = []

    def pid_of(actor: str) -> int:
        p = pids.get(actor)
        if p is None:
            p = pids[actor] = len(pids) + 1
            out.append({"name": "process_name", "ph": "M", "pid": p,
                        "tid": 0, "args": {"name": actor}})
        return p

    def tid_of(actor: str, track: str) -> tuple:
        key = (actor, track)
        t = tids.get(key)
        if t is None:
            t = tids[key] = len(tids) + 1
            out.append({"name": "thread_name", "ph": "M",
                        "pid": pid_of(actor), "tid": t,
                        "args": {"name": track}})
        return tids[key]

    for ph, name, ts, dv, actor, track, args in events:
        ev: Dict[str, Any] = {
            "name": name, "ph": ph,
            "ts": ts * time_scale,
            "pid": pid_of(actor),
            "tid": tid_of(actor, track),
        }
        if ph == "X":
            ev["dur"] = max(0.0, dv) * time_scale
            if args:
                ev["args"] = args
        elif ph == "i":
            ev["s"] = "t"                   # thread-scoped instant
            if args:
                ev["args"] = args
        elif ph == "C":
            ev["args"] = {"value": dv}
        out.append(ev)
    return out


def chrome_trace(events: List[list],
                 time_scale: float = _US) -> Dict[str, Any]:
    """Top-level Chrome trace object."""
    return {"traceEvents": to_trace_events(events, time_scale),
            "displayTimeUnit": "ms"}


def write_trace(path: str, events: Optional[List[list]] = None, *,
                time_scale: float = _US) -> str:
    """Drain the global tracer (unless ``events`` is given) and write a
    Perfetto-loadable JSON trace to ``path``.  Returns ``path``."""
    if events is None:
        events = _trace.get().drain()
    with open(path, "w", encoding="utf-8") as f:
        json.dump(chrome_trace(events, time_scale), f)
    return path
