"""Bounded crash flight recorder (DESIGN.md §Flight-recorder protocol).

A copy of ``repro/obs/recorder.py``, which needs no JAX: importing it would run the JAX
package's ``__init__``, so the port keeps its own.

A :class:`FlightRecorder` keeps the last ``capacity`` notable events
(admissions, weight flips, drains, errors …) as small picklable
tuples.  It is always on — recording is a lock + deque append, cheap
enough to leave enabled in production — so the *recent past* of every
role survives a hang or a SIGKILL.

Shipping protocol (fleet): each worker process records locally and
piggybacks only the entries since its last heartbeat
(:meth:`drain_new`) on the existing heartbeat message over the fleet
``Transport`` — no new channel, no unbounded growth.  The supervisor
accumulates per-worker tails; when a worker is failed (missed
heartbeats, crash, SIGKILL) the tail is dumped to disk and the most
recent entries are embedded in any subsequent ``TimeoutError``
alongside the liveness table, so a dead run is diagnosable from the
exception alone.

Entry layout: ``(seq, ts, kind, info)`` with ``info`` a small dict of
picklable values.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["FlightRecorder", "Entry"]

Entry = Tuple[int, float, str, Dict[str, Any]]


class FlightRecorder:
    """Thread-safe bounded event tail with incremental draining."""

    def __init__(self, capacity: int = 256, *,
                 clock=time.monotonic):
        self.capacity = capacity
        self._clock = clock
        self._lock = threading.Lock()
        self._buf: deque = deque(maxlen=capacity)
        self._seq = 0
        self._shipped = 0                  # last seq handed to drain_new

    def record(self, kind: str, **info: Any) -> None:
        with self._lock:
            self._seq += 1
            self._buf.append((self._seq, self._clock(), kind, info))

    def extend(self, entries: List[Entry]) -> None:
        """Fold entries shipped from another process (heartbeat path);
        original seq/ts are preserved for forensics."""
        with self._lock:
            for e in entries:
                self._buf.append(tuple(e))
                self._seq = max(self._seq, int(e[0]))

    def drain_new(self) -> List[Entry]:
        """Entries recorded since the previous ``drain_new`` call (and
        still inside the capacity window) — the heartbeat payload."""
        with self._lock:
            out = [e for e in self._buf if e[0] > self._shipped]
            if out:
                self._shipped = out[-1][0]
            return out

    def tail(self, n: Optional[int] = None) -> List[Entry]:
        with self._lock:
            items = list(self._buf)
        return items if n is None else items[-n:]

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def format_tail(self, n: int = 12) -> str:
        """Human-readable one-liner for embedding in TimeoutError."""
        items = self.tail(n)
        if not items:
            return "(empty)"
        parts = []
        for _, ts, kind, info in items:
            kv = " ".join(f"{k}={v}" for k, v in info.items())
            parts.append(f"t={ts:.3f} {kind}" + (f" {kv}" if kv else ""))
        return " | ".join(parts)

    def dump(self, path: str) -> str:
        """Write the full tail as JSON (the on-disk crash dump)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        payload = [
            {"seq": s, "ts": ts, "kind": kind, "info": info}
            for s, ts, kind, info in self.tail()
        ]
        with open(path, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=1)
        return path
