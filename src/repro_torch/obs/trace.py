"""Low-overhead structured tracer (DESIGN.md §Telemetry).

A copy of ``repro/obs/trace.py``, which needs no JAX: importing it would run
the JAX package's ``__init__``, so the port keeps its own.  The
Perfetto export (``repro.obs.export``) is a later part of the port.

One process-global :class:`Tracer` records span / instant / counter
events into per-thread append-only buffers — no cross-thread lock on
the hot path, no allocation beyond the event record itself.  Each
event carries an *actor* (process-level attribution: ``train``,
``rollout-0``, ``gateway`` …) and a *track* (thread-level lane,
defaulting to the thread name), which map onto Perfetto's pid/tid
axes in :mod:`repro.obs.export`.

Clock domains (DESIGN.md §Clock domains): the tracer timestamps with
whatever zero-argument callable is installed — ``perf_counter`` by
default, the virtual-clock controller's ``clock`` attribute for
deterministic runs, the gateway's tick counter for offline serving —
so every executor traces in its own time base and the exported
timeline is internally consistent rather than wall-approximate.

Disabled-mode guarantee (DESIGN.md §Disabled-mode guarantee): when
``enabled`` is False, ``span()`` returns one shared no-op context
manager and ``instant()``/``counter()`` return before touching the
clock or any buffer.  The tracer allocates nothing, reads no clock,
and perturbs no RNG — which is what keeps trajectory and StepLog
goldens bit-for-bit identical with tracing off.

Span events are appended at *enter* time (their duration is patched in
at exit), so each thread's buffer is naturally monotone in start
timestamp — the property ``tools/trace_check.py`` validates per track.
"""
from __future__ import annotations

import threading
from time import perf_counter
from typing import Any, Callable, Dict, List, Optional

__all__ = ["Tracer", "get", "configure", "span", "instant", "counter"]

# Event record layout (a plain list — mutated in place at span exit):
#   [ph, name, ts, dur_or_value, actor, track, args]
# ph: "X" complete span | "i" instant | "C" counter sample.


class _NullSpan:
    """Shared no-op context manager returned while tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """Open span: appended to the buffer on enter, patched on exit."""
    __slots__ = ("_ev", "_clock")

    def __init__(self, ev: list, clock: Callable[[], float]):
        self._ev = ev
        self._clock = clock

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        self._ev[3] = self._clock() - self._ev[2]
        return False


class Tracer:
    """Structured event recorder with per-thread buffers.

    Thread buffers are registered under ``_reg_lock`` exactly once (on
    a thread's first event); every subsequent event is a lock-free
    ``list.append``.  ``drain()`` snapshots all buffers for export.
    """

    def __init__(self, *, enabled: bool = False,
                 clock: Optional[Callable[[], float]] = None,
                 actor: str = "main"):
        self.enabled = enabled
        self._clock: Callable[[], float] = clock or perf_counter
        self._actor = actor
        self._local = threading.local()
        self._reg_lock = threading.Lock()
        self._buffers: List[List[list]] = []

    # ---- configuration ----------------------------------------------------
    def configure(self, *, enabled: Optional[bool] = None,
                  clock: Optional[Callable[[], float]] = None,
                  actor: Optional[str] = None) -> "Tracer":
        if enabled is not None:
            self.enabled = enabled
        if clock is not None:
            self._clock = clock
        if actor is not None:
            self._actor = actor
        return self

    def set_clock(self, clock: Callable[[], float]) -> None:
        """Install the executor's time base (DESIGN.md §Clock domains)."""
        self._clock = clock

    def set_actor(self, actor: str) -> None:
        self._actor = actor

    def set_track(self, track: str) -> None:
        """Override this thread's lane name (defaults to thread name)."""
        self._buf()
        self._local.track = track

    # ---- recording --------------------------------------------------------
    def _buf(self) -> List[list]:
        buf = getattr(self._local, "buf", None)
        if buf is None:
            buf = []
            self._local.buf = buf
            self._local.track = threading.current_thread().name
            with self._reg_lock:
                self._buffers.append(buf)
        return buf

    def span(self, name: str, **args: Any):
        """Context manager timing a region.  Free when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        buf = self._buf()
        ev = ["X", name, self._clock(), 0.0, self._actor,
              self._local.track, args or None]
        buf.append(ev)
        return _Span(ev, self._clock)

    def instant(self, name: str, **args: Any) -> None:
        """Point event (admission, flip fence, preemption …)."""
        if not self.enabled:
            return
        self._buf().append(["i", name, self._clock(), 0.0, self._actor,
                            self._local.track, args or None])

    def counter(self, name: str, value: float) -> None:
        """Sampled series (staleness, backlog, reward mean …)."""
        if not self.enabled:
            return
        self._buf().append(["C", name, self._clock(), value, self._actor,
                            self._local.track, None])

    # ---- draining ---------------------------------------------------------
    def drain(self) -> List[list]:
        """Snapshot and clear all recorded events (per-track order is
        preserved; tracks are concatenated)."""
        with self._reg_lock:
            out: List[list] = []
            for buf in self._buffers:
                out.extend(buf)
                del buf[:]
            return out

    def event_count(self) -> int:
        with self._reg_lock:
            return sum(len(b) for b in self._buffers)


_GLOBAL = Tracer()


def get() -> Tracer:
    """The process-global tracer all instrumentation points share."""
    return _GLOBAL


def configure(**kw: Any) -> Tracer:
    """Configure the global tracer (see :meth:`Tracer.configure`)."""
    return _GLOBAL.configure(**kw)


def span(name: str, **args: Any):
    return _GLOBAL.span(name, **args)


def instant(name: str, **args: Any) -> None:
    _GLOBAL.instant(name, **args)


def counter(name: str, value: float) -> None:
    _GLOBAL.counter(name, value)


def snapshot_args() -> Dict[str, Any]:
    """Debug helper: current global tracer configuration."""
    return {"enabled": _GLOBAL.enabled, "actor": _GLOBAL._actor}
