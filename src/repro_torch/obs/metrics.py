"""Typed metrics registry (DESIGN.md §Metrics registry).

A copy of ``repro/obs/metrics.py``, which needs no JAX: importing it would run the JAX
package's ``__init__``, so the port keeps its own.

Counters, gauges, and fixed-bucket histograms behind stable dotted
names (``gateway.ttft``, ``scheduler.publication.latency_mean`` …).
The registry does not replace the existing ``stats()`` /
``publication_stats()`` / ``stream_stats()`` dict surfaces — it
*absorbs* them: :func:`MetricsRegistry.absorb` flattens any stats dict
under a dotted prefix, and :func:`scrape` is the one implementation of
the "union every stat surface this object exposes" glue that was
previously copy-pasted (``getattr(engine, "stream_stats", …)`` in
``core/fleet.py``, manual dict-unions in the launchers).

Two export formats: :meth:`MetricsRegistry.prometheus_text` renders
the Prometheus text exposition format served by ``GET /metrics`` on
``serve/http.py``, and :meth:`MetricsRegistry.snapshot` is the JSON
shape behind the launchers' ``--metrics-snapshot`` flag.

Every exported name is documented in the metric table in
``docs/OPERATIONS.md``.
"""
from __future__ import annotations

import json
import re
import threading
from bisect import bisect_left
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "LATENCY_BUCKETS_S", "TICK_BUCKETS", "scrape", "get",
]

# Fixed buckets for wall-clock latencies (seconds): spans TTFT/ITL on
# a CPU dev box (ms) through publication-to-pickup on a loaded fleet.
LATENCY_BUCKETS_S: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)

# Fixed buckets for tick-clock latencies (the offline gateway's
# deterministic time base: one pump() == one tick).
TICK_BUCKETS: Tuple[float, ...] = (1, 2, 4, 8, 16, 32, 64, 128, 256)

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(dotted: str) -> str:
    """`gateway.ttft` -> `repro_gateway_ttft` (Prometheus charset)."""
    return "repro_" + _NAME_OK.sub("_", dotted.replace(".", "_"))


class Counter:
    """Monotonically increasing count."""
    kind = "counter"
    __slots__ = ("name", "help", "_v", "_lock")

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._v = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> float:
        return self._v


class Gauge:
    """Last-write-wins sample (absorbed stats land here)."""
    kind = "gauge"
    __slots__ = ("name", "help", "_v")

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._v = 0.0

    def set(self, v: float) -> None:
        self._v = float(v)

    @property
    def value(self) -> float:
        return self._v


class Histogram:
    """Fixed-bucket histogram (cumulative counts, Prometheus-style).

    ``buckets`` are the ascending upper bounds; an implicit ``+Inf``
    bucket catches the tail.  ``observe`` is a bisect + two adds — safe
    to call per generated token.
    """
    kind = "histogram"
    __slots__ = ("name", "help", "buckets", "_counts", "_sum", "_n", "_lock")

    def __init__(self, name: str, buckets: Sequence[float],
                 help: str = ""):
        if list(buckets) != sorted(buckets):
            raise ValueError(f"histogram {name}: buckets must ascend")
        self.name, self.help = name, help
        self.buckets = tuple(float(b) for b in buckets)
        self._counts = [0] * (len(self.buckets) + 1)  # +Inf tail
        self._sum = 0.0
        self._n = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        # le semantics: v lands in the first bucket whose bound >= v
        i = bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._n += 1

    @property
    def count(self) -> int:
        return self._n

    @property
    def sum(self) -> float:
        return self._sum

    def cumulative(self) -> List[Tuple[float, int]]:
        """(upper_bound, cumulative_count) pairs, ending at +Inf."""
        out, acc = [], 0
        with self._lock:
            for b, c in zip(self.buckets, self._counts):
                acc += c
                out.append((b, acc))
            out.append((float("inf"), acc + self._counts[-1]))
        return out

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile (upper bound of the bucket the
        q-th sample falls in) — good enough for stats() summaries."""
        if self._n == 0:
            return 0.0
        top = self.buckets[-1] if self.buckets else 0.0
        rank = q * self._n
        for b, acc in self.cumulative():
            if acc >= rank:
                # +Inf bucket clamps to the largest finite bound so
                # snapshots stay strict-JSON
                return min(b, top)
        return top


class MetricsRegistry:
    """Name-keyed registry; get-or-create with type checking."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Any] = {}

    def _get_or_make(self, cls, name: str, *args, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, *args, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_make(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_make(Gauge, name, help)

    def histogram(self, name: str,
                  buckets: Sequence[float] = LATENCY_BUCKETS_S,
                  help: str = "") -> Histogram:
        return self._get_or_make(Histogram, name, buckets, help=help)

    # ---- absorption of legacy stats surfaces ------------------------------
    def absorb(self, prefix: str, stats: Dict[str, Any]) -> None:
        """Fold a ``stats()``-style dict into gauges under ``prefix``.

        Nested dicts flatten with dots (``engine.per_env.math``);
        booleans become 0/1; non-numeric values are skipped — the
        registry is a numeric surface, not a log."""
        for k, v in stats.items():
            name = f"{prefix}.{k}"
            if isinstance(v, dict):
                self.absorb(name, v)
            elif isinstance(v, bool):
                self.gauge(name).set(1.0 if v else 0.0)
            elif isinstance(v, (int, float)):
                self.gauge(name).set(float(v))

    # ---- export -----------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready dump (the ``--metrics-snapshot`` payload)."""
        out: Dict[str, Any] = {}
        with self._lock:
            items = list(self._metrics.items())
        for name, m in sorted(items):
            if m.kind == "histogram":
                out[name] = {
                    "count": m.count, "sum": m.sum,
                    "buckets": [[b, c] for b, c in m.cumulative()
                                if b != float("inf")],
                    "p50": m.quantile(0.5), "p99": m.quantile(0.99),
                }
            else:
                out[name] = m.value
        return out

    def snapshot_json(self, **json_kw) -> str:
        return json.dumps(self.snapshot(), **json_kw)

    def prometheus_text(self) -> str:
        """Prometheus text exposition (``GET /metrics``)."""
        lines: List[str] = []
        with self._lock:
            items = list(self._metrics.items())
        for name, m in sorted(items):
            pn = _prom_name(name)
            if m.help:
                lines.append(f"# HELP {pn} {m.help}")
            lines.append(f"# TYPE {pn} {m.kind}")
            if m.kind == "histogram":
                for b, acc in m.cumulative():
                    le = "+Inf" if b == float("inf") else repr(b)
                    lines.append(f'{pn}_bucket{{le="{le}"}} {acc}')
                lines.append(f"{pn}_sum {m.sum!r}")
                lines.append(f"{pn}_count {m.count}")
            else:
                v = m.value
                lines.append(f"{pn} {int(v) if v == int(v) else v!r}")
        return "\n".join(lines) + "\n"


def scrape(obj: Any,
           surfaces: Iterable[str] = ("stats", "stream_stats",
                                      "publication_stats")) -> Dict[str, Any]:
    """Merged dict of every stat surface ``obj`` exposes.

    The one implementation of the ``getattr(obj, "stream_stats", …)``
    union glue: later surfaces win on key collisions, absent surfaces
    are skipped.  Used by the fleet heartbeat payload, the launchers'
    ``--metrics-snapshot``, and ``GET /metrics``."""
    out: Dict[str, Any] = {}
    for name in surfaces:
        fn = getattr(obj, name, None)
        if callable(fn):
            out.update(fn())
    return out


_GLOBAL: Optional[MetricsRegistry] = None
_GLOBAL_LOCK = threading.Lock()


def get() -> MetricsRegistry:
    """Process-global registry (launchers and the HTTP server share it)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = MetricsRegistry()
        return _GLOBAL
