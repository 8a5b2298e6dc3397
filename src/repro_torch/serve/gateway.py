"""Serving gateway core (DESIGN.md §Serving gateway).

A copy of ``repro/serve/gateway.py``, which needs no JAX: importing it would run the
JAX package's ``__init__``, so the port keeps its own.  The metric names are
the reference's (``gateway.ttft``, exported as ``repro_gateway_ttft``), so
one dashboard reads both.

The ``Gateway`` turns one interruptible ``RolloutEngine`` into a
multi-tenant service.  It owns four pieces of state the engine does not:

  * an ``SLAQueue`` of pending requests ordered by (priority tier,
    deadline, arrival) — ``core/scheduler.py``;
  * a session table: session id -> accumulated context tokens, so a
    session's next request shares its leading KV blocks through the
    paged pool's chained prefix hashes (DESIGN.md §Paged KV-cache pool,
    §Prefix eviction policy);
  * a park list of preempted-request snapshots (``preempt_slot``
    output) awaiting re-admission through ``admit_resume``;
  * per-request subscriber queues the HTTP layer (``serve/http.py``)
    streams tokens from.

Threading contract: ``submit``/``events`` are thread-safe (HTTP handler
threads call them); ``pump`` is the single-driver surface — exactly one
thread calls it, and that thread is the engine's driver.  The gateway
clock defaults to a deterministic step counter (one ``pump`` = one
tick), which is what makes the benchmark's TTFT percentiles
(benchmarks/serve_gateway.py) byte-stable; the HTTP server swaps in a
wall-clock so deadlines are in milliseconds.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.scheduler import SLAQueue
from repro_torch.obs import trace
from repro_torch.obs.metrics import MetricsRegistry, scrape

# TTFT/ITL/queue-wait buckets wide enough for both gateway clock
# domains (DESIGN.md §Clock domains): deterministic ticks (offline,
# O(1..100)) and wall milliseconds (HTTP mode, O(10..10000)).
GATEWAY_LATENCY_BUCKETS = (0.5, 1, 2, 4, 8, 16, 32, 64, 128, 256,
                           512, 1024, 2048, 4096, 8192, 16384)


@dataclass
class _Pending:
    """One request's gateway-side record, alive from submit to final
    token.  ``streamed`` is the count of response tokens already pushed
    to the subscriber queue."""
    rid: int
    session: Optional[str]
    prompt: List[int]
    priority: int
    deadline: float
    submit_clock: float
    answer: object = None
    sink: "queue.SimpleQueue" = field(default_factory=queue.SimpleQueue)
    streamed: int = 0
    first_token_clock: float = -1.0
    preempted: int = 0                 # times this request lost its slot


class Gateway:
    """SLA-scheduled serving front-end over one rollout engine
    (DESIGN.md §Serving gateway).

    Admission order is (priority, deadline, arrival); a queued request
    whose priority TIER is strictly more urgent than the least-urgent
    running request preempts it through ``RolloutEngine.preempt_slot``
    — the victim parks host-side and resumes bit-exact later via
    ``admit_resume`` (same-tier traffic never preempts, so slots cannot
    thrash).  Pool exhaustion is absorbed by the allocator's LRU prefix
    eviction (DESIGN.md §Prefix eviction policy): admission recomputes
    evicted prefixes instead of wedging, so every submitted request
    eventually completes — the zero-permanently-deferred property the
    gateway benchmark asserts.
    """

    def __init__(self, engine, *, preempt: bool = True,
                 clock: Optional[Callable[[], float]] = None):
        if not getattr(engine, "prefill_chunk", 0):
            raise ValueError(
                "Gateway requires a chunked-prefill engine "
                "(EngineConfig(prefill_chunk > 0)): preempted requests "
                "resume through the ingest queue at their watermark "
                "(DESIGN.md §Serving gateway)")
        self.engine = engine
        self.preempt_enabled = preempt
        self._clock_fn = clock
        self._ticks = 0
        self.queue = SLAQueue()
        self.sessions: Dict[str, List[int]] = {}
        self._lock = threading.Lock()      # submit-side state
        self._next_rid = 0
        self._live: Dict[int, _Pending] = {}      # rid -> record (anywhere)
        self._running: Dict[int, _Pending] = {}   # rid -> record (in a slot)
        self._parked: List[Tuple[tuple, _Pending, Dict]] = []  # key, rec, snap
        # counters
        self.completed = 0
        self.sla_misses = 0
        self.session_hits = 0              # submits that extended a session
        self._shareable_blocks = 0         # full prompt blocks at admission
        self._ttfts: List[float] = []
        self._itls: List[float] = []       # inter-token latencies (driver side)
        self._last_tok_clock: Dict[int, float] = {}
        # typed metrics (DESIGN.md §Metrics registry): histograms are
        # observed live on the driver path; counters/gauges are absorbed
        # from stats() at scrape time (GET /metrics, --metrics-snapshot)
        self.metrics = MetricsRegistry()
        self._h_ttft = self.metrics.histogram(
            "gateway.ttft", GATEWAY_LATENCY_BUCKETS,
            help="submit-to-first-token latency (gateway clock units)")
        self._h_itl = self.metrics.histogram(
            "gateway.itl", GATEWAY_LATENCY_BUCKETS,
            help="inter-token latency (gateway clock units)")
        self._h_queue_wait = self.metrics.histogram(
            "gateway.queue_wait", GATEWAY_LATENCY_BUCKETS,
            help="submit-to-slot-admission wait (gateway clock units)")

    # ---- clock ------------------------------------------------------------
    def now(self) -> float:
        return self._ticks if self._clock_fn is None else self._clock_fn()

    # ---- submit side (any thread) -----------------------------------------
    def submit(self, tokens: List[int], *, session: Optional[str] = None,
               priority: int = 1, deadline: Optional[float] = None,
               sla: Optional[float] = None, answer: object = None) -> int:
        """Enqueue one request; returns its rid.  ``tokens`` are the
        request's OWN tokens; with ``session`` set they are appended to
        the session's accumulated context (capped so the new tokens
        always fit the engine's prompt window while the leading context
        — the shared prefix — stays stable).  ``sla`` is a relative
        deadline (now + sla); ``deadline`` absolute; neither = inf."""
        now = self.now()
        if deadline is None:
            deadline = now + sla if sla is not None else float("inf")
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            new = list(tokens)
            if session is not None:
                ctx = self.sessions.get(session, [])
                if ctx:
                    self.session_hits += 1
                keep = max(0, self.engine.prompt_len - len(new))
                prompt = ctx[:keep] + new
            else:
                prompt = new
            prompt = prompt[: self.engine.prompt_len]
            rec = _Pending(rid=rid, session=session, prompt=prompt,
                           priority=int(priority), deadline=float(deadline),
                           submit_clock=now, answer=answer)
            self._live[rid] = rec
        self.queue.push(rec, priority=rec.priority, deadline=rec.deadline)
        trace.instant("gw.submit", rid=rid, priority=int(priority),
                      session=session or "")
        return rid

    def events(self, rid: int) -> "queue.SimpleQueue":
        """The rid's subscriber queue: ("tok", token_id) per generated
        token, then one ("end", info_dict).  HTTP handler threads block
        on it; the driver thread feeds it from ``pump``."""
        with self._lock:
            return self._live[rid].sink

    def release(self, rid: int) -> None:
        """Drop a finished request's record (the subscriber read its
        "end" event); idempotent."""
        with self._lock:
            self._live.pop(rid, None)

    def has_work(self) -> bool:
        return (len(self.queue) > 0 or bool(self._running)
                or bool(self._parked))

    # ---- driver side (single thread) --------------------------------------
    def _key(self, rec: _Pending) -> tuple:
        return (rec.priority, rec.deadline, rec.rid)

    def _resume_one(self) -> bool:
        """Try to re-admit the most urgent parked snapshot."""
        if not self._parked or not self.engine.free_slots():
            return False
        self._parked.sort(key=lambda e: e[0])
        key, rec, snap = self._parked[0]
        i = self.engine.admit_resume(snap)
        if i is None:
            return False                   # pool pressure: retry next pump
        self._parked.pop(0)
        self._running[rec.rid] = rec
        trace.instant("gw.resume", rid=rec.rid, slot=i)
        return True

    def _admit_one(self) -> bool:
        """Try to admit the queue head into a free slot."""
        if not self.engine.free_slots():
            return False
        rec = self.queue.pop()
        if rec is None:
            return False
        req = {"rid": rec.rid, "prompt_id": rec.rid, "prompt": rec.prompt,
               "answer": rec.answer}
        n = self.engine.admit([req], clock=self.now())
        if n == 0:
            # pool pressure even after LRU eviction (every block is held
            # by a running request): put the head back and wait for a
            # finish to release blocks
            self.queue.push(rec, priority=rec.priority,
                            deadline=rec.deadline)
            return False
        self._shareable_blocks += len(rec.prompt) // self.engine.block_size \
            if self.engine.cache_mode == "paged" else 0
        self._running[rec.rid] = rec
        wait = self.now() - rec.submit_clock
        self._h_queue_wait.observe(wait)
        trace.instant("gw.admit", rid=rec.rid, queue_wait=wait)
        return True

    def _maybe_preempt(self) -> bool:
        """Preempt the least-urgent RUNNING request when the most urgent
        WAITING one (queued or parked) is in a strictly more urgent
        priority tier and no slot is free."""
        if not self.preempt_enabled or self.engine.free_slots():
            return False
        heads = [k for k in (self.queue.head_key(),) if k is not None]
        if self._parked:
            self._parked.sort(key=lambda e: e[0])
            heads.append(self._parked[0][0][:2])
        if not heads:
            return False
        head_p = min(heads)[0]
        victims = sorted(self._running.values(), key=self._key, reverse=True)
        if not victims or victims[0].priority <= head_p:
            return False                   # same tier never preempts
        victim = victims[0]
        i = next(i for i, s in enumerate(self.engine.slots)
                 if s.active and s.rid == victim.rid)
        snap = self.engine.preempt_slot(i)
        del self._running[victim.rid]
        victim.preempted += 1
        self._parked.append((self._key(victim), victim, snap))
        trace.instant("gw.preempt", rid=victim.rid, slot=i,
                      by_priority=head_p)
        return True

    def pump(self) -> int:
        """One gateway tick: preempt/resume/admit, one engine step,
        stream the new tokens.  Returns the number of requests that
        FINISHED this tick.  Single-driver: the calling thread must be
        the engine's driver thread."""
        self._ticks += 1
        now = self.now()
        while self._maybe_preempt():
            pass
        progress = True
        while progress and self.engine.free_slots():
            qk = self.queue.head_key()
            pk = min((e[0] for e in self._parked), default=None)
            if pk is not None and (qk is None or pk[:2] <= qk):
                progress = self._resume_one()
            elif qk is not None:
                progress = self._admit_one()
            else:
                progress = False
        finished = self.engine.step()
        fin_by_rid = {f.rid: f for f in finished}
        # stream deltas for running slots
        for s in self.engine.slots:
            if s.active and s.rid in self._running:
                self._stream_delta(self._running[s.rid], s.response, now)
        n_done = 0
        for rid, f in fin_by_rid.items():
            rec = self._running.pop(rid, None)
            if rec is None:
                continue                   # not gateway-owned
            self._stream_delta(rec, f.response, now)
            self._finish(rec, f, now)
            n_done += 1
        return n_done

    def _stream_delta(self, rec: _Pending, response: List[int],
                      now: float) -> None:
        for t in response[rec.streamed:]:
            if rec.first_token_clock < 0:
                rec.first_token_clock = now
                ttft = now - rec.submit_clock
                self._ttfts.append(ttft)
                self._h_ttft.observe(ttft)
                trace.instant("gw.ttft", rid=rec.rid, ttft=ttft)
            else:
                itl = now - self._last_tok_clock[rec.rid]
                self._itls.append(itl)
                self._h_itl.observe(itl)
            self._last_tok_clock[rec.rid] = now
            rec.sink.put(("tok", int(t)))
            rec.streamed += 1

    def _finish(self, rec: _Pending, f, now: float) -> None:
        if rec.session is not None:
            # the session's next request prefix-shares this context
            self.sessions[rec.session] = list(f.prompt) + list(f.response)
        missed = now > rec.deadline
        self.sla_misses += int(missed)
        self.completed += 1
        self._last_tok_clock.pop(rec.rid, None)
        trace.instant("gw.done", rid=rec.rid, sla_missed=missed,
                      preempted=rec.preempted, tokens=len(f.response))
        rec.sink.put(("end", {
            "rid": rec.rid, "tokens": list(f.response),
            "truncated": f.truncated, "turns": f.turns,
            "preempted": rec.preempted,
            "ttft": (rec.first_token_clock - rec.submit_clock
                     if rec.first_token_clock >= 0 else -1.0),
            "sla_missed": missed,
        }))

    # ---- draining helpers (tests / offline mode) --------------------------
    def drain(self, rid: int) -> Dict:
        """Non-blocking read of everything rid's subscriber queue holds;
        returns {"tokens": [...], "end": info-or-None}."""
        q = self.events(rid)
        toks, end = [], None
        while True:
            try:
                kind, val = q.get_nowait()
            except queue.Empty:
                break
            if kind == "tok":
                toks.append(val)
            else:
                end = val
        if end is not None:
            self.release(rid)
        return {"tokens": toks, "end": end}

    def run_until_idle(self, max_ticks: int = 200_000) -> int:
        """Offline mode: pump until every submitted request finished.
        Returns ticks consumed.  The zero-permanently-deferred property:
        with LRU eviction an undersized pool degrades to recompute, so
        this always terminates (asserted by the gateway benchmark)."""
        t0 = self._ticks
        while self.has_work():
            self.pump()
            if self._ticks - t0 > max_ticks:
                raise RuntimeError("gateway did not drain: "
                                   f"{len(self._live)} live after "
                                   f"{max_ticks} ticks")
        return self._ticks - t0

    # ---- stats ------------------------------------------------------------
    @staticmethod
    def _pct(xs: List[float], q: float) -> float:
        if not xs:
            return 0.0
        ys = sorted(xs)
        return ys[min(len(ys) - 1, int(q * len(ys)))]

    def stats(self) -> Dict:
        eng = self.engine.stats()
        hit_rate = (eng["prefix_reused_blocks"] /
                    max(1, self._shareable_blocks))
        return {
            "completed": self.completed,
            "queued": len(self.queue),
            "running": len(self._running),
            "parked": len(self._parked),
            "sla_misses": self.sla_misses,
            "session_hits": self.session_hits,
            "preemptions": eng["preemptions"],
            "resumes": eng["resumes"],
            "evictions": eng["evictions"],
            "revivals": eng["revivals"],
            "deferred": eng["deferred"],
            "prefix_reused_blocks": eng["prefix_reused_blocks"],
            "prefix_hit_rate": round(hit_rate, 4),
            "recompute_tokens": eng["reprefill_tokens"],
            "ttft_p50": self._pct(self._ttfts, 0.50),
            "ttft_p99": self._pct(self._ttfts, 0.99),
            "itl_p50": self._pct(self._itls, 0.50),
            "itl_p99": self._pct(self._itls, 0.99),
            "ticks": self._ticks,
        }

    def metrics_registry(self) -> "MetricsRegistry":
        """Fold the live counter surfaces into ``self.metrics`` and
        return it (DESIGN.md §Metrics registry).  The TTFT/ITL/queue-wait
        histograms accumulate online in ``_stream_delta``/``_admit_one``;
        scalar gauges are refreshed here at scrape time so ``GET
        /metrics`` always reflects the current tick."""
        self.metrics.absorb("gateway", self.stats())
        self.metrics.absorb("engine", scrape(
            self.engine, surfaces=("stats", "stream_stats")))
        return self.metrics

    def prometheus_text(self) -> str:
        """Prometheus text exposition of the gateway + engine metrics
        (served by ``GET /metrics`` in serve/http.py)."""
        return self.metrics_registry().prometheus_text()
