"""Asynchronous reward service: a host-side worker pool that scores
finished generations OFF the rollout/trainer critical path (Section 4.1:
"reward computation latency is pipelined behind generation"; DESIGN.md
§Environments and reward service, queue discipline and locking in
DESIGN.md §Queue and thread ownership).

A copy of ``repro/env/service.py``, which needs no JAX: importing it would run the JAX
package's ``__init__``, so the port keeps its own.

Data flow::

    rollout thread                 reward workers            trainer thread
    ──────────────                 ──────────────            ──────────────
    engine.step() -> finished
    scheduler.collect(...) ─────►  queue.get()
      (enqueue only, O(1))         env.verify(fin)   [slow: sandbox, ...]
                                   sink.deposit_scored(fin, verdict)
                                     └─► ReplayBuffer.add ──► pop_batch(...)

Invariants:

  * trajectories reach the ``ReplayBuffer`` only once scored — batch
    formation never sees an unrewarded sample;
  * **bounded backlog**: the scheduler stops pulling fresh prompts while
    ``backlog() >= max_backlog`` (admission backpressure), so unscored
    work is bounded by ``max_backlog`` plus the generations already in
    flight — a slow verifier throttles admission instead of growing an
    unbounded queue;
  * **deadlock-free shutdown**: workers poll the queue with a timeout
    and exit once ``close()`` is called and the queue is drained; a
    worker stuck inside ``env.verify`` is bounded by the environment's
    own deadline (the code sandbox kills its subprocess at
    ``timeout_s``), and ``close(timeout=)`` returns False rather than
    hanging if a worker still fails to exit.

The service never touches the scheduler lock itself: ``deposit_scored``
(the sink callback, implemented by ``AsyncScheduler``) owns its own
synchronization.  Per-environment verification-latency statistics are
kept for the benchmarks (``stats()``).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List, Optional

from repro_torch.env.base import Environment, Verdict
from repro_torch.obs import trace


class AsyncRewardService:
    """Worker pool scoring ``Finished`` generations through an
    ``Environment``; results flow to a sink's ``deposit_scored``."""

    def __init__(self, env: Environment, *, n_workers: int = 2,
                 max_backlog: int = 64):
        assert n_workers >= 1, n_workers
        self.env = env
        self.n_workers = n_workers
        self.max_backlog = max_backlog
        self._q: "queue.Queue" = queue.Queue()
        self._threads: List[threading.Thread] = []
        self._sink = None
        self._draining = threading.Event()
        self._lock = threading.Lock()
        self._in_progress = 0
        self._errors: List[BaseException] = []
        # stats (read by benchmarks/reward_overlap.py and tests)
        self.n_submitted = 0
        self.n_scored = 0
        self.backlog_peak = 0
        self._lat: Dict[str, Dict[str, float]] = {}

    # ---- lifecycle --------------------------------------------------------
    def bind(self, sink) -> None:
        """Set the deposit target (an ``AsyncScheduler``; anything with
        ``deposit_scored(fin, verdict, finish_time)``)."""
        self._sink = sink

    def start(self) -> None:
        """Spawn the worker threads (idempotent; ``submit`` calls it
        lazily)."""
        if self._threads:
            return
        self._draining.clear()
        for k in range(self.n_workers):
            t = threading.Thread(target=self._worker, daemon=True,
                                 name=f"areal-reward-{k}")
            t.start()
            self._threads.append(t)

    def close(self, timeout: Optional[float] = 10.0) -> bool:
        """Drain the queue, stop the workers, join them.  Returns True
        when every worker exited within ``timeout`` seconds; False (no
        hang) otherwise.  Idempotent; a closed service can be
        ``start``-ed again."""
        self._draining.set()
        deadline = (time.monotonic() + timeout) if timeout else None
        ok = True
        for t in self._threads:
            left = None if deadline is None else max(0.0,
                                                     deadline - time.monotonic())
            t.join(left)
            ok = ok and not t.is_alive()
        if ok:
            self._threads = []
        return ok

    # ---- producer side (rollout thread) -----------------------------------
    def submit(self, finished, finish_time: float) -> None:
        """Enqueue finished generations for scoring — O(1), never blocks
        the caller.  Backlog bounding happens at ADMISSION (the scheduler
        checks ``saturated()``), not here: refusing a submit would leak a
        generation the engine already paid for."""
        if self._draining.is_set():
            raise RuntimeError("AsyncRewardService.submit() after close()")
        self.start()
        for f in finished:
            self._q.put((f, finish_time))
        with self._lock:
            self.n_submitted += len(finished)
            self.backlog_peak = max(self.backlog_peak, self.backlog())

    def backlog(self) -> int:
        """Trajectories enqueued or being scored right now."""
        return self._q.qsize() + self._in_progress

    def saturated(self) -> bool:
        """Admission backpressure signal (DESIGN.md §Environments and
        reward service): True while the unscored backlog is at/over the
        bound, telling the scheduler to stop pulling fresh prompts."""
        return self.backlog() >= self.max_backlog

    # ---- worker loop -------------------------------------------------------
    def _worker(self) -> None:
        while True:
            try:
                fin, finish_time = self._q.get(timeout=0.05)
            except queue.Empty:
                if self._draining.is_set():
                    return
                continue
            with self._lock:
                self._in_progress += 1
            try:
                t0 = time.perf_counter()
                with trace.span("reward.verify", env=self.env.name,
                                rid=getattr(fin, "rid", -1)):
                    try:
                        verdict = self.env.verify(fin)
                    except Exception as e:  # noqa: BLE001 — scored as a miss
                        verdict = Verdict(False, {"error": repr(e)})
                dt = time.perf_counter() - t0
                try:
                    self._sink.deposit_scored(fin, verdict, finish_time)
                except BaseException as e:  # noqa: BLE001 — surfaced in stats
                    self._errors.append(e)
                with self._lock:
                    self.n_scored += 1
                    s = self._lat.setdefault(
                        self.env.name, {"n": 0, "total_s": 0.0, "max_s": 0.0})
                    s["n"] += 1
                    s["total_s"] += dt
                    s["max_s"] = max(s["max_s"], dt)
            finally:
                with self._lock:
                    self._in_progress -= 1

    # ---- stats -------------------------------------------------------------
    @property
    def errors(self) -> List[BaseException]:
        return list(self._errors)

    def stats(self) -> Dict:
        with self._lock:
            per_env = {
                name: {"n": int(s["n"]),
                       "mean_s": s["total_s"] / max(s["n"], 1),
                       "max_s": s["max_s"]}
                for name, s in self._lat.items()}
            return {"n_submitted": self.n_submitted,
                    "n_scored": self.n_scored,
                    "backlog": self.backlog(),
                    "backlog_peak": self.backlog_peak,
                    "max_backlog": self.max_backlog,
                    "n_workers": self.n_workers,
                    "per_env": per_env,
                    "n_errors": len(self._errors)}
