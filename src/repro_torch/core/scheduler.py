"""Transport-agnostic asynchronous-RL scheduling core (DESIGN.md §Async
runtime).

A copy of ``repro/core/scheduler.py``, which needs no JAX: importing it would run
the JAX package's ``__init__``, so the port keeps its own.  The port
has each of the executors named below.  The ``env=`` and
``reward_service=`` branches are driven by the port's environments and
``AsyncRewardService`` (``repro_torch/env/``), duck-typed as in the
reference.

AReaL's pipeline policy — what to admit, when a batch forms, what a
training step publishes — is independent of *how* the pipeline executes.
``AsyncScheduler`` owns exactly that policy surface:

  * staleness-gated admission (Eq. 3): requests are pulled from the
    prompt stream only while the trajectories they would produce can
    still land within ``max_staleness`` of the trainer's version;
  * reward collection: finished generations are scored — inline, or on
    the async reward-service worker pool (repro/env/, DESIGN.md
    §Environments and reward service) — and appended to the
    oldest-first, use-once replay buffer only once scored; the
    pending-reward stage stays inside Eq. 3's in-flight count and
    backpressures admission when the scoring backlog hits its bound;
  * batch formation: delegated to ``ReplayBuffer`` (oldest behavior
    version first, every sample consumed exactly once);
  * weight-publication accounting: each completed train step advances
    the staleness controller's policy version and appends a ``StepLog``.

It owns NO transport: no clock, no threads, no device placement.  Four
executors drive it —

  * ``core/controller.py::AsyncRLController`` — the virtual-clock
    executor (deterministic single-thread interleaving under a
    ``TimingModel``; produces every timing figure);
  * ``core/runtime.py::ThreadedRuntime`` — real concurrency: a rollout
    thread and a trainer thread on disjoint device submeshes;
  * ``core/fleet.py::FleetRuntime`` — multi-process: N rollout worker
    processes and M trainer replicas under a supervisor (DESIGN.md
    §Fleet runtime), using the per-worker in-flight accounting and
    requeue API below;
  * the same with ``core/simulator.py``'s stub engine/trainer for
    cluster-scale discrete-event studies.

All methods are thread-safe: the virtual executor calls them from one
thread, the threaded runtime from two (admission/collection on the
rollout thread, batch formation/publication on the trainer thread), the
fleet supervisor from its receiver and trainer-pump threads.

Staleness accounting (DESIGN.md §Staleness accounting with
pending-unscored trajectories): Eq. 3's numerator ``n_submitted`` counts
a request exactly once, at first hand-off toward an engine, and never
decrements — finished-but-unscored trajectories and crashed-worker
requeues both stay inside N_r.  Requests carry a private ``_counted``
flag so a requeued or re-offered request is never double-counted.
"""
from __future__ import annotations

import heapq
import math
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.configs.base import RLConfig
from repro_torch.core.buffer import ReplayBuffer, Trajectory
from repro_torch.core.reward import RewardService
from repro_torch.core.staleness import StalenessController, StalenessStats
from repro_torch.obs import trace


@dataclass
class StepLog:
    """One training step's record, appended per policy version by every
    executor (re-exported by ``core/controller.py`` for compatibility)."""
    version: int
    clock: float
    reward_mean: float
    accuracy: float
    staleness_mean: float
    staleness_max: int
    n_tokens: int
    gen_tokens_total: int
    interruptions: int
    loss: float = 0.0
    diag: Dict = field(default_factory=dict)


class AsyncScheduler:
    """Policy core shared by every executor (DESIGN.md §Async runtime)."""

    def __init__(self, *, prompt_stream, rl: RLConfig,
                 reward: Optional[RewardService] = None,
                 buffer: Optional[ReplayBuffer] = None,
                 on_step: Optional[Callable] = None,
                 env=None, reward_service=None):
        self.stream = prompt_stream
        self.rl = rl
        self.reward = reward or RewardService(rl.reward_correct,
                                              rl.reward_incorrect)
        self.buffer = buffer or ReplayBuffer()
        # env wiring (DESIGN.md §Environments and reward service).
        # env=None keeps the legacy synchronous
        # math scoring path bit-for-bit; env set routes verification
        # through Environment.verify — inline when reward_service is
        # None, on the service's worker pool otherwise (trajectories
        # enter the buffer only once scored).
        self.env = env
        self.reward_service = reward_service
        self._pending_unscored = 0         # finished, not yet deposited
        if reward_service is not None:
            if self.env is None:
                self.env = reward_service.env
            reward_service.bind(self)
        self.stal = StalenessController(batch_size=rl.batch_size,
                                        max_staleness=(math.inf
                                                       if rl.max_staleness < 0
                                                       else rl.max_staleness))
        self.stal_stats = StalenessStats()
        self.history: List[StepLog] = []
        self.on_step = on_step
        self._next_rid = 0
        self._deferred: List[Dict] = []    # planned but not yet admitted
        self._starved = False              # engine bounced work on resources
        # fleet executor state (DESIGN.md §Fleet runtime): per-worker
        # in-flight assignment map for crash requeue, rid -> (worker, req)
        self._assigned: Dict[int, tuple] = {}
        self.requeued_total = 0
        # publication-to-pickup accounting
        # (DESIGN.md §Streaming weight publication):
        # version -> publish clock, and per-pickup samples
        self._published_t: Dict[int, float] = {}
        self.pickup_latencies: List[tuple] = []
        self._lock = threading.RLock()

    # ---- admission (rollout side) -----------------------------------------
    def plan_admission(self, n_free: int) -> List[Dict]:
        """Requests the executor should try to admit right now: deferred
        requests first (planned earlier, engine had no room), then fresh
        pulls from the prompt stream — each admitted against Eq. 3 at the
        CURRENT policy version.  Pulled requests must be handed back via
        ``admitted`` (possibly with n < len(reqs)); they are not counted
        as submitted until then.

        While the engine reports itself resource-starved (``admitted``
        got ``deferred > 0``: pool pressure despite free slots), only the
        deferred backlog is re-offered — free-slot count alone overstates
        a paged engine's capacity, and pulling fresh stream work it
        cannot take would just grow the backlog.

        Pending-reward stage: trajectories finished but not yet scored
        by the async reward service remain part of Eq. 3's N_r —
        ``n_submitted`` counts at submission and never decrements, so
        async scoring cannot silently loosen the staleness bound
        (DESIGN.md §Staleness accounting with pending-unscored
        trajectories).  On top of that, while the service backlog is at
        its bound (``saturated()``) fresh stream pulls stop entirely: a
        slow verifier throttles admission instead of growing an
        unbounded unscored queue (DESIGN.md §Environments and reward
        service).

        Requeued requests (fleet crash recovery) sit at the FRONT of the
        deferred queue already counted in ``n_submitted``; they bypass
        the ``can_submit`` gate — they are already inside N_r, and
        gating them again could deadlock a run sitting exactly at the
        staleness bound."""
        backpressure = self.saturated()
        with self._lock:
            reqs: List[Dict] = []
            n_new = 0                      # not-yet-counted reqs planned
            while self._deferred and n_free > len(reqs):
                counted = self._deferred[0].get("_counted", False)
                if not counted and not self.stal.can_submit(n_new + 1):
                    break
                reqs.append(self._deferred.pop(0))
                n_new += 0 if counted else 1
            while (not self._starved and not backpressure
                   and n_free > len(reqs)
                   and self.stal.can_submit(n_new + 1)):
                n_new += 1
                prob, gid = self.stream.next_request()
                reqs.append({"rid": self._next_rid, "prompt_id": gid,
                             "prompt": prob.prompt_tokens,
                             "answer": prob.answer})
                self._next_rid += 1
            return reqs

    def admitted(self, reqs: List[Dict], n: int, deferred: int = 0) -> None:
        """The engine accepted the first ``n`` of ``reqs``: count them as
        submitted (Eq. 3 numerator); re-queue the remainder so a later
        ``plan_admission`` retries them.  ``deferred`` is the engine's
        own count of requests it bounced on POOL pressure
        (``RolloutEngine.stats()["deferred_last"]``): while nonzero the
        scheduler stops pulling fresh stream work and only retries the
        backlog, instead of re-probing ``free_slots()`` — which cannot
        see block-pool headroom (DESIGN.md §Chunked prefill).

        Requests already counted into Eq. 3 (fleet pre-ack accounting or
        a crash requeue) are skipped by the submission count — a request
        enters ``n_submitted`` exactly once however many times it is
        re-offered."""
        with self._lock:
            taken = reqs[:n]
            n_uncounted = sum(1 for r in taken if not r.get("_counted"))
            if n_uncounted:
                self.stal.submit(n_uncounted)
            for r in taken:
                r["_counted"] = True
            if n < len(reqs):
                self._deferred[:0] = reqs[n:]
            self._starved = deferred > 0

    def saturated(self) -> bool:
        """True while the async reward service's scoring backlog is at
        its bound — the admission-backpressure signal (DESIGN.md
        §Environments and reward service) and the fleet's elastic
        shrink signal (DESIGN.md §Elastic policy)."""
        return (self.reward_service is not None
                and self.reward_service.saturated())

    # ---- per-worker in-flight accounting (fleet executor) -----------------
    # DESIGN.md §Requeue semantics: the supervisor counts a request into
    # Eq. 3 when it is SENT to a worker (assign), not when the worker
    # acks it — between send and ack the request is in flight on the
    # transport and must already bound fresh admission.  The assignment
    # map is the single source of truth for what a crashed worker owes.

    def assign(self, worker: str, reqs: List[Dict]) -> None:
        """Record ``reqs`` as sent to ``worker`` and count any
        not-yet-counted ones into Eq. 3's numerator.  Idempotent per
        request: a requeued request keeps its ``_counted`` flag."""
        with self._lock:
            n_uncounted = sum(1 for r in reqs if not r.get("_counted"))
            if n_uncounted:
                self.stal.submit(n_uncounted)
            for r in reqs:
                r["_counted"] = True
                self._assigned[r["rid"]] = (worker, r)

    def acked(self, worker: str, reqs: List[Dict], n: int,
              deferred: int = 0) -> None:
        """Worker accepted the first ``n`` of a previously ``assign``-ed
        batch: the remainder leaves the worker's in-flight set and goes
        back to the FRONT of the deferred queue (still counted — no
        double submission on retry).  ``deferred`` as in ``admitted``."""
        with self._lock:
            rest = reqs[n:]
            for r in rest:
                self._assigned.pop(r["rid"], None)
            if rest:
                self._deferred[:0] = rest
            self._starved = deferred > 0

    def finished_inflight(self, rid: int) -> bool:
        """A trajectory for ``rid`` arrived: drop it from the in-flight
        assignment map so a later crash of its worker cannot requeue an
        already-delivered request.  Returns False for unknown rids
        (e.g. a duplicate delivery the supervisor already dropped)."""
        with self._lock:
            return self._assigned.pop(rid, None) is not None

    def inflight_of(self, worker: str) -> List[int]:
        """rids currently assigned to ``worker`` (diagnostics/elastic)."""
        with self._lock:
            return sorted(rid for rid, (w, _) in self._assigned.items()
                          if w == worker)

    def requeue_worker(self, worker: str) -> List[Dict]:
        """Crash recovery (DESIGN.md §Requeue semantics): move every
        request still assigned to ``worker`` to the front of the
        deferred queue, in rid order, WITHOUT touching ``n_submitted``
        (they are still in flight for Eq. 3).  Idempotent — a second
        call for the same worker, or a requeue racing a late delivery,
        finds the map entries gone and returns [].  The re-admission
        path is the ordinary ``plan_admission``; the engine's
        interrupt/re-prefill machinery regenerates the trajectory from
        the prompt on whichever worker picks it up."""
        with self._lock:
            reqs = sorted((r for rid, (w, r) in self._assigned.items()
                           if w == worker), key=lambda r: r["rid"])
            for r in reqs:
                del self._assigned[r["rid"]]
            if reqs:
                self._deferred[:0] = reqs
                self.requeued_total += len(reqs)
            return reqs

    # ---- reward collection (rollout side) ---------------------------------
    def collect(self, finished, finish_time: float) -> None:
        """Route finished generations to scoring and, once scored, into
        the oldest-first buffer (DESIGN.md §Environments and reward
        service):

          * async reward service configured — enqueue and return (O(1));
            worker threads verify and call ``deposit_scored`` later.
            Trajectories are buffered ONLY once scored;
          * environment configured, no service — verify inline on the
            calling (rollout) thread, outside the scheduler lock: the
            synchronous-scoring baseline whose stall
            ``benchmarks/reward_overlap.py`` measures;
          * neither — the legacy math string-match via
            ``RewardService.score`` (bit-for-bit the pre-env behavior).
        """
        if not finished:
            return
        if self.reward_service is not None:
            with self._lock:
                self._pending_unscored += len(finished)
            self.reward_service.submit(finished, finish_time)
            return
        if self.env is not None:
            # verification (possibly slow: sandbox subprocess) runs
            # outside the lock so the trainer side never blocks on it
            verdicts = [self.env.verify(f) for f in finished]
            with self._lock:
                for f, v in zip(finished, verdicts):
                    self._deposit_locked(f, v.ok, finish_time,
                                         info=v.info)
            return
        with self._lock:
            self._collect_locked(finished, finish_time)

    def _collect_locked(self, finished, finish_time: float) -> None:
        for f in finished:
            r = self.reward.score(f.response, f.answer)
            self._buffer_locked(f, r, finish_time)

    def _buffer_locked(self, f, reward: float, finish_time: float,
                       info: Optional[Dict] = None) -> None:
        meta = {}
        lm = getattr(f, "loss_mask", None)
        if lm is not None:
            meta["loss_mask"] = lm         # env tokens carry no loss
        if info:
            meta["env"] = info
        self.buffer.add(Trajectory(
            rid=f.rid, prompt_id=f.prompt_id,
            prompt_tokens=f.prompt, response_tokens=f.response,
            behav_logprobs=f.logprobs, versions=f.versions,
            behavior_version=f.behavior_version, reward=reward,
            answer=f.answer, submit_time=f.submit_time,
            finish_time=finish_time, meta=meta))

    def _deposit_locked(self, f, ok: bool, finish_time: float,
                        info: Optional[Dict] = None) -> None:
        self._buffer_locked(f, self.reward.record(ok), finish_time, info)

    def deposit_scored(self, f, verdict, finish_time: float) -> None:
        """Reward-worker sink: fold one verified trajectory into the
        accuracy stats and release it into the replay buffer.  Called
        from ``AsyncRewardService`` worker threads; the scheduler lock
        serializes it against the rollout/trainer sides."""
        with self._lock:
            self._pending_unscored -= 1
            self._deposit_locked(f, verdict.ok, finish_time,
                                 info=verdict.info)

    def pending_rewards(self) -> int:
        """Trajectories handed to the reward service and not yet
        deposited (finished-but-unscored: still in-flight for Eq. 3)."""
        with self._lock:
            return self._pending_unscored

    # ---- publication accounting (DESIGN.md §Streaming weight publication) -
    def note_published(self, version: int, t: float) -> None:
        """The trainer side made ``version`` available to rollout (full
        tree in the store, or the first message of its weight stream on
        the wire): starts the publication-to-pickup clock the streaming
        benchmark reads (benchmarks/weight_stream.py)."""
        with self._lock:
            self._published_t[version] = t
        trace.instant("weights.published", version=version)

    def note_pickup(self, version: int, t: float, who: str = "engine") -> None:
        """A rollout engine flipped to ``version``: record the
        publication-to-pickup latency.  Unknown versions (picked up
        before ``note_published``, e.g. a register-time full send) are
        ignored; per-worker duplicates are kept — with many subscribers
        each worker's pickup is its own latency sample."""
        with self._lock:
            t0 = self._published_t.get(version)
            if t0 is not None:
                self.pickup_latencies.append((version, who, t - t0))
                trace.instant("weights.pickup", version=version, who=who,
                              latency=t - t0)

    def publication_stats(self) -> Dict:
        """Aggregate publication-to-pickup latencies (seconds — or the
        executor's own clock units)."""
        with self._lock:
            lats = [lat for _, _, lat in self.pickup_latencies]
            return {
                "published": len(self._published_t),
                "pickups": len(lats),
                "latency_mean": (sum(lats) / len(lats)) if lats else 0.0,
                "latency_max": max(lats) if lats else 0.0,
            }

    # ---- training accounting (trainer side) -------------------------------
    def record_consumed(self, batch: List[Trajectory]) -> None:
        """Staleness bookkeeping for a batch about to be trained on,
        measured against the policy version consuming it (i.e. BEFORE the
        version bump this batch produces)."""
        with self._lock:
            stals = [max(0, self.stal.policy_version - t.behavior_version)
                     for t in batch]
            for s in stals:
                self.stal_stats.record(s)
        if trace.get().enabled and stals:
            # staleness-at-consumption annotation on the trainer lane
            trace.instant("train.consume",
                          n=len(stals),
                          staleness_mean=sum(stals) / len(stals),
                          staleness_max=max(stals))

    def note_policy_update(self, version: int) -> None:
        """A train step completed: admission now gates against ``version``."""
        with self._lock:
            self.stal.on_policy_update(version)

    def log_step(self, metrics, *, version: int, clock: float,
                 gen_tokens_total: int, interruptions: int) -> StepLog:
        """Append the per-version StepLog (the executor supplies its own
        notion of ``clock``: virtual seconds or wall seconds)."""
        with self._lock:
            log = StepLog(
                version=version, clock=clock,
                reward_mean=metrics.reward_mean,
                accuracy=self.reward.recent_accuracy,
                staleness_mean=metrics.staleness_mean,
                staleness_max=metrics.staleness_max,
                n_tokens=metrics.n_tokens,
                gen_tokens_total=gen_tokens_total,
                interruptions=interruptions,
                loss=metrics.loss, diag=metrics.diag)
            self.history.append(log)
        if trace.get().enabled:
            trace.counter("reward_mean", log.reward_mean)
            trace.counter("staleness_mean", log.staleness_mean)
            trace.counter("version", float(version))
        if self.on_step:                   # user code: outside the lock
            self.on_step(log)
        return log

    # ---- derived ----------------------------------------------------------
    def tokens_consumed(self) -> int:
        with self._lock:
            return sum(h.n_tokens for h in self.history)


class SLAQueue:
    """Priority/deadline admission queue for the serving gateway
    (DESIGN.md §Serving gateway).

    Orders pending requests by ``(priority, deadline, arrival)``: lower
    priority value = more urgent tier; within a tier the earliest
    deadline wins (EDF); ties break FIFO by arrival sequence.  The
    gateway drains it into engine slots and consults ``head_key`` to
    decide preemption — a queued request beats a RUNNING one only when
    its priority tier is strictly more urgent, so same-tier traffic
    never thrashes slots.

    Thread-safe: HTTP handler threads push concurrently with the single
    driver thread popping."""

    def __init__(self):
        self._heap: List[tuple] = []
        self._seq = 0
        self._lock = threading.Lock()
        self.pushed_total = 0
        self.popped_total = 0

    def push(self, item, *, priority: int = 1,
             deadline: float = math.inf) -> None:
        with self._lock:
            heapq.heappush(self._heap,
                           (int(priority), float(deadline), self._seq, item))
            self._seq += 1
            self.pushed_total += 1

    def pop(self):
        """Most-urgent pending item, or None when empty."""
        with self._lock:
            if not self._heap:
                return None
            self.popped_total += 1
            return heapq.heappop(self._heap)[3]

    def head_key(self) -> Optional[tuple]:
        """(priority, deadline) of the most-urgent pending item, or
        None.  The gateway compares this against the least-urgent
        ACTIVE slot's key to decide preemption."""
        with self._lock:
            if not self._heap:
                return None
            p, d, _, _ = self._heap[0]
            return (p, d)

    def __len__(self) -> int:
        with self._lock:
            return len(self._heap)

    def overdue(self, now: float) -> int:
        """Pending items whose deadline already passed (diagnostics —
        the SLA-miss pressure gauge in gateway stats)."""
        with self._lock:
            return sum(1 for _, d, _, _ in self._heap if d < now)


class SchedulerExecutorMixin:
    """The attribute surface every executor shares (pre-refactor
    controllers owned these directly): delegates policy-owned state to
    ``self.sched``.  Mixed into AsyncRLController and ThreadedRuntime so
    the launch/benchmark/test layers see one interface."""

    sched: AsyncScheduler

    @property
    def buffer(self) -> ReplayBuffer:
        return self.sched.buffer

    @property
    def stal(self) -> StalenessController:
        return self.sched.stal

    @property
    def stal_stats(self) -> StalenessStats:
        return self.sched.stal_stats

    @property
    def reward(self) -> RewardService:
        return self.sched.reward

    @property
    def history(self) -> List[StepLog]:
        return self.sched.history

    @property
    def stream(self):
        return self.sched.stream

    @property
    def reward_service(self):
        return self.sched.reward_service

    @property
    def on_step(self):
        return self.sched.on_step
