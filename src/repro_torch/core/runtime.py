"""Threaded disaggregated runtime (DESIGN.md §Async runtime), after
``repro/core/runtime.py``: REAL concurrency for the AReaL pipeline.

Thread ownership (DESIGN.md §Thread ownership) — two threads drive the
shared scheduling core (core/scheduler.py):

  * the **rollout thread** owns the ``RolloutEngine`` (single-driver
    contract): it admits staleness-admissible prompts, runs decode
    steps, scores finished trajectories into the replay buffer, and — at
    each step boundary — picks up any newer weights the trainer has
    published (interruptible generation: the engine re-prefills the
    in-flight prefixes and decoding continues);
  * the **trainer thread** owns the ``PPOTrainer``: it blocks on
    ``ReplayBuffer.pop_batch(timeout=...)``, runs the PPO update, then
    publishes the new weights into the ``ParameterStore``; with the
    engine on another card (``launch/disaggregated.py``) the copy onto
    that card (``push_weights``) happens HERE, off the generation path.

Weight-publication path (DESIGN.md §Weight-publication path):

    trainer thread                       rollout thread
    ──────────────                       ──────────────
    train_step(batch)                    step() / admit() ...
    [push_weights(weights, device)]          │
    store.publish(version, weights) ───►  step boundary:
    note_policy_update(version)             store.latest() newer?
    pop_batch(...) blocks                    └─ acquire + update_weights
                                                (interrupt + re-prefill)

Generation never blocks on training and training never blocks on
generation beyond data availability, with the staleness controller
(Eq. 3) as the only coupling.

On one CUDA card the two threads share the device, and each runs its
work on a CUDA stream of its own (``rollout_stream``,
``trainer_stream``): PyTorch's current stream is per thread, so both
would otherwise queue on the default stream and serialise on the card.
The hand-written kernels launch on ``torch.cuda.current_stream``, so
they follow.  The hand-off is ordered across the streams, never by a
device-wide synchronise: ``store.publish`` copies the trainer's weights
on the trainer stream and records an event after the copy
(``core/weights.py::Published``); the rollout thread's pickup makes the
rollout stream wait for that event and marks the stored tensors as used
by the rollout stream (``weights.acquire``) before ``update_weights``
copies them, so a version the store evicts later keeps its memory until
the queued copy is done.  Each loop waits only for its own stream (the
engine's sampled tokens, the trainer's metrics).  The threads' streams
wait for the calling thread's stream when they start, and the calling
thread's stream waits for both when they end.

Single driver on the card: ring and paged decode and paged prefill keep
barrier counts per device that a second decode call in flight on
another stream would share (``kernels/decode_attention.py``,
``kernels/paged_prefill_attention.py``).  Every engine call stays on the
rollout thread (``RolloutEngine``'s single-driver contract) and the
trainer never decodes, so only one such kernel is ever in flight.  The
flash forward and backward hold no state between calls and run on both
streams.  Every kernel is built before the threads start
(``kernels/build.py``), so that no build lands inside the run.

When the scheduler carries an ``AsyncRewardService`` the runtime also
starts its reward-worker threads (DESIGN.md §Environments and reward
service): finished generations are verified off BOTH loops.

``run_serial`` drives the SAME components on one thread in strict
generate-then-train alternation: the forced-serial baseline that real
wall-clock overlap is measured against.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Protocol, runtime_checkable

import torch

from repro_torch.core.scheduler import AsyncScheduler, SchedulerExecutorMixin, StepLog
from repro_torch.core.weights import ENCODINGS, ParameterStore, acquire
from repro_torch.kernels import build
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace
from repro_torch.obs.recorder import FlightRecorder


@runtime_checkable
class Executor(Protocol):
    """The executor protocol every runtime implements (DESIGN.md §Async
    runtime): drive the shared ``AsyncScheduler`` policy core until the
    trainer has produced ``n_steps`` more policy versions, bounded by a
    wall-clock ``timeout``.  Implementations also expose the
    ``SchedulerExecutorMixin`` attribute surface plus ``clock`` (wall or
    virtual seconds of the last run) and ``effective_throughput()``.

    Implementations: ``core/controller.py::AsyncRLController`` (virtual
    clock) and ``core/runtime.py::ThreadedRuntime`` (two threads)."""

    sched: AsyncScheduler
    clock: float

    def run(self, n_steps: int, timeout: Optional[float] = None) -> List[StepLog]: ...

    def effective_throughput(self) -> float: ...


@dataclass
class RoleLiveness:
    """Per-role liveness snapshot for stall diagnostics (DESIGN.md
    §Supervision state machine): which thread a timed-out run should
    blame.  ``beat_age_s`` is seconds since the role's last heartbeat
    (the loop-top touch); None means it never beat."""
    role: str
    alive: bool
    beat_age_s: Optional[float]
    detail: str = ""


def format_liveness(roles: List[RoleLiveness]) -> str:
    """Render per-role liveness into the single diagnostic line of
    ``ThreadedRuntime.run``'s TimeoutError: 'role=trainer DEAD last-beat
    12.3s ago (version=4)'.  The stalest role sorts first so the culprit
    leads the message."""
    def order(r: RoleLiveness):
        age = r.beat_age_s if r.beat_age_s is not None else float("inf")
        return (r.alive, -age)

    parts = []
    for r in sorted(roles, key=order):
        beat = "never beat" if r.beat_age_s is None else f"last-beat {r.beat_age_s:.1f}s ago"
        state = "alive" if r.alive else "DEAD"
        detail = f" ({r.detail})" if r.detail else ""
        parts.append(f"role={r.role} {state} {beat}{detail}")
    return "; ".join(parts) if parts else "no roles running"


def _stream_of(device) -> Optional[torch.cuda.Stream]:
    """A new CUDA stream on ``device``, or None off CUDA (the CPU, the
    simulator's stubs)."""
    if device is None or torch.device(device).type != "cuda":
        return None
    return torch.cuda.Stream(device=device)


def _on(stream: Optional[torch.cuda.Stream]):
    return contextlib.nullcontext() if stream is None else torch.cuda.stream(stream)


class ThreadedRuntime(SchedulerExecutorMixin):
    """Two-thread executor for the async scheduling core.

    Parameters
    ----------
    engine, trainer : the rollout engine and PPO trainer (real or the
        simulator stubs — any duck-typed pair the virtual executor takes).
    scheduler : the shared ``AsyncScheduler`` policy core.
    store : ``ParameterStore`` carrying trainer→rollout publications
        (created if omitted).
    rollout_device : when set (the engine on another card than the
        trainer), published weights are ``push_weights``-ed onto it by
        the trainer thread before the store publication.
    weight_stream : ``"full"`` (default) publishes whole state dicts via
        the store; ``"delta"`` / ``"delta-q"`` stream chunked delta
        messages through an in-process queue instead (DESIGN.md
        §Streaming weight publication) — the rollout thread feeds a
        bounded number of chunks per tick into the engine's
        version-fenced decoder, so pickup overlaps decoding.
    stream_chunk_elems : elements per chunk when streaming.
    stream_chunks_per_tick : max stream messages fed per rollout tick.

    On CUDA the rollout and trainer loops run on ``rollout_stream`` and
    ``trainer_stream`` (see the module docstring).
    """

    def __init__(self, *, engine, trainer, scheduler: AsyncScheduler,
                 store: Optional[ParameterStore] = None, rollout_device=None,
                 idle_sleep: float = 1e-3, weight_stream: str = "full",
                 stream_chunk_elems: int = 65536, stream_chunks_per_tick: int = 8):
        self.engine = engine
        self.trainer = trainer
        self.sched = scheduler
        self.rl = scheduler.rl
        self.store = store or ParameterStore()
        self.rollout_device = rollout_device
        self.idle_sleep = idle_sleep
        if weight_stream not in ENCODINGS:
            raise ValueError(f"weight_stream must be one of {ENCODINGS}, got {weight_stream!r}")
        self.weight_stream = weight_stream
        self.stream_chunk_elems = stream_chunk_elems
        self.stream_chunks_per_tick = stream_chunks_per_tick
        # trainer→rollout stream channel (delta modes): the trainer thread
        # appends encoded messages, the rollout thread drains a bounded
        # slice per tick (DESIGN.md §Streaming weight publication)
        self._stream_q: collections.deque = collections.deque()
        self._stream_lock = threading.Lock()
        self._stream_base = None          # previous published HOST tree
        self._stream_base_version: Optional[int] = None
        # one record a streamed publication: version, encoding, chunks,
        # payload bytes and declared tolerance
        self.streams_sent: List[dict] = []
        # one CUDA stream per thread (None off CUDA)
        self.rollout_stream = _stream_of(getattr(engine, "device", None))
        trainer_model = getattr(trainer, "model", None)
        self.trainer_stream = _stream_of(getattr(trainer_model, "device", None))

        self.clock = 0.0                  # wall seconds of the last run
        self._t0 = 0.0
        self._stop = threading.Event()
        self._errors: List[BaseException] = []
        # crash flight recorder (DESIGN.md §Flight-recorder protocol):
        # always on — notable events only (pickups, train steps), so the
        # TimeoutError can show the recent past of a hung run
        self.flightrec = FlightRecorder(capacity=256)
        # per-role loop-top heartbeats: rollout/trainer touch these every
        # iteration so a timed-out run can say WHICH side stalled
        self._last_beat = {}

        # overlap accounting: trainer_busy_s is wall time inside
        # train_step; tokens_during_train counts tokens the rollout thread
        # generated while the trainer was mid-update — nonzero iff
        # generation and training truly overlap on the host's clock
        self.trainer_busy_s = 0.0
        self.tokens_during_train = 0
        self._train_busy = False

    def effective_throughput(self) -> float:
        """Tokens consumed by PPO updates per wall second."""
        return self.sched.tokens_consumed() / max(self.clock, 1e-9)

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    def _streams(self):
        return [s for s in (self.rollout_stream, self.trainer_stream) if s is not None]

    def _start_streams(self) -> None:
        """Before the threads start: every kernel built, and each
        thread's stream after the work the calling thread has queued
        (the models, the engine's cache)."""
        if not self._streams():
            return
        build.build()
        for s in self._streams():
            s.wait_stream(torch.cuda.current_stream(s.device))

    def _join_streams(self) -> None:
        """After the threads end: the calling thread's stream after all
        the work they queued."""
        for s in self._streams():
            torch.cuda.current_stream(s.device).wait_stream(s)

    # ---- rollout side -----------------------------------------------------
    def _maybe_pickup_weights(self, drain: bool = False) -> None:
        """Step-boundary weight pickup.  Full mode: if the trainer
        published a newer version, interrupt + re-prefill (rollout-thread
        work, on the rollout stream — the only generation-side cost of an
        update).  Stream mode: feed at most ``stream_chunks_per_tick``
        queued chunk messages into the engine's version-fenced decoder
        (DESIGN.md §Version fence) so the transfer overlaps decoding;
        ``drain=True`` (end of run) feeds everything queued."""
        if self.weight_stream != "full":
            budget = None if drain else self.stream_chunks_per_tick
            fed = 0
            while budget is None or fed < budget:
                with self._stream_lock:
                    msg = self._stream_q.popleft() if self._stream_q else None
                if msg is None:
                    break
                fed += 1
                if self.engine.feed_weight_message(msg, interruptible=self.rl.interruptible):
                    self.sched.note_pickup(self.engine.version, self._now())
                    self.flightrec.record("stream_flip", version=self.engine.version)
            return
        latest = self.store.latest()
        if latest is not None and latest[0] > self.engine.version:
            version, weights = latest
            acquire(weights)
            self.engine.update_weights(weights, version, interruptible=self.rl.interruptible)
            self.sched.note_pickup(version, self._now())
            self.flightrec.record("pickup", version=version)

    def _rollout_tick(self) -> bool:
        """One admission + decode round; returns True if any slot advanced."""
        eng = self.engine
        self._maybe_pickup_weights()
        eng.maybe_apply_pending()
        if not eng.has_pending_weights:
            reqs = self.sched.plan_admission(len(eng.free_slots()))
            if reqs:
                n = eng.admit(reqs, clock=self._now())
                # the engine's own pool-pressure count drives requeue
                # (free_slots() cannot see block headroom)
                self.sched.admitted(reqs, n, deferred=getattr(eng, "deferred_last", 0))
        if eng.n_active == 0:
            return False
        n_act = eng.n_active
        busy = self._train_busy           # sampled before the step
        finished = eng.step()
        if busy:
            self.tokens_during_train += n_act
        self.sched.collect(finished, finish_time=self._now())
        return True

    def _rollout_loop(self) -> None:
        try:
            with _on(self.rollout_stream):
                while not self._stop.is_set():
                    self._last_beat["rollout"] = time.monotonic()
                    if not self._rollout_tick():
                        time.sleep(self.idle_sleep)
        except BaseException as e:       # noqa: BLE001 — surfaced in run()
            self._errors.append(e)
            self._stop.set()
        finally:
            release = getattr(self.engine, "release_driver", None)
            if release:
                release()

    # ---- trainer side -----------------------------------------------------
    def _train_once(self, batch) -> StepLog:
        self.sched.record_consumed(batch)
        self._train_busy = True
        t0 = time.perf_counter()
        try:
            with trace.span("trainer.train_step", version=self.trainer.version + 1,
                            n=len(batch)):
                metrics = self.trainer.train_step(batch)
        finally:
            self._train_busy = False
            self.trainer_busy_s += time.perf_counter() - t0
        self.flightrec.record("train_step", version=self.trainer.version, n=len(batch))
        # publication OFF the generation path: the copy (onto the rollout
        # card, when it is another) runs on THIS thread; rollout picks the
        # result up at its next step boundary
        params = self.trainer.params
        if self.rollout_device is not None:
            from repro_torch.launch.disaggregated import push_weights
            params = push_weights(params, self.rollout_device)
        self.sched.note_published(self.trainer.version, self._now())
        if self.weight_stream != "full":
            # delta modes: encode against the previous published host tree
            # and enqueue the chunk messages; the store publication below
            # stays the canonical history/checkpoint path (the rollout
            # thread ignores it in stream mode)
            from repro_torch.launch.disaggregated import stream_weights
            host, stream = stream_weights(
                self.trainer.params, version=self.trainer.version, base=self._stream_base,
                base_version=self._stream_base_version, encoding=self.weight_stream,
                chunk_elems=self.stream_chunk_elems)
            self._stream_base = host
            self._stream_base_version = self.trainer.version
            self.streams_sent.append({
                "version": self.trainer.version, "encoding": stream.messages[0].encoding,
                "n_chunks": stream.n_chunks, "nbytes": stream.nbytes(),
                "tolerance": stream.tolerance()})
            with self._stream_lock:
                self._stream_q.extend(stream)
        self.store.publish(self.trainer.version, params)
        self.sched.note_policy_update(self.trainer.version)
        return self.sched.log_step(
            metrics, version=self.trainer.version, clock=self._now(),
            gen_tokens_total=self.engine.tokens_generated,
            interruptions=self.engine.interruptions)

    def _trainer_loop(self, target: int) -> None:
        try:
            with _on(self.trainer_stream):
                while self.trainer.version < target and not self._stop.is_set():
                    self._last_beat["trainer"] = time.monotonic()
                    batch = self.sched.buffer.pop_batch(self.rl.batch_size, timeout=0.2)
                    if batch is None:
                        if self.sched.buffer.closed:
                            break
                        continue
                    self._train_once(batch)
        except BaseException as e:       # noqa: BLE001 — surfaced in run()
            self._errors.append(e)
        finally:
            self._stop.set()             # rollout exits at its next tick

    # ---- entry points -----------------------------------------------------
    def _finish(self) -> None:
        """On the calling thread, once no loop runs: pick up the final
        published version (draining the whole stream queue in delta
        modes) so the engine's weights match the trainer's, as the
        synchronous executors guarantee, then release the engine so a
        later run's fresh rollout thread can bind."""
        self._maybe_pickup_weights(drain=True)
        self.engine.maybe_apply_pending()
        release = getattr(self.engine, "release_driver", None)
        if release:
            release()

    def run(self, n_steps: int, timeout: Optional[float] = None) -> List[StepLog]:
        """Run until the trainer completes ``n_steps`` more versions.

        ``timeout`` (wall seconds) bounds the whole run: on expiry both
        threads are signalled to stop and TimeoutError is raised — a
        deadlock fails fast instead of hanging.  The buffer stays open,
        so the run can be retried with a larger deadline.  ``n_steps`` of
        0 starts no thread (a launcher may build the runtime for
        ``run_serial``)."""
        if n_steps <= 0:
            return self.sched.history
        target = self.trainer.version + n_steps
        self._stop.clear()
        self._errors.clear()
        # reward workers: when the scheduler carries an AsyncRewardService,
        # its pool scores finished generations off both loops
        svc = getattr(self.sched, "reward_service", None)
        if svc is not None:
            svc.start()
        self._start_streams()
        self._t0 = time.perf_counter()
        rollout = threading.Thread(target=self._rollout_loop, name="areal-rollout", daemon=True)
        trainer = threading.Thread(target=self._trainer_loop, args=(target,),
                                   name="areal-trainer", daemon=True)
        rollout.start()
        trainer.start()
        trainer.join(timeout)
        if trainer.is_alive():
            # sample liveness BEFORE signalling stop — the diagnostics
            # should describe the stall, not the shutdown
            now = time.monotonic()

            def age(role: str) -> Optional[float]:
                beat = self._last_beat.get(role)
                return None if beat is None else now - beat

            liveness = [
                RoleLiveness("rollout", rollout.is_alive(), age("rollout"),
                             f"active={self.engine.n_active}"),
                RoleLiveness("trainer", trainer.is_alive(), age("trainer"),
                             f"version={self.trainer.version}"),
            ]
            # _stop alone unblocks both threads (the trainer's pop_batch
            # polls on a short timeout), so the buffer stays open and the
            # runtime can be re-run with a larger deadline
            self._stop.set()
            trainer.join(10.0)
            rollout.join(10.0)
            self.clock = time.perf_counter() - self._t0
            stream = obs_metrics.scrape(self.engine, surfaces=("stream_stats",))
            raise TimeoutError(
                f"threaded runtime exceeded {timeout}s at version "
                f"{self.trainer.version}/{target} "
                f"(buffered={len(self.sched.buffer)}, "
                f"active={self.engine.n_active}, "
                f"unscored={self.sched.pending_rewards()}): "
                + format_liveness(liveness)
                + f"; publication={self.sched.publication_stats()}"
                + f"; stream={stream}"
                + f"; flight-recorder tail: {self.flightrec.format_tail()}")
        rollout.join(30.0)
        self.clock = time.perf_counter() - self._t0
        if rollout.is_alive():
            # do NOT touch the engine: the stuck thread still owns it
            raise RuntimeError(
                "rollout thread failed to stop within 30s of the trainer "
                f"finishing (active={self.engine.n_active}); engine state "
                "was left to the stuck thread")
        self._join_streams()
        if self._errors:
            raise self._errors[0]
        self._finish()
        return self.sched.history

    def run_serial(self, n_steps: int, max_idle_ticks: int = 1000) -> List[StepLog]:
        """Forced-serial baseline: the same engine/trainer/scheduler on
        ONE thread (the caller's, on its current stream), strictly
        alternating generate-until-batch-ready and train — the
        colocated-synchronous regime the paper's asynchrony is measured
        against."""
        target = self.trainer.version + n_steps
        self._t0 = time.perf_counter()
        while self.trainer.version < target:
            idle = 0
            while len(self.sched.buffer) < self.rl.batch_size:
                if self._rollout_tick():
                    idle = 0
                else:
                    idle += 1
                    if idle > max_idle_ticks:
                        raise RuntimeError(
                            "serial runtime stalled: no active slots and "
                            "no admissible requests (check eta/batch/slots)")
            batch = self.sched.buffer.pop_batch(self.rl.batch_size)
            assert batch is not None
            self._train_once(batch)
        self._finish()                    # symmetric with run(): re-entrant
        self.clock = time.perf_counter() - self._t0
        return self.sched.history
