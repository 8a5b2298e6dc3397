"""Virtual-clock executor (Section 4.1, Figure 2/3): drives the shared
scheduling core (core/scheduler.py) under an explicit **virtual clock**
driven by a TimingModel.

A copy of ``repro/core/controller.py``, which needs no JAX: importing it would run
the JAX package's ``__init__``, so the port keeps its own.  It drives
the port's ``RolloutEngine`` and ``PPOTrainer``, whose computation runs
on the card's kernels; ``ThreadedRuntime`` is a later part of the port.

The policy — staleness-gated admission, reward collection, oldest-first
batch formation, weight-publication accounting — lives in
``AsyncScheduler`` (DESIGN.md §Async runtime); this executor supplies the
*transport*: deterministic single-thread interleaving of the real
computation (generation + PPO updates) with measurable concurrency
semantics on one device — the structure of AReaL's asynchronous
pipeline without nondeterministic threads:

  * rollout workers decode continuously; each decode step advances the
    clock by the generation-pool cost of one token step;
  * when a global batch is available, the trainer becomes busy for the
    training-pool cost; the weights it produces are applied when the
    clock reaches its completion time — generation in between keeps
    using the old weights, exactly like Figure 3;
  * weight application triggers the engine's interruption + re-prefill
    (or waits for drain in the non-interruptible ablation);
  * admission respects the staleness controller (Eq. 3);
  * reward computation and weight transfer are pipelined (latency-only).

The same executor drives the pure-timing cluster simulator
(core/simulator.py provides stub engine/trainer with the same duck-typed
API), which is how the paper-scale scaling figures are produced.  For
real two-thread execution on disjoint device submeshes, see
``core/runtime.py::ThreadedRuntime`` — same scheduler, real transport.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

from repro_torch.configs.base import RLConfig
from repro_torch.core.reward import RewardService
from repro_torch.core.scheduler import (AsyncScheduler,  # noqa: F401  (re-export)
                                  SchedulerExecutorMixin, StepLog)


@dataclass
class TimingModel:
    """Virtual-time costs (seconds).  Defaults are laptop-scale stand-ins;
    launch/roofline.py derives cluster-scale values from dry-run terms."""
    decode_step: Callable[[int], float] = lambda n_active: 1.0
    prefill: Callable[[int], float] = lambda n_tokens: 0.0
    train_step: Callable[[int], float] = lambda n_tokens: 40.0
    weight_sync: float = 0.0
    reward_latency: float = 0.0          # pipelined: latency only
    colocated: bool = False              # sync baseline: gen and train share
                                         # devices, so phases serialize


class AsyncRLController(SchedulerExecutorMixin):
    def __init__(self, *, engine, trainer, prompt_stream=None,
                 rl: Optional[RLConfig] = None,
                 timing: Optional[TimingModel] = None,
                 reward: Optional[RewardService] = None,
                 on_step: Optional[Callable] = None,
                 scheduler: Optional[AsyncScheduler] = None):
        self.engine = engine
        self.trainer = trainer
        if scheduler is not None:
            if prompt_stream is not None or reward is not None \
                    or on_step is not None:
                raise ValueError(
                    "scheduler= already owns prompt_stream/reward/on_step; "
                    "configure them on the AsyncScheduler instead")
            if rl is not None and rl is not scheduler.rl:
                raise ValueError(
                    "rl= disagrees with scheduler.rl; the scheduler's "
                    "RLConfig governs admission and must be the same object")
            self.sched = scheduler
            self.rl = scheduler.rl
        else:
            if prompt_stream is None or rl is None:
                raise ValueError(
                    "AsyncRLController needs prompt_stream= and rl= "
                    "(or a prebuilt scheduler=)")
            self.rl = rl
            self.sched = AsyncScheduler(prompt_stream=prompt_stream, rl=rl,
                                        reward=reward, on_step=on_step)
        if getattr(self.sched, "reward_service", None) is not None:
            raise ValueError(
                "the virtual-clock executor cannot drive a real "
                "AsyncRewardService (its worker threads are wall-clock); "
                "model pipelined verification with "
                "TimingModel.reward_latency instead, or use "
                "ThreadedRuntime (DESIGN.md §Environments and reward service)")
        self.timing = timing or TimingModel()
        self.clock = 0.0
        self._train_batch = None
        self._train_done_at = 0.0
        # pipelined reward stage (mirrors AsyncRewardService under the
        # virtual clock): finished generations become visible to batch
        # formation only reward_latency later — (ready_time, finished)
        # pairs drained at the top of every loop iteration
        self._pending_scored: List = []
        # chunked engines (DESIGN.md §Chunked prefill) do prefill work
        # inside step(), not at admission/interrupt: bill it there
        self._chunked = getattr(engine, "prefill_chunk", 0) > 0

    # ---- pieces -----------------------------------------------------------
    def _admit(self) -> None:
        if self.engine.has_pending_weights:
            return        # non-interruptible drain: no new admissions
        reqs = self.sched.plan_admission(len(self.engine.free_slots()))
        if reqs:
            # paged engines may take fewer than offered (pool exhaustion);
            # the scheduler requeues the remainder for the next plan,
            # gated by the engine's own deferral count rather than
            # another free_slots() probe
            n = self.engine.admit(reqs, clock=self.clock)
            self.sched.admitted(reqs, n,
                                deferred=getattr(self.engine,
                                                 "deferred_last", 0))
            if not self._chunked:
                # chunked admission does no prefill here: its ingest spans
                # are billed inside the step loop as they actually run
                self.clock += self.timing.prefill(
                    sum(len(r["prompt"]) for r in reqs[:n]))

    def _collect(self, finished) -> None:
        """Queue finished generations behind the (virtual) verification
        pipeline: they deposit into the buffer when the clock reaches
        ``clock + reward_latency`` — with zero latency this reduces
        exactly to the old immediate-deposit behavior (drained at the
        next loop top, before any batch can form), which is what keeps
        the pre-env StepLog goldens bit-for-bit."""
        if not finished:
            return
        self._pending_scored.append(
            (self.clock + self.timing.reward_latency, list(finished)))

    def _drain_scored(self, force: bool = False) -> None:
        remaining = []
        for ready, fins in self._pending_scored:
            if force or ready <= self.clock:
                self.sched.collect(fins, finish_time=ready)
            else:
                remaining.append((ready, fins))
        self._pending_scored = remaining

    def pending_rewards(self) -> int:
        """Finished-but-unscored trajectories inside the virtual reward
        pipeline (the executor-side mirror of
        ``AsyncScheduler.pending_rewards``)."""
        return sum(len(f) for _, f in self._pending_scored)

    def _maybe_start_training(self) -> None:
        if self._train_batch is not None:
            return
        batch = self.sched.buffer.pop_batch(self.rl.batch_size)
        if batch is None:
            return
        self._train_batch = batch
        cost = self.timing.train_step(sum(t.length for t in batch))
        self._train_done_at = self.clock + cost
        if self.timing.colocated:
            # synchronous/colocated baseline: generation pauses while the
            # shared devices run the PPO update
            self.clock = self._train_done_at

    def _maybe_finish_training(self) -> None:
        if self._train_batch is None or self.clock < self._train_done_at:
            return
        batch = self._train_batch
        self._train_batch = None
        self.sched.record_consumed(batch)
        metrics = self.trainer.train_step(batch)
        self.sched.note_policy_update(self.trainer.version)
        self.clock += self.timing.weight_sync
        inflight = self.engine.inflight_tokens()
        applied = self.engine.update_weights(
            self.trainer.params, self.trainer.version,
            interruptible=self.rl.interruptible)
        if applied and inflight and not self._chunked:
            # interruption overhead: re-prefill of every in-flight prefix
            # (chunked engines amortize it: billed per span in the step
            # loop instead of as a lump here)
            self.clock += self.timing.prefill(inflight)
        self.sched.log_step(metrics, version=self.trainer.version,
                            clock=self.clock,
                            gen_tokens_total=self.engine.tokens_generated,
                            interruptions=self.engine.interruptions)

    # ---- main loop ----------------------------------------------------------
    def run(self, n_steps: int, max_wallclock: float = float("inf")) -> List[StepLog]:
        target = self.trainer.version + n_steps
        stall_guard = 0
        while self.trainer.version < target and self.clock < max_wallclock:
            self._drain_scored()
            self._maybe_finish_training()
            self.engine.maybe_apply_pending()
            self._admit()
            self._maybe_start_training()
            if self.engine.n_active > 0:
                if self._chunked:
                    ing0 = (self.engine.prefill_tokens
                            + self.engine.reprefill_tokens
                            + getattr(self.engine, "continuation_tokens", 0))
                finished = self.engine.step()
                self.clock += self.timing.decode_step(self.engine.n_active)
                if self._chunked:
                    # bill the span(s) this step actually ingested (the
                    # engine's counters are span-length for admission,
                    # deduped writes for re-ingest and appended tokens
                    # for multi-turn continuation — the cost the chunked
                    # engine actually pays)
                    ing = (self.engine.prefill_tokens
                           + self.engine.reprefill_tokens
                           + getattr(self.engine, "continuation_tokens", 0)
                           ) - ing0
                    if ing:
                        self.clock += self.timing.prefill(ing)
                self._collect(finished)
                stall_guard = 0
            elif self._train_batch is not None:
                self.clock = max(self.clock, self._train_done_at)
                stall_guard = 0
            elif self._pending_scored:
                # everything is waiting on the verification pipeline:
                # jump to the earliest reward completion (pipelined
                # latency, Section 4.1)
                self.clock = max(self.clock,
                                 min(r for r, _ in self._pending_scored))
                stall_guard = 0
            else:
                stall_guard += 1
                if stall_guard > 10:
                    raise RuntimeError(
                        "controller stalled: no active slots, no training, "
                        "no admissible requests (check eta/batch/slots)")
                self.clock += 1e-6
        self._drain_scored(force=True)     # post-run buffer state matches
        return self.history

    # ---- derived metrics ----------------------------------------------------
    def effective_throughput(self) -> float:
        """Paper Sec 7.3: rate of consuming generated tokens during PPO
        updates (tokens/virtual-second)."""
        if not self.history:
            return 0.0
        return self.sched.tokens_consumed() / max(self.history[-1].clock, 1e-9)
