"""Cluster-scale discrete-event simulation of the AReaL pipeline.

A copy of ``repro/core/simulator.py``, which needs no JAX: importing it would run
the JAX package's ``__init__``, so the port keeps its own.  Its costs
are the reference's analytic TPU model, kept so that the virtual clock
of a run matches the reference's; they say nothing of the GPU the port
computes on.

Stub engine/trainer with the same duck-typed API as the real
RolloutEngine/PPOTrainer, driven by the SAME AsyncRLController — the
control flow (staleness admission, interruption, buffering, minibatch
cadence) is identical; only the token-level compute is replaced by
virtual durations from an analytic hardware model.

This is how the paper-scale studies are produced on CPU:
  Table 1   end-to-end hours, sync vs async, equal device count
  Figure 4  effective-throughput scaling vs device count
  Figure 6b interruptible-generation ablation

The hardware model is TPU v5e (197 bf16 TFLOP/s, 819 GB/s HBM,
~50 GB/s/link ICI) with generation in the memory-bound decode regime and
training at a configurable MFU — the same constants as §Roofline, so the
simulator and the dry-run roofline table are mutually consistent.
"""
from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.controller import TimingModel
from repro_torch.core.rollout import Finished
from repro_torch.core.trainer import TrainMetrics


# ---------------------------------------------------------------------------
# Hardware / workload model
# ---------------------------------------------------------------------------

@dataclass
class HardwareModel:
    peak_flops: float = 197e12          # bf16 / chip
    hbm_bw: float = 819e9               # bytes/s / chip
    ici_bw: float = 50e9                # bytes/s / link
    train_mfu: float = 0.4
    prefill_mfu: float = 0.5


@dataclass
class WorkloadModel:
    n_params: float                     # model parameters
    n_active_params: float = 0.0        # MoE active (0 -> dense)
    param_bytes: float = 2.0            # bf16 weights for serving
    kv_bytes_per_token: float = 0.0     # per-token KV cache traffic

    @property
    def active(self) -> float:
        return self.n_active_params or self.n_params


def make_llm_timing(hw: HardwareModel, wl: WorkloadModel, *,
                    n_gen_devices: int, n_train_devices: int,
                    colocated: bool = False,
                    slots_per_worker: int = 128) -> TimingModel:
    """Analytic TimingModel for an LLM RL pipeline.

    Decode is memory-IO bound at small per-worker batch (weights stream
    from HBM every step — the paper's Sec 3.2 scalability argument) and
    compute-bound at large batch; prefill and training are compute-bound.
    """
    weight_bytes = wl.active * wl.param_bytes
    n_workers = max(1, n_gen_devices)   # model-parallel group = 1 device here

    def decode_step(n_active: int) -> float:
        per_worker = max(1.0, n_active / n_workers)
        mem_t = (weight_bytes + per_worker * wl.kv_bytes_per_token) / hw.hbm_bw
        comp_t = per_worker * 2.0 * wl.active / hw.peak_flops
        return max(mem_t, comp_t)

    def prefill(n_tokens: int) -> float:
        return (2.0 * wl.active * n_tokens
                / (hw.peak_flops * hw.prefill_mfu * max(n_gen_devices, 1)))

    def train_step(n_tokens: int) -> float:
        return (6.0 * wl.active * n_tokens
                / (hw.peak_flops * hw.train_mfu * max(n_train_devices, 1)))

    weight_sync = weight_bytes / hw.ici_bw

    return TimingModel(decode_step=decode_step, prefill=prefill,
                       train_step=train_step, weight_sync=weight_sync,
                       colocated=colocated)


# ---------------------------------------------------------------------------
# Stub engine / trainer
# ---------------------------------------------------------------------------

@dataclass
class _SimSlot:
    active: bool = False
    rid: int = -1
    prompt_id: int = -1
    prompt_len: int = 0
    target_len: int = 0
    generated: int = 0
    behavior_version: int = 0
    versions: set = field(default_factory=set)
    submit_time: float = 0.0


class SimEngine:
    """Same API as RolloutEngine; one step() = one decode tick for all
    active slots.  Response lengths are drawn from a lognormal matched to
    LRM length skew (mean/p95 configurable)."""

    def __init__(self, *, n_slots: int, mean_len: float, max_len: int,
                 prompt_len: int = 1024, sigma: float = 0.8, seed: int = 0,
                 version: int = 0):
        self.n_slots = n_slots
        self.prompt_len = prompt_len
        self.max_len = max_len
        self.mean_len = mean_len
        self.sigma = sigma
        self.rng = np.random.default_rng(seed)
        self.version = version
        self.slots = [_SimSlot() for _ in range(n_slots)]
        self._pending_weights = None
        self.tokens_generated = 0
        self.interruptions = 0
        self.params = None
        self._driver_thread = None

    # same single-driver contract as the real engine, per
    # DESIGN.md §Async runtime: the threaded runtime's thread discipline
    # is exercised even in pure-simulation runs
    def _assert_single_driver(self) -> None:
        me = threading.get_ident()
        if self._driver_thread is None:
            self._driver_thread = me
        elif self._driver_thread != me:
            raise RuntimeError(
                f"SimEngine is single-driver: bound to thread "
                f"{self._driver_thread}, driven from {me}")

    def release_driver(self) -> None:
        self._driver_thread = None

    def _draw_len(self) -> int:
        mu = math.log(self.mean_len) - 0.5 * self.sigma ** 2
        return int(np.clip(self.rng.lognormal(mu, self.sigma), 8, self.max_len))

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if not s.active]

    @property
    def n_active(self) -> int:
        return sum(s.active for s in self.slots)

    @property
    def has_pending_weights(self) -> bool:
        return self._pending_weights is not None

    def inflight_tokens(self) -> int:
        return sum(s.prompt_len + s.generated for s in self.slots if s.active)

    def admit(self, requests: Sequence[Dict], clock: float = 0.0) -> int:
        self._assert_single_driver()
        free = self.free_slots()
        take = list(requests)[:len(free)]
        for j, req in enumerate(take):
            s = self.slots[free[j]]
            s.active = True
            s.rid = req["rid"]
            s.prompt_id = req.get("prompt_id", req["rid"])
            p = req.get("prompt")
            s.prompt_len = len(p) if p is not None else self.prompt_len
            s.target_len = self._draw_len()
            s.generated = 0
            s.behavior_version = self.version
            s.versions = {self.version}
            s.submit_time = clock
        return len(take)

    def step(self) -> List[Finished]:
        self._assert_single_driver()
        finished = []
        for i, s in enumerate(self.slots):
            if not s.active:
                continue
            s.generated += 1
            s.versions.add(self.version)
            self.tokens_generated += 1
            if s.generated >= s.target_len:
                finished.append(Finished(
                    rid=s.rid, prompt_id=s.prompt_id,
                    prompt=np.zeros(s.prompt_len, np.int16),
                    response=np.zeros(s.generated, np.int16),
                    logprobs=np.zeros(s.generated, np.float32),
                    versions=sorted(s.versions),
                    behavior_version=s.behavior_version,
                    answer=None, submit_time=s.submit_time, truncated=False))
                self.slots[i] = _SimSlot()
        return finished

    def update_weights(self, params, version: int, *,
                       interruptible: bool = True) -> bool:
        self._assert_single_driver()
        if not interruptible and self.n_active > 0:
            self._pending_weights = (params, version)
            return False
        self.version = version
        if self.n_active:
            self.interruptions += 1
        return True

    def maybe_apply_pending(self) -> bool:
        self._assert_single_driver()
        if self._pending_weights is not None and self.n_active == 0:
            _, version = self._pending_weights
            self._pending_weights = None
            self.version = version
            return True
        return False


class SimTrainer:
    """Duck-typed PPOTrainer stub: bumps the version, reports stats."""

    def __init__(self):
        self.version = 0
        self.params = None

    def train_step(self, batch) -> TrainMetrics:
        self.version += 1
        stal = [max(0, (self.version - 1) - t.behavior_version) for t in batch]
        return TrainMetrics(
            version=self.version, loss=0.0,
            reward_mean=float(np.mean([t.reward for t in batch])),
            seq_len_mean=float(np.mean([t.length for t in batch])),
            staleness_mean=float(np.mean(stal)), staleness_max=int(np.max(stal)),
            n_tokens=int(sum(t.length for t in batch)), n_microbatches=0)


class SimPromptStream:
    """Prompt stream stub for the simulator (no real tokens needed)."""

    class _P:
        def __init__(self, pid, plen):
            self.pid = pid
            self.prompt_tokens = np.zeros(plen, np.int16)
            self.answer = None

    def __init__(self, prompt_len: int = 1024, answers_per_prompt: int = 16):
        self.prompt_len = prompt_len
        self.answers_per_prompt = answers_per_prompt
        self._n = 0

    def next_request(self):
        gid = self._n // self.answers_per_prompt
        self._n += 1
        return self._P(gid, self.prompt_len), gid
