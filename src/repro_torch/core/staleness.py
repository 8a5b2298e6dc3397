"""Staleness-aware admission control (Section 5.1, Eq. 3).

A copy of ``repro/core/staleness.py``, which needs no JAX: importing it would run
the JAX package's ``__init__``, so the port keeps its own.

The rollout controller may submit a new generation request only while

    floor((N_r - 1) / B) <= i + eta

with N_r the total number of trajectories generated or in flight, B the
training batch size, i the current policy version and eta the maximum
permitted staleness.  eta = 0 degenerates to synchronous RL: exactly one
batch may be in flight per policy version.

What counts toward N_r is the scheduler's job, not this controller's:
``n_submitted`` is incremented exactly once per request (first hand-off
toward an engine) and NEVER decremented — generating, interrupted,
requeued-after-crash and finished-but-unscored requests all remain
inside N_r until trained on (DESIGN.md §Staleness accounting with
pending-unscored trajectories).  The controller only answers Eq. 3.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class StalenessController:
    batch_size: int                  # B
    max_staleness: float             # eta (math.inf allowed)
    n_submitted: int = 0             # N_r
    policy_version: int = 0          # i
    rejections: int = 0

    def can_submit(self, n_new: int = 1) -> bool:
        """Would submitting ``n_new`` more requests keep Eq. 3 satisfied?"""
        if math.isinf(self.max_staleness):
            return True
        nr = self.n_submitted + n_new
        return (nr - 1) // self.batch_size <= self.policy_version + self.max_staleness

    def submit(self, n_new: int = 1) -> bool:
        if self.can_submit(n_new):
            self.n_submitted += n_new
            return True
        self.rejections += 1
        return False

    def on_policy_update(self, new_version: int) -> None:
        assert new_version >= self.policy_version
        self.policy_version = new_version

    def sample_staleness(self, behavior_version: int) -> int:
        """Staleness of a sample consumed now (train steps elapsed)."""
        return self.policy_version - behavior_version


@dataclass
class StalenessStats:
    """Tracks the staleness distribution of consumed training samples."""
    counts: Dict[int, int] = field(default_factory=dict)

    def record(self, staleness: int) -> None:
        self.counts[staleness] = self.counts.get(staleness, 0) + 1

    def histogram(self) -> List:
        return sorted(self.counts.items())

    @property
    def mean(self) -> float:
        n = sum(self.counts.values())
        if not n:
            return 0.0
        return sum(k * v for k, v in self.counts.items()) / n

    @property
    def max(self) -> int:
        return max(self.counts) if self.counts else 0
