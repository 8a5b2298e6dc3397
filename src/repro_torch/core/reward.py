"""Reward service (Section 4.1): rule-based verification of generated
responses, decoupled from the accelerator path.

A copy of ``repro/core/reward.py``, which needs no JAX: importing it would run
the JAX package's ``__init__``, so the port keeps its own.

In AReaL this is a CPU worker pool whose latency is pipelined behind
generation; here verification is exact string matching on the synthetic
math task, executed host-side, and the *latency model* (TimingModel in
controller.py) accounts for its pipelined cost.  The service records
accuracy statistics used by the benchmarks.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, Optional

from repro_torch.data import tasks, tokenizer


@dataclass
class RewardService:
    reward_correct: float = 5.0
    reward_incorrect: float = -5.0
    n_evaluated: int = 0
    n_correct: int = 0
    recent: Optional[Deque[float]] = None      # built in __post_init__
    recent_window: int = 512

    def __post_init__(self):
        # a deque(maxlen) keeps the recent-accuracy window O(1) per score
        # (the old list re-slice copied the whole window per trajectory)
        if self.recent is None:
            self.recent = deque(maxlen=self.recent_window)
        elif not isinstance(self.recent, deque):
            self.recent = deque(self.recent, maxlen=self.recent_window)

    def record(self, ok: bool) -> float:
        """Fold one already-verified outcome into the accuracy stats and
        return its reward.  This is the stats half of ``score``; the
        environment subsystem (repro/env/, DESIGN.md §Environments and
        reward service) verifies responses itself — possibly on a reward
        worker thread — and deposits only the verdict here."""
        self.n_evaluated += 1
        self.n_correct += int(ok)
        self.recent.append(1.0 if ok else 0.0)
        return self.reward_correct if ok else self.reward_incorrect

    def score(self, response_tokens, answer) -> float:
        """Reward at the final token: +5 correct / -5 incorrect (App. B.1)."""
        if answer is None:
            ok = False          # simulator fast-path: no decode needed
        else:
            text = tokenizer.decode(response_tokens)
            ok = tasks.verify(text, str(answer))
        return self.record(ok)

    @property
    def accuracy(self) -> float:
        return self.n_correct / self.n_evaluated if self.n_evaluated else 0.0

    @property
    def recent_accuracy(self) -> float:
        return sum(self.recent) / len(self.recent) if self.recent else 0.0
