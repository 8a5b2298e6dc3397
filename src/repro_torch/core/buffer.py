"""Trajectory replay buffer (Section 4.1, Trainer Workers).

A copy of ``repro/core/buffer.py``, which needs no JAX: importing it
would run the JAX package's ``__init__``, so the port keeps its own.

Semantics from the paper: trainer workers accumulate rollouts until the
configured batch size, *older trajectories are prioritized* when forming
a batch, and every sample is used exactly once ("data from the replay
buffer is used only once").

Thread-safety is load-bearing (DESIGN.md §Async runtime): the threaded
runtime's rollout thread ``add``s while the trainer thread blocks in
``pop_batch(timeout=...)`` on a condition variable; ``close()`` wakes
every waiter for clean shutdown.  ``add`` inserts in
``(behavior_version, rid)`` order, so batch formation is O(batch) on the
trainer hot path instead of an O(n log n) re-sort per pop.
"""
from __future__ import annotations

import threading
import time
from bisect import insort
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class Trajectory:
    rid: int                          # request id
    prompt_id: int                    # group id (prompt) for GRPO/RLOO
    prompt_tokens: List[int]
    response_tokens: List[int]
    behav_logprobs: List[float]       # per response token, at generation time
    versions: List[int]               # per-token producing policy version
    behavior_version: int             # version at submission (for staleness)
    reward: float = 0.0
    answer: Any = None
    meta: Dict = field(default_factory=dict)
    submit_time: float = 0.0
    finish_time: float = 0.0

    @property
    def length(self) -> int:
        return len(self.prompt_tokens) + len(self.response_tokens)

    @property
    def n_versions(self) -> int:
        return len(set(self.versions)) if self.versions else 1


class ReplayBuffer:
    """FIFO-by-age, use-once buffer; thread-safe, optionally blocking."""

    def __init__(self):
        self._items: List[Trajectory] = []
        self._cond = threading.Condition()
        self._closed = False
        self.total_added = 0
        self.total_consumed = 0

    def add(self, traj: Trajectory) -> None:
        with self._cond:
            if self._closed:
                raise RuntimeError("ReplayBuffer.add() after close()")
            # maintain (behavior_version, rid) order at insert time: rids
            # are unique, so this is the same total order the per-pop sort
            # used to produce
            insort(self._items, traj,
                   key=lambda t: (t.behavior_version, t.rid))
            self.total_added += 1
            self._cond.notify_all()

    def close(self) -> None:
        """End the stream: wake every blocked ``pop_batch`` (they return
        whatever full batch is available, else None).  Idempotent."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed

    def __len__(self) -> int:
        with self._cond:
            return len(self._items)

    def pop_batch(self, batch_size: int,
                  timeout: Optional[float] = None) -> Optional[List[Trajectory]]:
        """Oldest-first batch; None if not enough data.  Each returned
        trajectory leaves the buffer permanently (use-once).

        ``timeout=None`` (default) is the non-blocking legacy behavior.
        A positive ``timeout`` blocks until a full batch is buffered, the
        buffer is closed, or the deadline passes — the trainer thread's
        wait point in the threaded runtime."""
        with self._cond:
            if timeout:
                deadline = time.monotonic() + timeout
                while len(self._items) < batch_size and not self._closed:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
            if len(self._items) < batch_size:
                return None
            batch = self._items[:batch_size]
            del self._items[:batch_size]
            self.total_consumed += batch_size
            return batch
