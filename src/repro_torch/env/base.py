"""Environment protocol (DESIGN.md §Environments and reward service).

A copy of ``repro/env/base.py``, which needs no JAX: importing it would run the JAX
package's ``__init__``, so the port keeps its own.

AReaL's fourth component — the reward service — verifies trajectories
produced by the rollout workers; Section 4.1 pipelines its latency
behind generation.  An ``Environment`` bundles everything the pipeline
needs to know about one verifiable workload:

  * ``sample()``     — a stream of tasks (``data/tasks.py::Problem``
                       instances: prompt tokens + ground-truth answer);
  * ``verify(fin)``  — score one finished generation.  This is the
                       potentially SLOW part (the code environment runs
                       a sandboxed subprocess); callers must assume it
                       blocks for up to the environment's own timeout
                       and route it through ``AsyncRewardService`` to
                       keep it off the rollout thread;
  * ``follow_up()``  — multi-turn hook: given a finished turn, the
                       tokens the environment says next (a tool result,
                       a hint, a user reply), or None to end the
                       episode.  The rollout engine appends them to the
                       slot's context and continues decoding in place
                       (DESIGN.md §Environments and reward service).

Environments are duck-typed against ``core.rollout.Finished`` (fields
``rid``/``prompt``/``response``/``answer``) rather than importing it, so
the dependency arrow stays env -> data only and ``core`` never needs to
know which environments exist.

``verify`` may be called from several reward-worker threads at once:
implementations must be thread-safe (the bundled ones are stateless or
lock-free by construction).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.data.tasks import Problem


@dataclass
class Verdict:
    """Outcome of verifying one trajectory: binary pass/fail (the paper's
    App. B.1 rule-based rewards) plus free-form diagnostics."""
    ok: bool
    info: Dict = field(default_factory=dict)


class Environment:
    """Base environment: single-turn, never verifies anything.

    Subclasses override ``sample``/``verify`` (all) and ``follow_up``
    (multi-turn ones).  ``name`` keys the per-environment latency stats
    of ``AsyncRewardService``; ``max_turns`` > 1 makes the launchers
    install the engine continuation hook."""

    name: str = "null"
    max_turns: int = 1

    def sample(self) -> Problem:
        raise NotImplementedError

    def verify(self, fin) -> Verdict:
        raise NotImplementedError

    def follow_up(self, fin, turn: int, budget: int) -> Optional[List[int]]:
        """Tokens the environment appends after turn ``turn`` (0-based),
        or None to end the episode.  ``budget`` is the token headroom the
        engine still has for this slot (appended tokens + at least one
        sampled token must fit); return None or a message that fits."""
        return None

    def continuation_hook(self, engine_max_turns: Optional[int] = None):
        """The ``RolloutEngine(continuation=...)`` adapter: None for
        single-turn environments, else a ``fn(fin, turn, budget)`` that
        delegates to ``follow_up`` while turns remain."""
        limit = engine_max_turns or self.max_turns
        if limit <= 1:
            return None

        def hook(fin, turn: int, budget: int) -> Optional[List[int]]:
            if turn + 1 >= limit:
                return None
            return self.follow_up(fin, turn, budget)

        return hook


class EnvPromptStream:
    """``data/dataset.py::PromptStream`` shaped stream over an
    Environment: each sampled task repeats ``answers_per_prompt`` times
    (one request per sampled response, the paper's group sampling)."""

    def __init__(self, env: Environment, answers_per_prompt: int = 16):
        self.env = env
        self.answers_per_prompt = answers_per_prompt
        self._current: Optional[Problem] = None
        self._remaining = 0

    def next_request(self) -> Tuple[Problem, int]:
        if self._remaining == 0:
            self._current = self.env.sample()
            self._remaining = self.answers_per_prompt
        self._remaining -= 1
        return self._current, self._current.pid


class DelayEnv(Environment):
    """Latency-injection wrapper: behaves exactly like the inner
    environment but sleeps ``latency_s`` inside ``verify`` — the
    controlled slow verifier that ``benchmarks/reward_overlap.py`` and
    the liveness tests use to measure scoring off the critical path."""

    def __init__(self, inner: Environment, latency_s: float):
        self.inner = inner
        self.latency_s = latency_s
        self.name = f"delay({inner.name})"
        self.max_turns = inner.max_turns

    def sample(self) -> Problem:
        return self.inner.sample()

    def verify(self, fin) -> Verdict:
        time.sleep(self.latency_s)
        return self.inner.verify(fin)

    def follow_up(self, fin, turn: int, budget: int) -> Optional[List[int]]:
        return self.inner.follow_up(fin, turn, budget)
