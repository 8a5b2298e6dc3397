"""Streaming prompt dataset: yields (Problem, group replication) in the
paper's sampling regime (``answers_per_prompt`` responses per prompt,
Table 3: 16).

A copy of ``repro/data/dataset.py``, which needs no JAX: importing it would run
the JAX package's ``__init__``, so the port keeps its own.
"""
from __future__ import annotations

from typing import Iterator, Tuple

from repro_torch.data.tasks import MathTaskGenerator, Problem


class PromptStream:
    def __init__(self, seed: int = 1, answers_per_prompt: int = 16,
                 max_operand: int = 20, n_ops: int = 1):
        self.gen = MathTaskGenerator(seed=seed, max_operand=max_operand,
                                     n_ops=n_ops)
        self.answers_per_prompt = answers_per_prompt
        self._current: Problem = None
        self._remaining = 0

    def next_request(self) -> Tuple[Problem, int]:
        """Next (problem, group_id); each problem repeats
        answers_per_prompt times (one per sampled response)."""
        if self._remaining == 0:
            self._current = self.gen.sample()
            self._remaining = self.answers_per_prompt
        self._remaining -= 1
        return self._current, self._current.pid

    def __iter__(self) -> Iterator[Tuple[Problem, int]]:
        while True:
            yield self.next_request()
