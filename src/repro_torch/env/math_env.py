"""Single-turn math environment: today's synthetic arithmetic task
behind the Environment protocol (DESIGN.md §Environments and reward
service).

A copy of ``repro/env/math_env.py``, which needs no JAX: importing it would run the JAX
package's ``__init__``, so the port keeps its own.

Verification is the exact rule the synchronous path has always used —
decode the response and string-match the claimed integer
(``data/tasks.py::verify``) — so scoring through this environment is
numerically identical to ``RewardService.score``, whether it runs inline
or on a reward worker.
"""
from __future__ import annotations

from repro_torch.data import tasks, tokenizer
from repro_torch.env.base import Environment, Verdict


class MathEnv(Environment):
    name = "math"

    def __init__(self, seed: int = 1, max_operand: int = 20, n_ops: int = 1):
        self.gen = tasks.MathTaskGenerator(seed=seed, max_operand=max_operand,
                                           n_ops=n_ops)

    def sample(self) -> tasks.Problem:
        return self.gen.sample()

    def verify(self, fin) -> Verdict:
        if fin.answer is None:            # simulator fast-path (no decode)
            return Verdict(False, {"reason": "no-answer"})
        text = tokenizer.decode(fin.response)
        ok = tasks.verify(text, str(fin.answer))
        return Verdict(ok, {"got": tasks.extract_answer(text)})
