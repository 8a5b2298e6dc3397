"""Checkpoint evaluation — the paper's protocol in miniature.

AReaL evaluates the *final checkpoint* on held-out benchmarks (Sec 7.1:
32 samples/question pass@1 for math; we use greedy + exact match on
held-out synthetic problems, which is the deterministic equivalent at
this scale).  Used by the training launcher's final evaluation.

Mirrors ``repro/core/evaluate.py``.  The port has no parameter tree
apart from its model, so ``evaluate`` takes the ``LM`` itself and, unless
given an engine, serves it from a greedy ring ``RolloutEngine`` built on
that same ``LM``: the engine only reads the weights.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.core.config import EngineConfig
from repro_torch.core.rollout import RolloutEngine
from repro_torch.data import tokenizer
from repro_torch.data.tasks import MathTaskGenerator, verify
from repro_torch.models.transformer import LM


@dataclass
class EvalResult:
    n: int
    n_correct: int
    mean_len: float

    @property
    def accuracy(self) -> float:
        return self.n_correct / self.n if self.n else 0.0


def evaluate(model: LM, *, n_problems: int = 64, prompt_len: int = 24,
             max_gen_len: int = 16, n_slots: int = 16, seed: int = 10_000,
             max_operand: int = 9, temperature: float = 0.0,
             engine: Optional[RolloutEngine] = None) -> EvalResult:
    """Greedy-decode ``n_problems`` held-out problems; exact-match score.

    The eval problem stream uses a disjoint seed space from training
    (default 10_000) so memorization of the training stream cannot
    inflate accuracy."""
    eng = engine or RolloutEngine(model, EngineConfig(
        n_slots=n_slots, prompt_len=prompt_len, max_gen_len=max_gen_len,
        temperature=temperature, seed=seed), device=model.device)
    gen = MathTaskGenerator(seed=seed, max_operand=max_operand)
    pending = []
    for i in range(n_problems):
        p = gen.sample()
        pending.append({"rid": i, "prompt_id": p.pid,
                        "prompt": p.prompt_tokens, "answer": p.answer})
    done = []
    steps = 0
    while len(done) < n_problems:
        n = eng.admit(pending)
        pending = pending[n:]
        done += eng.step()
        steps += 1
        if steps >= 100_000:
            raise RuntimeError("evaluation did not converge")
    n_correct = sum(
        1 for f in done if verify(tokenizer.decode(f.response), str(f.answer)))
    mean_len = sum(len(f.response) for f in done) / len(done)
    return EvalResult(n=n_problems, n_correct=n_correct, mean_len=mean_len)
