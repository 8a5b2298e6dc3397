"""Multi-turn math environment: the environment answers back (DESIGN.md
§Environments and reward service).

A copy of ``repro/env/multiturn.py``, which needs no JAX: importing it would run the
JAX package's ``__init__``, so the port keeps its own.

The task is the two-operator arithmetic problem; after the model's first
turn the environment emits a *tool result* — the value of the leading
sub-expression, formatted as ``" | hint <v> | "`` — and the trajectory
continues decoding in place for up to ``max_turns`` turns (the rollout
engine re-admits the slot's grown context through the FIFO ingest queue,
reusing its existing cache; no re-prefill of shared history).

Scoring: only the text AFTER the last environment message counts — the
final-turn answer, extracted with the last-``=`` rule.  The hint value
itself therefore cannot be echo-credited.  Environment-injected tokens
carry ``loss_mask = 0`` into training (they were never sampled), exactly
like prompt tokens.

The environment is stateless across calls: the engine tracks the turn
counter per slot and the marker token makes verification
self-delimiting, so ``verify`` is reward-worker-thread-safe for free.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.data import tasks, tokenizer
from repro_torch.env.base import Environment, Verdict

MARKER = "|"                 # delimits environment messages in the text


class MultiTurnEnv(Environment):
    name = "multiturn"

    def __init__(self, seed: int = 1, max_operand: int = 9,
                 max_turns: int = 2):
        self.gen = tasks.MathTaskGenerator(seed=seed, max_operand=max_operand,
                                           n_ops=2)
        self.max_turns = max_turns

    def sample(self) -> tasks.Problem:
        return self.gen.sample()

    # ---- the environment's reply -----------------------------------------
    def _hint_value(self, prompt_tokens) -> Optional[int]:
        """Value of the prompt's leading ``a op b`` sub-expression (the
        partial result a tool would return), honoring precedence: when
        the second operator is ``*`` it binds first, so the useful hint
        is ``b op2 c`` instead."""
        text = tokenizer.decode(prompt_tokens)
        try:
            a, op, b, op2, c = text.removeprefix("<q>").split("=")[0].split()
            a, b, c = int(a), int(b), int(c)
        except ValueError:
            return None
        if op2 == "*" and op != "*":
            return b * c
        return {"+": a + b, "-": a - b, "*": a * b}[op]

    def follow_up(self, fin, turn: int, budget: int) -> Optional[List[int]]:
        hint = self._hint_value(fin.prompt)
        if hint is None:
            return None
        toks = tokenizer.encode(f" {MARKER} hint {hint} {MARKER} ")
        return toks if len(toks) + 1 <= budget else None

    # ---- scoring ----------------------------------------------------------
    def verify(self, fin) -> Verdict:
        if fin.answer is None:
            return Verdict(False, {"reason": "no-answer"})
        text = tokenizer.decode(fin.response)
        final = text.rsplit(MARKER, 1)[-1]     # last turn only
        ok = tasks.verify(final, str(fin.answer))
        return Verdict(ok, {"got": tasks.extract_answer(final),
                            "turns": text.count(MARKER) // 2 + 1})
