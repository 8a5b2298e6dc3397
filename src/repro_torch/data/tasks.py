"""Synthetic verifiable math task (the laptop-scale stand-in for
DeepScaleR/DeepCoder data): arithmetic expressions with an exact
string-matched answer, verified by the rule-based reward service.

A copy of ``repro/data/tasks.py``, which needs no JAX: importing it would run
the JAX package's ``__init__``, so the port keeps its own.

Prompt format:   "<q> a op b = ?"        (or three-operand variants)
Expected answer: the decimal result; the model is rewarded +5/-5 on
exact match of the first integer token span in its response (paper
Appendix B.1 rewards).
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from repro_torch.data import tokenizer


@dataclass
class Problem:
    pid: int
    prompt_text: str
    answer: str

    @property
    def prompt_tokens(self) -> List[int]:
        return tokenizer.encode(self.prompt_text, bos=True)


_INT_RE = re.compile(r"-?\d+")


def extract_answer(response_text: str) -> Optional[str]:
    """Rule-based extraction of the model's claimed answer.

    When the response contains an ``=`` the answer is the first integer
    AFTER the last one — a model that merely echoes the prompt's
    operands ("3 + 4 = ?") or restates the equation ("3 + 4 = 7") is
    scored on what it puts right of the ``=``, not credited for the
    echoed left-hand side.  Without an ``=`` the first integer anywhere
    is used (the original rule)."""
    if "=" in response_text:
        m = _INT_RE.search(response_text.rsplit("=", 1)[1])
        return m.group(0) if m else None
    m = _INT_RE.search(response_text)
    return m.group(0) if m else None


def verify(response_text: str, answer: str) -> bool:
    got = extract_answer(response_text)
    return got is not None and int(got) == int(answer)


def _eval2(a: int, op: str, b: int, op2: str, c: int) -> int:
    """Evaluate ``a op b op2 c`` with standard operator precedence
    (``*`` binds tighter than ``+``/``-``), matching how the prompt text
    reads as arithmetic."""
    if op2 == "*" and op != "*":
        bc = b * c
        return a + bc if op == "+" else a - bc
    ab = {"+": a + b, "-": a - b, "*": a * b}[op]
    return {"+": ab + c, "-": ab - c, "*": ab * c}[op2]


class MathTaskGenerator:
    """Streaming generator of arithmetic problems with controlled difficulty."""

    def __init__(self, seed: int = 1, max_operand: int = 20, n_ops: int = 1):
        self.rng = np.random.default_rng(seed)
        self.max_operand = max_operand
        self.n_ops = n_ops
        self._next_pid = 0

    def sample(self) -> Problem:
        rng = self.rng
        a = int(rng.integers(0, self.max_operand))
        b = int(rng.integers(1, self.max_operand))
        op = rng.choice(["+", "-", "*"])
        if op == "+":
            val = a + b
        elif op == "-":
            val = a - b
        else:
            val = a * b
        text = f"<q> {a} {op} {b} = ?"
        if self.n_ops == 2:
            op2 = str(rng.choice(["+", "-", "*"]))
            c = int(rng.integers(1, self.max_operand))
            text = f"<q> {a} {op} {b} {op2} {c} = ?"
            val = _eval2(a, op, b, op2, c)
        pid = self._next_pid
        self._next_pid += 1
        return Problem(pid=pid, prompt_text=text, answer=str(val))
