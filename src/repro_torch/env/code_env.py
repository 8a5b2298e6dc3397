"""Code-verifier environment: the generated snippet is executed against
unit-test cases in a restricted subprocess sandbox, with a rule-based
pass/fail reward — the DeepCoder recipe at laptop scale (DESIGN.md
§Environments and reward service; the isolation layers below are
DESIGN.md §Sandbox policy).

A copy of ``repro/env/code_env.py``, which needs no JAX: importing it would run the JAX
package's ``__init__``, so the port keeps its own.

Task shape (learnable by the char-level toy LM: the target expression
appears verbatim in the prompt, so RL can learn to extract it):

    prompt:   "<q> code f(x) = x * 3 + 2 ; f(4) = 14 ?"
    expected: "x * 3 + 2"

Verification builds ``lambda x: (<response text>)`` and checks every
test case — in a SANDBOXED child process, never in the server:

  * ``python -I -S``: isolated mode (no site-packages, no env vars, no
    cwd on sys.path), so the snippet sees a bare interpreter;
  * ``eval`` under an empty ``__builtins__``: no imports, no open(), no
    getattr tricks through the builtin table;
  * hard resource limits (``RLIMIT_CPU``, ``RLIMIT_AS``) via preexec,
    plus a wall-clock ``subprocess.run(timeout=)`` — a hung or spinning
    snippet is KILLED at the deadline and scored as a failure.  This
    wall-clock kill is what keeps ``AsyncRewardService`` workers (and
    the synchronous fallback path) live no matter what the model wrote.

The sandbox rejects rather than interprets: any exception, any wrong
output, any timeout is simply ``ok=False`` (rule-based reward needs no
partial credit).
"""
from __future__ import annotations

import json
import subprocess
import sys
from typing import List, Tuple

from repro_torch.data import tasks, tokenizer
from repro_torch.env.base import Environment, Verdict

# Child-side runner: caps its OWN CPU/memory rlimits first (self-applied
# so the parent needs no preexec_fn — reward-worker threads can spawn
# the child via the fork-free fast path), then reads {"expr", "tests"}
# JSON from stdin, evaluates the expression as a one-argument lambda
# with NO builtins, and prints a single verdict token.  Any exception
# (syntax error, NameError from a blocked builtin, overflow) is a plain
# FAIL.  The limits are applied before any untrusted text is parsed.
_RUNNER = r"""
import json, sys
spec = json.loads(sys.stdin.read())
try:
    import resource
    cpu = int(spec["cpu_s"])
    resource.setrlimit(resource.RLIMIT_CPU, (cpu, cpu))
    mem = int(spec["mem_bytes"])
    resource.setrlimit(resource.RLIMIT_AS, (mem, mem))
except Exception:
    pass  # non-POSIX: the parent's wall-clock kill still bounds us
try:
    f = eval("lambda x: (" + spec["expr"] + ")", {"__builtins__": {}})
    ok = all(f(a) == b for a, b in spec["tests"])
except Exception:
    ok = False
sys.stdout.write("PASS" if ok else "FAIL")
"""

_MEM_LIMIT = 512 * 1024 * 1024            # RLIMIT_AS for the child


def run_snippet(expr: str, tests: List[Tuple[int, int]],
                timeout_s: float = 2.0) -> Verdict:
    """Execute ``expr`` as ``f(x)`` against ``tests`` in the sandbox.

    Returns ok=True iff the child ran to completion within the deadline
    and every case passed.  A child that exceeds ``timeout_s`` wall
    seconds is killed (``info["reason"] == "timeout"``)."""
    if not expr.strip():
        return Verdict(False, {"reason": "empty"})
    payload = json.dumps({"expr": expr, "tests": [list(t) for t in tests],
                          "cpu_s": max(1, int(timeout_s) + 1),
                          "mem_bytes": _MEM_LIMIT})
    try:
        r = subprocess.run(
            [sys.executable, "-I", "-S", "-c", _RUNNER], input=payload,
            capture_output=True, text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return Verdict(False, {"reason": "timeout"})
    except OSError as e:                   # pragma: no cover — spawn failure
        return Verdict(False, {"reason": f"spawn: {e!r}"})
    ok = r.returncode == 0 and r.stdout.strip() == "PASS"
    return Verdict(ok, {"reason": "ok" if ok else "failed-tests"})


class CodeTaskGenerator:
    """Streaming generator of linear-function synthesis tasks: the model
    must emit the expression ``x * k + c`` whose test cases the prompt
    states (and which the prompt itself spells out — copy-extraction is
    the learnable toy policy)."""

    def __init__(self, seed: int = 1, max_coef: int = 5, n_tests: int = 2):
        import numpy as np
        self.rng = np.random.default_rng(seed)
        self.max_coef = max_coef
        self.n_tests = n_tests
        self._next_pid = 0

    def sample(self) -> tasks.Problem:
        k = int(self.rng.integers(1, self.max_coef + 1))
        c = int(self.rng.integers(0, self.max_coef + 1))
        expr = f"x * {k} + {c}"
        xs = [int(v) for v in
              self.rng.choice(10, size=self.n_tests, replace=False)]
        cases = "; ".join(f"f({x}) = {x * k + c}" for x in xs)
        pid = self._next_pid
        self._next_pid += 1
        return tasks.Problem(pid=pid,
                             prompt_text=f"<q> code f(x) = {expr} ; {cases} ?",
                             answer=expr)


class CodeEnv(Environment):
    name = "code"

    def __init__(self, seed: int = 1, max_coef: int = 5, n_tests: int = 2,
                 timeout_s: float = 2.0):
        self.gen = CodeTaskGenerator(seed=seed, max_coef=max_coef,
                                     n_tests=n_tests)
        self.timeout_s = timeout_s

    def sample(self) -> tasks.Problem:
        return self.gen.sample()

    @staticmethod
    def _tests_for(answer: str, n: int = 4) -> List[Tuple[int, int]]:
        """Ground-truth cases from the stored answer expression (the
        generator's own f, trusted input)."""
        f = eval("lambda x: (" + answer + ")")  # noqa: S307 — our own text
        return [(x, f(x)) for x in range(n)]

    def verify(self, fin) -> Verdict:
        if fin.answer is None:
            return Verdict(False, {"reason": "no-answer"})
        # decode() drops PAD/BOS/EOS, so the snippet is the raw text
        text = tokenizer.decode(fin.response).strip()
        return run_snippet(text, self._tests_for(str(fin.answer)),
                           timeout_s=self.timeout_s)
