"""repro_torch.env — verifiable environments and the asynchronous reward
service (DESIGN.md §Environments and reward service), after
``repro/env/__init__.py``.  The modules are copies of the reference's,
which need no JAX, with their imports changed.

  base       Environment protocol, Verdict, EnvPromptStream, DelayEnv
  math_env   MathEnv — the synthetic arithmetic task (single turn)
  code_env   CodeEnv — sandboxed code execution against unit tests
  service    AsyncRewardService — worker pool scoring off the hot path

``make_env(name)`` is the launcher-facing factory behind ``--env``.  The
reference's third environment, ``multiturn``, needs the engine's
multi-turn ``continuation``, which is part of the paged engine's
remainder (ROADMAP.md queue A item 3): ``make_env("multiturn")`` raises
``NotImplementedError``.
"""
from repro_torch.env.base import DelayEnv, Environment, EnvPromptStream, Verdict
from repro_torch.env.code_env import CodeEnv, CodeTaskGenerator, run_snippet
from repro_torch.env.math_env import MathEnv
from repro_torch.env.service import AsyncRewardService

ENVS = {"math": MathEnv, "code": CodeEnv}


def make_env(name: str, **kwargs) -> Environment:
    """Build one of the named environments (``--env`` flag values)."""
    if name == "multiturn":
        raise NotImplementedError(
            "make_env('multiturn'): MultiTurnEnv needs the engine's multi-turn "
            "continuation, a later part of the PyTorch port (ROADMAP.md queue A "
            "item 3, the paged engine's remainder)")
    try:
        cls = ENVS[name]
    except KeyError:
        raise ValueError(f"unknown environment {name!r}; "
                         f"choose from {sorted(ENVS) + ['multiturn']}") from None
    return cls(**kwargs)


__all__ = [
    "AsyncRewardService", "CodeEnv", "CodeTaskGenerator", "DelayEnv",
    "ENVS", "Environment", "EnvPromptStream", "MathEnv",
    "Verdict", "make_env", "run_snippet",
]
