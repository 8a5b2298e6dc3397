"""repro_torch.env — verifiable environments and the asynchronous reward
service (DESIGN.md §Environments and reward service), after
``repro/env/__init__.py``.  The modules are copies of the reference's,
which need no JAX, with their imports changed.

  base       Environment protocol, Verdict, EnvPromptStream, DelayEnv
  math_env   MathEnv — the synthetic arithmetic task (single turn)
  code_env   CodeEnv — sandboxed code execution against unit tests
  multiturn  MultiTurnEnv — the environment answers back (multi-turn)
  service    AsyncRewardService — worker pool scoring off the hot path

``make_env(name)`` is the launcher-facing factory behind ``--env``.
"""
from repro_torch.env.base import DelayEnv, Environment, EnvPromptStream, Verdict
from repro_torch.env.code_env import CodeEnv, CodeTaskGenerator, run_snippet
from repro_torch.env.math_env import MathEnv
from repro_torch.env.multiturn import MultiTurnEnv
from repro_torch.env.service import AsyncRewardService

ENVS = {"math": MathEnv, "code": CodeEnv, "multiturn": MultiTurnEnv}


def make_env(name: str, **kwargs) -> Environment:
    """Build one of the named environments (``--env`` flag values)."""
    try:
        cls = ENVS[name]
    except KeyError:
        raise ValueError(f"unknown environment {name!r}; "
                         f"choose from {sorted(ENVS)}") from None
    return cls(**kwargs)


__all__ = [
    "AsyncRewardService", "CodeEnv", "CodeTaskGenerator", "DelayEnv",
    "ENVS", "Environment", "EnvPromptStream", "MathEnv", "MultiTurnEnv",
    "Verdict", "make_env", "run_snippet",
]
