"""Advantage estimation — critic-free, per paper Appendix B.1.

A copy of ``repro/core/advantages.py``, which needs only numpy: importing
it would run the JAX package's ``__init__``, so the port keeps its own.

The critic and reference model are disabled; gamma = lambda = 1, terminal
reward of +/-5.  Estimators:

  grpo  group-normalized return: (r - mean_group) / (std_group + eps),
        broadcast to every response token (the paper's default workflow).
  rloo  leave-one-out baseline within the group (Appendix C.4).
  mc    raw Monte-Carlo return (no baseline).

Followed by optional advantage normalization across the *global* batch
(Table 3: advantage normalization = True).
"""
from __future__ import annotations

import numpy as np


def group_advantages(rewards: np.ndarray, group_ids: np.ndarray,
                     estimator: str = "grpo", eps: float = 1e-5) -> np.ndarray:
    """rewards: (N,) sequence-level rewards; group_ids: (N,) prompt ids.

    Returns per-sequence advantages (N,).
    """
    rewards = np.asarray(rewards, np.float64)
    group_ids = np.asarray(group_ids)
    adv = np.zeros_like(rewards)
    for g in np.unique(group_ids):
        idx = group_ids == g
        r = rewards[idx]
        if estimator == "grpo":
            adv[idx] = (r - r.mean()) / (r.std() + eps)
        elif estimator == "rloo":
            n = r.size
            if n > 1:
                baseline = (r.sum() - r) / (n - 1)
                adv[idx] = r - baseline
            else:
                adv[idx] = r
        elif estimator == "mc":
            adv[idx] = r
        else:
            raise ValueError(estimator)
    return adv.astype(np.float32)


def normalize_global(adv: np.ndarray, eps: float = 1e-5) -> np.ndarray:
    """Advantage normalization across the global batch (Table 3)."""
    a = np.asarray(adv, np.float64)
    return ((a - a.mean()) / (a.std() + eps)).astype(np.float32)
