"""PPO objectives: standard (Eq. 2) and AReaL's decoupled objective (Eq. 5),
mirroring ``repro/core/ppo.py``.

The decoupled objective disentangles the *behavior* policy (generated the
tokens; logprobs recorded by the rollout worker, possibly spanning
several policy versions per trajectory — Proposition 1) from the
*proximal* policy (the parameters right before the current update step;
logprobs recomputed when the global batch arrives):

    J = E[ (pi_prox / pi_behav) * min(u A, clip(u, 1-eps, 1+eps) A) ],
    u = pi_theta / pi_prox.

With prox == behav this reduces exactly to standard PPO.  All inputs are
per-token; ``mask`` selects response (action) tokens.  The reference's
``stop_gradient`` is ``.detach()`` here.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def masked_mean(x, mask, axis=None, eps: float = 1e-8):
    if axis is None:
        return (x * mask).sum() / (mask.sum() + eps)
    return (x * mask).sum(dim=axis) / (mask.sum(dim=axis) + eps)


def ppo_loss(logprob_new, logprob_behav, logprob_prox, advantages, mask, *,
             clip_eps: float = 0.2, decoupled: bool = True,
             ratio_clip: float = 10.0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Per-token PPO surrogate.  All args (..., T); mask in {0, 1}.

    Returns (scalar loss, diagnostics dict).  ``ratio_clip`` bounds the
    behavior importance weight pi_prox/pi_behav for numerical safety with
    very stale data (the surrogate's min/clip already bounds u).
    """
    lp_new = logprob_new.float()
    lp_behav = logprob_behav.float().detach()
    lp_prox = logprob_prox.float().detach()
    adv = advantages.float().detach()
    mask = mask.float()

    if decoupled:
        center = lp_prox
        behav_weight = torch.clamp(torch.exp(lp_prox - lp_behav), 0.0, ratio_clip)
    else:
        center = lp_behav
        behav_weight = torch.ones_like(lp_behav)

    u = torch.exp(lp_new - center)                   # trust-region ratio
    clipped = torch.clamp(u, 1.0 - clip_eps, 1.0 + clip_eps)
    surr = torch.minimum(u * adv, clipped * adv)
    loss = -masked_mean(behav_weight * surr, mask)

    with torch.no_grad():
        diag = {
            "clip_frac": masked_mean(((u - 1.0).abs() > clip_eps).float(), mask),
            "approx_kl": masked_mean(center - lp_new, mask),
            "behav_kl": masked_mean(lp_prox - lp_behav, mask),
            "ratio_mean": masked_mean(u, mask),
            "behav_weight_mean": masked_mean(behav_weight, mask),
            "entropy_proxy": -masked_mean(lp_new, mask),
        }
    return loss, diag


def gather_logprobs(logits, tokens):
    """Per-token log pi(token).  logits: (B, S, V) f32 over the whole
    (padded) vocabulary, masked nowhere, as the reference; tokens: (B, S)."""
    logz = torch.logsumexp(logits, dim=-1)
    chosen = torch.gather(logits, -1, tokens.long()[..., None])[..., 0]
    return chosen - logz


def next_token_logprobs(logits, tokens, loss_mask=None):
    """Align logits_t -> predicts token_{t+1} (causal LM scoring).

    logits: (B, S, V); tokens: (B, S).  Returns (B, S) where entry t is
    log p(token_t | tokens_<t); entry 0 is 0 (no prediction for BOS).
    """
    lp = gather_logprobs(logits[:, :-1].float(), tokens[:, 1:])
    lp = torch.cat([torch.zeros_like(lp[:, :1]), lp], dim=1)
    if loss_mask is not None:
        lp = lp * loss_mask
    return lp
