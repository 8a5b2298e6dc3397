"""AdamW with global-norm gradient clipping and a warmup-constant
schedule (paper Table 3), mirroring ``repro/optim/adam.py``, written out
by hand over a list of parameters (not ``torch.optim.AdamW``): weight
decay on every parameter, norms included, inside the update; the
learning rate of the step before its increment; clipping by
``max_norm / (norm + 1e-12)``.

Master weights: params may be bf16; m and v and the update math are
f32, the result cast back to the parameter's dtype.  Where the
reference returns new arrays, the port updates the parameters and the
state in place.  The parameters may be DTensors (a model on a mesh,
``dist.sharding.distribute_model``): m and v then take each parameter's
placements, the norm is the global one over every shard, and the update
runs on each rank's shards.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication


@dataclass(frozen=True)
class AdamConfig:
    lr: float = 2e-5
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-5
    weight_decay: float = 0.05
    grad_clip: float = 1.0
    warmup_steps: int = 1             # constant schedule after warmup


def init_state(params: Sequence[torch.Tensor]) -> Dict:
    """m and v, f32 zeros shaped (and placed) like each parameter, and the
    step (0)."""
    return {"m": [torch.zeros_like(p, dtype=torch.float32) for p in params],
            "v": [torch.zeros_like(p, dtype=torch.float32) for p in params],
            "step": 0}


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over tensors of their f32 sums of squares (one f32
    scalar on the tensors' device; of a DTensor, its whole value's, the
    same on every rank)."""
    sq = [torch.sum(torch.square(x.float())) for x in tensors]
    sq = [s.full_tensor() if isinstance(s, DTensor) else s for s in sq]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def clip_by_global_norm(grads: Sequence[torch.Tensor],
                        max_norm: float) -> Tuple[List[torch.Tensor], torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return [g.float() * scale for g in grads], norm


def schedule(cfg: AdamConfig, step: int) -> float:
    return cfg.lr * min(1.0, (step + 1.0) / max(cfg.warmup_steps, 1))


@torch.no_grad()
def apply_updates(cfg: AdamConfig, params: Sequence[torch.Tensor],
                  grads: Sequence[torch.Tensor], state: Dict) -> Dict[str, object]:
    """One AdamW step: ``params`` and ``state`` updated in place.  Returns
    the metrics {"grad_norm": f32 scalar tensor (before clipping), "lr"}.
    The gradients are clipped as ``clip_by_global_norm`` does, one
    tensor at a time, so that no f32 copy of all of them is held at once."""
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-12), max=1.0)
    lr = schedule(cfg, state["step"])
    state["step"] += 1
    b1, b2 = cfg.beta1, cfg.beta2
    # the reference raises its f32 beta to an f32 step
    step = torch.tensor(float(state["step"]), dtype=torch.float32)
    bc1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** step)
    bc2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** step)
    # a DTensor update meets the plain clip scalar as a replicated one
    with implicit_replication():
        for p, g, m, v in zip(params, grads, state["m"], state["v"]):
            g = g.float() * clip
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            pf = p.float()
            delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * pf
            p.copy_(pf - lr * delta)
    return {"grad_norm": gnorm, "lr": lr}
