"""The plain reference of one decoupled-PPO train step (AReaL, Eq. 5),
from a global batch of trajectories (the traffic generator's dicts) to
the loss and the updated weights.

What the port's trainer derives from the batch is worked out again here,
from frozen copies of the published procedures: GRPO advantages
normalised within each group and then over the batch; Algorithm 1
(sequences by length, descending, each to the fitting micro-batch with
the fewest sequences, or a new one); first-fit packing into one row of
``microbatch_token_budget`` tokens with segment ids (-1 padding) and
positions that restart at each sequence; proximal log-probabilities
recomputed once with the weights from before the step; ``ppo_minibatches``
sequential updates, each the mean gradient of its micro-batches; the
decoupled loss per micro-batch, masked to answer tokens, plus the
router's losses for a mixture of experts; AdamW with global-norm
clipping, f32 moments, decoupled weight decay inside the update, and the
result stored at the configuration's dtype (bfloat16) as the port stores
its weights.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from hbench.reference.model import Reference, segment_runs

LOGIT_ROWS = 1024


def advantages(rewards: np.ndarray, groups: np.ndarray, eps: float = 1e-5) -> np.ndarray:
    rewards = np.asarray(rewards, np.float64)
    adv = np.zeros_like(rewards)
    for g in np.unique(groups):
        idx = groups == g
        r = rewards[idx]
        adv[idx] = (r - r.mean()) / (r.std() + eps)
    adv = adv.astype(np.float32).astype(np.float64)
    return ((adv - adv.mean()) / (adv.std() + eps)).astype(np.float32)


def algorithm1(lens: Sequence[int], capacity: int) -> List[List[int]]:
    order = sorted(range(len(lens)), key=lambda i: -lens[i])
    batches: List[List[int]] = []
    loads: List[int] = []
    for i in order:
        fits = [j for j in range(len(batches)) if loads[j] + lens[i] <= capacity]
        if not batches or not fits:
            batches.append([i])
            loads.append(lens[i])
        else:
            j = min(fits, key=lambda j: len(batches[j]))
            batches[j].append(i)
            loads[j] += lens[i]
    return batches


def pack(seqs: List[Dict], length: int) -> Dict[str, np.ndarray]:
    """One row of ``length`` tokens: sequences longest first."""
    order = sorted(range(len(seqs)), key=lambda i: -len(seqs[i]["tokens"]))
    out = {"tokens": np.zeros(length, np.int64), "positions": np.zeros(length, np.int64),
           "segment_ids": np.full(length, -1, np.int64), "loss_mask": np.zeros(length, np.float32),
           "advantages": np.zeros(length, np.float32), "behav": np.zeros(length, np.float32)}
    o = 0
    for seg, i in enumerate(order):
        s = seqs[i]
        n = len(s["tokens"])
        if o + n > length:
            raise ValueError("a micro-batch does not fit its row")
        out["tokens"][o:o + n] = s["tokens"]
        out["positions"][o:o + n] = np.arange(n)
        out["segment_ids"][o:o + n] = seg
        out["loss_mask"][o:o + n] = s["loss_mask"]
        out["advantages"][o:o + n] = np.asarray(s["loss_mask"], np.float32) * s["advantage"]
        out["behav"][o:o + n] = s["behav"]
        o += n
    return out


def micro_batches(batch: List[Dict], budget: int) -> List[Dict[str, np.ndarray]]:
    adv = advantages(np.array([t["reward"] for t in batch], np.float32),
                     np.array([t["prompt_id"] for t in batch]))
    seqs = []
    for t, a in zip(batch, adv):
        np_, nr = len(t["prompt_tokens"]), len(t["response_tokens"])
        seqs.append({"tokens": (list(t["prompt_tokens"]) + list(t["response_tokens"]))[:budget],
                     "loss_mask": ([0.0] * np_ + [1.0] * nr)[:budget],
                     "behav": ([0.0] * np_ + list(t["behav_logprobs"]))[:budget],
                     "advantage": float(a)})
    groups = algorithm1([len(s["tokens"]) for s in seqs], budget)
    return [pack([seqs[i] for i in g], budget) for g in groups]


def _lp_piece(ref: Reference, h, nxt):
    lg = ref.logits(h)
    return torch.gather(lg, -1, nxt[:, None])[:, 0] - torch.logsumexp(lg, dim=-1)


def logprobs(ref: Reference, mb: Dict[str, torch.Tensor]):
    """(per-token log-probabilities of one packed row, lb, z): entry t is
    log p(token t | its segment before t), 0 where t starts a segment or
    is padding."""
    tok, seg = mb["tokens"], mb["segment_ids"]
    h, lb, z = ref.hidden(tok, mb["positions"], mb["runs"])
    s = tok.shape[0]
    pieces = []
    for a in range(0, s - 1, LOGIT_ROWS):
        b = min(s - 1, a + LOGIT_ROWS)
        if torch.is_grad_enabled():
            pieces.append(checkpoint(_lp_piece, ref, h[a:b], tok[a + 1:b + 1], use_reentrant=False))
        else:
            pieces.append(_lp_piece(ref, h[a:b], tok[a + 1:b + 1]))
    lp = torch.cat([torch.zeros(1, device=h.device)] + pieces)
    same = torch.cat([torch.zeros(1, dtype=torch.bool, device=h.device), seg[1:] == seg[:-1]])
    return torch.where(same & (seg >= 0), lp, torch.zeros_like(lp)), lb, z


def ppo_loss(lp, behav, prox, adv, mask, clip_eps: float, ratio_clip: float = 10.0):
    weight = torch.clamp(torch.exp(prox - behav), 0.0, ratio_clip)
    u = torch.exp(lp - prox)
    surr = torch.minimum(u * adv, torch.clamp(u, 1.0 - clip_eps, 1.0 + clip_eps) * adv)
    return -(weight * surr * mask).sum() / (mask.sum() + 1e-8)


class ReferenceTrainer:
    """Float32 weights (``w``, leaves that require gradients, holding
    values of the stored dtype) and AdamW state over them."""

    def __init__(self, cfg: Dict, w: Dict[str, torch.Tensor], rl: Dict, *, quant=None):
        self.cfg, self.w, self.rl = cfg, w, rl
        self.ref = Reference(cfg, w, quant=quant, remat=True)
        self.names = list(w)
        for v in w.values():
            v.requires_grad_(True)
        self.m = {n: torch.zeros_like(v) for n, v in w.items()}
        self.v = {n: torch.zeros_like(v) for n, v in w.items()}
        self.step_count = 0
        self.store = getattr(torch, cfg["dtype"])
        self.lr = float(rl.get("lr", 2e-5))
        self.b1, self.b2 = float(rl.get("beta1", 0.9)), float(rl.get("beta2", 0.95))
        self.eps = float(rl.get("adam_eps", 1e-5))
        self.wd = float(rl.get("weight_decay", 0.05))
        self.clip = float(rl.get("grad_clip", 1.0))
        self.warmup = max(1, int(float(rl.get("warmup_proportion", 0.001))
                                 * int(rl.get("total_steps", 250))))

    def _device_mb(self, mb):
        dev = self.w["embed.table"].device
        out = {k: torch.from_numpy(v).to(dev) for k, v in mb.items()}
        out["runs"] = segment_runs(mb["segment_ids"].tolist())
        return out

    @torch.no_grad()
    def _adamw(self) -> None:
        grads = {n: torch.zeros_like(self.w[n]) if self.w[n].grad is None else self.w[n].grad
                 for n in self.names}
        norm = math.sqrt(sum(float(torch.sum(g * g, dtype=torch.float64)) for g in grads.values()))
        scale = min(1.0, self.clip / (norm + 1e-12))
        lr = self.lr * min(1.0, (self.step_count + 1.0) / self.warmup)
        self.step_count += 1
        bc1 = 1.0 - self.b1 ** self.step_count
        bc2 = 1.0 - self.b2 ** self.step_count
        for n in self.names:
            p, g = self.w[n], grads[n] * scale
            m, v = self.m[n], self.v[n]
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            delta = (m / bc1) / (torch.sqrt(v / bc2) + self.eps) + self.wd * p
            p.copy_((p - lr * delta).to(self.store).float())
            p.grad = None

    def step(self, batch: List[Dict]) -> float:
        rl = self.rl
        mbs = [self._device_mb(mb) for mb in micro_batches(batch, int(rl["microbatch_token_budget"]))]
        aux = int(self.cfg["n_experts"]) > 0
        with torch.no_grad():
            prox = [logprobs(self.ref, mb)[0] for mb in mbs]
        splits = np.array_split(np.arange(len(mbs)), min(int(rl["ppo_minibatches"]), len(mbs)))
        total = 0.0
        clip_eps = float(rl.get("clip_eps", 0.2))
        for idx in splits:
            losses = []
            for i in idx:
                mb = mbs[i]
                lp, lb, z = logprobs(self.ref, mb)
                loss = ppo_loss(lp, mb["behav"], prox[i], mb["advantages"], mb["loss_mask"], clip_eps)
                if aux:
                    loss = (loss + float(self.cfg["router_aux_coef"]) * lb
                            + float(self.cfg["router_z_coef"]) * z)
                (loss / len(idx)).backward()
                losses.append(float(loss.detach()))
            self._adamw()
            total += sum(losses) / len(idx)
        return total / len(splits)

    def moment_norms(self) -> Dict[str, float]:
        """Each leaf's norm of m / (1 - beta1)."""
        return {n: float(self.m[n].norm()) / (1.0 - self.b1) for n in self.names}
