"""Trainer worker (Section 4.1), mirroring ``repro/core/trainer.py``:
consumes a global batch of trajectories, computes advantages, packs them
into dynamic micro-batches (Algorithm 1), recomputes proximal-policy
logprobs (Section 5.2 practical remark: the parameters right before this
update step), then runs ``ppo_minibatches`` sequential PPO updates with
the decoupled objective.

The trainer trains the ``LM`` it is given, in place: ``params`` is that
live model, so the controller's ``engine.update_weights(trainer.params,
version)`` hands it over, and the engine copies it (it never keeps a
reference to weights the trainer goes on changing).  Each micro-batch is
one packed (rows, pack_len) block of tokens with segment ids; its
gradients are summed over a minibatch's micro-batches by autograd,
divided by their count, and applied by one AdamW step
(``repro_torch.optim``).  On the card the attention of every forward
and backward runs the flash kernels (``ops.flash_attention``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import optim
from repro_torch.configs.base import RLConfig
from repro_torch.core import advantages as adv_mod
from repro_torch.core import batching, ppo
from repro_torch.core.buffer import Trajectory
from repro_torch.models.transformer import LM


@dataclass
class TrainMetrics:
    version: int
    loss: float
    reward_mean: float
    seq_len_mean: float
    staleness_mean: float
    staleness_max: int
    n_tokens: int
    n_microbatches: int
    diag: Dict[str, float] = field(default_factory=dict)


class PPOTrainer:
    """``train_step`` updates ``model``'s weights in place.  After each
    step ``opt_metrics`` holds each AdamW step's gradient norm (before
    clipping) and learning rate, and ``timings`` the step's seconds by
    section ("prepare", "prox", "fwd_bwd" per micro-batch, "optimizer"
    per minibatch).  On the card a section's end is an event on the
    stream, read once the step's results come back, so the split adds no
    synchronisation: each section is the stream's time from the end of
    the one before."""

    def __init__(self, model: LM, rl: RLConfig, *, pack_rows: int = 1,
                 adam: Optional[optim.AdamConfig] = None):
        self.model = model
        self.rl = rl
        self.adam = adam or optim.AdamConfig(
            lr=rl.lr, beta1=rl.beta1, beta2=rl.beta2, eps=rl.adam_eps,
            weight_decay=rl.weight_decay, grad_clip=rl.grad_clip,
            warmup_steps=max(1, int(rl.warmup_proportion * rl.total_steps)))
        self._params = list(model.parameters())
        for p in self._params:
            p.requires_grad_(True)
        self.opt_state = optim.init_state(self._params)
        self.version = 0
        self.pack_rows = pack_rows
        self.pack_len = rl.microbatch_token_budget
        self.opt_metrics: List[Dict[str, float]] = []
        self.timings: Dict[str, object] = {}

    @property
    def params(self) -> LM:
        """The live model whose weights the trainer updates."""
        return self.model

    # ---- forward ----------------------------------------------------------
    def _forward_logprobs(self, batch):
        seg = batch["segment_ids"]
        hidden, aux = self.model.hidden_states(batch["tokens"], positions=batch["positions"],
                                               segment_ids=seg)
        logits = self.model.logits(hidden)
        lp = ppo.next_token_logprobs(logits, batch["tokens"])
        # token t's predictor (t-1) must be in the same segment
        same_seg = torch.cat([torch.zeros_like(seg[:, :1], dtype=torch.bool),
                              seg[:, 1:] == seg[:, :-1]], dim=1)
        lp = torch.where(same_seg & (seg >= 0), lp, torch.zeros_like(lp))
        return lp, aux

    def _loss(self, batch):
        lp, _ = self._forward_logprobs(batch)
        return ppo.ppo_loss(lp, batch["behav_logprob"], batch["prox_logprob"],
                            batch["advantages"], batch["loss_mask"],
                            clip_eps=self.rl.clip_eps, decoupled=self.rl.decoupled_objective)

    # ---- batch preparation -----------------------------------------------
    def _prepare(self, batch: List[Trajectory]):
        rewards = np.array([t.reward for t in batch], np.float32)
        groups = np.array([t.prompt_id for t in batch])
        adv = adv_mod.group_advantages(rewards, groups, self.rl.adv_estimator)
        if self.rl.advantage_norm:
            adv = adv_mod.normalize_global(adv)
        seqs = []
        for t, a in zip(batch, adv):
            toks = list(t.prompt_tokens) + list(t.response_tokens)
            np_ = len(t.prompt_tokens)
            # multi-turn episodes carry a per-response-token mask: tokens
            # the ENVIRONMENT injected were never sampled by the policy and
            # take no loss, exactly like prompt tokens
            resp_mask = t.meta.get("loss_mask") if t.meta else None
            if resp_mask is None:
                resp_mask = [1.0] * len(t.response_tokens)
            lm = [0.0] * np_ + [float(x) for x in resp_mask]
            blp = [0.0] * np_ + list(t.behav_logprobs)
            seqs.append({"tokens": toks[: self.pack_len],
                         "loss_mask": lm[: self.pack_len],
                         "behav_logprob": blp[: self.pack_len],
                         "advantage": float(a)})
        return seqs

    def _pack_microbatches(self, seqs) -> List[Dict[str, torch.Tensor]]:
        lens = [len(s["tokens"]) for s in seqs]
        cap = self.pack_rows * self.pack_len
        if self.rl.dynamic_batching:
            groups = batching.dynamic_batching(lens, cap, self.rl.min_microbatches)
        else:
            n_static = max(self.rl.min_microbatches,
                           int(np.ceil(sum(lens) / cap)) * 2)
            groups = batching.static_batching(lens, n_static)
        dev = self.model.device
        mbs = []
        for g in groups:
            pb = batching.pack_sequences([seqs[i] for i in g], self.pack_len,
                                         rows=self.pack_rows)
            mbs.append({name: torch.from_numpy(getattr(pb, name)).to(dev)
                        for name in ("tokens", "positions", "segment_ids", "loss_mask",
                                     "advantages", "behav_logprob")})
        return mbs

    # ---- the train step ----------------------------------------------------
    def _mark(self):
        """A section boundary: an event recorded on the card's stream, or
        the host clock on the CPU."""
        if self.model.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    @staticmethod
    def _seconds(a, b) -> float:
        if isinstance(a, float):
            return b - a
        return a.elapsed_time(b) / 1e3

    def train_step(self, batch: List[Trajectory],
                   current_version: Optional[int] = None) -> TrainMetrics:
        rl = self.rl
        t_prep = time.perf_counter()
        seqs = self._prepare(batch)
        mbs = self._pack_microbatches(seqs)
        marks = {"prepare": time.perf_counter() - t_prep, "fwd_bwd": [], "optimizer": []}
        t1 = self._mark()

        # proximal logprobs: recomputed ONCE on batch arrival with the
        # parameters before this update step (Sec 5.2, practical remark)
        with torch.no_grad():
            for mb in mbs:
                # naive PPO (Eq. 2): the trust region centers on the
                # behavior policy; prox is unused but kept equal for
                # diagnostics
                mb["prox_logprob"] = (self._forward_logprobs(mb)[0] if rl.decoupled_objective
                                      else mb["behav_logprob"])
        t0 = self._mark()
        marks["prox"] = (t1, t0)

        # minibatch splits (sequential updates, Sec 3.1 footnote 2)
        n_mb = len(mbs)
        n_mini = min(rl.ppo_minibatches, n_mb)
        splits = np.array_split(np.arange(n_mb), n_mini)
        losses, diags = [], []
        self.opt_metrics = []
        for idx in splits:
            for p in self._params:
                p.grad = None
            for i in idx:
                loss, diag = self._loss(mbs[i])
                loss.backward()
                losses.append(loss.detach())
                diags.append(diag)
                t1 = self._mark()
                marks["fwd_bwd"].append((t0, t1))
                t0 = t1
            # the minibatch's mean gradient, in the gradients' own dtype
            grads = [torch.zeros_like(p) if p.grad is None else p.grad.div_(len(idx))
                     for p in self._params]
            self.opt_metrics.append(optim.apply_updates(self.adam, self._params, grads,
                                                        self.opt_state))
            del grads
            t1 = self._mark()
            marks["optimizer"].append((t0, t1))
            t0 = t1
        for p in self._params:
            p.grad = None

        # one device-to-host copy of every loss, diagnostic and norm
        keys = list(diags[0])
        vals = torch.stack(losses + [d[k] for d in diags for k in keys]
                           + [m["grad_norm"] for m in self.opt_metrics]).tolist()
        n = len(losses)
        loss_v, diag_v, norms = vals[:n], vals[n:n + n * len(keys)], vals[n + n * len(keys):]
        for m, g in zip(self.opt_metrics, norms):
            m["grad_norm"] = g
        total_loss, pos = 0.0, 0
        for idx in splits:
            total_loss += sum(loss_v[pos:pos + len(idx)]) / len(idx)
            pos += len(idx)
        diag_acc = {k: sum(diag_v[j * len(keys) + a] for j in range(n))
                    for a, k in enumerate(keys)}
        self.timings = {
            "prepare": marks["prepare"], "prox": self._seconds(*marks["prox"]),
            **{k: [self._seconds(a, b) for a, b in marks[k]] for k in ("fwd_bwd", "optimizer")}}

        self.version += 1
        cur = self.version if current_version is None else current_version
        stal = [max(0, (cur - 1) - t.behavior_version) for t in batch]
        return TrainMetrics(
            version=self.version,
            loss=total_loss / max(n_mini, 1),
            reward_mean=float(np.mean([t.reward for t in batch])),
            seq_len_mean=float(np.mean([t.length for t in batch])),
            staleness_mean=float(np.mean(stal)),
            staleness_max=int(np.max(stal)),
            n_tokens=int(sum(t.length for t in batch)),
            n_microbatches=len(mbs),
            diag={k: v / max(n, 1) for k, v in diag_acc.items()},
        )
