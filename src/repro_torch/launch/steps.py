"""The production step functions, mirroring ``repro/launch/steps.py``:
the PPO ``train_step`` (the decoupled objective and AdamW in one call),
the proximal-logprob recompute, and the serving steps ``prefill_step``,
``serve_step``, ``paged_serve_step``, ``fused_serve_step`` and the
chunked-prefill ingest step, each at static shapes, the units the dry run
(``launch/dryrun.py``) analyses and the card runs whole.

The weights live in the model, so each step takes the model where the
reference takes ``params``, and keeps the rest of its signature:
``train_step(opt_state, batch) -> metrics`` updates the parameters and
``opt_state`` in place (``optim/adam.py``); the serving steps update the
cache they are given in place and return it.  On the card every
attention and scan in them runs the hand-written kernels
(``kernels/ops.py``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch import optim
from repro_torch.configs.base import ModelConfig, RLConfig
from repro_torch.core import ppo

DIAG_KEYS = ("clip_frac", "approx_kl", "behav_kl", "ratio_mean", "behav_weight_mean",
             "entropy_proxy")


def _hidden(model, batch):
    """The final-normed hidden states of the batch's tokens, without the
    prefix's positions (a VLM's)."""
    kw: Dict[str, Any] = {}
    if "prefix_embeds" in batch:
        kw["prefix_embeds"] = batch["prefix_embeds"]
    hidden, aux = model.hidden_states(batch["tokens"], positions=batch["positions"],
                                      segment_ids=batch["segment_ids"], **kw)
    s = batch["tokens"].shape[1]
    if hidden.shape[1] != s:
        hidden = hidden[:, hidden.shape[1] - s:, :]
    return hidden, aux


def _same_segment(lp, seg):
    """Token t's logprob where its predictor (t - 1) is in its segment and
    the token is not padding, else 0."""
    same = torch.cat([torch.zeros_like(seg[:, :1], dtype=torch.bool),
                      seg[:, 1:] == seg[:, :-1]], dim=1)
    return torch.where(same & (seg >= 0), lp, torch.zeros_like(lp))


def make_train_step(model, rl: RLConfig, adam: Optional[optim.AdamConfig] = None,
                    vocab_parallel_loss: bool = False, accum_steps: int = 1):
    """Returns ``train_step(opt_state, batch) -> metrics``; ``batch``
    follows ``models.model.train_batch_specs`` and ``opt_state`` is
    ``optim.init_state(list(model.parameters()))``.  The model's
    parameters are made to require gradients.

    accum_steps > 1 splits the rows into that many micro-batches (row
    blocks, in order) and sums their gradients into f32 buffers, as the
    reference's scan carry does, then scales by 1 / accum_steps; the loss
    and the diagnostics are averaged the same way.  Activation memory is
    bounded by one micro-batch."""
    cfg: ModelConfig = model.cfg
    adam = adam or optim.AdamConfig(
        lr=rl.lr, beta1=rl.beta1, beta2=rl.beta2, eps=rl.adam_eps,
        weight_decay=rl.weight_decay, grad_clip=rl.grad_clip)
    params = list(model.parameters())
    for p in params:
        p.requires_grad_(True)

    def loss_fn(batch):
        hidden, aux = _hidden(model, batch)
        if vocab_parallel_loss:
            lp = _vocab_parallel_logprobs(model, hidden, batch["tokens"])
        else:
            lp = ppo.next_token_logprobs(model.logits(hidden), batch["tokens"])
        lp = _same_segment(lp, batch["segment_ids"])
        loss, diag = ppo.ppo_loss(lp, batch["behav_logprob"], batch["prox_logprob"],
                                  batch["advantages"], batch["loss_mask"],
                                  clip_eps=rl.clip_eps, decoupled=rl.decoupled_objective)
        if cfg.is_moe:
            loss = loss + cfg.router_aux_coef * aux["lb"] + cfg.router_z_coef * aux["z"]
        return loss, diag

    def grads_of(loss):
        g = torch.autograd.grad(loss, params, allow_unused=True)
        return [torch.zeros_like(p) if x is None else x for p, x in zip(params, g)]

    def train_step(opt_state, batch):
        if accum_steps == 1:
            loss, diag = loss_fn(batch)
            grads = grads_of(loss)
            loss = loss.detach()
        else:
            rows = next(iter(batch.values())).shape[0] // accum_steps
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for p in params]
            loss = torch.zeros((), dtype=torch.float32, device=params[0].device)
            diag = {k: torch.zeros_like(loss) for k in DIAG_KEYS}
            for i in range(accum_steps):
                mb = {k: x[i * rows:(i + 1) * rows] for k, x in batch.items()}
                l, d = loss_fn(mb)
                for acc, g in zip(grads, grads_of(l)):
                    acc.add_(g.float())
                loss = loss + l.detach()
                diag = {k: diag[k] + d[k] for k in diag}
            scale = 1.0 / accum_steps
            for g in grads:
                g.mul_(scale)
            loss = loss * scale
            diag = {k: v * scale for k, v in diag.items()}
        om = optim.apply_updates(adam, params, grads, opt_state)
        return {"loss": loss, **diag, **om}

    return train_step


def _vocab_parallel_logprobs(model, hidden, tokens):
    """Per-token logprobs from the log-sum-exp and the chosen token's
    logit, without the (B, S, V) log-softmax the plain path's backward
    keeps (the reference's ``_vocab_parallel_logprobs``: there the vocab
    dim stays sharded and reduces by an all-reduce; on one device it gives
    the plain path's numbers)."""
    logits = model.logits(hidden).float()
    logz = torch.logsumexp(logits, dim=-1)
    chosen = torch.gather(logits[:, :-1], -1, tokens[:, 1:, None].long())[..., 0]
    lp = chosen - logz[:, :-1]
    return torch.cat([torch.zeros_like(lp[:, :1]), lp], dim=1)


def make_prox_logprob_step(model):
    """Proximal-policy recompute (Sec 5.2): ``prox_step(batch)`` gives the
    per-token logprobs under the current (pre-update) parameters, for
    ``batch["prox_logprob"]``."""
    @torch.no_grad()
    def prox_step(batch):
        hidden, _ = _hidden(model, batch)
        lp = ppo.next_token_logprobs(model.logits(hidden), batch["tokens"])
        return _same_segment(lp, batch["segment_ids"])
    return prox_step


def make_prefill_step(model, max_len: int, dtype=torch.bfloat16):
    """``prefill_step(batch) -> (last-token logits, populated cache)``: a
    fresh cache of ``max_len`` positions a row, filled by the prompts."""
    def prefill_step(batch):
        cache = model.init_cache(batch["tokens"].shape[0], max_len, dtype)
        kw = {}
        if "prefix_embeds" in batch:
            kw["prefix_embeds"] = batch["prefix_embeds"]
        return model.prefill(batch["tokens"], cache, length=batch["length"], **kw)
    return prefill_step


def make_serve_step(model):
    """``serve_step(token, cache) -> (logits, cache)``: ONE new token
    against the ring cache / recurrent state (decode_32k, long_500k)."""
    def serve_step(token, cache):
        return model.decode_step(token, cache)
    return serve_step


def make_paged_serve_step(model):
    """``paged_serve_step(token, cache, tables) -> (logits, cache)``: ONE
    new token against the block pool through the slots' tables."""
    def paged_serve_step(token, cache, tables):
        return model.decode_step_paged(token, cache, tables)
    return paged_serve_step


def make_fused_serve_step(model):
    """``fused_serve_step(token, cache, tables) -> (logits, cache)``: the
    paged step with each layer's attention and output projection in one
    fused kernel, the step the ``--fused-decode`` engine runs."""
    def fused_serve_step(token, cache, tables):
        return model.decode_step_paged(token, cache, tables, fused_tail=True)
    return fused_serve_step


def make_paged_prefill_chunk_step(model):
    """``chunk_step(tokens, cache, tables, dest, slot_ids, start, length)
    -> (last-token logits, cache)``: one span of prompt tokens scattered
    into the pool and attended through the slots' tables, the unit the
    chunked engine interleaves between decode steps."""
    def paged_prefill_chunk_step(tokens, cache, tables, dest, slot_ids, start, length):
        return model.prefill_chunk_paged(tokens, cache, tables, dest, slot_ids, start, length)
    return paged_prefill_chunk_step
