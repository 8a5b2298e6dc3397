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

Sharded: every step also runs on a model whose parameters are DTensors
(``dist.sharding.distribute_model``) with a batch, or the decode tokens,
on the data axes (``distribute_batch``) and a cache distributed by
``make_cache_specs`` (``cache_on_mesh``, ``distribute_cache``), the
counterpart of the reference's ``jit(in_shardings=...)``.  Each runs
under its parameters' mesh (``launch.mesh.use_mesh``, unless the caller
has one active), and gathers the FSDP-split weights to their
tensor-parallel placements before a forward (``_gathered``): otherwise
DTensor may move activations to meet a weight split on "data" where FSDP
moves the weight.  The metrics come back as plain tensors, the same on
every rank; the serving steps' logits as the reference's
``out_shardings`` lay them out.
"""
from __future__ import annotations

from contextlib import contextmanager, nullcontext
from typing import Any, Dict, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch import optim
from repro_torch.configs.base import ModelConfig, RLConfig
from repro_torch.core import ppo
from repro_torch.dist import sharding
from repro_torch.dist.constraints import active_mesh, constrain
from repro_torch.models import attention, layers

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


def _mesh_scope(model):
    """The mesh of the model's DTensor parameters as the active mesh,
    unless one is active already or the model is not distributed."""
    p = next(model.parameters())
    if active_mesh() is not None or not isinstance(p, DTensor):
        return nullcontext()
    from repro_torch.launch.mesh import use_mesh
    return use_mesh(p.device_mesh)


@contextmanager
def _gathered(model):
    """For the ``with`` body, every FSDP-split parameter of ``model``
    replaced by its gather over the data axes (``sharding.gather_fsdp``:
    differentiable, its gradient reduce-scattered back to the parameter),
    once for all of the body's uses; the parameters are put back after."""
    swapped = []
    for name, p in model.named_parameters():
        g = sharding.gather_fsdp(p)
        if g is not p:
            owner, _, leaf = name.rpartition(".")
            module = model.get_submodule(owner) if owner else model
            swapped.append((module, leaf, p))
            module._parameters[leaf] = g
    try:
        yield
    finally:
        for module, leaf, p in swapped:
            module._parameters[leaf] = p


def _plain(x):
    """A DTensor's whole value as a plain tensor; anything else as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def _micro_batches(batch, accum_steps: int):
    """The rows of ``batch`` in ``accum_steps`` blocks, in order.  Rows
    split over the data axes are gathered once, and each block is split
    over them again (``constrain``), so that micro-batch i holds the
    global rows [i * rows, (i + 1) * rows) as the reference's reshape
    does."""
    rows = next(iter(batch.values())).shape[0] // accum_steps
    full = {k: x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)
            if isinstance(x, DTensor) else x for k, x in batch.items()}
    for i in range(accum_steps):
        yield {k: constrain(x[i * rows:(i + 1) * rows], "dp") for k, x in full.items()}


def _same_segment(lp, seg):
    """Token t's logprob where its predictor (t - 1) is in its segment and
    the token is not padding, else 0."""
    same = ~layers.segment_starts(seg)
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
    bounded by one micro-batch.  On a distributed model the buffers take
    each parameter's placements and each gradient is brought to them
    (a reduce-scatter under FSDP) before it is added."""
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

    def grads_of(batch):
        with _gathered(model):
            loss, diag = loss_fn(batch)
            g = torch.autograd.grad(loss, params, allow_unused=True)
        grads = []
        for p, x in zip(params, g):
            if x is None:
                x = torch.zeros_like(p)
            elif isinstance(x, DTensor) and tuple(x.placements) != tuple(p.placements):
                x = x.redistribute(p.device_mesh, p.placements)
            grads.append(x)
        return loss.detach(), diag, grads

    def train_step(opt_state, batch):
        with _mesh_scope(model):
            if accum_steps == 1:
                loss, diag, grads = grads_of(batch)
            else:
                grads = [torch.zeros_like(p, dtype=torch.float32) for p in params]
                loss = torch.zeros((), dtype=torch.float32, device=params[0].device)
                diag = {k: torch.zeros_like(loss) for k in DIAG_KEYS}
                for mb in _micro_batches(batch, accum_steps):
                    l, d, g_mb = grads_of(mb)
                    for acc, g in zip(grads, g_mb):
                        acc.add_(g.float())
                    loss = loss + l
                    diag = {k: diag[k] + d[k] for k in diag}
                scale = 1.0 / accum_steps
                for g in grads:
                    g.mul_(scale)
                loss = loss * scale
                diag = {k: v * scale for k, v in diag.items()}
            om = optim.apply_updates(adam, params, grads, opt_state)
            return {k: _plain(v) for k, v in {"loss": loss, **diag, **om}.items()}

    return train_step


def _vocab_parallel_logprobs(model, hidden, tokens):
    """Per-token logprobs from the log-sum-exp and the chosen token's
    logit, without the (B, S, V) log-softmax the plain path's backward
    keeps (the reference's ``_vocab_parallel_logprobs``: there the vocab
    dim stays sharded and reduces by an all-reduce; on one device it gives
    the plain path's numbers)."""
    logits = model.logits(hidden).float()
    logz = torch.logsumexp(logits, dim=-1)
    lp = ppo.chosen_logits(logits[:, :-1], tokens[:, 1:]) - logz[:, :-1]
    return torch.cat([torch.zeros_like(lp[:, :1]), lp], dim=1)


def make_prox_logprob_step(model):
    """Proximal-policy recompute (Sec 5.2): ``prox_step(batch)`` gives the
    per-token logprobs under the current (pre-update) parameters, for
    ``batch["prox_logprob"]``."""
    @torch.no_grad()
    def prox_step(batch):
        with _mesh_scope(model), _gathered(model):
            hidden, _ = _hidden(model, batch)
            lp = ppo.next_token_logprobs(model.logits(hidden), batch["tokens"])
            return _same_segment(lp, batch["segment_ids"])
    return prox_step


def make_prefill_step(model, max_len: int, dtype=torch.bfloat16):
    """``prefill_step(batch) -> (last-token logits, populated cache)``: a
    fresh cache of ``max_len`` positions a row, filled by the prompts (on
    a distributed batch, a cache distributed by
    ``sharding.make_cache_specs``, each rank writing its own rows)."""
    def prefill_step(batch):
        with _mesh_scope(model), _gathered(model):
            b = batch["tokens"].shape[0]
            if isinstance(batch["tokens"], DTensor):
                cache = sharding.cache_on_mesh(model, b, max_len, dtype,
                                               batch["tokens"].device_mesh)
            else:
                cache = model.init_cache(b, max_len, dtype)
            kw = {}
            if "prefix_embeds" in batch:
                kw["prefix_embeds"] = batch["prefix_embeds"]
            return model.prefill(batch["tokens"], cache, length=batch["length"], **kw)
    return prefill_step


def make_serve_step(model):
    """``serve_step(token, cache) -> (logits, cache)``: ONE new token
    against the ring cache / recurrent state (decode_32k, long_500k).
    Sharded: the token's rows on the data axes, the cache distributed by
    ``sharding.make_cache_specs`` (``cache_on_mesh``, ``distribute_cache``);
    the logits come back as the reference's ``out_shardings`` lay them
    out, rows on the data axes and the vocab on "model"."""
    def serve_step(token, cache):
        with _mesh_scope(model), _gathered(model):
            logits, cache = model.decode_step(token, cache)
            return constrain(logits, "dp", "model"), cache
    return serve_step


def make_paged_serve_step(model):
    """``paged_serve_step(token, cache, tables) -> (logits, cache)``: ONE
    new token against the block pool through the slots' tables.  Sharded
    as ``serve_step``, the tables' rows on the data axes (the reference's
    ``tables_spec``)."""
    def paged_serve_step(token, cache, tables):
        with _mesh_scope(model), _gathered(model):
            logits, cache = model.decode_step_paged(token, cache, tables)
            return constrain(logits, "dp", "model"), cache
    return paged_serve_step


def make_fused_serve_step(model):
    """``fused_serve_step(token, cache, tables) -> (logits, cache)``: the
    paged step with each layer's attention and output projection in one
    fused kernel, the step the ``--fused-decode`` engine runs.  Sharded
    as ``paged_serve_step``."""
    def fused_serve_step(token, cache, tables):
        with _mesh_scope(model), _gathered(model):
            logits, cache = model.decode_step_paged(token, cache, tables, fused_tail=True)
            return constrain(logits, "dp", "model"), cache
    return fused_serve_step


def make_paged_prefill_chunk_step(model):
    """``chunk_step(tokens, cache, tables, dest, slot_ids, start, length)
    -> (last-token logits, cache)``: one span of prompt tokens scattered
    into the pool and attended through the slots' tables, the unit the
    chunked engine interleaves between decode steps.  Sharded: as the
    reference's ``in_shardings`` replicate the span, its tables,
    destinations, slots, start and length, every rank takes them whole
    (a DTensor is gathered); the logits are (None, "model")."""
    def paged_prefill_chunk_step(tokens, cache, tables, dest, slot_ids, start, length):
        with _mesh_scope(model), _gathered(model):
            args = [attention.gathered(x) for x in (tokens, tables, dest, slot_ids, start,
                                                    length)]
            logits, cache = model.prefill_chunk_paged(args[0], cache, *args[1:])
            return constrain(logits, None, "model"), cache
    return paged_prefill_chunk_step
