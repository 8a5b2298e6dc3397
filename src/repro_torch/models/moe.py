"""Mixture-of-experts layer, mirroring ``repro/models/moe.py``: a router,
top-k routing renormalised over the chosen experts, and a dropping
dispatch into a dense per-group (G, E, C, d) expert buffer.

The dispatch gives the reference's numbers, the dropped tokens included.
The tokens are split into G groups; within a group the (token, choice)
assignments are sorted by expert (a stable sort, as ``jnp.argsort``),
each takes the next free row of its expert's C rows, and the assignments
past C are dropped.  Capacity therefore couples the rows of a call: a
token's output depends on every other token of its group, padding
included, so a caller that wants the reference's answers hands the layer
the reference's token set.

The top k are chosen by a stable descending sort, which breaks ties
toward the lower expert id as ``jax.lax.top_k`` does (``torch.topk``
does not).  The combine gathers every assignment's output back to its
(token, choice) place and sums over the k choices in order, so a card
run repeats itself (no atomics).  The expert FFN is a batched product
over experts; it runs outside any hand-written kernel, as the
reference's does.  The reference's sharding constraints have no
counterpart on one card.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers


class MoE(nn.Module):
    """Router (d, E) and expert weights ``w_up``/``w_gate`` (E, d, ff) and
    ``w_down`` (E, ff, d), named as the reference's tree; applied by
    ``moe_apply``."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.cfg = cfg
        self.router = layers._param((d, e), device=device, dtype=dtype)
        self.w_up = layers._param((e, d, ff), device=device, dtype=dtype)
        self.w_down = layers._param((e, ff, d), device=device, dtype=dtype)
        self.w_gate = (layers._param((e, d, ff), device=device, dtype=dtype)
                       if cfg.act in ("swiglu", "geglu") else None)

    def init_(self, generator: torch.Generator) -> None:
        """The reference's scales: the router as a dense layer, the
        experts' up and gate normal / sqrt(d), down normal / sqrt(ff)."""
        d, ff = self.cfg.d_model, self.cfg.d_ff
        layers.dense_init_(self.router, generator)
        layers.dense_init_(self.w_up, generator, scale=1.0 / math.sqrt(d))
        layers.dense_init_(self.w_down, generator, scale=1.0 / math.sqrt(ff))
        if self.w_gate is not None:
            layers.dense_init_(self.w_gate, generator, scale=1.0 / math.sqrt(d))


def top_k_stable(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of the last axis, ties
    to the lower index: the order of ``jax.lax.top_k``."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _expert_ffn(cfg: ModelConfig, moe: MoE, h: torch.Tensor) -> torch.Tensor:
    """h: (G, E, C, d) -> (G, E, C, d), batched over groups and experts."""
    up = torch.einsum("gecd,edf->gecf", h, moe.w_up)
    if cfg.act in ("swiglu", "geglu"):
        gate = torch.einsum("gecd,edf->gecf", h, moe.w_gate).float()
        act = F.silu(gate) if cfg.act == "swiglu" else F.gelu(gate, approximate="tanh")
        up = act.to(h.dtype) * up
    else:
        up = F.gelu(up.float(), approximate="tanh").to(h.dtype)
    return torch.einsum("gecf,efd->gecd", up, moe.w_down)


def expert_counts(ids: torch.Tensor, e: int) -> torch.Tensor:
    """(..., N) expert ids -> (..., E) int64 counts, by comparison (on the
    card ``bincount`` and ``one_hot`` read their input's range back to the
    host)."""
    return (ids[..., None] == torch.arange(e, device=ids.device)).sum(dim=-2)


def group_slots(top_e: torch.Tensor, e: int, capacity: int):
    """Per-group slot assignment, as the reference's ``_group_slots``.
    top_e: (G, Tg, K) expert ids.  Returns (order, e_sorted, slot_c,
    keep), each (G, Tg*K): the stable sort of the flattened assignments
    by expert, their experts, their row in the expert's buffer
    (``capacity``, the overflow row, when dropped) and whether they are
    kept, in sorted order."""
    g, tg, k = top_e.shape
    flat_e = top_e.reshape(g, tg * k)
    e_sorted, order = torch.sort(flat_e, dim=-1, stable=True)
    counts = expert_counts(e_sorted, e)                                   # (G, E)
    starts = torch.cumsum(counts, dim=-1) - counts
    pos = torch.arange(tg * k, device=top_e.device)[None] - torch.gather(starts, 1, e_sorted)
    keep = pos < capacity
    slot_c = torch.where(keep, pos, torch.full_like(pos, capacity))
    return order, e_sorted, slot_c, keep


def moe_apply(cfg: ModelConfig, moe: MoE, x: torch.Tensor, *, capacity: int = 0,
              n_groups: int = 0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (..., d).  Returns (y of x's shape and dtype, aux): aux holds the
    f32 scalars ``lb`` (the load-balance loss), ``z`` (the router z-loss)
    and ``drop`` (the share of assignments dropped)."""
    orig_shape = x.shape
    d = orig_shape[-1]
    xt = x.reshape(-1, d)                                                  # (T, d)
    t = xt.shape[0]
    e, k = cfg.n_experts, cfg.experts_per_token

    logits = layers.matmul(xt, moe.router).float()                        # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = top_k_stable(probs, k)                                  # (T, K)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)

    # ---- aux losses ------------------------------------------------------
    me = probs.mean(dim=0)
    ce = expert_counts(top_e.reshape(-1), e).float() / (t * k)
    load_balance = e * torch.sum(me * ce)
    z_loss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))

    # ---- grouped dispatch ------------------------------------------------
    if n_groups <= 0:
        n_groups = 32 if t % 32 == 0 and t >= 32 * e else 1
    g = n_groups
    tg = t // g
    if capacity <= 0:
        capacity = int(cfg.moe_capacity_factor * tg * k / e) + 1

    # each (token, choice)'s row in its expert's buffer, in (token, choice)
    # order: the sorted assignments' rows put back through the inverse
    # permutation of the sort
    order, _, slot_sorted, keep_sorted = group_slots(top_e.reshape(g, tg, k), e, capacity)
    ar = torch.arange(tg * k, device=x.device)[None].expand_as(order)
    inv = torch.empty_like(order).scatter_(1, order, ar)
    slot = torch.gather(slot_sorted, 1, inv)
    keep = torch.gather(keep_sorted, 1, inv)
    e_flat = top_e.reshape(g, tg * k)
    gidx = torch.arange(g, device=x.device)[:, None].expand_as(order)

    # scatter: kept assignments take distinct (expert, row) places; the
    # dropped ones all land on the overflow row, which is cut off
    vals = xt.reshape(g, tg, 1, d).expand(g, tg, k, d).reshape(g, tg * k, d)
    vals = vals * keep[..., None].to(xt.dtype)
    buf = torch.zeros((g, e, capacity + 1, d), dtype=xt.dtype, device=x.device)
    buf = buf.index_put((gidx, e_flat, slot), vals)
    expert_out = _expert_ffn(cfg, moe, buf[:, :, :capacity])

    # combine: each assignment's output weighted by its renormalised
    # probability (0 when dropped), summed over the k choices in order
    out = expert_out[gidx, e_flat, slot.clamp(max=capacity - 1)]          # (G, Tg*K, d)
    w = top_p.reshape(g, tg * k).to(xt.dtype)
    w = torch.where(keep, w, torch.zeros_like(w))
    y = (out * w[..., None]).reshape(t, k, d).float().sum(dim=1).to(xt.dtype)

    dropped = 1.0 - keep.float().mean()
    aux = {"lb": load_balance, "z": z_loss, "drop": dropped}
    return y.reshape(orig_shape), aux


def aux_loss(cfg: ModelConfig, aux: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The router losses the trainer adds to the PPO loss."""
    return cfg.router_aux_coef * aux["lb"] + cfg.router_z_coef * aux["z"]
