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
reference's does.

Under a mesh ``moe_apply`` takes the reference's four constraints: the
groups on the data axes, the expert buffer and the experts' outputs
with their experts on "model" (each rank's ``_expert_ffn`` runs on its
own experts, ``local_map``), the combined output on the data axes.  The
combine gathers every expert's rows, so the outputs are gathered over
"model" first (the all-gather XLA inserts there).  Without a mesh the
constraints are exact no-ops.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.constraints import constrain, reshard
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
    """h: (G, E, C, d) -> (G, E, C, d), batched over groups and experts.
    A DTensor h runs on each rank's own groups and experts
    (``_local_experts``)."""
    weights = (moe.w_up, moe.w_gate, moe.w_down)
    if isinstance(h, DTensor):
        return _local_experts(cfg, h, weights)
    return _expert_math(cfg, h, *weights)


def _expert_math(cfg: ModelConfig, h, w_up, w_gate, w_down):
    up = torch.einsum("gecd,edf->gecf", h, w_up)
    if cfg.act in ("swiglu", "geglu"):
        gate = torch.einsum("gecd,edf->gecf", h, w_gate).float()
        act = F.silu(gate) if cfg.act == "swiglu" else F.gelu(gate, approximate="tanh")
        up = act.to(h.dtype) * up
    else:
        up = F.gelu(up.float(), approximate="tanh").to(h.dtype)
    return torch.einsum("gecf,efd->gecd", up, w_down)


def _local_experts(cfg: ModelConfig, h, weights):
    """The expert FFN of a DTensor buffer (G, E, C, d) on each rank's
    local groups and experts: a weight follows the buffer's expert split,
    and its gradient is a partial sum over the mesh dims that split the
    groups."""
    from torch.distributed.tensor.experimental import local_map
    dm = h.device_mesh
    hp, wp, wg = [], [], []
    for p in h.placements:
        if isinstance(p, Shard) and p.dim == 1:
            hp.append(p), wp.append(Shard(0)), wg.append(Shard(0))
        elif isinstance(p, Shard) and p.dim == 0:
            hp.append(p), wp.append(Replicate()), wg.append(Partial())
        else:
            hp.append(Replicate()), wp.append(Replicate()), wg.append(Replicate())
    h = reshard(h, dm, hp)
    ws = [None if w is None else reshard(w, dm, wp) for w in weights]
    spec = [None if w is None else wp for w in ws]
    grad = [None if w is None else wg for w in ws]
    fn = lambda x, *w: _expert_math(cfg, x, *w)                # noqa: E731
    return local_map(fn, out_placements=hp, in_placements=(hp, *spec),
                     in_grad_placements=(hp, *grad), device_mesh=dm)(h, *ws)


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

    xg, top_eg, top_pg = (a.reshape(g, tg, -1) for a in _on_groups((xt, top_e, top_p), g))
    xg = constrain(xg, "dp", None, None)
    buf, slot, keep = _group_local(lambda *a: _dispatch(*a, e, capacity), (xg, top_eg),
                                   n_out=3)
    expert_in = constrain(buf, "dp", "model", None, None)
    expert_out = constrain(_expert_ffn(cfg, moe, expert_in), "dp", "model", None, None)
    # the combine reads any expert's rows: the outputs are gathered over
    # "model" first (the all-gather XLA inserts there; no-op without a mesh)
    expert_out = constrain(expert_out, "dp", None, None, None)
    yg = _group_local(lambda *a: _combine(*a, capacity), (expert_out, top_pg, top_eg, slot, keep))
    y = constrain(yg, "dp", None, None).reshape(t, d)
    if isinstance(y, DTensor):
        # back to the rows' split of x, which x's shape can take
        y = reshard(y, y.device_mesh, xt.placements)

    dropped = 1.0 - keep.float().mean()
    aux = {"lb": load_balance, "z": z_loss, "drop": dropped}
    return y.reshape(orig_shape), aux


def _dispatch(xg, top_eg, e: int, capacity: int):
    """Per group: each (token, choice)'s row in its expert's buffer, and
    the buffer (G, E, C, d).  xg: (G, Tg, d); top_eg: (G, Tg, K).  Returns
    (buffer, slot, keep), slot and keep (G, Tg*K) in (token, choice)
    order: the sorted assignments' rows put back through the inverse
    permutation of the sort.  Kept assignments take distinct (expert,
    row) places; the dropped ones all land on the overflow row, which is
    cut off."""
    g, tg, k = top_eg.shape
    d = xg.shape[-1]
    order, _, slot_sorted, keep_sorted = group_slots(top_eg, e, capacity)
    ar = torch.arange(tg * k, device=xg.device)[None].expand_as(order)
    inv = torch.empty_like(order).scatter_(1, order, ar)
    slot = torch.gather(slot_sorted, 1, inv)
    keep = torch.gather(keep_sorted, 1, inv)
    gidx = torch.arange(g, device=xg.device)[:, None].expand_as(order)
    vals = xg.reshape(g, tg, 1, d).expand(g, tg, k, d).reshape(g, tg * k, d)
    vals = vals * keep[..., None].to(xg.dtype)
    buf = torch.zeros((g, e, capacity + 1, d), dtype=xg.dtype, device=xg.device)
    buf = buf.index_put((gidx, top_eg.reshape(g, tg * k), slot), vals)
    return buf[:, :, :capacity], slot, keep


def _combine(expert_out, top_pg, top_eg, slot, keep, capacity: int):
    """Per group: each assignment's output weighted by its renormalised
    probability (0 when dropped), summed over the k choices in order.
    Returns (G, Tg, d)."""
    g, tg, k = top_eg.shape
    d = expert_out.shape[-1]
    gidx = torch.arange(g, device=slot.device)[:, None].expand_as(slot)
    out = expert_out[gidx, top_eg.reshape(g, tg * k), slot.clamp(max=capacity - 1)]
    w = top_pg.reshape(g, tg * k).to(expert_out.dtype)
    w = torch.where(keep, w, torch.zeros_like(w))
    return (out * w[..., None]).reshape(g, tg, k, d).float().sum(dim=2).to(expert_out.dtype)


def _group_placements(g: int):
    """(the active DeviceMesh, the placements of a tensor whose leading
    dim is G groups): split over the data axes that divide G (the
    reference's "dp" tag), replicated elsewhere."""
    from repro_torch.dist.constraints import active_mesh, placements, resolve_spec
    mesh, dm = active_mesh()
    return dm, placements(resolve_spec(mesh, (g,), ("dp",)), mesh)


def _on_groups(xs, g: int):
    """Row-major (T, ...) DTensors with their rows split as the G groups
    of ``_group_placements`` will be (so the reshape to (G, T/G, ...) is
    even); plain tensors as they are."""
    if not isinstance(xs[0], DTensor):
        return xs
    dm, gp = _group_placements(g)
    return tuple(reshard(x, dm, gp) for x in xs)


def _group_local(fn, xs, n_out: int = 1):
    """``fn(*xs)`` of group-local work (the dispatch's sorts, scatters and
    gathers, the combine): on DTensors, each rank runs it on its own
    groups (``local_map``), every input and output with the groups'
    placements, so no DTensor rule of those ops is asked for."""
    if not isinstance(xs[0], DTensor):
        return fn(*xs)
    from torch.distributed.tensor.experimental import local_map
    dm, gp = _group_placements(xs[0].shape[0])
    xs = tuple(reshard(x, dm, gp) for x in xs)
    out = gp if n_out == 1 else (gp,) * n_out
    return local_map(fn, out_placements=out, in_placements=(gp,) * len(xs),
                     in_grad_placements=(gp,) * len(xs), device_mesh=dm)(*xs)


def aux_loss(cfg: ModelConfig, aux: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The router losses the trainer adds to the PPO loss."""
    return cfg.router_aux_coef * aux["lb"] + cfg.router_z_coef * aux["z"]
