"""GQA attention with RoPE and two KV caches, a ring buffer per slot and
a paged block pool, mirroring ``repro/models/attention.py``.

Ring layout: {"k": (B, W, Hkv, hd), "v": ..., "pos": (B, W) int32} per
layer, where ``pos`` holds each slot's absolute position (-1 = empty).
Full attention uses W = max_len (the ring never wraps); windowed
attention uses W = window.

Paged layout: {"k_pool": (N, bs, Hkv, hd), "v_pool": ...} per layer, a
global pool of N blocks of bs positions shared by every slot.  A slot's
block table (B, E) int32, held by the caller, maps its entry e to the
pool block holding positions [e*bs, (e+1)*bs); -1 = unbound.  There is
no ``pos``: a key's position is implicit in its entry, and windowed
layers mask instead of wrapping.

Unlike the reference, whose arrays are immutable, both caches are
updated in place: prefill and decode write their K/V rows into the
tensors they are given.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers

Cache = Dict[str, torch.Tensor]


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        d = cfg.d_model
        self.wq = layers._param((d, cfg.q_dim), device=device, dtype=dtype)
        self.wk = layers._param((d, cfg.kv_dim), device=device, dtype=dtype)
        self.wv = layers._param((d, cfg.kv_dim), device=device, dtype=dtype)
        self.wo = layers._param((cfg.q_dim, d), device=device, dtype=dtype)
        self.q_norm = self.k_norm = None
        if cfg.qk_norm:
            self.q_norm = layers.HeadNorm(cfg.head_dim, device=device, dtype=dtype)
            self.k_norm = layers.HeadNorm(cfg.head_dim, device=device, dtype=dtype)

    def init_(self, generator: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            layers.dense_init_(w, generator)
        if self.q_norm is not None:
            self.q_norm.reset_parameters()
            self.k_norm.reset_parameters()


def _project_qkv(cfg: ModelConfig, p: Attention, x, positions, rope: bool = True,
                 tables=None):
    """q, k, v of x (B, S, d), rotated at ``positions`` unless ``rope`` is
    False; ``tables``: precomputed ``layers.rope_tables`` of positions."""
    b, s, _ = x.shape
    q = layers.matmul(x, p.wq).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = layers.matmul(x, p.wk).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = layers.matmul(x, p.wv).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if p.q_norm is not None:
        q = p.q_norm(q)
        k = p.k_norm(k)
    if rope:
        if tables is None:
            tables = layers.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        q = layers.rope_rotate(q, *tables)
        k = layers.rope_rotate(k, *tables)
    return q, k, v


def attn_forward(cfg: ModelConfig, p: Attention, x, positions, *, segment_ids=None,
                 window: int = 0, causal: bool = True, tables=None):
    """Full-sequence attention, the training and scoring forward.  x: (B,
    S, d) at ``positions`` (B, S); segment_ids: (B, S) int32, packed
    sequences attend only within their segment (-1 = padding).
    Differentiable: on the card the flash kernel's backward is the
    gradient (``ops.flash_attention``)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x, positions, tables=tables)
    out = ops.flash_attention(q, k, v, segment_ids, causal=causal, window=window)
    return layers.matmul(out.reshape(b, s, cfg.q_dim), p.wo)


# ---------------------------------------------------------------------------
# KV cache (ring buffer)
# ---------------------------------------------------------------------------

def cache_width(cfg: ModelConfig, window: int, max_len: int) -> int:
    return min(window, max_len) if window and window > 0 else max_len


def init_cache(cfg: ModelConfig, batch: int, window: int, max_len: int, *,
               dtype, device, n_layers: Optional[int] = None) -> Cache:
    """One layer's ring cache, or ``n_layers`` of them stacked on a
    leading axis (a layer's cache is then a view ``cache[x][i]``)."""
    w = cache_width(cfg, window, max_len)
    lead = () if n_layers is None else (n_layers,)
    kv = lead + (batch, w, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(kv, dtype=dtype, device=device),
        "v": torch.zeros(kv, dtype=dtype, device=device),
        "pos": torch.full(lead + (batch, w), -1, dtype=torch.int32, device=device),
    }


def prefill_into_cache(cfg: ModelConfig, p: Attention, x, positions, cache: Cache, *,
                       valid=None, window: int = 0, tables=None):
    """Full attention over the right-padded prompt, and its K/V written
    into ``cache`` in place.

    positions: (B, S) absolute positions; valid: (B, S) bool (False =
    padding: segment -1, so valid queries never see it, and written with
    pos = -1 so decode never does).  When S exceeds the cache width only
    the last ``width`` valid tokens of each row are written: the ring
    state a stepwise decode would have left.
    """
    b, s, _ = x.shape
    w = cache["k"].shape[1]
    if valid is None:
        valid = torch.ones((b, s), dtype=torch.bool, device=x.device)
    segment_ids = torch.where(valid, 0, -1).to(torch.int32)
    q, k, v = _project_qkv(cfg, p, x, positions, tables=tables)
    out = ops.flash_attention(q, k, v, segment_ids, causal=True, window=window)
    k = k.to(cache["k"].dtype)
    v = v.to(cache["v"].dtype)

    if s > w:
        # keep the last w valid tokens per row (window >= w by design).
        # Rows with fewer than w of them leave the rest of the ring as it
        # is: the reference writes those entries as (0, pos -1) to slot 0
        # before the real entries land, which a fresh cache already holds.
        length = valid.sum(dim=1)                                       # (B,)
        idx = length[:, None] - w + torch.arange(w, device=x.device)[None, :]
        ok = idx >= 0
        idx_c = idx.clamp(0, s - 1)
        k = torch.gather(k, 1, idx_c[:, :, None, None].expand(-1, -1, *k.shape[2:]))
        v = torch.gather(v, 1, idx_c[:, :, None, None].expand(-1, -1, *v.shape[2:]))
        positions = torch.gather(positions, 1, idx_c)
        valid = torch.gather(valid, 1, idx_c)
        rows, cols = torch.nonzero(ok, as_tuple=True)
        slots = (positions[rows, cols] % w).long()
        cache["k"][rows, slots] = k[rows, cols]
        cache["v"][rows, slots] = v[rows, cols]
        cache["pos"][rows, slots] = torch.where(valid[rows, cols], positions[rows, cols],
                                                -1).to(torch.int32)
    else:
        slots = (positions.clamp_min(0) % w).long()                     # (B, S)
        bidx = torch.arange(b, device=x.device)[:, None]
        cache["k"][bidx, slots] = k
        cache["v"][bidx, slots] = v
        cache["pos"][bidx, slots] = torch.where(valid, positions, -1).to(torch.int32)
    return layers.matmul(out.reshape(b, s, cfg.q_dim), p.wo)


def attn_decode_step(cfg: ModelConfig, p: Attention, x_t, t, cache: Cache, *,
                     window: int = 0, active=None, tables=None):
    """One-token decode.  x_t: (B, d); t: (B,) int32 absolute position.
    The new K/V are written at ``t % W`` before the token attends, so it
    sees itself.  active: optional (B,) bool; inactive rows keep their
    cache entry unchanged.  tables: ``layers.rope_tables`` of t[:, None]."""
    b, _ = x_t.shape
    q, k, v = _project_qkv(cfg, p, x_t[:, None], t[:, None], tables=tables)

    w = cache["k"].shape[1]
    slot = (t % w).long()
    bidx = torch.arange(b, device=x_t.device)
    k_new = k[:, 0].to(cache["k"].dtype)
    v_new = v[:, 0].to(cache["v"].dtype)
    pos_new = t.to(torch.int32)
    if active is not None:
        # an inactive row writes back what its slot already holds
        keep = ~active
        k_new = torch.where(keep[:, None, None], cache["k"][bidx, slot], k_new)
        v_new = torch.where(keep[:, None, None], cache["v"][bidx, slot], v_new)
        pos_new = torch.where(keep, cache["pos"][bidx, slot], pos_new)
    cache["k"][bidx, slot] = k_new
    cache["v"][bidx, slot] = v_new
    cache["pos"][bidx, slot] = pos_new
    qc = q[:, 0].to(cache["k"].dtype).contiguous()
    out = ops.decode_attention(qc, cache["k"], cache["v"], cache["pos"], t,
                               window=window).to(x_t.dtype)
    return layers.matmul(out.reshape(b, cfg.q_dim), p.wo)


# ---------------------------------------------------------------------------
# KV cache (paged block pool)
# ---------------------------------------------------------------------------

def init_paged_cache(cfg: ModelConfig, n_blocks: int, block_size: int, *, dtype, device,
                     n_layers: Optional[int] = None) -> Cache:
    """One layer's block pool, or ``n_layers`` of them stacked on a
    leading axis (a layer's pool is then a view ``cache[x][i]``)."""
    lead = () if n_layers is None else (n_layers,)
    shape = lead + (n_blocks, block_size, cfg.n_kv_heads, cfg.head_dim)
    return {"k_pool": torch.zeros(shape, dtype=dtype, device=device),
            "v_pool": torch.zeros(shape, dtype=dtype, device=device)}


def pool_writes(dest, positions, block_size: int):
    """The pool writes of a forward pass, shared by all its layers: for
    every token whose destination block ``dest`` (any shape, -1 = do not
    write) is set, its index in the flattened tokens, its block and its
    offset ``position % block_size`` in the block.  Selecting them takes
    one device-to-host sync per pass instead of one per layer; the
    reference drops the -1 rows with an out-of-range scatter instead."""
    dest = dest.reshape(-1)
    rows = torch.nonzero(dest >= 0).squeeze(1)
    offsets = positions.reshape(-1)[rows] % block_size
    return rows, dest[rows].long(), offsets.long()


def _pool_scatter(pool: torch.Tensor, writes, vals: torch.Tensor) -> None:
    """pool: (N, bs, Hkv, hd); vals: (T, Hkv, hd), one row per token;
    writes: ``pool_writes`` of those T tokens.  In place."""
    rows, blocks, offsets = writes
    pool[blocks, offsets] = vals[rows].to(pool.dtype)


def prefill_into_paged_cache(cfg: ModelConfig, p: Attention, x, positions, pool: Cache,
                             writes, valid, *, window: int = 0, tables=None):
    """Full attention over the right-padded rows, and their K/V written
    into the pool in place at ``writes`` (``pool_writes`` of the
    destination blocks: padding and prefix blocks another slot already
    holds are not written).  valid: (B, S) bool, False on padding.
    Attention is row-local, so prefix sharing only changes which rows
    write a block, never what is computed."""
    b, s, _ = x.shape
    segment_ids = torch.where(valid, 0, -1).to(torch.int32)
    q, k, v = _project_qkv(cfg, p, x, positions, tables=tables)
    out = ops.flash_attention(q, k, v, segment_ids, causal=True, window=window)
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    _pool_scatter(pool["k_pool"], writes, k.reshape(-1, hkv, hd))
    _pool_scatter(pool["v_pool"], writes, v.reshape(-1, hkv, hd))
    return layers.matmul(out.reshape(b, s, cfg.q_dim), p.wo)


def prefill_chunk_into_paged_cache(cfg: ModelConfig, p: Attention, x, positions,
                                   pool: Cache, writes, block_tables, valid, *,
                                   window: int = 0, tables=None):
    """A chunk of prefill continued against the pool.  x: (B, C, d) at
    absolute ``positions`` (B, C); block_tables: (B, E), the rows' slot
    tables; valid: (B, C) bool, False on padding, whose queries sit at
    position -1.  The chunk's K/V are written into the pool FIRST, then its
    queries attend through the block tables (write-then-read is exact:
    pool blocks never wrap), so prior chunks, shared prefix blocks and
    the chunk itself come back through one positional mask."""
    b, c, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x, positions, tables=tables)
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    _pool_scatter(pool["k_pool"], writes, k.reshape(-1, hkv, hd))
    _pool_scatter(pool["v_pool"], writes, v.reshape(-1, hkv, hd))
    q_pos = torch.where(valid, positions, -1).to(torch.int32)
    out = ops.paged_prefill_attention(q.to(pool["k_pool"].dtype).contiguous(),
                                      pool["k_pool"], pool["v_pool"], block_tables, q_pos,
                                      window=window).to(x.dtype)
    return layers.matmul(out.reshape(b, c, cfg.q_dim), p.wo)


def decode_dest_blocks(t, block_tables, block_size: int, active=None):
    """The block the token at position ``t`` lands in: table[t // bs]
    per slot (B,), -1 for rows that do not decode.  Every attention
    layer of a decode step writes to the same entry, so the model
    computes this once per step."""
    entry = (t // block_size).clamp(0, block_tables.shape[1] - 1).long()
    dest = torch.gather(block_tables, 1, entry[:, None])[:, 0]
    if active is not None:
        dest = torch.where(active, dest, -1)
    return dest


def attn_decode_step_paged(cfg: ModelConfig, p: Attention, x_t, t, pool: Cache,
                           block_tables, writes, *, window: int = 0, tables=None,
                           fused_tail: bool = False):
    """One-token decode against the pool.  x_t: (B, d); t: (B,) absolute
    position; block_tables: (B, E) int32 (-1 = unbound); writes:
    ``pool_writes`` of ``decode_dest_blocks`` (rows that do not decode
    write nothing).  The new K/V land in the pool before the token
    attends, so it sees itself.  fused_tail: attention and the output
    projection run as the one fused kernel ``ops.fused_decode_tail``."""
    b, _ = x_t.shape
    q, k, v = _project_qkv(cfg, p, x_t[:, None], t[:, None], tables=tables)
    _pool_scatter(pool["k_pool"], writes, k[:, 0])
    _pool_scatter(pool["v_pool"], writes, v[:, 0])
    dt = pool["k_pool"].dtype
    qc = q[:, 0].to(dt).contiguous()
    if fused_tail:
        return ops.fused_decode_tail(qc, pool["k_pool"], pool["v_pool"], p.wo.to(dt),
                                     block_tables, t, window=window).to(x_t.dtype)
    out = ops.paged_decode_attention(qc, pool["k_pool"], pool["v_pool"], block_tables, t,
                                     window=window).to(x_t.dtype)
    return layers.matmul(out.reshape(b, cfg.q_dim), p.wo)
