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
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.constraints import constrain_qkv, on_mesh, reshard
from repro_torch.kernels import ops
from repro_torch.models import layers

Cache = Dict[str, torch.Tensor]


def _every_index(mask: torch.Tensor):
    """What ``torch.nonzero(mask, as_tuple=True)`` gives where every entry
    is set: the static upper bound the selections below take on the meta
    device, whose tensors hold no values to select by (the dry run then
    counts the scatters' bytes as an upper bound)."""
    grids = torch.meshgrid(*(torch.arange(n, device=mask.device) for n in mask.shape),
                           indexing="ij")
    return tuple(g.reshape(-1) for g in grids)


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
    False or the config has no rotary positions (``rope_theta <= 0``);
    ``tables``: precomputed ``layers.rope_tables`` of positions."""
    b, s, _ = x.shape
    q = layers.matmul(x, p.wq).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = layers.matmul(x, p.wk).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = layers.matmul(x, p.wv).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if p.q_norm is not None:
        q = p.q_norm(q)
        k = p.k_norm(k)
    if rope and cfg.rope_theta > 0:     # whisper has no rotary positions
        if tables is None:
            tables = layers.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        q = layers.rope_rotate(q, *tables)
        k = layers.rope_rotate(k, *tables)
    # one consistent tensor-parallel scheme across q/k/v under a mesh
    return constrain_qkv(q, k, v)


def attn_forward(cfg: ModelConfig, p: Attention, x, positions, *, segment_ids=None,
                 window: int = 0, causal: bool = True, tables=None):
    """Full-sequence attention, the training and scoring forward.  x: (B,
    S, d) at ``positions`` (B, S); segment_ids: (B, S) int32, packed
    sequences attend only within their segment (-1 = padding).
    Differentiable: on the card the flash kernel's backward is the
    gradient (``ops.flash_attention``).  Under a mesh ``wo`` is
    row-parallel: its output is a ``Partial`` sum over the model axis
    until the caller's next ``constrain``."""
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
    if valid is None:
        valid = torch.ones((b, s), dtype=torch.bool, device=x.device)
    segment_ids = torch.where(valid, 0, -1).to(torch.int32)
    q, k, v = _project_qkv(cfg, p, x, positions, tables=tables)
    out = ops.flash_attention(q, k, v, segment_ids, causal=True, window=window)
    on_local_rows(_ring_write, cache, k, v, positions, valid)
    return layers.matmul(out.reshape(b, s, cfg.q_dim), p.wo)


def _ring_write(cache: Cache, k, v, positions, valid) -> None:
    """Write the K/V rows (B, S, Hkv, hd) at ``positions`` into the ring
    cache in place (``prefill_into_cache``)."""
    b, s = positions.shape
    w = cache["k"].shape[1]
    k = k.to(cache["k"].dtype)
    v = v.to(cache["v"].dtype)
    if s > w:
        # keep the last w valid tokens per row (window >= w by design).
        # Rows with fewer than w of them leave the rest of the ring as it
        # is: the reference writes those entries as (0, pos -1) to slot 0
        # before the real entries land, which a fresh cache already holds.
        length = valid.sum(dim=1)                                       # (B,)
        idx = length[:, None] - w + torch.arange(w, device=k.device)[None, :]
        ok = idx >= 0
        idx_c = idx.clamp(0, s - 1)
        k = torch.gather(k, 1, idx_c[:, :, None, None].expand(-1, -1, *k.shape[2:]))
        v = torch.gather(v, 1, idx_c[:, :, None, None].expand(-1, -1, *v.shape[2:]))
        positions = torch.gather(positions, 1, idx_c)
        valid = torch.gather(valid, 1, idx_c)
        rows, cols = _every_index(ok) if ok.is_meta else torch.nonzero(ok, as_tuple=True)
        slots = (positions[rows, cols] % w).long()
        cache["k"][rows, slots] = k[rows, cols]
        cache["v"][rows, slots] = v[rows, cols]
        cache["pos"][rows, slots] = torch.where(valid[rows, cols], positions[rows, cols],
                                                -1).to(torch.int32)
    else:
        slots = (positions.clamp_min(0) % w).long()                     # (B, S)
        bidx = torch.arange(b, device=k.device)[:, None]
        cache["k"][bidx, slots] = k
        cache["v"][bidx, slots] = v
        cache["pos"][bidx, slots] = torch.where(valid, positions, -1).to(torch.int32)


def on_local_rows(fn, cache: Cache, *xs) -> None:
    """``fn(cache, *xs)``, a row-local in-place write of values (B, ...)
    into a cache of B rows.  With DTensors (under a mesh) each rank writes
    its own rows: every value is brought to the cache's split (its batch
    dim, and its heads where the cache's are split and the value has the
    cache's rank) and ``fn`` runs on the local shards, the cache's own
    storage.  A value may be None."""
    ref = cache["k"]
    if not isinstance(ref, DTensor):
        fn(cache, *xs)
        return
    dm, want = ref.device_mesh, ref.placements
    local = {name: c.to_local() for name, c in cache.items()}
    vals = []
    for x in xs:
        if x is None:
            vals.append(None)
            continue
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, dm, [Replicate()] * dm.ndim, run_check=False)
        pl = [p if isinstance(p, Shard) and (p.dim == 0 or x.dim() == ref.dim()) else Replicate()
              for p in want]
        vals.append(x.redistribute(dm, pl).to_local())
    fn(local, *vals)


def ring_chunk_writes(positions, valid, width: int):
    """The ring writes of a chunk of prefill, shared by all its layers:
    for every token the ring keeps, its row, its column in the chunk, its
    ring slot ``position % width`` and its position.  Padding tokens
    (``valid`` False) write nothing: their ring slot may hold a live
    earlier entry.  When C exceeds the width only each row's last
    ``width`` valid tokens are kept, the ring state a stepwise decode
    would have left.  Selecting them takes one device-to-host sync per
    pass instead of one per layer; the reference drops the other tokens
    through an out-of-range scatter index instead."""
    b, c = positions.shape
    if c > width:
        length = valid.sum(dim=1)                                       # (B,)
        idx = length[:, None] - width + torch.arange(width, device=positions.device)[None, :]
        idx_c = idx.clamp(0, c - 1)
        keep = (idx >= 0) & torch.gather(valid, 1, idx_c)
        rows, j = _every_index(keep) if keep.is_meta else torch.nonzero(keep, as_tuple=True)
        cols = idx_c[rows, j]
    else:
        rows, cols = (_every_index(valid) if valid.is_meta
                      else torch.nonzero(valid, as_tuple=True))
    pos = positions[rows, cols]
    return rows, cols, (pos % width).long(), pos.to(torch.int32)


def prefill_chunk_into_cache(cfg: ModelConfig, p: Attention, x, positions, cache: Cache,
                             start, writes, valid, *, window: int = 0, tables=None):
    """A chunk of prefill continued against the ring cache, in place.

    x: (B, C, d) at absolute ``positions`` (B, C); start: (B,) each
    row's ingest watermark, the chunk's first position; valid: (B, C)
    bool, False on padding.  The keys are the cache entries strictly
    before the watermark (an entry at or past it is stale: a re-prefill's
    old-weights row, or a previous occupant's) and the chunk's own K/V,
    concatenated rather than written and then read, because a ring write
    of the chunk could evict keys its earliest queries still need when
    the window wraps.  Then the chunk's K/V land in the ring at
    ``writes`` (``ring_chunk_writes``)."""
    b, c, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x, positions, tables=tables)
    k = k.to(cache["k"].dtype)
    v = v.to(cache["v"].dtype)
    hist_pos = torch.where(cache["pos"] < start[:, None], cache["pos"], -1)
    q_pos = torch.where(valid, positions, -1).to(torch.int32)
    keys = torch.cat([cache["k"], k], dim=1)
    vals = torch.cat([cache["v"], v], dim=1)
    key_pos = torch.cat([hist_pos, q_pos], dim=1)
    out = ops.chunked_prefill_attention(q, keys, vals, key_pos, q_pos, window=window)
    rows, cols, slots, pos = writes
    cache["k"][rows, slots] = k[rows, cols]
    cache["v"][rows, slots] = v[rows, cols]
    cache["pos"][rows, slots] = pos
    return layers.matmul(out.reshape(b, c, cfg.q_dim), p.wo)


def _ring_step_write(cache: Cache, k, v, t, active) -> None:
    """Write one decode step's K/V (B, 1, Hkv, hd) at ring slot ``t % W``
    in place (``attn_decode_step``); a row with ``active`` False writes
    back what its slot already holds."""
    b = t.shape[0]
    w = cache["k"].shape[1]
    slot = (t % w).long()
    bidx = torch.arange(b, device=t.device)
    k_new = k[:, 0].to(cache["k"].dtype)
    v_new = v[:, 0].to(cache["v"].dtype)
    pos_new = t.to(torch.int32)
    if active is not None:
        keep = ~active
        k_new = torch.where(keep[:, None, None], cache["k"][bidx, slot], k_new)
        v_new = torch.where(keep[:, None, None], cache["v"][bidx, slot], v_new)
        pos_new = torch.where(keep, cache["pos"][bidx, slot], pos_new)
    cache["k"][bidx, slot] = k_new
    cache["v"][bidx, slot] = v_new
    cache["pos"][bidx, slot] = pos_new


def attn_decode_step(cfg: ModelConfig, p: Attention, x_t, t, cache: Cache, *,
                     window: int = 0, active=None, tables=None):
    """One-token decode.  x_t: (B, d); t: (B,) int32 absolute position.
    The new K/V are written at ``t % W`` before the token attends, so it
    sees itself.  active: optional (B,) bool; inactive rows keep their
    cache entry unchanged.  tables: ``layers.rope_tables`` of t[:, None].
    Under a mesh each rank writes its own rows and kv heads
    (``on_local_rows``) and the kernel runs on them
    (``ops.decode_attention``); ``wo`` is row-parallel, its output a
    ``Partial`` sum over the model axis until the caller's ``constrain``."""
    b, _ = x_t.shape
    q, k, v = _project_qkv(cfg, p, x_t[:, None], t[:, None], tables=tables)
    on_local_rows(_ring_step_write, cache, k, v, t, active)
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


def gathered(x):
    """A DTensor's whole value as a plain tensor on every rank (a gather
    over the dims that split it, a pending sum reduced); anything else as
    it is."""
    if not isinstance(x, DTensor):
        return x
    return reshard(x, x.device_mesh, [Replicate()] * x.device_mesh.ndim).to_local()


def pool_writes(dest, positions, block_size: int):
    """The pool writes of a forward pass, shared by all its layers: for
    every token whose destination block ``dest`` (any shape, -1 = do not
    write) is set, its index in the flattened tokens, its block and its
    offset ``position % block_size`` in the block.  Selecting them takes
    one device-to-host sync per pass instead of one per layer; the
    reference drops the -1 rows with an out-of-range scatter instead.
    DTensors are gathered first: the pool is whole on the data axes, so
    every rank applies every row's write."""
    dest, positions = gathered(dest), gathered(positions)
    dest = dest.reshape(-1)
    rows = _every_index(dest)[0] if dest.is_meta else torch.nonzero(dest >= 0).squeeze(1)
    offsets = positions.reshape(-1)[rows] % block_size
    return rows, dest[rows].long(), offsets.long()


def _pool_scatter(pool: torch.Tensor, writes, vals: torch.Tensor) -> None:
    """pool: (N, bs, Hkv, hd); vals: (T, Hkv, hd), one row per token;
    writes: ``pool_writes`` of those T tokens.  In place.  A DTensor pool
    (whole on the data axes, its kv heads split on "model" where they
    divide) is written on each rank's local pool: the rows are gathered
    over every mesh dim that does not split the pool's heads, so each data
    replica applies every write and stays equal to the others."""
    if isinstance(pool, DTensor):
        dm = pool.device_mesh
        want = [Shard(vals.dim() - 2) if isinstance(p, Shard) and p.dim == pool.dim() - 2
                else Replicate() for p in pool.placements]
        vals = reshard(on_mesh(vals, dm), dm, want).to_local()
        pool = pool.to_local()
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
                                      window=window, mean_empty_rows=cfg.is_moe).to(x.dtype)
    return layers.matmul(out.reshape(b, c, cfg.q_dim), p.wo)


def decode_dest_blocks(t, block_tables, block_size: int, active=None):
    """The block the token at position ``t`` lands in: table[t // bs]
    per slot (B,), -1 for rows that do not decode and for a position
    past the table (a speculative draft step near the end of a
    generation; the reference clamps to the last entry inside a draft
    whose writes it drops).  Every attention layer of a decode step
    writes to the same entry, so the model computes this once per step.
    On DTensors each rank looks up its own rows (``layers.row_local``)."""
    if isinstance(t, DTensor) or isinstance(block_tables, DTensor):
        return layers.row_local(lambda t_, bt, a: decode_dest_blocks(t_, bt, block_size, a),
                                t, block_tables, active)
    entry = (t // block_size).long()
    e = block_tables.shape[1]
    dest = torch.gather(block_tables, 1, entry.clamp(0, e - 1)[:, None])[:, 0]
    keep = entry < e if active is None else active & (entry < e)
    return torch.where(keep, dest, -1)


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
                                     block_tables, t, window=window,
                                     mean_empty_rows=cfg.is_moe).to(x_t.dtype)
    out = ops.paged_decode_attention(qc, pool["k_pool"], pool["v_pool"], block_tables, t,
                                     window=window, mean_empty_rows=cfg.is_moe).to(x_t.dtype)
    return layers.matmul(out.reshape(b, cfg.q_dim), p.wo)


# ---------------------------------------------------------------------------
# Cross attention (the enc-dec decoder)
# ---------------------------------------------------------------------------

def cross_attn_kv(cfg: ModelConfig, p: Attention, enc_out) -> Cache:
    """The cross K/V {"k", "v"} (B, F, Hkv, hd) of the encoder's output
    (B, F, d), computed once a prefill and unchanged while decoding.  A
    cross-attention layer holds the reference's wq, wk, wv and wo: an
    ``Attention`` of a config without QK-norm."""
    b, f, _ = enc_out.shape
    k = layers.matmul(enc_out, p.wk).reshape(b, f, cfg.n_kv_heads, cfg.head_dim)
    v = layers.matmul(enc_out, p.wv).reshape(b, f, cfg.n_kv_heads, cfg.head_dim)
    return {"k": k, "v": v}


def cross_attn_apply(cfg: ModelConfig, p: Attention, x, kv: Cache):
    """x: (B, S, d) decoder states against ``cross_attn_kv``'s K/V, every
    frame visible.  With S != F this is the plain route on every device,
    as in the reference (``ops.flash_attention``)."""
    b, s, _ = x.shape
    q = layers.matmul(x, p.wq).reshape(b, s, cfg.n_heads, cfg.head_dim)
    out = ops.flash_attention(q, kv["k"], kv["v"], None, causal=False)
    return layers.matmul(out.reshape(b, s, cfg.q_dim), p.wo)
