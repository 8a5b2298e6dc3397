"""Decoder-only LM, mirroring ``repro/models/transformer.py`` (the
serving methods, and the training forward ``hidden_states`` /
``forward`` of the attention blocks), for block patterns over the attention
kinds ``"attn"``, ``"swa"`` and ``"local"`` and the RG-LRU recurrent
block ``"rec"`` (RecurrentGemma's ``("rec", "rec", "local")``).

The reference stacks the parameters of its repeating units on a leading
axis and scans over them; here the layers are an ``nn.ModuleList``
looped in Python, in the reference's order: ``n_units`` repeats of the
pattern, then its first ``n_rem`` kinds.  The serving caches stack the
layers' caches on a leading axis instead, one stack per kind of state:
the ring cache

    {"k": (L_attn, B, W, Hkv, hd), "v": ..., "pos": (L_attn, B, W) int32,
     "h": (L_rec, B, w) f32, "conv": (L_rec, B, W_conv - 1, w),
     "t": (B,) int32}

(the keys of a kind the pattern lacks are absent) and, for attention
patterns only, the paged cache, whose block tables the caller holds,

    {"k_pool": (L, N, bs, Hkv, hd), "v_pool": ..., "t": (B,) int32}

and every method updates them in place (the reference returns a new
cache; the port returns the same dict).

The training forward is differentiable once the parameters require
gradients (they are created without).  The reference's ``remat`` has no
counterpart: ``run_training`` builds without it, and it does not change
the numbers.  A ``"rec"`` block has no training forward yet: the RG-LRU
with packed-segment resets is ROADMAP queue A item 6.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.models import attention, layers, rglru

ATTN_KINDS = ("attn", "swa", "local")
BLOCK_KINDS = ATTN_KINDS + ("rec",)
FAMILIES = ("dense", "hybrid")


def _block_window(cfg: ModelConfig, bt: str) -> int:
    if bt == "swa":
        return cfg.sliding_window
    if bt == "local":
        return cfg.local_window
    return 0


class Block(nn.Module):
    """Pre-norm attention + MLP block."""

    def __init__(self, cfg: ModelConfig, bt: str, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        self.window = _block_window(cfg, bt)
        self.attn_norm = layers.Norm(cfg, cfg.d_model, device=device, dtype=dtype)
        self.attn = attention.Attention(cfg, device=device, dtype=dtype)
        self.mlp_norm = layers.Norm(cfg, cfg.d_model, device=device, dtype=dtype)
        self.mlp = layers.MLP(cfg, device=device, dtype=dtype)

    def init_(self, generator: torch.Generator) -> None:
        self.attn_norm.reset_parameters()
        self.attn.init_(generator)
        self.mlp_norm.reset_parameters()
        self.mlp.init_(generator)

    def forward(self, h, positions, segment_ids, tables):
        """The training forward (``block_forward`` of an attention kind)."""
        a = attention.attn_forward(self.cfg, self.attn, self.attn_norm(h), positions,
                                   segment_ids=segment_ids, window=self.window, tables=tables)
        h = h + a
        return h + self.mlp(self.mlp_norm(h))

    def prefill(self, h, positions, cache, valid, tables):
        a = attention.prefill_into_cache(self.cfg, self.attn, self.attn_norm(h), positions,
                                         cache, valid=valid, window=self.window, tables=tables)
        h = h + a
        return h + self.mlp(self.mlp_norm(h))

    def decode(self, h_t, t, cache, active, tables):
        a = attention.attn_decode_step(self.cfg, self.attn, self.attn_norm(h_t), t, cache,
                                       window=self.window, active=active, tables=tables)
        h_t = h_t + a
        return h_t + self.mlp(self.mlp_norm(h_t))

    def prefill_paged(self, h, positions, pool, writes, valid, tables):
        a = attention.prefill_into_paged_cache(self.cfg, self.attn, self.attn_norm(h),
                                               positions, pool, writes, valid,
                                               window=self.window, tables=tables)
        h = h + a
        return h + self.mlp(self.mlp_norm(h))

    def prefill_chunk_paged(self, h, positions, pool, writes, block_tables, valid, tables):
        a = attention.prefill_chunk_into_paged_cache(
            self.cfg, self.attn, self.attn_norm(h), positions, pool, writes, block_tables,
            valid, window=self.window, tables=tables)
        h = h + a
        return h + self.mlp(self.mlp_norm(h))

    def decode_paged(self, h_t, t, pool, block_tables, writes, tables, fused_tail):
        a = attention.attn_decode_step_paged(self.cfg, self.attn, self.attn_norm(h_t), t, pool,
                                             block_tables, writes, window=self.window,
                                             tables=tables, fused_tail=fused_tail)
        h_t = h_t + a
        return h_t + self.mlp(self.mlp_norm(h_t))


class RecBlock(nn.Module):
    """Pre-norm RG-LRU + MLP block."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        self.rec_norm = layers.Norm(cfg, cfg.d_model, device=device, dtype=dtype)
        self.rec = rglru.RGLRU(cfg, device=device, dtype=dtype)
        self.mlp_norm = layers.Norm(cfg, cfg.d_model, device=device, dtype=dtype)
        self.mlp = layers.MLP(cfg, device=device, dtype=dtype)

    def init_(self, generator: torch.Generator) -> None:
        self.rec_norm.reset_parameters()
        self.rec.init_(generator)
        self.mlp_norm.reset_parameters()
        self.mlp.init_(generator)

    def forward(self, h, positions, segment_ids, tables):
        raise NotImplementedError(
            "the RG-LRU block's training forward (packed-segment resets of the scan) is "
            "ROADMAP queue A item 6, a later part of the PyTorch port")

    def prefill(self, h, positions, state, valid, tables):
        r, new = rglru.rglru_prefill_state(self.cfg, self.rec, self.rec_norm(h), valid=valid)
        for name in ("h", "conv"):
            state[name].copy_(new[name])
        h = h + r
        return h + self.mlp(self.mlp_norm(h))

    def decode(self, h_t, t, state, active, tables):
        r, new = rglru.rglru_decode_step(self.cfg, self.rec, self.rec_norm(h_t), state)
        for name in ("h", "conv"):
            # an inactive row keeps its state, as the reference's _mask_rows
            keep = new[name] if active is None else torch.where(
                active.reshape((-1,) + (1,) * (new[name].dim() - 1)), new[name], state[name])
            state[name].copy_(keep)
        h_t = h_t + r
        return h_t + self.mlp(self.mlp_norm(h_t))


class LM(nn.Module):
    """Decoder-only language model over attention and RG-LRU blocks.
    ``LM(cfg)`` allocates its weights uninitialised on ``device`` (CUDA
    unless told otherwise); ``init`` fills them from a generator, or
    ``convert.params_from_jax`` loads the reference's."""

    def __init__(self, cfg: ModelConfig, *, device="cuda", dtype=torch.float32):
        super().__init__()
        if cfg.family not in FAMILIES or cfg.is_encdec or cfg.is_moe:
            raise NotImplementedError(
                f"the PyTorch port builds dense and hybrid decoders only; {cfg.name} is "
                f"{cfg.family}")
        if any(bt not in BLOCK_KINDS for bt in cfg.block_pattern):
            raise NotImplementedError(f"block pattern {cfg.block_pattern} is not ported")
        if len({bt for bt in cfg.block_pattern if bt in ATTN_KINDS}) > 1:
            raise NotImplementedError("attention kinds of different windows in one pattern "
                                      f"({cfg.block_pattern}) are not ported")
        if cfg.rope_theta <= 0 or (cfg.n_prefix_tokens and cfg.prefix_dim):
            raise NotImplementedError("sinusoidal positions and prefix embeddings "
                                      "are not ported")
        device = resolve(device)
        self.cfg = cfg
        self.pattern = cfg.block_pattern
        self.n_units, self.n_rem = cfg.pattern_counts
        seq = list(self.pattern) * self.n_units + list(self.pattern[:self.n_rem])
        self.kinds = tuple(seq)
        # each layer's index in the cache stack of its kind of state
        self.stack_index = [sum(1 for k in seq[:i] if (k == "rec") == (bt == "rec"))
                            for i, bt in enumerate(seq)]
        self.n_rec = seq.count("rec")
        self.n_attn = len(seq) - self.n_rec
        attn = [bt for bt in seq if bt in ATTN_KINDS]
        self.attn_window = _block_window(cfg, attn[0]) if attn else 0
        self.embed = layers.Embed(cfg, device=device, dtype=dtype)
        self.blocks = nn.ModuleList(
            RecBlock(cfg, device=device, dtype=dtype) if bt == "rec"
            else Block(cfg, bt, device=device, dtype=dtype) for bt in seq)
        self.final_norm = layers.Norm(cfg, cfg.d_model, device=device, dtype=dtype)
        self.head = None
        if not cfg.tie_embeddings:
            self.head = nn.Module()
            self.head.w = layers._param((cfg.d_model, cfg.padded_vocab), device=device,
                                        dtype=dtype)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.table.dtype

    # ---- init -----------------------------------------------------------
    @torch.no_grad()
    def init(self, generator: torch.Generator, dtype: Optional[torch.dtype] = None) -> "LM":
        """Fill the weights in place: dense weights normal * 1/sqrt(in_dim),
        the embedding normal * 0.02, norms ones/zeros, the RG-LRU's conv
        normal / sqrt(width) and ``lam`` uniform in [0.38, 0.8] (the
        reference's shapes and scales; the numbers are this generator's
        own).  ``dtype`` recasts every weight but the f32 ``lam``."""
        if dtype is not None and dtype != self.dtype:
            for name, p in self.named_parameters():
                if name.rsplit(".", 1)[-1] not in rglru.F32_PARAMS:
                    p.data = p.data.to(dtype)
        self.embed.init_(generator)
        for blk in self.blocks:
            blk.init_(generator)
        self.final_norm.reset_parameters()
        if self.head is not None:
            layers.dense_init_(self.head.w, generator)
        return self

    # ---- training / scoring forward --------------------------------------
    def hidden_states(self, tokens, *, positions=None, segment_ids=None):
        """tokens: (B, S).  Returns (the final-normed hidden states (B, S,
        d), aux): aux holds the reference's scalars ``lb``, ``z`` and
        ``drop``, zeros for a dense model."""
        b, s = tokens.shape
        dev = tokens.device
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)
        h = self.embed(tokens)
        tables = layers.rope_tables(positions, self.cfg.head_dim, self.cfg.rope_theta)
        for blk in self.blocks:
            h = blk(h, positions, segment_ids, tables)
        aux = {k: torch.zeros((), dtype=torch.float32, device=dev) for k in ("lb", "z", "drop")}
        return self.final_norm(h), aux

    def forward(self, tokens, **kw):
        """(logits (B, S, Vp) f32 over the padded vocabulary, aux)."""
        h, aux = self.hidden_states(tokens, **kw)
        return self.logits(h), aux

    # ---- logits ---------------------------------------------------------
    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return layers.unembed_apply(self.embed.table,
                                    None if self.head is None else self.head.w,
                                    hidden, self.cfg.tie_embeddings)

    def _last_logits(self, h, length):
        """Logits (B, Vp) f32 of the final-normed hidden state h (B, S, d)
        at each row's last real token, length - 1."""
        h = self.final_norm(h)
        idx = (length.long() - 1).clamp(0, h.shape[1] - 1)
        return self.logits(h[torch.arange(h.shape[0], device=h.device), idx])

    # ---- serving --------------------------------------------------------
    def init_cache(self, batch: int, max_len: int,
                   dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        dtype = dtype or self.dtype
        cache = {}
        if self.n_attn:
            cache.update(attention.init_cache(cfg, batch, self.attn_window, max_len,
                                              dtype=dtype, device=self.device,
                                              n_layers=self.n_attn))
        if self.n_rec:
            cache.update(rglru.rglru_init_state(cfg, batch, dtype=dtype, device=self.device,
                                                n_layers=self.n_rec))
        cache["t"] = torch.zeros((batch,), dtype=torch.int32, device=self.device)
        return cache

    def _layer(self, cache, i: int):
        """Layer i's views of the stacked ring cache."""
        j = self.stack_index[i]
        names = ("h", "conv") if self.kinds[i] == "rec" else ("k", "v", "pos")
        return {name: cache[name][j] for name in names}

    @torch.no_grad()
    def prefill(self, tokens, cache, *, positions=None, length=None):
        """Process right-padded prompts (B, S), fill ``cache`` (B rows) in
        place and return the logits (B, Vp) f32 at each row's last real
        token.  length: (B,) real prompt lengths."""
        b, s = tokens.shape
        dev = tokens.device
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)
        if length is None:
            length = torch.full((b,), s, dtype=torch.int32, device=dev)
        valid = positions < length[:, None]
        h = self.embed(tokens)
        tables = layers.rope_tables(positions, self.cfg.head_dim, self.cfg.rope_theta)
        for i, blk in enumerate(self.blocks):
            # the valid mask keeps the padded tail inert during prefill
            h = blk.prefill(h, positions, self._layer(cache, i), valid, tables)
        cache["t"].copy_(length)
        return self._last_logits(h, length), cache

    @torch.no_grad()
    def decode_step(self, token, cache, active=None):
        """token: (B,) int.  Writes position ``cache["t"]`` of every
        active row and advances its ``t``; rows with ``active`` False keep
        their cache and position.  Returns (logits (B, Vp) f32, cache)."""
        t = cache["t"]
        h = self.embed(token)
        tables = layers.rope_tables(t[:, None], self.cfg.head_dim, self.cfg.rope_theta)
        for i, blk in enumerate(self.blocks):
            h = blk.decode(h, t, self._layer(cache, i), active, tables)
        h = self.final_norm(h)
        logits = self.logits(h)
        t_new = t + 1 if active is None else torch.where(active, t + 1, t)
        cache["t"].copy_(t_new)
        return logits, cache

    @torch.no_grad()
    def cache_insert(self, full, sub, slots: torch.Tensor):
        """Copy the rows of a sub-batch cache (from a group prefill) into
        ``full`` at the slot ids ``slots`` (G,), in place.  Every id is a
        real slot: the caller selects the real rows (the reference
        scatters dummy rows to an out-of-range id and drops them)."""
        slots = slots.long()
        for name in full:
            if name != "t":
                full[name][:, slots] = sub[name].to(full[name].dtype)
        full["t"][slots] = sub["t"]
        return full

    # ---- paged serving --------------------------------------------------
    def _paged_only_attention(self) -> None:
        if self.n_rec:
            raise NotImplementedError("a paged cache for recurrent blocks is a later part "
                                      "of the PyTorch port")

    def init_paged_cache(self, batch: int, n_blocks: int, block_size: int,
                         dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
        """Every layer's slice of a global (n_blocks, block_size, Hkv, hd)
        pool, and each slot's position ``t``.  The block tables live with
        the caller and are arguments of the paged methods."""
        self._paged_only_attention()
        cache = attention.init_paged_cache(self.cfg, n_blocks, block_size,
                                           dtype=dtype or self.dtype, device=self.device,
                                           n_layers=len(self.blocks))
        cache["t"] = torch.zeros((batch,), dtype=torch.int32, device=self.device)
        return cache

    @staticmethod
    def _pool(cache, i: int):
        return {"k_pool": cache["k_pool"][i], "v_pool": cache["v_pool"][i]}

    @torch.no_grad()
    def prefill_paged(self, tokens, cache, dest_blocks, slot_ids, *, length):
        """Prefill right-padded rows (G, S) into the pool in place and
        return the logits (G, Vp) f32 at each row's last real token.
        dest_blocks: (G, S) int32 pool block each token is written to (-1
        = not written: padding, or a prefix block another slot holds);
        slot_ids: (G,) the rows' slots, whose ``t`` becomes ``length``
        (G,), the rows' real lengths.  Every id is a real slot: the
        caller selects the real rows."""
        self._paged_only_attention()
        b, s = tokens.shape
        positions = torch.arange(s, dtype=torch.int32, device=tokens.device)[None].expand(b, s)
        valid = positions < length[:, None]
        bs = cache["k_pool"].shape[2]
        writes = attention.pool_writes(torch.where(valid, dest_blocks, -1), positions, bs)
        h = self.embed(tokens)
        tables = layers.rope_tables(positions, self.cfg.head_dim, self.cfg.rope_theta)
        for i, blk in enumerate(self.blocks):
            h = blk.prefill_paged(h, positions, self._pool(cache, i), writes, valid, tables)
        cache["t"][slot_ids.long()] = length.to(torch.int32)
        return self._last_logits(h, length), cache

    @torch.no_grad()
    def prefill_chunk_paged(self, tokens, cache, block_tables, dest_blocks, slot_ids, start,
                            length):
        """Continue the prefill of slots ``slot_ids`` (G,) with one span
        each: tokens (G, C), row j holding ``length[j]`` real tokens of its
        history from absolute position ``start[j]`` (the rest padding).
        The span's K/V are written into the pool at ``dest_blocks`` (G,
        C) and its queries attend the rows' ``block_tables`` (G, E).
        Returns the logits (G, Vp) f32 at each row's last real token; the
        rows' ``t`` become start + length."""
        self._paged_only_attention()
        g, c = tokens.shape
        dev = tokens.device
        positions = start[:, None] + torch.arange(c, dtype=torch.int32, device=dev)[None, :]
        valid = torch.arange(c, device=dev)[None, :] < length[:, None]
        bs = cache["k_pool"].shape[2]
        writes = attention.pool_writes(torch.where(valid, dest_blocks, -1), positions, bs)
        h = self.embed(tokens)
        tables = layers.rope_tables(positions, self.cfg.head_dim, self.cfg.rope_theta)
        for i, blk in enumerate(self.blocks):
            h = blk.prefill_chunk_paged(h, positions, self._pool(cache, i), writes,
                                        block_tables, valid, tables)
        cache["t"][slot_ids.long()] = (start + length).to(torch.int32)
        return self._last_logits(h, length), cache

    @torch.no_grad()
    def decode_step_paged(self, token, cache, block_tables, active=None,
                          fused_tail: bool = False):
        """token: (B,) int; block_tables: (B, E) int32.  Writes position
        ``cache["t"]`` of every active row into the pool and advances its
        ``t``; rows with ``active`` False write nothing and keep their
        position.  The destination blocks are looked up once for all
        layers.  fused_tail: each layer's attention and output projection
        run as one fused kernel.  Returns (logits (B, Vp) f32, cache)."""
        self._paged_only_attention()
        t = cache["t"]
        bs = cache["k_pool"].shape[2]
        dest = attention.decode_dest_blocks(t, block_tables, bs, active=active)
        writes = attention.pool_writes(dest, t, bs)
        h = self.embed(token)
        tables = layers.rope_tables(t[:, None], self.cfg.head_dim, self.cfg.rope_theta)
        for i, blk in enumerate(self.blocks):
            h = blk.decode_paged(h, t, self._pool(cache, i), block_tables, writes, tables,
                                 fused_tail)
        logits = self.logits(self.final_norm(h))
        t_new = t + 1 if active is None else torch.where(active, t + 1, t)
        cache["t"].copy_(t_new)
        return logits, cache

    @torch.no_grad()
    def reset_slot_rows(self, cache, slots: torch.Tensor):
        """Reset the positions ``t`` of slots (G,) to 0, in place, when
        they (re)start ingesting at watermark 0.  The pools are global
        and are left alone: stale pool contents are handled positionally
        and by the block version tags of the caller's allocator."""
        self._paged_only_attention()
        cache["t"][slots.long()] = 0
        return cache
