"""Decoder-only LM for the dense block patterns ``("attn",)`` and
``("swa",)``, mirroring the serving half of ``repro/models/transformer.py``.

The reference stacks the parameters of its repeating units on a leading
axis and scans over them; here the layers are an ``nn.ModuleList``
looped in Python.  The serving cache stacks the layers' ring caches on a
leading axis instead:

    {"k": (L, B, W, Hkv, hd), "v": ..., "pos": (L, B, W) int32, "t": (B,) int32}

and ``prefill``/``decode_step``/``cache_insert`` update it in place (the
reference returns a new cache; the port returns the same dict).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.models import attention, layers

ATTN_KINDS = ("attn", "swa")


def _block_window(cfg: ModelConfig, bt: str) -> int:
    return cfg.sliding_window if bt == "swa" else 0


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


class LM(nn.Module):
    """Dense decoder-only language model.  ``LM(cfg)`` allocates its
    weights uninitialised on ``device`` (CUDA unless told otherwise);
    ``init`` fills them from a generator, or ``convert.params_from_jax``
    loads the reference's."""

    def __init__(self, cfg: ModelConfig, *, device="cuda", dtype=torch.float32):
        super().__init__()
        if cfg.family != "dense" or cfg.is_encdec or cfg.is_moe:
            raise NotImplementedError(
                f"the PyTorch port builds dense decoders only; {cfg.name} is {cfg.family}")
        if any(bt not in ATTN_KINDS for bt in cfg.block_pattern):
            raise NotImplementedError(f"block pattern {cfg.block_pattern} is not ported")
        if cfg.rope_theta <= 0 or (cfg.n_prefix_tokens and cfg.prefix_dim):
            raise NotImplementedError("sinusoidal positions and prefix embeddings "
                                      "are not ported")
        device = resolve(device)
        self.cfg = cfg
        self.pattern = cfg.block_pattern
        self.n_units, self.n_rem = cfg.pattern_counts
        seq = list(self.pattern) * self.n_units + list(self.pattern[:self.n_rem])
        self.embed = layers.Embed(cfg, device=device, dtype=dtype)
        self.blocks = nn.ModuleList(
            Block(cfg, bt, device=device, dtype=dtype) for bt in seq)
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
        the embedding normal * 0.02, norms ones/zeros (the reference's
        shapes and scales; the numbers are this generator's own)."""
        if dtype is not None and dtype != self.dtype:
            self.to(dtype)
        self.embed.init_(generator)
        for blk in self.blocks:
            blk.init_(generator)
        self.final_norm.reset_parameters()
        if self.head is not None:
            layers.dense_init_(self.head.w, generator)
        return self

    # ---- logits ---------------------------------------------------------
    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return layers.unembed_apply(self.embed.table,
                                    None if self.head is None else self.head.w,
                                    hidden, self.cfg.tie_embeddings)

    # ---- serving --------------------------------------------------------
    def init_cache(self, batch: int, max_len: int,
                   dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        cache = attention.init_cache(cfg, batch, _block_window(cfg, self.pattern[0]),
                                     max_len, dtype=dtype or self.dtype, device=self.device,
                                     n_layers=len(self.blocks))
        cache["t"] = torch.zeros((batch,), dtype=torch.int32, device=self.device)
        return cache

    @staticmethod
    def _layer(cache, i: int):
        return {"k": cache["k"][i], "v": cache["v"][i], "pos": cache["pos"][i]}

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
        h = self.final_norm(h)
        idx = (length.long() - 1).clamp(0, s - 1)
        h_last = h[torch.arange(b, device=dev), idx]
        cache["t"].copy_(length)
        return self.logits(h_last), cache

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
        for name in ("k", "v", "pos"):
            full[name][:, slots] = sub[name].to(full[name].dtype)
        full["t"][slots] = sub["t"]
        return full
