"""Whisper-style encoder-decoder (the audio family), mirroring
``repro/models/encdec.py``.

The mel spectrogram and its conv frontend are the stubbed modality
frontend: the model takes precomputed frame embeddings (B, F,
prefix_dim).  The encoder is bidirectional (non-causal flash attention
over the frames); the decoder is the autoregressive policy, with a ring
cache of self-attention and cross-attention whose K/V are computed once
at prefill and do not change while it decodes.  Both add sinusoidal
positions and have no rotary ones.

The serving cache is

    {"self": {"k": (L, B, W, Hkv, hd), "v": ..., "pos": (L, B, W) int32},
     "cross": {"k": (L, B, F, Hkv, hd), "v": ...}, "t": (B,) int32}

and every method updates it in place.  ``EncDecLM(cfg, remat=True,
remat_policy=...)`` checkpoints each encoder and each decoder layer of
the training forward (``layers.checkpointed``), as the reference's
``remat``.  ``init_cache`` sizes the cross
cache by ``cfg.encoder_seq_len``, as the reference does; ``prefill``
makes it as wide as the frames it is given (the reference returns a
cross cache of that width and ``decode_step`` attends over all of it),
so a decode never sees rows that no frame wrote.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.kernels import ops
from repro_torch.models import attention, layers


class EncoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.attn_norm = layers.Norm(cfg, cfg.d_model, **kw)
        self.attn = attention.Attention(cfg, **kw)
        self.mlp_norm = layers.Norm(cfg, cfg.d_model, **kw)
        self.mlp = layers.MLP(cfg, **kw)

    def init_(self, generator: torch.Generator) -> None:
        self.attn_norm.reset_parameters()
        self.attn.init_(generator)
        self.mlp_norm.reset_parameters()
        self.mlp.init_(generator)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.self_norm = layers.Norm(cfg, cfg.d_model, **kw)
        self.self = attention.Attention(cfg, **kw)
        self.cross_norm = layers.Norm(cfg, cfg.d_model, **kw)
        self.cross = attention.Attention(cfg, **kw)
        self.mlp_norm = layers.Norm(cfg, cfg.d_model, **kw)
        self.mlp = layers.MLP(cfg, **kw)

    def init_(self, generator: torch.Generator) -> None:
        for norm in (self.self_norm, self.cross_norm, self.mlp_norm):
            norm.reset_parameters()
        self.self.init_(generator)
        self.cross.init_(generator)
        self.mlp.init_(generator)


class EncDecLM(nn.Module):
    """The enc-dec model with ``LM``'s interface where the reference's
    ``EncDecLM`` has it: ``encode``, ``hidden_states``, ``forward``,
    ``logits``, ``init_cache``, ``prefill``, ``cache_insert`` and
    ``decode_step``.  The frames are ``prefix_embeds``.  ``EncDecLM(cfg)``
    allocates its weights uninitialised on ``device`` (CUDA unless told
    otherwise); ``init`` fills them, or ``convert.params_from_jax`` loads
    the reference's."""

    def __init__(self, cfg: ModelConfig, *, remat: bool = False, remat_policy: str = "none",
                 device="cuda", dtype=torch.float32):
        super().__init__()
        if not cfg.is_encdec:
            raise ValueError(f"{cfg.name} has no encoder layers")
        device = resolve(device)
        self.cfg = cfg
        if remat_policy not in layers.REMAT_POLICIES:
            raise ValueError(f"remat_policy {remat_policy!r}: one of {layers.REMAT_POLICIES}")
        self.remat, self.remat_policy = remat, remat_policy
        kw = dict(device=device, dtype=dtype)
        self.embed = layers.Embed(cfg, **kw)
        self.projector = nn.Module()
        self.projector.w = layers._param((cfg.prefix_dim, cfg.d_model), **kw)
        self.encoder = nn.ModuleList(EncoderLayer(cfg, **kw) for _ in range(cfg.encoder_layers))
        self.enc_norm = layers.Norm(cfg, cfg.d_model, **kw)
        self.decoder = nn.ModuleList(DecoderLayer(cfg, **kw) for _ in range(cfg.n_layers))
        self.final_norm = layers.Norm(cfg, cfg.d_model, **kw)
        self.head = None
        if not cfg.tie_embeddings:
            self.head = nn.Module()
            self.head.w = layers._param((cfg.d_model, cfg.padded_vocab), **kw)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.table.dtype

    @torch.no_grad()
    def init(self, generator: torch.Generator, dtype: Optional[torch.dtype] = None):
        """Fill the weights in place with the reference's distributions
        (dense weights normal * 1/sqrt(in_dim), the embedding normal *
        0.02, norms ones/zeros); ``dtype`` recasts every weight."""
        if dtype is not None and dtype != self.dtype:
            for p in self.parameters():
                p.data = p.data.to(dtype)
        self.embed.init_(generator)
        layers.dense_init_(self.projector.w, generator)
        for layer in (*self.encoder, *self.decoder):
            layer.init_(generator)
        self.enc_norm.reset_parameters()
        self.final_norm.reset_parameters()
        if self.head is not None:
            layers.dense_init_(self.head.w, generator)
        return self

    # ---- encoder ----------------------------------------------------------
    def encode(self, frames):
        """frames: (B, F, prefix_dim), the stubbed frontend's output.
        Returns the encoder's normed output (B, F, d)."""
        cfg = self.cfg
        h = layers.matmul(frames.to(self.dtype), self.projector.w)
        b, f, _ = h.shape
        positions = torch.arange(f, dtype=torch.int32, device=h.device)
        h = h + layers.sinusoidal_positions(positions, cfg.d_model)[None].to(h.dtype)
        positions = positions[None].expand(b, f)
        for layer in self.encoder:
            h = self._layer(self._encoder_layer, layer, h, positions)
        return self.enc_norm(h)

    def _layer(self, fn, *args):
        """``fn(*args)``, one layer's training forward: a checkpointed
        region under remat."""
        return layers.checkpointed(fn, self.remat_policy)(*args) if self.remat else fn(*args)

    def _encoder_layer(self, layer: EncoderLayer, h, positions):
        h = h + attention.attn_forward(self.cfg, layer.attn, layer.attn_norm(h), positions,
                                       causal=False)
        return h + layer.mlp(layer.mlp_norm(h))

    def _decoder_layer(self, layer: DecoderLayer, h, positions, segment_ids, enc_out):
        h = h + attention.attn_forward(self.cfg, layer.self, layer.self_norm(h), positions,
                                       segment_ids=segment_ids)
        return self._cross(layer, h, attention.cross_attn_kv(self.cfg, layer.cross, enc_out))

    def _embed(self, tokens, positions):
        """Token embeddings plus the sinusoidal rows at ``positions``
        (clipped to the reference's table of ``max_position_embeddings``)."""
        h = self.embed(tokens)
        pos = positions.clamp(0, self.cfg.max_position_embeddings - 1)
        return h + layers.sinusoidal_positions(pos, self.cfg.d_model).to(h.dtype)

    def _cross(self, layer: DecoderLayer, h, kv):
        h = h + attention.cross_attn_apply(self.cfg, layer.cross, layer.cross_norm(h), kv)
        return h + layer.mlp(layer.mlp_norm(h))

    # ---- training / scoring forward ---------------------------------------
    def hidden_states(self, tokens, *, positions=None, segment_ids=None, prefix_embeds=None,
                      enc_out=None):
        """tokens: (B, S); ``prefix_embeds`` are the frames (B, F,
        prefix_dim), or ``enc_out`` the encoder's output.  Returns (the
        final-normed decoder states (B, S, d), zero aux)."""
        b, s = tokens.shape
        dev = tokens.device
        if enc_out is None:
            if prefix_embeds is None:
                raise ValueError("the audio family needs frames (prefix_embeds)")
            enc_out = self.encode(prefix_embeds)
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)
        h = self._embed(tokens, positions)
        for layer in self.decoder:
            h = self._layer(self._decoder_layer, layer, h, positions, segment_ids, enc_out)
        aux = {k: torch.zeros((), dtype=torch.float32, device=dev) for k in ("lb", "z", "drop")}
        return self.final_norm(h), aux

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return layers.unembed_apply(self.embed.table,
                                    None if self.head is None else self.head.w,
                                    hidden, self.cfg.tie_embeddings)

    def forward(self, tokens, **kw):
        """(logits (B, S, Vp) f32, aux)."""
        h, aux = self.hidden_states(tokens, **kw)
        return self.logits(h), aux

    # ---- serving ------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, dtype: Optional[torch.dtype] = None,
                   device=None) -> Dict:
        cfg = self.cfg
        dtype = dtype or self.dtype
        device = device or self.device
        shape = (cfg.n_layers, batch, cfg.encoder_seq_len, cfg.n_kv_heads, cfg.head_dim)
        return {"self": attention.init_cache(cfg, batch, 0, max_len, dtype=dtype,
                                             device=device, n_layers=cfg.n_layers),
                "cross": {name: torch.zeros(shape, dtype=dtype, device=device)
                          for name in ("k", "v")},
                "t": torch.zeros((batch,), dtype=torch.int32, device=device)}

    @torch.no_grad()
    def prefill(self, tokens, cache, *, positions=None, prefix_embeds=None, length=None):
        """Encode the frames ``prefix_embeds`` (B, F, prefix_dim), run the
        right-padded decoder prompts (B, S) of ``length`` (B,) real tokens
        into ``cache`` (B rows) in place, and return the logits (B, Vp) f32
        at each row's last real token.  The cross cache becomes F frames
        wide."""
        cfg = self.cfg
        b, s = tokens.shape
        dev = tokens.device
        if prefix_embeds is None:
            raise ValueError("the audio family needs frames (prefix_embeds)")
        enc_out = self.encode(prefix_embeds)
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)
        if length is None:
            length = torch.full((b,), s, dtype=torch.int32, device=dev)
        valid = positions < length[:, None]
        f = enc_out.shape[1]
        cross = cache["cross"]
        if cross["k"].shape[2] != f:
            cache["cross"] = cross = {name: x.new_zeros(x.shape[:2] + (f,) + x.shape[3:])
                                      for name, x in cross.items()}
        h = self._embed(tokens, positions)
        for i, layer in enumerate(self.decoder):
            sc = {name: x[i] for name, x in cache["self"].items()}
            h = h + attention.prefill_into_cache(cfg, layer.self, layer.self_norm(h), positions,
                                                 sc, valid=valid)
            kv = attention.cross_attn_kv(cfg, layer.cross, enc_out)
            for name in ("k", "v"):
                cross[name][i] = kv[name]
            h = self._cross(layer, h, kv)
        cache["t"].copy_(length)
        h = self.final_norm(h)
        idx = (length.long() - 1).clamp(0, s - 1)
        return self.logits(h[torch.arange(b, device=dev), idx]), cache

    @torch.no_grad()
    def cache_insert(self, full, sub, slots: torch.Tensor):
        """Copy the rows of a sub-batch cache into ``full`` at the slot ids
        ``slots`` (G,), in place.  Both cross caches must be as wide."""
        slots = slots.long()
        if full["cross"]["k"].shape[2] != sub["cross"]["k"].shape[2]:
            raise ValueError(f"a cross cache of {sub['cross']['k'].shape[2]} frames does not "
                             f"fit one of {full['cross']['k'].shape[2]}")
        for part in ("self", "cross"):
            for name, x in full[part].items():
                x[:, slots] = sub[part][name].to(x.dtype)
        full["t"][slots] = sub["t"]
        return full

    @torch.no_grad()
    def decode_step(self, token, cache, active=None):
        """token: (B,) int.  Writes position ``cache["t"]`` of every active
        row into the self-attention ring and advances its ``t``; the cross
        attention reads every frame of the cross cache.  Returns (logits
        (B, Vp) f32, cache)."""
        cfg = self.cfg
        t = cache["t"]
        b = token.shape[0]
        h = self._embed(token, t)
        cross = cache["cross"]
        f = cross["k"].shape[2]
        cpos = torch.arange(f, dtype=torch.int32, device=t.device).repeat(b, 1)
        ct = torch.full((b,), f, dtype=torch.int32, device=t.device)
        for i, layer in enumerate(self.decoder):
            sc = {name: x[i] for name, x in cache["self"].items()}
            h = h + attention.attn_decode_step(cfg, layer.self, layer.self_norm(h), t, sc,
                                               active=active)
            hq = layer.cross_norm(h)
            q = layers.matmul(hq, layer.cross.wq).reshape(b, cfg.n_heads, cfg.head_dim)
            ck, cv = cross["k"][i], cross["v"][i]
            o = ops.decode_attention(q.to(ck.dtype).contiguous(), ck, cv, cpos, ct).to(h.dtype)
            h = h + layers.matmul(o.reshape(b, cfg.q_dim), layer.cross.wo)
            h = h + layer.mlp(layer.mlp_norm(h))
        logits = self.logits(self.final_norm(h))
        cache["t"].copy_(t + 1 if active is None else torch.where(active, t + 1, t))
        return logits, cache
