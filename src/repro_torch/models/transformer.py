"""Decoder-only LM, mirroring ``repro/models/transformer.py`` (the
serving methods, and the training forward ``hidden_states`` /
``forward``), for block patterns over the attention kinds ``"attn"``,
``"swa"`` and ``"local"``, the RG-LRU recurrent block ``"rec"``
(RecurrentGemma's ``("rec", "rec", "local")``) and the xLSTM blocks
``"mlstm"`` and ``"slstm"`` (xLSTM's ``("mlstm",) * 7 + ("slstm",)``).
An attention block's FFN is an MLP or, for the MoE family, the mixture
of experts of ``models/moe.py``, at every call site with the rows the
caller gives (capacity couples them).  A VLM config adds a projector:
``forward``, ``hidden_states`` and ``prefill`` take ``prefix_embeds``,
projected and put ahead of the tokens; the paged and chunked methods
take none, as in the reference.  The enc-dec family is
``models/encdec.py``'s ``EncDecLM``; this LM has no sinusoidal
positions.

The reference stacks the parameters of its repeating units on a leading
axis and scans over them; here the layers are an ``nn.ModuleList``
looped in Python, in the reference's order: ``n_units`` repeats of the
pattern, then its first ``n_rem`` kinds.  The serving caches stack the
layers' caches on a leading axis instead, one stack per kind of state
(every attention kind shares one): the ring cache

    {"k": (L_attn, B, W, Hkv, hd), "v": ..., "pos": (L_attn, B, W) int32,
     "h": (L_rec, B, w) f32, "conv": (L_rec, B, W_conv - 1, w),
     "mlstm_C": (L_mlstm, B, H, hd, hd) f32, "mlstm_n": (L_mlstm, B, H, hd) f32,
     "mlstm_m": (L_mlstm, B, H) f32, "mlstm_conv": (L_mlstm, B, W_conv - 1, 2d),
     "slstm_h" / "slstm_c" / "slstm_n" / "slstm_m": (L_slstm, B, d) f32,
     "t": (B,) int32}

(the keys of a kind the pattern lacks are absent; ``STATE_KEYS`` maps
each recurrent kind's keys to the reference's names of its state) and
the paged cache, whose block tables the caller holds,

    {"k_pool": (L_attn, N, bs, Hkv, hd), "v_pool": ..., the recurrent keys, "t"}

where the attention layers hold slices of a global block pool and the
recurrent layers keep their slot-major state, as in the ring cache.
Every method updates them in place (the reference returns a new cache;
the port returns the same dict).

The draft and verify hooks of self-speculative decoding: ``decode_step``
and ``decode_step_paged`` take ``draft_units`` (run the first units
only), ``prefill_chunk`` and ``prefill_chunk_paged`` take
``all_logits`` (every span position's logits) and ``commit`` (False:
score the span and keep none of its state), and ``draft_rows`` /
``restore_rows`` save and put back what draft steps overwrite.

The training forward, of every block kind (packed rows: the recurrent
blocks' convs and states restart at each segment), is differentiable
once the parameters require gradients (they are created without).
``LM(cfg, remat=True, remat_policy=...)`` rematerialises it as the
reference's ``remat``: each of the ``n_units`` repeats of the pattern is
one checkpointed region (``layers.checkpointed``: policy "none" saves
nothing inside it, "dots" the outputs of the products with no batch
dimension), the ``n_rem`` remainder blocks run plain, and the numbers
do not change.  The default is no remat: ``run_training`` and the
serving paths build without it, as the reference's.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.dist.constraints import constrain, on_mesh, reshard
from repro_torch.models import attention, layers, moe, rglru, xlstm

ATTN_KINDS = ("attn", "swa", "local")
BLOCK_KINDS = ATTN_KINDS + ("rec", "mlstm", "slstm")
FAMILIES = ("dense", "hybrid", "moe", "vlm", "ssm")
MLSTM_CHUNK_THRESHOLD = 512      # above this the mLSTM takes its chunkwise form
# each recurrent kind's cache keys, by the reference's name of the state
STATE_KEYS = {"rec": {"h": "h", "conv": "conv"},
              "mlstm": {n: f"mlstm_{n}" for n in ("C", "n", "m", "conv")},
              "slstm": {n: f"slstm_{n}" for n in ("h", "c", "n", "m")}}
INIT_STATE = {"rec": rglru.rglru_init_state, "mlstm": xlstm.mlstm_init_state,
              "slstm": xlstm.slstm_init_state}


def _group(bt: str) -> str:
    """The kind of state a block of kind ``bt`` keeps: "attn" for every
    attention kind, else the kind itself."""
    return "attn" if bt in ATTN_KINDS else bt


def _store(state, new, active=None) -> None:
    """Copy ``new`` into the layer's ``state`` views in place; a row with
    ``active`` False keeps its state, as the reference's ``_mask_rows``.
    A DTensor state is written on each rank's own shard, ``new`` brought
    to its placements first (a gather where the state keeps what ``new``
    splits)."""
    for name, x in new.items():
        dst, keep = state[name], active
        if isinstance(dst, DTensor):
            dm = dst.device_mesh
            x = reshard(on_mesh(x, dm), dm, dst.placements).to_local()
            if keep is not None:
                rows = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                        for p in dst.placements]
                keep = reshard(on_mesh(keep, dm), dm, rows).to_local()
            dst = dst.to_local()
        if keep is not None:
            x = torch.where(keep.reshape((-1,) + (1,) * (x.dim() - 1)), x, dst)
        dst.copy_(x)


def _take_rows(x, idx, dim: int):
    """``x.index_select(dim, idx)``: the rows ``idx`` (G,) of a cache
    tensor whose dim ``dim`` is the batch's.  On a DTensor whose rows are
    split over some mesh dims, each rank takes the rows it holds (zeros
    for the others) and their sum over those dims (an all-reduce of G
    rows, exact: one rank holds each row) gives every rank all G rows."""
    if not isinstance(x, DTensor):
        return x.index_select(dim, idx)
    lo, n, pl = _local_rows(x, dim)
    idx = attention.gathered(idx).long()
    held = (idx >= lo) & (idx < lo + n)
    rows = x.to_local().index_select(dim, (idx - lo).clamp(0, max(n - 1, 0)))
    shape = [1] * rows.dim()
    shape[dim] = -1
    rows = torch.where(held.reshape(shape), rows, torch.zeros((), dtype=rows.dtype,
                                                              device=rows.device))
    full = list(x.shape)
    full[dim] = idx.shape[0]
    dm = x.device_mesh
    part = [Partial() if isinstance(p, Shard) and p.dim == dim else p for p in pl]
    out = DTensor.from_local(rows, dm, part, run_check=False, shape=torch.Size(full),
                             stride=torch.empty(full, device="meta").stride())
    return reshard(out, dm, [Replicate() if isinstance(p, Partial) else p for p in part])


def _put_rows(x, idx, vals, dim: int) -> None:
    """``x[idx] = vals`` along dim ``dim`` (the batch's), in place: on a
    DTensor each rank writes the rows it holds, from ``vals`` brought to
    x's placements off that dim."""
    if not isinstance(x, DTensor):
        if dim == 0:
            x[idx] = vals
        else:
            x[:, idx] = vals
        return
    lo, n, pl = _local_rows(x, dim)
    dm = x.device_mesh
    want = [Replicate() if isinstance(p, Shard) and p.dim == dim else p for p in pl]
    vals = reshard(on_mesh(vals, dm), dm, want).to_local()
    idx = attention.gathered(idx).long()
    held = (idx >= lo) & (idx < lo + n)
    sel = (torch.arange(idx.shape[0], device=idx.device) if idx.is_meta
           else torch.nonzero(held).squeeze(1))
    x.to_local().index_copy_(dim, (idx[sel] - lo).clamp(0, max(n - 1, 0)),
                             vals.index_select(dim, sel).to(x.dtype))


def _last_rows(h, length):
    """h (B, S, d) at each row's last real token, length - 1: (B, d)."""
    idx = (length.long() - 1).clamp(0, h.shape[1] - 1)
    return torch.gather(h, 1, idx[:, None, None].expand(-1, 1, h.shape[2]))[:, 0]


def _local_rows(x, dim: int):
    """(first global row, row count, placements) of this rank's shard of
    DTensor x along ``dim``."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    shape, offset = compute_local_shape_and_global_offset(x.shape, x.device_mesh,
                                                          x.placements)
    return offset[dim], shape[dim], list(x.placements)


def _block_window(cfg: ModelConfig, bt: str) -> int:
    if bt == "swa":
        return cfg.sliding_window
    if bt == "local":
        return cfg.local_window
    return 0


class Block(nn.Module):
    """Pre-norm attention block; its FFN is an MLP, or a mixture of
    experts when ``cfg.is_moe``."""

    def __init__(self, cfg: ModelConfig, bt: str, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        self.window = _block_window(cfg, bt)
        self.attn_norm = layers.Norm(cfg, cfg.d_model, device=device, dtype=dtype)
        self.attn = attention.Attention(cfg, device=device, dtype=dtype)
        self.mlp_norm = layers.Norm(cfg, cfg.d_model, device=device, dtype=dtype)
        if cfg.is_moe:
            self.moe = moe.MoE(cfg, device=device, dtype=dtype)
        else:
            self.mlp = layers.MLP(cfg, device=device, dtype=dtype)

    def init_(self, generator: torch.Generator) -> None:
        self.attn_norm.reset_parameters()
        self.attn.init_(generator)
        self.mlp_norm.reset_parameters()
        (self.moe if self.cfg.is_moe else self.mlp).init_(generator)

    def ffn(self, h):
        """(h + the FFN of its normed self, the MoE's aux or None).  Every
        row of h reaches the MoE: its capacity couples them."""
        hin = self.mlp_norm(h)
        if self.cfg.is_moe:
            y, aux = moe.moe_apply(self.cfg, self.moe, hin)
            return h + y, aux
        return h + self.mlp(hin), None

    def forward(self, h, positions, segment_ids, tables):
        """The training forward (``block_forward`` of an attention kind):
        (h, aux or None).  Under a mesh the row-parallel ``wo``'s partial
        sums are reduced before the FFN's norm, which needs whole rows."""
        a = attention.attn_forward(self.cfg, self.attn, self.attn_norm(h), positions,
                                   segment_ids=segment_ids, window=self.window, tables=tables)
        return self.ffn(constrain(h + a, "dp", None, None))

    def prefill(self, h, positions, cache, valid, tables):
        a = attention.prefill_into_cache(self.cfg, self.attn, self.attn_norm(h), positions,
                                         cache, valid=valid, window=self.window, tables=tables)
        return self.ffn(constrain(h + a, "dp", None, None))[0]

    def decode(self, h_t, t, cache, active, tables):
        a = attention.attn_decode_step(self.cfg, self.attn, self.attn_norm(h_t), t, cache,
                                       window=self.window, active=active, tables=tables)
        return self.ffn(constrain(h_t + a, "dp", None))[0]

    def prefill_chunk(self, h, positions, cache, start, writes, valid, tables):
        a = attention.prefill_chunk_into_cache(self.cfg, self.attn, self.attn_norm(h), positions,
                                               cache, start, writes, valid, window=self.window,
                                               tables=tables)
        return self.ffn(h + a)[0]

    def prefill_paged(self, h, positions, pool, writes, valid, tables):
        a = attention.prefill_into_paged_cache(self.cfg, self.attn, self.attn_norm(h),
                                               positions, pool, writes, valid,
                                               window=self.window, tables=tables)
        return self.ffn(h + a)[0]

    def prefill_chunk_paged(self, h, positions, pool, writes, block_tables, valid, tables):
        a = attention.prefill_chunk_into_paged_cache(
            self.cfg, self.attn, self.attn_norm(h), positions, pool, writes, block_tables,
            valid, window=self.window, tables=tables)
        return self.ffn(constrain(h + a, "dp", None, None))[0]

    def decode_paged(self, h_t, t, pool, block_tables, writes, tables, fused_tail):
        a = attention.attn_decode_step_paged(self.cfg, self.attn, self.attn_norm(h_t), t, pool,
                                             block_tables, writes, window=self.window,
                                             tables=tables, fused_tail=fused_tail)
        return self.ffn(constrain(h_t + a, "dp", None))[0]


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
        """The training forward (``block_forward`` of ``"rec"``): the
        RG-LRU over packed rows, its conv taps and its scan cut at segment
        boundaries.  (h, None): no aux."""
        r, _ = rglru.rglru_forward(self.cfg, self.rec, self.rec_norm(h),
                                   segment_ids=segment_ids)
        h = h + r
        return h + self.mlp(self.mlp_norm(h)), None

    def prefill(self, h, positions, state, valid, tables):
        r, new = rglru.rglru_prefill_state(self.cfg, self.rec, self.rec_norm(h), valid=valid)
        _store(state, new)
        h = constrain(h + r, "dp", None, None)
        return h + self.mlp(self.mlp_norm(h))

    def prefill_chunk(self, h, positions, state, start, writes, valid, tables):
        """A span continued from the rows' state (``state`` holds the rows
        of the span, not of every slot): the scan starts from their h and
        the conv sees their history as left context."""
        r, new = rglru.rglru_prefill_state(self.cfg, self.rec, self.rec_norm(h), state=state,
                                           valid=valid)
        _store(state, new)
        h = constrain(h + r, "dp", None, None)
        return h + self.mlp(self.mlp_norm(h))

    def decode(self, h_t, t, state, active, tables):
        r, new = rglru.rglru_decode_step(self.cfg, self.rec, self.rec_norm(h_t), state)
        _store(state, new, active)
        h_t = constrain(h_t + r, "dp", None)
        return h_t + self.mlp(self.mlp_norm(h_t))


class MLSTMBlock(nn.Module):
    """The mLSTM block: its cell carries its own pre-norm and up/down
    projections, with no separate FFN."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        self.cell = xlstm.MLSTM(cfg, device=device, dtype=dtype)

    def init_(self, generator: torch.Generator) -> None:
        self.cell.init_(generator)

    def forward(self, h, positions, segment_ids, tables):
        """The training forward: the parallel form up to
        ``MLSTM_CHUNK_THRESHOLD`` tokens a row, the chunkwise form above
        (the two differ in rounding).  (h, None): no aux."""
        hin = self.cell.norm(h)
        fn = (xlstm.mlstm_forward_chunked if h.shape[1] > MLSTM_CHUNK_THRESHOLD
              else xlstm.mlstm_forward)
        return h + fn(self.cfg, self.cell, hin, segment_ids=segment_ids), None

    def prefill(self, h, positions, state, valid, tables):
        hin = self.cell.norm(h)
        if h.shape[1] > MLSTM_CHUNK_THRESHOLD:
            y, new = xlstm.mlstm_forward_chunked(self.cfg, self.cell, hin, valid=valid,
                                                 return_state=True)
        else:
            y, new = xlstm.mlstm_prefill_state(self.cfg, self.cell, hin, valid=valid)
        _store(state, new)
        return h + y

    def prefill_chunk(self, h, positions, state, start, writes, valid, tables):
        """A span continued from the rows' state (C, n, m and the conv
        history), in the chunkwise form."""
        y, new = xlstm.mlstm_forward_chunked(self.cfg, self.cell, self.cell.norm(h),
                                             valid=valid, state=state, return_state=True)
        _store(state, new)
        return h + y

    def decode(self, h_t, t, state, active, tables):
        y, new = xlstm.mlstm_decode_step(self.cfg, self.cell, self.cell.norm(h_t), state)
        _store(state, new, active)
        return h_t + y


class SLSTMBlock(nn.Module):
    """The sLSTM block: the cell's loop over time, then its own FFN."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        self.cell = xlstm.SLSTM(cfg, device=device, dtype=dtype)

    def init_(self, generator: torch.Generator) -> None:
        self.cell.init_(generator)

    def _ffn(self, h):
        return h + xlstm.slstm_ffn(self.cfg, self.cell, self.cell.ffn_norm(h))

    def forward(self, h, positions, segment_ids, tables):
        """The training forward: the state resets at each packed segment's
        start.  (h, None): no aux."""
        y, _ = xlstm.slstm_forward(self.cfg, self.cell, self.cell.norm(h),
                                   segment_ids=segment_ids)
        return self._ffn(h + y), None

    def prefill(self, h, positions, state, valid, tables):
        y, new = xlstm.slstm_forward(self.cfg, self.cell, self.cell.norm(h), valid=valid)
        _store(state, new)
        return self._ffn(h + y)

    def prefill_chunk(self, h, positions, state, start, writes, valid, tables):
        y, new = xlstm.slstm_forward(self.cfg, self.cell, self.cell.norm(h), state=state,
                                     valid=valid)
        _store(state, new)
        return self._ffn(h + y)

    def decode(self, h_t, t, state, active, tables):
        new = xlstm._slstm_cell(self.cfg, self.cell, self.cell.norm(h_t), state)
        h_t = h_t + new["h"].to(h_t.dtype)
        _store(state, new, active)
        return self._ffn(h_t)


RECURRENT_BLOCKS = {"rec": RecBlock, "mlstm": MLSTMBlock, "slstm": SLSTMBlock}


class LM(nn.Module):
    """Decoder-only language model over attention blocks (with an MLP or
    a mixture of experts), RG-LRU blocks and xLSTM blocks, with the VLM's
    projected prefix when the config has one.  ``LM(cfg)`` allocates its
    weights uninitialised on ``device`` (CUDA unless told otherwise);
    ``init`` fills them from a generator, or ``convert.params_from_jax``
    loads the reference's."""

    def __init__(self, cfg: ModelConfig, *, remat: bool = False, remat_policy: str = "none",
                 device="cuda", dtype=torch.float32):
        super().__init__()
        if remat_policy not in layers.REMAT_POLICIES:
            raise ValueError(f"remat_policy {remat_policy!r}: one of {layers.REMAT_POLICIES}")
        if cfg.family not in FAMILIES or cfg.is_encdec:
            raise NotImplementedError(
                f"LM builds the {', '.join(FAMILIES)} decoders; {cfg.name} is {cfg.family} "
                "(build_model gives the enc-dec family its EncDecLM)")
        if any(bt not in BLOCK_KINDS for bt in cfg.block_pattern):
            raise NotImplementedError(f"block pattern {cfg.block_pattern} is not ported")
        if len({bt for bt in cfg.block_pattern if bt in ATTN_KINDS}) > 1:
            raise NotImplementedError("attention kinds of different windows in one pattern "
                                      f"({cfg.block_pattern}) are not ported")
        if cfg.rope_theta <= 0:
            raise NotImplementedError("the decoder-only LM has no sinusoidal positions")
        device = resolve(device)
        self.cfg = cfg
        self.remat, self.remat_policy = remat, remat_policy
        self.pattern = cfg.block_pattern
        self.n_units, self.n_rem = cfg.pattern_counts
        seq = list(self.pattern) * self.n_units + list(self.pattern[:self.n_rem])
        self.kinds = tuple(seq)
        groups = [_group(bt) for bt in seq]
        # each layer's index in the cache stack of its kind of state
        self.stack_index = [groups[:i].count(g) for i, g in enumerate(groups)]
        # the layers of each kind of state, in the order of first use
        self.n_state = {g: groups.count(g) for g in dict.fromkeys(groups)}
        self.n_attn = self.n_state.get("attn", 0)
        self.n_rec = self.n_state.get("rec", 0)
        attn = [bt for bt in seq if bt in ATTN_KINDS]
        self.attn_window = _block_window(cfg, attn[0]) if attn else 0
        self.embed = layers.Embed(cfg, device=device, dtype=dtype)
        self.blocks = nn.ModuleList(
            RECURRENT_BLOCKS[bt](cfg, device=device, dtype=dtype) if bt in RECURRENT_BLOCKS
            else Block(cfg, bt, device=device, dtype=dtype) for bt in seq)
        self.final_norm = layers.Norm(cfg, cfg.d_model, device=device, dtype=dtype)
        self.head = None
        if not cfg.tie_embeddings:
            self.head = nn.Module()
            self.head.w = layers._param((cfg.d_model, cfg.padded_vocab), device=device,
                                        dtype=dtype)
        self.projector = None
        if cfg.n_prefix_tokens and cfg.prefix_dim:
            self.projector = nn.Module()
            self.projector.w = layers._param((cfg.prefix_dim, cfg.d_model), device=device,
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
        the embedding normal * 0.02, norms ones/zeros, the experts' as
        ``moe.MoE.init_``, the RG-LRU's conv normal / sqrt(width) and
        ``lam`` uniform in [0.38, 0.8], the xLSTM cells' as
        ``xlstm.MLSTM.init_`` / ``xlstm.SLSTM.init_`` (the reference's
        shapes and scales; the numbers are this generator's own).
        ``dtype`` recasts every weight but the f32 ``lam``."""
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
        if self.projector is not None:
            layers.dense_init_(self.projector.w, generator)
        return self

    # ---- embedding ------------------------------------------------------
    def _embed(self, tokens, positions, prefix_embeds):
        """(h, positions) of the token embeddings, behind the projected
        ``prefix_embeds`` (B, P, prefix_dim) when given: the prefix takes
        positions 0..P-1 and the tokens' positions shift by P."""
        h = self.embed(tokens)
        if prefix_embeds is not None:
            pre = layers.matmul(prefix_embeds.to(h.dtype), self.projector.w)
            b, p = pre.shape[:2]
            h = torch.cat([pre, h], dim=1)
            ppos = torch.arange(p, dtype=positions.dtype, device=h.device)[None].expand(b, p)
            positions = torch.cat([ppos, positions + p], dim=1)
        return h, positions

    # ---- training / scoring forward --------------------------------------
    def hidden_states(self, tokens, *, positions=None, segment_ids=None, prefix_embeds=None):
        """tokens: (B, S).  Returns (the final-normed hidden states (B, P +
        S, d), aux), P the prefix's length (0 without one): aux holds the
        reference's scalars ``lb``, ``z`` and ``drop`` summed over the
        layers, zeros for a model without experts.  The prefix takes the
        segment id of each row's first token.  Under ``remat`` each unit
        of the pattern is one checkpointed region, its aux returned once
        (the recompute's outputs are not returned)."""
        b, s = tokens.shape
        dev = tokens.device
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)
        h, positions = self._embed(tokens, positions, prefix_embeds)
        h = constrain(h, "dp", None, None)
        if segment_ids is not None and prefix_embeds is not None:
            pseg = segment_ids[:, :1].expand(b, prefix_embeds.shape[1])
            segment_ids = torch.cat([pseg, segment_ids], dim=1)
        tables = layers.rope_tables(positions, self.cfg.head_dim, self.cfg.rope_theta)
        aux = {k: torch.zeros((), dtype=torch.float32, device=dev) for k in ("lb", "z", "drop")}
        if self.remat:
            p = len(self.pattern)
            unit = layers.checkpointed(self._run_blocks, self.remat_policy)
            for u in range(self.n_units):
                h, aux = unit(self.blocks[u * p:(u + 1) * p], h, aux, positions, segment_ids,
                              tables)
            rest = self.blocks[self.n_units * p:]
        else:
            rest = self.blocks
        h, aux = self._run_blocks(rest, h, aux, positions, segment_ids, tables)
        return self.final_norm(h), aux

    @staticmethod
    def _run_blocks(blocks, h, aux, positions, segment_ids, tables):
        """``blocks`` in order on h, their aux added to ``aux``: a unit of
        the pattern (a checkpointed region under remat) or the rest."""
        for blk in blocks:
            h, a = blk(h, positions, segment_ids, tables)
            h = constrain(h, "dp", None, None)
            if a is not None:
                aux = {k: aux[k] + a[k] for k in aux}
        return h, aux

    def forward(self, tokens, **kw):
        """(logits (B, P + S, Vp) f32 over the padded vocabulary, aux)."""
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
        return self.logits(layers.row_local(_last_rows, self.final_norm(h), length))

    # ---- serving --------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, dtype: Optional[torch.dtype] = None,
                   device=None) -> Dict[str, torch.Tensor]:
        """A fresh ring cache of ``batch`` rows, on the model's device or on
        ``device``."""
        cfg = self.cfg
        dtype = dtype or self.dtype
        device = device or self.device
        cache = {}
        if self.n_attn:
            cache.update(attention.init_cache(cfg, batch, self.attn_window, max_len,
                                              dtype=dtype, device=device,
                                              n_layers=self.n_attn))
        cache.update(self._init_states(batch, dtype, device))
        cache["t"] = torch.zeros((batch,), dtype=torch.int32, device=device)
        return cache

    def _init_states(self, batch: int, dtype, device=None) -> Dict[str, torch.Tensor]:
        """Fresh stacked states of every recurrent kind, under their cache
        keys."""
        state = {}
        for g, n in self.n_state.items():
            if g != "attn":
                fresh = INIT_STATE[g](self.cfg, batch, dtype=dtype, device=device or self.device,
                                      n_layers=n)
                state.update({STATE_KEYS[g][name]: x for name, x in fresh.items()})
        return state

    def _state_keys(self):
        """The cache keys of every recurrent kind of the model."""
        return [k for g in self.n_state if g != "attn" for k in STATE_KEYS[g].values()]

    def _layer(self, cache, i: int):
        """Layer i's views of the stacked ring cache, under the reference's
        names of its state."""
        j = self.stack_index[i]
        g = _group(self.kinds[i])
        names = ({"k": "k", "v": "v", "pos": "pos"} if g == "attn" else STATE_KEYS[g])
        return {name: cache[key][j] for name, key in names.items()}

    @torch.no_grad()
    def prefill(self, tokens, cache, *, positions=None, length=None, prefix_embeds=None):
        """Process right-padded prompts (B, S), fill ``cache`` (B rows) in
        place and return the logits (B, Vp) f32 at each row's last real
        token.  length: (B,) real prompt lengths.  ``prefix_embeds`` (B,
        P, prefix_dim): the projected prefix goes ahead of every row, so
        the cache holds P + length positions a row."""
        b, s = tokens.shape
        dev = tokens.device
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)
        if length is None:
            length = torch.full((b,), s, dtype=torch.int32, device=dev)
        valid = positions < length[:, None]
        h, positions = self._embed(tokens, positions, prefix_embeds)
        if prefix_embeds is not None:
            npre = prefix_embeds.shape[1]
            length = length + npre
            valid = torch.cat([torch.ones((b, npre), dtype=torch.bool, device=dev), valid], 1)
        tables = layers.rope_tables(positions, self.cfg.head_dim, self.cfg.rope_theta)
        h = constrain(h, "dp", None, None)
        for i, blk in enumerate(self.blocks):
            # the valid mask keeps the padded tail inert during prefill
            h = constrain(blk.prefill(h, positions, self._layer(cache, i), valid, tables),
                          "dp", None, None)
        cache["t"].copy_(length)
        return self._last_logits(h, length), cache

    def _n_run(self, draft_units: Optional[int]) -> int:
        """Blocks a decode step runs: every one, or the first
        ``draft_units`` units' (no remainder layers), the truncated model
        that drafts for self-speculative decoding."""
        if draft_units is None:
            return len(self.blocks)
        if not 1 <= int(draft_units) <= self.n_units:
            raise ValueError(f"draft_units must be in [1, {self.n_units}], got {draft_units}")
        return int(draft_units) * len(self.pattern)

    @torch.no_grad()
    def decode_step(self, token, cache, active=None, draft_units: Optional[int] = None):
        """token: (B,) int.  Writes position ``cache["t"]`` of every
        active row and advances its ``t``; rows with ``active`` False keep
        their cache and position.  ``draft_units``: run only the first
        units (``_n_run``); the other layers' caches are not touched.
        Returns (logits (B, Vp) f32, cache)."""
        t = cache["t"]
        h = constrain(self.embed(token), "dp", None)
        tables = layers.rope_tables(t[:, None], self.cfg.head_dim, self.cfg.rope_theta)
        for i in range(self._n_run(draft_units)):
            h = constrain(self.blocks[i].decode(h, t, self._layer(cache, i), active, tables),
                          "dp", None)
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

    @torch.no_grad()
    def cache_gather(self, cache, slots: torch.Tensor):
        """The inverse of ``cache_insert``: a sub-batch cache holding a
        copy of the rows of ``cache`` at the slot ids ``slots`` (G,).
        Every id is a real slot, as for ``cache_insert``."""
        slots = slots.long()
        sub = {name: x[:, slots] for name, x in cache.items() if name != "t"}
        sub["t"] = cache["t"][slots]
        return sub

    def _span_logits(self, h, length, all_logits: bool):
        """A span's logits: at each row's last real token (G, Vp), or at
        every position (G, C, Vp), f32."""
        if all_logits:
            return self.logits(self.final_norm(h))
        return self._last_logits(h, length)

    @torch.no_grad()
    def prefill_chunk(self, tokens, cache, slot_ids, start, length, *, all_logits: bool = False,
                      commit: bool = True, rows=None):
        """Continue the prefill of slots ``slot_ids`` (G,) against the
        ring cache with one span each: tokens (G, C), row j holding
        ``length[j]`` real tokens of its history from absolute position
        ``start[j]`` (the rest padding).  The rows' cache is gathered,
        advanced through every block (each attention block attends to its
        cache entries before ``start`` and to the span itself; each
        recurrent block continues from the rows' state) and written back,
        so the rows' ``t`` become start + length.  Returns the logits at
        each row's last real token (G, Vp) f32, or with ``all_logits`` at
        every position (G, C, Vp), the verify pass of speculative
        decoding.  ``commit=False`` drops the advanced copy: the cache is
        left as it was.  ``rows``: the indices of the rows to write back
        (default every row; the others are dummy rows, computed and
        dropped, whose ids need not be distinct)."""
        g, c = tokens.shape
        dev = tokens.device
        positions = start[:, None] + torch.arange(c, dtype=torch.int32, device=dev)[None, :]
        valid = torch.arange(c, device=dev)[None, :] < length[:, None]
        sub = self.cache_gather(cache, slot_ids)
        writes = (attention.ring_chunk_writes(positions, valid, sub["k"].shape[2])
                  if self.n_attn else None)
        h = self.embed(tokens)
        tables = layers.rope_tables(positions, self.cfg.head_dim, self.cfg.rope_theta)
        for i, blk in enumerate(self.blocks):
            h = blk.prefill_chunk(h, positions, self._layer(sub, i), start, writes, valid, tables)
        if commit:
            sub["t"] = (start + length).to(torch.int32)
            if rows is not None:
                sub = {name: x[rows] if name == "t" else x[:, rows] for name, x in sub.items()}
                slot_ids = slot_ids[rows]
            self.cache_insert(cache, sub, slot_ids)
        return self._span_logits(h, length, all_logits), cache

    # ---- paged serving --------------------------------------------------
    def init_paged_cache(self, batch: int, n_blocks: int, block_size: int,
                         dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
        """Every attention layer's slice of a global (n_blocks,
        block_size, Hkv, hd) pool, every recurrent layer's slot-major
        state (nothing of it to page), and each slot's position ``t``.
        The block tables live with the caller and are arguments of the
        paged methods."""
        dtype = dtype or self.dtype
        cache = {}
        if self.n_attn:
            cache.update(attention.init_paged_cache(self.cfg, n_blocks, block_size,
                                                    dtype=dtype, device=self.device,
                                                    n_layers=self.n_attn))
        cache.update(self._init_states(batch, dtype))
        cache["t"] = torch.zeros((batch,), dtype=torch.int32, device=self.device)
        return cache

    def _pool(self, cache, i: int):
        """Attention layer i's slice of the pools."""
        j = self.stack_index[i]
        return {"k_pool": cache["k_pool"][j], "v_pool": cache["v_pool"][j]}

    def _rec_rows(self, cache, slots: torch.Tensor):
        """A copy of the recurrent state rows of ``slots`` (G,) (on a mesh,
        every rank gets every row: ``_take_rows``)."""
        return {name: _take_rows(cache[name], slots, 1) for name in self._state_keys()}

    @torch.no_grad()
    def prefill_paged(self, tokens, cache, dest_blocks, slot_ids, *, length, rows=None):
        """Prefill right-padded rows (G, S) into the pool in place and
        return the logits (G, Vp) f32 at each row's last real token.
        dest_blocks: (G, S) int32 pool block each token is written to (-1
        = not written: padding, or a prefix block another slot holds);
        slot_ids: (G,) the rows' slots, whose recurrent state is scanned
        from fresh and written to their rows and whose ``t`` becomes
        ``length`` (G,), the rows' real lengths.  ``rows``: the indices of
        the real rows (default: every row); the others are dummy rows,
        computed (a mixture of experts sees them) and written nowhere,
        their ``dest_blocks`` all -1."""
        b, s = tokens.shape
        positions = torch.arange(s, dtype=torch.int32, device=tokens.device)[None].expand(b, s)
        valid = positions < length[:, None]
        writes = None
        if self.n_attn:
            bs = cache["k_pool"].shape[2]
            writes = attention.pool_writes(torch.where(valid, dest_blocks, -1), positions, bs)
        # a fresh state for the rows, in the cache's dtype (a conv history's)
        conv = [cache[k] for k in ("conv", "mlstm_conv") if k in cache]
        rec = self._init_states(b, conv[0].dtype if conv else self.dtype)
        h = self.embed(tokens)
        tables = layers.rope_tables(positions, self.cfg.head_dim, self.cfg.rope_theta)
        for i, blk in enumerate(self.blocks):
            if self.kinds[i] not in ATTN_KINDS:
                h = blk.prefill(h, positions, self._layer(rec, i), valid, tables)
            else:
                h = blk.prefill_paged(h, positions, self._pool(cache, i), writes, valid, tables)
        sid = slot_ids.long()
        if rows is not None:
            sid, length_w = sid[rows], length[rows]
            rec = {name: x[:, rows] for name, x in rec.items()}
        else:
            length_w = length
        for name, x in rec.items():
            cache[name][:, sid] = x
        cache["t"][sid] = length_w.to(torch.int32)
        return self._last_logits(h, length), cache

    @torch.no_grad()
    def prefill_chunk_paged(self, tokens, cache, block_tables, dest_blocks, slot_ids, start,
                            length, *, all_logits: bool = False, commit: bool = True,
                            rows=None):
        """Continue the prefill of slots ``slot_ids`` (G,) with one span
        each: tokens (G, C), row j holding ``length[j]`` real tokens of its
        history from absolute position ``start[j]`` (the rest padding).
        The span's K/V are written into the pool at ``dest_blocks`` (G,
        C) and its queries attend the rows' ``block_tables`` (G, E); the
        recurrent blocks continue from the rows' state.  Returns the
        logits (G, Vp) f32 at each row's last real token, or with
        ``all_logits`` at every position (G, C, Vp); the rows' state is
        written back and their ``t`` become start + length.
        ``commit=False`` keeps neither, and with experts puts the pool
        entries the span wrote back as well (a row that sees no key
        averages every entry its table gathers); otherwise the span's K/V
        stay in the pool, at the rows' watermark and past it, where no
        query with a key in view reads them before a committed span
        rewrites them.  ``rows`` as in
        ``prefill_chunk`` (a dummy row's ``dest_blocks`` are all -1)."""
        g, c = tokens.shape
        dev = tokens.device
        positions = start[:, None] + torch.arange(c, dtype=torch.int32, device=dev)[None, :]
        valid = torch.arange(c, device=dev)[None, :] < length[:, None]
        writes = None
        if self.n_attn:
            bs = cache["k_pool"].shape[2]
            writes = attention.pool_writes(torch.where(valid, dest_blocks, -1), positions, bs)
        sid = slot_ids.long()
        rec = self._rec_rows(cache, sid)
        kept = None
        if not commit and self.cfg.is_moe and self.n_attn:
            _, blocks, offsets = writes
            kept = {name: cache[name][:, blocks, offsets] for name in ("k_pool", "v_pool")}
        h = constrain(self.embed(tokens), "dp", None, None)
        tables = layers.rope_tables(positions, self.cfg.head_dim, self.cfg.rope_theta)
        for i, blk in enumerate(self.blocks):
            if self.kinds[i] not in ATTN_KINDS:
                h = blk.prefill_chunk(h, positions, self._layer(rec, i), start, None, valid,
                                      tables)
            else:
                h = blk.prefill_chunk_paged(h, positions, self._pool(cache, i), writes,
                                            block_tables, valid, tables)
            h = constrain(h, "dp", None, None)
        if kept is not None:
            for name, x in kept.items():
                cache[name][:, writes[1], writes[2]] = x
        if commit:
            t_new = (start + length).to(torch.int32)
            if rows is not None:
                sid, t_new = sid[rows], t_new[rows]
                rec = {name: x[:, rows] for name, x in rec.items()}
            for name, x in rec.items():
                _put_rows(cache[name], sid, x, 1)
            _put_rows(cache["t"], sid, t_new, 0)
        return self._span_logits(h, length, all_logits), cache

    @torch.no_grad()
    def decode_step_paged(self, token, cache, block_tables, active=None,
                          fused_tail: bool = False, draft_units: Optional[int] = None):
        """token: (B,) int; block_tables: (B, E) int32.  Writes position
        ``cache["t"]`` of every active row into the pool and advances its
        ``t``; rows with ``active`` False write nothing and keep their
        state and position.  The destination blocks are looked up once
        for all layers.  fused_tail: each layer's attention and output
        projection run as one fused kernel.  ``draft_units`` as in
        ``decode_step``.  Returns (logits (B, Vp) f32, cache).  Under a
        mesh the pool is whole on the data axes, so the destinations and
        each layer's new K/V rows are gathered over them and every data
        replica applies every write (``attention.pool_writes``,
        ``_pool_scatter``)."""
        t = cache["t"]
        writes = None
        if self.n_attn:
            bs = cache["k_pool"].shape[2]
            dest = attention.decode_dest_blocks(t, block_tables, bs, active=active)
            writes = attention.pool_writes(dest, t, bs)
        h = constrain(self.embed(token), "dp", None)
        tables = layers.rope_tables(t[:, None], self.cfg.head_dim, self.cfg.rope_theta)
        for i in range(self._n_run(draft_units)):
            blk = self.blocks[i]
            if self.kinds[i] not in ATTN_KINDS:
                h = blk.decode(h, t, self._layer(cache, i), active, tables)
            else:
                h = blk.decode_paged(h, t, self._pool(cache, i), block_tables, writes, tables,
                                     fused_tail)
            h = constrain(h, "dp", None)
        logits = self.logits(self.final_norm(h))
        t_new = t + 1 if active is None else torch.where(active, t + 1, t)
        cache["t"].copy_(t_new)
        return logits, cache

    # ---- the draft's scratch --------------------------------------------
    @torch.no_grad()
    def draft_rows(self, cache, steps: int, draft_units: int,
                   block_tables=None) -> Dict[str, torch.Tensor]:
        """Copies of what ``steps`` decode steps of the first
        ``draft_units`` units can change in ``cache``, for
        ``restore_rows``: every slot's ``t``, the recurrent state of the
        layers the draft runs and, in a ring cache, the K/V/pos entries at
        ring slots (t + j) % W, j < steps, of its attention layers (a
        write at position p replaces the entry of p - W, which a later
        query still reads once the ring has wrapped).  A few rows a layer,
        not a copy of the cache.  A paged cache's pool entries at
        positions t + j (through ``block_tables``) are saved only for a
        mixture of experts, whose rows that see no key average every
        entry their table gathers, stale ones past the watermark
        included; a query with a key in view never reads them before a
        committed span rewrites them."""
        n = self._n_run(draft_units)
        groups = [_group(bt) for bt in self.kinds[:n]]
        n_attn = groups.count("attn")
        saved = {"t": cache["t"].clone()}
        for g in dict.fromkeys(groups):
            if g != "attn":
                saved.update({key: cache[key][:groups.count(g)].clone()
                              for key in STATE_KEYS[g].values()})
        if n_attn and "k" in cache:
            w = cache["k"].shape[2]
            steps_ = torch.arange(steps, device=cache["t"].device)
            saved["ring"] = (cache["t"].long()[:, None] + steps_[None, :]) % w    # (B, steps)
            rows = torch.arange(cache["t"].shape[0], device=cache["t"].device)[:, None]
            for name in ("k", "v", "pos"):
                saved[name] = cache[name][:n_attn, rows, saved["ring"]]
        if n_attn and block_tables is not None and self.cfg.is_moe:
            bs, e = cache["k_pool"].shape[2], block_tables.shape[1]
            pos = cache["t"].long()[:, None] + torch.arange(steps, device=cache["t"].device)
            entry = pos // bs
            blocks = torch.gather(block_tables.long(), 1, entry.clamp(max=e - 1))
            keep = (entry < e) & (blocks >= 0)
            saved["pool"] = (blocks[keep], (pos % bs)[keep])
            saved["k_pool"] = cache["k_pool"][:n_attn, saved["pool"][0], saved["pool"][1]]
            saved["v_pool"] = cache["v_pool"][:n_attn, saved["pool"][0], saved["pool"][1]]
        return saved

    @torch.no_grad()
    def restore_rows(self, cache, saved: Dict[str, torch.Tensor]):
        """Put ``draft_rows``' copies back, in place."""
        cache["t"].copy_(saved["t"])
        for name in self._state_keys():
            if name in saved:
                cache[name][:saved[name].shape[0]] = saved[name]
        if "ring" in saved:
            rows = torch.arange(cache["t"].shape[0], device=cache["t"].device)[:, None]
            for name in ("k", "v", "pos"):
                cache[name][:saved[name].shape[0], rows, saved["ring"]] = saved[name]
        if "pool" in saved:
            blocks, offsets = saved["pool"]
            for name in ("k_pool", "v_pool"):
                cache[name][:saved[name].shape[0], blocks, offsets] = saved[name]
        return cache

    @torch.no_grad()
    def reset_slot_rows(self, cache, slots: torch.Tensor):
        """Reset the rows of slots (G,) to their initial values, in place,
        when they (re)start ingesting at watermark 0: ``t`` to 0, the
        recurrent state to 0 (the xLSTM log-max trackers ``m`` to -inf)
        and, in the ring cache, every entry to empty (pos -1, K/V 0).  A
        paged cache's pools are global and are left alone: stale pool
        contents are handled positionally and by the block version tags of
        the caller's allocator."""
        slots = slots.long()
        for name, x in cache.items():
            if name == "t":
                x[slots] = 0
            elif name == "pos":
                x[:, slots] = -1
            elif name in ("mlstm_m", "slstm_m"):
                x[:, slots] = xlstm.NEG_INF
            elif name not in ("k_pool", "v_pool"):
                x[:, slots] = 0
        return cache
