"""Building blocks of the decoder, mirroring ``repro/models/layers.py``.

Functions work on tensors; the small modules hold the parameters, named
as the reference's parameter tree names them (``scale``, ``w_up``, ...)
so that ``convert.params_from_jax`` can map paths one to one.  Weights
are stored (in_dim, out_dim) and applied as ``x @ w``, as in the
reference.  Products accumulate in f32 and are cast back to the working
dtype; norms and RoPE are computed in f32; logits stay f32.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.constraints import on_mesh, reshard


# ---------------------------------------------------------------------------
# rematerialisation (the reference's jax.checkpoint around a unit)
# ---------------------------------------------------------------------------

REMAT_POLICIES = ("none", "dots")
# products with no batch dimension, the outputs the "dots" policy saves
# (``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``): a
# projection x (..., k) @ w (k, n) dispatches as one of these
SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return CheckpointPolicy.MUST_SAVE if op in SAVED_BY_DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def checkpointed(fn: Callable, policy: str = "none") -> Callable:
    """``fn`` as one rematerialised region: under gradients it runs
    through ``torch.utils.checkpoint`` (non-reentrant), which keeps the
    region's inputs and, in the backward, runs ``fn`` again for what its
    ops would have saved.  ``policy`` "none" saves nothing inside the
    region (the reference's ``policy=None``); "dots" saves the outputs of
    the products with no batch dimension (``SAVED_BY_DOTS``) and
    recomputes everything else: the batched products, the norms, the
    activations and the hand-written kernels, whose ``autograd.Function``s
    the policy never sees.  The forward has no randomness, so no RNG
    state is kept.  Without gradients ``fn`` runs as it is."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {policy!r}: one of {REMAT_POLICIES}")
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _dots_policy)

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)

    return run


def _param(shape, *, device, dtype, fill: Optional[float] = None) -> nn.Parameter:
    t = torch.empty(shape, device=device, dtype=dtype)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t, requires_grad=False)


def dense_init_(w: torch.Tensor, generator: torch.Generator,
                scale: Optional[float] = None) -> None:
    """Fill an (in_dim, out_dim) weight with normal * 1/sqrt(in_dim),
    drawn in f32 and cast, as ``layers.dense_init``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(w.shape[0])
    w.copy_(torch.randn(w.shape, generator=generator, device=w.device,
                        dtype=torch.float32) * scale)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    # float32 and bfloat16 GEMMs accumulate in f32 on both the CPU and the
    # card; the result comes back in the working dtype, as the reference's
    # preferred_element_type=f32 product cast to x.dtype
    if isinstance(x, DTensor) or isinstance(w, DTensor):
        return sharded_product(matmul, x, w)
    return torch.matmul(x, w).to(x.dtype)


def sharded_product(fn, x, w):
    """``fn(x, w)``, a product of x (..., k) and a weight w (k, n), on
    DTensors, as Megatron lays it out: on each mesh dim a column-split
    weight (Shard(1)) meets a replicated x and gives a column-split
    output; a row-split weight (Shard(0)) meets x split on k and gives a
    ``Partial`` sum; a replicated weight keeps x's split of its leading
    dims.  Each rank runs ``fn`` on its local tensors (``local_map``) and
    the gradients' placements are stated, so no DTensor strategy search
    runs: where a dim does not divide, DTensor's own choice can split the
    tokens unevenly, which its views then get wrong."""
    from torch.distributed.tensor.experimental import local_map
    dm = (x if isinstance(x, DTensor) else w).device_mesh
    rep = [Replicate()] * dm.ndim
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, dm, rep, run_check=False)
    if not isinstance(w, DTensor):
        w = DTensor.from_local(w, dm, rep, run_check=False)
    last = x.dim() - 1
    xp, wp, op, xg, wg = [], [], [], [], []
    for px, pw in zip(x.placements, w.placements):
        lead = isinstance(px, Shard) and px.dim < last
        if isinstance(pw, Shard) and pw.dim == 0 and not lead:          # row-parallel
            px, op_, xg_, wg_ = Shard(last), Partial(), Shard(last), pw
        elif isinstance(pw, Shard) and pw.dim == 1 and not lead:        # column-parallel
            px, op_, xg_, wg_ = Replicate(), Shard(last), Partial(), pw
        else:                                                            # replicated weight
            pw = Replicate()
            if lead:
                op_, xg_, wg_ = px, px, Partial()
            elif isinstance(px, Partial):
                op_, xg_, wg_ = px, Replicate(), Partial()
            else:
                px, op_, xg_, wg_ = Replicate(), Replicate(), Replicate(), Replicate()
        xp.append(px), wp.append(pw), op.append(op_), xg.append(xg_), wg.append(wg_)
    x, w = reshard(x, dm, xp), reshard(w, dm, wp)
    return local_map(fn, out_placements=op, in_placements=(xp, wp),
                     in_grad_placements=(xg, wg), device_mesh=dm)(x, w)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of one low-precision dtype, accumulated and returned in f32
    (the CPU has no mixed-dtype GEMM: widening is exact; the meta device
    takes the card's product, so that the dry run holds no f32 copy)."""
    if a.device.type in ("cuda", "meta"):
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _split_f32(g: torch.Tensor, dtype: torch.dtype):
    """Three ``dtype`` (bf16) terms whose f32 sum is g: each takes the
    leading 8 bits of what the terms before it left, so together they
    hold f32's 24."""
    parts = []
    for _ in range(3):
        p = g.to(dtype)
        parts.append(p)
        g = g - p.float()
    return parts


class _MatmulF32(torch.autograd.Function):
    """x (T, d) @ w (d, n) of one low-precision dtype with an f32 result.
    The gradients are products of the f32 output gradient itself, as the
    reference's transpose of a preferred_element_type=f32 product takes
    them: it enters as three bf16 terms that sum to it, each product
    accumulated in f32, and the sums are cast to the operands' dtype.
    The vocab is taken in column blocks so that no f32 copy of the
    gradient's terms or of w is held whole."""

    BLOCK = 16384

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm_f32(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = torch.zeros(x.shape, device=x.device, dtype=torch.float32)
        dw = torch.empty_like(w)
        xt = x.t()
        for j in range(0, w.shape[1], _MatmulF32.BLOCK):
            cols = slice(j, j + _MatmulF32.BLOCK)
            wt = w[:, cols].t()
            dwj = None
            for p in _split_f32(g[:, cols], x.dtype):
                dx += _mm_f32(p, wt)
                dwj = _mm_f32(xt, p) if dwj is None else dwj + _mm_f32(xt, p)
            dw[:, cols] = dwj
        return dx.to(x.dtype), dw


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with an f32 result, without widening a bf16 weight in memory
    on the card (the logits head reads a 152064 x 1536 table per step)."""
    if isinstance(x, DTensor) or isinstance(w, DTensor):
        return sharded_product(matmul_f32, x, w)
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return torch.matmul(x, w)
    lead = x.shape[:-1]
    out = _MatmulF32.apply(x.reshape(-1, x.shape[-1]), w)
    return out.reshape(*lead, w.shape[-1])


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

def norm_apply(cfg: ModelConfig, scale: Optional[torch.Tensor],
               bias: Optional[torch.Tensor], x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if cfg.norm_type == "rmsnorm":
        xf = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    else:  # layernorm
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
        xf = (xf - mu) * torch.rsqrt(var + eps)
    # a bf16 scale or bias is widened exactly inside the f32 product/sum
    if scale is not None:
        xf = xf * scale
    if bias is not None:
        xf = xf + bias
    return xf.to(x.dtype)


class Norm(nn.Module):
    """RMSNorm or LayerNorm; no parameters for a non-parametric norm."""

    def __init__(self, cfg: ModelConfig, dim: int, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        self.scale = self.bias = None
        if cfg.parametric_norm:
            self.scale = _param((dim,), device=device, dtype=dtype, fill=1.0)
            if cfg.norm_type != "rmsnorm":
                self.bias = _param((dim,), device=device, dtype=dtype, fill=0.0)

    def reset_parameters(self) -> None:
        if self.scale is not None:
            self.scale.fill_(1.0)
        if self.bias is not None:
            self.bias.fill_(0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return norm_apply(self.cfg, self.scale, self.bias, x)


class HeadNorm(nn.Module):
    """QK-norm: per-head RMS norm over head_dim."""

    def __init__(self, dim: int, *, device, dtype):
        super().__init__()
        self.scale = _param((dim,), device=device, dtype=dtype, fill=1.0)

    def reset_parameters(self) -> None:
        self.scale.fill_(1.0)

    def forward(self, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
        xf = x.float()
        xf = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
        return (xf * self.scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (split-halves layout)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float32,
                                   device=device) / head_dim)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin), each (..., S, 1, hd/2) f32, of the angles at integer
    ``positions`` (..., S).  Every layer rotates at the same positions, so
    a forward pass computes these once."""
    freqs = rope_freqs(head_dim, theta, positions.device)
    angles = (positions[..., None].float() * freqs)[..., None, :]
    return torch.cos(angles), torch.sin(angles)


def rope_rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate x (..., S, H, hd): the first and second halves of hd are the
    two components of each rotated pair (split-halves layout)."""
    # bf16 halves are widened exactly inside the products with the f32 tables
    x1, x2 = x.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) integer; angles in f32."""
    if theta <= 0:
        return x
    return rope_rotate(x, *rope_tables(positions, x.shape[-1], theta))


def sinusoidal_positions(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """Whisper-style sinusoidal embeddings (..., dim) f32 of the integer
    ``positions`` (...): [sin(p * inv), cos(p * inv)] with inv =
    exp(-log(1e4) / (dim/2 - 1) * arange(dim/2)), in f32 as the reference
    computes them.  The reference builds a table of
    ``max_position_embeddings`` rows and indexes it; a row does not depend
    on the table's length, so only the rows asked for are computed."""
    log_ts = math.log(10_000.0) / (dim // 2 - 1)
    inv = torch.exp(torch.tensor(-log_ts, dtype=torch.float32)
                    * torch.arange(dim // 2, dtype=torch.float32)).to(positions.device)
    ang = positions.float()[..., None] * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU / GeLU / squared-ReLU)
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device, dtype, d_ff: Optional[int] = None):
        super().__init__()
        ff = d_ff or cfg.d_ff
        d = cfg.d_model
        self.act = cfg.act
        self.w_up = _param((d, ff), device=device, dtype=dtype)
        self.w_down = _param((ff, d), device=device, dtype=dtype)
        self.w_gate = (_param((d, ff), device=device, dtype=dtype)
                       if cfg.act in ("swiglu", "geglu") else None)

    def init_(self, generator: torch.Generator) -> None:
        dense_init_(self.w_up, generator)
        dense_init_(self.w_down, generator)
        if self.w_gate is not None:
            dense_init_(self.w_gate, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_apply(self.act, self.w_up, self.w_gate, self.w_down, x)


def mlp_apply(act: str, w_up, w_gate, w_down, x: torch.Tensor) -> torch.Tensor:
    h = matmul(x, w_up)
    if act == "swiglu":
        h = F.silu(matmul(x, w_gate).float()).to(x.dtype) * h
    elif act == "geglu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(matmul(x, w_gate).float(), approximate="tanh").to(x.dtype) * h
    elif act == "gelu":
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    elif act == "relu2":
        h = torch.square(F.relu(h.float())).to(x.dtype)
    else:
        raise ValueError(act)
    return matmul(h, w_down)


# ---------------------------------------------------------------------------
# Causal temporal conv (recurrent blocks)
# ---------------------------------------------------------------------------

class CausalConv1d(nn.Module):
    """Depthwise causal conv weights, (width, channels)."""

    def __init__(self, width: int, channels: int, *, device, dtype):
        super().__init__()
        self.w = _param((width, channels), device=device, dtype=dtype)


def causal_conv1d_init_(w: torch.Tensor, generator: torch.Generator) -> None:
    """normal / sqrt(width), drawn in f32 and cast, as
    ``layers.causal_conv1d_init``."""
    w.copy_(torch.randn(w.shape, generator=generator, device=w.device,
                        dtype=torch.float32) / math.sqrt(w.shape[0]))


def causal_conv1d_apply(w: torch.Tensor, x: torch.Tensor,
                        history: Optional[torch.Tensor] = None,
                        segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv of x (B, S, C) with w (W, C); taps summed in
    f32, the result in x's dtype.  The left context is zero, or
    ``history`` (B, W-1, C), the last inputs of an earlier span (chunked
    prefill continues a slot's conv from them).  With ``segment_ids`` (B,
    S) (packed rows), a tap that reaches into another segment is zeroed;
    packing and ``history`` are exclusive, as in the reference.  A
    DTensor x runs on each rank's rows and channels (``_sharded_conv``)."""
    width, s = w.shape[0], x.shape[1]
    if history is not None and segment_ids is not None:
        raise ValueError("conv history and packed segments are exclusive")
    if isinstance(x, DTensor):
        return _sharded_conv(w, x, history, segment_ids)
    xp = (F.pad(x, (0, 0, width - 1, 0)) if history is None
          else torch.cat([history.to(x.dtype), x], dim=1))
    if segment_ids is not None:
        sp = F.pad(segment_ids, (width - 1, 0), value=-2)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(width):
        tap = xp[:, i:i + s].float()
        if segment_ids is not None:
            tap = torch.where((sp[:, i:i + s] == segment_ids)[..., None], tap, 0.0)
        out = out + tap * w[i].float()
    return out.to(x.dtype)


def conv_history_update(history: torch.Tensor, x: torch.Tensor,
                        length: torch.Tensor) -> torch.Tensor:
    """The conv history (B, W-1, C) after a right-padded span x (B, S, C)
    of ``length`` (B,) real rows each: the last W-1 real inputs of
    history ++ x, the state stepwise decoding would have left.  A DTensor
    x runs on each rank's rows and channels (``local_map``): the history
    follows both, ``length`` the rows; a split of time, or a pending
    ``Partial``, is gathered first."""
    if isinstance(x, DTensor):
        from torch.distributed.tensor.experimental import local_map
        dm = x.device_mesh
        xp = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
              for p in x.placements]
        lp = [p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in xp]
        args = (reshard(on_mesh(history, dm), dm, xp), reshard(x, dm, xp),
                reshard(on_mesh(length, dm), dm, lp))
        return local_map(conv_history_update, out_placements=xp, in_placements=(xp, xp, lp),
                         device_mesh=dm)(*args)
    w = history.shape[1]
    cat = torch.cat([history.to(x.dtype), x], dim=1)
    # the real rows are cat[:, :w + length); their last w start at length
    idx = length.long()[:, None] + torch.arange(w, device=x.device)[None, :]
    idx = idx.clamp(0, cat.shape[1] - 1)
    return torch.gather(cat, 1, idx[..., None].expand(-1, -1, cat.shape[2]))


def causal_conv1d_step(w: torch.Tensor, conv_state: torch.Tensor, x_t: torch.Tensor):
    """One decode step.  conv_state: (B, W-1, C) previous inputs; x_t:
    (B, C).  Returns (new conv_state, output (B, C)).  DTensors run on
    each rank's rows (``_sharded_conv_step``)."""
    if isinstance(x_t, DTensor) or isinstance(conv_state, DTensor):
        return _sharded_conv_step(w, conv_state, x_t)
    hist = torch.cat([conv_state, x_t[:, None, :]], dim=1)           # (B, W, C)
    out = (hist.float() * w[None].float()).sum(dim=1)
    return hist[:, 1:], out.to(x_t.dtype)


def _sharded_conv(w, x, history, segment_ids):
    """``causal_conv1d_apply`` of a DTensor x (B, S, C) through
    ``local_map``: the conv is independent per row and per channel, so
    each rank runs it on its own rows and channels.  The weight (W, C)
    follows the channels; the segment ids (B, S) follow the rows; the
    history (B, W-1, C) follows both.  A split of time, or a pending
    ``Partial``, is gathered first.  No DTensor rule of ``F.pad`` or
    ``torch.cat`` is asked for: the card's DTensor has none for the pad.
    The weight's gradient is a partial sum over the rows' mesh dims."""
    from torch.distributed.tensor.experimental import local_map
    dm = x.device_mesh
    xp, wp, sp, wg = [], [], [], []
    for p in x.placements:
        if isinstance(p, Shard) and p.dim == 0:
            xp.append(p), wp.append(Replicate()), sp.append(p), wg.append(Partial())
        elif isinstance(p, Shard) and p.dim == 2:
            xp.append(p), wp.append(Shard(1)), sp.append(Replicate()), wg.append(Shard(1))
        else:
            r = Replicate()
            xp.append(r), wp.append(r), sp.append(r), wg.append(r)
    x, w = reshard(x, dm, xp), reshard(on_mesh(w, dm), dm, wp)
    history, segment_ids = on_mesh(history, dm), on_mesh(segment_ids, dm)
    hp = None if history is None else xp
    segp = None if segment_ids is None else sp
    if history is not None:
        history = reshard(history, dm, xp)
    if segment_ids is not None:
        segment_ids = reshard(segment_ids, dm, sp)

    def local(w_, x_, h_, s_):
        return causal_conv1d_apply(w_, x_, history=h_, segment_ids=s_)

    return local_map(local, out_placements=xp, in_placements=(wp, xp, hp, segp),
                     in_grad_placements=(wg, xp, hp, segp), device_mesh=dm)(
        w, x, history, segment_ids)


def _sharded_conv_step(w, conv_state, x_t):
    """``causal_conv1d_step`` of DTensors through ``local_map``, on each
    rank's rows.  Where the state keeps every channel on a mesh dim (the
    decode cache's rule: the recurrent state is split on its rows only)
    x_t's channels are gathered there, so the new state is whole, as the
    layout holds it, and the output comes back whole; where the state is
    split on its channels, x_t's channels stay split with it."""
    from torch.distributed.tensor.experimental import local_map
    dm = (x_t if isinstance(x_t, DTensor) else conv_state).device_mesh
    x_t, conv_state = on_mesh(x_t, dm), on_mesh(conv_state, dm)
    xp, cp, wp = [], [], []
    for px, pc in zip(x_t.placements, conv_state.placements):
        if isinstance(px, Shard) and px.dim == 0 or isinstance(pc, Shard) and pc.dim == 0:
            xp.append(Shard(0)), cp.append(Shard(0)), wp.append(Replicate())
        elif isinstance(pc, Shard) and pc.dim == 2:
            xp.append(Shard(1)), cp.append(pc), wp.append(Shard(1))
        else:
            r = Replicate()
            xp.append(r), cp.append(r), wp.append(r)
    x_t, conv_state = reshard(x_t, dm, xp), reshard(conv_state, dm, cp)
    w = reshard(on_mesh(w, dm), dm, wp)
    return local_map(causal_conv1d_step, out_placements=(cp, xp), in_placements=(wp, cp, xp),
                     device_mesh=dm)(w, conv_state, x_t)


def segment_starts(segment_ids: torch.Tensor) -> torch.Tensor:
    """(B, S) bool: True where a packed row's token starts a segment (its
    first token, and each token whose id differs from its predecessor's).
    A DTensor runs on each rank's rows (``local_map``; a split of time is
    gathered first), with no DTensor rule of ``F.pad`` asked for."""
    if isinstance(segment_ids, DTensor):
        return row_local(segment_starts, segment_ids)
    return F.pad(segment_ids[:, 1:] != segment_ids[:, :-1], (1, 0), value=True)


def row_local(fn, *xs):
    """``fn(*xs)`` of tensors whose leading dim is the batch's rows (None
    passes through), on each rank's own rows where one is a DTensor: each
    is brought to the rows' split over the mesh dims that split the first
    DTensor's rows, replicated over the others (a pending ``Partial``
    reduced), and ``fn`` runs on the local tensors (``local_map``); its
    output (a tensor or a tuple of them, rows first) keeps the split.  No
    gradient: the row-local bookkeeping of the serving steps (positions,
    tables, destinations)."""
    from torch.distributed.tensor.experimental import local_map
    lead = next((x for x in xs if isinstance(x, DTensor)), None)
    if lead is None:
        return fn(*xs)
    dm = lead.device_mesh
    rp = [p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in lead.placements]
    args = [None if x is None else reshard(on_mesh(x, dm), dm, rp) for x in xs]
    out = fn(*(None if a is None else a.to_local() for a in args))
    wrap = lambda t: DTensor.from_local(t, dm, rp, run_check=False)     # noqa: E731
    return tuple(wrap(t) for t in out) if isinstance(out, tuple) else wrap(out)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

class Embed(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        self.table = _param((cfg.padded_vocab, cfg.d_model), device=device, dtype=dtype)

    def init_(self, generator: torch.Generator) -> None:
        self.table.copy_(torch.randn(self.table.shape, generator=generator,
                                     device=self.table.device, dtype=torch.float32) * 0.02)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return embed_apply(self.table, tokens)


def embed_apply(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    if isinstance(table, DTensor):
        return _vocab_parallel_embed(table, tokens)
    return F.embedding(tokens.long(), table)


def _vocab_parallel_embed(table, tokens):
    """The lookup of a DTensor table (V, d) whose vocab rows may be split
    (on "model"), as Megatron's vocab-parallel embedding: each rank looks
    up the tokens its rows hold and writes zeros for the rest, and the
    output is a ``Partial`` sum over that mesh dim (the caller's
    ``constrain`` reduces it).  DTensor's own rule for this gather tags
    its output with a mask that a later view or its backward cannot
    follow."""
    from torch.distributed.tensor.experimental import local_map
    dm = table.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, dm, [Replicate()] * dm.ndim, run_check=False)
    tp, kp, out, grad = [], [], [], []
    vocab_axis = None
    for i, (pt, pk) in enumerate(zip(table.placements, tokens.placements)):
        if isinstance(pt, Shard) and pt.dim == 0 and vocab_axis is None:
            vocab_axis = i
            tp.append(pt), kp.append(Replicate()), out.append(Partial()), grad.append(pt)
        elif isinstance(pk, Shard) and pk.dim < tokens.dim():
            tp.append(Replicate()), kp.append(pk), out.append(pk), grad.append(Partial())
        else:
            r = Replicate()
            tp.append(r), kp.append(r), out.append(r), grad.append(r)
    table, tokens = reshard(table, dm, tp), reshard(tokens, dm, kp)
    lo = 0 if vocab_axis is None else dm.get_local_rank(vocab_axis) * table.to_local().shape[0]

    def local(tab, tok):
        idx = tok.long() - lo
        held = (idx >= 0) & (idx < tab.shape[0])
        rows = F.embedding(idx.clamp(0, tab.shape[0] - 1), tab)
        return rows * held[..., None].to(rows.dtype)

    return local_map(local, out_placements=out, in_placements=(tp, kp),
                     in_grad_placements=(grad, kp), device_mesh=dm)(table, tokens)


def unembed_apply(table: torch.Tensor, head_w: Optional[torch.Tensor],
                  x: torch.Tensor, tie: bool) -> torch.Tensor:
    """(..., d) -> (..., Vp) f32 logits."""
    w = table.t() if tie else head_w
    return matmul_f32(x, w)
