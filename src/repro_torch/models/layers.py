"""Building blocks of the decoder, mirroring ``repro/models/layers.py``.

Functions work on tensors; the small modules hold the parameters, named
as the reference's parameter tree names them (``scale``, ``w_up``, ...)
so that ``convert.params_from_jax`` can map paths one to one.  Weights
are stored (in_dim, out_dim) and applied as ``x @ w``, as in the
reference.  Products accumulate in f32 and are cast back to the working
dtype; norms and RoPE are computed in f32; logits stay f32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig


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
    return torch.matmul(x, w).to(x.dtype)


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
    packing and ``history`` are exclusive, as in the reference."""
    width, s = w.shape[0], x.shape[1]
    if history is not None and segment_ids is not None:
        raise ValueError("conv history and packed segments are exclusive")
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
    history ++ x, the state stepwise decoding would have left."""
    w = history.shape[1]
    cat = torch.cat([history.to(x.dtype), x], dim=1)
    # the real rows are cat[:, :w + length); their last w start at length
    idx = length.long()[:, None] + torch.arange(w, device=x.device)[None, :]
    idx = idx.clamp(0, cat.shape[1] - 1)
    return torch.gather(cat, 1, idx[..., None].expand(-1, -1, cat.shape[2]))


def causal_conv1d_step(w: torch.Tensor, conv_state: torch.Tensor, x_t: torch.Tensor):
    """One decode step.  conv_state: (B, W-1, C) previous inputs; x_t:
    (B, C).  Returns (new conv_state, output (B, C))."""
    hist = torch.cat([conv_state, x_t[:, None, :]], dim=1)           # (B, W, C)
    out = (hist.float() * w[None].float()).sum(dim=1)
    return hist[:, 1:], out.to(x_t.dtype)


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
    return F.embedding(tokens.long(), table)


def unembed_apply(table: torch.Tensor, head_w: Optional[torch.Tensor],
                  x: torch.Tensor, tie: bool) -> torch.Tensor:
    """(..., d) -> (..., Vp) f32 logits."""
    w = table.t() if tie else head_w
    return matmul_f32(x, w)
