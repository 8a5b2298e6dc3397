"""Griffin / RecurrentGemma recurrent block, mirroring ``repro/models/rglru.py``.

Two branches from the pre-normed input, a gate branch (linear -> GeLU)
and a recurrence branch (linear -> causal conv -> RG-LRU), multiplied and
projected out.  The RG-LRU is a gated diagonal linear recurrence:

    r_t = sigmoid(W_a x_t)          (recurrence gate)
    i_t = sigmoid(W_i x_t)          (input gate)
    log a_t = -c * softplus(Lambda) * r_t          (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Training and prefill run the recurrence through ``ops.linear_scan``
(the Hopper kernel on the card, and its reverse-time gradient kernel in
training); decode is one O(width) step in plain PyTorch, as in the
reference.  ``lam`` and the recurrent state ``h`` are f32 whatever
the model's dtype; the conv state is in the model's dtype.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers

_C = 8.0
F32_PARAMS = ("lam",)        # kept f32 in a model of any dtype


class RGLRU(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        d, w = cfg.d_model, cfg.lru_width
        self.w_rec = layers._param((d, w), device=device, dtype=dtype)
        self.w_gate = layers._param((d, w), device=device, dtype=dtype)
        self.conv = layers.CausalConv1d(cfg.conv1d_width, w, device=device, dtype=dtype)
        self.w_a = layers._param((w, w), device=device, dtype=dtype)
        self.w_i = layers._param((w, w), device=device, dtype=dtype)
        self.lam = layers._param((w,), device=device, dtype=torch.float32)
        self.w_out = layers._param((w, d), device=device, dtype=dtype)

    def init_(self, generator: torch.Generator) -> None:
        """The reference's distributions: dense weights normal *
        1/sqrt(in_dim), the conv normal / sqrt(width), ``lam`` uniform in
        [0.38, 0.8]."""
        for w in (self.w_rec, self.w_gate):
            layers.dense_init_(w, generator)
        layers.causal_conv1d_init_(self.conv.w, generator)
        for w in (self.w_a, self.w_i, self.w_out):
            layers.dense_init_(w, generator)
        self.lam.copy_(0.38 + 0.42 * torch.rand(self.lam.shape, generator=generator,
                                                device=self.lam.device, dtype=torch.float32))


def _gelu_gate(p: RGLRU, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(layers.matmul(x, p.w_gate).float(), approximate="tanh").to(x.dtype)


def _lru_coeffs(p: RGLRU, xc: torch.Tensor):
    """xc: (..., w) conv output -> (a, scaled input), both f32."""
    r = torch.sigmoid(layers.matmul(xc, p.w_a).float())
    i = torch.sigmoid(layers.matmul(xc, p.w_i).float())
    log_a = -_C * F.softplus(p.lam) * r
    a = torch.exp(log_a)
    x_in = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xc.float())
    return a, x_in


def _forward(p: RGLRU, x, h0=None, valid=None, conv_hist=None, segment_ids=None):
    """(out, h_last, xr): rglru_forward's result and the recurrence
    branch's conv input, which the prefill keeps as conv history.
    conv_hist: (B, W-1, w) conv left context of an earlier span."""
    gate = _gelu_gate(p, x)
    xr = layers.matmul(x, p.w_rec)
    xc = layers.causal_conv1d_apply(p.conv.w, xr, history=conv_hist, segment_ids=segment_ids)
    a, x_in = _lru_coeffs(p, xc)
    if valid is not None:
        # padded steps are identity transitions: the final state is the
        # state at the last real token
        a = torch.where(valid[..., None], a, 1.0)
        x_in = torch.where(valid[..., None], x_in, 0.0)
    if segment_ids is not None:
        # packed rows: the recurrence restarts at each segment's first token
        first = F.pad(segment_ids[:, 1:] != segment_ids[:, :-1], (1, 0), value=True)
        a = torch.where(first[..., None], 0.0, a)
    h, h_last = ops.linear_scan(a, x_in, h0)
    out = layers.matmul(h.to(x.dtype) * gate, p.w_out)
    return out, h_last, xr


def rglru_forward(cfg: ModelConfig, p: RGLRU, x, h0=None, valid=None, segment_ids=None):
    """x: (B, S, d) pre-normed; h0: (B, w) or None; valid: (B, S) bool;
    segment_ids: (B, S) int32 of packed rows (the conv's taps stop and
    the scan restarts at each segment's start).  Returns (out (B, S, d),
    h_last (B, w) f32)."""
    out, h_last, _ = _forward(p, x, h0=h0, valid=valid, segment_ids=segment_ids)
    return out, h_last


def rglru_init_state(cfg: ModelConfig, batch: int, *, dtype, device,
                     n_layers: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """One layer's state, or ``n_layers`` of them stacked on a leading
    axis: h (B, w) f32 and conv (B, W-1, w) in ``dtype``."""
    lead = () if n_layers is None else (n_layers,)
    w = cfg.lru_width
    return {"h": torch.zeros(lead + (batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros(lead + (batch, cfg.conv1d_width - 1, w), dtype=dtype,
                                device=device)}


def rglru_decode_step(cfg: ModelConfig, p: RGLRU, x_t, state):
    """x_t: (B, d) pre-normed.  Returns (out (B, d), new state); the
    state given is not modified."""
    gate = _gelu_gate(p, x_t)
    xr = layers.matmul(x_t, p.w_rec)
    conv_state, xc = layers.causal_conv1d_step(p.conv.w, state["conv"], xr)
    a, x_in = _lru_coeffs(p, xc)
    h_new = a * state["h"] + x_in
    out = layers.matmul(h_new.to(x_t.dtype) * gate, p.w_out)
    return out, {"h": h_new, "conv": conv_state}


def rglru_prefill_state(cfg: ModelConfig, p: RGLRU, x, state=None, valid=None):
    """Forward over a right-padded span, returning (out, state): the
    recurrent state at each row's last real token and the conv history of
    its last W-1 real inputs.  Without ``state`` the span is a prefix
    from a fresh state (zeros before its start); with it the span
    continues an earlier one (chunked prefill): the scan starts from
    state["h"] and the conv sees state["conv"] as left context.  The
    state given is not modified."""
    h0 = None if state is None else state["h"]
    hist0 = None if state is None else state["conv"]
    out, h_last, xr = _forward(p, x, h0=h0, valid=valid, conv_hist=hist0)
    w = cfg.conv1d_width - 1
    b, s, c = xr.shape
    if state is not None:
        length = (valid.sum(dim=1) if valid is not None
                  else torch.full((b,), s, dtype=torch.long, device=x.device))
        hist = layers.conv_history_update(hist0, xr, length)
    elif valid is not None:
        length = valid.sum(dim=1)                                       # (B,)
        idx = length[:, None] - w + torch.arange(w, device=x.device)[None, :]
        hist = torch.gather(xr, 1, idx.clamp(0, s - 1)[..., None].expand(b, w, c))
        hist = torch.where((idx >= 0)[..., None], hist, torch.zeros((), dtype=xr.dtype,
                                                                    device=xr.device))
    else:
        hist = F.pad(xr[:, -w:], (0, 0, max(0, w - s), 0))
    return out, {"h": h_last.float(), "conv": hist}
