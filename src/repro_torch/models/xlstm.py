"""xLSTM blocks (arXiv:2405.04517), mirroring ``repro/models/xlstm.py``
function by function: the mLSTM (matrix memory, parallelisable) and the
sLSTM (scalar memory, sequential), both with exponential gates
stabilised in log space.

The mLSTM's training and prefill run its parallel form (a stabilised
decay matrix D over the sequence) or, over long rows, its chunkwise form
(the parallel form inside chunks, a recurrent state (C, n, m) carried
across them); decode is the O(1) recurrent step.  The sLSTM has a true
recurrent dependency (R @ h_{t-1}) and runs as a loop over time.  The
reference has no kernel for either: both are plain PyTorch on every
device, as the reference keeps them plain jnp.

As in the reference, the gates, ``m``, ``C``, ``n`` and the sLSTM's
state are f32 whatever the weights' dtype, and products accumulate in
f32 and come back in the working dtype.
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.constraints import on_mesh, reshard
from repro_torch.kernels import meta
from repro_torch.models import layers

NEG_INF = -1e30
BOUNDARY_LOG_F = -30.0     # "forget gate ~ 0" at a packed segment's start


def _first_of_segment(segment_ids: torch.Tensor) -> torch.Tensor:
    """(B, S) bool: True at each packed segment's first token."""
    return F.pad(segment_ids[:, 1:] != segment_ids[:, :-1], (1, 0), value=True)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

class MLSTM(nn.Module):
    """The mLSTM cell's parameters, named as the reference's tree."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        inner = 2 * d
        kw = dict(device=device, dtype=dtype)
        self.norm = layers.Norm(cfg, d, **kw)
        self.w_x = layers._param((d, inner), **kw)
        self.w_z = layers._param((d, inner), **kw)
        self.conv = layers.CausalConv1d(cfg.conv1d_width, inner, **kw)
        self.wq = layers._param((inner, inner), **kw)
        self.wk = layers._param((inner, inner), **kw)
        self.wv = layers._param((inner, inner), **kw)
        self.w_i = layers._param((inner, h), **kw)
        self.w_f = layers._param((inner, h), **kw)
        self.f_bias = layers._param((h,), **kw)
        self.out_norm = layers.HeadNorm(inner // h, **kw)
        self.w_down = layers._param((inner, d), **kw)

    def init_(self, generator: torch.Generator) -> None:
        """The reference's distributions: dense weights normal *
        1/sqrt(in_dim), the conv normal / sqrt(width), the forget bias 3
        (open gates), norms ones/zeros."""
        self.norm.reset_parameters()
        for w in (self.w_x, self.w_z):
            layers.dense_init_(w, generator)
        layers.causal_conv1d_init_(self.conv.w, generator)
        for w in (self.wq, self.wk, self.wv, self.w_i, self.w_f, self.w_down):
            layers.dense_init_(w, generator)
        self.f_bias.fill_(3.0)
        self.out_norm.reset_parameters()


def _mlstm_qkv_gates(cfg: ModelConfig, p: MLSTM, x, segment_ids=None, conv_hist=None):
    b, s, d = x.shape
    h = cfg.n_heads
    hd = 2 * d // h
    x_up = layers.matmul(x, p.w_x)                                    # (B, S, inner)
    z = layers.matmul(x, p.w_z)
    xc = layers.causal_conv1d_apply(p.conv.w, x_up, history=conv_hist,
                                    segment_ids=segment_ids)
    xc = F.silu(xc.float()).to(x.dtype)
    q = layers.matmul(xc, p.wq).reshape(b, s, h, hd)
    k = layers.matmul(xc, p.wk).reshape(b, s, h, hd) / _sqrt(hd, x)
    v = layers.matmul(x_up, p.wv).reshape(b, s, h, hd)
    log_i = layers.matmul(xc, p.w_i).float()                          # (B, S, H)
    log_f = _logsigmoid(layers.matmul(xc, p.w_f).float() + p.f_bias.float())
    return x_up, z, q, k, v, log_i, log_f


def _logsigmoid(x):
    """``F.logsigmoid``; a DTensor's on each rank's local tensor (DTensor
    has no rule for its backward), any pending sum reduced first."""
    if not isinstance(x, DTensor):
        return F.logsigmoid(x)
    from torch.distributed.tensor.experimental import local_map
    pl = [Replicate() if isinstance(q, Partial) else q for q in x.placements]
    x = reshard(x, x.device_mesh, pl)
    return local_map(F.logsigmoid, out_placements=pl, in_placements=(pl,),
                     device_mesh=x.device_mesh)(x)


def _sqrt(hd: int, x: torch.Tensor) -> torch.Tensor:
    """sqrt(hd) rounded to x's dtype, the divisor of k in the reference."""
    return torch.tensor(math.sqrt(hd), dtype=torch.float32).to(device=x.device, dtype=x.dtype)


def _mlstm_out(cfg: ModelConfig, p: MLSTM, h_tilde, z):
    h_n = p.out_norm(h_tilde)
    h_flat = h_n.reshape(*h_n.shape[:-2], 2 * cfg.d_model)
    if isinstance(h_flat, DTensor):
        # to z's split of the inner dim, both ways: DTensor would split it
        # for the product but leave the gradient split, which the heads'
        # view (4 heads over a model axis of 8) cannot take
        h_flat = reshard(h_flat, h_flat.device_mesh, z.placements)
    gated = h_flat * F.silu(z.float()).to(h_flat.dtype)
    return layers.matmul(gated, p.w_down)


def _mask_padding(log_i, log_f, valid):
    """Padded steps are identity transitions: log f = 0, log i = -inf."""
    if valid is None:
        return log_i, log_f
    return (torch.where(valid[..., None], log_i, NEG_INF),
            torch.where(valid[..., None], log_f, 0.0))


def _parallel(x, z, q, k, v, log_i, log_f, segment_ids, cfg, p):
    """The stabilised parallel form over (B, S) given the gates."""
    s = x.shape[1]
    cf = torch.cumsum(log_f, dim=1)                                   # F_t (B, S, H)
    # D[t, s'] = F_t - F_s' + log i_s'  for s' <= t
    dmat = cf[:, :, None, :] - cf[:, None, :, :] + log_i[:, None, :, :]   # (B, Sq, Sk, H)
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=x.device))[None, :, :, None]
    if segment_ids is not None:
        mask = mask & (segment_ids[:, :, None, None] == segment_ids[:, None, :, None])
    dmat = torch.where(mask, dmat, NEG_INF)
    m = dmat.amax(dim=2, keepdim=True)                                # (B, Sq, 1, H)
    w = torch.exp(dmat - m)
    scores = torch.einsum("bqhd,bkhd->bqkh", q.float(), k.float())
    sw = scores * w
    num = torch.einsum("bqkh,bkhd->bqhd", sw, v.float())
    den = torch.maximum(sw.sum(dim=2).abs(), torch.exp(-m[:, :, 0, :]))
    h_tilde = (num / den[..., None]).to(x.dtype)
    return _mlstm_out(cfg, p, h_tilde, z)


def mlstm_forward(cfg: ModelConfig, p: MLSTM, x, segment_ids=None, valid=None):
    """The parallel (quadratic) form.  x: (B, S, d), pre-normed by the
    caller; segment_ids: (B, S) packed rows (no attention across
    segments; the conv's taps stop at their starts); valid: (B, S) bool,
    padded steps are identity transitions."""
    x_up, z, q, k, v, log_i, log_f = _mlstm_qkv_gates(cfg, p, x, segment_ids)
    log_i, log_f = _mask_padding(log_i, log_f, valid)
    return _parallel(x, z, q, k, v, log_i, log_f, segment_ids, cfg, p)


def _conv_tail(cfg: ModelConfig, x_up, valid):
    """The conv history (B, W-1, inner) after a prefix from a fresh state:
    the last W-1 real inputs, zeros before the start."""
    w = cfg.conv1d_width - 1
    b, s, c = x_up.shape
    if valid is None:
        return F.pad(x_up[:, -w:], (0, 0, max(0, w - s), 0))
    length = valid.sum(dim=1)
    idx = length[:, None] - w + torch.arange(w, device=x_up.device)[None, :]
    hist = torch.gather(x_up, 1, idx.clamp(0, s - 1)[..., None].expand(b, w, c))
    return torch.where((idx >= 0)[..., None], hist, torch.zeros((), dtype=x_up.dtype,
                                                                device=x_up.device))


def _mlstm_chunk(qc, kc, vc, lic, lfc, c_prev, n_prev, m_prev, tril):
    """One chunk of ``mlstm_forward_chunked``: the stabilised parallel
    form inside it against the carried state (C, n, m), and the state at
    its end.  Returns (h (B, c, H, hd) f32, C, n, m)."""
    f_cum = torch.cumsum(lfc, dim=1)                                  # (B, c, H)
    dmat = f_cum[:, :, None, :] - f_cum[:, None, :, :] + lic[:, None, :, :]
    dmat = torch.where(tril, dmat, NEG_INF)
    m_intra = dmat.amax(dim=2)                                        # (B, c, H)
    b_inter = f_cum + m_prev[:, None, :]
    m_t = torch.maximum(m_intra, b_inter)
    w = torch.where(tril, torch.exp(dmat - m_t[:, :, None, :]), 0.0)
    sw = torch.einsum("bqhd,bkhd->bqkh", qc, kc) * w
    num = torch.einsum("bqkh,bkhd->bqhd", sw, vc)
    inter_scale = torch.exp(b_inter - m_t)                            # (B, c, H)
    num = num + inter_scale[..., None] * torch.einsum("bqhd,bhde->bqhe", qc, c_prev)
    den = sw.sum(dim=2) + inter_scale * torch.einsum("bqhd,bhd->bqh", qc, n_prev)
    den = torch.maximum(den.abs(), torch.exp(-m_t))
    # the state at the chunk's end
    f_total = f_cum[:, -1, :]                                         # (B, H)
    d_last = f_total[:, None, :] - f_cum + lic                        # (B, c, H)
    m_state = torch.maximum(f_total + m_prev, d_last.amax(dim=1))
    w_last = torch.exp(d_last - m_state[:, None, :])
    decay = torch.exp(f_total + m_prev - m_state)
    c_new = decay[..., None, None] * c_prev + torch.einsum(
        "bshd,bshe->bhde", w_last[..., None] * kc, vc)
    n_new = decay[..., None] * n_prev + torch.einsum("bsh,bshd->bhd", w_last, kc)
    return num / den[..., None], c_new, n_new, m_state


def mlstm_forward_chunked(cfg: ModelConfig, p: MLSTM, x, valid=None, segment_ids=None,
                          chunk: int = 256, return_state: bool = False, state=None):
    """The chunkwise-parallel mLSTM: O(S * chunk) memory instead of O(S^2).
    Inside a chunk the stabilised parallel form, across chunks the
    recurrent state (C, n, m), the decode step's math.  At a packed
    segment's first token the forget gate is closed (``BOUNDARY_LOG_F``).
    ``state`` ({C, n, m, conv}) continues an earlier span: the carry starts
    from it and the conv taps see its history (chunked prefill; exclusive
    with segment_ids).  With ``return_state``: (out, the state after each
    row's last real step)."""
    b, s, d = x.shape
    nh = cfg.n_heads
    hd = 2 * d // nh
    x_up, z, q, k, v, log_i, log_f = _mlstm_qkv_gates(
        cfg, p, x, segment_ids, conv_hist=None if state is None else state["conv"])
    log_i, log_f = _mask_padding(log_i, log_f, valid)
    if segment_ids is not None:
        log_f = torch.where(_first_of_segment(segment_ids)[..., None], BOUNDARY_LOG_F, log_f)

    chunk = min(chunk, s)
    pad = (-s) % chunk
    qf, kf, vf = q.float(), k.float(), v.float()
    if pad:
        qf, kf, vf = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (qf, kf, vf))
        log_f = F.pad(log_f, (0, 0, 0, pad))                          # f = 1
        log_i = F.pad(log_i, (0, 0, 0, pad), value=NEG_INF)           # i = 0
    if state is None:
        c_prev = torch.zeros((b, nh, hd, hd), dtype=torch.float32, device=x.device)
        n_prev = torch.zeros((b, nh, hd), dtype=torch.float32, device=x.device)
        m_prev = torch.full((b, nh), NEG_INF, dtype=torch.float32, device=x.device)
    else:
        c_prev, n_prev, m_prev = state["C"], state["n"], state["m"]
    tril = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    tril = tril[None, :, :, None]
    # every chunk body is rematerialised under gradients, as the
    # reference's ``jax.checkpoint(body)``: its (c, c) weights are not kept
    body = _mlstm_chunk
    if torch.is_grad_enabled() and any(t.requires_grad for t in (qf, kf, vf, log_i, log_f)):
        body = layers.checkpointed(_mlstm_chunk)
    hs = []
    for c0 in range(0, s + pad, chunk):
        sl = slice(c0, c0 + chunk)
        h_c, c_prev, n_prev, m_prev = body(qf[:, sl], kf[:, sl], vf[:, sl], log_i[:, sl],
                                           log_f[:, sl], c_prev, n_prev, m_prev, tril)
        hs.append(h_c)                                                # (B, c, H, hd)
    h_tilde = torch.cat(hs, dim=1)[:, :s].to(x.dtype)
    out = _mlstm_out(cfg, p, h_tilde, z)
    if not return_state:
        return out
    if state is not None:
        length = (valid.sum(dim=1) if valid is not None
                  else torch.full((b,), s, dtype=torch.long, device=x.device))
        conv_hist = layers.conv_history_update(state["conv"], x_up, length)
    else:
        conv_hist = _conv_tail(cfg, x_up, valid)
    return out, {"C": c_prev, "n": n_prev, "m": m_prev, "conv": conv_hist}


def mlstm_init_state(cfg: ModelConfig, batch: int, *, dtype, device,
                     n_layers: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """One layer's state, or ``n_layers`` of them stacked on a leading
    axis: C (B, H, hd, hd), n (B, H, hd) and m (B, H) f32, m at -inf;
    conv (B, W-1, 2d) in ``dtype``."""
    lead = () if n_layers is None else (n_layers,)
    d, h = cfg.d_model, cfg.n_heads
    hd = 2 * d // h
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros(lead + (batch, h, hd, hd), **f32),
            "n": torch.zeros(lead + (batch, h, hd), **f32),
            "m": torch.full(lead + (batch, h), NEG_INF, **f32),
            "conv": torch.zeros(lead + (batch, cfg.conv1d_width - 1, 2 * d), dtype=dtype,
                                device=device)}


def mlstm_decode_step(cfg: ModelConfig, p: MLSTM, x_t, state):
    """x_t: (B, d) pre-normed.  The O(1) recurrent step: (out (B, d), new
    state); the state given is not modified."""
    b, d = x_t.shape
    h = cfg.n_heads
    hd = 2 * d // h
    x_up = layers.matmul(x_t, p.w_x)                                  # (B, inner)
    z = layers.matmul(x_t, p.w_z)
    conv_state, xc = layers.causal_conv1d_step(p.conv.w, state["conv"], x_up)
    xc = F.silu(xc.float()).to(x_t.dtype)
    q = layers.matmul(xc, p.wq).reshape(b, h, hd).float()
    k = (layers.matmul(xc, p.wk).reshape(b, h, hd) / _sqrt(hd, x_t)).float()
    v = layers.matmul(x_up, p.wv).reshape(b, h, hd).float()
    log_i = layers.matmul(xc, p.w_i).float()                          # (B, H)
    log_f = F.logsigmoid(layers.matmul(xc, p.w_f).float() + p.f_bias.float())

    m_new = torch.maximum(log_f + state["m"], log_i)
    decay = torch.exp(log_f + state["m"] - m_new)[..., None]
    inject = torch.exp(log_i - m_new)[..., None]
    c_new = state["C"] * decay[..., None] + inject[..., None] * (k[..., :, None] * v[..., None, :])
    n_new = state["n"] * decay + inject * k
    num = torch.einsum("bhd,bhde->bhe", q, c_new)
    den = torch.maximum((n_new * q).sum(dim=-1).abs(), torch.exp(-m_new))
    h_tilde = (num / den[..., None]).to(x_t.dtype)
    out = _mlstm_out(cfg, p, h_tilde, z)
    return out, {"C": c_new, "n": n_new, "m": m_new, "conv": conv_state}


def mlstm_prefill_state(cfg: ModelConfig, p: MLSTM, x, valid=None):
    """The parallel forward over a right-padded prefix from a fresh state
    and the recurrent state after each row's last real step (for decode to
    continue from): (out, {C, n, m, conv})."""
    x_up, z, q, k, v, log_i, log_f = _mlstm_qkv_gates(cfg, p, x)
    log_i, log_f = _mask_padding(log_i, log_f, valid)
    out = _parallel(x, z, q, k, v, log_i, log_f, None, cfg, p)
    cf = torch.cumsum(log_f, dim=1)
    # the state after step S: weights w_s = exp(F_S - F_s + log i_s - m_S)
    d_last = cf[:, -1:, :] - cf + log_i                               # (B, S, H)
    m_last = d_last.amax(dim=1)                                       # (B, H)
    w_last = torch.exp(d_last - m_last[:, None, :])
    kf = k.float()
    c_state = torch.einsum("bshd,bshe->bhde", w_last[..., None] * kf, v.float())
    n_state = torch.einsum("bsh,bshd->bhd", w_last, kf)
    return out, {"C": c_state, "n": n_state, "m": m_last, "conv": _conv_tail(cfg, x_up, valid)}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

GATES = ("i", "f", "z", "o")


class SLSTM(nn.Module):
    """The sLSTM cell and its FFN, named as the reference's tree."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        d = cfg.d_model
        pf = (4 * d) // 3
        kw = dict(device=device, dtype=dtype)
        self.norm = layers.Norm(cfg, d, **kw)
        self.ffn_norm = layers.Norm(cfg, d, **kw)
        self.w_up = layers._param((d, pf), **kw)
        self.w_down = layers._param((pf, d), **kw)
        for g in GATES:
            setattr(self, f"w_{g}", layers._param((d, d), **kw))
            setattr(self, f"r_{g}", layers._param((d, d), **kw))
        self.f_bias = layers._param((d,), **kw)

    def init_(self, generator: torch.Generator) -> None:
        """Dense weights normal * 1/sqrt(in_dim), the recurrent ones
        normal * 0.5/sqrt(d), the forget bias 3."""
        d = self.w_i.shape[0]
        self.norm.reset_parameters()
        self.ffn_norm.reset_parameters()
        for g in GATES:
            layers.dense_init_(getattr(self, f"w_{g}"), generator)
            layers.dense_init_(getattr(self, f"r_{g}"), generator, scale=0.5 / d ** 0.5)
        layers.dense_init_(self.w_up, generator)
        layers.dense_init_(self.w_down, generator)
        self.f_bias.fill_(3.0)


def slstm_init_state(cfg: ModelConfig, batch: int, *, device,
                     n_layers: Optional[int] = None, dtype=None) -> Dict[str, torch.Tensor]:
    """One layer's state, or ``n_layers`` of them stacked: h, c, n (B, d)
    zeros and m (B, d) at -inf, all f32 (``dtype`` is not used: the
    sLSTM's state is f32 in a model of any dtype)."""
    lead = () if n_layers is None else (n_layers,)
    shape = lead + (batch, cfg.d_model)
    z = lambda: torch.zeros(shape, dtype=torch.float32, device=device)
    return {"h": z(), "c": z(), "n": z(),
            "m": torch.full(shape, NEG_INF, dtype=torch.float32, device=device)}


def _slstm_x_proj(p: SLSTM, x) -> Dict[str, torch.Tensor]:
    """The input's share of each gate's pre-activation, x @ w_g in x's
    dtype, for every step at once."""
    return {g: layers.matmul(x, getattr(p, f"w_{g}")) for g in GATES}


def _slstm_cell(cfg: ModelConfig, p: SLSTM, x_t, state, xw=None):
    """x_t: (B, d) pre-normed; state: dict of (B, d) f32.  ``xw``: this
    step's rows of ``_slstm_x_proj`` when the caller computed them for
    the whole sequence."""
    hp = state["h"].to(x_t.dtype)
    if xw is None:
        xw = _slstm_x_proj(p, x_t)
    pre = lambda g: (xw[g] + layers.matmul(hp, getattr(p, f"r_{g}"))).float()
    log_i = pre("i")
    log_f = F.logsigmoid(pre("f") + p.f_bias.float())
    z = torch.tanh(pre("z"))
    o = torch.sigmoid(pre("o"))
    m_new = torch.maximum(log_f + state["m"], log_i)
    keep = torch.exp(log_f + state["m"] - m_new)
    take = torch.exp(log_i - m_new)
    c_new = keep * state["c"] + take * z
    n_new = keep * state["n"] + take
    h_new = o * c_new / torch.maximum(n_new, torch.exp(-m_new))
    return {"h": h_new, "c": c_new, "n": n_new, "m": m_new}


def slstm_forward(cfg: ModelConfig, p: SLSTM, x, state=None, valid=None, segment_ids=None):
    """The sequential loop over time.  x: (B, S, d) pre-normed.  Returns
    (out (B, S, d), final state).  valid: padded steps leave the state as
    it was; segment_ids: the state resets at each packed segment's start.
    The state given is not modified.  On DTensors each rank runs the loop
    on its own rows with the cell's weights whole (``_slstm_rows``): the
    steps then dispatch no DTensor op.  On the meta device under a dry
    run's analysis (``launch/op_analysis.py``, ``scale_loops``) the loop
    runs three steps and the analysis counts the rest (``_slstm_scaled``)."""
    if isinstance(x, DTensor):
        return _slstm_rows(cfg, p, x, state, valid, segment_ids)
    b, s, d = x.shape
    init = slstm_init_state(cfg, b, device=x.device)
    if state is None:
        state = init
    first = _first_of_segment(segment_ids) if segment_ids is not None else None
    xw = _slstm_x_proj(p, x)
    analysis = meta.active_analysis() if x.device.type == "meta" else None
    if analysis is not None and analysis.scale_loops and s > META_LOOP_STEPS:
        return _slstm_scaled(cfg, p, x, xw, state, init, first, valid, analysis)
    hs = []
    for t in range(s):
        state = _slstm_step(cfg, p, x, xw, state, init, first, valid, t)
        hs.append(state["h"])
    return torch.stack(hs, dim=1).to(x.dtype), state


SLSTM_WEIGHTS = tuple(f"{k}_{g}" for k in ("w", "r") for g in GATES) + ("f_bias",)


def _slstm_rows(cfg: ModelConfig, p: SLSTM, x, state, valid, segment_ids):
    """``slstm_forward`` of a DTensor x (B, S, d): each rank runs it on its
    own rows (``local_map``), the state, masks and segment ids brought to
    the rows' split and the cell's weights whole on every rank (their
    gradients ``Partial`` over the mesh dims that split the rows).  The
    output and the final state keep the rows' split."""
    from torch.distributed.tensor.experimental import local_map
    dm = x.device_mesh
    rp = [q if isinstance(q, Shard) and q.dim == 0 else Replicate() for q in x.placements]
    wp = [Replicate()] * dm.ndim
    wg = [Partial() if isinstance(q, Shard) else Replicate() for q in rp]
    names = ("h", "c", "n", "m")
    rows = [x, valid, segment_ids] + ([state[n] for n in names] if state is not None else [])
    rows = [None if t is None else reshard(on_mesh(t, dm), dm, rp) for t in rows]
    weights = [reshard(on_mesh(getattr(p, n), dm), dm, wp) for n in SLSTM_WEIGHTS]
    has_state = state is not None

    def local(x, valid, segment_ids, *rest):
        st = dict(zip(names, rest[:4])) if has_state else None
        cell = SimpleNamespace(**dict(zip(SLSTM_WEIGHTS, rest[-len(SLSTM_WEIGHTS):])))
        out, new = slstm_forward(cfg, cell, x, st, valid, segment_ids)
        return (out, *(new[n] for n in names))

    in_p = tuple(None if t is None else rp for t in rows) + (wp,) * len(weights)
    in_g = tuple(None if t is None else rp for t in rows) + (wg,) * len(weights)
    outs = local_map(local, out_placements=(rp,) * 5, in_placements=in_p,
                     in_grad_placements=in_g, device_mesh=dm)(*rows, *weights)
    return outs[0], dict(zip(names, outs[1:]))


def _slstm_step(cfg: ModelConfig, p: SLSTM, x, xw, state, init, first, valid, t: int):
    """Step t of ``slstm_forward``'s loop: the state after it."""
    st_in = state
    if first is not None:
        ft = first[:, t, None]
        st_in = {n: torch.where(ft, init[n], state[n]) for n in state}
    st_new = _slstm_cell(cfg, p, x[:, t], st_in, {g: xw[g][:, t] for g in GATES})
    if valid is not None:
        vt = valid[:, t, None]
        st_new = {n: torch.where(vt, st_new[n], st_in[n]) for n in st_new}
    return st_new


# ---------------------------------------------------------------------------
# the sLSTM's loop in a dry run: three steps traced, the rest counted
# ---------------------------------------------------------------------------

# the first step (from the initial state, which needs no gradient), one
# middle step and the last (no later step adds to its state's gradient):
# every other step of the loop dispatches what the middle one does
META_LOOP_STEPS = 3


class _Held(torch.autograd.Function):
    """Identity on the gate projections ``xw`` ahead of the loop, whose
    backward, the last of the loop's, releases ``box``: a meta tensor the
    loop grows to the bytes its untraced steps' autograd graph would hold
    (saved, so a checkpointed region's recompute fills it as it fills
    every saved tensor)."""

    @staticmethod
    def forward(ctx, box, *xw):
        ctx.save_for_backward(box)
        return tuple(x.view_as(x) for x in xw)

    @staticmethod
    def backward(ctx, *grads):
        (box,) = ctx.saved_tensors      # unpacked (a recompute's box too), then let go
        del box
        return (None, *grads)


class _Mark(torch.autograd.Function):
    """Identity on a step's state whose backward marks the analysis: the
    ops between the marks of steps 1 and 0 are the middle step's backward,
    counted again for every step not traced."""

    @staticmethod
    def forward(ctx, loop, t, *state):
        ctx.set_materialize_grads(False)
        ctx.loop, ctx.t = loop, t
        return tuple(x.view_as(x) for x in state)

    @staticmethod
    def backward(ctx, *grads):
        loop = ctx.loop
        loop["marks"][ctx.t] = loop["analysis"].mark()
        if ctx.t == 0:
            loop["analysis"].add_scaled(loop["marks"][1], loop["marks"][0], loop["untraced"])
        return (None, None, *grads)


class _Stack(torch.autograd.Function):
    """``torch.stack`` of the S steps' h where only the traced ones exist:
    the op is dispatched over S inputs (its bytes), and the gradient goes
    to the traced steps, as ``unbind`` gives it."""

    @staticmethod
    def forward(ctx, s, *hs):
        ctx.n = len(hs)
        return torch.stack(list(hs) + [hs[1]] * (s - len(hs)), dim=1)

    @staticmethod
    def backward(ctx, g):
        return (None, *(g[:, i] for i in range(ctx.n)))


def _slstm_scaled(cfg: ModelConfig, p: SLSTM, x, xw, state, init, first, valid, analysis):
    """``slstm_forward``'s loop on meta: steps 0, 1 and 2 dispatched, and
    step 1 counted S - 3 more times by ``analysis``: its forward ops, its
    backward ops, the bytes its autograd graph keeps until the backward,
    and its h in the stack's inputs."""
    s, k = x.shape[1], META_LOOP_STEPS
    grad = torch.is_grad_enabled() and xw["i"].requires_grad
    loop = {"analysis": analysis, "marks": {}, "untraced": s - k}
    box = torch.empty((0,), dtype=torch.uint8, device="meta")
    if grad:
        xw = dict(zip(GATES, _Held.apply(box, *(xw[g] for g in GATES))))
    marks, hs = [analysis.mark()], []
    for t in range(k):
        state = _slstm_step(cfg, p, x, xw, state, init, first, valid, t)
        if grad and t < k - 1:
            state = dict(zip(state, _Mark.apply(loop, t, *state.values())))
        hs.append(state["h"])
        marks.append(analysis.mark())
    analysis.add_scaled(marks[1], marks[2], s - k)
    # the untraced steps' h and what their graph keeps, live through the stack
    per_step = analysis.born_alive(marks[1], marks[2])
    analysis.hold((s - k) * per_step)
    y = _Stack.apply(s, *hs)
    out = y.to(x.dtype)
    del y, hs
    analysis.hold(-(s - k) * per_step)
    # what the graph keeps of each step until the backward
    analysis.resize(box, (s - k) * analysis.born_alive(marks[1], marks[2]))
    return out, state


def slstm_ffn(cfg: ModelConfig, p: SLSTM, h):
    up = layers.matmul(h, p.w_up)
    up = F.gelu(up.float(), approximate="tanh").to(h.dtype)
    return layers.matmul(up, p.w_down)
