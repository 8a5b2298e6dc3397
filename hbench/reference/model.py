"""The plain reference decoder: what the port's ``LM`` computes, written
out again in float32 PyTorch from the configuration's file and the
published equations, with no kernel, cache or batching of the port.

* A block is pre-norm: RMSNorm (eps 1e-6) -> q, k, v projections (no
  bias) -> optional per-head RMS norm of q and k (OLMoE's QK-norm) ->
  rotary positions (split halves, theta from the file) -> causal softmax
  attention within each packed segment, GQA by repeating kv heads ->
  output projection -> residual; RMSNorm -> SwiGLU MLP, or the mixture
  of experts -> residual.  A final RMSNorm, then logits over the padded
  vocabulary by the tied table or the head.
* The mixture of experts routes every token of a call (padding included)
  by softmax over the router's logits, keeps the top k (ties to the lower
  id), renormalises their probabilities, and drops an assignment when its
  expert already holds ``capacity`` assignments of its group: the call's
  T tokens in G groups (G = 32 where T divides by 32 and T >= 32 E, else
  1), capacity int(factor * T/G * k / E) + 1, assignments counted in
  (token, choice) order.  It returns the load-balance loss E * sum(me *
  ce) and the z-loss mean(logsumexp^2).
* ``quant="fp8"`` computes as fp8 training and fp8 attention do: both
  operands of every projection (the experts', the router's and the
  logits' included) rounded to float8 e4m3 with one scale a tensor, the
  gradients entering their backward products rounded to e5m2, and q, k, v
  and the attention probabilities rounded to e4m3.  It is the control,
  one precision step below the bfloat16 the configuration states.

Imports nothing of the port.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

EPS = 1e-6


def _fp8(x: torch.Tensor, fmt=torch.float8_e4m3fn) -> torch.Tensor:
    """x rounded to fp8 with one scale for the tensor (its largest
    magnitude at the format's largest value)."""
    s = x.detach().abs().amax().clamp_min(1e-30) / torch.finfo(fmt).max
    return (x.detach() / s).to(fmt).float() * s


def _ste(x: torch.Tensor) -> torch.Tensor:
    """x rounded to fp8 e4m3 in the forward pass, its gradient passed
    through."""
    return x + (_fp8(x) - x).detach()


class _F8Product(torch.autograd.Function):
    """x (..., k) @ w (k, n) as fp8 training computes it: both operands
    rounded to e4m3, and in the backward pass the incoming gradient
    rounded to e5m2 before its products with the rounded operands."""

    @staticmethod
    def forward(ctx, x, w):
        xq, wq = _fp8(x), _fp8(w)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        g = _fp8(g, torch.float8_e5m2)
        gx = g @ wq.t()
        gw = xq.reshape(-1, xq.shape[-1]).t() @ g.reshape(-1, g.shape[-1])
        return gx, gw


class Reference:
    """``cfg``: the configuration's file as a dict; ``w``: name -> float32
    tensor, the port's parameter names."""

    def __init__(self, cfg: Dict, w: Dict[str, torch.Tensor], *, quant: Optional[str] = None,
                 remat: bool = False):
        self.cfg = cfg
        self.w = w
        self.quant = quant
        self.remat = remat
        self.d = int(cfg["d_model"])
        self.h, self.hkv, self.hd = int(cfg["n_heads"]), int(cfg["n_kv_heads"]), int(cfg["head_dim"])
        self.vocab = int(cfg["vocab_size"])

    # ---- pieces --------------------------------------------------------
    def mm(self, x, w):
        if self.quant == "fp8":
            return _F8Product.apply(x, w)
        return x @ w

    @staticmethod
    def norm(x, scale):
        return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + EPS) * scale

    def rope(self, x, pos):
        """x (S, H, hd) at integer positions pos (S,)."""
        freqs = float(self.cfg["rope_theta"]) ** (
            -torch.arange(0, self.hd, 2, dtype=torch.float32, device=x.device) / self.hd)
        ang = (pos.float()[:, None] * freqs)[:, None, :]
        c, s = torch.cos(ang), torch.sin(ang)
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)

    def attention(self, q, k, v, runs):
        """q (S, H, hd), k, v (S, Hkv, hd); runs: (start, end) of each
        segment, causal within it."""
        g = self.h // self.hkv
        if self.quant == "fp8":
            q, k, v = _ste(q), _ste(k), _ste(v)
        outs = []
        for a, b in runs:
            qs = q[a:b].transpose(0, 1)                                      # (H, n, hd)
            ks = k[a:b].repeat_interleave(g, dim=1).transpose(0, 1)
            vs = v[a:b].repeat_interleave(g, dim=1).transpose(0, 1)
            sc = qs @ ks.transpose(1, 2) / math.sqrt(self.hd)
            n = b - a
            mask = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
            sc = sc.masked_fill(~mask, float("-inf"))
            pr = torch.softmax(sc, dim=-1)
            if self.quant == "fp8":
                pr = _ste(pr)
            outs.append((pr @ vs).transpose(0, 1))
        return torch.cat(outs, dim=0)

    def mlp(self, p, x):
        return self.mm(F.silu(self.mm(x, self.w[p + "w_gate"])) * self.mm(x, self.w[p + "w_up"]),
                       self.w[p + "w_down"])

    def moe(self, p, x):
        """x (T, d) -> (y (T, d), lb, z)."""
        cfg = self.cfg
        t = x.shape[0]
        e, k = int(cfg["n_experts"]), int(cfg["experts_per_token"])
        logits = self.mm(x, self.w[p + "router"])
        probs = torch.softmax(logits, dim=-1)
        top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
        top_p, top_e = top_p[:, :k], top_e[:, :k]
        top_p = top_p / top_p.sum(dim=-1, keepdim=True)
        ce = torch.zeros(e, device=x.device).index_add_(
            0, top_e.reshape(-1), torch.ones(t * k, device=x.device)) / (t * k)
        lb = e * torch.sum(probs.mean(dim=0) * ce)
        z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
        groups = 32 if t % 32 == 0 and t >= 32 * e else 1
        tg = t // groups
        cap = int(float(cfg["moe_capacity_factor"]) * tg * k / e) + 1
        flat = top_e.reshape(groups, tg * k)
        onehot = F.one_hot(flat, e)
        before = torch.gather(onehot.cumsum(dim=1) - onehot, 2, flat[..., None])[..., 0]
        keep = (before < cap).reshape(t, k)
        y = torch.zeros_like(x)
        tok = torch.arange(t, device=x.device)[:, None].expand(t, k)
        wu, wg, wd = self.w[p + "w_up"], self.w[p + "w_gate"], self.w[p + "w_down"]
        for j in range(e):
            sel = (top_e == j) & keep
            if not bool(sel.any()):
                continue
            rows = tok[sel]
            hj = self.mm(F.silu(self.mm(x[rows], wg[j])) * self.mm(x[rows], wu[j]), wd[j])
            y = y.index_add(0, rows, hj * top_p[sel][:, None])
        return y, lb, z

    # ---- the model -----------------------------------------------------
    def layer(self, i: int, h, pos, runs):
        cfg, p = self.cfg, f"blocks.{i}."
        s = h.shape[0]
        x = self.norm(h, self.w[p + "attn_norm.scale"])
        q = self.mm(x, self.w[p + "attn.wq"]).reshape(s, self.h, self.hd)
        k = self.mm(x, self.w[p + "attn.wk"]).reshape(s, self.hkv, self.hd)
        v = self.mm(x, self.w[p + "attn.wv"]).reshape(s, self.hkv, self.hd)
        if cfg["qk_norm"]:
            q = self.norm(q, self.w[p + "attn.q_norm.scale"])
            k = self.norm(k, self.w[p + "attn.k_norm.scale"])
        q, k = self.rope(q, pos), self.rope(k, pos)
        a = self.attention(q, k, v, runs).reshape(s, self.h * self.hd)
        h = h + self.mm(a, self.w[p + "attn.wo"])
        x = self.norm(h, self.w[p + "mlp_norm.scale"])
        zero = torch.zeros((), device=h.device)
        if int(cfg["n_experts"]):
            y, lb, z = self.moe(p + "moe.", x)
            return h + y, lb, z
        return h + self.mlp(p + "mlp.", x), zero, zero

    def hidden(self, tokens, pos, runs) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """tokens, pos (S,) of one row; runs its segments.  Returns (the
        final-normed hidden states (S, d), lb, z summed over layers)."""
        h = self.w["embed.table"][tokens.long()]
        lb = z = torch.zeros((), device=h.device)
        for i in range(int(self.cfg["n_layers"])):
            if self.remat and torch.is_grad_enabled():
                h, a, b = checkpoint(self.layer, i, h, pos, runs, use_reentrant=False)
            else:
                h, a, b = self.layer(i, h, pos, runs)
            lb, z = lb + a, z + b
        return self.norm(h, self.w["final_norm.scale"]), lb, z

    def logits(self, h):
        """(..., padded vocab) over the whole padded vocabulary."""
        head = self.w["embed.table"].t() if self.cfg["tie_embeddings"] else self.w["head.w"]
        return self.mm(h, head)


def segment_runs(segment_ids: Sequence[int]) -> List[Tuple[int, int]]:
    """(start, end) of each run of equal segment ids (padding, -1, is one
    run of its own, as in the port's kernels)."""
    runs, a = [], 0
    ids = list(segment_ids)
    for i in range(1, len(ids) + 1):
        if i == len(ids) or ids[i] != ids[a]:
            runs.append((a, i))
            a = i
    return runs
