"""Plain PyTorch versions of the attention kernels on the serving path.

These mirror ``repro/kernels/ref.py`` (``flash_attention`` and
``decode_attention``) operation for operation: the same masks, the same
``-1e30`` fill, f32 scores and softmax, and in ``decode_attention`` the
probabilities cast to ``q.dtype`` before the PV product.  They are what
the kernel wrappers in ``ops.py`` run for CPU tensors, and what the
Hopper kernels are held against on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _gqa_expand(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, Hkv, hd) -> (B, S, H, hd) by repeating kv heads."""
    group = n_heads // k.shape[2]
    return k.repeat_interleave(group, dim=2) if group > 1 else k


def flash_attention(q, k, v, *, segment_ids=None, causal: bool = True,
                    window: int = 0, softmax_scale: Optional[float] = None):
    """Masked multi-head attention over a full sequence.

    q: (B, Sq, H, hd); k, v: (B, Sk, Hkv, hd) with H % Hkv == 0.
    segment_ids: (B, S) int32 (or a (seg_q, seg_kv) tuple): tokens attend
    only within their segment.  window > 0: token t sees keys in
    (t - window, t].  Returns (B, Sq, H, hd) in q's dtype.
    """
    b, s, h, hd = q.shape
    sk = k.shape[1]
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    kx = _gqa_expand(k, h).float()
    vx = _gqa_expand(v, h).float()
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kx) * scale
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((s, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window and window > 0:
        mask &= (qpos - kpos) < window
    mask = mask[None, None]
    if segment_ids is not None:
        seg_q, seg_kv = (segment_ids if isinstance(segment_ids, tuple)
                         else (segment_ids, segment_ids))
        mask = mask & (seg_q[:, None, :, None] == seg_kv[:, None, None, :])
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vx)
    return out.to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_pos, t, *, window: int = 0,
                     softmax_scale: Optional[float] = None):
    """Single-token attention against a ring-buffer KV cache.

    q: (B, H, hd), the token at absolute position t.  k_cache, v_cache:
    (B, W, Hkv, hd); cache_pos: (B, W) int32 absolute positions, -1 for
    empty.  t: (B,) int32.  window > 0 masks positions <= t - window.
    Returns (B, H, hd) in q's dtype.
    """
    b, h, hd = q.shape
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    hkv = k_cache.shape[2]
    group = h // hkv
    qg = q.reshape(b, hkv, group, hd)
    # f32 products of the working-dtype operands, as the reference's
    # preferred_element_type=f32 einsum
    scores = torch.einsum("bngd,bwnd->bngw", qg.float(), k_cache.float()) * scale
    tb = t.reshape(b, 1, 1, 1).to(torch.int32)
    pos = cache_pos[:, None, None, :]
    valid = (pos >= 0) & (pos <= tb)
    if window and window > 0:
        valid &= pos > tb - window
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bngw,bwnd->bngd", probs.to(q.dtype).float(),
                       v_cache.float())
    return out.reshape(b, h, hd).to(q.dtype)
