"""Plain PyTorch versions of the attention kernels of the serving and
training paths.

These mirror ``repro/kernels/ref.py`` (``flash_attention`` and its
chunked form ``flash_attention_chunked``,
``decode_attention``, ``chunked_prefill_attention``, the paged
``paged_prefill_attention``, ``paged_decode_attention`` and
``fused_decode_tail``, and the diagonal recurrence ``linear_scan``)
operation for operation: the same masks, the same
``-1e30`` fill, f32 scores and softmax, the probabilities cast to
``q.dtype`` before the PV product, and in ``fused_decode_tail`` the f32
projection of the rounded contexts followed by a cast.  They are what
the kernel wrappers in ``ops.py`` run for CPU tensors, and what the
Hopper kernels are held against on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30


def _gqa_expand(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, Hkv, hd) -> (B, S, H, hd) by repeating kv heads."""
    group = n_heads // k.shape[2]
    return k.repeat_interleave(group, dim=2) if group > 1 else k


def _split_segments(segment_ids):
    if segment_ids is None:
        return None, None
    return segment_ids if isinstance(segment_ids, tuple) else (segment_ids, segment_ids)


def _visible(sq: int, sk: int, seg_q, seg_kv, causal: bool, window: int, device, q0: int = 0):
    """(B or 1, 1, Sq, Sk) bool: key j visible to query q0 + i."""
    qpos = torch.arange(q0, q0 + sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window and window > 0:
        mask &= (qpos - kpos) < window
    mask = mask[None, None]
    if seg_q is not None:
        mask = mask & (seg_q[:, None, :, None] == seg_kv[:, None, None, :])
    return mask


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
    mask = _visible(s, sk, *_split_segments(segment_ids), causal, window, q.device)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vx)
    return out.to(q.dtype)


def flash_attention_chunked(q, k, v, segment_ids=None, *, causal: bool = True,
                            window: int = 0, softmax_scale: Optional[float] = None,
                            chunk: int = 128):
    """``flash_attention`` in chunks of ``chunk`` queries, with grouped GQA
    products (K and V never expanded): O(B·H·chunk·Sk) temporaries instead
    of O(B·H·Sq·Sk), as ``repro/kernels/ref.py::flash_attention_chunked``.
    Each chunk takes its row max, ``exp`` where visible and 0 elsewhere,
    and divides by max(sum, 1e-30), so a row that sees no key gives 0.
    Under autograd each chunk is recomputed in the backward pass
    (``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``."""
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    chunk = min(chunk, sq)
    seg_q, seg_kv = _split_segments(segment_ids)
    kf, vf = k.float(), v.float()

    def body(qc, q0: int, segc):
        n = qc.shape[1]
        qg = qc.reshape(b, n, hkv, g, hd).float()
        s = torch.einsum("bqngd,bknd->bngqk", qg, kf) * scale
        mask = _visible(n, sk, segc, seg_kv, causal, window, q.device, q0)[:, :, None]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
        den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        o = torch.einsum("bngqk,bknd->bqngd", p / den, vf)
        return o.reshape(b, n, h, hd)

    remat = torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v))
    outs = []
    for q0 in range(0, sq, chunk):
        args = (q[:, q0:q0 + chunk], q0, None if seg_q is None else seg_q[:, q0:q0 + chunk])
        outs.append(checkpoint(body, *args, use_reentrant=False) if remat else body(*args))
    return torch.cat(outs, dim=1).to(q.dtype)


def flash_attention_lse(q, k, *, segment_ids=None, causal: bool = True, window: int = 0,
                        softmax_scale: Optional[float] = None):
    """(B, H, Sq) f32: the log-sum-exp of each query row's scaled scores
    over the keys it sees, -inf for a row that sees none.  The forward
    kernel writes it beside its output for the backward pass."""
    b, s, h, hd = q.shape
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    seg_q, seg_kv = _split_segments(segment_ids)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), _gqa_expand(k, h).float()) * scale
    mask = _visible(s, k.shape[1], seg_q, seg_kv, causal, window, q.device)
    return torch.logsumexp(torch.where(mask, scores, torch.full_like(scores, -math.inf)), -1)


def flash_attention_bwd(q, k, v, out, lse, dout, *, segment_ids=None, causal: bool = True,
                        window: int = 0, softmax_scale: Optional[float] = None):
    """The gradients (dq, dk, dv) of ``flash_attention``'s masked attention
    given its output ``out`` (B, Sq, H, hd), the log-sum-exp ``lse`` (B,
    H, Sq) f32 of ``flash_attention_lse`` and the output's gradient
    ``dout``, from the recomputed probabilities in f32:

        P = exp(S·scale − lse) where visible, else 0
        D = rowsum(dout ∘ out),  dS = P ∘ (dout·Vᵀ − D)
        dV = Pᵀ·dout,  dK = dSᵀ·Q·scale,  dQ = dS·K·scale

    summed over each kv head's group of query heads.  A row whose ``lse``
    is -inf contributes nothing.  Each gradient comes back in its input's
    dtype.  What the backward kernel is held against on the card."""
    b, s, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    seg_q, seg_kv = _split_segments(segment_ids)
    qf, kx, vx, do = q.float(), _gqa_expand(k, h).float(), _gqa_expand(v, h).float(), dout.float()
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kx) * scale
    live = torch.isfinite(lse)[..., None]
    mask = _visible(s, sk, seg_q, seg_kv, causal, window, q.device) & live
    p = torch.where(mask, torch.exp(scores - torch.where(live, lse[..., None], 0.0)),
                    torch.zeros_like(scores))
    delta = (do * out.float()).sum(-1).transpose(1, 2)                  # (B, H, Sq)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, vx)
    ds = p * (dp - delta[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do).reshape(b, sk, hkv, g, hd).sum(3)
    dk = (torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale).reshape(b, sk, hkv, g, hd).sum(3)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kx) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def chunked_prefill_attention(q, k, v, key_pos, q_pos, *, window: int = 0,
                              softmax_scale: Optional[float] = None):
    """Chunk-of-queries attention against positioned keys.

    q: (B, C, H, hd), C query tokens at absolute positions q_pos (B, C)
    (-1 = padded row; its output is unspecified).  k, v: (B, S, Hkv, hd)
    with key_pos (B, S) absolute positions, -1 = invalid.  A key is
    visible to a query iff key_pos >= 0, key_pos <= q_pos and, for
    window > 0, q_pos - key_pos < window.  With C = 1 and q_pos = t this
    is ``decode_attention``.
    """
    b, c, h, hd = q.shape
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    hkv = k.shape[2]
    group = h // hkv
    qg = q.reshape(b, c, hkv, group, hd)
    scores = torch.einsum("bcngd,bwnd->bcngw", qg.float(), k.float()) * scale
    qp = q_pos[:, :, None, None, None].to(torch.int32)
    kp = key_pos[:, None, None, None, :].to(torch.int32)
    valid = (kp >= 0) & (kp <= qp) & (qp >= 0)
    if window and window > 0:
        valid &= kp > qp - window
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bcngw,bwnd->bcngd", probs.to(q.dtype).float(), v.float())
    return out.reshape(b, c, h, hd).to(q.dtype)


def gather_pool(k_pool, v_pool, block_tables):
    """Each slot's blocks gathered into a flat positioned cache: k, v
    (B, E*bs, Hkv, hd) and key positions (B, E*bs), entry e holding
    positions [e*bs, (e+1)*bs) and -1 where the entry is unbound."""
    n, bs, hkv, hd = k_pool.shape
    b, e = block_tables.shape
    safe = block_tables.clamp(0, n - 1).long()
    kg = k_pool[safe].reshape(b, e * bs, hkv, hd)
    vg = v_pool[safe].reshape(b, e * bs, hkv, hd)
    pos = torch.arange(e * bs, dtype=torch.int32, device=k_pool.device)[None].expand(b, -1)
    bound = (block_tables >= 0).repeat_interleave(bs, dim=1)
    return kg, vg, torch.where(bound, pos, -1)


def paged_prefill_attention(q, k_pool, v_pool, block_tables, q_pos, *,
                            window: int = 0, softmax_scale: Optional[float] = None):
    """Chunk-of-queries attention against a paged KV-block pool.

    q: (B, C, H, hd) at absolute positions q_pos (B, C) (-1 = padded
    row).  k_pool, v_pool: (N, bs, Hkv, hd); block_tables: (B, E) int32,
    entry e covering positions [e*bs, (e+1)*bs), -1 = unbound.  The
    chunk's own K/V are already in the pool (write-then-read).  The
    slot's blocks are gathered into a flat positioned cache and the
    chunk attends it through ``chunked_prefill_attention``.
    """
    kg, vg, key_pos = gather_pool(k_pool, v_pool, block_tables)
    return chunked_prefill_attention(q, kg, vg, key_pos, q_pos, window=window,
                                     softmax_scale=softmax_scale)


def paged_decode_attention(q, k_pool, v_pool, block_tables, t, *, window: int = 0,
                           softmax_scale: Optional[float] = None):
    """Single-token attention against a paged KV-block pool.

    q: (B, H, hd), the token at absolute position t (B,).  Pools and
    tables as in ``paged_prefill_attention``.  The slot's blocks are
    gathered into a flat positioned cache and the token attends it
    through ``decode_attention``.  Returns (B, H, hd).
    """
    kg, vg, cache_pos = gather_pool(k_pool, v_pool, block_tables)
    return decode_attention(q, kg, vg, cache_pos, t, window=window,
                            softmax_scale=softmax_scale)


def fused_decode_tail(q, k_pool, v_pool, wo, block_tables, t, *, window: int = 0,
                      softmax_scale: Optional[float] = None):
    """Paged decode attention followed by the output projection.

    q: (B, H, hd); wo: (H*hd, D); the rest as in
    ``paged_decode_attention``.  Returns (B, D) in q's dtype: the
    contexts, rounded to q's dtype, times wo in f32, then cast.
    """
    b, h, hd = q.shape
    out = paged_decode_attention(q, k_pool, v_pool, block_tables, t, window=window,
                                 softmax_scale=softmax_scale)
    return torch.matmul(out.reshape(b, h * hd).float(), wo.float()).to(q.dtype)


def linear_scan(a, x, h0=None):
    """Diagonal linear recurrence  h_t = a_t * h_{t-1} + x_t.

    a, x: (B, S, C); h0: (B, C) initial state (zeros if None).  Returns
    (h (B, S, C), h_last (B, C)) in x's dtype; the state is carried in
    f32.  A sequential loop over S: unlike a cumulative-product form it
    stays exact when some a_t is near 0 (the reference computes the same
    recurrence with an associative scan, so the two agree to f32
    rounding).  The states are stacked once at the end, so that autograd
    through the loop (the plain version of the scan's gradient) costs
    O(S C), not a copy of h per step."""
    b, s, c = x.shape
    af = a.float()
    xf = x.float()
    cur = (torch.zeros((b, c), dtype=torch.float32, device=x.device) if h0 is None
           else h0.float())
    states = []
    for t in range(s):
        cur = af[:, t] * cur + xf[:, t]
        states.append(cur)
    out = (torch.stack(states, dim=1) if states
           else torch.empty((b, 0, c), dtype=torch.float32, device=x.device))
    return out.to(x.dtype), cur.to(x.dtype)
