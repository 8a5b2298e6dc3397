"""Kernel entry points, with the signatures of ``repro/kernels/ops.py``.

Dispatch is by the device of the tensors, not by a global switch: a CPU
tensor goes to the plain PyTorch version in ``ref.py``; a CUDA tensor
goes to the Hopper kernel, or the wrapper raises.  There is no fallback
from the kernel to the plain version.

``LAUNCHES`` counts kernel launches by name, one per call that reached
the kernel, so a run can show that its path went through the kernels.

``flash_attention`` is differentiable.  On the CPU autograd goes through
the plain version; on the card, when an input needs a gradient, the
forward kernel also writes each row's log-sum-exp and the backward pass
launches the backward kernel (counted as ``"flash_attention_bwd"``, one
per backward call).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_cuda
from repro_torch.kernels.fused_decode_tail import fused_decode_tail_cuda
from repro_torch.kernels.linear_scan import linear_scan_cuda
from repro_torch.kernels.paged_decode_attention import paged_decode_attention_cuda
from repro_torch.kernels.paged_prefill_attention import paged_prefill_attention_cuda

LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0, "decode_attention": 0,
            "paged_decode_attention": 0, "paged_prefill_attention": 0, "fused_decode_tail": 0,
            "linear_scan": 0}
# the CPU route switches to the query-chunked oracle above ~1024 x 1024
# scores per (batch, head), as the reference's ops.flash_attention does
_CHUNKED_THRESHOLD = 1024 * 1024


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _route(x) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x.device}")
    return x.device.type


class _FlashAttention(torch.autograd.Function):
    """The forward kernel with its log-sum-exp saved, and the backward
    kernel as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal, window, softmax_scale):
        out, lse = flash_attention_cuda(q, k, v, segment_ids, causal=causal, window=window,
                                        softmax_scale=softmax_scale, return_lse=True)
        LAUNCHES["flash_attention"] += 1
        ctx.save_for_backward(q, k, v, out, lse, segment_ids)
        ctx.opts = dict(causal=causal, window=window, softmax_scale=softmax_scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, segment_ids = ctx.saved_tensors
        grads = flash_attention_bwd_cuda(q, k, v, out, lse, dout.contiguous(), segment_ids,
                                         **ctx.opts)
        LAUNCHES["flash_attention_bwd"] += 1
        return (*grads, None, None, None, None)


def flash_attention(q, k, v, segment_ids=None, *, causal: bool = True,
                    window: int = 0, softmax_scale: Optional[float] = None):
    """q: (B, S, H, hd); k, v: (B, S, Hkv, hd); segment_ids: (B, S) int32."""
    if q.shape[1] != k.shape[1]:
        raise NotImplementedError("cross-attention (Sq != Sk) is not ported yet")
    if _route(q) == "cpu":
        fn = (_ref.flash_attention_chunked if q.shape[1] * k.shape[1] > _CHUNKED_THRESHOLD
              else _ref.flash_attention)
        return fn(q, k, v, segment_ids=segment_ids, causal=causal, window=window,
                  softmax_scale=softmax_scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        return _FlashAttention.apply(q, k, v, segment_ids, causal, window, softmax_scale)
    out = flash_attention_cuda(q, k, v, segment_ids, causal=causal, window=window,
                               softmax_scale=softmax_scale)
    LAUNCHES["flash_attention"] += 1
    return out


def decode_attention(q, k_cache, v_cache, cache_pos, t, *, window: int = 0,
                     softmax_scale: Optional[float] = None):
    """q: (B, H, hd); caches: (B, W, Hkv, hd); cache_pos: (B, W) int32
    (-1 = empty); t: (B,) int32."""
    if _route(q) == "cpu":
        return _ref.decode_attention(q, k_cache, v_cache, cache_pos, t, window=window,
                                     softmax_scale=softmax_scale)
    out = decode_attention_cuda(q, k_cache, v_cache, cache_pos, t, window=window,
                                softmax_scale=softmax_scale)
    LAUNCHES["decode_attention"] += 1
    return out


def paged_decode_attention(q, k_pool, v_pool, block_tables, t, *, window: int = 0,
                           softmax_scale: Optional[float] = None):
    """q: (B, H, hd); pools: (N, bs, Hkv, hd); block_tables: (B, E) int32
    (-1 = unbound); t: (B,) int32."""
    if _route(q) == "cpu":
        return _ref.paged_decode_attention(q, k_pool, v_pool, block_tables, t, window=window,
                                           softmax_scale=softmax_scale)
    out = paged_decode_attention_cuda(q, k_pool, v_pool, block_tables, t, window=window,
                                      softmax_scale=softmax_scale)
    LAUNCHES["paged_decode_attention"] += 1
    return out


def fused_decode_tail(q, k_pool, v_pool, wo, block_tables, t, *, window: int = 0,
                      softmax_scale: Optional[float] = None):
    """Paged decode attention fused with the output projection: q (B, H,
    hd) against pools (N, bs, Hkv, hd) through block_tables (B, E),
    projected by wo (H*hd, D); returns (B, D)."""
    if _route(q) == "cpu":
        return _ref.fused_decode_tail(q, k_pool, v_pool, wo, block_tables, t, window=window,
                                      softmax_scale=softmax_scale)
    out = fused_decode_tail_cuda(q, k_pool, v_pool, wo, block_tables, t, window=window,
                                 softmax_scale=softmax_scale)
    LAUNCHES["fused_decode_tail"] += 1
    return out


def paged_prefill_attention(q, k_pool, v_pool, block_tables, q_pos, *, window: int = 0,
                            softmax_scale: Optional[float] = None):
    """q: (B, C, H, hd) at absolute positions q_pos (B, C) (-1 = padded
    row); pools: (N, bs, Hkv, hd); block_tables: (B, E) int32 (-1 =
    unbound).  The chunk's own K/V must already be in the pool."""
    if _route(q) == "cpu":
        return _ref.paged_prefill_attention(q, k_pool, v_pool, block_tables, q_pos,
                                            window=window, softmax_scale=softmax_scale)
    out = paged_prefill_attention_cuda(q, k_pool, v_pool, block_tables, q_pos, window=window,
                                       softmax_scale=softmax_scale)
    LAUNCHES["paged_prefill_attention"] += 1
    return out


def linear_scan(a, x, h0=None):
    """h_t = a_t * h_{t-1} + x_t over a, x: (B, S, C) with h0: (B, C) or
    None; returns (h (B, S, C), h_last (B, C)) in x's dtype."""
    if _route(x) == "cpu":
        return _ref.linear_scan(a, x, h0)
    out = linear_scan_cuda(a, x, h0)
    LAUNCHES["linear_scan"] += 1
    return out
