"""The kernels' routes on the ``meta`` device, for the dry run, and the
record of the kernels' work that an analysis of a step reads.

Each route runs its CUDA wrapper's own ``prepare``: the same checks and
refusals, the same split plan, and the same outputs and scratch,
allocated on meta so that an analysis of the step's peak sees them.  On
meta a plan is made for the H100's 132 SMs with no bound from the
resident grid (``decode_attention.META_SMS``, ``UNBOUNDED``), so the
split kernels' scratch is an upper bound of what the card's plan
allocates.  In place of the launch a route records the kernel's
operations and bytes with ``record_kernel``, by the convention of
``chip_smoke.py``'s ``bound``: each byte moved once, each visible
(query, key) pair's flops once.  Meta tensors hold no positions, so
every key of a cache, a pool or a segment is counted as visible (one
segment a row): an upper bound of what the data of a run needs.  The
barrier counts and merge counters the wrappers keep for the life of the
process are not allocated here.

An analysis (``launch/op_analysis.py``) receives the records on its
thread between ``push_analysis`` and ``pop_analysis``.  Nothing here is
counted in ``ops.LAUNCHES``: no kernel is launched.
"""
from __future__ import annotations

import threading

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_attention_bwd as _bwd
from repro_torch.kernels import fused_decode_tail as _ft
from repro_torch.kernels import linear_scan as _scan
from repro_torch.kernels import paged_decode_attention as _pd
from repro_torch.kernels import paged_prefill_attention as _pp

_ACTIVE = threading.local()       # .stack: this thread's analyses, innermost last


def push_analysis(analysis) -> None:
    """Send the kernels' records on this thread to ``analysis`` (an
    object with ``add_kernel(name, flops, nbytes)``) until it is popped."""
    if not hasattr(_ACTIVE, "stack"):
        _ACTIVE.stack = []
    _ACTIVE.stack.append(analysis)


def pop_analysis(analysis) -> None:
    _ACTIVE.stack.remove(analysis)


def active_analysis():
    """The innermost analysis running on this thread, or None."""
    stack = getattr(_ACTIVE, "stack", None)
    return stack[-1] if stack else None


def record_kernel(name: str, flops: float, nbytes: float) -> None:
    """Add a hand-written kernel's operations and bytes to the innermost
    analysis running on this thread, if one is."""
    stack = getattr(_ACTIVE, "stack", None)
    if stack:
        stack[-1].add_kernel(name, flops, nbytes)


def _nbytes(*xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs if x is not None)


def visible_pairs(s: int, causal: bool, window: int) -> int:
    """(query, key) pairs of one (row, head) of an S-long self-attention
    with every token in one segment."""
    if not causal:
        return s * s
    if window and 0 < window < s:
        return window * (window + 1) // 2 + (s - window) * window
    return s * (s + 1) // 2


def _visible_keys(keys: int, window: int) -> int:
    return min(keys, window) if window and window > 0 else keys


def _pool_read(k_pool, b: int, keys: int) -> int:
    _, _, hkv, hd = k_pool.shape
    return 2 * b * keys * hkv * hd * k_pool.element_size()


def flash_attention(q, k, v, segment_ids=None, *, causal: bool = True, window: int = 0,
                    softmax_scale=None, return_lse: bool = False):
    (out, lse), call = _fa.prepare(q, k, v, segment_ids, softmax_scale, return_lse)
    if call is not None:
        kq, kk, kv, seg, kout, _, _ = call
        b, s, h, hd = kq.shape
        record_kernel("flash_attention", 4.0 * hd * b * h * visible_pairs(s, causal, window),
                      _nbytes(kq, kk, kv, seg, kout, lse))
    return (out, lse) if return_lse else out


def flash_attention_bwd(q, k, v, out, lse, dout, segment_ids=None, *, causal: bool = True,
                        window: int = 0, softmax_scale=None):
    grads, call = _bwd.prepare(q, k, v, out, lse, dout, segment_ids, causal, window,
                               softmax_scale)
    if call is not None:
        kq, kk, _, _, klse, _, seg, dq, dk, dv = call[1][:10]
        b, s, h, hd = kq.shape
        record_kernel("flash_attention_bwd", 10.0 * hd * b * h * visible_pairs(s, causal, window),
                      3 * _nbytes(kq) + 2 * _nbytes(kk) + _nbytes(seg, klse, dq, dk, dv))
    return grads


def decode_attention(q, k_cache, v_cache, cache_pos, t, *, window: int = 0,
                     softmax_scale=None):
    out, call = _dec.prepare(q, k_cache, v_cache, cache_pos, t, None, softmax_scale)
    if call is not None:
        b, h, hd = q.shape
        w, hkv = k_cache.shape[1], k_cache.shape[2]
        keys = _visible_keys(w, window)
        record_kernel("decode_attention", 4.0 * hd * h * b * keys,
                      2 * b * keys * hkv * hd * k_cache.element_size()
                      + _nbytes(q, out, cache_pos, t))
    return out


def paged_decode_attention(q, k_pool, v_pool, block_tables, t, *, window: int = 0,
                           softmax_scale=None):
    out, call = _pd.prepare(q, k_pool, v_pool, block_tables, t, None, softmax_scale)
    if call is not None:
        b, h, hd = q.shape
        keys = _visible_keys(block_tables.shape[1] * k_pool.shape[1], window)
        record_kernel("paged_decode_attention", 4.0 * hd * h * b * keys,
                      _pool_read(k_pool, b, keys) + _nbytes(q, out, block_tables, t))
    return out


def fused_decode_tail(q, k_pool, v_pool, wo, block_tables, t, *, window: int = 0,
                      softmax_scale=None):
    out, call = _ft.prepare(q, k_pool, v_pool, wo, block_tables, t, None, softmax_scale)
    if call is not None:
        b, h, hd = q.shape
        keys = _visible_keys(block_tables.shape[1] * k_pool.shape[1], window)
        record_kernel("fused_decode_tail", 4.0 * hd * h * b * keys + 2.0 * b * h * hd * wo.shape[1],
                      _pool_read(k_pool, b, keys) + _nbytes(q, wo, out, block_tables, t))
    return out


def paged_prefill_attention(q, k_pool, v_pool, block_tables, q_pos, *, window: int = 0,
                            softmax_scale=None):
    out, call = _pp.prepare(q, k_pool, v_pool, block_tables, q_pos, None, softmax_scale)
    if call is not None:
        b, c, h, hd = q.shape
        keys = _visible_keys(block_tables.shape[1] * k_pool.shape[1], window)
        record_kernel("paged_prefill_attention", 4.0 * hd * h * b * c * keys,
                      _pool_read(k_pool, b, keys) + _nbytes(q, out, block_tables, q_pos))
    return out


def linear_scan(a, x, h0=None):
    (h, h_last), call = _scan.prepare(a, x, h0)
    if call is not None:
        b, s, c = x.shape
        record_kernel("linear_scan", 2.0 * b * s * c, _nbytes(a, x, call[0], h, h_last))
    return h, h_last


def linear_scan_bwd(a, h, h0, g, g_last=None):
    (da, dx, dh0), call = _scan.prepare_bwd(a, h, h0, g, g_last)
    if call is not None:
        b, s, c = g.shape
        record_kernel("linear_scan_bwd", 3.0 * b * s * c,
                      _nbytes(a, h, *call, g, da, dx, dh0))
    return da, dx, dh0
