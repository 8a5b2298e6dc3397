"""Kernel entry points, with the signatures of ``repro/kernels/ops.py``.

Dispatch is by the device of the tensors, not by a global switch: a CPU
tensor goes to the plain PyTorch version in ``ref.py``; a CUDA tensor
goes to the Hopper kernel, or the wrapper raises.  There is no fallback
from the kernel to the plain version.

``LAUNCHES`` counts kernel launches by name, one per call that reached
the kernel, so a run can show that its path went through the kernels.
Two threads launch kernels at once in the threaded runtime (the rollout
thread decodes while the trainer thread trains), so a count is raised
under a lock (``count_launch``): ``+= 1`` on a dict entry is a read and
a write, and two threads between them would lose a count.

``flash_attention`` and ``linear_scan`` are differentiable.  On the CPU
autograd goes through the plain versions; on the card, when an input
needs a gradient, the backward pass launches the backward kernel,
counted as ``"flash_attention_bwd"`` or ``"linear_scan_bwd"``, one per
backward call (the attention forward then also writes each row's
log-sum-exp).

On the ``meta`` device (the dry run, ``launch/dryrun.py``) each op takes
its kernel's meta route (``kernels/meta.py``): the CUDA wrapper's
outputs and scratch, no arithmetic, the kernel's operations and bytes
recorded in the active analysis, and no count in ``LAUNCHES``.  Meta
never takes the plain versions, whose score matrices the kernels never
allocate.

A query row that sees no key (a padded row of a chunked span, a free
slot's decode row) has an output the reference calls unspecified: its
jnp oracle, and so the plain version, averages V over every row the
slot's table gathers, while the paged kernels, as the TPU ones, write 0.
A mixture of experts routes every row, so such a row's value takes
expert capacity from the others.  ``mean_empty_rows=True`` (the MoE
model's calls) gives those rows the plain version's value on the card
too (``_empty_rows``, ``_gathered_mean``), so the card drops what the
CPU drops.
"""
from __future__ import annotations

import threading
from typing import Optional

import torch

from repro_torch.kernels import meta as _meta
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_cuda
from repro_torch.kernels.fused_decode_tail import fused_decode_tail_cuda
from repro_torch.kernels.linear_scan import linear_scan_bwd_cuda, linear_scan_cuda
from repro_torch.kernels.paged_decode_attention import paged_decode_attention_cuda
from repro_torch.kernels.paged_prefill_attention import paged_prefill_attention_cuda

LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0, "decode_attention": 0,
            "paged_decode_attention": 0, "paged_prefill_attention": 0, "fused_decode_tail": 0,
            "linear_scan": 0, "linear_scan_bwd": 0}
# the CPU route switches to the query-chunked oracle above ~1024 x 1024
# scores per (batch, head), as the reference's ops.flash_attention does
_CHUNKED_THRESHOLD = 1024 * 1024


_LAUNCHES_LOCK = threading.Lock()


def reset_launches() -> None:
    with _LAUNCHES_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    """Add one launch of kernel ``name`` to ``LAUNCHES``."""
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1


def _route(x) -> str:
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"no kernel for device {x.device}")
    return x.device.type


def _launched(x, name: str) -> None:
    """Count a launch of kernel ``name``, made on ``x``'s device unless
    that is meta."""
    if x.device.type == "cuda":
        count_launch(name)


class _FlashAttention(torch.autograd.Function):
    """The forward kernel with its log-sum-exp saved, and the backward
    kernel as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal, window, softmax_scale):
        fwd = _meta.flash_attention if q.is_meta else flash_attention_cuda
        out, lse = fwd(q, k, v, segment_ids, causal=causal, window=window,
                       softmax_scale=softmax_scale, return_lse=True)
        _launched(q, "flash_attention")
        ctx.save_for_backward(q, k, v, out, lse, segment_ids)
        ctx.opts = dict(causal=causal, window=window, softmax_scale=softmax_scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, segment_ids = ctx.saved_tensors
        bwd = _meta.flash_attention_bwd if q.is_meta else flash_attention_bwd_cuda
        grads = bwd(q, k, v, out, lse, dout.contiguous(), segment_ids, **ctx.opts)
        _launched(q, "flash_attention_bwd")
        return (*grads, None, None, None, None)


def _empty_rows(block_tables, q_pos, block_size: int, window: int = 0):
    """(B, C) bool: the query rows at positions q_pos (B, C) (-1 = padded)
    that see no key through their slot's table (B, E) (-1 = unbound): no
    bound entry holds a position in [q_pos - window + 1, q_pos], or in
    [0, q_pos] without a window."""
    e = block_tables.shape[1]
    first = torch.arange(e, device=q_pos.device) * block_size        # (E,)
    qp = q_pos.long()[..., None]                                     # (B, C, 1)
    seen = (block_tables >= 0)[:, None, :] & (first <= qp) & (qp >= 0)
    if window and window > 0:
        seen &= first + block_size - 1 > qp - window
    return ~seen.any(dim=-1)


def _gathered_mean(v_pool, block_tables, n_heads: int, dtype) -> torch.Tensor:
    """(B, H, hd) in ``dtype``: the plain version's output for a row that
    sees no key.  Its softmax over all-masked scores is uniform, so it is
    V averaged over every row the table gathers (an unbound entry reads
    block 0), each weight 1 / (E bs) rounded to ``dtype`` as the plain
    version rounds its probabilities."""
    n, bs, hkv, _ = v_pool.shape
    e = block_tables.shape[1]
    block_sum = v_pool.sum(dim=1, dtype=torch.float32)               # (N, Hkv, hd)
    total = block_sum[block_tables.clamp(0, n - 1).long()].sum(dim=1)
    w = torch.tensor(1.0 / (e * bs), dtype=torch.float32).to(dtype).float()
    return (total * w).repeat_interleave(n_heads // hkv, dim=1).to(dtype)


def flash_attention(q, k, v, segment_ids=None, *, causal: bool = True,
                    window: int = 0, softmax_scale: Optional[float] = None):
    """q: (B, Sq, H, hd); k, v: (B, Sk, Hkv, hd); segment_ids: (B, S)
    int32.  Cross-attention (Sq != Sk, the enc-dec decoder over its
    frames) takes the plain route on every device, as the reference keeps
    it on its jnp oracle on every backend (``repro/kernels/ops.py:65-73``):
    there is no TPU kernel of it to port, autograd goes through the plain
    version and nothing is counted in ``LAUNCHES``."""
    if _route(q) == "cpu" or q.shape[1] != k.shape[1]:
        fn = (_ref.flash_attention_chunked if q.shape[1] * k.shape[1] > _CHUNKED_THRESHOLD
              else _ref.flash_attention)
        return fn(q, k, v, segment_ids=segment_ids, causal=causal, window=window,
                  softmax_scale=softmax_scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        return _FlashAttention.apply(q, k, v, segment_ids, causal, window, softmax_scale)
    fwd = _meta.flash_attention if q.is_meta else flash_attention_cuda
    out = fwd(q, k, v, segment_ids, causal=causal, window=window, softmax_scale=softmax_scale)
    _launched(q, "flash_attention")
    return out


def decode_attention(q, k_cache, v_cache, cache_pos, t, *, window: int = 0,
                     softmax_scale: Optional[float] = None):
    """q: (B, H, hd); caches: (B, W, Hkv, hd); cache_pos: (B, W) int32
    (-1 = empty); t: (B,) int32."""
    if _route(q) == "cpu":
        return _ref.decode_attention(q, k_cache, v_cache, cache_pos, t, window=window,
                                     softmax_scale=softmax_scale)
    fn = _meta.decode_attention if q.is_meta else decode_attention_cuda
    out = fn(q, k_cache, v_cache, cache_pos, t, window=window, softmax_scale=softmax_scale)
    _launched(q, "decode_attention")
    return out


def paged_decode_attention(q, k_pool, v_pool, block_tables, t, *, window: int = 0,
                           softmax_scale: Optional[float] = None,
                           mean_empty_rows: bool = False):
    """q: (B, H, hd); pools: (N, bs, Hkv, hd); block_tables: (B, E) int32
    (-1 = unbound); t: (B,) int32.  ``mean_empty_rows``: see the module
    docstring."""
    if _route(q) == "cpu":
        return _ref.paged_decode_attention(q, k_pool, v_pool, block_tables, t, window=window,
                                           softmax_scale=softmax_scale)
    fn = _meta.paged_decode_attention if q.is_meta else paged_decode_attention_cuda
    out = fn(q, k_pool, v_pool, block_tables, t, window=window, softmax_scale=softmax_scale)
    _launched(q, "paged_decode_attention")
    if mean_empty_rows:
        empty = _empty_rows(block_tables, t[:, None], k_pool.shape[1], window)[:, 0]
        fill = _gathered_mean(v_pool, block_tables, q.shape[1], q.dtype)
        out = torch.where(empty[:, None, None], fill, out)
    return out


def fused_decode_tail(q, k_pool, v_pool, wo, block_tables, t, *, window: int = 0,
                      softmax_scale: Optional[float] = None, mean_empty_rows: bool = False):
    """Paged decode attention fused with the output projection: q (B, H,
    hd) against pools (N, bs, Hkv, hd) through block_tables (B, E),
    projected by wo (H*hd, D); returns (B, D).  ``mean_empty_rows``: see
    the module docstring (the mean contexts are projected by ``wo``)."""
    if _route(q) == "cpu":
        return _ref.fused_decode_tail(q, k_pool, v_pool, wo, block_tables, t, window=window,
                                      softmax_scale=softmax_scale)
    fn = _meta.fused_decode_tail if q.is_meta else fused_decode_tail_cuda
    out = fn(q, k_pool, v_pool, wo, block_tables, t, window=window, softmax_scale=softmax_scale)
    _launched(q, "fused_decode_tail")
    if mean_empty_rows:
        b, h, hd = q.shape
        empty = _empty_rows(block_tables, t[:, None], k_pool.shape[1], window)[:, 0]
        fill = torch.matmul(_gathered_mean(v_pool, block_tables, h, q.dtype).reshape(b, h * hd),
                            wo)
        out = torch.where(empty[:, None], fill, out)
    return out


def chunked_prefill_attention(q, k, v, key_pos, q_pos, *, window: int = 0,
                              softmax_scale: Optional[float] = None):
    """q: (B, C, H, hd) at absolute positions q_pos (B, C) (-1 = padded
    row); k, v: (B, S, Hkv, hd) at key_pos (B, S) (-1 = invalid).  The
    ring cache's chunked-prefill attention.  It has no kernel: on every
    device it is the plain version, as the reference keeps it on its jnp
    oracle on every backend (``repro/kernels/ops.py:185-197``), so there
    is no TPU kernel of it to port and nothing is counted in
    ``LAUNCHES``."""
    _route(q)
    return _ref.chunked_prefill_attention(q, k, v, key_pos, q_pos, window=window,
                                          softmax_scale=softmax_scale)


def paged_prefill_attention(q, k_pool, v_pool, block_tables, q_pos, *, window: int = 0,
                            softmax_scale: Optional[float] = None,
                            mean_empty_rows: bool = False):
    """q: (B, C, H, hd) at absolute positions q_pos (B, C) (-1 = padded
    row); pools: (N, bs, Hkv, hd); block_tables: (B, E) int32 (-1 =
    unbound).  The chunk's own K/V must already be in the pool.
    ``mean_empty_rows``: see the module docstring."""
    if _route(q) == "cpu":
        return _ref.paged_prefill_attention(q, k_pool, v_pool, block_tables, q_pos,
                                            window=window, softmax_scale=softmax_scale)
    fn = _meta.paged_prefill_attention if q.is_meta else paged_prefill_attention_cuda
    out = fn(q, k_pool, v_pool, block_tables, q_pos, window=window, softmax_scale=softmax_scale)
    _launched(q, "paged_prefill_attention")
    if mean_empty_rows:
        empty = _empty_rows(block_tables, q_pos, k_pool.shape[1], window)
        fill = _gathered_mean(v_pool, block_tables, q.shape[2], q.dtype)
        out = torch.where(empty[..., None, None], fill[:, None], out)
    return out


class _LinearScan(torch.autograd.Function):
    """The scan kernel, and its reverse-time kernel as its gradient."""

    @staticmethod
    def forward(ctx, a, x, h0):
        h, h_last = (_meta.linear_scan if x.is_meta else linear_scan_cuda)(a, x, h0)
        _launched(x, "linear_scan")
        ctx.save_for_backward(a, h, h0)
        return h, h_last

    @staticmethod
    def backward(ctx, g, g_last):
        a, h, h0 = ctx.saved_tensors
        bwd = _meta.linear_scan_bwd if g.is_meta else linear_scan_bwd_cuda
        da, dx, dh0 = bwd(a, h, h0, g.contiguous(), g_last)
        _launched(g, "linear_scan_bwd")
        return da, dx, None if dh0 is None else dh0.to(h0.dtype)


def linear_scan(a, x, h0=None):
    """h_t = a_t * h_{t-1} + x_t over a, x: (B, S, C) with h0: (B, C) or
    None; returns (h (B, S, C), h_last (B, C)) in x's dtype."""
    if _route(x) == "cpu":
        return _ref.linear_scan(a, x, h0)
    if torch.is_grad_enabled() and (a.requires_grad or x.requires_grad
                                    or (h0 is not None and h0.requires_grad)):
        return _LinearScan.apply(a.contiguous(), x.contiguous(), h0)
    out = (_meta.linear_scan if x.is_meta else linear_scan_cuda)(a, x, h0)
    _launched(x, "linear_scan")
    return out
