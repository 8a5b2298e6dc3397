"""Wrapper of the Hopper paged prefill attention kernel,
``csrc/paged_prefill_attention.cu``.

Replaces ``repro/kernels/paged_prefill_attention.py::paged_prefill_attention_pallas``.
One block per (64-row query tile, q head, slot) walks the key tiles up
to the tile's highest query position, loading each key row through the
slot's block table; the mask is positional per (query, key), so padded
rows (q_pos = -1) come out 0.  head_dim is 32, 64, 80 or 128.  Plain
version: ``repro_torch.kernels.ref.paged_prefill_attention``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import _DTYPE_CODES, _check
from repro_torch.kernels.paged_decode_attention import check_pool

HEAD_DIMS = (32, 64, 80, 128)
_FN = None


def _fn():
    global _FN
    if _FN is None:
        f = build.load("paged_prefill_attention").paged_prefill_attention_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [p] * 6 + [i] * 8 + [ctypes.c_float, i, p]
        f.restype = ctypes.c_int
        _FN = f
    return _FN


def paged_prefill_attention_cuda(q, k_pool, v_pool, block_tables, q_pos, *,
                                 window: int = 0, softmax_scale: Optional[float] = None):
    """q: (B, C, H, hd); pools: (N, bs, Hkv, hd); block_tables: (B, E)
    int32 (-1 = unbound); q_pos: (B, C) int32 (-1 = padded row).
    Launches on the current stream of q's device and returns (B, C, H,
    hd) in q's dtype; padded rows are 0."""
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill_attention_cuda needs CUDA tensors, got {q.device}")
    if q.dim() != 4:
        raise ValueError(f"q must be (B, C, H, hd), got {tuple(q.shape)}")
    b, c, h, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"unsupported head_dim {hd}; the kernel takes {HEAD_DIMS}")
    _, bs, hkv, _, e = check_pool(q, k_pool, v_pool, block_tables)
    if b == 0 or c == 0:
        return torch.empty_like(q)
    if h > 65535:
        raise ValueError("the head count must be at most 65535")
    _check("q", q, (b, c, h, hd), q.dtype, q.device)
    _check("q_pos", q_pos, (b, c), torch.int32, q.device)
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _fn()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                    block_tables.data_ptr(), q_pos.data_ptr(), out.data_ptr(),
                    b, c, e, bs, h, hkv, hd, _DTYPE_CODES[q.dtype], float(scale),
                    int(window or 0), torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_prefill_attention kernel launch failed with CUDA error {err}")
    return out
