"""Wrapper of the Hopper paged decode attention kernel,
``csrc/paged_decode_attention.cu``.

Replaces ``repro/kernels/paged_decode_attention.py::paged_decode_attention_pallas``.
Flash-decoding over a block pool: the grid of (entry split, kv head,
slot) blocks holds about two blocks per SM; each split reads the K/V
rows of its run of table entries through the slot's block table, writes
partial f32 softmax state to scratch allocated here, and a second
kernel merges the splits.  head_dim is at most 128 and a multiple of 8;
a block holds at most 64 positions.  Plain version:
``repro_torch.kernels.ref.paged_decode_attention``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import _DTYPE_CODES, _check

MAX_GROUP = 16      # query heads per kv head the kernel keeps in registers
MAX_ROWS = 64       # key rows per split (staged whole in shared memory)
MAX_HD = 128
_FN = None


def _fn():
    global _FN
    if _FN is None:
        f = build.load("paged_decode_attention").paged_decode_attention_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [p] * 9 + [i] * 9 + [ctypes.c_float, i, p]
        f.restype = ctypes.c_int
        _FN = f
    return _FN


def split_plan(b: int, hkv: int, entries: int, bs: int, n_sm: int) -> Tuple[int, int]:
    """(entries per split, n_split): enough splits for ~2 blocks per SM,
    no split longer than MAX_ROWS positions."""
    want = -(-2 * n_sm // max(1, b * hkv))
    eps = max(1, min(MAX_ROWS // bs, -(-entries // want)))
    return eps, -(-entries // eps)


def check_pool(q, k_pool, v_pool, block_tables):
    """Validate a paged call's q (B, ..., H, hd), pools (N, bs, Hkv, hd)
    and tables (B, E) int32; returns (N, bs, Hkv, hd, E)."""
    if k_pool.dim() != 4 or block_tables.dim() != 2:
        raise ValueError(f"pools must be (N, bs, Hkv, hd) and tables (B, E), got "
                         f"{tuple(k_pool.shape)} and {tuple(block_tables.shape)}")
    n, bs, hkv, hd = k_pool.shape
    h = q.shape[-2]
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {q.dtype}; the kernel takes float32 or bfloat16")
    if q.shape[-1] != hd or hd > MAX_HD or hd % 8:
        raise ValueError(f"unsupported head_dim {q.shape[-1]} (pool {hd}); the kernel takes a "
                         f"multiple of 8 up to {MAX_HD}")
    if hkv == 0 or h % hkv or h // hkv > MAX_GROUP:
        raise ValueError(f"{h} query heads over {hkv} kv heads: need a whole group "
                         f"of at most {MAX_GROUP}")
    if n == 0 or bs == 0:
        raise ValueError("the pool has no blocks")
    if q.shape[0] > 65535 or hkv > 65535:
        raise ValueError("batch and kv head counts must be at most 65535")
    _check("k_pool", k_pool, (n, bs, hkv, hd), q.dtype, q.device)
    _check("v_pool", v_pool, (n, bs, hkv, hd), q.dtype, q.device)
    _check("block_tables", block_tables, (q.shape[0], block_tables.shape[1]), torch.int32,
           q.device)
    return n, bs, hkv, hd, block_tables.shape[1]


def paged_decode_attention_cuda(q, k_pool, v_pool, block_tables, t, *, window: int = 0,
                                softmax_scale: Optional[float] = None):
    """q: (B, H, hd); pools: (N, bs, Hkv, hd); block_tables: (B, E) int32
    (-1 = unbound); t: (B,) int32.  Launches on the current stream of q's
    device and returns (B, H, hd) in q's dtype."""
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention_cuda needs CUDA tensors, got {q.device}")
    if q.dim() != 3:
        raise ValueError(f"q must be (B, H, hd), got {tuple(q.shape)}")
    b, h, hd = q.shape
    _, bs, hkv, _, e = check_pool(q, k_pool, v_pool, block_tables)
    if bs > MAX_ROWS:
        raise ValueError(f"block size {bs} over {MAX_ROWS}: a split stages whole blocks")
    if b == 0:
        return torch.empty_like(q)
    if e == 0:
        raise ValueError("the block tables have no entries")
    _check("q", q, (b, h, hd), q.dtype, q.device)
    _check("t", t, (b,), torch.int32, q.device)
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    eps, n_split = split_plan(b, hkv, e, bs, n_sm)
    # scratch, one allocation: part_m, part_l (B, n_split, H) and part_acc
    # (B, n_split, H, hd), all f32
    n_part = b * n_split * h
    scratch = torch.empty(n_part * (2 + hd), dtype=torch.float32, device=q.device)
    part_m, part_l, part_acc = scratch[:n_part], scratch[n_part:2 * n_part], scratch[2 * n_part:]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _fn()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                    block_tables.data_ptr(), t.data_ptr(), part_m.data_ptr(),
                    part_l.data_ptr(), part_acc.data_ptr(), out.data_ptr(),
                    b, e, bs, h, hkv, hd, _DTYPE_CODES[q.dtype], eps, n_split,
                    float(scale), int(window or 0),
                    torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_decode_attention kernel launch failed with CUDA error {err}")
    return out
