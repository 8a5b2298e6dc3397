"""Wrapper of the Hopper decode attention kernel, ``csrc/decode_attention.cu``.

Replaces ``repro/kernels/decode_attention.py::decode_attention_pallas``.
Flash-decoding: the cache is split so that the grid of (split, kv head,
slot) blocks holds about two blocks per SM; each split writes partial
f32 softmax state to scratch allocated here, and a second kernel merges
the splits.  W is any length and head_dim is 64, 128 or 256.  Plain version:
``repro_torch.kernels.ref.decode_attention``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import HEAD_DIMS, _DTYPE_CODES, _check

MAX_GROUP = 16      # query heads per kv head the kernel keeps in registers
MAX_CHUNK = 64      # cache entries per split (staged whole in shared memory)
MIN_CHUNK = 16
_FN = None


def _fn():
    global _FN
    if _FN is None:
        f = build.load("decode_attention").decode_attention_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [p] * 9 + [i] * 8 + [ctypes.c_float, i, p]
        f.restype = ctypes.c_int
        _FN = f
    return _FN


def split_plan(b: int, hkv: int, w: int, n_sm: int) -> Tuple[int, int]:
    """(chunk, n_split): enough splits for ~2 blocks per SM, no split
    shorter than MIN_CHUNK entries or longer than MAX_CHUNK."""
    want = -(-2 * n_sm // max(1, b * hkv))
    n_split = max(1, min(want, -(-w // MIN_CHUNK)))
    chunk = min(-(-w // n_split), MAX_CHUNK)
    return chunk, -(-w // chunk)


def decode_attention_cuda(q, k_cache, v_cache, cache_pos, t, *, window: int = 0,
                          softmax_scale: Optional[float] = None):
    """q: (B, H, hd); caches: (B, W, Hkv, hd); cache_pos: (B, W) int32;
    t: (B,) int32.  Launches on the current stream of q's device and
    returns (B, H, hd) in q's dtype."""
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_cuda needs CUDA tensors, got {q.device}")
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"q must be (B, H, hd) and caches (B, W, Hkv, hd), got "
                         f"{tuple(q.shape)} and {tuple(k_cache.shape)}")
    b, h, hd = q.shape
    w, hkv = k_cache.shape[1], k_cache.shape[2]
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {q.dtype}; the kernel takes float32 or bfloat16")
    if hd not in HEAD_DIMS:
        raise ValueError(f"unsupported head_dim {hd}; the kernel takes {HEAD_DIMS}")
    if hkv == 0 or h % hkv or h // hkv > MAX_GROUP:
        raise ValueError(f"{h} query heads over {hkv} kv heads: need a whole group "
                         f"of at most {MAX_GROUP}")
    if b == 0:
        return torch.empty_like(q)
    if w == 0:
        raise ValueError("the cache has no entries")
    if b > 65535 or hkv > 65535:
        raise ValueError("batch and kv head counts must be at most 65535")
    _check("q", q, (b, h, hd), q.dtype, q.device)
    _check("k_cache", k_cache, (b, w, hkv, hd), q.dtype, q.device)
    _check("v_cache", v_cache, (b, w, hkv, hd), q.dtype, q.device)
    _check("cache_pos", cache_pos, (b, w), torch.int32, q.device)
    _check("t", t, (b,), torch.int32, q.device)
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    chunk, n_split = split_plan(b, hkv, w, n_sm)
    # scratch, one allocation: part_m, part_l (B, Hkv, n_split, group) and
    # part_acc (B, Hkv, n_split, group, hd), all f32
    n_part = b * hkv * n_split * (h // hkv)
    scratch = torch.empty(n_part * (2 + hd), dtype=torch.float32, device=q.device)
    part_m, part_l, part_acc = scratch[:n_part], scratch[n_part:2 * n_part], scratch[2 * n_part:]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _fn()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                    cache_pos.data_ptr(), t.data_ptr(), part_m.data_ptr(),
                    part_l.data_ptr(), part_acc.data_ptr(), out.data_ptr(),
                    b, w, h, hkv, hd, _DTYPE_CODES[q.dtype], chunk, n_split,
                    float(scale), int(window or 0),
                    torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed with CUDA error {err}")
    return out
