"""Wrapper of the Hopper paged prefill attention kernel,
``csrc/paged_prefill_attention.cu``.

Replaces ``repro/kernels/paged_prefill_attention.py::paged_prefill_attention_pallas``.
In bf16, blocks of ``BLOCK_Q`` query rows run the wgmma mainloop of
``csrc/attention_fwd.cuh`` over the key tiles their rows can see, gathered
through the slot's block table; the keys are split ``n_split`` ways
(``split_plan``) and the splits' partial softmax states merged in a fixed
order by the last block of each (q tile, head).  f32 takes one pass per
64-row tile.  The mask is positional per (query, key), so padded rows
(q_pos = -1) come out 0.  head_dim is 32, 64, 80 or 128.  Plain version:
``repro_torch.kernels.ref.paged_prefill_attention``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import _DTYPE_CODES, _check
from repro_torch.kernels.paged_decode_attention import check_pool

HEAD_DIMS = (32, 64, 80, 128)
BLOCK_Q = 128           # query rows per block of the bf16 kernel
BLOCK_K = 64            # keys per tile
_FN = None
# device index -> the merge's counters, one per (slot, head, q tile), all
# 0 between calls.  Calls on a device run one after another on its current
# stream, as the engines make them; two calls in flight at once on two
# streams would share these counters.
_COUNTERS: Dict[int, torch.Tensor] = {}


def _fn():
    global _FN
    if _FN is None:
        f = build.load("paged_prefill_attention").paged_prefill_attention_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [p] * 9 + [i] * 10 + [ctypes.c_float, i, p]
        f.restype = ctypes.c_int
        _FN = f
    return _FN


def split_plan(b: int, c: int, h: int, e: int, bs: int, n_sm: int) -> int:
    """n_split: the ways each (q tile, head) splits its key tiles, from
    the shapes alone, so that the b x q tiles x h x n_split blocks about
    fill ``n_sm`` SMs; at most the key tiles the table can hold.  A q tile
    that sees fewer tiles uses as many splits as it sees
    (``split_ranges``)."""
    n_qt = -(-c // BLOCK_Q)
    max_tiles = max(1, -(-e * bs // BLOCK_K))
    want = -(-n_sm // max(1, b * n_qt * h))
    return max(1, min(max_tiles, want))


def visible_tiles(qmin: int, qmax: int, window: int, e: int, bs: int) -> Tuple[int, int]:
    """[begin, end) of the key tiles that hold a key some query at a
    position in [qmin, qmax] can see (qmax < 0: none), as the kernel
    computes it."""
    if qmax < 0:
        return 0, 0
    end = min(qmax // BLOCK_K + 1, -(-e * bs // BLOCK_K))
    begin = (qmin - window + 1) // BLOCK_K if window > 0 and qmin - window + 1 > 0 else 0
    return begin, max(begin, end)


def split_ranges(begin: int, end: int, n_split: int) -> List[Tuple[int, int]]:
    """The key tiles [lo, hi) of each split that a q tile seeing tiles
    [begin, end) uses, as the kernel divides them: min(n_split, visible)
    splits (at least one), sizes differing by at most one."""
    n_vis = end - begin
    n_eff = max(1, min(n_split, n_vis))
    return [(begin + s * n_vis // n_eff, begin + (s + 1) * n_vis // n_eff)
            for s in range(n_eff)]


def _counters(n: int, device) -> torch.Tensor:
    """n merge counters, zero; the kernel leaves them zero."""
    have = _COUNTERS.get(device.index)
    if have is None or have.numel() < n:
        have = _COUNTERS[device.index] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                                     device=device)
    return have


def paged_prefill_attention_cuda(q, k_pool, v_pool, block_tables, q_pos, *,
                                 window: int = 0, softmax_scale: Optional[float] = None,
                                 n_split: Optional[int] = None):
    """q: (B, C, H, hd); pools: (N, bs, Hkv, hd); block_tables: (B, E)
    int32 (-1 = unbound); q_pos: (B, C) int32 (-1 = padded row).
    Launches on the current stream of q's device and returns (B, C, H,
    hd) in q's dtype; padded rows are 0.  ``n_split`` forces a split plan
    (bf16 only); by default ``split_plan`` picks it."""
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
    if h > 65535 or b > 65535:
        raise ValueError("the head and slot counts must be at most 65535")
    _check("q", q, (b, c, h, hd), q.dtype, q.device)
    _check("q_pos", q_pos, (b, c), torch.int32, q.device)
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    n_qt = -(-c // BLOCK_Q)
    if q.dtype == torch.float32:
        if n_split not in (None, 1):
            raise ValueError("the f32 kernel does not split the keys: n_split must be 1")
        n_split = 1
    elif n_split is None:
        n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
        n_split = split_plan(b, c, h, e, bs, n_sm)
    elif n_split < 1:
        raise ValueError(f"n_split must be at least 1, got {n_split}")
    if n_qt * n_split > 65535:
        raise ValueError("q tiles x n_split must be at most 65535")
    out = torch.empty_like(q)
    part_ml = part_acc = counters = None
    if n_split > 1:
        n_part = b * h * n_qt * n_split * BLOCK_Q
        scratch = torch.empty(n_part * (2 + hd), dtype=torch.float32, device=q.device)
        part_ml, part_acc = scratch[:2 * n_part], scratch[2 * n_part:]
        counters = _counters(b * h * n_qt, q.device)
    ptr = lambda x: 0 if x is None else x.data_ptr()
    with torch.cuda.device(q.device):
        err = _fn()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                    block_tables.data_ptr(), q_pos.data_ptr(), out.data_ptr(), ptr(part_ml),
                    ptr(part_acc), ptr(counters), b, c, e, bs, h, hkv, hd,
                    _DTYPE_CODES[q.dtype], n_split, BLOCK_Q, float(scale), int(window or 0),
                    torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_prefill_attention kernel launch failed with CUDA error {err}")
    return out
