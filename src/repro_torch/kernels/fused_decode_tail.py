"""Wrapper of the Hopper fused decode tail kernel, ``csrc/fused_decode_tail.cu``.

Replaces ``repro/kernels/fused_decode_tail.py::fused_decode_tail_pallas``.
One cooperative launch in three steps: the paged decode body over
(slot, kv head, split) items (``paged_decode_attention.split_plan``, with
splits of at least SPLIT_TILES tiles); the splits' merge into each
slot's head contexts, rounded to q's dtype, in a (B, H * hd) scratch
allocated here; and, past a grid-wide barrier, the projection of all
slots' contexts by 8-column tiles of ``wo``, each block's first tile
requested into shared memory before the first step.  head_dim is at most
256 and a multiple of 8 (the RG-LRU hybrid's local attention is 256, a
group of 16), H at most 64, H * hd at most 8192, D a multiple of 8 (bf16)
or 4 (f32) elements.  ``prepare`` checks and plans a call on any
device: the CUDA launch and the dry run's meta route
(``kernels/meta.py``) both take it.  Plain version:
``repro_torch.kernels.ref.fused_decode_tail``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import (UNBOUNDED, barrier_counts, body_width,
                                                  record_floats)
from repro_torch.kernels.flash_attention import _DTYPE_CODES, _check
from repro_torch.kernels.paged_decode_attention import check_pool, plan_split

MAX_HD = 256
MAX_HEADS = 64
MAX_CONTEXT = 8192      # H * hd: a slot's contexts
TN = 8                  # output columns of a projection tile
# the fewest tiles of a split where the plan has blocks to spare: shorter
# splits than paged decode's reach the grid barrier sooner (the sweep of
# tools/fused_tail_breakdown.py, PERF.md)
SPLIT_TILES = 3
_FNS = None
# (dtype code, H, Hkv, hd, device index) -> the most blocks a launch may take
_CAPACITY: Dict[Tuple[int, int, int, int, int], int] = {}


def _fns():
    """(capacity, forward) entry points of the kernel's library."""
    global _FNS
    if _FNS is None:
        lib = build.load("fused_decode_tail")
        p, i = ctypes.c_void_p, ctypes.c_int
        cap, fwd = lib.fused_decode_tail_capacity, lib.fused_decode_tail_fwd
        cap.argtypes = [i] * 4 + [ctypes.POINTER(ctypes.c_int)]
        fwd.argtypes = [p] * 11 + [i] * 10 + [ctypes.c_float, i, p]
        cap.restype = fwd.restype = ctypes.c_int
        _FNS = cap, fwd
    return _FNS


def _capacity(code: int, h: int, hkv: int, hd: int, device) -> int:
    """The most blocks one cooperative launch may take for these widths
    on ``device``, queried once and kept."""
    if device.type == "meta":
        return UNBOUNDED
    key = (code, h, hkv, hd, device.index)
    if key not in _CAPACITY:
        blocks = ctypes.c_int()
        with torch.cuda.device(device):
            err = _fns()[0](h, hkv, hd, code, ctypes.byref(blocks))
        if err:
            raise RuntimeError(f"fused_decode_tail occupancy query failed with CUDA error {err}")
        _CAPACITY[key] = blocks.value
    return _CAPACITY[key]


def launch_grid(b: int, hkv: int, n_split: int, d: int, capacity: int) -> int:
    """Blocks of a launch: one per split item and one per projection tile
    where the resident grid allows (a block's first tile is requested at
    its start), never fewer than the split items of a split plan."""
    return max(1, min(capacity, max(b * hkv * n_split, -(-d // TN))))


def fused_decode_tail_cuda(q, k_pool, v_pool, wo, block_tables, t, *, window: int = 0,
                           softmax_scale: Optional[float] = None):
    """q: (B, H, hd); pools: (N, bs, Hkv, hd); wo: (H*hd, D); block_tables:
    (B, E) int32 (-1 = unbound); t: (B,) int32.  Launches one kernel on
    the current stream of q's device and returns (B, D) in q's dtype."""
    return fused_decode_tail_split(q, k_pool, v_pool, wo, block_tables, t, None, window=window,
                                   softmax_scale=softmax_scale)


def prepare(q, k_pool, v_pool, wo, block_tables, t, n_split: Optional[int] = None,
            softmax_scale: Optional[float] = None):
    """Check a call and plan it on q's device: returns the output and,
    unless B or D is 0, (n_split, grid, scale, records' floats, scratch),
    all allocated on that device.  The scratch is one allocation: the
    splits' records (f32, none with one split), then the contexts (B, H *
    hd) in q's dtype, 16-byte aligned."""
    if q.dim() != 3 or wo.dim() != 2:
        raise ValueError(f"q must be (B, H, hd) and wo (H*hd, D), got {tuple(q.shape)} "
                         f"and {tuple(wo.shape)}")
    b, h, hd = q.shape
    _, bs, hkv, _, e = check_pool(q, k_pool, v_pool, block_tables, max_hd=MAX_HD)
    if h > MAX_HEADS or h * hd > MAX_CONTEXT:
        raise ValueError(f"H = {h}, H * hd = {h * hd}: the kernel takes at most {MAX_HEADS} "
                         f"heads and {MAX_CONTEXT} context values")
    d = wo.shape[1]
    if d % (16 // q.element_size()):
        raise ValueError(f"D = {d} is not a multiple of 16 bytes of {q.dtype}: the kernel "
                         f"reads wo in 16-byte pieces")
    if b == 0 or d == 0:
        return torch.empty((b, d), dtype=q.dtype, device=q.device), None
    if e == 0:
        raise ValueError("the block tables have no entries")
    _check("q", q, (b, h, hd), q.dtype, q.device)
    _check("wo", wo, (h * hd, d), q.dtype, q.device)
    _check("t", t, (b,), torch.int32, q.device)
    if wo.data_ptr() % 16:
        raise ValueError("wo must start on a 16-byte boundary")
    cap = _capacity(_DTYPE_CODES[q.dtype], h, hkv, hd, q.device)
    n_split = plan_split(q, hkv, e * bs, n_split, cap, "fused_decode_tail", SPLIT_TILES)
    grid = launch_grid(b, hkv, n_split, d, cap)
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    n_rec = b * hkv * n_split * record_floats(h // hkv, body_width(hd)) if n_split > 1 else 0
    n_ctx = -(-b * h * hd * q.element_size() // 16) * 4
    scratch = torch.empty(n_rec + n_ctx, dtype=torch.float32, device=q.device)
    out = torch.empty((b, d), dtype=q.dtype, device=q.device)
    return out, (n_split, grid, scale, n_rec, scratch)


def fused_decode_tail_split(q, k_pool, v_pool, wo, block_tables, t, n_split: Optional[int], *,
                            window: int = 0, softmax_scale: Optional[float] = None):
    """``fused_decode_tail_cuda`` with its split plan forced to ``n_split``
    (1 to ceil(E * bs / 16), and B x Hkv x n_split within the resident
    grid); None takes ``paged_decode_attention.split_plan``'s with
    SPLIT_TILES."""
    if q.device.type != "cuda":
        raise ValueError(f"fused_decode_tail_cuda needs CUDA tensors, got {q.device}")
    out, plan = prepare(q, k_pool, v_pool, wo, block_tables, t, n_split, softmax_scale)
    if plan is None:
        return out
    n_split, grid, scale, n_rec, scratch = plan
    b, h, hd = q.shape
    _, bs, hkv, _ = k_pool.shape
    e, d = block_tables.shape[1], wo.shape[1]
    # the grid barrier's count at b * hkv, past the split barriers' counts
    # (which share its tensor when n_split == grid)
    grid_count = barrier_counts(grid, b * hkv + 1, q.device)[b * hkv:]
    counts = barrier_counts(n_split, b * hkv, q.device)
    with torch.cuda.device(q.device):
        err = _fns()[1](q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), wo.data_ptr(),
                        block_tables.data_ptr(), t.data_ptr(), scratch.data_ptr(),
                        scratch.data_ptr() + 4 * n_rec, counts.data_ptr(),
                        grid_count.data_ptr(), out.data_ptr(),
                        b, e, bs, h, hkv, hd, d, _DTYPE_CODES[q.dtype], n_split, grid,
                        float(scale), int(window or 0),
                        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_decode_tail kernel launch failed with CUDA error {err}")
    return out
