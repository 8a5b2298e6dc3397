"""Wrapper of the Hopper fused decode tail kernel, ``csrc/fused_decode_tail.cu``.

Replaces ``repro/kernels/fused_decode_tail.py::fused_decode_tail_pallas``.
One cooperative launch in two phases: blocks first write each slot's
per-split partial softmax state through the block table to scratch
allocated here, then, past a grid-wide barrier, merge a slot's splits
into its head contexts in shared memory and multiply them by a slice of
``wo``; the (B, H, hd) contexts never reach global memory.  head_dim is
at most 128 and a multiple of 8, H at most 64, H * hd at most 8192, D a
multiple of 8 (bf16) or 4 (f32) elements.  Plain version:
``repro_torch.kernels.ref.fused_decode_tail``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import _DTYPE_CODES, _check
from repro_torch.kernels.paged_decode_attention import check_pool

MAX_HEADS = 64
MAX_CONTEXT = 8192      # H * hd f32 contexts held in shared memory
MAX_ROWS = 64           # key positions per split, staged whole
_FNS = None
_GRID = {}              # (dtype code, H, Hkv, hd, device index) -> resident grid


def _fns():
    global _FNS
    if _FNS is None:
        lib = build.load("fused_decode_tail")
        p, i = ctypes.c_void_p, ctypes.c_int
        grid = lib.fused_decode_tail_grid
        grid.argtypes = [i] * 4 + [ctypes.POINTER(ctypes.c_int)]
        grid.restype = ctypes.c_int
        fwd = lib.fused_decode_tail_fwd
        fwd.argtypes = [p] * 10 + [i] * 11 + [ctypes.c_float, i, p]
        fwd.restype = ctypes.c_int
        _FNS = grid, fwd
    return _FNS


def split_rows(b: int, positions: int, n_sm: int) -> Tuple[int, int]:
    """(rows, n_split): key positions per split, at most MAX_ROWS, such
    that the b x n_split split items about fill two blocks per SM.  It
    depends on the shapes alone, so both dtypes split a call alike."""
    want = -(-2 * n_sm // max(1, b))
    rows = max(1, min(MAX_ROWS, -(-positions // want)))
    return rows, -(-positions // rows)


def _resident_grid(code: int, h: int, hkv: int, hd: int, device) -> int:
    """The most blocks one cooperative launch may take for these widths
    on ``device``, queried once and kept."""
    key = (code, h, hkv, hd, device.index)
    if key not in _GRID:
        grid = ctypes.c_int()
        err = _fns()[0](h, hkv, hd, code, ctypes.byref(grid))
        if err:
            raise RuntimeError(f"fused_decode_tail occupancy query failed with CUDA error {err}")
        _GRID[key] = grid.value
    return _GRID[key]


def fused_decode_tail_cuda(q, k_pool, v_pool, wo, block_tables, t, *, window: int = 0,
                           softmax_scale: Optional[float] = None):
    """q: (B, H, hd); pools: (N, bs, Hkv, hd); wo: (H*hd, D); block_tables:
    (B, E) int32 (-1 = unbound); t: (B,) int32.  Launches one kernel on
    the current stream of q's device and returns (B, D) in q's dtype."""
    if q.device.type != "cuda":
        raise ValueError(f"fused_decode_tail_cuda needs CUDA tensors, got {q.device}")
    if q.dim() != 3 or wo.dim() != 2:
        raise ValueError(f"q must be (B, H, hd) and wo (H*hd, D), got {tuple(q.shape)} "
                         f"and {tuple(wo.shape)}")
    b, h, hd = q.shape
    _, bs, hkv, _, e = check_pool(q, k_pool, v_pool, block_tables)
    if h > MAX_HEADS or h * hd > MAX_CONTEXT:
        raise ValueError(f"H = {h}, H * hd = {h * hd}: the kernel takes at most {MAX_HEADS} "
                         f"heads and {MAX_CONTEXT} context values, held in shared memory")
    d = wo.shape[1]
    if d % (16 // q.element_size()):
        raise ValueError(f"D = {d} is not a multiple of 16 bytes of {q.dtype}: the kernel "
                         f"reads wo in 16-byte pieces")
    if b == 0 or d == 0:
        return torch.empty((b, d), dtype=q.dtype, device=q.device)
    if e == 0:
        raise ValueError("the block tables have no entries")
    _check("q", q, (b, h, hd), q.dtype, q.device)
    _check("wo", wo, (h * hd, d), q.dtype, q.device)
    _check("t", t, (b,), torch.int32, q.device)
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    rows, _ = split_rows(b, e * bs, n_sm)
    with torch.cuda.device(q.device):
        grid = _resident_grid(_DTYPE_CODES[q.dtype], h, hkv, hd, q.device)
    return _launch(q, k_pool, v_pool, wo, block_tables, t, window, scale, rows, grid)


def _launch(q, k_pool, v_pool, wo, block_tables, t, window, scale, rows: int, grid: int):
    """One launch of the kernel on checked inputs, with splits of ``rows``
    key positions and ``grid`` blocks (at most the resident grid)."""
    b, h, hd = q.shape
    _, bs, hkv, _ = k_pool.shape
    e, d = block_tables.shape[1], wo.shape[1]
    n_split = -(-e * bs // rows)
    # scratch, one allocation: part_acc (B, n_split, H, hd) first, 16-byte
    # aligned for the merge's float4 loads, then part_m, part_l (B,
    # n_split, H), all f32
    n_part = b * n_split * h
    scratch = torch.empty(n_part * (hd + 2), dtype=torch.float32, device=q.device)
    part_acc = scratch[:n_part * hd]
    part_m, part_l = scratch[n_part * hd:n_part * (hd + 1)], scratch[n_part * (hd + 1):]
    out = torch.empty((b, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = _fns()[1](q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), wo.data_ptr(),
                        block_tables.data_ptr(), t.data_ptr(), part_m.data_ptr(),
                        part_l.data_ptr(), part_acc.data_ptr(), out.data_ptr(), b, e, bs, h,
                        hkv, hd, d, _DTYPE_CODES[q.dtype], n_split, rows, grid, float(scale),
                        int(window or 0), torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_decode_tail kernel launch failed with CUDA error {err}")
    return out
