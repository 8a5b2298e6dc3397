"""Wrapper of the Hopper paged decode attention kernel,
``csrc/paged_decode_attention.cu``.

Replaces ``repro/kernels/paged_decode_attention.py::paged_decode_attention_pallas``.
Flash-decoding over a block pool in one launch: each slot's positions
[0, E * bs) split into ``n_split`` runs of whole 16-key tiles
(``split_plan``, from the shapes alone); a (split, kv head, slot) block
reads the visible K/V rows of its run through the slot's block table and
writes partial f32 softmax state to scratch allocated here; the splits
of each (slot, kv head) then meet at a barrier
(``decode_attention.barrier_counts``), and each merges its share of the
output in split order.  A launch with more than one split is
cooperative.  In bf16 the products run on the tensor cores
(``mma.sync``), fed by a ``cp.async`` gather.  head_dim is at most 128
and a multiple of 8.  Plain version:
``repro_torch.kernels.ref.paged_decode_attention``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import (MAX_SPLIT, TILE, _n_sm, barrier_counts,
                                                  record_floats)
from repro_torch.kernels.flash_attention import _DTYPE_CODES, _check

MAX_GROUP = 16      # query heads per kv head: the 16 rows of the kernel's mma tiles
MAX_HD = 128
# the fewest tiles of a split where the plan has blocks to spare: one
# stage of the kernel's copy ring (64 keys), which its four warps take at
# once (the fused tail takes its own, fused_decode_tail.SPLIT_TILES)
SPLIT_TILES = 4
_FNS = None
# (dtype code, body width, device index) -> the most blocks a split launch may take
_CAPACITY: Dict[Tuple[int, int, int], int] = {}


def _fns():
    """(capacity, forward) entry points of the kernel's library."""
    global _FNS
    if _FNS is None:
        lib = build.load("paged_decode_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        cap, fwd = lib.paged_decode_attention_capacity, lib.paged_decode_attention_fwd
        cap.argtypes = [i, i, ctypes.POINTER(ctypes.c_int)]
        fwd.argtypes = [p] * 8 + [i] * 8 + [ctypes.c_float, i, p]
        cap.restype = fwd.restype = ctypes.c_int
        _FNS = cap, fwd
    return _FNS


def body_width(hd: int) -> int:
    """The head width the kernels' body is instantiated at for ``hd``:
    64 or 128; a narrower row is zero-padded in shared memory."""
    return 64 if hd <= 64 else 128


def split_plan(b: int, hkv: int, positions: int, n_sm: int, capacity: int,
               min_tiles: int = SPLIT_TILES) -> int:
    """n_split: the ways each (slot, kv head) splits its ceil(positions /
    TILE) key tiles.  As many splits as give each at least ``min_tiles``
    tiles, but no more than two blocks per SM of ``n_sm`` take, and a
    launch of more than one split within ``capacity`` (the blocks that
    can be resident at once).  From the shapes alone, so both dtypes split
    a call alike where the capacity allows."""
    tiles = -(-positions // TILE)
    want = min(tiles // min_tiles, -(-2 * n_sm // max(1, b * hkv)))
    return max(1, min(want, tiles, capacity // max(1, b * hkv), MAX_SPLIT))


def _capacity(code: int, hd: int, device) -> int:
    """The most blocks a launch of more than one split may take on
    ``device``, queried once and kept."""
    key = (code, body_width(hd), device.index)
    if key not in _CAPACITY:
        blocks = ctypes.c_int()
        with torch.cuda.device(device):
            err = _fns()[0](hd, code, ctypes.byref(blocks))
        if err:
            raise RuntimeError(f"paged_decode_attention occupancy query failed with CUDA "
                               f"error {err}")
        _CAPACITY[key] = blocks.value
    return _CAPACITY[key]


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


def plan_split(q, hkv: int, positions: int, n_split: Optional[int], capacity: int,
               name: str, min_tiles: int = SPLIT_TILES) -> int:
    """``n_split`` checked against the tiles and the resident grid, or
    ``split_plan``'s when it is None."""
    b = q.shape[0]
    tiles = -(-positions // TILE)
    if n_split is None:
        return split_plan(b, hkv, positions, _n_sm(q.device), capacity, min_tiles)
    if not 1 <= n_split <= min(tiles, MAX_SPLIT):
        raise ValueError(f"{name}: n_split must be in [1, {min(tiles, MAX_SPLIT)}], "
                         f"got {n_split}")
    if n_split > 1 and b * hkv * n_split > capacity:
        raise ValueError(f"{name}: {b * hkv * n_split} blocks exceed the {capacity} that can "
                         f"be resident")
    return n_split


def paged_decode_attention_cuda(q, k_pool, v_pool, block_tables, t, *, window: int = 0,
                                softmax_scale: Optional[float] = None):
    """q: (B, H, hd); pools: (N, bs, Hkv, hd); block_tables: (B, E) int32
    (-1 = unbound); t: (B,) int32.  Launches one kernel on the current
    stream of q's device and returns (B, H, hd) in q's dtype."""
    return paged_decode_attention_split(q, k_pool, v_pool, block_tables, t, None,
                                        window=window, softmax_scale=softmax_scale)


def paged_decode_attention_split(q, k_pool, v_pool, block_tables, t, n_split: Optional[int],
                                 *, window: int = 0, softmax_scale: Optional[float] = None):
    """``paged_decode_attention_cuda`` with its split plan forced to
    ``n_split`` (1 to ceil(E * bs / TILE), and B x Hkv x n_split within the
    resident grid); None takes ``split_plan``'s."""
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention_cuda needs CUDA tensors, got {q.device}")
    if q.dim() != 3:
        raise ValueError(f"q must be (B, H, hd), got {tuple(q.shape)}")
    b, h, hd = q.shape
    _, bs, hkv, _, e = check_pool(q, k_pool, v_pool, block_tables)
    if b == 0:
        return torch.empty_like(q)
    if e == 0:
        raise ValueError("the block tables have no entries")
    _check("q", q, (b, h, hd), q.dtype, q.device)
    _check("t", t, (b,), torch.int32, q.device)
    code = _DTYPE_CODES[q.dtype]
    n_split = plan_split(q, hkv, e * bs, n_split, _capacity(code, hd, q.device),
                         "paged_decode_attention")
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    out = torch.empty_like(q)
    part = counts = None
    if n_split > 1:
        part = torch.empty(b * hkv * n_split * record_floats(h // hkv, body_width(hd)),
                           dtype=torch.float32, device=q.device)
        counts = barrier_counts(n_split, b * hkv, q.device)
    ptr = lambda x: 0 if x is None else x.data_ptr()
    with torch.cuda.device(q.device):
        err = _fns()[1](q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                        block_tables.data_ptr(), t.data_ptr(), ptr(part), ptr(counts),
                        out.data_ptr(), b, e, bs, h, hkv, hd, code, n_split, float(scale),
                        int(window or 0), torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_decode_attention kernel launch failed with CUDA error {err}")
    return out
