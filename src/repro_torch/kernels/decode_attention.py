"""Wrapper of the Hopper decode attention kernel, ``csrc/decode_attention.cu``.

Replaces ``repro/kernels/decode_attention.py::decode_attention_pallas``.
Flash-decoding in one launch: the cache's 16-key tiles are split
``n_split`` ways (``split_plan``, from the shapes alone) so that the grid
of (split, kv head, slot) blocks holds at least two blocks per SM where
the resident grid allows; each split writes partial f32 softmax state to
scratch allocated here, then the splits of each (slot, kv head) meet at
a barrier (``barrier_counts``), and each merges its share of the output
in split order.  A launch with more than one split is cooperative.  In
bf16 the products run on the tensor cores (``mma.sync``), fed by a
``cp.async`` ring.  W is any length and head_dim a multiple of 8 up to
256: the body is built at 64, 128 and 256 and zero-pads a narrower row
in shared memory.  ``prepare`` checks and plans a call on any device:
the CUDA launch and the dry run's meta route (``kernels/meta.py``) both
take it.  Plain version: ``repro_torch.kernels.ref.decode_attention``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import _DTYPE_CODES, _check, kv_rows

MAX_HD = 256
MAX_GROUP = 16      # query heads per kv head: the 16 rows of the kernel's mma tiles
TILE = 16           # keys per tile; a split is a whole number of tiles
MAX_SPLIT = 512     # splits of a (slot, kv head), as the kernel bounds them
# the meta device (the dry run) plans for the H100 SXM's SMs and bounds no
# split launch by the resident grid: its scratch is then an upper bound
META_SMS = 132
UNBOUNDED = 1 << 30
_FNS = None
# device index -> SM count; (dtype code, head_dim, device index) -> the
# most blocks a split launch may take; each queried once
_N_SM: Dict[int, int] = {}
_CAPACITY: Dict[Tuple[int, int, int], int] = {}
# (device index, n) -> 64-bit counts for barriers of n blocks (the splits of
# a (slot, kv head), or a whole grid): every launch that uses a count
# advances it by exactly n, so a launch rounds it down to its base and
# nothing resets it.  Calls on a device run one after another on its
# current stream, as the engines make them; two calls in flight at once
# on two streams would share these counts.
_COUNTS: Dict[Tuple[int, int], torch.Tensor] = {}


def _fns():
    """(capacity, forward) entry points of the kernel's library."""
    global _FNS
    if _FNS is None:
        lib = build.load("decode_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        cap, fwd = lib.decode_attention_capacity, lib.decode_attention_fwd
        cap.argtypes = [i, i, ctypes.POINTER(ctypes.c_int)]
        fwd.argtypes = [p] * 8 + [i] * 8 + [ctypes.c_float, i, p]
        cap.restype = fwd.restype = ctypes.c_int
        _FNS = cap, fwd
    return _FNS


def split_plan(b: int, hkv: int, w: int, n_sm: int, capacity: int) -> int:
    """n_split: the ways each (slot, kv head) splits its ceil(W / TILE)
    key tiles, so that the b x hkv x n_split blocks hold at least two per
    SM of ``n_sm``, within ``capacity`` (the blocks that can be resident
    at once), and no split is empty."""
    want = -(-2 * n_sm // max(1, b * hkv))
    return max(1, min(-(-w // TILE), want, capacity // max(1, b * hkv), MAX_SPLIT))


def split_ranges(w: int, n_split: int) -> List[Tuple[int, int]]:
    """The keys [lo, hi) of each split, as the kernel divides them: whole
    tiles, sizes differing by at most one tile, the last ending at W."""
    nt = -(-w // TILE)
    return [(s * nt // n_split * TILE, min(w, (s + 1) * nt // n_split * TILE))
            for s in range(n_split)]


def body_width(hd: int) -> int:
    """The head width the kernels' body is instantiated at for ``hd``:
    64, 128 or 256; a narrower row is zero-padded in shared memory."""
    return 64 if hd <= 64 else 128 if hd <= 128 else 256


def record_floats(group: int, hd: int) -> int:
    """f32 words of one split's partial state in the scratch: acc (group
    x hd), then m and l (group each), padded to 16 bytes."""
    return group * hd + -(-2 * group // 4) * 4


def _n_sm(device) -> int:
    if device.type == "meta":
        return META_SMS
    n = _N_SM.get(device.index)
    if n is None:
        n = _N_SM[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return n


def _capacity(code: int, hd: int, device) -> int:
    """The most blocks a launch of more than one split may take on
    ``device``, queried once and kept."""
    if device.type == "meta":
        return UNBOUNDED
    key = (code, body_width(hd), device.index)
    if key not in _CAPACITY:
        blocks = ctypes.c_int()
        with torch.cuda.device(device):
            err = _fns()[0](hd, code, ctypes.byref(blocks))
        if err:
            raise RuntimeError(f"decode_attention occupancy query failed with CUDA error {err}")
        _CAPACITY[key] = blocks.value
    return _CAPACITY[key]


def barrier_counts(n: int, words: int, device) -> torch.Tensor:
    """At least ``words`` counts for barriers of n blocks on ``device``."""
    key = (device.index, n)
    have = _COUNTS.get(key)
    if have is None or have.numel() < words:
        have = _COUNTS[key] = torch.zeros(max(words, 1024), dtype=torch.int64, device=device)
    return have


def decode_attention_cuda(q, k_cache, v_cache, cache_pos, t, *, window: int = 0,
                          softmax_scale: Optional[float] = None):
    """q: (B, H, hd); caches: (B, W, Hkv, hd), or kv heads [lo, hi) of a
    larger cache, ``cache[..., lo:hi, :]``, read in place
    (``flash_attention.kv_rows``); cache_pos: (B, W) int32; t: (B,) int32.
    Launches one kernel on the current stream of q's device and returns
    (B, H, hd) in q's dtype."""
    return decode_attention_split(q, k_cache, v_cache, cache_pos, t, None, window=window,
                                  softmax_scale=softmax_scale)


def prepare(q, k_cache, v_cache, cache_pos, t, n_split: Optional[int] = None,
            softmax_scale: Optional[float] = None):
    """Check a call and plan it on q's device: returns the output and,
    unless B = 0, (cache_pos, n_split, scale, the split records' scratch
    or None), all allocated on that device."""
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"q must be (B, H, hd) and caches (B, W, Hkv, hd), got "
                         f"{tuple(q.shape)} and {tuple(k_cache.shape)}")
    b, h, hd = q.shape
    w, hkv = k_cache.shape[1], k_cache.shape[2]
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {q.dtype}; the kernel takes float32 or bfloat16")
    if hd > MAX_HD or hd % 8:
        raise ValueError(f"unsupported head_dim {hd}; the kernel takes a multiple of 8 up to "
                         f"{MAX_HD}")
    if hkv == 0 or h % hkv or h // hkv > MAX_GROUP:
        raise ValueError(f"{h} query heads over {hkv} kv heads: need a whole group "
                         f"of at most {MAX_GROUP}")
    if b == 0:
        return torch.empty_like(q), None
    if w == 0:
        raise ValueError("the cache has no entries")
    if b > 65535 or hkv > 65535:
        raise ValueError("batch and kv head counts must be at most 65535")
    _check("q", q, (b, h, hd), q.dtype, q.device)
    if kv_rows("k_cache", k_cache, (b, w, hkv, hd), q.dtype, q.device) != kv_rows(
            "v_cache", v_cache, (b, w, hkv, hd), q.dtype, q.device):
        raise ValueError("k_cache and v_cache must have the same row stride")
    if cache_pos.is_contiguous() and cache_pos.data_ptr() % 16:
        # one layer's view of a stacked ring cache whose B·W is not a
        # multiple of 4: a copy of its positions (B·W int32) is aligned
        cache_pos = cache_pos.clone()
    _check("cache_pos", cache_pos, (b, w), torch.int32, q.device)
    _check("t", t, (b,), torch.int32, q.device)
    cap = _capacity(_DTYPE_CODES[q.dtype], hd, q.device)
    if n_split is None:
        n_split = split_plan(b, hkv, w, _n_sm(q.device), cap)
    elif not 1 <= n_split <= min(-(-w // TILE), MAX_SPLIT):
        raise ValueError(f"n_split must be in [1, {min(-(-w // TILE), MAX_SPLIT)}], "
                         f"got {n_split}")
    elif n_split > 1 and b * hkv * n_split > cap:
        raise ValueError(f"{b * hkv * n_split} blocks exceed the {cap} that can be resident")
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    out = torch.empty_like(q)
    part = None
    if n_split > 1:
        part = torch.empty(b * hkv * n_split * record_floats(h // hkv, body_width(hd)),
                           dtype=torch.float32, device=q.device)
    return out, (cache_pos, n_split, scale, part)


def decode_attention_split(q, k_cache, v_cache, cache_pos, t, n_split: Optional[int], *,
                           window: int = 0, softmax_scale: Optional[float] = None):
    """``decode_attention_cuda`` with its split plan forced to ``n_split``
    (1 to ceil(W / TILE), and B x Hkv x n_split within the resident grid);
    None takes ``split_plan``'s."""
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_cuda needs CUDA tensors, got {q.device}")
    out, plan = prepare(q, k_cache, v_cache, cache_pos, t, n_split, softmax_scale)
    if plan is None:
        return out
    cache_pos, n_split, scale, part = plan
    b, h, hd = q.shape
    w, hkv = k_cache.shape[1], k_cache.shape[2]
    counts = barrier_counts(n_split, b * hkv, q.device) if n_split > 1 else None
    ptr = lambda x: 0 if x is None else x.data_ptr()
    with torch.cuda.device(q.device):
        err = _fns()[1](q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                        cache_pos.data_ptr(), t.data_ptr(), ptr(part), ptr(counts),
                        out.data_ptr(), b, w, h, hkv, k_cache.stride(-3) // hd, hd,
                        _DTYPE_CODES[q.dtype], n_split,
                        float(scale), int(window or 0),
                        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed with CUDA error {err}")
    return out
