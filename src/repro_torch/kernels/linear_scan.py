"""Wrapper of the Hopper diagonal linear scan, ``csrc/linear_scan.cu``.

Replaces ``repro/kernels/linear_scan.py::linear_scan_pallas``.  One
thread per (b, c) channel walks S in order with the state in f32; B, S
and C are any size and nothing is padded.  Plain version:
``repro_torch.kernels.ref.linear_scan``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import _DTYPE_CODES, _check

_FN = None


def _fn():
    global _FN
    if _FN is None:
        f = build.load("linear_scan").linear_scan_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [p, p, p, p, p, i, i, i, i, p]
        f.restype = ctypes.c_int
        _FN = f
    return _FN


def linear_scan_cuda(a, x, h0=None):
    """a, x: (B, S, C) of one dtype (float32 or bfloat16); h0: (B, C) or
    None.  Launches on the current stream of x's device and returns (h
    (B, S, C), h_last (B, C)) in x's dtype."""
    if x.device.type != "cuda":
        raise ValueError(f"linear_scan_cuda needs CUDA tensors, got {x.device}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, S, C), got {tuple(x.shape)}")
    b, s, c = x.shape
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {x.dtype}; the kernel takes float32 or bfloat16")
    _check("a", a, (b, s, c), x.dtype, x.device)
    _check("x", x, (b, s, c), x.dtype, x.device)
    h = torch.empty_like(x)
    h_last = torch.empty((b, c), dtype=x.dtype, device=x.device)
    if b == 0 or c == 0:
        return h, h_last
    if s == 0:
        raise ValueError("the sequence has no steps")
    if h0 is not None:
        if tuple(h0.shape) != (b, c):
            raise ValueError(f"h0 has shape {tuple(h0.shape)}, expected {(b, c)}")
        h0 = h0.to(torch.float32).contiguous()          # the carry's own type
        _check("h0", h0, (b, c), torch.float32, x.device)
    with torch.cuda.device(x.device):
        err = _fn()(a.data_ptr(), x.data_ptr(), 0 if h0 is None else h0.data_ptr(),
                    h.data_ptr(), h_last.data_ptr(), b, s, c, _DTYPE_CODES[x.dtype],
                    torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"linear_scan kernel launch failed with CUDA error {err}")
    return h, h_last
