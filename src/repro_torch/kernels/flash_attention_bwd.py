"""Wrapper of the Hopper attention backward kernel, ``csrc/flash_attention_bwd.cu``.

No Pallas kernel is replaced: the JAX package differentiates its jnp
oracle ``repro.kernels.ref.flash_attention`` with XLA's autodiff, and
this kernel is the gradient of the port's forward kernel on the
trainer's path (``ops.flash_attention`` under autograd).  Plain
version: ``repro_torch.kernels.ref.flash_attention_bwd``.  f32 and
bf16 at head_dim 64 and 128; other widths raise.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import _DTYPE_CODES, _check

HEAD_DIMS = (64, 128)
TILE = 64
_FN = None


def _fn():
    global _FN
    if _FN is None:
        f = build.load("flash_attention_bwd").flash_attention_bwd
        p, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [p] * 14 + [i, i, i, i, i, i, ctypes.c_float, i, i, p]
        f.restype = ctypes.c_int
        _FN = f
    return _FN


def flash_attention_bwd_cuda(q, k, v, out, lse, dout, segment_ids=None, *, causal: bool = True,
                             window: int = 0, softmax_scale: Optional[float] = None):
    """q, out, dout: (B, S, H, hd); k, v: (B, S, Hkv, hd); lse: (B, H, S)
    f32 from the forward kernel; segment_ids: (B, S) int32 or None.
    Launches the kernels on the current stream of q's device and returns
    (dq, dk, dv) in the inputs' dtype."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd_cuda needs CUDA tensors, got {q.device}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be 4-d, got {tuple(q.shape)} and {tuple(k.shape)}")
    b, s, h, hd = q.shape
    hkv = k.shape[2]
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {q.dtype}; the kernel takes float32 or bfloat16")
    if hd not in HEAD_DIMS:
        raise ValueError(f"unsupported head_dim {hd}; the backward kernel takes {HEAD_DIMS}")
    if hkv == 0 or h % hkv:
        raise ValueError(f"{h} query heads are not a multiple of {hkv} kv heads")
    if b == 0 or s == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    if b > 65535 or h > 65535:
        raise ValueError("batch and head counts must be at most 65535")
    dev = q.device
    for name, x, shape in (("q", q, (b, s, h, hd)), ("k", k, (b, s, hkv, hd)),
                           ("v", v, (b, s, hkv, hd)), ("out", out, (b, s, h, hd)),
                           ("dout", dout, (b, s, h, hd))):
        _check(name, x, shape, q.dtype, dev)
    _check("lse", lse, (b, h, s), torch.float32, dev)
    if segment_ids is None:
        segment_ids = torch.zeros((b, s), dtype=torch.int32, device=dev)
    _check("segment_ids", segment_ids, (b, s), torch.int32, dev)
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=dev)
    tile_seg = torch.empty((b, -(-s // TILE), 2), dtype=torch.int32, device=dev)
    dk_part = torch.empty((b, s, h, hd), dtype=torch.float32, device=dev)
    dv_part = torch.empty_like(dk_part)
    ptrs = [x.data_ptr() for x in (q, k, v, out, lse, dout, segment_ids, dq, dk, dv, delta,
                                   tile_seg, dk_part, dv_part)]
    with torch.cuda.device(dev):
        err = _fn()(*ptrs, b, s, h, hkv, hd, _DTYPE_CODES[q.dtype], float(scale),
                    int(bool(causal)), int(window or 0), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed with CUDA error {err}")
    return dq, dk, dv
