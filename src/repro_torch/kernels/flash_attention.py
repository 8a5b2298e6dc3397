"""Wrapper of the Hopper prefill attention kernel, ``csrc/flash_attention.cu``.

Replaces ``repro/kernels/flash_attention.py::flash_attention_pallas``.
The kernel masks the ragged edge itself, so S is any length.  It is
built at head_dim 64, 128 and 256; at 80 (h2o-danube-1.8b) the wrapper
zero-pads q, k and v to 128 columns in device memory, as the reference's
Pallas kernels pad head_dim to 128, and returns the first 80 columns of
the output (zero columns change no score, so the log-sum-exp is the
same).  ``prepare`` checks and plans a call on any device: the CUDA
launch and the dry run's meta route (``kernels/meta.py``) both take it.
Plain version:
``repro_torch.kernels.ref.flash_attention``.  On request the kernel also
writes each query row's log-sum-exp (``ref.flash_attention_lse``), which
the backward kernel (``flash_attention_bwd.py``) reads; the serving path
does not ask for it and the kernel then writes nothing more.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_DIMS = (64, 128, 256)        # the head widths the kernel is built at
PAD_TO = {80: 128}                  # a width the wrappers zero-pad to a built one
HEAD_DIMS = KERNEL_DIMS + tuple(PAD_TO)
_FN = None


def _fn():
    global _FN
    if _FN is None:
        f = build.load("flash_attention").flash_attention_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, i, p]
        f.restype = ctypes.c_int
        _FN = f
    return _FN


def _check(name: str, x: torch.Tensor, shape, dtype, device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def kv_rows(name: str, x: torch.Tensor, shape, dtype, device) -> int:
    """``_check`` of a cache or pool (..., Hkv, hd) that the decode-side
    kernels read in place at a row stride: each row's Hkv heads of hd
    contiguous values may sit inside a row of more heads (a slice of kv
    heads, ``x[..., lo:hi, :]``), the leading dims dense over the rows.
    Returns the heads a row holds (its stride over hd)."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    st, hd, hkv = x.stride(), shape[-1], shape[-2]
    row = st[-3] if len(shape) >= 3 else hkv * hd
    dense = all(shape[i] == 1 or st[i] == shape[i + 1] * st[i + 1]
                for i in range(len(shape) - 3))
    if (st[-1] != 1 or (hkv > 1 and st[-2] != hd) or row % hd or row // hd < hkv
            or not dense):
        raise ValueError(f"{name} must be rows of kv heads, each of {hd} contiguous values, "
                         f"got strides {st}")
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    return row // hd


def pad_head(hd: int, *xs):
    """xs with their last dim zero-padded from ``hd`` to ``PAD_TO[hd]``,
    or as they are at a width the kernels are built at."""
    if hd not in PAD_TO:
        return xs
    return tuple(torch.nn.functional.pad(x, (0, PAD_TO[hd] - hd)) for x in xs)


def prepare(q, k, v, segment_ids=None, softmax_scale: Optional[float] = None,
            return_lse: bool = False):
    """Check a call and plan it on q's device: returns (out, lse) as the
    wrapper returns them and, unless B or S is 0, the kernel's (q, k, v,
    segment_ids, out, lse, scale) at its built width, all allocated on
    that device."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, S, H, hd), got {tuple(q.shape)}")
    b, s, h, hd = q.shape
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {q.dtype}; the kernel takes float32 or bfloat16")
    if hd not in HEAD_DIMS:
        raise ValueError(f"unsupported head_dim {hd}; the kernel takes {HEAD_DIMS}")
    if k.dim() != 4:
        raise ValueError(f"k must be (B, S, Hkv, hd), got {tuple(k.shape)}")
    hkv = k.shape[2]
    if hkv == 0 or h % hkv:
        raise ValueError(f"{h} query heads are not a multiple of {hkv} kv heads")
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if return_lse else None
    if b == 0 or s == 0:
        return (torch.empty_like(q), lse), None
    if b > 65535 or h > 65535:
        raise ValueError("batch and head counts must be at most 65535")
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    q, k, v = pad_head(hd, q, k, v)
    hdk = q.shape[3]
    _check("q", q, (b, s, h, hdk), q.dtype, q.device)
    _check("k", k, (b, s, hkv, hdk), q.dtype, q.device)
    _check("v", v, (b, s, hkv, hdk), q.dtype, q.device)
    if segment_ids is None:
        segment_ids = torch.zeros((b, s), dtype=torch.int32, device=q.device)
    _check("segment_ids", segment_ids, (b, s), torch.int32, q.device)
    out = torch.empty_like(q)
    return (out[..., :hd], lse), (q, k, v, segment_ids, out, lse, scale)


def flash_attention_cuda(q, k, v, segment_ids=None, *, causal: bool = True,
                         window: int = 0, softmax_scale: Optional[float] = None,
                         return_lse: bool = False):
    """q: (B, S, H, hd); k, v: (B, S, Hkv, hd); segment_ids: (B, S) int32
    or None.  Launches the kernel on the current stream of q's device and
    returns (B, S, H, hd) in q's dtype; with ``return_lse`` also the (B, H,
    S) f32 log-sum-exp of each row (-inf where a row sees no key)."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {q.device}")
    result, call = prepare(q, k, v, segment_ids, softmax_scale, return_lse)
    if call is not None:
        q, k, v, segment_ids, out, lse, scale = call
        b, s, h, hd = q.shape
        with torch.cuda.device(q.device):
            err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), segment_ids.data_ptr(),
                        out.data_ptr(), None if lse is None else lse.data_ptr(),
                        b, s, h, k.shape[2], hd, _DTYPE_CODES[q.dtype], float(scale),
                        int(bool(causal)), int(window or 0),
                        torch.cuda.current_stream(q.device).cuda_stream)
        if err:
            raise RuntimeError(f"flash_attention kernel launch failed with CUDA error {err}")
    return result if return_lse else result[0]
