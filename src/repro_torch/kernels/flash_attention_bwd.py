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
# the launches of one bf16 call, in order, as ``flash_attention_bwd_part``
# numbers them: prep, the main launch (dK/dV and dQ blocks), the main
# launch with only its dK/dV blocks, with only its dQ blocks, the group sums
PARTS = ("prep", "main", "main_dkdv", "main_dq", "reduce")
_FN = {}


def _fn(name: str = "flash_attention_bwd"):
    if name not in _FN:
        f = getattr(build.load("flash_attention_bwd"), name)
        p, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = ([p] * 14 + [i, i, i, i, i, i, ctypes.c_float, i, i]
                      + ([i] if name.endswith("_part") else []) + [p])
        f.restype = ctypes.c_int
        _FN[name] = f
    return _FN[name]


def _prepare(q, k, v, out, lse, dout, segment_ids, causal, window, softmax_scale):
    """Check the inputs and allocate the outputs and scratch.  Returns
    (dq, dk, dv) and the C arguments before the stream, or None for
    them when there is nothing to compute."""
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
        return (torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)), None
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
    # D, and for bf16 lse log2 e, per (batch, head) row padded to whole tiles
    delta = torch.empty((2, b, h, -(-s // TILE) * TILE), dtype=torch.float32, device=dev)
    tile_seg = torch.empty((b, -(-s // TILE), 3), dtype=torch.int32, device=dev)
    dk_part = torch.empty((b, s, h, hd), dtype=torch.float32, device=dev)
    dv_part = torch.empty_like(dk_part)
    tensors = (q, k, v, out, lse, dout, segment_ids, dq, dk, dv, delta, tile_seg, dk_part,
               dv_part)
    args = [x.data_ptr() for x in tensors] + [
        b, s, h, hkv, hd, _DTYPE_CODES[q.dtype], float(scale), int(bool(causal)),
        int(window or 0)]
    return (dq, dk, dv), (args, tensors)


def flash_attention_bwd_cuda(q, k, v, out, lse, dout, segment_ids=None, *, causal: bool = True,
                             window: int = 0, softmax_scale: Optional[float] = None):
    """q, out, dout: (B, S, H, hd); k, v: (B, S, Hkv, hd); lse: (B, H, S)
    f32 from the forward kernel; segment_ids: (B, S) int32 or None.
    Launches the kernels on the current stream of q's device and returns
    (dq, dk, dv) in the inputs' dtype."""
    grads, call = _prepare(q, k, v, out, lse, dout, segment_ids, causal, window, softmax_scale)
    if call is None:
        return grads
    with torch.cuda.device(q.device):
        err = _fn()(*call[0], torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed with CUDA error {err}")
    return grads


def flash_attention_bwd_parts(q, k, v, out, lse, dout, segment_ids=None, *, causal: bool = True,
                              window: int = 0, softmax_scale: Optional[float] = None):
    """For timing a bf16 call's launches one at a time: returns (dq, dk,
    dv) and a dict of ``PARTS`` to functions that each launch that part
    on the same outputs and scratch.  Launching prep, main and reduce in
    that order computes the gradients.  No path of the port calls it."""
    if q.dtype != torch.bfloat16:
        raise ValueError("the parts are those of the bf16 route")
    grads, call = _prepare(q, k, v, out, lse, dout, segment_ids, causal, window, softmax_scale)
    if call is None:
        raise ValueError("nothing to compute at B = 0 or S = 0")
    args, tensors = call

    def launcher(part):
        def launch(keep=tensors):   # the scratch lives as long as the launchers
            with torch.cuda.device(q.device):
                err = _fn("flash_attention_bwd_part")(
                    *args, part, torch.cuda.current_stream(q.device).cuda_stream)
            if err:
                raise RuntimeError(f"flash_attention_bwd part {PARTS[part]} failed with CUDA "
                                   f"error {err}")
        return launch
    return grads, {name: launcher(i) for i, name in enumerate(PARTS)}
