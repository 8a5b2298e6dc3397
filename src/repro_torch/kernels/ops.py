"""Kernel entry points, with the signatures of ``repro/kernels/ops.py``.

Dispatch is by the device of the tensors, not by a global switch: a CPU
tensor goes to the plain PyTorch version in ``ref.py``; a CUDA tensor
goes to the Hopper kernel, or the wrapper raises.  There is no fallback
from the kernel to the plain version.

``LAUNCHES`` counts kernel launches by name, one per call that reached
the kernel, so a run can show that its path went through the kernels.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda

LAUNCHES = {"flash_attention": 0, "decode_attention": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _route(x) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x.device}")
    return x.device.type


def flash_attention(q, k, v, segment_ids=None, *, causal: bool = True,
                    window: int = 0, softmax_scale: Optional[float] = None):
    """q: (B, S, H, hd); k, v: (B, S, Hkv, hd); segment_ids: (B, S) int32."""
    if q.shape[1] != k.shape[1]:
        raise NotImplementedError("cross-attention (Sq != Sk) is not ported yet")
    if _route(q) == "cpu":
        return _ref.flash_attention(q, k, v, segment_ids=segment_ids, causal=causal,
                                    window=window, softmax_scale=softmax_scale)
    out = flash_attention_cuda(q, k, v, segment_ids, causal=causal, window=window,
                               softmax_scale=softmax_scale)
    LAUNCHES["flash_attention"] += 1
    return out


def decode_attention(q, k_cache, v_cache, cache_pos, t, *, window: int = 0,
                     softmax_scale: Optional[float] = None):
    """q: (B, H, hd); caches: (B, W, Hkv, hd); cache_pos: (B, W) int32
    (-1 = empty); t: (B,) int32."""
    if _route(q) == "cpu":
        return _ref.decode_attention(q, k_cache, v_cache, cache_pos, t, window=window,
                                     softmax_scale=softmax_scale)
    out = decode_attention_cuda(q, k_cache, v_cache, cache_pos, t, window=window,
                                softmax_scale=softmax_scale)
    LAUNCHES["decode_attention"] += 1
    return out
