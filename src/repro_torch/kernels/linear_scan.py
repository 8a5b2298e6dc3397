"""Wrapper of the Hopper diagonal linear scan, ``csrc/linear_scan.cu``.

Replaces ``repro/kernels/linear_scan.py::linear_scan_pallas``.  One
launch per call: a block owns a tile of 32·V channels of one batch row
and walks S in spans of W·L steps, which its W warps split in time (each
scans L steps in registers; the slices' aggregates are folded in warp
order into each warp's carry-in; each warp reruns its slice from it).
The state is f32; B, S and C are any size and nothing is padded.  Plain
version: ``repro_torch.kernels.ref.linear_scan``; ``span_scan`` is the
kernel's decomposition in plain PyTorch, for the CPU tests.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import _DTYPE_CODES, _check

# the plans the library is built with (LS_PLANS in csrc/linear_scan.cu),
# as (V channels a thread, W warps a block, L steps a warp's slice)
PLANS = ((4, 8, 4), (2, 8, 4), (1, 8, 4), (1, 16, 8))

_FNS = {}


def _lib_fns(lib=None):
    """The library's entry points (the built kernel's, or those of ``lib``,
    a variant loaded by ``build.load_variant``), with their C types."""
    key = id(lib)
    if key not in _FNS:
        lib = build.load("linear_scan") if lib is None else lib
        p, i = ctypes.c_void_p, ctypes.c_int
        fwd = lib.linear_scan_fwd
        fwd.argtypes = [p, p, p, p, p, i, i, i, i, p]
        forced = lib.linear_scan_fwd_plan
        forced.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
        plan = lib.linear_scan_plan
        plan.argtypes = [i, i, i, ctypes.POINTER(ctypes.c_int)]      # B, C, dtype
        for f in (fwd, forced, plan):
            f.restype = i
        _FNS[key] = {"fwd": fwd, "forced": forced, "plan": plan}
    return _FNS[key]


def scan_plan(b: int, c: int, dtype=torch.float32, lib=None) -> Tuple[int, int, int]:
    """The plan (V, W, L) the kernel takes for B rows of C channels in
    ``dtype``: ``linear_scan_plan`` of the library."""
    out = (ctypes.c_int * 3)()
    _lib_fns(lib)["plan"](b, c, _DTYPE_CODES[dtype], out)
    return tuple(out)


def linear_scan_cuda(a, x, h0=None):
    """a, x: (B, S, C) of one dtype (float32 or bfloat16); h0: (B, C) or
    None.  Launches on the current stream of x's device and returns (h
    (B, S, C), h_last (B, C)) in x's dtype."""
    return linear_scan_with_plan(a, x, h0)


def linear_scan_with_plan(a, x, h0=None, plan: Optional[Tuple[int, int, int]] = None,
                          lib=None):
    """``linear_scan_cuda`` at a forced plan (V, W, L), one of ``PLANS``
    with V dividing C (the default plan where None), through the built
    library or ``lib``, a variant built with other plans."""
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
    if b > 65535:
        raise ValueError("the batch must be at most 65535 rows")
    if h0 is not None:
        if tuple(h0.shape) != (b, c):
            raise ValueError(f"h0 has shape {tuple(h0.shape)}, expected {(b, c)}")
        h0 = h0.to(torch.float32).contiguous()          # the carry's own type
        _check("h0", h0, (b, c), torch.float32, x.device)
    if plan is not None and ((lib is None and tuple(plan) not in PLANS) or c % plan[0]):
        raise ValueError(f"plan {plan} is not built or its V does not divide C = {c}")
    fns = _lib_fns(lib)
    args = [a.data_ptr(), x.data_ptr(), 0 if h0 is None else h0.data_ptr(), h.data_ptr(),
            h_last.data_ptr(), b, s, c, _DTYPE_CODES[x.dtype]]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = (fns["fwd"](*args, stream) if plan is None
               else fns["forced"](*args, *plan, stream))
    if err:
        raise RuntimeError(f"linear_scan kernel launch failed with CUDA error {err}")
    return h, h_last


def span_scan(a, x, h0=None, *, warps: int, steps: int):
    """The kernel's decomposition in plain PyTorch, f32 state: spans of
    ``warps * steps`` steps; per span, each warp's slice of ``steps``
    steps scanned from 0 to its aggregate (A = prod a, H), the
    aggregates folded in warp order into each warp's carry-in from the
    span's carry, each slice rerun from its carry-in; the last warp's
    final state carries to the next span.  Steps past S are identities.
    Returns (h, h_last) in x's dtype, as ``ref.linear_scan``."""
    b, s, c = x.shape
    af, xf = a.float(), x.float()
    carry = (torch.zeros((b, c), dtype=torch.float32, device=x.device) if h0 is None
             else h0.float())
    out = torch.empty((b, s, c), dtype=torch.float32, device=x.device)
    for t0 in range(0, s, warps * steps):
        slices = [range(lo, min(lo + steps, s))
                  for lo in range(t0, t0 + warps * steps, steps)]
        aggs = []
        for sl in slices:                                       # phase 1
            big_a, big_h = torch.ones_like(carry), torch.zeros_like(carry)
            for t in sl:
                big_h = af[:, t] * big_h + xf[:, t]
                big_a = af[:, t] * big_a
            aggs.append((big_a, big_h))
        cin = carry
        for sl, (big_a, big_h) in zip(slices, aggs):
            st = cin
            for t in sl:                                        # phase 3
                st = af[:, t] * st + xf[:, t]
                out[:, t] = st
            cin = big_a * cin + big_h                           # phase 2, in warp order
        carry = st                                              # the last warp's state
    return out.to(x.dtype), out[:, s - 1].to(x.dtype)
