"""Wrapper of the Hopper diagonal linear scan, ``csrc/linear_scan.cu``.

Replaces ``repro/kernels/linear_scan.py::linear_scan_pallas``.  One
launch per call: a block owns a tile of 32·V channels of one batch row
and walks S in spans of W·L steps, which its W warps split in time (each
scans L steps in registers; the slices' aggregates are folded in warp
order into each warp's carry-in; each warp reruns its slice from it).
The state is f32; B, S and C are any size and nothing is padded.  Plain
version: ``repro_torch.kernels.ref.linear_scan``; ``span_scan`` is the
kernel's decomposition in plain PyTorch, for the CPU tests.

The gradient, ``linear_scan_bwd_cuda``, is the same kernel in reverse
time (``linear_scan_bwd``): one launch that reads a, the forward's h and
the upstream gradient once and writes dx and da once.  Its plain version
is ``torch.autograd`` through ``ref.linear_scan``; ``span_scan_bwd`` is
its decomposition.  ``prepare`` and ``prepare_bwd`` check a call and
allocate its outputs on any device: the CUDA launches and the dry run's
meta routes (``kernels/meta.py``) both take them.
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
        bwd = lib.linear_scan_bwd
        bwd.argtypes = [p] * 8 + [i, i, i, i, p]
        for f in (fwd, forced, plan, bwd):
            f.restype = i
        _FNS[key] = {"fwd": fwd, "forced": forced, "plan": plan, "bwd": bwd}
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


def prepare(a, x, h0=None):
    """Check a call on x's device: returns (h, h_last), allocated there,
    and, unless B or C is 0, (h0 as the kernel reads it: f32 or None,)."""
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
        return (h, h_last), None
    if s == 0:
        raise ValueError("the sequence has no steps")
    if b > 65535:
        raise ValueError("the batch must be at most 65535 rows")
    if h0 is not None:
        if tuple(h0.shape) != (b, c):
            raise ValueError(f"h0 has shape {tuple(h0.shape)}, expected {(b, c)}")
        h0 = h0.to(torch.float32).contiguous()          # the carry's own type
        _check("h0", h0, (b, c), torch.float32, x.device)
    return (h, h_last), (h0,)


def linear_scan_with_plan(a, x, h0=None, plan: Optional[Tuple[int, int, int]] = None,
                          lib=None):
    """``linear_scan_cuda`` at a forced plan (V, W, L), one of ``PLANS``
    with V dividing C (the default plan where None), through the built
    library or ``lib``, a variant built with other plans."""
    if x.device.type != "cuda":
        raise ValueError(f"linear_scan_cuda needs CUDA tensors, got {x.device}")
    (h, h_last), call = prepare(a, x, h0)
    if call is None:
        return h, h_last
    (h0,) = call
    b, s, c = x.shape
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


def prepare_bwd(a, h, h0, g, g_last=None):
    """Check a gradient call on g's device: returns (da, dx, dh0),
    allocated there, and, unless B or C is 0, (h0, g_last) as the kernel
    reads them (f32 or None)."""
    if g.dim() != 3:
        raise ValueError(f"g must be (B, S, C), got {tuple(g.shape)}")
    b, s, c = g.shape
    if g.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {g.dtype}; the kernel takes float32 or bfloat16")
    for name, x in (("a", a), ("h", h), ("g", g)):
        _check(name, x, (b, s, c), g.dtype, g.device)
    state = []
    for name, x in (("h0", h0), ("g_last", g_last)):
        if x is not None:
            if tuple(x.shape) != (b, c):
                raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {(b, c)}")
            x = x.to(torch.float32).contiguous()
            _check(name, x, (b, c), torch.float32, g.device)
        state.append(x)
    h0, g_last = state
    da, dx = torch.empty_like(g), torch.empty_like(g)
    dh0 = None if h0 is None else torch.empty((b, c), dtype=torch.float32, device=g.device)
    if b == 0 or c == 0:
        return (da, dx, dh0), None
    if s == 0:
        raise ValueError("the sequence has no steps")
    if b > 65535:
        raise ValueError("the batch must be at most 65535 rows")
    return (da, dx, dh0), (h0, g_last)


def linear_scan_bwd_cuda(a, h, h0, g, g_last=None):
    """The gradient of ``linear_scan_cuda(a, x, h0) = (h, h_last)``: a, h
    (the forward's output) and g = dL/dh, (B, S, C) of one dtype; h0 and
    g_last = dL/dh_last, (B, C) or None (zeros).  Launches one kernel on
    the current stream of g's device and returns (da, dx) in g's dtype
    and dh0 (B, C) f32, None without h0."""
    if g.device.type != "cuda":
        raise ValueError(f"linear_scan_bwd_cuda needs CUDA tensors, got {g.device}")
    (da, dx, dh0), call = prepare_bwd(a, h, h0, g, g_last)
    if call is None:
        return da, dx, dh0
    h0, g_last = call
    b, s, c = g.shape
    ptr = lambda x: 0 if x is None else x.data_ptr()
    with torch.cuda.device(g.device):
        err = _lib_fns()["bwd"](a.data_ptr(), h.data_ptr(), ptr(h0), g.data_ptr(), ptr(g_last),
                                dx.data_ptr(), da.data_ptr(), ptr(dh0), b, s, c,
                                _DTYPE_CODES[g.dtype],
                                torch.cuda.current_stream(g.device).cuda_stream)
    if err:
        raise RuntimeError(f"linear_scan_bwd kernel launch failed with CUDA error {err}")
    return da, dx, dh0


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


def span_scan_bwd(a, h, h0, g, g_last=None, *, warps: int, steps: int):
    """The gradient kernel's decomposition in plain PyTorch, f32 state:
    ``span_scan`` over reversed time, step u = S - 1 - t taking the
    coefficient a_{t+1} (1 at t = S - 1) and the input g_t from the carry
    g_last; then dx_t = dh_t, da_t = dh_t h_{t-1} (h_{-1} = h0 or 0) and
    dh0 = a_0 dh_0.  Returns (da, dx) in g's dtype and dh0 f32 (None
    without h0), as ``linear_scan_bwd_cuda``."""
    b, s, c = g.shape
    af = a.float()
    a_rev = torch.cat([torch.ones_like(af[:, :1]), af[:, 1:].flip(1)], dim=1)
    dh, _ = span_scan(a_rev, g.float().flip(1), None if g_last is None else g_last.float(),
                      warps=warps, steps=steps)
    dh = dh.flip(1)
    first = (torch.zeros((b, 1, c), dtype=torch.float32, device=g.device) if h0 is None
             else h0.float()[:, None])
    h_prev = torch.cat([first, h.float()[:, :-1]], dim=1)
    dh0 = None if h0 is None else af[:, 0] * dh[:, 0]
    return (dh * h_prev).to(g.dtype), dh.to(g.dtype), dh0
