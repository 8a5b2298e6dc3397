#!/usr/bin/env python3
"""Time the linear scan kernel's plans beside the one-thread-per-channel
design it replaced, on one NVIDIA H100.

    python3 tools/linear_scan_breakdown.py

At the shapes the RG-LRU prefill gives the scan (B=8 S=512 C=4096 f32,
the engine's admission and re-prefill lengths S=463 and 559, B=1 at
S=512 and 4096, and bf16 at B=8 S=512), with ``chip_smoke.py``'s timer
(CUDA events, L2 flushed), times:

- ``parent``: the earlier kernel (one thread per (b, c) channel walks
  all S steps with 16 steps of a and x prefetched into registers),
  built as a scratch variant through ``build.load_variant``; with 32
  steps prefetched (``parent_pf32``: more loads in flight a thread); and
  with its recurrence replaced by an elementwise h = a + x
  (``parent_nodep``: the same loads and stores with no dependent chain;
  timing only);
- the kernel at its own plan, and a sweep of plans (V channels a
  thread, W warps a block, L steps a warp's slice: span W*L, tile 32*V),
  built as one scratch variant with more plans than the library;
- ``stream_ms``: ``torch.add(a, x, out=h)``, the same bytes read and
  written by an elementwise kernel (a yardstick of the rate the card
  reaches, not a scan);

beside the bound (a, x and h of B*S*C, h_last of B*C, over 3.35 TB/s) and the timer's
floor (one launch of a kernel that adds 1 to one element).  Each plan is
checked against the plain version on the first shape.  Prints one JSON
object.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

SHAPES = [(8, 512, 4096, "float32"), (8, 463, 4096, "float32"), (8, 559, 4096, "float32"),
          (1, 512, 4096, "float32"), (1, 4096, 4096, "float32"), (8, 512, 4096, "bfloat16")]
SWEEP = [(v, w, l) for v in (1, 2, 4)
         for w, l in ((4, 4), (8, 2), (8, 4), (8, 8), (16, 2), (16, 4), (16, 8), (32, 4))
         if w * v <= 64]

# The one-thread-per-channel kernel the current design replaced: each
# thread owns one (b, c) channel and walks S in order, PF steps of a and x
# in flight in registers.  NODEP replaces the recurrence by h = a + x.
PARENT = r"""
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#ifndef PF
#define PF 16
#endif
namespace {
constexpr int NT = 128;
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}
template <typename T>
__global__ void __launch_bounds__(NT)
linear_scan_kernel(const T* __restrict__ a, const T* __restrict__ x,
                   const float* __restrict__ h0, T* __restrict__ h, T* __restrict__ h_last,
                   int S, int C, long long n_chan) {
    const long long i = (long long)blockIdx.x * NT + threadIdx.x;
    if (i >= n_chan) return;
    const long long b = i / C;
    const long long c = i - b * C;
    const size_t base = (size_t)b * S * C + c;
    float carry = h0 ? h0[i] : 0.f;
    float ra[PF], rx[PF];
#pragma unroll
    for (int k = 0; k < PF; ++k) {
        if (k < S) {
            ra[k] = to_f32(a[base + (size_t)k * C]);
            rx[k] = to_f32(x[base + (size_t)k * C]);
        }
    }
    for (int t0 = 0; t0 < S; t0 += PF) {
#pragma unroll
        for (int k = 0; k < PF; ++k) {
            const int t = t0 + k;
            if (t < S) {
                const float av = ra[k], xv = rx[k];
                const int tn = t + PF;
                if (tn < S) {
                    ra[k] = to_f32(a[base + (size_t)tn * C]);
                    rx[k] = to_f32(x[base + (size_t)tn * C]);
                }
#ifdef NODEP
                carry = av + xv;
#else
                carry = av * carry + xv;
#endif
                h[base + (size_t)t * C] = from_f32<T>(carry);
            }
        }
    }
    h_last[i] = from_f32<T>(carry);
}
template <typename T>
int launch(const void* a, const void* x, const float* h0, void* h, void* h_last, int B, int S,
           int C, cudaStream_t stream) {
    const long long n_chan = (long long)B * C;
    linear_scan_kernel<T><<<(unsigned)((n_chan + NT - 1) / NT), NT, 0, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(x), h0, static_cast<T*>(h),
        static_cast<T*>(h_last), S, C, n_chan);
    return (int)cudaGetLastError();
}
}  // namespace
extern "C" int linear_scan_fwd(const void* a, const void* x, const void* h0, void* h,
                               void* h_last, int B, int S, int C, int dtype, void* stream) {
    const float* h0f = static_cast<const float*>(h0);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch<float>(a, x, h0f, h, h_last, B, S, C, st);
    return launch<__nv_bfloat16>(a, x, h0f, h, h_last, B, S, C, st);
}
"""


def main() -> int:
    import ctypes

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("linear_scan_breakdown.py: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import linear_scan as ls

    build.build(["linear_scan"])
    plans = "".join("X(%d, %d, %d) " % p for p in SWEEP)
    sweep_lib = build.load_variant(
        "linear_scan_sweep",
        f"#define LS_PLANS(X) {plans}\n" + (build.CSRC / "linear_scan.cu").read_text())
    parents = {name: build.load_variant(f"linear_scan_{name}", defs + PARENT)
               for name, defs in (("parent", ""), ("parent_pf32", "#define PF 32\n"),
                                  ("parent_nodep", "#define NODEP\n"))}
    p = ctypes.c_void_p
    for lib in parents.values():
        lib.linear_scan_fwd.argtypes = [p, p, p, p, p] + [ctypes.c_int] * 4 + [p]
        lib.linear_scan_fwd.restype = ctypes.c_int

    def parent_call(lib, a, x):
        h = torch.empty_like(x)
        h_last = torch.empty((x.shape[0], x.shape[2]), dtype=x.dtype, device=x.device)
        err = lib.linear_scan_fwd(a.data_ptr(), x.data_ptr(), None, h.data_ptr(),
                                  h_last.data_ptr(), *x.shape,
                                  0 if x.dtype == torch.float32 else 1,
                                  torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent kernel launch failed with CUDA error {err}")
        return h, h_last

    timer = cs.Timer(torch)
    rng = np.random.default_rng(0)
    one = torch.zeros(1, device="cuda")
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": cs.nvidia_smi(),
              "floor_ms": timer(lambda: one.add_(1)), "shapes": []}
    for i, (b, s, c, dn) in enumerate(SHAPES):
        dtype = getattr(torch, dn)
        a = torch.from_numpy(rng.uniform(0.5, 1.0, size=(b, s, c)).astype(np.float32)).to(
            "cuda", dtype)
        x = torch.from_numpy(rng.standard_normal((b, s, c), dtype=np.float32)).to("cuda", dtype)
        out = torch.empty_like(x)
        row = {"case": f"B={b} S={s} C={c} {dn}", "plan": ls.scan_plan(b, c, dtype),
               **cs.bound(2.0 * b * s * c, (3 * s + 1) * b * c * a.element_size(), dn),
               "ms": timer(lambda: ls.linear_scan_cuda(a, x)),
               "stream_ms": timer(lambda: torch.add(a, x, out=out))}
        for name, lib in parents.items():
            row[f"{name}_ms"] = timer(lambda: parent_call(lib, a, x))
        if i == 0:
            want = ref.linear_scan(a, x)
            got = [parent_call(parents["parent"], a, x)]
            got += [ls.linear_scan_with_plan(a, x, None, plan, sweep_lib) for plan in SWEEP]
            torch.cuda.synchronize()
            row["max_abs_err_over_plans_and_parent"] = max(
                cs.check("linear_scan", g, w, dn, row["case"]) for pair in got
                for g, w in zip(pair, want))
            del want, got
        row["ms_by_plan"] = {"V%dW%dL%d" % plan: timer(
            lambda: ls.linear_scan_with_plan(a, x, None, plan, sweep_lib))
            for plan in SWEEP if c % plan[0] == 0}
        result["shapes"].append(row)
        del a, x, out
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
