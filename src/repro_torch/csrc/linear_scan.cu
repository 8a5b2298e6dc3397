// Diagonal linear recurrence for Hopper (sm_90a):  h_t = a_t * h_{t-1} + x_t
// over a, x: (B, S, C), from an optional initial state h0: (B, C).
//
// Replaces: src/repro/kernels/linear_scan.py::linear_scan_pallas (the
// Pallas TPU kernel behind repro.kernels.ops.linear_scan, which
// repro/models/rglru.py::rglru_forward calls for every RG-LRU prefill).
// Plain version: src/repro_torch/kernels/ref.py::linear_scan.
//
// What bounds it on the H100: memory.  Each element of a and x is read
// once and each h written once, with two FLOPs per element; at the
// serving shape (B=8, S=512, C=4096, f32) that is 3 * 4 * 16.8M = 201 MB,
// 0.060 ms at 3.35 TB/s.
//
// What the design does about it:
//  * the TPU kernel walks time blocks in sequence on its grid, carrying
//    the state in VMEM scratch, and runs a log-depth associative scan
//    inside each (256, 256) block.  Here one thread owns one (b, c)
//    channel and walks S in order, the state in an f32 register: no
//    scan tree, no carry between blocks, every product exact in the
//    recurrence's own order.
//  * neighbouring threads own neighbouring channels, so every load and
//    store of a warp is one coalesced 128-byte (f32) or 64-byte (bf16)
//    transaction.
//  * the loads do not depend on the carry, so each thread keeps PF
//    steps of a and x in flight in registers (a ring of PF slots,
//    unrolled so it stays in registers) ahead of the multiply-add that
//    consumes them.
//  * no padding of S or C (the Pallas wrapper pads to its 256-row,
//    128-lane blocks); h_last is the true last step's state.
//  * B*C threads: 32768 at the serving shape (about 8 of the 64 warps an
//    SM can hold), 4096 at B=1, leave the card mostly empty; a time-split
//    two-pass scan would fill it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;   // threads per block
constexpr int PF = 16;    // steps of a and x in flight per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

// One thread per channel (b, c) of the B*C channels.  h0 is f32 or null.
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
                carry = av * carry + xv;
                h[base + (size_t)t * C] = from_f32<T>(carry);
            }
        }
    }
    h_last[i] = from_f32<T>(carry);
}

template <typename T>
cudaError_t launch(const void* a, const void* x, const float* h0, void* h, void* h_last, int B,
                   int S, int C, cudaStream_t stream) {
    const long long n_chan = (long long)B * C;
    const long long blocks = (n_chan + NT - 1) / NT;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    linear_scan_kernel<T><<<(unsigned)blocks, NT, 0, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(x), h0, static_cast<T*>(h),
        static_cast<T*>(h_last), S, C, n_chan);
    return cudaGetLastError();
}

}  // namespace

// a, x, h: (B, S, C); h0: (B, C) float32 or null (zeros); h_last: (B, C).
// a, x, h and h_last share one dtype: 0 = float32, 1 = bfloat16.
// Returns the CUDA error of the launch (0 = success).
extern "C" int linear_scan_fwd(const void* a, const void* x, const void* h0, void* h,
                               void* h_last, int B, int S, int C, int dtype, void* stream) {
    const float* h0f = static_cast<const float*>(h0);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (B <= 0 || S <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
    if (dtype == 0) return launch<float>(a, x, h0f, h, h_last, B, S, C, st);
    if (dtype == 1) return launch<__nv_bfloat16>(a, x, h0f, h, h_last, B, S, C, st);
    return (int)cudaErrorInvalidValue;
}
