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
// 0.060 ms at 3.35 TB/s.  The card reaches that only with a few MB of
// loads in flight at every moment, while the recurrence is a chain of
// dependent multiply-adds along S.
//
// What the design does about it:
//  * the TPU kernel walks time blocks in sequence on its grid, carrying
//    the state in VMEM scratch, and runs a log-depth associative scan
//    inside each (256, 256) block.  Blocks of a CUDA grid run in no
//    order, so here one block owns a tile of TC = 32 * V channels of one
//    batch row (V adjacent channels a thread, one V-wide load per step)
//    and walks all of S itself, in spans of TS = W * L steps.
//  * inside a span the block's W warps split time: warp w takes steps
//    [w * L, (w + 1) * L) of the tile.  Phase 1: each thread, its L steps
//    of a and x already in registers, scans its slice from 0, giving the
//    slice's aggregate (A = prod a, H = the state from 0).  Phase 2:
//    after the span's one block barrier, each thread folds the aggregates
//    of the warps before its own, in warp order, into the span's carry:
//    its carry-in.  Phase 3: each thread reruns h = a * h + x over its
//    registers from its carry-in and stores h; the last warp's final
//    state is the next span's carry, through shared memory.
//  * the next span's loads are issued between phases 2 and 3, into a
//    second set of registers kept raw (in the input's type, converted at
//    use), so no instruction waits on them before the next span: device
//    memory stays busy across the span boundary.
//  * shared memory (aggregates and carry) is double-buffered by span
//    parity, so the one barrier per span orders every read and write of
//    it.  Nothing crosses blocks: no scratch, no flags, no atomics, and
//    the combine order is fixed, so two calls and a CUDA-graph replay
//    give the same bits.
//  * the plan (linear_scan_plan): B * C * TS elements each of a and x
//    are in flight, so a large state row takes short spans (W = 8, L =
//    4) in wide tiles (V = 4 where C allows it), two blocks per SM, and a
//    small one long spans (W = 16, L = 8) in 32-channel tiles, which also
//    put B * C / 32 blocks on the card (128 at B = 1, C = 4096).
//  * no padding of S or C (the Pallas wrapper pads to its 256-row,
//    128-lane blocks): channels past C are neither read nor written,
//    steps past S are identities; h_last is the state at step S - 1.
//  * a = 0 resets the state: the slice's A is then 0 and drops the
//    carry, as the recurrence does.  A product A that underflows to 0 in
//    f32 (below ~1e-45, e.g. four factors of 1e-12) drops a carry whose
//    true weight is below f32's range, so the result differs from the
//    step-by-step recurrence by less than that weight times the carry.
//
// The gradient (linear_scan_bwd) is the same kernel run in reverse time
// (REV).  With g = dL/dh and g_last = dL/dh_last:
//    dh_{S-1} = g_{S-1} + g_last,   dh_t = g_t + a_{t+1} dh_{t+1},
//    dx_t = dh_t,   da_t = dh_t h_{t-1} (h_{-1} = h0 or 0),   dh0 = a_0 dh_0.
// So reversed step u = S - 1 - t scans with coefficient a_{t+1} (1 at
// u = 0) and input g_t from the carry g_last, through the same spans,
// slices and warp-order fold; phase 3 writes dx_t and, from the forward's
// h_{t-1} loaded with the slice, da_t, and the step t = 0 writes dh0.
// Reads a, g and h once, writes dx and da once.  A reset (a_t = 0) gives
// a_t dh_t = 0 at step t - 1, so the gradient stops at segment starts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// V adjacent elements, moved as one access of V * sizeof(T) bytes.
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
    T v[V];
};

// The L steps [t0, t0 + L) of a thread's V channels into registers, raw:
// forward, a_t and x_t at t = t0 + i; reverse (REV), for the reversed step
// u = t0 + i at time t = S - 1 - u, the coefficient a_{t+1} (1 at t = S -
// 1), the input g_t (in x) and the forward's h_{t-1} (in rh; none at t =
// 0).  Steps past S (and a tile's channels past C) are not read.
template <bool REV, typename T, int V, int L>
__device__ __forceinline__ void load_slice(Vec<T, V> (&ra)[L], Vec<T, V> (&rx)[L],
                                           Vec<T, V> (&rh)[L], const T* __restrict__ a,
                                           const T* __restrict__ x, const T* __restrict__ hs,
                                           size_t base, int t0, int S, int C, bool live) {
#pragma unroll
    for (int i = 0; i < L; ++i) {
        const int u = t0 + i;
        if (live && u < S) {
            if constexpr (!REV) {
                const size_t off = base + (size_t)u * C;
                ra[i] = *reinterpret_cast<const Vec<T, V>*>(a + off);
                rx[i] = *reinterpret_cast<const Vec<T, V>*>(x + off);
            } else {
                const int t = S - 1 - u;
                const size_t off = base + (size_t)t * C;
                rx[i] = *reinterpret_cast<const Vec<T, V>*>(x + off);
                if (t + 1 < S) {
                    ra[i] = *reinterpret_cast<const Vec<T, V>*>(a + off + C);
                } else {
#pragma unroll
                    for (int j = 0; j < V; ++j) ra[i].v[j] = from_f32<T>(1.f);
                }
                if (t > 0) rh[i] = *reinterpret_cast<const Vec<T, V>*>(hs + off - C);
            }
        }
    }
}

// Grid (ceil(C / TC), B); block 32 * W threads.  carry0 (the state before
// the first step: h0 forward, g_last reverse) is f32 or null (zeros).
// Forward: h_t into h, the state at S - 1 into h_last.  Reverse (REV): x
// holds g, hs the forward's h and h0 its initial state (f32 or null); dx_t
// goes into h, da_t into da and, where dh0 is not null, a_0 dh_0 into dh0
// (f32).
template <bool REV, typename T, int V, int W, int L>
__global__ void __launch_bounds__(32 * W)
linear_scan_kernel(const T* __restrict__ a, const T* __restrict__ x,
                   const float* __restrict__ carry0, T* __restrict__ h, T* __restrict__ h_last,
                   const T* __restrict__ hs, const float* __restrict__ h0, T* __restrict__ da,
                   float* __restrict__ dh0, int S, int C) {
    constexpr int TC = 32 * V;
    constexpr int TS = W * L;
    using Vt = Vec<T, V>;
    // [span parity][warp][channel of the thread][lane]: conflict-free
    __shared__ float agg_a[2][W][V][32], agg_h[2][W][V][32];
    __shared__ float carry[2][V][32];

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int c = blockIdx.x * TC + lane * V;
    const bool live = c < C;                  // C % V == 0: all V channels or none
    const size_t base = (size_t)blockIdx.y * S * C + c;

    if (warp == 0) {
#pragma unroll
        for (int j = 0; j < V; ++j)
            carry[0][j][lane] = (carry0 != nullptr && live)
                                    ? carry0[(size_t)blockIdx.y * C + c + j] : 0.f;
    }

    Vt ca[L] = {}, cx[L] = {}, ch[L] = {}, na[L] = {}, nx[L] = {}, nh[L] = {};
    load_slice<REV, T, V, L>(ca, cx, ch, a, x, hs, base, warp * L, S, C, live);
    const int n_spans = (S + TS - 1) / TS;
    for (int k = 0; k < n_spans; ++k) {
        const int p = k & 1;
        const int t0 = k * TS + warp * L;

        // phase 1: the slice's aggregate from a zero state
        float A[V], H[V];
#pragma unroll
        for (int j = 0; j < V; ++j) A[j] = 1.f, H[j] = 0.f;
#pragma unroll
        for (int i = 0; i < L; ++i) {
            if (t0 + i < S) {
#pragma unroll
                for (int j = 0; j < V; ++j) {
                    const float av = to_f32(ca[i].v[j]);
                    H[j] = fmaf(av, H[j], to_f32(cx[i].v[j]));
                    A[j] *= av;
                }
            }
        }
#pragma unroll
        for (int j = 0; j < V; ++j) {
            agg_a[p][warp][j][lane] = A[j];
            agg_h[p][warp][j][lane] = H[j];
        }
        __syncthreads();

        // phase 2: the carry-in, the span's carry folded through the
        // slices before this warp's, in warp order
        float st[V];
#pragma unroll
        for (int j = 0; j < V; ++j) st[j] = carry[p][j][lane];
#pragma unroll
        for (int w = 0; w < W - 1; ++w) {
            if (w < warp) {
#pragma unroll
                for (int j = 0; j < V; ++j)
                    st[j] = fmaf(agg_a[p][w][j][lane], st[j], agg_h[p][w][j][lane]);
            }
        }

        // the next span's loads, in flight through phase 3
        if (k + 1 < n_spans)
            load_slice<REV, T, V, L>(na, nx, nh, a, x, hs, base, t0 + TS, S, C, live);

        // phase 3: the slice again from its carry-in, stored
#pragma unroll
        for (int i = 0; i < L; ++i) {
            const int u = t0 + i;
            if (u < S) {
                Vt out;
#pragma unroll
                for (int j = 0; j < V; ++j) {
                    st[j] = fmaf(to_f32(ca[i].v[j]), st[j], to_f32(cx[i].v[j]));
                    out.v[j] = from_f32<T>(st[j]);
                }
                if constexpr (!REV) {
                    if (live) {
                        *reinterpret_cast<Vt*>(h + base + (size_t)u * C) = out;
                        if (u == S - 1)
                            *reinterpret_cast<Vt*>(h_last + (size_t)blockIdx.y * C + c) = out;
                    }
                } else if (live) {
                    const int t = S - 1 - u;
                    const size_t off = base + (size_t)t * C;
                    Vt d;
#pragma unroll
                    for (int j = 0; j < V; ++j) {
                        const float hp = t > 0 ? to_f32(ch[i].v[j])
                                         : h0 != nullptr ? h0[(size_t)blockIdx.y * C + c + j]
                                                         : 0.f;
                        d.v[j] = from_f32<T>(st[j] * hp);
                    }
                    *reinterpret_cast<Vt*>(h + off) = out;
                    *reinterpret_cast<Vt*>(da + off) = d;
                    if (t == 0 && dh0 != nullptr) {
                        const Vt a0 = *reinterpret_cast<const Vt*>(a + base);
#pragma unroll
                        for (int j = 0; j < V; ++j)
                            dh0[(size_t)blockIdx.y * C + c + j] = to_f32(a0.v[j]) * st[j];
                    }
                }
            }
        }
        if (warp == W - 1) {
#pragma unroll
            for (int j = 0; j < V; ++j) carry[p ^ 1][j][lane] = st[j];
        }
#pragma unroll
        for (int i = 0; i < L; ++i) ca[i] = na[i], cx[i] = nx[i], ch[i] = nh[i];
    }
}

template <typename T, int V, int W, int L>
cudaError_t launch(const void* a, const void* x, const float* h0, void* h, void* h_last, int B,
                   int S, int C, cudaStream_t stream) {
    const dim3 grid((unsigned)((C + 32 * V - 1) / (32 * V)), (unsigned)B);
    linear_scan_kernel<false, T, V, W, L><<<grid, 32 * W, 0, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(x), h0, static_cast<T*>(h),
        static_cast<T*>(h_last), nullptr, nullptr, nullptr, nullptr, S, C);
    return cudaGetLastError();
}

template <typename T, int V, int W, int L>
cudaError_t launch_bwd(const void* a, const void* hs, const float* h0, const void* g,
                       const float* g_last, void* dx, void* da, float* dh0, int B, int S, int C,
                       cudaStream_t stream) {
    const dim3 grid((unsigned)((C + 32 * V - 1) / (32 * V)), (unsigned)B);
    linear_scan_kernel<true, T, V, W, L><<<grid, 32 * W, 0, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(g), g_last, static_cast<T*>(dx),
        nullptr, static_cast<const T*>(hs), h0, static_cast<T*>(da), dh0, S, C);
    return cudaGetLastError();
}

}  // namespace

// The plans built into the library, as X(V, W, L).  A timing experiment
// may define LS_PLANS before including this file to build others.
#ifndef LS_PLANS
#define LS_PLANS(X) X(4, 8, 4) X(2, 8, 4) X(1, 8, 4) X(1, 16, 8)
#endif

// The plan linear_scan_fwd takes for B, C and dtype (0 = float32,
// 1 = bfloat16): out = {V, W, L}.  A state row of B * C elements of at
// least 128 KB puts 8 MB of a and x in flight in spans of 32 steps: V as
// wide as C allows (4, 2 or 1), 8 warps of 4 steps; at B = 8, C = 4096 in
// f32 that is 256 blocks, two per SM.  A smaller row takes 32-channel
// tiles (B * C / 32 blocks: 128 at B = 1, C = 4096) of 16 warps of 8
// steps, spans of 128.  Returns 0.
extern "C" int linear_scan_plan(int B, int C, int dtype, int* out) {
    const long long row_bytes = (long long)B * C * (dtype == 0 ? 4 : 2);
    const bool short_spans = row_bytes >= (128 << 10);
    out[0] = !short_spans ? 1 : C % 4 == 0 ? 4 : C % 2 == 0 ? 2 : 1;
    out[1] = short_spans ? 8 : 16;
    out[2] = short_spans ? 4 : 8;
    return 0;
}

// a, x, h: (B, S, C); h0: (B, C) float32 or null (zeros); h_last: (B, C).
// a, x, h and h_last share one dtype: 0 = float32, 1 = bfloat16; every
// pointer 16-byte aligned.  Runs plan (V, W, L), which must be one of
// LS_PLANS with V dividing C.  Returns the CUDA error of the launch
// (0 = success).
extern "C" int linear_scan_fwd_plan(const void* a, const void* x, const void* h0, void* h,
                                    void* h_last, int B, int S, int C, int dtype, int v, int w,
                                    int l, void* stream) {
    const float* h0f = static_cast<const float*>(h0);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (B <= 0 || S <= 0 || C <= 0 || B > 65535 || v <= 0 || C % v)
        return (int)cudaErrorInvalidValue;
#define LS_DISPATCH(V, W, L)                                                          \
    if (v == V && w == W && l == L) {                                                 \
        if (dtype == 0) return (int)launch<float, V, W, L>(a, x, h0f, h, h_last, B, S, C, st); \
        if (dtype == 1)                                                               \
            return (int)launch<__nv_bfloat16, V, W, L>(a, x, h0f, h, h_last, B, S, C, st); \
        return (int)cudaErrorInvalidValue;                                            \
    }
    LS_PLANS(LS_DISPATCH)
#undef LS_DISPATCH
    return (int)cudaErrorInvalidValue;
}

// As linear_scan_fwd_plan, at the plan linear_scan_plan picks.
extern "C" int linear_scan_fwd(const void* a, const void* x, const void* h0, void* h,
                               void* h_last, int B, int S, int C, int dtype, void* stream) {
    int plan[3];
    linear_scan_plan(B, C, dtype, plan);
    return linear_scan_fwd_plan(a, x, h0, h, h_last, B, S, C, dtype, plan[0], plan[1], plan[2],
                                stream);
}

// The gradient of linear_scan_fwd (the reverse-time kernel, REV above):
// a, hs (the forward's h), g (dL/dh), dx, da: (B, S, C) of one dtype (0 =
// float32, 1 = bfloat16); h0 (the forward's initial state), g_last
// (dL/dh_last) and dh0: (B, C) float32, each may be null (zeros; no dh0).
// Every pointer 16-byte aligned.  Runs the plan linear_scan_plan picks.
// Returns the CUDA error of the launch (0 = success).
extern "C" int linear_scan_bwd(const void* a, const void* hs, const void* h0, const void* g,
                               const void* g_last, void* dx, void* da, void* dh0, int B, int S,
                               int C, int dtype, void* stream) {
    int plan[3];
    linear_scan_plan(B, C, dtype, plan);
    const int v = plan[0], w = plan[1], l = plan[2];
    const float* h0f = static_cast<const float*>(h0);
    const float* glf = static_cast<const float*>(g_last);
    float* dh0f = static_cast<float*>(dh0);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (B <= 0 || S <= 0 || C <= 0 || B > 65535 || C % v) return (int)cudaErrorInvalidValue;
#define LS_BWD_DISPATCH(V, W, L)                                                             \
    if (v == V && w == W && l == L) {                                                        \
        if (dtype == 0)                                                                      \
            return (int)launch_bwd<float, V, W, L>(a, hs, h0f, g, glf, dx, da, dh0f, B, S, C, \
                                                   st);                                      \
        if (dtype == 1)                                                                      \
            return (int)launch_bwd<__nv_bfloat16, V, W, L>(a, hs, h0f, g, glf, dx, da, dh0f, \
                                                           B, S, C, st);                     \
        return (int)cudaErrorInvalidValue;                                                   \
    }
    LS_PLANS(LS_BWD_DISPATCH)
#undef LS_BWD_DISPATCH
    return (int)cudaErrorInvalidValue;
}
