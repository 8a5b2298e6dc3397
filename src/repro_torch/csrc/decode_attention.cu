// Decode attention for Hopper (sm_90a): one query token per slot against
// a ring-buffer KV cache, as flash-decoding with a split over the cache.
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention_pallas
// (the Pallas TPU kernel behind repro.kernels.ops.decode_attention).
// Plain version: src/repro_torch/kernels/ref.py::decode_attention.
//
// What bounds it on the H100: memory.  Each call reads the whole K and V
// cache once and does 4 FLOP per cache element (QK^T and PV for each of
// the `group` query heads of a kv head), far below the card's ~295
// FLOP/byte balance point; at B=8, W=768, Hkv=2, hd=128 in bf16 the
// bound is ~6.3 MB / 3.35 TB/s per layer.
//
// What the design does about it:
//  * the TPU kernel runs one program per (slot, q head) and walks the
//    cache in sequence; on Hopper that gives B*H blocks (96 at the
//    serving shapes) and reads each kv tile once per q head of its
//    group.  Here the grid is (cache split, kv head, slot): each block
//    reads its stretch of K and V once and applies it to all `group`
//    query heads that share the kv head, and the number of splits is
//    chosen by the wrapper so that the grid holds about two blocks per SM.
//  * a block stages its whole stretch of K and V (at most 64 entries) in
//    shared memory with 16-byte loads, all issued before any is waited
//    on, then computes from there.
//  * each split writes its partial softmax state (m, l, acc[group, hd])
//    in f32 to scratch that the wrapper allocates; a second small kernel
//    combines the splits and writes (B, H, hd) in q's dtype.
//  * a block has head_dim threads (256 at head_dim 256); its shared
//    memory at chunk 64 and a group of 16 is ~84 KB in bf16 and ~148 KB
//    in f32, above the 48 KB default, so the launch opts in.
//  * the mask is purely positional (0 <= pos <= t, pos > t - window), so
//    ring wrap-around, empty slots (pos = -1) and a ragged W need no
//    special case and the wrapper pads nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int MAX_GROUP = 16;
constexpr int MAX_CHUNK = 64;     // cache entries per split, staged in shared memory

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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}

// grid (n_split, Hkv, B), HD threads.  Partial state index:
// ((b * Hkv + kh) * n_split + split) * group + g.
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
                    const int* __restrict__ pos, const int* __restrict__ t,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc, int W, int H, int Hkv, int chunk, float scale,
                    int window) {
    constexpr int E = HD / 32;            // q/k elements per lane, 32 apart
    constexpr int NWARP = HD / 32;
    constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte load
    extern __shared__ __align__(16) unsigned char smem[];
    const int split = blockIdx.x;
    const int kh = blockIdx.y;
    const int b = blockIdx.z;
    const int n_split = gridDim.x;
    const int group = H / Hkv;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int w0 = split * chunk;
    const int n = min(chunk, W - w0);
    const int tb = t[b];
    // this split's K and V rows, staged whole: every load is issued before
    // any is waited on
    T* sk = reinterpret_cast<T*>(smem);                       // chunk x HD
    T* sv = sk + (size_t)chunk * HD;                          // chunk x HD
    float* sq = reinterpret_cast<float*>(sv + (size_t)chunk * HD);   // group x HD
    float* ss = sq + group * HD;          // group x chunk: scores, then probabilities
    int* sp = reinterpret_cast<int*>(ss + group * chunk);     // chunk positions

    const size_t row_stride = (size_t)Hkv * HD;
    const T* kb = kc + ((size_t)b * W + w0) * row_stride + (size_t)kh * HD;
    const T* vb = vc + ((size_t)b * W + w0) * row_stride + (size_t)kh * HD;
    for (int i = tid; i < n * (HD / VEC); i += HD) {
        const int w = i / (HD / VEC);
        const int c = (i % (HD / VEC)) * VEC;
        *reinterpret_cast<uint4*>(sk + w * HD + c) =
            *reinterpret_cast<const uint4*>(kb + (size_t)w * row_stride + c);
        *reinterpret_cast<uint4*>(sv + w * HD + c) =
            *reinterpret_cast<const uint4*>(vb + (size_t)w * row_stride + c);
    }
    const int* pb = pos + (size_t)b * W + w0;
    for (int i = tid; i < n; i += HD) sp[i] = pb[i];
    const T* qb = q + ((size_t)b * H + (size_t)kh * group) * HD;
    for (int i = tid; i < group * HD; i += HD) sq[i] = to_f32(qb[i]);
    __syncthreads();

    // scores: one warp per cache entry, all group heads at once
    for (int w = warp; w < n; w += NWARP) {
        float kv[E];
#pragma unroll
        for (int e = 0; e < E; ++e) kv[e] = to_f32(sk[w * HD + e * 32 + lane]);
        const int p = sp[w];
        bool valid = p >= 0 && p <= tb;
        if (window > 0) valid = valid && p > tb - window;
        for (int g = 0; g < group; ++g) {
            float d = 0.f;
#pragma unroll
            for (int e = 0; e < E; ++e) d += sq[g * HD + e * 32 + lane] * kv[e];
            d = warp_sum(d);
            if (lane == 0) ss[g * chunk + w] = valid ? d * scale : NEG_INF;
        }
    }
    __syncthreads();

    // per-head max and sum over this split
    const size_t pidx = ((size_t)(b * Hkv + kh) * n_split + split) * group;
    for (int g = warp; g < group; g += NWARP) {
        float mx = NEG_INF;
        for (int w = lane; w < n; w += 32) mx = fmaxf(mx, ss[g * chunk + w]);
        mx = warp_max(mx);
        float sum = 0.f;
        for (int w = lane; w < n; w += 32) {
            const float s = ss[g * chunk + w];
            const float p = (s == NEG_INF) ? 0.f : expf(s - mx);
            ss[g * chunk + w] = p;
            sum += p;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
            part_m[pidx + g] = mx;
            part_l[pidx + g] = sum;
        }
    }
    __syncthreads();

    // acc[g][d] = sum_w p[g][w] * v[w][d]; thread d
    float acc[MAX_GROUP];
#pragma unroll
    for (int g = 0; g < MAX_GROUP; ++g) acc[g] = 0.f;
    for (int w = 0; w < n; ++w) {
        const float vv = to_f32(sv[w * HD + tid]);
#pragma unroll
        for (int g = 0; g < MAX_GROUP; ++g)
            if (g < group) acc[g] += ss[g * chunk + w] * vv;
    }
#pragma unroll
    for (int g = 0; g < MAX_GROUP; ++g)
        if (g < group) part_acc[(pidx + g) * HD + tid] = acc[g];
}

// grid (H, B), HD threads: merge the splits of one (slot, q head).
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
decode_combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                      const float* __restrict__ part_acc, T* __restrict__ out, int H, int Hkv,
                      int n_split) {
    const int h = blockIdx.x;
    const int b = blockIdx.y;
    const int group = H / Hkv;
    const int kh = h / group;
    const int g = h % group;
    const int tid = threadIdx.x;
    const size_t base = (size_t)(b * Hkv + kh) * n_split * group + g;
    // the loops are unrolled so that their independent loads overlap
    float mx = NEG_INF;
#pragma unroll 8
    for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, part_m[base + (size_t)s * group]);
    float l = 0.f, a = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_split; ++s) {
        const size_t i = base + (size_t)s * group;
        const float c = expf(part_m[i] - mx);
        l += c * part_l[i];
        a += c * part_acc[i * HD + tid];
    }
    out[((size_t)b * H + h) * HD + tid] = from_f32<T>(a / fmaxf(l, 1e-30f));
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* kc, const void* vc, const int* pos, const int* t,
                   float* part_m, float* part_l, float* part_acc, void* out, int B, int W, int H,
                   int Hkv, int chunk, int n_split, float scale, int window,
                   cudaStream_t stream) {
    const int group = H / Hkv;
    const size_t smem = 2 * sizeof(T) * (size_t)chunk * HD
                        + sizeof(float) * (size_t)group * (HD + chunk) + sizeof(int) * chunk;
    cudaError_t err = cudaFuncSetAttribute(decode_split_kernel<T, HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid1(n_split, Hkv, B);
    decode_split_kernel<T, HD><<<grid1, HD, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc), pos, t,
        part_m, part_l, part_acc, W, H, Hkv, chunk, scale, window);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    dim3 grid2(H, B);
    decode_combine_kernel<T, HD><<<grid2, HD, 0, stream>>>(part_m, part_l, part_acc,
                                                            static_cast<T*>(out), H, Hkv,
                                                            n_split);
    return cudaGetLastError();
}

}  // namespace

// q: (B, H, hd); k_cache, v_cache: (B, W, Hkv, hd); cache_pos: (B, W)
// int32; t: (B,) int32; part_m, part_l: (B, Hkv, n_split, group) f32;
// part_acc: (B, Hkv, n_split, group, hd) f32; out like q.  dtype: 0 =
// float32, 1 = bfloat16; hd 64, 128 or 256; group = H / Hkv <= 16; chunk *
// n_split >= W and chunk <= 64.  Returns the CUDA error (0 = success).
extern "C" int decode_attention_fwd(const void* q, const void* kc, const void* vc,
                                    const void* cache_pos, const void* t, void* part_m,
                                    void* part_l, void* part_acc, void* out, int B, int W, int H,
                                    int Hkv, int hd, int dtype, int chunk, int n_split,
                                    float scale, int window, void* stream) {
    const int* pos = static_cast<const int*>(cache_pos);
    const int* tt = static_cast<const int*>(t);
    float* pm = static_cast<float*>(part_m);
    float* pl = static_cast<float*>(part_l);
    float* pa = static_cast<float*>(part_acc);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (H % Hkv != 0 || H / Hkv > MAX_GROUP || chunk > MAX_CHUNK || chunk <= 0)
        return (int)cudaErrorInvalidValue;
    if (dtype == 1 && hd == 256)
        return launch<__nv_bfloat16, 256>(q, kc, vc, pos, tt, pm, pl, pa, out, B, W, H, Hkv, chunk,
                                          n_split, scale, window, st);
    if (dtype == 1 && hd == 128)
        return launch<__nv_bfloat16, 128>(q, kc, vc, pos, tt, pm, pl, pa, out, B, W, H, Hkv, chunk,
                                          n_split, scale, window, st);
    if (dtype == 1 && hd == 64)
        return launch<__nv_bfloat16, 64>(q, kc, vc, pos, tt, pm, pl, pa, out, B, W, H, Hkv, chunk,
                                         n_split, scale, window, st);
    if (dtype == 0 && hd == 256)
        return launch<float, 256>(q, kc, vc, pos, tt, pm, pl, pa, out, B, W, H, Hkv, chunk,
                                  n_split, scale, window, st);
    if (dtype == 0 && hd == 128)
        return launch<float, 128>(q, kc, vc, pos, tt, pm, pl, pa, out, B, W, H, Hkv, chunk,
                                  n_split, scale, window, st);
    if (dtype == 0 && hd == 64)
        return launch<float, 64>(q, kc, vc, pos, tt, pm, pl, pa, out, B, W, H, Hkv, chunk,
                                 n_split, scale, window, st);
    return (int)cudaErrorInvalidValue;
}
