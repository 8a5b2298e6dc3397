// Prefill attention backward for Hopper (sm_90a): dQ, dK and dV of the
// forward's exact masked attention (flash_attention.cu) over a full
// right-padded or packed sequence, with GQA, causal and sliding-window
// masks and segment ids (a key is visible only within its query's
// segment, padding's -1 included).
//
// Replaces: no Pallas kernel.  The JAX package never wrote a backward:
// its trainer differentiates the jnp oracle repro.kernels.ref.flash_attention
// with XLA's autodiff.  This is the gradient of the port's forward kernel
// on the trainer's path.  Plain version:
// src/repro_torch/kernels/ref.py::flash_attention_bwd.
//
// The algorithm is FlashAttention-2's, without atomics, so a call is
// bitwise repeatable:
//  1. prep: D = rowsum(dO o O) per (batch, head, row) in f32, and each
//     64-row tile's [min, max] segment id;
//  2. dkdv: one block per (key tile, query head, batch) walks the query
//     tiles that can see its keys, recomputes P = exp(S scale - lse) from
//     the forward's log-sum-exp and accumulates dV += P^T dO and
//     dK += dS^T Q with dS = P o (dO V^T - D); each query head writes its
//     own f32 partial, and
//  3. dq: one block per (query tile, query head, batch) walks the key
//     tiles its rows can see and accumulates dQ += dS K (in bf16, dkdv and
//     dq are one launch: they need only prep's results);
//  4. reduce sums a kv head's group of partials in head order into dK and
//     dV (no cross-block reduction order to vary, and B x S/64 x H blocks
//     in flight rather than B x S/64 x Hkv).
// A tile pair that the causal mask, the window or disjoint segment ranges
// hide entirely is skipped.  A row whose lse is -inf (it saw no key)
// gets P = 0, so zero gradients and never NaN.
//
// What bounds it on the H100: the five products of a tile pair (S and dP
// recomputed by both passes) are ~3.7 M multiply-adds at head_dim 128
// against ~100 KB of tiles, far above the card's balance point:
// operations bound it.  bf16 (the training dtype) runs the products on
// the tensor cores with mma.sync, P and dS rounded to bf16 as their A
// operands (FlashAttention-2's rounding), everything else in f32; no
// wgmma or TMA yet.  f32 (the CPU-parity dtype) runs plain FMA loops over
// tiles staged in shared memory, each thread holding a 4 x N register
// tile, rows padded to an odd stride so that row- and column-wise reads
// are free of bank conflicts.  head_dim 64 or 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "decode_body.cuh"   // ldmatrix, mma.sync m16n8k16, cp.async, pack_bf16

namespace {

constexpr int BT = 64;    // rows of a query tile and of a key tile
constexpr int NT = 256;   // threads of a block: 16 x 16, thread (ty, tx)
constexpr int LDP = BT + 1;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// shared f32 tiles of 64 rows, rows LD = HD + 1 apart
template <int HD>
struct Tiles {
    static constexpr int LD = HD + 1;
    static constexpr size_t TILE = sizeof(float) * BT * LD;
    static constexpr size_t PT = sizeof(float) * BT * LDP;
};

// rows [r0, r0 + 64) of head hx of x (B, S, Hx, HD) into a shared tile;
// rows past S read as zeros
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ x, int b, int r0,
                                          int hx, int S, int Hx, int tid) {
    for (int i = tid; i < BT * HD; i += NT) {
        const int r = i / HD, c = i % HD;
        const int row = r0 + r;
        dst[r * (HD + 1) + c] =
            row < S ? to_f(x[(((size_t)b * S + row) * Hx + hx) * HD + c]) : 0.f;
    }
}

// acc[i][j] += sum_k A(ty + 16 i, k) B(k, tx + 16 j) over k < K, where
// A(m, k) = A[m AM + k AK] and B(k, n) = B[k BK + n BN] in shared memory.
// With odd row strides the 16 distinct addresses a warp reads at once lie
// in 16 distinct banks.
template <int NJ, int K, int AM, int AK, int BK_, int BN>
__device__ __forceinline__ void mm(float (&acc)[4][NJ], const float* A, const float* B, int ty,
                                   int tx) {
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
        float a[4], bb[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * AM + k * AK];
#pragma unroll
        for (int j = 0; j < NJ; ++j) bb[j] = B[k * BK_ + (tx + 16 * j) * BN];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
}

template <int NJ>
__device__ __forceinline__ void zero(float (&acc)[4][NJ]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
}

struct Mask {
    int S, causal, window;
    __device__ __forceinline__ bool operator()(int qpos, int kpos, int sq, int sk) const {
        bool ok = qpos < S && kpos < S && sq == sk;
        if (causal) ok = ok && qpos >= kpos;
        if (window > 0) ok = ok && qpos - kpos < window;
        return ok;
    }
};

// P and dS of a (query tile, key tile) pair from S = Q K^T and dP = dO V^T
// in registers: element (i, j) is query row ty + 16 i, key tx + 16 j.
// Writes P (when sp is not null) and dS into shared tiles, rows = queries.
__device__ __forceinline__ void probs(const float (&s)[4][4], const float (&dp)[4][4], float* sp,
                                      float* sds, const float* slse, const float* sdelta,
                                      const int* sseg_q, const int* sseg_k, int q0, int k0,
                                      float scale, const Mask& mask, int ty, int tx) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const float l = slse[r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int c = tx + 16 * j;
            const bool ok = l > -INFINITY && mask(q0 + r, k0 + c, sseg_q[r], sseg_k[c]);
            const float p = ok ? expf(s[i][j] * scale - l) : 0.f;
            if (sp != nullptr) sp[r * LDP + c] = p;
            sds[r * LDP + c] = p * (dp[i][j] - sdelta[r]);
        }
    }
}

// ---------------------------------------------------------------------------
// 1. D = rowsum(dO o O), and the segment range of every 64-row tile
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
bwd_prep_kernel(const T* __restrict__ out, const T* __restrict__ dout, const int* __restrict__ seg,
                float* __restrict__ delta, int* __restrict__ tile_seg, int B, int S, int H) {
    const int warp = (blockIdx.x * NT + threadIdx.x) / 32;
    const int lane = threadIdx.x % 32;
    const int rows = B * S * H;
    if (warp < rows) {   // row (b, s, h) of out and dout
        const size_t base = (size_t)warp * HD;
        float acc = 0.f;
        for (int c = lane; c < HD; c += 32) acc += to_f(out[base + c]) * to_f(dout[base + c]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
        const int h = warp % H, s = (warp / H) % S, b = warp / (H * S);
        if (lane == 0) delta[((size_t)b * H + h) * S + s] = acc;
    }
    const int nt = (S + BT - 1) / BT;
    if (warp < B * nt) {   // tile t of batch row b: [min, max] of its segment ids
        const int b = warp / nt, t = warp % nt;
        int lo = INT_MAX, hi = INT_MIN;
        for (int r = t * BT + lane; r < min(S, (t + 1) * BT); r += 32) {
            lo = min(lo, seg[(size_t)b * S + r]);
            hi = max(hi, seg[(size_t)b * S + r]);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
            hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
        }
        if (lane == 0) {
            tile_seg[2 * warp] = lo;
            tile_seg[2 * warp + 1] = hi;
        }
    }
}

// the segment ranges of query tile qt and key tile kt of batch row b overlap
__device__ __forceinline__ bool segments_meet(const int* tile_seg, int b, int nt, int qt,
                                              int kt) {
    const int* a = tile_seg + 2 * (b * nt + qt);
    const int* c = tile_seg + 2 * (b * nt + kt);
    return a[0] <= c[1] && c[0] <= a[1];
}

// stage a tile's segment ids (0 past S: those rows are masked by position)
__device__ __forceinline__ void load_seg(int* dst, const int* seg, int b, int r0, int S,
                                         int tid) {
    if (tid < BT) dst[tid] = r0 + tid < S ? seg[(size_t)b * S + r0 + tid] : 0;
}

// ---------------------------------------------------------------------------
// 2. dK, dV partials: one block per (key tile, query head, batch row)
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(NT, 1)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, const int* __restrict__ seg,
                const int* __restrict__ tile_seg, float* __restrict__ dk_part,
                float* __restrict__ dv_part, int S, int H, int Hkv, float scale, int causal,
                int window) {
    using L = Tiles<HD>;
    constexpr int LD = L::LD, NJ = HD / 16;
    extern __shared__ __align__(16) unsigned char smem[];
    float* sK = reinterpret_cast<float*>(smem);
    float* sV = reinterpret_cast<float*>(smem + L::TILE);
    float* sQ = reinterpret_cast<float*>(smem + 2 * L::TILE);
    float* sdO = reinterpret_cast<float*>(smem + 3 * L::TILE);
    float* sP = reinterpret_cast<float*>(smem + 4 * L::TILE);
    float* sdS = reinterpret_cast<float*>(smem + 4 * L::TILE + L::PT);
    float* slse = reinterpret_cast<float*>(smem + 4 * L::TILE + 2 * L::PT);
    float* sdelta = slse + BT;
    int* sseg_q = reinterpret_cast<int*>(sdelta + BT);
    int* sseg_k = sseg_q + BT;

    const int h = blockIdx.x, b = blockIdx.y, kt = blockIdx.z;   // the heaviest causal tiles first
    const int kh = h / (H / Hkv);
    const int k0 = kt * BT;
    const int nt = (S + BT - 1) / BT;
    const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
    const Mask mask{S, causal, window};

    load_rows<T, HD>(sK, k, b, k0, kh, S, Hkv, tid);
    load_rows<T, HD>(sV, v, b, k0, kh, S, Hkv, tid);
    load_seg(sseg_k, seg, b, k0, S, tid);
    // query tiles that can see a key of this tile
    const int qt_begin = causal ? kt : 0;
    const int qt_end = window > 0 ? min(nt, (k0 + BT - 1 + window - 1) / BT + 1) : nt;

    float dk[4][NJ], dv[4][NJ];
    zero(dk);
    zero(dv);
    for (int qt = qt_begin; qt < qt_end; ++qt) {
        if (!segments_meet(tile_seg, b, nt, qt, kt)) continue;
        const int q0 = qt * BT;
        __syncthreads();   // the previous tile's readers are done
        load_rows<T, HD>(sQ, q, b, q0, h, S, H, tid);
        load_rows<T, HD>(sdO, dout, b, q0, h, S, H, tid);
        load_seg(sseg_q, seg, b, q0, S, tid);
        if (tid < BT) {
            const bool in = q0 + tid < S;
            slse[tid] = in ? lse[((size_t)b * H + h) * S + q0 + tid] : -INFINITY;
            sdelta[tid] = in ? delta[((size_t)b * H + h) * S + q0 + tid] : 0.f;
        }
        __syncthreads();
        float s[4][4], dp[4][4];
        zero(s);
        zero(dp);
        mm<4, HD, LD, 1, 1, LD>(s, sQ, sK, ty, tx);      // S = Q K^T
        mm<4, HD, LD, 1, 1, LD>(dp, sdO, sV, ty, tx);    // dP = dO V^T
        probs(s, dp, sP, sdS, slse, sdelta, sseg_q, sseg_k, q0, k0, scale, mask, ty, tx);
        __syncthreads();
        // rows of dV and dK are keys: A(key, r) = P[r][key]
        mm<NJ, BT, 1, LDP, LD, 1>(dv, sP, sdO, ty, tx);  // dV += P^T dO
        mm<NJ, BT, 1, LDP, LD, 1>(dk, sdS, sQ, ty, tx);  // dK += dS^T Q
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int key = k0 + ty + 16 * i;
        if (key >= S) continue;
        const size_t row = (((size_t)b * S + key) * H + h) * HD;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            dk_part[row + tx + 16 * j] = dk[i][j] * scale;
            dv_part[row + tx + 16 * j] = dv[i][j];
        }
    }
}

// ---------------------------------------------------------------------------
// 3. dK, dV: a kv head's group of partials summed in head order
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(NT)
bwd_reduce_kernel(const float* __restrict__ dk_part, const float* __restrict__ dv_part,
                  T* __restrict__ dk, T* __restrict__ dv, int B, int S, int H, int Hkv, int HD) {
    const size_t i = (size_t)blockIdx.x * NT + threadIdx.x;   // element (b, s, kh, c) of dk
    if (i >= (size_t)B * S * Hkv * HD) return;
    const int g = H / Hkv;
    const int c = i % HD;
    const size_t bskh = i / HD;               // (b, s) * Hkv + kh
    const int kh = bskh % Hkv;
    const size_t base = ((bskh / Hkv) * H + (size_t)kh * g) * HD + c;
    float sk = 0.f, sv = 0.f;
    for (int j = 0; j < g; ++j) {
        sk += dk_part[base + (size_t)j * HD];
        sv += dv_part[base + (size_t)j * HD];
    }
    store(dk + i, sk);
    store(dv + i, sv);
}

// ---------------------------------------------------------------------------
// 4. dQ: one block per (query tile, query head, batch row)
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(NT, 1)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, const int* __restrict__ seg,
              const int* __restrict__ tile_seg, T* __restrict__ dq, int S, int H, int Hkv,
              float scale, int causal, int window) {
    using L = Tiles<HD>;
    constexpr int LD = L::LD, NJ = HD / 16;
    extern __shared__ __align__(16) unsigned char smem[];
    float* sQ = reinterpret_cast<float*>(smem);
    float* sdO = reinterpret_cast<float*>(smem + L::TILE);
    float* sK = reinterpret_cast<float*>(smem + 2 * L::TILE);
    float* sV = reinterpret_cast<float*>(smem + 3 * L::TILE);
    float* sdS = reinterpret_cast<float*>(smem + 4 * L::TILE);
    float* slse = reinterpret_cast<float*>(smem + 4 * L::TILE + L::PT);
    float* sdelta = slse + BT;
    int* sseg_q = reinterpret_cast<int*>(sdelta + BT);
    int* sseg_k = sseg_q + BT;

    const int h = blockIdx.x, b = blockIdx.y;
    const int nt = (S + BT - 1) / BT;
    const int qt = nt - 1 - blockIdx.z;   // the heaviest causal tiles first
    const int q0 = qt * BT;
    const int kh = h / (H / Hkv);
    const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
    const Mask mask{S, causal, window};

    load_rows<T, HD>(sQ, q, b, q0, h, S, H, tid);
    load_rows<T, HD>(sdO, dout, b, q0, h, S, H, tid);
    load_seg(sseg_q, seg, b, q0, S, tid);
    if (tid < BT) {
        const bool in = q0 + tid < S;
        slse[tid] = in ? lse[((size_t)b * H + h) * S + q0 + tid] : -INFINITY;
        sdelta[tid] = in ? delta[((size_t)b * H + h) * S + q0 + tid] : 0.f;
    }
    // key tiles holding a key some row of this tile can see
    const int kt_end = causal ? qt + 1 : nt;
    const int kt_begin = (window > 0 && q0 - window + 1 > 0) ? (q0 - window + 1) / BT : 0;

    float acc[4][NJ];
    zero(acc);
    for (int kt = kt_begin; kt < kt_end; ++kt) {
        if (!segments_meet(tile_seg, b, nt, qt, kt)) continue;
        const int k0 = kt * BT;
        __syncthreads();
        load_rows<T, HD>(sK, k, b, k0, kh, S, Hkv, tid);
        load_rows<T, HD>(sV, v, b, k0, kh, S, Hkv, tid);
        load_seg(sseg_k, seg, b, k0, S, tid);
        __syncthreads();
        float s[4][4], dp[4][4];
        zero(s);
        zero(dp);
        mm<4, HD, LD, 1, 1, LD>(s, sQ, sK, ty, tx);
        mm<4, HD, LD, 1, 1, LD>(dp, sdO, sV, ty, tx);
        probs(s, dp, nullptr, sdS, slse, sdelta, sseg_q, sseg_k, q0, k0, scale, mask, ty, tx);
        __syncthreads();
        mm<NJ, BT, LDP, 1, LD, 1>(acc, sdS, sK, ty, tx);   // dQ += dS K
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty + 16 * i;
        if (row >= S) continue;
        T* dst = dq + (((size_t)b * S + row) * H + h) * HD;
#pragma unroll
        for (int j = 0; j < NJ; ++j) store(dst + tx + 16 * j, acc[i][j] * scale);
    }
}

// ---------------------------------------------------------------------------
// bf16: the dK/dV and dQ passes on the tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------
//
// A block is 8 warps.  In dkdv, warp w owns keys 16 (w % 4) .. + 15 of
// the block's key tile and queries 32 (w / 4) .. + 31 of each query tile;
// it computes S^T = K Q^T and dP^T = V dO^T with the keys as the rows, so
// that P^T and dS^T, rounded to bf16, are the A fragments of dV += P^T dO
// and dK += dS^T Q straight from the accumulators (K and V rows are A by
// ldmatrix, Q and dO rows B, and B again by ldmatrix.trans for the
// second products).  The two warps of a key row sum their dK and dV in
// fixed order through shared memory at the end.  dq mirrors it with the
// queries as the rows: S = Q K^T, dP = dO V^T, dQ += dS K, warp w owning
// queries 16 (w % 4) .. + 15 and keys 32 (w / 4) .. + 31 of each key
// tile.  The streamed tiles (Q and dO, or K and V) come by cp.async into
// two stages, the next tile's copies in flight while the current one is
// used.  Rows are HD + 8 bf16 apart, so the eight rows an ldmatrix reads
// lie in distinct banks.

namespace tc {

using attn::cp_async_16;
using attn::pack_bf16;
using attn::smem_u32;
using dec::cp_async_commit;
using dec::cp_async_wait;
using dec::ldsm_x4;
using dec::ldsm_x4_trans;
using dec::mma_bf16;
typedef __nv_bfloat16 bf16;

constexpr int NTM = 256;   // threads: 8 warps

template <int HD>
struct Geom {
    static constexpr int LD = HD + 8;
    static constexpr int TILE_BYTES = BT * LD * 2;
    static constexpr int NJ = HD / 8;    // 8-column n-tiles of HD
    static constexpr int KS = HD / 16;   // k16 steps over HD
    // the fixed pair of tiles, then two stages of the streamed pair; at the
    // end the upper warps' f32 partials (2 x 4 warps x NJ x 4 x 32) reuse it
    static constexpr size_t bytes = 6 * TILE_BYTES;
    static_assert(2 * 4 * NJ * 4 * 32 * 4 <= bytes, "the exchange must fit");
};

// rows [r0, r0 + 64) of head hx of x (B, S, Hx, HD) into a shared tile by
// cp.async; rows past S are zero-filled, never read
template <int HD>
__device__ __forceinline__ void issue_rows(uint32_t dst, const bf16* __restrict__ x, int b, int r0,
                                           int hx, int S, int Hx, int tid) {
    constexpr int CPR = HD / 8;
    for (int i = tid; i < BT * CPR; i += NTM) {
        const int r = i / CPR, c = (i % CPR) * 8;
        const bool ok = r0 + r < S;
        cp_async_16(dst + (r * Geom<HD>::LD + c) * 2,
                    x + (ok ? (((size_t)b * S + r0 + r) * Hx + hx) * HD + c : 0), ok);
    }
}

// ldmatrix lane offsets (row, column) of a 16 x 16 block: A fragments (and
// B fragments by .trans: k = rows), and B fragments of two 8-row n-tiles
// from rows (n = rows, k = columns)
struct Lanes {
    int a_row, a_col, b_row, b_col;
    __device__ __forceinline__ explicit Lanes(int lane)
        : a_row((lane & 7) + (((lane >> 3) & 1) << 3)), a_col((lane >> 4) * 8),
          b_row((lane & 7) + ((lane >> 4) << 3)), b_col(((lane >> 3) & 1) * 8) {}
};

// the upper four warps hand their accumulators to the lower four, which
// add them in that order: acc (NJ x 4) of warp w and lane into ex
template <int NJ>
__device__ __forceinline__ void exchange_put(float* ex, const float (&acc)[NJ][4], int w4,
                                             int lane) {
#pragma unroll
    for (int n = 0; n < NJ; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) ex[((w4 * NJ + n) * 4 + c) * 32 + lane] = acc[n][c];
}

// dK and dV of key tile kt of head blockIdx.x, batch row blockIdx.y
template <int HD>
__device__ __forceinline__ void dkdv(int kt, const bf16* __restrict__ q,
                                     const bf16* __restrict__ k, const bf16* __restrict__ v,
                                     const bf16* __restrict__ dout, const float* __restrict__ lse,
                                     const float* __restrict__ delta, const int* __restrict__ seg,
                                     const int* __restrict__ tile_seg, float* __restrict__ dk_part,
                                     float* __restrict__ dv_part, int S, int H, int Hkv,
                                     float scale, int causal, int window) {
    using G = Geom<HD>;
    constexpr int LD = G::LD, NJ = G::NJ;
    extern __shared__ __align__(128) unsigned char smem[];
    const uint32_t base = smem_u32(smem);
    const uint32_t sK = base, sV = base + G::TILE_BYTES;

    const int h = blockIdx.x, b = blockIdx.y;
    const int kh = h / (H / Hkv);
    const int k0 = kt * BT;
    const int nt = (S + BT - 1) / BT;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int w4 = warp & 3;
    const int kr = 16 * w4;            // this warp's keys of the tile
    const int qh = 32 * (warp >> 2);   // and its queries of each query tile
    const int g = lane >> 2, t = lane & 3;
    const Lanes ln(lane);
    const Mask mask{S, causal, window};
    const size_t row_bh = ((size_t)b * H + h) * S;

    const int qt_begin = causal ? kt : 0;
    const int qt_end = window > 0 ? min(nt, (k0 + BT - 1 + window - 1) / BT + 1) : nt;
    auto next = [&](int qt) {
        while (qt < qt_end && !segments_meet(tile_seg, b, nt, qt, kt)) ++qt;
        return qt;
    };
    auto issue = [&](int qt, int st) {
        issue_rows<HD>(base + (2 + 2 * st) * G::TILE_BYTES, q, b, qt * BT, h, S, H, tid);
        issue_rows<HD>(base + (3 + 2 * st) * G::TILE_BYTES, dout, b, qt * BT, h, S, H, tid);
    };
    issue_rows<HD>(sK, k, b, k0, kh, S, Hkv, tid);
    issue_rows<HD>(sV, v, b, k0, kh, S, Hkv, tid);
    int qt = next(qt_begin);
    if (qt < qt_end) issue(qt, 0);
    cp_async_commit();
    int key[2], kseg[2];
#pragma unroll
    for (int rs = 0; rs < 2; ++rs) {
        key[rs] = k0 + kr + g + 8 * rs;
        kseg[rs] = key[rs] < S ? seg[(size_t)b * S + key[rs]] : 0;
    }

    float dk[NJ][4], dv[NJ][4];
#pragma unroll
    for (int n = 0; n < NJ; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) dk[n][c] = dv[n][c] = 0.f;
    for (int i = 0; qt < qt_end; ++i) {
        const int nxt = next(qt + 1);
        if (nxt < qt_end) issue(nxt, (i + 1) & 1);   // its stage was freed at the end of i - 1
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const uint32_t sQ = base + (2 + 2 * (i & 1)) * G::TILE_BYTES;
        const uint32_t sdO = sQ + G::TILE_BYTES;
        const int q0 = qt * BT;
        // S^T and dP^T: element (j, 2 rs + e) is key kr + g + 8 rs, query
        // qh + 8 j + 2 t + e of the tiles
        float s[4][4], dp[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
#pragma unroll
        for (int ks = 0; ks < G::KS; ++ks) {
            uint32_t ka[4], va[4];
            ldsm_x4(sK + ((kr + ln.a_row) * LD + 16 * ks + ln.a_col) * 2, ka);
            ldsm_x4(sV + ((kr + ln.a_row) * LD + 16 * ks + ln.a_col) * 2, va);
#pragma unroll
            for (int np = 0; np < 2; ++np) {
                uint32_t qf[4], of[4];
                const uint32_t off = ((qh + 16 * np + ln.b_row) * LD + 16 * ks + ln.b_col) * 2;
                ldsm_x4(sQ + off, qf);
                ldsm_x4(sdO + off, of);
                mma_bf16(s[2 * np], ka, qf[0], qf[1]);
                mma_bf16(s[2 * np + 1], ka, qf[2], qf[3]);
                mma_bf16(dp[2 * np], va, of[0], of[1]);
                mma_bf16(dp[2 * np + 1], va, of[2], of[3]);
            }
        }
        // P^T and dS^T, rounded to bf16, as the A fragments of the k16
        // steps over the warp's 32 queries
        uint32_t pa[2][4], da[2][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int qpos = q0 + qh + 8 * j + 2 * t + e;
                const bool in = qpos < S;
                const float l = in ? lse[row_bh + qpos] : -INFINITY;
                const float dl = in ? delta[row_bh + qpos] : 0.f;
                const int sq = in ? seg[(size_t)b * S + qpos] : 0;
#pragma unroll
                for (int rs = 0; rs < 2; ++rs) {
                    const bool ok = l > -INFINITY && mask(qpos, key[rs], sq, kseg[rs]);
                    const float p = ok ? expf(s[j][2 * rs + e] * scale - l) : 0.f;
                    s[j][2 * rs + e] = p;
                    dp[j][2 * rs + e] = p * (dp[j][2 * rs + e] - dl);
                }
            }
#pragma unroll
            for (int rs = 0; rs < 2; ++rs) {
                pa[j >> 1][(j & 1) * 2 + rs] = pack_bf16(s[j][2 * rs], s[j][2 * rs + 1]);
                da[j >> 1][(j & 1) * 2 + rs] = pack_bf16(dp[j][2 * rs], dp[j][2 * rs + 1]);
            }
        }
        // dV += P^T dO and dK += dS^T Q: dO and Q rows are k, by .trans
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
            for (int n2 = 0; n2 < NJ / 2; ++n2) {
                uint32_t of[4], qf[4];
                const uint32_t off = ((qh + 16 * kk + ln.a_row) * LD + 16 * n2 + ln.a_col) * 2;
                ldsm_x4_trans(sdO + off, of);
                ldsm_x4_trans(sQ + off, qf);
                mma_bf16(dv[2 * n2], pa[kk], of[0], of[1]);
                mma_bf16(dv[2 * n2 + 1], pa[kk], of[2], of[3]);
                mma_bf16(dk[2 * n2], da[kk], qf[0], qf[1]);
                mma_bf16(dk[2 * n2 + 1], da[kk], qf[2], qf[3]);
            }
        __syncthreads();   // the stage may be refilled
        qt = nxt;
    }
    cp_async_wait<0>();    // no copy may land in the exchange
    __syncthreads();
    float* ex = reinterpret_cast<float*>(smem);
    if (warp >= 4) {
        exchange_put(ex, dk, w4, lane);
        exchange_put(ex + 4 * NJ * 4 * 32, dv, w4, lane);
    }
    __syncthreads();
    if (warp >= 4) return;
#pragma unroll
    for (int n = 0; n < NJ; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int kpos = key[c >> 1];
            if (kpos >= S) continue;
            const int x = ((w4 * NJ + n) * 4 + c) * 32 + lane;
            const size_t o = (((size_t)b * S + kpos) * H + h) * HD + 8 * n + 2 * t + (c & 1);
            dk_part[o] = (dk[n][c] + ex[x]) * scale;
            dv_part[o] = dv[n][c] + ex[4 * NJ * 4 * 32 + x];
        }
}

// dQ of query tile qt of head blockIdx.x, batch row blockIdx.y
template <int HD>
__device__ __forceinline__ void dq_tile(int qt, const bf16* __restrict__ q,
                                        const bf16* __restrict__ k, const bf16* __restrict__ v,
                                        const bf16* __restrict__ dout,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ delta,
                                        const int* __restrict__ seg,
                                        const int* __restrict__ tile_seg, bf16* __restrict__ dq,
                                        int S, int H, int Hkv, float scale, int causal,
                                        int window) {
    using G = Geom<HD>;
    constexpr int LD = G::LD, NJ = G::NJ, KS = G::KS;
    extern __shared__ __align__(128) unsigned char smem[];
    const uint32_t base = smem_u32(smem);
    const uint32_t sQ = base, sdO = base + G::TILE_BYTES;

    const int h = blockIdx.x, b = blockIdx.y;
    const int nt = (S + BT - 1) / BT;
    const int q0 = qt * BT;
    const int kh = h / (H / Hkv);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int w4 = warp & 3;
    const int qr = 16 * w4;            // this warp's queries of the tile
    const int kc = 32 * (warp >> 2);   // and its keys of each key tile
    const int g = lane >> 2, t = lane & 3;
    const Lanes ln(lane);
    const Mask mask{S, causal, window};

    const int kt_end = causal ? qt + 1 : nt;
    const int kt_begin = (window > 0 && q0 - window + 1 > 0) ? (q0 - window + 1) / BT : 0;
    auto next = [&](int kt) {
        while (kt < kt_end && !segments_meet(tile_seg, b, nt, qt, kt)) ++kt;
        return kt;
    };
    auto issue = [&](int kt, int st) {
        issue_rows<HD>(base + (2 + 2 * st) * G::TILE_BYTES, k, b, kt * BT, kh, S, Hkv, tid);
        issue_rows<HD>(base + (3 + 2 * st) * G::TILE_BYTES, v, b, kt * BT, kh, S, Hkv, tid);
    };
    issue_rows<HD>(sQ, q, b, q0, h, S, H, tid);
    issue_rows<HD>(sdO, dout, b, q0, h, S, H, tid);
    int kt = next(kt_begin);
    if (kt < kt_end) issue(kt, 0);
    cp_async_commit();
    int qpos[2], qseg[2];
    float l[2], dl[2];
#pragma unroll
    for (int rs = 0; rs < 2; ++rs) {
        qpos[rs] = q0 + qr + g + 8 * rs;
        const bool in = qpos[rs] < S;
        qseg[rs] = in ? seg[(size_t)b * S + qpos[rs]] : 0;
        l[rs] = in ? lse[((size_t)b * H + h) * S + qpos[rs]] : -INFINITY;
        dl[rs] = in ? delta[((size_t)b * H + h) * S + qpos[rs]] : 0.f;
    }

    float acc[NJ][4];
#pragma unroll
    for (int n = 0; n < NJ; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
    uint32_t qa[KS][4], oa[KS][4];
    for (int i = 0; kt < kt_end; ++i) {
        const int nxt = next(kt + 1);
        if (nxt < kt_end) issue(nxt, (i + 1) & 1);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        if (i == 0) {   // Q's and dO's A fragments, once
#pragma unroll
            for (int ks = 0; ks < KS; ++ks) {
                const uint32_t off = ((qr + ln.a_row) * LD + 16 * ks + ln.a_col) * 2;
                ldsm_x4(sQ + off, qa[ks]);
                ldsm_x4(sdO + off, oa[ks]);
            }
        }
        const uint32_t sK = base + (2 + 2 * (i & 1)) * G::TILE_BYTES;
        const uint32_t sV = sK + G::TILE_BYTES;
        const int k0 = kt * BT;
        // S and dP: element (j, 2 rs + e) is query qr + g + 8 rs, key
        // kc + 8 j + 2 t + e of the tiles
        float s[4][4], dp[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
#pragma unroll
            for (int np = 0; np < 2; ++np) {
                uint32_t kf[4], vf[4];
                const uint32_t off = ((kc + 16 * np + ln.b_row) * LD + 16 * ks + ln.b_col) * 2;
                ldsm_x4(sK + off, kf);
                ldsm_x4(sV + off, vf);
                mma_bf16(s[2 * np], qa[ks], kf[0], kf[1]);
                mma_bf16(s[2 * np + 1], qa[ks], kf[2], kf[3]);
                mma_bf16(dp[2 * np], oa[ks], vf[0], vf[1]);
                mma_bf16(dp[2 * np + 1], oa[ks], vf[2], vf[3]);
            }
        uint32_t da[2][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int kpos = k0 + kc + 8 * j + 2 * t + e;
                const int ks_ = kpos < S ? seg[(size_t)b * S + kpos] : 0;
#pragma unroll
                for (int rs = 0; rs < 2; ++rs) {
                    const bool ok = l[rs] > -INFINITY && mask(qpos[rs], kpos, qseg[rs], ks_);
                    const float p = ok ? expf(s[j][2 * rs + e] * scale - l[rs]) : 0.f;
                    dp[j][2 * rs + e] = p * (dp[j][2 * rs + e] - dl[rs]);
                }
            }
#pragma unroll
            for (int rs = 0; rs < 2; ++rs)
                da[j >> 1][(j & 1) * 2 + rs] = pack_bf16(dp[j][2 * rs], dp[j][2 * rs + 1]);
        }
        // dQ += dS K: K rows are k, by .trans
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
            for (int n2 = 0; n2 < NJ / 2; ++n2) {
                uint32_t kf[4];
                ldsm_x4_trans(sK + ((kc + 16 * kk + ln.a_row) * LD + 16 * n2 + ln.a_col) * 2, kf);
                mma_bf16(acc[2 * n2], da[kk], kf[0], kf[1]);
                mma_bf16(acc[2 * n2 + 1], da[kk], kf[2], kf[3]);
            }
        __syncthreads();
        kt = nxt;
    }
    cp_async_wait<0>();
    __syncthreads();
    float* ex = reinterpret_cast<float*>(smem);
    if (warp >= 4) exchange_put(ex, acc, w4, lane);
    __syncthreads();
    if (warp >= 4) return;
#pragma unroll
    for (int n = 0; n < NJ; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int row = qpos[c >> 1];
            if (row >= S) continue;
            const float x = (acc[n][c] + ex[((w4 * NJ + n) * 4 + c) * 32 + lane]) * scale;
            dq[(((size_t)b * S + row) * H + h) * HD + 8 * n + 2 * t + (c & 1)] =
                __float2bfloat16(x);
        }
}

// The two passes in one launch, blocks alternating between them along z,
// the heaviest causal tiles of each first (dK/dV: the first key tiles; dQ:
// the last query tiles): the lighter blocks of one fill the card while
// the longest of the other run.
template <int HD>
__global__ void __launch_bounds__(NTM, 1)
bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
           const bf16* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, const int* __restrict__ seg,
           const int* __restrict__ tile_seg, float* __restrict__ dk_part,
           float* __restrict__ dv_part, bf16* __restrict__ dq, int S, int H, int Hkv,
           float scale, int causal, int window) {
    const int nt = (S + BT - 1) / BT;
    const int z = blockIdx.z;
    if (z & 1)
        dq_tile<HD>(nt - 1 - z / 2, q, k, v, dout, lse, delta, seg, tile_seg, dq, S, H, Hkv, scale,
                    causal, window);
    else
        dkdv<HD>(z / 2, q, k, v, dout, lse, delta, seg, tile_seg, dk_part, dv_part, S, H, Hkv,
                 scale, causal, window);
}

}  // namespace tc

// shared bytes: four row tiles, the P and dS tiles (dQ: dS only), and
// lse, D and the two tiles' segment ids
constexpr size_t kv_smem(int hd) {
    return 4 * sizeof(float) * BT * (hd + 1) + 2 * sizeof(float) * BT * LDP + 4 * BT * 4;
}
constexpr size_t q_smem(int hd) {
    return 4 * sizeof(float) * BT * (hd + 1) + sizeof(float) * BT * LDP + 4 * BT * 4;
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* out, const void* lse,
                   const void* dout, const int* seg, void* dq, void* dk, void* dv, float* delta,
                   int* tile_seg, float* dk_part, float* dv_part, int B, int S, int H, int Hkv,
                   float scale, int causal, int window, cudaStream_t st) {
    const T* tq = static_cast<const T*>(q);
    const T* tk = static_cast<const T*>(k);
    const T* tv = static_cast<const T*>(v);
    const T* tdo = static_cast<const T*>(dout);
    const float* flse = static_cast<const float*>(lse);
    const int nt = (S + BT - 1) / BT;
    const int prep_warps = max(B * S * H, B * nt);
    bwd_prep_kernel<T, HD><<<(prep_warps * 32 + NT - 1) / NT, NT, 0, st>>>(
        static_cast<const T*>(out), tdo, seg, delta, tile_seg, B, S, H);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;

    const size_t n = (size_t)B * S * Hkv * HD;
    auto reduce = [&]() {
        bwd_reduce_kernel<T><<<(unsigned)((n + NT - 1) / NT), NT, 0, st>>>(
            dk_part, dv_part, static_cast<T*>(dk), static_cast<T*>(dv), B, S, H, Hkv, HD);
        return cudaGetLastError();
    };
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        // bf16: both passes on the tensor cores in one launch, then the group sums
        constexpr size_t bytes = tc::Geom<HD>::bytes;
        auto kern = tc::bwd_kernel<HD>;
        err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (err != cudaSuccess) return err;
        kern<<<dim3(H, B, 2 * nt), tc::NTM, bytes, st>>>(
            tq, tk, tv, tdo, flse, delta, seg, tile_seg, dk_part, dv_part, static_cast<T*>(dq),
            S, H, Hkv, scale, causal, window);
        err = cudaGetLastError();
        return err != cudaSuccess ? err : reduce();
    } else {
        // f32, the CPU-parity dtype: FMA loops, dK/dV, the group sums, then dQ
        constexpr size_t kv_bytes = kv_smem(HD), q_bytes = q_smem(HD);
        static_assert(kv_bytes <= 232448, "the tiles must fit in 227 KB of shared memory");
        auto kv_kern = bwd_dkdv_kernel<T, HD>;
        err = cudaFuncSetAttribute(kv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)kv_bytes);
        if (err != cudaSuccess) return err;
        kv_kern<<<dim3(H, B, nt), NT, kv_bytes, st>>>(tq, tk, tv, tdo, flse, delta, seg,
                                                      tile_seg, dk_part, dv_part, S, H, Hkv,
                                                      scale, causal, window);
        err = cudaGetLastError();
        if (err == cudaSuccess) err = reduce();
        if (err != cudaSuccess) return err;
        auto q_kern = bwd_dq_kernel<T, HD>;
        err = cudaFuncSetAttribute(q_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)q_bytes);
        if (err != cudaSuccess) return err;
        q_kern<<<dim3(H, B, nt), NT, q_bytes, st>>>(tq, tk, tv, tdo, flse, delta, seg, tile_seg,
                                                    static_cast<T*>(dq), S, H, Hkv, scale,
                                                    causal, window);
        return cudaGetLastError();
    }
}

}  // namespace

// q, out, dout, dq: (B, S, H, hd); k, v, dk, dv: (B, S, Hkv, hd); lse: (B,
// H, S) float32 from the forward; seg: (B, S) int32.  Scratch, allocated
// by the caller: delta (B, H, S) float32, tile_seg (B, ceil(S / 64), 2)
// int32, dk_part and dv_part (B, S, H, hd) float32.  dtype: 0 = float32,
// 1 = bfloat16; hd 64 or 128.  Returns the first CUDA error of the
// launches (0 = success).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                                   const void* lse, const void* dout, const void* seg, void* dq,
                                   void* dk, void* dv, void* delta, void* tile_seg,
                                   void* dk_part, void* dv_part, int B, int S, int H, int Hkv,
                                   int hd, int dtype, float scale, int causal, int window,
                                   void* stream) {
    if (Hkv <= 0 || H % Hkv != 0 || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
    const int* sg = static_cast<const int*>(seg);
    float* d = static_cast<float*>(delta);
    int* ts = static_cast<int*>(tile_seg);
    float* pk = static_cast<float*>(dk_part);
    float* pv = static_cast<float*>(dv_part);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BWD_ARGS q, k, v, out, lse, dout, sg, dq, dk, dv, d, ts, pk, pv, B, S, H, Hkv, scale, \
                 causal, window, st
    if (dtype == 0 && hd == 64) return launch<float, 64>(BWD_ARGS);
    if (dtype == 0 && hd == 128) return launch<float, 128>(BWD_ARGS);
    if (dtype == 1 && hd == 64) return launch<__nv_bfloat16, 64>(BWD_ARGS);
    if (dtype == 1 && hd == 128) return launch<__nv_bfloat16, 128>(BWD_ARGS);
#undef BWD_ARGS
    return (int)cudaErrorInvalidValue;
}
