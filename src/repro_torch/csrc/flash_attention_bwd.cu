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
//     64-row tile's [min, max] segment id and whether it holds padding
//     (bf16: also lse log2 e);
//  2. dK/dV: a block per (keys, query head, batch row) walks the query
//     tiles that can see its keys, recomputes P = exp(S scale - lse) from
//     the forward's log-sum-exp and accumulates dV += P^T dO and
//     dK += dS^T Q with dS = P o (dO V^T - D); each query head writes its
//     own f32 partial, and
//  3. dQ: a block per (query rows, query head, batch row) walks the key
//     tiles its rows can see and accumulates dQ += dS K (in bf16, dK/dV
//     and dQ are one launch: they need only prep's results);
//  4. reduce sums a kv head's group of partials in head order into dK and
//     dV (no cross-block reduction order to vary, and a block per query
//     head rather than per kv head in flight).
// A tile pair that the causal mask, the window or disjoint segment ranges
// hide entirely is skipped.  A row whose lse is -inf (it saw no key)
// gets P = 0, so zero gradients and never NaN.
//
// What bounds it on the H100: the products of a tile pair (S and dP
// recomputed by both passes: seven where the gradient needs five) are
// ~3.7 M multiply-adds at head_dim 128 against ~100 KB of tiles, far
// above the card's balance point: operations bound it.  bf16 (the
// training dtype) runs them on wgmma fed by TMA, with P and dS kept in
// registers (the `tc` section below);
// everything but the products' bf16 operands is f32.  f32 (the
// CPU-parity dtype) runs plain FMA loops over tiles staged in shared
// memory, each thread holding a 4 x N register tile, rows padded to an
// odd stride so that row- and column-wise reads are free of bank
// conflicts.  head_dim 64 or 128, and in bf16 also 256 (the RG-LRU
// hybrid's local attention, 16 query heads over one kv head: see the `tc`
// section for how its accumulators fit).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_fwd.cuh"   // TMA, mbarriers, wgmma, ex2, pack_bf16

namespace {

constexpr int BT = 64;    // rows of a query tile and of a key tile
constexpr int NT = 256;   // threads of a block: 16 x 16, thread (ty, tx)
constexpr int LDP = BT + 1;
constexpr float LOG2E = 1.4426950408889634f;

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
                const float* __restrict__ lse, float* __restrict__ delta,
                float* __restrict__ lse2, int* __restrict__ tile_seg, int B, int S, int Sp,
                int H) {
    const int warp = (blockIdx.x * NT + threadIdx.x) / 32;
    const int lane = threadIdx.x % 32;
    {
        // row (b, s, h) of out and dout, s < Sp (D is 0 past S): a row a
        // warp in f32; in bf16 a row every LPR lanes, 16 columns a lane
        // in two 16-byte loads of each
        constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;
        constexpr int LPR = BF ? HD / 16 : 32;
        const int row = (blockIdx.x * NT + threadIdx.x) / LPR, sub = threadIdx.x % LPR;
        const int h = row % H, s = (row / H) % Sp, b = row / (H * Sp);
        const bool in = row < B * Sp * H;
        float acc = 0.f;
        if (in && s < S) {
            const size_t base = (((size_t)b * S + s) * H + h) * HD;
            if constexpr (BF) {
                const uint4* o = reinterpret_cast<const uint4*>(out + base + 16 * sub);
                const uint4* d = reinterpret_cast<const uint4*>(dout + base + 16 * sub);
                const uint4 v[4] = {o[0], o[1], d[0], d[1]};
                const __nv_bfloat16* ob = reinterpret_cast<const __nv_bfloat16*>(v);
#pragma unroll
                for (int u = 0; u < 16; ++u) acc += to_f(ob[u]) * to_f(ob[16 + u]);
            } else {
                for (int c = lane; c < HD; c += 32) acc += to_f(out[base + c]) * to_f(dout[base + c]);
            }
        }
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (in && sub == 0) {
            const size_t o = ((size_t)b * H + h) * Sp + s;
            delta[o] = acc;
            // lse log2 e for the exp2 of the tensor-core route; +inf where
            // the row saw no key (lse = -inf) or lies past S, so P = 0 there
            if (lse2 != nullptr) {
                const float l = s < S ? lse[((size_t)b * H + h) * S + s] : -INFINITY;
                lse2[o] = l == -INFINITY ? INFINITY : l * LOG2E;
            }
        }
    }
    const int nt = (S + BT - 1) / BT;
    if (warp < B * nt) {
        // tile t of batch row b: [min, max] of its segment ids other than
        // -1 (padding), and whether it holds a -1: a tile of the last
        // segment and the padding would otherwise span every segment
        const int b = warp / nt, t = warp % nt;
        int lo = INT_MAX, hi = INT_MIN, pad = 0;
        for (int r = t * BT + lane; r < min(S, (t + 1) * BT); r += 32) {
            const int x = seg[(size_t)b * S + r];
            if (x == -1) {
                pad = 1;
            } else {
                lo = min(lo, x);
                hi = max(hi, x);
            }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
            hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
            pad |= __shfl_xor_sync(0xffffffffu, pad, o);
        }
        if (lane == 0) {
            tile_seg[3 * warp] = lo;
            tile_seg[3 * warp + 1] = hi;
            tile_seg[3 * warp + 2] = pad;
        }
    }
}

// a row of query tile qt and a key of key tile kt of batch row b may share
// a segment: their ranges overlap, or both hold padding
__device__ __forceinline__ bool segments_meet(const int* tile_seg, int b, int nt, int qt,
                                              int kt) {
    const int* a = tile_seg + 3 * (b * nt + qt);
    const int* c = tile_seg + 3 * (b * nt + kt);
    return (a[0] <= c[1] && c[0] <= a[1]) || (a[2] && c[2]);
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
    // elements (b, s, kh, c .. c + 3) of dk: 16-byte loads of the partials
    const size_t i = 4 * ((size_t)blockIdx.x * NT + threadIdx.x);
    if (i >= (size_t)B * S * Hkv * HD) return;
    const int g = H / Hkv;
    const int c = i % HD;
    const size_t bskh = i / HD;               // (b, s) * Hkv + kh
    const int kh = bskh % Hkv;
    const size_t base = ((bskh / Hkv) * H + (size_t)kh * g) * HD + c;
    float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
    for (int j = 0; j < g; ++j) {
        const float4 a = *reinterpret_cast<const float4*>(dk_part + base + (size_t)j * HD);
        const float4 e = *reinterpret_cast<const float4*>(dv_part + base + (size_t)j * HD);
        sk.x += a.x, sk.y += a.y, sk.z += a.z, sk.w += a.w;
        sv.x += e.x, sv.y += e.y, sv.z += e.z, sv.w += e.w;
    }
    const float ks[4] = {sk.x, sk.y, sk.z, sk.w}, vs[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
        store(dk + i + u, ks[u]);
        store(dv + i + u, vs[u]);
    }
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
// bf16: the dK/dV and dQ passes on wgmma, fed by TMA
// ---------------------------------------------------------------------------
//
// A block is two warpgroups (256 threads, one block per SM).  A dK/dV
// block owns 128 keys of one query head, 64 per warpgroup, and holds their
// K and V tiles in shared memory.  Thread 0 streams the (Q, dO) tile pairs
// of 64 query rows that can see those keys, with the rows' lse and D, by
// TMA into a ring of stages, each guarded by a full and an empty mbarrier,
// AHEAD tiles ahead of the one in use; both warpgroups read every
// stage, so each Q and dO byte feeds 128 keys.  There is no producer warp:
// registers are split between the SM's four sub-partitions, and with 8
// warps (2 on each) a thread may hold 255 of them, which the dK/dV pass
// needs (2 HD + 64 accumulator floats live at once); a producer warp or
// warpgroup beside them (9 or 12 warps, 3 on one sub-partition) holds
// every thread to 168, where ptxas spilled and serialised the wgmmas
// (setmaxnreg did not lift its budget).  Per stage a warpgroup computes
//   S^T = K Q^T, dP^T = V dO^T     wgmma m64n64k16, A and B K-major, from
//                                  the 128-byte-swizzled tiles TMA wrote;
//   P^T = exp2(S^T scale log2 e - lse log2 e), dS^T = P^T o (dP^T - D)
//                                  on the accumulators, rounded to bf16 as
//                                  A fragments (the m64n64 accumulator
//                                  layout is the A layout of four k16
//                                  steps);
//   dV += P^T dO, dK += dS^T Q     register-sourced wgmma with dO and Q
//                                  read MN-major (queries x hd, as loaded),
// so nothing is transposed in memory, P and dS never touch shared memory
// and dK and dV stay in registers for the whole walk.  A dQ block mirrors
// it over 128 query rows: it holds their Q and dO, streams (K, V) tile
// pairs and computes S = Q K^T, dP = dO V^T and dQ += dS K (K read
// MN-major).  The loads and the products walk the same sequence of
// visible tiles, between the first and last tiles whose segments meet the
// block's own, so the barriers' phases agree whatever a block's trip
// count.  A warpgroup whose 64 rows see nothing of a stage waits for it
// and releases it without a product; a warp that sees every pair of its
// rows whole (one segment on both sides, below the diagonal, inside the
// window) skips the per-element mask, a warp-uniform test.
//
// At head_dim 256 a 64-row dK plus dV accumulator is 128 floats a thread
// each, and 128 K/V rows with three streamed stages would not fit shared
// memory.  So there the two warpgroups own the SAME 64 rows and split the
// accumulated columns (CS = 2): both compute S^T and dP^T (or S and dP)
// over all 256 columns, and warpgroup w accumulates dV, dK (or dQ) in
// columns [128 w, 128 w + 128) only, from the matching half of dO and Q
// (or K).  A thread then holds as many accumulator floats as at 128; the
// price is the score products done twice.  A block owns one 64-row tile
// (64 KB with its pair) and streams two stages of 64 KB.

namespace tc {

using attn::COL_BLOCK;
using attn::fence_regs;
using attn::mbar_arrive;
using attn::mbar_expect_tx;
using attn::mbar_wait;
using attn::smem_u32;
using attn::tma_load_4d;
typedef __nv_bfloat16 bf16;

constexpr int NWG = 2;                 // warpgroups
constexpr int NTM = 128 * NWG;         // threads

template <int HD>
struct Geom {
    static constexpr int CS = HD > 128 ? 2 : 1;      // warpgroups splitting the accumulated columns
    static constexpr int RG = NWG / CS;              // 64-row tiles a block owns
    static constexpr int BR = 64 * RG;               // keys of a dK/dV block, rows of a dQ block
    static constexpr int HDA = HD / CS;              // accumulated columns of a warpgroup
    static constexpr int NCB = HD / 64;              // 64-column blocks of a row tile
    static constexpr int NA = HDA / 2;               // accumulator floats a thread of dK, dV, dQ
    static constexpr int TILE = NCB * COL_BLOCK;     // bytes of one 64-row tile
    static constexpr int OWN = 2 * RG * TILE;        // the block's K and V, or Q and dO
    static constexpr int STAGE = 2 * TILE;           // a streamed pair
    static constexpr int ROWS = 2 * 64 * 4;          // a dK/dV stage's lse log2 e and D
    static constexpr int FIT = (attn::SMEM_LIMIT - 1024 - 256 - OWN) / (STAGE + ROWS);
    static constexpr int STAGES = FIT < 6 ? FIT : 6;
    // tiles in flight ahead of the one in use: a stage is refilled once
    // both warpgroups are done with the tile two before, so one may run up
    // to a tile ahead of the other; with two stages (head_dim 256), once
    // both are done with the tile before
    static constexpr int AHEAD = STAGES >= 3 ? STAGES - 2 : STAGES - 1;
    static constexpr int ROWS_AT = OWN + STAGES * STAGE;
    static constexpr int BAR = ROWS_AT + STAGES * ROWS;        // full, empty, own
    static constexpr int REACH = BAR + 8 * (2 * STAGES + 1);   // two ints: walk bounds
    // 1024 bytes of slack to align the tiles for the 128-byte swizzle
    static constexpr size_t bytes = 1024 + REACH + 8;
    static_assert(STAGES >= 2 && bytes <= attn::SMEM_LIMIT, "the tiles must fit in shared memory");
};

struct Params {
    const float* lse2;    // (B, H, Sp): lse log2 e; +inf where lse = -inf and past S
    const float* delta;   // (B, H, Sp): D; 0 past S
    const int* seg;       // (B, S)
    const int* tile_seg;  // (B, nt, 3)
    float* dk_part;       // (B, S, H, hd) f32, scaled
    float* dv_part;
    bf16* dq;             // (B, S, H, hd)
    int S, Sp, H, Hkv, causal, window;
    int mode;             // 0: dK/dV and dQ blocks alternating; 1: dK/dV only; 2: dQ only
    float scale, scale_log2;
};

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// `bytes` contiguous bytes global -> shared, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(dst), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// some key of 64-row tile kt is visible to some query of tile qt: their
// segment ranges meet, and neither the causal mask nor the window hides
// the whole pair
__device__ __forceinline__ bool pair_visible(const Params& p, int b, int nt, int qt, int kt) {
    return segments_meet(p.tile_seg, b, nt, qt, kt) && (!p.causal || qt >= kt)
           && (p.window <= 0 || 64 * (qt - kt) - 63 < p.window);
}

// every row of 64-row tile t lies in segment s
__device__ __forceinline__ bool tile_is(const int* tile_seg, int b, int nt, int t, int s) {
    const int* r = tile_seg + 3 * (b * nt + t);
    return s == -1 ? r[0] > r[1] && r[2] : r[0] == s && r[1] == s && !r[2];
}

__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos, int sq, int sk) {
    bool ok = qpos < p.S && kpos < p.S && sq == sk;
    if (p.causal) ok = ok && qpos >= kpos;
    if (p.window > 0) ok = ok && qpos - kpos < p.window;
    return ok;
}

// D (64 x 64, f32) = A B^T over HD: A and B 64-row tiles, K-major; one
// commit group
template <int HD>
__device__ __forceinline__ void product_ss(float* d, uint32_t sa, uint32_t sb) {
    const uint64_t da = attn::desc_k_major(sa), db = attn::desc_k_major(sb);
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
        const uint32_t off = ((ks / 4) * COL_BLOCK + (ks % 4) * 32) >> 4;
        attn::wgmma_ss_n64(d, da + off, db + off);
    }
    attn::wgmma_commit();
}

// D (64 x HD, f32) += A B over 64: A the bf16 fragments of four k16 steps,
// B a 64-row tile read MN-major (its rows are k); one commit group
template <int HD>
__device__ __forceinline__ void product_rs(float* d, const uint32_t (&a)[4][4], uint32_t sb) {
    const uint64_t db = attn::desc_mn_major(sb);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
        const uint32_t off = (kk * 16 * 128) >> 4;
        if constexpr (HD == 64) {
            attn::wgmma_rs_n64(d, a[kk], db + off);
        } else {
            attn::wgmma_rs_n128(d, a[kk], db + off);
        }
    }
    attn::wgmma_commit();
}

// a m64n64 accumulator as bf16 A fragments: k16 step kk covers its
// 8-column chunks 2 kk and 2 kk + 1
__device__ __forceinline__ void to_frags(const float* x, uint32_t (&a)[4][4]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        a[j >> 1][(j & 1) * 2] = attn::pack_bf16(x[4 * j], x[4 * j + 1]);
        a[j >> 1][(j & 1) * 2 + 1] = attn::pack_bf16(x[4 * j + 2], x[4 * j + 3]);
    }
}

template <int N>
__device__ __forceinline__ void zero(float* x) {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = 0.f;
}

struct Maps {
    const CUtensorMap *q, *k, *v, *dout;
};

// Thread `lane` of warp w of a warpgroup owns accumulator rows
// r0 = 16 w + lane / 4 and r0 + 8 of the warpgroup's 64, and in each
// 8-column chunk J the columns 8 J + 2 (lane % 4) + {0, 1}: element 4 J + e
// is row r0 + 8 (e / 2), column 8 J + 2 (lane % 4) + e % 2.

// dK and dV of keys [128 kb, 128 kb + 128) of head blockIdx.x, batch row blockIdx.y
template <int HD>
__device__ __forceinline__ void dkdv_block(int kb, int first, int last, const Maps& m,
                                           const Params& p, unsigned char* smem, uint64_t* full,
                                           uint64_t* empty, uint64_t* own) {
    using G = Geom<HD>;
    constexpr int NA = G::NA;
    const uint32_t base = smem_u32(smem);
    const int h = blockIdx.x, b = blockIdx.y;
    const int S = p.S, H = p.H;
    const int k0 = kb * G::BR;
    const int nt = (S + BT - 1) / BT;
    const int kt0 = k0 / BT, kt1 = min(kt0 + G::RG, nt);
    // query tiles from the diagonal (causal) and from the first tile whose
    // segments meet the block's, to the window's end and the last such tile
    const int qt_begin = max(p.causal ? kt0 : 0, first);
    const int qt_end = min(
        p.window > 0 ? min(nt, (min(k0 + G::BR, S) - 1 + p.window - 1) / BT + 1) : nt,
        last + 1);
    // the next query tile from qt that sees a key of the block
    auto next = [&](int qt) {
        for (; qt < qt_end; ++qt)
            for (int kt = kt0; kt < kt1; ++kt)
                if (pair_visible(p, b, nt, qt, kt)) return qt;
        return qt;
    };

    const float* lse2 = p.lse2 + ((size_t)b * H + h) * p.Sp;
    const float* delta = p.delta + ((size_t)b * H + h) * p.Sp;
    // stage st <- query tile qt: its Q and dO tiles, and the rows' lse and D
    auto issue = [&](int qt, int st) {
        mbar_expect_tx(&full[st], G::STAGE + G::ROWS);
        const uint32_t sq = base + G::OWN + st * G::STAGE;
        for (int cb = 0; cb < G::NCB; ++cb) {
            tma_load_4d(sq + cb * COL_BLOCK, m.q, &full[st], cb * 64, h, qt * BT, b);
            tma_load_4d(sq + G::TILE + cb * COL_BLOCK, m.dout, &full[st], cb * 64, h, qt * BT, b);
        }
        const uint32_t sr = base + G::ROWS_AT + st * G::ROWS;
        bulk_load(sr, lse2 + qt * BT, BT * 4, &full[st]);
        bulk_load(sr + BT * 4, delta + qt * BT, BT * 4, &full[st]);
    };
    const int tid = threadIdx.x;
    int pq = next(qt_begin);   // thread 0: the next query tile to load
    if (tid == 0) {
        for (int j = 0; j < G::AHEAD && pq < qt_end; ++j, pq = next(pq + 1)) issue(pq, j);
    }

    const int wg = tid / 128, lane = tid % 32, quad = lane & 3;
    const int rg = wg / G::CS, half = wg % G::CS;   // its row tile and column share
    const int kw0 = k0 + 64 * rg;   // this warpgroup's keys
    const int kt = kw0 / BT;
    const bool live = kw0 < S;
    const int r0 = kw0 + 16 * ((tid % 128) / 32) + lane / 4;
    const int key[2] = {r0, r0 + 8};
    const int* segb = p.seg + (size_t)b * S;
    int kseg[2];
#pragma unroll
    for (int rs = 0; rs < 2; ++rs) kseg[rs] = key[rs] < S ? segb[key[rs]] : 0;
    const uint32_t sk = base + rg * G::TILE, sv = sk + G::OWN / 2;
    // the streamed tiles' columns this warpgroup accumulates from
    const uint32_t cols = half * (G::HDA / 64) * COL_BLOCK;

    float dk[NA], dv[NA];
    zero<NA>(dk);
    zero<NA>(dv);
    attn::mbar_wait(own, 0);
    for (int qt = next(qt_begin), i = 0; qt < qt_end; qt = next(qt + 1), ++i) {
        if (tid == 0 && pq < qt_end) {   // refill the stage that iteration i + AHEAD - STAGES used
            const int j = i + G::AHEAD;
            if (j >= G::STAGES) mbar_wait(&empty[j % G::STAGES], ((j / G::STAGES) - 1) & 1);
            issue(pq, j % G::STAGES);
            pq = next(pq + 1);
        }
        const int st = i % G::STAGES;
        const bool vis = live && pair_visible(p, b, nt, qt, kt);
        mbar_wait(&full[st], (i / G::STAGES) & 1);
        if (vis) {
            const int q0 = qt * BT;
            // every query of the tile visible to both keys of every thread of the warp
            const bool whole = q0 + BT - 1 < S && key[1] < S && kseg[1] == kseg[0]
                               && tile_is(p.tile_seg, b, nt, qt, kseg[0])
                               && (!p.causal || q0 >= key[1])
                               && (p.window <= 0 || q0 + BT - 1 - key[0] < p.window);
            const bool masked = !__all_sync(0xffffffffu, whole);
            const uint32_t sq = base + G::OWN + st * G::STAGE, sdo = sq + G::TILE;
            const float* rows = reinterpret_cast<const float*>(smem + G::ROWS_AT + st * G::ROWS);

            // S^T = K Q^T and dP^T = V dO^T (P^T from S^T while dP^T's
            // products run), dS^T, then dV += P^T dO and dK += dS^T Q: at
            // most 2 HD + 64 accumulator floats are live a thread
            float s[32], dp[32];
            zero<32>(s);
            zero<32>(dp);
            fence_regs<32>(s);
            fence_regs<32>(dp);
            attn::wgmma_fence();
            product_ss<HD>(s, sk, sq);
            product_ss<HD>(dp, sv, sdo);
            wgmma_wait<1>();   // S^T has landed; dP^T's products run on
            fence_regs<32>(s);
            // element (key, query): column 8 J + 2 quad + c is query q0 + that
            auto probs = [&](auto with_mask) {
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    const float2 l = *reinterpret_cast<const float2*>(rows + 8 * j + 2 * quad);
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        float x = attn::ex2(
                            fmaf(s[4 * j + e], p.scale_log2, -((e & 1) ? l.y : l.x)));
                        if constexpr (decltype(with_mask)::value) {
                            const int qpos = q0 + 8 * j + 2 * quad + (e & 1);
                            const int sq_ = qpos < S ? segb[qpos] : INT_MIN;
                            if (!visible(p, qpos, key[e >> 1], sq_, kseg[e >> 1])) x = 0.f;
                        }
                        s[4 * j + e] = x;
                    }
                }
            };
            if (masked)
                probs(std::true_type{});
            else
                probs(std::false_type{});
            attn::wgmma_wait_all();
            fence_regs<32>(dp);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const float2 d = *reinterpret_cast<const float2*>(rows + BT + 8 * j + 2 * quad);
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? d.y : d.x));
            }
            uint32_t pa[4][4], da[4][4];
            to_frags(s, pa);
            to_frags(dp, da);
            fence_regs<NA>(dv);
            fence_regs<NA>(dk);
            attn::wgmma_fence();
            product_rs<G::HDA>(dv, pa, sdo + cols);
            product_rs<G::HDA>(dk, da, sq + cols);
            attn::wgmma_wait_all();
            fence_regs<NA>(dv);
            fence_regs<NA>(dk);
        }
        mbar_arrive(&empty[st]);
    }
    if (!live) return;
#pragma unroll
    for (int rs = 0; rs < 2; ++rs) {
        if (key[rs] >= S) continue;
        const size_t o = (((size_t)b * S + key[rs]) * H + h) * HD + half * G::HDA + 2 * quad;
#pragma unroll
        for (int j = 0; j < G::HDA / 8; ++j) {
            *reinterpret_cast<float2*>(p.dk_part + o + 8 * j) =
                make_float2(dk[4 * j + 2 * rs] * p.scale, dk[4 * j + 2 * rs + 1] * p.scale);
            *reinterpret_cast<float2*>(p.dv_part + o + 8 * j) =
                make_float2(dv[4 * j + 2 * rs], dv[4 * j + 2 * rs + 1]);
        }
    }
}

// dQ of query rows [128 qb, 128 qb + 128) of head blockIdx.x, batch row blockIdx.y
template <int HD>
__device__ __forceinline__ void dq_block(int qb, int first, int last, const Maps& m,
                                         const Params& p, unsigned char* smem, uint64_t* full,
                                         uint64_t* empty, uint64_t* own) {
    using G = Geom<HD>;
    constexpr int NA = G::NA;
    const uint32_t base = smem_u32(smem);
    const int h = blockIdx.x, b = blockIdx.y;
    const int S = p.S, H = p.H;
    const int kh = h / (H / p.Hkv);
    const int q0 = qb * G::BR;
    const int nt = (S + BT - 1) / BT;
    const int qt0 = q0 / BT, qt1 = min(qt0 + G::RG, nt);
    // key tiles from the window's start and the first tile whose segments
    // meet the block's, to the diagonal (causal) and the last such tile
    const int kt_end =
        min(p.causal ? min(nt, (min(q0 + G::BR, S) - 1) / BT + 1) : nt, last + 1);
    const int kt_begin = max(
        (p.window > 0 && q0 - p.window + 1 > 0) ? (q0 - p.window + 1) / BT : 0, first);
    // the next key tile from kt that some query of the block sees
    auto next = [&](int kt) {
        for (; kt < kt_end; ++kt)
            for (int qt = qt0; qt < qt1; ++qt)
                if (pair_visible(p, b, nt, qt, kt)) return kt;
        return kt;
    };

    // stage st <- key tile kt: its K and V tiles
    auto issue = [&](int kt, int st) {
        mbar_expect_tx(&full[st], G::STAGE);
        const uint32_t sk = base + G::OWN + st * G::STAGE;
        for (int cb = 0; cb < G::NCB; ++cb) {
            tma_load_4d(sk + cb * COL_BLOCK, m.k, &full[st], cb * 64, kh, kt * BT, b);
            tma_load_4d(sk + G::TILE + cb * COL_BLOCK, m.v, &full[st], cb * 64, kh, kt * BT, b);
        }
    };
    const int tid = threadIdx.x;
    int pk = next(kt_begin);   // thread 0: the next key tile to load
    if (tid == 0) {
        for (int j = 0; j < G::AHEAD && pk < kt_end; ++j, pk = next(pk + 1)) issue(pk, j);
    }

    const int wg = tid / 128, lane = tid % 32, quad = lane & 3;
    const int rg = wg / G::CS, half = wg % G::CS;   // its row tile and column share
    const int qw0 = q0 + 64 * rg;   // this warpgroup's query rows
    const int qt = qw0 / BT;
    const bool live = qw0 < S;
    const int r0 = qw0 + 16 * ((tid % 128) / 32) + lane / 4;
    const int qrow[2] = {r0, r0 + 8};
    const int* segb = p.seg + (size_t)b * S;
    const size_t row_bh = ((size_t)b * H + h) * p.Sp;
    int qseg[2];
    float l2[2], dl[2];
#pragma unroll
    for (int rs = 0; rs < 2; ++rs) {
        const bool in = qrow[rs] < S;
        qseg[rs] = in ? segb[qrow[rs]] : 0;
        l2[rs] = in ? p.lse2[row_bh + qrow[rs]] : INFINITY;
        dl[rs] = in ? p.delta[row_bh + qrow[rs]] : 0.f;
    }
    const uint32_t sq = base + rg * G::TILE, sdo = sq + G::OWN / 2;
    // the streamed K tile's columns this warpgroup accumulates from
    const uint32_t cols = half * (G::HDA / 64) * COL_BLOCK;

    float acc[NA];
    zero<NA>(acc);
    attn::mbar_wait(own, 0);
    for (int kt = next(kt_begin), i = 0; kt < kt_end; kt = next(kt + 1), ++i) {
        if (tid == 0 && pk < kt_end) {   // refill the stage that iteration i + AHEAD - STAGES used
            const int j = i + G::AHEAD;
            if (j >= G::STAGES) mbar_wait(&empty[j % G::STAGES], ((j / G::STAGES) - 1) & 1);
            issue(pk, j % G::STAGES);
            pk = next(pk + 1);
        }
        const int st = i % G::STAGES;
        const bool vis = live && pair_visible(p, b, nt, qt, kt);
        mbar_wait(&full[st], (i / G::STAGES) & 1);
        if (vis) {
            const int k0 = kt * BT;
            // every key of the tile visible to both rows of every thread of the warp
            const bool whole = k0 + BT - 1 < S && qrow[1] < S && qseg[1] == qseg[0]
                               && tile_is(p.tile_seg, b, nt, kt, qseg[0])
                               && (!p.causal || k0 + BT - 1 <= qrow[0])
                               && (p.window <= 0 || qrow[1] - k0 < p.window);
            const bool masked = !__all_sync(0xffffffffu, whole);
            const uint32_t sk = base + G::OWN + st * G::STAGE, sv = sk + G::TILE;

            float s[32], dp[32];
            zero<32>(s);
            zero<32>(dp);
            fence_regs<32>(s);
            fence_regs<32>(dp);
            attn::wgmma_fence();
            product_ss<HD>(s, sq, sk);     // S = Q K^T
            product_ss<HD>(dp, sdo, sv);   // dP = dO V^T
            wgmma_wait<1>();               // S has landed; dP's products run on
            fence_regs<32>(s);
            auto probs = [&](auto with_mask) {
#pragma unroll
                for (int j = 0; j < 8; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        float x = attn::ex2(fmaf(s[4 * j + e], p.scale_log2, -l2[e >> 1]));
                        if constexpr (decltype(with_mask)::value) {
                            const int kpos = k0 + 8 * j + 2 * quad + (e & 1);
                            const int sk_ = kpos < S ? segb[kpos] : INT_MIN;
                            if (!visible(p, qrow[e >> 1], kpos, qseg[e >> 1], sk_)) x = 0.f;
                        }
                        s[4 * j + e] = x;
                    }
            };
            if (masked)
                probs(std::true_type{});
            else
                probs(std::false_type{});
            attn::wgmma_wait_all();
            fence_regs<32>(dp);
#pragma unroll
            for (int i2 = 0; i2 < 32; ++i2) dp[i2] = s[i2] * (dp[i2] - dl[(i2 >> 1) & 1]);
            uint32_t da[4][4];
            to_frags(dp, da);
            fence_regs<NA>(acc);
            attn::wgmma_fence();
            product_rs<G::HDA>(acc, da, sk + cols);   // dQ += dS K
            attn::wgmma_wait_all();
            fence_regs<NA>(acc);
        }
        mbar_arrive(&empty[st]);
    }
#pragma unroll
    for (int rs = 0; rs < 2; ++rs) {
        if (qrow[rs] >= S) continue;
        bf16* dst = p.dq + (((size_t)b * S + qrow[rs]) * H + h) * HD + half * G::HDA + 2 * quad;
#pragma unroll
        for (int j = 0; j < G::HDA / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
                acc[4 * j + 2 * rs] * p.scale, acc[4 * j + 2 * rs + 1] * p.scale);
    }
}

// The two passes in one launch (mode 0), blocks alternating between them
// along z, the heaviest causal blocks of each first (dK/dV: the first
// keys; dQ: the last queries): the lighter blocks of one fill the card
// while the longest of the other run.  Modes 1 and 2 launch one pass alone
// (the breakdown tool's timings).
template <int HD>
__global__ void __launch_bounds__(NTM, 1)
bwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
           const Params p) {
    using G = Geom<HD>;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::BAR);
    uint64_t* empty = full + G::STAGES;
    uint64_t* own = empty + G::STAGES;
    int* reach = reinterpret_cast<int*>(smem + G::REACH);
    const int nb = (p.S + G::BR - 1) / G::BR, nt = (p.S + BT - 1) / BT;
    const int z = blockIdx.z;
    const bool dq = p.mode == 2 || (p.mode == 0 && (z & 1));
    const int blk = p.mode == 0 ? (dq ? nb - 1 - z / 2 : z / 2) : (dq ? nb - 1 - z : z);
    if (threadIdx.x == 0) {
        reach[0] = nt;
        reach[1] = -1;
        for (int i = 0; i < G::STAGES; ++i) {
            attn::mbar_init(&full[i], 1);
            attn::mbar_init(&empty[i], NWG * 128);
        }
        attn::mbar_init(own, 1);
        attn::mbar_init_fence();
    }
    __syncthreads();
    const Maps m{&tq, &tk, &tv, &tdo};
    if (threadIdx.x == 0) {
        // the block's own tiles (K and V of its keys, or Q and dO of its
        // query rows) first: their load runs while the walk's bounds are found
        const CUtensorMap* x = dq ? m.q : m.k;
        const CUtensorMap* y = dq ? m.dout : m.v;
        const int hx = dq ? blockIdx.x : blockIdx.x / (p.H / p.Hkv);
        const uint32_t base = smem_u32(smem);
        mbar_expect_tx(own, G::OWN);
        for (int w = 0; w < G::RG; ++w)
            for (int cb = 0; cb < G::NCB; ++cb) {
                const uint32_t dst = base + w * G::TILE + cb * COL_BLOCK;
                const int r = blk * G::BR + 64 * w;
                tma_load_4d(dst, x, own, cb * 64, hx, r, blockIdx.y);
                tma_load_4d(dst + G::OWN / 2, y, own, cb * 64, hx, r, blockIdx.y);
            }
    }
    // The first and last 64-row tiles whose segment ranges meet those of
    // the block's own tiles (its keys, or its query rows), all threads at
    // once: the walk runs between them, rather than testing every tile of
    // the row in turn (integer atomics on shared memory: the result does
    // not depend on their order)
    {
        const int a = blk * G::RG, a_end = min(a + G::RG, nt);
        int lo = nt, hi = -1;
        for (int t = threadIdx.x; t < nt; t += NTM) {
            bool meet = false;
            for (int x = a; x < a_end; ++x) meet |= segments_meet(p.tile_seg, blockIdx.y, nt, t, x);
            if (meet) {
                lo = min(lo, t);
                hi = max(hi, t);
            }
        }
        lo = __reduce_min_sync(0xffffffffu, lo);
        hi = __reduce_max_sync(0xffffffffu, hi);
        if (threadIdx.x % 32 == 0) {
            atomicMin(&reach[0], lo);
            atomicMax(&reach[1], hi);
        }
    }
    __syncthreads();
    if (dq)
        dq_block<HD>(blk, reach[0], reach[1], m, p, smem, full, empty, own);
    else
        dkdv_block<HD>(blk, reach[0], reach[1], m, p, smem, full, empty, own);
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout, int B,
                   const Params& p, cudaStream_t st) {
    CUtensorMap mq, mk, mv, mdo;
    if (!attn::tensor_map(&mq, q, B, p.S, p.H, HD) || !attn::tensor_map(&mk, k, B, p.S, p.Hkv, HD)
        || !attn::tensor_map(&mv, v, B, p.S, p.Hkv, HD)
        || !attn::tensor_map(&mdo, dout, B, p.S, p.H, HD))
        return cudaErrorInvalidValue;
    constexpr size_t bytes = Geom<HD>::bytes;
    auto kern = bwd_kernel<HD>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return err;
    const int nb = (p.S + Geom<HD>::BR - 1) / Geom<HD>::BR;
    kern<<<dim3(p.H, B, p.mode == 0 ? 2 * nb : nb), NTM, bytes, st>>>(mq, mk, mv, mdo, p);
    return cudaGetLastError();
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

// the launches of a backward call, as bits: the full call launches all
enum Part { PREP = 1, DKDV = 2, DQ = 4, REDUCE = 8, ALL = 15 };

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* out, const void* lse,
                   const void* dout, const int* seg, void* dq, void* dk, void* dv, float* delta,
                   int* tile_seg, float* dk_part, float* dv_part, int B, int S, int H, int Hkv,
                   float scale, int causal, int window, int parts, cudaStream_t st) {
    constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
    const T* tq = static_cast<const T*>(q);
    const T* tk = static_cast<const T*>(k);
    const T* tv = static_cast<const T*>(v);
    const T* tdo = static_cast<const T*>(dout);
    const float* flse = static_cast<const float*>(lse);
    const int nt = (S + BT - 1) / BT;
    // bf16 reads D and lse log2 e by whole 64-row tiles: rows padded to Sp
    const int Sp = bf16 ? nt * BT : S;
    float* lse2 = bf16 ? delta + (size_t)B * H * Sp : nullptr;
    cudaError_t err = cudaSuccess;
    if (parts & PREP) {
        const int rows_a_warp = bf16 ? 512 / HD : 1;
        const int prep_warps = max((B * Sp * H + rows_a_warp - 1) / rows_a_warp, B * nt);
        bwd_prep_kernel<T, HD><<<(prep_warps * 32 + NT - 1) / NT, NT, 0, st>>>(
            static_cast<const T*>(out), tdo, seg, flse, delta, lse2, tile_seg, B, S, Sp, H);
        err = cudaGetLastError();
        if (err != cudaSuccess) return err;
    }

    const size_t n = (size_t)B * S * Hkv * HD;
    auto reduce = [&]() {
        bwd_reduce_kernel<T><<<(unsigned)((n / 4 + NT - 1) / NT), NT, 0, st>>>(
            dk_part, dv_part, static_cast<T*>(dk), static_cast<T*>(dv), B, S, H, Hkv, HD);
        return cudaGetLastError();
    };
    if constexpr (bf16) {
        // both passes on wgmma in one launch, then the group sums
        if (parts & (DKDV | DQ)) {
            const int mode = (parts & DKDV) && (parts & DQ) ? 0 : (parts & DKDV) ? 1 : 2;
            const tc::Params p{lse2, delta, seg, tile_seg, dk_part, dv_part,
                               static_cast<__nv_bfloat16*>(dq), S, Sp, H, Hkv, causal, window,
                               mode, scale, scale * LOG2E};
            err = tc::launch<HD>(tq, tk, tv, tdo, B, p, st);
            if (err != cudaSuccess) return err;
        }
        return (parts & REDUCE) ? reduce() : cudaSuccess;
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

int dispatch(const void* q, const void* k, const void* v, const void* out, const void* lse,
             const void* dout, const void* seg, void* dq, void* dk, void* dv, void* delta,
             void* tile_seg, void* dk_part, void* dv_part, int B, int S, int H, int Hkv, int hd,
             int dtype, float scale, int causal, int window, int parts, void* stream) {
    if (Hkv <= 0 || H % Hkv != 0 || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
    const int* sg = static_cast<const int*>(seg);
    float* d = static_cast<float*>(delta);
    int* ts = static_cast<int*>(tile_seg);
    float* pk = static_cast<float*>(dk_part);
    float* pv = static_cast<float*>(dv_part);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BWD_ARGS q, k, v, out, lse, dout, sg, dq, dk, dv, d, ts, pk, pv, B, S, H, Hkv, scale, \
                 causal, window, parts, st
    if (dtype == 0 && hd == 64 && parts == ALL) return launch<float, 64>(BWD_ARGS);
    if (dtype == 0 && hd == 128 && parts == ALL) return launch<float, 128>(BWD_ARGS);
    if (dtype == 1 && hd == 64) return launch<__nv_bfloat16, 64>(BWD_ARGS);
    if (dtype == 1 && hd == 128) return launch<__nv_bfloat16, 128>(BWD_ARGS);
    if (dtype == 1 && hd == 256) return launch<__nv_bfloat16, 256>(BWD_ARGS);
#undef BWD_ARGS
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, out, dout, dq: (B, S, H, hd); k, v, dk, dv: (B, S, Hkv, hd); lse: (B,
// H, S) float32 from the forward; seg: (B, S) int32.  Scratch, allocated
// by the caller: delta (2, B, H, Sp) float32 with Sp = ceil(S / 64) x 64
// (D, and in bf16 lse log2 e), tile_seg (B, ceil(S / 64), 3) int32,
// dk_part and dv_part (B, S, H, hd) float32.  dtype: 0 = float32, 1 =
// bfloat16; hd 64 or 128, and 256 in bfloat16.  Returns the first CUDA
// error of the launches (0 = success).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                                   const void* lse, const void* dout, const void* seg, void* dq,
                                   void* dk, void* dv, void* delta, void* tile_seg,
                                   void* dk_part, void* dv_part, int B, int S, int H, int Hkv,
                                   int hd, int dtype, float scale, int causal, int window,
                                   void* stream) {
    return dispatch(q, k, v, out, lse, dout, seg, dq, dk, dv, delta, tile_seg, dk_part, dv_part,
                    B, S, H, Hkv, hd, dtype, scale, causal, window, ALL, stream);
}

// One part of a bf16 backward call, for timing it alone
// (tools/flash_bwd_breakdown.py): part 0 the prep kernel, 1 the main
// launch, 2 the main launch with only its dK/dV blocks, 3 with only its dQ
// blocks, 4 the group sums.  Each part reads what the earlier ones wrote
// into the same scratch.  Arguments as flash_attention_bwd's.
extern "C" int flash_attention_bwd_part(const void* q, const void* k, const void* v,
                                        const void* out, const void* lse, const void* dout,
                                        const void* seg, void* dq, void* dk, void* dv,
                                        void* delta, void* tile_seg, void* dk_part,
                                        void* dv_part, int B, int S, int H, int Hkv, int hd,
                                        int dtype, float scale, int causal, int window, int part,
                                        void* stream) {
    static const int parts[5] = {PREP, DKDV | DQ, DKDV, DQ, REDUCE};
    if (dtype != 1 || part < 0 || part > 4) return (int)cudaErrorInvalidValue;
    return dispatch(q, k, v, out, lse, dout, seg, dq, dk, dv, delta, tile_seg, dk_part, dv_part,
                    B, S, H, Hkv, hd, dtype, scale, causal, window, parts[part], stream);
}
