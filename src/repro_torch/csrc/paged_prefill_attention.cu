// Paged prefill attention for Hopper (sm_90a): a chunk of C query tokens
// at absolute positions q_pos against a global pool of fixed-size KV
// blocks, addressed through each slot's block table, with a tiled
// online softmax.  The chunk's own K/V are already in the pool
// (write-then-read), so one positional mask covers history and chunk.
//
// Replaces: src/repro/kernels/paged_prefill_attention.py::
// paged_prefill_attention_pallas (the Pallas TPU kernel behind
// repro.kernels.ops.paged_prefill_attention).
// Plain version: src/repro_torch/kernels/ref.py::paged_prefill_attention.
//
// What bounds it on the H100: at the chunked engine's shapes (one slot
// per span, C=128 queries, H=12, Hkv=2, hd=128, bf16, up to 512 prior
// positions) a call reads under 1 MB of K/V and does ~0.4 GFLOP of
// visible QK^T and PV products: its bound is a few microseconds, and at
// 2 q tiles x 12 heads = 24 blocks on 132 SMs it is bound by latency.
//
// What the design does about it:
//  * it follows flash_attention.cu: one block per (64-row q tile, q
//    head, slot); the key loop runs inside the block over 64-row key
//    tiles, from the first tile inside the window of the tile's lowest
//    query position up to the tile holding its highest one.  The TPU
//    kernel walks every table entry on its sequential grid axis and masks
//    the ones past the query; here they are never loaded.
//  * a key tile of 64 positions spans 64 / bs table entries (4 on the
//    engine's path, bs = 16; any bs works).  The block copies the tile's
//    block ids from the slot's table to shared memory, then issues its
//    K/V loads four at a time per thread; a row whose entry is unbound
//    (-1) or past the table, or that no query of the tile can see, is
//    never read from the pool and is staged as zeros.
//  * the mask is positional per (query, key): the key's entry is bound,
//    key position <= q_pos, q_pos >= 0, and for a window q_pos - key <
//    window.  So a chunk that starts at a nonzero offset, whose causal
//    diagonal is not the tile's own, needs no special case, and a padded
//    query row (q_pos = -1) sees nothing and writes 0 (the l >= 1e-30
//    clamp).
//  * bf16 QK^T and PV tile products run on the tensor cores through
//    warp-level wmma (16x16x16, f32 accumulate); f32 inputs take a plain
//    FMA loop.  The running max, sum and output of each query row live in
//    the f32 registers of the two threads that own it.
//  * head_dim 32, 64, 80 or 128 (a multiple of 16 for wmma).
// wgmma, TMA and a split over keys to fill the card at small C are left
// for a later version.

#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace {

using namespace nvcuda;
using namespace paged;

constexpr int BQ = 64;    // query rows per block
constexpr int BK = 64;    // key rows per tile
constexpr int NT = 128;   // 4 warps; two threads per query row

// Shared-memory tiles, every row padded by 16 bytes (4 banks); the P.V
// product (sO) reuses the K tile and the scores, which are dead by then.
template <typename T, int HD>
struct Layout {
    static constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
    static constexpr int LDT = HD + 16 / sizeof(T);   // q, k, v rows (elements)
    static constexpr int LDS = BK + 4;                // scores (floats)
    static constexpr int LDP = BK + 8;                // bf16 probabilities
    static constexpr int LDO = HD + 4;                // P.V product (floats)
    static constexpr size_t q = 0;
    static constexpr size_t v = q + sizeof(T) * BQ * LDT;
    static constexpr size_t k = v + sizeof(T) * BK * LDT;
    static constexpr size_t s = k + sizeof(T) * BK * LDT;
    static constexpr size_t p = s + sizeof(float) * BQ * LDS;
    static constexpr size_t qp = p + (kBf16 ? 2 * BQ * LDP : 0);
    static constexpr size_t kb = qp + sizeof(int) * BQ;
    static constexpr size_t blk = kb + sizeof(int) * BK;
    static constexpr size_t o = k;
    static constexpr size_t bytes = blk + sizeof(int) * (BK + 1);
    static_assert(!kBf16 || sizeof(float) * BQ * LDO <= p - o, "sO must fit over K and S");
};

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
                     const int* __restrict__ tables, const int* __restrict__ q_pos,
                     T* __restrict__ out, int C, int E, int bs, int H, int Hkv, float scale,
                     int window) {
    using L = Layout<T, HD>;
    constexpr int LDT = L::LDT, LDS = L::LDS, LDP = L::LDP, LDO = L::LDO;
    constexpr int VEC = 16 / sizeof(T);
    constexpr int VPR = HD / VEC;
    constexpr int HALF = HD / 2;     // output columns per thread
    constexpr int KH = BK / 2;       // score columns per thread
    extern __shared__ __align__(128) unsigned char smem[];
    T* sQ = reinterpret_cast<T*>(smem + L::q);
    T* sK = reinterpret_cast<T*>(smem + L::k);
    T* sV = reinterpret_cast<T*>(smem + L::v);
    float* sS = reinterpret_cast<float*>(smem + L::s);
    int* sQp = reinterpret_cast<int*>(smem + L::qp);
    int* sKb = reinterpret_cast<int*>(smem + L::kb);     // key rows read
    int* sBlk = reinterpret_cast<int*>(smem + L::blk);   // the key tile's block ids

    const int q0 = blockIdx.x * BQ;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int kh = h / (H / Hkv);
    const int tid = threadIdx.x;
    const int row = tid >> 1;
    const int half = tid & 1;
    const bool row_ok = q0 + row < C;
    const int* tab = tables + (size_t)b * E;
    const size_t q_stride = (size_t)H * HD;

    if (tid < BQ) sQp[tid] = (q0 + tid < C) ? q_pos[(size_t)b * C + q0 + tid] : -1;
    const T* qb = q + ((size_t)b * C + q0) * q_stride + (size_t)h * HD;
    for (int i = tid; i < BQ * VPR; i += NT) {
        const int r = i / VPR;
        const int c = (i % VPR) * VEC;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (q0 + r < C) val = *reinterpret_cast<const uint4*>(qb + (size_t)r * q_stride + c);
        *reinterpret_cast<uint4*>(sQ + r * LDT + c) = val;
    }
    __syncthreads();
    const int qpos = sQp[row];
    // the tile's lowest and highest real query position
    int qmax = -1, qmin = 0x7fffffff;
    for (int r = 0; r < BQ; ++r) {
        const int p = sQp[r];
        if (p >= 0) {
            qmax = max(qmax, p);
            qmin = min(qmin, p);
        }
    }

    float m = NEG_INF, l = 0.f;
    float acc[HALF];
#pragma unroll
    for (int c = 0; c < HALF; ++c) acc[c] = 0.f;

    // key tiles that hold a key some row of this tile can see
    const int kt_end = (qmax < 0) ? 0 : min(qmax / BK + 1, (E * bs + BK - 1) / BK);
    int kt_begin = 0;
    if (window > 0 && qmax >= 0 && qmin - window + 1 > 0) kt_begin = (qmin - window + 1) / BK;

    for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();   // the previous tile's readers are done
        load_blocks(sBlk, tab, k0 / bs, (k0 + BK - 1) / bs, E, tid, NT);
        __syncthreads();
        stage_kv<NT, 4>(sK, LDT, sV, LDT, sKb, kp, vp, sBlk, k0 / bs, k0, BK, bs, Hkv, kh, HD,
                        qmin, qmax, window, tid);
        __syncthreads();

        // ---- S = Q K^T (unscaled) ------------------------------------
        if constexpr (L::kBf16) {
            const int warp = tid >> 5;
            wmma::fragment<wmma::accumulator, 16, 16, 16, float> cf[BK / 16];
#pragma unroll
            for (int n = 0; n < BK / 16; ++n) wmma::fill_fragment(cf[n], 0.f);
#pragma unroll
            for (int kk = 0; kk < HD; kk += 16) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
                wmma::load_matrix_sync(af, sQ + warp * 16 * LDT + kk, LDT);
#pragma unroll
                for (int n = 0; n < BK / 16; ++n) {
                    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf;
                    wmma::load_matrix_sync(bf, sK + n * 16 * LDT + kk, LDT);
                    wmma::mma_sync(cf[n], af, bf, cf[n]);
                }
            }
#pragma unroll
            for (int n = 0; n < BK / 16; ++n)
                wmma::store_matrix_sync(sS + warp * 16 * LDS + n * 16, cf[n], LDS,
                                        wmma::mem_row_major);
        } else {
            for (int jj = 0; jj < KH; ++jj) {
                const int j = 2 * jj + half;
                float d = 0.f;
#pragma unroll 8
                for (int c = 0; c < HD; ++c) d += to_f32(sQ[row * LDT + c]) * to_f32(sK[j * LDT + c]);
                sS[row * LDS + j] = d;
            }
        }
        __syncthreads();

        // ---- online softmax over this tile, row by row ----------------
        float sv[KH];
        uint32_t ok = 0u;
        float mt = NEG_INF;
#pragma unroll
        for (int jj = 0; jj < KH; ++jj) {
            const int j = 2 * jj + half;
            const bool valid = visible(sKb[j] != 0, k0 + j, qpos, window);
            sv[jj] = valid ? sS[row * LDS + j] * scale : NEG_INF;
            ok |= valid ? (1u << jj) : 0u;
            mt = fmaxf(mt, sv[jj]);
        }
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
        const float m_new = fmaxf(m, mt);
        const float alpha = expf(m - m_new);
        float ls = 0.f;
#pragma unroll
        for (int jj = 0; jj < KH; ++jj) {
            const int j = 2 * jj + half;
            const float p = ((ok >> jj) & 1u) ? expf(sv[jj] - m_new) : 0.f;
            ls += p;
            if constexpr (L::kBf16) {
                reinterpret_cast<__nv_bfloat16*>(smem + L::p)[row * LDP + j] = __float2bfloat16(p);
            } else {
                sS[row * LDS + j] = p;
            }
        }
        ls += __shfl_xor_sync(0xffffffffu, ls, 1);
        l = l * alpha + ls;
        m = m_new;
#pragma unroll
        for (int c = 0; c < HALF; ++c) acc[c] *= alpha;
        __syncthreads();

        // ---- acc += P V -------------------------------------------------
        if constexpr (L::kBf16) {
            const int warp = tid >> 5;
            const __nv_bfloat16* sP = reinterpret_cast<const __nv_bfloat16*>(smem + L::p);
            float* sO = reinterpret_cast<float*>(smem + L::o);
            wmma::fragment<wmma::accumulator, 16, 16, 16, float> of[HD / 16];
#pragma unroll
            for (int n = 0; n < HD / 16; ++n) wmma::fill_fragment(of[n], 0.f);
#pragma unroll
            for (int kk = 0; kk < BK; kk += 16) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
                wmma::load_matrix_sync(af, sP + warp * 16 * LDP + kk, LDP);
#pragma unroll
                for (int n = 0; n < HD / 16; ++n) {
                    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
                    wmma::load_matrix_sync(bf, sV + kk * LDT + n * 16, LDT);
                    wmma::mma_sync(of[n], af, bf, of[n]);
                }
            }
            // sO overlays K and S: no warp reads either after the softmax
#pragma unroll
            for (int n = 0; n < HD / 16; ++n)
                wmma::store_matrix_sync(sO + warp * 16 * LDO + n * 16, of[n], LDO,
                                        wmma::mem_row_major);
            __syncthreads();
#pragma unroll
            for (int c = 0; c < HALF; ++c) acc[c] += sO[row * LDO + 2 * c + half];
        } else {
            for (int j = 0; j < BK; ++j) {
                const float p = sS[row * LDS + j];
#pragma unroll
                for (int c = 0; c < HALF; ++c) acc[c] += p * to_f32(sV[j * LDT + 2 * c + half]);
            }
        }
    }

    if (row_ok) {
        const float inv = 1.f / fmaxf(l, 1e-30f);
        T* orow = out + ((size_t)b * C + q0 + row) * q_stride + (size_t)h * HD + half;
#pragma unroll
        for (int c = 0; c < HALF; ++c) orow[2 * c] = from_f32<T>(acc[c] * inv);
    }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* kp, const void* vp, const int* tables,
                   const int* q_pos, void* out, int B, int C, int E, int bs, int H, int Hkv,
                   float scale, int window, cudaStream_t stream) {
    constexpr size_t smem = Layout<T, HD>::bytes;
    auto kern = paged_prefill_kernel<T, HD>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((C + BQ - 1) / BQ, H, B);
    kern<<<grid, NT, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(kp),
                                     static_cast<const T*>(vp), tables, q_pos,
                                     static_cast<T*>(out), C, E, bs, H, Hkv, scale, window);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* kp, const void* vp,
                        const int* tables, const int* q_pos, void* out, int B, int C, int E,
                        int bs, int H, int Hkv, float scale, int window, cudaStream_t st) {
    switch (hd) {
        case 32: return launch<T, 32>(q, kp, vp, tables, q_pos, out, B, C, E, bs, H, Hkv, scale, window, st);
        case 64: return launch<T, 64>(q, kp, vp, tables, q_pos, out, B, C, E, bs, H, Hkv, scale, window, st);
        case 80: return launch<T, 80>(q, kp, vp, tables, q_pos, out, B, C, E, bs, H, Hkv, scale, window, st);
        case 128: return launch<T, 128>(q, kp, vp, tables, q_pos, out, B, C, E, bs, H, Hkv, scale, window, st);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// q: (B, C, H, hd); k_pool, v_pool: (N, bs, Hkv, hd); tables: (B, E)
// int32 (-1 = unbound); q_pos: (B, C) int32 (-1 = padded row); out like
// q.  dtype: 0 = float32, 1 = bfloat16.  hd in {32, 64, 80, 128}.
// Returns the CUDA error of the launch (0 = success).
extern "C" int paged_prefill_attention_fwd(const void* q, const void* kp, const void* vp,
                                           const void* tables, const void* q_pos, void* out,
                                           int B, int C, int E, int bs, int H, int Hkv, int hd,
                                           int dtype, float scale, int window, void* stream) {
    if (Hkv <= 0 || H % Hkv != 0 || bs <= 0) return (int)cudaErrorInvalidValue;
    const int* tab = static_cast<const int*>(tables);
    const int* qp = static_cast<const int*>(q_pos);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 1)
        return dispatch_hd<__nv_bfloat16>(hd, q, kp, vp, tab, qp, out, B, C, E, bs, H, Hkv,
                                          scale, window, st);
    if (dtype == 0)
        return dispatch_hd<float>(hd, q, kp, vp, tab, qp, out, B, C, E, bs, H, Hkv, scale,
                                  window, st);
    return (int)cudaErrorInvalidValue;
}
