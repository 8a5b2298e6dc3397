// Prefill attention forward for Hopper (sm_90a): tiled online-softmax
// attention over a full right-padded sequence with GQA, causal and
// sliding-window masks and packed segment ids (padding = segment -1).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas
// (the Pallas TPU kernel behind repro.kernels.ops.flash_attention).
// Plain version: src/repro_torch/kernels/ref.py::flash_attention.
//
// What bounds it on the H100: at the serving path's prefill shapes
// (B=8, S=512..768, H=12, Hkv=2, hd=128, bf16) the causal half of the
// QK^T and PV products is ~6-14 GFLOP against ~30-45 MB of q/k/v/out, so
// it sits near the card's balance point (~295 FLOP/byte in bf16): the
// tensor cores bound it once the products run on them.
//
// What the design does about it:
//  * one block per (64-row q tile, q head, batch row); the k loop runs
//    inside the block, and only over the tiles that hold a visible key:
//    from the first tile inside the window up to the causal diagonal.
//    The TPU kernel walks every k block on its sequential grid axis and
//    masks the tiles above the diagonal; here they are never loaded.
//  * Q, K and V tiles sit in shared memory (dynamic, above 48 KB); in
//    bf16 the QK^T and PV tile products run on the tensor cores through
//    warp-level wmma (16x16x16, f32 accumulate).  f32 inputs take a
//    plain FMA loop.
//  * the softmax is online: each query row's running max m, sum l and
//    output accumulator live in f32 registers of the TPR threads that own
//    the row (2 at head_dim 64/128, 4 at 256, so a thread holds at most
//    64 accumulator columns); a row with no visible key writes 0, as the
//    TPU kernel does through its max(l, 1e-30) clamp.
//  * with 4 threads per row the block has 8 warps: each 16-row strip of
//    the tile is shared by two warps, which split the QK^T key columns
//    and the P.V output columns in halves, so no warp holds more than 8
//    wmma accumulators.  At head_dim 256 in bf16 the P.V product no
//    longer fits over the dead K tile and scores and gets its own region
//    (~195 KB in all; ~212 KB in f32, which needs no P.V buffer).
//  * GQA: q head h reads kv head h / (H / Hkv).
//  * the ragged edge (S not a multiple of 64) is masked here, so the
//    wrapper pads nothing.
// wgmma, TMA and warp specialisation are left for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int BQ = 64;    // query rows per block
constexpr int BK = 64;    // key rows per tile
constexpr float NEG_INF = -1e30f;

// threads per query row and per block: 2 (4 warps) up to head_dim 128,
// 4 (8 warps) at 256
template <int HD>
struct Threads {
    static constexpr int TPR = HD > 128 ? 4 : 2;
    static constexpr int NT = BQ * TPR;
    static constexpr int CS = NT / 32 / (BQ / 16);   // warps sharing a 16-row strip
};

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

// Shared-memory tiles.  Every row is padded by 16 bytes (4 banks), so
// the 16x16 fragment loads and the row-wise softmax pass hit distinct
// banks; the P.V product (sO) reuses the K tile and the scores, which
// are dead by then, where it fits over them (head_dim <= 128), and has
// its own region after the rest where it does not.
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
    static constexpr size_t seg = p + (kBf16 ? 2 * BQ * LDP : 0);
    static constexpr size_t end = seg + sizeof(int) * BK;
    static constexpr bool kOverlay = sizeof(float) * BQ * LDO <= p - k;
    static constexpr size_t o = kOverlay ? k : (end + 127) / 128 * 128;
    static constexpr size_t bytes = kBf16 && !kOverlay ? o + sizeof(float) * BQ * LDO : end;
    static_assert(bytes <= 232448, "the tiles must fit in 227 KB of shared memory");
};

// Copy up to BQ rows of HD elements, 16 bytes per thread and step, from
// a strided global row set into a padded shared tile; rows past `valid`
// are zero-filled.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, size_t row_stride,
                                          int valid, int tid) {
    constexpr int VEC = 16 / sizeof(T);
    constexpr int VPR = HD / VEC;
    constexpr int LD = Layout<T, HD>::LDT;
    constexpr int NT = Threads<HD>::NT;
    for (int i = tid; i < BQ * VPR; i += NT) {
        const int r = i / VPR;
        const int c = (i % VPR) * VEC;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (r < valid) val = *reinterpret_cast<const uint4*>(src + (size_t)r * row_stride + c);
        *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
    }
}

template <typename T, int HD>
__global__ void __launch_bounds__(Threads<HD>::NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ seg, T* __restrict__ out, int S, int H, int Hkv,
                 float scale, int causal, int window) {
    using L = Layout<T, HD>;
    constexpr int LDT = L::LDT, LDS = L::LDS, LDP = L::LDP, LDO = L::LDO;
    constexpr int TPR = Threads<HD>::TPR;
    constexpr int CS = Threads<HD>::CS;
    constexpr int HALF = HD / TPR;   // output columns per thread
    constexpr int KH = BK / TPR;     // score columns per thread
    extern __shared__ __align__(128) unsigned char smem[];
    T* sQ = reinterpret_cast<T*>(smem + L::q);
    T* sK = reinterpret_cast<T*>(smem + L::k);
    T* sV = reinterpret_cast<T*>(smem + L::v);
    float* sS = reinterpret_cast<float*>(smem + L::s);
    int* sSeg = reinterpret_cast<int*>(smem + L::seg);

    const int q0 = blockIdx.x * BQ;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int kh = h / (H / Hkv);
    const int tid = threadIdx.x;
    // TPR neighbouring threads per query row; thread `half` of a row owns
    // its score and output columns j with j % TPR == half
    const int row = tid / TPR;
    const int half = tid % TPR;
    const int qpos = q0 + row;
    const bool row_ok = qpos < S;
    const int seg_q = row_ok ? seg[(size_t)b * S + qpos] : 0;

    const size_t q_stride = (size_t)H * HD;
    const size_t kv_stride = (size_t)Hkv * HD;
    const T* qb = q + (size_t)b * S * q_stride + (size_t)h * HD;
    const T* kb = k + (size_t)b * S * kv_stride + (size_t)kh * HD;
    const T* vb = v + (size_t)b * S * kv_stride + (size_t)kh * HD;

    load_tile<T, HD>(sQ, qb + (size_t)q0 * q_stride, q_stride, S - q0, tid);

    // key tiles holding at least one visible key for some row of this block
    int kt_end = (S + BK - 1) / BK;
    if (causal) kt_end = min(kt_end, (min(q0 + BQ, S) - 1) / BK + 1);
    int kt_begin = 0;
    if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / BK;

    float m = NEG_INF, l = 0.f;
    float acc[HALF];
#pragma unroll
    for (int c = 0; c < HALF; ++c) acc[c] = 0.f;

    for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();   // the previous tile's readers are done
        load_tile<T, HD>(sK, kb + (size_t)k0 * kv_stride, kv_stride, S - k0, tid);
        load_tile<T, HD>(sV, vb + (size_t)k0 * kv_stride, kv_stride, S - k0, tid);
        if (tid < BK) sSeg[tid] = (k0 + tid < S) ? seg[(size_t)b * S + k0 + tid] : 0;
        __syncthreads();

        // ---- S = Q K^T (unscaled) ------------------------------------
        if constexpr (L::kBf16) {
            // warp: 16-row strip `strip`, key columns [cs * BK/CS, ...)
            constexpr int NF = BK / 16 / CS;
            const int warp = tid >> 5;
            const int strip = warp % (BQ / 16);
            const int n0 = (warp / (BQ / 16)) * NF;
            wmma::fragment<wmma::accumulator, 16, 16, 16, float> cf[NF];
#pragma unroll
            for (int n = 0; n < NF; ++n) wmma::fill_fragment(cf[n], 0.f);
#pragma unroll
            for (int kk = 0; kk < HD; kk += 16) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
                wmma::load_matrix_sync(af, sQ + strip * 16 * LDT + kk, LDT);
#pragma unroll
                for (int n = 0; n < NF; ++n) {
                    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf;
                    wmma::load_matrix_sync(bf, sK + (n0 + n) * 16 * LDT + kk, LDT);
                    wmma::mma_sync(cf[n], af, bf, cf[n]);
                }
            }
#pragma unroll
            for (int n = 0; n < NF; ++n)
                wmma::store_matrix_sync(sS + strip * 16 * LDS + (n0 + n) * 16, cf[n], LDS,
                                        wmma::mem_row_major);
        } else {
            for (int jj = 0; jj < KH; ++jj) {
                const int j = TPR * jj + half;
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
            const int j = TPR * jj + half;
            const int kpos = k0 + j;
            bool valid = row_ok && kpos < S && sSeg[j] == seg_q;
            if (causal) valid = valid && qpos >= kpos;
            if (window > 0) valid = valid && (qpos - kpos) < window;
            sv[jj] = valid ? sS[row * LDS + j] * scale : NEG_INF;
            ok |= valid ? (1u << jj) : 0u;
            mt = fmaxf(mt, sv[jj]);
        }
#pragma unroll
        for (int o = 1; o < TPR; o <<= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
        const float m_new = fmaxf(m, mt);
        const float alpha = expf(m - m_new);
        float ls = 0.f;
#pragma unroll
        for (int jj = 0; jj < KH; ++jj) {
            const int j = TPR * jj + half;
            const float p = ((ok >> jj) & 1u) ? expf(sv[jj] - m_new) : 0.f;
            ls += p;
            if constexpr (L::kBf16) {
                reinterpret_cast<__nv_bfloat16*>(smem + L::p)[row * LDP + j] = __float2bfloat16(p);
            } else {
                sS[row * LDS + j] = p;
            }
        }
#pragma unroll
        for (int o = 1; o < TPR; o <<= 1) ls += __shfl_xor_sync(0xffffffffu, ls, o);
        l = l * alpha + ls;
        m = m_new;
#pragma unroll
        for (int c = 0; c < HALF; ++c) acc[c] *= alpha;
        __syncthreads();

        // ---- acc += P V -------------------------------------------------
        if constexpr (L::kBf16) {
            // warp: 16-row strip `strip`, output columns [cs * HD/CS, ...)
            constexpr int NF = HD / 16 / CS;
            const int warp = tid >> 5;
            const int strip = warp % (BQ / 16);
            const int n0 = (warp / (BQ / 16)) * NF;
            const __nv_bfloat16* sP = reinterpret_cast<const __nv_bfloat16*>(smem + L::p);
            float* sO = reinterpret_cast<float*>(smem + L::o);
            wmma::fragment<wmma::accumulator, 16, 16, 16, float> of[NF];
#pragma unroll
            for (int n = 0; n < NF; ++n) wmma::fill_fragment(of[n], 0.f);
#pragma unroll
            for (int kk = 0; kk < BK; kk += 16) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
                wmma::load_matrix_sync(af, sP + strip * 16 * LDP + kk, LDP);
#pragma unroll
                for (int n = 0; n < NF; ++n) {
                    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
                    wmma::load_matrix_sync(bf, sV + kk * LDT + (n0 + n) * 16, LDT);
                    wmma::mma_sync(of[n], af, bf, of[n]);
                }
            }
            // where sO overlays K and S, no warp reads either after the softmax
#pragma unroll
            for (int n = 0; n < NF; ++n)
                wmma::store_matrix_sync(sO + strip * 16 * LDO + (n0 + n) * 16, of[n], LDO,
                                        wmma::mem_row_major);
            __syncthreads();
#pragma unroll
            for (int c = 0; c < HALF; ++c) acc[c] += sO[row * LDO + TPR * c + half];
        } else {
            for (int j = 0; j < BK; ++j) {
                const float p = sS[row * LDS + j];
#pragma unroll
                for (int c = 0; c < HALF; ++c)
                    acc[c] += p * to_f32(sV[j * LDT + TPR * c + half]);
            }
        }
    }

    if (row_ok) {
        const float inv = 1.f / fmaxf(l, 1e-30f);
        T* orow = out + ((size_t)b * S + qpos) * q_stride + (size_t)h * HD + half;
#pragma unroll
        for (int c = 0; c < HALF; ++c) orow[TPR * c] = from_f32<T>(acc[c] * inv);
    }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const int* seg, void* out,
                   int B, int S, int H, int Hkv, float scale, int causal, int window,
                   cudaStream_t stream) {
    constexpr size_t smem = Layout<T, HD>::bytes;
    auto kern = flash_fwd_kernel<T, HD>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((S + BQ - 1) / BQ, H, B);
    kern<<<grid, Threads<HD>::NT, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                     static_cast<const T*>(v), seg, static_cast<T*>(out), S, H,
                                     Hkv, scale, causal, window);
    return cudaGetLastError();
}

}  // namespace

// q: (B, S, H, hd); k, v: (B, S, Hkv, hd); seg: (B, S) int32; out like q.
// dtype: 0 = float32, 1 = bfloat16.  hd must be 64, 128 or 256.  Returns
// the CUDA error of the launch (0 = success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* seg, void* out, int B, int S, int H, int Hkv,
                                   int hd, int dtype, float scale, int causal, int window,
                                   void* stream) {
    const int* sg = static_cast<const int*>(seg);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 1 && hd == 256)
        return launch<__nv_bfloat16, 256>(q, k, v, sg, out, B, S, H, Hkv, scale, causal, window, st);
    if (dtype == 1 && hd == 128)
        return launch<__nv_bfloat16, 128>(q, k, v, sg, out, B, S, H, Hkv, scale, causal, window, st);
    if (dtype == 1 && hd == 64)
        return launch<__nv_bfloat16, 64>(q, k, v, sg, out, B, S, H, Hkv, scale, causal, window, st);
    if (dtype == 0 && hd == 256)
        return launch<float, 256>(q, k, v, sg, out, B, S, H, Hkv, scale, causal, window, st);
    if (dtype == 0 && hd == 128)
        return launch<float, 128>(q, k, v, sg, out, B, S, H, Hkv, scale, causal, window, st);
    if (dtype == 0 && hd == 64)
        return launch<float, 64>(q, k, v, sg, out, B, S, H, Hkv, scale, causal, window, st);
    return (int)cudaErrorInvalidValue;
}
