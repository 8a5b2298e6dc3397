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
// it sits near the card's balance point (~295 FLOP/byte in bf16); on the
// trainer's packed sequences, thousands of tokens long, the tensor cores
// bound it.
//
// What the design does about it (bf16):
//  * the mainloop of attention_fwd.cuh: per block 128 query rows in two
//    consumer warpgroups (64 rows in one at head_dim 256), QK^T and PV on
//    wgmma with the scores, the softmax and the output in registers, and a
//    producer warpgroup that keeps a ring of K/V stages in flight (4
//    stages at head_dim 64 and 128, 2 at 256).
//  * the producer loads by TMA: 4-d tensor maps over q, k and v (hd, heads,
//    S, B), boxes of 64 rows x 64 columns written with the 128-byte
//    swizzle; rows past S are zero-filled by the hardware, so a tile on the
//    ragged edge never reads the next batch row.  One thread issues every
//    load; a stage's full barrier counts its bytes (expect_tx).
//  * the k loop covers only the tiles that hold a visible key for some row
//    of the block: from the first tile inside the window up to the causal
//    diagonal.  The TPU kernel walks every k block on its sequential grid
//    axis and masks the tiles above the diagonal; here they are never
//    loaded.  The mask is per (row, key) from positions and segments.
//  * the grid is (q head, batch row, q tile), q tiles in reverse: the
//    heaviest causal tiles start first, and a GQA group's heads run side
//    by side, so their K/V tiles are read from L2.
//  * the ragged edge (S not a multiple of 64) is masked here, so the
//    wrapper pads nothing; head_dim 64, 128 or 256.
// f32 inputs (the CPU-parity dtype, not the serving one) take a plain FMA
// loop with one block per 64-row q tile.
//
// For training, both bodies can also write each query row's log-sum-exp
// (B, H, S) f32 (-inf for a row that sees no key), from the running max
// and sum they already hold: the backward kernel
// (flash_attention_bwd.cu) recomputes the probabilities from it.  A null
// pointer writes nothing; the serving path passes null.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_fwd.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// bf16: the wgmma mainloop fed by TMA
// ---------------------------------------------------------------------------

// Two consumer warpgroups (128 query rows) up to head_dim 128; one at 256,
// where a thread holds 128 accumulator floats: with two warpgroups ptxas
// spilled and serialised the wgmmas there, and one measured faster.
template <int HD>
struct FlashGeom : attn::Block<(HD > 128 ? 1 : 2)> {
    static constexpr int NCB = HD / 64;                                // 64-column blocks
    static constexpr int Q_BYTES = FlashGeom::NWG * NCB * attn::COL_BLOCK;
    static constexpr int STAGE_BYTES = 2 * NCB * attn::COL_BLOCK;      // K then V
    static constexpr int FIT = (attn::SMEM_LIMIT - 2048 - Q_BYTES) / STAGE_BYTES;
    static constexpr int STAGES = FIT < 4 ? FIT : 4;
    static constexpr int BAR = Q_BYTES + STAGES * STAGE_BYTES;
    // 1024 bytes of slack to align the tiles for the 128-byte swizzle
    static constexpr size_t bytes = 1024 + BAR + 8 * (2 * STAGES + 1);
    static_assert(STAGES >= 2 && bytes <= attn::SMEM_LIMIT, "the tiles must fit in shared memory");
};

template <int HD>
__global__ void __launch_bounds__(FlashGeom<HD>::NT, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const int* __restrict__ seg,
                       __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int S, int H,
                       int Hkv, float scale_log2, int causal, int window) {
    using namespace attn;
    using G = FlashGeom<HD>;
    constexpr int NWG = G::NWG, BQ = G::BQ;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    const uint32_t base = smem_u32(smem);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::BAR);
    uint64_t* empty = full + G::STAGES;
    uint64_t* qbar = empty + G::STAGES;

    const int h = blockIdx.x;
    const int b = blockIdx.y;
    const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;   // the heaviest causal tiles first
    const int kh = h / (H / Hkv);
    // key tiles holding at least one visible key for some row of this block
    int kt_end = (S + BK - 1) / BK;
    if (causal) kt_end = min(kt_end, (min(q0 + BQ, S) - 1) / BK + 1);
    const int kt_begin = (window > 0 && q0 - window + 1 > 0) ? (q0 - window + 1) / BK : 0;

    const int tid = threadIdx.x;
    if (tid == 0) {
        for (int i = 0; i < G::STAGES; ++i) {
            mbar_init(&full[i], 1);
            mbar_init(&empty[i], NWG * 128);
        }
        mbar_init(qbar, 1);
        mbar_init_fence();
    }
    __syncthreads();

    if (tid >= NWG * 128) {   // the producer warpgroup: one thread issues every load
        setmaxnreg_dec<TMA_PRODUCER_REGS>();
        if (tid == NWG * 128) {
            mbar_expect_tx(qbar, G::Q_BYTES);
            for (int w = 0; w < NWG; ++w)
                for (int cb = 0; cb < G::NCB; ++cb)
                    tma_load_4d(base + (w * G::NCB + cb) * COL_BLOCK, &tq, qbar, cb * 64, h,
                                q0 + 64 * w, b);
            for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
                const int st = i % G::STAGES;
                if (i >= G::STAGES) mbar_wait(&empty[st], ((i / G::STAGES) - 1) & 1);
                mbar_expect_tx(&full[st], G::STAGE_BYTES);
                const uint32_t sk = base + G::Q_BYTES + st * G::STAGE_BYTES;
                for (int cb = 0; cb < G::NCB; ++cb) {
                    tma_load_4d(sk + cb * COL_BLOCK, &tk, &full[st], cb * 64, kh, kt * BK, b);
                    tma_load_4d(sk + (G::NCB + cb) * COL_BLOCK, &tv, &full[st], cb * 64, kh,
                                kt * BK, b);
                }
            }
        }
        return;
    }

    setmaxnreg_inc<TMA_CONSUMER_REGS>();
    const int wg = tid / 128;
    const int lane = tid % 32;
    const int quad = lane & 3;
    const int r0 = q0 + 64 * wg + 16 * ((tid % 128) / 32) + lane / 4;
    const int qrow[2] = {r0, r0 + 8};
    const int* segb = seg + (size_t)b * S;
    int segq[2];
#pragma unroll
    for (int rs = 0; rs < 2; ++rs) segq[rs] = qrow[rs] < S ? segb[qrow[rs]] : 0;
    const uint32_t sq = base + wg * G::NCB * COL_BLOCK;

    Consumer<HD> c;
    c.init();
    mbar_wait(qbar, 0);
    for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
        const int st = i % G::STAGES;
        const int k0 = kt * BK;
        // bit 2 J + e (+ 16 for row r0 + 8): key column 8 J + 2 quad + e is
        // inside S and in the row's segment
        uint32_t same = 0u;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int kpos = k0 + 8 * j + 2 * quad + e;
                const int ks = kpos < S ? segb[kpos] : 0;
                same |= (kpos < S && ks == segq[0] ? 1u : 0u) << (2 * j + e);
                same |= (kpos < S && ks == segq[1] ? 1u : 0u) << (16 + 2 * j + e);
            }
        // every key of the tile visible to both rows of every thread of the warp
        const bool full_tile = same == 0xffffffffu && qrow[1] < S
                               && (!causal || k0 + BK - 1 <= qrow[0])
                               && (window <= 0 || qrow[1] - k0 < window);
        const bool masked = !__all_sync(0xffffffffu, full_tile);
        mbar_wait(&full[st], (i / G::STAGES) & 1);
        const uint32_t sk = base + G::Q_BYTES + st * G::STAGE_BYTES;
        c.tile(sq, sk, sk + G::NCB * COL_BLOCK, scale_log2, masked, [&](int rs, int j, int e) {
            const int kpos = k0 + 8 * j + 2 * quad + e;
            const int qp = qrow[rs];
            bool ok = ((same >> (16 * rs + 2 * j + e)) & 1u) && qp < S;
            if (causal) ok = ok && qp >= kpos;
            if (window > 0) ok = ok && qp - kpos < window;
            return ok;
        });
        mbar_arrive(&empty[st]);
    }
    c.finish();
    if (lse != nullptr && quad == 0) {
#pragma unroll
        for (int rs = 0; rs < 2; ++rs)
            if (qrow[rs] < S)   // m is in the log2 domain
                lse[((size_t)b * H + h) * S + qrow[rs]] =
                    c.l[rs] > 0.f ? (c.m[rs] + log2f(c.l[rs])) * LN2 : -INFINITY;
    }
    __nv_bfloat16* rows[2];
#pragma unroll
    for (int rs = 0; rs < 2; ++rs)
        rows[rs] = qrow[rs] < S ? out + (((size_t)b * S + qrow[rs]) * H + h) * HD : nullptr;
    c.template store<HD>(rows, quad);
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const int* seg, void* out,
                        float* lse, int B, int S, int H, int Hkv, float scale, int causal,
                        int window, cudaStream_t stream) {
    CUtensorMap mq, mk, mv;
    if (!attn::tensor_map(&mq, q, B, S, H, HD) || !attn::tensor_map(&mk, k, B, S, Hkv, HD)
        || !attn::tensor_map(&mv, v, B, S, Hkv, HD))
        return cudaErrorInvalidValue;
    constexpr size_t smem = FlashGeom<HD>::bytes;
    auto kern = flash_fwd_wgmma_kernel<HD>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid(H, B, (S + FlashGeom<HD>::BQ - 1) / FlashGeom<HD>::BQ);
    kern<<<grid, FlashGeom<HD>::NT, smem, stream>>>(mq, mk, mv, seg,
                                                    static_cast<__nv_bfloat16*>(out), lse, S, H,
                                                    Hkv, scale * LOG2E, causal, window);
    return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: one block per (64-row q tile, q head, batch row), FMA loops
// ---------------------------------------------------------------------------

constexpr int BQ32 = 64;   // query rows per block
constexpr int BK32 = 64;   // key rows per tile

// threads per query row: 2 up to head_dim 128, 4 at 256
template <int HD>
struct Threads {
    static constexpr int TPR = HD > 128 ? 4 : 2;
    static constexpr int NT = BQ32 * TPR;
};

// q, k and v tiles, rows padded by 16 bytes, then the scores
template <int HD>
struct Layout32 {
    static constexpr int LDT = HD + 4;
    static constexpr int LDS = BK32 + 4;
    static constexpr size_t q = 0;
    static constexpr size_t v = q + sizeof(float) * BQ32 * LDT;
    static constexpr size_t k = v + sizeof(float) * BK32 * LDT;
    static constexpr size_t s = k + sizeof(float) * BK32 * LDT;
    static constexpr size_t seg = s + sizeof(float) * BQ32 * LDS;
    static constexpr size_t bytes = seg + sizeof(int) * BK32;
    static_assert(bytes <= 232448, "the tiles must fit in 227 KB of shared memory");
};

// up to 64 rows of HD floats from a strided global row set into a padded
// shared tile; rows past `valid` are zero-filled
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* src, size_t row_stride,
                                          int valid, int tid) {
    constexpr int VPR = HD / 4;
    for (int i = tid; i < 64 * VPR; i += Threads<HD>::NT) {
        const int r = i / VPR;
        const int c = (i % VPR) * 4;
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < valid) val = *reinterpret_cast<const float4*>(src + (size_t)r * row_stride + c);
        *reinterpret_cast<float4*>(dst + r * Layout32<HD>::LDT + c) = val;
    }
}

template <int HD>
__global__ void __launch_bounds__(Threads<HD>::NT)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ seg,
                     float* __restrict__ out, float* __restrict__ lse, int S, int H, int Hkv,
                     float scale, int causal, int window) {
    using L = Layout32<HD>;
    constexpr int LDT = L::LDT, LDS = L::LDS;
    constexpr int TPR = Threads<HD>::TPR;
    constexpr int HALF = HD / TPR;   // output columns per thread
    constexpr int KH = BK32 / TPR;   // score columns per thread
    extern __shared__ __align__(16) unsigned char smem[];
    float* sQ = reinterpret_cast<float*>(smem + L::q);
    float* sK = reinterpret_cast<float*>(smem + L::k);
    float* sV = reinterpret_cast<float*>(smem + L::v);
    float* sS = reinterpret_cast<float*>(smem + L::s);
    int* sSeg = reinterpret_cast<int*>(smem + L::seg);

    const int q0 = blockIdx.x * BQ32;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int kh = h / (H / Hkv);
    const int tid = threadIdx.x;
    // TPR neighbouring threads per query row; thread `part` of a row owns
    // its score and output columns j with j % TPR == part
    const int row = tid / TPR;
    const int part = tid % TPR;
    const int qpos = q0 + row;
    const bool row_ok = qpos < S;
    const int seg_q = row_ok ? seg[(size_t)b * S + qpos] : 0;

    const size_t q_stride = (size_t)H * HD;
    const size_t kv_stride = (size_t)Hkv * HD;
    const float* qb = q + (size_t)b * S * q_stride + (size_t)h * HD;
    const float* kb = k + (size_t)b * S * kv_stride + (size_t)kh * HD;
    const float* vb = v + (size_t)b * S * kv_stride + (size_t)kh * HD;

    load_tile<HD>(sQ, qb + (size_t)q0 * q_stride, q_stride, S - q0, tid);

    int kt_end = (S + BK32 - 1) / BK32;
    if (causal) kt_end = min(kt_end, (min(q0 + BQ32, S) - 1) / BK32 + 1);
    int kt_begin = 0;
    if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / BK32;

    float m = NEG_INF, l = 0.f;
    float acc[HALF];
#pragma unroll
    for (int c = 0; c < HALF; ++c) acc[c] = 0.f;

    for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int k0 = kt * BK32;
        __syncthreads();   // the previous tile's readers are done
        load_tile<HD>(sK, kb + (size_t)k0 * kv_stride, kv_stride, S - k0, tid);
        load_tile<HD>(sV, vb + (size_t)k0 * kv_stride, kv_stride, S - k0, tid);
        if (tid < BK32) sSeg[tid] = (k0 + tid < S) ? seg[(size_t)b * S + k0 + tid] : 0;
        __syncthreads();

        float sv[KH];
        uint32_t ok = 0u;
        float mt = NEG_INF;
#pragma unroll
        for (int jj = 0; jj < KH; ++jj) {
            const int j = TPR * jj + part;
            const int kpos = k0 + j;
            bool valid = row_ok && kpos < S && sSeg[j] == seg_q;
            if (causal) valid = valid && qpos >= kpos;
            if (window > 0) valid = valid && (qpos - kpos) < window;
            float d = 0.f;
            if (valid) {
#pragma unroll 8
                for (int c = 0; c < HD; ++c) d += sQ[row * LDT + c] * sK[j * LDT + c];
            }
            sv[jj] = valid ? d * scale : NEG_INF;
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
            const int j = TPR * jj + part;
            const float p = ((ok >> jj) & 1u) ? expf(sv[jj] - m_new) : 0.f;
            ls += p;
            sS[row * LDS + j] = p;
        }
#pragma unroll
        for (int o = 1; o < TPR; o <<= 1) ls += __shfl_xor_sync(0xffffffffu, ls, o);
        l = l * alpha + ls;
        m = m_new;
#pragma unroll
        for (int c = 0; c < HALF; ++c) acc[c] *= alpha;
        __syncwarp();   // a row's probabilities are written by its own warp
        for (int j = 0; j < BK32; ++j) {
            const float p = sS[row * LDS + j];
#pragma unroll
            for (int c = 0; c < HALF; ++c) acc[c] += p * sV[j * LDT + TPR * c + part];
        }
    }

    if (row_ok) {
        const float inv = 1.f / fmaxf(l, 1e-30f);
        float* orow = out + ((size_t)b * S + qpos) * q_stride + (size_t)h * HD + part;
#pragma unroll
        for (int c = 0; c < HALF; ++c) orow[TPR * c] = acc[c] * inv;
        if (lse != nullptr && part == 0)
            lse[((size_t)b * H + h) * S + qpos] = l > 0.f ? m + logf(l) : -INFINITY;
    }
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const int* seg, void* out,
                       float* lse, int B, int S, int H, int Hkv, float scale, int causal,
                       int window, cudaStream_t stream) {
    constexpr size_t smem = Layout32<HD>::bytes;
    auto kern = flash_fwd_f32_kernel<HD>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((S + BQ32 - 1) / BQ32, H, B);
    kern<<<grid, Threads<HD>::NT, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        seg, static_cast<float*>(out), lse, S, H, Hkv, scale, causal, window);
    return cudaGetLastError();
}

}  // namespace

// q: (B, S, H, hd); k, v: (B, S, Hkv, hd); seg: (B, S) int32; out like q;
// lse: (B, H, S) float32 or null.  dtype: 0 = float32, 1 = bfloat16.  hd
// must be 64, 128 or 256.  Returns the CUDA error of the launch (0 =
// success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* seg, void* out, void* lse_out, int B, int S,
                                   int H, int Hkv, int hd, int dtype, float scale, int causal,
                                   int window, void* stream) {
    const int* sg = static_cast<const int*>(seg);
    float* lse = static_cast<float*>(lse_out);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
    if (dtype == 1 && hd == 256)
        return launch_bf16<256>(q, k, v, sg, out, lse, B, S, H, Hkv, scale, causal, window, st);
    if (dtype == 1 && hd == 128)
        return launch_bf16<128>(q, k, v, sg, out, lse, B, S, H, Hkv, scale, causal, window, st);
    if (dtype == 1 && hd == 64)
        return launch_bf16<64>(q, k, v, sg, out, lse, B, S, H, Hkv, scale, causal, window, st);
    if (dtype == 0 && hd == 256)
        return launch_f32<256>(q, k, v, sg, out, lse, B, S, H, Hkv, scale, causal, window, st);
    if (dtype == 0 && hd == 128)
        return launch_f32<128>(q, k, v, sg, out, lse, B, S, H, Hkv, scale, causal, window, st);
    if (dtype == 0 && hd == 64)
        return launch_f32<64>(q, k, v, sg, out, lse, B, S, H, Hkv, scale, causal, window, st);
    return (int)cudaErrorInvalidValue;
}
