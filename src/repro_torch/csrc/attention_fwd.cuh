// The attention forward mainloop for Hopper (sm_90a), shared by the dense
// prefill kernel (flash_attention.cu, K/V tiles loaded by TMA) and the
// paged prefill kernel (paged_prefill_attention.cu, K/V rows gathered
// through a block table with cp.async).
//
// A block is one or two consumer warpgroups, each owning 64 query rows,
// and one producer warpgroup that fills a ring of K/V stages in shared
// memory, each guarded by a "full" and an "empty" mbarrier.  setmaxnreg moves
// registers from the producer, which needs few, to the consumers.  Per
// 64-key tile a consumer warpgroup
//  1. computes S = Q K^T with wgmma m64n64k16 from shared memory (Q and K
//     K-major, 128-byte swizzle); the scores stay in the accumulator
//     registers;
//  2. masks them per (row, key) and runs the online softmax on the
//     fragments: row max and sum from quad shuffles, the rescale of O by
//     alpha in registers, probabilities in the log2 domain;
//  3. converts P to bf16 A fragments in registers (the m64n64 accumulator
//     layout is the A layout of two k16 steps) and computes O += P V with
//     register-sourced wgmma, V read MN-major (keys x hd, as loaded), so
//     nothing is transposed and P never touches shared memory;
//  4. releases the stage to the producer.
// The softmax, not the products, holds the tile's time at these widths:
// a tile that every row of a warp sees whole skips the per-element mask
// (a warp-uniform test), and exp2 is ex2.approx.ftz.  A row that sees no
// key keeps l = 0 and writes 0 (the max(l, 1e-30) clamp of the TPU
// kernels).
//
// Shared tiles are stored as 64-column blocks of 64 rows x 128 bytes,
// 1024-byte aligned, with the 128-byte swizzle (16-byte chunk c of row r
// at chunk c ^ (r % 8)) that TMA's CU_TENSOR_MAP_SWIZZLE_128B writes and
// the wgmma descriptors declare.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

constexpr int BK = 64;                  // keys per tile
constexpr int COL_BLOCK = 64 * BK * 2;  // bytes of one 64-row x 64-column bf16 block
constexpr int SMEM_LIMIT = 232448;      // shared bytes a block may take

// A block: NWG consumer warpgroups of 64 query rows each, then one
// producer warpgroup; one block per SM.
template <int NWG_>
struct Block {
    static constexpr int NWG = NWG_;
    static constexpr int BQ = 64 * NWG;           // query rows per block
    static constexpr int NT = 128 * (NWG + 1);    // threads
};

// registers per thread after setmaxnreg, (producer + 2 consumers) x 128 <=
// 65536: a TMA producer needs fewer than a gathering one
constexpr int TMA_PRODUCER_REGS = 24;
constexpr int TMA_CONSUMER_REGS = 240;
constexpr int GATHER_PRODUCER_REGS = 40;
constexpr int GATHER_CONSUMER_REGS = 232;
constexpr float NEG_INF = -1e30f;
// named barriers (0 is __syncthreads): the producer warpgroup, all
// consumers, and consumer warpgroup w at BAR_CONSUMER_WG + w
constexpr int BAR_PRODUCER = 1, BAR_CONSUMERS = 2, BAR_CONSUMER_WG = 3;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c (0..7) of row r in a swizzled 64-column block
__device__ __forceinline__ uint32_t swz(int r, int c) {
    return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}

// ---- mbarriers --------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    return done != 0;
}

// wait until the phase of parity `parity` has completed; a wait of more
// than ~2^35 cycles (~15 s) is a fault of the pipeline, and traps rather
// than hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = smem_u32(bar);
    if (mbar_try_wait(addr, parity)) return;
    const long long t0 = clock64();
    while (!mbar_try_wait(addr, parity))
        if (clock64() - t0 > (1ll << 35)) __trap();
}

// generic-proxy writes to shared memory (stores, cp.async) made visible
// to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---- asynchronous copies ----------------------------------------------

// 16 bytes global -> shared; with ok = false nothing is read and the
// destination is zero-filled (source size 0)
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool ok) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

// one arrival on `bar` once every cp.async this thread issued so far has landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                 ::"r"(smem_u32(bar)) : "memory");
}

// TMA: a box of a 4-d tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
        ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
          "r"(smem_u32(bar)) : "memory");
}

// TMA: a box of a 2-d tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map, uint64_t* bar,
                                            int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3}], [%4];\n"
        ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
          "r"(smem_u32(bar)) : "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime so
// that the library needs no -lcuda
inline EncodeTiled encoder() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
        cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &found);
#endif
        if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// A tensor map over x (B, S, Hx, hd) bf16 as (hd, Hx, S, B), boxes of 64
// columns x 1 head x 64 rows x 1 batch row, 128-byte swizzle; rows past S
// read as zeros.  Used by the forward and the backward (flash_attention_bwd.cu).
inline bool tensor_map(CUtensorMap* map, const void* x, int B, int S, int Hx, int hd) {
    EncodeTiled enc = encoder();
    if (enc == nullptr) return false;
    const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)Hx, (cuuint64_t)S, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)Hx * hd * 2,
                                   (cuuint64_t)S * Hx * hd * 2};
    const cuuint32_t box[4] = {64, 1, BK, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides,
               box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE)
           == CUDA_SUCCESS;
}

// ---- wgmma --------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accesses of accumulator registers across
// the asynchronous wgmma that owns them
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptors, 128-byte swizzle.  K-major (Q, K):
// 8-row groups 1024 bytes apart (SBO), the leading offset unused; a k16
// step inside a 64-column block adds 32 bytes to the start address.
// MN-major (V, keys x hd): 8-key groups 1024 bytes apart (SBO), 64-column
// blocks COL_BLOCK bytes apart (LBO).
__device__ __forceinline__ uint64_t desc_encode(uint32_t x) { return (uint64_t)((x & 0x3FFFF) >> 4); }
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
    return desc_encode(addr) | (desc_encode(16) << 16) | (desc_encode(1024) << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr) {
    return desc_encode(addr) | (desc_encode(COL_BLOCK) << 16) | (desc_encode(1024) << 32)
           | (1ull << 62);
}

// D (m64 x n64, f32) += A (m64 x k16) * B (k16 x n64), A and B in shared
// memory, both K-major, through descriptors.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
        "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
}

// D (m64 x n64, f32) += A (m64 x k16, bf16 fragments in registers) * B
// (k16 x n64) in shared memory, MN-major (trans-b = 1).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
        "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (m64 x n128, f32) += A (m64 x k16, bf16 fragments in registers) * B
// (k16 x n128) in shared memory, MN-major (trans-b = 1).
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
        "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
        "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, "
        "%49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x, flushing subnormal results to 0 (x <= 0 here: a probability)
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// The running softmax state and output of one consumer thread over key
// tiles, for head widths up to HDP (64, 128 or 256; a multiple of 64).
// Thread `lane` of warp w of the warpgroup owns rows r0 = 16 w + lane / 4
// and r0 + 8 of the warpgroup's 64, and in each 8-column chunk J the
// columns 8 J + 2 (lane % 4) + {0, 1}: accumulator element 4 J + e is row
// r0 + 8 (e / 2), column 8 J + 2 (lane % 4) + e % 2.  m is in the log2
// domain (scores times scale * log2 e); l is this thread's share of the
// row sum until finish() adds the quad's shares.
template <int HDP>
struct Consumer {
    static_assert(HDP == 64 || HDP == 128 || HDP == 256, "HDP is 64, 128 or 256");
    static constexpr int NO = HDP / 2;
    float o[NO];
    float m[2], l[2];

    __device__ __forceinline__ void init() {
#pragma unroll
        for (int i = 0; i < NO; ++i) o[i] = 0.f;
        m[0] = m[1] = NEG_INF;
        l[0] = l[1] = 0.f;
    }

    // One tile of BK keys.  sq: the warpgroup's Q tile (HDP / 64 blocks of
    // 64 rows); sk, sv: the stage's K and V tiles (keys x hd, the same
    // layout).  valid(rs, J, e): key column 8 J + 2 (lane % 4) + e of the
    // tile is visible to row r0 + 8 rs.  masked = false (uniform over the
    // warp) when every key of the tile is visible to every row of the
    // warp: the mask is then skipped.
    template <typename Valid>
    __device__ __forceinline__ void tile(uint32_t sq, uint32_t sk, uint32_t sv, float scale_log2,
                                         bool masked, Valid valid) {
        float s[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = 0.f;
        fence_regs<32>(s);
        wgmma_fence();
        // a k16 step's descriptors are the tile's plus its offset in 16-byte units
        const uint64_t dq = desc_k_major(sq), dk = desc_k_major(sk);
#pragma unroll
        for (int ks = 0; ks < HDP / 16; ++ks) {
            const uint32_t off = ((ks / 4) * COL_BLOCK + (ks % 4) * 32) >> 4;
            wgmma_ss_n64(s, dq + off, dk + off);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<32>(s);

        // scale, mask, and the tile's row max over the quad
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] *= scale_log2;
        if (masked) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    if (!valid(e >> 1, j, e & 1)) s[4 * j + e] = NEG_INF;
        }
        float mt[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int i = 0; i < 32; ++i) mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], s[i]);
        float alpha[2];
#pragma unroll
        for (int rs = 0; rs < 2; ++rs) {
            mt[rs] = fmaxf(mt[rs], __shfl_xor_sync(0xffffffffu, mt[rs], 1));
            mt[rs] = fmaxf(mt[rs], __shfl_xor_sync(0xffffffffu, mt[rs], 2));
            const float mn = fmaxf(m[rs], mt[rs]);
            alpha[rs] = ex2(m[rs] - mn);
            m[rs] = mn;
            l[rs] *= alpha[rs];
        }
        // P as bf16 A fragments: k16 step kk covers chunks 2 kk and 2 kk + 1.
        // A masked key gives 0 explicitly: in a row that has seen no key
        // yet, m is NEG_INF and exp2 of the difference would be 1.
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            const float x = s[i];
            s[i] = ex2(x - m[(i >> 1) & 1]);
            if (masked && x == NEG_INF) s[i] = 0.f;
            l[(i >> 1) & 1] += s[i];
        }
        uint32_t p[4][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            p[j >> 1][(j & 1) * 2] = pack_bf16(s[4 * j], s[4 * j + 1]);
            p[j >> 1][(j & 1) * 2 + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
        }
#pragma unroll
        for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];

        // O += P V
        fence_regs<NO>(o);
        wgmma_fence();
        const uint64_t dv = desc_mn_major(sv);
        constexpr int PARTS = HDP == 64 ? 1 : HDP / 128;   // one n64, or an n128 per 128 columns
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
            for (int hh = 0; hh < PARTS; ++hh) {
                const uint32_t off = (kk * 16 * 128 + 2 * hh * COL_BLOCK) >> 4;
                if constexpr (HDP == 64) {
                    wgmma_rs_n64(o, p[kk], dv + off);
                } else {
                    wgmma_rs_n128(o + 64 * hh, p[kk], dv + off);
                }
            }
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<NO>(o);
    }

    // the quad's row sums, after the last tile
    __device__ __forceinline__ void finish() {
#pragma unroll
        for (int rs = 0; rs < 2; ++rs) {
            l[rs] += __shfl_xor_sync(0xffffffffu, l[rs], 1);
            l[rs] += __shfl_xor_sync(0xffffffffu, l[rs], 2);
        }
    }

    // the normalised output of rows r0 (row[0]) and r0 + 8 (row[1]), the
    // first HD columns; a null row is skipped
    template <int HD>
    __device__ __forceinline__ void store(__nv_bfloat16* const (&row)[2], int quad) const {
#pragma unroll
        for (int rs = 0; rs < 2; ++rs) {
            if (row[rs] == nullptr) continue;
            const float inv = 1.f / fmaxf(l[rs], 1e-30f);
#pragma unroll
            for (int j = 0; j < HD / 8; ++j)
                *reinterpret_cast<__nv_bfloat162*>(row[rs] + 8 * j + 2 * quad) =
                    __floats2bfloat162_rn(o[4 * j + 2 * rs] * inv, o[4 * j + 2 * rs + 1] * inv);
        }
    }
};

}  // namespace attn
