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
// visible QK^T and PV products: its bound is a few microseconds, and
// with one block per (q tile, head) it would be 12 blocks on 132 SMs,
// bound by the latency of one block walking every key tile in series.
//
// What the design does about it (bf16):
//  * the mainloop of attention_fwd.cuh (two consumer warpgroups of 64
//    query rows on wgmma, a producer warpgroup, a ring of 2 K/V stages);
//    head_dim 32 and 80 are padded with zero columns in shared memory
//    (to 64 and 128), never in device memory.
//  * the producer gathers: per key tile it stages the tile's block ids
//    from the slot's table in shared memory (common.cuh::load_blocks), then
//    copies the K/V rows with 16-byte cp.async into the swizzled stage.  A
//    row whose entry is unbound (-1) or past the table, or that no query of
//    the tile can see, is never dereferenced and is zero-filled (source
//    size 0): P = 0 times stale shared memory could be NaN.  Each producer
//    thread arrives on the stage's full barrier twice, once by
//    cp.async.mbarrier.arrive when its copies land and once plainly, which
//    publishes its row flags.
//  * the mask is positional per (query, key): the key's row was read,
//    key position <= q_pos, q_pos >= 0, and for a window q_pos - key <
//    window.  So a chunk that starts at a nonzero offset needs no special
//    case, and a padded query row (q_pos = -1) sees nothing and writes 0.
//  * a split over keys fills the card: the grid is (q head, q tile x
//    n_split, slot), n_split planned by the wrapper from the shapes.  A
//    block takes its share of the key tiles its q tile can see (at most
//    that many splits are used); each split writes its partial (m, l,
//    acc) in f32 to scratch, and the last block of a (q tile, head) to
//    finish, found by a counter it resets itself, merges them in split
//    order: no float atomics, and a repeated call gives the same bits.
//    With one split the block writes its output directly.
// f32 inputs (the CPU-parity dtype, not the serving one) take a plain FMA
// loop over 64-row tiles, one block per (q tile, head, slot), no split.

#include <limits.h>

#include "attention_fwd.cuh"
#include "common.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bf16: the wgmma mainloop fed by a cp.async gather
// ---------------------------------------------------------------------------

template <int HD>
struct PagedGeom : attn::Block<2> {
    static constexpr int HDP = HD <= 64 ? 64 : 128;   // head_dim padded in shared memory
    static constexpr int NCB = HDP / 64;
    static constexpr int CPR = HD / 8;                // 16-byte chunks of a real row
    static constexpr int STAGES = 2;
    static constexpr int MAX_ENTRIES = attn::BK + 8;  // table entries of a key tile (<= 65)
    static constexpr int Q_BYTES = PagedGeom::NWG * NCB * attn::COL_BLOCK;
    static constexpr int STAGE_BYTES = 2 * NCB * attn::COL_BLOCK;   // K then V
    static constexpr int ROWS = Q_BYTES + STAGES * STAGE_BYTES;       // per stage: row read
    static constexpr int BLK = ROWS + STAGES * attn::BK * 4;          // per stage: block ids
    static constexpr int RED = BLK + STAGES * MAX_ENTRIES * 4;        // q_pos max, min; flag
    static constexpr int BAR = RED + ((2 * PagedGeom::NT / 32 + 1) * 4 + 7) / 8 * 8;
    static constexpr size_t bytes = 1024 + BAR + 8 * 2 * STAGES;
    static_assert(HD % 16 == 0 && HD <= HDP, "head_dim is 32, 64, 80 or 128");
    static_assert(bytes <= attn::SMEM_LIMIT, "the tiles must fit in shared memory");
};

template <int HD>
__global__ void __launch_bounds__(PagedGeom<HD>::NT, 1)
paged_prefill_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ kp,
                           const __nv_bfloat16* __restrict__ vp, const int* __restrict__ tables,
                           const int* __restrict__ q_pos, __nv_bfloat16* __restrict__ out,
                           float2* __restrict__ part_ml, float* __restrict__ part_acc,
                           int* __restrict__ counters, int C, int E, int bs, int H, int Hkv,
                           int n_split, float scale_log2, int window) {
    using namespace attn;
    using G = PagedGeom<HD>;
    constexpr int NWG = G::NWG, BQ = G::BQ, NT = G::NT;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    const uint32_t base = smem_u32(smem);
    int* sRow = reinterpret_cast<int*>(smem + G::ROWS);
    int* sBlk = reinterpret_cast<int*>(smem + G::BLK);
    int* sRed = reinterpret_cast<int*>(smem + G::RED);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::BAR);
    uint64_t* empty = full + G::STAGES;

    const int h = blockIdx.x;
    const int qt = blockIdx.y / n_split;
    const int split = blockIdx.y % n_split;
    const int b = blockIdx.z;
    const int q0 = qt * BQ;
    const int kh = h / (H / Hkv);
    const int* tab = tables + (size_t)b * E;
    const int* qpb = q_pos + (size_t)b * C;
    const int tid = threadIdx.x;
    const int lane = tid % 32;

    // the tile's lowest and highest real query position
    const int p = (tid < BQ && q0 + tid < C) ? qpb[q0 + tid] : -1;
    const int wmax = __reduce_max_sync(0xffffffffu, p);
    const int wmin = __reduce_min_sync(0xffffffffu, p >= 0 ? p : INT_MAX);
    if (lane == 0) {
        sRed[tid / 32] = wmax;
        sRed[NT / 32 + tid / 32] = wmin;
    }
    if (tid == 0) {
        for (int i = 0; i < G::STAGES; ++i) {
            mbar_init(&full[i], 2 * 128);   // a cp.async arrival and a plain one per producer thread
            mbar_init(&empty[i], NWG * 128);
        }
        mbar_init_fence();
    }
    if constexpr (HD < G::HDP) {
        // the padding columns of the stages are never written again
        for (int i = tid; i < G::STAGES * G::STAGE_BYTES / 16; i += NT)
            reinterpret_cast<uint4*>(smem + G::Q_BYTES)[i] = make_uint4(0u, 0u, 0u, 0u);
        fence_proxy_async();
    }
    __syncthreads();
    int qmax = -1, qmin = INT_MAX;
#pragma unroll
    for (int w = 0; w < BQ / 32; ++w) {
        qmax = max(qmax, sRed[w]);
        qmin = min(qmin, sRed[NT / 32 + w]);
    }

    // key tiles that hold a key some row of this tile can see, and this
    // split's share of them (splits past the visible tiles have none)
    const int kt_end = (qmax < 0) ? 0 : min(qmax / BK + 1, (E * bs + BK - 1) / BK);
    const int kt_begin =
        (window > 0 && qmax >= 0 && qmin - window + 1 > 0) ? (qmin - window + 1) / BK : 0;
    const int n_vis = max(0, kt_end - kt_begin);
    const int n_eff = max(1, min(n_split, n_vis));
    if (split >= n_eff) return;
    const int lo = kt_begin + split * n_vis / n_eff;
    const int hi = kt_begin + (split + 1) * n_vis / n_eff;

    if (tid >= NWG * 128) {   // the producer warpgroup gathers K/V rows
        setmaxnreg_dec<GATHER_PRODUCER_REGS>();
        const int pt = tid - NWG * 128;
        const int r = pt % BK;   // this thread's key row of every tile
        for (int kt = lo, i = 0; kt < hi; ++kt, ++i) {
            const int st = i % G::STAGES;
            if (i >= G::STAGES) mbar_wait(&empty[st], ((i / G::STAGES) - 1) & 1);
            const int k0 = kt * BK;
            const int e0 = k0 / bs;
            int* blk = sBlk + st * G::MAX_ENTRIES;
            paged::load_blocks(blk, tab, e0, (k0 + BK - 1) / bs, E, pt, 128);
            named_sync(BAR_PRODUCER, 128);
            const int kpos = k0 + r;
            const int id = blk[kpos / bs - e0];
            const bool ok = id >= 0 && kpos <= qmax && (window <= 0 || kpos > qmin - window);
            const size_t off = ok ? ((size_t)id * bs + kpos % bs) * Hkv * HD + (size_t)kh * HD : 0;
            const uint32_t sk = base + G::Q_BYTES + st * G::STAGE_BYTES;
            const uint32_t sv = sk + G::NCB * COL_BLOCK;
            for (int c = pt / BK; c < G::CPR; c += 128 / BK) {
                const uint32_t dst = (c / 8) * COL_BLOCK + swz(r, c % 8);
                cp_async_16(sk + dst, kp + off + 8 * c, ok);
                cp_async_16(sv + dst, vp + off + 8 * c, ok);
            }
            if (pt < BK) sRow[st * BK + r] = ok;
            cp_async_arrive(&full[st]);
            mbar_arrive(&full[st]);
        }
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        return;
    }

    setmaxnreg_inc<GATHER_CONSUMER_REGS>();
    const int wg = tid / 128;
    const int quad = lane & 3;
    const int rl = 64 * wg + 16 * ((tid % 128) / 32) + lane / 4;   // row in the block
    // this warpgroup's Q rows, zero past C and in the padding columns
    const int q_off = wg * G::NCB * COL_BLOCK;
    for (int i = tid % 128; i < 64 * (G::HDP / 8); i += 128) {
        const int r = i / (G::HDP / 8);
        const int c = i % (G::HDP / 8);
        const int qi = q0 + 64 * wg + r;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (qi < C && c < G::CPR)
            val = *reinterpret_cast<const uint4*>(q + (((size_t)b * C + qi) * H + h) * HD + 8 * c);
        *reinterpret_cast<uint4*>(smem + q_off + (c / 8) * COL_BLOCK + swz(r, c % 8)) = val;
    }
    fence_proxy_async();
    named_sync(BAR_CONSUMER_WG + wg, 128);
    int qp[2];
#pragma unroll
    for (int rs = 0; rs < 2; ++rs) {
        const int qi = q0 + rl + 8 * rs;
        qp[rs] = qi < C ? qpb[qi] : -1;
    }

    Consumer<G::HDP> c;
    c.init();
    for (int kt = lo, i = 0; kt < hi; ++kt, ++i) {
        const int st = i % G::STAGES;
        const int k0 = kt * BK;
        mbar_wait(&full[st], (i / G::STAGES) & 1);
        fence_proxy_async();   // the gathered rows, written through the generic proxy
        uint32_t read = 0u;    // which of this thread's key columns were read
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
                read |= (sRow[st * BK + 8 * j + 2 * quad + e] != 0 ? 1u : 0u) << (2 * j + e);
        // every key of the tile read and visible to both rows of every thread of the warp
        const bool full_tile = read == 0xffffu && min(qp[0], qp[1]) >= k0 + BK - 1
                               && (window <= 0 || k0 > max(qp[0], qp[1]) - window);
        const bool masked = !__all_sync(0xffffffffu, full_tile);
        const uint32_t sk = base + G::Q_BYTES + st * G::STAGE_BYTES;
        c.tile(base + q_off, sk, sk + G::NCB * COL_BLOCK, scale_log2, masked,
               [&](int rs, int j, int e) {
            const int kpos = k0 + 8 * j + 2 * quad + e;
            const int pos = qp[rs];
            bool ok = ((read >> (2 * j + e)) & 1u) && pos >= 0 && kpos <= pos;
            if (window > 0) ok = ok && kpos > pos - window;
            return ok;
        });
        mbar_arrive(&empty[st]);
    }
    c.finish();

    __nv_bfloat16* rows[2];
#pragma unroll
    for (int rs = 0; rs < 2; ++rs) {
        const int qi = q0 + rl + 8 * rs;
        rows[rs] = qi < C ? out + (((size_t)b * C + qi) * H + h) * HD : nullptr;
    }
    if (n_eff == 1) {
        c.template store<HD>(rows, quad);
        return;
    }

    // this split's partial state: (m, l) per row and the unnormalised acc
    const int tile_id = (b * H + h) * (gridDim.y / n_split) + qt;
    const size_t slot = (size_t)tile_id * n_split;
#pragma unroll
    for (int rs = 0; rs < 2; ++rs) {
        const int row = rl + 8 * rs;
        if (quad == 0) part_ml[(slot + split) * BQ + row] = make_float2(c.m[rs], c.l[rs]);
        float* acc = part_acc + ((slot + split) * BQ + row) * HD + 2 * quad;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
            *reinterpret_cast<float2*>(acc + 8 * j) =
                make_float2(c.o[4 * j + 2 * rs], c.o[4 * j + 2 * rs + 1]);
    }
    __threadfence();
    named_sync(BAR_CONSUMERS, NWG * 128);
    int* flag = sRed + 2 * NT / 32;
    if (tid == 0) *flag = atomicAdd(&counters[tile_id], 1) == n_eff - 1;
    named_sync(BAR_CONSUMERS, NWG * 128);
    if (!*flag) return;
    __threadfence();

    // the last split to finish merges all of them, in split order
#pragma unroll
    for (int rs = 0; rs < 2; ++rs) {
        if (rows[rs] == nullptr) continue;
        const int row = rl + 8 * rs;
        float mx = NEG_INF;
        for (int s = 0; s < n_eff; ++s) mx = fmaxf(mx, __ldcg(&part_ml[(slot + s) * BQ + row]).x);
        float sum = 0.f;
        float acc[HD / 4];
#pragma unroll
        for (int i = 0; i < HD / 4; ++i) acc[i] = 0.f;
        for (int s = 0; s < n_eff; ++s) {
            const float2 ml = __ldcg(&part_ml[(slot + s) * BQ + row]);
            const float w = exp2f(ml.x - mx);
            sum += ml.y * w;
            const float* src = part_acc + ((slot + s) * BQ + row) * HD + 2 * quad;
#pragma unroll
            for (int j = 0; j < HD / 8; ++j) {
                const float2 a = __ldcg(reinterpret_cast<const float2*>(src + 8 * j));
                acc[2 * j] += w * a.x;
                acc[2 * j + 1] += w * a.y;
            }
        }
        const float inv = 1.f / fmaxf(sum, 1e-30f);
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(rows[rs] + 8 * j + 2 * quad) =
                __floats2bfloat162_rn(acc[2 * j] * inv, acc[2 * j + 1] * inv);
    }
    if (tid == 0) counters[tile_id] = 0;   // ready for the next call
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* kp, const void* vp, const int* tables,
                        const int* q_pos, void* out, void* part_ml, void* part_acc,
                        int* counters, int B, int C, int E, int bs, int H, int Hkv, int n_split,
                        float scale, int window, cudaStream_t stream) {
    constexpr size_t smem = PagedGeom<HD>::bytes;
    auto kern = paged_prefill_wgmma_kernel<HD>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid(H, (C + PagedGeom<HD>::BQ - 1) / PagedGeom<HD>::BQ * n_split, B);
    kern<<<grid, PagedGeom<HD>::NT, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kp),
        static_cast<const __nv_bfloat16*>(vp), tables, q_pos, static_cast<__nv_bfloat16*>(out),
        static_cast<float2*>(part_ml), static_cast<float*>(part_acc), counters, C, E, bs, H, Hkv,
        n_split, scale * LOG2E, window);
    return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: one block per (64-row q tile, q head, slot), FMA loops
// ---------------------------------------------------------------------------

constexpr int BQ32 = 64;    // query rows per block
constexpr int BK32 = 64;    // key rows per tile
constexpr int NT32 = 128;   // two threads per query row

// q, k and v tiles, rows padded by 16 bytes, then the probabilities, the
// query positions, the read flags and the key tile's block ids
template <int HD>
struct Layout32 {
    static constexpr int LDT = HD + 4;
    static constexpr int LDS = BK32 + 4;
    static constexpr size_t q = 0;
    static constexpr size_t v = q + sizeof(float) * BQ32 * LDT;
    static constexpr size_t k = v + sizeof(float) * BK32 * LDT;
    static constexpr size_t s = k + sizeof(float) * BK32 * LDT;
    static constexpr size_t qp = s + sizeof(float) * BQ32 * LDS;
    static constexpr size_t kb = qp + sizeof(int) * BQ32;
    static constexpr size_t blk = kb + sizeof(int) * BK32;
    static constexpr size_t bytes = blk + sizeof(int) * (BK32 + 1);
};

template <int HD>
__global__ void __launch_bounds__(NT32)
paged_prefill_f32_kernel(const float* __restrict__ q, const float* __restrict__ kp,
                         const float* __restrict__ vp, const int* __restrict__ tables,
                         const int* __restrict__ q_pos, float* __restrict__ out, int C, int E,
                         int bs, int H, int Hkv, float scale, int window) {
    using namespace paged;
    using L = Layout32<HD>;
    constexpr int LDT = L::LDT, LDS = L::LDS;
    constexpr int VPR = HD / 4;
    constexpr int HALF = HD / 2;     // output columns per thread
    constexpr int KH = BK32 / 2;     // score columns per thread
    extern __shared__ __align__(16) unsigned char smem[];
    float* sQ = reinterpret_cast<float*>(smem + L::q);
    float* sK = reinterpret_cast<float*>(smem + L::k);
    float* sV = reinterpret_cast<float*>(smem + L::v);
    float* sS = reinterpret_cast<float*>(smem + L::s);
    int* sQp = reinterpret_cast<int*>(smem + L::qp);
    int* sKb = reinterpret_cast<int*>(smem + L::kb);     // key rows read
    int* sBlk = reinterpret_cast<int*>(smem + L::blk);   // the key tile's block ids

    const int q0 = blockIdx.x * BQ32;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int kh = h / (H / Hkv);
    const int tid = threadIdx.x;
    const int row = tid >> 1;
    const int half = tid & 1;
    const bool row_ok = q0 + row < C;
    const int* tab = tables + (size_t)b * E;
    const size_t q_stride = (size_t)H * HD;

    if (tid < BQ32) sQp[tid] = (q0 + tid < C) ? q_pos[(size_t)b * C + q0 + tid] : -1;
    const float* qb = q + ((size_t)b * C + q0) * q_stride + (size_t)h * HD;
    for (int i = tid; i < BQ32 * VPR; i += NT32) {
        const int r = i / VPR;
        const int c = (i % VPR) * 4;
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (q0 + r < C) val = *reinterpret_cast<const float4*>(qb + (size_t)r * q_stride + c);
        *reinterpret_cast<float4*>(sQ + r * LDT + c) = val;
    }
    __syncthreads();
    const int qpos = sQp[row];
    // the tile's lowest and highest real query position
    int qmax = -1, qmin = 0x7fffffff;
    for (int r = 0; r < BQ32; ++r) {
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
    const int kt_end = (qmax < 0) ? 0 : min(qmax / BK32 + 1, (E * bs + BK32 - 1) / BK32);
    int kt_begin = 0;
    if (window > 0 && qmax >= 0 && qmin - window + 1 > 0) kt_begin = (qmin - window + 1) / BK32;

    for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int k0 = kt * BK32;
        __syncthreads();   // the previous tile's readers are done
        load_blocks(sBlk, tab, k0 / bs, (k0 + BK32 - 1) / bs, E, tid, NT32);
        __syncthreads();
        stage_kv<NT32, 4>(sK, LDT, sV, LDT, sKb, kp, vp, sBlk, k0 / bs, k0, BK32, bs, Hkv, kh,
                          HD, qmin, qmax, window, tid);
        __syncthreads();

        float sv[KH];
        uint32_t ok = 0u;
        float mt = NEG_INF;
#pragma unroll
        for (int jj = 0; jj < KH; ++jj) {
            const int j = 2 * jj + half;
            const bool valid = visible(sKb[j] != 0, k0 + j, qpos, window);
            float d = 0.f;
            if (valid) {
#pragma unroll 8
                for (int c = 0; c < HD; ++c) d += sQ[row * LDT + c] * sK[j * LDT + c];
            }
            sv[jj] = valid ? d * scale : NEG_INF;
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
            sS[row * LDS + j] = p;
        }
        ls += __shfl_xor_sync(0xffffffffu, ls, 1);
        l = l * alpha + ls;
        m = m_new;
#pragma unroll
        for (int c = 0; c < HALF; ++c) acc[c] *= alpha;
        __syncwarp();   // a row's probabilities are written by its own warp
        for (int j = 0; j < BK32; ++j) {
            const float p = sS[row * LDS + j];
#pragma unroll
            for (int c = 0; c < HALF; ++c) acc[c] += p * sV[j * LDT + 2 * c + half];
        }
    }

    if (row_ok) {
        const float inv = 1.f / fmaxf(l, 1e-30f);
        float* orow = out + ((size_t)b * C + q0 + row) * q_stride + (size_t)h * HD + half;
#pragma unroll
        for (int c = 0; c < HALF; ++c) orow[2 * c] = acc[c] * inv;
    }
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* kp, const void* vp, const int* tables,
                       const int* q_pos, void* out, int B, int C, int E, int bs, int H, int Hkv,
                       float scale, int window, cudaStream_t stream) {
    constexpr size_t smem = Layout32<HD>::bytes;
    auto kern = paged_prefill_f32_kernel<HD>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((C + BQ32 - 1) / BQ32, H, B);
    kern<<<grid, NT32, smem, stream>>>(static_cast<const float*>(q), static_cast<const float*>(kp),
                                       static_cast<const float*>(vp), tables, q_pos,
                                       static_cast<float*>(out), C, E, bs, H, Hkv, scale, window);
    return cudaGetLastError();
}

}  // namespace

// q: (B, C, H, hd); k_pool, v_pool: (N, bs, Hkv, hd); tables: (B, E)
// int32 (-1 = unbound); q_pos: (B, C) int32 (-1 = padded row); out like
// q.  dtype: 0 = float32, 1 = bfloat16.  hd in {32, 64, 80, 128}.
// bf16 splits the keys n_split ways; block_q must equal the kernel's query
// rows per block, and with n_split > 1 part_ml (B x H x q tiles x n_split
// x block_q float2), part_acc (the same x hd floats) and counters (B x H x
// q tiles int32, all 0, left 0) are the merge's scratch.  f32 takes
// n_split = 1.  Returns the CUDA error of the launch (0 = success).
extern "C" int paged_prefill_attention_fwd(const void* q, const void* kp, const void* vp,
                                           const void* tables, const void* q_pos, void* out,
                                           void* part_ml, void* part_acc, void* counters,
                                           int B, int C, int E, int bs, int H, int Hkv, int hd,
                                           int dtype, int n_split, int block_q, float scale,
                                           int window, void* stream) {
    if (Hkv <= 0 || H % Hkv != 0 || bs <= 0 || n_split < 1) return (int)cudaErrorInvalidValue;
    const int* tab = static_cast<const int*>(tables);
    const int* qp = static_cast<const int*>(q_pos);
    int* cnt = static_cast<int*>(counters);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 1) {
        if (block_q != attn::Block<2>::BQ) return (int)cudaErrorInvalidValue;
        switch (hd) {
            case 32: return launch_bf16<32>(q, kp, vp, tab, qp, out, part_ml, part_acc, cnt, B, C, E, bs, H, Hkv, n_split, scale, window, st);
            case 64: return launch_bf16<64>(q, kp, vp, tab, qp, out, part_ml, part_acc, cnt, B, C, E, bs, H, Hkv, n_split, scale, window, st);
            case 80: return launch_bf16<80>(q, kp, vp, tab, qp, out, part_ml, part_acc, cnt, B, C, E, bs, H, Hkv, n_split, scale, window, st);
            case 128: return launch_bf16<128>(q, kp, vp, tab, qp, out, part_ml, part_acc, cnt, B, C, E, bs, H, Hkv, n_split, scale, window, st);
            default: return (int)cudaErrorInvalidValue;
        }
    }
    if (dtype == 0 && n_split == 1) {
        switch (hd) {
            case 32: return launch_f32<32>(q, kp, vp, tab, qp, out, B, C, E, bs, H, Hkv, scale, window, st);
            case 64: return launch_f32<64>(q, kp, vp, tab, qp, out, B, C, E, bs, H, Hkv, scale, window, st);
            case 80: return launch_f32<80>(q, kp, vp, tab, qp, out, B, C, E, bs, H, Hkv, scale, window, st);
            case 128: return launch_f32<128>(q, kp, vp, tab, qp, out, B, C, E, bs, H, Hkv, scale, window, st);
            default: return (int)cudaErrorInvalidValue;
        }
    }
    return (int)cudaErrorInvalidValue;
}
