// Decode attention for Hopper (sm_90a): one query token per slot against
// a ring-buffer KV cache, as flash-decoding in one launch.
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention_pallas
// (the Pallas TPU kernel behind repro.kernels.ops.decode_attention).
// Plain version: src/repro_torch/kernels/ref.py::decode_attention.
//
// What bounds it on the H100: memory.  Each call reads the whole K and V
// cache once and does 4 FLOP per cache element and query head of the
// group, far below the card's ~295 FLOP/byte balance point; at B=8,
// W=768, Hkv=2, hd=128 in bf16 that is ~6.3 MB per layer, under 2 us at
// 3.35 TB/s.  At that size the call is bound by latency: one launch, one
// round trip to HBM, and the merge of the splits.
//
// What the design does about it:
//  * the TPU kernel runs one program per (slot, q head) and walks the
//    cache in sequence.  Here the grid is (split, kv head, slot): a block
//    reads its stretch of K and V once and applies it to all `group`
//    query heads of the kv head.  A split is a whole number of 16-key
//    tiles, planned by the wrapper from the shapes alone so that the grid
//    holds at least two blocks per SM where the tiles and the resident
//    grid allow (split s of n takes tiles [s nt / n, (s + 1) nt / n) of
//    the nt = ceil(W / 16)), so no split is empty.
//  * one launch per call: each split writes its partial state (m, l, acc)
//    in f32 to scratch; the splits of a (slot, kv head) then meet at a
//    barrier, a counter that the last to arrive resets, and each merges its
//    own 1/n_split of the group's output over all the records, in split
//    order (weights from every split's m and l, then nsub threads per
//    float4 so that all its loads are in flight, their parts added in a
//    fixed order).  No float atomics: two calls give the same bits.  A
//    launch with more than one split is cooperative, so that its grid is
//    resident all at once and the barrier cannot wait on a block that is
//    not scheduled; the wrapper's plan stays within that grid.  With one
//    split the block writes its output directly.  (A first design had the
//    last split to arrive merge every record alone: at head_dim 256 and 33
//    splits that one block read 33 x 16 KB and took most of the call.)
//  * bf16: the products run on the tensor cores, mma.sync m16n8k16 (bf16
//    in, f32 out), with the group's query heads as the 16 rows (rows >=
//    group are zero; wgmma's 64 rows would leave 3/4 or more idle).  Each
//    warp holds Q's A fragments in registers for the whole block.  Per
//    16-key tile it computes S = Q K^T from K fragments loaded by
//    ldmatrix, runs the online softmax on the accumulator fragments (quad
//    shuffles for the row max, the row sum kept per thread until the
//    end), rounds P to bf16 in registers (the accumulator layout of S is
//    the A layout of P) and adds P V from V fragments loaded by
//    ldmatrix.trans.  Four warps take disjoint tiles of each ring stage;
//    at head_dim 256 two warps share a tile, each owning half of the
//    output columns, so that O fits in registers.  The warps' states merge
//    in shared memory in a fixed order.
//  * K and V rows, and their positions, arrive by cp.async into a ring of
//    two stages of 64 keys (32 at head_dim 256): the next stage's copies
//    are in flight while the current one computes.  Rows past the split
//    are zero-filled (source size 0), never read, and masked by index.
//    Rows are padded by 16 bytes in shared memory so that ldmatrix's eight
//    rows fall in distinct banks.
//  * the mask is positional (0 <= pos <= t, and pos > t - window for a
//    window > 0), so ring wrap-around, empty slots (pos = -1) and a ragged
//    W need no special case and the wrapper pads nothing.  A masked key
//    gets probability 0, and a slot with no visible key writes 0 (the
//    max(l, 1e-30) clamp of the TPU kernel).
// f32 inputs (the CPU-parity dtype, not the serving one) take CUDA-core
// products over chunks of 32 keys, a warp per key, and the same merge.

#include <atomic>

#include "attention_fwd.cuh"   // smem_u32, cp_async_16, ex2, pack_bf16

namespace {

using attn::cp_async_16;
using attn::ex2;
using attn::pack_bf16;
using attn::smem_u32;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_GROUP = 16;   // query heads per kv head: the 16 rows of an mma tile
constexpr int TILE = 16;        // keys per tile: one k16 step of P.V
constexpr int NT = 128;         // threads per block
constexpr int NWARP = NT / 32;
constexpr int MAX_SPLIT = 512;  // splits of a (slot, kv head): bounds the merge's shared memory

// ---------------------------------------------------------------------------
// small device helpers
// ---------------------------------------------------------------------------

// 4 bytes global -> shared; with ok = false nothing is read and the
// destination is zero-filled
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool ok) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 ::"r"(dst), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group this thread committed, but the newest N, has landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// d += a b: a 16x16 (row), b 16x8 (col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

__device__ __forceinline__ void store4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
    uint2 u;
    u.x = pack_bf16(v.x, v.y);
    u.y = pack_bf16(v.z, v.w);
    *reinterpret_cast<uint2*>(p) = u;
}

// keys [lo, hi) of split `split` of n_split: whole tiles, sizes differing
// by at most one tile, the last one ending at W
__device__ __forceinline__ void split_keys(int W, int n_split, int split, int& lo, int& hi) {
    const long long nt = (W + TILE - 1) / TILE;
    lo = (int)(split * nt / n_split) * TILE;
    hi = min(W, (int)((split + 1) * nt / n_split) * TILE);
}

// floats of one split's record in the scratch: acc (group x hd), then m
// (group) and l (group), padded to a multiple of 4
__host__ __device__ inline int record_floats(int group, int hd) {
    return group * hd + (2 * group + 3) / 4 * 4;
}

// ---------------------------------------------------------------------------
// the end of a block, both dtypes.  Its state (sacc, group x HD f32; sm, sl
// per head, m in the log2 domain) is the output (one split), or one
// split's record: then the splits of the (slot, kv head) meet at
// split_barrier, and each merges its own share of the output's float4s
// over all the records, in split order.  `work` (16-byte aligned) may
// alias sacc and holds at least 2 (group + 3 n_split) + 20 + 4 NT floats
// (14.5 KB at MAX_SPLIT).
// ---------------------------------------------------------------------------

__device__ __forceinline__ int ld_acquire(const int* p) {
    int v;
    asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ int ld_relaxed(const int* p) {
    int v;
    asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
    asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// The barrier of the n splits of a (slot, kv head), by thread 0 of each,
// over two counters: [0] the splits arrived, [1] the generation, read at
// the block's start (`gen`).  The last split to arrive resets [0] and
// advances [1], which releases the others; the launch is cooperative, so
// they are all resident.  A wait of more than ~2^35 cycles (~15 s) is a
// fault, and traps rather than hanging the card.
__device__ __forceinline__ void split_barrier(int* counter, int gen, int n) {
    if (atomicAdd(counter, 1) == n - 1) {
        counter[0] = 0;
        st_release(counter + 1, (int)((unsigned)gen + 1u));
    } else {
        const long long t0 = clock64();
        while (ld_acquire(counter + 1) == gen)
            if (clock64() - t0 > (1ll << 35)) __trap();
    }
    __threadfence();
}

template <int HD, typename T>
__device__ __forceinline__ void finish_block(float* work, const float* sacc, const float* sm,
                                             const float* sl, T* __restrict__ out,
                                             float* __restrict__ part, int* __restrict__ counters,
                                             int b, int kh, int H, int Hkv, int group, int split,
                                             int n_split, int gen, int tid) {
    constexpr int C4 = HD / 4;                      // float4s of a row
    const int n4 = group * C4;
    const int lane = tid & 31, warp = tid >> 5;
    T* ob = out + ((size_t)b * H + (size_t)kh * group) * HD;
    if (n_split == 1) {
        for (int i = tid; i < n4; i += NT) {
            const float inv = 1.f / fmaxf(sl[i / C4], 1e-30f);
            const float4 a = reinterpret_cast<const float4*>(sacc)[i];
            store4(ob + 4 * i, make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv));
        }
        return;
    }

    const int rec = record_floats(group, HD);
    const int bh = b * Hkv + kh;
    const float* base = part + (size_t)bh * n_split * rec;
    float* mine = part + ((size_t)bh * n_split + split) * rec;
    for (int i = tid; i < n4; i += NT)
        reinterpret_cast<float4*>(mine)[i] = reinterpret_cast<const float4*>(sacc)[i];
    for (int r = tid; r < group; r += NT) {
        mine[group * HD + r] = sm[r];
        mine[group * HD + group + r] = sl[r];
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) split_barrier(counters + 2 * bh, gen, n_split);
    __syncthreads();

    // this split's share of the output: float4s [p0, p0 + P) of the group's
    // (group x HD) block, rows r0 .. r0 + R - 1.  nsub threads per float4,
    // each over every nsub-th split: the first KPRE of a thread's records
    // are loaded before the merge weights are known, so that both wait on
    // one round trip; the parts are added in a fixed order.
    const int p0 = (int)((long long)split * n4 / n_split);
    const int P = (int)((long long)(split + 1) * n4 / n_split) - p0;
    if (P > 0) {
        constexpr int KPRE = 12;
        const int r0 = p0 / C4;
        const int R = (p0 + P - 1) / C4 - r0 + 1;
        const int nsub = P >= NT ? 1 : NT / P;
        const int p = tid % P, sub = tid / P;
        const bool mine_p = tid < P * nsub;
        const float4* src = reinterpret_cast<const float4*>(base) + p0 + p;
        float4 pre[KPRE];
#pragma unroll
        for (int k = 0; k < KPRE; ++k) {
            const int s = sub + k * nsub;
            pre[k] = mine_p && s < n_split ? __ldcg(src + (size_t)s * (rec / 4))
                                           : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        float* cm = work;                      // R x n_split: m, then the merge weights
        float* cl = cm + R * n_split;          // R x n_split: l
        float* inv = cl + R * n_split;         // R: 1 / max(L, 1e-30)
        float4* red = reinterpret_cast<float4*>(work + ((2 * R * n_split + R + 3) & ~3));
        for (int i = tid; i < R * n_split; i += NT) {
            const int r = r0 + i / n_split;
            const float* rs = base + (size_t)(i % n_split) * rec + group * HD;
            cm[i] = __ldcg(rs + r);
            cl[i] = __ldcg(rs + group + r);
        }
        __syncthreads();
        // per row, a warp: M = max m, weights 2^(m - M), L = sum l weights
        for (int rr = warp; rr < R; rr += NWARP) {
            float M = NEG_INF;
            for (int s = lane; s < n_split; s += 32) M = fmaxf(M, cm[rr * n_split + s]);
            M = warp_max(M);
            float L = 0.f;
            for (int s = lane; s < n_split; s += 32) {
                const float c = exp2f(cm[rr * n_split + s] - M);
                cm[rr * n_split + s] = c;
                L += cl[rr * n_split + s] * c;
            }
            L = warp_sum(L);
            if (lane == 0) inv[rr] = 1.f / fmaxf(L, 1e-30f);
        }
        __syncthreads();
        for (int j = tid; j < P * nsub; j += NT) {
            const int pj = j % P, sj = j / P;
            const int rr = (p0 + pj) / C4 - r0;
            const float* c = cm + rr * n_split;
            float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
            int s = sj;
            if (j == tid) {          // the first float4 of this thread: its records are here
#pragma unroll
                for (int k = 0; k < KPRE; ++k, s += nsub) {
                    const float w = s < n_split ? c[s] : 0.f;
                    a = make_float4(a.x + w * pre[k].x, a.y + w * pre[k].y, a.z + w * pre[k].z,
                                    a.w + w * pre[k].w);
                }
            }
            const float4* sj_src = reinterpret_cast<const float4*>(base) + p0 + pj;
            for (; s < n_split; s += nsub) {
                const float4 v = __ldcg(sj_src + (size_t)s * (rec / 4));
                a = make_float4(a.x + c[s] * v.x, a.y + c[s] * v.y, a.z + c[s] * v.z,
                                a.w + c[s] * v.w);
            }
            if (nsub == 1) {
                const float w = inv[rr];
                store4(ob + 4 * (p0 + pj), make_float4(a.x * w, a.y * w, a.z * w, a.w * w));
            } else {
                red[sj * P + pj] = a;
            }
        }
        if (nsub > 1) {
            __syncthreads();
            for (int q = tid; q < P; q += NT) {
                float4 a = red[q];
                for (int sj = 1; sj < nsub; ++sj) {
                    const float4 v = red[sj * P + q];
                    a = make_float4(a.x + v.x, a.y + v.y, a.z + v.z, a.w + v.w);
                }
                const float w = inv[(p0 + q) / C4 - r0];
                store4(ob + 4 * (p0 + q), make_float4(a.x * w, a.y * w, a.z * w, a.w * w));
            }
        }
    }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core products fed by a cp.async ring
// ---------------------------------------------------------------------------

template <int HD>
struct Geom {
    static constexpr int NWD = HD > 128 ? 2 : 1;   // warps sharing a tile, each HD / NWD columns
    static constexpr int NWK = NWARP / NWD;        // tiles of a ring stage
    static constexpr int STEP = TILE * NWK;        // keys of a ring stage
    static constexpr int STAGES = 2;
    static constexpr int LD = HD + 8;              // row stride in elements (16-byte pad)
    static constexpr int KV_BYTES = STEP * LD * 2; // K (or V) rows of a stage
    static constexpr int STAGE_BYTES = 2 * KV_BYTES + STEP * 4;   // K, V, positions
    static constexpr int RING = STAGES * STAGE_BYTES;
    static constexpr size_t bytes = RING + 2 * MAX_GROUP * 4;   // + sm, sl
    // after the loop the ring holds the warps' states, then the merge's work
    static_assert(NWK * MAX_GROUP * (HD + 2) * 4 <= RING, "warp states fit in the ring");
    static_assert(STAGE_BYTES % 16 == 0, "stages are 16-byte aligned");
};

template <int HD>
__global__ void __launch_bounds__(NT, 2)
ring_decode_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
                       const __nv_bfloat16* __restrict__ vc, const int* __restrict__ pos,
                       const int* __restrict__ t, __nv_bfloat16* __restrict__ out,
                       float* __restrict__ part, int* __restrict__ counters, int W, int H, int Hkv,
                       int n_split, float scale_log2, int window) {
    using G = Geom<HD>;
    constexpr int KS = HD / 16;               // k16 steps of Q K^T
    constexpr int NJ = HD / G::NWD / 8;       // 8-column n-tiles of this warp's share of O
    constexpr int CPR = HD / 8;               // 16-byte chunks of a row
    extern __shared__ __align__(16) unsigned char smem[];
    const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
    const int group = H / Hkv;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int kg = warp / G::NWD;             // this warp's tile of each stage
    const int cd = warp % G::NWD;             // this warp's share of the output columns
    const int quad = lane & 3, row = lane >> 2;
    int k_lo, k_hi;
    split_keys(W, n_split, split, k_lo, k_hi);
    const int tb = t[b];
    const size_t row_stride = (size_t)Hkv * HD;
    const __nv_bfloat16* kb = kc + (size_t)b * W * row_stride + (size_t)kh * HD;
    const __nv_bfloat16* vb = vc + (size_t)b * W * row_stride + (size_t)kh * HD;
    const int* pb = pos + (size_t)b * W;
    const uint32_t ring = smem_u32(smem);

    // one ring stage: the K and V rows and positions of keys [k0, k0 + STEP)
    // of this split; rows past the split are zero-filled, never read
    auto issue = [&](int step) {
        const int k0 = k_lo + step * G::STEP;
        if (k0 < k_hi) {
            const uint32_t sk = ring + (step % G::STAGES) * G::STAGE_BYTES;
            const uint32_t sv = sk + G::KV_BYTES;
            const uint32_t sp = sv + G::KV_BYTES;
            for (int i = tid; i < G::STEP * CPR; i += NT) {
                const int r = i / CPR, c = (i % CPR) * 8;
                const bool ok = k0 + r < k_hi;
                const size_t off = ok ? (size_t)(k0 + r) * row_stride + c : 0;
                cp_async_16(sk + (r * G::LD + c) * 2, kb + off, ok);
                cp_async_16(sv + (r * G::LD + c) * 2, vb + off, ok);
            }
            for (int r = tid; r < G::STEP; r += NT)
                cp_async_4(sp + 4 * r, pb + (k0 + r < k_hi ? k0 + r : 0), k0 + r < k_hi);
        }
        cp_async_commit();
    };
    issue(0);
    // the barrier's generation for this call, read while the copies fly
    const int gen = tid == 0 && n_split > 1 ? ld_relaxed(counters + 2 * (b * Hkv + kh) + 1) : 0;

    // Q's A fragments, rows >= group zero: register e holds row `row` + 8 (e
    // & 1), columns 16 ks + 2 quad + 8 (e >> 1) + {0, 1}
    uint32_t qa[KS][4];
    const __nv_bfloat16* qb = q + ((size_t)b * H + (size_t)kh * group) * HD;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int r = row + 8 * (e & 1);
            const int c = 16 * ks + 2 * quad + 8 * (e >> 1);
            qa[ks][e] = r < group ? *reinterpret_cast<const uint32_t*>(qb + (size_t)r * HD + c)
                                  : 0u;
        }

    // O (rows row, row + 8; this warp's columns), m in the log2 domain, and
    // this thread's share of l
    float o[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

    // ldmatrix row addresses: x4 of K gives the B fragments of key n-tiles 0
    // and 1 for one k16 step; x4.trans of V those of two 8-column n-tiles
    const int k_row = (lane & 7) + ((lane >> 4) << 3);
    const int k_col = ((lane >> 3) & 1) * 8;
    const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3);
    const int v_col = (lane >> 4) * 8 + cd * (HD / G::NWD);

    const int n_steps = (k_hi - k_lo + G::STEP - 1) / G::STEP;
    for (int i = 0; i < n_steps; ++i) {
        issue(i + 1);            // its stage was freed by the barrier closing step i - 1
        cp_async_wait<1>();
        __syncthreads();
        const int k0 = k_lo + i * G::STEP + kg * TILE;   // this warp's tile
        if (k0 < k_hi) {
            const uint32_t stage = ring + (i % G::STAGES) * G::STAGE_BYTES;
            const uint32_t sk = stage + kg * TILE * G::LD * 2;
            const uint32_t sv = stage + G::KV_BYTES + kg * TILE * G::LD * 2;
            const int* sp = reinterpret_cast<const int*>(smem + (i % G::STAGES) * G::STAGE_BYTES
                                                         + 2 * G::KV_BYTES) + kg * TILE;
            // S = Q K^T: s[j] holds rows (row, row + 8) x keys 8 j + 2 quad + {0, 1}
            float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
            const uint32_t ka = sk + (k_row * G::LD + k_col) * 2;
#pragma unroll
            for (int ks = 0; ks < KS; ++ks) {
                uint32_t kf[4];
                ldsm_x4(ka + ks * 32, kf);
                mma_bf16(s[0], qa[ks], kf[0], kf[1]);
                mma_bf16(s[1], qa[ks], kf[2], kf[3]);
            }
            // mask, then the online softmax of rows row and row + 8
            bool ok[2][2];
            float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int kk = 8 * j + 2 * quad + e;
                    const int p = sp[kk];
                    bool v = k0 + kk < k_hi && p >= 0 && p <= tb;
                    if (window > 0) v = v && p > tb - window;
                    ok[j][e] = v;
                    s[j][e] = v ? s[j][e] * scale_log2 : NEG_INF;
                    s[j][e + 2] = v ? s[j][e + 2] * scale_log2 : NEG_INF;
                    mx[0] = fmaxf(mx[0], s[j][e]);
                    mx[1] = fmaxf(mx[1], s[j][e + 2]);
                }
            float alpha[2];
#pragma unroll
            for (int rs = 0; rs < 2; ++rs) {
                mx[rs] = fmaxf(mx[rs], __shfl_xor_sync(0xffffffffu, mx[rs], 1));
                mx[rs] = fmaxf(mx[rs], __shfl_xor_sync(0xffffffffu, mx[rs], 2));
                const float mn = fmaxf(m[rs], mx[rs]);
                alpha[rs] = ex2(m[rs] - mn);
                m[rs] = mn;
            }
            // P, rounded to bf16: the accumulator layout of S is the A
            // layout of P (register 2 j + rs: row row + 8 rs, keys of n-tile j)
            uint32_t pa[4];
            float ps[2] = {0.f, 0.f};
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int rs = 0; rs < 2; ++rs) {
                    const float p0 = ok[j][0] ? ex2(s[j][2 * rs] - m[rs]) : 0.f;
                    const float p1 = ok[j][1] ? ex2(s[j][2 * rs + 1] - m[rs]) : 0.f;
                    ps[rs] += p0 + p1;
                    pa[2 * j + rs] = pack_bf16(p0, p1);
                }
#pragma unroll
            for (int rs = 0; rs < 2; ++rs) l[rs] = l[rs] * alpha[rs] + ps[rs];
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                o[j][0] *= alpha[0];
                o[j][1] *= alpha[0];
                o[j][2] *= alpha[1];
                o[j][3] *= alpha[1];
            }
            // O += P V over this warp's columns
            const uint32_t va = sv + (v_row * G::LD + v_col) * 2;
#pragma unroll
            for (int jp = 0; jp < NJ / 2; ++jp) {
                uint32_t vf[4];
                ldsm_x4_trans(va + jp * 32, vf);
                mma_bf16(o[2 * jp], pa, vf[0], vf[1]);
                mma_bf16(o[2 * jp + 1], pa, vf[2], vf[3]);
            }
        }
        __syncthreads();         // the stage may be refilled
    }

    // the warps' states into the ring, then merged in warp order into sO[0]
#pragma unroll
    for (int rs = 0; rs < 2; ++rs) {
        l[rs] += __shfl_xor_sync(0xffffffffu, l[rs], 1);
        l[rs] += __shfl_xor_sync(0xffffffffu, l[rs], 2);
    }
    float* sO = reinterpret_cast<float*>(smem);              // [NWK][16][HD]
    float* sWM = sO + G::NWK * MAX_GROUP * HD;                // [NWK][16]
    float* sWL = sWM + G::NWK * MAX_GROUP;                    // [NWK][16]
    float* ow = sO + kg * MAX_GROUP * HD + cd * (HD / G::NWD) + 2 * quad;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
        *reinterpret_cast<float2*>(ow + row * HD + 8 * j) = make_float2(o[j][0], o[j][1]);
        *reinterpret_cast<float2*>(ow + (row + 8) * HD + 8 * j) = make_float2(o[j][2], o[j][3]);
    }
    if (cd == 0 && quad == 0) {
        sWM[kg * MAX_GROUP + row] = m[0];
        sWM[kg * MAX_GROUP + row + 8] = m[1];
        sWL[kg * MAX_GROUP + row] = l[0];
        sWL[kg * MAX_GROUP + row + 8] = l[1];
    }
    __syncthreads();
    float* sm = reinterpret_cast<float*>(smem + G::RING);
    float* sl = sm + MAX_GROUP;
    for (int r = tid; r < group; r += NT) {
        float M = NEG_INF, L = 0.f;
#pragma unroll
        for (int w = 0; w < G::NWK; ++w) M = fmaxf(M, sWM[w * MAX_GROUP + r]);
#pragma unroll
        for (int w = 0; w < G::NWK; ++w)
            L += sWL[w * MAX_GROUP + r] * exp2f(sWM[w * MAX_GROUP + r] - M);
        sm[r] = M;
        sl[r] = L;
    }
    for (int i = tid; i < group * HD / 4; i += NT) {
        const int r = 4 * i / HD;
        float M = NEG_INF;
#pragma unroll
        for (int w = 0; w < G::NWK; ++w) M = fmaxf(M, sWM[w * MAX_GROUP + r]);
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int w = 0; w < G::NWK; ++w) {
            const float c = exp2f(sWM[w * MAX_GROUP + r] - M);
            const float4 v = reinterpret_cast<const float4*>(sO + w * MAX_GROUP * HD)[i];
            a = make_float4(a.x + c * v.x, a.y + c * v.y, a.z + c * v.z, a.w + c * v.w);
        }
        reinterpret_cast<float4*>(sO)[i] = a;
    }
    __syncthreads();
    finish_block<HD>(sO, sO, sm, sl, out, part, counters, b, kh, H, Hkv, group, split, n_split,
                     gen, tid);
}

// ---------------------------------------------------------------------------
// f32: CUDA-core products over chunks of keys, the same split and merge
// ---------------------------------------------------------------------------

constexpr int CH32 = 32;   // keys per chunk

template <int HD>
struct Geom32 {
    static constexpr int KV = CH32 * HD * 4;                    // K (or V) of a chunk
    static constexpr int Q = MAX_GROUP * HD * 4;                // q, then the block's acc
    static constexpr int S = MAX_GROUP * CH32 * 4;              // scores, then probabilities
    static constexpr size_t bytes = 2 * KV + Q + S + CH32 * 4 + 3 * MAX_GROUP * 4;
};

template <int HD>
__global__ void __launch_bounds__(NT)
ring_decode_f32_kernel(const float* __restrict__ q, const float* __restrict__ kc,
                       const float* __restrict__ vc, const int* __restrict__ pos,
                       const int* __restrict__ t, float* __restrict__ out,
                       float* __restrict__ part, int* __restrict__ counters, int W, int H, int Hkv,
                       int n_split, float scale_log2, int window) {
    using G = Geom32<HD>;
    constexpr int E = HD / 32;                 // elements of a key row per lane
    constexpr int UC = (HD + NT - 1) / NT;     // output columns per thread
    extern __shared__ __align__(16) unsigned char smem[];
    const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
    const int group = H / Hkv;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    int k_lo, k_hi;
    split_keys(W, n_split, split, k_lo, k_hi);
    const int tb = t[b];
    float* sk = reinterpret_cast<float*>(smem);              // CH32 x HD
    float* sv = sk + CH32 * HD;                               // CH32 x HD
    float* sq = sv + CH32 * HD;                               // group x HD
    float* ss = sq + MAX_GROUP * HD;                          // group x CH32
    int* sp = reinterpret_cast<int*>(ss + MAX_GROUP * CH32);  // CH32
    float* sm = reinterpret_cast<float*>(sp + CH32);
    float* sl = sm + MAX_GROUP;
    float* salpha = sl + MAX_GROUP;

    const size_t row_stride = (size_t)Hkv * HD;
    const float* kb = kc + (size_t)b * W * row_stride + (size_t)kh * HD;
    const float* vb = vc + (size_t)b * W * row_stride + (size_t)kh * HD;
    const float* qb = q + ((size_t)b * H + (size_t)kh * group) * HD;
    const int gen = tid == 0 && n_split > 1 ? ld_relaxed(counters + 2 * (b * Hkv + kh) + 1) : 0;
    for (int i = tid; i < group * HD; i += NT) sq[i] = qb[i];
    for (int g = tid; g < group; g += NT) {
        sm[g] = NEG_INF;
        sl[g] = 0.f;
    }
    float acc[MAX_GROUP][UC];
#pragma unroll
    for (int g = 0; g < MAX_GROUP; ++g)
#pragma unroll
        for (int u = 0; u < UC; ++u) acc[g][u] = 0.f;

    for (int k0 = k_lo; k0 < k_hi; k0 += CH32) {
        const int n = min(CH32, k_hi - k0);
        __syncthreads();   // the previous chunk is consumed
        for (int i = tid; i < n * HD / 4; i += NT) {
            const int r = i / (HD / 4), c = (i % (HD / 4)) * 4;
            const size_t off = (size_t)(k0 + r) * row_stride + c;
            store4(sk + r * HD + c, *reinterpret_cast<const float4*>(kb + off));
            store4(sv + r * HD + c, *reinterpret_cast<const float4*>(vb + off));
        }
        for (int r = tid; r < n; r += NT) sp[r] = pos[(size_t)b * W + k0 + r];
        __syncthreads();
        // scores: a warp per key, all heads of the group
        for (int w = warp; w < n; w += NWARP) {
            float kv[E];
#pragma unroll
            for (int e = 0; e < E; ++e) kv[e] = sk[w * HD + e * 32 + lane];
            const int p = sp[w];
            bool valid = p >= 0 && p <= tb;
            if (window > 0) valid = valid && p > tb - window;
            for (int g = 0; g < group; ++g) {
                float d = 0.f;
#pragma unroll
                for (int e = 0; e < E; ++e) d += sq[g * HD + e * 32 + lane] * kv[e];
                d = warp_sum(d);
                if (lane == 0) ss[g * CH32 + w] = valid ? d * scale_log2 : NEG_INF;
            }
        }
        __syncthreads();
        // per head: the chunk's max, the rescale of the running state, P
        for (int g = warp; g < group; g += NWARP) {
            const float s = lane < n ? ss[g * CH32 + lane] : NEG_INF;
            const float mo = sm[g];
            const float mn = fmaxf(mo, warp_max(s));
            const float p = s == NEG_INF ? 0.f : exp2f(s - mn);
            if (lane < n) ss[g * CH32 + lane] = p;
            const float sum = warp_sum(p);
            if (lane == 0) {
                const float a = exp2f(mo - mn);
                salpha[g] = a;
                sl[g] = sl[g] * a + sum;
                sm[g] = mn;
            }
        }
        __syncthreads();
#pragma unroll
        for (int u = 0; u < UC; ++u) {
            const int c = tid + NT * u;
            if (c >= HD) continue;
#pragma unroll
            for (int g = 0; g < MAX_GROUP; ++g)
                if (g < group) acc[g][u] *= salpha[g];
            for (int w = 0; w < n; ++w) {
                const float vv = sv[w * HD + c];
#pragma unroll
                for (int g = 0; g < MAX_GROUP; ++g)
                    if (g < group) acc[g][u] += ss[g * CH32 + w] * vv;
            }
        }
    }
    // the block's state: acc over q's shared memory (q is no longer read)
#pragma unroll
    for (int u = 0; u < UC; ++u) {
        const int c = tid + NT * u;
        if (c >= HD) continue;
#pragma unroll
        for (int g = 0; g < MAX_GROUP; ++g)
            if (g < group) sq[g * HD + c] = acc[g][u];
    }
    __syncthreads();
    finish_block<HD>(sk, sq, sm, sl, out, part, counters, b, kh, H, Hkv, group, split, n_split,
                     gen, tid);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// One instantiation's kernel and shared memory; its opt-in to that much
// shared memory is made once per device.
template <typename T, int HD>
struct Kernel {
    static constexpr bool BF16 = sizeof(T) == 2;
    static constexpr size_t smem = BF16 ? Geom<HD>::bytes : Geom32<HD>::bytes;
    static const void* fn() {
        if constexpr (BF16) return (const void*)ring_decode_mma_kernel<HD>;
        else return (const void*)ring_decode_f32_kernel<HD>;
    }
    static cudaError_t prepare() {
        static std::atomic<unsigned long long> done{0};
        int dev = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err != cudaSuccess) return err;
        const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
        if (bit && (done.load(std::memory_order_relaxed) & bit)) return cudaSuccess;
        err = cudaFuncSetAttribute(fn(), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
        return err;
    }
};

// blocks of this instantiation that can be resident at once on the
// current device: the most a split launch may take
template <typename T, int HD>
cudaError_t capacity(int* blocks) {
    using K = Kernel<T, HD>;
    cudaError_t err = K::prepare();
    if (err != cudaSuccess) return err;
    int dev = 0, n_sm = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
        return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, K::fn(), NT, K::smem);
    if (err != cudaSuccess) return err;
    *blocks = per_sm * n_sm;
    return cudaSuccess;
}

// One split: a plain launch.  More: a cooperative launch, which refuses a
// grid that cannot be resident all at once, so the splits of a (slot, kv
// head) can wait for each other.
template <typename T, int HD>
cudaError_t launch(const void* q, const void* kc, const void* vc, const int* pos, const int* t,
                   void* out, float* part, int* counters, int B, int W, int H, int Hkv,
                   int n_split, float scale, int window, cudaStream_t stream) {
    using K = Kernel<T, HD>;
    cudaError_t err = K::prepare();
    if (err != cudaSuccess) return err;
    const T* q_ = static_cast<const T*>(q);
    const T* kc_ = static_cast<const T*>(kc);
    const T* vc_ = static_cast<const T*>(vc);
    T* out_ = static_cast<T*>(out);
    const float scale_log2 = scale * LOG2E;
    void* args[] = {(void*)&q_,     (void*)&kc_,      (void*)&vc_,     (void*)&pos,
                    (void*)&t,      (void*)&out_,     (void*)&part,    (void*)&counters,
                    (void*)&W,      (void*)&H,        (void*)&Hkv,     (void*)&n_split,
                    (void*)&scale_log2, (void*)&window};
    const dim3 grid(n_split, Hkv, B);
    err = n_split == 1 ? cudaLaunchKernel(K::fn(), grid, dim3(NT), args, K::smem, stream)
                       : cudaLaunchCooperativeKernel(K::fn(), grid, dim3(NT), args, K::smem,
                                                     stream);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

}  // namespace

// The most blocks a call with n_split > 1 may launch on the current
// device: dtype 0 = float32, 1 = bfloat16; hd 64, 128 or 256.  Returns the
// CUDA error (0 = success).
extern "C" int decode_attention_capacity(int hd, int dtype, int* blocks) {
    if (dtype == 1 && hd == 64) return (int)capacity<__nv_bfloat16, 64>(blocks);
    if (dtype == 1 && hd == 128) return (int)capacity<__nv_bfloat16, 128>(blocks);
    if (dtype == 1 && hd == 256) return (int)capacity<__nv_bfloat16, 256>(blocks);
    if (dtype == 0 && hd == 64) return (int)capacity<float, 64>(blocks);
    if (dtype == 0 && hd == 128) return (int)capacity<float, 128>(blocks);
    if (dtype == 0 && hd == 256) return (int)capacity<float, 256>(blocks);
    return (int)cudaErrorInvalidValue;
}

// q: (B, H, hd); k_cache, v_cache: (B, W, Hkv, hd); cache_pos: (B, W)
// int32; t: (B,) int32; out like q.  part: B * Hkv * n_split records of
// record_floats(group, hd) f32, 16-byte aligned, and counters: 2 * B *
// Hkv int32 (split_barrier's; each pair's first 0, as the kernel leaves
// it); both unused, and may be null, when n_split is 1.  dtype: 0 =
// float32, 1 = bfloat16; hd 64, 128 or 256; group = H / Hkv <= 16; 1 <=
// n_split <= min(ceil(W / 16), MAX_SPLIT), and with n_split > 1 at most
// decode_attention_capacity blocks.  Returns the CUDA error (0 =
// success).
extern "C" int decode_attention_fwd(const void* q, const void* kc, const void* vc,
                                    const void* cache_pos, const void* t, void* part,
                                    void* counters, void* out, int B, int W, int H, int Hkv,
                                    int hd, int dtype, int n_split, float scale, int window,
                                    void* stream) {
    const int* pos = static_cast<const int*>(cache_pos);
    const int* tt = static_cast<const int*>(t);
    float* pt = static_cast<float*>(part);
    int* cnt = static_cast<int*>(counters);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > MAX_GROUP || W <= 0 || n_split < 1
        || n_split > (W + TILE - 1) / TILE || n_split > MAX_SPLIT
        || (n_split > 1 && (pt == nullptr || cnt == nullptr
                            || reinterpret_cast<uintptr_t>(pt) % 16)))
        return (int)cudaErrorInvalidValue;
#define DECODE_CASE(CODE, T, HD)                                                              \
    if (dtype == CODE && hd == HD)                                                             \
        return (int)launch<T, HD>(q, kc, vc, pos, tt, out, pt, cnt, B, W, H, Hkv, n_split,    \
                                  scale, window, st);
    DECODE_CASE(1, __nv_bfloat16, 64)
    DECODE_CASE(1, __nv_bfloat16, 128)
    DECODE_CASE(1, __nv_bfloat16, 256)
    DECODE_CASE(0, float, 64)
    DECODE_CASE(0, float, 128)
    DECODE_CASE(0, float, 256)
#undef DECODE_CASE
    return (int)cudaErrorInvalidValue;
}
