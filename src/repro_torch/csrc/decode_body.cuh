// The decode attention body for Hopper (sm_90a), shared by ring decode
// attention (decode_attention.cu) and the two paged decode kernels
// (paged_decode_attention.cu, fused_decode_tail.cu): one query token per
// slot, the group of query heads of one kv head at a time, over one split
// of the slot's keys, then the split barrier and the merge.
//
// Work item: (slot, kv head, split).  A split is a whole number of 16-key
// tiles of the keys [0, n_keys) (split_keys); its block reads those keys
// once and applies them to all `group` query heads.  What differs between
// the kernels is only where a key's K and V rows and its position come
// from, a "row source":
//  * RingSrc: row k of the slot's ring cache, its position from cache_pos;
//  * PagedSrc: key k is absolute position k, in pool block sblk[k / bs -
//    w0] at offset k % bs, where sblk holds NBLK block ids of the slot's
//    table from entry w0 in shared memory (loaded before the first stage
//    and again only when a stage runs past them), an unbound entry (-1)
//    giving position -1.
// A row that is past the split, unbound or (paged) outside the visible
// range is zero-filled, never dereferenced, and masked by its position.
//
// bf16 (mma_state): the products run on the tensor cores, mma.sync
// m16n8k16 (bf16 in, f32 out), with the group's query heads as the 16 rows
// (rows >= group are zero).  Each warp holds Q's A fragments in registers.
// Per 16-key tile it computes S = Q K^T from K fragments loaded by
// ldmatrix, runs the online softmax on the accumulator fragments, rounds P
// to bf16 in registers (the accumulator layout of S is the A layout of P)
// and adds P V from V fragments loaded by ldmatrix.trans.  Four warps take
// disjoint tiles of each ring stage (at head_dim 256 two warps share a
// tile, each owning half the output columns).  K and V rows, and their
// positions, arrive by cp.async into a ring of two stages of 64 keys (32
// at head_dim 256): the next stage's copies are in flight while the
// current one computes.  Rows are padded by 16 bytes in shared memory so
// that ldmatrix's eight rows fall in distinct banks; a head_dim below the
// instantiated width HD is zero-padded in shared memory only.
// f32 (f32_state, the CPU-parity dtype): CUDA-core products over chunks of
// 32 keys, a warp per key.
//
// The end (finish_block): with one split the block writes its output.
// Otherwise each split writes its f32 record (acc, m, l), the splits of a
// (slot, kv head) meet at a barrier (count_barrier: a 64-bit count that
// only launches of n_split splits advance), and each merges its own
// 1/n_split of the group's output over all the records, in split order.
// No float atomics: two calls give the same bits.  A launch with more than
// one split is cooperative, so that the splits that wait for each other
// are resident at once.  A slot with no visible key writes 0 (the
// max(l, 1e-30) clamp of the TPU kernels).
#pragma once

#include <limits.h>

#include <atomic>

#include "attention_fwd.cuh"   // smem_u32, cp_async_16, ex2, pack_bf16
#include "common.cuh"          // load_blocks, warp_sum, warp_max

namespace dec {

using attn::cp_async_16;
using attn::ex2;
using attn::pack_bf16;
using attn::smem_u32;
using paged::warp_max;
using paged::warp_sum;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_GROUP = 16;   // query heads per kv head: the 16 rows of an mma tile
constexpr int TILE = 16;        // keys per tile: one k16 step of P.V
constexpr int NT = 128;         // threads per block
constexpr int NWARP = NT / 32;
constexpr int MAX_SPLIT = 512;  // splits of a (slot, kv head): bounds the merge's shared memory
constexpr int NBLK = 128;       // block ids a paged source holds: more than a stage spans

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

__device__ __forceinline__ void st_shared(uint32_t dst, int v) {
    asm volatile("st.shared.s32 [%0], %1;\n" ::"r"(dst), "r"(v) : "memory");
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

__device__ __forceinline__ void store4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
    uint2 u;
    u.x = pack_bf16(v.x, v.y);
    u.y = pack_bf16(v.z, v.w);
    *reinterpret_cast<uint2*>(p) = u;
}

// keys [lo, hi) of split `split` of n_split over n keys: whole tiles, sizes
// differing by at most one tile, the last one ending at n
__device__ __forceinline__ void split_keys(int n, int n_split, int split, int& lo, int& hi) {
    const long long nt = (n + TILE - 1) / TILE;
    lo = (int)(split * nt / n_split) * TILE;
    hi = min(n, (int)((split + 1) * nt / n_split) * TILE);
}

// floats of one split's record in the scratch: acc (group x hd), then m
// (group) and l (group), padded to a multiple of 4
__host__ __device__ inline int record_floats(int group, int hd) {
    return group * hd + (2 * group + 3) / 4 * 4;
}

// The barrier of the n blocks that take part in it, over a 64-bit count
// that only launches of n such blocks advance, each by n.  At a block's
// start the count holds k n plus the arrivals of this launch so far, fewer
// than n, so count_base (read then, before the block arrives) rounds it
// down to k n.  A block arrives by a release-add that waits for nothing
// (after a block barrier, so it publishes every thread's writes) and waits
// by acquire-loads until all n have arrived; the count is never reset, so
// no block waits for another to reset it.  A wait of more than ~2^35
// cycles (~15 s) is a fault, and traps rather than hanging the card.
__device__ __forceinline__ unsigned long long count_base(const unsigned long long* count,
                                                         int n) {
    unsigned long long v;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(count) : "memory");
    return v - v % (unsigned long long)n;
}

// by thread 0 of each block, between two block barriers
__device__ __forceinline__ void count_barrier(unsigned long long* count, unsigned long long base,
                                              int n) {
    asm volatile("red.release.gpu.global.add.u64 [%0], 1;\n" ::"l"(count) : "memory");
    const long long t0 = clock64();
    unsigned long long v;
    do {
        asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(count) : "memory");
        if (clock64() - t0 > (1ll << 35)) __trap();
    } while (v - base < (unsigned long long)n);
}

// ---------------------------------------------------------------------------
// row sources
// ---------------------------------------------------------------------------

// Row k of one slot's ring cache (kv head kh), its position from cache_pos.
template <typename T>
struct RingSrc {
    const T* k;              // the slot's K rows at kv head kh
    const T* v;
    const int* pos;          // the slot's cache_pos row
    size_t stride;           // elements between rows: Hkv * hd

    __device__ __forceinline__ void stage(int, int, int) {}
    __device__ __forceinline__ bool row(int key, size_t& off) const {
        off = (size_t)key * stride;
        return true;
    }
    __device__ __forceinline__ void pos_async(uint32_t dst, int key, bool ok) const {
        cp_async_4(dst, pos + (ok ? key : 0), ok);
    }
    __device__ __forceinline__ int pos_of(int key) const { return pos[key]; }
};

// Key k of one slot is absolute position k, in pool block tab[k / bs] at
// offset k % bs; sblk (NBLK ints of shared memory) holds the block ids of
// entries [w0, w0 + NBLK).
template <typename T>
struct PagedSrc {
    const T* k;              // the pool's K at kv head kh
    const T* v;
    const int* tab;          // the slot's table row, E entries
    int E, bs;
    size_t stride;           // elements between pool rows: Hkv * hd
    int* sblk;
    int w0;                  // first entry in sblk; INT_MIN / 2 before the first stage

    // before a stage of keys [k0, k1) is issued, by every thread: the block
    // ids it needs are in sblk.  Every thread has finished reading sblk for
    // the previous stage (a block barrier lies between), so it is reloaded
    // without waiting.
    __device__ __forceinline__ void stage(int k0, int k1, int tid) {
        const int e0 = k0 / bs, e1 = (k1 - 1) / bs;
        if (e0 < w0 || e1 >= w0 + NBLK) {
            w0 = e0;
            paged::load_blocks(sblk, tab, w0, min(w0 + NBLK, E) - 1, E, tid, NT);
            __syncthreads();
        }
    }
    __device__ __forceinline__ bool row(int key, size_t& off) const {
        const int blk = sblk[key / bs - w0];
        off = ((size_t)blk * bs + key % bs) * stride;
        return blk >= 0;
    }
    __device__ __forceinline__ void pos_async(uint32_t dst, int key, bool ok) const {
        size_t off;
        st_shared(dst, ok && row(key, off) ? key : -1);
    }
    __device__ __forceinline__ int pos_of(int key) const {
        size_t off;
        return row(key, off) ? key : -1;
    }
};

// ---------------------------------------------------------------------------
// the end of a block, both dtypes.  Its state (sacc, group x HD f32; sm, sl
// per head, m in the log2 domain) is the output (one split), or one
// split's record: then the splits of the (slot, kv head) meet at
// count_barrier (counts[b Hkv + kh], base read at the block's start), and
// each merges its own share of the output's float4s
// over all the records, in split order.  The output holds group rows of
// hd <= HD columns; columns past hd are not written.  `work` (16-byte
// aligned) may alias sacc and holds at least 2 (group + 3 n_split) + 20 +
// 4 NT floats (14.5 KB at MAX_SPLIT).
// ---------------------------------------------------------------------------

template <int HD, typename T>
__device__ __forceinline__ void finish_block(float* work, const float* sacc, const float* sm,
                                             const float* sl, T* __restrict__ out,
                                             float* __restrict__ part,
                                             unsigned long long* __restrict__ counts, int b,
                                             int kh, int H, int Hkv, int group, int split,
                                             int n_split, unsigned long long base, int hd,
                                             int tid) {
    constexpr int C4 = HD / 4;                      // float4s of a row
    const int n4 = group * C4;
    const int lane = tid & 31, warp = tid >> 5;
    T* ob = out + ((size_t)b * H + (size_t)kh * group) * hd;
    // float4 i of the group's (group x HD) block is row i / C4, columns 4 (i
    // % C4) + 0..3; it is written iff those lie below hd (hd % 8 == 0)
    auto dst = [&](int i) { return ob + (size_t)(i / C4) * hd + 4 * (i % C4); };
    auto kept = [&](int i) { return 4 * (i % C4) < hd; };
    if (n_split == 1) {
        for (int i = tid; i < n4; i += NT) {
            if (!kept(i)) continue;
            const float inv = 1.f / fmaxf(sl[i / C4], 1e-30f);
            const float4 a = reinterpret_cast<const float4*>(sacc)[i];
            store4(dst(i), make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv));
        }
        return;
    }

    const int rec = record_floats(group, HD);
    const int bh = b * Hkv + kh;
    const float* recs = part + (size_t)bh * n_split * rec;
    float* mine = part + ((size_t)bh * n_split + split) * rec;
    for (int i = tid; i < n4; i += NT)
        reinterpret_cast<float4*>(mine)[i] = reinterpret_cast<const float4*>(sacc)[i];
    for (int r = tid; r < group; r += NT) {
        mine[group * HD + r] = sm[r];
        mine[group * HD + group + r] = sl[r];
    }
    __syncthreads();
    if (tid == 0) count_barrier(counts + bh, base, n_split);
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
        const float4* src = reinterpret_cast<const float4*>(recs) + p0 + p;
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
            const float* rs = recs + (size_t)(i % n_split) * rec + group * HD;
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
            const float4* sj_src = reinterpret_cast<const float4*>(recs) + p0 + pj;
            for (; s < n_split; s += nsub) {
                const float4 v = __ldcg(sj_src + (size_t)s * (rec / 4));
                a = make_float4(a.x + c[s] * v.x, a.y + c[s] * v.y, a.z + c[s] * v.z,
                                a.w + c[s] * v.w);
            }
            if (nsub == 1) {
                const float w = inv[rr];
                if (kept(p0 + pj))
                    store4(dst(p0 + pj), make_float4(a.x * w, a.y * w, a.z * w, a.w * w));
            } else {
                red[sj * P + pj] = a;
            }
        }
        if (nsub > 1) {
            __syncthreads();
            for (int q = tid; q < P; q += NT) {
                if (!kept(p0 + q)) continue;
                float4 a = red[q];
                for (int sj = 1; sj < nsub; ++sj) {
                    const float4 v = red[sj * P + q];
                    a = make_float4(a.x + v.x, a.y + v.y, a.z + v.z, a.w + v.w);
                }
                const float w = inv[(p0 + q) / C4 - r0];
                store4(dst(p0 + q), make_float4(a.x * w, a.y * w, a.z * w, a.w * w));
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
    static_assert(NBLK > STEP, "a paged source's block ids span a stage");
};

// The partial state of the group's query heads (qb: group rows of hd <= HD
// bf16) over the keys [k_lo, k_hi) of `src`, visible iff their position p
// has 0 <= p <= tb and, with window > 0, p > tb - window.  Leaves, in
// shared memory, acc at smem (group x HD f32, columns past hd zero) and m
// (log2 domain) and l at sm, sl (smem + Geom<HD>::RING), and returns after
// a block barrier.
template <int HD, class Src>
__device__ __forceinline__ void mma_state(Src& src, const __nv_bfloat16* __restrict__ qb,
                                          int group, int hd, int k_lo, int k_hi, int tb,
                                          float scale_log2, int window, unsigned char* smem,
                                          int tid) {
    using G = Geom<HD>;
    constexpr int KS = HD / 16;               // k16 steps of Q K^T
    constexpr int NJ = HD / G::NWD / 8;       // 8-column n-tiles of this warp's share of O
    constexpr int CPR = HD / 8;               // 16-byte chunks of a row
    const int lane = tid & 31, warp = tid >> 5;
    const int kg = warp / G::NWD;             // this warp's tile of each stage
    const int cd = warp % G::NWD;             // this warp's share of the output columns
    const int quad = lane & 3, row = lane >> 2;
    const uint32_t ring = smem_u32(smem);

    // one ring stage: the K and V rows and positions of keys [k0, k0 + STEP)
    // of this split; rows past the split, or that the source does not hold,
    // are zero-filled, never read
    auto issue = [&](int step) {
        const int k0 = k_lo + step * G::STEP;
        if (k0 < k_hi) {
            src.stage(k0, min(k0 + G::STEP, k_hi), tid);
            const uint32_t sk = ring + (step % G::STAGES) * G::STAGE_BYTES;
            const uint32_t sv = sk + G::KV_BYTES;
            const uint32_t sp = sv + G::KV_BYTES;
            for (int i = tid; i < G::STEP * CPR; i += NT) {
                const int r = i / CPR, c = (i % CPR) * 8;
                size_t off = 0;
                const bool ok = k0 + r < k_hi && c < hd && src.row(k0 + r, off);
                off = ok ? off + c : 0;
                cp_async_16(sk + (r * G::LD + c) * 2, src.k + off, ok);
                cp_async_16(sv + (r * G::LD + c) * 2, src.v + off, ok);
            }
            for (int r = tid; r < G::STEP; r += NT) src.pos_async(sp + 4 * r, k0 + r, k0 + r < k_hi);
        }
        cp_async_commit();
    };
    issue(0);

    // Q's A fragments, rows >= group and columns >= hd zero: register e
    // holds row `row` + 8 (e & 1), columns 16 ks + 2 quad + 8 (e >> 1) + {0, 1}
    uint32_t qa[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int r = row + 8 * (e & 1);
            const int c = 16 * ks + 2 * quad + 8 * (e >> 1);
            qa[ks][e] = r < group && c < hd
                            ? *reinterpret_cast<const uint32_t*>(qb + (size_t)r * hd + c)
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
}

// ---------------------------------------------------------------------------
// f32: CUDA-core products over chunks of keys
// ---------------------------------------------------------------------------

constexpr int CH32 = 32;   // keys per chunk

template <int HD>
struct Geom32 {
    static constexpr int KV = CH32 * HD * 4;                    // K (or V) of a chunk
    static constexpr int Q = MAX_GROUP * HD * 4;                // q, then the block's acc
    static constexpr int S = MAX_GROUP * CH32 * 4;              // scores, then probabilities
    static constexpr size_t bytes = 2 * KV + Q + S + CH32 * 4 + 3 * MAX_GROUP * 4;
    // after the loop: acc at smem + 2 KV, m and l at SM, SM + MAX_GROUP floats
    static constexpr size_t SM = 2 * KV + Q + S + CH32 * 4;
};

// As mma_state, for f32 inputs: leaves acc at smem + Geom32<HD>::2 KV
// (group x HD f32) and m, l at smem + Geom32<HD>::SM; the K/V chunk area
// at smem is free for the merge's work.
template <int HD, class Src>
__device__ __forceinline__ void f32_state(Src& src, const float* __restrict__ qb, int group,
                                          int hd, int k_lo, int k_hi, int tb, float scale_log2,
                                          int window, unsigned char* smem, int tid) {
    using G = Geom32<HD>;
    constexpr int E = HD / 32;                 // elements of a key row per lane
    constexpr int UC = (HD + NT - 1) / NT;     // output columns per thread
    const int lane = tid & 31, warp = tid >> 5;
    float* sk = reinterpret_cast<float*>(smem);              // CH32 x HD
    float* sv = sk + CH32 * HD;                               // CH32 x HD
    float* sq = sv + CH32 * HD;                               // group x HD
    float* ss = sq + MAX_GROUP * HD;                          // group x CH32
    int* sp = reinterpret_cast<int*>(ss + MAX_GROUP * CH32);  // CH32
    float* sm = reinterpret_cast<float*>(sp + CH32);
    float* sl = sm + MAX_GROUP;
    float* salpha = sl + MAX_GROUP;

    for (int i = tid; i < group * HD; i += NT) {
        const int c = i % HD;
        sq[i] = c < hd ? qb[(size_t)(i / HD) * hd + c] : 0.f;
    }
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
        src.stage(k0, k0 + n, tid);
        for (int i = tid; i < n * HD / 4; i += NT) {
            const int r = i / (HD / 4), c = (i % (HD / 4)) * 4;
            size_t off = 0;
            const bool ok = c < hd && src.row(k0 + r, off);
            const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
            store4(sk + r * HD + c, ok ? *reinterpret_cast<const float4*>(src.k + off + c) : z);
            store4(sv + r * HD + c, ok ? *reinterpret_cast<const float4*>(src.v + off + c) : z);
        }
        for (int r = tid; r < n; r += NT) sp[r] = src.pos_of(k0 + r);
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
    __syncthreads();
#pragma unroll
    for (int u = 0; u < UC; ++u) {
        const int c = tid + NT * u;
        if (c >= HD) continue;
#pragma unroll
        for (int g = 0; g < MAX_GROUP; ++g)
            if (g < group) sq[g * HD + c] = acc[g][u];
    }
    __syncthreads();
}

// ---------------------------------------------------------------------------
// one paged split, both dtypes: the state of keys [lo, hi) of split
// `split` of slot b, kv head kh, then finish_block into out (B, H, hd)
// ---------------------------------------------------------------------------

// The keys of split `split` of n_split over the slot's E * bs positions that
// some key of position <= tb (and > tb - window with a window) can hold:
// tiles wholly past t or before the window are dropped, and the split may
// end up empty.
__device__ __forceinline__ void paged_keys(int n_keys, int n_split, int split, int tb,
                                           int window, int& lo, int& hi) {
    split_keys(n_keys, n_split, split, lo, hi);
    lo = max(lo, window > 0 ? tb - window + 1 : 0);
    hi = min(hi, tb + 1);
    if (hi < lo) hi = lo;
}

// shared memory of one paged split: the body's, then NBLK block ids
template <int HD, typename T>
struct PagedGeom {
    static constexpr size_t body = sizeof(T) == 2 ? Geom<HD>::bytes : Geom32<HD>::bytes;
    static constexpr size_t bytes = body + NBLK * 4;
};

template <int HD, typename T>
__device__ __forceinline__ void paged_split(const T* __restrict__ q, const T* __restrict__ kp,
                                            const T* __restrict__ vp,
                                            const int* __restrict__ tables, int tb,
                                            T* __restrict__ out, float* __restrict__ part,
                                            unsigned long long* __restrict__ counts, int b, int kh,
                                            int split,
                                            int E, int bs, int H, int Hkv, int hd, int n_split,
                                            float scale_log2, int window, unsigned long long base,
                                            unsigned char* smem, int tid) {
    const int group = H / Hkv;
    int k_lo, k_hi;
    paged_keys(E * bs, n_split, split, tb, window, k_lo, k_hi);
    PagedSrc<T> src{kp + (size_t)kh * hd, vp + (size_t)kh * hd, tables + (size_t)b * E, E, bs,
                    (size_t)Hkv * hd,
                    reinterpret_cast<int*>(smem + PagedGeom<HD, T>::body), INT_MIN / 2};
    const T* qb = q + ((size_t)b * H + (size_t)kh * group) * hd;
    if constexpr (sizeof(T) == 2) {
        mma_state<HD>(src, qb, group, hd, k_lo, k_hi, tb, scale_log2, window, smem, tid);
        float* sO = reinterpret_cast<float*>(smem);
        const float* sm = reinterpret_cast<const float*>(smem + Geom<HD>::RING);
        finish_block<HD>(sO, sO, sm, sm + MAX_GROUP, out, part, counts, b, kh, H, Hkv, group,
                         split, n_split, base, hd, tid);
    } else {
        f32_state<HD>(src, qb, group, hd, k_lo, k_hi, tb, scale_log2, window, smem, tid);
        const float* sacc = reinterpret_cast<const float*>(smem) + 2 * CH32 * HD;
        const float* sm = reinterpret_cast<const float*>(smem + Geom32<HD>::SM);
        finish_block<HD>(reinterpret_cast<float*>(smem), sacc, sm, sm + MAX_GROUP, out, part,
                         counts, b, kh, H, Hkv, group, split, n_split, base, hd, tid);
    }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// A kernel's opt-in to `smem` bytes of dynamic shared memory, made once
// per device (`done` holds a bit per device index below 64).
inline cudaError_t opt_in(const void* fn, size_t smem, std::atomic<unsigned long long>& done) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
    if (bit && (done.load(std::memory_order_relaxed) & bit)) return cudaSuccess;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
    return err;
}

// blocks of `fn` (NT threads, `smem` bytes) that can be resident at once on
// the current device
inline cudaError_t resident_blocks(const void* fn, size_t smem, int* blocks) {
    int dev = 0, n_sm = 0, per_sm = 0;
    cudaError_t err;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
        return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, NT, smem);
    if (err != cudaSuccess) return err;
    *blocks = per_sm * n_sm;
    return cudaSuccess;
}

}  // namespace dec
