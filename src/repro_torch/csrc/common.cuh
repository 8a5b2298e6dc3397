// Helpers shared by the paged attention kernels: f32 <-> element type
// conversion, warp reductions, the positional visibility rule of a paged
// KV pool, the staging of pool rows into shared memory, the scores and
// P.V products of staged rows, and the partial softmax state of one
// split of a slot's key positions (flash-decoding's first phase).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace paged {

constexpr float NEG_INF = -1e30f;

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

// A key at absolute position `kpos`, in a pool block the slot's table
// binds (`bound`), is visible to a query at position `qpos` (< 0 = a
// padded query row, which sees nothing).  Keys past the query, and for
// window > 0 keys at or before qpos - window, are masked.
__device__ __forceinline__ bool visible(bool bound, int kpos, int qpos, int window) {
    bool ok = bound && qpos >= 0 && kpos <= qpos;
    if (window > 0) ok = ok && kpos > qpos - window;
    return ok;
}

// Block ids of entries [e0, e1] of a slot's table (-1 past its end, E)
// into shared memory, by threads tid = 0, nt, 2 nt, ...
__device__ __forceinline__ void load_blocks(int* sblk, const int* __restrict__ tab, int e0,
                                            int e1, int E, int tid, int nt) {
    for (int i = tid; i <= e1 - e0; i += nt) sblk[i] = (e0 + i < E) ? tab[e0 + i] : -1;
}

// Stage the K and V rows of key positions [k0, k0 + n), kv head kh, from
// the pool (N, bs, Hkv, hd) into shared memory, K rows ldk and V rows ldv
// elements apart.  Position p lies in pool block sblk[p / bs - e0] at
// offset p % bs.  A row is read iff its block is bound and p lies in
// (lo - window, hi] ([0, hi] when window <= 0): the only rows some query
// at a position in [lo, hi] can see.  Other rows are written as zeros and
// never read, so an unbound entry (-1) is never dereferenced.  sok[r]
// records whether row r was read.  Each thread keeps UNR 16-byte loads
// of K and of V in flight before it stores any: the block ids come from
// shared memory, so no load waits on another.
template <int NT, int UNR, typename T>
__device__ __forceinline__ void stage_kv(T* sk, int ldk, T* sv, int ldv, int* sok,
                                         const T* __restrict__ kp, const T* __restrict__ vp,
                                         const int* sblk, int e0, int k0, int n, int bs,
                                         int Hkv, int kh, int hd, int lo, int hi, int window,
                                         int tid) {
    constexpr int VEC = 16 / sizeof(T);
    const int vpr = hd / VEC;
    const int total = n * vpr;
    for (int base = tid; base < total; base += NT * UNR) {
        uint4 kv[UNR], vv[UNR];
#pragma unroll
        for (int u = 0; u < UNR; ++u) {
            const int i = base + u * NT;
            kv[u] = make_uint4(0u, 0u, 0u, 0u);
            vv[u] = kv[u];
            if (i < total) {
                const int r = i / vpr;
                const int c = (i % vpr) * VEC;
                const int kpos = k0 + r;
                const int blk = sblk[kpos / bs - e0];
                const bool ok = blk >= 0 && kpos <= hi && (window <= 0 || kpos > lo - window);
                if (ok) {
                    const size_t off = ((size_t)blk * bs + kpos % bs) * Hkv * hd
                                       + (size_t)kh * hd + c;
                    kv[u] = *reinterpret_cast<const uint4*>(kp + off);
                    vv[u] = *reinterpret_cast<const uint4*>(vp + off);
                }
                if (c == 0) sok[r] = ok;
            }
        }
#pragma unroll
        for (int u = 0; u < UNR; ++u) {
            const int i = base + u * NT;
            if (i < total) {
                const int r = i / vpr;
                const int c = (i % vpr) * VEC;
                *reinterpret_cast<uint4*>(sk + (size_t)r * ldk + c) = kv[u];
                *reinterpret_cast<uint4*>(sv + (size_t)r * ldv + c) = vv[u];
            }
        }
    }
}

// Scores of the staged key rows [0, n) (K rows ldk elements apart)
// against the group's query heads sq (group x hd, f32): thread (row =
// tid % ROWS, part = tid / ROWS) dots its row with heads part, part + P,
// part + 2P, ... (P = NT / ROWS) and writes ss[g * ROWS + row], scaled,
// or NEG_INF where sok[row] is 0.  No step reduces across lanes; the
// lanes of a warp share their heads, so their 16-byte q reads are
// broadcasts, and with ldk = hd + 16 / sizeof(T) the 16-byte K reads of
// a warp's consecutive rows fall in distinct banks.  sq must be 16-byte
// aligned.
template <int NT, int ROWS, int MAX_GROUP, typename T>
__device__ __forceinline__ void score_rows(float* ss, const T* sk, int ldk, const float* sq,
                                           const int* sok, int n, int group, int hd,
                                           float scale, int tid) {
    constexpr int VEC = 16 / sizeof(T);
    constexpr int P = NT / ROWS;
    constexpr int PER = (MAX_GROUP + P - 1) / P;
    const int row = tid % ROWS;
    const int part = tid / ROWS;
    if (row >= n) return;
    float dot[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) dot[j] = 0.f;
    const T* kr = sk + (size_t)row * ldk;
    for (int c = 0; c < hd; c += VEC) {
        const uint4 raw = *reinterpret_cast<const uint4*>(kr + c);
        const T* e = reinterpret_cast<const T*>(&raw);
        float kf[VEC];
#pragma unroll
        for (int u = 0; u < VEC; ++u) kf[u] = to_f32(e[u]);
#pragma unroll
        for (int j = 0; j < PER; ++j) {
            const int g = part + P * j;
            if (g < group) {
                const float4* qv = reinterpret_cast<const float4*>(sq + g * hd + c);
#pragma unroll
                for (int w = 0; w < VEC / 4; ++w) {
                    const float4 x = qv[w];
                    dot[j] += x.x * kf[4 * w] + x.y * kf[4 * w + 1] + x.z * kf[4 * w + 2]
                              + x.w * kf[4 * w + 3];
                }
            }
        }
    }
    const bool ok = sok[row];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
        const int g = part + P * j;
        if (g < group) ss[g * ROWS + row] = ok ? dot[j] * scale : NEG_INF;
    }
}

__device__ __forceinline__ float2 load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

constexpr int PV_COLS = 64;   // column pairs of P.V: head_dim <= 128

// P.V of the staged value rows [0, n) (V rows hd elements apart) with
// the probabilities ss[g * ROWS + r]: thread (pair = tid % 64, part =
// tid / 64) adds to pv[j] the columns 2 pair and 2 pair + 1 of heads
// part + P j (P = NT / 64), j < PV_PER.  Four rows at a time, so that
// each probability read is one 16-byte broadcast (ss must be 16-byte
// aligned and ROWS a multiple of 4).
template <int NT, int ROWS, int PV_PER, typename T>
__device__ __forceinline__ void pv_rows(float2 (&pv)[PV_PER], const T* sv, const float* ss,
                                        int n, int group, int hd, int tid) {
    constexpr int P = NT / PV_COLS;
    const int c = 2 * (tid % PV_COLS);
    const int part = tid / PV_COLS;
    if (c >= hd) return;
    int r = 0;
    for (; r + 4 <= n; r += 4) {
        float2 v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = load2(sv + (size_t)(r + i) * hd + c);
#pragma unroll
        for (int j = 0; j < PV_PER; ++j) {
            const int g = part + P * j;
            if (g < group) {
                const float4 p = *reinterpret_cast<const float4*>(ss + g * ROWS + r);
                pv[j].x += p.x * v[0].x + p.y * v[1].x + p.z * v[2].x + p.w * v[3].x;
                pv[j].y += p.x * v[0].y + p.y * v[1].y + p.z * v[2].y + p.w * v[3].y;
            }
        }
    }
    for (; r < n; ++r) {
        const float2 v = load2(sv + (size_t)r * hd + c);
#pragma unroll
        for (int j = 0; j < PV_PER; ++j) {
            const int g = part + P * j;
            if (g < group) {
                const float p = ss[g * ROWS + r];
                pv[j].x += p * v.x;
                pv[j].y += p * v.y;
            }
        }
    }
}

// Shared memory of split_state for at most ROWS key rows: K rows
// (padded, see score_rows), V rows, the group's q in f32, scores, read
// flags and block ids (ROWS + 1 entries: a split need not start on a
// block boundary).
template <int ROWS, typename T>
__host__ __device__ inline size_t split_smem(int hd, int group) {
    return sizeof(T) * (size_t)ROWS * (2 * hd + 16 / sizeof(T))
           + sizeof(float) * (size_t)group * (hd + ROWS) + sizeof(int) * (2 * ROWS + 1);
}

// Partial softmax state of one split: the group's query heads (qb, group
// x hd, of slot b) against the visible keys among positions [k0, k0 +
// rows) (rows <= ROWS) of kv head kh, read through the slot's table row
// tab (E entries; tb = t[b]).  Writes, for head g of the group, m[g] =
// the max score, l[g] = sum of exp(s - m[g]) and acc[g * hd + c] = sum
// of exp(s - m[g]) v[c], in f32.  A split with no visible key reads
// nothing from the pool and writes m = NEG_INF, l = 0, acc = 0, which a
// merge weighs as nothing.  Opens with a barrier, so shared memory may be
// reused by the next call; smem holds split_smem<ROWS, T>(hd, group)
// bytes, 16-byte aligned.
template <int NT, int ROWS, int UNR, int MAX_GROUP, typename T>
__device__ __forceinline__ void split_state(unsigned char* smem, const T* __restrict__ qb,
                                            const T* __restrict__ kp, const T* __restrict__ vp,
                                            const int* __restrict__ tab, int E, int bs, int Hkv,
                                            int kh, int group, int hd, int k0, int rows, int tb,
                                            float scale, int window, float* m, float* l,
                                            float* acc, int tid) {
    const int lane = tid & 31;
    const int warp = tid >> 5;
    // rows [0, n) may hold a visible key: positions k0 .. min(tb, table end)
    const int n = max(0, min(min(rows, E * bs - k0), tb - k0 + 1));
    const bool any = n > 0 && (window <= 0 || k0 + n - 1 > tb - window);
    __syncthreads();   // the previous readers of shared memory are done
    if (!any) {
        for (int g = tid; g < group; g += NT) {
            m[g] = NEG_INF;
            l[g] = 0.f;
        }
        for (int i = tid; i < group * hd; i += NT) acc[i] = 0.f;
        return;
    }

    const int ldk = hd + 16 / (int)sizeof(T);
    T* sk = reinterpret_cast<T*>(smem);                              // ROWS x ldk
    T* sv = sk + (size_t)ROWS * ldk;                                 // ROWS x hd
    float* sq = reinterpret_cast<float*>(sv + (size_t)ROWS * hd);    // group x hd
    float* ss = sq + group * hd;          // group x ROWS: scores, then probabilities
    int* sok = reinterpret_cast<int*>(ss + group * ROWS);            // ROWS read flags
    int* sblk = sok + ROWS;                                          // ROWS + 1 block ids

    const int e0 = k0 / bs;
    load_blocks(sblk, tab, e0, (k0 + n - 1) / bs, E, tid, NT);
    for (int i = tid; i < group * hd; i += NT) sq[i] = to_f32(qb[i]);
    __syncthreads();
    stage_kv<NT, UNR>(sk, ldk, sv, hd, sok, kp, vp, sblk, e0, k0, n, bs, Hkv, kh, hd, tb, tb,
                      window, tid);
    __syncthreads();
    score_rows<NT, ROWS, MAX_GROUP>(ss, sk, ldk, sq, sok, n, group, hd, scale, tid);
    __syncthreads();

    // per-head max and sum over this split, a warp per head
    for (int g = warp; g < group; g += NT / 32) {
        float mx = NEG_INF;
        for (int r = lane; r < n; r += 32) mx = fmaxf(mx, ss[g * ROWS + r]);
        mx = warp_max(mx);
        float sum = 0.f;
        for (int r = lane; r < n; r += 32) {
            const float s = ss[g * ROWS + r];
            const float p = (s == NEG_INF) ? 0.f : expf(s - mx);
            ss[g * ROWS + r] = p;
            sum += p;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
            m[g] = mx;
            l[g] = sum;
        }
    }
    __syncthreads();

    // acc[g][c] = sum_r p[g][r] * v[r][c]: thread (column pair, head part)
    constexpr int PV_PER = MAX_GROUP / (NT / PV_COLS);
    float2 pv[PV_PER];
#pragma unroll
    for (int j = 0; j < PV_PER; ++j) pv[j] = make_float2(0.f, 0.f);
    pv_rows<NT, ROWS, PV_PER>(pv, sv, ss, n, group, hd, tid);
    const int c = 2 * (tid % PV_COLS);
    if (c < hd) {
#pragma unroll
        for (int j = 0; j < PV_PER; ++j) {
            const int g = tid / PV_COLS + (NT / PV_COLS) * j;
            if (g < group) *reinterpret_cast<float2*>(acc + (size_t)g * hd + c) = pv[j];
        }
    }
}

}  // namespace paged
