// Helpers shared by the paged attention kernels: warp reductions, the
// positional visibility rule of a paged KV pool, the block ids of a
// slot's table in shared memory, and the staging of pool rows into shared
// memory (paged prefill's f32 body).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace paged {

constexpr float NEG_INF = -1e30f;

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

}  // namespace paged
