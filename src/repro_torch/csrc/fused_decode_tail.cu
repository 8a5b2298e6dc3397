// Fused decode tail for Hopper (sm_90a): paged decode attention for all
// query heads of a slot followed by the attention output projection, in
// ONE launch whose per-head contexts never reach global memory.
//
// Replaces: src/repro/kernels/fused_decode_tail.py::fused_decode_tail_pallas
// (the Pallas TPU kernel behind repro.kernels.ops.fused_decode_tail).
// Plain version: src/repro_torch/kernels/ref.py::fused_decode_tail.
//
// What bounds it on the H100: memory.  A call must read the slots'
// visible K/V rows once (about 2.6 MB of distinct rows at the paged
// engine's shapes: B=8 slots in 2 groups of 4 sharing their prompt
// blocks, t in [256, 768), Hkv=2, hd=128, bf16) and wo once (H*hd x D =
// 1536 x 1536 bf16, 4.7 MB); its 2*B*H*hd*D projection FLOP (38 MFLOP)
// and the attention FLOP are far below the tensor cores' rate.  Bound:
// about 7.3 MB / 3.35 TB/s, near 2.2 us.
//
// What the design does about it:
//  * the TPU kernel walks (slot, table entry) in sequence with all of wo
//    resident in VMEM and folds the projection into its last step.  On
//    Hopper one block per slot would leave most SMs idle, and wo does not
//    fit in 227 KB of shared memory.  So the kernel is cooperative and
//    persistent (as many blocks as can be resident at once) and runs in
//    two phases split by a grid-wide barrier:
//      1. work item (slot, split of the key positions): the block reads
//         the split's visible K/V rows once, for all kv heads, and writes
//         each query head's partial softmax state (max, sum, f32 P.V) to
//         scratch the wrapper allocates;
//      2. work item (slot, 64-column D tile): the block merges its slot's
//         splits, in a fixed order and with 16-byte loads, into the head
//         contexts (f32, in shared memory: H x hd, 6 KB at the path's
//         shapes) and multiplies them by its (H*hd x 64) slice of wo
//         (16-byte loads, 8 in flight per thread), writing the 64 outputs
//         in q's dtype.  Every tile of a slot repeats the merge; it costs
//         a few instructions per split and thread, so more splits (a
//         fuller phase 1) cost phase 2 little.
//    The contexts never reach global memory, nothing is atomic, and the
//    result does not depend on the schedule.  The contexts stay in f32
//    (the TPU kernel's order; the plain version rounds them to q's dtype
//    before its f32 projection).
//  * phase 1 runs the paged decode kernel's split, common.cuh::
//    split_state, over the same scratch layout: the block ids go to
//    shared memory first, then all K/V loads are in flight; an
//    unbound entry (-1) is never dereferenced and rows that are not
//    visible are zero-filled; a thread scores a whole key row for its
//    share of the heads, and P.V reads are 16 bytes where they can be.
//    A slot with no visible key merges to l = 0, clamped to 1e-30, and
//    projects a zero context.
//  * head_dim is a runtime value <= 128 and a multiple of 8; D is a
//    multiple of 16 bytes of elements.

#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace paged;

constexpr int NT = 256;          // threads per block
constexpr int MAX_HD = 128;
constexpr int MAX_GROUP = 16;
constexpr int MAX_H = 64;        // query heads (H * hd <= 8192 as well)
constexpr int TD = 64;           // output columns per phase-2 item
constexpr int SR = 64;           // key rows per split, at most
constexpr int SCH = 32;          // splits whose merge weights are staged at once
constexpr int MAXV4 = 8192 / 4 / NT;  // float4 context pieces per thread (H * hd <= 8192)

template <typename T>
struct Smem {
    // phase 1: common.cuh::split_state's
    static size_t phase1(int hd, int group) { return split_smem<SR, T>(hd, group); }
    // phase 2: contexts, per-head max and inverse sum, merge weights,
    // partial outputs
    static size_t phase2(int H, int hd) {
        return sizeof(float) * ((size_t)H * hd + 2 * MAX_H + SCH * MAX_H + NT * 16 / sizeof(T));
    }
    static size_t bytes(int H, int hd, int group) {
        const size_t a = phase1(hd, group), b = phase2(H, hd);
        return a > b ? a : b;
    }
};

// part_m, part_l: (B, n_split, H) f32; part_acc: (B, n_split, H, hd) f32.
template <typename T>
__global__ void __launch_bounds__(NT)
fused_decode_tail_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                         const T* __restrict__ vp, const T* __restrict__ wo,
                         const int* __restrict__ tables, const int* __restrict__ t,
                         float* part_m, float* part_l, float* part_acc,
                         T* __restrict__ out, int B, int E,
                         int bs, int H, int Hkv, int hd, int D, int n_split, int rows,
                         float scale, int window) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int group = H / Hkv;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;

    // ---- phase 1: partial softmax state of every (slot, split, head) ----
    for (int item = blockIdx.x; item < B * n_split; item += gridDim.x) {
        const int b = item / n_split;
        const int split = item % n_split;
        for (int kh = 0; kh < Hkv; ++kh) {
            const size_t i = (size_t)item * H + (size_t)kh * group;
            split_state<NT, SR, 4, MAX_GROUP>(
                smem, q + ((size_t)b * H + (size_t)kh * group) * hd, kp, vp,
                tables + (size_t)b * E, E, bs, Hkv, kh, group, hd, split * rows, rows, t[b],
                scale, window, part_m + i, part_l + i, part_acc + i * hd, tid);
        }
    }

    cg::this_grid().sync();   // every split's state is written and visible

    // ---- phase 2: merge a slot's splits, project one D tile --------------
    // (scratch written in phase 1 by other blocks is read past L1: __ldcg)
    {
        float* sctx = reinterpret_cast<float*>(smem);                    // H x hd
        float* smax = sctx + (size_t)H * hd;                             // MAX_H
        float* sinv = smax + MAX_H;                                      // MAX_H
        float* sw = sinv + MAX_H;                                        // SCH x MAX_H
        float* sred = sw + SCH * MAX_H;                                  // NT x 16/sizeof(T)
        constexpr int CPT = 16 / sizeof(T);       // columns per 16-byte piece
        constexpr int PIECES = TD / CPT;
        constexpr int RG = NT / PIECES;
        const int n_tiles = (D + TD - 1) / TD;
        const int K = H * hd;
        const int K4 = K / 4;                     // hd % 8 == 0
        // the thread's context pieces: float4 tid, tid + NT, ... and the
        // head each lies in
        int hk[MAXV4];
#pragma unroll
        for (int k = 0; k < MAXV4; ++k) hk[k] = 4 * (tid + NT * k) / hd;
        for (int item = blockIdx.x; item < B * n_tiles; item += gridDim.x) {
            const int b = item / n_tiles;
            const int d0 = (item % n_tiles) * TD;
            const size_t base = (size_t)b * n_split * H;
            __syncthreads();   // the previous item's readers are done
            // per head: the max over the splits and 1 / the merged sum; a
            // warp per head, its lanes over the splits
            for (int h = warp; h < H; h += NT / 32) {
                float mx = NEG_INF;
                for (int s = lane; s < n_split; s += 32)
                    mx = fmaxf(mx, __ldcg(part_m + base + (size_t)s * H + h));
                mx = warp_max(mx);
                float l = 0.f;
                for (int s = lane; s < n_split; s += 32) {
                    const size_t i = base + (size_t)s * H + h;
                    l += expf(__ldcg(part_m + i) - mx) * __ldcg(part_l + i);
                }
                l = warp_sum(l);
                if (lane == 0) {
                    smax[h] = mx;
                    sinv[h] = 1.f / fmaxf(l, 1e-30f);
                }
            }
            // contexts: the splits' weights go to shared memory SCH splits
            // at a time; each split adds w * acc to the thread's pieces,
            // one 16-byte load each
            float4 a[MAXV4];
#pragma unroll
            for (int k = 0; k < MAXV4; ++k) a[k] = make_float4(0.f, 0.f, 0.f, 0.f);
            for (int s0 = 0; s0 < n_split; s0 += SCH) {
                const int ns = min(SCH, n_split - s0);
                __syncthreads();   // smax / sinv written; the previous weights read
                for (int x = tid; x < ns * H; x += NT) {
                    const int h = x % H;
                    sw[x] = expf(__ldcg(part_m + base + (size_t)(s0 + x / H) * H + h) - smax[h])
                            * sinv[h];
                }
                __syncthreads();
#pragma unroll 4
                for (int s = 0; s < ns; ++s) {
                    const float4* pa = reinterpret_cast<const float4*>(
                        part_acc + (base + (size_t)(s0 + s) * H) * hd);
#pragma unroll
                    for (int k = 0; k < MAXV4; ++k) {
                        const int i4 = tid + NT * k;
                        if (i4 < K4) {
                            const float w = sw[s * H + hk[k]];
                            const float4 v = __ldcg(pa + i4);
                            a[k].x += w * v.x;
                            a[k].y += w * v.y;
                            a[k].z += w * v.z;
                            a[k].w += w * v.w;
                        }
                    }
                }
            }
#pragma unroll
            for (int k = 0; k < MAXV4; ++k) {
                const int i4 = tid + NT * k;
                if (i4 < K4) reinterpret_cast<float4*>(sctx)[i4] = a[k];
            }
            __syncthreads();

            // out[b, d0 + j] = sum_i ctx[i] * wo[i, d0 + j]: thread (rg, pc)
            // reads the 16-byte piece pc of rows rg, rg + RG, ... of the tile
            const int pc = tid % PIECES;
            const int rg = tid / PIECES;
            const int oc0 = d0 + pc * CPT;
            float o[CPT];
#pragma unroll
            for (int u = 0; u < CPT; ++u) o[u] = 0.f;
            if (oc0 < D) {
#pragma unroll 8
                for (int i = rg; i < K; i += RG) {
                    const uint4 raw = *reinterpret_cast<const uint4*>(wo + (size_t)i * D + oc0);
                    const T* e = reinterpret_cast<const T*>(&raw);
                    const float x = sctx[i];
#pragma unroll
                    for (int u = 0; u < CPT; ++u) o[u] += x * to_f32(e[u]);
                }
            }
#pragma unroll
            for (int u = 0; u < CPT; ++u) sred[rg * TD + pc * CPT + u] = o[u];
            __syncthreads();
            if (tid < TD && d0 + tid < D) {
                float s = 0.f;
                for (int k = 0; k < RG; ++k) s += sred[k * TD + tid];
                out[(size_t)b * D + d0 + tid] = from_f32<T>(s);
            }
        }
    }
}

// The resident grid of the kernel for these widths: blocks per SM at its
// shared memory, times the SMs.  The opt-in maximum of dynamic shared
// memory is allowed once, so a grid queried for one width stays valid for
// any other.
template <typename T>
cudaError_t resident_grid(int H, int Hkv, int hd, int* grid) {
    const size_t smem = Smem<T>::bytes(H, hd, H / Hkv);
    int dev = 0, n_sm = 0, optin = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    if (smem > (size_t)optin) return cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(fused_decode_tail_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_decode_tail_kernel<T>, NT,
                                                        smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    *grid = n_sm * per_sm;
    return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp, const void* wo,
                   const int* tables, const int* t, float* part_m, float* part_l,
                   float* part_acc, void* out, int B, int E, int bs, int H, int Hkv, int hd,
                   int D, int n_split, int rows, int grid, float scale, int window,
                   cudaStream_t stream) {
    const size_t smem = Smem<T>::bytes(H, hd, H / Hkv);
    const T* q_ = static_cast<const T*>(q);
    const T* kp_ = static_cast<const T*>(kp);
    const T* vp_ = static_cast<const T*>(vp);
    const T* wo_ = static_cast<const T*>(wo);
    T* out_ = static_cast<T*>(out);
    void* args[] = {(void*)&q_,      (void*)&kp_,     (void*)&vp_,    (void*)&wo_,
                    (void*)&tables,  (void*)&t,       (void*)&part_m, (void*)&part_l,
                    (void*)&part_acc, (void*)&out_,   (void*)&B,      (void*)&E,
                    (void*)&bs,      (void*)&H,       (void*)&Hkv,    (void*)&hd,
                    (void*)&D,       (void*)&n_split, (void*)&rows,   (void*)&scale,
                    (void*)&window};
    cudaError_t err = cudaLaunchCooperativeKernel((const void*)fused_decode_tail_kernel<T>,
                                                  dim3(grid), dim3(NT), args, smem, stream);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

bool takes(int H, int Hkv, int hd, int D, int bs, int dtype) {
    return Hkv > 0 && H % Hkv == 0 && H / Hkv <= MAX_GROUP && H <= MAX_H && hd > 0
           && hd <= MAX_HD && hd % 8 == 0 && H * hd <= 8192 && D > 0
           && D % (dtype == 1 ? 8 : 4) == 0 && bs > 0 && (dtype == 0 || dtype == 1);
}

}  // namespace

// The resident grid for these widths on the current device (see
// resident_grid), the most blocks a launch may take.  Returns the CUDA
// error (0 = success).
extern "C" int fused_decode_tail_grid(int H, int Hkv, int hd, int dtype, int* grid) {
    if (!takes(H, Hkv, hd, 8, 1, dtype)) return (int)cudaErrorInvalidValue;
    if (dtype == 1) return resident_grid<__nv_bfloat16>(H, Hkv, hd, grid);
    return resident_grid<float>(H, Hkv, hd, grid);
}

// q: (B, H, hd); k_pool, v_pool: (N, bs, Hkv, hd); wo: (H*hd, D); tables:
// (B, E) int32 (-1 = unbound); t: (B,) int32; split j of slot b covers key
// positions [j rows, (j + 1) rows), rows <= 64; part_m, part_l: (B,
// n_split, H) f32 and part_acc: (B, n_split, H, hd) f32, 16-byte
// aligned, scratch; grid at
// most fused_decode_tail_grid's; out: (B, D) in q's dtype.  dtype: 0 =
// float32, 1 = bfloat16.  hd <= 128 and a multiple of 8; D a multiple of
// 16 bytes of elements; group = H / Hkv <= 16; H <= 64; H * hd <= 8192.
// Returns the CUDA error (0 = success).
extern "C" int fused_decode_tail_fwd(const void* q, const void* kp, const void* vp,
                                     const void* wo, const void* tables, const void* t,
                                     void* part_m, void* part_l, void* part_acc, void* out,
                                     int B, int E, int bs, int H, int Hkv, int hd, int D,
                                     int dtype, int n_split, int rows, int grid, float scale,
                                     int window, void* stream) {
    if (!takes(H, Hkv, hd, D, bs, dtype) || rows < 1 || rows > SR
        || (long long)rows * n_split < (long long)E * bs || grid < 1
        || reinterpret_cast<uintptr_t>(part_acc) % 16)
        return (int)cudaErrorInvalidValue;
    const int* tab = static_cast<const int*>(tables);
    const int* tt = static_cast<const int*>(t);
    float* pm = static_cast<float*>(part_m);
    float* pl = static_cast<float*>(part_l);
    float* pa = static_cast<float*>(part_acc);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 1)
        return launch<__nv_bfloat16>(q, kp, vp, wo, tab, tt, pm, pl, pa, out, B, E, bs, H, Hkv,
                                     hd, D, n_split, rows, grid, scale, window, st);
    return launch<float>(q, kp, vp, wo, tab, tt, pm, pl, pa, out, B, E, bs, H, Hkv, hd, D,
                         n_split, rows, grid, scale, window, st);
}
