// Paged decode attention for Hopper (sm_90a): one query token per slot
// against a global pool of fixed-size KV blocks, addressed through each
// slot's block table, as flash-decoding with a split over table entries.
//
// Replaces: src/repro/kernels/paged_decode_attention.py::
// paged_decode_attention_pallas (the Pallas TPU kernel behind
// repro.kernels.ops.paged_decode_attention).
// Plain version: src/repro_torch/kernels/ref.py::paged_decode_attention.
//
// What bounds it on the H100: memory.  Each call must read every visible
// K and V row once (positions <= t of the slot's bound entries; a pool
// block that several slots share, once) and does 4 FLOP per row element
// and q head of the group, far below the card's ~295 FLOP/byte balance
// point.  At the paged engine's shapes (B=8 slots in 2 groups of 4 that
// share their first 16 blocks, E=48 entries of bs=16, Hkv=2, hd=128,
// bf16, t in [256, 768)) that is about 2.6 MB of distinct rows per call
// and layer: a bound near 0.8 us at 3.35 TB/s.  The kernel reads a
// shared row once per slot, the later reads mostly from L2.
//
// What the design does about it:
//  * the TPU kernel walks (slot, q head, table entry) with the entry axis
//    sequential, and its index map streams the pool block that
//    tables[b, e] names.  Here the grid is (entry split, kv head, slot):
//    each block loads its own block ids from the table, stages the K/V
//    rows of its run of entries in shared memory with 16-byte loads, and
//    applies them to all query heads of the kv head's group, so each row
//    is read once per call.  The wrapper picks the split so that the grid
//    holds about two blocks per SM.  A thread scores a whole key row for
//    its share of the heads, so no step reduces across lanes.  The
//    split's body is common.cuh::split_state, which the fused decode
//    tail's first phase runs too.
//  * key positions are implicit (entry e holds [e*bs, (e+1)*bs)), and a
//    row is visible iff its entry is bound, its position <= t and, with a
//    window, > t - window.  Rows that are not visible are never read from
//    the pool (an unbound entry, -1, is never dereferenced) and are staged
//    as zeros; a split with no visible row does no loads at all.  The
//    block ids go to shared memory first, so a thread's K/V loads depend
//    on no other global load and are all in flight at once.
//  * each split writes its partial softmax state (m, l, acc) in f32 to
//    scratch that the wrapper allocates; a second kernel merges the splits
//    with the TPU kernel's max(l, 1e-30) clamp, so a slot with no visible
//    key (an inactive row) comes out 0, not NaN.
//  * head_dim is a runtime value <= 128 and a multiple of 8.

#include "common.cuh"

namespace {

using namespace paged;

constexpr int NT = 128;          // threads per block: one per output column
constexpr int MAX_HD = 128;
constexpr int MAX_GROUP = 16;
constexpr int MAX_ROWS = 64;     // key rows per split, staged whole

// grid (n_split, Hkv, B): split `split` of slot b, kv head kh, covers the
// eps entries from split * eps.  Partial state index (b * n_split +
// split) * H + h, the layout of the fused decode tail's.
template <typename T>
__global__ void __launch_bounds__(NT)
paged_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                          const T* __restrict__ vp, const int* __restrict__ tables,
                          const int* __restrict__ t, float* __restrict__ part_m,
                          float* __restrict__ part_l, float* __restrict__ part_acc, int E,
                          int bs, int H, int Hkv, int hd, int eps, float scale, int window) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int split = blockIdx.x;
    const int kh = blockIdx.y;
    const int b = blockIdx.z;
    const int group = H / Hkv;
    const size_t pidx = ((size_t)b * gridDim.x + split) * H + (size_t)kh * group;
    split_state<NT, MAX_ROWS, 8, MAX_GROUP>(
        smem, q + ((size_t)b * H + (size_t)kh * group) * hd, kp, vp, tables + (size_t)b * E, E,
        bs, Hkv, kh, group, hd, split * eps * bs, eps * bs, t[b], scale, window, part_m + pidx,
        part_l + pidx, part_acc + pidx * hd, threadIdx.x);
}

// grid (H, B): merge the splits of one (slot, q head); thread d.
template <typename T>
__global__ void __launch_bounds__(NT)
paged_decode_combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                            const float* __restrict__ part_acc, T* __restrict__ out, int H,
                            int hd, int n_split) {
    const int h = blockIdx.x;
    const int b = blockIdx.y;
    const int tid = threadIdx.x;
    if (tid >= hd) return;
    const size_t base = (size_t)b * n_split * H + h;
    float mx = NEG_INF;
#pragma unroll 8
    for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, part_m[base + (size_t)s * H]);
    float l = 0.f, a = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_split; ++s) {
        const size_t i = base + (size_t)s * H;
        const float c = expf(part_m[i] - mx);
        l += c * part_l[i];
        a += c * part_acc[i * hd + tid];
    }
    out[((size_t)b * H + h) * hd + tid] = from_f32<T>(a / fmaxf(l, 1e-30f));
}

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp, const int* tables,
                   const int* t, float* part_m, float* part_l, float* part_acc, void* out,
                   int B, int E, int bs, int H, int Hkv, int hd, int eps, int n_split,
                   float scale, int window, cudaStream_t stream) {
    const size_t smem = split_smem<MAX_ROWS, T>(hd, H / Hkv);
    cudaError_t err = cudaFuncSetAttribute(paged_decode_split_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid1(n_split, Hkv, B);
    paged_decode_split_kernel<T><<<grid1, NT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), tables,
        t, part_m, part_l, part_acc, E, bs, H, Hkv, hd, eps, scale, window);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    dim3 grid2(H, B);
    paged_decode_combine_kernel<T><<<grid2, NT, 0, stream>>>(part_m, part_l, part_acc,
                                                             static_cast<T*>(out), H, hd,
                                                             n_split);
    return cudaGetLastError();
}

}  // namespace

// q: (B, H, hd); k_pool, v_pool: (N, bs, Hkv, hd); tables: (B, E) int32
// (-1 = unbound); t: (B,) int32; part_m, part_l: (B, n_split, H) f32;
// part_acc: (B, n_split, H, hd) f32; out like q.  dtype:
// 0 = float32, 1 = bfloat16.  hd <= 128 and a multiple of 8; group =
// H / Hkv <= 16; eps entries per split with eps * bs <= 64 and eps *
// n_split >= E.  Returns the CUDA error (0 = success).
extern "C" int paged_decode_attention_fwd(const void* q, const void* kp, const void* vp,
                                          const void* tables, const void* t, void* part_m,
                                          void* part_l, void* part_acc, void* out, int B, int E,
                                          int bs, int H, int Hkv, int hd, int dtype, int eps,
                                          int n_split, float scale, int window, void* stream) {
    if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > MAX_GROUP || hd <= 0 || hd > MAX_HD || hd % 8
        || eps <= 0 || eps * bs > MAX_ROWS || (long long)eps * n_split < E)
        return (int)cudaErrorInvalidValue;
    const int* tab = static_cast<const int*>(tables);
    const int* tt = static_cast<const int*>(t);
    float* pm = static_cast<float*>(part_m);
    float* pl = static_cast<float*>(part_l);
    float* pa = static_cast<float*>(part_acc);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 1)
        return launch<__nv_bfloat16>(q, kp, vp, tab, tt, pm, pl, pa, out, B, E, bs, H, Hkv, hd,
                                     eps, n_split, scale, window, st);
    if (dtype == 0)
        return launch<float>(q, kp, vp, tab, tt, pm, pl, pa, out, B, E, bs, H, Hkv, hd, eps,
                             n_split, scale, window, st);
    return (int)cudaErrorInvalidValue;
}
