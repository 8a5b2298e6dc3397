// Paged decode attention for Hopper (sm_90a): one query token per slot
// against a global pool of fixed-size KV blocks, addressed through each
// slot's block table, as flash-decoding in one launch.
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
// and layer: a bound near 0.8 us at 3.35 TB/s.  At that size the call is
// bound by latency: one launch, the block table's round trip before the
// rows', and the merge of the splits.  At the RG-LRU hybrid's local
// attention (head_dim 256, a group of 16 over one kv head, a window of
// 2048) a call reads at most the window's 2048 rows a slot, 2 MB in bf16
// for 8 slots: ~0.6 us at 3.35 TB/s.
//
// What the design does about it:
//  * the TPU kernel walks (slot, q head, table entry) with the entry axis
//    sequential, and its index map streams the pool block that
//    tables[b, e] names.  Here the grid is (split, kv head, slot): a split
//    is a whole number of 16-key tiles of the slot's positions [0, E bs),
//    planned by the wrapper from the shapes alone; its block reads the
//    split's visible K and V rows once and applies them to all query heads
//    of the kv head's group.  Tiles wholly past t or before the window are
//    dropped with no loads, so a split may have nothing to do.
//  * the body is decode_body.cuh's, which ring decode attention runs too:
//    mma.sync products with the group as the 16 rows, fed by a two-stage
//    cp.async ring.  Its rows come from a paged source: the block ids of
//    the split's entries go to shared memory first, then each K/V row
//    arrives by a 16-byte cp.async from pool block sblk[p / bs - e0] at
//    offset p % bs, so any block size works and a tile may span blocks.
//    Rows of an unbound entry (-1) or past t are zero-filled (source size
//    0), never dereferenced, and masked by position.  head_dim is a runtime
//    value <= 256 and a multiple of 8: the body is instantiated at 64, 128
//    and 256 (ring decode's widths) and zero-pads a narrower row in shared
//    memory only.  At 256 two warps share a 16-key tile, each owning half
//    the output columns, and a ring stage holds 32 keys: the block ids of
//    a stage span at most 32 entries, well inside the NBLK ids the source
//    keeps in shared memory.
//  * one launch per call: the splits of a (slot, kv head) write f32
//    records, meet at a barrier (a count that only launches of as many
//    splits advance, so nothing resets it), and each
//    merges its share of the output in split order (no float atomics: two
//    calls give the same bits; a call captured in a CUDA graph replays).
//    A launch with more than one split is cooperative and stays within
//    the resident grid; with one split the block writes its output.  A
//    slot with no visible key comes out 0 (the TPU kernel's max(l, 1e-30)
//    clamp), not NaN.
// f32 inputs (the CPU-parity dtype, not the serving one) take the body's
// CUDA-core products and the same merge.

#include "decode_body.cuh"

namespace {

using namespace dec;

// grid (n_split, Hkv, B): split `split` of slot b, kv head kh
template <int HD, typename T>
__global__ void __launch_bounds__(NT, 2)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
                    const int* __restrict__ tables, const int* __restrict__ t,
                    T* __restrict__ out, float* __restrict__ part,
                    unsigned long long* __restrict__ counts,
                    int E, int bs, int H, int Hkv, int kv_row, int hd, int n_split,
                    float scale_log2, int window) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x;
    const unsigned long long base =
        tid == 0 && n_split > 1 ? count_base(counts + b * Hkv + kh, n_split) : 0ull;
    paged_split<HD>(q, kp, vp, tables, t[b], out, part, counts, b, kh, split, E, bs, H, Hkv,
                    kv_row, hd, n_split, scale_log2, window, base, smem, tid);
}

// One instantiation's kernel and shared memory; its opt-in to that much
// shared memory is made once per device.
template <typename T, int HD>
struct Kernel {
    static constexpr size_t smem = PagedGeom<HD, T>::bytes;
    static const void* fn() { return (const void*)paged_decode_kernel<HD, T>; }
    static cudaError_t prepare() {
        static std::atomic<unsigned long long> done{0};
        return opt_in(fn(), smem, done);
    }
};

template <typename T, int HD>
cudaError_t capacity(int* blocks) {
    using K = Kernel<T, HD>;
    cudaError_t err = K::prepare();
    if (err != cudaSuccess) return err;
    return resident_blocks(K::fn(), K::smem, blocks);
}

// One split: a plain launch.  More: a cooperative launch, which refuses a
// grid that cannot be resident all at once.
template <typename T, int HD>
cudaError_t launch(const void* q, const void* kp, const void* vp, const int* tables,
                   const int* t, void* out, float* part, unsigned long long* counts, int B,
                   int E, int bs,
                   int H, int Hkv, int kv_row, int hd, int n_split, float scale, int window,
                   cudaStream_t stream) {
    using K = Kernel<T, HD>;
    cudaError_t err = K::prepare();
    if (err != cudaSuccess) return err;
    const T* q_ = static_cast<const T*>(q);
    const T* kp_ = static_cast<const T*>(kp);
    const T* vp_ = static_cast<const T*>(vp);
    T* out_ = static_cast<T*>(out);
    const float scale_log2 = scale * LOG2E;
    void* args[] = {(void*)&q_,  (void*)&kp_,     (void*)&vp_,  (void*)&tables,
                    (void*)&t,   (void*)&out_,    (void*)&part, (void*)&counts,
                    (void*)&E,   (void*)&bs,      (void*)&H,    (void*)&Hkv,
                    (void*)&kv_row, (void*)&hd,   (void*)&n_split, (void*)&scale_log2,
                    (void*)&window};
    const dim3 grid(n_split, Hkv, B);
    err = n_split == 1 ? cudaLaunchKernel(K::fn(), grid, dim3(NT), args, K::smem, stream)
                       : cudaLaunchCooperativeKernel(K::fn(), grid, dim3(NT), args, K::smem,
                                                     stream);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

}  // namespace

// The most blocks a call with n_split > 1 may launch on the current
// device: dtype 0 = float32, 1 = bfloat16; the body's width for hd (64
// up to 64, 128 up to 128, else 256).  Returns the CUDA error (0 =
// success).
extern "C" int paged_decode_attention_capacity(int hd, int dtype, int* blocks) {
    if (hd <= 0 || hd > 256) return (int)cudaErrorInvalidValue;
    if (dtype == 1) return (int)(hd <= 64    ? capacity<__nv_bfloat16, 64>(blocks)
                                 : hd <= 128 ? capacity<__nv_bfloat16, 128>(blocks)
                                             : capacity<__nv_bfloat16, 256>(blocks));
    if (dtype == 0) return (int)(hd <= 64    ? capacity<float, 64>(blocks)
                                 : hd <= 128 ? capacity<float, 128>(blocks)
                                             : capacity<float, 256>(blocks));
    return (int)cudaErrorInvalidValue;
}

// q: (B, H, hd); k_pool, v_pool: (N, bs, Hkv, hd) at a row stride of
// kv_row >= Hkv heads (decode_attention_fwd's); tables: (B, E) int32
// (-1 = unbound); t: (B,) int32; out like q.  part: B * Hkv * n_split
// records of record_floats(group, HDw) f32 (HDw = 64 for hd <= 64, 128 for
// hd <= 128, else 256), 16-byte aligned, and counts: B * Hkv 64-bit counts that only
// launches of n_split splits advance (count_barrier's); both unused, and
// may be null, when n_split is 1.  dtype: 0 = float32, 1 = bfloat16; hd <= 256
// and a multiple of 8; group = H / Hkv <= 16; 1 <= n_split <= min(ceil(E
// bs / 16), MAX_SPLIT), and with n_split > 1 at most
// paged_decode_attention_capacity blocks.  Returns the CUDA error (0 =
// success).
extern "C" int paged_decode_attention_fwd(const void* q, const void* kp, const void* vp,
                                          const void* tables, const void* t, void* part,
                                          void* counts, void* out, int B, int E, int bs, int H,
                                          int Hkv, int kv_row, int hd, int dtype, int n_split,
                                          float scale, int window, void* stream) {
    const int* tab = static_cast<const int*>(tables);
    const int* tt = static_cast<const int*>(t);
    float* pt = static_cast<float*>(part);
    auto* cnt = static_cast<unsigned long long*>(counts);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (Hkv <= 0 || kv_row < Hkv || H % Hkv != 0 || H / Hkv > MAX_GROUP || hd <= 0 || hd > 256
        || hd % 8 || E <= 0 || bs <= 0 || n_split < 1 || (long long)n_split * TILE > (long long)E * bs + 15
        || n_split > MAX_SPLIT
        || (n_split > 1 && (pt == nullptr || cnt == nullptr
                            || reinterpret_cast<uintptr_t>(pt) % 16)))
        return (int)cudaErrorInvalidValue;
#define PAGED_CASE(CODE, T, HD)                                                               \
    if (dtype == CODE && hd <= HD)                                                             \
        return (int)launch<T, HD>(q, kp, vp, tab, tt, out, pt, cnt, B, E, bs, H, Hkv, kv_row,  \
                                  hd, n_split, scale, window, st);
    PAGED_CASE(1, __nv_bfloat16, 64)
    PAGED_CASE(1, __nv_bfloat16, 128)
    PAGED_CASE(1, __nv_bfloat16, 256)
    PAGED_CASE(0, float, 64)
    PAGED_CASE(0, float, 128)
    PAGED_CASE(0, float, 256)
#undef PAGED_CASE
    return (int)cudaErrorInvalidValue;
}
