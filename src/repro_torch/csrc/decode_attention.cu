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
//    barrier (a 64-bit count that only launches of as many splits advance,
//    so nothing resets it), and each merges its own 1/n_split of the group's output over all the records, in split
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
//  * the body, its merge and the row source interface are
//    decode_body.cuh's, which the paged decode kernels share; this file
//    gives it ring rows (RingSrc: row k of the slot's cache, its position
//    from cache_pos);
//    head_dim is a runtime value <= 256 and a multiple of 8, as there: the
//    body is instantiated at 64, 128 and 256 and zero-pads a narrower row
//    (h2o-danube's 80) in shared memory only.
//  * the mask is positional (0 <= pos <= t, and pos > t - window for a
//    window > 0), so ring wrap-around, empty slots (pos = -1) and a ragged
//    W need no special case and the wrapper pads nothing.  A masked key
//    gets probability 0, and a slot with no visible key writes 0 (the
//    max(l, 1e-30) clamp of the TPU kernel).
// f32 inputs (the CPU-parity dtype, not the serving one) take CUDA-core
// products over chunks of 32 keys, a warp per key, and the same merge.

#include "decode_body.cuh"

namespace {

using namespace dec;

// split `split` of slot b, kv head kh: keys [k_lo, k_hi) of the ring
template <int HD>
__global__ void __launch_bounds__(NT, 2)
ring_decode_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
                       const __nv_bfloat16* __restrict__ vc, const int* __restrict__ pos,
                       const int* __restrict__ t, __nv_bfloat16* __restrict__ out,
                       float* __restrict__ part, unsigned long long* __restrict__ counts, int W,
                       int H, int Hkv, int hd,
                       int n_split, float scale_log2, int window) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
    const int group = H / Hkv;
    const int tid = threadIdx.x;
    int k_lo, k_hi;
    split_keys(W, n_split, split, k_lo, k_hi);
    const size_t row_stride = (size_t)Hkv * hd;
    RingSrc<__nv_bfloat16> src{kc + (size_t)b * W * row_stride + (size_t)kh * hd,
                               vc + (size_t)b * W * row_stride + (size_t)kh * hd,
                               pos + (size_t)b * W, row_stride};
    // the barrier's base for this call: nothing waits on the load until the
    // barrier
    const unsigned long long base =
        tid == 0 && n_split > 1 ? count_base(counts + b * Hkv + kh, n_split) : 0ull;
    mma_state<HD>(src, q + ((size_t)b * H + (size_t)kh * group) * hd, group, hd, k_lo, k_hi, t[b],
                  scale_log2, window, smem, tid);
    float* sO = reinterpret_cast<float*>(smem);
    const float* sm = reinterpret_cast<const float*>(smem + Geom<HD>::RING);
    finish_block<HD>(sO, sO, sm, sm + MAX_GROUP, out, part, counts, b, kh, H, Hkv, group, split,
                     n_split, base, hd, tid);
}

// f32: CUDA-core products over chunks of keys, the same split and merge
template <int HD>
__global__ void __launch_bounds__(NT)
ring_decode_f32_kernel(const float* __restrict__ q, const float* __restrict__ kc,
                       const float* __restrict__ vc, const int* __restrict__ pos,
                       const int* __restrict__ t, float* __restrict__ out,
                       float* __restrict__ part, unsigned long long* __restrict__ counts, int W,
                       int H, int Hkv, int hd,
                       int n_split, float scale_log2, int window) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
    const int group = H / Hkv;
    const int tid = threadIdx.x;
    int k_lo, k_hi;
    split_keys(W, n_split, split, k_lo, k_hi);
    const size_t row_stride = (size_t)Hkv * hd;
    RingSrc<float> src{kc + (size_t)b * W * row_stride + (size_t)kh * hd,
                       vc + (size_t)b * W * row_stride + (size_t)kh * hd, pos + (size_t)b * W,
                       row_stride};
    const unsigned long long base =
        tid == 0 && n_split > 1 ? count_base(counts + b * Hkv + kh, n_split) : 0ull;
    f32_state<HD>(src, q + ((size_t)b * H + (size_t)kh * group) * hd, group, hd, k_lo, k_hi, t[b],
                  scale_log2, window, smem, tid);
    const float* sm = reinterpret_cast<const float*>(smem + Geom32<HD>::SM);
    finish_block<HD>(reinterpret_cast<float*>(smem),
                     reinterpret_cast<const float*>(smem) + 2 * CH32 * HD, sm, sm + MAX_GROUP, out,
                     part, counts, b, kh, H, Hkv, group, split, n_split, base, hd, tid);
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
        return opt_in(fn(), smem, done);
    }
};

// blocks of this instantiation that can be resident at once on the
// current device: the most a split launch may take
template <typename T, int HD>
cudaError_t capacity(int* blocks) {
    using K = Kernel<T, HD>;
    cudaError_t err = K::prepare();
    if (err != cudaSuccess) return err;
    return resident_blocks(K::fn(), K::smem, blocks);
}

// One split: a plain launch.  More: a cooperative launch, which refuses a
// grid that cannot be resident all at once, so the splits of a (slot, kv
// head) can wait for each other.
template <typename T, int HD>
cudaError_t launch(const void* q, const void* kc, const void* vc, const int* pos, const int* t,
                   void* out, float* part, unsigned long long* counts, int B, int W, int H,
                   int Hkv, int hd,
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
                    (void*)&t,      (void*)&out_,     (void*)&part,    (void*)&counts,
                    (void*)&W,      (void*)&H,        (void*)&Hkv,     (void*)&hd,
                    (void*)&n_split, (void*)&scale_log2, (void*)&window};
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
extern "C" int decode_attention_capacity(int hd, int dtype, int* blocks) {
    if (hd <= 0 || hd > 256) return (int)cudaErrorInvalidValue;
    if (dtype == 1) return (int)(hd <= 64    ? capacity<__nv_bfloat16, 64>(blocks)
                                 : hd <= 128 ? capacity<__nv_bfloat16, 128>(blocks)
                                             : capacity<__nv_bfloat16, 256>(blocks));
    if (dtype == 0) return (int)(hd <= 64    ? capacity<float, 64>(blocks)
                                 : hd <= 128 ? capacity<float, 128>(blocks)
                                             : capacity<float, 256>(blocks));
    return (int)cudaErrorInvalidValue;
}

// q: (B, H, hd); k_cache, v_cache: (B, W, Hkv, hd); cache_pos: (B, W)
// int32; t: (B,) int32; out like q.  part: B * Hkv * n_split records of
// record_floats(group, HDw) f32 (HDw = 64 for hd <= 64, 128 for hd <=
// 128, else 256), 16-byte aligned, and counts: B * Hkv 64-bit counts that
// only launches of n_split splits advance (count_barrier's); both unused,
// and may be null, when n_split is 1.  dtype: 0 = float32, 1 = bfloat16;
// hd <= 256 and a multiple of 8; group = H / Hkv <= 16; 1 <=
// n_split <= min(ceil(W / 16), MAX_SPLIT), and with n_split > 1 at most
// decode_attention_capacity blocks.  Returns the CUDA error (0 =
// success).
extern "C" int decode_attention_fwd(const void* q, const void* kc, const void* vc,
                                    const void* cache_pos, const void* t, void* part,
                                    void* counts, void* out, int B, int W, int H, int Hkv,
                                    int hd, int dtype, int n_split, float scale, int window,
                                    void* stream) {
    const int* pos = static_cast<const int*>(cache_pos);
    const int* tt = static_cast<const int*>(t);
    float* pt = static_cast<float*>(part);
    auto* cnt = static_cast<unsigned long long*>(counts);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > MAX_GROUP || hd <= 0 || hd > 256 || hd % 8
        || W <= 0 || n_split < 1
        || n_split > (W + TILE - 1) / TILE || n_split > MAX_SPLIT
        || (n_split > 1 && (pt == nullptr || cnt == nullptr
                            || reinterpret_cast<uintptr_t>(pt) % 16)))
        return (int)cudaErrorInvalidValue;
#define DECODE_CASE(CODE, T, HD)                                                              \
    if (dtype == CODE && hd <= HD)                                                             \
        return (int)launch<T, HD>(q, kc, vc, pos, tt, out, pt, cnt, B, W, H, Hkv, hd, n_split, \
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
