// Fused decode tail for Hopper (sm_90a): paged decode attention for all
// query heads of every slot followed by the attention output projection,
// in ONE launch.
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
// about 7.3 MB / 3.35 TB/s, near 2.2 us.  At that size a call is bound by
// the latency of its chain: the table, the K/V rows, the merge, the
// projection.
//
// What the design does about it:
//  * the TPU kernel walks (slot, table entry) in sequence with all of wo
//    resident in VMEM and folds the projection into its last step.  Here
//    the launch is cooperative (every block resident at once) and runs in
//    three steps:
//      1. work item (slot, kv head, split): the paged decode body of
//         decode_body.cuh, as paged_decode_attention.cu runs it (mma.sync
//         products with the group as the rows, fed by a cp.async gather
//         through the block table);
//      2. the splits of a (slot, kv head) meet at their barrier and each
//         merges its share of the group's contexts, in split order,
//         rounded to q's dtype, into a (B, H*hd) scratch in global memory
//         (24 KB at the path's shapes: it stays in L2).  Every record is
//         read once per call;
//      3. after a grid-wide barrier (a count that the launch reads at its
//         start, so the call stays graph-capturable), projection items over 8-column tiles of
//         D for ALL slots at once: out[:, d0:d0+8] = ctx wo[:, d0:d0+8] by
//         mma.sync with the slots as rows (16 per row tile), the warps
//         splitting H*hd and adding their parts in warp order, f32
//         accumulation, cast to q's dtype.
//    Each block requests its first wo tile into shared memory by TMA at its
//    start, before step 1, so the wo read (most of the call's bytes)
//    overlaps steps 1-2, and every element of wo is read once per call.
//    The contexts pass through no other memory, nothing is atomic in
//    floating point, and the result does not depend on the schedule.
//  * the contexts are rounded to q's dtype before the f32-accumulated
//    projection, as the plain version (the JAX semantics of record) does,
//    so the fused and unfused paths compute the same function.  A slot
//    with no visible key projects a zero context.
//  * head_dim is a runtime value <= 256 and a multiple of 8 (the body is
//    instantiated at 64, 128 and 256, as paged decode's); D is a multiple
//    of 16 bytes of elements.  At the RG-LRU hybrid's local attention (H
//    16 over one kv head, hd 256, D 4096) a slot has 4096 contexts: a wo
//    tile is 16 TMA boxes of 256 rows (64 KB), beside the hd-256 ring (67
//    KB), one block per SM; the 8 slots' (slot, kv head) items split 16
//    ways fill 128 of the 132 resident blocks, and the 512 projection
//    tiles of D take 3 or 4 a block.  A call must read the window's 2048
//    K/V rows a slot (16.8 MB for 8 slots, or less where slots share
//    blocks) and wo once (33.6 MB): ~15 us at 3.35 TB/s.
// f32 inputs (the CPU-parity dtype, not the serving one) take the body's
// CUDA-core products, the same merge, and a CUDA-core projection that
// reads wo from global memory after the barrier.

#include "decode_body.cuh"

namespace {

using namespace dec;

constexpr int MAX_H = 64;        // query heads
constexpr int MAX_K = 8192;      // H * hd: contexts of a slot
constexpr int TN = 8;            // output columns per projection tile
constexpr int BOXR = 256;        // rows of wo per TMA box (the most a box takes)
constexpr int U = 12;            // k pairs of A fragments a warp loads at once

// shared memory of the bf16 kernel for contexts of K values: the paged
// split's, then the wo tile (K rows of TN columns, whole boxes, 128-byte
// aligned), then the tile's mbarrier
template <int HD>
struct FusedGeom {
    static constexpr size_t WO = (PagedGeom<HD, __nv_bfloat16>::bytes + 127) / 128 * 128;
    __host__ __device__ static size_t wo_bytes(int K) {
        return (size_t)(K + BOXR - 1) / BOXR * BOXR * TN * 2;
    }
    static size_t bytes(int K) { return WO + wo_bytes(K) + 16; }
};

// step 1-2 for every item of this block: (slot, kv head, split) items in
// that order, at most one per block when n_split > 1
template <int HD, typename T>
__device__ __forceinline__ void split_items(const T* q, const T* kp, const T* vp,
                                            const int* tables, const int* t, T* ctx,
                                            float* part, unsigned long long* counts, int B,
                                            int E, int bs, int H, int Hkv, int kv_row, int hd,
                                            int n_split, float scale_log2, int window,
                                            unsigned char* smem, int tid) {
    for (int item = blockIdx.x; item < B * Hkv * n_split; item += gridDim.x) {
        const int split = item % n_split, kh = (item / n_split) % Hkv;
        const int b = item / (n_split * Hkv);
        const unsigned long long base =
            tid == 0 && n_split > 1 ? count_base(counts + b * Hkv + kh, n_split) : 0ull;
        __syncthreads();   // the previous item's readers of shared memory are done
        paged_split<HD>(q, kp, vp, tables, t[b], ctx, part, counts, b, kh, split, E, bs, H, Hkv,
                        kv_row, hd, n_split, scale_log2, window, base, smem, tid);
    }
}

template <int HD>
__global__ void __launch_bounds__(NT, 1)
fused_decode_tail_mma_kernel(const __grid_constant__ CUtensorMap wo_map,
                             const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ kp,
                             const __nv_bfloat16* __restrict__ vp,
                             const int* __restrict__ tables, const int* __restrict__ t,
                             float* __restrict__ part, __nv_bfloat16* __restrict__ ctx,
                             unsigned long long* __restrict__ counts,
                             unsigned long long* __restrict__ grid_count,
                             __nv_bfloat16* __restrict__ out, int B,
                             int E, int bs, int H, int Hkv, int kv_row, int hd, int D,
                             int n_split, float scale_log2, int window) {
    using FG = FusedGeom<HD>;
    extern __shared__ __align__(128) unsigned char smem[];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int K = H * hd;
    const int n_tiles = D / TN;
    const uint32_t wo_bytes = (uint32_t)FG::wo_bytes(K);
    const uint32_t swo = smem_u32(smem + FG::WO);
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem + FG::WO + wo_bytes);
    // the grid-wide barrier's base: only barriers of gridDim.x blocks
    // advance its count
    const unsigned long long gbase = tid == 0 ? count_base(grid_count, gridDim.x) : 0ull;
    auto request = [&](int tile) {   // by thread 0: wo[:, tile TN : (tile + 1) TN] by TMA
        attn::mbar_expect_tx(bar, wo_bytes);
        for (int r = 0; r < K; r += BOXR)
            attn::tma_load_2d(swo + r * TN * 2, &wo_map, bar, tile * TN, r);
    };
    if (tid == 0 && blockIdx.x < n_tiles) {   // the first wo tile overlaps steps 1-2
        attn::mbar_init(bar, 1);
        attn::mbar_init_fence();
        request(blockIdx.x);
    }
    split_items<HD>(q, kp, vp, tables, t, ctx, part, counts, B, E, bs, H, Hkv, kv_row, hd,
                    n_split, scale_log2, window, smem, tid);
    __syncthreads();   // this block's contexts are written; then every block's
    if (tid == 0) count_barrier(grid_count, gbase, gridDim.x);
    __syncthreads();

    // out[r0 + row, d0 + c] for row tiles of 16 slots: warp w adds the k
    // pairs (32 contexts) w, w + 4, ...  The order of k inside a pair is
    // free as long as A and B agree, so each thread reads its A fragments
    // of both k16 steps as ONE 16-byte load of the context scratch (L2):
    // thread quad's 8 contexts 8 quad .. 8 quad + 7 stand for columns 2 quad
    // + {0, 1}, 2 quad + 8 + {0, 1} of step 0, then the same of step 1; the
    // B fragments come by ldmatrix.trans from the wo tile rows of the same
    // contexts (lane l of matrix m = l / 8 names row `perm`; rows of 16
    // bytes, so a matrix's eight rows fall in distinct banks).  The two
    // steps accumulate apart, halving the chain of dependent products.
    const int quad = lane & 3, row = lane >> 2;
    const int n_pairs = (K + 31) / 32;
    const int perm = 8 * ((lane & 7) >> 1) + 4 * ((lane >> 4) & 1) + 2 * ((lane >> 3) & 1)
                     + (lane & 1);
    float* red = reinterpret_cast<float*>(smem);   // NWARP x 16 x TN, in the ring
    int it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
        if (it > 0) {
            __syncthreads();   // every warp is done with the previous tile
            if (tid == 0) {
                attn::fence_proxy_async();
                request(tile);
            }
        }
        attn::mbar_wait(bar, it & 1);
        const int d0 = tile * TN;
        for (int r0 = 0; r0 < B; r0 += 16) {
            float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
            for (int p0 = warp; p0 < n_pairs; p0 += NWARP * U) {
                uint4 a[U][2];      // rows row, row + 8
#pragma unroll
                for (int u = 0; u < U; ++u)
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const int r = r0 + row + 8 * h;
                        const int c = 32 * (p0 + NWARP * u) + 8 * quad;
                        a[u][h] = r < B && c < K
                                      ? __ldcg(reinterpret_cast<const uint4*>(
                                            ctx + (size_t)r * K + c))
                                      : make_uint4(0u, 0u, 0u, 0u);
                    }
#pragma unroll
                for (int u = 0; u < U; ++u) {
                    const int p = p0 + NWARP * u;
                    if (p < n_pairs) {
                        uint32_t bf[4];
                        ldsm_x4_trans(swo + (32 * p + perm) * TN * 2, bf);
                        const uint32_t f0[4] = {a[u][0].x, a[u][1].x, a[u][0].y, a[u][1].y};
                        const uint32_t f1[4] = {a[u][0].z, a[u][1].z, a[u][0].w, a[u][1].w};
                        mma_bf16(acc[0], f0, bf[0], bf[1]);
                        mma_bf16(acc[1], f1, bf[2], bf[3]);
                    }
                }
            }
            __syncthreads();   // the previous row tile's sums are read
            float* rw = red + warp * 16 * TN;
            rw[row * TN + 2 * quad] = acc[0][0] + acc[1][0];
            rw[row * TN + 2 * quad + 1] = acc[0][1] + acc[1][1];
            rw[(row + 8) * TN + 2 * quad] = acc[0][2] + acc[1][2];
            rw[(row + 8) * TN + 2 * quad + 1] = acc[0][3] + acc[1][3];
            __syncthreads();
            const int r = tid / TN, c = tid % TN;
            if (r < 16 && r0 + r < B) {
                float s = 0.f;
#pragma unroll
                for (int w = 0; w < NWARP; ++w) s += red[(w * 16 + r) * TN + c];
                out[(size_t)(r0 + r) * D + d0 + c] = __float2bfloat16(s);
            }
        }
    }
}

template <int HD>
__global__ void __launch_bounds__(NT, 2)
fused_decode_tail_f32_kernel(const float* __restrict__ q, const float* __restrict__ kp,
                             const float* __restrict__ vp, const float* __restrict__ wo,
                             const int* __restrict__ tables, const int* __restrict__ t,
                             float* __restrict__ part, float* __restrict__ ctx,
                             unsigned long long* __restrict__ counts,
                             unsigned long long* __restrict__ grid_count,
                             float* __restrict__ out, int B, int E,
                             int bs, int H, int Hkv, int kv_row, int hd, int D, int n_split,
                             float scale_log2, int window) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int tid = threadIdx.x;
    const int K = H * hd;
    // the grid-wide barrier's base: only barriers of gridDim.x blocks
    // advance its count
    const unsigned long long gbase = tid == 0 ? count_base(grid_count, gridDim.x) : 0ull;
    split_items<HD>(q, kp, vp, tables, t, ctx, part, counts, B, E, bs, H, Hkv, kv_row, hd,
                    n_split, scale_log2, window, smem, tid);
    __syncthreads();   // this block's contexts are written; then every block's
    if (tid == 0) count_barrier(grid_count, gbase, gridDim.x);
    __syncthreads();

    // out[b, d0 + c]: thread (part = tid / TN, c = tid % TN) sums the
    // contexts part, part + 16, ...; the 16 parts are added in order
    constexpr int PARTS = NT / TN;
    float* red = reinterpret_cast<float*>(smem);
    const int pp = tid / TN, c = tid % TN;
    for (int tile = blockIdx.x; tile < (D + TN - 1) / TN; tile += gridDim.x) {
        const int d = tile * TN + c;
        for (int b = 0; b < B; ++b) {
            float s = 0.f;
            if (d < D)
                for (int k = pp; k < K; k += PARTS)
                    s += __ldcg(ctx + (size_t)b * K + k) * wo[(size_t)k * D + d];
            __syncthreads();   // the previous slot's parts are read
            red[pp * TN + c] = s;
            __syncthreads();
            if (tid < TN && d < D) {
                float sum = 0.f;
                for (int j = 0; j < PARTS; ++j) sum += red[j * TN + c];
                out[(size_t)b * D + d] = sum;
            }
        }
    }
}

// One instantiation's kernel and shared memory.  The opt-in to the most
// shared memory it can take (contexts of MAX_K values) is made once per
// device; a launch takes what its K needs.
template <typename T, int HD>
struct Kernel {
    static constexpr bool BF16 = sizeof(T) == 2;
    static size_t smem(int K) {
        return BF16 ? FusedGeom<HD>::bytes(K) : PagedGeom<HD, float>::bytes;
    }
    static const void* fn() {
        if constexpr (BF16) return (const void*)fused_decode_tail_mma_kernel<HD>;
        else return (const void*)fused_decode_tail_f32_kernel<HD>;
    }
    static cudaError_t prepare() {
        static std::atomic<unsigned long long> done{0};
        return opt_in(fn(), smem(MAX_K), done);
    }
};

template <typename T, int HD>
cudaError_t capacity(int K, int* blocks) {
    using Kn = Kernel<T, HD>;
    cudaError_t err = Kn::prepare();
    if (err != cudaSuccess) return err;
    return resident_blocks(Kn::fn(), Kn::smem(K), blocks);
}

// A tensor map over wo (K, D) bf16 as (D, K), boxes of TN columns x BOXR
// rows, no swizzle; rows past K read as zeros.
bool wo_map(CUtensorMap* map, const void* wo, int K, int D) {
    attn::EncodeTiled enc = attn::encoder();
    if (enc == nullptr) return false;
    const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)K};
    const cuuint64_t strides[1] = {(cuuint64_t)D * 2};
    const cuuint32_t box[2] = {TN, BOXR};
    const cuuint32_t unit[2] = {1, 1};
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(wo), dims, strides,
               box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE)
           == CUDA_SUCCESS;
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* kp, const void* vp, const void* wo,
                   const int* tables, const int* t, float* part, void* ctx,
                   unsigned long long* counts,
                   unsigned long long* grid_count, void* out, int B, int E, int bs, int H,
                   int Hkv, int kv_row, int hd, int D, int n_split,
                   int grid, float scale, int window, cudaStream_t stream) {
    using Kn = Kernel<T, HD>;
    cudaError_t err = Kn::prepare();
    if (err != cudaSuccess) return err;
    const T* q_ = static_cast<const T*>(q);
    const T* kp_ = static_cast<const T*>(kp);
    const T* vp_ = static_cast<const T*>(vp);
    const T* wo_ = static_cast<const T*>(wo);
    T* ctx_ = static_cast<T*>(ctx);
    T* out_ = static_cast<T*>(out);
    const float scale_log2 = scale * LOG2E;
    const size_t smem = Kn::smem(H * hd);
    if constexpr (Kn::BF16) {
        CUtensorMap map;
        if (!wo_map(&map, wo, H * hd, D)) return cudaErrorInvalidValue;
        void* args[] = {(void*)&map,  (void*)&q_,    (void*)&kp_,      (void*)&vp_,
                        (void*)&tables, (void*)&t,   (void*)&part,     (void*)&ctx_,
                        (void*)&counts, (void*)&grid_count, (void*)&out_, (void*)&B, (void*)&E,
                        (void*)&bs,   (void*)&H,     (void*)&Hkv,      (void*)&kv_row,
                        (void*)&hd,   (void*)&D,     (void*)&n_split,  (void*)&scale_log2,
                        (void*)&window};
        err = cudaLaunchCooperativeKernel(Kn::fn(), dim3(grid), dim3(NT), args, smem, stream);
    } else {
        void* args[] = {(void*)&q_,   (void*)&kp_,   (void*)&vp_,      (void*)&wo_,
                        (void*)&tables, (void*)&t,   (void*)&part,     (void*)&ctx_,
                        (void*)&counts, (void*)&grid_count, (void*)&out_, (void*)&B, (void*)&E,
                        (void*)&bs,   (void*)&H,     (void*)&Hkv,      (void*)&kv_row,
                        (void*)&hd,   (void*)&D,     (void*)&n_split,  (void*)&scale_log2,
                        (void*)&window};
        err = cudaLaunchCooperativeKernel(Kn::fn(), dim3(grid), dim3(NT), args, smem, stream);
    }
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

bool takes(int H, int Hkv, int hd, int dtype) {
    return Hkv > 0 && H % Hkv == 0 && H / Hkv <= MAX_GROUP && H <= MAX_H && hd > 0 && hd <= 256
           && hd % 8 == 0 && H * hd <= MAX_K && (dtype == 0 || dtype == 1);
}

}  // namespace

// The most blocks one launch may take on the current device for these
// widths (dtype 0 = float32, 1 = bfloat16).  Returns the CUDA error (0 =
// success).
extern "C" int fused_decode_tail_capacity(int H, int Hkv, int hd, int dtype, int* blocks) {
    if (!takes(H, Hkv, hd, dtype)) return (int)cudaErrorInvalidValue;
    const int K = H * hd;
    if (dtype == 1) return (int)(hd <= 64    ? capacity<__nv_bfloat16, 64>(K, blocks)
                                 : hd <= 128 ? capacity<__nv_bfloat16, 128>(K, blocks)
                                             : capacity<__nv_bfloat16, 256>(K, blocks));
    return (int)(hd <= 64    ? capacity<float, 64>(K, blocks)
                 : hd <= 128 ? capacity<float, 128>(K, blocks)
                             : capacity<float, 256>(K, blocks));
}

// q: (B, H, hd); k_pool, v_pool: (N, bs, Hkv, hd) at a row stride of
// kv_row >= Hkv heads (decode_attention_fwd's); wo: (H*hd, D), 16-byte
// aligned; tables: (B, E) int32 (-1 = unbound); t: (B,) int32; out: (B,
// D) in q's dtype.  Scratch: part, B * Hkv * n_split records of
// record_floats(group, HDw) f32 (HDw = 64 for hd <= 64, 128 for hd <= 128,
// else 256; unused
// when n_split is 1) and ctx, B * H * hd in q's dtype, both 16-byte
// aligned; counts: B * Hkv 64-bit counts that only launches of n_split
// splits advance (the split barriers'; may be null when n_split is 1);
// grid_count: one that only launches of `grid` blocks advance (the grid
// barrier's; count_barrier in decode_body.cuh).  dtype: 0 = float32,
// 1 = bfloat16.  hd <= 256 and a multiple of 8; D a multiple of 16 bytes
// of elements; group = H / Hkv <= 16; H <= 64; H * hd <= 8192; 1 <=
// n_split <= min(ceil(E bs / 16), MAX_SPLIT); grid blocks, at most
// fused_decode_tail_capacity's and, with n_split > 1, at least B * Hkv *
// n_split.  Returns the CUDA error (0 = success).
extern "C" int fused_decode_tail_fwd(const void* q, const void* kp, const void* vp,
                                     const void* wo, const void* tables, const void* t,
                                     void* part, void* ctx, void* counts, void* grid_count,
                                     void* out, int B, int E, int bs, int H, int Hkv,
                                     int kv_row, int hd, int D, int dtype, int n_split, int grid,
                                     float scale, int window, void* stream) {
    float* pt = static_cast<float*>(part);
    if (!takes(H, Hkv, hd, dtype) || kv_row < Hkv || B <= 0 || E <= 0 || bs <= 0 || D <= 0
        || D % (dtype == 1 ? 8 : 4) || n_split < 1 || n_split > MAX_SPLIT
        || (long long)n_split * TILE > (long long)E * bs + 15 || grid < 1
        || (n_split > 1 && ((long long)B * Hkv * n_split > grid || pt == nullptr
                            || reinterpret_cast<uintptr_t>(pt) % 16))
        || grid_count == nullptr || reinterpret_cast<uintptr_t>(grid_count) % 8 || reinterpret_cast<uintptr_t>(ctx) % 16
        || reinterpret_cast<uintptr_t>(wo) % 16)
        return (int)cudaErrorInvalidValue;
    const int* tab = static_cast<const int*>(tables);
    const int* tt = static_cast<const int*>(t);
    auto* cnt = static_cast<unsigned long long*>(counts);
    auto* gc = static_cast<unsigned long long*>(grid_count);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FUSED_CASE(CODE, T, HD)                                                               \
    if (dtype == CODE && hd <= HD)                                                             \
        return (int)launch<T, HD>(q, kp, vp, wo, tab, tt, pt, ctx, cnt, gc, out, B, E, bs, H,  \
                                  Hkv, kv_row, hd, D, n_split, grid, scale, window, st);
    FUSED_CASE(1, __nv_bfloat16, 64)
    FUSED_CASE(1, __nv_bfloat16, 128)
    FUSED_CASE(1, __nv_bfloat16, 256)
    FUSED_CASE(0, float, 64)
    FUSED_CASE(0, float, 128)
    FUSED_CASE(0, float, 256)
#undef FUSED_CASE
    return (int)cudaErrorInvalidValue;
}
