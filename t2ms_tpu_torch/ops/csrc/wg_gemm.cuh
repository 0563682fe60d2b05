// Row GEMMs on wgmma for Hopper (sm_90a), bf16 operands, f32 sums:
//
//   out = epilogue(prologue(A) @ W + bias)
//
// for A (rows, K) and W (K, cols) row-major (W in flax's (in, out) layout),
// the products of one adaLN-zero DiT block (dit_split.cu runs its four on
// them; dit_layer.cuh's persistent row kernels build on the primitives
// below: the mbarrier and TMA helpers, the swizzled descriptors, WgSS,
// wg_modln_rows, epi_pair and resid_pair). Prologues: LN stages the
// block's whole K-wide row tile in shared
// memory and replaces it, once, by T(LN(a) * (1 + mod[b, isc]) +
// mod[b, ish]) (f32 statistics, one rounding); STREAM brings A in with W,
// K chunk by K chunk. Epilogues, from the accumulator registers (the
// rounding points of the stack's kernels):
//
//   BIAS   T(acc + f32(T(bias)))
//   GELU   T(gelu_fast(rnd(acc + bias)))  (tanh-GELU from exp(-2u))
//   RESID  T(res + rnd(rnd(T(gate)) * rnd(acc + bias))), gate = mod[b, igate]
//
// mod is (B, 6, width) in f32, width K for LN and cols for RESID; b is a
// row's element (row / N).
//
// Design. A block owns BM = 64 * WG rows and walks the output in
// BN-column steps with WG consumer warpgroups (64 rows each, both on every
// step) and two producer warps, warp-specialised around mbarriers:
// - One producer thread feeds a ring of ST stages of 64 K rows by the
//   tensor memory accelerator (TMA): W in 64-column boxes and, streamed,
//   A; each stage's copies complete on its `full` barrier, and a stage is
//   refilled once every consumer warp has released it on `empty`. For LN
//   it first loads the row tile (its own barrier), which the consumers
//   normalise in place. The second producer thread (RESID) loads each
//   step's residual tile into the output tiles while the step's products
//   run.
// - Both operands reach wgmma through shared-memory descriptors in the
//   128-byte swizzle TMA writes: A K-major (a 64-value K slab is BM rows
//   of 128 bytes, 16-byte chunk c of row r at chunk c ^ (r % 8)), W
//   MN-major (a stage holds BN / 64 slabs of 64 K rows x 128 bytes). A
//   consumer commits one wgmma group (4 x m64nBNk16) a chunk and keeps one
//   in flight while it waits for the next chunk.
// - The sums stay in registers over the K loop. The epilogue reads them in
//   wgmma's accumulator layout into the group's output tile (rounded, the
//   residual added where the tile holds it) and sends the tile out in
//   16-byte chunks, a row's by consecutive threads. The producer keeps
//   filling the ring meanwhile.
// Bounds at the scaled DiT's call (32,768 rows, D 512, hidden 2048; H100
// SXM): the products are 206 GFLOP (0.208 ms at 989 TFLOP/s) against
// 0.58 GB of activations (0.17 ms at 3.35 TB/s), and each block reads the
// whole weight through L2 (qkv: 384 MB in all) and, streamed, its A once
// a column step. No atomics and no split-K: calls repeat bit for bit.
//
// Shared memory: a 1 KB slack to align the swizzle atoms, the staged tile
// (LN: BM * K * 2 bytes), the ring (ST stages of the A chunk, when
// streamed, and the W chunk) and a 64 x BN output tile a group: smem_wg
// below.

#pragma once

#include "attn_heads.cuh"

namespace {

constexpr int WG_BK = 64;       // K depth of a ring stage: 128 bytes of bf16
constexpr int WG_ALIGN = 1024;  // the swizzle atom: 8 rows of 128 bytes

enum { WG_PRO_LN, WG_PRO_STREAM };
enum { WG_EPI_BIAS, WG_EPI_GELU, WG_EPI_RESID };

struct WgArgs {
  const bf16* a;      // (rows, K)
  const float* mod;   // (B, 6, width) adaLN vectors, f32
  const bf16* w;      // (K, cols)
  const bf16* bias;   // (cols)
  const bf16* res;    // (rows, cols), RESID
  bf16* out;          // (rows, cols)
  int rows, N, K, cols;
  int ish, isc, igate;  // rows of mod: LN shift and scale, residual gate
  float eps;
};

// a block's threads: WG consumer warpgroups and two producer warps
__host__ __device__ constexpr int wg_threads(int WG) { return 128 * WG + 64; }

// A block's tiles: WG consumer warpgroups of 64 rows and two producer warps,
// BN columns a step, ST ring stages (as many as the staged tile and the
// output tiles leave room for at D = 512 (LN, two groups: 4), at D = 1536
// (LN, one group: 3) and beside the output tiles (streamed: 6)).
template <int WG, int BN, bool LN> struct WgShape {
  static constexpr int BM = 64 * WG;              // rows of a block
  static constexpr int NC = 128 * WG;             // consumer threads
  static constexpr int NTH = wg_threads(WG);
  static constexpr int A_SLAB = BM * 128;         // BM rows x 64 K values
  static constexpr int B_STAGE = WG_BK * BN * 2;  // 64 K rows x BN columns
  static constexpr int STAGE = (LN ? 0 : A_SLAB) + B_STAGE;  // ring stage
  static constexpr int ST = LN ? (WG == 2 ? 4 : 3) : 6;
  static constexpr int OUT_TILE = 64 * BN * 2;    // a group's output tile
};

template <int WG, int BN>
__host__ __device__ constexpr size_t smem_wg(bool staged, int K) {
  using L = WgShape<WG, BN, true>;
  using S = WgShape<WG, BN, false>;
  return staged ? WG_ALIGN + (size_t)L::BM * K * 2 + L::ST * L::STAGE +
                      WG * L::OUT_TILE
                : WG_ALIGN + (size_t)S::ST * S::STAGE + WG * S::OUT_TILE;
}

// ------------------------------------------------- mbarriers and TMA, in PTX

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(sm_addr(b))
               : "memory");
}
// a barrier of `n` threads on hardware barrier `id` (0 is __syncthreads')
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
// the box of map m at (column c0, row c1) into shared memory at dst, by
// the tensor memory accelerator; its bytes complete on b
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* m,
                                         int c0, int c1, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(sm_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(c0), "r"(c1), "r"(sm_addr(b))
      : "memory");
}

// the box of map m at (column c0, row c1) out of shared memory at src, by
// the tensor memory accelerator (rows past the map's last are not written);
// completes in the issuing thread's bulk group
__device__ __forceinline__ void tma_store(const CUtensorMap* m,
                                          const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(m)),
      "r"(sm_addr(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the issuing thread's bulk groups but the N youngest have read their
// shared memory (READ) or are complete
template <int N, bool READ>
__device__ __forceinline__ void bulk_wait() {
  if constexpr (READ)
    asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
  else
    asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// A map of a row-major (rows, cols) bf16 matrix for tma_load and
// tma_store: boxes of 64 columns (128 bytes, the swizzle's width) x
// box_rows rows, laid out in the 128-byte swizzle, zeros past the last row
// on loads, rows past it left alone on stores. False when the driver's
// encoder is missing or refuses the map.
inline bool make_tmap(CUtensorMap* m, const void* p, int rows, int cols,
                      int box_rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tmap_encoder();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p),
                dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The same over the 3-d (B, N, cols) view of a (B * N, cols) bf16 matrix:
// boxes of 64 columns x 64 rows of one element, so a box at an element's
// last tile loads zeros past its last row and stores nothing there
// (tma_load3, tma_store3 at (column, row in the element, element)).
inline bool make_tmap3(CUtensorMap* m, const void* p, int B, int N,
                       int cols) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tmap_encoder();
  if (!encode) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)N,
                              (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)N * cols * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p),
                dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
__device__ __forceinline__ void tma_load3(void* dst, const CUtensorMap* m,
                                          int c0, int c1, int c2,
                                          uint64_t* b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(sm_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(c0), "r"(c1), "r"(c2),
      "r"(sm_addr(b))
      : "memory");
}
__device__ __forceinline__ void tma_store3(const CUtensorMap* m,
                                           const void* src, int c0, int c1,
                                           int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(m)),
      "r"(sm_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The same with an L2 cache policy (createpolicy's, below), e.g. evict_first
// for a stream that should not stay in L2: its lines go first, dirty ones
// back to memory as they come rather than filling the cache.
__device__ __forceinline__ void tma_load3(void* dst, const CUtensorMap* m,
                                          int c0, int c1, int c2,
                                          uint64_t* b, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%2, %3, %4}], [%5], %6;\n" ::"r"(
          sm_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(c0), "r"(c1), "r"(c2),
      "r"(sm_addr(b)), "l"(policy)
      : "memory");
}
__device__ __forceinline__ void tma_store3(const CUtensorMap* m,
                                           const void* src, int c0, int c1,
                                           int c2, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0, {%2, %3, %4}], [%1], %5;\n" ::"l"(reinterpret_cast<uint64_t>(m)),
      "r"(sm_addr(src)), "r"(c0), "r"(c1), "r"(c2), "l"(policy)
      : "memory");
}
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

// the swizzle is a function of the address: dynamic shared memory from
// its first 1 KB swizzle atom (WG_ALIGN of slack kept for it)
__device__ __forceinline__ unsigned char* align_atoms(unsigned char* raw) {
  return raw +
         ((WG_ALIGN - (sm_addr(raw) & (WG_ALIGN - 1))) & (WG_ALIGN - 1));
}

// ------------------------------------------------------ wgmma, in PTX

// byte offset of 16-byte chunk c (of 8) of row r in a 128-byte-swizzled slab
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// a shared-memory matrix descriptor in the 128-byte swizzle: 8-row groups
// 1024 bytes apart (stride byte offset); lbo, the leading byte offset, is
// the distance between 64-column slabs of an MN-major operand (K-major: 16,
// unused)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(1024 >> 4) << 32 | 1ull << 62;
}
// d[64 x N] (+)= a[64 x 16] b[16 x N] for a warpgroup, a K-major and b
// MN-major (TB 1, a weight (K, N) as stored) or K-major (TB 0, the same
// slabs read as its transpose) through descriptors; d in the mma16816 C
// layout per n8 tile (row 16 * warp + lane / 4 (+ 8), columns 8 nt + 2
// (lane % 4) (+ 1)). scale_d 0 overwrites d.
template <int N> struct WgSS;
template <> struct WgSS<64> {
  template <int TB = 1>
  static __device__ __forceinline__ void run(float (&d)[8][4], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, %35;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
  }
};
template <> struct WgSS<128> {
  template <int TB = 1>
  static __device__ __forceinline__ void run(float (&d)[16][4], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63}, "
        "%64, %65, p, 1, 1, 0, %67;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
  }
};

// the row kernels' widest products (dit_layer.cuh, D 192)
template <> struct WgSS<192> {
  static __device__ __forceinline__ void run(float (&d)[24][4], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
        "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
        "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
        "%96, %97, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
          "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
          "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
          "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
          "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
          "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
          "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
          "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
          "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

// ------------------------------------------------------------ prologue

// Over a staged tile of K / 64 slabs of BM swizzled rows: row i of Z =
// T(LN(row i of A) * (1 + m[isc * K]) + m[ish * K]) in f32, m = modrow(i)
// (the row's adaLN block: its rows of K values), for the rows below
// `valid`; Z may be A. P = NTH / BM threads a row (t the thread's index
// among the NTH) over its chunks q, q + P, ..., statistics in two passes
// (mean, then the variance of the centred row), eight partial sums a
// thread (one per place in a chunk). KC > 0: K is 8 * P * KC, and the
// thread's KC chunks are read once into registers (one pass over shared
// memory, every load in flight together); the sums run in the same order.
// Rows past `valid` are left as they are. No barrier inside.
template <int BM, int NTH, int KC = 0, typename ModRow>
__device__ __forceinline__ void wg_modln_rows(const unsigned char* A,
                                              unsigned char* Z, int valid,
                                              int K, float eps, int ish,
                                              int isc, int t,
                                              ModRow&& modrow) {
  constexpr int P = NTH / BM;
  constexpr int NC = KC > 0 ? KC : 1;  // chunks held in registers
  const int i = t / P, q = t % P, nc = KC > 0 ? P * KC : K / 8;
  auto at = [&](int c) { return (c >> 3) * (BM * 128) + sw128(i, c & 7); };
  auto lanes_sum = [](float v) {
#pragma unroll
    for (int o = P / 2; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
  };
  // the adds form eight short chains
  auto total = [](const float (&p)[8]) {
    return ((p[0] + p[1]) + (p[2] + p[3])) + ((p[4] + p[5]) + (p[6] + p[7]));
  };
  float f[NC][8];
  // fn(u, c) over the thread's chunks c (the u-th of them)
  auto each = [&](auto&& fn) {
    if constexpr (KC > 0) {
#pragma unroll
      for (int u = 0; u < KC; ++u) fn(u, q + P * u);
    } else {
#pragma unroll 4
      for (int c = q; c < nc; c += P) fn(0, c);
    }
  };
  // chunk c's eight values: from the registers, or read anew
  auto chunk = [&](int u, int c) -> const float(&)[8] {
    if constexpr (KC == 0)
      unpack8(*reinterpret_cast<const uint4*>(A + at(c)), f[0]);
    return f[u];
  };
  if constexpr (KC > 0)
    each([&](int u, int c) {
      unpack8(*reinterpret_cast<const uint4*>(A + at(c)), f[u]);
    });
  float s[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  each([&](int u, int c) {
    const float(&x)[8] = chunk(u, c);
#pragma unroll
    for (int k = 0; k < 8; ++k) s[k] += x[k];
  });
  const float mu = lanes_sum(total(s)) / K;
#pragma unroll
  for (int k = 0; k < 8; ++k) s[k] = 0.0f;
  each([&](int u, int c) {
    const float(&x)[8] = chunk(u, c);
#pragma unroll
    for (int k = 0; k < 8; ++k) s[k] += (x[k] - mu) * (x[k] - mu);
  });
  const float rs = rsqrtf(lanes_sum(total(s)) / K + eps);
  if (i >= valid) return;
  const float* m = modrow(i);
  const float* msh = m + (size_t)ish * K;
  const float* msc = m + (size_t)isc * K;
  each([&](int u, int c) {
    const float(&x)[8] = chunk(u, c);
    const float4 h0 = *reinterpret_cast<const float4*>(msh + 8 * c);
    const float4 h1 = *reinterpret_cast<const float4*>(msh + 8 * c + 4);
    const float4 g0 = *reinterpret_cast<const float4*>(msc + 8 * c);
    const float4 g1 = *reinterpret_cast<const float4*>(msc + 8 * c + 4);
    const float sh[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
    const float sc[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = pack_bf16(
          (x[2 * k] - mu) * rs * (1.0f + sc[2 * k]) + sh[2 * k],
          (x[2 * k + 1] - mu) * rs * (1.0f + sc[2 * k + 1]) + sh[2 * k + 1]);
    *reinterpret_cast<uint4*>(Z + at(c)) = make_uint4(w[0], w[1], w[2], w[3]);
  });
}

// wg_gemm_kernel's LN prologue: in place over its staged tile, mod (B, 6,
// K) indexed by each row's element; rows past `valid` stay zero
template <int BM, int NTH>
__device__ __forceinline__ void wg_modln(unsigned char* A, int valid,
                                         int r0, const WgArgs& g) {
  wg_modln_rows<BM, NTH>(A, A, valid, g.K, g.eps, g.ish, g.isc, threadIdx.x,
                         [&](int i) {
                           return g.mod + (size_t)((r0 + i) / g.N) * 6 * g.K;
                         });
}

// ------------------------------------------------------------- the kernel

// tanh-GELU in f32 written as v * sigmoid(2u), u = sqrt(2/pi) (v + 0.044715
// v^3), since 0.5 (1 + tanh(u)) = 1 / (1 + exp(-2u)): the exponential on the
// exponent unit (ex2, relative error about 2^-22) and a fast reciprocal, no
// branch (tanhf's range split kept the unrolled epilogue from overlapping
// its values). The value differs from tanhf's in the last f32 bits, so a
// bf16 rounding of h flips now and then, as with the attention's exp.
__device__ __forceinline__ float gelu_fast(float v) {
  const float u = 0.7978845608028654f * (v + 0.044715f * v * v * v);
  return __fdividef(v, 1.0f + ex2(-2.0f * LOG2E * u));
}

// the epilogue's value of a column pair before any residual: BIAS T(v),
// GELU T(gelu_fast(rnd(v))), RESID T(v) (the residual comes after)
template <int EPI>
__device__ __forceinline__ uint32_t epi_pair(float v0, float v1) {
  if constexpr (EPI == WG_EPI_GELU) {
    float x0, x1;
    round2(v0, v1, x0, x1);
    return pack_bf16(gelu_fast(x0), gelu_fast(x1));
  } else {
    return pack_bf16(v0, v1);
  }
}

// RESID: T(res + rnd(rnd(T(gate)) * v)) for a pair, v rounded already
__device__ __forceinline__ uint32_t resid_pair(uint32_t v, uint32_t res,
                                               float g0, float g1) {
  float r0, r1, p0, p1;
  round2(g0, g1, r0, r1);
  round2(r0 * __uint_as_float(v << 16), r1 * __uint_as_float(v & 0xffff0000u),
         p0, p1);
  return pack_bf16(__uint_as_float(res << 16) + p0,
                   __uint_as_float(res & 0xffff0000u) + p1);
}

// byte offset of 16-byte chunk c of row i of a group's 64-row output tile:
// 64-column slabs of 64 rows x 128 bytes in the 128-byte swizzle, the
// layout the residual's tensor copies write
__device__ __forceinline__ uint32_t out_at(int i, int c) {
  return (c >> 3) * (64 * 128) + sw128(i, c & 7);
}

template <int PRO, int EPI, int WG, int BN>
__global__ void __launch_bounds__(wg_threads(WG), 1)
    wg_gemm_kernel(const WgArgs g, const __grid_constant__ CUtensorMap ta,
                   const __grid_constant__ CUtensorMap tw,
                   const __grid_constant__ CUtensorMap tr) {
  constexpr bool LN = PRO == WG_PRO_LN;
  using S = WgShape<WG, BN, LN>;
  constexpr int CPR = BN / 8;  // 16-byte chunks of a W or output row
  extern __shared__ unsigned char wg_raw[];
  constexpr bool RES = EPI == WG_EPI_RESID;
  __shared__ uint64_t full[S::ST], empty[S::ST], tile, rfull[2], rempty[2];
  unsigned char* smem = align_atoms(wg_raw);
  const int tid = threadIdx.x, K = g.K, nk = K / WG_BK, ncs = g.cols / BN;
  const int r0 = blockIdx.x * S::BM, valid = min(S::BM, g.rows - r0);
  const int total = ncs * nk;  // chunks over all column steps
  unsigned char* ring = smem + (LN ? S::BM * K * 2 : 0);
  unsigned char* outs = ring + S::ST * S::STAGE;
  if (tid == 0) {
    for (int i = 0; i < S::ST; ++i) {
      mbar_init(&full[i], 1);            // the producer
      mbar_init(&empty[i], S::NC / 32);  // the consumers' warps
    }
    mbar_init(&tile, 1);
    for (int w = 0; w < 2; ++w) {
      mbar_init(&rfull[w], 1);   // the residual's producer
      mbar_init(&rempty[w], 4);  // the group's warps
    }
  }
  __syncthreads();

  if (tid >= S::NC) {
    // The producer, one thread: the LN tile (K / 64 slabs of BM rows),
    // then chunk t (column step t / nk, K rows [64 (t % nk), +64) of W in
    // BN / 64 slabs and, when streamed, of A) into stage t % ST once the
    // consumers have released the stage's previous chunk.
    if (tid == S::NC) {
      if (LN) {
        mbar_expect(&tile, S::BM * K * 2);
        for (int kb = 0; kb < nk; ++kb)
          tma_load(smem + kb * S::A_SLAB, &ta, kb * WG_BK, r0, &tile);
      }
      for (int t = 0; t < total; ++t) {
        const int cs = t / nk, kc = t % nk, st = t % S::ST;
        if (t >= S::ST) mbar_wait(&empty[st], (t / S::ST - 1) & 1);
        unsigned char* sb = ring + st * S::STAGE;
        mbar_expect(&full[st], S::STAGE);
        if (!LN) tma_load(sb, &ta, kc * WG_BK, r0, &full[st]);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load(sb + (LN ? 0 : S::A_SLAB) + j * (WG_BK * 128), &tw,
                   cs * BN + 64 * j, kc * WG_BK, &full[st]);
      }
    } else if (RES && tid == S::NC + 32) {
      // The second producer: each group's residual tile of column step cs
      // into its output tile, once the group has sent out step cs - 1's,
      // so the tile lands while the step's products run.
      for (int cs = 0; cs < ncs; ++cs) {
        for (int w = 0; w < WG; ++w) {
          if (cs > 0) mbar_wait(&rempty[w], (cs - 1) & 1);
          mbar_expect(&rfull[w], S::OUT_TILE);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load(outs + w * S::OUT_TILE + j * (64 * 128), &tr,
                     cs * BN + 64 * j, r0 + 64 * w, &rfull[w]);
        }
      }
    }
    return;
  }

  // The consumers.
  if (LN) {  // the row tile, normalised in place
    mbar_wait(&tile, 0);
    wg_modln<S::BM, S::NC>(smem, valid, r0, g);
    fence_async_shared();  // the LayerNorm's stores, to wgmma's reads
    bar_sync(1, S::NC);
  }

  const int wg = tid / 128, lane = tid & 31, wr = (tid >> 5) & 3;
  const uint32_t base = sm_addr(smem), ring_at = sm_addr(ring);
  unsigned char* ot = outs + wg * S::OUT_TILE;  // the group's output tile
  float acc[BN / 8][4];
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
  for (int cs = 0; cs < ncs; ++cs) {
    for (int kc = 0; kc < nk; ++kc) {
      const int t = cs * nk + kc, st = t % S::ST;
      mbar_wait(&full[st], (t / S::ST) & 1);
      const uint32_t sb = ring_at + st * S::STAGE;
      const uint32_t a0 =
          (LN ? base + kc * S::A_SLAB : sb) + wg * (64 * 128);
      const uint32_t b0 = sb + (LN ? 0 : S::A_SLAB);
      wg_fence();
#pragma unroll
      for (int s = 0; s < WG_BK / 16; ++s)
        WgSS<BN>::run(acc, sw128_desc(a0 + 32 * s, 16),
                      sw128_desc(b0 + 2048 * s, WG_BK * 128),
                      kc > 0 || s > 0);
      wg_commit();
      wg_wait<1>();
      // chunk t - 1's products are done in this group: release its stage
      if (kc > 0 && lane == 0) mbar_arrive(&empty[(t - 1) % S::ST]);
    }
    wg_wait<0>();
    fence_regs(acc);
    // and the step's last chunk's, so the ring refills under the epilogue
    if (lane == 0) mbar_arrive(&empty[(cs * nk + nk - 1) % S::ST]);

    // Epilogue: the group's 64 x BN tile, rounded, into its output tile
    // (out_at: conflict-free), the thread's rows 16 wr + lane / 4 (+ 8)
    // and column pairs c0 + 8 nt, RESID adding the gated product to the
    // residual the tile already holds; then out in 16-byte chunks, a row's
    // by consecutive threads.
    if constexpr (RES)
      mbar_wait(&rfull[wg], cs & 1);  // the residual tile is in
    else
      bar_sync(2 + wg, 128);  // the previous step's tile is out
    const int c0 = cs * BN + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = wr * 16 + (lane >> 2) + 8 * h;
      const int b = min(r0 + wg * 64 + i, g.rows - 1) / g.N;
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const uint32_t bp =
            __ldg(reinterpret_cast<const unsigned*>(g.bias + c0 + 8 * nt));
        uint32_t* o = reinterpret_cast<uint32_t*>(ot + out_at(i, nt) +
                                                  4 * (lane & 3));
        uint32_t v =
            epi_pair<EPI>(acc[nt][2 * h] + __uint_as_float(bp << 16),
                          acc[nt][2 * h + 1] +
                              __uint_as_float(bp & 0xffff0000u));
        if constexpr (RES) {
          const float2 gt = __ldg(reinterpret_cast<const float2*>(
              g.mod + ((size_t)b * 6 + g.igate) * g.cols + c0 + 8 * nt));
          v = resid_pair(v, *o, gt.x, gt.y);
        }
        *o = v;
      }
    }
    bar_sync(2 + wg, 128);
    const int tw = tid & 127;
#pragma unroll
    for (int u = 0; u < 64 * CPR / 128; ++u) {
      const int idx = u * 128 + tw, i = idx / CPR, c = idx % CPR;
      if (wg * 64 + i < valid)
        *reinterpret_cast<uint4*>(g.out +
                                  (size_t)(r0 + wg * 64 + i) * g.cols +
                                  cs * BN + 8 * c) =
            *reinterpret_cast<const uint4*>(ot + out_at(i, c));
    }
    if constexpr (RES) {
      // the tile's reads before the next residual's tensor copy
      fence_async_shared();
      __syncwarp();
      if (lane == 0) mbar_arrive(&rempty[wg]);
    }
  }
}

// Launch one GEMM on `rows` rows; the caller has checked the shape (K and
// cols multiples of 128, the shared memory within the device's opt-in).
template <int PRO, int EPI, int WG, int BN>
cudaError_t launch_wg(const WgArgs& g, cudaStream_t st) {
  const size_t s = smem_wg<WG, BN>(PRO == WG_PRO_LN, g.K);
  const cudaError_t e =
      set_smem((const void*)wg_gemm_kernel<PRO, EPI, WG, BN>, s);
  if (e != cudaSuccess) return e;
  using S = WgShape<WG, BN, PRO == WG_PRO_LN>;
  CUtensorMap ta, tw, tr;
  if (!make_tmap(&ta, g.a, g.rows, g.K, S::BM) ||
      !make_tmap(&tw, g.w, g.K, g.cols, WG_BK) ||
      (EPI == WG_EPI_RESID && !make_tmap(&tr, g.res, g.rows, g.cols, 64)))
    return cudaErrorInvalidValue;
  wg_gemm_kernel<PRO, EPI, WG, BN><<<(g.rows + S::BM - 1) / S::BM, S::NTH,
                                      s, st>>>(
      g, ta, tw, EPI == WG_EPI_RESID ? tr : tw);
  return cudaGetLastError();
}

}  // namespace
