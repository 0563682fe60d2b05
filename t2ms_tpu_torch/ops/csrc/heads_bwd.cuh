// The bf16 fused-heads attention backward on wgmma, its streamed tiles by
// TMA (fused_heads.cu holds the recipes' arithmetic; the f32 entries keep
// its FMA-loop kernels). It replaces the backward half of the TPU kernels
// t2ms_tpu/ops/attention.py:fused_heads_attention_bwd (#11, the pipelined
// and recompute recipes), fused_heads_attention_bwd_two_pass (#12),
// fused_heads_attention_bwd_lean and _lean_two_pass (#13, #14), and the
// attention VJP inside t2ms_tpu/ops/dit_block.py:_fused_block_diff_bwd
// (#3, the BLOCK recipe, launched by dit_block_bwd.cu). Two kernels, no
// atomics, so every sum has one order and runs repeat bit for bit:
//
//   heads_bwd_q_kernel   per (element, 128 q rows, head): two warpgroups
//       of 64 q rows share each 64-key K/V tile. Pass 1 takes the row max
//       m of S = T(q * qscale) K^T; pass 2 forms e = T(exp(T(s - m))) with
//       r = sum e and u = sum dp * e (dP = G V^T), writes m, 1/r and t = u
//       / r to the stats workspace and, pipelined, T(q * scale / r) and
//       T(g / r) to a (B, N, HD) bf16 workspace; pass 3 forms ds and
//       dq += ds K. The lean and block recipes read their statistics and
//       run pass 3 only. Pass 3's rounding needs the exact row max, so the
//       passes are not merged into an online softmax (one rounding point
//       against a running max is not JAX's).
//   heads_bwd_kv_kernel  per (element, 128 k rows, head): two warpgroups
//       of 64 k rows share each streamed q-side tile (q, g and, pipelined,
//       the workspace's two; the rows' statistics): S^T = K Qs^T and
//       dP^T = V G^T, e^T and ds^T formed in the accumulators, then
//       dV += e^T G' and dK += ds^T Q'.
//
// Every product runs on wgmma (m64, f32 sums). The fixed operand of a
// block (q and g in the q kernel, k and v in the kv kernel) is wgmma's A:
// in registers where they are few (the q kernel up to head width 32, the
// kv kernel at 16), else through a shared-memory descriptor, so that the
// registers go to the sums. e and ds are packed from the S and dP
// accumulators straight into register-A fragments of the next product;
// its B (the streamed tile) is read through a descriptor, K-major for S
// and dP, transposed (MN-major) for dq, dV and dK. Thread 0 brings the
// block's own tiles (two 64-row boxes each) and the streamed tiles in by
// TMA (4-d maps per operand, attn_heads.cuh's make_heads_map: boxes of one
// head's 16-byte chunks that land chunk by chunk, wgmma's core-matrix
// layout without swizzle) into a ring of BWD_STAGES stages, each
// completing on its own mbarrier; pass 1 loads K alone. TMA's zero fill
// stands for the rows past N (TMA's box of rows at or past N is not asked
// for: that half of the own tile is zeroed by the threads), and those keys
// are set to -inf before the exponential. The kv kernel's Qs = T(q *
// qscale) is written by the threads from the landed q tile one step
// ahead, while that step's S^T and dP^T run, beside the rows' statistics
// (a 12-byte row has no TMA box; each thread loads its one value a tile
// before it is stored, so the load's latency hides behind a step); both
// are double-buffered, and one __syncthreads a step guards the ring and
// those buffers. Strided operands need only 16-byte rows and strides: the
// block recipe's qkv rows of 3D (D a multiple of 16, so 6D bytes a row)
// and dq, dk, dv written into the column slices of dqkv at row stride ldo.
//
// Registers and the q step of the kv kernel: register-A wgmma serialises
// in ptxas (C7512) when the register cap leaves it too few. At head width
// 64 and 128 the kv kernel holds dK and dV (DH / 2 f32 each) beside S^T
// and dP^T (BQ / 2 each), so it steps over 32 q rows there (wgmma n = 32)
// and 64 below. Head widths 16 and 32 run two blocks an SM (a cap of 128
// registers a thread), 64 and 128 one; ptxas (H100, -Xptxas -v): the q
// kernel 106, 122, 122-125 and 154 registers at 16, 32, 64 and 128, the kv
// kernel 114, 122, 122 and 186, no spills, no C7512. Timed at every path's
// call (PERF.md), k and v in registers at 32 spilled at two blocks an SM
// and ran slower at one; q and g in registers at 64 ran slower; two blocks
// an SM at 64, three stages instead of four, and waiting for a step's last
// product in the next step moved nothing.
//
// What bounds them on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s, the
// exponent unit 16 MUFU.EX2 a clock an SM, 4.182e12 a second): the
// gradient needs five N x N x DH products; the recipes run 10 (pipelined
// and recompute: S three times, dP twice, dq in the q kernel; S, dP, dV, dK
// in the kv kernel) or 7 (lean, block), and three exponentials a score (two
// lean and block). At #11's scaled call (B=64, N=1024, 8 heads of 64) the five
// products take 0.3474 ms and the exponentials 0.3852 ms: the exponent
// unit is the floor; at head width 32 (#3, #12, #14) more so. The design
// keeps every score, e and ds in registers, shares each streamed tile
// between two warpgroups (half the L2 traffic of 64-row blocks), and keeps
// the copies off the threads.

#pragma once

#include <type_traits>

#include "attn_heads.cuh"

namespace {

// One operand of the backward: element b's row n of head h starts at
// p + b * sb + n * sn + h * DH.
template <typename T> struct Opd {
  const T* p;
  long long sb, sn;
  __device__ const T* head(int b, int h, int DH) const {
    return p + (size_t)b * sb + h * DH;
  }
};

template <typename T> struct BwdArgs {
  Opd<T> q, k, v, g;
  T *dq, *dk, *dv;  // (B, N, HD) at row stride ldo
  float* st;        // (B*N, H, 3): m, 1/r, t (BLOCK: t = delta)
  int B, N, HD, H;
  float scale, qscale;
  const float *lse, *delta;  // the lean recipe's (B*N, H) inputs
  T *qsc, *gsc;  // bf16 pipelined: T(q * scale / r), T(g / r), (B, N, HD)
  int ldo;  // row stride of dq, dk and dv: HD, or 3 * HD where they are
            // the column slices of one dqkv (BLOCK)
};

// The backward's recipes: the rounding points of dq, dk and dv, and where
// the rows' statistics come from (the backward's own first passes, or the
// caller's lse and delta, or, BLOCK, the caller's m, 1/r and delta in st).
// BLOCK rounds as RECOMP does (p = e * (1/r), ds = T(p (dp - delta)),
// dv = T(sum T(p)^T g), dq = T((ds k) * scale)) but takes dk from the
// rounded operand: dk = T(sum ds^T T(q * qscale)), as the block's forward
// scales q (dit_block_bwd.cu).
enum Recipe { PIPE = 0, RECOMP = 1, LEAN = 2, BLOCK = 3 };

constexpr int BWD_NT = 256;   // threads: two warpgroups
constexpr int BWD_R = 128;    // the block's own rows, 64 a warpgroup
constexpr int BWD_KT = TC_R;  // keys a step of the q kernel
constexpr int BWD_STAGES = 4;  // stages of either kernel's ring

// Tuning, chosen on an H100 by timing each choice at every path's call
// (PERF.md): q rows a step of the kv kernel (wgmma n of S^T and dP^T);
// whether a block's fixed A operand sits in registers (else it is read
// through a descriptor), in the q kernel or (kv) the kv kernel; and the
// blocks per SM the register budget is cut for
__host__ __device__ constexpr int hb_bq(int DH) { return DH >= 64 ? 32 : 64; }
__host__ __device__ constexpr bool hb_regs(int DH, bool kv) {
  return kv ? DH <= 16 : DH <= 32;
}
__host__ __device__ constexpr int hb_min_blocks(int DH) {
  return DH <= 32 ? 2 : 1;
}

// elements of one head's box of `rows` rows (DH / 8 chunks of rows x 16
// bytes)
__host__ __device__ constexpr int hb_box(int rows, int DH) {
  return rows * DH;
}
// Shared memory (carved in this order, after up to 128 bytes of alignment):
// the q kernel's q and g tiles (two 64-row boxes each), the ring's stages
// of [K | V], the mbarriers (the ring's and the own tiles') and the rows'
// 1/r; the kv kernel's K and V tiles, the ring's stages of [q | g] (and,
// pipelined, [q' | g']), the two Qs buffers, the two statistics buffers
// and the mbarriers.
__host__ __device__ constexpr size_t smem_bwd_q(int DH) {
  return 128 + (size_t)(4 * hb_box(64, DH) +
                        BWD_STAGES * 2 * hb_box(BWD_KT, DH)) * 2 +
         (BWD_STAGES + 1) * 8 + BWD_R * 4;
}
__host__ __device__ constexpr size_t smem_bwd_kv(int DH, int rec) {
  return 128 + (size_t)(4 * hb_box(64, DH) +
                        BWD_STAGES * (rec == PIPE ? 4 : 2) *
                            hb_box(hb_bq(DH), DH) +
                        2 * hb_box(hb_bq(DH), DH)) * 2 +
         2 * 3 * hb_bq(DH) * 4 + (BWD_STAGES + 1) * 8;
}
// blocks of either kernel's grid, one per (element, 128 rows, head)
__host__ __device__ constexpr long long bwd_blocks(int B, int N, int H) {
  return (long long)B * ((N + BWD_R - 1) / BWD_R) * H;
}

// ------------------------------------------------------------ wgmma, both
// operands through descriptors

template <int N> struct WgMmaSS;
template <> struct WgMmaSS<32> {
  static __device__ __forceinline__ void run(float (&d)[4][4], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};
template <> struct WgMmaSS<64> {
  static __device__ __forceinline__ void run(float (&d)[8][4], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
        "%27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

// Descriptors of a TMA box of R rows (16-byte chunk c of row r at c * 16 R
// + r * 16 bytes), k16 step kk: K-major (the head's columns are the
// product's depth: two chunks a step) and transposed, MN-major (its rows
// are the depth: 16 rows a step)
__device__ __forceinline__ uint64_t desc_k(const bf16* t, int kk, int R) {
  return wg_desc(t + kk * 16 * R, R * 16, 128);
}
__device__ __forceinline__ uint64_t desc_t(const bf16* t, int kk, int R) {
  return wg_desc(t + kk * 128, 128, R * 16);
}

// The A operand of a warpgroup: its 64 rows of a block's own tile (one
// 64-row box) over the head width, as register fragments (REGS; each
// warp's 16 rows in the mma16816 A layout, by ldmatrix) or through a
// K-major descriptor. mma<N> adds step kk of A B into d (kk 0 overwrites).
template <int DH, bool REGS> struct ARows;
template <int DH> struct ARows<DH, true> {
  uint32_t f[DH / 16][4];
  __device__ __forceinline__ void init(const bf16* t) {
    const int l = threadIdx.x & 31, r = (threadIdx.x >> 5 & 3) * 16 + (l & 15);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      ldsm4(f[kk], t + (2 * kk + (l >> 4)) * 512 + r * 8);
  }
  template <int N>
  __device__ __forceinline__ void mma(float (&d)[N / 8][4], int kk,
                                      uint64_t b) const {
    WgMma<N>::template run<0>(d, f[kk], b, kk);
  }
};
template <int DH> struct ARows<DH, false> {
  const bf16* t;
  __device__ __forceinline__ void init(const bf16* tile) { t = tile; }
  template <int N>
  __device__ __forceinline__ void mma(float (&d)[N / 8][4], int kk,
                                      uint64_t b) const {
    WgMmaSS<N>::run(d, desc_k(t, kk, 64), b, kk);
  }
};

// by thread 0: a block's own 128 rows of one operand (two 64-row boxes of
// `box` elements at dst and dst + box) by the map m, completing on bar;
// the second box only where it holds rows below N (`two`)
__device__ __forceinline__ void load_own(bf16* dst, int box,
                                         const CUtensorMap* m, int r0, int c,
                                         int b, bool two, uint64_t* bar) {
  tma_load4(dst, m, 0, r0, c, b, bar);
  if (two) tma_load4(dst + box, m, 0, r0 + 64, c, b, bar);
}

// zeros over n bf16 values (a multiple of 8) by the block
__device__ __forceinline__ void zero_smem(bf16* p, int n) {
  for (int i = threadIdx.x; i < n / 8; i += BWD_NT)
    reinterpret_cast<uint4*>(p)[i] = make_uint4(0u, 0u, 0u, 0u);
}

// T(x * s) of n bf16 values (a multiple of 8) from src to dst (which may
// be src) by the block, s a bf16 pair
__device__ __forceinline__ void scale_smem(bf16* dst, const bf16* src, int n,
                                           uint32_t s2) {
  for (int i = threadIdx.x; i < n / 8; i += BWD_NT) {
    uint4 v = reinterpret_cast<const uint4*>(src)[i];
    v.x = mul_bf16x2(v.x, s2);
    v.y = mul_bf16x2(v.y, s2);
    v.z = mul_bf16x2(v.z, s2);
    v.w = mul_bf16x2(v.w, s2);
    reinterpret_cast<uint4*>(dst)[i] = v;
  }
}

// T(acc * f[h]) of the warp's rows r0 + gr + 8 h below N into dst (row
// stride ld), in pairs of 4 bytes
template <int DH>
__device__ __forceinline__ void store_scaled(const float (&acc)[DH / 8][4],
                                             const float (&f)[2], bf16* dst,
                                             long long ld, int r0, int N) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + gr + 8 * h;
    if (row >= N) continue;
#pragma unroll
    for (int nt = 0; nt < DH / 8; ++nt)
      *reinterpret_cast<uint32_t*>(dst + (size_t)row * ld + 8 * nt +
                                   2 * tq) =
          pack_bf16(acc[nt][2 * h] * f[h], acc[nt][2 * h + 1] * f[h]);
  }
}

// ------------------------------------------------------- the q-tile kernel

template <int DH, int REC>
__global__ void __launch_bounds__(BWD_NT, hb_min_blocks(DH))
    heads_bwd_q_kernel(const BwdArgs<bf16> a,
                       const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_g,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v) {
  constexpr int CH = DH / 8, S = BWD_STAGES;
  constexpr int BOX = hb_box(64, DH), KTILE = hb_box(BWD_KT, DH);
  constexpr int NP = REC == LEAN || REC == BLOCK ? 1 : 3;  // k-tile passes
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // TMA writes to 128-byte-aligned shared memory
  bf16* Qt = reinterpret_cast<bf16*>(  // T(q * qscale), two boxes
      smem_raw + (-(uint32_t)sm_addr(smem_raw) & 127));
  bf16* Gt = Qt + 2 * BOX;             // g, two boxes
  bf16* KV = Gt + 2 * BOX;             // S stages of [K | V]
  uint64_t* full = reinterpret_cast<uint64_t*>(KV + S * 2 * KTILE);
  float* Irs = reinterpret_cast<float*>(full + S + 1);  // rows' 1/r

  const int N = a.N, H = a.H;
  const Place pl = place(N, H, BWD_R);
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int w0 = (threadIdx.x >> 5) * 16, r0 = pl.t0 + w0;  // warp's rows
  const int nk = (N + BWD_KT - 1) / BWD_KT, total = NP * nk;
  const int c = pl.h * CH;
  const bool two = pl.t0 + 64 < N;

  auto stage = [&](int it) { return KV + it % S * 2 * KTILE; };
  // by thread 0: iteration it's K (and, past pass 1, V) into its stage
  auto fetch = [&](int it) {
    if (it < total) {
      bf16* Ks = stage(it);
      const int k0 = it % nk * BWD_KT;
      const bool withv = NP == 1 || it >= nk;
      mbar_expect(&full[it % S], (withv ? 4 : 2) * KTILE);
      tma_load4(Ks, &map_k, 0, k0, c, pl.b, &full[it % S]);
      if (withv)
        tma_load4(Ks + KTILE, &map_v, 0, k0, c, pl.b, &full[it % S]);
    }
  };
  // iteration it's stage landed, every warp done with it - 1's, which
  // thread 0 then refills
  auto begin = [&](int it) {
    mbar_wait(&full[it % S], it / S & 1);
    __syncthreads();
    if (threadIdx.x == 0) fetch(it + S - 1);
  };

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st <= S; ++st) mbar_init(&full[st], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(&full[S], (two ? 8 : 4) * BOX);
    load_own(Qt, BOX, &map_q, pl.t0, c, pl.b, two, &full[S]);
    load_own(Gt, BOX, &map_g, pl.t0, c, pl.b, two, &full[S]);
#pragma unroll
    for (int st = 0; st < S - 1; ++st) fetch(st);
  }
  if (!two) {  // the second warpgroup's rows are all past N
    zero_smem(Qt + BOX, BOX);
    zero_smem(Gt + BOX, BOX);
  }
  __syncthreads();  // the barriers and the zeros in
  mbar_wait(&full[S], 0);
  scale_smem(Qt, Qt, 2 * BOX, bf16_pair(a.qscale));
  fence_async_shared();
  __syncthreads();
  ARows<DH, hb_regs(DH, false)> qa, ga;
  qa.init(Qt + wg * BOX);
  ga.init(Gt + wg * BOX);

  // rows r0 + gr (index 0) and r0 + gr + 8 (index 1)
  float m[2], ir[2] = {0.0f, 0.0f}, tt[2], rs[2] = {0.0f, 0.0f},
              us[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = r0 + gr + 8 * r;
    const size_t row = ((size_t)pl.b * N + (n < N ? n : 0)) * H + pl.h;
    if (REC == BLOCK) {
      m[r] = n < N ? a.st[row * 3] : 0.0f;
      ir[r] = n < N ? a.st[row * 3 + 1] : 0.0f;
      tt[r] = n < N ? a.st[row * 3 + 2] : 0.0f;
    } else {
      m[r] = REC == LEAN ? (n < N ? a.lse[row] : 0.0f) : -INFINITY;
      tt[r] = REC == LEAN && n < N ? a.delta[row] : 0.0f;
    }
  }
  float s[8][4], dp[8][4], dq[DH / 8][4];
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt)
    dq[nt][0] = dq[nt][1] = dq[nt][2] = dq[nt][3] = 0.0f;
  // S = T(q * qscale) K^T and, WITH_DP, dP = g V^T over iteration it's
  // keys (a constant, so that no branch surrounds a wgmma)
  auto scores = [&](int it, auto with_dp) {
    const bf16* Ks = stage(it);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      qa.template mma<64>(s, kk, desc_k(Ks, kk, BWD_KT));
    if constexpr (decltype(with_dp)::value) {
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        ga.template mma<64>(dp, kk, desc_k(Ks + KTILE, kk, BWD_KT));
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
    if constexpr (decltype(with_dp)::value) fence_regs(dp);
    mask_tile(s, it % nk * BWD_KT, N);
  };

  int it = 0;
  if (NP == 3) {
    for (; it < nk; ++it) {  // pass 1: the row max
      begin(it);
      scores(it, std::false_type{});
      row_max(s, m);
    }
    m[0] = quad_max(m[0]);
    m[1] = quad_max(m[1]);
    for (; it < 2 * nk; ++it) {  // pass 2: r and u
      begin(it);
      scores(it, std::true_type{});
      uint32_t E[4][4];  // e's fragments, unused: pass 3 forms ds
      exp_rows(s, m, rs, E, [&](int nt, int h, float e0, float e1) {
        us[h] += dp[nt][2 * h] * e0;
        us[h] += dp[nt][2 * h + 1] * e1;
      });
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] = quad_sum(rs[r]);
      us[r] = quad_sum(us[r]);
      ir[r] = 1.0f / rs[r];
      tt[r] = us[r] * ir[r];
      const int n = r0 + gr + 8 * r;
      if (tq == 0) {
        Irs[w0 + gr + 8 * r] = ir[r];
        if (n < N) {
          float* o = a.st + (((size_t)pl.b * N + n) * H + pl.h) * 3;
          o[0] = m[r];
          o[1] = ir[r];
          o[2] = tt[r];
        }
      }
    }
    if (REC == PIPE) {
      // T(q * (scale / r)) and T(g / r), once per q row, from device memory
      __syncthreads();
      const bf16* qh = a.q.head(pl.b, pl.h, DH);
      const bf16* gh = a.g.head(pl.b, pl.h, DH);
      for (int idx = threadIdx.x; idx < BWD_R * CH; idx += BWD_NT) {
        const int i = idx / CH, cc = idx % CH * 8, n = pl.t0 + i;
        if (n >= N) continue;
        const float fi = Irs[i], fq = a.scale * fi;
        const uint4 qv =
            *reinterpret_cast<const uint4*>(qh + (size_t)n * a.q.sn + cc);
        const uint4 gv =
            *reinterpret_cast<const uint4*>(gh + (size_t)n * a.g.sn + cc);
        const bf16* qe = reinterpret_cast<const bf16*>(&qv);
        const bf16* ge = reinterpret_cast<const bf16*>(&gv);
        uint4 qo, go;
        uint32_t* qw = reinterpret_cast<uint32_t*>(&qo);
        uint32_t* gw = reinterpret_cast<uint32_t*>(&go);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qw[j] = pack_bf16(to_f<bf16>(qe[2 * j]) * fq,
                            to_f<bf16>(qe[2 * j + 1]) * fq);
          gw[j] = pack_bf16(to_f<bf16>(ge[2 * j]) * fi,
                            to_f<bf16>(ge[2 * j + 1]) * fi);
        }
        const size_t o = ((size_t)pl.b * N + n) * a.HD + pl.h * DH + cc;
        *reinterpret_cast<uint4*>(a.qsc + o) = qo;
        *reinterpret_cast<uint4*>(a.gsc + o) = go;
      }
    }
  }
  for (; it < total; ++it) {  // pass 3 (the only one of lean and block)
    begin(it);
    scores(it, std::true_type{});
    // ds: pipelined T(e (dp - t)); recompute p = e / r, T(p (dp - t));
    // lean p = T(exp(T(s - lse))), T(p (dp - delta)); block
    // p = e * (1/r), T(p (dp - delta))
    uint32_t P[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float p0, p1;
        exp_rounded2(s[nt][2 * h], s[nt][2 * h + 1], m[h], m[h], p0, p1);
        if (REC == RECOMP || REC == BLOCK) {
          p0 *= ir[h];
          p1 *= ir[h];
        }
        P[nt / 2][(nt & 1) * 2 + h] =
            pack_bf16(p0 * (dp[nt][2 * h] - tt[h]),
                      p1 * (dp[nt][2 * h + 1] - tt[h]));
      }
    }
    const bf16* Ks = stage(it);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BWD_KT / 16; ++kk)
      WgMma<DH>::template run<1>(dq, P[kk], desc_t(Ks, kk, BWD_KT), 1);
    wg_commit();
    wg_wait<0>();
    fence_regs(dq);
  }

  // dq = T(dQ * scale / r) pipelined, T(dQ * scale) otherwise
  const float f[2] = {REC == PIPE ? a.scale * ir[0] : a.scale,
                      REC == PIPE ? a.scale * ir[1] : a.scale};
  store_scaled<DH>(dq, f, a.dq + (size_t)pl.b * N * a.ldo + pl.h * DH, a.ldo,
                   r0, N);
}

// ------------------------------------------------------- the k-tile kernel

template <int DH, int REC>
__global__ void __launch_bounds__(BWD_NT, hb_min_blocks(DH))
    heads_bwd_kv_kernel(const BwdArgs<bf16> a,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_g,
                        const __grid_constant__ CUtensorMap map_qs,
                        const __grid_constant__ CUtensorMap map_gs) {
  constexpr int CH = DH / 8, S = BWD_STAGES, BQ = hb_bq(DH);
  constexpr int NQ = REC == PIPE ? 4 : 2;  // TMA tiles a stage
  constexpr int KN = REC == LEAN ? 2 : 3;  // statistics a q row
  constexpr int BOX = hb_box(64, DH), QT = hb_box(BQ, DH);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Kt = reinterpret_cast<bf16*>(  // k, two boxes
      smem_raw + (-(uint32_t)sm_addr(smem_raw) & 127));
  bf16* Vt = Kt + 2 * BOX;         // v, two boxes
  bf16* Ring = Vt + 2 * BOX;       // S stages of [q | g | q' | g']
  bf16* Qs = Ring + S * NQ * QT;   // two buffers of T(q * qscale)
  float* Stat = reinterpret_cast<float*>(Qs + 2 * QT);  // two of 3 x BQ
  uint64_t* full = reinterpret_cast<uint64_t*>(Stat + 2 * 3 * BQ);

  const int N = a.N, H = a.H;
  const Place pl = place(N, H, BWD_R);
  const int wg = threadIdx.x >> 7, tq = threadIdx.x & 3;
  const int r0 = pl.t0 + (threadIdx.x >> 5) * 16;  // the warp's k rows
  const int nq = (N + BQ - 1) / BQ;
  const int c = pl.h * CH;
  const bool two = pl.t0 + 64 < N;

  auto stage = [&](int it) { return Ring + it % S * NQ * QT; };
  // by thread 0: q tile it's q and g (pipelined also T(q * scale / r) and
  // T(g / r)) into its stage
  auto fetch = [&](int it) {
    if (it < nq) {
      bf16* Sq = stage(it);
      const int q0 = it * BQ;
      mbar_expect(&full[it % S], NQ * 2 * QT);
      tma_load4(Sq, &map_q, 0, q0, c, pl.b, &full[it % S]);
      tma_load4(Sq + QT, &map_g, 0, q0, c, pl.b, &full[it % S]);
      if (REC == PIPE) {
        tma_load4(Sq + 2 * QT, &map_qs, 0, q0, c, pl.b, &full[it % S]);
        tma_load4(Sq + 3 * QT, &map_gs, 0, q0, c, pl.b, &full[it % S]);
      }
    }
  };
  // the rows' statistics: thread sk * BQ + si (below KN * BQ <= BWD_NT)
  // brings in statistic sk (m, 1/r, t; lean lse, -, delta) of row si of a
  // q tile, from device memory a tile ahead of its store (zero past N)
  const int sk = REC == LEAN ? threadIdx.x / BQ * 2 : threadIdx.x / BQ;
  const int si = threadIdx.x % BQ;
  const bool sl = threadIdx.x < KN * BQ;
  auto stat_load = [&](int it) {
    const int n = it * BQ + si;
    if (!sl || it >= nq || n >= N) return 0.0f;
    const size_t row = ((size_t)pl.b * N + n) * H + pl.h;
    return REC == LEAN ? (sk == 0 ? a.lse : a.delta)[row]
                       : a.st[row * 3 + sk];
  };
  float pf = stat_load(0);
  // by every thread, for q tile it (landed): T(q * qscale) into its Qs
  // buffer and the rows' statistics into its statistics buffer
  const uint32_t qs2 = bf16_pair(a.qscale);
  auto prep = [&](int it) {
    mbar_wait(&full[it % S], it / S & 1);
    scale_smem(Qs + (it & 1) * QT, stage(it), QT, qs2);
    if (sl) Stat[(it & 1) * 3 * BQ + sk * BQ + si] = pf;
    pf = stat_load(it + 1);
    fence_async_shared();
  };

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st <= S; ++st) mbar_init(&full[st], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(&full[S], (two ? 8 : 4) * BOX);
    load_own(Kt, BOX, &map_k, pl.t0, c, pl.b, two, &full[S]);
    load_own(Vt, BOX, &map_v, pl.t0, c, pl.b, two, &full[S]);
#pragma unroll
    for (int st = 0; st < S - 1; ++st) fetch(st);
  }
  if (!two) {  // the second warpgroup's rows are all past N
    zero_smem(Kt + BOX, BOX);
    zero_smem(Vt + BOX, BOX);
  }
  __syncthreads();  // the barriers and the zeros in
  prep(0);
  mbar_wait(&full[S], 0);
  __syncthreads();
  ARows<DH, hb_regs(DH, true)> ka, va;
  ka.init(Kt + wg * BOX);
  va.init(Vt + wg * BOX);

  float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nt][e] = dv[nt][e] = 0.0f;
  }

  for (int it = 0; it < nq; ++it) {
    if (threadIdx.x == 0) fetch(it + S - 1);  // into it - 1's stage
    const int q0 = it * BQ;
    const bf16* Sq = stage(it);
    const bf16* Qsc = Qs + (it & 1) * QT;
    const float* St = Stat + (it & 1) * 3 * BQ;

    // S^T = K T(q * qscale)^T and dP^T = V g^T: rows are k rows, columns
    // q rows; the next tile's Qs and statistics while they run
    float s[BQ / 8][4], dp[BQ / 8][4];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      ka.template mma<BQ>(s, kk, desc_k(Qsc, kk, BQ));
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      va.template mma<BQ>(dp, kk, desc_k(Sq + QT, kk, BQ));
    wg_commit();
    if (it + 1 < nq) prep(it + 1);
    wg_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    if (q0 + BQ > N) {  // q rows past N: e = exp(-inf) = 0
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (q0 + 8 * nt + 2 * tq + (e & 1) >= N) s[nt][e] = -INFINITY;
      }
    }
    // pipelined e and ds_u = T(e (dp - t)); recompute p = e / r, T(p) and
    // ds = T(p (dp - t)); lean p = T(exp(T(s - lse))), ds = T(p (dp -
    // delta)); block p = e * (1/r), T(p), ds = T(p (dp - delta))
    uint32_t Pe[BQ / 16][4], Pd[BQ / 16][4];
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
      const int i = 8 * nt + 2 * tq;
      const float2 mm = *reinterpret_cast<const float2*>(St + i);
      const float2 rr = *reinterpret_cast<const float2*>(St + BQ + i);
      const float2 tv2 = *reinterpret_cast<const float2*>(St + 2 * BQ + i);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float p0, p1;
        uint32_t pb =
            exp_rounded2(s[nt][2 * h], s[nt][2 * h + 1], mm.x, mm.y, p0, p1);
        if (REC == RECOMP || REC == BLOCK) {
          p0 *= rr.x;
          p1 *= rr.y;
          pb = pack_bf16(p0, p1);
        }
        Pe[nt / 2][(nt & 1) * 2 + h] = pb;
        Pd[nt / 2][(nt & 1) * 2 + h] = pack_bf16(
            p0 * (dp[nt][2 * h] - tv2.x), p1 * (dp[nt][2 * h + 1] - tv2.y));
      }
    }
    // pipelined dV += e^T T(g / r), dK += ds_u^T T(q * scale / r);
    // block dV += T(p)^T g, dK += ds^T T(q * qscale); otherwise
    // dV += T(p)^T g, dK += ds^T q
    const bf16* Gv = REC == PIPE ? Sq + 3 * QT : Sq + QT;
    const bf16* Qk = REC == PIPE ? Sq + 2 * QT : REC == BLOCK ? Qsc : Sq;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      WgMma<DH>::template run<1>(dv, Pe[kk], desc_t(Gv, kk, BQ), 1);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      WgMma<DH>::template run<1>(dk, Pd[kk], desc_t(Qk, kk, BQ), 1);
    wg_commit();
    wg_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    __syncthreads();  // every warp done with tile it; it + 1's Qs in
  }

  // dk = T(dK) pipelined and block, T(dK * scale) otherwise; dv = T(dV)
  const float fk = REC == PIPE || REC == BLOCK ? 1.0f : a.scale;
  const float f1[2] = {fk, fk}, f2[2] = {1.0f, 1.0f};
  const size_t o = (size_t)pl.b * N * a.ldo + pl.h * DH;
  store_scaled<DH>(dk, f1, a.dk + o, a.ldo, r0, N);
  store_scaled<DH>(dv, f2, a.dv + o, a.ldo, r0, N);
}

// The q-tile kernel, then the k-tile kernel, on every (element, 128 rows,
// head); the caller has checked that the grid fits an int. A map the TMA
// encoder refuses (a row or stride that is not a multiple of 16 bytes)
// returns cudaErrorInvalidValue and launches nothing.
template <int DH, int REC>
cudaError_t launch_bwd_bf16(const BwdArgs<bf16>& a, cudaStream_t st) {
  constexpr size_t s1 = smem_bwd_q(DH), s2 = smem_bwd_kv(DH, REC);
  constexpr int BQ = hb_bq(DH);
  cudaError_t e;
  if ((e = set_smem((const void*)heads_bwd_q_kernel<DH, REC>, s1)) ||
      (e = set_smem((const void*)heads_bwd_kv_kernel<DH, REC>, s2)))
    return e;
  CUtensorMap mq, mg, mk, mv, mqb, mgb, mqs, mgs;
  const int B = a.B, N = a.N, HD = a.HD;
  bool ok = make_heads_map(&mq, a.q.p, B, N, HD, DH, a.q.sb, a.q.sn) &&
            make_heads_map(&mg, a.g.p, B, N, HD, DH, a.g.sb, a.g.sn) &&
            make_heads_map(&mk, a.k.p, B, N, HD, DH, a.k.sb, a.k.sn) &&
            make_heads_map(&mv, a.v.p, B, N, HD, DH, a.v.sb, a.v.sn) &&
            make_heads_map(&mqb, a.q.p, B, N, HD, DH, a.q.sb, a.q.sn, BQ) &&
            make_heads_map(&mgb, a.g.p, B, N, HD, DH, a.g.sb, a.g.sn, BQ);
  if (REC == PIPE) {
    const long long sb = (long long)N * HD;
    ok = ok && make_heads_map(&mqs, a.qsc, B, N, HD, DH, sb, HD, BQ) &&
         make_heads_map(&mgs, a.gsc, B, N, HD, DH, sb, HD, BQ);
  } else {
    mqs = mqb;  // unread
    mgs = mgb;
  }
  if (!ok) return cudaErrorInvalidValue;
  const int blocks = (int)bwd_blocks(B, N, a.H);
  heads_bwd_q_kernel<DH, REC><<<blocks, BWD_NT, s1, st>>>(a, mq, mg, mk, mv);
  if ((e = cudaGetLastError())) return e;
  heads_bwd_kv_kernel<DH, REC>
      <<<blocks, BWD_NT, s2, st>>>(a, mk, mv, mqb, mgb, mqs, mgs);
  return cudaGetLastError();
}

}  // namespace
