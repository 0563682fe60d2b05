// Attention on the head-split (B, H, N, DH) layout, hand-written for Hopper
// (sm_90a), bf16 and f32.
//
// Replaces the TPU kernels t2ms_tpu/ops/attention.py:flash_attention
// (_flash_kernel, online softmax over KV blocks, all f32 inside),
// vmem_attention (_vmem_attn_kernel) and packed_attention (_packed_kernel),
// the last two the same exact softmax with p normalised and cast to v's
// dtype before PV. The TPU kernels hold one (b, h) row's whole K and V (and,
// for the exact ones, the whole (N, N) score matrix) in VMEM; a Hopper block
// has 227 KB of shared memory, so the scores stay in registers, 16 q rows a
// warp, and K and V come through shared memory:
//
//   online (#15)  one pass over the K/V tiles: s = q k^T in f32, the
//                 running row max m, the correction 2^(c m_old - c m_new),
//                 p = 2^(c s - c m) and the row sum all in f32 (c = scale *
//                 log2(e)), the f32 accumulator rescaled and p v added with
//                 p as two bf16 products (p = hi + lo, which keeps p's
//                 rounding below the output's); o = T(acc / sum).
//   exact (#16, #17)  two passes: the f32 row max and sum (each thread
//                 carries its own max and sum over its columns; the four
//                 threads of a row combine them once), then p = 2^(c s -
//                 c m) * (1 / sum) in f32, cast to T, PV accumulated in f32,
//                 o = T(PV).
//
// The rounding points are the JAX kernels' (f32 s, m and sum; exact: T(p)
// before PV; online: f32 throughout, T() at the end). Two things move f32
// values by a few ulp and nothing else: the exponential is ex2.approx.ftz
// (one MUFU.EX2, relative error about 2^-22, results below 2^-126 flushed to
// 0) of s * c - m * c formed by one FFMA, where the JAX kernels take
// exp(s * scale - m); and the exact kernels multiply by one reciprocal of
// the row sum where JAX divides every score.
//
// bf16 keeps the scores in registers in the mma.m16n8k16 accumulator layout
// (the row max over the quad of lanes that holds a row, p packed from the
// score registers into the A fragments of PV), with q's fragments read from
// device memory straight into registers. Only the 64-key tile that crosses
// N masks its keys to -inf; rows past N load as zero. Three kernels:
//
//   split_heads_online_kernel (#15)  8 warps (two warpgroups) own 128 q
//            rows of one (b, h); K and V stream through a cp.async ring of
//            three 64-key stages in wgmma's core-matrix layout, one
//            __syncthreads a tile. q K^T and p V run on wgmma, K read
//            K-major and V transposed through shared-memory descriptors.
//            Each tile starts the next tile's q K^T before its own softmax,
//            so the tensor cores and the exponent unit work at once.
//   split_heads_resident_kernel (#16, #17 where 2 * N * (DH + 8) * 2 bytes
//            fit two blocks an SM: attention.py split_heads_route) the
//            block copies its head's whole K and V into shared memory once
//            and its 8 warps loop over the head's 16-row q tiles, the two
//            passes reading K (ldmatrix, ld_b) and V (ldmatrix.trans,
//            ld_bt) from shared memory into mma.sync. One block covers a
//            whole head where the grid holds two blocks an SM anyway
//            (packed_480: 2048 heads); with fewer heads (vmem_480: 32) a
//            head's q tiles split over up to ceil(tiles / 8) blocks.
//   split_heads_exact_kernel (#16, #17 where they do not fit) 8 warps own
//            128 q rows and stream K, then K and V, through a cp.async ring
//            of padded 64-row tiles into ldmatrix and mma.sync.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): at the 8192-token
// DiT's serving call (2B=8, H=4, N=8192, DH=32) the two N x N x DH products
// are 274.9 GFLOP, 0.278 ms, against 8.4 MB of q, k, v and o; at the packed
// sampler's call (2B=512, H=4, N=480, DH=32) 60.4 GFLOP, 0.061 ms, against
// 252 MB, 0.075 ms. At head width 32 a score carries 128 tensor-core flops,
// so the exponent unit is a floor of its own: 16 ex2 a clock an SM, about
// 4.2e12 a second on 132 SMs, 0.51 ms for #15's 2.1e9 exponentials and 0.23
// ms for #17's two of each of its 0.47e9 scores. The per-score scalar work
// (the max, one FFMA, the sum, the bf16 packing) runs beside it, and #15's
// p V is two products (hi and lo).
//
// f32 runs split_heads_f32_kernel, the first version's FMA loops (4 warps,
// 64 q rows, plain tile loads, p through shared memory), which the CPU-twin
// checks hold tight; no timed path runs it.
//
// q, k, v and o are read and written through their own batch, head and row
// strides (16-byte aligned rows, unit column stride: the wrapper checks), so
// the head-split views of one qkv projection are not copied and the output
// can be a view of the merged (B, N, H*DH) layout.

#include "attn_heads.cuh"

namespace {

struct Strides {
  long long b, h, n;
};
struct SplitShape {
  Strides q, k, v, o;
  int H, N;
  float scale;
};

// ------------------------------------------------------- bf16: both routes

constexpr int SW = 8;         // warps of a bf16 block, 16 q rows each
constexpr int SNT = SW * 32;  // its threads
constexpr int SR = SW * 16;   // q rows of a streaming block
constexpr int KR = TC_R;      // keys a tile

// the ring's stages: three, but two for the exact kernel at head widths 64
// and 128 (padded tiles)
__host__ __device__ constexpr int split_stages(int DH, bool exact) {
  return exact && DH > 32 ? 2 : 3;
}
// blocks per SM the register budget is cut for: two of 8 warps (128
// registers), one at head width 128
__host__ __device__ constexpr int split_min_blocks(int DH) {
  return DH == 128 ? 1 : 2;
}
// a stage of [K | V]: padded rows for ldmatrix (exact), core matrices for
// wgmma (online)
__host__ __device__ constexpr size_t smem_stream(int DH, bool exact) {
  return (size_t)split_stages(DH, exact) * 2 *
         (exact ? tc_tile(KR, DH) : (size_t)KR * DH * 2);
}
// the resident route's K and V of a whole head, N rounded up to a tile
__host__ __device__ inline size_t smem_resident(int N, int DH) {
  return 2 * tc_tile((N + KR - 1) / KR * KR, DH);
}

// s = q K^T (f32 sums) for the 64 keys of tile Ks. s[nt][e] is row gr + 8
// (e / 2), key 8 nt + 2 tq + e % 2 of the tile.
template <int DH>
__device__ __forceinline__ void qk_tile(float (&s)[8][4],
                                        const uint32_t (&qa)[DH / 16][4],
                                        const bf16* Ks) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      uint32_t b[4];
      ld_b(b, Ks, DH + 8, 16 * p, 16 * kk);
      mma16816(s[2 * p], qa[kk], b[0], b[1]);
      mma16816(s[2 * p + 1], qa[kk], b[2], b[3]);
    }
  }
}

// the largest of the thread's 16 scores of row h
__device__ __forceinline__ float tile_max(const float (&s)[8][4], int h) {
  float mx = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
    mx = fmaxf(mx, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
  return mx;
}

// exact, pass 1: this thread's running c * max (mc) and sum of 2^(c s - mc)
// over its own columns of each of its two rows; -inf until it has seen a
// key (with N < 4 a thread may see none)
__device__ __forceinline__ void thread_stats(const float (&s)[8][4], float c,
                                             float (&mc)[2], float (&l)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float mn = fmaxf(mc[h], tile_max(s, h) * c);
    const float sub = mn == -INFINITY ? 0.0f : mn;
    float sum = 0.0f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      sum += ex2(fmaf(s[nt][2 * h], c, -sub)) +
             ex2(fmaf(s[nt][2 * h + 1], c, -sub));
    l[h] = l[h] * ex2(mc[h] - sub) + sum;
    mc[h] = mn;
  }
}

// exact, after pass 1: the row's c * max over the quad of lanes that holds
// it into mc, and 1 / (the row sum) into l
__device__ __forceinline__ void row_totals(float (&mc)[2], float (&l)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m = quad_max(mc[h]);  // finite: key 0 is in every row
    l[h] = 1.0f / quad_sum(l[h] * ex2(mc[h] - m));
    mc[h] = m;
  }
}

// exact, pass 2: acc += T(2^(c s - mc) * rinv) V for the 64 rows of tile Vs
template <int DH>
__device__ __forceinline__ void exact_pv(float (&acc)[DH / 8][4],
                                         const float (&s)[8][4], float c,
                                         const float (&mc)[2],
                                         const float (&rinv)[2],
                                         const bf16* Vs) {
  uint32_t P[4][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      P[nt / 2][(nt & 1) * 2 + h] =
          pack_bf16(ex2(fmaf(s[nt][2 * h], c, -mc[h])) * rinv[h],
                    ex2(fmaf(s[nt][2 * h + 1], c, -mc[h])) * rinv[h]);
  }
  frags_by_tile<DH, 4>(acc, P, Vs);
}

// online: one tile's softmax before its PV. mc (c * the running max) and
// the row sums l are the quad's; l is rescaled by corr = 2^(mc_old -
// mc_new) (the caller rescales the accumulator by it), then p = 2^(c s -
// mc) is added to l and split into the A fragments hi + lo of PV, 16 keys
// each.
__device__ __forceinline__ void online_probs(const float (&s)[8][4], float c,
                                             float (&mc)[2], float (&l)[2],
                                             float (&corr)[2],
                                             uint32_t (&hi)[4][4],
                                             uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float mn = fmaxf(mc[h], quad_max(tile_max(s, h)) * c);
    corr[h] = ex2(mc[h] - mn);  // 0 at the first tile
    mc[h] = mn;
    l[h] *= corr[h];
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float e0 = ex2(fmaf(s[nt][2 * h], c, -mc[h]));
      const float e1 = ex2(fmaf(s[nt][2 * h + 1], c, -mc[h]));
      l[h] += e0 + e1;
      float r0, r1;
      const int i = (nt & 1) * 2 + h;
      hi[nt / 2][i] = round2(e0, e1, r0, r1);
      lo[nt / 2][i] = pack_bf16(e0 - r0, e1 - r1);
    }
  }
}

// ------------------------------------------- wgmma (the online kernel's)

// K and V tiles of the online kernel hold core matrices of 8 keys x 8
// columns (8 rows of 16 bytes, 128 contiguous bytes), a row's column chunks
// 128 bytes apart and key groups DH * 16 bytes apart: wgmma's layout without
// swizzle, read K-major for q K^T and MN-major (transposed) for p V.
template <int DH> struct CoreCopy {
  static constexpr int CH = DH / 8, U = (KR * CH + SNT - 1) / SNT;
  int r[U];                 // this thread's rows of a tile (KR: none)
  uint32_t so[U];           // their chunks' byte offsets in the tile
  long long gk[U], gv[U];   // and their elements' offsets in K and V
  __device__ __forceinline__ void init(long long skn, long long svn) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = u * SNT + threadIdx.x, c = idx % CH;
      r[u] = idx < KR * CH ? idx / CH : KR;
      so[u] = (r[u] >> 3) * (16 * DH) + c * 128 + (r[u] & 7) * 16;
      gk[u] = r[u] * skn + c * 8;
      gv[u] = r[u] * svn + c * 8;
    }
  }
  // the K and V tiles whose row 0 is at kt and vt, rows from `valid` on
  // zero, into Ks and Vs, asynchronously
  __device__ __forceinline__ void copy(bf16* Ks, bf16* Vs, const bf16* kt,
                                       const bf16* vt, int valid) const {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r[u] < KR) {
        const bool ok = r[u] < valid;
        cp16(reinterpret_cast<char*>(Ks) + so[u], ok ? kt + gk[u] : kt, ok);
        cp16(reinterpret_cast<char*>(Vs) + so[u], ok ? vt + gv[u] : vt, ok);
      }
    }
  }
};

// Streaming route of the exact softmax (#16, #17 where K and V do not fit):
// one block per (b, h, 128 q rows), the q tile fastest, so the blocks of
// one (b, h) share its K/V in L2; the ring runs twice, K alone for the row
// statistics, then K and V.
template <int DH>
__global__ void __launch_bounds__(SNT, split_min_blocks(DH))
    split_heads_exact_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             bf16* __restrict__ o, const SplitShape s) {
  constexpr int TILE = KR * (DH + 8), S = split_stages(DH, true);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* KV = reinterpret_cast<bf16*>(smem);  // S stages of [K | V]

  const int N = s.N, q_tiles = (N + SR - 1) / SR;
  const int bh = blockIdx.x / q_tiles, b = bh / s.H, h = bh % s.H;
  const int r0 = blockIdx.x % q_tiles * SR + (threadIdx.x >> 5) * 16;
  const bf16* kh = k + b * s.k.b + h * s.k.h;
  const bf16* vh = v + b * s.v.b + h * s.v.h;
  const int nk = (N + KR - 1) / KR, total = 2 * nk;

  // iteration `it` is pass it / nk over k tile it % nk, in stage it % S;
  // the first pass needs no V. Every call commits a group (empty past the
  // last tile), so the wait below counts S - 2 younger groups.
  auto fetch = [&](int it) {
    if (it < total) {
      const int k0 = it % nk * KR;
      bf16* Ks = KV + it % S * 2 * TILE;
      cp_tile<KR, DH, SNT>(Ks, kh + (size_t)k0 * s.k.n, s.k.n, N - k0);
      if (it >= nk)
        cp_tile<KR, DH, SNT>(Ks + TILE, vh + (size_t)k0 * s.v.n, s.v.n,
                             N - k0);
    }
    cp_commit();
  };
#pragma unroll
  for (int st = 0; st < S - 1; ++st) fetch(st);
  uint32_t qa[DH / 16][4];
  load_q<DH>(qa, q + b * s.q.b + h * s.q.h, s.q.n, r0, N);

  const float c = s.scale * LOG2E;
  float mc[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float acc[DH / 8][4];
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
  for (int it = 0; it < total; ++it) {
    cp_wait<S - 2>();
    __syncthreads();    // tile `it` in; every warp done with tile it - 1
    fetch(it + S - 1);  // into the stage tile it - 1 used
    const bf16* Ks = KV + it % S * 2 * TILE;
    float sc[8][4];
    qk_tile<DH>(sc, qa, Ks);
    mask_tile(sc, it % nk * KR, N);
    if (it < nk) {
      thread_stats(sc, c, mc, l);
      if (it == nk - 1) row_totals(mc, l);
    } else {
      exact_pv<DH>(acc, sc, c, mc, l, Ks + TILE);
    }
  }
  store_o<DH, false>(acc, l, o + b * s.o.b + h * s.o.h, s.o.n, r0, N);
}

// The online softmax (#15): one block per (b, h, 128 q rows), the q tile
// fastest, two warpgroups of 64 rows. q K^T and p V run on wgmma (q and p
// from registers, K and V through descriptors). Each tile's step starts
// q K^T of the next tile first, so that product runs on the tensor cores
// while this tile's softmax runs on the ALUs and the exponent unit; then p
// V, waited for before the next step. K and V stream through a ring of S
// stages of core-matrix tiles: a step reads tile it (V) and it + 1 (K) and
// refills tile it - 1's stage, S - 2 tiles ahead.
template <int DH>
__global__ void __launch_bounds__(SNT, split_min_blocks(DH))
    split_heads_online_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              bf16* __restrict__ o, const SplitShape s) {
  constexpr int TILE = KR * DH, S = split_stages(DH, false);
  static_assert(S >= 3, "the ring holds tiles it and it + 1 and a refill");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* KV = reinterpret_cast<bf16*>(smem);  // S stages of [K | V]

  const int N = s.N, q_tiles = (N + SR - 1) / SR;
  const int bh = blockIdx.x / q_tiles, b = bh / s.H, h = bh % s.H;
  const int r0 = blockIdx.x % q_tiles * SR + (threadIdx.x >> 5) * 16;
  const bf16* kh = k + b * s.k.b + h * s.k.h;
  const bf16* vh = v + b * s.v.b + h * s.v.h;
  const int nk = (N + KR - 1) / KR;

  CoreCopy<DH> cp;
  cp.init(s.k.n, s.v.n);
  // every call commits a group (empty past the last tile), so the waits
  // count a fixed number of younger groups
  auto fetch = [&](int it) {
    if (it < nk) {
      bf16* Ks = KV + it % S * 2 * TILE;
      cp.copy(Ks, Ks + TILE, kh + (size_t)it * KR * s.k.n,
              vh + (size_t)it * KR * s.v.n, N - it * KR);
    }
    cp_commit();
  };
  auto stage = [&](int it) { return KV + it % S * 2 * TILE; };
  // s = q K^T over tile `it`'s keys, started, not waited for
  uint32_t qa[DH / 16][4];
  auto start_qk = [&](float (&sc)[8][4], int it) {
    const bf16* Ks = stage(it);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      WgMma<64>::run<0>(sc, qa[kk], wg_desc(Ks + kk * 128, 128, 16 * DH),
                        kk);
    wg_commit();
  };

#pragma unroll
  for (int st = 0; st < S - 1; ++st) fetch(st);
  load_q<DH>(qa, q + b * s.q.b + h * s.q.h, s.q.n, r0, N);
  const float c = s.scale * LOG2E;
  float mc[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float acc[DH / 8][4];
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;

  // one tile: sc holds tile it's scores, sn receives tile it + 1's (past
  // the last tile, from a stale stage, and dropped). No branch surrounds a
  // wgmma and both waits drain every group: then ptxas keeps q K^T in
  // flight across the softmax (partial waits made it serialise them all).
  auto step = [&](float (&sc)[8][4], float (&sn)[8][4], int it) {
    cp_wait<S - 3>();
    fence_async_shared();
    __syncthreads();    // tile it + 1 in; every warp done with tile it - 1
    fetch(it + S - 1);  // into tile it - 1's stage
    start_qk(sn, it + 1);
    mask_tile(sc, it * KR, N);
    float corr[2];
    uint32_t hi[4][4], lo[4][4];
    online_probs(sc, c, mc, l, corr, hi, lo);
    wg_wait<0>();  // q K^T of tile it + 1 done
    fence_regs(sn);
    fence_regs(acc);
#pragma unroll
    for (int nt = 0; nt < DH / 8; ++nt) {
      acc[nt][0] *= corr[0];
      acc[nt][1] *= corr[0];
      acc[nt][2] *= corr[1];
      acc[nt][3] *= corr[1];
    }
    const bf16* Vs = stage(it) + TILE;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t vd = wg_desc(Vs + kk * 16 * DH, 16 * DH, 128);
      WgMma<DH>::template run<1>(acc, hi[kk], vd, 1);
      WgMma<DH>::template run<1>(acc, lo[kk], vd, 1);
    }
    wg_commit();
    wg_wait<0>();  // p V of tile it done
    fence_regs(acc);
  };

  float s0[8][4], s1[8][4];
  cp_wait<S - 2>();
  fence_async_shared();
  __syncthreads();  // tile 0 in
  start_qk(s0, 0);
  wg_wait<0>();
  fence_regs(s0);
  int it = 0;
  for (; it + 1 < nk; it += 2) {
    step(s0, s1, it);
    step(s1, s0, it + 1);
  }
  if (it < nk) step(s0, s1, it);
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  store_o<DH, true>(acc, l, o + b * s.o.b + h * s.o.h, s.o.n, r0, N);
}

// Resident route (exact softmax): block -> (b, h, a run of `tpb` 16-row q
// tiles), the run fastest. The head's K and V come into shared memory once
// (K first, so pass 1 starts while V lands); warp w takes the run's tiles
// w, w + 8, ..., prefetching the next tile's q into registers before the
// current tile's pass 2.
template <int DH>
__global__ void __launch_bounds__(SNT, split_min_blocks(DH))
    split_heads_resident_kernel(const bf16* __restrict__ q,
                                const bf16* __restrict__ k,
                                const bf16* __restrict__ v,
                                bf16* __restrict__ o, const SplitShape s,
                                int tpb) {
  constexpr int LD = DH + 8, TILE = KR * LD;
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = s.N, nk = (N + KR - 1) / KR, q16 = (N + 15) / 16;
  const int runs = (q16 + tpb - 1) / tpb;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + nk * TILE;

  const int bh = blockIdx.x / runs, b = bh / s.H, h = bh % s.H;
  const int t_end = min(q16, (blockIdx.x % runs + 1) * tpb);
  const bf16* kh = k + b * s.k.b + h * s.k.h;
  const bf16* vh = v + b * s.v.b + h * s.v.h;
  const bf16* qh = q + b * s.q.b + h * s.q.h;
  bf16* oh = o + b * s.o.b + h * s.o.h;

  for (int kt = 0; kt < nk; ++kt)
    cp_tile<KR, DH, SNT>(Ks + kt * TILE, kh + (size_t)kt * KR * s.k.n, s.k.n,
                         N - kt * KR);
  cp_commit();
  for (int kt = 0; kt < nk; ++kt)
    cp_tile<KR, DH, SNT>(Vs + kt * TILE, vh + (size_t)kt * KR * s.v.n, s.v.n,
                         N - kt * KR);
  cp_commit();

  const float c = s.scale * LOG2E;
  int t = blockIdx.x % runs * tpb + (threadIdx.x >> 5);
  uint32_t qa[DH / 16][4];
  load_q<DH>(qa, qh, s.q.n, t * 16, N);
  cp_wait<1>();
  __syncthreads();  // K in
  for (int i = 0;; ++i, t += SW) {
    const bool mine = t < t_end;
    float mc[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
    if (mine) {
      for (int kt = 0; kt < nk; ++kt) {
        float sc[8][4];
        qk_tile<DH>(sc, qa, Ks + kt * TILE);
        mask_tile(sc, kt * KR, N);
        thread_stats(sc, c, mc, l);
      }
      row_totals(mc, l);
    }
    if (i == 0) {  // every warp, once: V in
      cp_wait<0>();
      __syncthreads();
    }
    if (!mine) break;
    uint32_t qn[DH / 16][4];
    load_q<DH>(qn, qh, s.q.n, (t + SW) * 16, N);
    float acc[DH / 8][4];
#pragma unroll
    for (int nt = 0; nt < DH / 8; ++nt)
      acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
    for (int kt = 0; kt < nk; ++kt) {
      float sc[8][4];
      qk_tile<DH>(sc, qa, Ks + kt * TILE);
      mask_tile(sc, kt * KR, N);
      exact_pv<DH>(acc, sc, c, mc, l, Vs + kt * TILE);
    }
    store_o<DH, false>(acc, l, oh, s.o.n, t * 16, N);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) qa[kk][e] = qn[kk][e];
    }
  }
}

// ------------------------------------------------ f32: the FMA-loop kernel

constexpr int SQ = 64;  // q rows per block, 16 per warp
constexpr int SK = 64;  // keys per tile
constexpr int FWARPS = SQ / 16;
constexpr int FTHREADS = FWARPS * 32;
constexpr int LDF = SK + PADF;

// Shared memory: the q tile and a k tile (row-major, rows padded by 16
// bytes), the v tile transposed (DH x SK), and each warp's p rows.
__host__ __device__ constexpr int ldq_f32(int DH) { return DH + PADF; }
__host__ __device__ inline size_t smem_f32(int DH) {
  return (size_t)((SQ + SK) * ldq_f32(DH) + DH * LDF) * 4 +
         (size_t)FWARPS * 16 * LDF * 4;
}

// dst[r * ld + c] = src[r * sn + c] for r < valid, 0 below, rows of DH
template <int DH>
__device__ void load_tile_f32(float* dst, int ld, const float* __restrict__ src,
                              long long sn, int valid) {
  constexpr int VPR = DH / 4;
  for (int idx = threadIdx.x; idx < 64 * VPR; idx += FTHREADS) {
    const int r = idx / VPR, c = (idx % VPR) * 4;
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < valid) val = *reinterpret_cast<const float4*>(src + r * sn + c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = val;
  }
}

// dst[c * ld + r] = src[r * sn + c]: the tile stored transposed
template <int DH>
__device__ void load_tile_t_f32(float* dst, int ld,
                                const float* __restrict__ src, long long sn,
                                int valid) {
  constexpr int VPR = DH / 4;
  for (int idx = threadIdx.x; idx < 64 * VPR; idx += FTHREADS) {
    const int r = idx / VPR, c = (idx % VPR) * 4;
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < valid) val = *reinterpret_cast<const float4*>(src + r * sn + c);
    dst[c * ld + r] = val.x;
    dst[(c + 1) * ld + r] = val.y;
    dst[(c + 2) * ld + r] = val.z;
    dst[(c + 3) * ld + r] = val.w;
  }
}

// The scores of this warp's 16 rows against the 64 keys in Ks, scaled in
// f32, keys at or past N masked to -inf, in the mma layout of the bf16
// kernels: sc[j][e] is row g + 8 * (e / 2), key j * 8 + 2 * t + e % 2.
template <int DH>
__device__ __forceinline__ void tile_scores_f32(float (&sc)[SK / 8][4],
                                                const float* Qs,
                                                const float* Ks, int r0,
                                                int k0, int N, float scale) {
  constexpr int LD = ldq_f32(DH);
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < SK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* qr = Qs + (r0 + g + 8 * (e / 2)) * LD;
      const float* kr = Ks + (j * 8 + 2 * t + e % 2) * LD;
      float s = 0.0f;
#pragma unroll 8
      for (int c = 0; c < DH; ++c) s = fmaf(qr[c], kr[c], s);
      sc[j][e] = k0 + j * 8 + 2 * t + e % 2 < N ? s * scale : -INFINITY;
    }
  }
}

// acc (this warp's 16 rows x DH, acc[n][e] row g + 8 * (e/2), column n * 8
// + 2 * t + e % 2) += p @ v, p through this warp's rows of Ps, v transposed
// in Vt; FMA sums added once per tile
template <int DH>
__device__ __forceinline__ void tile_pv_f32(float (&acc)[DH / 8][4],
                                            const float (&p)[SK / 8][4],
                                            const float* Vt, float* Ps) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  float* Pw = Ps + (threadIdx.x / 32) * 16 * LDF;
#pragma unroll
  for (int j = 0; j < SK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      Pw[(g + 8 * (e / 2)) * LDF + j * 8 + 2 * t + e % 2] = p[j][e];
  __syncwarp();
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* pr = Pw + (g + 8 * (e / 2)) * LDF;
      const float* vr = Vt + (n * 8 + 2 * t + e % 2) * LDF;
      float s = 0.0f;
#pragma unroll 8
      for (int c = 0; c < SK; ++c) s = fmaf(pr[c], vr[c], s);
      acc[n][e] += s;
    }
  __syncwarp();
}

// One block per (b, h, 64 q rows), the q tile fastest. EXACT: the exact
// softmax (#16, #17); else the online one (#15).
template <int DH, bool EXACT>
__global__ void __launch_bounds__(FTHREADS)
split_heads_f32_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       const SplitShape s) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LD = ldq_f32(DH);
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + SQ * LD;
  float* Vt = Ks + SK * LD;
  float* Ps = Vt + DH * LDF;

  const int N = s.N, q_tiles = (N + SQ - 1) / SQ;
  const int q0 = (blockIdx.x % q_tiles) * SQ;
  const int bh = blockIdx.x / q_tiles, b = bh / s.H, h = bh % s.H;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = (threadIdx.x / 32) * 16;
  const float* qh = q + b * s.q.b + h * s.q.h;
  const float* kh = k + b * s.k.b + h * s.k.h;
  const float* vh = v + b * s.v.b + h * s.v.h;

  load_tile_f32<DH>(Qs, LD, qh + q0 * s.q.n, s.q.n, N - q0);

  // this thread's rows g (index 0) and g + 8 (index 1): the f32 row max
  // (the same across the row's four threads) and this thread's part of the
  // f32 row sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float acc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float sc[SK / 8][4];

  if constexpr (EXACT) {
    // pass 1: the row max and the row sum of exp(s - max)
    for (int k0 = 0; k0 < N; k0 += SK) {
      __syncthreads();
      load_tile_f32<DH>(Ks, LD, kh + k0 * s.k.n, s.k.n, N - k0);
      __syncthreads();
      tile_scores_f32<DH>(sc, Qs, Ks, r0, k0, N, s.scale);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < SK / 8; ++j)
          mx = fmaxf(mx, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
        const float mn = fmaxf(m[r], quad_max(mx));
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < SK / 8; ++j)
          sum += expf(sc[j][2 * r] - mn) + expf(sc[j][2 * r + 1] - mn);
        l[r] = l[r] * expf(m[r] - mn) + sum;
        m[r] = mn;
      }
    }
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
  }

  for (int k0 = 0; k0 < N; k0 += SK) {
    __syncthreads();
    load_tile_f32<DH>(Ks, LD, kh + k0 * s.k.n, s.k.n, N - k0);
    load_tile_t_f32<DH>(Vt, LDF, vh + k0 * s.v.n, s.v.n, N - k0);
    __syncthreads();
    tile_scores_f32<DH>(sc, Qs, Ks, r0, k0, N, s.scale);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if constexpr (EXACT) {
#pragma unroll
        for (int j = 0; j < SK / 8; ++j) {
          sc[j][2 * r] = expf(sc[j][2 * r] - m[r]) / l[r];
          sc[j][2 * r + 1] = expf(sc[j][2 * r + 1] - m[r]) / l[r];
        }
      } else {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < SK / 8; ++j)
          mx = fmaxf(mx, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
        const float mn = fmaxf(m[r], quad_max(mx));
        const float corr = expf(m[r] - mn);
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < SK / 8; ++j) {
          sc[j][2 * r] = expf(sc[j][2 * r] - mn);
          sc[j][2 * r + 1] = expf(sc[j][2 * r + 1] - mn);
          sum += sc[j][2 * r] + sc[j][2 * r + 1];
        }
        l[r] = l[r] * corr + sum;
        m[r] = mn;
#pragma unroll
        for (int n = 0; n < DH / 8; ++n) {
          acc[n][2 * r] *= corr;
          acc[n][2 * r + 1] *= corr;
        }
      }
    }
    tile_pv_f32<DH>(acc, sc, Vt, Ps);
  }

  if constexpr (!EXACT) {
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
  }
  float* oh = o + b * s.o.b + h * s.o.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + 8 * r;
    if (row >= N) continue;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      float x = acc[n][2 * r], y = acc[n][2 * r + 1];
      if constexpr (!EXACT) {
        x /= l[r];
        y /= l[r];
      }
      float* dst = oh + row * s.o.n + n * 8 + 2 * t;
      dst[0] = x;
      dst[1] = y;
    }
  }
}

// --------------------------------------------------------------- launches

// SMs of the current device, or a negative CUDA error
inline int sm_count() {
  int dev = 0, n = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return e == cudaSuccess ? n : -(int)e;
}

template <int DH>
cudaError_t launch_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                        int BH, const SplitShape& s, bool exact,
                        bool resident, cudaStream_t st) {
  cudaError_t e;
  if (resident) {
    // a whole head a block while the grid holds two blocks an SM anyway;
    // else a head's tiles split over up to one block per 8 tiles
    const int sms = sm_count();
    if (sms < 0) return (cudaError_t)-sms;
    const int q16 = (s.N + 15) / 16, want = 2 * sms;
    int runs = 1;
    if (BH < want) {
      const int most = (q16 + SW - 1) / SW, fill = (want + BH - 1) / BH;
      runs = most < fill ? most : fill;
    }
    const int tpb = (q16 + runs - 1) / runs;
    runs = (q16 + tpb - 1) / tpb;
    const size_t bytes = smem_resident(s.N, DH);
    e = set_smem((const void*)split_heads_resident_kernel<DH>, bytes);
    if (e != cudaSuccess) return e;
    split_heads_resident_kernel<DH><<<BH * runs, SNT, bytes, st>>>(q, k, v, o,
                                                                    s, tpb);
    return cudaGetLastError();
  }
  const size_t bytes = smem_stream(DH, exact);
  const int blocks = BH * ((s.N + SR - 1) / SR);
  if (exact) {
    e = set_smem((const void*)split_heads_exact_kernel<DH>, bytes);
    if (e != cudaSuccess) return e;
    split_heads_exact_kernel<DH><<<blocks, SNT, bytes, st>>>(q, k, v, o, s);
  } else {
    e = set_smem((const void*)split_heads_online_kernel<DH>, bytes);
    if (e != cudaSuccess) return e;
    split_heads_online_kernel<DH><<<blocks, SNT, bytes, st>>>(q, k, v, o, s);
  }
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_f32(const float* q, const float* k, const float* v,
                       float* o, int BH, const SplitShape& s, bool exact,
                       cudaStream_t st) {
  const int blocks = BH * ((s.N + SQ - 1) / SQ);
  const size_t bytes = smem_f32(DH);
  auto kern = exact ? split_heads_f32_kernel<DH, true>
                    : split_heads_f32_kernel<DH, false>;
  const cudaError_t e = set_smem((const void*)kern, bytes);
  if (e != cudaSuccess) return e;
  kern<<<blocks, FTHREADS, bytes, st>>>(q, k, v, o, s);
  return cudaGetLastError();
}

bool width_ok(int DH) {
  return DH == 16 || DH == 32 || DH == 64 || DH == 128;
}

// 0 when the kernels take head width DH on the current device,
// T2MS_UNSUPPORTED_SHAPE when they do not, else the CUDA error of the query.
// DH is 16, 32, 64 or 128 (whole 16-wide products over the head, 8-wide
// output tiles, 16-byte rows) and the streaming block's shared memory fits
// what one block may opt in to on this device.
int check_split(int DH, bool bf) {
  if (!width_ok(DH)) return T2MS_UNSUPPORTED_SHAPE;
  const long long optin = smem_optin();
  if (optin < 0) return (int)-optin;
  return (bf ? smem_stream(DH, false) : smem_f32(DH)) <= (size_t)optin
             ? 0
             : T2MS_UNSUPPORTED_SHAPE;
}

template <typename T>
int run_split(const T* q, const T* k, const T* v, T* o, int B, int H, int DH,
              const SplitShape& s, bool exact, bool resident,
              cudaStream_t st) {
  constexpr bool BF = sizeof(T) == 2;
  const int N = s.N;
  if (B < 1 || H < 1 || N < 1 || !width_ok(DH) ||
      (resident && (!BF || !exact)) ||
      (long long)B * H * ((N + 15) / 16) > INT_MAX)
    return T2MS_UNSUPPORTED_SHAPE;
  const long long optin = smem_optin();
  if (optin < 0) return (int)-optin;
  const size_t need = !BF       ? smem_f32(DH)
                      : resident ? smem_resident(N, DH)
                                 : smem_stream(DH, exact);
  if (need > (size_t)optin) return T2MS_UNSUPPORTED_SHAPE;
  const int BH = B * H;
  if constexpr (BF) {
    switch (DH) {
      case 16: return launch_bf16<16>(q, k, v, o, BH, s, exact, resident, st);
      case 32: return launch_bf16<32>(q, k, v, o, BH, s, exact, resident, st);
      case 64: return launch_bf16<64>(q, k, v, o, BH, s, exact, resident, st);
      default: return launch_bf16<128>(q, k, v, o, BH, s, exact, resident, st);
    }
  } else {
    switch (DH) {
      case 16: return launch_f32<16>(q, k, v, o, BH, s, exact, st);
      case 32: return launch_f32<32>(q, k, v, o, BH, s, exact, st);
      case 64: return launch_f32<64>(q, k, v, o, BH, s, exact, st);
      default: return launch_f32<128>(q, k, v, o, BH, s, exact, st);
    }
  }
}

}  // namespace

// resident: the exact kernel's resident route (bf16 only; the caller picks
// it where the head's K and V fit, attention.py split_heads_route)
#define T2MS_SPLIT_ENTRY(SUFFIX, T)                                           \
  extern "C" int split_heads_forward_##SUFFIX(                                \
      const void* q, const void* k, const void* v, void* o, int B, int H,     \
      int N, int DH, long long sqb, long long sqh, long long sqn,             \
      long long skb, long long skh, long long skn, long long svb,             \
      long long svh, long long svn, long long sob, long long soh,             \
      long long son, int exact, int resident, float scale, void* stream) {    \
    const SplitShape s{{sqb, sqh, sqn}, {skb, skh, skn}, {svb, svh, svn},     \
                       {sob, soh, son}, H, N, scale};                         \
    return run_split<T>((const T*)q, (const T*)k, (const T*)v, (T*)o, B, H,  \
                        DH, s, exact != 0, resident != 0,                    \
                        (cudaStream_t)stream);                               \
  }

T2MS_SPLIT_ENTRY(bf16, __nv_bfloat16)
T2MS_SPLIT_ENTRY(f32, float)

extern "C" int split_heads_check(int DH, int is_bf16) {
  return check_split(DH, is_bf16 != 0);
}

// dynamic shared memory of a bf16 launch: the resident route's at N, else
// the streaming one's (for the resource log)
extern "C" long long split_heads_smem(int N, int DH, int exact,
                                      int resident) {
  return resident ? (long long)smem_resident(N, DH)
                  : (long long)smem_stream(DH, exact != 0);
}

extern "C" const char* t2ms_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
