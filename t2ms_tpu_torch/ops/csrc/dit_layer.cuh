// The bf16 forward of one adaLN-zero DiT block on Hopper's tensor cores,
// shared by dit_stack.cu (every layer of fused_dit_stack, and
// fused_dit_block as the stack with L = 1) and dit_block_bwd.cu (the
// backward's recompute of the forward's intermediates). Three launches a
// block, cut at its residual boundaries:
//
//   (a) modln_qkv_tc_kernel   f32 LayerNorm -> *(1+scale)+shift -> cast (in
//       shared memory) -> qkv = T(rows @ wqkv + T(bqkv)), the sum in f32;
//       z_out, if given, receives the modulated rows.
//   (b) heads_fwd_kernel      (attn_heads.cuh) one block per (element, 128
//       q rows, head), two warpgroups on wgmma: q, k and v read in place
//       from qkv (row stride 3*D; K and V by TMA); the merged attention
//       output o, (B*N, D), to a workspace.
//   (c) proj_mlp_tc_kernel    x1 = x + T(gate2) * T(o @ wproj + T(bproj))
//       in T; then LN + modulate(mod[3], mod[4]) -> fc1 + bias ->
//       tanh-GELU -> fc2 + bias -> y = x1 + T(gate5) * h2. The backward's
//       recompute runs its first half only (MLP = false), writing proj and
//       x1.
//
// The recipe and its rounding points are dit_common.cuh's (and JAX's
// _block_math): q scaled at input width, f32 scores, the exact two-pass
// softmax with e = T(exp(T(s - m))) and f32 row sums, normalisation after
// PV, every product summed in f32 with the rounded bias added in f32 and
// then one rounding, tanh-GELU in f32 on the rounded fc1 output, gated
// residuals in T.
//
// Bound on an H100 SXM at the main path's CFG call (2B=512, N=480: 245,760
// rows, D 128, hidden 256): (a) moves 251.7 MB a layer (x in, qkv out)
// against 24.2 GFLOP, 0.075 ms at 3.35 TB/s; (c) moves 188.7 MB (o and x
// in, y out) against 40.3 GFLOP, 0.056 ms. Both are bound by bytes, so the
// design keeps every byte but those in flight and overlaps the phases of
// a tile with the loads and stores of others.
//
// Row kernels (a) and (c), persistent and warp-specialised (wgmma, TMA):
// - Grid: one block an SM (at most; fewer for a short call), 384 threads:
//   two consumer warpgroups and a producer warpgroup, which gives up its
//   registers (setmaxnreg: 40 a thread, the consumers 232). Warpgroup w of
//   block b walks the 64-row tiles (j * grid + b) * 2 + w, j = 0, 1, ...: a
//   fixed order, no atomics, no split-K, so calls repeat bit for bit. The
//   two warpgroups run apart (each its own tiles, its own named barrier),
//   so one's LayerNorm and epilogues overlap the other's products.
// - Producers, one thread of each of three warps, all by TMA into
//   128-byte-swizzled 64-row slabs (zeros past the last row, so ragged row
//   counts need no masks): warp w fills warpgroup w's activation stages (a:
//   the x tile; c: the o tile and the x tile, each on its own mbarrier) as
//   soon as the group releases them, so the next tile lands while this one
//   runs; warp 2 fills the weight slots.
// - Weights on chip: the layer's weights are cut into items of 64 K rows x
//   D columns (D / 64 slabs of 8 KB; fc1's item is D K rows x 64 columns),
//   in the order a tile consumes them: (a) q, k, v column steps by K chunk;
//   (c) proj by K chunk, then per 64-column chunk of hidden an fc1 item and
//   an fc2 item. Where every item fits (D 64 and 128 at the flagship hidden
//   256: wqkv 96 KB, wproj + w1 + w2 160 KB), each block loads them once
//   and keeps them for every tile it walks (resident). Otherwise (D 192,
//   or a wide hidden) the same items stream through a ring of slots, each
//   released by every consumer warp and refilled in the same order for the
//   next tile. The host picks the plan (row_plan) before any launch.
// - Products: wgmma with both operands through 128-byte-swizzle
//   descriptors (A K-major from the tile, B MN-major from the weight
//   item), m64nDk16, so a group's sums for a column step of D are D / 2
//   registers a thread. (a) keeps two sets and two staging tiles, so each
//   column step's products run under the previous step's epilogue. (c)
//   never stores the MLP's hidden tile: per 64 columns of hidden, fc1
//   (m64n64k16, A = z2 from shared memory) gives 32 sums, rounded, GELU'd
//   and packed straight into register-A fragments of fc2, whose sums stay
//   in registers over all of hidden; fc1 of the next chunk runs under this
//   chunk's GELU. At D 192, (c) with the MLP runs proj and the MLP in three
//   passes of 64 output columns (fc1 and the GELU again each pass): its 96
//   registers of sums spilled beside fc1's even at 255 a thread. Every wait
//   drains every group (no partial waits, no wgmma under a branch), so
//   ptxas serialises none (C7512).
// - LayerNorm (wg_modln_rows): two threads a row over the swizzled tile,
//   its chunks read once into registers, statistics in f32 in two passes;
//   (a) normalises the x tile in place, (c) writes z2 over the o tile once
//   proj has read it. x1 is written over the x tile, and y over x1.
// - Epilogues work from registers in wgmma's accumulator layout: bias,
//   rounding, GELU, gated residual (epi_pair, resid_pair's arithmetic on
//   the rounded gate), the residual read from the tile the product's row
//   lands in; (c)'s gate pairs of a thread's first row load under the
//   proj products. The GELU is v / (1 + exp(-2u)) with the exponential on
//   the exponent unit (gelu_fast). Outputs go out by TMA store from shared
//   memory (a: a staging tile a column step; c: the x tile (x1, y) and the
//   o tile (proj)), so a group goes on while its stores drain; rows past
//   the end are clipped by the map. A slot is refilled only once the stores
//   that read it have read it.
// - In-place layers: x and y may be the same buffer; a tile's y rows are
//   its own x rows, loaded before they are stored, and no tile reads
//   another's.
// Probes on an H100 (PERF.md) chose these: the exponential GELU cut (c) by
// a fifth (tanhf's range split serialised it); storing y straight from
// registers made (c) a third slower; fusing z2's LayerNorm into the proj
// epilogue, a reciprocal by Newton steps in the GELU and starting the
// second group half a tile late each moved it by under 3%. Both kernels
// are bound by their groups' own instruction latency, not by a load
// (skipping the activation waits moved (c) by 2%).
// Bf16 geometries at another head width, and f32, keep dit_common.cuh's
// modln_qkv_kernel, attn_proj_kernel and mlp_kernel (tc_route picks from
// the geometry before any launch). D 256 never reaches this route:
// check_shape refuses it for the first kernels' attention tile.

#pragma once

#include "rw_common.cuh"

namespace {

// ----------------- the backward's row-tile helpers (dit_block_bwd.cu)

constexpr int GC = 128;          // output columns of a GEMM chunk
constexpr int GLD = GC + 8;      // padded ring row, elements

// bytes of a padded 64-row bf16 tile of `cols` values a row (the 16 bytes a
// row keep ldmatrix's eight row addresses on distinct banks)
__host__ __device__ constexpr size_t row_tile(int cols) {
  return (size_t)RT * (cols + 8) * 2;
}

// head widths with a heads_fwd_kernel instance
__host__ __device__ constexpr bool tc_head_width(int dh) {
  return dh == 16 || dh == 32 || dh == 64 || dh == 128;
}

// ------------------------------------------------------------ tile copies

// rows [0, valid) of `cols` values of the tile src (row stride lds) out to
// dst (row stride ldd), 16 bytes a thread
__device__ __forceinline__ void st_rows(bf16* dst, size_t ldd,
                                        const bf16* src, int lds, int cols,
                                        int valid) {
  const int ch = cols / 8;
  for (int idx = threadIdx.x; idx < valid * ch; idx += NT) {
    const int r = idx / ch, c = idx % ch * 8;
    *reinterpret_cast<uint4*>(dst + (size_t)r * ldd + c) =
        *reinterpret_cast<const uint4*>(src + r * lds + c);
  }
}

__device__ __forceinline__ void st_bf16x2(bf16* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(lo, hi);
}

// ------------------------------------------------------ the row-tile GEMM

// A block's R rows (64 or 128) by 8 warps: warp w takes rows R/2 * (w / 4)
// on, in WM = R / 32 m16 tiles, and columns 32 * (w % 4) on of each GC-wide
// chunk. Its sums: rows R/2 wr + 16 mi + gr (+ 8), columns 32 wc + 8 nt +
// 2 tq (+ 1).
template <int R> using Acc = float[R / 32][4][4];

// f(r, i, c, v0, v1) for each pair of a warp's sums: tile row r (the
// thread's row i, i = 2 mi + h), chunk column c (even) and c + 1
template <int R, typename F>
__device__ __forceinline__ void for_pairs(const Acc<R>& acc, F&& f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = R / 2 * (warp >> 2) + (lane >> 2);
  const int c0 = 32 * (warp & 3) + 2 * (lane & 3);
#pragma unroll
  for (int mi = 0; mi < R / 32; ++mi)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f(r0 + 16 * mi + 8 * h, 2 * mi + h, c0 + 8 * nt, acc[mi][nt][2 * h],
          acc[mi][nt][2 * h + 1]);
}

// C[R x ncols] = A[R x K] @ W[K x ncols] in f32, chunk by chunk of GC
// columns: A is a padded tile in shared memory (row stride lda), W row-major
// in device memory (row stride ncols), through a ring of GS stages of GKS
// weight rows (GKS * GS = 128); K a multiple of GKS, ncols of 64. pro() runs
// once the ring's first stages are in flight (a prologue that fills A
// overlaps them); epi(c0, acc) gets each chunk's sums, is called by every
// thread and may hold barriers. Ends with a barrier, so the caller may
// overwrite A and the ring.
template <int R, int GKS, int GS, typename Pro, typename Epi>
__device__ __forceinline__ void tile_gemm(const bf16* As, int lda,
                                          const bf16* __restrict__ W, int K,
                                          int ncols, bf16* ring, Pro&& pro,
                                          Epi&& epi) {
  constexpr int WM = R / 32;
  const int warp = threadIdx.x >> 5, wr = warp >> 2, wc = warp & 3;
  const int total = (ncols + GC - 1) / GC * (K / GKS);
  // slice `it` is weight rows [fk, fk + GKS) of the chunk at column fc, in
  // stage it % GS; every call commits a group (empty past the last), so the
  // wait below counts GS - 2 younger ones
  int fit = 0, fk = 0, fc = 0;
  auto fetch = [&]() {
    if (fit < total) {
      const int ch = min(GC, ncols - fc) / 8;
      bf16* dst = ring + fit % GS * (GKS * GLD);
      const bf16* src = W + (size_t)fk * ncols + fc;
      for (int idx = threadIdx.x; idx < GKS * ch; idx += NT) {
        const int r = idx / ch, c = idx % ch * 8;
        cp16(dst + r * GLD + c, src + (size_t)r * ncols + c, true);
      }
      fk += GKS;
      if (fk == K) fk = 0, fc += GC;
    }
    ++fit;
    cp_commit();
  };
#pragma unroll
  for (int s = 0; s < GS - 1; ++s) fetch();
  pro();
  Acc<R> acc;
  auto zero = [&] {
#pragma unroll
    for (int mi = 0; mi < WM; ++mi)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        acc[mi][nt][0] = acc[mi][nt][1] = acc[mi][nt][2] = acc[mi][nt][3] =
            0.f;
  };
  zero();
  int c0 = 0, k0 = 0;
  for (int it = 0; it < total; ++it) {
    cp_wait<GS - 2>();
    __syncthreads();  // slice `it` in; every warp done with slice it - 1
    fetch();          // into the stage slice it - 1 used
    const bf16* Ws = ring + it % GS * (GKS * GLD);
    if (c0 + 32 * wc < ncols) {  // a chunk of 64 columns leaves wc 2, 3 idle
#pragma unroll
      for (int kk = 0; kk < GKS / 16; ++kk) {
        uint32_t a[WM][4];
#pragma unroll
        for (int mi = 0; mi < WM; ++mi)
          ld_a(a[mi], As, lda, R / 2 * wr + 16 * mi, k0 + 16 * kk);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          uint32_t b[4];
          ld_bt(b, Ws, GLD, 16 * kk, 32 * wc + 16 * p);
#pragma unroll
          for (int mi = 0; mi < WM; ++mi) {
            mma16816(acc[mi][2 * p], a[mi], b[0], b[1]);
            mma16816(acc[mi][2 * p + 1], a[mi], b[2], b[3]);
          }
        }
      }
    }
    k0 += GKS;
    if (k0 == K) {
      epi(c0, acc);
      zero();
      k0 = 0;
      c0 += GC;
    }
  }
  cp_wait<0>();  // only empty groups are left
  __syncthreads();
}

// ===================================================== the forward row kernels

// (c)'s MLP output columns a pass: all D up to 128; at D 192 three passes
// of 64 (each recomputes fc1 and the GELU), since 96 registers of fc2 sums
// beside fc1's spill even at 255 a thread
__host__ __device__ constexpr int mlp_cols(int D) { return D > 128 ? 64 : D; }
constexpr int RW_SLOTS = 32;            // weight slots at most
constexpr int RW_STAGES = 2;            // activation stages a group at most

// the widths with an instance of both kernels
__host__ __device__ constexpr bool rw_width(int D) {
  return D == 64 || D == 128 || D == 192;
}

// A kernel's shared memory: `slots` weight items of 128 * D bytes (resident
// when slots >= items, else a ring), `stages` activation stages a group,
// and the dynamic bytes of the whole (slots 0: no plan fits).
struct RowPlan {
  int items, slots, stages;
  size_t smem;
};

// The plan for `items` weight items and a group's `stage` bytes a stage
// plus `fixed` bytes: resident with the deepest activation ring that fits,
// else streamed with two stages where four weight slots remain, else one
// stage and at least two slots; never fewer than `least`, the items a
// group holds at once.
inline RowPlan row_plan(int D, int items, size_t stage, size_t fixed,
                        int least, long long optin) {
  RowPlan p{items, 0, 0, 0};
  if (optin <= 0 || !rw_width(D)) return p;
  const size_t item = (size_t)128 * D;
  const size_t budget = (size_t)optin - RW_STATIC - WG_ALIGN;
  auto act = [&](int st) { return (size_t)RW_WG * (st * stage + fixed); };
  for (int st = RW_STAGES; st >= 1 && !p.slots; --st)
    if (items <= RW_SLOTS && act(st) + items * item <= budget)
      p.slots = items, p.stages = st;
  for (int st = RW_STAGES; st >= 1 && !p.slots; --st) {
    if (act(st) > budget) continue;
    size_t s = (budget - act(st)) / item;
    if (s > RW_SLOTS) s = RW_SLOTS;
    if (s >= (st == 1 ? 2u : 4u) && s >= (size_t)least)
      p.slots = (int)s, p.stages = st;
  }
  if (p.slots) p.smem = WG_ALIGN + act(p.stages) + (size_t)p.slots * item;
  return p;
}
// (a): 3 D / 64 items, two column steps' held at once up to D 128; a
// stage is the x tile, plus two staging tiles a group
inline RowPlan plan_qkv(int D, long long optin) {
  return row_plan(D, 3 * D / 64, (size_t)128 * D, (size_t)256 * D,
                  (D <= 128 ? 2 : 1) * D / 64, optin);
}
// (c): D / 64 proj items and, with the MLP, two items a 64 columns of
// hidden a pass; a stage is the o tile and the x tile
inline RowPlan plan_mlp(int D, int hidden, bool mlp, long long optin) {
  return row_plan(D, D / 64 + (mlp ? D / mlp_cols(D) * hidden / 32 : 0),
                  (size_t)256 * D, 0, D / 64 > 2 ? D / 64 : 2, optin);
}
// their dynamic shared memory (LLONG_MAX: no plan fits)
inline size_t smem_qkv_tc(int D) {
  const RowPlan p = plan_qkv(D, smem_optin());
  return p.slots ? p.smem : (size_t)LLONG_MAX;
}
inline size_t smem_mlp_tc(int D, int hidden, bool mlp) {
  const RowPlan p = plan_mlp(D, hidden, mlp, smem_optin());
  return p.slots ? p.smem : (size_t)LLONG_MAX;
}

// Whether a bf16 block at this geometry (which check_shape has taken) runs
// on the kernels below: a head width heads_fwd_kernel takes, a width with
// row-kernel instances, a plan for each row kernel and the attention's
// shared memory within the device's opt-in, and the attention grid within
// an int. Otherwise it runs on dit_common.cuh's three kernels.
inline bool tc_route(int B, int N, int D, int hidden, int H) {
  if (H < 1 || D % H || !tc_head_width(D / H) || !rw_width(D) ||
      hidden < 64 || hidden % 64)
    return false;
  const long long optin = smem_optin();
  return optin > 0 && plan_qkv(D, optin).slots &&
         plan_mlp(D, hidden, true, optin).slots &&
         plan_mlp(D, hidden, false, optin).slots &&
         smem_fwd(D / H) <= (size_t)optin && fwd_blocks(B, N, H) <= INT_MAX;
}

struct RowArgs {
  const float* mod;                 // (B, L, 6, D) adaLN vectors, f32
  const bf16* bias;                 // (a) bqkv, (c) bproj
  const bf16* b1;                   // (c) fc1's bias
  const bf16* b2;                   // (c) fc2's bias
  int rows, N, L, l, hidden;
  float eps;
  int items, slots, stages;         // the plan
  int z, proj, x1;                  // optional outputs given
};

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// block iterations of this block over `tiles` 64-row tiles, and warpgroup
// w's tile in iteration j
__device__ __forceinline__ int rw_iters(int tiles) {
  const int nb = (tiles + RW_WG - 1) / RW_WG;
  return (nb - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
}
__device__ __forceinline__ int rw_tile(int j, int w) {
  return (j * (int)gridDim.x + (int)blockIdx.x) * RW_WG + w;
}

// The weight slots: item k of block iteration j sits in slot k (resident:
// loaded once, never released) or in slot (j * items + k) % slots, and is
// released by every consumer warp once its products have read it.
struct WRing {
  uint64_t* full;
  uint64_t* empty;
  int items, slots;
  __device__ bool resident() const { return slots >= items; }
  __device__ int slot(int j, int k) const {
    return resident() ? k : (j * items + k) % slots;
  }
  __device__ void wait(int j, int k) const {
    mbar_wait(&full[slot(j, k)],
              resident() ? 0 : ((j * items + k) / slots) & 1);
  }
  __device__ void release(int j, int k) const {
    if (!resident() && (threadIdx.x & 31) == 0)
      mbar_arrive(&empty[slot(j, k)]);
  }
  // a group without a tile in iteration j passes its items on
  __device__ void drain(int j) const {
    if (resident()) return;
    for (int k = 0; k < items; ++k) {
      wait(j, k);
      release(j, k);
    }
  }
  // by the weight producer: every item once (resident) or each iteration's
  // in turn, into slots of ITEM bytes; load(dst, k, bar) arms bar with item
  // k's bytes and issues its copies
  template <int ITEM, typename Load>
  __device__ void produce(unsigned char* wsl, int iters, Load&& load) const {
    const int n = resident() ? 1 : iters;
    for (int j = 0; j < n; ++j)
      for (int k = 0; k < items; ++k) {
        const int it = j * items + k, s = resident() ? k : it % slots;
        if (!resident() && it >= slots)
          mbar_wait(&empty[s], (it / slots - 1) & 1);
        load(wsl + (size_t)s * ITEM, k, &full[s]);
      }
  }
};

// ---------------------------------------------------------------------------
// (a) qkv = T(modLN(x; mod[0], mod[1]) @ w + T(bias)); z_out, if given,
//     receives the modulated LN rows. Per tile: the x tile lands by TMA,
//     is normalised in place, then three column steps of D (q, k, v), each
//     D / 64 wgmma groups over the resident or streamed weight items, the
//     epilogue into the group's staging tile and out by TMA store.

template <int D>
__global__ void __launch_bounds__(RW_NT, 1)
    modln_qkv_tc_kernel(const RowArgs g,
                        const __grid_constant__ CUtensorMap m_x,
                        const __grid_constant__ CUtensorMap m_w,
                        const __grid_constant__ CUtensorMap m_q,
                        const __grid_constant__ CUtensorMap m_z) {
  constexpr int NK = D / 64, TILE = 128 * D;
  extern __shared__ unsigned char rw_raw[];
  __shared__ uint64_t wfull[RW_SLOTS], wempty[RW_SLOTS];
  __shared__ uint64_t afull[RW_WG][RW_STAGES], aempty[RW_WG][RW_STAGES];
  unsigned char* wsl = align_atoms(rw_raw);  // the weight slots
  // a group's stages (the x tile, normalised in place), its two staging
  // tiles
  unsigned char* acts = wsl + (size_t)g.slots * TILE;
  const size_t group = (size_t)(g.stages + 2) * TILE;
  const WRing wr{wfull, wempty, g.items, g.slots};
  const int tid = threadIdx.x, tiles = (g.rows + 63) / 64;
  const int iters = rw_iters(tiles);
  if (tid == 0) {
    for (int i = 0; i < g.slots; ++i) {
      mbar_init(&wfull[i], 1);
      mbar_init(&wempty[i], RW_NC / 32);
    }
    for (int w = 0; w < RW_WG; ++w)
      for (int s = 0; s < g.stages; ++s) {
        mbar_init(&afull[w][s], 1);
        mbar_init(&aempty[w][s], 4);
      }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= RW_NC) {
    regs_dec<RW_PRODUCER_REGS>();
    const int pw = (tid - RW_NC) >> 5;
    if ((tid & 31) != 0 || pw > RW_WG) return;
    if (pw < RW_WG) {
      // group pw's x tiles, a stage refilled once the group releases it
      for (int j = 0; j < iters; ++j) {
        const int t = rw_tile(j, pw);
        if (t >= tiles) break;
        const int s = j % g.stages;
        if (j >= g.stages) mbar_wait(&aempty[pw][s], (j / g.stages - 1) & 1);
        unsigned char* X = acts + pw * group + (size_t)s * TILE;
        mbar_expect(&afull[pw][s], TILE);
#pragma unroll
        for (int kc = 0; kc < NK; ++kc)
          tma_load(X + kc * 8192, &m_x, 64 * kc, 64 * t, &afull[pw][s]);
      }
    } else {
      // item k: K chunk k % NK of column step k / NK, D / 64 slabs
      const CUtensorMap* mw = &m_w;
      wr.produce<TILE>(wsl, iters, [=](unsigned char* dst, int k,
                                       uint64_t* bar) {
        const int cs = k / NK, kc = k % NK;
        mbar_expect(bar, TILE);
#pragma unroll
        for (int jj = 0; jj < NK; ++jj)
          tma_load(dst + jj * 8192, mw, cs * D + 64 * jj, 64 * kc, bar);
      });
    }
    return;
  }

  // The consumers: warpgroup w, its rows 16 warp + lane / 4 (+ 8) of a tile
  regs_inc<RW_CONSUMER_REGS>();
  const int w = tid >> 7, wt = tid & 127, warp = wt >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  unsigned char* grp = acts + w * group;
  unsigned char* Cs = grp + (size_t)g.stages * TILE;  // two staging tiles
  const uint32_t wsl_at = sm_addr(wsl);
  float acc0[D / 8][4], acc1[D / 8][4];
  int sb = 0;  // the staging tile next written
  for (int j = 0; j < iters; ++j) {
    const int t = rw_tile(j, w);
    if (t >= tiles) {
      wr.drain(j);
      continue;
    }
    const int s = j % g.stages, r0 = 64 * t, valid = min(64, g.rows - r0);
    unsigned char* X = grp + (size_t)s * TILE;
    mbar_wait(&afull[w][s], (j / g.stages) & 1);
    wg_modln_rows<64, 128, D / 16>(X, X, valid, D, g.eps, 0, 1, wt, [&](int i) {
      return g.mod + ((size_t)((r0 + i) / g.N) * g.L + g.l) * 6 * D;
    });
    fence_async_shared();  // the LayerNorm's stores, to wgmma and TMA
    bar_sync(1 + w, 128);
    if (g.z && wt == 0) {
#pragma unroll
      for (int kc = 0; kc < NK; ++kc)
        tma_store(&m_z, X + kc * 8192, 64 * kc, r0);
      bulk_commit();
    }
    const uint32_t xa = sm_addr(X);
    // column step cs (q, k or v) into a, started, not waited for
    auto issue = [&](float (&a)[D / 8][4], int cs) {
#pragma unroll
      for (int kc = 0; kc < NK; ++kc) {
        const int k = cs * NK + kc;
        wr.wait(j, k);
        const uint32_t a0 = xa + kc * 8192;
        const uint32_t b0 = wsl_at + wr.slot(j, k) * TILE;
        wg_fence();
#pragma unroll
        for (int s4 = 0; s4 < 4; ++s4)
          WgSS<D>::run(a, sw128_desc(a0 + 32 * s4, 16),
                       sw128_desc(b0 + 2048 * s4, 8192), kc > 0 || s4 > 0);
        wg_commit();
      }
    };
    // after the wait that drains step cs: its items go back to the ring
    auto drained = [&](float (&a)[D / 8][4], int cs) {
      fence_regs(a);
#pragma unroll
      for (int kc = 0; kc < NK; ++kc) wr.release(j, cs * NK + kc);
    };
    // step cs's epilogue into the next staging tile, then out: the tile
    // is free once the store two steps back has read it
    auto epi = [&](const float (&a)[D / 8][4], int cs) {
      unsigned char* C = Cs + sb * TILE;
      sb ^= 1;
      if (wt == 0) bulk_wait<1, true>();
      bar_sync(1 + w, 128);
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        const uint32_t bp = ld_pair(g.bias + cs * D + 8 * nt + 2 * tq);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint32_t*>(
              C + out_at(16 * warp + gr + 8 * h, nt) + 4 * tq) =
              bias_pair<WG_EPI_BIAS>(a[nt], h, bp);
      }
      fence_async_shared();
      bar_sync(1 + w, 128);
      if (wt == 0) {
#pragma unroll
        for (int jj = 0; jj < NK; ++jj)
          tma_store(&m_q, C + jj * 8192, cs * D + 64 * jj, r0);
        bulk_commit();
      }
    };
    if constexpr (D <= 128) {
      // each step's products run under the previous step's epilogue
      issue(acc0, 0);
      wg_wait<0>();
      drained(acc0, 0);
      issue(acc1, 1);
      epi(acc0, 0);
      wg_wait<0>();
      drained(acc1, 1);
      issue(acc0, 2);
      epi(acc1, 1);
      wg_wait<0>();
      drained(acc0, 2);
      epi(acc0, 2);
    } else {  // D 192: one accumulator set (96 registers a thread)
      for (int cs = 0; cs < 3; ++cs) {
        issue(acc0, cs);
        wg_wait<0>();
        drained(acc0, cs);
        epi(acc0, cs);
      }
    }
    // the stage is free once the products and the z store have read it
    if (wt == 0) bulk_wait<1, true>();
    __syncwarp();
    if (lane == 0) mbar_arrive(&aempty[w][s]);
  }
  if (wt == 0) bulk_wait<0, false>();
}

// ---------------------------------------------------------------------------
// (c) x1 = x + T(gate2) * T(o @ wproj + T(bproj)); with MLP, then
//     y = x1 + T(gate5) * T(gelu(T(modLN(x1; mod[3], mod[4]) @ w1 + T(b1)))
//     @ w2 + T(b2)). Without MLP, proj_out and x1_out, if given, receive
//     proj and x1 (the MLP variant writes neither: run_layer_tc refuses).
//     x and y may be the same buffer (the stack's layers after the first):
//     a tile's y rows are its own x rows, loaded before they are stored.

template <int D, bool MLP>
__global__ void __launch_bounds__(RW_NT, 1)
    proj_mlp_tc_kernel(const RowArgs g, const __grid_constant__ CUtensorMap m_o,
                       const __grid_constant__ CUtensorMap m_x,
                       const __grid_constant__ CUtensorMap m_wp,
                       const __grid_constant__ CUtensorMap m_w1,
                       const __grid_constant__ CUtensorMap m_w2,
                       const __grid_constant__ CUtensorMap m_y,
                       const __grid_constant__ CUtensorMap m_p,
                       const __grid_constant__ CUtensorMap m_x1) {
  constexpr int NK = D / 64, TILE = 128 * D;
  // output columns a pass of proj and of the MLP, passes (one without the
  // MLP, whose proj_out needs every column at once)
  constexpr int NP = MLP ? mlp_cols(D) : D, PASSES = D / NP;
  // the optional outputs: the first half's only
  const bool proj = !MLP && g.proj, x1 = !MLP && g.x1;
  extern __shared__ unsigned char rw_raw[];
  __shared__ uint64_t wfull[RW_SLOTS], wempty[RW_SLOTS];
  // a stage's two halves: 0 the o tile (then z2, or proj), 1 the x tile
  // (then x1, then y), each on its own barriers
  __shared__ uint64_t afull[RW_WG][RW_STAGES][2], aempty[RW_WG][RW_STAGES][2];
  unsigned char* wsl = align_atoms(rw_raw);
  unsigned char* acts = wsl + (size_t)g.slots * TILE;
  const size_t group = (size_t)g.stages * 2 * TILE;
  const WRing wr{wfull, wempty, g.items, g.slots};
  const int tid = threadIdx.x, tiles = (g.rows + 63) / 64;
  const int iters = rw_iters(tiles);
  if (tid == 0) {
    for (int i = 0; i < g.slots; ++i) {
      mbar_init(&wfull[i], 1);
      mbar_init(&wempty[i], RW_NC / 32);
    }
    for (int w = 0; w < RW_WG; ++w)
      for (int s = 0; s < g.stages; ++s)
        for (int u = 0; u < 2; ++u) {
          mbar_init(&afull[w][s][u], 1);
          mbar_init(&aempty[w][s][u], 4);
        }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= RW_NC) {
    regs_dec<RW_PRODUCER_REGS>();
    const int pw = (tid - RW_NC) >> 5;
    if ((tid & 31) != 0 || pw > RW_WG) return;
    if (pw < RW_WG) {
      // group pw's o and x tiles, each half refilled once released
      for (int j = 0; j < iters; ++j) {
        const int t = rw_tile(j, pw);
        if (t >= tiles) break;
        const int s = j % g.stages;
        unsigned char* O = acts + pw * group + (size_t)s * 2 * TILE;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (j >= g.stages)
            mbar_wait(&aempty[pw][s][u], (j / g.stages - 1) & 1);
          mbar_expect(&afull[pw][s][u], TILE);
#pragma unroll
          for (int kc = 0; kc < NK; ++kc)
            tma_load(O + u * TILE + kc * 8192, u ? &m_x : &m_o, 64 * kc, 64 * t,
                     &afull[pw][s][u]);
        }
      }
    } else {
      // items: proj's K chunks, then a pass at a time, per 64 columns hc
      // of hidden, fc1's (D K rows of those columns) and fc2's (those 64 K
      // rows, the pass's NP columns)
      const CUtensorMap *mp = &m_wp, *m1 = &m_w1, *m2 = &m_w2;
      const int nh2 = g.hidden / 32;
      wr.produce<TILE>(wsl, iters, [=](unsigned char* dst, int k,
                                       uint64_t* bar) {
        if (k < NK) {
          mbar_expect(bar, TILE);
#pragma unroll
          for (int jj = 0; jj < NK; ++jj)
            tma_load(dst + jj * 8192, mp, 64 * jj, 64 * k, bar);
        } else {
          const int q = (k - NK) % nh2, part = (k - NK) / nh2, hc = q >> 1;
          if (q & 1) {
            mbar_expect(bar, 128 * NP);
#pragma unroll
            for (int jj = 0; jj < NP / 64; ++jj)
              tma_load(dst + jj * 8192, m2, part * NP + 64 * jj, 64 * hc, bar);
          } else {
            mbar_expect(bar, TILE);
#pragma unroll
            for (int jj = 0; jj < NK; ++jj)
              tma_load(dst + jj * 8192, m1, 64 * hc, 64 * jj, bar);
          }
        }
      });
    }
    return;
  }

  regs_inc<RW_CONSUMER_REGS>();
  const int w = tid >> 7, wt = tid & 127, warp = wt >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  unsigned char* grp = acts + w * group;
  const uint32_t wsl_at = sm_addr(wsl);
  // the adaLN block of a tile row (the last row's past the end)
  auto modrow = [&](int r) {
    const int b = min(r, g.rows - 1) / g.N;
    return g.mod + ((size_t)b * g.L + g.l) * 6 * D;
  };
  for (int j = 0; j < iters; ++j) {
    const int t = rw_tile(j, w);
    if (t >= tiles) {
      wr.drain(j);
      continue;
    }
    const int s = j % g.stages, r0 = 64 * t, valid = min(64, g.rows - r0);
    const int ph = (j / g.stages) & 1;
    unsigned char* O = grp + (size_t)s * 2 * TILE;
    unsigned char* X = O + TILE;
    const uint32_t oa = sm_addr(O);
    mbar_wait(&afull[w][s][0], ph);
    // the gate's pairs of the element of the thread's first row, loaded
    // under the products; its second row is nearly always of the same
    // element and reads its own only where it is not (at D 192 both rows
    // read theirs in the epilogue: registers)
    constexpr bool PRE = D <= 128;
    const int i0 = 16 * warp + gr;
    const bool same =
        min(r0 + i0, g.rows - 1) / g.N == min(r0 + i0 + 8, g.rows - 1) / g.N;
    auto gate2 = [&](int h, int c8) {
      return gate_pair(modrow(r0 + i0 + 8 * h) + 2 * D + 2 * tq + 8 * c8);
    };
    // proj a pass of NP columns at a time (one pass up to D 128): its sums,
    // then x1 = x + T(T(gate2) * proj) over those columns of the x tile and,
    // once every warp's products have read the o tile, proj over it
    for (int part = 0; part < PASSES; ++part) {
      const int c8 = part * NP / 8;  // the pass's first 8-column tile
      float acc[NP / 8][4];
#pragma unroll
      for (int kc = 0; kc < NK; ++kc) {
        wr.wait(j, kc);
        const uint32_t b0 = wsl_at + wr.slot(j, kc) * TILE + c8 * 1024;
        wg_fence();
#pragma unroll
        for (int s4 = 0; s4 < 4; ++s4)
          WgSS<NP>::run(acc, sw128_desc(oa + kc * 8192 + 32 * s4, 16),
                        sw128_desc(b0 + 2048 * s4, 8192), kc > 0 || s4 > 0);
        wg_commit();
      }
      uint32_t g2[PRE ? NP / 8 : 1];
      if constexpr (PRE) {
#pragma unroll
        for (int nt = 0; nt < NP / 8; ++nt) g2[nt] = gate2(0, nt);
      }
      wg_wait<0>();
      fence_regs(acc);
      if (part == PASSES - 1) {
#pragma unroll
        for (int kc = 0; kc < NK; ++kc) wr.release(j, kc);
      }
      if (part == 0) mbar_wait(&afull[w][s][1], ph);
      if (proj) bar_sync(1 + w, 128);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 16 * warp + gr + 8 * h;
#pragma unroll
        for (int nt = 0; nt < NP / 8; ++nt) {
          uint32_t gv;
          if constexpr (PRE)
            gv = h == 0 || same ? g2[nt] : gate2(h, nt);
          else
            gv = gate2(h, c8 + nt);
          const uint32_t v = bias_pair<WG_EPI_RESID>(
              acc[nt], h, ld_pair(g.bias + 8 * (c8 + nt) + 2 * tq));
          uint32_t* xp =
              reinterpret_cast<uint32_t*>(X + out_at(i, c8 + nt) + 4 * tq);
          *xp = resid2(v, *xp, gv);
          if (proj)  // one pass: its products were the o tile's last reads
            *reinterpret_cast<uint32_t*>(O + out_at(i, nt) + 4 * tq) = v;
        }
      }
    }
    fence_async_shared();
    bar_sync(1 + w, 128);
    if (wt == 0 && (x1 || proj)) {
#pragma unroll
      for (int kc = 0; kc < NK; ++kc) {
        if (x1) tma_store(&m_x1, X + kc * 8192, 64 * kc, r0);
        if (proj) tma_store(&m_p, O + kc * 8192, 64 * kc, r0);
      }
      bulk_commit();
    }
    if constexpr (MLP) {
      // (the loop form at D 192: registers)
      wg_modln_rows<64, 128, D <= 128 ? D / 16 : 0>(
          X, O, valid, D, g.eps, 3, 4, wt,
          [&](int i) { return modrow(r0 + i); });
      fence_async_shared();
      bar_sync(1 + w, 128);
      // per 64 columns hc of hidden: a1 = z2 @ w1[:, hc] (32 sums), h =
      // T(gelu(T(a1 + b1))) packed into fc2's A fragments, acc2 += h @
      // w2[hc, the pass's NP columns]. Up to D 128, fc1 of chunk hc + 1
      // runs under chunk hc's GELU, and the one wait after fc2 drains both
      // (every stage ends inside its step).
      const int nh = g.hidden / 64;
      for (int part = 0; part < PASSES; ++part) {
        const int kb = NK + part * 2 * nh;  // the pass's first item
        float acc2[NP / 8][4];
        float a1a[8][4], a1b[8][4];
        auto fc1 = [&](float (&a1)[8][4], int hc) {
          const int k1 = kb + 2 * hc;
          wr.wait(j, k1);
          const uint32_t w1a = wsl_at + wr.slot(j, k1) * TILE;
          const uint32_t za = opaque(oa);
          wg_fence();
#pragma unroll
          for (int s16 = 0; s16 < D / 16; ++s16)
            WgSS<64>::run(
                a1, sw128_desc(za + (s16 >> 2) * 8192 + 32 * (s16 & 3), 16),
                sw128_desc(w1a + 2048 * s16, 8192), s16 > 0);
          wg_commit();
        };
        // chunk hc's GELU and fc2 from a1 (its fc1 done)
        auto fc2 = [&](const float (&a1)[8][4], int hc) {
          uint32_t hf[4][4];
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const uint32_t bp = ld_pair(g.b1 + 64 * hc + 8 * nt + 2 * tq);
#pragma unroll
            for (int h = 0; h < 2; ++h)
              hf[nt >> 1][(nt & 1) * 2 + h] = gelu_pair(a1[nt], h, bp);
          }
          const int k2 = kb + 2 * hc + 1;
          wr.wait(j, k2);
          const uint32_t w2a = wsl_at + wr.slot(j, k2) * TILE;
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            WgMma<NP>::template run<1>(acc2, hf[kk],
                                       sw128_desc(w2a + 2048 * kk, 8192),
                                       hc > 0 || kk > 0);
          wg_commit();
        };
        // a step: fc1 of hc + 1 into nxt, then chunk hc from cur; one wait
        auto step = [&](const float (&cur)[8][4], float (&nxt)[8][4],
                        int hc) {
          fc1(nxt, hc + 1);
          fc2(cur, hc);
          wg_wait<0>();
          fence_regs(nxt);
          wr.release(j, kb + 2 * hc + 2);
          wr.release(j, kb + 2 * hc + 1);
        };
        // the last chunk: after the last pass's, z2 has had its last
        // reader, so the o tile is free
        auto last = [&](const float (&cur)[8][4], int hc) {
          if (part == PASSES - 1) {
            __syncwarp();
            if (lane == 0) mbar_arrive(&aempty[w][s][0]);
          }
          fc2(cur, hc);
          wg_wait<0>();
          wr.release(j, kb + 2 * hc + 1);
        };
        fc1(a1a, 0);
        wg_wait<0>();
        fence_regs(a1a);
        wr.release(j, kb);
        if constexpr (PASSES == 1) {
          int hc = 0;
          for (; hc + 2 < nh; hc += 2) {
            step(a1a, a1b, hc);
            step(a1b, a1a, hc + 1);
          }
          if (nh - hc == 2) {
            step(a1a, a1b, hc);
            last(a1b, hc + 1);
          } else {
            last(a1a, hc);
          }
        } else {  // one set of fc1 sums, each chunk in turn
          for (int hc = 0; hc + 1 < nh; ++hc) {
            fc2(a1a, hc);
            wg_wait<0>();
            wr.release(j, kb + 2 * hc + 1);
            fc1(a1a, hc + 1);
            wg_wait<0>();
            fence_regs(a1a);
            wr.release(j, kb + 2 * hc + 2);
          }
          last(a1a, nh - 1);
        }
        fence_regs(acc2);
        // y = x1 + T(T(gate5) * h2) over the pass's columns of the x tile
        const int c8 = part * NP / 8;  // its first 8-column tile
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 16 * warp + gr + 8 * h;
          const float* gate = modrow(r0 + i) + 5 * D + 2 * tq + 8 * c8;
#pragma unroll
          for (int nt = 0; nt < NP / 8; ++nt) {
            const uint32_t v = bias_pair<WG_EPI_RESID>(
                acc2[nt], h, ld_pair(g.b2 + 8 * (c8 + nt) + 2 * tq));
            uint32_t* xp = reinterpret_cast<uint32_t*>(
                X + out_at(i, c8 + nt) + 4 * tq);
            *xp = resid2(v, *xp, gate_pair(gate + 8 * nt));
          }
        }
      }
      fence_async_shared();
      bar_sync(1 + w, 128);
      if (wt == 0) {
#pragma unroll
        for (int kc = 0; kc < NK; ++kc)
          tma_store(&m_y, X + kc * 8192, 64 * kc, r0);
        bulk_commit();
        bulk_wait<0, true>();
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&aempty[w][s][1]);
    } else {
      if (wt == 0) bulk_wait<0, true>();
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(&aempty[w][s][0]);
        mbar_arrive(&aempty[w][s][1]);
      }
    }
  }
  if (wt == 0) bulk_wait<0, false>();
}

// --------------------------------------------------------------- launches

// (b) for every (element, q tile, head), q, k and v the column slices of
// qkv; m_out and r_out, if given, receive each row's max and sum
template <int DH>
cudaError_t launch_layer_attn_dh(const bf16* qkv, bf16* o, int B, int N,
                                 int D, int H, float qscale, float* m_out,
                                 float* r_out, cudaStream_t st) {
  const long long sb = (long long)N * 3 * D, sn = 3 * D;
  return launch_fwd_bf16<DH>(qkv, qkv + D, qkv + 2 * D, sb, sn, sb, sn, sb,
                             sn, o, B, N, D, H, qscale, st, nullptr, m_out,
                             r_out);
}

inline cudaError_t launch_layer_attn(const bf16* qkv, bf16* o, int B, int N,
                                     int D, int H, float qscale,
                                     float* m_out, float* r_out,
                                     cudaStream_t st) {
  switch (D / H) {
    case 16:
      return launch_layer_attn_dh<16>(qkv, o, B, N, D, H, qscale, m_out,
                                      r_out, st);
    case 32:
      return launch_layer_attn_dh<32>(qkv, o, B, N, D, H, qscale, m_out,
                                      r_out, st);
    case 64:
      return launch_layer_attn_dh<64>(qkv, o, B, N, D, H, qscale, m_out,
                                      r_out, st);
    default:
      return launch_layer_attn_dh<128>(qkv, o, B, N, D, H, qscale, m_out,
                                       r_out, st);
  }
}

// The three launches of one layer at width D (run_layer_tc's arguments)
template <int D>
cudaError_t run_layer_rows(
    const bf16* x, const float* mod, const bf16* wqkv, const bf16* bqkv,
    const bf16* wproj, const bf16* bproj, const bf16* wfc1, const bf16* bfc1,
    const bf16* wfc2, const bf16* bfc2, bf16* qkv, bf16* o, bf16* y, int B,
    int N, int hidden, int H, int L, int l, float eps, float qscale,
    cudaStream_t st, bf16* z_out, float* m_out, float* r_out, bf16* proj_out,
    bf16* x1_out) {
  const int rows = B * N, tiles = (rows + 63) / 64;
  if (y && (proj_out || x1_out)) return cudaErrorInvalidValue;
  const long long optin = smem_optin();
  if (optin < 0) return (cudaError_t)-optin;
  const RowPlan pa = plan_qkv(D, optin);
  const RowPlan pc = plan_mlp(D, hidden, y != nullptr, optin);
  const int sms = rw_sms();
  if (!pa.slots || !pc.slots || sms <= 0) return cudaErrorInvalidValue;
  const int blocks = (tiles + RW_WG - 1) / RW_WG;
  const int grid = blocks < sms ? blocks : sms;
  const void* ka = (const void*)modln_qkv_tc_kernel<D>;
  const void* kc = y ? (const void*)proj_mlp_tc_kernel<D, true>
                     : (const void*)proj_mlp_tc_kernel<D, false>;
  cudaError_t e;
  if ((e = set_smem(ka, pa.smem)) || (e = set_smem(kc, pc.smem))) return e;
  CUtensorMap mx, mw, mq, mz;
  if (!make_tmap(&mx, x, rows, D, 64) || !make_tmap(&mw, wqkv, D, 3 * D, 64) ||
      !make_tmap(&mq, qkv, rows, 3 * D, 64) ||
      (z_out && !make_tmap(&mz, z_out, rows, D, 64)))
    return cudaErrorInvalidValue;
  const RowArgs ga{mod,      bqkv,     nullptr,   nullptr, rows,
                   N,        L,        l,         hidden,  eps,
                   pa.items, pa.slots, pa.stages, z_out != nullptr, 0, 0};
  modln_qkv_tc_kernel<D><<<grid, RW_NT, pa.smem, st>>>(ga, mx, mw, mq,
                                                       z_out ? mz : mx);
  if ((e = cudaGetLastError()) ||
      (e = launch_layer_attn(qkv, o, B, N, D, H, qscale, m_out, r_out, st)))
    return e;
  CUtensorMap mo, mwp, mw1 = mx, mw2 = mx, my = mx, mp = mx, mx1 = mx;
  if (!make_tmap(&mo, o, rows, D, 64) || !make_tmap(&mwp, wproj, D, D, 64) ||
      (y && (!make_tmap(&mw1, wfc1, D, hidden, 64) ||
             !make_tmap(&mw2, wfc2, hidden, D, 64) ||
             !make_tmap(&my, y, rows, D, 64))) ||
      (proj_out && !make_tmap(&mp, proj_out, rows, D, 64)) ||
      (x1_out && !make_tmap(&mx1, x1_out, rows, D, 64)))
    return cudaErrorInvalidValue;
  const RowArgs gc{mod,      bproj,    bfc1,      bfc2,   rows,
                   N,        L,        l,         hidden, eps,
                   pc.items, pc.slots, pc.stages, 0,      proj_out != nullptr,
                   x1_out != nullptr};
  if (y)
    proj_mlp_tc_kernel<D, true><<<grid, RW_NT, pc.smem, st>>>(
        gc, mo, mx, mwp, mw1, mw2, my, mp, mx1);
  else
    proj_mlp_tc_kernel<D, false><<<grid, RW_NT, pc.smem, st>>>(
        gc, mo, mx, mwp, mw1, mw2, my, mp, mx1);
  return cudaGetLastError();
}

// One block on the route tc_route picks, layer l of L (the weights are that
// layer's): qkv and o are workspaces of (B*N, 3D) and (B*N, D). With y, the
// whole block into y (which may be x); without, only the first half, for
// the backward, which also takes z_out, m_out, r_out, proj_out and x1_out.
inline cudaError_t run_layer_tc(
    const bf16* x, const float* mod, const bf16* wqkv, const bf16* bqkv,
    const bf16* wproj, const bf16* bproj, const bf16* wfc1, const bf16* bfc1,
    const bf16* wfc2, const bf16* bfc2, bf16* qkv, bf16* o, bf16* y, int B,
    int N, int D, int hidden, int H, int L, int l, float eps, float qscale,
    cudaStream_t st, bf16* z_out = nullptr, float* m_out = nullptr,
    float* r_out = nullptr, bf16* proj_out = nullptr,
    bf16* x1_out = nullptr) {
  switch (D) {
    case 64:
      return run_layer_rows<64>(x, mod, wqkv, bqkv, wproj, bproj, wfc1, bfc1,
                                wfc2, bfc2, qkv, o, y, B, N, hidden, H, L, l,
                                eps, qscale, st, z_out, m_out, r_out,
                                proj_out, x1_out);
    case 128:
      return run_layer_rows<128>(x, mod, wqkv, bqkv, wproj, bproj, wfc1,
                                 bfc1, wfc2, bfc2, qkv, o, y, B, N, hidden, H,
                                 L, l, eps, qscale, st, z_out, m_out, r_out,
                                 proj_out, x1_out);
    case 192:
      return run_layer_rows<192>(x, mod, wqkv, bqkv, wproj, bproj, wfc1,
                                 bfc1, wfc2, bfc2, qkv, o, y, B, N, hidden, H,
                                 L, l, eps, qscale, st, z_out, m_out, r_out,
                                 proj_out, x1_out);
    default:  // tc_route takes no other width
      return cudaErrorInvalidValue;
  }
}

}  // namespace
