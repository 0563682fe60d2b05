// The split block's qkv, proj and fc1 GEMMs as a persistent,
// warp-specialised wgmma kernel for Hopper (sm_90a), at D 128, 256 and 512:
//
//   split_rows_tc_kernel<D, SP_QKV>   (1) qkv = T(modLN(x; mod0, mod1) @
//                                         wqkv + T(bqkv))
//   split_rows_tc_kernel<D, SP_PROJ>  (3) y1  = x + T(gate2) * T(o @ wproj
//                                         + T(bproj))
//   split_rows_tc_kernel<D, SP_FC1>   (4) h1  = T(gelu(T(modLN(y1; mod3,
//                                         mod4) @ w1 + T(b1))))
//
// dit_split.cu's ROUTE_TC runs them here in place of wg_gemm_kernel on
// calls of more rows than one 128-row tile a SM (sp_rows_take); fc2 stays
// on wg_gemm.cuh's. The rounding points are wg_gemm.cuh's: f32 LayerNorm
// statistics and one rounding of the modulated row, every product summed
// in f32 with the rounded bias added in f32 and one rounding, the GELU
// (gelu_fast) on the rounded fc1 output, gated residuals in bf16.
//
// Bound on an H100 SXM at the scaled DiT's CFG call (32,768 rows, D 512,
// hidden 2048): qkv 51.5 GFLOP (0.052 ms at 989 TFLOP/s), proj 17.2 GFLOP
// against 101 MB (0.030 ms at 3.35 TB/s: bytes), fc1 68.7 GFLOP (0.069
// ms).
//
// Design (rw_common.cuh's pieces, as dit_layer.cuh's kernels):
// - Grid: at most one block an SM, 384 threads: two consumer warpgroups and
//   a producer warpgroup (setmaxnreg 40 / 232). Every block walks its tiles
//   in a fixed order (no atomics, no split-K: calls repeat bit for bit);
//   each consumer warpgroup owns its own 64-row tiles ((j * grid + block) *
//   2 + w), so one group's LayerNorm, residual wait and epilogue overlap
//   the other's products. A group with no tile left in an iteration runs a
//   tile past the last row (loads give zeros, stores are clipped), so every
//   item of the weight ring has all its readers.
// - Weights stream by TMA through a ring of 16 KB slots (128-byte-swizzled
//   slabs of 64 columns: 64 K rows x 128 columns an item), refilled in a
//   fixed item order once every consumer warp has released the slot, with
//   L2 policies: the weights evict_last, the activations evict_first (every
//   stage faster with them). Both groups read every item, one commit group
//   left in flight while the next item is awaited, in column steps of 128
//   (64 registers of sums) K chunk by K chunk.
// - wgmma with both operands through swizzled descriptors (A K-major, B
//   MN-major as the weights are stored). No wgmma sits under a branch, so
//   ptxas serialises none (C7512).
// - A group's A tile (64 x D: x or y1, normalised in place, or o) stays in
//   shared memory for all its column steps; its 64 x 128 C tile takes each
//   step's output (qkv, fc1) or first the step's residual, by TMA under the
//   step's products (proj), then the gated sum over it; out by TMA store.
//   The producer's waits are bounded (sp_wait: a fault traps instead of
//   hanging the card).
//
// Shared memory (227 KB opt-in): the ring, then two A tiles (128 D bytes
// each) and two C tiles (16 KB each).

#pragma once

#include "rw_common.cuh"

namespace {

// ------------------------------------------- TMA with L2 policies, waits

// L2 policies: the weights (read by every block, a few MB) evict_last, the
// activations (streamed once each way) evict_first, so the stream does not
// push the weights out of L2 (every stage faster with them)
__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}
// tma_load and tma_store with an L2 policy
__device__ __forceinline__ void tma_load_l2(void* dst, const CUtensorMap* m,
                                            int c0, int c1, uint64_t* b,
                                            uint64_t pol) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(
          sm_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(c0), "r"(c1), "r"(sm_addr(b)),
      "l"(pol)
      : "memory");
}
__device__ __forceinline__ void tma_store_l2(const CUtensorMap* m,
                                             const void* src, int c0, int c1,
                                             uint64_t pol) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0, {%2, %3}], [%1], %4;\n" ::"l"(reinterpret_cast<uint64_t>(m)),
      "r"(sm_addr(src)), "r"(c0), "r"(c1), "l"(pol)
      : "memory");
}
// a weight box, evict_last
__device__ __forceinline__ void tma_w(void* dst, const CUtensorMap* m, int c0,
                                      int c1, uint64_t* b) {
  tma_load_l2(dst, m, c0, c1, b, l2_evict_last());
}

// mbar_wait with a bound: a phase that has not completed after 2^26 tries
// (each suspends the thread a while: seconds in all, far past any wait of
// a correct launch) traps, so a fault in the item order ends the launch
// with an error instead of hanging the card
__device__ __forceinline__ bool sp_try(uint64_t* b, int ph) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(sm_addr(b)), "r"(ph)
      : "memory");
  return ok != 0;
}
__device__ __forceinline__ void sp_wait(uint64_t* b, int ph) {
  for (uint32_t n = 0; !sp_try(b, ph);)
    if (++n == (1u << 26)) __trap();
}

// in an unrolled epilogue, every G column tiles: the compiler may not hoist
// the next tiles' loads (bias, gate, residual) above this one's stores, so
// they do not all sit in registers beside the sums
template <int G> __device__ __forceinline__ void sp_group_fence(int nt) {
  if (nt % G == 0) asm volatile("" ::: "memory");
}

// ------------------------------------------------------------ geometry

constexpr int SP_SLOT = 16384;            // a ring slot: two 8 KB slabs
constexpr int SP_CT = 16384;              // a 64 x 128 output tile
constexpr size_t SP_OPTIN = 232448;       // the H100's opt-in per block
// ring slots beside `fixed` bytes: as many as fit, at most 8, a power of
// two (slot and phase of item g are g % S and g / S)
__host__ __device__ constexpr int sp_slots(size_t fixed) {
  return (SP_OPTIN - RW_STATIC - WG_ALIGN - fixed) / SP_SLOT >= 8   ? 8
         : (SP_OPTIN - RW_STATIC - WG_ALIGN - fixed) / SP_SLOT >= 4 ? 4
                                                                     : 2;
}
// beside the ring: two A tiles and two C tiles
__host__ __device__ constexpr size_t sp_rows_fixed(int D) {
  return 2 * (size_t)128 * D + 2 * SP_CT;
}
__host__ __device__ constexpr size_t smem_sp_rows(int D) {
  return WG_ALIGN + (size_t)sp_slots(sp_rows_fixed(D)) * SP_SLOT +
         sp_rows_fixed(D);
}
// the widths with instances
__host__ __device__ constexpr bool sp_width(int D) {
  return D == 128 || D == 256 || D == 512;
}

struct SplitArgs {
  const float* mod;  // (B, 6, D) adaLN vectors, f32
  const bf16* bias;  // (cols)
  int rows, N, cols;
  float eps;
};

// what an instance of split_rows_tc_kernel computes: the block's stages
// (1), (3) and (4)
enum { SP_QKV = 0, SP_PROJ = 1, SP_FC1 = 2 };

// The weight ring's consumer side: item g in slot g % S, phase (g / S) & 1,
// released by lane 0 of each warp that reads it
template <int S> struct SpRing {
  uint64_t* full;
  uint64_t* empty;
  uint32_t base;  // the slots' shared address
  __device__ void wait(uint32_t g) const {
    sp_wait(&full[g % S], (g / S) & 1);
  }
  __device__ uint32_t at(uint32_t g) const {
    return base + (g % S) * SP_SLOT;
  }
  __device__ void release(uint32_t g) const {
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[g % S]);
  }
};

// The producer side: item g into slot g % S once its previous item there
// has been released by all `empty` arrivals; load(dst, bar) issues its
// boxes
template <int S, typename Load>
__device__ __forceinline__ void sp_put(uint64_t* full, uint64_t* empty,
                                       unsigned char* ring, uint32_t& g,
                                       uint32_t bytes, Load&& load) {
  const uint32_t s = g % S;
  if (g >= (uint32_t)S) sp_wait(&empty[s], ((g / S) - 1) & 1);
  mbar_expect(&full[s], bytes);
  load(ring + s * SP_SLOT, &full[s]);
  ++g;
}

// ---------------------------------------------------------------------------
// (1), (3) and (4): out = epilogue(A @ w + T(bias)), A the normalised x tile
//     (qkv: mod rows 0 and 1, the rounded sum out; fc1: y1's tile, mod rows
//     3 and 4, the GELU of the rounded sum out) or the o tile (proj, its
//     epilogue the gated residual on x)

template <int D, int MODE>
__global__ void __launch_bounds__(RW_NT, 1)
    split_rows_tc_kernel(const SplitArgs g,
                         const __grid_constant__ CUtensorMap m_a,
                         const __grid_constant__ CUtensorMap m_w,
                         const __grid_constant__ CUtensorMap m_r,
                         const __grid_constant__ CUtensorMap m_o) {
  constexpr bool PROJ = MODE == SP_PROJ;
  constexpr int NK = D / 64, ISH = MODE == SP_FC1 ? 3 : 0;
  // column steps of 128 (fc1's from its hidden width) and weight items a
  // block iteration
  const int ncs = MODE == SP_QKV ? 3 * D / 128
                  : PROJ         ? D / 128
                                 : g.cols / 128;
  const int items = ncs * NK;
  constexpr int S = sp_slots(sp_rows_fixed(D)), TILE = 128 * D;
  extern __shared__ unsigned char sp_raw[];
  __shared__ uint64_t full[S], empty[S];
  __shared__ uint64_t afull[2], aempty[2], cfull[2], cempty[2];
  unsigned char* ring = align_atoms(sp_raw);
  unsigned char* As = ring + S * SP_SLOT;  // group w's A tile: + w * TILE
  unsigned char* Cs = As + 2 * TILE;       // group w's C tile: + w * SP_CT
  const int tid = threadIdx.x, tiles = (g.rows + 63) / 64;
  const int iters = ((tiles + 1) / 2 + (int)gridDim.x - 1) / (int)gridDim.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], RW_NC / 32);
    }
    for (int w = 0; w < 2; ++w) {
      mbar_init(&afull[w], 1);
      mbar_init(&aempty[w], 4);
      mbar_init(&cfull[w], 1);
      mbar_init(&cempty[w], 1);
    }
  }
  __syncthreads();

  if (tid >= RW_NC) {
    regs_dec<RW_PRODUCER_REGS>();
    const int pw = (tid - RW_NC) >> 5;
    if ((tid & 31) == 0 && pw == 0) {
      // the weights: item k of an iteration is K chunk k % NK of column
      // step k / NK, two slabs of 64 columns
      const CUtensorMap* mw = &m_w;
      uint32_t gi = 0;
      for (int j = 0; j < iters; ++j)
        for (int k = 0; k < items; ++k)
          sp_put<S>(full, empty, ring, gi, SP_SLOT,
                    [&](unsigned char* dst, uint64_t* bar) {
                      const int cs = k / NK, kc = k % NK;
#pragma unroll
                      for (int h = 0; h < 2; ++h)
                        tma_w(dst + h * 8192, mw, 128 * cs + 64 * h, 64 * kc,
                              bar);
                    });
    } else if ((tid & 31) == 0 && pw <= 2) {
      // group w's A tiles and, for proj, each column step's residual tile,
      // each once the group has released the previous
      const int w = pw - 1;
      unsigned char* A = As + w * TILE;
      unsigned char* C = Cs + w * SP_CT;
      for (int j = 0; j < iters; ++j) {
        const int t = (j * (int)gridDim.x + (int)blockIdx.x) * 2 + w;
        if (j > 0) sp_wait(&aempty[w], (j - 1) & 1);
        mbar_expect(&afull[w], TILE);
#pragma unroll
        for (int kc = 0; kc < NK; ++kc)
          tma_load_l2(A + kc * 8192, &m_a, 64 * kc, 64 * t, &afull[w],
                      l2_evict_first());
        if constexpr (PROJ) {
          for (int cs = 0; cs < ncs; ++cs) {
            const int u = j * ncs + cs;
            if (u > 0) sp_wait(&cempty[w], (u - 1) & 1);
            mbar_expect(&cfull[w], SP_CT);
#pragma unroll
            for (int h = 0; h < 2; ++h)
              tma_load_l2(C + h * 8192, &m_r, 128 * cs + 64 * h, 64 * t,
                          &cfull[w], l2_evict_first());
          }
        }
      }
    }
    return;
  }
  {
    // The consumers: warpgroup w, its rows 16 warp + lane / 4 (+ 8)
    regs_inc<RW_CONSUMER_REGS>();
    const int w = tid >> 7, wt = tid & 127, warp = wt >> 5, lane = tid & 31;
    const int gr = lane >> 2, tq = lane & 3;
    unsigned char* A = As + w * TILE;
    unsigned char* C = Cs + w * SP_CT;
    const uint32_t aa = sm_addr(A);
    const SpRing<S> ring_c{full, empty, sm_addr(ring)};
    float acc[16][4];
    uint32_t pend = ~0u;  // the item of the group left in flight
    auto modrow = [&](int r) {
      return g.mod + (size_t)(min(r, g.rows - 1) / g.N) * 6 * D;
    };
    for (int j = 0; j < iters; ++j) {
      const int t = (j * (int)gridDim.x + (int)blockIdx.x) * 2 + w;
      const int r0 = 64 * t;
      const uint32_t gt = (uint32_t)j * items;
      sp_wait(&afull[w], j & 1);
      if constexpr (!PROJ) {
        wg_modln_rows<64, 128>(A, A, g.rows - r0, D, g.eps, ISH, ISH + 1, wt,
                               [&](int i) { return modrow(r0 + i); });
        fence_async_shared();  // the LayerNorm's stores, to wgmma
        bar_sync(1 + w, 128);
      }
      for (int cs = 0; cs < ncs; ++cs) {
        for (int kc = 0; kc < NK; ++kc) {
          const uint32_t gi = gt + cs * NK + kc;
          ring_c.wait(gi);
          const uint32_t b0 = ring_c.at(gi);
          wg_fence();
#pragma unroll
          for (int s = 0; s < 4; ++s)
            WgSS<128>::run(acc, sw128_desc(aa + kc * 8192 + 32 * s, 16),
                           sw128_desc(b0 + 2048 * s, 8192), kc > 0 || s > 0);
          wg_commit();
          wg_wait<1>();
          if (pend != ~0u) ring_c.release(pend);
          pend = gi;
        }
        wg_wait<0>();
        fence_regs(acc);
        ring_c.release(pend);
        pend = ~0u;
        // the last step's products were the A tile's last readers
        if (cs == ncs - 1) {
          __syncwarp();
          if (lane == 0) mbar_arrive(&aempty[w]);
        }
        // Epilogue into the C tile (out_at: two 64-column slabs), then out
        if constexpr (PROJ) {
          sp_wait(&cfull[w], (j * ncs + cs) & 1);  // the residual is in
        } else {
          if (wt == 0) bulk_wait<0, true>();  // the last step's store read C
          bar_sync(1 + w, 128);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 16 * warp + gr + 8 * h;
          const float* gate = modrow(r0 + i) + 2 * D + 128 * cs + 2 * tq;
#pragma unroll
          for (int nt = 0; nt < 16; ++nt) {
            sp_group_fence<8>(nt);
            const uint32_t bp = ld_pair(g.bias + 128 * cs + 8 * nt + 2 * tq);
            uint32_t* o =
                reinterpret_cast<uint32_t*>(C + out_at(i, nt) + 4 * tq);
            if constexpr (PROJ)
              *o = resid2(bias_pair<WG_EPI_RESID>(acc[nt], h, bp), *o,
                          gate_pair(gate + 8 * nt));
            else if constexpr (MODE == SP_FC1)
              *o = bias_pair<WG_EPI_GELU>(acc[nt], h, bp);
            else
              *o = bias_pair<WG_EPI_BIAS>(acc[nt], h, bp);
          }
        }
        fence_async_shared();  // the tile's stores, to the TMA store
        bar_sync(1 + w, 128);
        if (wt == 0) {
          tma_store_l2(&m_o, C, 128 * cs, r0, l2_evict_first());
          tma_store_l2(&m_o, C + 8192, 128 * cs + 64, r0, l2_evict_first());
          bulk_commit();
          if constexpr (PROJ) {
            bulk_wait<0, true>();  // read: the next residual may land
            mbar_arrive(&cempty[w]);
          }
        }
      }
    }
    if (wt == 0) bulk_wait<0, false>();
  }
}

// --------------------------------------------------------------- launches

// blocks for `units` units of work (a block takes one an iteration): at
// most the SMs (0: no SM count)
inline int sp_grid(int units) {
  const int sms = rw_sms();
  return sms <= 0 ? 0 : units < sms ? units : sms;
}

// (1), (3) or (4) on `rows` rows: a (rows, D) x, o or y1, w (D, cols),
// bias (cols), res (rows, D) for proj, out (rows, cols); cols 3D for qkv,
// D for proj, a multiple of 128 for fc1
template <int D, int MODE>
cudaError_t launch_sp_rows(const bf16* a, const float* mod, const bf16* w,
                           const bf16* bias, const bf16* res, bf16* out,
                           int rows, int N, int cols, float eps,
                           cudaStream_t st) {
  constexpr bool PROJ = MODE == SP_PROJ;
  const int grid = sp_grid(((rows + 63) / 64 + 1) / 2);
  CUtensorMap ma, mw, mr, mo;
  if (grid <= 0 || !make_tmap(&ma, a, rows, D, 64) ||
      !make_tmap(&mw, w, D, cols, 64) ||
      (PROJ && !make_tmap(&mr, res, rows, D, 64)) ||
      !make_tmap(&mo, out, rows, cols, 64))
    return cudaErrorInvalidValue;
  const void* k = (const void*)split_rows_tc_kernel<D, MODE>;
  const cudaError_t e = set_smem(k, smem_sp_rows(D));
  if (e != cudaSuccess) return e;
  const SplitArgs g{mod, bias, rows, N, cols, eps};
  split_rows_tc_kernel<D, MODE><<<grid, RW_NT, smem_sp_rows(D), st>>>(
      g, ma, mw, PROJ ? mr : ma, mo);
  return cudaGetLastError();
}

// stage SP_QKV, SP_PROJ or SP_FC1 at width D on the kernel above (the
// caller has checked sp_width(D) and the shapes)
inline cudaError_t launch_sp(int stage, int D, const bf16* a,
                             const float* mod, const bf16* w,
                             const bf16* bias, const bf16* res, bf16* out,
                             int rows, int N, int cols, float eps,
                             cudaStream_t st) {
#define T2MS_SP_CASE(DD)                                                     \
  case DD:                                                                   \
    return stage == SP_QKV ? launch_sp_rows<DD, SP_QKV>(                     \
                                 a, mod, w, bias, nullptr, out, rows, N,     \
                                 cols, eps, st)                              \
           : stage == SP_PROJ                                                \
               ? launch_sp_rows<DD, SP_PROJ>(a, mod, w, bias, res, out,      \
                                             rows, N, cols, eps, st)         \
               : launch_sp_rows<DD, SP_FC1>(a, mod, w, bias, nullptr, out,   \
                                            rows, N, cols, eps, st);
  switch (D) {
    T2MS_SP_CASE(128)
    T2MS_SP_CASE(256)
    T2MS_SP_CASE(512)
    default:
      return cudaErrorInvalidValue;
  }
#undef T2MS_SP_CASE
}

}  // namespace