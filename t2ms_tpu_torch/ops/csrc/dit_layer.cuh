// The bf16 forward of one adaLN-zero DiT block on Hopper's tensor cores,
// shared by dit_stack.cu (every layer of fused_dit_stack, and
// fused_dit_block as the stack with L = 1) and dit_block_bwd.cu (the
// backward's recompute of the forward's intermediates). Three launches a
// block, cut at its residual boundaries:
//
//   (a) modln_qkv_tc_kernel   one block per 128-row tile of the (B*N) rows:
//       f32 LayerNorm -> *(1+scale)+shift -> cast (the rows stay in shared
//       memory) -> qkv = T(rows @ wqkv + T(bqkv)), the sum in f32.
//   (b) heads_fwd_kernel      (attn_heads.cuh) one block per (element, 128
//       q rows, head), two warpgroups on wgmma: q, k and v read in place
//       from qkv (row stride 3*D; K and V by TMA); the merged attention
//       output o, (B*N, D), to a workspace.
//   (c) proj_mlp_tc_kernel    one block per 64-row tile: x1 = x + T(gate2)
//       * T(o @ wproj + T(bproj)) in T, kept in shared memory; then LN +
//       modulate(mod[3], mod[4]) -> fc1 + bias -> tanh-GELU (the 64 x
//       hidden tile stays in shared memory) -> fc2 + bias -> y = x1 +
//       T(gate5) * h2. The backward's recompute runs its first half only
//       (MLP = false), writing proj and x1.
//
// The recipe and its rounding points are dit_common.cuh's (and JAX's
// _block_math): q scaled at input width, f32 scores, the exact two-pass
// softmax with e = T(exp(T(s - m))) and f32 row sums, normalisation after
// PV, every product summed in f32 with the rounded bias added in f32 and
// then one rounding, tanh-GELU in f32, gated residuals in T.
//
// Bound on an H100 SXM at the main-path call (2B=512, N=480, D=128, 4 heads
// of 32, hidden 256): 64.4 GFLOP of dense products and 60.4 GFLOP of
// attention products a layer, 0.126 ms at 989 TFLOP/s, against 63 MB of
// activation in and out, 0.019 ms at 3.35 TB/s. The cut at the residual
// boundaries adds qkv (189 MB) written and read and o (63 MB) written and
// read: about 0.69 GB a layer, 0.21 ms. What the design does about it:
// - row GEMMs (tile_gemm): blocks of 128 rows in (a) and 64 in (c); 8 warps
//   of R/2 rows x 32 columns of an R x 128 output chunk, mma.sync m16n8k16
//   with the sums in registers; A from the tile in shared memory and the
//   weight through ldmatrix(.trans); the
//   weight comes in through a cp.async ring that runs across the column
//   chunks, one barrier a stage (four stages of 32 weight rows in (a), two
//   of 64 in (c), whose fc2 runs over 256), so loads overlap products;
//   epilogues work from registers on (row, column pair) and write packed
//   bf16x2, in (a) staged in shared memory for 16-byte stores.
// - LayerNorm (modln_tile): the x tile comes in by cp.async with the
//   ring's first stages; two or four threads a row, 16 bytes a load, so
//   the whole tile's statistics are a few short chains rather than a
//   warp's rows one after another.
// - the LayerNorm rows, x1 and the MLP hidden tile never leave shared
//   memory; (c) fuses the out-projection with the MLP, so x1 makes no round
//   trip through device memory.
// - attention is attn_heads.cuh's wgmma kernel (scores, exponentials and
//   the row sums in registers, K and V through a TMA ring, launched by its
//   one helper, launch_fwd_bf16); it takes head widths 16, 32, 64 and
//   128.
// Probes on an H100 chose these shapes: two blocks an SM of each row
// kernel; cutting shared memory and registers for three or four ran
// slower (PERF.md).
// Bf16 geometries at another head width, and f32, keep dit_common.cuh's
// modln_qkv_kernel, attn_proj_kernel and mlp_kernel (tc_route picks from
// the geometry before any launch).

#pragma once

#include "attn_heads.cuh"

namespace {

constexpr int GC = 128;          // output columns of a GEMM chunk
constexpr int GLD = GC + 8;      // padded ring row, elements
// the weight ring: GS stages of GKS rows (tile_gemm's parameters), the
// same bytes either way: (a) takes four stages of 32 rows, (c) two of 64
constexpr size_t RING_BYTES = (size_t)128 * GLD * 2;

// bytes of a padded 64-row bf16 tile of `cols` values a row (the 16 bytes a
// row keep ldmatrix's eight row addresses on distinct banks)
__host__ __device__ constexpr size_t row_tile(int cols) {
  return (size_t)RT * (cols + 8) * 2;
}
// rows of a block of (a) and of (c): on an H100 at the main path's call,
// 128-row blocks of (a) ran faster than 64-row ones (two blocks an SM
// either way); (c) at 128 rows fits one block an SM and ran slower
constexpr int QR = 128, MR = 64;
// (a): the x / z1 tile, the qkv staging tile and the ring
__host__ __device__ inline size_t smem_qkv_tc(int D) {
  return (row_tile(D) + row_tile(GC)) * (QR / RT) + RING_BYTES;
}
// (c): o/z2/y tile, x/x1 tile, the hidden tile when MLP, the ring
__host__ __device__ inline size_t smem_mlp_tc(int D, int hidden, bool mlp) {
  return (2 * row_tile(D) + (mlp ? row_tile(hidden) : 0)) * (MR / RT) +
         RING_BYTES;
}

// head widths with a heads_fwd_kernel instance
__host__ __device__ constexpr bool tc_head_width(int dh) {
  return dh == 16 || dh == 32 || dh == 64 || dh == 128;
}

// Whether a bf16 block at this geometry (which check_shape has taken) runs
// on the kernels below: a head width heads_fwd_kernel takes, the shared
// memory of each kernel within the device's opt-in, and the attention grid
// within an int. Otherwise it runs on dit_common.cuh's three kernels.
inline bool tc_route(int B, int N, int D, int hidden, int H) {
  if (H < 1 || D % H || !tc_head_width(D / H)) return false;
  const long long optin = smem_optin();
  size_t need = smem_qkv_tc(D);
  if (smem_mlp_tc(D, hidden, true) > need)
    need = smem_mlp_tc(D, hidden, true);
  if (smem_fwd(D / H) > need) need = smem_fwd(D / H);
  return optin > 0 && need <= (size_t)optin &&
         fwd_blocks(B, N, H) <= INT_MAX;
}

// ------------------------------------------------------------ tile copies

// rows [0, R) of a matrix of `cols` values a row (row stride ld) into the
// padded tile dst, asynchronously; rows from `valid` on are zeros
template <int R>
__device__ __forceinline__ void cp_rows(bf16* dst, const bf16* src,
                                        size_t ld, int cols, int valid) {
  const int ch = cols / 8;
  for (int idx = threadIdx.x; idx < R * ch; idx += NT) {
    const int r = idx / ch, c = idx % ch * 8;
    const bool ok = r < valid;
    cp16(dst + r * (cols + 8) + c, src + (size_t)(ok ? r : 0) * ld + c, ok);
  }
}

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

__device__ __forceinline__ float2 ld_bf16x2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
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

// the element b of each of the thread's R / 16 tile rows (rows past the
// end take the last row's)
template <int R>
__device__ __forceinline__ void row_elems(int r0, int rows, int N,
                                          int (&b)[R / 16]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < R / 16; ++i) {
    const int r = r0 + R / 2 * (warp >> 2) + (lane >> 2) + 8 * i;
    b[i] = min(r, rows - 1) / N;
  }
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

// the sum of x over the P (2 or 4) neighbouring lanes that share a row
template <int P> __device__ __forceinline__ float lanes_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return P == 4 ? x + __shfl_xor_sync(0xffffffffu, x, 2) : x;
}

// Z[i] = T(LN(X[i]) * (1 + mod[b, l, isc]) + mod[b, l, ish]) in f32 for
// the R rows of the tile X (row stride ldx) into Z (row stride ldz; Z may
// be X): P = NT / R threads a row, each over the row's 16-byte chunks q,
// q + P, ..., so the whole tile's statistics take one pass of short chains.
// Rows past `rows` are zero.
template <int R>
__device__ __forceinline__ void modln_tile(const bf16* X, int ldx, bf16* Z,
                                           int ldz,
                                           const float* __restrict__ mod,
                                           int r0, int rows, int N, int D,
                                           int L, int l, int ish, int isc,
                                           float eps) {
  constexpr int P = NT / R;
  const int i = threadIdx.x / P, q = threadIdx.x % P, r = r0 + i;
  const bf16* xr = X + i * ldx;
  auto row8 = [&](int c, float (&f)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(xr + c);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  };
  float s = 0.0f;
  for (int c = 8 * q; c < D; c += 8 * P) {
    float f[8];
    row8(c, f);
#pragma unroll
    for (int k = 0; k < 8; ++k) s += f[k];
  }
  const float mu = lanes_sum<P>(s) / D;
  float v = 0.0f;
  for (int c = 8 * q; c < D; c += 8 * P) {
    float f[8];
    row8(c, f);
#pragma unroll
    for (int k = 0; k < 8; ++k) v += (f[k] - mu) * (f[k] - mu);
  }
  const float rs = rsqrtf(lanes_sum<P>(v) / D + eps);
  const size_t mb = ((size_t)(min(r, rows - 1) / N) * L + l) * 6;
  const float* msh = mod + (mb + ish) * D;
  const float* msc = mod + (mb + isc) * D;
  for (int c = 8 * q; c < D; c += 8 * P) {
    float f[8];
    row8(c, f);
    const float4 h0 = *reinterpret_cast<const float4*>(msh + c);
    const float4 h1 = *reinterpret_cast<const float4*>(msh + c + 4);
    const float4 g0 = *reinterpret_cast<const float4*>(msc + c);
    const float4 g1 = *reinterpret_cast<const float4*>(msc + c + 4);
    const float sh[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
    const float sc[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    uint4 o = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) {
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        w[k] = pack_bf16((f[2 * k] - mu) * rs * (1.0f + sc[2 * k]) +
                             sh[2 * k],
                         (f[2 * k + 1] - mu) * rs * (1.0f + sc[2 * k + 1]) +
                             sh[2 * k + 1]);
      o = make_uint4(w[0], w[1], w[2], w[3]);
    }
    *reinterpret_cast<uint4*>(Z + i * ldz + c) = o;
  }
}

// ---------------------------------------------------------------------------
// (a) qkv = T(modLN(x; mod[0], mod[1]) @ w + T(bias)); z_out, if given,
//     receives the modulated LN rows. The x tile comes in by cp.async
//     ahead of the ring's first slices and is normalised in place.

template <int R>
__global__ void __launch_bounds__(NT, 2)
modln_qkv_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ mod,
                    const bf16* __restrict__ w, const bf16* __restrict__ bias,
                    bf16* __restrict__ qkv, bf16* __restrict__ z_out,
                    int rows, int N, int D, int L, int l, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = D + 8, W3 = 3 * D;
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Cs = As + R * lda;       // a chunk of qkv, staged for the stores
  bf16* ring = Cs + R * GLD;
  const int r0 = blockIdx.x * R, valid = min(R, rows - r0);
  cp_rows<R>(As, x + (size_t)r0 * D, D, D, valid);
  cp_commit();
  tile_gemm<R, 32, 4>(
      As, lda, w, D, W3, ring,
      [&] {
        cp_wait<3>();  // the x tile (older than the ring's three groups)
        __syncthreads();
        modln_tile<R>(As, lda, As, lda, mod, r0, rows, N, D, L, l, 0, 1, eps);
        if (z_out) {
          __syncthreads();
          st_rows(z_out + (size_t)r0 * D, D, As, lda, D, valid);
        }
      },
      [&](int c0, const Acc<R>& acc) {
        for_pairs<R>(acc, [&](int r, int, int c, float v0, float v1) {
          if (c0 + c < W3) {
            const float2 b = ld_bf16x2(bias + c0 + c);
            st_bf16x2(Cs + r * GLD + c, v0 + b.x, v1 + b.y);
          }
        });
        __syncthreads();
        st_rows(qkv + (size_t)r0 * W3 + c0, W3, Cs, GLD, min(GC, W3 - c0),
                valid);
      });
}

// ---------------------------------------------------------------------------
// (c) x1 = x + T(gate2) * T(o @ wproj + T(bproj)); with MLP, then
//     y = x1 + T(gate5) * T(gelu(T(modLN(x1; mod[3], mod[4]) @ w1 + T(b1)))
//     @ w2 + T(b2)). proj_out and x1_out, if given, receive proj and x1.
//     x and y may be the same buffer (the stack's layers after the first):
//     a block reads its rows of x before it writes them, and no block reads
//     another's.

template <int R, bool MLP>
__global__ void __launch_bounds__(NT, 2)
proj_mlp_tc_kernel(const bf16* __restrict__ o, const bf16* x,
                   const float* __restrict__ mod,
                   const bf16* __restrict__ wproj,
                   const bf16* __restrict__ bproj,
                   const bf16* __restrict__ w1, const bf16* __restrict__ b1,
                   const bf16* __restrict__ w2, const bf16* __restrict__ b2,
                   bf16* y, bf16* __restrict__ proj_out,
                   bf16* __restrict__ x1_out, int rows, int N, int D,
                   int hidden, int L, int l, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = D + 8, ldh = hidden + 8;
  bf16* As = reinterpret_cast<bf16*>(smem);  // o, then z2, then y
  bf16* Xs = As + R * lda;                   // x, then x1
  bf16* Hs = Xs + R * lda;                   // the MLP hidden tile
  bf16* ring = MLP ? Hs + R * ldh : Hs;
  const int r0 = blockIdx.x * R, valid = min(R, rows - r0);
  int eb[R / 16];  // the element of each of the thread's rows
  row_elems<R>(r0, rows, N, eb);
  // mod[b, l, i] of the thread's row j
  auto modrow = [&](int j, int i) {
    return mod + (((size_t)eb[j] * L + l) * 6 + i) * D;
  };

  cp_rows<R>(As, o + (size_t)r0 * D, D, D, valid);
  cp_rows<R>(Xs, x + (size_t)r0 * D, D, D, valid);
  cp_commit();  // older than the ring's groups, so in before its first slice
  tile_gemm<R, 64, 2>(As, lda, wproj, D, D, ring, [] {},
                      [&](int c0, const Acc<R>& acc) {
    for_pairs<R>(acc, [&](int r, int i, int c, float v0, float v1) {
      const int col = c0 + c;
      if (col >= D) return;
      const float2 b = ld_bf16x2(bproj + col);
      const float* g = modrow(i, 2) + col;
      const float p0 = rnd<bf16>(v0 + b.x), p1 = rnd<bf16>(v1 + b.y);
      const float2 xv = ld_bf16x2(Xs + r * lda + col);
      st_bf16x2(Xs + r * lda + col,
                xv.x + rnd<bf16>(rnd<bf16>(g[0]) * p0),
                xv.y + rnd<bf16>(rnd<bf16>(g[1]) * p1));
      if (proj_out && r < valid)
        st_bf16x2(proj_out + (size_t)(r0 + r) * D + col, p0, p1);
    });
  });
  if (x1_out) st_rows(x1_out + (size_t)r0 * D, D, Xs, lda, D, valid);
  if constexpr (MLP) {
    // z2 = modLN(x1) into As while the first slices of w1 come in (the
    // loop's first barrier orders it before the products)
    tile_gemm<R, 64, 2>(As, lda, w1, D, hidden, ring,
                        [&] {
                          modln_tile<R>(Xs, lda, As, lda, mod, r0, rows, N, D,
                                        L, l, 3, 4, eps);
                        },
                        [&](int c0, const Acc<R>& acc) {
      for_pairs<R>(acc, [&](int r, int, int c, float v0, float v1) {
        const int col = c0 + c;
        if (col >= hidden) return;
        const float2 b = ld_bf16x2(b1 + col);
        st_bf16x2(Hs + r * ldh + col, gelu_tanh(rnd<bf16>(v0 + b.x)),
                  gelu_tanh(rnd<bf16>(v1 + b.y)));
      });
    });
    tile_gemm<R, 64, 2>(Hs, ldh, w2, hidden, D, ring, [] {},
                        [&](int c0, const Acc<R>& acc) {
      for_pairs<R>(acc, [&](int r, int i, int c, float v0, float v1) {
        const int col = c0 + c;
        if (col >= D) return;
        const float2 b = ld_bf16x2(b2 + col);
        const float* g = modrow(i, 5) + col;
        const float2 xv = ld_bf16x2(Xs + r * lda + col);
        st_bf16x2(As + r * lda + col,
                  xv.x + rnd<bf16>(rnd<bf16>(g[0]) * rnd<bf16>(v0 + b.x)),
                  xv.y + rnd<bf16>(rnd<bf16>(g[1]) * rnd<bf16>(v1 + b.y)));
      });
    });
    st_rows(y + (size_t)r0 * D, D, As, lda, D, valid);
  }
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
  const int rows = B * N;
  const int q_tiles = (rows + QR - 1) / QR, m_tiles = (rows + MR - 1) / MR;
  const size_t s_qkv = smem_qkv_tc(D);
  const size_t s_mlp = smem_mlp_tc(D, hidden, y != nullptr);
  const void* mlp = y ? (const void*)proj_mlp_tc_kernel<MR, true>
                      : (const void*)proj_mlp_tc_kernel<MR, false>;
  cudaError_t e;
  if ((e = set_smem((const void*)modln_qkv_tc_kernel<QR>, s_qkv)) ||
      (e = set_smem(mlp, s_mlp)))
    return e;
  modln_qkv_tc_kernel<QR><<<q_tiles, NT, s_qkv, st>>>(
      x, mod, wqkv, bqkv, qkv, z_out, rows, N, D, L, l, eps);
  if ((e = cudaGetLastError()) ||
      (e = launch_layer_attn(qkv, o, B, N, D, H, qscale, m_out, r_out, st)))
    return e;
  if (y)
    proj_mlp_tc_kernel<MR, true><<<m_tiles, NT, s_mlp, st>>>(
        o, x, mod, wproj, bproj, wfc1, bfc1, wfc2, bfc2, y, proj_out, x1_out,
        rows, N, D, hidden, L, l, eps);
  else
    proj_mlp_tc_kernel<MR, false><<<m_tiles, NT, s_mlp, st>>>(
        o, x, mod, wproj, bproj, nullptr, nullptr, nullptr, nullptr, nullptr,
        proj_out, x1_out, rows, N, D, hidden, L, l, eps);
  return cudaGetLastError();
}

}  // namespace
