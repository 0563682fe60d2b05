// Backward of one adaLN-zero DiT block, hand-written for Hopper (sm_90a),
// bf16 and f32.
//
// Replaces the TPU kernel t2ms_tpu/ops/dit_block.py:_fused_block_diff_bwd
// (_block_vjp_kernel), which runs jax.vjp over _block_math inside ONE program
// per batch element: the element's activations, every head's (N, N)
// probabilities and every intermediate gradient stay in VMEM, and the f32
// weight grads accumulate in scratch across the sequential batch grid.
// Hopper has 227 KB of shared memory per block and nothing carries across
// blocks, so the VJP is derived by hand and cut at the residual boundaries,
// as the forward is:
//
//   recompute  the forward's kernels run again from the saved inputs,
//              writing what the backward reads: z1 = modLN(x), qkv, the
//              attention output o, the per-(row, head) row max m and row
//              sum r, proj, x1. In bf16 on the stack's tensor-core kernels
//              (dit_layer.cuh: modln_qkv_tc_kernel, heads_fwd_kernel, the
//              first half of proj_mlp_tc_kernel), in f32 on dit_common.cuh's
//              modln_qkv and attn_proj kernels.
//   mlp_bwd    per 64-row tile of one element: recompute z2, a1 = fc1,
//              h1 = GELU(a1), h2 = fc2; dgate_m = sum dy*h2; dh2 = gate_m*dy;
//              dh1 = dh2 @ w2^T; da1 = dh1 * GELU'(a1); dz2 = da1 @ w1^T; the
//              modulate + LayerNorm VJP -> dshift_m, dscale_m and
//              dx1 = dy + LN-VJP (f32).
//   attn_out   dgate_a = sum dx1*proj; dpo = gate_a*dx1; do = dpo @ wproj^T;
//              delta = rowsum over each head of do*o.
//   attn_dq    per (element, q tile), looping over k tiles: p rebuilt from
//              the saved m and r exactly as the forward rounds it
//              (T(exp(T(s - m))) / r), dp = do v^T, ds = p (dp - delta),
//              dq += ds k; dq * scale.
//   attn_dkdv  per (element, k tile), looping over q tiles: dv += p^T do,
//              dk += ds^T q_scaled. Two kernels instead of atomics, so
//              every sum has one fixed order and runs repeat bit for bit.
//   qkv_bwd    dz1 = dqkv @ wqkv^T; modulate + LN VJP -> dshift_a,
//              dscale_a and dx = dx1 + LN-VJP.
//   wgrad      dW = A^T G over all B*N rows (z1^T dqkv, o^T dpo, z2^T da1,
//              h1^T dh2) and db = column sums of G: f32 partials per split
//              of rows, then a reduction over the splits in a fixed order.
//   dmod       per-(element, tile) f32 partials of the six adaLN rows,
//              summed over the tiles in a fixed order.
//
// Rows past N (N = 480 is not a multiple of 64) load as zero and are kept
// out of every row sum, softmax and weight-grad sum. adaLN-zero at init
// zeroes every gate and with it every block-weight grad but adaLN's, which
// would hide faults: every check feeds random mod.
//
// bf16 runs this on tensor-core kernels (below, "bf16"): the recompute on
// dit_layer.cuh's three; the MLP half and the qkv half on persistent,
// warp-specialised wgmma kernels (mlp_bwd_tc_kernel, qkv_bwd_tc_kernel),
// each with its elementwise work and LayerNorm VJP in the same kernel; the
// attention output on dit_layer.cuh's row GEMM (tile_gemm, mma.sync); the
// attention VJP on heads_bwd.cuh's q-tile and kv-tile kernels with their
// BLOCK recipe (the rows' m, 1/r and delta from the attention-output
// kernel); the weight grads on wgrad_tc_kernel. Rounding points as above,
// with these differences from the first kernels (f32 still runs those, FMA
// loops held tightly to the twin):
//   - p = e * (1/r), one f32 reciprocal a row, where they divide by r;
//   - tanh-GELU and its derivative from exp(-2u) on the exponent unit (the
//     forward's gelu_fast), where they call tanhf: h1 rounds as the
//     forward's h does;
//   - every sum over rows or columns runs in another (still fixed) order:
//     the dmod, dgate and bias partials through warp shuffles and then the
//     warps in order; the LayerNorm statistics of the VJP over the four
//     lanes that hold a row in wgmma's accumulator layout.
//
// Bound on an H100 SXM at the main-path call (B=1024, N=480, D=128, 4
// heads, hidden 256, bf16): the recompute is the forward's ~0.25 TFLOP and
// the backward's own products ~0.50 TFLOP (dense: 2 products per forward
// product; attention: QK^T again, dP, dQ, dK, dV), ~0.75 TFLOP or 0.76 ms
// at 989 TFLOP/s, against ~0.5 GB that must move (x, dy, dx) or 0.15 ms:
// bound by operations. The cut at the residual boundaries adds the
// intermediates above, about 2.5 GB written and read (0.75 ms at 3.35
// TB/s), so a realistic floor is near 2 ms. Each row kernel alone is bound
// by its bytes: the MLP half moves about 1.5 GB a call (x1 and dy read
// twice, as below; dx1 in f32, z2, h1, dh2 and da1 out) against 161 GFLOP
// (its z2 @ w1 twice), 0.45 against 0.16 ms; the qkv half 0.89 GB (dqkv, x,
// dx1 in; dx out) against 48 GFLOP, 0.27 against 0.05 ms.
// What the design does about it:
// - the MLP and qkv halves (dit_layer.cuh's row-kernel design: one block
//   an SM, two consumer warpgroups on their own 64-row tiles, a TMA producer
//   warpgroup, the weights resident in shared memory where they fit, else
//   streamed through row_plan's slots; wgmma with the sums in registers,
//   epilogues from registers, outputs by TMA store through 3-d maps that
//   clip each element's last tile): the weights are read both ways from
//   one copy (a slab MN-major for z2 @ w1 is K-major for da1 @ w1^T), so
//   no transposed copy is made; the MLP's hidden-width tiles never sit in
//   shared memory (h1 and da1 are computed 64 columns at a time, stored
//   through a staging slab and packed into register-A fragments of h2 and
//   dz2, whose sums stay in registers over all of hidden; a1 is rebuilt by
//   a second z2 @ w1 in pass 2, cheaper than holding it); z2 and dh2 are
//   written over the x1 and dy tiles, which come in again for the
//   LayerNorm VJP (a group's x1, dy and staging tiles beside the 128 KB of
//   weights fill the block's shared memory); the VJP's statistics are
//   recomputed from x1 in registers; the qkv half takes dqkv's 3 D columns as 64-column K
//   slabs, each on its own barrier, and loads dx1 into registers under the
//   products;
// - the attention output runs dit_layer.cuh's tile_gemm (mma.sync m16n8k16
//   with the sums in registers, operands through ldmatrix, the weight
//   through a cp.async ring, wproj^T copied once a call);
// - the attention VJP (heads_bwd.cuh's BLOCK recipe) runs on wgmma: K/V
//   (q kernel) and q/do (kv kernel) tiles of one head come in by TMA,
//   shared by two warpgroups, with S, dP, e and ds in registers, one pass
//   over the k tiles (the statistics come from the recompute);
// - the weight grads run 128 x 128 output tiles over about 256 row splits,
//   so A and G are read once a tile column (L2 catches the rest).
// Probes on an H100 chose the out-projection's ring (two stages of 64 rows)
// and the weight grads' split count; other launch bounds for the attention
// kernels gained nothing; the two row kernels' variants are in PERF.md.

// C interface for ctypes: dit_block_backward_{bf16,f32} launch everything
// on the given stream and return cudaGetLastError(), or
// T2MS_UNSUPPORTED_SHAPE for a shape the kernels do not take (launching
// nothing); dit_block_backward_workspace gives the workspace bytes the
// caller allocates; dit_block_check answers the shape question for the
// forward and backward kernels together; dit_block_attention_bwd_bf16 runs
// the bf16 attention VJP alone (for checks against its twin).

#include "dit_layer.cuh"
#include "heads_bwd.cuh"

namespace {

constexpr int WG_ROWS = 8192;  // rows of one split of a weight-grad sum

template <typename T> __host__ __device__ size_t mlp_bwd_big(int D, int hidden) {
  const size_t a = (size_t)tb<T>() * (hidden + pad<T>()) * sizeof(T);
  const size_t b = (size_t)tb<T>() * (D + PADF) * 4;
  return al128(a > b ? a : b);
}
template <typename T> __host__ __device__ size_t mlp_bwd_w(int D, int hidden) {
  const int wmax = D > hidden ? D : hidden;
  const size_t a = (size_t)wmax * (CW + pad<T>());
  const size_t b = (size_t)CW * (wmax + pad<T>());
  return al128((a > b ? a : b) * sizeof(T));
}
template <typename T> __host__ __device__ size_t smem_mlp_bwd(int D, int hidden) {
  const int R = tb<T>(), P = pad<T>();
  return 2 * al128(R * (D + P) * sizeof(T)) + 2 * mlp_bwd_big<T>(D, hidden) +
         mlp_bwd_w<T>(D, hidden) + al128(R * (CW + PADF) * 4) + al128(R * 4);
}
template <typename T> __host__ __device__ size_t smem_attn_out_bwd(int D) {
  const int R = tb<T>(), P = pad<T>();
  return al128(R * (D + P) * sizeof(T)) + al128(CW * (D + P) * sizeof(T)) +
         al128(R * (D + PADF) * 4);
}
template <typename T> __host__ __device__ size_t smem_attn_dq(int D, int H) {
  const int R = tb<T>(), P = pad<T>();
  return 4 * al128(R * (D + P) * sizeof(T)) + 2 * al128(R * (R + PADF) * 4) +
         al128(R * (R + P) * sizeof(T)) + al128(R * (D + PADF) * 4) +
         3 * al128(R * H * 4);
}
template <typename T> __host__ __device__ size_t smem_attn_dkdv(int D, int H) {
  const int R = tb<T>(), P = pad<T>();
  return 4 * al128(R * (D + P) * sizeof(T)) + 2 * al128(R * (R + PADF) * 4) +
         2 * al128(R * (R + P) * sizeof(T)) + 2 * al128(R * (D + PADF) * 4) +
         3 * al128(R * H * 4);
}
template <typename T> __host__ __device__ size_t smem_qkv_bwd(int D) {
  const int R = tb<T>(), P = pad<T>();
  return al128(R * (3 * D + P) * sizeof(T)) +
         al128(CW * (3 * D + P) * sizeof(T)) + 2 * al128(R * (D + PADF) * 4) +
         al128(R * 4);
}
template <typename T> __host__ __device__ size_t smem_wgrad() {
  return 2 * al128(tb<T>() * (CW + pad<T>()) * sizeof(T)) +
         al128(CW * (CW + PADF) * 4);
}

__device__ __forceinline__ float gelu_tanh_grad(float v) {
  const float k = 0.7978845608028654f;  // sqrt(2/pi)
  const float t = tanhf(k * (v + 0.044715f * v * v * v));
  return 0.5f * (1.0f + t) +
         0.5f * v * (1.0f - t * t) * k * (1.0f + 3.0f * 0.044715f * v * v);
}

// Element-aligned row tile of the backward's row kernels: block
// b * tiles + t holds rows n0 = t * R .. n0 + valid of element b, so the
// per-element dmod partials never mix two elements.
struct Tile {
  int b, valid;
  size_t r0;  // first global row
};
template <typename T> __device__ Tile tile_of(int N) {
  const int R = tb<T>(), tiles = (N + R - 1) / R;
  const int b = blockIdx.x / tiles, n0 = (blockIdx.x % tiles) * R;
  return Tile{b, min(R, N - n0), (size_t)b * N + n0};
}

// As[i][c] = T(LN(x[i]) * (1 + modb[isc]) + modb[ish]), one warp per row;
// rows past `valid` are zero. x points at the tile's first row.
template <typename T>
__device__ void modln_tile(const T* __restrict__ x,
                           const float* __restrict__ modb, int ish, int isc,
                           T* As, int lda, int R, int valid, int D,
                           float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < R; i += NW) {
    if (i >= valid) {
      for (int c = lane; c < D; c += 32) As[i * lda + c] = from_f<T>(0.0f);
      continue;
    }
    float v[MAXD / 32];
#pragma unroll
    for (int u = 0; u < MAXD / 32; ++u) {
      const int c = lane + 32 * u;
      v[u] = c < D ? to_f<T>(x[(size_t)i * D + c]) : 0.0f;
    }
    float rs;
    const float mu = ln_stats(v, D, eps, rs);
#pragma unroll
    for (int u = 0; u < MAXD / 32; ++u) {
      const int c = lane + 32 * u;
      if (c < D)
        As[i * lda + c] = from_f<T>((v[u] - mu) * rs *
                                    (1.0f + modb[isc * D + c]) +
                                    modb[ish * D + c]);
    }
  }
}

// The VJP of z = LN(x) * (1 + scale) + shift for one tile, given dz (f32
// in shared memory): part[ish] = sum_rows dz, part[isc] = sum_rows dz*xhat,
// and dst = base + rs * (g - mean(g) - xhat * mean(g * xhat)) with
// g = dz * (1 + scale). x, base and dst point at the tile's first row.
template <typename T, typename Base, typename Out>
__device__ void ln_vjp_tile(const T* __restrict__ x,
                            const float* __restrict__ modb, int ish, int isc,
                            const float* DZ, int ldz, float* Xh, int ldx,
                            float* RS, const Base* __restrict__ base,
                            Out* __restrict__ dst, float* __restrict__ part,
                            int R, int valid, int D, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < R; i += NW) {
    if (i >= valid) {
      for (int c = lane; c < D; c += 32) Xh[i * ldx + c] = 0.0f;
      continue;
    }
    float v[MAXD / 32];
#pragma unroll
    for (int u = 0; u < MAXD / 32; ++u) {
      const int c = lane + 32 * u;
      v[u] = c < D ? to_f<T>(x[(size_t)i * D + c]) : 0.0f;
    }
    float rs;
    const float mu = ln_stats(v, D, eps, rs);
#pragma unroll
    for (int u = 0; u < MAXD / 32; ++u) {
      const int c = lane + 32 * u;
      if (c < D) Xh[i * ldx + c] = (v[u] - mu) * rs;
    }
    if (lane == 0) RS[i] = rs;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += NT) {
    float s0 = 0.0f, s1 = 0.0f;
    for (int i = 0; i < valid; ++i) {
      const float d = DZ[i * ldz + c];
      s0 += d;
      s1 += d * Xh[i * ldx + c];
    }
    part[ish * D + c] = s0;
    part[isc * D + c] = s1;
  }
  const float* sc = modb + isc * D;
  for (int i = warp; i < valid; i += NW) {
    float g[MAXD / 32], xh[MAXD / 32];
    float sg = 0.0f, sgx = 0.0f;
#pragma unroll
    for (int u = 0; u < MAXD / 32; ++u) {
      const int c = lane + 32 * u;
      g[u] = c < D ? DZ[i * ldz + c] * (1.0f + sc[c]) : 0.0f;
      xh[u] = c < D ? Xh[i * ldx + c] : 0.0f;
      sg += g[u];
      sgx += g[u] * xh[u];
    }
    const float mg = warp_sum(sg) / D, mgx = warp_sum(sgx) / D;
    const float rs = RS[i];
#pragma unroll
    for (int u = 0; u < MAXD / 32; ++u) {
      const int c = lane + 32 * u;
      if (c < D) {
        const size_t o = (size_t)i * D + c;
        dst[o] = from_f<Out>(to_f<Base>(base[o]) +
                             rs * (g[u] - mg - xh[u] * mgx));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// MLP half: recompute, then dy -> dx1 (f32), with z2, h1, dh2, da1 written
// for the weight grads and the dshift_m, dscale_m, dgate_m partials.

template <typename T>
__global__ void __launch_bounds__(NT)
mlp_bwd_kernel(const T* __restrict__ x1, const float* __restrict__ mod,
               const T* __restrict__ w1, const T* __restrict__ b1,
               const T* __restrict__ w2, const T* __restrict__ b2,
               const T* __restrict__ dy, float* __restrict__ dx1,
               T* __restrict__ z2_out, T* __restrict__ h1_out,
               T* __restrict__ dh2_out, T* __restrict__ da1_out,
               float* __restrict__ part, int N, int D, int hidden,
               float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int R = tb<T>();
  const int P = pad<T>();
  const int ldz = D + P, ldh = hidden + P, ldc = CW + PADF, ldf = D + PADF;
  unsigned char* p = smem;
  T* Zs = reinterpret_cast<T*>(p);   p += al128(R * ldz * sizeof(T));
  T* A1s = reinterpret_cast<T*>(p);  // a1, then da1 in place
  float* Xh = reinterpret_cast<float*>(p);  // after the last use of da1
  p += mlp_bwd_big<T>(D, hidden);
  T* H1s = reinterpret_cast<T*>(p);  // h1
  float* DZ = reinterpret_cast<float*>(p);  // dz2, after the last use of h1
  p += mlp_bwd_big<T>(D, hidden);
  T* DH2s = reinterpret_cast<T*>(p); p += al128(R * ldz * sizeof(T));
  T* Ws = reinterpret_cast<T*>(p);   p += mlp_bwd_w<T>(D, hidden);
  float* Cs = reinterpret_cast<float*>(p); p += al128(R * ldc * 4);
  float* RS = reinterpret_cast<float*>(p);

  const Tile tl = tile_of<T>(N);
  const int valid = tl.valid;
  const size_t r0 = tl.r0;
  const float* modb = mod + (size_t)tl.b * 6 * D;
  float* pt = part + (size_t)blockIdx.x * 6 * D;

  // z2 = T(LN(x1) * (1 + scale_m) + shift_m)
  modln_tile<T>(x1 + r0 * D, modb, 3, 4, Zs, ldz, R, valid, D, eps);
  __syncthreads();
  for (int idx = threadIdx.x; idx < valid * D; idx += NT)
    z2_out[r0 * D + idx] = Zs[(idx / D) * ldz + idx % D];
  // a1 = T(z2 @ w1 + b1), h1 = T(gelu(a1))
  for (int c0 = 0; c0 < hidden; c0 += CW) {
    load_rows<T>(Ws, CW + P, w1 + c0, hidden, D, D, CW);
    __syncthreads();
    Mma<T, false>::run(Zs, ldz, Ws, CW + P, Cs, ldc, R, CW, D, false);
    __syncthreads();
    for (int idx = threadIdx.x; idx < R * CW; idx += NT) {
      const int i = idx / CW, c = c0 + idx % CW;
      const float a = rnd<T>(Cs[i * ldc + idx % CW] + to_f<T>(b1[c]));
      const T h = from_f<T>(gelu_tanh(a));
      A1s[i * ldh + c] = from_f<T>(a);
      H1s[i * ldh + c] = h;
      if (i < valid) h1_out[(r0 + i) * hidden + c] = h;
    }
  }
  // h2 = T(h1 @ w2 + b2); dgate_m = sum_rows dy * h2; dh2 = T(gate_m * dy)
  for (int c0 = 0; c0 < D; c0 += CW) {
    load_rows<T>(Ws, CW + P, w2 + c0, D, hidden, hidden, CW);
    __syncthreads();
    Mma<T, false>::run(H1s, ldh, Ws, CW + P, Cs, ldc, R, CW, hidden, false);
    __syncthreads();
    for (int idx = threadIdx.x; idx < R * CW; idx += NT) {
      const int i = idx / CW, j = idx % CW, c = c0 + j;
      float prod = 0.0f, d = 0.0f;
      if (i < valid) {
        const size_t o = (r0 + i) * D + c;
        const float dyv = to_f<T>(dy[o]);
        prod = dyv * rnd<T>(Cs[i * ldc + j] + to_f<T>(b2[c]));
        d = rnd<T>(rnd<T>(modb[5 * D + c]) * dyv);
        dh2_out[o] = from_f<T>(d);
      }
      DH2s[i * ldz + c] = from_f<T>(d);
      Cs[i * ldc + j] = prod;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < CW; j += NT) {
      float s = 0.0f;
      for (int i = 0; i < valid; ++i) s += Cs[i * ldc + j];
      pt[5 * D + c0 + j] = s;
    }
  }
  // dh1 = dh2 @ w2^T (w2 rows c0.. as the transposed operand);
  // da1 = T(dh1 * gelu'(a1)) in place of a1
  for (int c0 = 0; c0 < hidden; c0 += CW) {
    load_rows<T>(Ws, D + P, w2 + (size_t)c0 * D, D, CW, CW, D);
    __syncthreads();
    Mma<T, true>::run(DH2s, ldz, Ws, D + P, Cs, ldc, R, CW, D, false);
    __syncthreads();
    for (int idx = threadIdx.x; idx < R * CW; idx += NT) {
      const int i = idx / CW, c = c0 + idx % CW;
      float da = 0.0f;
      if (i < valid)
        da = Cs[i * ldc + idx % CW] * gelu_tanh_grad(to_f<T>(A1s[i * ldh + c]));
      const T v = from_f<T>(da);
      A1s[i * ldh + c] = v;
      if (i < valid) da1_out[(r0 + i) * hidden + c] = v;
    }
  }
  // dz2 = da1 @ w1^T (w1 rows c0.. as the transposed operand)
  for (int c0 = 0; c0 < D; c0 += CW) {
    load_rows<T>(Ws, hidden + P, w1 + (size_t)c0 * hidden, hidden, CW, CW,
                 hidden);
    __syncthreads();
    Mma<T, true>::run(A1s, ldh, Ws, hidden + P, DZ + c0, ldf, R, CW, hidden,
                      false);
    __syncthreads();
  }
  // dshift_m, dscale_m; dx1 = dy + LN-VJP
  ln_vjp_tile<T>(x1 + r0 * D, modb, 3, 4, DZ, ldf, Xh, ldf, RS, dy + r0 * D,
                 dx1 + r0 * D, pt, R, valid, D, eps);
}

// ---------------------------------------------------------------------------
// Attention output: dgate_a partial, dpo = T(gate_a * dx1),
// do = T(dpo @ wproj^T) and delta = rowsum over each head of do * o.

template <typename T>
__global__ void __launch_bounds__(NT)
attn_out_bwd_kernel(const float* __restrict__ dx1, const T* __restrict__ proj,
                    const T* __restrict__ o, const float* __restrict__ mod,
                    const T* __restrict__ wproj, T* __restrict__ dpo_out,
                    T* __restrict__ do_out, float* __restrict__ delta,
                    float* __restrict__ part, int N, int D, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int R = tb<T>();
  const int ld = D + pad<T>(), ldf = D + PADF, DH = D / H;
  unsigned char* p = smem;
  T* DPO = reinterpret_cast<T*>(p);  p += al128(R * ld * sizeof(T));
  T* Ws = reinterpret_cast<T*>(p);   p += al128(CW * ld * sizeof(T));
  float* DO = reinterpret_cast<float*>(p);

  const Tile tl = tile_of<T>(N);
  const int valid = tl.valid;
  const size_t r0 = tl.r0;
  const float* gate = mod + ((size_t)tl.b * 6 + 2) * D;
  float* pt = part + (size_t)blockIdx.x * 6 * D;

  for (int idx = threadIdx.x; idx < R * D; idx += NT) {
    const int i = idx / D, c = idx % D;
    float d = 0.0f;
    if (i < valid) {
      d = rnd<T>(rnd<T>(gate[c]) * dx1[(r0 + i) * D + c]);
      dpo_out[(r0 + i) * D + c] = from_f<T>(d);
    }
    DPO[i * ld + c] = from_f<T>(d);
  }
  for (int c = threadIdx.x; c < D; c += NT) {
    float s = 0.0f;
    for (int i = 0; i < valid; ++i) {
      const size_t e = (r0 + i) * D + c;
      s += dx1[e] * to_f<T>(proj[e]);
    }
    pt[2 * D + c] = s;
  }
  for (int c0 = 0; c0 < D; c0 += CW) {
    load_rows<T>(Ws, ld, wproj + (size_t)c0 * D, D, CW, CW, D);
    __syncthreads();
    Mma<T, true>::run(DPO, ld, Ws, ld, DO + c0, ldf, R, CW, D, false);
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < valid * D; idx += NT)
    do_out[r0 * D + idx] = from_f<T>(DO[(idx / D) * ldf + idx % D]);
  for (int idx = threadIdx.x; idx < valid * H; idx += NT) {
    const int i = idx / H, h = idx % H;
    float s = 0.0f;
    for (int c = h * DH; c < (h + 1) * DH; ++c)
      s += rnd<T>(DO[i * ldf + c]) * to_f<T>(o[(r0 + i) * D + c]);
    delta[(r0 + i) * H + h] = s;
  }
}

// ---------------------------------------------------------------------------
// Attention VJP. Shared pieces: the q tile scaled at input width as the
// forward scales it, the tile's dO rows and the q rows' m, r, delta.

template <typename T>
__device__ void load_q_side(const T* __restrict__ base, const T* __restrict__ dO,
                            const float* __restrict__ mst,
                            const float* __restrict__ rst,
                            const float* __restrict__ delta, T* Qs, T* dOs,
                            int ld, float* Ms, float* Rs, float* Dl,
                            size_t row0, int q0, int vq, int D, int H,
                            float qscale) {
  constexpr int R = tb<T>();
  const int W3 = 3 * D;
  for (int idx = threadIdx.x; idx < R * D; idx += NT) {
    const int i = idx / D, c = idx % D;
    const bool ok = i < vq;
    const float q = ok ? to_f<T>(base[(size_t)(q0 + i) * W3 + c]) : 0.0f;
    Qs[i * ld + c] = from_f<T>(q * qscale);
    dOs[i * ld + c] = ok ? dO[(row0 + i) * D + c] : from_f<T>(0.0f);
  }
  for (int idx = threadIdx.x; idx < R * H; idx += NT) {
    const int i = idx / H, h = idx % H;
    const bool ok = i < vq;
    const size_t s = (row0 + i) * H + h;
    Ms[h * R + i] = ok ? mst[s] : 0.0f;
    Rs[h * R + i] = ok ? rst[s] : 1.0f;
    Dl[h * R + i] = ok ? delta[s] : 0.0f;
  }
}

// p = T(exp(T(s - m))) / r as the forward rounds it, ds = p * (dp - delta);
// zero outside the valid q rows i < vq and k rows j < vk.
template <typename T>
__device__ __forceinline__ void p_ds(const float* Ss, const float* dPs,
                                     int lds, const float* Ms,
                                     const float* Rs, const float* Dl, int i,
                                     int j, int vq, int vk, float& pv,
                                     float& ds) {
  pv = 0.0f;
  ds = 0.0f;
  if (i < vq && j < vk) {
    pv = rnd<T>(expf(rnd<T>(Ss[i * lds + j] - Ms[i]))) / Rs[i];
    ds = pv * (dPs[i * lds + j] - Dl[i]);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
attn_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ dO,
               const float* __restrict__ mst, const float* __restrict__ rst,
               const float* __restrict__ delta, T* __restrict__ dqkv, int N,
               int D, int H, float qscale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int R = tb<T>();
  const int P = pad<T>();
  const int ld = D + P, lds = R + PADF, ldp = R + P, ldf = D + PADF;
  const int DH = D / H, W3 = 3 * D;
  unsigned char* p = smem;
  T* Qs = reinterpret_cast<T*>(p);   p += al128(R * ld * sizeof(T));
  T* dOs = reinterpret_cast<T*>(p);  p += al128(R * ld * sizeof(T));
  T* Ks = reinterpret_cast<T*>(p);   p += al128(R * ld * sizeof(T));
  T* Vs = reinterpret_cast<T*>(p);   p += al128(R * ld * sizeof(T));
  float* Ss = reinterpret_cast<float*>(p);  p += al128(R * lds * 4);
  float* dPs = reinterpret_cast<float*>(p); p += al128(R * lds * 4);
  T* DSs = reinterpret_cast<T*>(p);  p += al128(R * ldp * sizeof(T));
  float* dQ = reinterpret_cast<float*>(p);  p += al128(R * ldf * 4);
  float* Ms = reinterpret_cast<float*>(p);  p += al128(R * H * 4);
  float* Rs = reinterpret_cast<float*>(p);  p += al128(R * H * 4);
  float* Dl = reinterpret_cast<float*>(p);

  const int tiles = (N + R - 1) / R;
  const int b = blockIdx.x / tiles, q0 = (blockIdx.x % tiles) * R;
  const int vq = min(R, N - q0);
  const size_t row0 = (size_t)b * N + q0;
  const T* base = qkv + (size_t)b * N * W3;
  load_q_side<T>(base, dO, mst, rst, delta, Qs, dOs, ld, Ms, Rs, Dl, row0,
                 q0, vq, D, H, qscale);
  for (int idx = threadIdx.x; idx < R * D; idx += NT)
    dQ[(idx / D) * ldf + idx % D] = 0.0f;

  for (int k0 = 0; k0 < N; k0 += R) {
    const int vk = min(R, N - k0);
    __syncthreads();
    load_rows<T>(Ks, ld, base + (size_t)k0 * W3 + D, W3, R, vk, D);
    load_rows<T>(Vs, ld, base + (size_t)k0 * W3 + 2 * D, W3, R, vk, D);
    __syncthreads();
    for (int h = 0; h < H; ++h) {
      Mma<T, true>::run(Qs + h * DH, ld, Ks + h * DH, ld, Ss, lds, R, R, DH,
                        false);
      Mma<T, true>::run(dOs + h * DH, ld, Vs + h * DH, ld, dPs, lds, R, R,
                        DH, false);
      __syncthreads();
      for (int idx = threadIdx.x; idx < R * R; idx += NT) {
        const int i = idx / R, j = idx % R;
        float pv, ds;
        p_ds<T>(Ss, dPs, lds, Ms + h * R, Rs + h * R, Dl + h * R, i, j, vq,
                vk, pv, ds);
        DSs[i * ldp + j] = from_f<T>(ds);
      }
      __syncthreads();
      Mma<T, false>::run(DSs, ldp, Ks + h * DH, ld, dQ + h * DH, ldf, R, DH,
                         R, true);
      __syncthreads();
    }
  }
  for (int idx = threadIdx.x; idx < vq * D; idx += NT) {
    const int i = idx / D, c = idx % D;
    dqkv[(row0 + i) * W3 + c] = from_f<T>(dQ[i * ldf + c] * qscale);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
attn_dkdv_kernel(const T* __restrict__ qkv, const T* __restrict__ dO,
                 const float* __restrict__ mst, const float* __restrict__ rst,
                 const float* __restrict__ delta, T* __restrict__ dqkv, int N,
                 int D, int H, float qscale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int R = tb<T>();
  const int P = pad<T>();
  const int ld = D + P, lds = R + PADF, ldp = R + P, ldf = D + PADF;
  const int DH = D / H, W3 = 3 * D;
  unsigned char* p = smem;
  T* Ks = reinterpret_cast<T*>(p);   p += al128(R * ld * sizeof(T));
  T* Vs = reinterpret_cast<T*>(p);   p += al128(R * ld * sizeof(T));
  T* Qs = reinterpret_cast<T*>(p);   p += al128(R * ld * sizeof(T));
  T* dOs = reinterpret_cast<T*>(p);  p += al128(R * ld * sizeof(T));
  float* Ss = reinterpret_cast<float*>(p);  p += al128(R * lds * 4);
  float* dPs = reinterpret_cast<float*>(p); p += al128(R * lds * 4);
  T* PTs = reinterpret_cast<T*>(p);  p += al128(R * ldp * sizeof(T));
  T* DSs = reinterpret_cast<T*>(p);  p += al128(R * ldp * sizeof(T));
  float* dK = reinterpret_cast<float*>(p);  p += al128(R * ldf * 4);
  float* dV = reinterpret_cast<float*>(p);  p += al128(R * ldf * 4);
  float* Ms = reinterpret_cast<float*>(p);  p += al128(R * H * 4);
  float* Rs = reinterpret_cast<float*>(p);  p += al128(R * H * 4);
  float* Dl = reinterpret_cast<float*>(p);

  const int tiles = (N + R - 1) / R;
  const int b = blockIdx.x / tiles, k0 = (blockIdx.x % tiles) * R;
  const int vk = min(R, N - k0);
  const T* base = qkv + (size_t)b * N * W3;
  load_rows<T>(Ks, ld, base + (size_t)k0 * W3 + D, W3, R, vk, D);
  load_rows<T>(Vs, ld, base + (size_t)k0 * W3 + 2 * D, W3, R, vk, D);
  for (int idx = threadIdx.x; idx < R * D; idx += NT) {
    dK[(idx / D) * ldf + idx % D] = 0.0f;
    dV[(idx / D) * ldf + idx % D] = 0.0f;
  }

  for (int q0 = 0; q0 < N; q0 += R) {
    const int vq = min(R, N - q0);
    __syncthreads();
    load_q_side<T>(base, dO, mst, rst, delta, Qs, dOs, ld, Ms, Rs, Dl,
                   (size_t)b * N + q0, q0, vq, D, H, qscale);
    __syncthreads();
    for (int h = 0; h < H; ++h) {
      Mma<T, true>::run(Qs + h * DH, ld, Ks + h * DH, ld, Ss, lds, R, R, DH,
                        false);
      Mma<T, true>::run(dOs + h * DH, ld, Vs + h * DH, ld, dPs, lds, R, R,
                        DH, false);
      __syncthreads();
      for (int idx = threadIdx.x; idx < R * R; idx += NT) {
        const int i = idx / R, j = idx % R;   // q row i, k row j
        float pv, ds;
        p_ds<T>(Ss, dPs, lds, Ms + h * R, Rs + h * R, Dl + h * R, i, j, vq,
                vk, pv, ds);
        PTs[i * ldp + j] = from_f<T>(pv);
        DSs[i * ldp + j] = from_f<T>(ds);
      }
      __syncthreads();
      // dv += p^T do and dk += ds^T q_scaled (A stored q x k, read transposed)
      Mma<T, false, true>::run(PTs, ldp, dOs + h * DH, ld, dV + h * DH, ldf,
                               R, DH, R, true);
      Mma<T, false, true>::run(DSs, ldp, Qs + h * DH, ld, dK + h * DH, ldf,
                               R, DH, R, true);
      __syncthreads();
    }
  }
  for (int idx = threadIdx.x; idx < vk * D; idx += NT) {
    const int j = idx / D, c = idx % D;
    const size_t o = ((size_t)b * N + k0 + j) * W3;
    dqkv[o + D + c] = from_f<T>(dK[j * ldf + c]);
    dqkv[o + 2 * D + c] = from_f<T>(dV[j * ldf + c]);
  }
}

// ---------------------------------------------------------------------------
// qkv half: dz1 = dqkv @ wqkv^T, then dshift_a, dscale_a and
// dx = dx1 + LN-VJP, cast to T.

template <typename T>
__global__ void __launch_bounds__(NT)
qkv_bwd_kernel(const T* __restrict__ x, const float* __restrict__ mod,
               const T* __restrict__ wqkv, const T* __restrict__ dqkv,
               const float* __restrict__ dx1, T* __restrict__ dx,
               float* __restrict__ part, int N, int D, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int R = tb<T>();
  const int W3 = 3 * D, ldq = W3 + pad<T>(), ldf = D + PADF;
  unsigned char* p = smem;
  T* DQs = reinterpret_cast<T*>(p);  p += al128(R * ldq * sizeof(T));
  T* Ws = reinterpret_cast<T*>(p);   p += al128(CW * ldq * sizeof(T));
  float* DZ = reinterpret_cast<float*>(p); p += al128(R * ldf * 4);
  float* Xh = reinterpret_cast<float*>(p); p += al128(R * ldf * 4);
  float* RS = reinterpret_cast<float*>(p);

  const Tile tl = tile_of<T>(N);
  const size_t r0 = tl.r0;
  load_rows<T>(DQs, ldq, dqkv + r0 * W3, W3, R, tl.valid, W3);
  for (int c0 = 0; c0 < D; c0 += CW) {
    load_rows<T>(Ws, ldq, wqkv + (size_t)c0 * W3, W3, CW, CW, W3);
    __syncthreads();
    Mma<T, true>::run(DQs, ldq, Ws, ldq, DZ + c0, ldf, R, CW, W3, false);
    __syncthreads();
  }
  ln_vjp_tile<T>(x + r0 * D, mod + (size_t)tl.b * 6 * D, 0, 1, DZ, ldf, Xh,
                 ldf, RS, dx1 + r0 * D, dx + r0 * D,
                 part + (size_t)blockIdx.x * 6 * D, R, tl.valid, D, eps);
}

// ---------------------------------------------------------------------------
// Weight grads: part_w[s] = A[rows of s]^T G[rows of s] (a CW x CW tile per
// block; A is rows x K, G rows x M), part_b[s] = column sums of G; then
// sum_splits adds the splits in order.

template <typename T>
__global__ void __launch_bounds__(NT)
wgrad_kernel(const T* __restrict__ A, int K, const T* __restrict__ G, int M,
             int rows, int split_rows, float* __restrict__ part_w,
             float* __restrict__ part_b) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int R = tb<T>();
  const int ld = CW + pad<T>(), ldc = CW + PADF;
  unsigned char* p = smem;
  T* As = reinterpret_cast<T*>(p);  p += al128(R * ld * sizeof(T));
  T* Gs = reinterpret_cast<T*>(p);  p += al128(R * ld * sizeof(T));
  float* Cs = reinterpret_cast<float*>(p);
  const int m0 = blockIdx.x * CW, k0 = blockIdx.y * CW, s = blockIdx.z;
  const int rbeg = s * split_rows, rend = min(rows, rbeg + split_rows);
  const bool bias = blockIdx.y == 0 && threadIdx.x < CW;
  float bsum = 0.0f;
  for (int r = rbeg; r < rend; r += R) {
    const int v = min(R, rend - r);
    load_rows<T>(As, ld, A + (size_t)r * K + k0, K, R, v, CW);
    load_rows<T>(Gs, ld, G + (size_t)r * M + m0, M, R, v, CW);
    __syncthreads();
    Mma<T, false, true>::run(As, ld, Gs, ld, Cs, ldc, CW, CW, R, r != rbeg);
    if (bias)
      for (int i = 0; i < v; ++i) bsum += to_f<T>(Gs[i * ld + threadIdx.x]);
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < CW * CW; idx += NT) {
    const int kk = idx / CW, mm = idx % CW;
    part_w[((size_t)s * K + k0 + kk) * M + m0 + mm] = Cs[kk * ldc + mm];
  }
  if (bias) part_b[(size_t)s * M + m0 + threadIdx.x] = bsum;
}

__global__ void sum_splits_kernel(const float* __restrict__ part, int S,
                                  size_t n, float* __restrict__ out) {
  for (size_t e = (size_t)blockIdx.x * NT + threadIdx.x; e < n;
       e += (size_t)gridDim.x * NT) {
    float s = 0.0f;
    for (int k = 0; k < S; ++k) s += part[(size_t)k * n + e];
    out[e] = s;
  }
}

// ---------------------------------------------------------------------------
// bf16: the attention output's and the weight grads' kernels on mma.sync
// m16n8k16 (sums in registers, operands through cp.async rings). The
// out-projection runs dit_layer.cuh's tile_gemm on 64-row tiles aligned to
// one element (tile_of), so each tile's dmod partials belong to one
// element, and reads wproj^T from a copy the launch makes once a call
// (transpose_kernel). The row pass around it runs LP = 4 threads a row over
// 16-byte chunks; column sums over a tile's rows go through the warp
// (shuffles over its 8 rows) and then over the 8 warps in order, so every
// sum keeps one order.

constexpr int LP = NT / RT;  // threads a row in the row passes

// f[0..7] = the 8 values at p (bf16 or f32), and back
__device__ __forceinline__ void ld8(const bf16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(w[k] << 16);
    f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}
__device__ __forceinline__ void ld8(const float* p, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void st8(bf16* p, const float (&f)[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                 pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
}
__device__ __forceinline__ void st8(float* p, const float (&f)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(f[4], f[5], f[6], f[7]);
}

// v[k] summed over the warp's 8 rows (the lanes that share this lane's
// quarter of a row); lanes 0..LP-1 write the sums at CSw[c + k]
__device__ __forceinline__ void warp_col_sums8(float (&v)[8], float* CSw,
                                               int c) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    v[k] += __shfl_xor_sync(0xffffffffu, v[k], 4);
    v[k] += __shfl_xor_sync(0xffffffffu, v[k], 8);
    v[k] += __shfl_xor_sync(0xffffffffu, v[k], 16);
  }
  if ((threadIdx.x & 31) < LP) st8(CSw + c, v);
}

// dst[j] = the sum over the NW warps, in order, of CS[w * W + j], j < W
__device__ __forceinline__ void warps_sum(const float* CS, int W,
                                          float* __restrict__ dst) {
  for (int j = threadIdx.x; j < W; j += NT) {
    float s = 0.0f;
    for (int w = 0; w < NW; ++w) s += CS[w * W + j];
    dst[j] = s;
  }
}

// bytes of the out-projection kernel's shared memory: weight ring of two
// stages of 64 rows
constexpr size_t RING64x2 = (size_t)2 * 64 * GLD * 2;
__host__ __device__ inline size_t smem_attn_out_tc(int D) {
  return 2 * row_tile(D) + (size_t)NW * D * 4 + RING64x2;
}

// Attention output: dpo = T(T(gate_a) dx1) and the dgate_a partial (column
// sums of dx1 * proj); do = T(dpo wproj^T); then the rows' statistics of
// the attention VJP into st (B*N, H, 3): the recompute's m, 1/r, and
// delta = the sum over each head of T(do) * o.
__global__ void __launch_bounds__(NT, 2)
attn_out_bwd_tc_kernel(const float* __restrict__ dx1,
                       const bf16* __restrict__ proj,
                       const bf16* __restrict__ o,
                       const float* __restrict__ mod,
                       const bf16* __restrict__ wprojt,
                       const float* __restrict__ mst,
                       const float* __restrict__ rst,
                       bf16* __restrict__ dpo_out, bf16* __restrict__ do_out,
                       float* __restrict__ st, float* __restrict__ part, int N,
                       int D, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int R = RT;
  const int lda = D + 8;
  bf16* As = reinterpret_cast<bf16*>(smem);  // dpo
  bf16* DOs = As + R * lda;                  // T(do)
  float* CS = reinterpret_cast<float*>(DOs + R * lda);
  bf16* ring = reinterpret_cast<bf16*>(CS + NW * D);

  const Tile tl = tile_of<bf16>(N);
  const int valid = tl.valid;
  const size_t r0 = tl.r0;
  const float* gate = mod + ((size_t)tl.b * 6 + 2) * D;
  float* pt = part + (size_t)blockIdx.x * 6 * D;

  tile_gemm<R, 64, 2>(
      As, lda, wprojt, D, D, ring,
      [&] {
        const int i = threadIdx.x / LP, q = threadIdx.x % LP;
        float* CSw = CS + (threadIdx.x >> 5) * D;
        for (int c = 8 * q; c < D; c += 8 * LP) {
          float d[8] = {}, pr[8] = {}, g[8];
          if (i < valid) {
            ld8(dx1 + (r0 + i) * D + c, d);
            ld8(proj + (r0 + i) * D + c, pr);
          }
          ld8(gate + c, g);
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            pr[k] *= d[k];
            d[k] = rnd<bf16>(rnd<bf16>(g[k]) * d[k]);
          }
          warp_col_sums8(pr, CSw, c);
          st8(As + i * lda + c, d);
          if (i < valid) st8(dpo_out + (r0 + i) * D + c, d);
        }
      },
      [&](int c0, const Acc<R>& acc) {
        for_pairs<R>(acc, [&](int r, int, int c, float v0, float v1) {
          const int col = c0 + c;
          if (col < D) st_bf16x2(DOs + r * lda + col, v0, v1);
        });
      });
  warps_sum(CS, D, pt + 2 * D);
  st_rows(do_out + r0 * D, D, DOs, lda, D, valid);
  const int DH = D / H;
  for (int idx = threadIdx.x; idx < valid * H; idx += NT) {
    const int i = idx / H, h = idx % H;
    const size_t row = (r0 + i) * H + h;
    float s = 0.0f;
    for (int c = h * DH; c < (h + 1) * DH; c += 8) {
      float a[8], b[8];
      ld8(DOs + i * lda + c, a);
      ld8(o + (r0 + i) * D + c, b);
#pragma unroll
      for (int k = 0; k < 8; ++k) s += a[k] * b[k];
    }
    st[row * 3] = mst[row];
    st[row * 3 + 1] = 1.0f / rst[row];
    st[row * 3 + 2] = s;
  }
}

// Weight grads: part_w[s] = A[rows of s]^T G[rows of s] (A rows x K,
// G rows x M) for one WT x WT output tile a block, and part_b[s] = column
// sums of G; sum_splits_kernel then adds the splits in order. 8 warps of
// 64 x 32 outputs, mma.sync with A^T through ldmatrix.trans; rows come in
// WR at a time through a cp.async ring of WST stages.
constexpr int WT = 128, WR = 64, WST = 3, WLD = WT + 8;
constexpr size_t SMEM_WGRAD_TC = (size_t)WST * 2 * WR * WLD * 2;

// A fragment of X = t^T (X rows m0.., columns k0..) from a tile stored
// k-major (t[k][m]), by ldmatrix.trans
__device__ __forceinline__ void ld_at(uint32_t (&a)[4], const bf16* t, int ld,
                                      int m0, int k0) {
  const int l = threadIdx.x & 31;
  ldsm4t(a, t + (k0 + (l & 7) + ((l >> 4) << 3)) * ld + m0 +
                ((l >> 3) & 1) * 8);
}

__global__ void __launch_bounds__(NT, 2)
wgrad_tc_kernel(const bf16* __restrict__ A, int K, const bf16* __restrict__ G,
                int M, int rows, int split, float* __restrict__ part_w,
                float* __restrict__ part_b) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);  // stages of [A rows | G rows]
  const int j0 = blockIdx.x * WT, i0 = blockIdx.y * WT, s = blockIdx.z;
  const int kw = min(WT, K - i0), mw = min(WT, M - j0);
  const int rbeg = s * split, rend = min(rows, rbeg + split);
  const int steps = (rend - rbeg + WR - 1) / WR;
  const int warp = threadIdx.x >> 5, wi = warp >> 2, wj = warp & 3;
  const bool active = 64 * wi < kw && 32 * wj < mw;
  const int ca = kw / 8, cg = mw / 8;
  int fit = 0;
  auto fetch = [&] {
    if (fit < steps) {
      const int r = rbeg + fit * WR, v = min(WR, rend - r);
      bf16* As = ring + fit % WST * 2 * WR * WLD;
      bf16* Gs = As + WR * WLD;
      for (int idx = threadIdx.x; idx < WR * (ca + cg); idx += NT) {
        const int rr = idx / (ca + cg), c = idx % (ca + cg);
        const bool ok = rr < v;
        const size_t row = (size_t)r + (ok ? rr : 0);
        if (c < ca)
          cp16(As + rr * WLD + 8 * c, A + row * K + i0 + 8 * c, ok);
        else
          cp16(Gs + rr * WLD + 8 * (c - ca), G + row * M + j0 + 8 * (c - ca),
               ok);
      }
    }
    ++fit;
    cp_commit();
  };
#pragma unroll
  for (int f = 0; f < WST - 1; ++f) fetch();
  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      acc[mi][nt][0] = acc[mi][nt][1] = acc[mi][nt][2] = acc[mi][nt][3] = 0.f;
  // the bias: two threads a column, each over half of a stage's rows
  const bool bias = blockIdx.y == 0;
  const int bc = threadIdx.x % WT, bh = threadIdx.x / WT;
  float bs = 0.0f;
  for (int it = 0; it < steps; ++it) {
    cp_wait<WST - 2>();
    __syncthreads();  // stage `it` in; every warp done with stage it - 1
    fetch();
    const bf16* As = ring + it % WST * 2 * WR * WLD;
    const bf16* Gs = As + WR * WLD;
    if (active) {
#pragma unroll
      for (int kk = 0; kk < WR / 16; ++kk) {
        uint32_t a[4][4];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
          ld_at(a[mi], As, WLD, 64 * wi + 16 * mi, 16 * kk);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          uint32_t b[4];
          ld_bt(b, Gs, WLD, 16 * kk, 32 * wj + 16 * p);
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) {
            mma16816(acc[mi][2 * p], a[mi], b[0], b[1]);
            mma16816(acc[mi][2 * p + 1], a[mi], b[2], b[3]);
          }
        }
      }
    }
    if (bias && bc < mw)
      for (int r = bh * (WR / 2); r < (bh + 1) * (WR / 2); ++r)
        bs += __bfloat162float(Gs[r * WLD + bc]);
  }
  cp_wait<0>();  // only empty groups are left
  if (active) {
    const int lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
    float* pw = part_w + (size_t)s * K * M;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = i0 + 64 * wi + 16 * mi + gr + 8 * h;
          const int j = j0 + 32 * wj + 8 * nt + 2 * tq;
          *reinterpret_cast<float2*>(pw + (size_t)i * M + j) =
              make_float2(acc[mi][nt][2 * h], acc[mi][nt][2 * h + 1]);
        }
  }
  if (bias) {  // the halves in order: rows of the first, then the second
    __syncthreads();
    float* BS = reinterpret_cast<float*>(smem);
    if (bh == 1) BS[bc] = bs;
    __syncthreads();
    if (bh == 0 && bc < mw) part_b[(size_t)s * M + j0 + bc] = bs + BS[bc];
  }
}

// rows of one split of a bf16 weight-grad sum over `tiles` output tiles:
// about 256 blocks in all (two an SM on the H100's 132), 64-row multiples
inline int wgrad_tc_split(int rows, int tiles) {
  const int want = (256 + tiles - 1) / tiles;
  const int split = ((rows + want - 1) / want + WR - 1) / WR * WR;
  return split > WR ? split : WR;
}
inline int wgrad_tc_tiles(int K, int M) {
  return ((K + WT - 1) / WT) * ((M + WT - 1) / WT);
}
// splits of the sum dW = A^T G (A rows x K, G rows x M)
inline int wgrad_tc_splits(int rows, int K, int M) {
  const int split = wgrad_tc_split(rows, wgrad_tc_tiles(K, M));
  return (rows + split - 1) / split;
}

// ---------------------------------------------------------------------------
// bf16 MLP and qkv halves: persistent, warp-specialised wgmma kernels on
// dit_layer.cuh's row-kernel machinery (its note has the common design).
// One block an SM, two consumer warpgroups each walking its own 64-row tiles
// (rw_tile's fixed order over tile_of's element-aligned tiles, so each
// tile's dmod partials belong to one element and `part` keeps its layout)
// and a producer warpgroup (setmaxnreg 40 / 232) whose threads fill the
// groups' tiles and the weight slots by TMA into 128-byte-swizzled slabs.
// The activations come through 3-d maps over (B, N, columns): a tile at an
// element's end loads zeros past its last row and stores nothing there.
// The weights are read both ways from one copy: a slab that is MN-major
// for x @ W is K-major for dz @ W^T (wgmma's B may be either), so no
// transposed copy is made.

struct BwdRowArgs {
  const float* mod;  // (B, 6, D) adaLN vectors, f32
  const bf16* b1;    // fc1's bias (MLP half)
  const bf16* b2;    // fc2's bias (MLP half)
  float* dx1;        // (B * N, D) f32: the MLP half's output, the qkv half's input
  float* part;       // (B * tiles, 6, D) per-(element, tile) dmod partials
  int B, N, hidden;
  float eps;
  int items, slots, stages;  // the plan
};

// element b, its first row n0 and live rows of the element-aligned tile t
struct RowTile {
  int b, n0, valid;
};
__device__ __forceinline__ RowTile bwd_tile(int t, int N) {
  const int tpe = (N + 63) / 64, n0 = (t % tpe) * 64;
  return RowTile{t / tpe, n0, min(64, N - n0)};
}

// The MLP half's plan: per 64 columns of hidden an item of w1 (D K rows x
// those columns) and one of w2 (those 64 rows x D columns), each read in
// both passes of a tile; a stage is a group's x1 and dy tiles; fixed, its
// staging tile of two 64 x 64 slabs (h1 and da1 out, the column sums).
constexpr size_t MB_STAGING = 16384;
inline RowPlan plan_mlp_bwd(int D, int hidden, long long optin) {
  return row_plan(D, hidden / 32, (size_t)256 * D, MB_STAGING, 4, optin);
}
// The qkv half's: an item per 64 columns of wqkv (D rows x those columns);
// a stage is a group's x tile and dqkv's 3 D / 64 K slabs of 64 columns.
inline RowPlan plan_qkv_bwd(int D, long long optin) {
  return row_plan(D, 3 * D / 64, (size_t)512 * D, 0, 2, optin);
}
// their dynamic shared memory (LLONG_MAX: no plan fits)
inline size_t smem_mlp_bwd_tc(int D, int hidden) {
  const RowPlan p = plan_mlp_bwd(D, hidden, smem_optin());
  return p.slots ? p.smem : (size_t)LLONG_MAX;
}
inline size_t smem_qkv_bwd_tc(int D) {
  const RowPlan p = plan_qkv_bwd(D, smem_optin());
  return p.slots ? p.smem : (size_t)LLONG_MAX;
}

// tanh-GELU's derivative from the exponential gelu_fast takes (the same
// t = tanh(u) = 2 s - 1, s = 1 / (1 + exp(-2u))): 0.5 (1 + t) = s and
// 1 - t^2 = 4 s (1 - s), so gelu'(v) = s + 2 k v s (1 - s) (1 + 3 c v^2)
__device__ __forceinline__ float gelu_fast_grad(float v) {
  const float k = 0.7978845608028654f, c = 0.044715f;
  const float u = k * (v + c * v * v * v);
  const float s = __fdividef(1.0f, 1.0f + ex2(-2.0f * LOG2E * u));
  return s + 2.0f * k * v * s * (1.0f - s) * (1.0f + 3.0f * c * v * v);
}
// T(g gelu'(T(a1 + T(b1)))) of the thread's pair in row h of an n8 tile
__device__ __forceinline__ uint32_t dgelu_pair(const float (&a)[4],
                                               const float (&gv)[4], int h,
                                               uint32_t bp) {
  float x0, x1;
  round2(a[2 * h] + __uint_as_float(bp << 16),
         a[2 * h + 1] + __uint_as_float(bp & 0xffff0000u), x0, x1);
  return pack_bf16(gv[2 * h] * gelu_fast_grad(x0),
                   gv[2 * h + 1] * gelu_fast_grad(x1));
}
// a 128-byte-swizzle descriptor at base + off, built where its wgmma is
// issued (opaque: with the products of pass 2 and dz2's in flight, the
// descriptors of a whole step held at once spill)
__device__ __forceinline__ uint64_t desc_at(uint32_t base, uint32_t off,
                                            uint32_t lbo) {
  return sw128_desc(opaque(base) + off, lbo);
}
__device__ __forceinline__ float bf_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}
// the sum of v over the 8 lanes of a warp that hold the same columns
__device__ __forceinline__ float col_sum8(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// The LayerNorm VJP of a warpgroup's 64-row tile (both halves' epilogue),
// from dz, the sums of its product in wgmma's accumulator layout (the
// thread's rows 16 warp + lane / 4 (+ 8), columns 8 nt + 2 (lane % 4)
// (+ 1)), and X, the tile's input rows (64-column slabs in the 128-byte
// swizzle). With x̂ = (x - mu) rs, scale = modb[ish + 1], g = dz (1 +
// scale): out(h, nt, v0, v1) gets the pair of base(h, nt) + rs (g -
// mean(g) - x̂ mean(g x̂)) (it may write it over X), and pt[ish * D + c],
// pt[(ish + 1) * D + c] the tile's column sums of dz and dz x̂ over its
// live rows. The statistics of x in f32 over the quad of lanes that holds
// a row (the mean, then the variance of the centred row); the column sums
// by shuffles over the warp's rows, then over the four warps in order
// through cs (8 D floats). Ends past a barrier of the group, after which
// the caller may store X.
template <int D, typename Base, typename Out>
__device__ __forceinline__ void wg_ln_vjp(const float (&dz)[D / 8][4],
                                         const unsigned char* X,
                                         const float* modb, int ish,
                                         int valid, float eps, float* cs,
                                         float* pt, int w, Base&& base,
                                         Out&& out) {
  constexpr int NT8 = D / 8;
  const int wt = threadIdx.x & 127, warp = wt >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;
  auto xp = [&](int h, int nt) {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(
        X + out_at(16 * warp + gr + 8 * h, nt) + 4 * tq);
    return make_float2(bf_lo(u), bf_hi(u));
  };
  float mu[2], rs[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float s = 0.0f;
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt) {
      const float2 p = xp(h, nt);
      s += p.x + p.y;
    }
    mu[h] = quad_sum(s) / D;
    float v = 0.0f;
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt) {
      const float2 p = xp(h, nt);
      v += (p.x - mu[h]) * (p.x - mu[h]) + (p.y - mu[h]) * (p.y - mu[h]);
    }
    rs[h] = rsqrtf(quad_sum(v) / D + eps);
  }
  const float* sc = modb + (size_t)(ish + 1) * D + 2 * tq;
  float* csw = cs + warp * 2 * D + 2 * tq;
  float sg[2] = {0.0f, 0.0f}, sgx[2] = {0.0f, 0.0f};
#pragma unroll
  for (int nt = 0; nt < NT8; ++nt) {
    const float2 s2 = __ldg(reinterpret_cast<const float2*>(sc + 8 * nt));
    float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // dz, dz x̂ of the two columns
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 p = xp(h, nt);
      const float d0 = dz[nt][2 * h], d1 = dz[nt][2 * h + 1];
      const float x0 = (p.x - mu[h]) * rs[h], x1 = (p.y - mu[h]) * rs[h];
      const float g0 = d0 * (1.0f + s2.x), g1 = d1 * (1.0f + s2.y);
      sg[h] += g0 + g1;
      sgx[h] += g0 * x0 + g1 * x1;
      if (16 * warp + gr + 8 * h < valid) {
        c[0] += d0;
        c[1] += d1;
        c[2] += d0 * x0;
        c[3] += d1 * x1;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] = col_sum8(c[e]);
    if (gr == 0) {
      *reinterpret_cast<float2*>(csw + 8 * nt) = make_float2(c[0], c[1]);
      *reinterpret_cast<float2*>(csw + D + 8 * nt) = make_float2(c[2], c[3]);
    }
  }
  float mg[2], mgx[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mg[h] = quad_sum(sg[h]) / D;
    mgx[h] = quad_sum(sgx[h]) / D;
  }
#pragma unroll
  for (int nt = 0; nt < NT8; ++nt) {
    const float2 s2 = __ldg(reinterpret_cast<const float2*>(sc + 8 * nt));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 p = xp(h, nt), b = base(h, nt);
      const float x0 = (p.x - mu[h]) * rs[h], x1 = (p.y - mu[h]) * rs[h];
      const float g0 = dz[nt][2 * h] * (1.0f + s2.x);
      const float g1 = dz[nt][2 * h + 1] * (1.0f + s2.y);
      out(h, nt, b.x + rs[h] * (g0 - mg[h] - x0 * mgx[h]),
          b.y + rs[h] * (g1 - mg[h] - x1 * mgx[h]));
    }
  }
  fence_async_shared();  // out's stores over X, to a TMA store
  bar_sync(1 + w, 128);
  for (int c = wt; c < 2 * D; c += 128)
    pt[(size_t)ish * D + c] =
        ((cs[c] + cs[2 * D + c]) + cs[4 * D + c]) + cs[6 * D + c];
}

// MLP half, per 64-row tile of one element:
//   z2 = T(modLN(x1; mod[3], mod[4])) over the x1 tile, out;
//   pass 1, per 64 columns hc of hidden: a1 = z2 @ w1[:, hc] (32 sums a
//     thread), h1 = T(gelu(T(a1 + T(b1)))) out through the staging slab and
//     packed into register-A fragments of h2 += h1 @ w2[hc] (its sums over
//     all of hidden in registers);
//   h2 = T(h2 + T(b2)); the dgate partial = column sums of dy h2; dh2 =
//     T(T(gate) dy) over the dy tile, out;
//   pass 2, per hc: a1 = z2 @ w1[:, hc] again and g = dh2 @ w2[hc]^T (w2's
//     item read K-major), da1 = T(g gelu'(T(a1 + T(b1)))) out and packed
//     into register-A fragments of dz2 += da1 @ w1[:, hc]^T (w1's item read
//     K-major);
//   x1 and dy come in again over z2 and dh2; the LayerNorm VJP from dz2's
//     registers (wg_ln_vjp): dshift and dscale partials and dx1 = dy +
//     LN-VJP, f32, stored from registers.
// Rounding points as the first kernels' but the GELU and its derivative,
// taken from exp(-2u) on the exponent unit as the forward's gelu_fast does.
// L2 policies: every load (x1 and dy, both times) and every store (z2,
// h1, dh2, da1; dx1 streaming) with evict_first, so the kernel leaves
// nothing of its own in L2 (without them it ran 2.57 ms at the flagship
// call; with x1 and dy first kept by evict_last, 1.79; so, 1.41: PERF.md).
template <int D>
__global__ void __launch_bounds__(RW_NT, 1)
    mlp_bwd_tc_kernel(const BwdRowArgs g,
                      const __grid_constant__ CUtensorMap m_x1,
                      const __grid_constant__ CUtensorMap m_dy,
                      const __grid_constant__ CUtensorMap m_w1,
                      const __grid_constant__ CUtensorMap m_w2,
                      const __grid_constant__ CUtensorMap m_z2,
                      const __grid_constant__ CUtensorMap m_h1,
                      const __grid_constant__ CUtensorMap m_dh2,
                      const __grid_constant__ CUtensorMap m_da1) {
  constexpr int NK = D / 64, TILE = 128 * D;
  extern __shared__ unsigned char rw_raw[];
  __shared__ uint64_t wfull[RW_SLOTS], wempty[RW_SLOTS];
  // a stage's x1 and dy tiles, loaded twice a tile on one barrier pair
  __shared__ uint64_t afull[RW_WG][RW_STAGES], aempty[RW_WG][RW_STAGES];
  unsigned char* wsl = align_atoms(rw_raw);
  unsigned char* acts = wsl + (size_t)g.slots * TILE;
  const size_t group = (size_t)g.stages * 2 * TILE + MB_STAGING;
  const int nh = g.hidden / 64;
  // item k is w1's (k even) or w2's (k odd) of columns k / 2 of hidden;
  // resident, both passes read the same slots; streamed, the ring carries
  // the two passes' 4 nh reads in order
  const WRing wr{wfull, wempty, g.slots >= 2 * nh ? 2 * nh : 4 * nh,
                 g.slots};
  const int tid = threadIdx.x, tiles = g.B * ((g.N + 63) / 64);
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
      // group pw's x1 and dy tiles, twice a tile: at its start, and for the
      // LayerNorm VJP once pass 2 has read z2 and dh2 over them (each
      // load waits for the release before it: completions alternate)
      for (int j = 0; j < iters; ++j) {
        const int t = rw_tile(j, pw);
        if (t >= tiles) break;
        const RowTile rt = bwd_tile(t, g.N);
        const int s = j % g.stages;
        unsigned char* X = acts + pw * group + (size_t)s * 2 * TILE;
        for (int again = 0; again < 2; ++again) {
          if (again || j >= g.stages) mbar_wait(&aempty[pw][s], again ^ 1);
          mbar_expect(&afull[pw][s], 2 * TILE);
#pragma unroll
          for (int kc = 0; kc < NK; ++kc) {
            tma_load3(X + kc * 8192, &m_x1, 64 * kc, rt.n0, rt.b,
                      &afull[pw][s], l2_evict_first());
            tma_load3(X + TILE + kc * 8192, &m_dy, 64 * kc, rt.n0, rt.b,
                      &afull[pw][s], l2_evict_first());
          }
        }
      }
    } else {
      const CUtensorMap *m1 = &m_w1, *m2 = &m_w2;
      wr.produce<TILE>(wsl, iters, [=](unsigned char* dst, int k,
                                       uint64_t* bar) {
        const int q = k % (2 * nh), hc = q >> 1;
        mbar_expect(bar, TILE);
#pragma unroll
        for (int jj = 0; jj < NK; ++jj) {
          if (q & 1)
            tma_load(dst + jj * 8192, m2, 64 * jj, 64 * hc, bar);
          else
            tma_load(dst + jj * 8192, m1, 64 * hc, 64 * jj, bar);
        }
      });
    }
    return;
  }

  regs_inc<RW_CONSUMER_REGS>();
  const int w = tid >> 7, wt = tid & 127, warp = wt >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  unsigned char* grp = acts + w * group;
  unsigned char* C = grp + (size_t)g.stages * 2 * TILE;  // the staging tile
  float* cs = reinterpret_cast<float*>(C);
  const uint32_t wsl_at = sm_addr(wsl);
  auto item = [&](int pass, int k) {
    return wr.resident() ? k : pass * 2 * nh + k;
  };
  auto at = [&](int j, int k) { return wsl_at + wr.slot(j, k) * TILE; };
  // one set of sums over D columns (h2, then dz2) and two over 64 (fc1's
  // in pass 1; a1 and g in pass 2) for every phase: wgmma's sums sit in
  // ranges of registers, and arrays of their own a phase left the
  // allocator too few
  float acc[D / 8][4], ra[8][4], rb[8][4];
  for (int j = 0; j < iters; ++j) {
    const int t = rw_tile(j, w);
    if (t >= tiles) {
      wr.drain(j);
      continue;
    }
    const RowTile rt = bwd_tile(t, g.N);
    const int s = j % g.stages, valid = rt.valid;
    unsigned char* X = grp + (size_t)s * 2 * TILE;
    unsigned char* Y = X + TILE;
    const uint32_t xa = sm_addr(X), ya = sm_addr(Y);
    const float* modb = g.mod + (size_t)rt.b * 6 * D;
    float* pt = g.part + (size_t)t * 6 * D;
    // chunk hc of h1 or da1 out of its staging slab; the store before it
    // (the other slab's) must have read its slab before anyone writes it
    auto stage_out = [&](const CUtensorMap* m, int hc) {
      fence_async_shared();
      if (wt == 0) bulk_wait<0, true>();
      bar_sync(1 + w, 128);
      if (wt == 0) {
        tma_store3(m, C + (hc & 1) * 8192, 64 * hc, rt.n0, rt.b,
                   l2_evict_first());
        bulk_commit();
      }
    };

    mbar_wait(&afull[w][s], 0);
    wg_modln_rows<64, 128, D / 16>(X, X, valid, D, g.eps, 3, 4, wt,
                                   [&](int) { return modb; });
    fence_async_shared();  // z2, to wgmma and the store
    bar_sync(1 + w, 128);
    if (wt == 0) {
#pragma unroll
      for (int kc = 0; kc < NK; ++kc)
        tma_store3(&m_z2, X + kc * 8192, 64 * kc, rt.n0, rt.b,
                   l2_evict_first());
      bulk_commit();
    }

    // pass 1 (as proj_mlp_tc_kernel's MLP: fc1 of chunk hc + 1 runs under
    // chunk hc's GELU, the one wait after fc2 drains both)
    float (&acc2)[D / 8][4] = acc;
    {
      float (&a1a)[8][4] = ra;
      float (&a1b)[8][4] = rb;
      auto fc1 = [&](float (&a1)[8][4], int hc) {
        const int k = item(0, 2 * hc);
        wr.wait(j, k);
        const uint32_t wa = at(j, k);
        wg_fence();
#pragma unroll
        for (int s16 = 0; s16 < D / 16; ++s16)
          WgSS<64>::run(a1,
                        desc_at(xa, (s16 >> 2) * 8192 + 32 * (s16 & 3), 16),
                        desc_at(wa, 2048 * s16, 8192), s16 > 0);
        wg_commit();
      };
      auto fc2 = [&](const float (&a1)[8][4], int hc) {
        unsigned char* cb = C + (hc & 1) * 8192;
        uint32_t hf[4][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const uint32_t bp = ld_pair(g.b1 + 64 * hc + 8 * nt + 2 * tq);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t v = gelu_pair(a1[nt], h, bp);
            hf[nt >> 1][(nt & 1) * 2 + h] = v;
            *reinterpret_cast<uint32_t*>(
                cb + out_at(16 * warp + gr + 8 * h, nt) + 4 * tq) = v;
          }
        }
        const int k = item(0, 2 * hc + 1);
        wr.wait(j, k);
        const uint32_t wa = at(j, k);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          WgMma<D>::template run<1>(acc2, hf[kk],
                                    desc_at(wa, 2048 * kk, 8192),
                                    hc > 0 || kk > 0);
        wg_commit();
        stage_out(&m_h1, hc);
      };
      auto step = [&](const float (&cur)[8][4], float (&nxt)[8][4], int hc) {
        fc1(nxt, hc + 1);
        fc2(cur, hc);
        wg_wait<0>();
        fence_regs(nxt);
        wr.release(j, item(0, 2 * hc + 2));
        wr.release(j, item(0, 2 * hc + 1));
      };
      auto last = [&](const float (&cur)[8][4], int hc) {
        fc2(cur, hc);
        wg_wait<0>();
        wr.release(j, item(0, 2 * hc + 1));
      };
      fc1(a1a, 0);
      wg_wait<0>();
      fence_regs(a1a);
      wr.release(j, item(0, 0));
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
      fence_regs(acc2);
    }

    // h2, the dgate partial (through cs, once the last h1 store has read
    // the staging tile) and dh2 over dy
    if (wt == 0) bulk_wait<0, true>();
    bar_sync(1 + w, 128);
    {
      float* csw = cs + warp * D + 2 * tq;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        const uint32_t bp = ld_pair(g.b2 + 8 * nt + 2 * tq);
        const uint32_t gp = gate_pair(modb + 5 * D + 8 * nt + 2 * tq);
        float c0 = 0.0f, c1 = 0.0f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 16 * warp + gr + 8 * h;
          uint32_t* yp =
              reinterpret_cast<uint32_t*>(Y + out_at(i, nt) + 4 * tq);
          const uint32_t dv = *yp;
          float h0, h1;
          round2(acc2[nt][2 * h] + bf_lo(bp), acc2[nt][2 * h + 1] + bf_hi(bp),
                 h0, h1);
          if (i < valid) {
            c0 += bf_lo(dv) * h0;
            c1 += bf_hi(dv) * h1;
          }
          *yp = pack_bf16(bf_lo(gp) * bf_lo(dv), bf_hi(gp) * bf_hi(dv));
        }
        c0 = col_sum8(c0);
        c1 = col_sum8(c1);
        if (gr == 0)
          *reinterpret_cast<float2*>(csw + 8 * nt) = make_float2(c0, c1);
      }
      fence_async_shared();  // dh2, to wgmma and the store
      bar_sync(1 + w, 128);
      if (wt == 0) {
#pragma unroll
        for (int kc = 0; kc < NK; ++kc)
          tma_store3(&m_dh2, Y + kc * 8192, 64 * kc, rt.n0, rt.b,
                     l2_evict_first());
        bulk_commit();
      }
      for (int c = wt; c < D; c += 128)
        pt[5 * D + c] = ((cs[c] + cs[D + c]) + cs[2 * D + c]) + cs[3 * D + c];
      bar_sync(1 + w, 128);  // cs read, before da1's staging
    }

    // pass 2: chunk hc's two products, then its da1 and dz2's product
    // under chunk hc + 1's two
    float (&dz)[D / 8][4] = acc;
    {
      float (&a1)[8][4] = ra;
      float (&gg)[8][4] = rb;
      auto rg = [&](int hc) {
        const int k1 = item(1, 2 * hc), k2 = item(1, 2 * hc + 1);
        wr.wait(j, k1);
        wr.wait(j, k2);
        const uint32_t w1a = at(j, k1), w2a = at(j, k2);
        wg_fence();
#pragma unroll
        for (int s16 = 0; s16 < D / 16; ++s16)
          WgSS<64>::run(a1,
                        desc_at(xa, (s16 >> 2) * 8192 + 32 * (s16 & 3), 16),
                        desc_at(w1a, 2048 * s16, 8192), s16 > 0);
#pragma unroll
        for (int s16 = 0; s16 < D / 16; ++s16) {
          const uint32_t ko = (s16 >> 2) * 8192 + 32 * (s16 & 3);
          WgSS<64>::run<0>(gg, desc_at(ya, ko, 16), desc_at(w2a, ko, 16),
                           s16 > 0);
        }
        wg_commit();
      };
      auto dzp = [&](int hc) {
        unsigned char* cb = C + (hc & 1) * 8192;
        uint32_t df[4][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const uint32_t bp = ld_pair(g.b1 + 64 * hc + 8 * nt + 2 * tq);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t v = dgelu_pair(a1[nt], gg[nt], h, bp);
            df[nt >> 1][(nt & 1) * 2 + h] = v;
            *reinterpret_cast<uint32_t*>(
                cb + out_at(16 * warp + gr + 8 * h, nt) + 4 * tq) = v;
          }
        }
        const uint32_t wa = at(j, item(1, 2 * hc));
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          WgMma<D>::template run<0>(dz, df[kk], desc_at(wa, 32 * kk, 16),
                                    hc > 0 || kk > 0);
        wg_commit();
      };
      rg(0);
      wg_wait<0>();
      fence_regs(a1);
      fence_regs(gg);
      wr.release(j, item(1, 1));
      for (int hc = 0; hc + 1 < nh; ++hc) {
        dzp(hc);
        rg(hc + 1);
        stage_out(&m_da1, hc);
        wg_wait<0>();
        fence_regs(a1);
        fence_regs(gg);
        fence_regs(dz);
        wr.release(j, item(1, 2 * hc));
        wr.release(j, item(1, 2 * hc + 3));
      }
      // z2 and dh2 have had their last readers (the stores of both have
      // read them: every store but the last da1 chunk's), so x1 and dy may
      // come in again over them under the last chunk
      if (wt == 0) {
        if (nh > 1)
          bulk_wait<1, true>();
        else
          bulk_wait<0, true>();
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&aempty[w][s]);
      dzp(nh - 1);
      stage_out(&m_da1, nh - 1);
      wg_wait<0>();
      fence_regs(dz);
      wr.release(j, item(1, 2 * nh - 2));
    }

    // the LayerNorm VJP: cs once the last da1 store has read the staging
    // tile, x1 and dy once in again; dx1 (f32) stored from registers,
    // streaming (the attention output's kernel reads it back from memory)
    if (wt == 0) bulk_wait<0, true>();
    mbar_wait(&afull[w][s], 1);
    bar_sync(1 + w, 128);
    float* dst = g.dx1 + ((size_t)rt.b * g.N + rt.n0) * D + 2 * tq;
    wg_ln_vjp<D>(
        dz, X, modb, 3, valid, g.eps, cs, pt, w,
        [&](int h, int nt) {
          const uint32_t u = *reinterpret_cast<const uint32_t*>(
              Y + out_at(16 * warp + gr + 8 * h, nt) + 4 * tq);
          return make_float2(bf_lo(u), bf_hi(u));
        },
        [&](int h, int nt, float v0, float v1) {
          const int i = 16 * warp + gr + 8 * h;
          if (i < valid)
            __stcs(reinterpret_cast<float2*>(dst + (size_t)i * D + 8 * nt),
                   make_float2(v0, v1));
        });
    __syncwarp();
    if (lane == 0) mbar_arrive(&aempty[w][s]);  // x1 and dy read
  }
  if (wt == 0) bulk_wait<0, false>();
}

// qkv half, per 64-row tile of one element: dz1 = dqkv @ wqkv^T (f32; each
// of dqkv's 64-column K slabs on its own barrier, wqkv's item read
// K-major), dx1 loaded into registers under the products, then the
// LayerNorm VJP from dz1's registers (wg_ln_vjp): the dshift_a and
// dscale_a partials and dx = T(dx1 + LN-VJP) over the x tile, out. The
// stage's last dqkv slab holds the column sums; it and the x tile go back
// to the producer once dx's store has read the tile, the other slabs once
// the products have read them.
template <int D>
__global__ void __launch_bounds__(RW_NT, 1)
    qkv_bwd_tc_kernel(const BwdRowArgs g,
                      const __grid_constant__ CUtensorMap m_dq,
                      const __grid_constant__ CUtensorMap m_x,
                      const __grid_constant__ CUtensorMap m_w,
                      const __grid_constant__ CUtensorMap m_dx) {
  constexpr int NK = D / 64, NS = 3 * NK, TILE = 128 * D;
  constexpr int STAGE = NS * 8192 + TILE;  // the dqkv slabs, then x
  extern __shared__ unsigned char rw_raw[];
  __shared__ uint64_t wfull[RW_SLOTS], wempty[RW_SLOTS];
  __shared__ uint64_t sfull[RW_WG][RW_STAGES][NS + 1];
  __shared__ uint64_t pempty[RW_WG][RW_STAGES], tempty[RW_WG][RW_STAGES];
  unsigned char* wsl = align_atoms(rw_raw);
  unsigned char* acts = wsl + (size_t)g.slots * TILE;
  const size_t group = (size_t)g.stages * STAGE;
  const WRing wr{wfull, wempty, g.items, g.slots};
  const int tid = threadIdx.x, tiles = g.B * ((g.N + 63) / 64);
  const int iters = rw_iters(tiles);
  if (tid == 0) {
    for (int i = 0; i < g.slots; ++i) {
      mbar_init(&wfull[i], 1);
      mbar_init(&wempty[i], RW_NC / 32);
    }
    for (int w = 0; w < RW_WG; ++w)
      for (int s = 0; s < g.stages; ++s) {
        for (int k = 0; k <= NS; ++k) mbar_init(&sfull[w][s][k], 1);
        mbar_init(&pempty[w][s], 4);
        mbar_init(&tempty[w][s], 1);
      }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= RW_NC) {
    regs_dec<RW_PRODUCER_REGS>();
    const int pw = (tid - RW_NC) >> 5;
    if ((tid & 31) != 0 || pw > RW_WG) return;
    if (pw < RW_WG) {
      for (int j = 0; j < iters; ++j) {
        const int t = rw_tile(j, pw);
        if (t >= tiles) break;
        const RowTile rt = bwd_tile(t, g.N);
        const int s = j % g.stages, u = j / g.stages;
        unsigned char* S0 = acts + pw * group + (size_t)s * STAGE;
        uint64_t* f = sfull[pw][s];
        if (u > 0) mbar_wait(&pempty[pw][s], (u - 1) & 1);
        for (int k = 0; k < NS - 1; ++k) {
          mbar_expect(&f[k], 8192);
          tma_load3(S0 + k * 8192, &m_dq, 64 * k, rt.n0, rt.b, &f[k]);
        }
        if (u > 0) mbar_wait(&tempty[pw][s], (u - 1) & 1);
        mbar_expect(&f[NS - 1], 8192);
        tma_load3(S0 + (NS - 1) * 8192, &m_dq, 64 * (NS - 1), rt.n0, rt.b,
                  &f[NS - 1]);
        mbar_expect(&f[NS], TILE);
#pragma unroll
        for (int kc = 0; kc < NK; ++kc)
          tma_load3(S0 + NS * 8192 + kc * 8192, &m_x, 64 * kc, rt.n0, rt.b,
                    &f[NS]);
      }
    } else {
      // item k: wqkv's columns 64 k.. over its D rows, D / 64 slabs
      const CUtensorMap* mw = &m_w;
      wr.produce<TILE>(wsl, iters, [=](unsigned char* dst, int k,
                                       uint64_t* bar) {
        mbar_expect(bar, TILE);
#pragma unroll
        for (int dd = 0; dd < NK; ++dd)
          tma_load(dst + dd * 8192, mw, 64 * k, 64 * dd, bar);
      });
    }
    return;
  }

  regs_inc<RW_CONSUMER_REGS>();
  const int w = tid >> 7, wt = tid & 127, warp = wt >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  unsigned char* grp = acts + w * group;
  const uint32_t wsl_at = sm_addr(wsl);
  for (int j = 0; j < iters; ++j) {
    const int t = rw_tile(j, w);
    if (t >= tiles) {
      wr.drain(j);
      continue;
    }
    const RowTile rt = bwd_tile(t, g.N);
    const int s = j % g.stages, ph = (j / g.stages) & 1, valid = rt.valid;
    unsigned char* S0 = grp + (size_t)s * STAGE;
    unsigned char* X = S0 + NS * 8192;
    const uint32_t sa = sm_addr(S0);
    float dz[D / 8][4];
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      mbar_wait(&sfull[w][s][k], ph);
      wr.wait(j, k);
      const uint32_t wa = wsl_at + wr.slot(j, k) * TILE;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgSS<D>::template run<0>(dz, sw128_desc(sa + k * 8192 + 32 * kk, 16),
                                 sw128_desc(wa + 32 * kk, 16),
                                 k > 0 || kk > 0);
      wg_commit();
    }
    float2 dxr[2][D / 8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 16 * warp + gr + 8 * h;
      const float* src =
          g.dx1 + ((size_t)rt.b * g.N + rt.n0 + i) * D + 2 * tq;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
        dxr[h][nt] = i < valid
                         ? __ldg(reinterpret_cast<const float2*>(src + 8 * nt))
                         : make_float2(0.0f, 0.0f);
    }
    wg_wait<0>();
    fence_regs(dz);
#pragma unroll
    for (int k = 0; k < NS; ++k) wr.release(j, k);
    __syncwarp();
    if (lane == 0) mbar_arrive(&pempty[w][s]);
    mbar_wait(&sfull[w][s][NS], ph);
    wg_ln_vjp<D>(
        dz, X, g.mod + (size_t)rt.b * 6 * D, 0, valid, g.eps,
        reinterpret_cast<float*>(S0 + (NS - 1) * 8192),
        g.part + (size_t)t * 6 * D, w,
        [&](int h, int nt) { return dxr[h][nt]; },
        [&](int h, int nt, float v0, float v1) {
          *reinterpret_cast<uint32_t*>(
              X + out_at(16 * warp + gr + 8 * h, nt) + 4 * tq) =
              pack_bf16(v0, v1);
        });
    if (wt == 0) {
#pragma unroll
      for (int kc = 0; kc < NK; ++kc)
        tma_store3(&m_dx, X + kc * 8192, 64 * kc, rt.n0, rt.b);
      bulk_commit();
    }
    bar_sync(1 + w, 128);  // every column sum read
    if (wt == 0) {
      bulk_wait<0, true>();
      mbar_arrive(&tempty[w][s]);
    }
  }
  if (wt == 0) bulk_wait<0, false>();
}

// blocks of a persistent row kernel over B * ceil(N / 64) tiles
inline int bwd_row_grid(int B, int N, int sms) {
  const long long tiles = (long long)B * ((N + 63) / 64);
  const long long blocks = (tiles + RW_WG - 1) / RW_WG;
  return blocks < sms ? (int)blocks : sms;
}

template <int D>
cudaError_t launch_mlp_bwd_tc(const bf16* x1, const float* mod,
                              const bf16* w1, const bf16* b1, const bf16* w2,
                              const bf16* b2, const bf16* dy, float* dx1,
                              bf16* z2, bf16* h1, bf16* dh2, bf16* da1,
                              float* part, int B, int N, int hidden,
                              float eps, cudaStream_t st) {
  const long long optin = smem_optin();
  if (optin < 0) return (cudaError_t)-optin;
  const RowPlan p = plan_mlp_bwd(D, hidden, optin);
  const int sms = rw_sms();
  if (!p.slots || sms <= 0) return cudaErrorInvalidValue;
  cudaError_t e = set_smem((const void*)mlp_bwd_tc_kernel<D>, p.smem);
  if (e) return e;
  CUtensorMap mx, mdy, mw1, mw2, mz, mh, mdh, mda;
  if (!make_tmap3(&mx, x1, B, N, D) || !make_tmap3(&mdy, dy, B, N, D) ||
      !make_tmap(&mw1, w1, D, hidden, 64) ||
      !make_tmap(&mw2, w2, hidden, D, 64) ||
      !make_tmap3(&mz, z2, B, N, D) || !make_tmap3(&mh, h1, B, N, hidden) ||
      !make_tmap3(&mdh, dh2, B, N, D) || !make_tmap3(&mda, da1, B, N, hidden))
    return cudaErrorInvalidValue;
  const BwdRowArgs g{mod,  b1,    b2,      dx1,     part,    B,
                     N,    hidden, eps,    p.items, p.slots, p.stages};
  mlp_bwd_tc_kernel<D><<<bwd_row_grid(B, N, sms), RW_NT, p.smem, st>>>(
      g, mx, mdy, mw1, mw2, mz, mh, mdh, mda);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_qkv_bwd_tc(const bf16* x, const float* mod,
                              const bf16* wqkv, const bf16* dqkv,
                              const float* dx1, bf16* dx, float* part, int B,
                              int N, float eps, cudaStream_t st) {
  const long long optin = smem_optin();
  if (optin < 0) return (cudaError_t)-optin;
  const RowPlan p = plan_qkv_bwd(D, optin);
  const int sms = rw_sms();
  if (!p.slots || sms <= 0) return cudaErrorInvalidValue;
  cudaError_t e = set_smem((const void*)qkv_bwd_tc_kernel<D>, p.smem);
  if (e) return e;
  CUtensorMap mdq, mx, mw, mdx;
  if (!make_tmap3(&mdq, dqkv, B, N, 3 * D) || !make_tmap3(&mx, x, B, N, D) ||
      !make_tmap(&mw, wqkv, D, 3 * D, 64) || !make_tmap3(&mdx, dx, B, N, D))
    return cudaErrorInvalidValue;
  const BwdRowArgs g{mod,  nullptr, nullptr, const_cast<float*>(dx1),
                     part, B,       N,       0,
                     eps,  p.items, p.slots, p.stages};
  qkv_bwd_tc_kernel<D><<<bwd_row_grid(B, N, sms), RW_NT, p.smem, st>>>(
      g, mdq, mx, mw, mdx);
  return cudaGetLastError();
}

// the widths with instances of the two kernels above (check_bwd takes D up
// to GC = 128 in bf16)
inline cudaError_t launch_mlp_bwd(const bf16* x1, const float* mod,
                                  const bf16* w1, const bf16* b1,
                                  const bf16* w2, const bf16* b2,
                                  const bf16* dy, float* dx1, bf16* z2,
                                  bf16* h1, bf16* dh2, bf16* da1, float* part,
                                  int B, int N, int D, int hidden, float eps,
                                  cudaStream_t st) {
  if (D == 64)
    return launch_mlp_bwd_tc<64>(x1, mod, w1, b1, w2, b2, dy, dx1, z2, h1,
                                 dh2, da1, part, B, N, hidden, eps, st);
  if (D == 128)
    return launch_mlp_bwd_tc<128>(x1, mod, w1, b1, w2, b2, dy, dx1, z2, h1,
                                  dh2, da1, part, B, N, hidden, eps, st);
  return cudaErrorInvalidValue;
}
inline cudaError_t launch_qkv_bwd(const bf16* x, const float* mod,
                                  const bf16* wqkv, const bf16* dqkv,
                                  const float* dx1, bf16* dx, float* part,
                                  int B, int N, int D, float eps,
                                  cudaStream_t st) {
  if (D == 64)
    return launch_qkv_bwd_tc<64>(x, mod, wqkv, dqkv, dx1, dx, part, B, N, eps,
                                 st);
  if (D == 128)
    return launch_qkv_bwd_tc<128>(x, mod, wqkv, dqkv, dx1, dx, part, B, N,
                                  eps, st);
  return cudaErrorInvalidValue;
}

// wproj^T, which the out-projection kernel multiplies by, made once a call:
// dst (cols x rows) = src (rows x cols)^T
__global__ void transpose_kernel(const bf16* __restrict__ src,
                                 bf16* __restrict__ dst, int rows, int cols) {
  const int n = rows * cols;
  for (int idx = blockIdx.x * NT + threadIdx.x; idx < n;
       idx += gridDim.x * NT) {
    const int r = idx / cols, c = idx % cols;
    dst[(size_t)c * rows + r] = src[idx];
  }
}

// The attention VJP of the block (the BLOCK recipe of heads_bwd.cuh): q, k
// and v read in place from qkv (row stride 3D), g = do (B, N, D), the rows'
// m, 1/r, delta from st; dq, dk, dv into the column slices of dqkv
inline cudaError_t launch_block_attn_bwd(const bf16* qkv, const bf16* dO,
                                         const float* st, bf16* dqkv, int B,
                                         int N, int D, int H, float qscale,
                                         cudaStream_t s) {
  BwdArgs<bf16> a{};
  const long long sb = (long long)N * 3 * D, sn = 3 * D;
  a.q = {qkv, sb, sn};
  a.k = {qkv + D, sb, sn};
  a.v = {qkv + 2 * D, sb, sn};
  a.g = {dO, (long long)N * D, D};
  a.dq = dqkv;
  a.dk = dqkv + D;
  a.dv = dqkv + 2 * D;
  a.st = const_cast<float*>(st);
  a.B = B;
  a.N = N;
  a.HD = D;
  a.H = H;
  a.scale = a.qscale = qscale;
  a.ldo = 3 * D;
  switch (D / H) {
    case 16: return launch_bwd_bf16<16, BLOCK>(a, s);
    case 32: return launch_bwd_bf16<32, BLOCK>(a, s);
    case 64: return launch_bwd_bf16<64, BLOCK>(a, s);
    default: return launch_bwd_bf16<128, BLOCK>(a, s);
  }
}

// whether the bf16 kernels above take the attention VJP's grid
inline bool block_attn_grid_ok(int B, int N, int H) {
  return bwd_blocks(B, N, H) <= INT_MAX;
}

// check_shape (the forward kernels) plus the backward kernels' shared memory:
// in bf16 those of the tensor-core route (a head width heads_bwd.cuh takes,
// D within one GEMM chunk of the out-projection's tile_gemm, where the MLP
// and qkv halves have instances, a plan for each, and the recompute's
// kernels), in f32 the FMA-loop kernels'
template <typename T> int check_bwd(int D, int hidden, int H) {
  const int ok = check_shape<T>(D, hidden, H);
  if (ok) return ok;
  const long long optin = smem_optin();
  if (optin < 0) return (int)-optin;
  if constexpr (sizeof(T) == 2) {
    if (D > GC || !tc_head_width(D / H)) return T2MS_UNSUPPORTED_SHAPE;
    const int DH = D / H;
    const size_t need[] = {smem_mlp_bwd_tc(D, hidden), smem_attn_out_tc(D),
                           smem_qkv_bwd_tc(D), SMEM_WGRAD_TC, smem_bwd_q(DH),
                           smem_bwd_kv(DH, BLOCK), smem_qkv_tc(D),
                           smem_mlp_tc(D, hidden, true), smem_fwd(DH)};
    for (size_t n : need)
      if (n > (size_t)optin) return T2MS_UNSUPPORTED_SHAPE;
  } else {
    const size_t need[] = {smem_mlp_bwd<T>(D, hidden), smem_attn_out_bwd<T>(D),
                           smem_attn_dq<T>(D, H), smem_attn_dkdv<T>(D, H),
                           smem_qkv_bwd<T>(D), smem_wgrad<T>()};
    for (size_t n : need)
      if (n > (size_t)optin) return T2MS_UNSUPPORTED_SHAPE;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Workspace: the intermediates above, carved in one order by both the size
// query and the launch.

template <typename T> struct Work {
  T *qkv, *z1, *o, *proj, *x1, *z2, *h1, *dh2, *da1, *dpo, *dO, *dqkv;
  float *mst, *rst, *delta, *st, *dx1, *part, *pw, *pb;
  T* wprojt;  // bf16: wproj^T
};

// rows of one f32 weight-grad split, and the number of splits (grid.z <=
// 65535)
inline int wgrad_split_rows(int rows) {
  const int min_rows = (rows + 65534) / 65535;
  return WG_ROWS > min_rows ? WG_ROWS : min_rows;
}

template <typename T>
size_t carve(unsigned char* base, int B, int N, int D, int hidden, int H,
             Work<T>* w) {
  const size_t rows = (size_t)B * N;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    unsigned char* p = base ? base + off : nullptr;
    off += (bytes + 255) / 256 * 256;
    return p;
  };
  auto t = [&](size_t n) { return reinterpret_cast<T*>(take(n * sizeof(T))); };
  auto f = [&](size_t n) { return reinterpret_cast<float*>(take(n * 4)); };
  const int tiles = (N + tb<T>() - 1) / tb<T>();
  w->qkv = t(rows * 3 * D);
  w->z1 = t(rows * D);
  w->o = t(rows * D);
  w->proj = t(rows * D);
  w->x1 = t(rows * D);
  w->z2 = t(rows * D);
  w->h1 = t(rows * hidden);
  w->dh2 = t(rows * D);
  w->da1 = t(rows * hidden);
  w->dpo = t(rows * D);
  w->dO = t(rows * D);
  w->dqkv = t(rows * 3 * D);
  w->mst = f(rows * H);
  w->rst = f(rows * H);
  w->dx1 = f(rows * D);
  w->part = f((size_t)B * tiles * 6 * D);
  size_t pw = 0, pb = 0;  // the largest split partials of dW and db
  if constexpr (sizeof(T) == 2) {
    // the four weight grads' (A columns K, G columns M)
    const int km[4][2] = {{D, 3 * D}, {D, D}, {D, hidden}, {hidden, D}};
    for (const auto& s : km) {
      const size_t S = wgrad_tc_splits((int)rows, s[0], s[1]);
      pw = S * s[0] * s[1] > pw ? S * s[0] * s[1] : pw;
      pb = S * s[1] > pb ? S * s[1] : pb;
    }
    w->st = f(rows * H * 3);
    w->delta = nullptr;
    w->wprojt = t((size_t)D * D);
  } else {
    const int split = wgrad_split_rows((int)rows);
    const size_t S = (rows + split - 1) / split;
    const int wmax = 3 * D > hidden ? 3 * D : hidden;
    pw = S * D * wmax;
    pb = S * wmax;
    w->st = nullptr;
    w->delta = f(rows * H);
    w->wprojt = nullptr;
  }
  w->pw = f(pw);
  w->pb = f(pb);
  return off;
}

inline void sum_splits(const float* pw, const float* pb, int S, int K, int M,
                       float* dw, float* db, cudaStream_t st) {
  const size_t n = (size_t)K * M;
  sum_splits_kernel<<<(unsigned)((n + NT - 1) / NT), NT, 0, st>>>(pw, S, n,
                                                                  dw);
  sum_splits_kernel<<<(M + NT - 1) / NT, NT, 0, st>>>(pb, S, M, db);
}

template <typename T>
void weight_grad(const T* A, int K, const T* G, int M, int rows, float* pw,
                 float* pb, float* dw, float* db, cudaStream_t st) {
  if constexpr (sizeof(T) == 2) {
    const int split = wgrad_tc_split(rows, wgrad_tc_tiles(K, M));
    const int S = (rows + split - 1) / split;
    wgrad_tc_kernel<<<dim3((M + WT - 1) / WT, (K + WT - 1) / WT, S), NT,
                      SMEM_WGRAD_TC, st>>>(A, K, G, M, rows, split, pw, pb);
    sum_splits(pw, pb, S, K, M, dw, db, st);
  } else {
    const int split = wgrad_split_rows(rows);
    const int S = (rows + split - 1) / split;
    wgrad_kernel<T><<<dim3(M / CW, K / CW, S), NT, smem_wgrad<T>(), st>>>(
        A, K, G, M, rows, split, pw, pb);
    sum_splits(pw, pb, S, K, M, dw, db, st);
  }
}

// bf16: the recompute on dit_layer.cuh's kernels, then the kernels above
inline cudaError_t run_backward_tc(
    const bf16* x, const float* mod, const bf16* wqkv, const bf16* bqkv,
    const bf16* wproj, const bf16* bproj, const bf16* wfc1, const bf16* bfc1,
    const bf16* wfc2, const bf16* bfc2, const bf16* dy, bf16* dx,
    const Work<bf16>& w, int B, int N, int D, int hidden, int H, float eps,
    float qscale, cudaStream_t st) {
  const size_t s_out = smem_attn_out_tc(D);
  cudaError_t e;
  if ((e = set_smem((const void*)attn_out_bwd_tc_kernel, s_out)) ||
      (e = set_smem((const void*)wgrad_tc_kernel, SMEM_WGRAD_TC)))
    return e;
  const dim3 g_tiles(B * ((N + RT - 1) / RT));
  transpose_kernel<<<64, NT, 0, st>>>(wproj, w.wprojt, D, D);
  // recompute the forward's intermediates
  if ((e = run_layer_tc(x, mod, wqkv, bqkv, wproj, bproj, nullptr, nullptr,
                        nullptr, nullptr, w.qkv, w.o, nullptr, B, N, D,
                        hidden, H, 1, 0, eps, qscale, st, w.z1, w.mst, w.rst,
                        w.proj, w.x1)) != cudaSuccess)
    return e;
  // activation grads, back to front
  if ((e = launch_mlp_bwd(w.x1, mod, wfc1, bfc1, wfc2, bfc2, dy, w.dx1, w.z2,
                          w.h1, w.dh2, w.da1, w.part, B, N, D, hidden, eps,
                          st)) != cudaSuccess)
    return e;
  attn_out_bwd_tc_kernel<<<g_tiles, NT, s_out, st>>>(
      w.dx1, w.proj, w.o, mod, w.wprojt, w.mst, w.rst, w.dpo, w.dO, w.st,
      w.part, N, D, H);
  if ((e = cudaGetLastError()) != cudaSuccess ||
      (e = launch_block_attn_bwd(w.qkv, w.dO, w.st, w.dqkv, B, N, D, H,
                                 qscale, st)) != cudaSuccess)
    return e;
  return launch_qkv_bwd(x, mod, wqkv, w.dqkv, w.dx1, dx, w.part, B, N, D,
                        eps, st);
}

template <typename T>
int run_backward(const T* x, const float* mod, const T* wqkv, const T* bqkv,
                 const T* wproj, const T* bproj, const T* wfc1,
                 const T* bfc1, const T* wfc2, const T* bfc2, const T* dy,
                 T* dx, float* dmod, float* dwqkv, float* dbqkv,
                 float* dwproj, float* dbproj, float* dwfc1, float* dbfc1,
                 float* dwfc2, float* dbfc2, void* work, int B, int N, int D,
                 int hidden, int H, float eps, float qscale,
                 cudaStream_t st) {
  if (B < 1 || N < 1 || (long long)B * N > INT_MAX)
    return T2MS_UNSUPPORTED_SHAPE;
  const int ok = check_bwd<T>(D, hidden, H);
  if (ok) return ok;
  Work<T> w;
  carve<T>(static_cast<unsigned char*>(work), B, N, D, hidden, H, &w);
  const int rows = B * N;
  const int tiles = (N + tb<T>() - 1) / tb<T>();
  cudaError_t e;
  if constexpr (sizeof(T) == 2) {
    // the recompute's route and the attention VJP's grid (int blocks)
    if (!tc_route(B, N, D, hidden, H) || !block_attn_grid_ok(B, N, H))
      return T2MS_UNSUPPORTED_SHAPE;
    if ((e = run_backward_tc(x, mod, wqkv, bqkv, wproj, bproj, wfc1, bfc1,
                             wfc2, bfc2, dy, dx, w, B, N, D, hidden, H, eps,
                             qscale, st)) != cudaSuccess)
      return e;
  } else {
    const size_t s_qkv = smem_qkv<T>(D), s_attn = smem_attn<T>(D, H);
    const size_t s_mlpb = smem_mlp_bwd<T>(D, hidden);
    const size_t s_outb = smem_attn_out_bwd<T>(D);
    const size_t s_dq = smem_attn_dq<T>(D, H), s_dkdv = smem_attn_dkdv<T>(D, H);
    const size_t s_qkvb = smem_qkv_bwd<T>(D);
    if ((e = set_smem((const void*)modln_qkv_kernel<T>, s_qkv)) ||
        (e = set_smem((const void*)attn_proj_kernel<T>, s_attn)) ||
        (e = set_smem((const void*)mlp_bwd_kernel<T>, s_mlpb)) ||
        (e = set_smem((const void*)attn_out_bwd_kernel<T>, s_outb)) ||
        (e = set_smem((const void*)attn_dq_kernel<T>, s_dq)) ||
        (e = set_smem((const void*)attn_dkdv_kernel<T>, s_dkdv)) ||
        (e = set_smem((const void*)qkv_bwd_kernel<T>, s_qkvb)) ||
        (e = set_smem((const void*)wgrad_kernel<T>, smem_wgrad<T>())))
      return e;
    const dim3 g_rows((rows + RT - 1) / RT), g_attn(B * ((N + QT - 1) / QT));
    const dim3 g_tiles(B * tiles);
    // recompute the forward's intermediates
    modln_qkv_kernel<T><<<g_rows, NT, s_qkv, st>>>(
        x, mod, wqkv, bqkv, w.qkv, w.z1, rows, N, D, 1, 0, eps);
    attn_proj_kernel<T><<<g_attn, NT, s_attn, st>>>(
        w.qkv, x, mod, wproj, bproj, w.x1, N, D, H, 1, 0, qscale, w.o, w.mst,
        w.rst, w.proj);
    // activation grads, back to front
    mlp_bwd_kernel<T><<<g_tiles, NT, s_mlpb, st>>>(
        w.x1, mod, wfc1, bfc1, wfc2, bfc2, dy, w.dx1, w.z2, w.h1, w.dh2,
        w.da1, w.part, N, D, hidden, eps);
    attn_out_bwd_kernel<T><<<g_tiles, NT, s_outb, st>>>(
        w.dx1, w.proj, w.o, mod, wproj, w.dpo, w.dO, w.delta, w.part, N, D,
        H);
    attn_dq_kernel<T><<<g_tiles, NT, s_dq, st>>>(w.qkv, w.dO, w.mst, w.rst,
                                                 w.delta, w.dqkv, N, D, H,
                                                 qscale);
    attn_dkdv_kernel<T><<<g_tiles, NT, s_dkdv, st>>>(
        w.qkv, w.dO, w.mst, w.rst, w.delta, w.dqkv, N, D, H, qscale);
    qkv_bwd_kernel<T><<<g_tiles, NT, s_qkvb, st>>>(
        x, mod, wqkv, w.dqkv, w.dx1, dx, w.part, N, D, eps);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  // weight and bias grads over all rows, then dmod
  weight_grad<T>(w.z1, D, w.dqkv, 3 * D, rows, w.pw, w.pb, dwqkv, dbqkv, st);
  weight_grad<T>(w.o, D, w.dpo, D, rows, w.pw, w.pb, dwproj, dbproj, st);
  weight_grad<T>(w.z2, D, w.da1, hidden, rows, w.pw, w.pb, dwfc1, dbfc1, st);
  weight_grad<T>(w.h1, hidden, w.dh2, D, rows, w.pw, w.pb, dwfc2, dbfc2, st);
  launch_dmod_reduce(w.part, B, tiles, 6 * D, dmod, st);
  return cudaGetLastError();
}

}  // namespace

#define T2MS_BWD_ENTRY(NAME, T)                                              \
  extern "C" int NAME(                                                       \
      const void* x, const void* mod, const void* wqkv, const void* bqkv,    \
      const void* wproj, const void* bproj, const void* wfc1,                \
      const void* bfc1, const void* wfc2, const void* bfc2, const void* dy,  \
      void* dx, void* dmod, void* dwqkv, void* dbqkv, void* dwproj,          \
      void* dbproj, void* dwfc1, void* dbfc1, void* dwfc2, void* dbfc2,      \
      void* work, int B, int N, int D, int hidden, int H, float eps,         \
      float qscale, void* stream) {                                          \
    return run_backward<T>(                                                  \
        (const T*)x, (const float*)mod, (const T*)wqkv, (const T*)bqkv,      \
        (const T*)wproj, (const T*)bproj, (const T*)wfc1, (const T*)bfc1,    \
        (const T*)wfc2, (const T*)bfc2, (const T*)dy, (T*)dx, (float*)dmod,  \
        (float*)dwqkv, (float*)dbqkv, (float*)dwproj, (float*)dbproj,        \
        (float*)dwfc1, (float*)dbfc1, (float*)dwfc2, (float*)dbfc2, work, B, \
        N, D, hidden, H, eps, qscale, (cudaStream_t)stream);                 \
  }

T2MS_BWD_ENTRY(dit_block_backward_bf16, __nv_bfloat16)
T2MS_BWD_ENTRY(dit_block_backward_f32, float)

// The bf16 attention VJP alone (for checks against its twin): qkv (B, N,
// 3D), do (B, N, D), st (B*N, H, 3) f32 holding each row's m, 1/r and
// delta; dq, dk and dv into the column slices of dqkv (B, N, 3D)
extern "C" int dit_block_attention_bwd_bf16(const void* qkv, const void* dO,
                                            const void* st, void* dqkv, int B,
                                            int N, int D, int H, float qscale,
                                            void* stream) {
  if (B < 1 || N < 1 || H < 1 || D % H || D % 64 || !tc_head_width(D / H) ||
      (long long)B * N > INT_MAX || !block_attn_grid_ok(B, N, H))
    return T2MS_UNSUPPORTED_SHAPE;
  return launch_block_attn_bwd((const bf16*)qkv, (const bf16*)dO,
                               (const float*)st, (bf16*)dqkv, B, N, D, H,
                               qscale, (cudaStream_t)stream);
}

// The bf16 MLP half's and qkv half's kernels alone (for checks against
// their twins, mlp_half_bwd_reference and qkv_half_bwd_reference), on the
// operands run_backward_tc passes them: (B, N, .) activations, mod (B, 6, D)
// f32, flax-layout weights; part (B * ceil(N / 64), 6, D) f32 receives the
// MLP half's rows 3 to 5 or the qkv half's rows 0 and 1 of each tile's
// dmod partials (the other rows are left as they are)
inline bool row_bwd_ok(int B, int N, int D, int hidden) {
  const long long optin = smem_optin();
  return B >= 1 && N >= 1 && (long long)B * N <= INT_MAX &&
         (D == 64 || D == 128) && hidden >= 64 && hidden % 64 == 0 &&
         optin > 0 && plan_mlp_bwd(D, hidden, optin).slots &&
         plan_qkv_bwd(D, optin).slots;
}
extern "C" int dit_block_mlp_bwd_bf16(const void* x1, const void* mod,
                                      const void* w1, const void* b1,
                                      const void* w2, const void* b2,
                                      const void* dy, void* dx1, void* z2,
                                      void* h1, void* dh2, void* da1,
                                      void* part, int B, int N, int D,
                                      int hidden, float eps, void* stream) {
  if (!row_bwd_ok(B, N, D, hidden)) return T2MS_UNSUPPORTED_SHAPE;
  return launch_mlp_bwd((const bf16*)x1, (const float*)mod, (const bf16*)w1,
                        (const bf16*)b1, (const bf16*)w2, (const bf16*)b2,
                        (const bf16*)dy, (float*)dx1, (bf16*)z2, (bf16*)h1,
                        (bf16*)dh2, (bf16*)da1, (float*)part, B, N, D, hidden,
                        eps, (cudaStream_t)stream);
}
extern "C" int dit_block_qkv_bwd_bf16(const void* x, const void* mod,
                                      const void* wqkv, const void* dqkv,
                                      const void* dx1, void* dx, void* part,
                                      int B, int N, int D, float eps,
                                      void* stream) {
  if (!row_bwd_ok(B, N, D, 64)) return T2MS_UNSUPPORTED_SHAPE;
  return launch_qkv_bwd((const bf16*)x, (const float*)mod,
                        (const bf16*)wqkv, (const bf16*)dqkv,
                        (const float*)dx1, (bf16*)dx, (float*)part, B, N, D,
                        eps, (cudaStream_t)stream);
}

extern "C" long long dit_block_backward_workspace(int B, int N, int D,
                                                  int hidden, int H,
                                                  int is_bf16) {
  if (is_bf16) {
    Work<__nv_bfloat16> w;
    return (long long)carve<__nv_bfloat16>(nullptr, B, N, D, hidden, H, &w);
  }
  Work<float> w;
  return (long long)carve<float>(nullptr, B, N, D, hidden, H, &w);
}

// dynamic shared memory of the bf16 backward's kernels at (D, hidden, H):
// 0 mlp_bwd_tc_kernel, 1 attn_out_bwd_tc_kernel, 2 qkv_bwd_tc_kernel,
// 3 wgrad_tc_kernel, 4 heads_bwd_q_kernel, 5 heads_bwd_kv_kernel (BLOCK)
extern "C" long long dit_block_bwd_smem(int kernel, int D, int hidden,
                                        int H) {
  const size_t s[] = {smem_mlp_bwd_tc(D, hidden), smem_attn_out_tc(D),
                      smem_qkv_bwd_tc(D), SMEM_WGRAD_TC,
                      smem_bwd_q(D / H), smem_bwd_kv(D / H, BLOCK)};
  return kernel >= 0 && kernel < 6 ? (long long)s[kernel] : -1;
}

extern "C" int dit_block_check(int D, int hidden, int H, int is_bf16) {
  return is_bf16 ? check_bwd<__nv_bfloat16>(D, hidden, H)
                 : check_bwd<float>(D, hidden, H);
}

extern "C" const char* t2ms_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
