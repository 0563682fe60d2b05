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
// dit_layer.cuh's three; the MLP half, the attention output and the qkv
// half on its row GEMM (tile_gemm), each with its elementwise and LayerNorm
// VJP work in the same kernel; the attention VJP on heads_bwd.cuh's q-tile
// and kv-tile kernels with their BLOCK recipe (the rows' m, 1/r and delta
// from the attention-output kernel); the weight grads on wgrad_tc_kernel.
// Rounding points as above, with these differences from the first kernels
// (f32 still runs those, FMA loops held tightly to the twin):
//   - p = e * (1/r), one f32 reciprocal a row, where they divide by r;
//   - every sum over rows or columns runs in another (still fixed) order:
//     the dmod, dgate and bias partials through warp shuffles and then the
//     warps in order, the LayerNorm statistics four threads a row.
//
// Bound on an H100 SXM at the main-path call (B=1024, N=480, D=128, 4
// heads, hidden 256, bf16): the recompute is the forward's ~0.25 TFLOP and
// the backward's own products ~0.50 TFLOP (dense: 2 products per forward
// product; attention: QK^T again, dP, dQ, dK, dV), ~0.75 TFLOP or 0.76 ms
// at 989 TFLOP/s, against ~0.5 GB that must move (x, dy, dx) or 0.15 ms:
// bound by operations. The cut at the residual boundaries adds the
// intermediates above, about 2.5 GB written and read (0.75 ms at 3.35
// TB/s), so a realistic floor is near 2 ms. What the design does about it:
// - every dense product is mma.sync m16n8k16 with the sums in registers
//   and the operands through ldmatrix (.trans where read k-major); no f32
//   tile of a product goes through shared memory except dz, which the
//   LayerNorm VJP reads by row;
// - the MLP half keeps z2, a1, h1, h2, dh2 and da1 of its 64 rows in shared
//   memory through all four products (two blocks an SM), and writes z2, h1,
//   dh2 and da1 once for the weight grads;
// - the weights stream through tile_gemm's cp.async rings; the four that
//   are multiplied transposed are copied transposed once a call;
// - the attention VJP (heads_bwd.cuh's BLOCK recipe) runs on wgmma: K/V
//   (q kernel) and q/do (kv kernel) tiles of one head come in by TMA,
//   shared by two warpgroups, with S, dP, e and ds in registers, one pass
//   over the k tiles (the statistics come from the recompute);
// - the weight grads run 128 x 128 output tiles over about 256 row splits,
//   so A and G are read once a tile column (L2 catches the rest).
// Probes on an H100 chose the rings (two stages of 32 weight rows in the
// MLP kernel, three in the qkv kernel: deeper rings, 64-row stages and one
// block an SM ran slower) and the weight grads' split count; other launch
// bounds for the attention kernels gained nothing (PERF.md).

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
// bf16: the backward's own kernels on tensor-core tiles. The row kernels
// run dit_layer.cuh's tile_gemm (8 warps of mma.sync m16n8k16, sums in
// registers, the weight through a cp.async ring) on 64-row tiles aligned to
// one element (tile_of), so each tile's dmod partials belong to one
// element. Products by a transposed weight read W^T from copies the launch
// makes once a call (transpose4_kernel). The row passes around them run
// LP = 4 threads a row over 16-byte chunks; column sums over a tile's rows
// go through the warp (shuffles over its 8 rows) and then over the 8 warps
// in order, so every sum keeps one order.

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

// The VJP of z = LN(x) * (1 + scale) + shift for a 64-row tile, given dz
// (f32 in shared memory, row stride ldz, zero past `valid`):
// dst = base + rs * (g - mean(g) - xhat * mean(g * xhat)), g = dz * (1 +
// scale), LP threads a row with its chunks in registers (D <= GC); the
// tile's column sums of dz and dz * xhat (dshift, dscale) into pt[ish * D]
// and pt[(ish + 1) * D] through CS (NW x 2D floats). x, base and dst point
// at the tile's first row. The LayerNorm statistics are summed as
// modln_tile<64> sums them, so the MLP half's match its z2's bit for bit.
template <typename Base, typename Out>
__device__ void ln_vjp_rows(const bf16* __restrict__ x,
                            const float* __restrict__ modb, int ish,
                            const float* DZ, int ldz, float* CS,
                            const Base* __restrict__ base,
                            Out* __restrict__ dst, float* __restrict__ pt,
                            int valid, int D, float eps) {
  constexpr int MC = GC / (8 * LP);  // chunks a thread holds at D = GC
  const int i = threadIdx.x / LP, q = threadIdx.x % LP, nc = D / (8 * LP);
  const bool ok = i < valid;
  float xv[MC][8];
  float s = 0.0f;
#pragma unroll
  for (int u = 0; u < MC; ++u) {
    if (u >= nc) break;
#pragma unroll
    for (int k = 0; k < 8; ++k) xv[u][k] = 0.0f;
    if (ok) ld8(x + (size_t)i * D + 8 * q + 8 * LP * u, xv[u]);
#pragma unroll
    for (int k = 0; k < 8; ++k) s += xv[u][k];
  }
  const float mu = lanes_sum<LP>(s) / D;
  float v = 0.0f;
#pragma unroll
  for (int u = 0; u < MC; ++u) {
    if (u >= nc) break;
#pragma unroll
    for (int k = 0; k < 8; ++k) v += (xv[u][k] - mu) * (xv[u][k] - mu);
  }
  const float rs = rsqrtf(lanes_sum<LP>(v) / D + eps);
  const float* sc = modb + (ish + 1) * D;
  float* CSw = CS + (threadIdx.x >> 5) * 2 * D;
  float sg = 0.0f, sgx = 0.0f;
#pragma unroll
  for (int u = 0; u < MC; ++u) {
    if (u >= nc) break;
    const int c = 8 * q + 8 * LP * u;
    float dz[8], s8[8], a[8], b[8];
    ld8(DZ + i * ldz + c, dz);
    ld8(sc + c, s8);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float xh = (xv[u][k] - mu) * rs, g = dz[k] * (1.0f + s8[k]);
      xv[u][k] = xh;
      sg += g;
      sgx += g * xh;
      a[k] = ok ? dz[k] : 0.0f;
      b[k] = ok ? dz[k] * xh : 0.0f;
    }
    warp_col_sums8(a, CSw, c);
    warp_col_sums8(b, CSw + D, c);
  }
  const float mg = lanes_sum<LP>(sg) / D, mgx = lanes_sum<LP>(sgx) / D;
  if (ok) {
#pragma unroll
    for (int u = 0; u < MC; ++u) {
      if (u >= nc) break;
      const int c = 8 * q + 8 * LP * u;
      float dz[8], s8[8], o[8];
      ld8(DZ + i * ldz + c, dz);
      ld8(sc + c, s8);
      ld8(base + (size_t)i * D + c, o);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        o[k] += rs * (dz[k] * (1.0f + s8[k]) - mg - xv[u][k] * mgx);
      st8(dst + (size_t)i * D + c, o);
    }
  }
  __syncthreads();
  warps_sum(CS, 2 * D, pt + ish * D);
}

// bytes of the region that holds a1 and then dz2 (f32)
__host__ __device__ inline size_t mlp_a1_bytes(int D, int hidden) {
  const size_t a = row_tile(hidden), b = (size_t)RT * (D + 4) * 4;
  return a > b ? a : b;
}
// ... and of the one that holds h1, then da1, then column sums
__host__ __device__ inline size_t mlp_h1_bytes(int D, int hidden) {
  const size_t a = row_tile(hidden), b = (size_t)NW * 2 * D * 4;
  return a > b ? a : b;
}
// weight rings: two stages of 32 rows in the MLP kernel, three in the qkv
// kernel, two of 64 in the out-projection kernel
constexpr size_t RING32x2 = (size_t)2 * 32 * GLD * 2;
constexpr size_t RING32x3 = (size_t)3 * 32 * GLD * 2;
constexpr size_t RING64x2 = (size_t)2 * 64 * GLD * 2;
__host__ __device__ inline size_t smem_mlp_bwd_tc(int D, int hidden) {
  return row_tile(D) + mlp_a1_bytes(D, hidden) + mlp_h1_bytes(D, hidden) +
         RING32x2;
}
__host__ __device__ inline size_t smem_attn_out_tc(int D) {
  return 2 * row_tile(D) + (size_t)NW * D * 4 + RING64x2;
}
__host__ __device__ inline size_t smem_qkv_bwd_tc(int D) {
  return row_tile(3 * D) + (size_t)RT * (D + 4) * 4 + RING32x3;
}

// MLP half: recompute z2, a1, h1, h2; dgate_m = column sums of dy * h2;
// dh2 = T(T(gate_m) dy); da1 = T((dh2 w2^T) * gelu'(a1)); dz2 = da1 w1^T;
// the LayerNorm VJP -> dshift_m, dscale_m, dx1 = dy + LN-VJP (f32). z2,
// h1, dh2 and da1 go out for the weight grads.
__global__ void __launch_bounds__(NT, 2)
mlp_bwd_tc_kernel(const bf16* __restrict__ x1, const float* __restrict__ mod,
                  const bf16* __restrict__ w1, const bf16* __restrict__ b1,
                  const bf16* __restrict__ w2, const bf16* __restrict__ b2,
                  const bf16* __restrict__ w1t, const bf16* __restrict__ w2t,
                  const bf16* __restrict__ dy, float* __restrict__ dx1,
                  bf16* __restrict__ z2_out, bf16* __restrict__ h1_out,
                  bf16* __restrict__ dh2_out, bf16* __restrict__ da1_out,
                  float* __restrict__ part, int N, int D, int hidden,
                  float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int R = RT;
  const int lda = D + 8, ldh = hidden + 8, ldz = D + 4;
  bf16* Zs = reinterpret_cast<bf16*>(smem);  // z2, then h2, then dh2
  unsigned char* p = smem + row_tile(D);
  bf16* A1 = reinterpret_cast<bf16*>(p);     // a1, then dz2 (f32)
  float* DZ = reinterpret_cast<float*>(p);
  p += mlp_a1_bytes(D, hidden);
  bf16* Hs = reinterpret_cast<bf16*>(p);     // h1, then da1; column sums
  float* CS = reinterpret_cast<float*>(p);
  bf16* ring = reinterpret_cast<bf16*>(p + mlp_h1_bytes(D, hidden));

  const Tile tl = tile_of<bf16>(N);
  const int valid = tl.valid, r0 = (int)tl.r0;
  const float* modb = mod + (size_t)tl.b * 6 * D;
  float* pt = part + (size_t)blockIdx.x * 6 * D;

  // z2 = T(modLN(x1; shift_m, scale_m)) in place of the x1 tile; then
  // a1 = T(z2 w1 + T(b1)) and h1 = T(gelu(a1))
  cp_rows<R>(Zs, x1 + (size_t)r0 * D, D, D, valid);
  cp_commit();  // older than the ring's groups
  tile_gemm<R, 32, 2>(
      Zs, lda, w1, D, hidden, ring,
      [&] {
        cp_wait<1>();
        __syncthreads();
        modln_tile<R>(Zs, lda, Zs, lda, mod, r0, r0 + valid, N, D, 1, 0, 3,
                      4, eps);
        __syncthreads();
        st_rows(z2_out + (size_t)r0 * D, D, Zs, lda, D, valid);
      },
      [&](int c0, const Acc<R>& acc) {
        for_pairs<R>(acc, [&](int r, int, int c, float v0, float v1) {
          const int col = c0 + c;
          if (col >= hidden) return;
          const float2 b = ld_bf16x2(b1 + col);
          float a0, a1;
          *reinterpret_cast<uint32_t*>(A1 + r * ldh + col) =
              round2(v0 + b.x, v1 + b.y, a0, a1);
          const uint32_t h = pack_bf16(gelu_tanh(a0), gelu_tanh(a1));
          *reinterpret_cast<uint32_t*>(Hs + r * ldh + col) = h;
          if (r < valid)
            *reinterpret_cast<uint32_t*>(
                h1_out + ((size_t)r0 + r) * hidden + col) = h;
        });
      });
  // h2 = T(h1 w2 + T(b2)) into Zs
  tile_gemm<R, 32, 2>(Hs, ldh, w2, hidden, D, ring, [] {},
                      [&](int c0, const Acc<R>& acc) {
    for_pairs<R>(acc, [&](int r, int, int c, float v0, float v1) {
      const int col = c0 + c;
      if (col >= D) return;
      const float2 b = ld_bf16x2(b2 + col);
      st_bf16x2(Zs + r * lda + col, v0 + b.x, v1 + b.y);
    });
  });
  // dgate_m partial = column sums of dy * h2 (the sums in Hs: h1 is done);
  // dh2 = T(T(gate_m) dy) in place of h2, zero past `valid`
  {
    const int i = threadIdx.x / LP, q = threadIdx.x % LP;
    float* CSw = CS + (threadIdx.x >> 5) * D;
    for (int c = 8 * q; c < D; c += 8 * LP) {
      float d[8] = {}, h2[8], g[8], pr[8];
      if (i < valid) ld8(dy + ((size_t)r0 + i) * D + c, d);
      ld8(Zs + i * lda + c, h2);
      ld8(modb + 5 * D + c, g);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        pr[k] = d[k] * h2[k];
        d[k] = rnd<bf16>(rnd<bf16>(g[k]) * d[k]);
      }
      warp_col_sums8(pr, CSw, c);
      st8(Zs + i * lda + c, d);
      if (i < valid) st8(dh2_out + ((size_t)r0 + i) * D + c, d);
    }
  }
  __syncthreads();
  warps_sum(CS, D, pt + 5 * D);
  // da1 = T((dh2 w2^T) * gelu'(a1)) into Hs
  tile_gemm<R, 32, 2>(Zs, lda, w2t, D, hidden, ring, [] {},
                      [&](int c0, const Acc<R>& acc) {
    for_pairs<R>(acc, [&](int r, int, int c, float v0, float v1) {
      const int col = c0 + c;
      if (col >= hidden) return;
      const float2 a = ld_bf16x2(A1 + r * ldh + col);
      const uint32_t d = pack_bf16(v0 * gelu_tanh_grad(a.x),
                                   v1 * gelu_tanh_grad(a.y));
      *reinterpret_cast<uint32_t*>(Hs + r * ldh + col) = d;
      if (r < valid)
        *reinterpret_cast<uint32_t*>(da1_out + ((size_t)r0 + r) * hidden +
                                     col) = d;
    });
  });
  // dz2 = da1 w1^T (f32) in place of a1
  tile_gemm<R, 32, 2>(Hs, ldh, w1t, hidden, D, ring, [] {},
                      [&](int c0, const Acc<R>& acc) {
    for_pairs<R>(acc, [&](int r, int, int c, float v0, float v1) {
      const int col = c0 + c;
      if (col < D)
        *reinterpret_cast<float2*>(DZ + r * ldz + col) = make_float2(v0, v1);
    });
  });
  // dshift_m, dscale_m; dx1 = dy + LN-VJP
  ln_vjp_rows<bf16, float>(x1 + (size_t)r0 * D, modb, 3, DZ, ldz, CS,
                           dy + (size_t)r0 * D, dx1 + (size_t)r0 * D, pt,
                           valid, D, eps);
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

// qkv half: dz1 = dqkv wqkv^T (f32), then dshift_a, dscale_a and
// dx = T(dx1 + LN-VJP).
__global__ void __launch_bounds__(NT, 2)
qkv_bwd_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ mod,
                  const bf16* __restrict__ wqkvt,
                  const bf16* __restrict__ dqkv,
                  const float* __restrict__ dx1, bf16* __restrict__ dx,
                  float* __restrict__ part, int N, int D, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int R = RT;
  const int W3 = 3 * D, lda = W3 + 8, ldz = D + 4;
  bf16* As = reinterpret_cast<bf16*>(smem);  // dqkv, then column sums
  float* DZ = reinterpret_cast<float*>(smem + row_tile(W3));
  bf16* ring = reinterpret_cast<bf16*>(DZ + R * ldz);

  const Tile tl = tile_of<bf16>(N);
  const size_t r0 = tl.r0;
  cp_rows<R>(As, dqkv + r0 * W3, W3, W3, tl.valid);
  cp_commit();  // older than the ring's groups, so in before its first slice
  tile_gemm<R, 32, 3>(As, lda, wqkvt, W3, D, ring, [] {},
                      [&](int c0, const Acc<R>& acc) {
    for_pairs<R>(acc, [&](int r, int, int c, float v0, float v1) {
      const int col = c0 + c;
      if (col < D)
        *reinterpret_cast<float2*>(DZ + r * ldz + col) = make_float2(v0, v1);
    });
  });
  ln_vjp_rows<float, bf16>(x + r0 * D, mod + (size_t)tl.b * 6 * D, 0, DZ, ldz,
                           reinterpret_cast<float*>(As), dx1 + r0 * D,
                           dx + r0 * D, part + (size_t)blockIdx.x * 6 * D,
                           tl.valid, D, eps);
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

// W^T of the four weights the backward multiplies by transposed, made once
// a call: dst (cols x rows) = src (rows x cols)^T, blockIdx.y the weight
struct Transpose {
  const bf16* src;
  bf16* dst;
  int rows, cols;
};
struct Transposes {
  Transpose t[4];
};
__global__ void transpose4_kernel(Transposes job) {
  const Transpose t = job.t[blockIdx.y];
  const int n = t.rows * t.cols;
  for (int idx = blockIdx.x * NT + threadIdx.x; idx < n;
       idx += gridDim.x * NT) {
    const int r = idx / t.cols, c = idx % t.cols;
    t.dst[(size_t)c * t.rows + r] = t.src[idx];
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
// D within one GEMM chunk, which the LayerNorm VJP's row pass holds in
// registers, and the recompute's kernels), in f32 the FMA-loop kernels'
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
  T *wqkvt, *wprojt, *w1t, *w2t;  // bf16: the transposed weights
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
    w->wqkvt = t((size_t)3 * D * D);
    w->wprojt = t((size_t)D * D);
    w->w1t = t((size_t)hidden * D);
    w->w2t = t((size_t)D * hidden);
  } else {
    const int split = wgrad_split_rows((int)rows);
    const size_t S = (rows + split - 1) / split;
    const int wmax = 3 * D > hidden ? 3 * D : hidden;
    pw = S * D * wmax;
    pb = S * wmax;
    w->st = nullptr;
    w->delta = f(rows * H);
    w->wqkvt = w->wprojt = w->w1t = w->w2t = nullptr;
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
  const size_t s_mlp = smem_mlp_bwd_tc(D, hidden), s_out = smem_attn_out_tc(D);
  const size_t s_qkv = smem_qkv_bwd_tc(D);
  cudaError_t e;
  if ((e = set_smem((const void*)mlp_bwd_tc_kernel, s_mlp)) ||
      (e = set_smem((const void*)attn_out_bwd_tc_kernel, s_out)) ||
      (e = set_smem((const void*)qkv_bwd_tc_kernel, s_qkv)) ||
      (e = set_smem((const void*)wgrad_tc_kernel, SMEM_WGRAD_TC)))
    return e;
  const dim3 g_tiles(B * ((N + RT - 1) / RT));
  const Transposes tr{{{wqkv, w.wqkvt, D, 3 * D},
                       {wproj, w.wprojt, D, D},
                       {wfc1, w.w1t, D, hidden},
                       {wfc2, w.w2t, hidden, D}}};
  transpose4_kernel<<<dim3(64, 4), NT, 0, st>>>(tr);
  // recompute the forward's intermediates
  if ((e = run_layer_tc(x, mod, wqkv, bqkv, wproj, bproj, nullptr, nullptr,
                        nullptr, nullptr, w.qkv, w.o, nullptr, B, N, D,
                        hidden, H, 1, 0, eps, qscale, st, w.z1, w.mst, w.rst,
                        w.proj, w.x1)) != cudaSuccess)
    return e;
  // activation grads, back to front
  mlp_bwd_tc_kernel<<<g_tiles, NT, s_mlp, st>>>(
      w.x1, mod, wfc1, bfc1, wfc2, bfc2, w.w1t, w.w2t, dy, w.dx1, w.z2, w.h1,
      w.dh2, w.da1, w.part, N, D, hidden, eps);
  attn_out_bwd_tc_kernel<<<g_tiles, NT, s_out, st>>>(
      w.dx1, w.proj, w.o, mod, w.wprojt, w.mst, w.rst, w.dpo, w.dO, w.st,
      w.part, N, D, H);
  if ((e = cudaGetLastError()) != cudaSuccess ||
      (e = launch_block_attn_bwd(w.qkv, w.dO, w.st, w.dqkv, B, N, D, H,
                                 qscale, st)) != cudaSuccess)
    return e;
  qkv_bwd_tc_kernel<<<g_tiles, NT, s_qkv, st>>>(x, mod, w.wqkvt, w.dqkv,
                                                w.dx1, dx, w.part, N, D, eps);
  return cudaGetLastError();
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
