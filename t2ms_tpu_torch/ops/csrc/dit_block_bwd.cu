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
//              sum r, proj, x1. In bf16 on the stack's route (dit_layer.cuh:
//              modln_qkv_tc_kernel, heads_fwd_kernel, the first half of
//              proj_mlp_tc_kernel), else dit_common.cuh's modln_qkv and
//              attn_proj kernels.
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
// Bound on an H100 SXM at the main-path call (B=1024, N=480, D=128, 4
// heads, hidden 256, bf16): the recompute is the forward's ~0.25 TFLOP and
// the backward's own products ~0.50 TFLOP (dense: 2 products per forward
// product; attention: QK^T again, dP, dQ, dK, dV), ~0.75 TFLOP or 0.76 ms
// at 989 TFLOP/s, against ~0.5 GB that must move (x, dy, dx) or 0.15 ms:
// bound by operations. Every product runs on the tensor cores (the
// recompute on dit_layer.cuh's mma.sync tiles; the backward's own kernels on
// WMMA bf16 16x16x16, f32 accumulation; the f32 entry uses FMA loops so it
// can be held tightly to its twin); the intermediates above go through
// device memory (about 2.5 GB of workspace at the main path), which is far
// below the compute bound. The backward's own kernels are still the first
// versions; their redesign (register tiles, fewer round trips) is later
// work.
//
// C interface for ctypes: dit_block_backward_{bf16,f32} launch everything
// on the given stream and return cudaGetLastError(), or
// T2MS_UNSUPPORTED_SHAPE for a shape the kernels do not take (launching
// nothing); dit_block_backward_workspace gives the workspace bytes the
// caller allocates; dit_block_check answers the shape question for the
// forward and backward kernels together.

#include "dit_layer.cuh"

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

// check_shape (the forward kernels) plus the backward kernels' shared memory
template <typename T> int check_bwd(int D, int hidden, int H) {
  const int ok = check_shape<T>(D, hidden, H);
  if (ok) return ok;
  const long long optin = smem_optin();
  if (optin < 0) return (int)-optin;
  const size_t need[] = {smem_mlp_bwd<T>(D, hidden), smem_attn_out_bwd<T>(D),
                         smem_attn_dq<T>(D, H), smem_attn_dkdv<T>(D, H),
                         smem_qkv_bwd<T>(D), smem_wgrad<T>()};
  for (size_t n : need)
    if (n > (size_t)optin) return T2MS_UNSUPPORTED_SHAPE;
  return 0;
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
// Workspace: the intermediates above, carved in one order by both the size
// query and the launch.

template <typename T> struct Work {
  T *qkv, *z1, *o, *proj, *x1, *z2, *h1, *dh2, *da1, *dpo, *dO, *dqkv;
  float *mst, *rst, *delta, *dx1, *part, *pw, *pb;
};

// rows of one weight-grad split, and the number of splits (grid.z <= 65535)
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
  const int split = wgrad_split_rows((int)rows);
  const size_t S = (rows + split - 1) / split;
  const int wmax = 3 * D > hidden ? 3 * D : hidden;
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
  w->delta = f(rows * H);
  w->dx1 = f(rows * D);
  w->part = f((size_t)B * tiles * 6 * D);
  w->pw = f(S * D * wmax);
  w->pb = f(S * wmax);
  return off;
}

template <typename T>
void weight_grad(const T* A, int K, const T* G, int M, int rows, float* pw,
                 float* pb, float* dw, float* db, cudaStream_t st) {
  const int split = wgrad_split_rows(rows);
  const int S = (rows + split - 1) / split;
  wgrad_kernel<T><<<dim3(M / CW, K / CW, S), NT, smem_wgrad<T>(), st>>>(
      A, K, G, M, rows, split, pw, pb);
  const size_t n = (size_t)K * M;
  sum_splits_kernel<<<(unsigned)((n + NT - 1) / NT), NT, 0, st>>>(pw, S, n,
                                                                  dw);
  sum_splits_kernel<<<(M + NT - 1) / NT, NT, 0, st>>>(pb, S, M, db);
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
  const size_t s_qkv = smem_qkv<T>(D), s_attn = smem_attn<T>(D, H);
  const size_t s_mlpb = smem_mlp_bwd<T>(D, hidden);
  const size_t s_outb = smem_attn_out_bwd<T>(D);
  const size_t s_dq = smem_attn_dq<T>(D, H), s_dkdv = smem_attn_dkdv<T>(D, H);
  const size_t s_qkvb = smem_qkv_bwd<T>(D);
  cudaError_t e;
  if ((e = set_smem((const void*)modln_qkv_kernel<T>, s_qkv)) ||
      (e = set_smem((const void*)attn_proj_kernel<T>, s_attn)) ||
      (e = set_smem((const void*)mlp_bwd_kernel<T>, s_mlpb)) ||
      (e = set_smem((const void*)attn_out_bwd_kernel<T>, s_outb)) ||
      (e = set_smem((const void*)attn_dq_kernel<T>, s_dq)) ||
      (e = set_smem((const void*)attn_dkdv_kernel<T>, s_dkdv)) ||
      (e = set_smem((const void*)qkv_bwd_kernel<T>, s_qkvb)) ||
      (e = set_smem((const void*)wgrad_kernel<T>, smem_wgrad<T>())))
    return e;
  Work<T> w;
  carve<T>(static_cast<unsigned char*>(work), B, N, D, hidden, H, &w);
  const int rows = B * N;
  const int tiles = (N + tb<T>() - 1) / tb<T>();
  const dim3 g_rows((rows + RT - 1) / RT), g_attn(B * ((N + QT - 1) / QT));
  const dim3 g_tiles(B * tiles);

  // recompute the forward's intermediates, on the forward's own route
  bool tc = false;
  if constexpr (sizeof(T) == 2) {
    tc = tc_route(B, N, D, hidden, H);
    if (tc && (e = run_layer_tc(x, mod, wqkv, bqkv, wproj, bproj, nullptr,
                                nullptr, nullptr, nullptr, w.qkv, w.o,
                                nullptr, B, N, D, hidden, H, 1, 0, eps,
                                qscale, st, w.z1, w.mst, w.rst, w.proj,
                                w.x1)) != cudaSuccess)
      return e;
  }
  if (!tc) {
    modln_qkv_kernel<T><<<g_rows, NT, s_qkv, st>>>(
        x, mod, wqkv, bqkv, w.qkv, w.z1, rows, N, D, 1, 0, eps);
    attn_proj_kernel<T><<<g_attn, NT, s_attn, st>>>(
        w.qkv, x, mod, wproj, bproj, w.x1, N, D, H, 1, 0, qscale, w.o, w.mst,
        w.rst, w.proj);
  }
  // activation grads, back to front
  mlp_bwd_kernel<T><<<g_tiles, NT, s_mlpb, st>>>(
      w.x1, mod, wfc1, bfc1, wfc2, bfc2, dy, w.dx1, w.z2, w.h1, w.dh2, w.da1,
      w.part, N, D, hidden, eps);
  attn_out_bwd_kernel<T><<<g_tiles, NT, s_outb, st>>>(
      w.dx1, w.proj, w.o, mod, wproj, w.dpo, w.dO, w.delta, w.part, N, D, H);
  attn_dq_kernel<T><<<g_tiles, NT, s_dq, st>>>(w.qkv, w.dO, w.mst, w.rst,
                                               w.delta, w.dqkv, N, D, H,
                                               qscale);
  attn_dkdv_kernel<T><<<g_tiles, NT, s_dkdv, st>>>(w.qkv, w.dO, w.mst, w.rst,
                                                   w.delta, w.dqkv, N, D, H,
                                                   qscale);
  qkv_bwd_kernel<T><<<g_tiles, NT, s_qkvb, st>>>(x, mod, wqkv, w.dqkv, w.dx1,
                                                 dx, w.part, N, D, eps);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
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

extern "C" int dit_block_check(int D, int hidden, int H, int is_bf16) {
  return is_bf16 ? check_bwd<__nv_bfloat16>(D, hidden, H)
                 : check_bwd<float>(D, hidden, H);
}

extern "C" const char* t2ms_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
