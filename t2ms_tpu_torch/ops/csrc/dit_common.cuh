// Device code shared by the port's kernels (dit_stack.cu, the forward,
// dit_block_bwd.cu, the backward, and through attn_heads.cuh dit_split.cu,
// fused_heads.cu and dit_layer.cuh; mod_ln.cu): tile sizes, shared-memory
// copies, the block-level WMMA product, the f32 LayerNorm + adaLN modulate
// of a row tile, the ordered per-tile reduction of dmod, and the first
// three forward kernels of one adaLN-zero block, cut at its residual
// boundaries. They run the f32 stack and block (FMA loops, which keep them
// tight against the twin) and the bf16 ones at a head width without a
// heads_fwd_kernel instance (WMMA); the bf16 main path runs dit_layer.cuh's
// tensor-core kernels, which keep these kernels' rounding points:
//
//   (a) modln_qkv_kernel   one block per 64-row tile of the (B*N) rows:
//       f32 LayerNorm (eps 1e-6) -> *(1+scale)+shift in f32 -> cast ->
//       (rows x D) @ (D x 3D) with f32 accumulation + f32 add of the
//       rounded bias -> cast -> qkv.
//   (b) attn_proj_kernel   one block per (batch element, 64 q rows), all
//       heads: q scaled at input width, f32 scores, the exact row softmax
//       in TWO passes over K (row max first; then e = T(exp(T(s - m))),
//       r += f32(e), o += e @ v in f32), o / r, out-projection + bias,
//       x + gate * proj in T. This is attn_heads_natural's order of
//       rounding; an online rescaling softmax would not reproduce it.
//   (c) mlp_kernel         one block per 64-row tile: LN + modulate with
//       mod[3:5], fc1 + bias, tanh-GELU, fc2 + bias, x + gate * h2.
//
// (a) and (b) can also write what the backward needs from the forward
// (the modulated LN output, the attention output, the per-(row, head) row
// max and row sum, the projection); the stack passes null pointers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <math.h>
#include <limits.h>
#include <stdint.h>

using namespace nvcuda;

// Returned instead of a CUDA error for a shape the kernels do not take;
// cudaError_t values are never negative.
#define T2MS_UNSUPPORTED_SHAPE (-1)

namespace {

constexpr int NT = 256;   // threads per block (8 warps)
constexpr int NW = NT / 32;
constexpr int RT = 64;    // rows per block of the modLN + GEMM kernels
constexpr int QT = 64;    // q rows per attention block
constexpr int KT = 64;    // k rows per attention step
constexpr int CW = 64;    // weight columns per GEMM chunk
constexpr int MAXD = 256; // widest row a lane-strided LayerNorm holds
// Shared-memory rows are padded by 16 bytes: an unpadded leading dimension
// of 128 or 256 bytes puts every row of a 16x16 fragment on the same banks.
constexpr int PADF = 4;   // floats
template <typename T> __host__ __device__ constexpr int pad() {
  return 16 / sizeof(T);
}

__host__ __device__ constexpr size_t al128(size_t n) {
  return (n + 127) / 128 * 128;
}

// Rows per tile of the backward kernels (dit_block_bwd.cu, fused_heads.cu):
// 64 in bf16; 32 in f32, whose FMA-loop tiles hold twice the bytes in
// shared memory.
template <typename T> __host__ __device__ constexpr int tb() {
  return sizeof(T) == 2 ? 64 : 32;
}

// Dynamic shared memory of each forward kernel; the carve-up inside the
// kernels follows the same order.
template <typename T> __host__ __device__ size_t smem_qkv(int D) {
  const int P = pad<T>();
  return al128(RT * (D + P) * sizeof(T)) + al128(D * (CW + P) * sizeof(T)) +
         al128(RT * (CW + PADF) * 4);
}
template <typename T> __host__ __device__ size_t smem_attn(int D, int H) {
  const int P = pad<T>();
  const int kv_rows = 2 * KT > D ? 2 * KT : D;
  return al128(QT * (D + P) * sizeof(T)) +
         al128(kv_rows * (D + P) * sizeof(T)) + al128(QT * (KT + PADF) * 4) +
         al128(QT * (KT + P) * sizeof(T)) + al128(QT * (D + PADF) * 4) +
         2 * al128(QT * H * 4);
}
template <typename T>
__host__ __device__ size_t smem_mlp(int D, int hidden) {
  const int P = pad<T>();
  const int w_rows = D > hidden ? D : hidden;
  return al128(RT * (D + P) * sizeof(T)) +
         al128(RT * (hidden + P) * sizeof(T)) +
         al128(w_rows * (CW + P) * sizeof(T)) + al128(RT * (CW + PADF) * 4);
}

// Let fn use `bytes` of dynamic shared memory (above 48 KB it must ask).
inline cudaError_t set_smem(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// The device's opt-in shared memory per block, or a negative CUDA error.
inline long long smem_optin() {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return e == cudaSuccess ? optin : -(long long)e;
}

// 0 when the forward kernels take (D, hidden, H) on the current device,
// T2MS_UNSUPPORTED_SHAPE when they do not, else the CUDA error of the query.
// D and hidden are multiples of the GEMM chunk CW (D at most MAXD, the
// LayerNorm's register row); the head width is a multiple of the 16-wide
// tensor-core tile; each kernel's shared memory fits what one block may opt
// in to on this device.
template <typename T> int check_shape(int D, int hidden, int H) {
  if (H < 1 || D < CW || hidden < CW || D % CW || hidden % CW || D > MAXD ||
      D % H || (D / H) % 16)
    return T2MS_UNSUPPORTED_SHAPE;
  const long long optin = smem_optin();
  if (optin < 0) return (int)-optin;
  size_t need = smem_qkv<T>(D);
  if (smem_attn<T>(D, H) > need) need = smem_attn<T>(D, H);
  if (smem_mlp<T>(D, hidden) > need) need = smem_mlp<T>(D, hidden);
  return need <= (size_t)optin ? 0 : T2MS_UNSUPPORTED_SHAPE;
}

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}
// round a float to T's precision and back (one op "at input width")
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f<T>(from_f<T>(v));
}

// the eight bf16 values of a 16-byte chunk as floats
__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(w[k] << 16);
    f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// Block-level product from shared memory:
//   C[M x N] (f32, ldc) (+)= A[M x K] @ B[K x N]
// A_T = false: element (m, k) of A at A[m * lda + k]
// A_T = true : element (m, k) of A at A[k * lda + m]  (A stored as K x M)
// B_T = false: element (k, n) of B at B[k * ldb + n]
// B_T = true : element (k, n) of B at B[n * ldb + k]  (B stored as N x K)
// M, N, K are multiples of 16. No barrier inside: callers sync around it.

template <bool TR> struct Layout { using type = wmma::row_major; };
template <> struct Layout<true> { using type = wmma::col_major; };

template <typename T, bool B_T, bool A_T = false> struct Mma;

template <bool B_T, bool A_T> struct Mma<__nv_bfloat16, B_T, A_T> {
  __device__ static void run(const __nv_bfloat16* A, int lda,
                             const __nv_bfloat16* B, int ldb, float* C,
                             int ldc, int M, int N, int K, bool acc) {
    const int warp = threadIdx.x / 32;
    const int tn = N / 16, tiles = (M / 16) * tn;
    for (int t = warp; t < tiles; t += NW) {
      const int i = (t / tn) * 16, j = (t % tn) * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      if (acc)
        wmma::load_matrix_sync(c, C + i * ldc + j, ldc, wmma::mem_row_major);
      else
        wmma::fill_fragment(c, 0.0f);
      for (int k = 0; k < K; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       typename Layout<A_T>::type> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       typename Layout<B_T>::type> b;
        wmma::load_matrix_sync(a, A_T ? A + k * lda + i : A + i * lda + k,
                               lda);
        wmma::load_matrix_sync(b, B_T ? B + j * ldb + k : B + k * ldb + j,
                               ldb);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(C + i * ldc + j, c, ldc, wmma::mem_row_major);
    }
  }
};

template <bool B_T, bool A_T> struct Mma<float, B_T, A_T> {
  __device__ static void run(const float* A, int lda, const float* B,
                             int ldb, float* C, int ldc, int M, int N, int K,
                             bool acc) {
    for (int idx = threadIdx.x; idx < M * N; idx += NT) {
      const int i = idx / N, j = idx % N;
      float s = 0.0f;
      for (int k = 0; k < K; ++k)
        s = fmaf(A_T ? A[k * lda + i] : A[i * lda + k],
                 B_T ? B[j * ldb + k] : B[k * ldb + j], s);
      C[i * ldc + j] = acc ? C[i * ldc + j] + s : s;
    }
  }
};

// ---------------------------------------------------------------------------
// Copies between device and shared memory (16 bytes per thread and step;
// every row length and stride here is a multiple of 16 bytes).

// dst[r * ldd + c] = src[r * ld + c] for r < valid, 0 for valid <= r < rows
template <typename T>
__device__ void load_rows(T* dst, int ldd, const T* __restrict__ src,
                          size_t ld, int rows, int valid, int cols) {
  constexpr int V = 16 / sizeof(T);
  const int vpr = cols / V;
  for (int idx = threadIdx.x; idx < rows * vpr; idx += NT) {
    const int r = idx / vpr, c = (idx % vpr) * V;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) v = *reinterpret_cast<const uint4*>(src + r * ld + c);
    *reinterpret_cast<uint4*>(dst + r * ldd + c) = v;
  }
}

// f32 LayerNorm statistics of one row held lane-strided in v (D <= MAXD):
// returns the mean, sets rs = 1 / sqrt(var + eps).
__device__ __forceinline__ float ln_stats(const float (&v)[MAXD / 32],
                                          int D, float eps, float& rs) {
  const int lane = threadIdx.x % 32;
  float s = 0.0f;
#pragma unroll
  for (int u = 0; u < MAXD / 32; ++u) s += v[u];
  const float mu = warp_sum(s) / D;
  float q = 0.0f;
#pragma unroll
  for (int u = 0; u < MAXD / 32; ++u) {
    const float d = lane + 32 * u < D ? v[u] - mu : 0.0f;
    q += d * d;
  }
  rs = rsqrtf(warp_sum(q) / D + eps);
  return mu;
}

// As[i][c] = T(LN(x[r0 + i]) * (1 + mod[b, l, isc]) + mod[b, l, ish]) in
// f32, one warp per row; rows past `rows` are zero. As has row stride lda.
template <typename T>
__device__ void modln_rows(const T* __restrict__ x,
                           const float* __restrict__ mod, T* As, int lda,
                           int r0,
                           int rows, int N, int D, int L, int l, int ish,
                           int isc, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < RT; i += NW) {
    const int r = r0 + i;
    if (r >= rows) {
      for (int c = lane; c < D; c += 32) As[i * lda + c] = from_f<T>(0.0f);
      continue;
    }
    const T* xr = x + (size_t)r * D;
    float v[MAXD / 32];
#pragma unroll
    for (int u = 0; u < MAXD / 32; ++u) {
      const int c = lane + 32 * u;
      v[u] = c < D ? to_f<T>(xr[c]) : 0.0f;
    }
    float rs;
    const float mu = ln_stats(v, D, eps, rs);
    const int b = r / N;
    const float* msh = mod + ((size_t)(b * L + l) * 6 + ish) * D;
    const float* msc = mod + ((size_t)(b * L + l) * 6 + isc) * D;
#pragma unroll
    for (int u = 0; u < MAXD / 32; ++u) {
      const int c = lane + 32 * u;
      if (c < D)
        As[i * lda + c] =
            from_f<T>((v[u] - mu) * rs * (1.0f + msc[c]) + msh[c]);
    }
  }
}

// ---------------------------------------------------------------------------
// (a) LN -> modulate(mod[0], mod[1]) -> qkv = T(A @ wqkv + bqkv); z_out, if
//     given, receives the modulated LN rows A.

template <typename T>
__global__ void __launch_bounds__(NT)
modln_qkv_kernel(const T* __restrict__ x, const float* __restrict__ mod,
                 const T* __restrict__ w, const T* __restrict__ bias,
                 T* __restrict__ qkv, T* __restrict__ z_out, int rows, int N,
                 int D, int L, int l, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = D + pad<T>(), ldw = CW + pad<T>(), ldc = CW + PADF;
  unsigned char* p = smem;
  T* As = reinterpret_cast<T*>(p);      p += al128(RT * lda * sizeof(T));
  T* Ws = reinterpret_cast<T*>(p);      p += al128(D * ldw * sizeof(T));
  float* Cs = reinterpret_cast<float*>(p);
  const int r0 = blockIdx.x * RT;
  const int W3 = 3 * D;
  modln_rows<T>(x, mod, As, lda, r0, rows, N, D, L, l, 0, 1, eps);
  if (z_out) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < RT * D; idx += NT) {
      const int i = idx / D, c = idx % D;
      if (r0 + i < rows) z_out[(size_t)(r0 + i) * D + c] = As[i * lda + c];
    }
  }
  for (int c0 = 0; c0 < W3; c0 += CW) {
    load_rows<T>(Ws, ldw, w + c0, W3, D, D, CW);
    __syncthreads();
    Mma<T, false>::run(As, lda, Ws, ldw, Cs, ldc, RT, CW, D, false);
    __syncthreads();
    for (int idx = threadIdx.x; idx < RT * CW; idx += NT) {
      const int i = idx / CW, j = idx % CW, r = r0 + i;
      if (r < rows)
        qkv[(size_t)r * W3 + c0 + j] =
            from_f<T>(Cs[i * ldc + j] + to_f<T>(bias[c0 + j]));
    }
  }
}

// ---------------------------------------------------------------------------
// (b) multi-head attention (exact two-pass softmax) -> out-projection ->
//     y = x + gate(mod[2]) * proj, for one (batch element, q tile); the
//     grid is 1-D (blockIdx.x = b * q_tiles + q tile), so the batch is not
//     held to grid.y's 65535. If o_out is given, it also writes the merged
//     attention output o, the per-(row, head) row max m and row sum r
//     ((B*N, H) f32) and the projection proj.

template <typename T>
__global__ void __launch_bounds__(NT)
attn_proj_kernel(const T* __restrict__ qkv, const T* __restrict__ x,
                 const float* __restrict__ mod, const T* __restrict__ wproj,
                 const T* __restrict__ bproj, T* __restrict__ y, int N, int D,
                 int H, int L, int l, float qscale, T* __restrict__ o_out,
                 float* __restrict__ m_out, float* __restrict__ r_out,
                 T* __restrict__ proj_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int DH = D / H;
  const int ld = D + pad<T>();          // Qs, Ks, Vs, Wp
  const int lds = KT + PADF, lde = KT + pad<T>(), ldo = D + PADF;
  const int kv_rows = 2 * KT > D ? 2 * KT : D;
  unsigned char* p = smem;
  T* Qs = reinterpret_cast<T*>(p);      p += al128(QT * ld * sizeof(T));
  T* Ks = reinterpret_cast<T*>(p);      p += al128(kv_rows * ld * sizeof(T));
  T* Vs = Ks + KT * ld;
  T* Wp = Ks;                           // out-projection weights, after attn
  float* Ss = reinterpret_cast<float*>(p); p += al128(QT * lds * 4);
  T* Es = reinterpret_cast<T*>(p);      p += al128(QT * lde * sizeof(T));
  float* Os = reinterpret_cast<float*>(p); p += al128(QT * ldo * 4);
  float* Ms = reinterpret_cast<float*>(p); p += al128(QT * H * 4);
  float* Rs = reinterpret_cast<float*>(p);

  const int q_tiles = (N + QT - 1) / QT;
  const int b = blockIdx.x / q_tiles, q0 = (blockIdx.x % q_tiles) * QT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int W3 = 3 * D;
  const T* base = qkv + (size_t)b * N * W3;

  // q tile, scaled at input width (attention.py:265)
  for (int idx = threadIdx.x; idx < QT * D; idx += NT) {
    const int i = idx / D, c = idx % D, n = q0 + i;
    const float q = n < N ? to_f<T>(base[(size_t)n * W3 + c]) : 0.0f;
    Qs[i * ld + c] = from_f<T>(q * qscale);
  }
  for (int idx = threadIdx.x; idx < QT * H; idx += NT) {
    Ms[idx] = -INFINITY;
    Rs[idx] = 0.0f;
  }
  for (int idx = threadIdx.x; idx < QT * D; idx += NT)
    Os[(idx / D) * ldo + idx % D] = 0.0f;
  __syncthreads();

  // pass 1: the f32 row max of the scores, per head
  for (int k0 = 0; k0 < N; k0 += KT) {
    load_rows<T>(Ks, ld, base + (size_t)k0 * W3 + D, W3, KT, N - k0, D);
    __syncthreads();
    for (int h = 0; h < H; ++h) {
      Mma<T, true>::run(Qs + h * DH, ld, Ks + h * DH, ld, Ss, lds, QT, KT,
                        DH, false);
      __syncthreads();
      for (int i = warp; i < QT; i += NW) {
        float m = -INFINITY;
        for (int j = lane; j < KT; j += 32)
          if (k0 + j < N) m = fmaxf(m, Ss[i * lds + j]);
        m = warp_max(m);
        if (lane == 0) Ms[h * QT + i] = fmaxf(Ms[h * QT + i], m);
      }
      __syncthreads();
    }
  }

  // pass 2: e = T(exp(T(s - m))), r += f32(e), o += e @ v (f32)
  for (int k0 = 0; k0 < N; k0 += KT) {
    load_rows<T>(Ks, ld, base + (size_t)k0 * W3 + D, W3, KT, N - k0, D);
    load_rows<T>(Vs, ld, base + (size_t)k0 * W3 + 2 * D, W3, KT, N - k0, D);
    __syncthreads();
    for (int h = 0; h < H; ++h) {
      Mma<T, true>::run(Qs + h * DH, ld, Ks + h * DH, ld, Ss, lds, QT, KT,
                        DH, false);
      __syncthreads();
      for (int i = warp; i < QT; i += NW) {
        const float m = Ms[h * QT + i];
        float r = 0.0f;
        for (int j = lane; j < KT; j += 32) {
          float e = 0.0f;
          if (k0 + j < N) e = rnd<T>(expf(rnd<T>(Ss[i * lds + j] - m)));
          Es[i * lde + j] = from_f<T>(e);
          r += e;
        }
        r = warp_sum(r);
        if (lane == 0) Rs[h * QT + i] += r;
      }
      __syncthreads();
      Mma<T, false>::run(Es, lde, Vs + h * DH, ld, Os + h * DH, ldo, QT, DH,
                         KT, true);
      __syncthreads();
    }
  }

  // normalize after PV, cast (the merged-head attention output)
  for (int idx = threadIdx.x; idx < QT * D; idx += NT) {
    const int i = idx / D, c = idx % D, n = q0 + i;
    const T o = from_f<T>(Os[i * ldo + c] / Rs[(c / DH) * QT + i]);
    Qs[i * ld + c] = o;
    if (o_out && n < N) o_out[((size_t)b * N + n) * D + c] = o;
  }
  if (o_out)
    for (int idx = threadIdx.x; idx < QT * H; idx += NT) {
      const int i = idx / H, h = idx % H, n = q0 + i;
      if (n < N) {
        m_out[((size_t)b * N + n) * H + h] = Ms[h * QT + i];
        r_out[((size_t)b * N + n) * H + h] = Rs[h * QT + i];
      }
    }
  load_rows<T>(Wp, ld, wproj, D, D, D, D);
  __syncthreads();
  Mma<T, false>::run(Qs, ld, Wp, ld, Os, ldo, QT, D, D, false);
  __syncthreads();
  const float* gate = mod + ((size_t)(b * L + l) * 6 + 2) * D;
  for (int idx = threadIdx.x; idx < QT * D; idx += NT) {
    const int i = idx / D, c = idx % D, n = q0 + i;
    if (n < N) {
      const size_t o = ((size_t)b * N + n) * D + c;
      const float pr = rnd<T>(Os[i * ldo + c] + to_f<T>(bproj[c]));
      if (proj_out) proj_out[o] = from_f<T>(pr);
      y[o] = from_f<T>(to_f<T>(x[o]) + rnd<T>(rnd<T>(gate[c]) * pr));
    }
  }
}

// ---------------------------------------------------------------------------
// (c) LN -> modulate(mod[3], mod[4]) -> fc1 -> tanh-GELU -> fc2 ->
//     y = x + gate(mod[5]) * h2

__device__ __forceinline__ float gelu_tanh(float v) {
  const float k = 0.7978845608028654f;  // sqrt(2/pi)
  return 0.5f * v * (1.0f + tanhf(k * (v + 0.044715f * v * v * v)));
}

template <typename T>
__global__ void __launch_bounds__(NT)
mlp_kernel(const T* __restrict__ x, const float* __restrict__ mod,
           const T* __restrict__ w1, const T* __restrict__ b1,
           const T* __restrict__ w2, const T* __restrict__ b2,
           T* __restrict__ y, int rows, int N, int D, int hidden, int L,
           int l, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = D + pad<T>(), ldh = hidden + pad<T>();
  const int ldw = CW + pad<T>(), ldc = CW + PADF;
  unsigned char* p = smem;
  T* As = reinterpret_cast<T*>(p);  p += al128(RT * lda * sizeof(T));
  T* Hs = reinterpret_cast<T*>(p);  p += al128(RT * ldh * sizeof(T));
  T* Ws = reinterpret_cast<T*>(p);
  p += al128((D > hidden ? D : hidden) * ldw * sizeof(T));
  float* Cs = reinterpret_cast<float*>(p);
  const int r0 = blockIdx.x * RT;

  modln_rows<T>(x, mod, As, lda, r0, rows, N, D, L, l, 3, 4, eps);
  for (int c0 = 0; c0 < hidden; c0 += CW) {
    load_rows<T>(Ws, ldw, w1 + c0, hidden, D, D, CW);
    __syncthreads();
    Mma<T, false>::run(As, lda, Ws, ldw, Cs, ldc, RT, CW, D, false);
    __syncthreads();
    for (int idx = threadIdx.x; idx < RT * CW; idx += NT) {
      const int i = idx / CW, j = idx % CW;
      Hs[i * ldh + c0 + j] = from_f<T>(
          gelu_tanh(rnd<T>(Cs[i * ldc + j] + to_f<T>(b1[c0 + j]))));
    }
  }
  for (int c0 = 0; c0 < D; c0 += CW) {
    load_rows<T>(Ws, ldw, w2 + c0, D, hidden, hidden, CW);
    __syncthreads();
    Mma<T, false>::run(Hs, ldh, Ws, ldw, Cs, ldc, RT, CW, hidden, false);
    __syncthreads();
    for (int idx = threadIdx.x; idx < RT * CW; idx += NT) {
      const int i = idx / CW, j = idx % CW, r = r0 + i;
      if (r < rows) {
        const int b = r / N, c = c0 + j;
        const size_t o = (size_t)r * D + c;
        const float g = rnd<T>(mod[((size_t)(b * L + l) * 6 + 5) * D + c]);
        const float h2 = rnd<T>(Cs[i * ldc + j] + to_f<T>(b2[c]));
        y[o] = from_f<T>(to_f<T>(x[o]) + rnd<T>(g * h2));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Per-element sums of per-tile partials, in a fixed order (no atomics, so
// runs repeat bit for bit): dmod[b][j] = sum over t of part[b * tiles + t][j]
// for j < W (W = 6*D adaLN rows in the block backward, 2*D or 3*D in
// mod_ln), written in O (f32, or bf16 rounded once from the f32 total).

template <typename O>
__global__ void dmod_reduce_kernel(const float* __restrict__ part, int B,
                                   int tiles, int W, O* __restrict__ dmod) {
  const size_t n = (size_t)B * W;
  for (size_t e = (size_t)blockIdx.x * NT + threadIdx.x; e < n;
       e += (size_t)gridDim.x * NT) {
    const size_t b = e / W, j = e % W;
    float s = 0.0f;
    for (int t = 0; t < tiles; ++t) s += part[(b * tiles + t) * W + j];
    dmod[e] = from_f<O>(s);
  }
}

template <typename O>
inline void launch_dmod_reduce(const float* part, int B, int tiles, int W,
                               O* dmod, cudaStream_t st) {
  const size_t blocks = ((size_t)B * W + NT - 1) / NT;
  dmod_reduce_kernel<<<(unsigned)(blocks < 65535 ? blocks : 65535), NT, 0,
                       st>>>(part, B, tiles, W, dmod);
}

}  // namespace
