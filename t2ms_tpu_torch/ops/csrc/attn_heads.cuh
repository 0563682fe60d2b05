// Per-head attention device code shared by dit_split.cu (the split block's
// attention) and fused_heads.cu (fused_heads_attention, its stats variant
// fused_heads_attention_with_stats, and their backwards).
//
// Operands are on the natural (B, N, H*DH) layout, head h the columns
// [h*DH, (h+1)*DH). Each of q, k, v (and, in the backward, g) is read
// through its own batch and row strides in elements, so the column slices
// of one qkv projection are read in place. Rows and strides must be 16-byte
// aligned (the wrappers check it); rows past N load as zero and stay out of
// every sum.

#pragma once

#include "dit_common.cuh"

namespace {

// O[R x DH] += A[R x R] @ V[R x DH] with A row-major (lda) or, with A_T,
// stored transposed (A[m][k] at A[k * lda + m]). bf16 keeps O in registers
// (R = 64: each warp 16 rows x DH/2 columns); f32 accumulates in the shared
// tile O with FMA loops.
template <typename T, int DH, int R = QT, bool A_T = false> struct PvAcc;

template <int DH, int R, bool A_T> struct PvAcc<__nv_bfloat16, DH, R, A_T> {
  static_assert(R == 64, "eight warps cover 64 rows in 16-row groups");
  static constexpr int F = DH / 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[F];
  __device__ void zero(float*, int) {
#pragma unroll
    for (int j = 0; j < F; ++j) wmma::fill_fragment(c[j], 0.0f);
  }
  __device__ void mma(const __nv_bfloat16* E, int lde,
                      const __nv_bfloat16* V, int ldv, float*, int) {
    const int w = threadIdx.x / 32, rb = (w % 4) * 16, cb = (w / 4) * (DH / 2);
#pragma unroll
    for (int k = 0; k < R; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     typename Layout<A_T>::type> a;
      wmma::load_matrix_sync(a, A_T ? E + k * lde + rb : E + rb * lde + k,
                             lde);
#pragma unroll
      for (int j = 0; j < F; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> b;
        wmma::load_matrix_sync(b, V + k * ldv + cb + j * 16, ldv);
        wmma::mma_sync(c[j], a, b, c[j]);
      }
    }
  }
  __device__ void store(float* O, int ldo) {
    const int w = threadIdx.x / 32, rb = (w % 4) * 16, cb = (w / 4) * (DH / 2);
#pragma unroll
    for (int j = 0; j < F; ++j)
      wmma::store_matrix_sync(O + rb * ldo + cb + j * 16, c[j], ldo,
                              wmma::mem_row_major);
  }
};

template <int DH, int R, bool A_T> struct PvAcc<float, DH, R, A_T> {
  __device__ void zero(float* O, int ldo) {
    for (int idx = threadIdx.x; idx < R * DH; idx += NT)
      O[(idx / DH) * ldo + idx % DH] = 0.0f;
  }
  __device__ void mma(const float* E, int lde, const float* V, int ldv,
                      float* O, int ldo) {
    Mma<float, false, A_T>::run(E, lde, V, ldv, O, ldo, R, DH, R, true);
  }
  __device__ void store(float*, int) {}
};

// Qs[i][c] = T(q[n0 + i][c] * qscale) for i < valid, 0 below: the q tile
// scaled at input width (attention.py:265). qh points at head h's columns
// of the element's row 0; sn is the row stride.
template <typename T, int DH>
__device__ void load_q_scaled(T* Qs, int ld, const T* __restrict__ qh,
                              long long sn, int n0, int rows, int valid,
                              float qscale) {
  for (int idx = threadIdx.x; idx < rows * DH; idx += NT) {
    const int i = idx / DH, c = idx % DH;
    const float q = i < valid ? to_f<T>(qh[(size_t)(n0 + i) * sn + c]) : 0.0f;
    Qs[i * ld + c] = from_f<T>(q * qscale);
  }
}

// Shared memory of heads_attn_kernel: Q, K, V tiles of one head, f32
// scores, exp values, the f32 output tile, row max and row sum.
template <typename T>
__host__ __device__ size_t smem_heads_attn(int DH) {
  const int P = pad<T>();
  return al128(QT * (DH + P) * sizeof(T)) +
         2 * al128(KT * (DH + P) * sizeof(T)) + al128(QT * (KT + PADF) * 4) +
         al128(QT * (KT + P) * sizeof(T)) + al128(QT * (DH + PADF) * 4) +
         2 * al128(QT * 4);
}

// Attention for one (batch element, q tile, head): q scaled at input width,
// f32 scores, the exact row softmax in two passes over 64-row K tiles of the
// head (row max first; then e = T(exp(T(s - m))), f32 row sums, f32 PV),
// o = T(PV / rowsum) into head h's columns of the merged (B*N, HD) output;
// with a non-null lse, also each row's log-sum-exp m + log(rowsum) (f32,
// (B*N, H)), which leaves o as it is.
// The grid is 1-D with the q tile fastest, so the blocks of one (b, head)
// share its K/V in L2, and the batch is not held to grid.y's 65535.
template <typename T, int DH>
__global__ void __launch_bounds__(NT)
heads_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, long long sqb, long long sqn,
                  long long skb, long long skn, long long svb, long long svn,
                  T* __restrict__ o, int N, int HD, int H, float qscale,
                  float* __restrict__ lse) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ld = DH + pad<T>(), lds = KT + PADF, lde = KT + pad<T>();
  constexpr int ldo = DH + PADF;
  unsigned char* p = smem;
  T* Qs = reinterpret_cast<T*>(p);      p += al128(QT * ld * sizeof(T));
  T* Ks = reinterpret_cast<T*>(p);      p += al128(KT * ld * sizeof(T));
  T* Vs = reinterpret_cast<T*>(p);      p += al128(KT * ld * sizeof(T));
  float* Ss = reinterpret_cast<float*>(p); p += al128(QT * lds * 4);
  T* Es = reinterpret_cast<T*>(p);      p += al128(QT * lde * sizeof(T));
  float* Os = reinterpret_cast<float*>(p); p += al128(QT * ldo * 4);
  float* Ms = reinterpret_cast<float*>(p); p += al128(QT * 4);
  float* Rs = reinterpret_cast<float*>(p);

  const int q_tiles = (N + QT - 1) / QT;
  const int q0 = (blockIdx.x % q_tiles) * QT;
  const int h = (blockIdx.x / q_tiles) % H, b = blockIdx.x / (q_tiles * H);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* qh = q + (size_t)b * sqb + h * DH;
  const T* kh = k + (size_t)b * skb + h * DH;
  const T* vh = v + (size_t)b * svb + h * DH;

  load_q_scaled<T, DH>(Qs, ld, qh, sqn, q0, QT, min(QT, N - q0), qscale);
  if (threadIdx.x < QT) {
    Ms[threadIdx.x] = -INFINITY;
    Rs[threadIdx.x] = 0.0f;
  }
  PvAcc<T, DH> acc;
  acc.zero(Os, ldo);
  __syncthreads();

  // pass 1: the f32 row max of the scores
  for (int k0 = 0; k0 < N; k0 += KT) {
    load_rows<T>(Ks, ld, kh + (size_t)k0 * skn, skn, KT, N - k0, DH);
    __syncthreads();
    Mma<T, true>::run(Qs, ld, Ks, ld, Ss, lds, QT, KT, DH, false);
    __syncthreads();
    for (int i = warp; i < QT; i += NW) {
      float m = -INFINITY;
      for (int j = lane; j < KT; j += 32)
        if (k0 + j < N) m = fmaxf(m, Ss[i * lds + j]);
      m = warp_max(m);
      if (lane == 0) Ms[i] = fmaxf(Ms[i], m);
    }
    __syncthreads();
  }

  // pass 2: e = T(exp(T(s - m))), r += f32(e), O += e @ v (f32)
  for (int k0 = 0; k0 < N; k0 += KT) {
    load_rows<T>(Ks, ld, kh + (size_t)k0 * skn, skn, KT, N - k0, DH);
    load_rows<T>(Vs, ld, vh + (size_t)k0 * svn, svn, KT, N - k0, DH);
    __syncthreads();
    Mma<T, true>::run(Qs, ld, Ks, ld, Ss, lds, QT, KT, DH, false);
    __syncthreads();
    for (int i = warp; i < QT; i += NW) {
      const float m = Ms[i];
      float r = 0.0f;
      for (int j = lane; j < KT; j += 32) {
        float e = 0.0f;
        if (k0 + j < N) e = rnd<T>(expf(rnd<T>(Ss[i * lds + j] - m)));
        Es[i * lde + j] = from_f<T>(e);
        r += e;
      }
      r = warp_sum(r);
      if (lane == 0) Rs[i] += r;
    }
    __syncthreads();
    acc.mma(Es, lde, Vs, ld, Os, ldo);
    __syncthreads();
  }

  // normalise after PV, cast, into head h's columns of the merged output
  acc.store(Os, ldo);
  __syncthreads();
  for (int idx = threadIdx.x; idx < QT * DH; idx += NT) {
    const int i = idx / DH, c = idx % DH, n = q0 + i;
    if (n < N)
      o[((size_t)b * N + n) * HD + h * DH + c] =
          from_f<T>(Os[i * ldo + c] / Rs[i]);
  }
  if (lse != nullptr)
    for (int i = threadIdx.x; i < QT && q0 + i < N; i += NT)
      lse[((size_t)b * N + q0 + i) * H + h] = Ms[i] + logf(Rs[i]);
}

template <typename T, int DH>
cudaError_t launch_heads_attn_dh(const T* q, const T* k, const T* v,
                                 long long sqb, long long sqn, long long skb,
                                 long long skn, long long svb, long long svn,
                                 T* o, int B, int N, int HD, int H,
                                 float qscale, cudaStream_t st, float* lse) {
  const size_t s = smem_heads_attn<T>(DH);
  const cudaError_t e = set_smem((const void*)heads_attn_kernel<T, DH>, s);
  if (e != cudaSuccess) return e;
  const int blocks = B * ((N + QT - 1) / QT) * H;
  heads_attn_kernel<T, DH><<<blocks, NT, s, st>>>(q, k, v, sqb, sqn, skb, skn,
                                                  svb, svn, o, N, HD, H,
                                                  qscale, lse);
  return cudaGetLastError();
}

// The attention of every (element, q tile, head); the caller has checked
// the head width (32, 64 or 128) and that B * q tiles * H fits an int. lse,
// when given, receives the rows' log-sum-exp (fused_heads_forward_stats).
template <typename T>
cudaError_t launch_heads_attn(const T* q, const T* k, const T* v,
                              long long sqb, long long sqn, long long skb,
                              long long skn, long long svb, long long svn,
                              T* o, int B, int N, int HD, int H, float qscale,
                              cudaStream_t st, float* lse = nullptr) {
  switch (HD / H) {
    case 32:
      return launch_heads_attn_dh<T, 32>(q, k, v, sqb, sqn, skb, skn, svb,
                                         svn, o, B, N, HD, H, qscale, st, lse);
    case 64:
      return launch_heads_attn_dh<T, 64>(q, k, v, sqb, sqn, skb, skn, svb,
                                         svn, o, B, N, HD, H, qscale, st, lse);
    default:
      return launch_heads_attn_dh<T, 128>(q, k, v, sqb, sqn, skb, skn, svb,
                                          svn, o, B, N, HD, H, qscale, st,
                                          lse);
  }
}

}  // namespace
