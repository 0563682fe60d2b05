// Per-head attention device code shared by dit_split.cu (the split block's
// attention), dit_layer.cuh (the attention stage of the stack and block
// kernels, and of the block backward's recompute) and fused_heads.cu
// (fused_heads_attention, its stats variant
// fused_heads_attention_with_stats, and their backwards in heads_bwd.cuh):
// the forward kernels and the tensor-core primitives both directions use.
// split_heads.cu (the head-split kernels) and dit_layer.cuh's row GEMMs use
// the primitives too.
//
// Operands are on the natural (B, N, H*DH) layout, head h the columns
// [h*DH, (h+1)*DH). Each of q, k, v (and, in the backward, g) is read
// through its own batch and row strides in elements, so the column slices
// of one qkv projection are read in place. Rows and strides must be 16-byte
// aligned (the wrappers check it); rows past N load as zero and stay out of
// every sum.
//
// The forward computes, per (element, head, q row): qs = T(q * qscale),
// s = qs k^T in f32, m = the row max, e = T(exp(T(s - m))), r = sum f32(e),
// o = T((e v in f32) / r) and, with an lse pointer, lse = m + log(r) in f32
// (o untouched); T() rounds to the input type. The bf16 kernel can also
// write m and r themselves (f32, (B*N, H)), which the DiT block backward
// rebuilds p from (dit_layer.cuh); every other caller passes null. The row
// max is a pass of its own, since e needs the row's final m (an online
// rescaling would round elsewhere), so the kernel runs three N x N x DH
// products where the function needs two.
//
// bf16: heads_fwd_kernel, one block per (element, 64 q rows, head), 4 warps
// of 16 q rows, on mma.sync m16n8k16 tiles (bf16 in, f32 sums). Bound on an
// H100 SXM (989 TFLOP/s bf16, 3.35 TB/s) at the scaled train step's call
// (B=64, N=1024, 8 heads of 64): the two products are 137.4 GFLOP, 0.139 ms,
// against 268 MB, 0.080 ms, so operations bound it; the exponentials
// (N^2 per head, about a dozen instructions each with expf) come next.
// What the design does about it:
// - scores stay in registers: S is the mma accumulator; the row max is
//   taken over the quad of lanes that holds a row; e is formed in the
//   accumulator layout, rounded in pairs and packed to bf16x2, which is the
//   A layout of the next product, so O = e V runs on registers (V through
//   ldmatrix.trans). No f32 score tile or exp tile in shared memory.
// - K and V come in through a cp.async ring of 64-row stages (three at
//   head width 32, two at 64 and 128), zero past N; the next tiles land
//   while the current one is multiplied, and one __syncthreads a tile
//   guards the ring.
// - registers are cut so that four blocks (16 warps) share an SM at head
//   width 64, five at 32 and 16 and two at 128, with no spills.
// - q comes in once, is scaled to T(q * qscale) on its ldmatrix fragments
//   with one bf16x2 multiply (the single rounding of load_q_scaled) and is
//   held in registers up to head width 64.
// - the row max (pass 1) and e and r (pass 2) are the device functions the
//   backward's q-tile kernel calls, so the forward's e is the backward's.
// - the blocks of one (element, head) are adjacent in the grid and share
//   its K and V in L2.
// f32: heads_attn_kernel, the earlier FMA-loop kernel (8 warps, scores
// through shared memory), which the CPU-twin checks hold tight; no timed
// path runs it.

#pragma once

#include "dit_common.cuh"

namespace {

// ------------------------------------------------- f32: the FMA-loop forward

// O[R x DH] += A[R x R] @ V[R x DH] in f32 FMA loops on the shared tile O,
// with A row-major (lda) or, with A_T, stored transposed (A[m][k] at
// A[k * lda + m]); the f32 kernels' only product into an accumulator.
template <typename T, int DH, int R = QT, bool A_T = false> struct PvAcc;

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

// Shared memory of the f32 heads_attn_kernel: Q, K, V tiles of one head,
// f32 scores, exp values, the f32 output tile, row max and row sum.
__host__ __device__ inline size_t smem_attn_f32(int DH) {
  const int P = pad<float>();
  return al128(QT * (DH + P) * 4) + 2 * al128(KT * (DH + P) * 4) +
         al128(QT * (KT + PADF) * 4) + al128(QT * (KT + P) * 4) +
         al128(QT * (DH + PADF) * 4) + 2 * al128(QT * 4);
}

// Attention for one (batch element, q tile, head) in f32: q scaled, f32
// scores, the exact row softmax in two passes over 64-row K tiles of the
// head (row max first; then e = exp(s - m), row sums, PV),
// o = PV / rowsum into head h's columns of the merged (B*N, HD) output;
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

// ------------------------------------- bf16: tensor-core tiles, both ways

using bf16 = __nv_bfloat16;

constexpr int TC_NT = 128;  // threads per block: 4 warps of 16 rows
constexpr int TC_R = 64;    // rows of a block's own tile, k rows a step

// Block -> (element b, tile, head h), the tile fastest, so the blocks of
// one (element, head) run together and share its operands in L2
struct Place {
  int b, t0, h;
};
__device__ Place place(int N, int H, int R) {
  const int tiles = (N + R - 1) / R;
  return Place{(int)(blockIdx.x / (tiles * H)), (int)(blockIdx.x % tiles) * R,
               (int)(blockIdx.x / tiles) % H};
}

// bytes of a padded bf16 tile (rows of DH + 8 values: the 16 bytes a row
// put ldmatrix's eight row addresses on distinct banks)
__host__ __device__ constexpr size_t tc_tile(int rows, int DH) {
  return (size_t)rows * (DH + 8) * 2;
}

// ------------------------------------------------ PTX: copies and products

__device__ __forceinline__ uint32_t sm_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 (or 4) bytes from device to shared memory, asynchronously; zeros when
// !ok (src is then not read)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   sm_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   sm_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(sm_addr(p)));
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(sm_addr(p)));
}

// c[16 x 8] += a[16 x 16] b[16 x 8], bf16 operands, f32 sums. Thread
// (group gr = lane / 4, tq = lane % 4) holds c[gr][2tq, 2tq+1] in c[0..1]
// and c[gr+8][2tq, 2tq+1] in c[2..3].
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// T(x * s) for two bf16 values, one rounding of the exact product, as
// from_f(to_f(x) * s) with s a bf16 value
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t x, uint32_t s) {
  const __nv_bfloat162 v = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&x),
                                   *reinterpret_cast<const __nv_bfloat162*>(&s));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A fragment: rows r0..r0+15, columns c0..c0+15 of a row-major tile
__device__ __forceinline__ void ld_a(uint32_t (&a)[4], const bf16* t, int ld,
                                     int r0, int c0) {
  const int l = threadIdx.x & 31;
  ldsm4(a, t + (r0 + (l & 15)) * ld + c0 + (l >> 4) * 8);
}
// B fragments {b0, b1} of the n8 tiles n0 and n0 + 8 over k0..k0+15, with
// B(k, n) = t[n][k] (the tile's rows are the product's columns)
__device__ __forceinline__ void ld_b(uint32_t (&b)[4], const bf16* t, int ld,
                                     int n0, int k0) {
  const int l = threadIdx.x & 31;
  ldsm4(b, t + (n0 + (l & 7) + ((l >> 4) << 3)) * ld + k0 + ((l >> 3) & 1) * 8);
}
// the same with B(k, n) = t[k][n] (the tile read k-major, transposed)
__device__ __forceinline__ void ld_bt(uint32_t (&b)[4], const bf16* t, int ld,
                                      int k0, int n0) {
  const int l = threadIdx.x & 31;
  ldsm4t(b, t + (k0 + (l & 7) + ((l >> 3) & 1) * 8) * ld + n0 + (l >> 4) * 8);
}

// rows [0, ROWS) of a head slice (row stride sn) into a padded tile,
// asynchronously, by a block of NTH threads; rows from `valid` on are zeros
template <int ROWS, int DH, int NTH = TC_NT>
__device__ __forceinline__ void cp_tile(bf16* dst, const bf16* src,
                                        long long sn, int valid) {
  constexpr int CH = DH / 8, LD = DH + 8;
  if constexpr (ROWS * CH % NTH == 0) {
#pragma unroll
    for (int u = 0; u < ROWS * CH / NTH; ++u) {
      const int idx = u * NTH + threadIdx.x, r = idx / CH, c = idx % CH * 8;
      const bool ok = r < valid;
      cp16(dst + r * LD + c, src + (size_t)(ok ? r : 0) * sn + c, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * CH; idx += NTH) {
      const int r = idx / CH, c = idx % CH * 8;
      const bool ok = r < valid;
      cp16(dst + r * LD + c, src + (size_t)(ok ? r : 0) * sn + c, ok);
    }
  }
}

// The A fragments of a warp's 16 rows of a fixed [rows][DH] tile, each
// optionally scaled by a bf16 pair: held in registers up to head width 64,
// read again at each use at 128 (which keeps the sums in registers).
template <int DH, bool SCALED> struct RowFrags {
  static constexpr bool REGS = DH <= 64;
  uint32_t f[REGS ? DH / 16 : 1][4];
  const bf16* t;
  int r0;
  uint32_t s2;
  __device__ __forceinline__ void load(uint32_t (&a)[4], int kk) const {
    ld_a(a, t, DH + 8, r0, kk * 16);
    if (SCALED) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = mul_bf16x2(a[i], s2);
    }
  }
  __device__ __forceinline__ void init(const bf16* tile, int row0,
                                       uint32_t scale2) {
    t = tile;
    r0 = row0;
    s2 = scale2;
    if constexpr (REGS) {
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) load(f[kk], kk);
    }
  }
  __device__ __forceinline__ void get(uint32_t (&a)[4], int kk) const {
    if constexpr (REGS) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = f[kk][i];
    } else {
      load(a, kk);
    }
  }
};

// acc[16 x 8 NT] += A[16 x DH] B, B(c, n) = t[n][c] for the NT * 8 rows of
// tile t, its B fragments scaled by the bf16 pair s2 when SB
template <int DH, int NT, bool SA, bool SB>
__device__ __forceinline__ void rows_by_tile(float (&acc)[NT][4],
                                             const RowFrags<DH, SA>& A,
                                             const bf16* t, uint32_t s2) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    uint32_t a[4];
    A.get(a, kk);
#pragma unroll
    for (int p = 0; p < NT / 2; ++p) {
      uint32_t b[4];
      ld_b(b, t, DH + 8, 16 * p, 16 * kk);
      if (SB) {
#pragma unroll
        for (int i = 0; i < 4; ++i) b[i] = mul_bf16x2(b[i], s2);
      }
      mma16816(acc[2 * p], a, b[0], b[1]);
      mma16816(acc[2 * p + 1], a, b[2], b[3]);
    }
  }
}

// acc[16 x DH] += P[16 x 16 KK] t[16 KK x DH], P given as KK A fragments,
// t's B fragments scaled by the bf16 pair s2 when SB
template <int DH, int KK, bool SB = false>
__device__ __forceinline__ void frags_by_tile(float (&acc)[DH / 8][4],
                                              const uint32_t (&P)[KK][4],
                                              const bf16* t,
                                              uint32_t s2 = 0u) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
    for (int p = 0; p < DH / 16; ++p) {
      uint32_t b[4];
      ld_bt(b, t, DH + 8, 16 * kk, 16 * p);
      if (SB) {
#pragma unroll
        for (int i = 0; i < 4; ++i) b[i] = mul_bf16x2(b[i], s2);
      }
      mma16816(acc[2 * p], P[kk], b[0], b[1]);
      mma16816(acc[2 * p + 1], P[kk], b[2], b[3]);
    }
  }
}

// T(acc * (row's factor)) for a warp's 16 rows into rows [0, 16) of the
// padded tile O, then rows n0 + r < N out to dst (row stride HD), 16 bytes
// a lane
template <int DH>
__device__ __forceinline__ void store_rows(const float (&acc)[DH / 8][4],
                                           float f0, float f1, bf16* O,
                                           bf16* dst, int HD, int rows) {
  constexpr int LD = DH + 8, CH = DH / 8;
  const int lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt) {
    const int c = 8 * nt + 2 * tq;
    *reinterpret_cast<uint32_t*>(O + gr * LD + c) =
        pack_bf16(acc[nt][0] * f0, acc[nt][1] * f0);
    *reinterpret_cast<uint32_t*>(O + (gr + 8) * LD + c) =
        pack_bf16(acc[nt][2] * f1, acc[nt][3] * f1);
  }
  __syncwarp();
  for (int idx = lane; idx < 16 * CH; idx += 32) {
    const int r = idx / CH, c = idx % CH * 8;
    if (r < rows)
      *reinterpret_cast<uint4*>(dst + (size_t)r * HD + c) =
          *reinterpret_cast<const uint4*>(O + r * LD + c);
  }
}

__device__ __forceinline__ uint32_t bf16_pair(float s) {
  return pack_bf16(s, s);
}

// T(a) and T(b) into ra and rb, and their bf16 pair: one paired conversion
// and two integer operations (the same round to nearest even as rnd<bf16>)
__device__ __forceinline__ uint32_t round2(float a, float b, float& ra,
                                           float& rb) {
  const uint32_t u = pack_bf16(a, b);
  ra = __uint_as_float(u << 16);
  rb = __uint_as_float(u & 0xffff0000u);
  return u;
}

// e = T(exp(T(s - m))) for two scores (e0, e1), and their bf16 pair
__device__ __forceinline__ uint32_t exp_rounded2(float s0, float s1, float m0,
                                                 float m1, float& e0,
                                                 float& e1) {
  float x0, x1;
  round2(s0 - m0, s1 - m1, x0, x1);
  return round2(expf(x0), expf(x1), e0, e1);
}

// ---------------------------------- the softmax on a warp's 16 x 64 scores
// (rows gr and gr + 8 of the warp's 16, index 0 and 1 below; thread tq
// holds columns 8 nt + 2 tq and + 1 of each n8 tile nt)

// s = T(q * qscale) K^T for the 64 k rows of tile Ks at k0, with the
// columns past N at -inf, so that exp takes them to 0
template <int DH>
__device__ __forceinline__ void score_tile(float (&s)[8][4],
                                           const RowFrags<DH, true>& qf,
                                           const bf16* Ks, int k0, int N) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
  rows_by_tile<DH, 8, true, false>(s, qf, Ks, 0u);
  if (k0 + TC_R > N) {
    const int tq = threadIdx.x & 3;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + 8 * nt + 2 * tq + (e & 1) >= N) s[nt][e] = -INFINITY;
    }
  }
}

// pass 1: m = max(m, the thread's scores of each of its two rows)
__device__ __forceinline__ void row_max(const float (&s)[8][4],
                                        float (&m)[2]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], s[nt][e]);
  }
}

// the max and the sum of x over the quad of lanes that holds a row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// pass 2: e = T(exp(T(s - m))) in the accumulator layout, packed in pairs
// into P, the bf16 A fragments of e for a product over these 64 columns;
// r[h] += f32(e) pair by pair, and each pair also goes to f(nt, h, e0, e1)
template <typename F>
__device__ __forceinline__ void exp_rows(const float (&s)[8][4],
                                         const float (&m)[2], float (&r)[2],
                                         uint32_t (&P)[4][4], F&& f) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float e0, e1;
      P[nt / 2][(nt & 1) * 2 + h] =
          exp_rounded2(s[nt][2 * h], s[nt][2 * h + 1], m[h], m[h], e0, e1);
      r[h] += e0;
      r[h] += e1;
      f(nt, h, e0, e1);
    }
  }
}

// ----------------------------------------------------- the bf16 forward

// stages of the K/V ring: three at head width 32, two at 64 and 128,
// where a third would keep one block off each SM (four blocks of two
// stages fit in shared memory at 64, three of three; two at 128)
__host__ __device__ constexpr int fwd_stages(int DH) {
  return DH == 32 ? 3 : 2;
}
// blocks per SM the register budget is cut for: what the shared memory
// of fwd_stages lets in, up to five, as far as ptxas fits the sums
// without spills (H100, `-Xptxas -v`: 96 registers at 32, 128 at 64)
__host__ __device__ constexpr int fwd_min_blocks(int DH) {
  return DH == 128 ? 2 : DH == 64 ? 4 : 5;
}
// Shared memory of heads_fwd_kernel: the q tile and the ring's stages of
// [K | V]
__host__ __device__ constexpr size_t smem_fwd(int DH) {
  return (1 + 2 * fwd_stages(DH)) * tc_tile(TC_R, DH);
}

template <int DH>
__global__ void __launch_bounds__(TC_NT, fwd_min_blocks(DH))
    heads_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, long long sqb, long long sqn,
                     long long skb, long long skn, long long svb,
                     long long svn, bf16* __restrict__ o, int N, int HD,
                     int H, float qscale, float* __restrict__ lse,
                     float* __restrict__ m_out, float* __restrict__ r_out) {
  constexpr int LD = DH + 8, TILE = TC_R * LD, S = fwd_stages(DH);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qr = reinterpret_cast<bf16*>(smem);  // q, unscaled
  bf16* KV = Qr + TILE;                      // S stages of [K | V]

  const Place pl = place(N, H, TC_R);
  const int q0 = pl.t0;
  const int lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
  const int w0 = (threadIdx.x >> 5) * 16;
  const int nk = (N + TC_R - 1) / TC_R, total = 2 * nk;
  const bf16* kh = k + (size_t)pl.b * skb + pl.h * DH;
  const bf16* vh = v + (size_t)pl.b * svb + pl.h * DH;

  // the ring: iteration `it` is pass it / nk over k tile it % nk, in stage
  // it % S; the first pass needs no V. Every call commits a group (empty
  // past the last tile), so the wait below counts S - 2 younger ones.
  auto fetch = [&](int it) {
    if (it < total) {
      const int k0 = it % nk * TC_R;
      bf16* Ks = KV + it % S * 2 * TILE;
      cp_tile<TC_R, DH>(Ks, kh + (size_t)k0 * skn, skn, N - k0);
      if (it >= nk)
        cp_tile<TC_R, DH>(Ks + TILE, vh + (size_t)k0 * svn, svn, N - k0);
    }
    cp_commit();
  };
  cp_tile<TC_R, DH>(Qr, q + (size_t)pl.b * sqb + (size_t)q0 * sqn + pl.h * DH,
                    sqn, N - q0);
#pragma unroll
  for (int s = 0; s < S - 1; ++s) fetch(s);

  float m[2] = {-INFINITY, -INFINITY}, r[2] = {0.0f, 0.0f};
  float acc[DH / 8][4];
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
  RowFrags<DH, true> qf;  // T(q * qscale)

  for (int it = 0; it < total; ++it) {
    cp_wait<S - 2>();
    __syncthreads();  // tile `it` in; every warp done with tile it - 1
    fetch(it + S - 1);  // into the stage tile it - 1 used
    if (it == 0) qf.init(Qr, w0, bf16_pair(qscale));
    const int k0 = it % nk * TC_R;
    const bf16* Ks = KV + it % S * 2 * TILE;
    float s[8][4];
    score_tile<DH>(s, qf, Ks, k0, N);
    if (it < nk) {
      row_max(s, m);
      if (it == nk - 1) {
        m[0] = quad_max(m[0]);
        m[1] = quad_max(m[1]);
      }
    } else {
      uint32_t P[4][4];
      exp_rows(s, m, r, P, [](int, int, float, float) {});
      frags_by_tile<DH, 4>(acc, P, Ks + TILE);  // O += e V
    }
  }

  // o = T(O / r), staged through this warp's own rows of the q tile
#pragma unroll
  for (int i = 0; i < 2; ++i) r[i] = quad_sum(r[i]);
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt) {
    acc[nt][0] /= r[0];
    acc[nt][1] /= r[0];
    acc[nt][2] /= r[1];
    acc[nt][3] /= r[1];
  }
  store_rows<DH>(acc, 1.0f, 1.0f, Qr + w0 * LD,
                 o + ((size_t)pl.b * N + q0 + w0) * HD + pl.h * DH, HD,
                 N - q0 - w0);
  if (lse != nullptr && tq == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int n = q0 + w0 + gr + 8 * i;
      if (n < N) lse[((size_t)pl.b * N + n) * H + pl.h] = m[i] + logf(r[i]);
    }
  }
  if (m_out != nullptr && tq == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int n = q0 + w0 + gr + 8 * i;
      if (n < N) {
        m_out[((size_t)pl.b * N + n) * H + pl.h] = m[i];
        r_out[((size_t)pl.b * N + n) * H + pl.h] = r[i];
      }
    }
  }
}

// --------------------------------------------------------------- launches

// Shared memory of the forward for input type T at head width DH
template <typename T> __host__ __device__ size_t smem_heads_attn(int DH) {
  return sizeof(T) == 2 ? smem_fwd(DH) : smem_attn_f32(DH);
}

template <typename T, int DH>
cudaError_t launch_heads_attn_dh(const T* q, const T* k, const T* v,
                                 long long sqb, long long sqn, long long skb,
                                 long long skn, long long svb, long long svn,
                                 T* o, int B, int N, int HD, int H,
                                 float qscale, cudaStream_t st, float* lse) {
  const size_t s = smem_heads_attn<T>(DH);
  if constexpr (sizeof(T) == 2) {
    const cudaError_t e = set_smem((const void*)heads_fwd_kernel<DH>, s);
    if (e != cudaSuccess) return e;
    const int blocks = B * ((N + TC_R - 1) / TC_R) * H;
    heads_fwd_kernel<DH><<<blocks, TC_NT, s, st>>>(
        q, k, v, sqb, sqn, skb, skn, svb, svn, o, N, HD, H, qscale, lse,
        nullptr, nullptr);
  } else {
    const cudaError_t e = set_smem((const void*)heads_attn_kernel<T, DH>, s);
    if (e != cudaSuccess) return e;
    const int blocks = B * ((N + QT - 1) / QT) * H;
    heads_attn_kernel<T, DH><<<blocks, NT, s, st>>>(
        q, k, v, sqb, sqn, skb, skn, svb, svn, o, N, HD, H, qscale, lse);
  }
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
