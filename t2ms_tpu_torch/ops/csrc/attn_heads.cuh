// Per-head attention device code shared by dit_split.cu (the split block's
// attention), dit_layer.cuh (the attention stage of the stack and block
// kernels, and of the block backward's recompute) and fused_heads.cu
// (fused_heads_attention, its stats variant
// fused_heads_attention_with_stats, and their backwards in heads_bwd.cuh):
// the forward kernels and the tensor-core, wgmma, mbarrier and TMA
// primitives the port's attention kernels share. split_heads.cu (the
// head-split kernels), wg_gemm.cuh and dit_layer.cuh's row GEMMs use them
// too.
//
// Operands are on the natural (B, N, H*DH) layout, head h the columns
// [h*DH, (h+1)*DH). Each of q, k, v (and, in the backward, g) is read
// through its own batch and row strides in elements, so the column slices
// of one qkv projection are read in place. Rows and strides must be 16-byte
// aligned (the wrappers check it); rows past N load as zero and stay out of
// every sum.
//
// The forward computes, per (element, head, q row): qs = T(q * qscale),
// s = qs k^T in f32, m = the exact row max, e = T(exp(T(s - m))), r = sum
// f32(e), o = T((e v in f32) / r) and, with an lse pointer, lse = m +
// log(r) in f32 (o untouched); T() rounds to the input type. The bf16
// kernel can also write m and r themselves (f32, (B*N, H)), which the DiT
// block backward rebuilds p from (dit_layer.cuh); every other caller
// passes null. The row max is a pass of its own, since e needs the row's
// final m (an online rescaling would round T(s - m) against a running max,
// not JAX's point), so the kernel runs three N x N x DH products where the
// function needs two. The exponential is exp_rounded2's 2^(x log2 e) on
// the exponent unit (ex2.approx.ftz, relative error about 2^-22, results
// below 2^-126 flushed to zero) where JAX calls exp: a bf16 rounding of e
// flips now and then, a deliberate difference (ROADMAP.md C). The
// backward (heads_bwd.cuh) forms its e with the same function.
//
// bf16: heads_fwd_kernel<DH> (head widths 16, 32, 64, 128), one launch
// helper for every caller (launch_fwd_bf16: the grid, fwd_blocks, and the
// shared memory, smem_fwd). One block per (element, 128 q rows, head): two
// consumer warpgroups of 64 rows share each K/V tile, which halves the
// L2 traffic of K and V against 64-row blocks (measured: the largest
// single lever, PERF.md). Thread 0 brings 64-key tiles of K (pass 1) and
// of K and V (pass 2) in by TMA (a 4-d tensor map per operand, boxes of
// one head's 16-byte chunks x 64 rows that land chunk by chunk, which is
// wgmma's core-matrix layout without swizzle; rows past N zero-filled)
// into a ring of four stages, each completing on its own mbarrier; one
// __syncthreads a step guards the refill. Both products run on wgmma:
// S = Qs K^T as m64n64k16 with Qs in registers (read once, scaled on its
// fragments with one bf16x2 multiply) and K through a descriptor; e is
// packed from the S accumulators straight into register-A fragments and
// [e V | e 1] runs as m64n(DH+8)k16 with V transposed by descriptor and a
// chunk of ones beside V in each stage, so the product also yields each
// row's f32 sum r (no per-score add, no quad reduction). Each step starts
// the next iteration's q K^T before its own softmax and starts e V before
// the one wait that drains both, so no branch surrounds a wgmma and every
// wait is a full one (partial waits make ptxas serialise, C7512).
// Registers: 118 at head width 32 (two blocks an SM, 16 warps; at 128 a
// thread ptxas serialises the wgmma at 64), 142 at 64 and 190 at 128 (one
// block); no spills (H100, -Xptxas -v).
// Work a score takes on each pipe, pass 2 (cuobjdump -sass of the d=32
// instance: 96 MUFU.EX2, 105 F2FP, 100 FMUL, 102 FADD over three unrolled
// steps of 32 scores a thread): one MUFU.EX2, one F2FP (two roundings of a
// pair), one FMUL (x log2 e), one FADD (s - m), one integer unpack; pass 1
// one FMNMX. Bound on an H100 SXM at the flagship CFG call (2B=512, N=480,
// 4 heads of 32): the two products 0.061 ms, the bytes 0.075 ms, the
// exponent unit (16 a clock an SM, 4.2e12 a second) 0.113 ms, so at head
// widths 16 and 32 the exponent unit is the floor; at 64 the products and
// the exponentials weigh alike (0.139 and 0.128 ms at the scaled call), at
// 128 the products. Measured, the kernel sits near 4x its floor at 32,
// and timing it with the exponentials, the roundings or both taken out
// moved it by under 4%: per-step latency (the barrier, the wgmma and TMA
// waits), not a pipe, bounds it (PERF.md).
// f32: heads_attn_kernel, the earlier FMA-loop kernel (8 warps, scores
// through shared memory), which the CPU-twin checks hold tight; no timed
// path runs it.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

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

constexpr int TC_R = 64;  // keys a tile of the forward's and backward's rings

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
// 16 bytes from device to shared memory, asynchronously; zeros when
// !ok (src is then not read)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   sm_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 2^x on the exponent unit (MUFU.EX2, relative error about 2^-22); 2^-inf
// = +0, results below 2^-126 flushed to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
constexpr float LOG2E = 1.4426950408889634f;

// ------------------------------------------------------------- wgmma

// a shared-memory matrix descriptor, no swizzle: leading and stride byte
// offsets as wgmma reads them for the operand's major-ness
__device__ __forceinline__ uint64_t wg_desc(const void* p, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((sm_addr(p) & 0x3FFFF) >> 4) |
         (uint64_t)(lbo >> 4) << 16 | (uint64_t)(sbo >> 4) << 32;
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// the generic proxy's shared-memory writes (cp.async, plain stores) made
// visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from moving uses of an accumulator across a wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
  }
}

// d[64 x N] (+)= a[64 x 16] b[16 x N] for a warpgroup, a from registers
// (each warp's 16 rows in the mma16816 A layout), b through a descriptor,
// read transposed when TB; d in the mma16816 C layout per n8 tile. scale_d
// 0 overwrites d.
template <int N> struct WgMma;
template <> struct WgMma<16> {
  template <int TB>
  static __device__ __forceinline__ void run(float (&d)[2][4],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
          "n"(TB));
  }
};
template <> struct WgMma<32> {
  template <int TB>
  static __device__ __forceinline__ void run(float (&d)[4][4],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
          "n"(TB));
  }
};
template <> struct WgMma<64> {
  template <int TB>
  static __device__ __forceinline__ void run(float (&d)[8][4],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
        "%27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
          "n"(TB));
  }
};
template <> struct WgMma<128> {
  template <int TB>
  static __device__ __forceinline__ void run(float (&d)[16][4],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
        "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
        "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
          "n"(TB));
  }
};

// the products e [V | 1] of the forward (head width + 8)
template <> struct WgMma<24> {
  template <int TB>
  static __device__ __forceinline__ void run(float (&d)[3][4],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
        "{%12, %13, %14, %15}, %16, p, 1, 1, %18;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
          "n"(TB));
  }
};
template <> struct WgMma<40> {
  template <int TB>
  static __device__ __forceinline__ void run(float (&d)[5][4],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19}, "
        "{%20, %21, %22, %23}, %24, p, 1, 1, %26;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
          "n"(TB));
  }
};
template <> struct WgMma<72> {
  template <int TB>
  static __device__ __forceinline__ void run(float (&d)[9][4],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35}, "
        "{%36, %37, %38, %39}, %40, p, 1, 1, %42;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
          "n"(TB));
  }
};
template <> struct WgMma<136> {
  template <int TB>
  static __device__ __forceinline__ void run(float (&d)[17][4],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %73, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n136k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
        "%67}, "
        "{%68, %69, %70, %71}, %72, p, 1, 1, %74;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
          "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
          "n"(TB));
  }
};

// ----------------------------------------------- mbarriers and TMA, in PTX

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(sm_addr(b)),
               "r"(count));
}
// arrives on b and expects `bytes` more from copies that complete on it
__device__ __forceinline__ void mbar_expect(uint64_t* b, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          sm_addr(b)),
      "r"(bytes)
      : "memory");
}
// waits until the phase of parity `ph` of b has completed
__device__ __forceinline__ void mbar_wait(uint64_t* b, int ph) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(sm_addr(b)),
      "r"(ph)
      : "memory");
}
// the box of the 4-d map m at (c0, c1, c2, c3) into shared memory at dst,
// by the tensor memory accelerator; its bytes complete on b
__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* m,
                                          int c0, int c1, int c2, int c3,
                                          uint64_t* b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(sm_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(sm_addr(b))
      : "memory");
}

// cuTensorMapEncodeTiled, reached through the runtime's entry-point query
// (so the build needs only the toolkit's headers); null where it is missing
inline PFN_cuTensorMapEncodeTiled_v12000 tmap_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn)
               : nullptr;
  }();
  return encode;
}

// One operand (q, k, v, g) of every (element, head) on the natural (B, N,
// HD) layout (row stride sn, batch stride sb, in elements) for tma_load4:
// dimensions (the 8 columns of a 16-byte chunk, N rows, HD / 8 chunks, B),
// boxes of `rows` rows (64 unless given) x one head's DH / 8 chunks. A box
// lands chunk by chunk, each chunk's rows of 16 bytes contiguous: wgmma's
// core matrices without swizzle (fwd_kt, fwd_vt; the backward's desc_k,
// desc_t), rows past N zero. False when the encoder is missing or refuses.
inline bool make_heads_map(CUtensorMap* m, const bf16* p, int B, int N,
                           int HD, int DH, long long sb, long long sn,
                           int rows = TC_R) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tmap_encoder();
  if (!encode) return false;
  const cuuint64_t dims[4] = {8, (cuuint64_t)N, (cuuint64_t)HD / 8,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sn * 2, 16, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {8, (cuuint32_t)rows, (cuuint32_t)DH / 8, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(p),
                dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Descriptors of such a tile of 64 keys: 16-byte chunk c of key r at c *
// 1024 + r * 16 bytes. K is read K-major for q K^T (16 columns a step kk:
// chunks 1024 bytes apart, key groups 128), V MN-major, transposed, for
// e V (16 keys a step kk: key groups 128 bytes apart, chunks 1024).
__device__ __forceinline__ uint64_t fwd_kt(const bf16* Ks, int kk) {
  return wg_desc(Ks + kk * 1024, 1024, 128);
}
__device__ __forceinline__ uint64_t fwd_vt(const bf16* Vs, int kk) {
  return wg_desc(Vs + kk * 128, 128, 1024);
}

// ------------------------------------------- ldmatrix and mma.sync

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
template <int ROWS, int DH, int NTH>
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

// acc[16 x DH] += P[16 x 16 KK] t[16 KK x DH], P given as KK A fragments
template <int DH, int KK>
__device__ __forceinline__ void frags_by_tile(float (&acc)[DH / 8][4],
                                              const uint32_t (&P)[KK][4],
                                              const bf16* t) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
    for (int p = 0; p < DH / 16; ++p) {
      uint32_t b[4];
      ld_bt(b, t, DH + 8, 16 * kk, 16 * p);
      mma16816(acc[2 * p], P[kk], b[0], b[1]);
      mma16816(acc[2 * p + 1], P[kk], b[2], b[3]);
    }
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

// e = T(exp(T(s - m))) for two scores (e0, e1), and their bf16 pair; the
// exponential is 2^(x log2(e)), one FMUL and one MUFU.EX2 (the one formula
// of both directions: the forward's and the backward's e)
__device__ __forceinline__ uint32_t exp_rounded2(float s0, float s1, float m0,
                                                 float m1, float& e0,
                                                 float& e1) {
  float x0, x1;
  round2(s0 - m0, s1 - m1, x0, x1);
  return round2(ex2(x0 * LOG2E), ex2(x1 * LOG2E), e0, e1);
}

// ---------------------------------- the softmax on a warp's 16 x 64 scores
// (rows gr and gr + 8 of the warp's 16, index 0 and 1 below; thread tq
// holds columns 8 nt + 2 tq and + 1 of each n8 tile nt)

// in the tile at k0 that crosses N, the keys at or past N to -inf, so that
// exp takes them to 0
__device__ __forceinline__ void mask_tile(float (&s)[8][4], int k0, int N) {
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

// e = T(exp(T(s - m))) in the accumulator layout, packed in pairs into P,
// the bf16 A fragments of e for a product over these 64 columns (the
// forward's exp_rows, whose row sums come from the product)
__device__ __forceinline__ void exp_pack(const float (&s)[8][4],
                                         const float (&m)[2],
                                         uint32_t (&P)[4][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float e0, e1;
      P[nt / 2][(nt & 1) * 2 + h] =
          exp_rounded2(s[nt][2 * h], s[nt][2 * h + 1], m[h], m[h], e0, e1);
    }
  }
}

// ----------------------------------------------------- the bf16 forward

constexpr int FWD_WG = 2;             // consumer warpgroups of a block
constexpr int FWD_NT = FWD_WG * 128;  // its threads
constexpr int FWD_R = FWD_WG * 64;    // its q rows, 16 a warp
// stages of the K/V ring: a step reads tile it (V) and it + 1 (K) and
// refills tile it - 1's stage, so four stages keep two tiles in flight
constexpr int FWD_STAGES = 4;
// blocks per SM the register budget is cut for: two (128 registers a
// thread) up to head width 32, else one; at 128 registers ptxas serialises
// the wgmma at head width 64 (C7512)
__host__ __device__ constexpr int fwd_min_blocks(int DH) {
  return DH >= 64 ? 1 : 2;
}
// bytes of a ring stage: K's DH / 8 chunks and V's, and a chunk of ones
// beside V that makes its product carry the row sums
__host__ __device__ constexpr size_t fwd_stage(int DH) {
  return (size_t)(2 * (DH / 8) + 1) * 1024;
}
// Shared memory of heads_fwd_kernel: the ring's stages, their mbarriers and
// room to align the ring
__host__ __device__ constexpr size_t smem_fwd(int DH) {
  return FWD_STAGES * (fwd_stage(DH) + 8) + 128;
}
// blocks of the forward's grid, one per (element, 128 q rows, head); the
// callers check that it fits an int
__host__ __device__ constexpr long long fwd_blocks(int B, int N, int H) {
  return (long long)B * ((N + FWD_R - 1) / FWD_R) * H;
}

// The A fragments of q's 16 rows r0.. of a head slice (row stride sn),
// read from device memory straight into registers; rows at or past N zero
template <int DH>
__device__ __forceinline__ void load_q(uint32_t (&qa)[DH / 16][4],
                                       const bf16* __restrict__ qh,
                                       long long sn, int r0, int N) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
  const bool ok0 = r0 + gr < N, ok1 = r0 + gr + 8 < N;
  const bf16* p0 = qh + (size_t)(ok0 ? r0 + gr : 0) * sn + 2 * tq;
  const bf16* p1 = qh + (size_t)(ok1 ? r0 + gr + 8 : 0) * sn + 2 * tq;
  auto ld = [](const bf16* p, bool ok) {
    return ok ? *reinterpret_cast<const uint32_t*>(p) : 0u;
  };
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    qa[kk][0] = ld(p0 + 16 * kk, ok0);
    qa[kk][1] = ld(p1 + 16 * kk, ok1);
    qa[kk][2] = ld(p0 + 16 * kk + 8, ok0);
    qa[kk][3] = ld(p1 + 16 * kk + 8, ok1);
  }
}

// T(acc), or with DIV T(acc / l), for the warp's 16 rows r0.. below N, in
// pairs of 4 bytes through o's row stride
template <int DH, bool DIV, int NT8 = DH / 8>
__device__ __forceinline__ void store_o(const float (&acc)[NT8][4],
                                        const float (&l)[2], bf16* oh,
                                        long long sn, int r0, int N) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + gr + 8 * h;
    if (row >= N) continue;
#pragma unroll
    for (int nt = 0; nt < DH / 8; ++nt) {
      float x = acc[nt][2 * h], y = acc[nt][2 * h + 1];
      if (DIV) {
        x /= l[h];
        y /= l[h];
      }
      *reinterpret_cast<uint32_t*>(oh + (size_t)row * sn + 8 * nt + 2 * tq) =
          pack_bf16(x, y);
    }
  }
}

// One block per (element b, 128 q rows, head h), two warpgroups of 64 rows
// sharing each K/V tile. Iteration `it` of 2 nk is pass it / nk over k tile
// it % nk: pass 1 takes the row max, pass 2 forms e and adds [e V | e 1] to
// the sums, whose last n8 tile is each row's sum r (V's chunk of ones).
// Both products run on wgmma with q and e from registers, K and V through
// descriptors; thread 0 brings the tiles in by TMA into a ring of
// FWD_STAGES stages, each completing on its own mbarrier. Each step starts
// the next iteration's q K^T (the same product in both passes) before its
// own softmax, so that product runs on the tensor cores while this one's
// max or exponentials run; in pass 2 e V follows, waited for before the
// next step.
template <int DH>
__global__ void __launch_bounds__(FWD_NT, fwd_min_blocks(DH))
    heads_fwd_kernel(const bf16* __restrict__ q, long long sqb, long long sqn,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     bf16* __restrict__ o, int N, int HD, int H, float qscale,
                     float* __restrict__ lse, float* __restrict__ m_out,
                     float* __restrict__ r_out) {
  constexpr int CH = DH / 8, S = FWD_STAGES;
  constexpr int STAGE = (int)fwd_stage(DH) / 2, TILE = CH * 512;  // elements
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // TMA writes to 128-byte-aligned shared memory
  bf16* KV = reinterpret_cast<bf16*>(  // S stages of [K | V | ones]
      smem_raw + (-(uint32_t)sm_addr(smem_raw) & 127));
  uint64_t* full = reinterpret_cast<uint64_t*>(KV + S * STAGE);

  const Place pl = place(N, H, FWD_R);
  const int lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
  const int r0 = pl.t0 + (threadIdx.x >> 5) * 16;  // the warp's first row
  const int nk = (N + TC_R - 1) / TC_R, total = 2 * nk;
  const CUtensorMap *mk = &tk, *mv = &tv;

  auto stage = [&](int it) { return KV + it % S * STAGE; };
  // by thread 0: iteration it's K (and in pass 2 V) into its stage
  auto fetch = [&](int it) {
    if (it < total) {
      bf16* Ks = stage(it);
      const int k0 = it % nk * TC_R, c = pl.h * CH;
      mbar_expect(&full[it % S], (it < nk ? 2 : 4) * TILE);
      tma_load4(Ks, mk, 0, k0, c, pl.b, &full[it % S]);
      if (it >= nk) tma_load4(Ks + TILE, mv, 0, k0, c, pl.b, &full[it % S]);
    }
  };
  auto landed = [&](int it) { mbar_wait(&full[it % S], it / S & 1); };
  // s = T(q * qscale) K^T over iteration it's keys, started, not waited for
  uint32_t qa[DH / 16][4];
  auto start_qk = [&](float (&sc)[8][4], int it) {
    const bf16* Ks = stage(it);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      WgMma<64>::run<0>(sc, qa[kk], fwd_kt(Ks, kk), kk);
    wg_commit();
  };

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < S; ++st) mbar_init(&full[st], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#pragma unroll
    for (int st = 0; st < S - 1; ++st) fetch(st);
  }
  // each stage's chunk of ones (TMA leaves it alone)
  for (int i = threadIdx.x; i < S * 64; i += FWD_NT)
    reinterpret_cast<uint4*>(KV + i / 64 * STAGE + 2 * TILE)[i % 64] =
        make_uint4(0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u);
  fence_async_shared();
  load_q<DH>(qa, q + (size_t)pl.b * sqb + pl.h * DH, sqn, r0, N);
  const uint32_t qs2 = bf16_pair(qscale);
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) qa[kk][i] = mul_bf16x2(qa[kk][i], qs2);
  }
  float m[2] = {-INFINITY, -INFINITY};
  float acc[CH + 1][4];  // [e V | e 1]
#pragma unroll
  for (int nt = 0; nt <= CH; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;

  // one step: sc holds iteration it's scores, sn receives it + 1's (past
  // the last iteration, from a stale stage, and dropped). No branch
  // surrounds a wgmma and both waits drain every group, which keeps ptxas
  // from serialising them.
  auto begin = [&](float (&sn)[8][4], int it) {
    if (it + 1 < total) landed(it + 1);
    __syncthreads();  // every warp done with it - 1's stage
    if (threadIdx.x == 0) fetch(it + S - 1);  // into it - 1's stage
    start_qk(sn, it + 1);
  };
  auto max_step = [&](float (&sc)[8][4], float (&sn)[8][4], int it) {
    begin(sn, it);
    mask_tile(sc, it * TC_R, N);
    row_max(sc, m);
    wg_wait<0>();  // q K^T of it + 1 done
    fence_regs(sn);
  };
  // e V starts while q K^T of it + 1 may still run (the two share no
  // register), and one wait drains both: the softmax feeds e V, so it
  // runs before the wait, beside q K^T
  auto exp_step = [&](float (&sc)[8][4], float (&sn)[8][4], int it) {
    begin(sn, it);
    mask_tile(sc, (it - nk) * TC_R, N);
    uint32_t P[4][4];
    exp_pack(sc, m, P);
    const bf16* Vs = stage(it) + TILE;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      WgMma<DH + 8>::template run<1>(acc, P[kk], fwd_vt(Vs, kk), 1);
    wg_commit();
    wg_wait<0>();  // q K^T of it + 1 and e V of it done
    fence_regs(sn);
    fence_regs(acc);
  };

  float s0[8][4], s1[8][4];
  __syncthreads();  // the barriers and the ones in
  landed(0);
  start_qk(s0, 0);
  wg_wait<0>();
  fence_regs(s0);
  int it = 0;
  for (; it + 1 < nk; it += 2) {
    max_step(s0, s1, it);
    max_step(s1, s0, it + 1);
  }
  if (it < nk) {  // odd nk: pass 2's first scores landed in s1
    max_step(s0, s1, it);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s0[nt][e] = s1[nt][e];
    }
  }
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);
  for (it = nk; it + 1 < total; it += 2) {
    exp_step(s0, s1, it);
    exp_step(s1, s0, it + 1);
  }
  if (it < total) exp_step(s0, s1, it);

  const float r[2] = {acc[CH][0], acc[CH][2]};  // every column of e 1 is r
  store_o<DH, true, CH + 1>(acc, r, o + (size_t)pl.b * N * HD + pl.h * DH, HD,
                            r0, N);
  if (tq == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int n = r0 + gr + 8 * i;
      if (n >= N) continue;
      const size_t row = ((size_t)pl.b * N + n) * H + pl.h;
      if (lse != nullptr) lse[row] = m[i] + logf(r[i]);
      if (m_out != nullptr) {
        m_out[row] = m[i];
        r_out[row] = r[i];
      }
    }
  }
}

// --------------------------------------------------------------- launches

// The bf16 forward's one launch: its grid (fwd_blocks) and shared memory
// (smem_fwd), for every caller (fused_heads.cu, dit_split.cu and
// dit_layer.cuh); the caller has checked that the grid fits an int
template <int DH>
cudaError_t launch_fwd_bf16(const bf16* q, const bf16* k, const bf16* v,
                            long long sqb, long long sqn, long long skb,
                            long long skn, long long svb, long long svn,
                            bf16* o, int B, int N, int HD, int H,
                            float qscale, cudaStream_t st, float* lse,
                            float* m_out, float* r_out) {
  const size_t s = smem_fwd(DH);
  const cudaError_t e = set_smem((const void*)heads_fwd_kernel<DH>, s);
  if (e != cudaSuccess) return e;
  CUtensorMap tk, tv;
  if (!make_heads_map(&tk, k, B, N, HD, DH, skb, skn) ||
      !make_heads_map(&tv, v, B, N, HD, DH, svb, svn))
    return cudaErrorInvalidValue;
  heads_fwd_kernel<DH><<<(int)fwd_blocks(B, N, H), FWD_NT, s, st>>>(
      q, sqb, sqn, tk, tv, o, N, HD, H, qscale, lse, m_out, r_out);
  return cudaGetLastError();
}

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
  if constexpr (sizeof(T) == 2) {
    return launch_fwd_bf16<DH>(q, k, v, sqb, sqn, skb, skn, svb, svn, o, B,
                               N, HD, H, qscale, st, lse, nullptr, nullptr);
  } else {
    const size_t s = smem_attn_f32(DH);
    const cudaError_t e = set_smem((const void*)heads_attn_kernel<T, DH>, s);
    if (e != cudaSuccess) return e;
    const int blocks = B * ((N + QT - 1) / QT) * H;
    heads_attn_kernel<T, DH><<<blocks, NT, s, st>>>(
        q, k, v, sqb, sqn, skb, skn, svb, svn, o, N, HD, H, qscale, lse);
    return cudaGetLastError();
  }
}

// The attention of every (element, q tile, head); the caller has checked
// the head width (32, 64 or 128) and that the grid fits an int. lse, when
// given, receives the rows' log-sum-exp (fused_heads_forward_stats).
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
