// Pieces shared by the persistent, warp-specialised row kernels of
// dit_layer.cuh (the stack and the block backward) and split_tc.cuh (the
// split block): the block's roles and register split, the static shared
// memory they keep for barriers, setmaxnreg, and the epilogues' bf16-pair
// arithmetic (bias, exponential GELU, gated residual) from wgmma's
// accumulator layout.

#pragma once

#include "wg_gemm.cuh"

namespace {

constexpr int RW_WG = 2;                // consumer warpgroups of a block
constexpr int RW_NC = 128 * RW_WG;      // their threads
constexpr int RW_NT = RW_NC + 128;      // and a producer warpgroup
// registers a thread after the split: a sub-partition holds a producer
// warp and two consumer warps, (40 + 2 * 232) * 32 <= 16384
constexpr int RW_PRODUCER_REGS = 40, RW_CONSUMER_REGS = 232;
constexpr size_t RW_STATIC = 1024;      // kept for the static barriers

template <int N> __device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N> __device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
// T(acc + T(bias)) of the thread's pairs, column c0 + 8 nt + 2 (lane % 4)
// of row h of the two it holds, as a bf16 pair (EPI: epi_pair)
template <int EPI>
__device__ __forceinline__ uint32_t bias_pair(const float (&a)[4], int h,
                                              uint32_t bp) {
  return epi_pair<EPI>(a[2 * h] + __uint_as_float(bp << 16),
                       a[2 * h + 1] + __uint_as_float(bp & 0xffff0000u));
}
__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned*>(p));
}

// a value the compiler must take as new where it is used: keeps
// descriptors built from it inside the loop that uses them (hoisted, D 192's
// twelve fc1 descriptors stay live across the whole tile and spill)
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("mov.b32 %0, %0;\n" : "+r"(x));
  return x;
}
// T(res + T(g * v)) of bf16 pairs, g the rounded gate pair: resid_pair's
// arithmetic without rounding g again
__device__ __forceinline__ uint32_t resid2(uint32_t v, uint32_t res,
                                          uint32_t g) {
  float p0, p1;
  round2(__uint_as_float(g << 16) * __uint_as_float(v << 16),
         __uint_as_float(g & 0xffff0000u) * __uint_as_float(v & 0xffff0000u),
         p0, p1);
  return pack_bf16(__uint_as_float(res << 16) + p0,
                   __uint_as_float(res & 0xffff0000u) + p1);
}
// the rounded gate pair T(mod[row, col..col+1])
__device__ __forceinline__ uint32_t gate_pair(const float* p) {
  const float2 v = __ldg(reinterpret_cast<const float2*>(p));
  return pack_bf16(v.x, v.y);
}

// T(gelu(T(v))) of a pair: the rounded fc1 output, GELU'd in f32
// (wg_gemm.cuh's gelu_fast), rounded
__device__ __forceinline__ uint32_t gelu_pair(const float (&a)[4], int h,
                                              uint32_t bp) {
  float x0, x1;
  round2(a[2 * h] + __uint_as_float(bp << 16),
         a[2 * h + 1] + __uint_as_float(bp & 0xffff0000u), x0, x1);
  return pack_bf16(gelu_fast(x0), gelu_fast(x1));
}

// SMs of the current device (0 on an error)
inline int rw_sms() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

}  // namespace
