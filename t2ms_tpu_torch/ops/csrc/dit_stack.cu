// Whole adaLN-zero transformer stack of the DiT, hand-written for Hopper
// (sm_90a), bf16 and f32.
//
// Replaces the TPU kernel t2ms_tpu/ops/dit_block.py:fused_dit_stack
// (_stack_kernel over _block_math and ops/attention.py:attn_heads_natural),
// which holds one batch element's whole (N, D) activation, all L layers'
// weights and a full (N, N) f32 score matrix per head in one program's
// VMEM. A Hopper block has at most 227 KB of shared memory (one head's f32
// scores at N=480 alone are 900 KB), so the stack is re-tiled: three
// kernels per layer (dit_common.cuh: modLN+qkv, attention+proj+gated
// residual, modLN+MLP+gated residual), cut at the block's residual
// boundaries, with ping-pong activation buffers so no launch reads what it
// writes. With L = 1 the same launches are one block, fused_dit_block.
//
// Bound on an H100 SXM at the main-path call (2B=512, N=480, D=128, 4
// heads, hidden 256, L=4, bf16): about 0.50 TFLOP of matrix products
// (attention 60 GFLOP + dense 64 GFLOP per layer) against about 0.13 GB
// that must move (x in and out, mod, weights). At 989 TFLOP/s and
// 3.35 TB/s that is 0.50 ms of tensor-core work against 0.04 ms of
// memory traffic: the call is bound by operations. The design therefore
// keeps every product on the tensor cores (WMMA bf16 16x16x16 with f32
// accumulation; the f32 path uses plain FMA loops so it stays exact
// against its twin), never writes scores to device memory (QK^T is
// recomputed in the second pass instead), and accepts three HBM
// round-trips of the activation per layer, which stay far below the
// compute bound. Speed (wgmma, TMA, padding against bank conflicts) is
// later work; this kernel is the simple, right one.
//
// C interface for ctypes: dit_stack_forward_{bf16,f32} launch the whole
// stack on the given stream and return cudaGetLastError(), or
// T2MS_UNSUPPORTED_SHAPE (launching nothing) for a shape the kernels do not
// take; dit_stack_check answers that question alone. The shape limits live
// only in dit_common.cuh (check_shape), next to the tiling they follow.

#include "dit_common.cuh"

namespace {

template <typename T>
int run_stack(const T* x, const float* mod, const T* wqkv, const T* bqkv,
              const T* wproj, const T* bproj, const T* wfc1, const T* bfc1,
              const T* wfc2, const T* bfc2, T* out, T* tmp, T* qkv, int B,
              int N, int D, int hidden, int L, int H, float eps, float qscale,
              cudaStream_t st) {
  // rows of the (B*N, D) activation are indexed as int
  if (B < 1 || N < 1 || (long long)B * N > INT_MAX)
    return T2MS_UNSUPPORTED_SHAPE;
  const int ok = check_shape<T>(D, hidden, H);
  if (ok) return ok;
  const size_t s_qkv = smem_qkv<T>(D), s_attn = smem_attn<T>(D, H);
  const size_t s_mlp = smem_mlp<T>(D, hidden);
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(modln_qkv_kernel<T>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)s_qkv)) != cudaSuccess) return e;
  if ((e = cudaFuncSetAttribute(attn_proj_kernel<T>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)s_attn)) != cudaSuccess) return e;
  if ((e = cudaFuncSetAttribute(mlp_kernel<T>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)s_mlp)) != cudaSuccess) return e;
  const int rows = B * N;
  const dim3 g_rows((rows + RT - 1) / RT), g_attn(B * ((N + QT - 1) / QT));
  const T* cur = x;
  for (int l = 0; l < L; ++l) {
    modln_qkv_kernel<T><<<g_rows, NT, s_qkv, st>>>(
        cur, mod, wqkv + (size_t)l * D * 3 * D, bqkv + (size_t)l * 3 * D, qkv,
        nullptr, rows, N, D, L, l, eps);
    attn_proj_kernel<T><<<g_attn, NT, s_attn, st>>>(
        qkv, cur, mod, wproj + (size_t)l * D * D, bproj + (size_t)l * D, tmp,
        N, D, H, L, l, qscale, nullptr, nullptr, nullptr, nullptr);
    mlp_kernel<T><<<g_rows, NT, s_mlp, st>>>(
        tmp, mod, wfc1 + (size_t)l * D * hidden, bfc1 + (size_t)l * hidden,
        wfc2 + (size_t)l * hidden * D, bfc2 + (size_t)l * D, out, rows, N, D,
        hidden, L, l, eps);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    cur = out;
  }
  return cudaGetLastError();
}

}  // namespace

#define T2MS_STACK_ENTRY(NAME, T)                                            \
  extern "C" int NAME(const void* x, const void* mod, const void* wqkv,      \
                      const void* bqkv, const void* wproj, const void* bproj, \
                      const void* wfc1, const void* bfc1, const void* wfc2,  \
                      const void* bfc2, void* out, void* tmp, void* qkv,     \
                      int B, int N, int D, int hidden, int L, int H,         \
                      float eps, float qscale, void* stream) {               \
    return run_stack<T>(                                                     \
        (const T*)x, (const float*)mod, (const T*)wqkv, (const T*)bqkv,      \
        (const T*)wproj, (const T*)bproj, (const T*)wfc1, (const T*)bfc1,    \
        (const T*)wfc2, (const T*)bfc2, (T*)out, (T*)tmp, (T*)qkv, B, N, D,  \
        hidden, L, H, eps, qscale, (cudaStream_t)stream);                    \
  }

T2MS_STACK_ENTRY(dit_stack_forward_bf16, __nv_bfloat16)
T2MS_STACK_ENTRY(dit_stack_forward_f32, float)

extern "C" int dit_stack_check(int D, int hidden, int H, int is_bf16) {
  return is_bf16 ? check_shape<__nv_bfloat16>(D, hidden, H)
                 : check_shape<float>(D, hidden, H);
}

extern "C" const char* t2ms_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
