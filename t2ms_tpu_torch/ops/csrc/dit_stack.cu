// Whole adaLN-zero transformer stack of the DiT, hand-written for Hopper
// (sm_90a), bf16 and f32.
//
// Replaces the TPU kernel t2ms_tpu/ops/dit_block.py:fused_dit_stack
// (_stack_kernel over _block_math and ops/attention.py:attn_heads_natural),
// which holds one batch element's whole (N, D) activation, all L layers'
// weights and a full (N, N) f32 score matrix per head in one program's
// VMEM. A Hopper block has at most 227 KB of shared memory (one head's f32
// scores at N=480 alone are 900 KB), so the stack is re-tiled: three
// kernels per layer, cut at the block's residual boundaries. With L = 1
// the same launches are one block, fused_dit_block.
//
// Bound on an H100 SXM at the main-path call (2B=512, N=480, D=128, 4
// heads, hidden 256, L=4, bf16): about 0.50 TFLOP of matrix products
// (attention 60 GFLOP + dense 64 GFLOP per layer) against about 0.13 GB
// that must move (x in and out, mod, weights). At 989 TFLOP/s and
// 3.35 TB/s that is 0.50 ms of tensor-core work against 0.04 ms of
// memory traffic: the call is bound by operations.
//
// bf16, at head widths 16, 32, 64 and 128: dit_layer.cuh's tensor-core
// kernels (modLN + qkv, the register-tile attention of attn_heads.cuh,
// out-projection + gated residual + modLN + MLP + gated residual; it says
// what the design does about the bound). The output buffer serves every
// layer in place (a block of the last kernel reads its rows of x before it
// writes them), tmp holds the attention output.
// f32, and bf16 at any other head width: dit_common.cuh's first kernels
// (modLN + qkv, attention + out-projection + gated residual, modLN + MLP +
// gated residual: WMMA in bf16, FMA loops in f32, which keep the f32 entry
// tight against its twin; no timed path runs them), with tmp and out as
// ping-pong activation buffers.
//
// C interface for ctypes: dit_stack_forward_{bf16,f32} launch the whole
// stack on the given stream and return cudaGetLastError(), or
// T2MS_UNSUPPORTED_SHAPE (launching nothing) for a shape the kernels do not
// take; dit_stack_check answers that question alone. The shape limits live
// only in dit_common.cuh (check_shape), next to the tiling they follow;
// dit_stack_tc_route says which kernels a bf16 geometry runs on,
// dit_stack_smem gives each tensor-core kernel's dynamic shared memory, and
// dit_stack_attention_bf16 runs the attention stage alone (for checks of
// its row max and row sum).

#include "dit_layer.cuh"

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
  if constexpr (sizeof(T) == 2) {
    if (tc_route(B, N, D, hidden, H)) {
      const size_t D3 = (size_t)D * 3 * D, DD = (size_t)D * D;
      const size_t DF = (size_t)D * hidden;
      const T* cur = x;
      for (int l = 0; l < L; ++l) {
        const cudaError_t e = run_layer_tc(
            cur, mod, wqkv + l * D3, bqkv + (size_t)l * 3 * D, wproj + l * DD,
            bproj + (size_t)l * D, wfc1 + l * DF, bfc1 + (size_t)l * hidden,
            wfc2 + l * DF, bfc2 + (size_t)l * D, qkv, tmp, out, B, N, D,
            hidden, H, L, l, eps, qscale, st);
        if (e != cudaSuccess) return e;
        cur = out;
      }
      return cudaSuccess;
    }
  }
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

extern "C" int dit_stack_tc_route(int B, int N, int D, int hidden, int H) {
  return check_shape<__nv_bfloat16>(D, hidden, H) == 0 &&
         tc_route(B, N, D, hidden, H);
}

// dynamic shared memory of the tensor-core route's kernels: part 0 the
// modLN + qkv kernel, 1 the attention, 2 the out-projection + MLP kernel,
// 3 its first half alone (the block backward's recompute)
extern "C" long long dit_stack_smem(int part, int D, int hidden, int H) {
  return part == 0 ? (long long)smem_qkv_tc(D)
         : part == 1 ? (long long)smem_fwd(D / H)
                     : (long long)smem_mlp_tc(D, hidden, part == 2);
}

// The tensor-core route's attention stage alone on a bf16 qkv (B*N, 3D):
// o (B*N, D), and each row's max m and sum r (f32, (B*N, H)) of every head.
extern "C" int dit_stack_attention_bf16(const void* qkv, void* o, void* m,
                                        void* r, int B, int N, int D, int H,
                                        float qscale, void* stream) {
  if (B < 1 || N < 1 || H < 1 || D % H || D % 64 || !tc_head_width(D / H) ||
      fwd_blocks(B, N, H) > INT_MAX)
    return T2MS_UNSUPPORTED_SHAPE;
  return launch_layer_attn((const bf16*)qkv, (bf16*)o, B, N, D, H, qscale,
                           (float*)m, (float*)r, (cudaStream_t)stream);
}

extern "C" const char* t2ms_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
