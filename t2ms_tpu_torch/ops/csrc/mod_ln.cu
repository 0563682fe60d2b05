// LayerNorm + adaLN modulate, forward and backward, hand-written for Hopper
// (sm_90a), bf16 and f32.
//
// Replaces the TPU kernels t2ms_tpu/ops/dit_block.py:_mod_ln_call
// (_mod_ln_fwd_kernel) and _mod_ln_diff_bwd (_mod_ln_bwd_kernel), which the
// flax-path DiT block runs around its attention and its MLP:
//
//   forward   out = T(LN(x) * (1 + scale) + shift), LN without scale or
//             bias in f32 (mean, then the variance of the centred row,
//             eps from the caller), the modulate in f32, one rounding.
//   backward  with xh = LN(x), rs = 1 / sqrt(var + eps) and
//             g = f32(dy) * (1 + scale):
//             dx = T(rs * (g - mean(g) - xh * mean(g * xh))),
//             dshift = sum over rows of dy, dscale = sum over rows of dy * xh
//             (per batch element, in f32; the wrapper rounds them once to
//             mod2's dtype).
//
// mod2 is (B, 2, D) = [shift, scale] in f32 (the wrapper converts it).
//
// Bound on an H100 SXM at the scaled train step's call (B=64, N=1024,
// D=512, bf16): the forward moves 134 MB (x in, out), 0.040 ms at
// 3.35 TB/s, the backward 201 MB (x, dy in, dx out), 0.060 ms; a few f32
// operations per element are far below either. Both are bound by bytes, so
// each reads x (and dy) once and writes once, and keeps everything else in
// registers: one warp per row, each lane holding its D/32 values; the
// backward's per-column sums stay in each warp's registers over its rows of
// a 64-row tile of one element, then go through shared memory to one f32
// partial per (element, tile), summed over the tiles in a fixed order by
// dmod_reduce_kernel (dit_common.cuh). No atomics: runs repeat bit for bit.
//
// C interface for ctypes: mod_ln_forward_{bf16,f32} and
// mod_ln_backward_{bf16,f32} launch on the given stream and return
// cudaGetLastError(), or T2MS_UNSUPPORTED_SHAPE (launching nothing) for a
// shape the kernels do not take; mod_ln_backward_workspace gives the bytes of
// the partials the caller allocates; mod_ln_check answers the shape question.

#include "dit_common.cuh"

namespace {

constexpr int MLN_ROWS = 64;    // rows of one backward block (one element)
constexpr int MLN_MAXD = 1024;  // 32 values per lane

// f32 mean and 1 / sqrt(var + eps) of a row held lane-strided in v
template <int V>
__device__ __forceinline__ float row_stats(const float (&v)[V], int D,
                                           float eps, float& rs) {
  const int lane = threadIdx.x % 32;
  float s = 0.0f;
#pragma unroll
  for (int u = 0; u < V; ++u) s += v[u];
  const float mu = warp_sum(s) / D;
  float q = 0.0f;
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const float d = lane + 32 * u < D ? v[u] - mu : 0.0f;
    q += d * d;
  }
  rs = rsqrtf(warp_sum(q) / D + eps);
  return mu;
}

template <typename T, int V>
__global__ void __launch_bounds__(NT)
mod_ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ mod2,
                  T* __restrict__ out, int rows, int N, int D, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = blockIdx.x * NW + warp;
  if (r >= rows) return;
  const T* xr = x + (size_t)r * D;
  float v[V];
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const int c = lane + 32 * u;
    v[u] = c < D ? to_f<T>(xr[c]) : 0.0f;
  }
  float rs;
  const float mu = row_stats<V>(v, D, eps, rs);
  const float* sh = mod2 + (size_t)(r / N) * 2 * D;
  const float* sc = sh + D;
  T* o = out + (size_t)r * D;
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const int c = lane + 32 * u;
    if (c < D) o[c] = from_f<T>((v[u] - mu) * rs * (1.0f + sc[c]) + sh[c]);
  }
}

// One block per 64-row tile of one element: dx of its rows and the tile's
// f32 partials part[blockIdx.x] = [sum dy, sum dy * xh] (2 x D).
template <typename T, int V>
__global__ void __launch_bounds__(NT)
mod_ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ mod2,
                  const T* __restrict__ dy, T* __restrict__ dx,
                  float* __restrict__ part, int N, int D, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ps = reinterpret_cast<float*>(smem);  // NW x 2 x D warp partials
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles = (N + MLN_ROWS - 1) / MLN_ROWS;
  const int b = blockIdx.x / tiles, n0 = (blockIdx.x % tiles) * MLN_ROWS;
  const int valid = min(MLN_ROWS, N - n0);
  const float* sc = mod2 + (size_t)b * 2 * D + D;
  float scp[V], psh[V], psc[V];
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const int c = lane + 32 * u;
    scp[u] = c < D ? 1.0f + sc[c] : 0.0f;
    psh[u] = psc[u] = 0.0f;
  }
  for (int i = warp; i < valid; i += NW) {
    const size_t r = (size_t)b * N + n0 + i;
    const T* xr = x + r * D;
    const T* dr = dy + r * D;
    float v[V], d[V];
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const int c = lane + 32 * u;
      v[u] = c < D ? to_f<T>(xr[c]) : 0.0f;
      d[u] = c < D ? to_f<T>(dr[c]) : 0.0f;
    }
    float rs;
    const float mu = row_stats<V>(v, D, eps, rs);
    float sg = 0.0f, sgx = 0.0f;
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const int c = lane + 32 * u;
      v[u] = c < D ? (v[u] - mu) * rs : 0.0f;  // xh
      psh[u] += d[u];
      psc[u] += d[u] * v[u];
      d[u] *= scp[u];                          // g
      sg += d[u];
      sgx += d[u] * v[u];
    }
    const float mg = warp_sum(sg) / D, mgx = warp_sum(sgx) / D;
    T* o = dx + r * D;
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const int c = lane + 32 * u;
      if (c < D) o[c] = from_f<T>(rs * (d[u] - mg - v[u] * mgx));
    }
  }
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const int c = lane + 32 * u;
    if (c < D) {
      Ps[(warp * 2) * D + c] = psh[u];
      Ps[(warp * 2 + 1) * D + c] = psc[u];
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < 2 * D; j += NT) {
    float s = 0.0f;
    for (int w = 0; w < NW; ++w) s += Ps[w * 2 * D + j];
    part[(size_t)blockIdx.x * 2 * D + j] = s;
  }
}

size_t smem_mod_ln_bwd(int D) { return (size_t)NW * 2 * D * 4; }

// 0 when the kernels take rows of D values on the current device,
// T2MS_UNSUPPORTED_SHAPE when they do not, else the CUDA error of the query.
// A lane holds at most 32 values of a row, so D <= 1024; the backward's
// warp partials fit what one block may opt in to.
int check_mod_ln(int D) {
  if (D < 1 || D > MLN_MAXD) return T2MS_UNSUPPORTED_SHAPE;
  const long long optin = smem_optin();
  if (optin < 0) return (int)-optin;
  return smem_mod_ln_bwd(D) <= (size_t)optin ? 0 : T2MS_UNSUPPORTED_SHAPE;
}

template <typename T> struct Args {
  const T* x;
  const float* mod2;
  const T* dy;
  T* out;         // the forward's output, or dx
  float* part;    // the backward's per-tile partials
  int B, N, D;
  float eps;
};

template <typename T, int V> struct Forward {
  static cudaError_t run(const Args<T>& a, cudaStream_t st) {
    const int rows = a.B * a.N;
    const unsigned blocks = (unsigned)(((long long)rows + NW - 1) / NW);
    mod_ln_fwd_kernel<T, V><<<blocks, NT, 0, st>>>(
        a.x, a.mod2, a.out, rows, a.N, a.D, a.eps);
    return cudaGetLastError();
  }
};

template <typename T, int V> struct Backward {
  static cudaError_t run(const Args<T>& a, cudaStream_t st) {
    const size_t s = smem_mod_ln_bwd(a.D);
    const cudaError_t e = set_smem((const void*)mod_ln_bwd_kernel<T, V>, s);
    if (e != cudaSuccess) return e;
    const int tiles = (a.N + MLN_ROWS - 1) / MLN_ROWS;
    mod_ln_bwd_kernel<T, V><<<a.B * tiles, NT, s, st>>>(
        a.x, a.mod2, a.dy, a.out, a.part, a.N, a.D, a.eps);
    return cudaGetLastError();
  }
};

// L<T, V>::run with V the values a lane holds for a row of D (the next power
// of two of D / 32), after the shape checks.
template <template <typename, int> class L, typename T>
int by_lanes(const Args<T>& a, cudaStream_t st) {
  // rows of (B*N, D) and the backward's B * tiles blocks are indexed as int
  if (a.B < 1 || a.N < 1 || (long long)a.B * a.N > INT_MAX)
    return T2MS_UNSUPPORTED_SHAPE;
  const int ok = check_mod_ln(a.D);
  if (ok) return ok;
  if (a.D <= 32) return L<T, 1>::run(a, st);
  if (a.D <= 64) return L<T, 2>::run(a, st);
  if (a.D <= 128) return L<T, 4>::run(a, st);
  if (a.D <= 256) return L<T, 8>::run(a, st);
  if (a.D <= 512) return L<T, 16>::run(a, st);
  return L<T, 32>::run(a, st);
}

template <typename T>
int run_backward(const Args<T>& a, float* dmod2, cudaStream_t st) {
  const int e = by_lanes<Backward, T>(a, st);
  if (e) return e;
  launch_dmod_reduce(a.part, a.B, (a.N + MLN_ROWS - 1) / MLN_ROWS, 2 * a.D,
                     dmod2, st);
  return cudaGetLastError();
}

}  // namespace

#define T2MS_MOD_LN_ENTRIES(SUFFIX, T)                                        \
  extern "C" int mod_ln_forward_##SUFFIX(const void* x, const void* mod2,     \
                                         void* out, int B, int N, int D,      \
                                         float eps, void* stream) {           \
    const Args<T> a{(const T*)x, (const float*)mod2, nullptr, (T*)out,       \
                    nullptr, B, N, D, eps};                                   \
    return by_lanes<Forward, T>(a, (cudaStream_t)stream);                     \
  }                                                                           \
  extern "C" int mod_ln_backward_##SUFFIX(                                    \
      const void* x, const void* mod2, const void* dy, void* dx, void* dmod2, \
      void* work, int B, int N, int D, float eps, void* stream) {             \
    const Args<T> a{(const T*)x, (const float*)mod2, (const T*)dy, (T*)dx,   \
                    (float*)work, B, N, D, eps};                              \
    return run_backward<T>(a, (float*)dmod2, (cudaStream_t)stream);           \
  }

T2MS_MOD_LN_ENTRIES(bf16, __nv_bfloat16)
T2MS_MOD_LN_ENTRIES(f32, float)

extern "C" long long mod_ln_backward_workspace(int B, int N, int D) {
  return (long long)B * ((N + MLN_ROWS - 1) / MLN_ROWS) * 2 * D * 4;
}

extern "C" int mod_ln_check(int D, int is_bf16) {
  (void)is_bf16;  // the limits are the same for both types
  return check_mod_ln(D);
}

extern "C" const char* t2ms_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
