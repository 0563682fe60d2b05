// Attention on the head-split (B, H, N, DH) layout, hand-written for Hopper
// (sm_90a), bf16 and f32.
//
// Replaces the TPU kernels t2ms_tpu/ops/attention.py:flash_attention
// (_flash_kernel, online softmax over KV blocks, all f32 inside),
// vmem_attention (_vmem_attn_kernel) and packed_attention (_packed_kernel),
// the last two the same exact softmax with p normalised and cast to v's
// dtype before PV. The TPU kernels hold one (b, h) row's whole K and V (and,
// for the exact ones, the whole (N, N) score matrix) in VMEM; a Hopper block
// has 227 KB of shared memory, so here every block owns 64 q rows of one
// (b, h) and streams K/V through shared memory in 64-row tiles:
//
//   online (#15)  one pass over the K/V tiles: s = (q k^T) * scale in f32,
//                 the running row max m, the correction exp(m_old - m_new),
//                 p = exp(s - m_new) and the row sum all in f32, the f32
//                 accumulator rescaled and p v added; o = T(acc / sum).
//   exact (#16, #17)  two passes: the f32 row max and sum (carried online,
//                 the same as max-then-sum up to f32 rounding), then p =
//                 exp(s - m) / sum, cast to T, PV accumulated in f32, o =
//                 T(PV).
//
// Each warp owns 16 q rows and keeps its scores and its output accumulator in
// registers in the layout of mma.sync.m16n8k16 (bf16 operands, f32 sums):
// q k^T from the q fragments (held for the whole loop) and k rows, p v with p
// straight from the score registers and v stored transposed in shared memory.
// The exact kernels' PV takes p rounded to bf16, as the TPU kernels do; the
// online kernel's p is f32 there, so it enters PV as two bf16 products (p =
// hi + lo), which keeps p's rounding below the output's. f32 operands run the
// same loops with FMA products on the CUDA cores (p through shared memory),
// so the f32 kernels compute in full f32.
//
// q, k, v and o are read and written through their own batch, head and row
// strides (16-byte aligned rows, unit column stride: the wrapper checks), so
// the head-split views of one qkv projection are not copied and the output
// can be a view of the merged (B, N, H*DH) layout. Rows past N load as zero;
// their keys are masked to -inf before the max.
//
// Bound on an H100 SXM at the 8192-token DiT's serving call (2B=8, H=4,
// N=8192, DH=32, bf16): the two N x N x DH products are 274.9 GFLOP, 0.278 ms
// at 989 TFLOP/s, against 8.4 MB of q, k, v and o: bound by operations, and
// the exp of every score (2.1e9 of them) runs on the CUDA cores beside the
// tensor cores. This first kernel stages its tiles with plain loads (no
// cp.async or TMA pipeline, no wgmma): see PERF.md for its times.

#include "dit_common.cuh"

namespace {

constexpr int SQ = 64;               // q rows per block, 16 per warp
constexpr int SK = 64;               // keys per tile
constexpr int SWARPS = SQ / 16;
constexpr int STHREADS = SWARPS * 32;

struct Strides {
  long long b, h, n;
};
struct SplitShape {
  Strides q, k, v, o;
  int H, N;
  float scale;
};

// Shared memory: the q tile and a k tile (row-major, rows padded by 16
// bytes), the v tile transposed (DH x SK), and in f32 each warp's p rows.
template <typename T> __host__ __device__ constexpr int ldq(int DH) {
  return DH + pad<T>();
}
template <typename T> __host__ __device__ constexpr int ldv() {
  return SK + pad<T>();
}
constexpr int LDP = SK + PADF;
template <typename T> __host__ __device__ size_t smem_split(int DH) {
  return (size_t)((SQ + SK) * ldq<T>(DH) + DH * ldv<T>()) * sizeof(T) +
         (sizeof(T) == 4 ? (size_t)SWARPS * 16 * LDP * 4 : 0);
}

// dst[r * ld + c] = src[r * sn + c] for r < valid, 0 below, rows of DH
template <typename T, int DH>
__device__ void load_tile(T* dst, int ld, const T* __restrict__ src,
                          long long sn, int valid) {
  constexpr int V = 16 / sizeof(T), VPR = DH / V;
  for (int idx = threadIdx.x; idx < 64 * VPR; idx += STHREADS) {
    const int r = idx / VPR, c = (idx % VPR) * V;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + r * sn + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// dst[c * ld + r] = src[r * sn + c]: the tile stored transposed
template <typename T, int DH>
__device__ void load_tile_t(T* dst, int ld, const T* __restrict__ src,
                            long long sn, int valid) {
  constexpr int V = 16 / sizeof(T), VPR = DH / V;
  for (int idx = threadIdx.x; idx < 64 * VPR; idx += STHREADS) {
    const int r = idx / VPR, c = (idx % VPR) * V;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + r * sn + c);
    const uint32_t w[4] = {val.x, val.y, val.z, val.w};
    if constexpr (sizeof(T) == 2) {
      unsigned short* d = reinterpret_cast<unsigned short*>(dst);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        d[(c + i) * ld + r] = (unsigned short)(w[i / 2] >> (16 * (i % 2)));
    } else {
      uint32_t* d = reinterpret_cast<uint32_t*>(dst);
#pragma unroll
      for (int i = 0; i < 4; ++i) d[(c + i) * ld + r] = w[i];
    }
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// x and y rounded to bf16 (hi) and what rounding left over, rounded (lo)
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(x - f.x, y - f.y);
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) @ b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The scores of this warp's 16 rows against the 64 keys in Ks, scaled in
// f32, keys at or past N masked to -inf. In the mma layout: sc[j][e] is row
// g + 8 * (e / 2), key j * 8 + 2 * t + e % 2, for g = lane / 4, t = lane % 4.
template <typename T, int DH>
__device__ __forceinline__ void tile_scores(
    float (&sc)[SK / 8][4], const uint32_t (&qa)[DH / 16][4], const T* Qs,
    const T* Ks, int r0, int k0, int N, float scale) {
  constexpr int LD = ldq<T>(DH);
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < SK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
    if constexpr (sizeof(T) == 2) {
      const T* kr = Ks + (j * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        mma_bf16(sc[j], qa[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* qr = Qs + (r0 + g + 8 * (e / 2)) * LD;
        const float* kr = Ks + (j * 8 + 2 * t + e % 2) * LD;
        float s = 0.0f;
#pragma unroll 8
        for (int c = 0; c < DH; ++c) s = fmaf(qr[c], kr[c], s);
        sc[j][e] = s;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sc[j][e] = k0 + j * 8 + 2 * t + e % 2 < N ? sc[j][e] * scale
                                                 : -INFINITY;
  }
}

// acc (this warp's 16 rows x DH, mma layout: acc[n][e] is row g + 8 * (e/2),
// column n * 8 + 2 * t + e % 2) += p @ v, p (16 x 64) in the score layout,
// v transposed in Vt. bf16: p rounded to bf16 (SPLIT: as hi + lo); f32: p
// through this warp's rows of Ps, FMA sums added once per tile.
template <typename T, int DH, bool SPLIT>
__device__ __forceinline__ void tile_pv(float (&acc)[DH / 8][4],
                                        const float (&p)[SK / 8][4],
                                        const T* Vt, float* Ps) {
  constexpr int LV = ldv<T>();
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int kk = 0; kk < SK / 16; ++kk) {
      uint32_t a[4], lo[4];
      if constexpr (SPLIT) {
        split_bf16(p[2 * kk][0], p[2 * kk][1], a[0], lo[0]);
        split_bf16(p[2 * kk][2], p[2 * kk][3], a[1], lo[1]);
        split_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1], a[2], lo[2]);
        split_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3], a[3], lo[3]);
      } else {
        a[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
        a[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
        a[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
        a[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
      }
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        const T* vr = Vt + (n * 8 + g) * LV + kk * 16 + 2 * t;
        const uint32_t b0 = ld32(vr), b1 = ld32(vr + 8);
        mma_bf16(acc[n], a, b0, b1);
        if constexpr (SPLIT) mma_bf16(acc[n], lo, b0, b1);
      }
    }
  } else {
    float* Pw = Ps + (threadIdx.x / 32) * 16 * LDP;
#pragma unroll
    for (int j = 0; j < SK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        Pw[(g + 8 * (e / 2)) * LDP + j * 8 + 2 * t + e % 2] = p[j][e];
    __syncwarp();
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* pr = Pw + (g + 8 * (e / 2)) * LDP;
        const float* vr =
            reinterpret_cast<const float*>(Vt) + (n * 8 + 2 * t + e % 2) * LV;
        float s = 0.0f;
#pragma unroll 8
        for (int c = 0; c < SK; ++c) s = fmaf(pr[c], vr[c], s);
        acc[n][e] += s;
      }
    __syncwarp();
  }
}

// One block per (b, h, 64 q rows), the q tile fastest, so the blocks of one
// (b, h) share its K/V in L2. EXACT: the exact softmax (#16, #17); else the
// online one (#15).
template <typename T, int DH, bool EXACT>
__global__ void __launch_bounds__(STHREADS)
split_heads_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ o,
                   const SplitShape s) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LD = ldq<T>(DH);
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + SQ * LD;
  T* Vt = Ks + SK * LD;
  float* Ps = reinterpret_cast<float*>(Vt + DH * ldv<T>());

  const int N = s.N, q_tiles = (N + SQ - 1) / SQ;
  const int q0 = (blockIdx.x % q_tiles) * SQ;
  const int bh = blockIdx.x / q_tiles, b = bh / s.H, h = bh % s.H;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = (threadIdx.x / 32) * 16;
  const T* qh = q + b * s.q.b + h * s.q.h;
  const T* kh = k + b * s.k.b + h * s.k.h;
  const T* vh = v + b * s.v.b + h * s.v.h;

  load_tile<T, DH>(Qs, LD, qh + q0 * s.q.n, s.q.n, N - q0);
  __syncthreads();
  uint32_t qa[DH / 16][4];
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const T* qr = Qs + (r0 + g) * LD + kk * 16 + 2 * t;
      qa[kk][0] = ld32(qr);
      qa[kk][1] = ld32(qr + 8 * LD);
      qa[kk][2] = ld32(qr + 8);
      qa[kk][3] = ld32(qr + 8 * LD + 8);
    }
  }

  // this thread's rows g (index 0) and g + 8 (index 1): the f32 row max
  // (the same across the row's four threads) and this thread's part of the
  // f32 row sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float acc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float sc[SK / 8][4];

  if constexpr (EXACT) {
    // pass 1: the row max and the row sum of exp(s - max)
    for (int k0 = 0; k0 < N; k0 += SK) {
      __syncthreads();
      load_tile<T, DH>(Ks, LD, kh + k0 * s.k.n, s.k.n, N - k0);
      __syncthreads();
      tile_scores<T, DH>(sc, qa, Qs, Ks, r0, k0, N, s.scale);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < SK / 8; ++j)
          mx = fmaxf(mx, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
        const float mn = fmaxf(m[r], quad_max(mx));
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < SK / 8; ++j)
          sum += expf(sc[j][2 * r] - mn) + expf(sc[j][2 * r + 1] - mn);
        l[r] = l[r] * expf(m[r] - mn) + sum;
        m[r] = mn;
      }
    }
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
  }

  for (int k0 = 0; k0 < N; k0 += SK) {
    __syncthreads();
    load_tile<T, DH>(Ks, LD, kh + k0 * s.k.n, s.k.n, N - k0);
    load_tile_t<T, DH>(Vt, ldv<T>(), vh + k0 * s.v.n, s.v.n, N - k0);
    __syncthreads();
    tile_scores<T, DH>(sc, qa, Qs, Ks, r0, k0, N, s.scale);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if constexpr (EXACT) {
#pragma unroll
        for (int j = 0; j < SK / 8; ++j) {
          sc[j][2 * r] = expf(sc[j][2 * r] - m[r]) / l[r];
          sc[j][2 * r + 1] = expf(sc[j][2 * r + 1] - m[r]) / l[r];
        }
      } else {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < SK / 8; ++j)
          mx = fmaxf(mx, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
        const float mn = fmaxf(m[r], quad_max(mx));
        const float corr = expf(m[r] - mn);
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < SK / 8; ++j) {
          sc[j][2 * r] = expf(sc[j][2 * r] - mn);
          sc[j][2 * r + 1] = expf(sc[j][2 * r + 1] - mn);
          sum += sc[j][2 * r] + sc[j][2 * r + 1];
        }
        l[r] = l[r] * corr + sum;
        m[r] = mn;
#pragma unroll
        for (int n = 0; n < DH / 8; ++n) {
          acc[n][2 * r] *= corr;
          acc[n][2 * r + 1] *= corr;
        }
      }
    }
    tile_pv<T, DH, !EXACT>(acc, sc, Vt, Ps);
  }

  if constexpr (!EXACT) {
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
  }
  T* oh = o + b * s.o.b + h * s.o.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + 8 * r;
    if (row >= N) continue;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      float x = acc[n][2 * r], y = acc[n][2 * r + 1];
      if constexpr (!EXACT) {
        x /= l[r];
        y /= l[r];
      }
      T* dst = oh + row * s.o.n + n * 8 + 2 * t;
      if constexpr (sizeof(T) == 2) {
        *reinterpret_cast<uint32_t*>(dst) = pack_bf16(x, y);
      } else {
        dst[0] = x;
        dst[1] = y;
      }
    }
  }
}

template <typename T, int DH, bool EXACT>
cudaError_t launch_split_dh(const T* q, const T* k, const T* v, T* o,
                            int blocks, const SplitShape& s,
                            cudaStream_t st) {
  const size_t bytes = smem_split<T>(DH);
  const cudaError_t e =
      set_smem((const void*)split_heads_kernel<T, DH, EXACT>, bytes);
  if (e != cudaSuccess) return e;
  split_heads_kernel<T, DH, EXACT><<<blocks, STHREADS, bytes, st>>>(q, k, v,
                                                                     o, s);
  return cudaGetLastError();
}

template <typename T, bool EXACT>
cudaError_t launch_split(const T* q, const T* k, const T* v, T* o, int DH,
                         int blocks, const SplitShape& s, cudaStream_t st) {
  switch (DH) {
    case 16: return launch_split_dh<T, 16, EXACT>(q, k, v, o, blocks, s, st);
    case 32: return launch_split_dh<T, 32, EXACT>(q, k, v, o, blocks, s, st);
    case 64: return launch_split_dh<T, 64, EXACT>(q, k, v, o, blocks, s, st);
    default: return launch_split_dh<T, 128, EXACT>(q, k, v, o, blocks, s, st);
  }
}

// 0 when the kernels take head width DH on the current device,
// T2MS_UNSUPPORTED_SHAPE when they do not, else the CUDA error of the query.
// DH is 16, 32, 64 or 128 (whole 16-wide products over the head, 8-wide
// output tiles, 16-byte rows) and the block's shared memory fits what one
// block may opt in to on this device.
template <typename T> int check_split(int DH) {
  if (DH != 16 && DH != 32 && DH != 64 && DH != 128)
    return T2MS_UNSUPPORTED_SHAPE;
  const long long optin = smem_optin();
  if (optin < 0) return (int)-optin;
  return smem_split<T>(DH) <= (size_t)optin ? 0 : T2MS_UNSUPPORTED_SHAPE;
}

template <typename T>
int run_split(const T* q, const T* k, const T* v, T* o, int B, int H, int N,
              int DH, const SplitShape& s, bool exact, cudaStream_t st) {
  if (B < 1 || H < 1 || N < 1 ||
      (long long)B * H * ((N + SQ - 1) / SQ) > INT_MAX)
    return T2MS_UNSUPPORTED_SHAPE;
  const int ok = check_split<T>(DH);
  if (ok) return ok;
  const int blocks = B * H * ((N + SQ - 1) / SQ);
  return exact ? launch_split<T, true>(q, k, v, o, DH, blocks, s, st)
               : launch_split<T, false>(q, k, v, o, DH, blocks, s, st);
}

}  // namespace

#define T2MS_SPLIT_ENTRY(SUFFIX, T)                                           \
  extern "C" int split_heads_forward_##SUFFIX(                                \
      const void* q, const void* k, const void* v, void* o, int B, int H,     \
      int N, int DH, long long sqb, long long sqh, long long sqn,             \
      long long skb, long long skh, long long skn, long long svb,             \
      long long svh, long long svn, long long sob, long long soh,             \
      long long son, int exact, float scale, void* stream) {                  \
    const SplitShape s{{sqb, sqh, sqn}, {skb, skh, skn}, {svb, svh, svn},     \
                       {sob, soh, son}, H, N, scale};                         \
    return run_split<T>((const T*)q, (const T*)k, (const T*)v, (T*)o, B, H,  \
                        N, DH, s, exact != 0, (cudaStream_t)stream);         \
  }

T2MS_SPLIT_ENTRY(bf16, __nv_bfloat16)
T2MS_SPLIT_ENTRY(f32, float)

extern "C" int split_heads_check(int DH, int is_bf16) {
  return is_bf16 ? check_split<__nv_bfloat16>(DH) : check_split<float>(DH);
}

extern "C" const char* t2ms_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
