// LayerNorm + adaLN modulate, and the gated residual fused in front of it,
// forward and backward, hand-written for Hopper (sm_90a), bf16 and f32.
//
// Replaces the TPU kernels t2ms_tpu/ops/dit_block.py:_mod_ln_call
// (_mod_ln_fwd_kernel), _mod_ln_diff_bwd (_mod_ln_bwd_kernel),
// _res_mod_ln_call (_res_mod_ln_fwd_kernel) and _res_mod_ln_diff_bwd
// (_res_mod_ln_bwd_kernel), which the flax-path DiT block runs at its
// boundaries (the first block's leading LN+modulate, then every gated
// residual fused into the next LN+modulate):
//
//   mod_ln forward   out = T(LN(x) * (1 + scale) + shift), LN without scale
//             or bias in f32 (mean, then the variance of the centred row,
//             eps from the caller), the modulate in f32, one rounding.
//   mod_ln backward  with xh = LN(x), rs = 1 / sqrt(var + eps) and
//             g = f32(dy) * (1 + scale):
//             dx = T(rs * (g - mean(g) - xh * mean(g * xh))),
//             dshift = sum over rows of dy, dscale = sum over rows of dy * xh
//             (per batch element, in f32; the wrapper rounds them once to
//             mod2's dtype).
//   res forward      y = T(x + T(T(gate) * h)) (the gated residual in the
//             compute dtype, as the eager block), then out = the mod_ln
//             forward of y; emits (out, y).
//   res backward     from the cotangents do (of out) and dy (of y): the
//             mod_ln backward of y gives T(dln), the stream's total
//             cotangent is dt = T(T(dln) + dy), and dx = dt,
//             dh = T(dt * T(gate)), dgate = sum over rows of dt * h,
//             dshift = sum of do, dscale = sum of do * LN(y) (f32 sums,
//             rounded once to gm3's dtype). The JAX kernel takes this VJP
//             with jax.vjp inside its body; here it is written out.
//
// mod2 is (B, 2, D) = [shift, scale] and gm3 (B, 3, D) = [gate, shift,
// scale]. Every kernel reads them in place, bf16 or f32 (converted
// exactly in registers), rows of D contiguous at the caller's batch
// stride (the flax path hands over views of the (B, 6, D) modulation),
// and the backwards write dmod2 and dgm3 in the modulation's dtype,
// rounded once from the f32 totals.
//
// Bound on an H100 SXM: every kernel here moves a few (B, N, D) tensors and
// does a few f32 operations per element, so bytes bound it. At the scaled
// train step's call (B=64, N=1024, D=512, bf16) the mod_ln forward moves
// 134 MB (x in, out), 0.040 ms at 3.35 TB/s, its backward 201 MB (x, dy in,
// dx out), 0.060 ms; the res forward 268 MB (x, h in, out, y), 0.080 ms,
// its backward 403 MB (x, h, do, dy in, dx, dh out), 0.120 ms. So each
// reads its inputs once and writes once, and keeps everything else in
// registers: one warp per row, each lane holding its D/32 values; the
// backwards' per-column sums stay in each warp's registers over its rows of
// a 64-row tile of one element, then go through shared memory to one f32
// partial per (element, tile), summed over the tiles in a fixed order by
// dmod_reduce_kernel (dit_common.cuh). No atomics: runs repeat bit for bit.
//
// The bf16 res backward (D a multiple of 8; the others keep the kernel
// above) is res_mod_ln_bwd_vec_kernel: the lane-strided 2-byte accesses
// made a warp instruction move 64 bytes and each warp walked its rows one
// after another behind four serial 32-lane reductions, which held it near
// a quarter of its byte bound. It reads and writes 16-byte chunks (a warp
// instruction moves 512 bytes), issues a row's four loads before its first
// sum, spreads a narrow row over fewer lanes (D = 128: 16 lanes, two rows a
// warp), and keeps the per-column partials in registers, summed over the
// warps through a buffer half the size of the warp partials' above.
//
// The bf16 forwards and mod_ln backward (D a multiple of 8; f32 and other
// widths keep the lane-strided kernels) take the 16-byte chunks and lane
// groups above too, hold the lane's columns of the per-sample vectors in
// registers while its rows stay in one batch element (rather than read
// 2 * D or 3 * D of them for every row), and issue the next row's loads
// before this row's sums. mod_ln_fwd_vec_kernel and
// res_mod_ln_fwd_vec_kernel are persistent: each block walks one
// contiguous run of rows, its warps on neighbouring rows, reloading the
// vectors where the run crosses into the next element, so every block
// ends together. mod_ln_bwd_vec_kernel keeps the backward's 64-row tiles
// of one element and its ordered fold of the per-column partials. All
// three reach about 80% of their byte bound at the scaled call (B=64,
// N=1024, D=512), near 90% of the rate of PyTorch's own elementwise
// passes moving as many tensors; their loads and stores alone reach
// 79-84%, and neither the number of warps, the rows in flight, L2
// policies, the order of the rows nor a grid that is not persistent
// moved them (chip_smoke.py --mod_ln). The res backward reads its gate and scale
// again for each row with 16-byte loads (held in registers they made it
// spill), so its entry takes that route only for a bf16 gm3 view the
// loads may address or a contiguous f32 gm3; another goes to the
// lane-strided kernel.
//
// C interface for ctypes: {mod_ln,res_mod_ln}_{forward,backward}_{bf16,f32}
// launch on the given stream and return cudaGetLastError(), or
// T2MS_UNSUPPORTED_SHAPE (launching nothing) for a shape the kernels do not
// take; *_backward_workspace gives the bytes of the partials the caller
// allocates; mod_ln_check and res_mod_ln_check answer the shape question.

#include "dit_common.cuh"

#include <algorithm>
#include <type_traits>

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

// The host side's arguments of every launch; the kernels take them as
// __restrict__ parameters, so their loads may move ahead of their stores.
template <typename T> struct Args {
  const T* x;
  const T* h;       // the residual branch (res kernels)
  const void* mod;  // mod2 (B, 2, D) or gm3 (B, 3, D), in M (below)
  long long ms;     // its batch stride in elements
  const T* dout;    // the cotangent of the modulated output (backwards)
  const T* dy;      // the cotangent of the stream y (res backward)
  T* out;           // the forward's output, or dx
  T* out2;          // y (res forward), or dh (res backward)
  float* part;      // the backwards' per-tile partials
  int B, N, D;
  float eps;
};

// ------------------------------------------------------------- mod_ln

template <typename T, typename M, int V>
__global__ void __launch_bounds__(NT)
mod_ln_fwd_kernel(const T* __restrict__ x, const M* __restrict__ mod2,
                  long long ms, T* __restrict__ out, int rows, int N, int D,
                  float eps) {
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
  const M* sh = mod2 + (r / N) * ms;
  const M* sc = sh + D;
  T* o = out + (size_t)r * D;
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const int c = lane + 32 * u;
    if (c < D)
      o[c] = from_f<T>((v[u] - mu) * rs * (1.0f + to_f<M>(sc[c])) +
                       to_f<M>(sh[c]));
  }
}

// The block's warp partials Ps (NW x W x D) summed over the warps into
// part[blockIdx.x] (W x D), in a fixed order.
__device__ void flush_partials(const float* Ps, int W, int D,
                               float* __restrict__ part) {
  __syncthreads();
  for (int j = threadIdx.x; j < W * D; j += NT) {
    float s = 0.0f;
    for (int w = 0; w < NW; ++w) s += Ps[w * W * D + j];
    part[(size_t)blockIdx.x * W * D + j] = s;
  }
}

// One block per 64-row tile of one element: dx of its rows and the tile's
// f32 partials part[blockIdx.x] = [sum dy, sum dy * xh] (2 x D).
template <typename T, typename M, int V>
__global__ void __launch_bounds__(NT)
mod_ln_bwd_kernel(const T* __restrict__ x, const M* __restrict__ mod2,
                  long long ms, const T* __restrict__ dy, T* __restrict__ dx,
                  float* __restrict__ part, int N, int D, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ps = reinterpret_cast<float*>(smem);  // NW x 2 x D warp partials
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles = (N + MLN_ROWS - 1) / MLN_ROWS;
  const int b = blockIdx.x / tiles, n0 = (blockIdx.x % tiles) * MLN_ROWS;
  const int valid = min(MLN_ROWS, N - n0);
  const M* sc = mod2 + b * ms + D;
  float scp[V], psh[V], psc[V];
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const int c = lane + 32 * u;
    scp[u] = c < D ? 1.0f + to_f<M>(sc[c]) : 0.0f;
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
  flush_partials(Ps, 2, D, part);
}

// --------------------------------------------- gated residual + mod_ln

// y = T(x + T(T(gate) * h)) of a row, lane-strided into v (h kept in hv)
template <typename T, int V>
__device__ __forceinline__ void res_row(const T* __restrict__ xr,
                                        const T* __restrict__ hr, int D,
                                        const float (&gt)[V], float (&v)[V],
                                        float (&hv)[V]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const int c = lane + 32 * u;
    hv[u] = c < D ? to_f<T>(hr[c]) : 0.0f;
    v[u] = c < D ? rnd<T>(to_f<T>(xr[c]) + rnd<T>(gt[u] * hv[u])) : 0.0f;
  }
}

template <typename T, typename M, int V>
__global__ void __launch_bounds__(NT)
res_mod_ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ h,
                      const M* __restrict__ gm3, long long ms,
                      T* __restrict__ out, T* __restrict__ y, int rows, int N,
                      int D, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = blockIdx.x * NW + warp;
  if (r >= rows) return;
  const M* gate = gm3 + (r / N) * ms;
  const M* sh = gate + D;
  const M* sc = gate + 2 * D;
  float gt[V], v[V], hv[V];
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const int c = lane + 32 * u;
    gt[u] = c < D ? rnd<T>(to_f<M>(gate[c])) : 0.0f;
  }
  res_row<T, V>(x + (size_t)r * D, h + (size_t)r * D, D, gt, v, hv);
  T* yo = y + (size_t)r * D;
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const int c = lane + 32 * u;
    if (c < D) yo[c] = from_f<T>(v[u]);
  }
  float rs;
  const float mu = row_stats<V>(v, D, eps, rs);
  T* o = out + (size_t)r * D;
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const int c = lane + 32 * u;
    if (c < D)
      o[c] = from_f<T>((v[u] - mu) * rs * (1.0f + to_f<M>(sc[c])) +
                       to_f<M>(sh[c]));
  }
}

// One block per 64-row tile of one element: dx and dh of its rows and the
// tile's f32 partials part[blockIdx.x] = [sum dt * h, sum do, sum do * xh]
// (3 x D), the forward recomputed from x and h.
template <typename T, typename M, int V>
__global__ void __launch_bounds__(NT)
res_mod_ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ h,
                      const M* __restrict__ gm3, long long ms,
                      const T* __restrict__ dout, const T* __restrict__ dy,
                      T* __restrict__ dx, T* __restrict__ dh,
                      float* __restrict__ part, int N, int D, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ps = reinterpret_cast<float*>(smem);  // NW x 3 x D warp partials
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles = (N + MLN_ROWS - 1) / MLN_ROWS;
  const int b = blockIdx.x / tiles, n0 = (blockIdx.x % tiles) * MLN_ROWS;
  const int valid = min(MLN_ROWS, N - n0);
  const M* gate = gm3 + b * ms;
  const M* sc = gate + 2 * D;
  float gt[V], scp[V], pg[V], psh[V], psc[V];
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const int c = lane + 32 * u;
    gt[u] = c < D ? rnd<T>(to_f<M>(gate[c])) : 0.0f;
    scp[u] = c < D ? 1.0f + to_f<M>(sc[c]) : 0.0f;
    pg[u] = psh[u] = psc[u] = 0.0f;
  }
  for (int i = warp; i < valid; i += NW) {
    const size_t r = (size_t)b * N + n0 + i;
    float v[V], hv[V], d[V];
    res_row<T, V>(x + r * D, h + r * D, D, gt, v, hv);
    const T* dr = dout + r * D;
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const int c = lane + 32 * u;
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
    const T* yr = dy + r * D;
    T* dxo = dx + r * D;
    T* dho = dh + r * D;
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const int c = lane + 32 * u;
      if (c < D) {
        const float dt = rnd<T>(rnd<T>(rs * (d[u] - mg - v[u] * mgx)) +
                                to_f<T>(yr[c]));
        dxo[c] = from_f<T>(dt);
        dho[c] = from_f<T>(dt * gt[u]);
        pg[u] += dt * hv[u];
      }
    }
  }
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const int c = lane + 32 * u;
    if (c < D) {
      Ps[(warp * 3) * D + c] = pg[u];
      Ps[(warp * 3 + 1) * D + c] = psh[u];
      Ps[(warp * 3 + 2) * D + c] = psc[u];
    }
  }
  flush_partials(Ps, 3, D, part);
}

// bf16 backward of the gated residual on 16-byte chunks: a row of D
// values (D a multiple of 8) is D / 8 chunks spread over a group of G lanes
// (the next power of two of D / 8, at most 32; 32 / G rows of a warp at
// once), lane l of a group holding chunks l, l + G, ... (CPL of them). Each
// lane loads its chunks of x, h, do and dy with one 16-byte load each, all
// issued before the row's first sum, and stores dx and dh the same way; a
// row's sums are chains of log2(G) shuffles. The lane's per-column partials
// stay in registers over the warp's rows, then add up across the warp's
// groups (shuffles) and across the 8 warps through a (NW / 2) x 3 x D
// buffer, warp w + h into warp w for h = 4, 2, 1: a fixed order. The
// arithmetic and its rounding points are res_mod_ln_bwd_kernel's. gm3 is
// read in place by 16-byte loads: its rows must be 16-byte aligned, and an
// f32 one contiguous (the entry checks).

using bf16 = __nv_bfloat16;

// two floats rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// the 8 floats at q (16-byte aligned) from p, or added into p
__device__ __forceinline__ void put8(float* q, const float (&p)[8]) {
  reinterpret_cast<float4*>(q)[0] = make_float4(p[0], p[1], p[2], p[3]);
  reinterpret_cast<float4*>(q)[1] = make_float4(p[4], p[5], p[6], p[7]);
}
__device__ __forceinline__ void add8(const float* q, float (&p)[8]) {
  const float4 a = reinterpret_cast<const float4*>(q)[0];
  const float4 c = reinterpret_cast<const float4*>(q)[1];
  p[0] += a.x, p[1] += a.y, p[2] += a.z, p[3] += a.w;
  p[4] += c.x, p[5] += c.y, p[6] += c.z, p[7] += c.w;
}
// the 8 values at q (16-byte aligned) as floats, loaded where they are
// used: the volatile loads stay in the row loop (the gate and scale,
// hoisted into registers for the whole loop, made the kernel spill)
__device__ __forceinline__ void ldg8(const float* q, float (&f)[8]) {
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(f[0]), "=f"(f[1]), "=f"(f[2]), "=f"(f[3])
               : "l"(q));
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4+16];\n"
               : "=f"(f[4]), "=f"(f[5]), "=f"(f[6]), "=f"(f[7])
               : "l"(q));
}
__device__ __forceinline__ void ldg8(const bf16* q, float (&f)[8]) {
  uint4 u;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w)
               : "l"(q));
  unpack8(u, f);
}

// the sum over an aligned group of G lanes (G a power of two)
template <int G> __device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The lane's per-column sums p (W x D over the block) added up across the
// warp's groups (shuffles), then warp w + half into warp w for half =
// NW / 2, ..., 1 through Ps ((NW / 2) x W x D floats): a fixed order; warp
// 0's sums go to out (W x D).
template <int CPL, int G, int W>
__device__ __forceinline__ void fold_partials(float (&p)[W][CPL][8],
                                              float* Ps,
                                              float* __restrict__ out,
                                              int D) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gi = lane / G, l = lane % G, nch = D / 8;
#pragma unroll
  for (int o = G; o < 32; o <<= 1) {
#pragma unroll
    for (int u = 0; u < W; ++u) {
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          p[u][j][k] += __shfl_xor_sync(0xffffffffu, p[u][j][k], o);
      }
    }
  }
  auto io = [&](float* buf, bool add) {
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      if (l + G * j >= nch) continue;
#pragma unroll
      for (int u = 0; u < W; ++u) {
        float* c = buf + u * D + 8 * (l + G * j);
        if (add)
          add8(c, p[u][j]);
        else
          put8(c, p[u][j]);
      }
    }
  };
#pragma unroll
  for (int half = NW / 2; half >= 1; half /= 2) {
    if (gi == 0 && warp >= half && warp < 2 * half)
      io(Ps + (size_t)(warp - half) * W * D, false);
    __syncthreads();
    if (gi == 0 && warp < half) io(Ps + (size_t)warp * W * D, true);
    __syncthreads();
  }
  if (warp == 0 && gi == 0) io(out, false);
}

template <int CPL, int G, typename M>
__global__ void __launch_bounds__(NT, CPL <= 2 ? 2 : 1)
res_mod_ln_bwd_vec_kernel(const bf16* __restrict__ x,
                          const bf16* __restrict__ h,
                          const M* __restrict__ gm3, long long ms,
                          const bf16* __restrict__ dout,
                          const bf16* __restrict__ dy, bf16* __restrict__ dx,
                          bf16* __restrict__ dh, float* __restrict__ part,
                          int N, int D, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int RPW = 32 / G;                  // rows of a warp at once
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gi = lane / G, l = lane % G, nch = D / 8;
  const int tiles = (N + MLN_ROWS - 1) / MLN_ROWS;
  const int b = blockIdx.x / tiles, n0 = (blockIdx.x % tiles) * MLN_ROWS;
  const int valid = min(MLN_ROWS, N - n0);
  // an f32 gm3 comes contiguous (the entry sees to it) and its stride is
  // formed here: with the stride parameter ptxas spilled 20 B more at D 512
  const M* gate = gm3 + (sizeof(M) == 4 ? (size_t)b * 3 * D : b * ms);
  const M* sc = gate + 2 * D;
  // the lane's chunk j: its first column (clamped for a lane without one)
  auto col = [&](int j) { return 8 * min(l + G * j, nch - 1); };
  float p[3][CPL][8];  // [sum dt * h, sum do, sum do * xh]
  auto& pg = p[0];
  auto& psh = p[1];
  auto& psc = p[2];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
#pragma unroll
    for (int k = 0; k < 8; ++k) pg[j][k] = psh[j][k] = psc[j][k] = 0.0f;
  }
  // every lane of a warp runs every pass (the shuffles take the whole
  // warp); a row past `valid` loads zeros and adds nothing
  for (int i0 = warp * RPW; i0 < valid; i0 += NW * RPW) {
    const int i = i0 + gi;
    const size_t r = (size_t)b * N + n0 + min(i, valid - 1);
    bool on[CPL];
    uint4 ux[CPL], uh[CPL], ud[CPL], uy[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      on[j] = i < valid && l + G * j < nch;
      const size_t o = r * D + col(j);
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
      ux[j] = on[j] ? *reinterpret_cast<const uint4*>(x + o) : z;
      uh[j] = on[j] ? *reinterpret_cast<const uint4*>(h + o) : z;
      ud[j] = on[j] ? *reinterpret_cast<const uint4*>(dout + o) : z;
      uy[j] = on[j] ? *reinterpret_cast<const uint4*>(dy + o) : z;
    }
    // y = T(x + T(T(gate) * h)), then its f32 mean and 1 / sqrt(var + eps)
    float v[CPL][8];
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      float xv[8], hv[8], gs[8];
      unpack8(ux[j], xv);
      unpack8(uh[j], hv);
      ldg8(gate + col(j), gs);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        v[j][k] = rnd<bf16>(xv[k] + rnd<bf16>(rnd<bf16>(gs[k]) * hv[k]));
        s += on[j] ? v[j][k] : 0.0f;
      }
    }
    const float mu = group_sum<G>(s) / D;
    float q = 0.0f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float dv = on[j] ? v[j][k] - mu : 0.0f;
        q += dv * dv;
      }
    }
    const float rs = rsqrtf(group_sum<G>(q) / D + eps);
    // xh, the column sums of do and do * xh, g = do * (1 + scale) (formed
    // again below from the packed do: fewer live registers)
    auto grad = [&](int j, float (&d)[8]) {
      float scj[8];
      ldg8(sc + col(j), scj);
      unpack8(ud[j], d);
#pragma unroll
      for (int k = 0; k < 8; ++k) d[k] *= 1.0f + scj[k];
    };
    float sg = 0.0f, sgx = 0.0f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      float d[8], g[8];
      unpack8(ud[j], d);
      grad(j, g);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        v[j][k] = on[j] ? (v[j][k] - mu) * rs : 0.0f;  // xh
        psh[j][k] += d[k];
        psc[j][k] += d[k] * v[j][k];
        sg += g[k];
        sgx += g[k] * v[j][k];
      }
    }
    const float mg = group_sum<G>(sg) / D, mgx = group_sum<G>(sgx) / D;
    // dt = T(T(dln) + dy): dx = dt, dh = T(dt * T(gate)), dgate += dt * h
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      if (!on[j]) continue;
      float yv[8], hv[8], gs[8], dt[8], g[8];
      unpack8(uy[j], yv);
      unpack8(uh[j], hv);
      ldg8(gate + col(j), gs);
      grad(j, g);
      uint32_t wx[4], wh[4];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        dt[k] = rnd<bf16>(rnd<bf16>(rs * (g[k] - mg - v[j][k] * mgx)) +
                          yv[k]);
        gs[k] = rnd<bf16>(gs[k]);
        pg[j][k] += dt[k] * hv[k];
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        wx[k] = pack2(dt[2 * k], dt[2 * k + 1]);
        wh[k] = pack2(dt[2 * k] * gs[2 * k], dt[2 * k + 1] * gs[2 * k + 1]);
      }
      const size_t o = r * D + col(j);
      *reinterpret_cast<uint4*>(dx + o) =
          make_uint4(wx[0], wx[1], wx[2], wx[3]);
      *reinterpret_cast<uint4*>(dh + o) =
          make_uint4(wh[0], wh[1], wh[2], wh[3]);
    }
  }

  fold_partials<CPL, G, 3>(p, reinterpret_cast<float*>(smem),
                           part + (size_t)blockIdx.x * 3 * D, D);
}

// ---------- bf16 res forward and mod_ln backward on 16-byte chunks

// The eight values of a per-sample vector (gate, shift or scale) at a
// lane's chunk, held in registers while the lane's rows stay in one batch
// element: bf16 as its bits (4 registers), f32 as is. Scalar loads, so the
// caller's views need no alignment; they run once per element a lane
// meets.
template <typename M> struct Mod8;
template <> struct Mod8<bf16> {
  uint32_t w[4];
  __device__ __forceinline__ void load(const bf16* p) {
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = (uint32_t)q[2 * k] | (uint32_t)q[2 * k + 1] << 16;
  }
  __device__ __forceinline__ void round_to_bf16() {}  // exact already
  __device__ __forceinline__ float operator[](int k) const {
    return __uint_as_float(k % 2 ? w[k / 2] & 0xffff0000u : w[k / 2] << 16);
  }
};
template <> struct Mod8<float> {
  float f[8];
  __device__ __forceinline__ void load(const float* p) {
#pragma unroll
    for (int k = 0; k < 8; ++k) f[k] = p[k];
  }
  __device__ __forceinline__ void round_to_bf16() {
#pragma unroll
    for (int k = 0; k < 8; ++k) f[k] = rnd<bf16>(f[k]);
  }
  __device__ __forceinline__ float operator[](int k) const { return f[k]; }
};

__device__ __forceinline__ uint4 ld16(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void st16(bf16* p, const uint4& v) {
  *reinterpret_cast<uint4*>(p) = v;
}

// The res forward, y = T(x + T(T(gate) * h)) and out = T((y - mu) * rs *
// (1 + scale) + shift), with res_row's and row_stats' rounding points and
// f32 statistics (the mean, then the variance of the centred row). A row
// is D / 8 chunks over a group of G lanes, RPW = 32 / G rows a warp at
// once (one "slot"). Persistent: block k of the grid's K takes the slots
// [k * S / K, (k + 1) * S / K) of all S, so runs differ by one slot at
// most, its warp w the slots w, w + NW, ... of them (the block's warps on
// neighbouring rows), and each warp loads its next slot while it reduces
// and stores this one.
template <int CPL, int G, typename M>
__global__ void __launch_bounds__(NT, CPL <= 2 ? 2 : 1)
res_mod_ln_fwd_vec_kernel(const bf16* __restrict__ x,
                          const bf16* __restrict__ h,
                          const M* __restrict__ gm3, long long ms,
                          bf16* __restrict__ out, bf16* __restrict__ y,
                          int rows, int N, int D, float eps) {
  constexpr int RPW = 32 / G;
  const int lane = threadIdx.x % 32, gi = lane / G, l = lane % G;
  const int nch = D / 8;
  const long long S = (rows + RPW - 1) / RPW;
  const long long s1 = (blockIdx.x + 1LL) * S / gridDim.x;
  const long long s0 = blockIdx.x * S / gridDim.x + threadIdx.x / 32;
  auto col = [&](int j) { return 8 * min(l + G * j, nch - 1); };
  auto on = [&](long long r, int j) { return r < rows && l + G * j < nch; };
  auto fetch = [&](long long s, uint4 (&ux)[CPL], uint4 (&uh)[CPL]) {
    const long long r = s * RPW + gi;
    const size_t base = (size_t)min(r, (long long)rows - 1) * D;
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      ux[j] = on(r, j) ? ld16(x + base + col(j)) : z;
      uh[j] = on(r, j) ? ld16(h + base + col(j)) : z;
    }
  };
  Mod8<M> gt[CPL], sh[CPL], sc[CPL];
  long long cb = -1;  // the element whose vectors the lane holds
  uint4 ux[CPL], uh[CPL];
  if (s0 < s1) fetch(s0, ux, uh);
  for (long long s = s0; s < s1; s += NW) {
    uint4 nx[CPL], nh[CPL];
    if (s + NW < s1) fetch(s + NW, nx, nh);
    const long long r = s * RPW + gi;
    if (r < rows && r / N != cb) {
      cb = r / N;
      const M* g = gm3 + cb * ms;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        gt[j].load(g + col(j));
        gt[j].round_to_bf16();
        sh[j].load(g + D + col(j));
        sc[j].load(g + 2 * D + col(j));
      }
    }
    // y as bf16 bits (exact: it is rounded), its mean and 1 / sqrt(var + eps)
    uint4 yc[CPL];
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      float xv[8], hv[8], yv[8];
      unpack8(ux[j], xv);
      unpack8(uh[j], hv);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        yv[k] = rnd<bf16>(xv[k] + rnd<bf16>(gt[j][k] * hv[k]));
        sum += on(r, j) ? yv[k] : 0.0f;
      }
      yc[j] = make_uint4(pack2(yv[0], yv[1]), pack2(yv[2], yv[3]),
                         pack2(yv[4], yv[5]), pack2(yv[6], yv[7]));
    }
    const float mu = group_sum<G>(sum) / D;
    float q = 0.0f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      float yv[8];
      unpack8(yc[j], yv);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float d = on(r, j) ? yv[k] - mu : 0.0f;
        q += d * d;
      }
    }
    const float rs = rsqrtf(group_sum<G>(q) / D + eps);
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      if (!on(r, j)) continue;
      float yv[8], o[8];
      unpack8(yc[j], yv);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        o[k] = (yv[k] - mu) * rs * (1.0f + sc[j][k]) + sh[j][k];
      const size_t at = (size_t)r * D + col(j);
      st16(y + at, yc[j]);
      st16(out + at, make_uint4(pack2(o[0], o[1]), pack2(o[2], o[3]),
                                pack2(o[4], o[5]), pack2(o[6], o[7])));
    }
    if (s + NW < s1) {
#pragma unroll
      for (int j = 0; j < CPL; ++j) ux[j] = nx[j], uh[j] = nh[j];
    }
  }
}

// The mod_ln forward, out = T((x - mu) * rs * (1 + scale) + shift) with
// mod_ln_fwd_kernel's arithmetic, on the chunks, lane groups and
// persistent runs of slots of res_mod_ln_fwd_vec_kernel (without its
// residual): the lane's columns of shift and scale held in registers
// while its rows stay in one element, the next slot's x loaded while
// this one is reduced and stored. Slots and rows are counted in 32 bits
// (B * N <= INT_MAX, so rows + 31 fits an unsigned): at the long call (D
// 128, two rows a slot) the 64-bit counters of res_mod_ln_fwd_vec_kernel
// cost this kernel a tenth of its time. A lane divides by N only where
// its row passes the end of the element whose vectors it holds.
template <int CPL, int G, typename M>
__global__ void __launch_bounds__(NT, CPL <= 2 ? 2 : 1)
mod_ln_fwd_vec_kernel(const bf16* __restrict__ x, const M* __restrict__ mod2,
                      long long ms, bf16* __restrict__ out, int rows, int N,
                      int D, float eps) {
  constexpr int RPW = 32 / G;
  const int lane = threadIdx.x % 32, gi = lane / G, l = lane % G;
  const int nch = D / 8;
  const unsigned S = ((unsigned)rows + RPW - 1) / RPW;
  const unsigned s1 = (unsigned)((blockIdx.x + 1ULL) * S / gridDim.x);
  const unsigned s0 =
      (unsigned)(blockIdx.x * (unsigned long long)S / gridDim.x) +
      threadIdx.x / 32;
  auto col = [&](int j) { return 8 * min(l + G * j, nch - 1); };
  auto on = [&](unsigned r, int j) {
    return r < (unsigned)rows && l + G * j < nch;
  };
  auto fetch = [&](unsigned s, uint4 (&ux)[CPL]) {
    const unsigned r = s * RPW + gi;
    const size_t base = (size_t)min(r, (unsigned)rows - 1) * D;
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int j = 0; j < CPL; ++j)
      ux[j] = on(r, j) ? ld16(x + base + col(j)) : z;
  };
  Mod8<M> sh[CPL], sc[CPL];
  unsigned nb = 0;  // the end row of the element whose vectors it holds
  uint4 ux[CPL];
  if (s0 < s1) fetch(s0, ux);
  for (unsigned s = s0; s < s1; s += NW) {
    uint4 nx[CPL];
    if (s + NW < s1) fetch(s + NW, nx);
    const unsigned r = s * RPW + gi;
    if (r < (unsigned)rows && r >= nb) {
      const unsigned cb = r / N;
      nb = (cb + 1) * N;
      const M* m = mod2 + (long long)cb * ms;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        sh[j].load(m + col(j));
        sc[j].load(m + D + col(j));
      }
    }
    // the row's f32 mean, then 1 / sqrt(var + eps) of the centred row
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      float xv[8];
      unpack8(ux[j], xv);
#pragma unroll
      for (int k = 0; k < 8; ++k) sum += on(r, j) ? xv[k] : 0.0f;
    }
    const float mu = group_sum<G>(sum) / D;
    float q = 0.0f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      float xv[8];
      unpack8(ux[j], xv);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float d = on(r, j) ? xv[k] - mu : 0.0f;
        q += d * d;
      }
    }
    const float rs = rsqrtf(group_sum<G>(q) / D + eps);
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      if (!on(r, j)) continue;
      float xv[8], o[8];
      unpack8(ux[j], xv);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        o[k] = (xv[k] - mu) * rs * (1.0f + sc[j][k]) + sh[j][k];
      st16(out + (size_t)r * D + col(j),
           make_uint4(pack2(o[0], o[1]), pack2(o[2], o[3]), pack2(o[4], o[5]),
                      pack2(o[6], o[7])));
    }
    if (s + NW < s1) {
#pragma unroll
      for (int j = 0; j < CPL; ++j) ux[j] = nx[j];
    }
  }
}

// The mod_ln backward on the chunks and lane groups above, one block per
// 64-row tile of one element, with mod_ln_bwd_kernel's arithmetic: dx of
// its rows and part[blockIdx.x] = [sum dy, sum dy * xh] (2 x D). The
// lane's (1 + scale) columns are read once; each warp loads its next rows
// while it reduces and stores these.
template <int CPL, int G, typename M>
__global__ void __launch_bounds__(NT, CPL <= 2 ? 2 : 1)
mod_ln_bwd_vec_kernel(const bf16* __restrict__ x, const M* __restrict__ mod2,
                      long long ms, const bf16* __restrict__ dy,
                      bf16* __restrict__ dx, float* __restrict__ part, int N,
                      int D, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int RPW = 32 / G, STEP = NW * RPW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gi = lane / G, l = lane % G, nch = D / 8;
  const int tiles = (N + MLN_ROWS - 1) / MLN_ROWS;
  const int b = blockIdx.x / tiles, n0 = (blockIdx.x % tiles) * MLN_ROWS;
  const int valid = min(MLN_ROWS, N - n0);
  auto col = [&](int j) { return 8 * min(l + G * j, nch - 1); };
  auto on = [&](int i, int j) { return i < valid && l + G * j < nch; };
  auto fetch = [&](int i0, uint4 (&ux)[CPL], uint4 (&ud)[CPL]) {
    const int i = i0 + gi;
    const size_t base = ((size_t)b * N + n0 + min(i, valid - 1)) * D;
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      ux[j] = on(i, j) ? ld16(x + base + col(j)) : z;
      ud[j] = on(i, j) ? ld16(dy + base + col(j)) : z;
    }
  };
  Mod8<M> sc[CPL];
  float p[2][CPL][8];  // [sum dy, sum dy * xh] of the lane's columns
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    sc[j].load(mod2 + b * ms + D + col(j));
#pragma unroll
    for (int k = 0; k < 8; ++k) p[0][j][k] = p[1][j][k] = 0.0f;
  }
  // every lane of a warp runs every pass (the shuffles take the whole
  // warp); a row past `valid` loads zeros and adds nothing
  uint4 ux[CPL], ud[CPL];
  if (warp * RPW < valid) fetch(warp * RPW, ux, ud);
  for (int i0 = warp * RPW; i0 < valid; i0 += STEP) {
    uint4 nx[CPL], nd[CPL];
    if (i0 + STEP < valid) fetch(i0 + STEP, nx, nd);
    const int i = i0 + gi;
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      float xv[8];
      unpack8(ux[j], xv);
#pragma unroll
      for (int k = 0; k < 8; ++k) sum += on(i, j) ? xv[k] : 0.0f;
    }
    const float mu = group_sum<G>(sum) / D;
    float q = 0.0f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      float xv[8];
      unpack8(ux[j], xv);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float d = on(i, j) ? xv[k] - mu : 0.0f;
        q += d * d;
      }
    }
    const float rs = rsqrtf(group_sum<G>(q) / D + eps);
    // xh, the column sums of dy and dy * xh, g = dy * (1 + scale) (xh and g
    // formed again below from the packed rows: fewer live registers)
    float sg = 0.0f, sgx = 0.0f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      float xv[8], d[8];
      unpack8(ux[j], xv);
      unpack8(ud[j], d);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float xh = on(i, j) ? (xv[k] - mu) * rs : 0.0f;
        const float g = d[k] * (1.0f + sc[j][k]);
        p[0][j][k] += d[k];
        p[1][j][k] += d[k] * xh;
        sg += g;
        sgx += g * xh;
      }
    }
    const float mg = group_sum<G>(sg) / D, mgx = group_sum<G>(sgx) / D;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      if (!on(i, j)) continue;
      float xv[8], d[8], o[8];
      unpack8(ux[j], xv);
      unpack8(ud[j], d);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float xh = (xv[k] - mu) * rs;
        o[k] = rs * (d[k] * (1.0f + sc[j][k]) - mg - xh * mgx);
      }
      st16(dx + ((size_t)b * N + n0 + i) * D + col(j),
           make_uint4(pack2(o[0], o[1]), pack2(o[2], o[3]), pack2(o[4], o[5]),
                      pack2(o[6], o[7])));
    }
    if (i0 + STEP < valid) {
#pragma unroll
      for (int j = 0; j < CPL; ++j) ux[j] = nx[j], ud[j] = nd[j];
    }
  }
  fold_partials<CPL, G, 2>(p, reinterpret_cast<float*>(smem),
                           part + (size_t)blockIdx.x * 2 * D, D);
}

// ------------------------------------------------------------ launches

// shared memory of a backward with W per-column sums: NW x W x D floats
size_t smem_bwd(int W, int D) { return (size_t)NW * W * D * 4; }

// 0 when the kernels take rows of D values with W sums in their backward on
// the current device, T2MS_UNSUPPORTED_SHAPE when they do not, else the CUDA
// error of the query. A lane holds at most 32 values of a row, so
// D <= 1024; the backward's warp partials fit what one block may opt in to.
int check_rows(int D, int W) {
  if (D < 1 || D > MLN_MAXD) return T2MS_UNSUPPORTED_SHAPE;
  const long long optin = smem_optin();
  if (optin < 0) return (int)-optin;
  return smem_bwd(W, D) <= (size_t)optin ? 0 : T2MS_UNSUPPORTED_SHAPE;
}

// 0 when the kernels take (B, N, D) with W backward sums (rows of (B*N, D)
// and the backward's B * tiles blocks are indexed as int), else as
// check_rows
int check_call(int B, int N, int D, int W) {
  if (B < 1 || N < 1 || (long long)B * N > INT_MAX)
    return T2MS_UNSUPPORTED_SHAPE;
  return check_rows(D, W);
}

// the forwards: one warp per row of (B*N, D)
template <typename T, typename M, int V, bool RES> struct Forward {
  static cudaError_t run(const Args<T>& a, cudaStream_t st) {
    const int rows = a.B * a.N;
    const unsigned blocks = (unsigned)(((long long)rows + NW - 1) / NW);
    if constexpr (RES)
      res_mod_ln_fwd_kernel<T, M, V><<<blocks, NT, 0, st>>>(
          a.x, a.h, (const M*)a.mod, a.ms, a.out, a.out2, rows, a.N, a.D,
          a.eps);
    else
      mod_ln_fwd_kernel<T, M, V><<<blocks, NT, 0, st>>>(
          a.x, (const M*)a.mod, a.ms, a.out, rows, a.N, a.D, a.eps);
    return cudaGetLastError();
  }
};

// the backwards: one block per 64-row tile of one element
template <typename T, typename M, int V, bool RES> struct Backward {
  static cudaError_t run(const Args<T>& a, cudaStream_t st) {
    const size_t s = smem_bwd(RES ? 3 : 2, a.D);
    const int blocks = a.B * ((a.N + MLN_ROWS - 1) / MLN_ROWS);
    cudaError_t e;
    if constexpr (RES) {
      if ((e = set_smem((const void*)res_mod_ln_bwd_kernel<T, M, V>, s)))
        return e;
      res_mod_ln_bwd_kernel<T, M, V><<<blocks, NT, s, st>>>(
          a.x, a.h, (const M*)a.mod, a.ms, a.dout, a.dy, a.out, a.out2,
          a.part, a.N, a.D, a.eps);
    } else {
      if ((e = set_smem((const void*)mod_ln_bwd_kernel<T, M, V>, s)))
        return e;
      mod_ln_bwd_kernel<T, M, V><<<blocks, NT, s, st>>>(
          a.x, (const M*)a.mod, a.ms, a.dout, a.out, a.part, a.N, a.D, a.eps);
    }
    return cudaGetLastError();
  }
};

// L<T, M, V, RES>::run with V the values a lane holds for a row of D (the
// next power of two of D / 32), after the shape checks.
template <template <typename, typename, int, bool> class L, typename T,
          typename M, bool RES>
int by_lanes(const Args<T>& a, cudaStream_t st) {
  const int ok = check_call(a.B, a.N, a.D, RES ? 3 : 2);
  if (ok) return ok;
  if (a.D <= 32) return L<T, M, 1, RES>::run(a, st);
  if (a.D <= 64) return L<T, M, 2, RES>::run(a, st);
  if (a.D <= 128) return L<T, M, 4, RES>::run(a, st);
  if (a.D <= 256) return L<T, M, 8, RES>::run(a, st);
  if (a.D <= 512) return L<T, M, 16, RES>::run(a, st);
  return L<T, M, 32, RES>::run(a, st);
}

// The bf16 kernels on 16-byte chunks (D a multiple of 8): f(CPL, G) with
// CPL chunks a lane in groups of G lanes, after the shape checks; the
// chunks' tensors 16-byte aligned (the wrappers see to it).
template <typename F>
int by_chunks(const Args<bf16>& a, int W, F&& f) {
  const int ok = check_call(a.B, a.N, a.D, W);
  if (ok) return ok;
  for (const void* p : {(const void*)a.x, (const void*)a.h,
                        (const void*)a.dout, (const void*)a.dy,
                        (const void*)a.out, (const void*)a.out2})
    if ((uintptr_t)p % 16) return T2MS_UNSUPPORTED_SHAPE;
  using std::integral_constant;
  const int nch = a.D / 8;
  if (nch <= 8)
    return f(integral_constant<int, 1>(), integral_constant<int, 8>());
  if (nch <= 16)
    return f(integral_constant<int, 1>(), integral_constant<int, 16>());
  if (nch <= 32)
    return f(integral_constant<int, 1>(), integral_constant<int, 32>());
  if (nch <= 64)
    return f(integral_constant<int, 2>(), integral_constant<int, 32>());
  if (nch <= 96)
    return f(integral_constant<int, 3>(), integral_constant<int, 32>());
  return f(integral_constant<int, 4>(), integral_constant<int, 32>());
}

// the bf16 backwards on 16-byte chunks: one block per 64-row tile, the
// warps' partials summed through (NW / 2) x W x D floats
template <int W, typename K, typename... P>
cudaError_t launch_tiles(K kernel, const Args<bf16>& a, cudaStream_t st,
                         P... args) {
  const size_t s = (size_t)(NW / 2) * W * a.D * 4;
  const cudaError_t e = set_smem((const void*)kernel, s);
  if (e) return e;
  const int blocks = a.B * ((a.N + MLN_ROWS - 1) / MLN_ROWS);
  kernel<<<blocks, NT, s, st>>>(args...);
  return cudaGetLastError();
}

template <typename M> int res_bwd_vec(const Args<bf16>& a, cudaStream_t st) {
  return by_chunks(a, 3, [&](auto cpl, auto g) {
    return launch_tiles<3>(
        res_mod_ln_bwd_vec_kernel<decltype(cpl)::value, decltype(g)::value,
                                  M>,
        a, st, a.x, a.h, (const M*)a.mod, a.ms, a.dout, a.dy, a.out, a.out2,
        a.part, a.N, a.D, a.eps);
  });
}

template <typename M> int mod_bwd_vec(const Args<bf16>& a, cudaStream_t st) {
  return by_chunks(a, 2, [&](auto cpl, auto g) {
    return launch_tiles<2>(
        mod_ln_bwd_vec_kernel<decltype(cpl)::value, decltype(g)::value, M>,
        a, st, a.x, (const M*)a.mod, a.ms, a.dout, a.out, a.part, a.N, a.D,
        a.eps);
  });
}

// Blocks of `kernel` (NT threads, no dynamic shared memory) an SM holds
// at once, or a negative CUDA error.
int blocks_per_sm(const void* kernel) {
  int n = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, NT, 0);
  return e ? -(int)e : n;
}

// The grid of a persistent forward over `rows` rows in lane groups of G:
// as many blocks as the device holds at once (per_sm a SM), fewer for a
// call of fewer slots than that holds warps; or a negative CUDA error.
long long persistent_blocks(int per_sm, int rows, int G) {
  if (per_sm <= 0)
    return per_sm ? per_sm : -(long long)cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (!e) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
  if (e) return -(long long)e;
  const long long slots = (rows + 32 / G - 1) / (32 / G);
  return std::min((long long)sms * per_sm, (slots + NW - 1) / NW);
}

// the persistent bf16 forwards, the res forward (RES) or the mod_ln one
template <typename M, bool RES>
int fwd_vec(const Args<bf16>& a, cudaStream_t st) {
  return by_chunks(a, RES ? 3 : 2, [&](auto cpl, auto g) -> int {
    constexpr int CPL = decltype(cpl)::value, G = decltype(g)::value;
    const int rows = a.B * a.N;
    if constexpr (RES) {
      const auto kernel = res_mod_ln_fwd_vec_kernel<CPL, G, M>;
      static const int per_sm = blocks_per_sm((const void*)kernel);
      const long long blocks = persistent_blocks(per_sm, rows, G);
      if (blocks < 0) return (int)-blocks;
      kernel<<<(unsigned)blocks, NT, 0, st>>>(a.x, a.h, (const M*)a.mod,
                                              a.ms, a.out, a.out2, rows, a.N,
                                              a.D, a.eps);
    } else {
      const auto kernel = mod_ln_fwd_vec_kernel<CPL, G, M>;
      static const int per_sm = blocks_per_sm((const void*)kernel);
      const long long blocks = persistent_blocks(per_sm, rows, G);
      if (blocks < 0) return (int)-blocks;
      kernel<<<(unsigned)blocks, NT, 0, st>>>(a.x, (const M*)a.mod, a.ms,
                                              a.out, rows, a.N, a.D, a.eps);
    }
    return cudaGetLastError();
  });
}

// the forward (persistent on 16-byte chunks where T is bf16 and D a
// multiple of 8)
template <typename T, typename M, bool RES>
int run_forward(const Args<T>& a, cudaStream_t st) {
  if constexpr (sizeof(T) == 2)
    if (a.D % 8 == 0) return fwd_vec<M, RES>(a, st);
  return by_lanes<Forward, T, M, RES>(a, st);
}

// Whether res_mod_ln_bwd_vec_kernel reads a's gm3: its 16-byte loads need
// the rows' starts 16-byte aligned, and an f32 gm3 must be contiguous
template <typename M> bool gm3_for_chunks(const Args<bf16>& a) {
  return (uintptr_t)a.mod % 16 == 0 && a.ms * (long long)sizeof(M) % 16 == 0
         && (sizeof(M) == 2 || a.ms == 3LL * a.D);
}

// the backward (on 16-byte chunks where T is bf16, D a multiple of 8 and,
// for the res backward, gm3_for_chunks), then the ordered sum of its W x D
// partials over the tiles into dmod, rounded once to M
template <typename T, typename M, bool RES>
int run_backward(const Args<T>& a, M* dmod, cudaStream_t st) {
  int e;
  if constexpr (sizeof(T) == 2) {
    if (a.D % 8 || (RES && !gm3_for_chunks<M>(a)))
      e = by_lanes<Backward, T, M, RES>(a, st);
    else
      e = RES ? res_bwd_vec<M>(a, st) : mod_bwd_vec<M>(a, st);
  } else {
    e = by_lanes<Backward, T, M, RES>(a, st);
  }
  if (e) return e;
  launch_dmod_reduce(a.part, a.B, (a.N + MLN_ROWS - 1) / MLN_ROWS,
                     (RES ? 3 : 2) * a.D, dmod, st);
  return cudaGetLastError();
}

long long workspace(int B, int N, int D, int W) {
  return (long long)B * ((N + MLN_ROWS - 1) / MLN_ROWS) * W * D * 4;
}

}  // namespace

// Each entry takes the modulation (mod2 or gm3) in place: its pointer, its
// batch stride in elements and whether it is bf16 (else f32); the
// backwards write dmod2 and dgm3 in that dtype.
#define T2MS_MOD_LN_ENTRIES(SUFFIX, T)                                        \
  extern "C" int mod_ln_forward_##SUFFIX(                                     \
      const void* x, const void* mod2, long long mod2_stride, int mod2_bf16,  \
      void* out, int B, int N, int D, float eps, void* stream) {              \
    const Args<T> a{(const T*)x, nullptr, mod2, mod2_stride, nullptr,        \
                    nullptr, (T*)out, nullptr, nullptr, B, N, D, eps};        \
    const cudaStream_t st = (cudaStream_t)stream;                             \
    return mod2_bf16 ? run_forward<T, bf16, false>(a, st)                     \
                     : run_forward<T, float, false>(a, st);                   \
  }                                                                           \
  extern "C" int mod_ln_backward_##SUFFIX(                                    \
      const void* x, const void* mod2, long long mod2_stride, int mod2_bf16,  \
      const void* dy, void* dx, void* dmod2, void* work, int B, int N, int D, \
      float eps, void* stream) {                                              \
    const Args<T> a{(const T*)x, nullptr, mod2, mod2_stride, (const T*)dy,   \
                    nullptr, (T*)dx, nullptr, (float*)work, B, N, D, eps};    \
    const cudaStream_t st = (cudaStream_t)stream;                             \
    return mod2_bf16 ? run_backward<T, bf16, false>(a, (bf16*)dmod2, st)      \
                     : run_backward<T, float, false>(a, (float*)dmod2, st);   \
  }                                                                           \
  extern "C" int res_mod_ln_forward_##SUFFIX(                                 \
      const void* x, const void* h, const void* gm3, long long gm3_stride,    \
      int gm3_bf16, void* out, void* y, int B, int N, int D, float eps,       \
      void* stream) {                                                         \
    const Args<T> a{(const T*)x, (const T*)h, gm3, gm3_stride, nullptr,      \
                    nullptr, (T*)out, (T*)y, nullptr, B, N, D, eps};          \
    const cudaStream_t st = (cudaStream_t)stream;                             \
    return gm3_bf16 ? run_forward<T, bf16, true>(a, st)                       \
                    : run_forward<T, float, true>(a, st);                     \
  }                                                                           \
  extern "C" int res_mod_ln_backward_##SUFFIX(                                \
      const void* x, const void* h, const void* gm3, long long gm3_stride,    \
      int gm3_bf16, const void* dout, const void* dy, void* dx, void* dh,     \
      void* dgm3, void* work, int B, int N, int D, float eps, void* stream) { \
    const Args<T> a{(const T*)x, (const T*)h, gm3, gm3_stride, (const T*)dout,\
                    (const T*)dy, (T*)dx, (T*)dh, (float*)work, B, N, D,     \
                    eps};                                                     \
    const cudaStream_t st = (cudaStream_t)stream;                             \
    return gm3_bf16 ? run_backward<T, bf16, true>(a, (bf16*)dgm3, st)         \
                    : run_backward<T, float, true>(a, (float*)dgm3, st);      \
  }

T2MS_MOD_LN_ENTRIES(bf16, __nv_bfloat16)
T2MS_MOD_LN_ENTRIES(f32, float)

extern "C" long long mod_ln_backward_workspace(int B, int N, int D) {
  return workspace(B, N, D, 2);
}

extern "C" long long res_mod_ln_backward_workspace(int B, int N, int D) {
  return workspace(B, N, D, 3);
}

extern "C" int mod_ln_check(int D, int is_bf16) {
  (void)is_bf16;  // the limits are the same for both types
  return check_rows(D, 2);
}

extern "C" int res_mod_ln_check(int D, int is_bf16) {
  (void)is_bf16;
  return check_rows(D, 3);
}

extern "C" const char* t2ms_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
