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
//             rounded once by the wrapper). The JAX kernel takes this VJP
//             with jax.vjp inside its body; here it is written out.
//
// mod2 is (B, 2, D) = [shift, scale] and gm3 (B, 3, D) = [gate, shift,
// scale], both in f32 (the wrappers convert them).
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
// C interface for ctypes: {mod_ln,res_mod_ln}_{forward,backward}_{bf16,f32}
// launch on the given stream and return cudaGetLastError(), or
// T2MS_UNSUPPORTED_SHAPE (launching nothing) for a shape the kernels do not
// take; *_backward_workspace gives the bytes of the partials the caller
// allocates; mod_ln_check and res_mod_ln_check answer the shape question.

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

// The host side's arguments of every launch; the kernels take them as
// __restrict__ parameters, so their loads may move ahead of their stores.
template <typename T> struct Args {
  const T* x;
  const T* h;       // the residual branch (res kernels)
  const float* mod; // mod2 (B, 2, D) or gm3 (B, 3, D)
  const T* dout;    // the cotangent of the modulated output (backwards)
  const T* dy;      // the cotangent of the stream y (res backward)
  T* out;           // the forward's output, or dx
  T* out2;          // y (res forward), or dh (res backward)
  float* part;      // the backwards' per-tile partials
  int B, N, D;
  float eps;
};

// ------------------------------------------------------------- mod_ln

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

template <typename T, int V>
__global__ void __launch_bounds__(NT)
res_mod_ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ h,
                      const float* __restrict__ gm3, T* __restrict__ out,
                      T* __restrict__ y, int rows, int N, int D, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = blockIdx.x * NW + warp;
  if (r >= rows) return;
  const float* gate = gm3 + (size_t)(r / N) * 3 * D;
  const float* sh = gate + D;
  const float* sc = gate + 2 * D;
  float gt[V], v[V], hv[V];
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const int c = lane + 32 * u;
    gt[u] = c < D ? rnd<T>(gate[c]) : 0.0f;
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
    if (c < D) o[c] = from_f<T>((v[u] - mu) * rs * (1.0f + sc[c]) + sh[c]);
  }
}

// One block per 64-row tile of one element: dx and dh of its rows and the
// tile's f32 partials part[blockIdx.x] = [sum dt * h, sum do, sum do * xh]
// (3 x D), the forward recomputed from x and h.
template <typename T, int V>
__global__ void __launch_bounds__(NT)
res_mod_ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ h,
                      const float* __restrict__ gm3,
                      const T* __restrict__ dout, const T* __restrict__ dy,
                      T* __restrict__ dx, T* __restrict__ dh,
                      float* __restrict__ part, int N, int D, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ps = reinterpret_cast<float*>(smem);  // NW x 3 x D warp partials
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles = (N + MLN_ROWS - 1) / MLN_ROWS;
  const int b = blockIdx.x / tiles, n0 = (blockIdx.x % tiles) * MLN_ROWS;
  const int valid = min(MLN_ROWS, N - n0);
  const float* gate = gm3 + (size_t)b * 3 * D;
  const float* sc = gate + 2 * D;
  float gt[V], scp[V], pg[V], psh[V], psc[V];
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const int c = lane + 32 * u;
    gt[u] = c < D ? rnd<T>(gate[c]) : 0.0f;
    scp[u] = c < D ? 1.0f + sc[c] : 0.0f;
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
// arithmetic and its rounding points are res_mod_ln_bwd_kernel's.

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
// the 8 floats at q (16-byte aligned), loaded where they are used: the
// volatile loads stay in the row loop (the gate and scale, hoisted into
// registers for the whole loop, made the kernel spill)
__device__ __forceinline__ void ldg8(const float* q, float (&f)[8]) {
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(f[0]), "=f"(f[1]), "=f"(f[2]), "=f"(f[3])
               : "l"(q));
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4+16];\n"
               : "=f"(f[4]), "=f"(f[5]), "=f"(f[6]), "=f"(f[7])
               : "l"(q));
}

template <int CPL, int G>
__global__ void __launch_bounds__(NT, CPL <= 2 ? 2 : 1)
res_mod_ln_bwd_vec_kernel(const bf16* __restrict__ x,
                          const bf16* __restrict__ h,
                          const float* __restrict__ gm3,
                          const bf16* __restrict__ dout,
                          const bf16* __restrict__ dy, bf16* __restrict__ dx,
                          bf16* __restrict__ dh, float* __restrict__ part,
                          int N, int D, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ps = reinterpret_cast<float*>(smem);  // (NW / 2) x 3 x D
  constexpr int RPW = 32 / G;                  // rows of a warp at once
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gi = lane / G, l = lane % G, nch = D / 8;
  const int tiles = (N + MLN_ROWS - 1) / MLN_ROWS;
  const int b = blockIdx.x / tiles, n0 = (blockIdx.x % tiles) * MLN_ROWS;
  const int valid = min(MLN_ROWS, N - n0);
  const float* gate = gm3 + (size_t)b * 3 * D;
  const float* sc = gate + 2 * D;
  auto group_sum = [](float v) {
#pragma unroll
    for (int o = G / 2; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
  };
  // the lane's chunk j: its first column (clamped for a lane without one)
  auto col = [&](int j) { return 8 * min(l + G * j, nch - 1); };
  float pg[CPL][8], psh[CPL][8], psc[CPL][8];
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
    const float mu = group_sum(s) / D;
    float q = 0.0f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float dv = on[j] ? v[j][k] - mu : 0.0f;
        q += dv * dv;
      }
    }
    const float rs = rsqrtf(group_sum(q) / D + eps);
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
    const float mg = group_sum(sg) / D, mgx = group_sum(sgx) / D;
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

  // the warp's groups into group 0 (shuffles), then warp w + half into
  // warp w for half = 4, 2, 1 through Ps, then warp 0's sums out
#pragma unroll
  for (int o = G; o < 32; o <<= 1) {
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        pg[j][k] += __shfl_xor_sync(0xffffffffu, pg[j][k], o);
        psh[j][k] += __shfl_xor_sync(0xffffffffu, psh[j][k], o);
        psc[j][k] += __shfl_xor_sync(0xffffffffu, psc[j][k], o);
      }
    }
  }
  // the lane's sums into (or added from) a 3 x D buffer [pg, psh, psc]
  auto io = [&](float* buf, bool add) {
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      if (l + G * j >= nch) continue;
      float* c = buf + 8 * (l + G * j);
      if (add) {
        add8(c, pg[j]), add8(c + D, psh[j]), add8(c + 2 * D, psc[j]);
      } else {
        put8(c, pg[j]), put8(c + D, psh[j]), put8(c + 2 * D, psc[j]);
      }
    }
  };
#pragma unroll
  for (int half = NW / 2; half >= 1; half /= 2) {
    if (gi == 0 && warp >= half && warp < 2 * half)
      io(Ps + (size_t)(warp - half) * 3 * D, false);
    __syncthreads();
    if (gi == 0 && warp < half) io(Ps + (size_t)warp * 3 * D, true);
    __syncthreads();
  }
  if (warp == 0 && gi == 0) io(part + (size_t)blockIdx.x * 3 * D, false);
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

// the forwards: one warp per row of (B*N, D)
template <typename T, int V, bool RES> struct Forward {
  static cudaError_t run(const Args<T>& a, cudaStream_t st) {
    const int rows = a.B * a.N;
    const unsigned blocks = (unsigned)(((long long)rows + NW - 1) / NW);
    if constexpr (RES)
      res_mod_ln_fwd_kernel<T, V><<<blocks, NT, 0, st>>>(
          a.x, a.h, a.mod, a.out, a.out2, rows, a.N, a.D, a.eps);
    else
      mod_ln_fwd_kernel<T, V><<<blocks, NT, 0, st>>>(a.x, a.mod, a.out, rows,
                                                     a.N, a.D, a.eps);
    return cudaGetLastError();
  }
};

// the backwards: one block per 64-row tile of one element
template <typename T, int V, bool RES> struct Backward {
  static cudaError_t run(const Args<T>& a, cudaStream_t st) {
    const size_t s = smem_bwd(RES ? 3 : 2, a.D);
    const int blocks = a.B * ((a.N + MLN_ROWS - 1) / MLN_ROWS);
    cudaError_t e;
    if constexpr (RES) {
      if ((e = set_smem((const void*)res_mod_ln_bwd_kernel<T, V>, s)))
        return e;
      res_mod_ln_bwd_kernel<T, V><<<blocks, NT, s, st>>>(
          a.x, a.h, a.mod, a.dout, a.dy, a.out, a.out2, a.part, a.N, a.D,
          a.eps);
    } else {
      if ((e = set_smem((const void*)mod_ln_bwd_kernel<T, V>, s))) return e;
      mod_ln_bwd_kernel<T, V><<<blocks, NT, s, st>>>(
          a.x, a.mod, a.dout, a.out, a.part, a.N, a.D, a.eps);
    }
    return cudaGetLastError();
  }
};

// L<T, V, RES>::run with V the values a lane holds for a row of D (the next
// power of two of D / 32), after the shape checks.
template <template <typename, int, bool> class L, typename T, bool RES>
int by_lanes(const Args<T>& a, cudaStream_t st) {
  // rows of (B*N, D) and the backward's B * tiles blocks are indexed as int
  if (a.B < 1 || a.N < 1 || (long long)a.B * a.N > INT_MAX)
    return T2MS_UNSUPPORTED_SHAPE;
  const int ok = check_rows(a.D, RES ? 3 : 2);
  if (ok) return ok;
  if (a.D <= 32) return L<T, 1, RES>::run(a, st);
  if (a.D <= 64) return L<T, 2, RES>::run(a, st);
  if (a.D <= 128) return L<T, 4, RES>::run(a, st);
  if (a.D <= 256) return L<T, 8, RES>::run(a, st);
  if (a.D <= 512) return L<T, 16, RES>::run(a, st);
  return L<T, 32, RES>::run(a, st);
}

// the bf16 gated-residual backward on 16-byte chunks (D a multiple of 8):
// CPL chunks a lane in groups of G lanes, after by_lanes' shape checks
template <int CPL, int G>
cudaError_t launch_res_bwd_vec(const Args<bf16>& a, cudaStream_t st) {
  const size_t s = (size_t)(NW / 2) * 3 * a.D * 4;
  const cudaError_t e =
      set_smem((const void*)res_mod_ln_bwd_vec_kernel<CPL, G>, s);
  if (e) return e;
  const int blocks = a.B * ((a.N + MLN_ROWS - 1) / MLN_ROWS);
  res_mod_ln_bwd_vec_kernel<CPL, G><<<blocks, NT, s, st>>>(
      a.x, a.h, a.mod, a.dout, a.dy, a.out, a.out2, a.part, a.N, a.D, a.eps);
  return cudaGetLastError();
}

int res_bwd_vec(const Args<bf16>& a, cudaStream_t st) {
  if (a.B < 1 || a.N < 1 || (long long)a.B * a.N > INT_MAX)
    return T2MS_UNSUPPORTED_SHAPE;
  const int ok = check_rows(a.D, 3);
  if (ok) return ok;
  const int nch = a.D / 8;
  if (nch <= 8) return launch_res_bwd_vec<1, 8>(a, st);
  if (nch <= 16) return launch_res_bwd_vec<1, 16>(a, st);
  if (nch <= 32) return launch_res_bwd_vec<1, 32>(a, st);
  if (nch <= 64) return launch_res_bwd_vec<2, 32>(a, st);
  if (nch <= 96) return launch_res_bwd_vec<3, 32>(a, st);
  return launch_res_bwd_vec<4, 32>(a, st);
}

// the backward, then the ordered sum of its W x D partials over the tiles
// (the bf16 gated residual's on 16-byte chunks where D allows)
template <typename T, bool RES>
int run_backward(const Args<T>& a, float* dmod, cudaStream_t st) {
  int e;
  if constexpr (RES && sizeof(T) == 2)
    e = a.D % 8 ? by_lanes<Backward, T, RES>(a, st) : res_bwd_vec(a, st);
  else
    e = by_lanes<Backward, T, RES>(a, st);
  if (e) return e;
  launch_dmod_reduce(a.part, a.B, (a.N + MLN_ROWS - 1) / MLN_ROWS,
                     (RES ? 3 : 2) * a.D, dmod, st);
  return cudaGetLastError();
}

long long workspace(int B, int N, int D, int W) {
  return (long long)B * ((N + MLN_ROWS - 1) / MLN_ROWS) * W * D * 4;
}

}  // namespace

#define T2MS_MOD_LN_ENTRIES(SUFFIX, T)                                        \
  extern "C" int mod_ln_forward_##SUFFIX(const void* x, const void* mod2,     \
                                         void* out, int B, int N, int D,      \
                                         float eps, void* stream) {           \
    const Args<T> a{(const T*)x, nullptr, (const float*)mod2, nullptr,       \
                    nullptr, (T*)out, nullptr, nullptr, B, N, D, eps};        \
    return by_lanes<Forward, T, false>(a, (cudaStream_t)stream);              \
  }                                                                           \
  extern "C" int mod_ln_backward_##SUFFIX(                                    \
      const void* x, const void* mod2, const void* dy, void* dx, void* dmod2, \
      void* work, int B, int N, int D, float eps, void* stream) {             \
    const Args<T> a{(const T*)x, nullptr, (const float*)mod2, (const T*)dy,  \
                    nullptr, (T*)dx, nullptr, (float*)work, B, N, D, eps};    \
    return run_backward<T, false>(a, (float*)dmod2, (cudaStream_t)stream);    \
  }                                                                           \
  extern "C" int res_mod_ln_forward_##SUFFIX(                                 \
      const void* x, const void* h, const void* gm3, void* out, void* y,      \
      int B, int N, int D, float eps, void* stream) {                         \
    const Args<T> a{(const T*)x, (const T*)h, (const float*)gm3, nullptr,    \
                    nullptr, (T*)out, (T*)y, nullptr, B, N, D, eps};          \
    return by_lanes<Forward, T, true>(a, (cudaStream_t)stream);               \
  }                                                                           \
  extern "C" int res_mod_ln_backward_##SUFFIX(                                \
      const void* x, const void* h, const void* gm3, const void* dout,        \
      const void* dy, void* dx, void* dh, void* dgm3, void* work, int B,      \
      int N, int D, float eps, void* stream) {                                \
    const Args<T> a{(const T*)x, (const T*)h, (const float*)gm3,             \
                    (const T*)dout, (const T*)dy, (T*)dx, (T*)dh,            \
                    (float*)work, B, N, D, eps};                              \
    return run_backward<T, true>(a, (float*)dgm3, (cudaStream_t)stream);      \
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
