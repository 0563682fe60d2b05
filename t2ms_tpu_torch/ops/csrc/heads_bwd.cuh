// The bf16 fused-heads attention backward on register-resident tensor-core
// tiles (fused_heads.cu holds the source note; the f32 entries keep its
// FMA-loop kernels). Two kernels, no atomics:
//
//   heads_bwd_q_kernel   per (element, 64 q rows, head), 4 warps of 16 q
//       rows each, over the 64-row K/V tiles of the head: the row max m
//       (pass 1), then r = sum e and u = sum dp * e, so 1/r and t = u / r,
//       written to the stats workspace and, pipelined, T(q * scale / r)
//       and T(g / r) to a (B, N, HD) bf16 workspace (pass 2), then ds and
//       dq += ds k (pass 3). The lean recipe reads lse and delta and runs
//       pass 3 only.
//   heads_bwd_kv_kernel  per (element, 64 k rows, head), 4 warps of 16 k
//       rows each, over the q tiles of the head: S^T = K Qs^T and
//       dP^T = V G^T, e^T and ds^T formed in the accumulators, then
//       dV += e^T G' and dK += ds^T Q' with the rows' statistics read by
//       column from a small shared array.
//
// Every product is mma.sync m16n8k16 (bf16 in, f32 sums) with operands from
// ldmatrix (.trans where a tile is read k-major). S and dP stay in f32
// accumulator registers; e and ds are rounded there and packed into the
// bf16 A fragments of the next product (the m16n8 accumulator layout is the
// A layout of m16n8k16). The tiles that stream (K/V in the q kernel, q/g,
// the pipelined workspace tiles and the rows' statistics in the kv kernel)
// come in through cp.async into a ring of two stages, the next tile landing
// while the current one's products run. Shared tiles are padded by 16
// bytes a row, so ldmatrix's eight row addresses fall on distinct banks.

#pragma once

#include "attn_heads.cuh"

namespace {

// One operand of the backward: element b's row n of head h starts at
// p + b * sb + n * sn + h * DH.
template <typename T> struct Opd {
  const T* p;
  long long sb, sn;
  __device__ const T* head(int b, int h, int DH) const {
    return p + (size_t)b * sb + h * DH;
  }
};

template <typename T> struct BwdArgs {
  Opd<T> q, k, v, g;
  T *dq, *dk, *dv;  // contiguous (B, N, HD)
  float* st;        // (B*N, H, 3): m, 1/r, t
  int B, N, HD, H;
  float scale, qscale;
  const float *lse, *delta;  // the lean recipe's (B*N, H) inputs
  T *qsc, *gsc;  // bf16 pipelined: T(q * scale / r), T(g / r), (B, N, HD)
};

// The backward's recipes: the rounding points of dq, dk and dv, and where
// the rows' statistics come from (the backward's own first passes, or the
// caller's lse and delta)
enum Recipe { PIPE = 0, RECOMP = 1, LEAN = 2 };

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

using bf16 = __nv_bfloat16;

constexpr int HB_NT = 128;  // threads per block: 4 warps of 16 rows
constexpr int HB_R = 64;    // rows of a block's own tile, k rows a q step

// q rows per step of the kv kernel: 32 at head width 128 keeps its S^T,
// dP^T, dK and dV sums within the register file
__host__ __device__ constexpr int hb_bq(int DH) { return DH == 128 ? 32 : 64; }

// blocks per SM the register budget is cut for: three at head width 32
// (no spills at 168 registers), else what the registers give (two at
// 64: a cap of 168 spilled there and ran slower; H100, `-Xptxas -v`)
__host__ __device__ constexpr int hb_min_blocks(int DH) {
  return DH == 32 ? 3 : 1;
}

// bytes of a padded bf16 tile (rows of DH + 8 values)
__host__ __device__ constexpr size_t hb_tile(int rows, int DH) {
  return (size_t)rows * (DH + 8) * 2;
}

// Shared memory of the two kernels (carved in this order): the q kernel's
// q and g tiles, two stages of K and V tiles and the rows' 1/r; the kv
// kernel's K and V tiles and two stages of q-side tiles (q, g and,
// pipelined, the workspace's two) with the rows' statistics.
__host__ __device__ constexpr size_t smem_bwd_q(int DH) {
  return 6 * hb_tile(HB_R, DH) + HB_R * 4;
}
__host__ __device__ constexpr size_t smem_bwd_kv(int DH, int rec) {
  return 2 * hb_tile(HB_R, DH) +
         2 * ((rec == PIPE ? 4 : 2) * hb_tile(hb_bq(DH), DH) +
              3 * hb_bq(DH) * 4);
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
// asynchronously; rows from `valid` on are zeros
template <int ROWS, int DH>
__device__ __forceinline__ void cp_tile(bf16* dst, const bf16* src,
                                        long long sn, int valid) {
  constexpr int CH = DH / 8, LD = DH + 8;
  static_assert(ROWS * CH % HB_NT == 0, "whole copies per thread");
#pragma unroll
  for (int u = 0; u < ROWS * CH / HB_NT; ++u) {
    const int idx = u * HB_NT + threadIdx.x, r = idx / CH, c = idx % CH * 8;
    const bool ok = r < valid;
    cp16(dst + r * LD + c, src + (size_t)(ok ? r : 0) * sn + c, ok);
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

// ------------------------------------------------------- the q-tile kernel

template <int DH, int REC>
__global__ void __launch_bounds__(HB_NT, hb_min_blocks(DH))
    heads_bwd_q_kernel(BwdArgs<bf16> a) {
  constexpr int LD = DH + 8, TILE = HB_R * LD, CH = DH / 8;
  constexpr int NP = REC == LEAN ? 1 : 3;  // passes over the k tiles
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qr = reinterpret_cast<bf16*>(smem);  // q, unscaled
  bf16* Gt = Qr + TILE;                      // g
  bf16* KV = Gt + TILE;                      // stages of [K | V]
  float* Irs = reinterpret_cast<float*>(KV + 4 * TILE);  // rows' 1/r

  const int N = a.N, H = a.H;
  const Place pl = place(N, H, HB_R);
  const int q0 = pl.t0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3, w0 = warp * 16;
  const int nk = (N + HB_R - 1) / HB_R, total = NP * nk;
  const bf16* kh = a.k.head(pl.b, pl.h, DH);
  const bf16* vh = a.v.head(pl.b, pl.h, DH);

  // the ring: iteration `it` is pass it / nk (pass 3 only for the lean
  // recipe) over k tile it % nk; the first pass needs no V
  auto fetch = [&](int it) {
    const int k0 = it % nk * HB_R;
    bf16* Ks = KV + (it & 1) * 2 * TILE;
    cp_tile<HB_R, DH>(Ks, kh + (size_t)k0 * a.k.sn, a.k.sn, N - k0);
    if (NP == 1 || it >= nk)
      cp_tile<HB_R, DH>(Ks + TILE, vh + (size_t)k0 * a.v.sn, a.v.sn, N - k0);
  };
  cp_tile<HB_R, DH>(Qr, a.q.head(pl.b, pl.h, DH) + (size_t)q0 * a.q.sn,
                    a.q.sn, N - q0);
  cp_tile<HB_R, DH>(Gt, a.g.head(pl.b, pl.h, DH) + (size_t)q0 * a.g.sn,
                    a.g.sn, N - q0);
  fetch(0);
  cp_commit();

  // rows w0 + gr (index 0) and w0 + gr + 8 (index 1) of the tile
  float m[2], ir[2] = {0.0f, 0.0f}, tt[2], rs[2] = {0.0f, 0.0f},
              us[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = q0 + w0 + gr + 8 * r;
    const size_t row = ((size_t)pl.b * N + (n < N ? n : 0)) * H + pl.h;
    m[r] = REC == LEAN ? (n < N ? a.lse[row] : 0.0f) : -INFINITY;
    tt[r] = REC == LEAN && n < N ? a.delta[row] : 0.0f;
  }
  float dq[DH / 8][4];
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt)
    dq[nt][0] = dq[nt][1] = dq[nt][2] = dq[nt][3] = 0.0f;
  RowFrags<DH, true> qf;  // T(q * qscale)
  RowFrags<DH, false> gf;

  for (int it = 0; it < total; ++it) {
    if (it + 1 < total) {
      fetch(it + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
      qf.init(Qr, w0, bf16_pair(a.qscale));
      gf.init(Gt, w0, 0u);
    }
    const int pass = NP == 1 ? 2 : it / nk, k0 = it % nk * HB_R;
    const bf16* Ks = KV + (it & 1) * 2 * TILE;
    const bf16* Vs = Ks + TILE;
    const bool ragged = k0 + HB_R > N;
    float s[8][4] = {};
    rows_by_tile<DH, 8, true, false>(s, qf, Ks, 0u);
    if (ragged) {  // columns past N: e = exp(-inf) = 0
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * nt + 2 * tq + (e & 1) >= N) s[nt][e] = -INFINITY;
      }
    }
    if (pass == 0) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], s[nt][e]);
      }
      if (it == nk - 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
          m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
        }
      }
    } else {
      float dp[8][4] = {};
      rows_by_tile<DH, 8, false, false>(dp, gf, Vs, 0u);
      if (pass == 1) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float e0, e1;
            exp_rounded2(s[nt][2 * h], s[nt][2 * h + 1], m[h], m[h], e0, e1);
            rs[h] += e0;
            rs[h] += e1;
            us[h] += dp[nt][2 * h] * e0;
            us[h] += dp[nt][2 * h + 1] * e1;
          }
        }
        if (it == 2 * nk - 1) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
            rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
            us[r] += __shfl_xor_sync(0xffffffffu, us[r], 1);
            us[r] += __shfl_xor_sync(0xffffffffu, us[r], 2);
            ir[r] = 1.0f / rs[r];
            tt[r] = us[r] * ir[r];
            const int i = w0 + gr + 8 * r, n = q0 + i;
            if (tq == 0) {
              Irs[i] = ir[r];
              if (n < N) {
                float* o = a.st + (((size_t)pl.b * N + n) * H + pl.h) * 3;
                o[0] = m[r];
                o[1] = ir[r];
                o[2] = tt[r];
              }
            }
          }
          if (REC == PIPE) {
            // T(q * (scale / r)) and T(g / r), once per q row
            __syncthreads();
            for (int idx = threadIdx.x; idx < HB_R * CH; idx += HB_NT) {
              const int i = idx / CH, c = idx % CH * 8, n = q0 + i;
              if (n >= N) continue;
              const float fi = Irs[i], fq = a.scale * fi;
              const uint4 qv = *reinterpret_cast<const uint4*>(Qr + i * LD + c);
              const uint4 gv = *reinterpret_cast<const uint4*>(Gt + i * LD + c);
              const bf16* qe = reinterpret_cast<const bf16*>(&qv);
              const bf16* ge = reinterpret_cast<const bf16*>(&gv);
              uint4 qo, go;
              uint32_t* qw = reinterpret_cast<uint32_t*>(&qo);
              uint32_t* gw = reinterpret_cast<uint32_t*>(&go);
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                qw[j] = pack_bf16(to_f<bf16>(qe[2 * j]) * fq,
                                  to_f<bf16>(qe[2 * j + 1]) * fq);
                gw[j] = pack_bf16(to_f<bf16>(ge[2 * j]) * fi,
                                  to_f<bf16>(ge[2 * j + 1]) * fi);
              }
              const size_t o = ((size_t)pl.b * N + n) * a.HD + pl.h * DH + c;
              *reinterpret_cast<uint4*>(a.qsc + o) = qo;
              *reinterpret_cast<uint4*>(a.gsc + o) = go;
            }
          }
        }
      } else {
        // ds: pipelined T(e (dp - t)); recompute p = e / r, T(p (dp - t));
        // lean p = T(exp(T(s - lse))), T(p (dp - delta))
        uint32_t P[4][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float p0, p1;
            exp_rounded2(s[nt][2 * h], s[nt][2 * h + 1], m[h], m[h], p0, p1);
            if (REC == RECOMP) {
              p0 *= ir[h];
              p1 *= ir[h];
            }
            P[nt / 2][(nt & 1) * 2 + h] =
                pack_bf16(p0 * (dp[nt][2 * h] - tt[h]),
                          p1 * (dp[nt][2 * h + 1] - tt[h]));
          }
        }
        frags_by_tile<DH, 4>(dq, P, Ks);
      }
    }
    __syncthreads();
  }

  // dq = T(dQ * scale / r) pipelined, T(dQ * scale) otherwise, staged
  // through this warp's own rows of the q tile
  const float f0 = REC == PIPE ? a.scale * ir[0] : a.scale;
  const float f1 = REC == PIPE ? a.scale * ir[1] : a.scale;
  store_rows<DH>(dq, f0, f1, Qr + w0 * LD,
                 a.dq + ((size_t)pl.b * N + q0 + w0) * a.HD + pl.h * DH, a.HD,
                 N - q0 - w0);
}

// ------------------------------------------------------- the k-tile kernel

template <int DH, int REC>
__global__ void __launch_bounds__(HB_NT, hb_min_blocks(DH))
    heads_bwd_kv_kernel(BwdArgs<bf16> a) {
  constexpr int LD = DH + 8, BQ = hb_bq(DH), NQ = REC == PIPE ? 4 : 2;
  constexpr int QTILE = BQ * LD, STAGE = NQ * QTILE + 3 * BQ * 2;  // bf16s
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Kt = reinterpret_cast<bf16*>(smem);
  bf16* Vt = Kt + HB_R * LD;
  bf16* Ring = Vt + HB_R * LD;  // stages of [q | g | q' | g' | stats]

  const int N = a.N, H = a.H;
  const Place pl = place(N, H, HB_R);
  const int k0 = pl.t0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tq = lane & 3, w0 = warp * 16;
  const int nq = (N + BQ - 1) / BQ;
  const bf16* qh = a.q.head(pl.b, pl.h, DH);
  const bf16* gh = a.g.head(pl.b, pl.h, DH);
  const size_t ws = (size_t)pl.b * N * a.HD + pl.h * DH;  // workspace head

  // stage of q tile `it`: q and g, pipelined T(q * scale / r) and T(g / r),
  // and the rows' m, 1/r, t (lean: lse, -, delta), zeros past N
  auto fetch = [&](int it) {
    const int q0 = it * BQ;
    bf16* Sq = Ring + (it & 1) * STAGE;
    cp_tile<BQ, DH>(Sq, qh + (size_t)q0 * a.q.sn, a.q.sn, N - q0);
    cp_tile<BQ, DH>(Sq + QTILE, gh + (size_t)q0 * a.g.sn, a.g.sn, N - q0);
    if (REC == PIPE) {
      cp_tile<BQ, DH>(Sq + 2 * QTILE, a.qsc + ws + (size_t)q0 * a.HD, a.HD,
                      N - q0);
      cp_tile<BQ, DH>(Sq + 3 * QTILE, a.gsc + ws + (size_t)q0 * a.HD, a.HD,
                      N - q0);
    }
    float* St = reinterpret_cast<float*>(Sq + NQ * QTILE);
    constexpr int KN = REC == LEAN ? 2 : 3;
    for (int idx = threadIdx.x; idx < KN * BQ; idx += HB_NT) {
      const int k = REC == LEAN ? idx / BQ * 2 : idx / BQ, i = idx % BQ;
      const int n = q0 + i;
      const bool ok = n < N;
      const size_t row = ((size_t)pl.b * N + (ok ? n : 0)) * H + pl.h;
      const float* src = REC == LEAN ? (k == 0 ? a.lse : a.delta) + row
                                     : a.st + row * 3 + k;
      cp4(St + k * BQ + i, src, ok);
    }
  };
  cp_tile<HB_R, DH>(Kt, a.k.head(pl.b, pl.h, DH) + (size_t)k0 * a.k.sn,
                    a.k.sn, N - k0);
  cp_tile<HB_R, DH>(Vt, a.v.head(pl.b, pl.h, DH) + (size_t)k0 * a.v.sn,
                    a.v.sn, N - k0);
  fetch(0);
  cp_commit();

  const uint32_t qs2 = bf16_pair(a.qscale);
  float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nt][e] = dv[nt][e] = 0.0f;
  }
  RowFrags<DH, false> kf, vf;

  for (int it = 0; it < nq; ++it) {
    if (it + 1 < nq) {
      fetch(it + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
      kf.init(Kt, w0, 0u);
      vf.init(Vt, w0, 0u);
    }
    const int q0 = it * BQ;
    const bf16* Sq = Ring + (it & 1) * STAGE;
    const bf16* Gq = Sq + QTILE;
    const float* St = reinterpret_cast<const float*>(Sq + NQ * QTILE);
    const bool ragged = q0 + BQ > N;

    // S^T = K T(q * qscale)^T and dP^T = V g^T: rows are k rows, columns
    // q rows
    float s[BQ / 8][4] = {}, dp[BQ / 8][4] = {};
    rows_by_tile<DH, BQ / 8, false, true>(s, kf, Sq, qs2);
    rows_by_tile<DH, BQ / 8, false, false>(dp, vf, Gq, 0u);
    if (ragged) {  // q rows past N: e = exp(-inf) = 0
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (q0 + 8 * nt + 2 * tq + (e & 1) >= N) s[nt][e] = -INFINITY;
      }
    }
    // pipelined e and ds_u = T(e (dp - t)); recompute p = e / r, T(p) and
    // ds = T(p (dp - t)); lean p = T(exp(T(s - lse))), ds = T(p (dp - delta))
    uint32_t Pe[BQ / 16][4], Pd[BQ / 16][4];
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
      const int i = 8 * nt + 2 * tq;
      const float2 mm = *reinterpret_cast<const float2*>(St + i);
      const float2 rr = *reinterpret_cast<const float2*>(St + BQ + i);
      const float2 tv = *reinterpret_cast<const float2*>(St + 2 * BQ + i);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float p0, p1;
        uint32_t pb =
            exp_rounded2(s[nt][2 * h], s[nt][2 * h + 1], mm.x, mm.y, p0, p1);
        if (REC == RECOMP) {
          p0 *= rr.x;
          p1 *= rr.y;
          pb = pack_bf16(p0, p1);
        }
        Pe[nt / 2][(nt & 1) * 2 + h] = pb;
        Pd[nt / 2][(nt & 1) * 2 + h] = pack_bf16(
            p0 * (dp[nt][2 * h] - tv.x), p1 * (dp[nt][2 * h + 1] - tv.y));
      }
    }
    // pipelined dV += e^T T(g / r), dK += ds_u^T T(q * scale / r);
    // otherwise dV += T(p)^T g, dK += ds^T q
    frags_by_tile<DH, BQ / 16>(dv, Pe, REC == PIPE ? Sq + 3 * QTILE : Gq);
    frags_by_tile<DH, BQ / 16>(dk, Pd, REC == PIPE ? Sq + 2 * QTILE : Sq);
    __syncthreads();
  }

  // dk = T(dK) pipelined, T(dK * scale) otherwise; dv = T(dV); staged
  // through this warp's own rows of the K and V tiles
  const float fk = REC == PIPE ? 1.0f : a.scale;
  const size_t o = ((size_t)pl.b * N + k0 + w0) * a.HD + pl.h * DH;
  store_rows<DH>(dk, fk, fk, Kt + w0 * LD, a.dk + o, a.HD, N - k0 - w0);
  store_rows<DH>(dv, 1.0f, 1.0f, Vt + w0 * LD, a.dv + o, a.HD, N - k0 - w0);
}

template <int DH, int REC>
cudaError_t launch_bwd_mma(const BwdArgs<bf16>& a, cudaStream_t st) {
  constexpr size_t s1 = smem_bwd_q(DH), s2 = smem_bwd_kv(DH, REC);
  cudaError_t e;
  if ((e = set_smem((const void*)heads_bwd_q_kernel<DH, REC>, s1)) ||
      (e = set_smem((const void*)heads_bwd_kv_kernel<DH, REC>, s2)))
    return e;
  const int blocks = a.B * ((a.N + HB_R - 1) / HB_R) * a.H;
  heads_bwd_q_kernel<DH, REC><<<blocks, HB_NT, s1, st>>>(a);
  heads_bwd_kv_kernel<DH, REC><<<blocks, HB_NT, s2, st>>>(a);
  return cudaGetLastError();
}

}  // namespace
