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
//       pass 3 only; so does the DiT block backward's recipe (BLOCK,
//       dit_block_bwd.cu), which reads m, 1/r and delta from the stats
//       workspace its caller fills.
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
  T *dq, *dk, *dv;  // (B, N, HD) at row stride ldo
  float* st;        // (B*N, H, 3): m, 1/r, t (BLOCK: t = delta)
  int B, N, HD, H;
  float scale, qscale;
  const float *lse, *delta;  // the lean recipe's (B*N, H) inputs
  T *qsc, *gsc;  // bf16 pipelined: T(q * scale / r), T(g / r), (B, N, HD)
  int ldo;  // row stride of dq, dk and dv: HD, or 3 * HD where they are
            // the column slices of one dqkv (BLOCK)
};

// The backward's recipes: the rounding points of dq, dk and dv, and where
// the rows' statistics come from (the backward's own first passes, or the
// caller's lse and delta, or, BLOCK, the caller's m, 1/r and delta in st).
// BLOCK rounds as RECOMP does (p = e * (1/r), ds = T(p (dp - delta)),
// dv = T(sum T(p)^T g), dq = T((ds k) * scale)) but takes dk from the
// rounded operand: dk = T(sum ds^T T(q * qscale)), as the block's forward
// scales q (dit_block_bwd.cu).
enum Recipe { PIPE = 0, RECOMP = 1, LEAN = 2, BLOCK = 3 };

// q rows per step of the kv kernel: 32 at head width 128 keeps its S^T,
// dP^T, dK and dV sums within the register file
__host__ __device__ constexpr int hb_bq(int DH) { return DH == 128 ? 32 : 64; }

// blocks per SM the register budget is cut for: three at head width 32
// (no spills at 168 registers), else what the registers give (two at
// 64: a cap of 168 spilled there and ran slower; H100, `-Xptxas -v`)
__host__ __device__ constexpr int hb_min_blocks(int DH) {
  return DH == 32 ? 3 : 1;
}

// Shared memory of the two kernels (carved in this order): the q kernel's
// q and g tiles, two stages of K and V tiles and the rows' 1/r; the kv
// kernel's K and V tiles and two stages of q-side tiles (q, g and,
// pipelined, the workspace's two) with the rows' statistics.
__host__ __device__ constexpr size_t smem_bwd_q(int DH) {
  return 6 * tc_tile(TC_R, DH) + TC_R * 4;
}
__host__ __device__ constexpr size_t smem_bwd_kv(int DH, int rec) {
  return 2 * tc_tile(TC_R, DH) +
         2 * ((rec == PIPE ? 4 : 2) * tc_tile(hb_bq(DH), DH) +
              3 * hb_bq(DH) * 4);
}

// ------------------------------------------------------- the q-tile kernel

template <int DH, int REC>
__global__ void __launch_bounds__(TC_NT, hb_min_blocks(DH))
    heads_bwd_q_kernel(BwdArgs<bf16> a) {
  constexpr int LD = DH + 8, TILE = TC_R * LD, CH = DH / 8;
  constexpr int NP = REC == LEAN || REC == BLOCK ? 1 : 3;  // k-tile passes
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qr = reinterpret_cast<bf16*>(smem);  // q, unscaled
  bf16* Gt = Qr + TILE;                      // g
  bf16* KV = Gt + TILE;                      // stages of [K | V]
  float* Irs = reinterpret_cast<float*>(KV + 4 * TILE);  // rows' 1/r

  const int N = a.N, H = a.H;
  const Place pl = place(N, H, TC_R);
  const int q0 = pl.t0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3, w0 = warp * 16;
  const int nk = (N + TC_R - 1) / TC_R, total = NP * nk;
  const bf16* kh = a.k.head(pl.b, pl.h, DH);
  const bf16* vh = a.v.head(pl.b, pl.h, DH);

  // the ring: iteration `it` is pass it / nk (pass 3 only for the lean
  // and block recipes) over k tile it % nk; the first pass needs no V
  auto fetch = [&](int it) {
    const int k0 = it % nk * TC_R;
    bf16* Ks = KV + (it & 1) * 2 * TILE;
    cp_tile<TC_R, DH>(Ks, kh + (size_t)k0 * a.k.sn, a.k.sn, N - k0);
    if (NP == 1 || it >= nk)
      cp_tile<TC_R, DH>(Ks + TILE, vh + (size_t)k0 * a.v.sn, a.v.sn, N - k0);
  };
  cp_tile<TC_R, DH>(Qr, a.q.head(pl.b, pl.h, DH) + (size_t)q0 * a.q.sn,
                    a.q.sn, N - q0);
  cp_tile<TC_R, DH>(Gt, a.g.head(pl.b, pl.h, DH) + (size_t)q0 * a.g.sn,
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
    if (REC == BLOCK) {
      m[r] = n < N ? a.st[row * 3] : 0.0f;
      ir[r] = n < N ? a.st[row * 3 + 1] : 0.0f;
      tt[r] = n < N ? a.st[row * 3 + 2] : 0.0f;
    } else {
      m[r] = REC == LEAN ? (n < N ? a.lse[row] : 0.0f) : -INFINITY;
      tt[r] = REC == LEAN && n < N ? a.delta[row] : 0.0f;
    }
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
    const int pass = NP == 1 ? 2 : it / nk, k0 = it % nk * TC_R;
    const bf16* Ks = KV + (it & 1) * 2 * TILE;
    const bf16* Vs = Ks + TILE;
    float s[8][4];
    score_tile<DH>(s, qf, Ks, k0, N);
    if (pass == 0) {
      row_max(s, m);
      if (it == nk - 1) {
        m[0] = quad_max(m[0]);
        m[1] = quad_max(m[1]);
      }
    } else {
      float dp[8][4] = {};
      rows_by_tile<DH, 8, false, false>(dp, gf, Vs, 0u);
      if (pass == 1) {
        uint32_t E[4][4];  // e's fragments, unused: pass 3 forms ds
        exp_rows(s, m, rs, E, [&](int nt, int h, float e0, float e1) {
          us[h] += dp[nt][2 * h] * e0;
          us[h] += dp[nt][2 * h + 1] * e1;
        });
        if (it == 2 * nk - 1) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            rs[r] = quad_sum(rs[r]);
            us[r] = quad_sum(us[r]);
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
            for (int idx = threadIdx.x; idx < TC_R * CH; idx += TC_NT) {
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
        // lean p = T(exp(T(s - lse))), T(p (dp - delta)); block
        // p = e * (1/r), T(p (dp - delta))
        uint32_t P[4][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float p0, p1;
            exp_rounded2(s[nt][2 * h], s[nt][2 * h + 1], m[h], m[h], p0, p1);
            if (REC == RECOMP || REC == BLOCK) {
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
                 a.dq + ((size_t)pl.b * N + q0 + w0) * a.ldo + pl.h * DH,
                 a.ldo, N - q0 - w0);
}

// ------------------------------------------------------- the k-tile kernel

template <int DH, int REC>
__global__ void __launch_bounds__(TC_NT, hb_min_blocks(DH))
    heads_bwd_kv_kernel(BwdArgs<bf16> a) {
  constexpr int LD = DH + 8, BQ = hb_bq(DH), NQ = REC == PIPE ? 4 : 2;
  constexpr int QTILE = BQ * LD, STAGE = NQ * QTILE + 3 * BQ * 2;  // bf16s
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Kt = reinterpret_cast<bf16*>(smem);
  bf16* Vt = Kt + TC_R * LD;
  bf16* Ring = Vt + TC_R * LD;  // stages of [q | g | q' | g' | stats]

  const int N = a.N, H = a.H;
  const Place pl = place(N, H, TC_R);
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
    for (int idx = threadIdx.x; idx < KN * BQ; idx += TC_NT) {
      const int k = REC == LEAN ? idx / BQ * 2 : idx / BQ, i = idx % BQ;
      const int n = q0 + i;
      const bool ok = n < N;
      const size_t row = ((size_t)pl.b * N + (ok ? n : 0)) * H + pl.h;
      const float* src = REC == LEAN ? (k == 0 ? a.lse : a.delta) + row
                                     : a.st + row * 3 + k;
      cp4(St + k * BQ + i, src, ok);
    }
  };
  cp_tile<TC_R, DH>(Kt, a.k.head(pl.b, pl.h, DH) + (size_t)k0 * a.k.sn,
                    a.k.sn, N - k0);
  cp_tile<TC_R, DH>(Vt, a.v.head(pl.b, pl.h, DH) + (size_t)k0 * a.v.sn,
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
    // ds = T(p (dp - t)); lean p = T(exp(T(s - lse))), ds = T(p (dp - delta));
    // block p = e * (1/r), T(p), ds = T(p (dp - delta))
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
        if (REC == RECOMP || REC == BLOCK) {
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
    // block dV += T(p)^T g, dK += ds^T T(q * qscale); otherwise
    // dV += T(p)^T g, dK += ds^T q
    frags_by_tile<DH, BQ / 16>(dv, Pe, REC == PIPE ? Sq + 3 * QTILE : Gq);
    if constexpr (REC == BLOCK)
      frags_by_tile<DH, BQ / 16, true>(dk, Pd, Sq, qs2);
    else
      frags_by_tile<DH, BQ / 16>(dk, Pd, REC == PIPE ? Sq + 2 * QTILE : Sq);
    __syncthreads();
  }

  // dk = T(dK) pipelined and block, T(dK * scale) otherwise; dv = T(dV);
  // staged through this warp's own rows of the K and V tiles
  const float fk = REC == PIPE || REC == BLOCK ? 1.0f : a.scale;
  const size_t o = ((size_t)pl.b * N + k0 + w0) * a.ldo + pl.h * DH;
  store_rows<DH>(dk, fk, fk, Kt + w0 * LD, a.dk + o, a.ldo, N - k0 - w0);
  store_rows<DH>(dv, 1.0f, 1.0f, Vt + w0 * LD, a.dv + o, a.ldo,
                 N - k0 - w0);
}

template <int DH, int REC>
cudaError_t launch_bwd_mma(const BwdArgs<bf16>& a, cudaStream_t st) {
  constexpr size_t s1 = smem_bwd_q(DH), s2 = smem_bwd_kv(DH, REC);
  cudaError_t e;
  if ((e = set_smem((const void*)heads_bwd_q_kernel<DH, REC>, s1)) ||
      (e = set_smem((const void*)heads_bwd_kv_kernel<DH, REC>, s2)))
    return e;
  const int blocks = a.B * ((a.N + TC_R - 1) / TC_R) * a.H;
  heads_bwd_q_kernel<DH, REC><<<blocks, TC_NT, s1, st>>>(a);
  heads_bwd_kv_kernel<DH, REC><<<blocks, TC_NT, s2, st>>>(a);
  return cudaGetLastError();
}

}  // namespace
