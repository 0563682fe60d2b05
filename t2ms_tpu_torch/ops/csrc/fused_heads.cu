// Multi-head attention on the natural (B, N, H*DH) layout, forward and
// backward, hand-written for Hopper (sm_90a), bf16 and f32.
//
// Replaces the TPU kernels t2ms_tpu/ops/attention.py:fused_heads_attention
// (_fused_heads_kernel), fused_heads_attention_with_stats
// (_fused_heads_stats_kernel), fused_heads_attention_bwd (the head-grouped
// _bwd_pipelined_blocked_kernel, the JAX default at the scaled train step's
// geometry, and the ungrouped recompute kernels _fused_heads_bwd_kernel and
// _fused_heads_bwd_blocked_kernel), fused_heads_attention_bwd_two_pass
// (_bwd_pass1_kernel, _bwd_pass2_kernel: the recompute recipe split for the
// TPU's VMEM at N=4096, the JAX default on the long-series train path), and
// the opt-in lean backwards fused_heads_attention_bwd_lean (_bwd_lean_kernel)
// and fused_heads_attention_bwd_lean_two_pass (_bwd_lean_p1_kernel,
// _bwd_lean_p2_kernel). q, k, v and g are read through their own batch and
// row strides, so the column slices of one qkv projection are not copied.
//
//   forward   heads_fwd_kernel in bf16, heads_attn_kernel in f32
//             (attn_heads.cuh, shared with the split block and the stack,
//             whose source note has the design): bf16 per (element, 128 q
//             rows, head), two warpgroups on wgmma over a TMA ring of
//             64-key K/V tiles; q scaled at input width, f32 scores, the
//             exact softmax in two passes (row max; then e =
//             T(exp(T(s - m))), f32 row sums, f32 PV), o = T(PV / r); the
//             stats forward also writes each row's lse = m + log(r) (f32,
//             (B, N, H)), and o stays bit-equal.
//   backward  recomputes the probabilities from q and k with one of three
//             recipes' rounding points:
//     rows    m, the row max of s = T(q * scale) k^T (f32); e =
//             T(exp(T(s - m))); r = sum e and u = sum dp * e with dp = g v^T
//             (f32), so 1/r and t = u / r; t is the recompute recipe's
//             delta = rowsum(dp * p) too.
//     dq      pipelined  ds_u = T(e * (dp - t)), dq = T((ds_u k) * (scale/r));
//             recompute  p = e / r, ds = T(p * (dp - t)), dq = T((ds k) * scale).
//     dk, dv  pipelined  dv = T(sum e^T T(g / r)),
//                        dk = T(sum ds_u^T T(q * scale / r));
//             recompute  dv = T(sum T(p)^T g), dk = T((sum ds^T q) * scale),
//                        q unscaled.
//     lean    m and t are the caller's lse and delta = rowsum(f32(g) f32(o))
//             (f32, (B, N, H)), p = T(exp(T(s - lse))),
//             ds = T(p * (dp - delta)); dq, dk and dv as in the recompute
//             recipe.
//             The TPU's single-pass and two-pass kernels differ in how they
//             tile VMEM, not in what they compute, so the recompute recipe
//             serves #11's ungrouped kernels and #12, and the lean recipe
//             serves both lean kernels.
//
// bf16 backward (heads_bwd.cuh): two kernels, dq in the q-tile kernel and
// dk/dv in the k-tile kernel, so every sum has one order and runs repeat
// bit for bit (no atomics). The q-tile kernel folds in the rows' statistics
// (pass 1: m; pass 2: r, u, and for the pipelined recipe T(q * scale / r)
// and T(g / r) written once to a (B, N, HD) workspace; pass 3: dq), so q and
// g are loaded once per q tile; the row max stays a pass of its own, since
// e needs the row's final m (an online rescaling would round elsewhere).
// N x N x d products: pipelined and recompute 10 (q kernel: QK^T three
// times, dP twice, dS K; kv kernel: QK^T, dP, dS^T Q, e^T G), lean 7 (no
// statistics passes). The f32 entries keep the FMA-loop kernels below
// (a stats, a dq and a dk/dv kernel), which the CPU-twin checks hold
// tight; no timed path runs them.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s) counts the five
// products the gradient needs (QK^T, dP, dQ, dK, dV). At the scaled train
// step's call (B=64, N=1024, HD=512, 8 heads of 64, bf16): 343.6 GFLOP,
// 0.347 ms, against 470 MB, 0.140 ms; at the long-series train step's call
// (B=8, N=4096, 4 heads of 32): 171.8 GFLOP, 0.174 ms, against 59 MB. Both
// are bound by operations. The forward's two products at the scaled call
// are 137.4 GFLOP, 0.139 ms, against 268 MB, 0.080 ms: operations again.
//
// The bf16 forward and backward run on wgmma with their streamed tiles
// by TMA (attn_heads.cuh holds the shared primitives and the forward's
// note, heads_bwd.cuh the backward's): 128-row blocks of two warpgroups
// that share each streamed tile, S and dP in accumulator registers, e and
// ds packed where they are formed as the next product's A operand, and
// one formula for e in both directions (exp_rounded2). The q-tile kernel
// also forms T(q * scale / r) and T(g / r) once per q row for the
// pipelined recipe, which the kv kernel streams; the product count stays
// 10 (7 lean), since an exact row max needs its own pass.
//
// C interface for ctypes: fused_heads_forward_{bf16,f32},
// fused_heads_forward_stats_{bf16,f32} (with the lse output),
// fused_heads_backward_{bf16,f32} (its `pipelined` flag picks the recipe) and
// fused_heads_backward_lean_{bf16,f32} launch on the given stream and return
// cudaGetLastError(), or T2MS_UNSUPPORTED_SHAPE (launching nothing) for a
// shape the kernels do not take; fused_heads_backward_workspace gives the
// bytes of the per-row statistics (and, pipelined, of the two bf16 tiles)
// the caller allocates; fused_heads_forward_smem and
// fused_heads_backward_smem give the bf16 kernels' shared memory;
// fused_heads_check answers the shape question.

#include "heads_bwd.cuh"

namespace {

// ------------------------------------------------ the f32 backward kernels

// Shared memory of the three f32 backward kernels (carved in this order)
template <typename T>
__host__ __device__ size_t smem_bwd(int DH, int kernel) {
  const int R = tb<T>(), P = pad<T>();
  const size_t tile = al128(R * (DH + P) * sizeof(T));    // Q, G, K, V
  const size_t sq = al128(R * (R + PADF) * 4);            // S, dP
  const size_t e = al128(R * (R + P) * sizeof(T));        // E, dS
  const size_t acc = al128(R * (DH + PADF) * 4);          // dQ, dK, dV
  const size_t rows = 3 * al128(R * 4);                   // per-row stats
  if (kernel == 0) return 4 * tile + 2 * sq + rows;             // stats
  if (kernel == 1) return 4 * tile + 2 * sq + e + acc + rows;   // dq
  return 4 * tile + 2 * sq + 2 * e + 2 * acc + rows;            // dkdv
}

// The q side of a backward tile: Qs = T(q * qscale), Gs = g, rows past
// `valid` zero.
template <typename T, int DH>
__device__ void load_q_side(const BwdArgs<T>& a, int b, int h, int q0,
                            int valid, T* Qs, T* Gs, int ld) {
  constexpr int R = tb<T>();
  load_q_scaled<T, DH>(Qs, ld, a.q.head(b, h, DH), a.q.sn, q0, R, valid,
                       a.qscale);
  load_rows<T>(Gs, ld, a.g.head(b, h, DH) + (size_t)q0 * a.g.sn, a.g.sn, R,
               valid, DH);
}

// S = Qs Ks^T and dP = Gs Vs^T (f32)
template <typename T, int DH>
__device__ void scores(const T* Qs, const T* Gs, const T* Ks, const T* Vs,
                       int ld, float* Ss, float* dPs, int lds) {
  constexpr int R = tb<T>();
  Mma<T, true>::run(Qs, ld, Ks, ld, Ss, lds, R, R, DH, false);
  Mma<T, true>::run(Gs, ld, Vs, ld, dPs, lds, R, R, DH, false);
}

// stats: m (pass 1), then r = sum e and u = sum dp * e (pass 2)
template <typename T, int DH>
__global__ void __launch_bounds__(NT) heads_bwd_stats_kernel(BwdArgs<T> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int R = tb<T>(), ld = DH + pad<T>(), lds = R + PADF;
  unsigned char* p = smem;
  T* Qs = reinterpret_cast<T*>(p);  p += al128(R * ld * sizeof(T));
  T* Gs = reinterpret_cast<T*>(p);  p += al128(R * ld * sizeof(T));
  T* Ks = reinterpret_cast<T*>(p);  p += al128(R * ld * sizeof(T));
  T* Vs = reinterpret_cast<T*>(p);  p += al128(R * ld * sizeof(T));
  float* Ss = reinterpret_cast<float*>(p);  p += al128(R * lds * 4);
  float* dPs = reinterpret_cast<float*>(p); p += al128(R * lds * 4);
  float* Ms = reinterpret_cast<float*>(p);  p += al128(R * 4);
  float* Rs = reinterpret_cast<float*>(p);  p += al128(R * 4);
  float* Us = reinterpret_cast<float*>(p);

  const int N = a.N;
  const Place pl = place(N, a.H, R);
  const int vq = min(R, N - pl.t0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* kh = a.k.head(pl.b, pl.h, DH);
  const T* vh = a.v.head(pl.b, pl.h, DH);
  load_q_side<T, DH>(a, pl.b, pl.h, pl.t0, vq, Qs, Gs, ld);
  for (int i = threadIdx.x; i < R; i += NT) {
    Ms[i] = -INFINITY;
    Rs[i] = Us[i] = 0.0f;
  }

  for (int k0 = 0; k0 < N; k0 += R) {
    __syncthreads();
    load_rows<T>(Ks, ld, kh + (size_t)k0 * a.k.sn, a.k.sn, R, N - k0, DH);
    __syncthreads();
    Mma<T, true>::run(Qs, ld, Ks, ld, Ss, lds, R, R, DH, false);
    __syncthreads();
    for (int i = warp; i < R; i += NW) {
      float m = -INFINITY;
      for (int j = lane; j < R; j += 32)
        if (k0 + j < N) m = fmaxf(m, Ss[i * lds + j]);
      m = warp_max(m);
      if (lane == 0) Ms[i] = fmaxf(Ms[i], m);
    }
  }
  for (int k0 = 0; k0 < N; k0 += R) {
    __syncthreads();
    load_rows<T>(Ks, ld, kh + (size_t)k0 * a.k.sn, a.k.sn, R, N - k0, DH);
    load_rows<T>(Vs, ld, vh + (size_t)k0 * a.v.sn, a.v.sn, R, N - k0, DH);
    __syncthreads();
    scores<T, DH>(Qs, Gs, Ks, Vs, ld, Ss, dPs, lds);
    __syncthreads();
    for (int i = warp; i < R; i += NW) {
      const float m = Ms[i];
      float r = 0.0f, u = 0.0f;
      for (int j = lane; j < R; j += 32) {
        if (k0 + j < N) {
          const float e = rnd<T>(expf(rnd<T>(Ss[i * lds + j] - m)));
          r += e;
          u += dPs[i * lds + j] * e;
        }
      }
      r = warp_sum(r);
      u = warp_sum(u);
      if (lane == 0) {
        Rs[i] += r;
        Us[i] += u;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < vq; i += NT) {
    float* s = a.st + (((size_t)pl.b * N + pl.t0 + i) * a.H + pl.h) * 3;
    const float inv_r = 1.0f / Rs[i];
    s[0] = Ms[i];
    s[1] = inv_r;
    s[2] = Us[i] * inv_r;
  }
}

// The rows' m, 1/r and t from the stats workspace, or (lean) lse in m's
// place and delta in t's; rows past `valid` get 0, so their e, ds, g / r and
// q * scale / r vanish.
template <typename T, int REC>
__device__ void load_stats(const BwdArgs<T>& a, int b, int h, int q0,
                           int valid, float* Ms, float* Ir, float* Ts) {
  for (int i = threadIdx.x; i < tb<T>(); i += NT) {
    const size_t r = ((size_t)b * a.N + q0 + i) * a.H + h;
    const bool ok = i < valid;
    if (REC == LEAN) {
      Ms[i] = ok ? a.lse[r] : 0.0f;
      Ir[i] = 0.0f;
      Ts[i] = ok ? a.delta[r] : 0.0f;
    } else {
      Ms[i] = ok ? a.st[r * 3] : 0.0f;
      Ir[i] = ok ? a.st[r * 3 + 1] : 0.0f;
      Ts[i] = ok ? a.st[r * 3 + 2] : 0.0f;
    }
  }
}

// For q row i < vq and k row j < vk (zero outside): e = T(exp(T(s - m)))
// and ds_u = e * (dp - t) (pipelined), or p = e / r and ds = p * (dp - t)
// (recompute, returned in e's place), or (lean, m = lse and t = delta)
// p = e and ds = p * (dp - delta).
template <typename T, int REC>
__device__ __forceinline__ void e_ds(const float* Ss, const float* dPs,
                                     int lds, const float* Ms,
                                     const float* Ir, const float* Ts, int i,
                                     int j, int vq, int vk, float& e,
                                     float& ds) {
  e = 0.0f;
  ds = 0.0f;
  if (i < vq && j < vk) {
    e = rnd<T>(expf(rnd<T>(Ss[i * lds + j] - Ms[i])));
    if (REC == RECOMP) e *= Ir[i];
    ds = e * (dPs[i * lds + j] - Ts[i]);
  }
}

template <typename T, int DH, int REC>
__global__ void __launch_bounds__(NT) heads_bwd_dq_kernel(BwdArgs<T> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int R = tb<T>(), P = pad<T>();
  constexpr int ld = DH + P, lds = R + PADF, ldp = R + P, ldf = DH + PADF;
  unsigned char* p = smem;
  T* Qs = reinterpret_cast<T*>(p);  p += al128(R * ld * sizeof(T));
  T* Gs = reinterpret_cast<T*>(p);  p += al128(R * ld * sizeof(T));
  T* Ks = reinterpret_cast<T*>(p);  p += al128(R * ld * sizeof(T));
  T* Vs = reinterpret_cast<T*>(p);  p += al128(R * ld * sizeof(T));
  float* Ss = reinterpret_cast<float*>(p);  p += al128(R * lds * 4);
  float* dPs = reinterpret_cast<float*>(p); p += al128(R * lds * 4);
  T* DSs = reinterpret_cast<T*>(p);  p += al128(R * ldp * sizeof(T));
  float* dQ = reinterpret_cast<float*>(p);  p += al128(R * ldf * 4);
  float* Ms = reinterpret_cast<float*>(p);  p += al128(R * 4);
  float* Ir = reinterpret_cast<float*>(p);  p += al128(R * 4);
  float* Ts = reinterpret_cast<float*>(p);

  const int N = a.N;
  const Place pl = place(N, a.H, R);
  const int vq = min(R, N - pl.t0);
  const T* kh = a.k.head(pl.b, pl.h, DH);
  const T* vh = a.v.head(pl.b, pl.h, DH);
  load_q_side<T, DH>(a, pl.b, pl.h, pl.t0, vq, Qs, Gs, ld);
  load_stats<T, REC>(a, pl.b, pl.h, pl.t0, vq, Ms, Ir, Ts);
  PvAcc<T, DH, R> acc;
  acc.zero(dQ, ldf);

  for (int k0 = 0; k0 < N; k0 += R) {
    const int vk = min(R, N - k0);
    __syncthreads();
    load_rows<T>(Ks, ld, kh + (size_t)k0 * a.k.sn, a.k.sn, R, vk, DH);
    load_rows<T>(Vs, ld, vh + (size_t)k0 * a.v.sn, a.v.sn, R, vk, DH);
    __syncthreads();
    scores<T, DH>(Qs, Gs, Ks, Vs, ld, Ss, dPs, lds);
    __syncthreads();
    for (int idx = threadIdx.x; idx < R * R; idx += NT) {
      const int i = idx / R, j = idx % R;
      float e, ds;
      e_ds<T, REC>(Ss, dPs, lds, Ms, Ir, Ts, i, j, vq, vk, e, ds);
      DSs[i * ldp + j] = from_f<T>(ds);
    }
    __syncthreads();
    acc.mma(DSs, ldp, Ks, ld, dQ, ldf);  // dQ += ds k
  }
  __syncthreads();
  acc.store(dQ, ldf);
  __syncthreads();
  for (int idx = threadIdx.x; idx < vq * DH; idx += NT) {
    const int i = idx / DH, c = idx % DH;
    a.dq[((size_t)pl.b * N + pl.t0 + i) * a.HD + pl.h * DH + c] =
        from_f<T>(dQ[i * ldf + c] * (REC == PIPE ? a.scale * Ir[i] : a.scale));
  }
}

template <typename T, int DH, int REC>
__global__ void __launch_bounds__(NT) heads_bwd_dkdv_kernel(BwdArgs<T> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int R = tb<T>(), P = pad<T>();
  constexpr int ld = DH + P, lds = R + PADF, ldp = R + P, ldf = DH + PADF;
  unsigned char* p = smem;
  T* Qs = reinterpret_cast<T*>(p);  p += al128(R * ld * sizeof(T));
  T* Gs = reinterpret_cast<T*>(p);  p += al128(R * ld * sizeof(T));
  T* Ks = reinterpret_cast<T*>(p);  p += al128(R * ld * sizeof(T));
  T* Vs = reinterpret_cast<T*>(p);  p += al128(R * ld * sizeof(T));
  float* Ss = reinterpret_cast<float*>(p);  p += al128(R * lds * 4);
  float* dPs = reinterpret_cast<float*>(p); p += al128(R * lds * 4);
  T* Es = reinterpret_cast<T*>(p);   p += al128(R * ldp * sizeof(T));
  T* DSs = reinterpret_cast<T*>(p);  p += al128(R * ldp * sizeof(T));
  float* dK = reinterpret_cast<float*>(p);  p += al128(R * ldf * 4);
  float* dV = reinterpret_cast<float*>(p);  p += al128(R * ldf * 4);
  float* Ms = reinterpret_cast<float*>(p);  p += al128(R * 4);
  float* Ir = reinterpret_cast<float*>(p);  p += al128(R * 4);
  float* Ts = reinterpret_cast<float*>(p);

  const int N = a.N;
  const Place pl = place(N, a.H, R);
  const int vk = min(R, N - pl.t0);
  const T* qh = a.q.head(pl.b, pl.h, DH);
  load_rows<T>(Ks, ld, a.k.head(pl.b, pl.h, DH) + (size_t)pl.t0 * a.k.sn,
               a.k.sn, R, vk, DH);
  load_rows<T>(Vs, ld, a.v.head(pl.b, pl.h, DH) + (size_t)pl.t0 * a.v.sn,
               a.v.sn, R, vk, DH);
  PvAcc<T, DH, R, true> ak, av;  // dK += ds^T Qs, dV += e^T Gs
  ak.zero(dK, ldf);
  av.zero(dV, ldf);

  for (int q0 = 0; q0 < N; q0 += R) {
    const int vq = min(R, N - q0);
    __syncthreads();
    load_q_side<T, DH>(a, pl.b, pl.h, q0, vq, Qs, Gs, ld);
    load_stats<T, REC>(a, pl.b, pl.h, q0, vq, Ms, Ir, Ts);
    __syncthreads();
    scores<T, DH>(Qs, Gs, Ks, Vs, ld, Ss, dPs, lds);
    __syncthreads();
    for (int idx = threadIdx.x; idx < R * R; idx += NT) {
      const int i = idx / R, j = idx % R;  // q row i, k row j
      float e, ds;
      e_ds<T, REC>(Ss, dPs, lds, Ms, Ir, Ts, i, j, vq, vk, e, ds);
      Es[i * ldp + j] = from_f<T>(e);
      DSs[i * ldp + j] = from_f<T>(ds);
    }
    // the scores are done with Qs (and Gs): q read again, unscaled, in its
    // place; pipelined: qs = T(q * (scale / r)) and gs = T(g / r)
    for (int idx = threadIdx.x; idx < R * DH; idx += NT) {
      const int i = idx / DH, c = idx % DH;
      const float qv =
          i < vq ? to_f<T>(qh[(size_t)(q0 + i) * a.q.sn + c]) : 0.0f;
      if (REC == PIPE) {
        const float ir = Ir[i];
        Gs[i * ld + c] = from_f<T>(to_f<T>(Gs[i * ld + c]) * ir);
        Qs[i * ld + c] = from_f<T>(qv * (a.scale * ir));
      } else {
        Qs[i * ld + c] = from_f<T>(qv);
      }
    }
    __syncthreads();
    av.mma(Es, ldp, Gs, ld, dV, ldf);
    ak.mma(DSs, ldp, Qs, ld, dK, ldf);
  }
  __syncthreads();
  ak.store(dK, ldf);
  av.store(dV, ldf);
  __syncthreads();
  for (int idx = threadIdx.x; idx < vk * DH; idx += NT) {
    const int j = idx / DH, c = idx % DH;
    const size_t o = ((size_t)pl.b * N + pl.t0 + j) * a.HD + pl.h * DH + c;
    a.dk[o] =
        from_f<T>(REC == PIPE ? dK[j * ldf + c] : dK[j * ldf + c] * a.scale);
    a.dv[o] = from_f<T>(dV[j * ldf + c]);
  }
}

// The stats kernel (not for the lean recipe), then dq, then dk/dv
template <typename T, int DH, int REC>
cudaError_t launch_bwd(const BwdArgs<T>& a, cudaStream_t st) {
  const size_t s0 = smem_bwd<T>(DH, 0), s1 = smem_bwd<T>(DH, 1),
               s2 = smem_bwd<T>(DH, 2);
  cudaError_t e;
  if (REC != LEAN &&
      (e = set_smem((const void*)heads_bwd_stats_kernel<T, DH>, s0)))
    return e;
  if ((e = set_smem((const void*)heads_bwd_dq_kernel<T, DH, REC>, s1)) ||
      (e = set_smem((const void*)heads_bwd_dkdv_kernel<T, DH, REC>, s2)))
    return e;
  const int blocks = a.B * ((a.N + tb<T>() - 1) / tb<T>()) * a.H;
  if (REC != LEAN) heads_bwd_stats_kernel<T, DH><<<blocks, NT, s0, st>>>(a);
  heads_bwd_dq_kernel<T, DH, REC><<<blocks, NT, s1, st>>>(a);
  heads_bwd_dkdv_kernel<T, DH, REC><<<blocks, NT, s2, st>>>(a);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_recipe(const BwdArgs<T>& a, Recipe rec, cudaStream_t st) {
  if constexpr (sizeof(T) == 2) {
    switch (rec) {
      case PIPE: return launch_bwd_bf16<DH, PIPE>(a, st);
      case RECOMP: return launch_bwd_bf16<DH, RECOMP>(a, st);
      default: return launch_bwd_bf16<DH, LEAN>(a, st);
    }
  } else {
    switch (rec) {
      case PIPE: return launch_bwd<T, DH, PIPE>(a, st);
      case RECOMP: return launch_bwd<T, DH, RECOMP>(a, st);
      default: return launch_bwd<T, DH, LEAN>(a, st);
    }
  }
}

// bytes of the per-row statistics, rounded up so that the pipelined bf16
// workspace tiles after them start 256-byte aligned
long long stats_bytes(int B, int N, int H) {
  return ((long long)B * N * H * 3 * 4 + 255) / 256 * 256;
}

// 0 when the kernels take H*DH = HD in H heads on the current device,
// T2MS_UNSUPPORTED_SHAPE when they do not, else the CUDA error of the query.
// The head width is 32, 64 or 128 (the width JAX's fused-heads route
// takes; the f32 forward splits a head's columns over two warps); every
// kernel's shared memory fits what
// one block may opt in to on this device.
template <typename T> int check_heads(int HD, int H) {
  if (H < 1 || HD < 1 || HD % H) return T2MS_UNSUPPORTED_SHAPE;
  const int DH = HD / H;
  if (DH != 32 && DH != 64 && DH != 128) return T2MS_UNSUPPORTED_SHAPE;
  const long long optin = smem_optin();
  if (optin < 0) return (int)-optin;
  size_t need = smem_heads_attn<T>(DH);
  if constexpr (sizeof(T) == 2) {
    if (smem_bwd_q(DH) > need) need = smem_bwd_q(DH);
    if (smem_bwd_kv(DH, PIPE) > need) need = smem_bwd_kv(DH, PIPE);
  } else {
    for (int k = 0; k < 3; ++k)
      if (smem_bwd<T>(DH, k) > need) need = smem_bwd<T>(DH, k);
  }
  return need <= (size_t)optin ? 0 : T2MS_UNSUPPORTED_SHAPE;
}

// rows of (B*N, .) and the blocks of every grid are indexed as int (the
// forward's tiles are QT rows, the backward's tb<T>() <= QT)
template <typename T> int check_all(int B, int N, int HD, int H) {
  if (B < 1 || N < 1 || (long long)B * N > INT_MAX ||
      (long long)B * ((N + tb<T>() - 1) / tb<T>()) * H > INT_MAX)
    return T2MS_UNSUPPORTED_SHAPE;
  return check_heads<T>(HD, H);
}

template <typename T>
int run_forward(const T* q, const T* k, const T* v, T* o, float* lse, int B,
                int N, int HD, int H, long long sqb, long long sqn,
                long long skb, long long skn, long long svb, long long svn,
                float qscale, cudaStream_t st) {
  const int ok = check_all<T>(B, N, HD, H);
  if (ok) return ok;
  return launch_heads_attn<T>(q, k, v, sqb, sqn, skb, skn, svb, svn, o, B, N,
                              HD, H, qscale, st, lse);
}

template <typename T>
int run_backward(BwdArgs<T> a, Recipe rec, cudaStream_t st) {
  const int ok = check_all<T>(a.B, a.N, a.HD, a.H);
  if (ok) return ok;
  a.ldo = a.HD;  // dq, dk and dv contiguous (B, N, HD)
  if (sizeof(T) == 2 && rec == PIPE) {  // the workspace's bf16 tiles
    a.qsc = reinterpret_cast<T*>(reinterpret_cast<char*>(a.st) +
                                 stats_bytes(a.B, a.N, a.H));
    a.gsc = a.qsc + (size_t)a.B * a.N * a.HD;
  }
  switch (a.HD / a.H) {
    case 32: return launch_recipe<T, 32>(a, rec, st);
    case 64: return launch_recipe<T, 64>(a, rec, st);
    default: return launch_recipe<T, 128>(a, rec, st);
  }
}

}  // namespace

#define T2MS_HEADS_ENTRIES(SUFFIX, T)                                         \
  extern "C" int fused_heads_forward_##SUFFIX(                                \
      const void* q, const void* k, const void* v, void* o, int B, int N,     \
      int HD, int H, long long sqb, long long sqn, long long skb,             \
      long long skn, long long svb, long long svn, float qscale,              \
      void* stream) {                                                         \
    return run_forward<T>((const T*)q, (const T*)k, (const T*)v, (T*)o,       \
                          nullptr, B, N, HD, H, sqb, sqn, skb, skn, svb, svn, \
                          qscale, (cudaStream_t)stream);                      \
  }                                                                           \
  extern "C" int fused_heads_forward_stats_##SUFFIX(                          \
      const void* q, const void* k, const void* v, void* o, void* lse, int B, \
      int N, int HD, int H, long long sqb, long long sqn, long long skb,      \
      long long skn, long long svb, long long svn, float qscale,              \
      void* stream) {                                                         \
    return run_forward<T>((const T*)q, (const T*)k, (const T*)v, (T*)o,       \
                          (float*)lse, B, N, HD, H, sqb, sqn, skb, skn, svb,  \
                          svn, qscale, (cudaStream_t)stream);                 \
  }                                                                           \
  extern "C" int fused_heads_backward_##SUFFIX(                               \
      const void* q, const void* k, const void* v, const void* g, void* dq,   \
      void* dk, void* dv, void* work, int B, int N, int HD, int H,            \
      long long sqb, long long sqn, long long skb, long long skn,             \
      long long svb, long long svn, long long sgb, long long sgn,             \
      int pipelined, float scale, float qscale, void* stream) {               \
    const BwdArgs<T> a{{(const T*)q, sqb, sqn}, {(const T*)k, skb, skn},      \
                       {(const T*)v, svb, svn}, {(const T*)g, sgb, sgn},      \
                       (T*)dq, (T*)dk, (T*)dv, (float*)work, B, N, HD, H,     \
                       scale, qscale};                                        \
    return run_backward<T>(a, pipelined ? PIPE : RECOMP,                      \
                           (cudaStream_t)stream);                             \
  }                                                                           \
  extern "C" int fused_heads_backward_lean_##SUFFIX(                          \
      const void* q, const void* k, const void* v, const void* g,             \
      const void* lse, const void* delta, void* dq, void* dk, void* dv,       \
      int B, int N, int HD, int H, long long sqb, long long sqn,              \
      long long skb, long long skn, long long svb, long long svn,             \
      long long sgb, long long sgn, float scale, float qscale,                \
      void* stream) {                                                         \
    const BwdArgs<T> a{{(const T*)q, sqb, sqn}, {(const T*)k, skb, skn},      \
                       {(const T*)v, svb, svn}, {(const T*)g, sgb, sgn},      \
                       (T*)dq, (T*)dk, (T*)dv, nullptr, B, N, HD, H, scale,   \
                       qscale, (const float*)lse, (const float*)delta};       \
    return run_backward<T>(a, LEAN, (cudaStream_t)stream);                    \
  }

T2MS_HEADS_ENTRIES(bf16, __nv_bfloat16)
T2MS_HEADS_ENTRIES(f32, float)

// the statistics (B*N, H, 3) f32 and, for the pipelined recipe, the bf16
// T(q * scale / r) and T(g / r), each (B, N, HD) (which the f32 kernels
// leave unused); the lean recipe asks for none
extern "C" long long fused_heads_backward_workspace(int B, int N, int HD,
                                                    int H, int pipelined) {
  return stats_bytes(B, N, H) + (pipelined ? 2LL * B * N * HD * 2 : 0);
}

// dynamic shared memory of the bf16 forward's heads_fwd_kernel at head
// width DH
extern "C" long long fused_heads_forward_smem(int DH) {
  return (long long)smem_fwd(DH);
}

// dynamic shared memory of the bf16 backward's q-tile (kernel 0) and k-tile
// (kernel 1) kernels at head width DH with recipe rec (0 pipelined, 1
// recompute, 2 lean)
extern "C" long long fused_heads_backward_smem(int DH, int rec, int kernel) {
  return kernel == 0 ? (long long)smem_bwd_q(DH)
                     : (long long)smem_bwd_kv(DH, rec);
}

extern "C" int fused_heads_check(int HD, int H, int is_bf16) {
  return is_bf16 ? check_heads<__nv_bfloat16>(HD, H)
                 : check_heads<float>(HD, H);
}

extern "C" const char* t2ms_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
