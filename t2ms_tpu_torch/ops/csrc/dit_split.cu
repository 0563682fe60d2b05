// One adaLN-zero DiT block for wide geometries, hand-written for Hopper
// (sm_90a), bf16 and f32.
//
// Replaces the TPU kernel t2ms_tpu/ops/dit_block.py:fused_dit_block_split
// (_qkv_split_kernel, _attn_split_kernel, _mlp_split_kernel): the block of
// _block_math cut at its residual boundaries, for geometries too wide for
// the stack's kernels (whole D-wide K/V tiles and hidden-wide rows in
// shared memory). Its case is the scaled DiT: d_model 512, 8 heads of 64,
// mlp hidden 2048, 1024 tokens. Five launches per block:
//
//   (1) LN GEMM, BIAS       qkv = T(modLN(x; mod0, mod1) @ wqkv + bqkv)
//   (2) heads_fwd_kernel    o   = softmax(q k^T) v, per head, merged
//                           (attn_heads.cuh, shared with fused_heads.cu:
//                           bf16 on wgmma, 128 q rows a block, K and V by
//                           TMA; heads_attn_kernel in f32)
//   (3) STREAM GEMM, RESID  y1  = x + T(gate2) * T(o @ wproj + bproj)
//   (4) LN GEMM, GELU       h1  = gelu(T(modLN(y1; mod3, mod4) @ wfc1
//                                 + bfc1))
//   (5) STREAM GEMM, RESID  y   = y1 + T(gate5) * T(h1 @ wfc2 + bfc2)
//
// In bf16 at D 128, 256 and 512 (ROUTE_TC) (1), (3) and (4) run on
// split_tc.cuh's persistent, warp-specialised kernel (split_rows_tc_kernel)
// once a call has more rows than one 128-row tile a SM (sp_rows_take: the
// scaled CFG call's 32,768); on fewer (one server request's 2048)
// wg_gemm.cuh's kernel was as fast or faster (PERF.md). The MLP half stays
// two launches with h1 through device memory: one launch that keeps h1 on
// chip was built and measured slower (PERF.md: 0.76 ms against 0.43 for (4)
// and (5) at the scaled call, its 64-row tiles streaming 2.2 GB of weights
// through L2, and slower still in clusters of two and four blocks sharing
// each weight item).
//
// Numerics are the stack's: LayerNorm in f32 (eps from the caller), every
// product accumulated in f32 with the rounded bias added in f32 and then
// cast, q scaled at input width, f32 scores, the exact row softmax in two
// passes over K (row max first; then e = T(exp(T(s - m))), f32 row sums,
// f32 PV), normalisation after PV, tanh-GELU (in bf16 as v / (1 +
// exp(-2u)) on the exponent unit, wg_gemm.cuh's gelu_fast, as the stack's
// bf16 MLP takes it), gated residuals in T.
//
// Bound on an H100 SXM at the scaled call (2B=32, N=1024, D=512, 8 heads,
// hidden 2048, bf16): 274.9 GFLOP of matrix products, 206.2 of them in the
// four GEMMs (qkv 51.5, proj 17.2, fc1 68.7, fc2 68.7), 0.278 ms at 989
// TFLOP/s. The GEMMs also move their operands through device memory
// between launches (x and qkv, o, y1 and x, y1 and h1, h1 and y1 and y:
// about 0.58 GB, 0.17 ms at 3.35 TB/s), so each is near the line where
// bytes and operations bound it alike: proj is bound by bytes (101 MB
// against 17.2 GFLOP), the others by operations.
//
// Elsewhere, and (5) always, the GEMMs run on wg_gemm.cuh's wgmma
// row GEMM: 128-row blocks of two consumer warpgroups, 128-column steps,
// both operands through 128-byte-swizzled shared memory filled by TMA from
// a producer warp, and the epilogue from the accumulator registers through
// a shared output tile. (1) and (4) normalise their 128 x D row tile once
// into shared memory and serve every column step from it; where that tile,
// the ring and the output tiles outgrow the opt-in (D above 512 at 227 KB)
// they take 64-row blocks of one warpgroup and 64-column steps
// (ROUTE_NARROW; D up to 1536). (3) and (5) stream A with W and prefetch
// the residual. The attention (2) takes one block per (batch element, 64
// q rows, head) and streams that head's K/V tiles, so a head's whole K/V
// is never staged (attn_heads.cuh says how).
//
// f32 keeps the first version's kernels: gemm_kernel, one block per 64-row
// tile walking 128-column steps with FMA loops (WarpAcc<float>) that stay
// tight against the twin, the weight (and a streamed A) through a
// double-buffered cp.async ring of 64-deep chunks, the f32 output tile
// through shared memory. No timed path runs f32.
//
// C interface for ctypes: dit_split_forward_{bf16,f32} launch the block on
// the given stream and return cudaGetLastError(), or T2MS_UNSUPPORTED_SHAPE
// (launching nothing) for a shape the kernels do not take; dit_split_check
// answers that question alone (the limits live in check_split below);
// dit_split_gemm_bf16 launches one of the four GEMMs alone, and
// dit_split_route and dit_split_smem say which bf16 route a call takes and
// how much shared memory a stage takes.

#include <type_traits>

#include "split_tc.cuh"

namespace {

constexpr int GM = 64;    // rows per GEMM tile
constexpr int GN = 128;   // output columns per GEMM step
constexpr int GK = 64;    // K depth of a streamed chunk

enum { PRO_LN, PRO_LOAD };               // A: modulated LN of x, or as is
enum { EPI_BIAS, EPI_GELU, EPI_RESID };  // what the GEMM writes

// ---------------------------------------------------------------------------
// dst[r * ldd + c] = src[r * ld + c] for r < valid, 0 for valid <= r < rows,
// through the asynchronous copies of attn_heads.cuh
template <typename T>
__device__ void cp_tile(T* dst, int ldd, const T* __restrict__ src, size_t ld,
                        int rows, int valid, int cols) {
  constexpr int V = 16 / sizeof(T);
  const int vpr = cols / V;
  for (int idx = threadIdx.x; idx < rows * vpr; idx += NT) {
    const int r = idx / vpr, c = (idx % vpr) * V;
    const bool ok = r < valid;
    cp16(dst + r * ldd + c, ok ? src + (size_t)r * ld + c : src, ok);
  }
}

// ---------------------------------------------------------------------------
// f32: a warp's 32 x 32 block of C += A @ B, f32 sums kept in registers
// across calls. A: 32 rows, row-major (lda); B: K x 32, row-major (ldb).

template <typename T> struct WarpAcc;

template <> struct WarpAcc<float> {
  float c[32];  // lane l holds column l of the warp's 32 rows
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 32; ++i) c[i] = 0.0f;
  }
  __device__ void mma(const float* A, int lda, const float* B, int ldb,
                      int K) {
    const int lane = threadIdx.x % 32;
    for (int k = 0; k < K; ++k) {
      const float b = B[k * ldb + lane];
#pragma unroll
      for (int i = 0; i < 32; ++i) c[i] = fmaf(A[i * lda + k], b, c[i]);
    }
  }
  __device__ void store(float* C, int ldc) {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int i = 0; i < 32; ++i) C[i * ldc + lane] = c[i];
  }
};

// ---------------------------------------------------------------------------
// Shared memory and shape limits

// gemm_kernel: the A operand (the whole K-wide row tile when staged for the
// LayerNorm, else two streamed chunks), then two weight chunks, which the
// f32 output tile of a step reuses after its last product.
template <typename T>
__host__ __device__ size_t smem_gemm(bool staged, int K) {
  const int P = pad<T>();
  const size_t a = staged ? al128(GM * (K + P) * sizeof(T))
                          : 2 * al128(GM * (GK + P) * sizeof(T));
  const size_t w = 2 * al128(GK * (GN + P) * sizeof(T));
  const size_t c = al128(GM * (GN + PADF) * 4);
  return a + (w > c ? w : c);
}

// bf16 routes of the LayerNorm GEMMs (1) and (4): 128-row blocks with
// 128-column steps where the staged 128 x D tile and the ring fit the
// device's opt-in, else 64-row blocks with 64-column steps, else none
enum { ROUTE_NONE = 0, ROUTE_NARROW = 1, ROUTE_WIDE = 2, ROUTE_TC = 3 };
inline int ln_route(int D, long long optin) {
  if (smem_wg<2, 128>(true, D) <= (size_t)optin) return ROUTE_WIDE;
  if (smem_wg<1, 64>(true, D) <= (size_t)optin) return ROUTE_NARROW;
  return ROUTE_NONE;
}
// The bf16 block's route at width D: qkv, proj and fc1 on split_tc.cuh's
// persistent kernel where it has an instance and fits the opt-in beside its
// static barriers (fc2 then on ln_route's 128-row kernel), else ln_route's
// for all four
inline int split_route(int D, long long optin) {
  if (sp_width(D) && smem_sp_rows(D) + RW_STATIC <= (size_t)optin &&
      ln_route(D, optin) == ROUTE_WIDE)
    return ROUTE_TC;
  return ln_route(D, optin);
}
// Whether a call of `rows` rows on ROUTE_TC runs qkv, proj and fc1 on the
// persistent kernel: with more rows than one 128-row tile a SM, the 128-row
// kernel needs a second wave and the persistent one overlaps one group's
// LayerNorm and epilogue with the other's products; with fewer, each of its
// groups has one tile at most, nothing to overlap, and it was no faster
// (qkv) or slower (proj, 0.0225 against 0.0212 ms at 2048 rows, PERF.md),
// so wg_gemm.cuh's 128-row kernels take them (ROUTE_WIDE)
inline bool sp_rows_take(int rows) {
  const int sms = rw_sms();
  return sms > 0 && (long long)rows > 128LL * sms;
}
// The route a bf16 call of `rows` rows takes at width D
inline int call_route(int D, int rows, long long optin) {
  const int r = split_route(D, optin);
  return r == ROUTE_TC && !sp_rows_take(rows) ? ROUTE_WIDE : r;
}

// 0 when the kernels take (D, hidden, H) on the current device,
// T2MS_UNSUPPORTED_SHAPE when they do not, else the CUDA error of the query.
// D and hidden are multiples of the 128-column GEMM step (so of the 64-deep
// K chunk too); the head width is 32, 64 or 128 (the attention holds a
// warp's rows of a head as 16-wide tensor-core tiles); each kernel's
// shared memory fits what one block may opt in to on this device (the
// staged LayerNorm tile grows with D: in bf16 up to D = 1536 at 227 KB).
template <typename T>
int check_split(int D, int hidden, int H) {
  if (H < 1 || D < GN || hidden < GN || D % GN || hidden % GN || D % H)
    return T2MS_UNSUPPORTED_SHAPE;
  const int DH = D / H;
  if (DH != 32 && DH != 64 && DH != 128) return T2MS_UNSUPPORTED_SHAPE;
  const long long optin = smem_optin();
  if (optin < 0) return (int)-optin;
  size_t need = smem_heads_attn<T>(DH);
  if constexpr (sizeof(T) == 2) {
    if (ln_route(D, optin) == ROUTE_NONE) return T2MS_UNSUPPORTED_SHAPE;
    if (smem_wg<2, 128>(false, 0) > need) need = smem_wg<2, 128>(false, 0);
  } else {
    if (smem_gemm<T>(true, D) > need) need = smem_gemm<T>(true, D);
    if (smem_gemm<T>(false, 0) > need) need = smem_gemm<T>(false, 0);
  }
  return need <= (size_t)optin ? 0 : T2MS_UNSUPPORTED_SHAPE;
}

// ---------------------------------------------------------------------------
// f32 (1), (3), (4), (5): out = epilogue(A @ w + bias) for one 64-row tile

template <typename T> struct GemmArgs {
  const T* a;        // (rows, K): x for the LayerNorm prologue, else A
  const float* mod;  // (B, 6, D) adaLN vectors, f32
  const T* w;        // (K, cols), flax layout
  const T* bias;     // (cols)
  const T* res;      // (rows, cols) residual of EPI_RESID
  T* out;            // (rows, cols)
  int rows, N, K, cols;
  int ish, isc, igate;  // rows of mod: LN shift and scale, residual gate
  float eps;
};

// In place: As[i] = T(LN(As[i]) * (1 + mod[b, isc]) + mod[b, ish]) in f32
// for the tile's valid rows, one warp per row, two passes over the staged
// row (mean, then variance); rows past `valid` stay zero.
template <typename T>
__device__ void modln_tile(T* As, int lda, int valid, int D,
                           const float* __restrict__ mod, int r0, int N,
                           int ish, int isc, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < valid; i += NW) {
    T* row = As + i * lda;
    float s = 0.0f;
    for (int c = lane; c < D; c += 32) s += to_f<T>(row[c]);
    const float mu = warp_sum(s) / D;
    float q = 0.0f;
    for (int c = lane; c < D; c += 32) {
      const float d = to_f<T>(row[c]) - mu;
      q += d * d;
    }
    const float rs = rsqrtf(warp_sum(q) / D + eps);
    const int b = (r0 + i) / N;
    const float* sh = mod + ((size_t)b * 6 + ish) * D;
    const float* sc = mod + ((size_t)b * 6 + isc) * D;
    for (int c = lane; c < D; c += 32)
      row[c] = from_f<T>((to_f<T>(row[c]) - mu) * rs * (1.0f + sc[c]) + sh[c]);
  }
}

// Issue the copies of K chunk kc into buffer kc & 1: the weight rows
// [kc*GK, +GK) x columns [c0, +GN) and, unless A is staged, A's tile rows x
// columns [kc*GK, +GK).
template <typename T, bool STAGED>
__device__ __forceinline__ void load_chunk(const GemmArgs<T>& g,
                                           unsigned char* a_buf,
                                           size_t a_bytes,
                                           unsigned char* w_buf,
                                           size_t w_bytes, int lda, int ldw,
                                           int r0, int valid, int c0,
                                           int kc) {
  const int s = kc & 1;
  cp_tile<T>(reinterpret_cast<T*>(w_buf + s * w_bytes), ldw,
             g.w + (size_t)kc * GK * g.cols + c0, g.cols, GK, GK, GN);
  if (!STAGED)
    cp_tile<T>(reinterpret_cast<T*>(a_buf + s * a_bytes), lda,
               g.a + (size_t)r0 * g.K + kc * GK, g.K, GM, valid, GK);
  cp_commit();
}

template <typename T, int PRO, int EPI>
__global__ void __launch_bounds__(NT) gemm_kernel(const GemmArgs<T> g) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr bool staged = PRO == PRO_LN;
  const int K = g.K;
  const int lda = (staged ? K : GK) + pad<T>(), ldw = GN + pad<T>();
  const int ldc = GN + PADF;
  const size_t a_bytes = al128(GM * lda * sizeof(T));
  const size_t w_bytes = al128(GK * ldw * sizeof(T));
  T* As = reinterpret_cast<T*>(smem);
  unsigned char* w_buf = smem + (staged ? 1 : 2) * a_bytes;
  float* Cs = reinterpret_cast<float*>(w_buf);  // after a step's last product
  const int r0 = blockIdx.x * GM;
  const int valid = min(GM, g.rows - r0);
  const int warp = threadIdx.x / 32;
  const int wr = (warp % 2) * 32, wc = (warp / 2) * 32;  // 2 x 4 warps
  const int nk = K / GK;

  if (staged) {
    load_rows<T>(As, lda, g.a + (size_t)r0 * K, K, GM, valid, K);
    __syncthreads();
    modln_tile<T>(As, lda, valid, K, g.mod, r0, g.N, g.ish, g.isc, g.eps);
  }
  for (int c0 = 0; c0 < g.cols; c0 += GN) {
    WarpAcc<T> acc;
    acc.zero();
    load_chunk<T, staged>(g, smem, a_bytes, w_buf, w_bytes, lda, ldw, r0,
                          valid, c0, 0);
    for (int kc = 0; kc < nk; ++kc) {
      // the next chunk's copies fly while this one is multiplied
      if (kc + 1 < nk)
        load_chunk<T, staged>(g, smem, a_bytes, w_buf, w_bytes, lda, ldw, r0,
                              valid, c0, kc + 1);
      else
        cp_commit();
      cp_wait<1>();
      __syncthreads();
      const T* Ab = staged ? As + kc * GK
                           : reinterpret_cast<const T*>(
                                 smem + (kc & 1) * a_bytes);
      const T* Wb = reinterpret_cast<const T*>(w_buf + (kc & 1) * w_bytes);
      acc.mma(Ab + wr * lda, lda, Wb + wc, ldw, GK);
      __syncthreads();
    }
    acc.store(Cs + wr * ldc + wc, ldc);
    __syncthreads();
    for (int idx = threadIdx.x; idx < GM * GN; idx += NT) {
      const int i = idx / GN, j = idx % GN;
      if (i >= valid) continue;
      const int r = r0 + i, c = c0 + j;
      const size_t o = (size_t)r * g.cols + c;
      const float v = Cs[i * ldc + j] + to_f<T>(g.bias[c]);
      if (EPI == EPI_BIAS) {
        g.out[o] = from_f<T>(v);
      } else if (EPI == EPI_GELU) {
        g.out[o] = from_f<T>(gelu_tanh(rnd<T>(v)));
      } else {
        const int b = r / g.N;
        const float gate =
            rnd<T>(g.mod[((size_t)b * 6 + g.igate) * g.cols + c]);
        g.out[o] = from_f<T>(to_f<T>(g.res[o]) + rnd<T>(gate * rnd<T>(v)));
      }
    }
    __syncthreads();  // Cs is the next step's weight buffer
  }
}

// ---------------------------------------------------------------------------
// Launches

// the four GEMMs of a block, by their place in it
enum { STAGE_QKV, STAGE_PROJ, STAGE_FC1, STAGE_FC2 };
static_assert(STAGE_QKV == SP_QKV && STAGE_PROJ == SP_PROJ &&
                  STAGE_FC1 == SP_FC1,
              "launch_sp takes the block's stage");

template <typename T, int PRO, int EPI>
cudaError_t launch_gemm(const GemmArgs<T>& g, cudaStream_t st) {
  const size_t s = smem_gemm<T>(PRO == PRO_LN, g.K);
  const cudaError_t e = cudaFuncSetAttribute(
      gemm_kernel<T, PRO, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)s);
  if (e != cudaSuccess) return e;
  gemm_kernel<T, PRO, EPI><<<(g.rows + GM - 1) / GM, NT, s, st>>>(g);
  return cudaGetLastError();
}

// f32: one GEMM stage on gemm_kernel
template <typename T>
cudaError_t launch_stage(int stage, GemmArgs<T> g, int, cudaStream_t st) {
  switch (stage) {
    case STAGE_QKV:
      g.ish = 0, g.isc = 1;
      return launch_gemm<T, PRO_LN, EPI_BIAS>(g, st);
    case STAGE_FC1:
      g.ish = 3, g.isc = 4;
      return launch_gemm<T, PRO_LN, EPI_GELU>(g, st);
    default:
      g.igate = stage == STAGE_PROJ ? 2 : 5;
      return launch_gemm<T, PRO_LOAD, EPI_RESID>(g, st);
  }
}

// bf16: one GEMM stage on the wgmma row GEMM, the LayerNorm stages on
// `route` (ln_route)
inline cudaError_t launch_stage(int stage, WgArgs g, int route,
                                cudaStream_t st) {
  const bool wide = route == ROUTE_WIDE;
  switch (stage) {
    case STAGE_QKV:
      g.ish = 0, g.isc = 1;
      return wide ? launch_wg<WG_PRO_LN, WG_EPI_BIAS, 2, 128>(g, st)
                  : launch_wg<WG_PRO_LN, WG_EPI_BIAS, 1, 64>(g, st);
    case STAGE_FC1:
      g.ish = 3, g.isc = 4;
      return wide ? launch_wg<WG_PRO_LN, WG_EPI_GELU, 2, 128>(g, st)
                  : launch_wg<WG_PRO_LN, WG_EPI_GELU, 1, 64>(g, st);
    default:
      g.igate = stage == STAGE_PROJ ? 2 : 5;
      return launch_wg<WG_PRO_STREAM, WG_EPI_RESID, 2, 128>(g, st);
  }
}

template <typename T>
int run_split(const T* x, const float* mod, const T* wqkv, const T* bqkv,
              const T* wproj, const T* bproj, const T* wfc1, const T* bfc1,
              const T* wfc2, const T* bfc2, T* out, T* qkv, T* attn, T* y1,
              T* h1, int B, int N, int D, int hidden, int H, float eps,
              float qscale, cudaStream_t st) {
  // rows of (B*N, .) and attention blocks are indexed as int
  if (B < 1 || N < 1 || (long long)B * N > INT_MAX ||
      (long long)B * ((N + QT - 1) / QT) * H > INT_MAX)
    return T2MS_UNSUPPORTED_SHAPE;
  const int ok = check_split<T>(D, hidden, H);
  if (ok) return ok;
  const int route =
      sizeof(T) == 2 ? call_route(D, B * N, smem_optin()) : ROUTE_NONE;
  // out = the stage's epilogue(prologue(a) @ w + bias), (B*N, K) @ (K, cols)
  auto gemm = [&](int stage, const T* a, const T* w, const T* bias,
                  const T* res, T* o, int K, int cols) {
    using Args = std::conditional_t<sizeof(T) == 2, WgArgs, GemmArgs<T>>;
    const Args g{a, mod, w, bias, res, o, B * N, N, K, cols, 0, 0, 0, eps};
    // fc2 on ROUTE_TC takes the 128-row kernel (ln_route's wide)
    return launch_stage(stage, g, route == ROUTE_TC ? ROUTE_WIDE : route, st);
  };
  // qkv, proj and fc1: on ROUTE_TC split_tc.cuh's persistent kernel
  auto rows_gemm = [&](int stage, const T* a, const T* w, const T* bias,
                       const T* res, T* o, int cols) -> cudaError_t {
    if constexpr (sizeof(T) == 2)
      if (route == ROUTE_TC)
        return launch_sp(stage, D, (const bf16*)a, mod, (const bf16*)w,
                         (const bf16*)bias, (const bf16*)res, (bf16*)o,
                         B * N, N, cols, eps, st);
    return gemm(stage, a, w, bias, res, o, D, cols);
  };
  cudaError_t e;
  if ((e = rows_gemm(STAGE_QKV, x, wqkv, bqkv, nullptr, qkv, 3 * D)))
    return e;
  // attention on the q, k and v columns of qkv
  const long long W3 = 3LL * D, sb = N * W3;
  if ((e = launch_heads_attn<T>(qkv, qkv + D, qkv + 2 * D, sb, W3, sb, W3, sb,
                                W3, attn, B, N, D, H, qscale, st)))
    return e;
  if ((e = rows_gemm(STAGE_PROJ, attn, wproj, bproj, x, y1, D))) return e;
  if ((e = rows_gemm(STAGE_FC1, y1, wfc1, bfc1, nullptr, h1, hidden)))
    return e;
  if ((e = gemm(STAGE_FC2, h1, wfc2, bfc2, y1, out, hidden, D))) return e;
  return cudaGetLastError();
}

// dynamic shared memory of a bf16 GEMM stage at depth K on its route
// (split_route at D = K: qkv, proj and fc1 on ROUTE_TC at the persistent
// kernel's); 0 for a stage or K the kernels do not take on this device
size_t stage_smem(int stage, int K, long long optin) {
  const bool tc = split_route(K, optin) == ROUTE_TC;
  if (tc && stage != STAGE_FC2) return smem_sp_rows(K);
  if (stage == STAGE_PROJ || stage == STAGE_FC2)
    return smem_wg<2, 128>(false, 0) <= (size_t)optin
               ? smem_wg<2, 128>(false, 0)
               : 0;
  if (stage != STAGE_QKV && stage != STAGE_FC1) return 0;
  switch (ln_route(K, optin)) {
    case ROUTE_WIDE: return smem_wg<2, 128>(true, K);
    case ROUTE_NARROW: return smem_wg<1, 64>(true, K);
    default: return 0;
  }
}

}  // namespace

#define T2MS_SPLIT_ENTRY(NAME, T)                                            \
  extern "C" int NAME(const void* x, const void* mod, const void* wqkv,      \
                      const void* bqkv, const void* wproj, const void* bproj, \
                      const void* wfc1, const void* bfc1, const void* wfc2,  \
                      const void* bfc2, void* out, void* qkv, void* attn,    \
                      void* y1, void* h1, int B, int N, int D, int hidden,   \
                      int H, float eps, float qscale, void* stream) {        \
    return run_split<T>(                                                     \
        (const T*)x, (const float*)mod, (const T*)wqkv, (const T*)bqkv,      \
        (const T*)wproj, (const T*)bproj, (const T*)wfc1, (const T*)bfc1,    \
        (const T*)wfc2, (const T*)bfc2, (T*)out, (T*)qkv, (T*)attn, (T*)y1,  \
        (T*)h1, B, N, D, hidden, H, eps, qscale, (cudaStream_t)stream);      \
  }

T2MS_SPLIT_ENTRY(dit_split_forward_bf16, __nv_bfloat16)
T2MS_SPLIT_ENTRY(dit_split_forward_f32, float)

extern "C" int dit_split_check(int D, int hidden, int H, int is_bf16) {
  return is_bf16 ? check_split<__nv_bfloat16>(D, hidden, H)
                 : check_split<float>(D, hidden, H);
}

// One bf16 GEMM stage of the block alone (STAGE_QKV 0, STAGE_PROJ 1,
// STAGE_FC1 2, STAGE_FC2 3) on `rows` rows, N a batch element: a (rows, K),
// mod (rows / N, 6, width) f32, w (K, cols), bias (cols), res (rows, cols)
// for proj and fc2 (else unread), out (rows, cols); K and cols multiples
// of 128. The block's launches run the same kernels: qkv, proj and fc1 on
// split_tc.cuh's where call_route takes K and rows (cols 3K, K and any),
// else on wg_gemm.cuh's, as fc2 always.
extern "C" int dit_split_gemm_bf16(const void* a, const void* mod,
                                   const void* w, const void* bias,
                                   const void* res, void* out, int rows,
                                   int N, int K, int cols, int stage,
                                   float eps, void* stream) {
  if (rows < 1 || N < 1 || K < GN || cols < GN || K % GN || cols % GN ||
      stage < STAGE_QKV || stage > STAGE_FC2)
    return T2MS_UNSUPPORTED_SHAPE;
  const long long optin = smem_optin();
  if (optin < 0) return (int)-optin;
  if (!stage_smem(stage, K, optin)) return T2MS_UNSUPPORTED_SHAPE;
  cudaError_t e;
  if (call_route(K, rows, optin) == ROUTE_TC &&
      ((stage == STAGE_QKV && cols == 3 * K) ||
       (stage == STAGE_PROJ && cols == K) || stage == STAGE_FC1)) {
    e = launch_sp(stage, K, (const bf16*)a, (const float*)mod,
                  (const bf16*)w, (const bf16*)bias, (const bf16*)res,
                  (bf16*)out, rows, N, cols, eps, (cudaStream_t)stream);
  } else {
    const WgArgs g{(const bf16*)a, (const float*)mod, (const bf16*)w,
                   (const bf16*)bias, (const bf16*)res, (bf16*)out, rows, N,
                   K, cols, 0, 0, 0, eps};
    e = launch_stage(stage, g, ln_route(K, optin), (cudaStream_t)stream);
  }
  return e ? (int)e : (int)cudaGetLastError();
}

// The bf16 route a call of `rows` rows takes at width D: ROUTE_TC 3 (qkv,
// proj and fc1 on split_tc.cuh), ROUTE_WIDE 2 (128-row blocks), ROUTE_NARROW 1
// (64-row blocks) or ROUTE_NONE 0
extern "C" int dit_split_route(int D, int rows) {
  const long long optin = smem_optin();
  return optin < 0 ? ROUTE_NONE : call_route(D, rows, optin);
}

// Dynamic shared memory (bytes) of bf16 stage `stage` at depth K on its
// route
extern "C" long long dit_split_smem(int stage, int K) {
  const long long optin = smem_optin();
  return optin < 0 ? 0 : (long long)stage_smem(stage, K, optin);
}

extern "C" const char* t2ms_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
