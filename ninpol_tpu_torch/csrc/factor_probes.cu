/*
 * Kernel 1's factorization probes for NVIDIA Hopper (sm_90a): design
 * alternatives for the two factorizations of the fused solve
 * (gls_solve.cu) and for how it applies its preconditioner.
 * They are the counterparts of the TPU probes in the repo's tools/
 * (trsm_probe.py, chol_mxu_probe.py, trisolve_probe.py), timed by
 * ninpol_tpu_torch/tools/factor_probes.py on the route's own float32
 * inputs beside kernel 1's stage cuts.  No route runs them: this library
 * is built apart from the production ones, at the first probe launch.
 * ninpol_tpu_torch/ops/factor_probes.py holds the contracts, the wrappers
 * and the plain PyTorch versions.  One block a node throughout.
 *
 * chol_factor_kernel replaces tools/trisolve_probe.py:79 (the Cholesky
 *   panels alone): L of G, clamped (dinv = rsqrt(max(pivot, tiny))), no
 *   inverse; the baseline of the trisolve verdict.  Bound by memory on the
 *   card (G's triangle read, L written: 32.1 KB a node at n = 73 for 0.13
 *   MFLOP); an elimination would be held back by one block barrier for
 *   each of the n dependent pivots.  It runs blocked_factor (kernel 1's
 *   factor, panels of 16): G's triangle staged as chol_linv_tc stages it,
 *   the next node's G asked of L2, 20 block barriers a node at n = 73, L
 *   out once rounded in whole rows.
 *
 * chol_trsm_gram_kernel replaces tools/trsm_probe.py:129 (variant B) and
 *   :192 (variant C): G2 = X X^T with X = L^-1 A^T, the factor L of G,
 *   without L^-1 and without Q = A L^-T in device memory, in the TPU
 *   probe's matrix-unit form: the factor by the elimination (template kW
 *   = 0, variant B) or by blocked_factor with panels of kW = 8, 16, 32
 *   (variant C), while the node's A arrives by one cp.async.bulk; then
 *   X^T = A L^-T in place over the staged A, a warp an 8-row tile, X in
 *   float64 registers through the tile, rounded once (substitute); then
 *   X X^T on m16n8k8 by 16 x 16 blocks of its lower triangle
 *   (gram_lower), mirrored on the way out.  Bound by FP32 operations
 *   (1.55 MFLOP for 71 KB a node at (132, 73)); held by shared memory's
 *   rate in the substitution (every row tile reads all of L) and by the
 *   Gram's float64 conversions.
 *
 * chol_linv_tc_kernel replaces tools/chol_mxu_probe.py:73: the clamped
 *   Cholesky factor and L^-1 by blocked_factor (template kW = 8, 16, 32,
 *   48, the probe's super-panel widths), L^-1's 8-row block rows formed
 *   inside the factor's steps (inverse_tile), each block one DMMA product
 *   chain over the block rows already done.  With a right factor P
 *   (template kRight) it gives L^-1 P, lower_product's blocks over P's
 *   staged triangle: the route's chol2 (Lc = L2^-1 L1^-1) alone, which
 *   replaces tools/trisolve_probe.py:95.  Bound by memory (G's triangle
 *   read, L^-1 written); held by the lead warp's pivot chain, the block
 *   rows' products and its input and output, which all blocks of a
 *   launch meet at once.
 *
 * The blocked factor (chol_linv_tc, chol_trsm_gram's variant C) is
 *   blocked_factor.cuh's, which the fused solve's two factorizations run
 *   too (gls_solve.cu): L, the part still to factor and L^-1 in float64
 *   as packed triangles of 8 x 8 blocks, so no product converts an
 *   operand; 8 columns a step, right-looking by panels of kW, two block
 *   barriers a step (20 a node at n = 73; 23 in all for chol_trsm_gram);
 *   warp 0 factors each diagonal block by shuffles, with its inverse, a
 *   step ahead of the other seven warps, which form the panel against
 *   that inverse, update the rest on m16n8k8 and wait for the lead on a
 *   named barrier.  n is padded to a multiple of 8 with the identity on
 *   the padded diagonal.  The products run on FP64 DMMA (float32 inputs
 *   widened once, so each product is exact and the sums are float64,
 *   rounded once to float32): single-pass TF32 keeps ~3 digits, the
 *   preconditioner needs Gram-quality products, and DMMA's fragments
 *   need no hi/lo split.
 *
 * chol_trisolve_apply_kernel replaces tools/trisolve_probe.py:162: the
 *   factor L2 of G2 kept (no L2^-1 L1^-1), then `applies` times v <-
 *   Li^T L2^-T L2^-1 Li v, = Lc^T Lc v with Lc = L2^-1 Li (what
 *   prec_apply_f32 applies with Lc explicit).  One block of 8 warps a
 *   node, as kernel 1.  Bound by memory (G's and Li's triangles read, v
 *   read and written: 0.22 ms a (24, 36) chunk); held back by its chain of
 *   dependent steps: the factor's n / 8, then two triangular solves an
 *   apply.  The factor is chol_factor's, while Li arrives by one
 *   cp.async.bulk of the span that covers the node; after it Li's
 *   triangle is widened into a packed float64 triangle (packed_at, as
 *   kernel 1 holds L1^-1) over its own raw span (a float32 staging region
 *   of its own would cost the third block an SM: 63,680 B a node at n =
 *   73).  Template kB = 8, the blocked solves on all 8 warps: L's blocks
 *   below the diagonal are scaled to W_ik = Linv_ii L_ik and Li's block
 *   rows to Li' = Linv_ii Li (scale_rows), so a step needs no diagonal
 *   product and u = Li' v, v = Li'^T z (y never formed); warp w owns block
 *   rows (columns) w and w + 8 and keeps their partial sums in registers;
 *   at step k, after one block barrier, the owner of row k + 1 forms
 *   x_{k+1} from x_k by one m16n8k8 with the vector as A's rows (no
 *   shuffle) and stores it, while every other warp subtracts W_ik x_k from
 *   its rows by two FMAs a lane, adds a block of Li' v, or sums its next
 *   row's partial into its full value (one more m16n8k8: two shuffle
 *   levels of doubles cost more); the backward solve alike on W^T, each
 *   z_k also summed into v (apply_blocked).  2 nb - 1 block barriers an
 *   apply: 100 a node at n = 73 with the factor's 21, the staging's 3 and
 *   four applies.  kB = 1 is the TPU probe's form: Li v and Li^T y on all
 *   8 warps, a warp a block row (column); L rounded into a float32 square
 *   at an odd stride; warp 0 sweeps both solves a column at a time, one
 *   shuffle a pivot (3 barriers an apply, 37 a node).
 * Every launch function returns a cudaError_t as int (0 on success).
 */
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "blocked_factor.cuh"
#include "bulk_copy.cuh"

namespace {

using namespace blocked_factor_device;
using namespace bulk_copy;

constexpr int kGrid = 16;                 // the register grid: kGrid x kGrid threads
constexpr int kThreads = kGrid * kGrid, kWarps = kThreads / 32;
static_assert(kThreads == kFactorThreads, "blocked_factor runs on the probes' blocks");
constexpr int kFactorWidth = 16;          // chol_factor's and chol_trisolve_apply's panels

// ---- the elimination in registers (chol_trsm_gram with kW = 0)
//
// Thread (tr, tc) = (t / kGrid, t % kGrid) holds rows i = tr + kGrid a and
// columns c = tc + kGrid b of the n x n lower triangle of G, a, b < kS;
// entries outside it are 0.
template <int kS>
__device__ __forceinline__ void load_lower(const float* Gb, int n, float (&g)[kS][kS]) {
  const int tr = threadIdx.x / kGrid, tc = threadIdx.x % kGrid;
#pragma unroll
  for (int a = 0; a < kS; ++a)
#pragma unroll
    for (int b = 0; b < kS; ++b) {
      const int i = tr + kGrid * a, c = tc + kGrid * b;
      g[a][b] = i < n && c <= i ? Gb[i * n + c] : 0.f;
    }
}

// The clamped Cholesky elimination of g, d_k = rsqrt(max(pivot_k, tiny))
// into dinv[k].  At pivot k every thread reads column k of g (lcol) from
// shared memory, scales it by d_k and updates its entries of the later
// rows: g[i][c] -= L[i][k] L[c][k] for k < c <= i (only the lower half:
// all the elimination reads).  The owners of column k + 1 publish it into
// the other buffer, one barrier a pivot.  A thread visits only the slots that can still change:
// a slot of g above the diagonal slot (b > a) never does, so those are
// left out when the loops unroll, and a row slot whose rows are all <= k,
// or a column slot of g whose columns are, is skipped (each test is the
// same for the whole warp).  On exit g's column c holds L's column c
// unscaled: L[i][c] = g[i][c] dinv[c] for i > c.  Starts and ends with a
// barrier.
template <int kS>
__device__ __forceinline__ void eliminate(float (&g)[kS][kS], int n, float tiny,
                                          float (*lcol)[kGrid * kS], float* dinv) {
  const int tr = threadIdx.x / kGrid, tc = threadIdx.x % kGrid;
  if (tc == 0)
#pragma unroll
    for (int a = 0; a < kS; ++a) lcol[0][tr + kGrid * a] = g[a][0];
  __syncthreads();
  for (int k = 0; k < n; ++k) {
    const int p = k & 1;
    const float d = rsqrtf(fmaxf(lcol[p][k], tiny));
    if (threadIdx.x == 0) dinv[k] = d;
    float mg[kS];   // L[c][k]
#pragma unroll
    for (int b = 0; b < kS; ++b) mg[b] = lcol[p][tc + kGrid * b] * d;
#pragma unroll
    for (int a = 0; a < kS; ++a) {
      if (kGrid * a + kGrid - 1 < k) continue;   // every row of the slot is final
      const int i = tr + kGrid * a;
      if (i > k) {
        const float l = lcol[p][i] * d;
#pragma unroll
        for (int b = 0; b <= a; ++b) {
          if (kGrid * b + kGrid - 1 <= k) continue;   // every column of the slot is <= k
          const int c = tc + kGrid * b;
          if (c > k && c <= i) g[a][b] = fmaf(-l, mg[b], g[a][b]);
        }
      }
    }
    // publish the raw column k + 1 for the next pivot
    const int k1 = k + 1;
    if (k1 < n) {
      // (rows i < k + 1 of the column are never read: slots a < b stay out)
      if (tc == k1 % kGrid)
#pragma unroll
        for (int b = 0; b < kS; ++b)
          if (tc + kGrid * b == k1)
#pragma unroll
            for (int a = b; a < kS; ++a) lcol[p ^ 1][tr + kGrid * a] = g[a][b];
    }
    __syncthreads();
  }
}

// ---- the blocked factor's inputs (blocked_factor.cuh)

// The workers (warps 1..7): G's lower triangle, widened, into lp, the
// identity past n; block row 0 is left to factor_first, which warp 0 runs
// meanwhile.  A warp a row, its three column slots' loads issued
// together.
__device__ inline void stage_lower(const float* __restrict__ Gb, double* lp, int n, int np) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  for (int i = 7 + warp; i < np; i += kWarps - 1) {
    float v[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int c = lane + 32 * q;
      v[q] = i < n && c <= i ? Gb[i * n + c] : i == c ? 1.f : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int c = lane + 32 * q;
      if (c <= i) lp[packed_at(i, c)] = v[q];
    }
  }
}

// The lower triangle of P (chol_linv_tc's right factor), widened, into
// lp: zeros above the diagonal of the diagonal blocks (lower_product
// reads whole blocks), the identity past n.  A warp a row.
__device__ inline void stage_right(const float* __restrict__ Pb, double* lp, int n, int np) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  for (int i = warp; i < np; i += kWarps)
    for (int c = lane; c <= (i | 7); c += 32)
      lp[packed_at(i, c)] = i < n && c <= i ? Pb[i * n + c] : i == c ? 1.f : 0.f;
}

// Warp 0: diagonal block 0 of G (the identity past n) straight from
// device memory into diag_factor.
__device__ inline void factor_first(const float* Gb, double* lp, double* inv, int n, float tiny,
                                    float* dinv) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = 2 * (lane & 3);
  const float a0 = g < n && c < n ? Gb[g * n + c] : g == c ? 1.f : 0.f;
  const float a1 = g < n && c + 1 < n ? Gb[g * n + c + 1] : g == c + 1 ? 1.f : 0.f;
  diag_factor(a0, a1, lp, inv, 0, tiny, dinv);
}

// ---- the kernels

// ---- chol_factor

// Shared memory of chol_factor (bytes): L's packed triangle and the
// diagonal blocks' inverses (float64), dinv (np float32): 33,600 B a node
// at n = 73.
__host__ __device__ inline long long factor_bytes(int n) {
  const long long np = pad8(n), nb = np / 8;
  return 64LL * 8 * (tri_blocks((int)nb) + nb) + np * 4;
}

// G's triangle staged (warp 0 factoring diagonal block 0 meanwhile), then
// blocked_factor, panels of kFactorWidth, the next node's G asked of L2;
// L out rounded once, a warp a row, zeros above the diagonal.
__global__ void __launch_bounds__(kThreads, 4)
chol_factor_kernel(const float* __restrict__ G, float* __restrict__ L, int n, float tiny,
                   long long B, long long ahead) {
  extern __shared__ __align__(16) float smem[];
  const int np = pad8(n), nb = np / 8, warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  double* lp = reinterpret_cast<double*>(smem);
  double* dp = lp + 64 * tri_blocks(nb);
  float* dinv = reinterpret_cast<float*>(dp + 64 * nb);
  const long long node = blockIdx.x;
  const float* Gb = G + node * n * n;
  if (warp == 0) factor_first(Gb, lp, dp, n, tiny, dinv);
  else stage_lower(Gb, lp, n, np);
  __syncthreads();
  blocked_factor<kFactorWidth, false>(lp, nullptr, dp, nb, tiny, dinv,
                                      node + ahead < B ? Gb + ahead * n * n : nullptr,
                                      (long long)n * n * 4);
  float* ob = L + node * n * n;
  for (int i = warp; i < n; i += kWarps)
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int c = lane + 32 * q;
      if (c < n) ob[i * n + c] = c <= i ? (float)lp[packed_at(i, c)] : 0.f;
    }
}

// ---- chol_trsm_gram

// Shared memory of chol_trsm_gram (bytes): L's packed triangle (float64),
// later G2 (float32, np x (np + 1)); the diagonal blocks' inverses (nb x
// 64 float64); A, staged whole
// (m x n float32, 16-byte aligned), then X^T = A L^-T in its place; dinv
// (np float32).  72.1 KB a node at (132, 73), three blocks an SM.
__host__ __device__ inline long long trsm_region_bytes(int n) {
  const long long np = pad8(n), tri = 64LL * tri_blocks((int)np / 8) * 8;
  const long long g2 = np * (np + 1) * 4;
  return ((tri > g2 ? tri : g2) + 15) / 16 * 16;
}
__host__ __device__ inline long long trsm_bytes(int m, int n) {
  const long long np = pad8(n);
  return trsm_region_bytes(n) + np * 64 + (long long)m * n * 4 + np * 4;
}

// X^T = A L^-T in place over the staged A (xt: m x n), L packed in lp, the
// diagonal blocks' inverses in dp: a warp an 8-row tile of A at a time,
// its row block of X^T in registers as float64 C fragments of m8n8k4
// (kNB of them, the node's nb at most): block k is T = A[rows][k] -
// sum_{l < k} X[rows][l] L_kl^T (each X block's fragment is the A
// fragment of its product, two accumulator chains, even and odd l), then
// T Linv_kk^T, with no block barrier (row tiles are independent); the
// tile is rounded to float32 once, into its own rows of A.
// The warp's row tile lives in shared memory (``tile``, one int a warp)
// across the tile's body, whose X and products take every register a
// thread has at three blocks an SM.
template <int kNB>
__device__ void substitute(float* xt, const double* lp, const double* dp, int m, int n, int nb,
                           volatile int* tile) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if (lane == 0) tile[warp] = 8 * warp;
  __syncwarp();
  for (;;) {
    const int r0 = tile[warp];
    if (r0 >= m) break;
    const int r = r0 + g;
    float* row = xt + r * n;
    double x[kNB][2];
#pragma unroll
    for (int k = 0; k < kNB; ++k) {
      if (k >= nb) break;
      const int c = 8 * k + 2 * t;
      double p0 = r < m && c < n ? row[c] : 0.f, p1 = r < m && c + 1 < n ? row[c + 1] : 0.f;
      double q0 = 0.0, q1 = 0.0;
#pragma unroll
      for (int l = 0; l < k; ++l) {
        const double2 w = row_pair(lp + bo(k, l), g, 2 * t);   // L_kl[g][2t]
        if (l & 1) {
          mma_f64(q0, q1, x[l][0], -w.x);
          mma_f64(q0, q1, x[l][1], -w.y);
        } else {
          mma_f64(p0, p1, x[l][0], -w.x);
          mma_f64(p0, p1, x[l][1], -w.y);
        }
      }
      const double2 v = row_pair(dp + 64 * k, g, 2 * t);   // Linv_kk[g][2t]
      double y0 = 0.0, y1 = 0.0;
      mma_f64(y0, y1, p0 + q0, v.x);
      mma_f64(y0, y1, p1 + q1, v.y);
      x[k][0] = y0;
      x[k][1] = y1;
    }
    const int rw = tile[warp] + g;
    if (rw < m) {
#pragma unroll
      for (int k = 0; k < kNB; ++k) {
        if (k >= nb) break;
        const int c = 8 * k + 2 * t;
        if (c < n) xt[rw * n + c] = (float)x[k][0];
        if (c + 1 < n) xt[rw * n + c + 1] = (float)x[k][1];
      }
    }
    __syncwarp();
    if (lane == 0) tile[warp] += 8 * kWarps;
    __syncwarp();
  }
}

// G2 = X X^T, the Gram of the staged X^T (m x n float32), its lower
// triangle by blocks of 16 x 16 (bands bi >= bj of 16 columns of X^T, two
// 16 x 8 tiles each: two accumulator chains), a block a warp at a time, K
// = m in chunks of 8 rows (the mma's natural order: the fragments are
// columns of X^T, widened at the load); band bj's fragments are both B
// fragments of the block, (a0, a2) and (a1, a3).  Each block's tiles,
// rounded, into gs (np x (np + 1) float32, over L, which is read no more).
__device__ void gram_lower(const float* xt, float* gs, int m, int n, int np) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nband = (np + 15) / 16, gl = np + 1;
  for (int it = warp, b = 0, q = warp; it < nband * (nband + 1) / 2; it += kWarps, q += kWarps) {
    while (q > b) q -= ++b;   // it -> (b, q), q <= b, row by row
    const int i0 = 16 * b, j0 = 16 * q, ci = i0 + g, cj = j0 + g;
    const bool vi = ci < n, hi = ci + 8 < n, vj = cj < n, hj = cj + 8 < n;
    double c[2][4] = {{0.0, 0.0, 0.0, 0.0}, {0.0, 0.0, 0.0, 0.0}};
    for (int r0 = 0; r0 < m; r0 += 8) {
      const bool v0 = r0 + t < m, v4 = r0 + t + 4 < m;
      const float* x0 = xt + (r0 + t) * n;
      const float* x4 = x0 + 4 * n;
      const double a[4] = {v0 && vi ? x0[ci] : 0.f, v0 && hi ? x0[ci + 8] : 0.f,
                           v4 && vi ? x4[ci] : 0.f, v4 && hi ? x4[ci + 8] : 0.f};
      const double f[4] = {v0 && vj ? x0[cj] : 0.f, v0 && hj ? x0[cj + 8] : 0.f,
                           v4 && vj ? x4[cj] : 0.f, v4 && hj ? x4[cj + 8] : 0.f};
      const double b0[2] = {f[0], f[2]}, b1[2] = {f[1], f[3]};
      mma16(c[0], a, b0);
      mma16(c[1], a, b1);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (j0 + 8 * h >= np) break;
      float* o = gs + ci * gl + j0 + 8 * h + 2 * t;
      o[0] = (float)c[h][0];
      o[1] = (float)c[h][1];
      if (i0 + 8 < np) {
        o[8 * gl] = (float)c[h][2];
        o[8 * gl + 1] = (float)c[h][3];
      }
    }
  }
}

// L of G (kW = 0 the elimination in registers, then L into lp and the
// inverses of its 8 x 8 diagonal blocks, a thread a column; else
// blocked_factor with panels of kW), while A arrives by one cp.async.bulk
// (element copies where a node's A is not a 16-byte multiple: ``bulk``
// 0); then substitute's X^T in place over A, as the last warp asks L2 for
// the inputs of the node ``ahead`` on (kW > 0: the elimination's
// registers leave no room for the pointers); then gram_lower's G2,
// written out whole in coalesced rows, its upper triangle mirrored.
template <int kW, int kNB>
__global__ void __launch_bounds__(kThreads, 3)
chol_trsm_gram_kernel(const float* __restrict__ A, const float* __restrict__ G,
                      float* __restrict__ out, int m, int n, float tiny, int bulk,
                      long long B, long long ahead) {
  constexpr int kS = kNB <= 6 ? 3 : 5;   // the elimination's register grid
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t bar[1];
  __shared__ int tile[kWarps];   // substitute's row tiles
  const int t = threadIdx.x, warp = t / 32, lane = t & 31;
  const int np = pad8(n), nb = np / 8;
  const long long region = trsm_region_bytes(n);
  double* lp = reinterpret_cast<double*>(smem);              // L, then X^T's slabs
  double* dp = reinterpret_cast<double*>(reinterpret_cast<char*>(smem) + region);
  float* xt = reinterpret_cast<float*>(dp + 64 * nb);        // A, then X^T
  float* dinv = xt + m * n;
  const long long node = blockIdx.x;
  const float* Ab = A + node * m * n;
  const float* Gb = G + node * n * n;
  if (bulk) {
    if (t == 0) {
      mbar_init(bar, 1);
      bulk_load(xt, Ab, (unsigned)(m * n * sizeof(float)), bar);
    }
  } else {
    for (int i = t; i < m * n; i += kThreads) __pipeline_memcpy_async(xt + i, Ab + i, sizeof(float));
    __pipeline_commit();
  }
  if constexpr (kW > 0) {
    if (warp == 0) factor_first(Gb, lp, dp, n, tiny, dinv);
    else stage_lower(Gb, lp, n, np);
    __syncthreads();
    blocked_factor<kW, false>(lp, nullptr, dp, nb, tiny, dinv);
  } else {
    __shared__ float lcol[2][kGrid * kS];
    float g[kS][kS];
    load_lower<kS>(Gb, n, g);
    eliminate<kS>(g, n, tiny, lcol, dinv);
    const int tr = t / kGrid, tc = t % kGrid;
#pragma unroll
    for (int a = 0; a < kS; ++a)
#pragma unroll
      for (int b = 0; b < kS; ++b) {
        const int i = tr + kGrid * a, c = tc + kGrid * b;
        if (i < np && c <= i)
          lp[packed_at(i, c)] =
              i >= n ? (i == c ? 1.f : 0.f) : c < i ? g[a][b] * dinv[c] : 1.f / dinv[c];
      }
    for (int i = n + t; i < np; i += kThreads) dinv[i] = 1.f;
    __syncthreads();
    // the inverse of each 8 x 8 diagonal block of L, a thread a column
    for (int w = t; w < np; w += kThreads) {
      const int k = w >> 3, c = w & 7;
      const double* lk = lp + bo(k, k);
      double y[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        double acc = 0.0;   // y[j] = 0 for j < c
#pragma unroll
        for (int j = 0; j < r; ++j) acc = fma(lk[r * 8 + j], y[j], acc);
        const double d = dinv[8 * k + r];
        y[r] = r < c ? 0.0 : r == c ? d : -acc * d;
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) dp[64 * k + r * 8 + c] = y[r];
    }
    __syncthreads();
  }
  if (kW > 0 && warp == kWarps - 1 && node + ahead < B) {
    prefetch_l2(Ab + ahead * m * n, (long long)m * n * 4);
    prefetch_l2(Gb + ahead * n * n, (long long)n * n * 4);
  }
  if (bulk) mbar_wait(bar, 0);
  else __pipeline_wait_prior(0);
  __syncthreads();   // (the element copies: every thread's)
  substitute<kNB>(xt, lp, dp, m, n, nb, tile);
  __syncthreads();   // L read no more: G2 over it
  gram_lower(xt, reinterpret_cast<float*>(smem), m, n, np);
  __syncthreads();
  const int gl = np + 1;
  const float* gs = reinterpret_cast<const float*>(smem);
  float* ob = out + node * n * n;
  for (int i = warp; i < n; i += kWarps)
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int c = lane + 32 * q;
      if (c < n) ob[i * n + c] = c <= i ? gs[i * gl + c] : gs[c * gl + i];
    }
}

// ---- chol_linv_tc

// Shared memory of chol_linv_tc (bytes): L's and L^-1's packed triangles
// (float64) and dinv (np float32): 56,640 B a node at n = 73, four blocks
// an SM.
__host__ __device__ inline long long linv_tc_bytes(int n) {
  const long long np = pad8(n);
  return 2 * 64LL * tri_blocks((int)np / 8) * 8 + np * 4;
}

// blocked_factor with L^-1's block rows, then L^-1 out in rows, rounded,
// zeros above the diagonal; with kRight, L^-1 P instead (chol2 of the
// route, Lc = L2^-1 L1^-1): P's lower triangle staged over L, which is read
// no more, then lower_product's blocks straight to device memory.
template <int kW, bool kRight>
__global__ void __launch_bounds__(kThreads, 4)
chol_linv_tc_kernel(const float* __restrict__ G, const float* __restrict__ P,
                    float* __restrict__ out, int n, float tiny, long long B, long long ahead) {
  extern __shared__ __align__(16) float smem[];
  const int np = pad8(n), nb = np / 8, warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  double* lp = reinterpret_cast<double*>(smem);
  double* ip = lp + 64 * tri_blocks(nb);
  float* dinv = reinterpret_cast<float*>(ip + 64 * tri_blocks(nb));
  const long long node = blockIdx.x;
  const float* Gb = G + node * n * n;
  if (warp == 0) factor_first(Gb, lp, ip, n, tiny, dinv);
  else stage_lower(Gb, lp, n, np);
  __syncthreads();
  blocked_factor<kW, true>(lp, ip, nullptr, nb, tiny, dinv,
                           node + ahead < B ? Gb + ahead * n * n : nullptr, (long long)n * n * 4);
  float* ob = out + node * n * n;
  if constexpr (kRight) {
    stage_right(P + node * n * n, lp, n, np);
    __syncthreads();
    lower_product(ip, lp, ob, n, n, nb);
  }
  for (int i = warp; i < n; i += kWarps)
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int c = lane + 32 * q;
      if (kRight) {
        if (c > i && c < n) ob[i * n + c] = 0.f;
      } else if (c < n) {
        ob[i * n + c] = c <= i ? (float)ip[packed_at(i, c)] : 0.f;
      }
    }
}

// ---- chol_trisolve_apply

// Shared memory of chol_trisolve_apply (bytes): L's and Li's packed
// triangles (Li's region first holds the raw span of the node's Li, which
// fits: at most 4 n^2 + 28 bytes against the triangle's 4 np (np + 8)),
// the diagonal blocks' inverses (float64), x, y and v (np float64 each)
// and dinv (np float32): 63,680 B a node at n = 73, three blocks an SM.
__host__ __device__ inline long long trisolve_bytes(int n) {
  const long long np = pad8(n), nb = np / 8;
  return 64LL * 8 * (2 * tri_blocks((int)nb) + nb) + np * (3 * 8 + 4);
}

// The entries of a packed triangle of nb <= 10 block rows a thread holds
// while repack moves it.
constexpr int kPackSlots = (64 * 55 + kThreads - 1) / kThreads;

// Entry s of this thread in a packed triangle's order: its index p, row r
// and column c.
struct Entry {
  int p, r, c;
};
__device__ __forceinline__ Entry packed_entry(int s) {
  const int p = threadIdx.x + kThreads * s, b = p >> 6;   // block b = I (I + 1) / 2 + J
  int i = (int)((sqrtf(8.f * b + 1.f) - 1.f) * 0.5f);
  i += (i + 1) * (i + 2) / 2 <= b;
  return {p, 8 * i + ((p >> 3) & 7), 8 * (b - i * (i + 1) / 2) + (p & 7)};
}

// A change of layout in place: every entry of a packed triangle of nb
// block rows through ``get(Entry)`` into registers (a warp 32 consecutive
// ones), a block barrier, then through ``put(Entry, value)``.  Ends with a
// barrier.
template <typename Get, typename Put>
__device__ void repack(int nb, Get get, Put put) {
  const int count = 64 * tri_blocks(nb);
  float e[kPackSlots];
#pragma unroll
  for (int s = 0; s < kPackSlots; ++s) {
    const Entry x = packed_entry(s);
    e[s] = x.p < count ? get(x) : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kPackSlots; ++s) {
    const Entry x = packed_entry(s);
    if (x.p < count) put(x, e[s]);
  }
  __syncthreads();
}

// ---- the applies (chol_trisolve_apply)
//
// A warp's vector block of 8 in the "rows" layout: lane 4 g + t holds
// entry g, in full (in every lane of that g) or as a partial that its 4
// lanes sum to (sum_t).  Its products with an 8 x 8 block read the block
// by row pairs (row_pair: X[g][2t], X[g][2t + 1]) or by column pairs
// (col_pair: X[2t][g], X[2t + 1][g]) against the vector's own pair
// (pair_at: entries 2t and 2t + 1, one double2 of shared memory).

__device__ __forceinline__ double2 pair_at(const double* x, int k) {
  return *reinterpret_cast<const double2*>(x + 8 * k + 2 * (threadIdx.x & 3));
}
__device__ __forceinline__ double2 col_pair(const double* X) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  return double2{X[16 * t + g], X[16 * t + 8 + g]};
}
__device__ __forceinline__ double2 row_of(const double* X) {
  const int lane = threadIdx.x & 31;
  return row_pair(X, lane >> 2, 2 * (lane & 3));
}
// The sum over the 4 lanes of a g, in each of them.
__device__ __forceinline__ double sum_t(double x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}
// The sum over the 8 lanes of a t, in each of them.
__device__ __forceinline__ double sum_g(double x) {
  x += __shfl_xor_sync(kFull, x, 4);
  x += __shfl_xor_sync(kFull, x, 8);
  return x + __shfl_xor_sync(kFull, x, 16);
}

// v = Li^T y by the owners of Li's block columns (warp w: w and w + 8):
// partials of entries 2t, 2t + 1 over g, row pairs of Li against y's entry
// g, summed over g; a lane of g = 0 stores a pair.
__device__ __forceinline__ void li_transpose_times(const double* li, const double* ys, double* vs,
                                                   int nb) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int J = warp + kWarps * q;
    if (J >= nb) continue;
    double p0 = 0.0, p1 = 0.0;
    const double* col = li + J * 64 + g * 8 + 2 * t;   // + bo(I, 0) for block (I, J)
#pragma unroll 2
    for (int I = J; I < nb; ++I) {
      const double2 l = *reinterpret_cast<const double2*>(col + bo(I, 0));
      const double y = ys[8 * I + g];
      p0 = fma(l.x, y, p0);
      p1 = fma(l.y, y, p1);
    }
    p0 = sum_g(p0);
    p1 = sum_g(p1);
    if (g == 0) *reinterpret_cast<double2*>(vs + 8 * J + 2 * t) = double2{p0, p1};
  }
}

// c += s X w in full on the FP64 tensor cores, one m16n8k8 with no
// shuffle: X (this lane's pair x of it) in the upper (``hi`` false) or the
// lower half of A, w's pair as every column of B, so entry g lands in the
// lanes of g: c[0] (= c[1]) from the upper half, c[2] (= c[3]) from the
// lower, the other half of c unchanged.
__device__ __forceinline__ void mma_times(double (&c)[4], double2 x, double2 w, double s, bool hi) {
  const double a[4] = {hi ? 0.0 : s * x.x, hi ? s * x.x : 0.0, hi ? 0.0 : s * x.y,
                       hi ? s * x.y : 0.0};
  const double b[2] = {w.x, w.y};
  mma16(c, a, b);
}

// c += the sum of p over the 4 lanes of each g, by one m16n8k8 (p as A's
// first 4 columns, in its upper or, ``hi``, lower half; ones as B's first
// 4 rows): entry g in the lanes of g, as mma_times leaves it (two shuffle
// levels of a double take longer on an H100).
__device__ __forceinline__ void sum_into(double (&c)[4], double p, bool hi) {
  const double a[4] = {hi ? 0.0 : p, hi ? p : 0.0, 0.0, 0.0}, b[2] = {1.0, 0.0};
  mma16(c, a, b);
}

// X_Ik <- Linv_II X_Ik over each block (I, k) of a packed triangle below
// the diagonal (``diag``: and on it), in place, a warp a block, one
// m16n8k8 each; no barrier.  On the factor (L = diag(L_II) W', W' unit
// block lower triangular with W below) the solves' steps need no
// diagonal product: W' x = Linv u, W'^T z = x, y = Linv^T z.  On Li (Li'
// = diag(Linv_II) Li) u = Linv Li v = Li' v and Li^T y = Li'^T z: the
// applies' products become updates of the same partials, and y is never
// formed.
__device__ void scale_rows(double* X, const double* dp, int nb, bool diag) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int d = diag ? 1 : 0;   // row I holds I + d blocks
  for (int it = warp, I = 1 - d, k = warp; it < tri_blocks(nb) - nb * (1 - d);
       it += kWarps, k += kWarps) {
    while (k >= I + d) k -= I++ + d;   // it -> (I, k), row by row
    double* blk = X + bo(I, k);
    const double2 w = row_pair(dp + 64 * I, g, 2 * t), l = col_pair(blk);
    const double a[4] = {w.x, 0.0, w.y, 0.0}, b[2] = {l.x, l.y};
    double c[4] = {0.0, 0.0, 0.0, 0.0};
    mma16(c, a, b);   // D[g][2t] = (Linv_II X_Ik)[g][2t]
    store_pair(blk, g, 2 * t, c[0], c[1]);
  }
}

// One apply, v <- Li^T L^-T L^-1 Li v, by blocks of 8 on all 8 warps, on
// scale_rows' W and Li': warp w owns block rows (and columns) w and w + 8,
// half q of its C fragment ``full`` and its partials ``part[q]`` (x, z)
// and ``po[q]`` (v), all in the rows layout.  Forward W' x = u, u = Li'
// v: at step k, after one block barrier, every warp with rows past k
// subtracts W_ik x_k from them, by two FMAs a lane into the partial (and
// adds a block of Li' v: row i's blocks 0, 1 and i before the steps, k +
// 2 at step k), and the owner of row k + 1 by one m16n8k8 into the full
// value, which is then x_{k+1}, stored (the partial was summed into it at
// the step before): a step is a barrier, a load, one product and a store
// on its critical path.  Backward W'^T z = x alike (W_kj^T by column
// pairs) from each owner's x, each published z_k also added into v =
// Li'^T z by the owners of block columns j <= k.  2 nb - 1 block barriers;
// starts after one (v complete) and ends with one.  (Flags on mbarriers
// in place of the steps' barriers, so that only the next owner waits,
// timed the same on the card.)
__device__ void apply_blocked(const double* lp, const double* li, double* xs, double* ys,
                              double* vs, int nb) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rp = g * 8 + 2 * t, cp = 16 * t + g;   // a lane's row pair, column pair in a block
  const int I0 = warp, I1 = warp + kWarps;          // the owned block rows (columns)
  double full[4] = {0.0, 0.0, 0.0, 0.0}, part[2] = {0.0, 0.0}, po[2] = {0.0, 0.0};
  const double* wrow[2] = {lp + bo(I0, 0) + rp, lp + bo(I1, 0) + rp};
  const double* lrow[2] = {li + bo(I0, 0) + rp, li + bo(I1, 0) + rp};
  auto li_v = [&](int q, int J) {   // part[q] += Li'_IJ v_J
    const double2 l = *reinterpret_cast<const double2*>(lrow[q] + 64 * J), w = pair_at(vs, J);
    part[q] = fma(l.x, w.x, fma(l.y, w.y, part[q]));
  };
  auto fold = [&](int q) {   // part[q] summed into the full value
    sum_into(full, part[q], q);
    part[q] = 0.0;
  };
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int I = q ? I1 : I0;
    if (I >= nb) continue;
    li_v(q, 0);
    if (I >= 1) li_v(q, 1);
    if (I >= 2) li_v(q, I);
    if (I <= 1) fold(q);   // rows 0 and 1: full before their first product
  }
  if (warp == 0 && t == 0) xs[g] = full[0];
  for (int k = 0; k + 1 < nb; ++k) {
    __syncthreads();
    if (I0 <= k && (I1 <= k || I1 >= nb)) continue;   // no row of this warp left
    const double2 xk = pair_at(xs, k);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int I = q ? I1 : I0;
      if (I <= k || I >= nb) continue;
      const double2 l = *reinterpret_cast<const double2*>(wrow[q] + 64 * k);
      if (I == k + 1) {
        mma_times(full, l, xk, -1.0, q);
        if (t == 0) xs[8 * I + g] = full[2 * q];
      } else {
        part[q] = fma(-l.x, xk.x, fma(-l.y, xk.y, part[q]));
        if (I >= k + 3) li_v(q, k + 2);
        else fold(q);   // row I = k + 2 is next
      }
    }
  }
  // backward: z_{nb-1} = x_{nb-1}, from its owner's full value
#pragma unroll
  for (int q = 0; q < 2; ++q)
    if ((q ? I1 : I0) == nb - 1 && t == 0) ys[8 * (nb - 1) + g] = full[2 * q];
  for (int k = nb - 1; k > 0; --k) {
    __syncthreads();
    if (I0 > k) continue;   // no column of this warp left (I1 > I0)
    const double2 zk = pair_at(ys, k);
    const double* wblk = lp + bo(k, 0) + cp;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int J = q ? I1 : I0;
      if (J >= k) continue;
      const double2 l = {wblk[64 * J], wblk[64 * J + 8]};
      if (J == k - 1) {
        mma_times(full, l, zk, -1.0, q);
        if (t == 0) ys[8 * J + g] = full[2 * q];
      } else {
        part[q] = fma(-l.x, zk.x, fma(-l.y, zk.y, part[q]));
        if (J == k - 2) fold(q);
      }
    }
    const double* lblk = li + bo(k, 0) + cp;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int J = q ? I1 : I0;
      if (J > k) continue;
      po[q] = fma(lblk[64 * J], zk.x, fma(lblk[64 * J + 8], zk.y, po[q]));
    }
  }
  if (warp == 0) {   // z_0, its own
    __syncwarp();
    const double2 z0 = pair_at(ys, 0);
    po[0] = fma(li[cp], z0.x, fma(li[cp + 8], z0.y, po[0]));
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int J = q ? I1 : I0;
    if (J >= nb) continue;
    double c[4] = {0.0, 0.0, 0.0, 0.0};
    sum_into(c, po[q], false);
    if (t == 0) vs[8 * J + g] = c[0];
  }
  __syncthreads();
}

// x[s] for a slot s known only at run time, from registers
template <int kL>
__device__ __forceinline__ float pick(const float (&x)[kL], int s) {
  float r = x[0];
#pragma unroll
  for (int q = 1; q < kL; ++q)
    if (s == q) r = x[q];
  return r;
}

// One warp: y = L^-T L^-1 u by the TPU probe's column sweeps in float32
// (the port's earlier warp_solves<1, kL>), lane l holding rows l + 32 q
// (n <= 96): at pivot k the value x_k = r_k dinv_k by one shuffle, then
// every later row (earlier, backward) takes its share.  L's strictly
// lower triangle ls at the odd row stride ld (a column's 32 rows in
// distinct banks).  y past n is 0.
__device__ void column_sweeps(const float* ls, int ld, const float* dinv, const double* u,
                              double* y, int n, int np) {
  constexpr int kL = 3;
  const int lane = threadIdx.x & 31;
  float x[kL];
#pragma unroll
  for (int q = 0; q < kL; ++q) x[q] = lane + 32 * q < n ? (float)u[lane + 32 * q] : 0.f;
  for (int k = 0; k < n; ++k) {
    const float xk = __shfl_sync(kFull, pick(x, k >> 5), k & 31) * dinv[k];
#pragma unroll
    for (int q = 0; q < kL; ++q) {
      const int i = lane + 32 * q;
      if (i >= k + 1 && i < n) x[q] = fmaf(-ls[i * ld + k], xk, x[q]);
      else if (i == k) x[q] = xk;
    }
  }
  for (int k = n - 1; k >= 0; --k) {
    const float yk = __shfl_sync(kFull, pick(x, k >> 5), k & 31) * dinv[k];
#pragma unroll
    for (int q = 0; q < kL; ++q) {
      const int i = lane + 32 * q;
      if (i < k) x[q] = fmaf(-ls[k * ld + i], yk, x[q]);
      else if (i == k) x[q] = yk;
    }
  }
#pragma unroll
  for (int q = 0; q < kL; ++q)
    if (lane + 32 * q < np) y[lane + 32 * q] = lane + 32 * q < n ? x[q] : 0.f;
}

// One apply with the column sweeps (kB = 1): u = Li v by the 8 warps (a
// warp a block row) into xs, the sweeps on warp 0 into ys, Li^T y by the 8
// warps (a warp a block column) into v: 3 block barriers; starts after
// one and ends with one.
__device__ void apply_sweeps(const float* ls, int ld, const double* li, const float* dinv,
                             double* xs, double* ys, double* vs, int n, int nb) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int I = warp + kWarps * q;
    if (I >= nb) continue;
    double p = 0.0;
    for (int J = 0; J <= I; ++J) {
      const double2 l = row_of(li + bo(I, J)), w = pair_at(vs, J);
      p = fma(l.x, w.x, fma(l.y, w.y, p));
    }
    p = sum_t(p);
    if (t == 0) xs[8 * I + g] = p;
  }
  __syncthreads();
  if (warp == 0) column_sweeps(ls, ld, dinv, xs, ys, n, 8 * nb);
  __syncthreads();
  li_transpose_times(li, ys, vs, nb);
  __syncthreads();
}

// G's triangle staged and factored as chol_factor's (the next node's G
// asked of L2) while Li's span arrives by one bulk copy and v by plain
// loads; Li widened into its packed triangle over its span (repack); with
// kB = 1, L's strictly lower triangle rounded into a float32 square at an
// odd stride over its packed one (the sweeps read columns, which the 8 x 8
// blocks would put in two banks); then the applies (apply_blocked, kB =
// 8; apply_sweeps, kB = 1); v out, rounded once.
template <int kB>
__global__ void __launch_bounds__(kThreads, 3)
chol_trisolve_apply_kernel(const float* __restrict__ G, const float* __restrict__ Li,
                           const float* __restrict__ v, float* __restrict__ out, int n,
                           int applies, float tiny, long long B, long long ahead) {
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t bar[1];
  const int t = threadIdx.x, warp = t / 32;
  const int np = pad8(n), nb = np / 8, tri = 64 * tri_blocks(nb);
  double* lp = reinterpret_cast<double*>(smem);   // L
  double* li = lp + tri;                          // Li's raw span, then Li
  double* dp = li + tri;                          // the diagonal blocks' inverses
  double* xs = dp + 64 * nb;
  double* ys = xs + np;
  double* vs = ys + np;
  float* dinv = reinterpret_cast<float*>(vs + np);
  const long long node = blockIdx.x;
  const float* Gb = G + node * n * n;
  const float* Lb = Li + node * n * n;
  if (t == 0) mbar_init(bar, 1);
  load_span(reinterpret_cast<float*>(li), Lb, (long long)n * n, bar);
  for (int j = t; j < np; j += kThreads) vs[j] = j < n ? v[node * n + j] : 0.0;
  if (warp == 0) factor_first(Gb, lp, dp, n, tiny, dinv);
  else stage_lower(Gb, lp, n, np);
  __syncthreads();
  blocked_factor<kFactorWidth, false>(lp, nullptr, dp, nb, tiny, dinv,
                                      node + ahead < B ? Gb + ahead * n * n : nullptr,
                                      (long long)n * n * 4);
  mbar_wait(bar, 0);
  if constexpr (kB == 8) scale_rows(lp, dp, nb, false);   // (no barrier: Li's repack has one first)
  const float* lraw = reinterpret_cast<const float*>(li) + span_head(Lb);
  repack(nb, [=](Entry x) { return x.r < n && x.c <= x.r ? lraw[x.r * n + x.c] : 0.f; },
         [=](Entry x, float e) { li[x.p] = e; });
  if constexpr (kB == 8) {
    scale_rows(li, dp, nb, true);
    __syncthreads();
  }
  const int ld = n | 1;
  float* ls = reinterpret_cast<float*>(lp);   // kB = 1: L's strictly lower triangle, float32
  if constexpr (kB == 1)
    repack(nb, [=](Entry x) { return (float)lp[x.p]; },
           [=](Entry x, float e) {
             if (x.c < x.r && x.r < n) ls[x.r * ld + x.c] = e;
           });
  for (int rep = 0; rep < applies; ++rep) {
    if constexpr (kB == 8) apply_blocked(lp, li, xs, ys, vs, nb);
    else apply_sweeps(ls, ld, li, dinv, xs, ys, vs, n, nb);
  }
  for (int j = t; j < n; j += kThreads) out[node * n + j] = (float)vs[j];
}

// ---- host side

using FactorKernel = void (*)(const float*, float*, int, float, long long, long long);
using TrsmKernel = void (*)(const float*, const float*, float*, int, int, float, int, long long,
                           long long);
using LinvTcKernel = void (*)(const float*, const float*, float*, int, float, long long,
                             long long);
using TrisolveKernel = void (*)(const float*, const float*, const float*, float*, int, int,
                                float, long long, long long);

// The probes, by their ids in factor_probes_occupancy (4: chol_linv_tc
// with a right factor)
enum Probe { kFactor = 0, kTrsm = 1, kLinvTc = 2, kTrisolve = 3, kLinvTcRight = 4 };

FactorKernel factor_kernel(int n) { return n <= 10 * 8 ? chol_factor_kernel : nullptr; }

// width 0: the elimination's factor; 8, 16 or 32: blocked_factor's
// panels; by the 8-column blocks that X^T's registers hold, 6 (n <= 48)
// or 10 (n <= 80)
template <int kNB>
TrsmKernel trsm_kernel_nb(int width) {
  switch (width) {
    case 0: return chol_trsm_gram_kernel<0, kNB>;
    case 8: return chol_trsm_gram_kernel<8, kNB>;
    case 16: return chol_trsm_gram_kernel<16, kNB>;
    case 32: return chol_trsm_gram_kernel<32, kNB>;
    default: return nullptr;
  }
}

TrsmKernel trsm_kernel(int n, int width) {
  if (n <= 6 * 8) return trsm_kernel_nb<6>(width);
  if (n <= 10 * 8) return trsm_kernel_nb<10>(width);
  return nullptr;
}

template <bool kRight>
LinvTcKernel linv_tc_kernel_of(int width) {
  switch (width) {
    case 8: return chol_linv_tc_kernel<8, kRight>;
    case 16: return chol_linv_tc_kernel<16, kRight>;
    case 32: return chol_linv_tc_kernel<32, kRight>;
    case 48: return chol_linv_tc_kernel<48, kRight>;
    default: return nullptr;
  }
}

// by the panel width, with or without the right factor
LinvTcKernel linv_tc_kernel(int n, int width, bool right) {
  if (n > 10 * 8) return nullptr;
  return right ? linv_tc_kernel_of<true>(width) : linv_tc_kernel_of<false>(width);
}

// block 1: the column sweeps on one warp; 8: blocks of 8 rows on all 8
TrisolveKernel trisolve_kernel(int n, int block) {
  if (n > 10 * 8) return nullptr;
  return block == 1 ? chol_trisolve_apply_kernel<1>
                    : block == 8 ? chol_trisolve_apply_kernel<8> : nullptr;
}

struct Launch {
  const void* kernel;
  long long bytes;   // dynamic shared memory
};

Launch launch_of(int probe, int m, int n, int width) {
  switch (probe) {
    case kFactor: return {(const void*)factor_kernel(n), factor_bytes(n)};
    case kTrsm: return {(const void*)trsm_kernel(n, width), trsm_bytes(m, n)};
    case kLinvTc:
    case kLinvTcRight:
      return {(const void*)linv_tc_kernel(n, width, probe == kLinvTcRight), linv_tc_bytes(n)};
    case kTrisolve:
      return {(const void*)trisolve_kernel(n, width), trisolve_bytes(n)};
    default: return {nullptr, 0};
  }
}

// The launch's dynamic shared memory, the larger of its need and
// ``request`` (bytes: to run at another kernel's occupancy), set on its
// kernel; an error where there is no instance for the shape or the node
// does not fit.
cudaError_t prepare(const Launch& l, long long request, size_t* bytes) {
  if (l.kernel == nullptr || request < 0) return cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *bytes = (size_t)(l.bytes > request ? l.bytes : request);
  if (*bytes > (size_t)optin) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(l.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*bytes);
}

// The blocks of a launch resident at once on the current card (SMs x
// blocks an SM): how many nodes on a block prefetches.
long long resident(const Launch& l, size_t bytes) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, l.kernel, kThreads, bytes);
  return (long long)sms * (per_sm > 0 ? per_sm : 1);
}

}  // namespace

// A probe's launch (0 chol_factor, 1 chol_trsm_gram, 2 chol_linv_tc, 3
// chol_trisolve_apply, 4 chol_linv_tc with a right factor) at (m, n), width (chol_trsm_gram: 0 the
// elimination, else the panel width; chol_linv_tc: the panel width;
// chol_trisolve_apply: the solves' block of rows, 1 or 8), at a dynamic
// shared memory request of ``request`` bytes (the larger of it and the
// launch's need is taken): its dynamic shared memory, threads, the blocks
// an SM holds, and its registers and local memory bytes (spills) a
// thread; returns the cudaError_t.
extern "C" int factor_probes_occupancy(int probe, int m, int n, int width, long long request,
                                       long long* smem_bytes, int* threads, int* blocks_per_sm,
                                       int* regs, long long* local_bytes) {
  const Launch l = launch_of(probe, m, n, width);
  size_t bytes = 0;
  cudaError_t err = prepare(l, request, &bytes);
  if (err != cudaSuccess) return (int)err;
  *smem_bytes = (long long)bytes;
  *threads = kThreads;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, l.kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (long long)attr.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, l.kernel, kThreads,
                                                            bytes);
}

// L (lower triangular, 1 / dinv on the diagonal, zeros above) of G; dynamic
// shared memory of at least ``request`` bytes.
extern "C" int chol_factor_launch(const float* G, float* L, int B, int n, float tiny,
                                  long long request, void* stream) {
  if (B <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const Launch l = launch_of(kFactor, 0, n, 0);
  size_t bytes = 0;
  cudaError_t err = prepare(l, request, &bytes);
  if (err != cudaSuccess) return (int)err;
  const FactorKernel k = factor_kernel(n);
  k<<<B, kThreads, bytes, (cudaStream_t)stream>>>(G, L, n, tiny, (long long)B, resident(l, bytes));
  return (int)cudaGetLastError();
}

// G2 = X X^T, X = L^-1 A^T, G = L L^T; width 0 the elimination's
// factor, 8, 16 or 32 blocked_factor's; dynamic shared memory of at least
// ``request`` bytes.  A node's A comes in by one bulk copy where every
// node's A is 16-byte aligned and a multiple of 16 bytes, else by element
// copies.
extern "C" int chol_trsm_gram_launch(const float* A, const float* G, float* out, int B, int m,
                                     int n, int width, float tiny, long long request,
                                     void* stream) {
  if (B <= 0 || m <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const Launch l = launch_of(kTrsm, m, n, width);
  size_t bytes = 0;
  cudaError_t err = prepare(l, request, &bytes);
  if (err != cudaSuccess) return (int)err;
  const TrsmKernel k = trsm_kernel(n, width);
  const int bulk = (long long)m * n % 4 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0;
  k<<<B, kThreads, bytes, (cudaStream_t)stream>>>(A, G, out, m, n, tiny, bulk, (long long)B,
                                                  resident(l, bytes));
  return (int)cudaGetLastError();
}

// L^-1 of G, or L^-1 P where P is given (read as lower triangular), lower
// triangular with zeros above; panels of `width` on DMMA; dynamic shared
// memory of at least ``request`` bytes.
extern "C" int chol_linv_tc_launch(const float* G, const float* P, float* out, int B, int n,
                                   int width, float tiny, long long request, void* stream) {
  if (B <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const Launch l = launch_of(P ? kLinvTcRight : kLinvTc, 0, n, width);
  size_t bytes = 0;
  cudaError_t err = prepare(l, request, &bytes);
  if (err != cudaSuccess) return (int)err;
  const LinvTcKernel k = linv_tc_kernel(n, width, P != nullptr);
  k<<<B, kThreads, bytes, (cudaStream_t)stream>>>(G, P, out, n, tiny, (long long)B,
                                                  resident(l, bytes));
  return (int)cudaGetLastError();
}

// `applies` times v <- Li^T L^-T L^-1 Li v, G = L L^T, the solves by
// blocks of `block` rows (1: the column sweeps, or 8); Li read as lower
// triangular (its upper triangle is ignored); dynamic shared memory of at
// least ``request`` bytes.
extern "C" int chol_trisolve_apply_launch(const float* G, const float* Li, const float* v,
                                          float* out, int B, int n, int applies, int block,
                                          float tiny, long long request, void* stream) {
  if (B <= 0 || n <= 0 || applies < 0) return (int)cudaErrorInvalidValue;
  const Launch l = launch_of(kTrisolve, 0, n, block);
  size_t bytes = 0;
  cudaError_t err = prepare(l, request, &bytes);
  if (err != cudaSuccess) return (int)err;
  const TrisolveKernel k = trisolve_kernel(n, block);
  k<<<B, kThreads, bytes, (cudaStream_t)stream>>>(G, Li, v, out, n, applies, tiny, (long long)B,
                                                  resident(l, bytes));
  return (int)cudaGetLastError();
}
