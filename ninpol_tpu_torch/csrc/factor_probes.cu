/*
 * Kernel 1's factorization probes for NVIDIA Hopper (sm_90a): design
 * alternatives for the two factorizations of the fused solve
 * (gls_solve.cu), which take 61% of its time on the tet interior class.
 * They are the counterparts of the TPU probes in the repo's tools/
 * (trsm_probe.py, chol_mxu_probe.py, trisolve_probe.py), timed by
 * ninpol_tpu_torch/tools/factor_probes.py on the route's own float32
 * inputs beside kernel 1's stage cuts.  No route runs them: this library
 * is built apart from the production ones, at the first probe launch.
 * ninpol_tpu_torch/ops/factor_probes.py holds the contracts, the wrappers
 * and the plain PyTorch versions.  One block a node throughout.
 *
 * chol_factor_kernel replaces tools/trisolve_probe.py:79 (the Cholesky
 *   panels alone): L and dinv = rsqrt(max(pivot, tiny)) of G, no inverse;
 *   the baseline that the other probes' verdicts subtract.  The lower
 *   triangle of G in registers, 5 x 5 entries a thread on a 16 x 16 grid
 *   (chol_linv_reg_kernel's layout in cholqr.cu, without its inverse), one
 *   barrier a pivot.  Bound by memory on the card (G's triangle read, L
 *   written: 32.1 KB a node at n = 73 for 0.13 MFLOP), held back by the n
 *   dependent pivots.
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
 *   prec_apply_f32 applies with Lc explicit).  The factor as
 *   chol_factor_kernel's, while Li's triangle and v arrive by
 *   asynchronous copies; the matrix-vector products by the block; each
 *   triangular solve by one warp, lanes over the rows (warp_solves).
 *   Template kB: 1, the TPU probe's column sweep, one shuffle a pivot, a
 *   dependence chain n long, which the TPU probe found bound by latency;
 *   8, the same sweep by blocks of 8 rows, each block's values at once
 *   from its inverted diagonal block (computed after the factor), so the
 *   chain is n / 8 block steps long.
 *
 * Every launch function returns a cudaError_t as int (0 on success).
 */
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "blocked_factor.cuh"

namespace {

using namespace blocked_factor_device;

constexpr int kGrid = 16;                 // the register grid: kGrid x kGrid threads
constexpr int kThreads = kGrid * kGrid, kWarps = kThreads / 32;
static_assert(kThreads == kFactorThreads, "blocked_factor runs on the probes' blocks");
constexpr unsigned kSpinLimit = 1u << 22;   // tries of an mbarrier wait before __trap

// ---- the elimination in registers (chol_factor, chol_trsm_gram with kW =
// 0, chol_trisolve_apply)
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

template <int kS>
__global__ void __launch_bounds__(kThreads, 3)
chol_factor_kernel(const float* __restrict__ G, float* __restrict__ L, int n, float tiny) {
  __shared__ float lcol[2][kGrid * kS], dinv[kGrid * kS];
  const long long node = blockIdx.x;
  float g[kS][kS];
  load_lower<kS>(G + node * n * n, n, g);
  eliminate<kS>(g, n, tiny, lcol, dinv);
  const int tr = threadIdx.x / kGrid, tc = threadIdx.x % kGrid;
  float* Lb = L + node * n * n;
#pragma unroll
  for (int a = 0; a < kS; ++a)
#pragma unroll
    for (int b = 0; b < kS; ++b) {
      const int i = tr + kGrid * a, c = tc + kGrid * b;
      if (i < n && c < n)
        Lb[i * n + c] = c < i ? g[a][b] * dinv[c] : c == i ? 1.f / dinv[c] : 0.f;
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

// The mbarrier of chol_trsm_gram's copy of A, and the copy.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
#ifdef CUDA_EMU
  return 0;
#else
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
#endif
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
#ifdef CUDA_EMU
  emu_mbarrier_init(bar, count);
#else
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
#endif
}

// One thread: expect ``bytes`` on ``bar`` (its one arrival) and copy them
// from device memory to shared memory (both 16-byte aligned, bytes a
// multiple of 16) by cp.async.bulk, completing on ``bar``.  The fence
// orders the block's earlier accesses of dst (generic proxy) before the
// copy's writes (async proxy).
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
#ifdef CUDA_EMU
  emu_mbarrier_arrive_expect_tx(bar, bytes);
  emu_cp_async_bulk(dst, src, bytes, bar);
#else
  const uint32_t b = smem_addr(bar);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(b)
      : "memory");
#endif
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, unsigned parity) {
#ifdef CUDA_EMU
  return emu_mbarrier_try_wait_parity(bar, parity);
#else
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
#endif
}

// Wait for the phase of ``bar`` with this parity to complete; trap after
// kSpinLimit tries, so a wrong parity ends the launch with an error
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  for (unsigned tries = 0; !mbar_try_wait(bar, parity); ++tries)
    if (tries == kSpinLimit) __trap();
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

// Shared memory of chol_trisolve_apply: L's strictly lower triangle (n x
// (n | 1): an odd stride, so lanes reading one column down 32 rows fall
// in distinct banks), Li's lower triangle packed by rows, v and u, and
// the inverses of L's kB x kB diagonal blocks.
__host__ __device__ inline long long trisolve_floats(int n, int kb) {
  const long long blocks = (n + kb - 1) / kb;
  return (long long)n * (n | 1) + (long long)n * (n + 1) / 2 + 2LL * n + blocks * kb * kb;
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

// The warp's two triangular solves, x <- L^-T L^-1 x, x in the lanes'
// registers (lane l holds rows l + 32 q): block by block of kB rows, each
// block's values from its inverted diagonal block dblk (kB^2 floats a
// block, lower triangular) applied to the block's current entries, which
// every lane gathers by kB shuffles; then every later row (earlier, in
// the backward solve) takes the block's share at once.  kB = 1 is the
// column sweep, one shuffle a pivot (the TPU probe's form); kB = 8 cuts
// the dependence chain to n / 8 block steps, at the price of the
// diagonal blocks' inverses.
template <int kB, int kL>
__device__ __forceinline__ void warp_solves(float (&xs)[kL], const float* ls, int ld,
                                            const float* dblk, int n) {
  const int lane = threadIdx.x % 32;
  for (int b0 = 0; b0 < n; b0 += kB) {
    const float* d = dblk + (b0 / kB) * kB * kB;
    float t[kB], xb[kB];
#pragma unroll
    for (int c = 0; c < kB; ++c) t[c] = __shfl_sync(0xffffffffu, pick(xs, b0 >> 5), (b0 + c) & 31);
#pragma unroll
    for (int r = 0; r < kB; ++r) {
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c <= r; ++c) acc = fmaf(d[r * kB + c], t[c], acc);
      xb[r] = acc;
    }
#pragma unroll
    for (int q = 0; q < kL; ++q) {
      const int i = lane + 32 * q;
      if (i >= b0 + kB && i < n) {
#pragma unroll
        for (int c = 0; c < kB; ++c) xs[q] = fmaf(-ls[i * ld + b0 + c], xb[c], xs[q]);
      } else if (i >= b0) {
#pragma unroll
        for (int r = 0; r < kB; ++r)
          if (i == b0 + r) xs[q] = xb[r];
      }
    }
  }
  for (int b0 = (n - 1) / kB * kB; b0 >= 0; b0 -= kB) {
    const float* d = dblk + (b0 / kB) * kB * kB;
    float t[kB], yb[kB];
#pragma unroll
    for (int c = 0; c < kB; ++c) t[c] = __shfl_sync(0xffffffffu, pick(xs, b0 >> 5), (b0 + c) & 31);
#pragma unroll
    for (int r = 0; r < kB; ++r) {   // the block's inverse, transposed
      float acc = 0.f;
#pragma unroll
      for (int c = r; c < kB; ++c) acc = fmaf(d[c * kB + r], t[c], acc);
      yb[r] = acc;
    }
#pragma unroll
    for (int q = 0; q < kL; ++q) {
      const int i = lane + 32 * q;
      if (i < b0) {
#pragma unroll
        for (int c = 0; c < kB; ++c)
          if (b0 + c < n) xs[q] = fmaf(-ls[(b0 + c) * ld + i], yb[c], xs[q]);
      } else if (i < b0 + kB) {
#pragma unroll
        for (int r = 0; r < kB; ++r)
          if (i == b0 + r) xs[q] = yb[r];
      }
    }
  }
}

template <int kS, int kL, int kB>
__global__ void __launch_bounds__(kThreads, 2)
chol_trisolve_apply_kernel(const float* __restrict__ G, const float* __restrict__ Li,
                           const float* __restrict__ v, float* __restrict__ out, int n,
                           int applies, float tiny) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float lcol[2][kGrid * kS], dinv[kGrid * kS];
  const int t = threadIdx.x, tr = t / kGrid, tc = t % kGrid;
  const int warp = t / 32, lane = t % 32, ld = n | 1;
  float* ls = smem;                 // L, strictly lower
  float* tri = ls + n * ld;         // Li, packed: row i from i (i + 1) / 2
  float* vs = tri + n * (n + 1) / 2;
  float* us = vs + n;
  float* dblk = us + n;             // the diagonal blocks' inverses
  const long long node = blockIdx.x;
  // Li's triangle and v arrive while G is factored
  {
    const float* Lb = Li + node * n * n;
    const int count = n * (n + 1) / 2;
    int i = 0, j = t;   // packed entry p = t
    while (j > i) j -= ++i;
    for (int p = t; p < count; p += blockDim.x) {
      __pipeline_memcpy_async(tri + p, Lb + i * n + j, sizeof(float));
      j += blockDim.x;
      while (j > i) j -= ++i;
    }
  }
  for (int j = t; j < n; j += blockDim.x)
    __pipeline_memcpy_async(vs + j, v + node * n + j, sizeof(float));
  __pipeline_commit();
  float g[kS][kS];
  load_lower<kS>(G + node * n * n, n, g);
  eliminate<kS>(g, n, tiny, lcol, dinv);
#pragma unroll
  for (int a = 0; a < kS; ++a)
#pragma unroll
    for (int b = 0; b < a + 1; ++b) {
      const int i = tr + kGrid * a, c = tc + kGrid * b;
      if (i < n && c < i) ls[i * ld + c] = g[a][b] * dinv[c];
    }
  __syncthreads();
  // the inverse of each diagonal block, a thread a column: L's diagonal is
  // 1 / dinv, rows past n the identity
  for (int w = t; w < (n + kB - 1) / kB * kB; w += blockDim.x) {
    const int b0 = w / kB * kB, c = w % kB;
    float y[kB];
#pragma unroll
    for (int r = 0; r < kB; ++r) {
      float acc = 0.f;   // y[j] = 0 for j < c
      if (b0 + r < n)
#pragma unroll
        for (int j = 0; j < r; ++j) acc = fmaf(ls[(b0 + r) * ld + b0 + j], y[j], acc);
      y[r] = r < c ? 0.f : b0 + r >= n ? (r == c ? 1.f : 0.f)
                   : r == c ? dinv[b0 + r] : -acc * dinv[b0 + r];
    }
#pragma unroll
    for (int r = 0; r < kB; ++r) dblk[b0 * kB + r * kB + c] = y[r];
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  for (int rep = 0; rep < applies; ++rep) {
    // u = Li v: a warp a row, a shuffle reduction
    for (int i = warp; i < n; i += blockDim.x / 32) {
      const float* row = tri + i * (i + 1) / 2;
      float acc = 0.f;
      for (int j = lane; j <= i; j += 32) acc = fmaf(row[j], vs[j], acc);
      for (int off = 16; off > 0; off /= 2) acc += __shfl_down_sync(0xffffffffu, acc, off);
      if (lane == 0) us[i] = acc;
    }
    __syncthreads();
    if (warp == 0) {
      float xs[kL];
#pragma unroll
      for (int q = 0; q < kL; ++q) xs[q] = lane + 32 * q < n ? us[lane + 32 * q] : 0.f;
      warp_solves<kB, kL>(xs, ls, ld, dblk, n);
#pragma unroll
      for (int q = 0; q < kL; ++q)
        if (lane + 32 * q < n) us[lane + 32 * q] = xs[q];
    }
    __syncthreads();
    // v = Li^T y: a thread a column, consecutive entries of each row
    for (int j = t; j < n; j += blockDim.x) {
      float acc = 0.f;
      for (int i = j; i < n; ++i) acc = fmaf(tri[i * (i + 1) / 2 + j], us[i], acc);
      vs[j] = acc;
    }
    __syncthreads();
  }
  for (int j = t; j < n; j += blockDim.x) out[node * n + j] = vs[j];
}

// ---- host side

using FactorKernel = void (*)(const float*, float*, int, float);
using TrsmKernel = void (*)(const float*, const float*, float*, int, int, float, int, long long,
                           long long);
using LinvTcKernel = void (*)(const float*, const float*, float*, int, float, long long,
                             long long);
using TrisolveKernel = void (*)(const float*, const float*, const float*, float*, int, int,
                                float);

// The probes, by their ids in factor_probes_occupancy (4: chol_linv_tc
// with a right factor)
enum Probe { kFactor = 0, kTrsm = 1, kLinvTc = 2, kTrisolve = 3, kLinvTcRight = 4 };

FactorKernel factor_kernel(int n) {
  if (n <= 3 * kGrid) return chol_factor_kernel<3>;
  if (n <= 5 * kGrid) return chol_factor_kernel<5>;
  return nullptr;
}

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

// block 1: the column sweep; 8: blocks of 8 rows, their diagonal
// blocks inverted
TrisolveKernel trisolve_kernel(int n, int block) {
  if (block != 1 && block != 8) return nullptr;
  if (n <= 3 * kGrid)
    return block == 1 ? chol_trisolve_apply_kernel<3, 2, 1> : chol_trisolve_apply_kernel<3, 2, 8>;
  if (n <= 5 * kGrid)
    return block == 1 ? chol_trisolve_apply_kernel<5, 3, 1> : chol_trisolve_apply_kernel<5, 3, 8>;
  return nullptr;
}

struct Launch {
  const void* kernel;
  long long bytes;   // dynamic shared memory
};

Launch launch_of(int probe, int m, int n, int width) {
  switch (probe) {
    case kFactor: return {(const void*)factor_kernel(n), 0};
    case kTrsm: return {(const void*)trsm_kernel(n, width), trsm_bytes(m, n)};
    case kLinvTc:
    case kLinvTcRight:
      return {(const void*)linv_tc_kernel(n, width, probe == kLinvTcRight), linv_tc_bytes(n)};
    case kTrisolve:
      return {(const void*)trisolve_kernel(n, width), trisolve_floats(n, width) * 4};
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

// L (lower triangular, 1 / dinv on the diagonal, zeros above) of G.
extern "C" int chol_factor_launch(const float* G, float* L, int B, int n, float tiny,
                                  void* stream) {
  if (B <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const FactorKernel k = factor_kernel(n);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  k<<<B, kThreads, 0, (cudaStream_t)stream>>>(G, L, n, tiny);
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
// blocks of `block` rows (1 or 8); Li read as lower triangular (its upper
// triangle is not read).
extern "C" int chol_trisolve_apply_launch(const float* G, const float* Li, const float* v,
                                          float* out, int B, int n, int applies, int block,
                                          float tiny, void* stream) {
  if (B <= 0 || n <= 0 || applies < 0) return (int)cudaErrorInvalidValue;
  const Launch l = launch_of(kTrisolve, 0, n, block);
  size_t bytes = 0;
  cudaError_t err = prepare(l, 0, &bytes);
  if (err != cudaSuccess) return (int)err;
  const TrisolveKernel k = trisolve_kernel(n, block);
  k<<<B, kThreads, bytes, (cudaStream_t)stream>>>(G, Li, v, out, n, applies, tiny);
  return (int)cudaGetLastError();
}
