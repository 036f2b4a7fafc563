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
 *   chain over the block rows already done.  Bound by memory (G's triangle
 *   read, L^-1 written); held by the lead warp's pivot chain, the block
 *   rows' products and its input and output, which all blocks of a
 *   launch meet at once.
 *
 * The blocked factor (chol_linv_tc, chol_trsm_gram's variant C) keeps L,
 *   the part still to factor and L^-1 in float64 as packed triangles of
 *   8 x 8 blocks, so no product converts an operand; it goes 8 columns a
 *   step, right-looking by panels of kW, with two block barriers a step
 *   (20 a node at n = 73; 23 in all for chol_trsm_gram): warp 0 factors
 *   each diagonal block by shuffles, with its inverse, a step ahead of
 *   the other seven warps, which form the panel against that inverse,
 *   update the rest on m16n8k8 and wait for the lead on a named
 *   barrier.  n is
 *   padded to a multiple of 8 with the identity on the padded diagonal.
 *   The products run on FP64 DMMA (float32 inputs widened once, so each
 *   product is exact and the sums are float64, rounded once to float32):
 *   single-pass TF32 keeps ~3 digits, the preconditioner needs
 *   Gram-quality products, and DMMA's fragments need no hi/lo split.
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

namespace {

constexpr int kGrid = 16;                 // the register grid: kGrid x kGrid threads
constexpr int kThreads = kGrid * kGrid, kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kSpinLimit = 1u << 22;   // tries of an mbarrier wait before __trap

__host__ __device__ inline int pad8(int n) { return (n + 7) / 8 * 8; }

// D = A B + D for one 8 x 8 x 4 tile on the FP64 tensor cores, the warp's
// fragments of mma.sync.m8n8k4.row.col.f64: lane 4 g + t holds a = A[g][t],
// b = B[t][g], c0 = D[g][2t] and c1 = D[g][2t + 1].
__device__ __forceinline__ void mma_f64(double& c0, double& c1, double a, double b) {
#ifdef CUDA_EMU
  emu_mma_m8n8k4_f64(c0, c1, a, b);
#else
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};"
               : "+d"(c0), "+d"(c1)
               : "d"(a), "d"(b));
#endif
}

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

// ---- the blocked factor on the tensor cores (chol_linv_tc, chol_trsm_gram
// with kW > 0)
//
// L (and S, the part still to factor), L^-1 and the diagonal blocks'
// inverses are float64 in shared memory, as packed lower triangles of 8 x
// 8 blocks (bo: block (i, j), j <= i, row-major), so no product converts
// an operand: G is widened once where it is staged, the result rounded
// once where it leaves.  np = pad8(n), nb = np / 8 blocks; at np = 80 a
// triangle takes 28,160 B, what a float32 square took.  The products are
// m16n8k8 (16 x 8 tiles: two blocks of a column) and m8n8k4 on FP64 DMMA.
// A product's K = 8 columns of a block row are taken in a permuted order,
// the mma's k = t on column 2t and k = t + 4 on 2t + 1, so that a lane's
// two operands of a row are one double2 and a C fragment (D[g][2t],
// D[g][2t + 1], D[g + 8][2t], D[g + 8][2t + 1]) is already the A fragment
// of a product over its own columns, (c0, c2, c1, c3): a result feeds the
// next product from registers.

__host__ __device__ inline int tri_blocks(int nb) { return nb * (nb + 1) / 2; }
__device__ __forceinline__ int bo(int i, int j) { return (i * (i + 1) / 2 + j) * 64; }

// D = A B + D for one 16 x 8 x 8 tile on the FP64 tensor cores (sm_90's
// shape): lane 4 g + t holds a = (A[g][t], A[g + 8][t], A[g][t + 4], A[g +
// 8][t + 4]), b = (B[t][g], B[t + 4][g]), c = (D[g][2t], D[g][2t + 1],
// D[g + 8][2t], D[g + 8][2t + 1]).
__device__ __forceinline__ void mma16(double (&c)[4], const double (&a)[4], const double (&b)[2]) {
#ifdef CUDA_EMU
  emu_mma_m16n8k8_f64(c, a, b);
#else
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
#endif
}

// Named barrier ``id`` of ``count`` threads: bar.sync waits for the
// count, bar.arrive adds its warp without waiting (a producer's release:
// its earlier shared memory writes are seen by the threads that wait).
__device__ __forceinline__ void named_sync(int id, int count) {
#ifdef CUDA_EMU
  emu_named_barrier(id, count, true);
#else
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
#endif
}
__device__ __forceinline__ void named_arrive(int id, int count) {
#ifdef CUDA_EMU
  emu_named_barrier(id, count, false);
#else
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
#endif
}

// A block's row r, columns c and c + 1 (c even), and their store.
__device__ __forceinline__ double2 row_pair(const double* blk, int r, int c) {
  return *reinterpret_cast<const double2*>(blk + r * 8 + c);
}
__device__ __forceinline__ void store_pair(double* blk, int r, int c, double x, double y) {
  double2 v;
  v.x = x;
  v.y = y;
  *reinterpret_cast<double2*>(blk + r * 8 + c) = v;
}

// One warp: the 128-byte lines of [p, p + bytes) into L2
// (prefetch.global.L2).  The blocks of a launch run in step, so their
// input and output phases meet at device memory's rate while no product
// runs; a block that asks, while device memory is idle, for the input of
// the node that the next block on its SM slot will take (``ahead``
// nodes on: the launch's resident blocks) lets that block's loads find
// L2.
__device__ __forceinline__ void prefetch_l2(const void* p, long long bytes) {
#ifndef CUDA_EMU
  const char* c = static_cast<const char*>(p);
  const long long first = (long long)(reinterpret_cast<uintptr_t>(c) & 127);
  for (long long off = 128LL * (threadIdx.x & 31); off < first + bytes; off += 32 * 128)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(c - first + off));
#endif
}

// One warp: the clamped Cholesky factor of diagonal block k, given as this
// lane's entries a0 = S[g][2t], a1 = S[g][2t + 1] of the block (lane 4 g
// + t; entries above the diagonal are not read), by 8 pivots of float32
// shuffles, with no block barrier; the block's inverse by the same row
// operations on the identity (M = L_unit^-1, L^-1 = diag(dinv) M).
// Writes L's block into lp (below the diagonal and 1 / dinv on it),
// dinv[8k..8k + 7], and the inverse (zeros above the diagonal) into inv.
__device__ void diag_factor(float a0, float a1, double* lp, double* inv, int k, float tiny,
                            float* dinv) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, j0 = 2 * t, j1 = j0 + 1;
  float m0 = g == j0 ? 1.f : 0.f, m1 = g == j1 ? 1.f : 0.f;
  float d0 = 1.f, d1 = 1.f, dg = 1.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int q = c >> 1;
    const float v = (c & 1) ? a1 : a0;   // S[g][c] where t == q
    const float piv = __shfl_sync(kFull, v, 4 * c + q);
    const float lg = __shfl_sync(kFull, v, 4 * g + q);
    const float l0 = __shfl_sync(kFull, v, 4 * j0 + q);
    const float l1 = __shfl_sync(kFull, v, 4 * j1 + q);
    const float mc0 = __shfl_sync(kFull, m0, 4 * c + t);   // M[c][j0], final
    const float mc1 = __shfl_sync(kFull, m1, 4 * c + t);
    const float d = rsqrtf(fmaxf(piv, tiny));
    if (g == c) dg = d;
    if (j0 == c) d0 = d;
    if (j1 == c) d1 = d;
    if (g > c) {
      const float lgd = lg * d;   // L[g][c]
      if (j0 > c && j0 <= g) a0 = fmaf(-lgd, l0 * d, a0);
      if (j1 > c && j1 <= g) a1 = fmaf(-lgd, l1 * d, a1);
      const float u = lgd * d;   // L_unit[g][c]
      m0 = fmaf(-u, mc0, m0);
      m1 = fmaf(-u, mc1, m1);
    }
  }
  double* row = lp + bo(k, k) + g * 8;
  if (j0 < g) row[j0] = a0 * d0;
  else if (j0 == g) row[j0] = 1.f / d0;
  if (j1 < g) row[j1] = a1 * d1;
  else if (j1 == g) row[j1] = 1.f / d1;
  store_pair(inv, g, j0, dg * m0, dg * m1);
  if (g == 0) {
    dinv[8 * k + j0] = d0;
    dinv[8 * k + j1] = d1;
  }
}

// One item of an update: S -= L[rows][K] L[cols][K]^T for block rows ib
// and ib + 1 (the second where ib + 1 < nb) against block column jb and,
// where nt == 2, jb + 1 (jb <= ib + 1), K the block columns [l0, l1):
// one m16n8k8 a tile and K block, the A fragment loaded once for both
// tiles, one accumulator chain a tile, started from S.  A tile's upper
// block (jb > ib) is outside the triangle: neither read nor stored; with
// ``lead``, neither is the first tile's upper block (the next diagonal
// block, which the lead warp updates itself).
template <bool kUnroll>
__device__ void update_item(double* lp, int nb, int ib, int jb, int nt, int l0, int l1,
                            bool lead) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool lo = ib + 1 < nb;
  const double2 zero = {0.0, 0.0};
  double c[2][4];
#pragma unroll
  for (int q = 0; q < 2; ++q)
    if (q < nt) {
      const int j = jb + q;
      const double2 u = j <= ib && !(lead && q == 0) ? row_pair(lp + bo(ib, j), g, 2 * t) : zero;
      const double2 v = lo ? row_pair(lp + bo(ib + 1, j), g, 2 * t) : zero;
      c[q][0] = u.x;
      c[q][1] = u.y;
      c[q][2] = v.x;
      c[q][3] = v.y;
    }
  auto product = [&](int l) {
    const double2 u = row_pair(lp + bo(ib, l), g, 2 * t);
    const double2 v = lo ? row_pair(lp + bo(ib + 1, l), g, 2 * t) : zero;
    const double a[4] = {-u.x, -v.x, -u.y, -v.y};
#pragma unroll
    for (int q = 0; q < 2; ++q)
      if (q < nt) {
        const double2 w = row_pair(lp + bo(jb + q, l), g, 2 * t);
        const double b[2] = {w.x, w.y};
        mma16(c[q], a, b);
      }
  };
  if constexpr (kUnroll) {
    for (int l = l0; l < l1; ++l) product(l);
  } else {
#pragma unroll 1   // a K of several blocks: no loads in flight across blocks (registers)
    for (int l = l0; l < l1; ++l) product(l);
  }
#pragma unroll
  for (int q = 0; q < 2; ++q)
    if (q < nt) {
      const int j = jb + q;
      if (j <= ib && !(lead && q == 0)) store_pair(lp + bo(ib, j), g, 2 * t, c[q][0], c[q][1]);
      if (lo) store_pair(lp + bo(ib + 1, j), g, 2 * t, c[q][2], c[q][3]);
    }
}

// The lead warp's step k (warp 0): L's block (k + 1, k) = S's times
// Linv_kk^T (two m8n8k4), published to the workers by named barrier 1;
// then diagonal block k + 1 updated by L's blocks (k + 1, l), l in [l0,
// k] (block k from registers; two accumulator chains), and factored
// (diag_factor) into lp, inv1 and dinv.
__device__ void lead_step(double* lp, int k, const double* inv, int l0, double* inv1,
                          float tiny, float* dinv) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, k1 = k + 1;
  double* pk = lp + bo(k1, k);
  const double2 u = row_pair(pk, g, 2 * t), w = row_pair(inv, g, 2 * t);
  double x0 = 0.0, x1 = 0.0;
  mma_f64(x0, x1, u.x, w.x);
  mma_f64(x0, x1, u.y, w.y);
  store_pair(pk, g, 2 * t, x0, x1);
  named_arrive(1, kThreads);
  const double2 s = row_pair(lp + bo(k1, k1), g, 2 * t);
  double d0 = s.x, d1 = s.y, e0 = 0.0, e1 = 0.0;
  mma_f64(d0, d1, -x0, x0);
  mma_f64(d0, d1, -x1, x1);
#pragma unroll 1
  for (int l = l0; l < k; ++l) {
    const double2 y = row_pair(lp + bo(k1, l), g, 2 * t);
    mma_f64(e0, e1, -y.x, y.x);
    mma_f64(e0, e1, -y.y, y.y);
  }
  diag_factor((float)(d0 + e0), (float)(d1 + e1), lp, inv1, k1, tiny, dinv);
}

// One panel tile: L's blocks (ib, k) and (ib + 1, k) (the second below
// nb) = S's times Linv_kk^T (inv), one m16n8k8.
__device__ void panel_tile(double* lp, int nb, int ib, int k, const double* inv) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool lo = ib + 1 < nb;
  double* top = lp + bo(ib, k);
  double* bot = lo ? lp + bo(ib + 1, k) : top;
  const double2 u = row_pair(top, g, 2 * t);
  const double2 v = lo ? row_pair(bot, g, 2 * t) : double2{0.0, 0.0};
  const double2 w = row_pair(inv, g, 2 * t);
  const double a[4] = {u.x, v.x, u.y, v.y}, b[2] = {w.x, w.y};
  double c[4] = {0.0, 0.0, 0.0, 0.0};
  mma16(c, a, b);
  store_pair(top, g, 2 * t, c[0], c[1]);
  if (lo) store_pair(bot, g, 2 * t, c[2], c[3]);
}

// One tile of L^-1's block row k (chol_linv_tc, ip packed as lp): its
// blocks (k, jb) and (k, jb + 1) (the second where jb + 1 < k), Linv_kj =
// -Linv_kk sum_{l = j}^{k - 1} L_kl Linv_lj, computed transposed so that
// it reads L by rows: T^T = sum_l Linv_lj^T L_kl^T (the mma's natural K
// order, two accumulator chains), then -T^T Linv_kk^T from T^T's
// registers.  Linv_lj is 0 for l < j: block jb + 1's first K block is
// zero operands.
__device__ void inverse_tile(const double* lp, double* ip, int jb, int k) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  double e[2][4] = {{0.0, 0.0, 0.0, 0.0}, {0.0, 0.0, 0.0, 0.0}};
  int q = 0;
#pragma unroll 1
  for (int l = jb; l < k; ++l, q ^= 1) {
    const bool hi = l > jb;
    const double* a0 = ip + bo(l, jb) + t * 8 + g;
    const double* a1 = ip + bo(l, hi ? jb + 1 : jb) + t * 8 + g;
    const double a[4] = {a0[0], hi ? a1[0] : 0.0, a0[32], hi ? a1[32] : 0.0};
    const double* lk = lp + bo(k, l) + g * 8 + t;
    const double b[2] = {lk[0], lk[4]};
    if (q) mma16(e[1], a, b);
    else mma16(e[0], a, b);
  }
  const double a[4] = {-(e[0][0] + e[1][0]), -(e[0][2] + e[1][2]), -(e[0][1] + e[1][1]),
                       -(e[0][3] + e[1][3])};
  const double2 w = row_pair(ip + bo(k, k), g, 2 * t);
  const double b[2] = {w.x, w.y};
  double c[4] = {0.0, 0.0, 0.0, 0.0};
  mma16(c, a, b);   // Linv^T[8 jb + g][8 k + 2t], ...
  double* out = ip + bo(k, jb) + 2 * t * 8 + g;
  out[0] = c[0];
  out[8] = c[1];
  if (jb + 1 < k) {
    out[64] = c[2];
    out[72] = c[3];
  }
}

// The clamped Cholesky factor of lp (the lower triangle of G on entry,
// the identity past n; diagonal block 0 already factored by diag_factor
// and a barrier passed), right-looking by 8-column steps, panels of kW.
// Warp 0 leads (lead_step): at step k it forms L's block (k + 1, k),
// updates diagonal block k + 1 and factors it, one step ahead of the other
// seven warps, the workers, which at step k form L's blocks below it (one
// m16n8k8 a 16-row tile against Linv_kk; with kInv also L^-1's block row
// k, inverse_tile, into ip), wait on named barrier 1 (the workers' tiles
// and the lead's block), then update the panel's later columns by block
// column k (K = 8), or at the panel's last step every later column by the
// whole panel (K = its width), the next diagonal block left to the lead.
// One block barrier ends the step: two barriers a step, and the lead's
// pivot chain runs beside the workers' products.  Diagonal block k's
// inverse is ip's (kInv) or dp's block k.  At step 1 the last worker
// asks L2 for ``next_g`` (prefetch_l2), when given.  On exit lp holds L
// (1 / dinv on the diagonal), dinv[i] = d_i, and with kInv ip holds L^-1.
template <int kW, bool kInv>
__device__ void blocked_factor(double* lp, double* ip, double* dp, int nb, float tiny,
                               float* dinv, const float* next_g = nullptr, long long next_bytes = 0) {
  constexpr int kPB = kW / 8;   // blocks a panel
  constexpr int kWorkers = kWarps - 1;
  const int warp = threadIdx.x / 32;
  for (int k = 0; k < nb; ++k) {
    const int k1 = k + 1;
    const double* inv = kInv ? ip + bo(k, k) : dp + 64 * k;
    const int p0 = k / kPB * kPB, pe = min(p0 + kPB, nb);
    const bool in_panel = k1 < pe;   // else k1 == pe
    const int l0 = in_panel ? k : p0;
    if (warp == 0) {
      if (k1 < nb)
        lead_step(lp, k, inv, l0, kInv ? ip + bo(k1, k1) : dp + 64 * k1, tiny, dinv);
    } else {
      if (k == 1 && warp == kWarps - 1 && next_g != nullptr) prefetch_l2(next_g, next_bytes);
      const int ninv = kInv ? k1 / 2 : 0, npt = (nb - k1) / 2;
      for (int it = warp - 1; it < ninv + npt; it += kWorkers) {
        if (it < ninv) inverse_tile(lp, ip, 2 * it, k);
        else panel_tile(lp, nb, k1 + 1 + 2 * (it - ninv), k, inv);
      }
      if (k1 < nb) {
        named_sync(1, kThreads);
        const int ncol = (in_panel ? pe : nb) - k1, gc = (ncol + 1) / 2;
        const int nband = (nb - k1 + 1) / 2;
        int items = 0;
        for (int b = 0; b < nband; ++b) items += min(gc, b + 1);
        // item it: band b (block rows k1 + 2b, + 1), block columns k1 + 2q
        // and the next where it reaches the band's triangle
        for (int it = warp - 1; it < items; it += kWorkers) {
          int b = 0, q = it;
          while (q >= min(gc, b + 1)) q -= min(gc, b + 1), ++b;
          const int nt = min(2, min(ncol, 2 * b + 2) - 2 * q);
          update_item<kW == 8>(lp, nb, k1 + 2 * b, k1 + 2 * q, nt, l0, k1, it == 0);
        }
      }
    }
    __syncthreads();
  }
}

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
      if (c <= i) lp[bo(i >> 3, c >> 3) + (i & 7) * 8 + (c & 7)] = v[q];
    }
  }
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
          lp[bo(i >> 3, c >> 3) + (i & 7) * 8 + (c & 7)] =
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
// zeros above the diagonal.
template <int kW>
__global__ void __launch_bounds__(kThreads, 4)
chol_linv_tc_kernel(const float* __restrict__ G, float* __restrict__ out, int n, float tiny,
                    long long B, long long ahead) {
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
  for (int i = warp; i < n; i += kWarps)
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int c = lane + 32 * q;
      if (c < n) ob[i * n + c] = c <= i ? (float)ip[bo(i >> 3, c >> 3) + (i & 7) * 8 + (c & 7)] : 0.f;
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
using LinvTcKernel = void (*)(const float*, float*, int, float, long long, long long);
using TrisolveKernel = void (*)(const float*, const float*, const float*, float*, int, int,
                                float);

// The probes, by their ids in factor_probes_occupancy
enum Probe { kFactor = 0, kTrsm = 1, kLinvTc = 2, kTrisolve = 3 };

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

LinvTcKernel linv_tc_kernel(int n, int width) {
  if (n > 10 * 8) return nullptr;
  switch (width) {
    case 8: return chol_linv_tc_kernel<8>;
    case 16: return chol_linv_tc_kernel<16>;
    case 32: return chol_linv_tc_kernel<32>;
    case 48: return chol_linv_tc_kernel<48>;
    default: return nullptr;
  }
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
    case kLinvTc: return {(const void*)linv_tc_kernel(n, width), linv_tc_bytes(n)};
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
// chol_trisolve_apply) at (m, n), width (chol_trsm_gram: 0 the
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

// L^-1 of G (lower triangular, zeros above), panels of `width` on DMMA;
// dynamic shared memory of at least ``request`` bytes.
extern "C" int chol_linv_tc_launch(const float* G, float* out, int B, int n, int width,
                                   float tiny, long long request, void* stream) {
  if (B <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const Launch l = launch_of(kLinvTc, 0, n, width);
  size_t bytes = 0;
  cudaError_t err = prepare(l, request, &bytes);
  if (err != cudaSuccess) return (int)err;
  const LinvTcKernel k = linv_tc_kernel(n, width);
  k<<<B, kThreads, bytes, (cudaStream_t)stream>>>(G, out, n, tiny, (long long)B,
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
