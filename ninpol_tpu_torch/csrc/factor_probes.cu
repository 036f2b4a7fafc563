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
 *   = 0, variant B) or by tc_factor's panels (kW = 8, 16, 32, variant
 *   C), then X by row blocks of 8 and X X^T as products on FP64 DMMA,
 *   the substitution without a block barrier.  Bound by FP32 operations
 *   (1.55 MFLOP for 71 KB a node at (132, 73)), held back by the pivot
 *   chain.
 *
 * chol_linv_tc_kernel replaces tools/chol_mxu_probe.py:73: the clamped
 *   Cholesky factor and L^-1 by left-looking panels of width kW (template:
 *   8, 16, 32, 48, the probe's super-panel widths), each panel's update
 *   by all earlier panels one product on the tensor cores, the rest on
 *   the CUDA cores: the factor's panel eliminated column by column (one
 *   barrier a column), then L^-1 by row panels, earlier row panels folded
 *   in by one product, the panel's own rows solved row by row.  n is
 *   padded to a multiple of 8 with the identity on the padded diagonal.
 *   The products run on FP64 DMMA (mma.sync m8n8k4, float32 operands
 *   widened, so each product is exact and the sums are float64, rounded
 *   once to float32): single-pass TF32 keeps ~3 digits, the
 *   preconditioner needs Gram-quality products, and DMMA's one-register
 *   fragments need no hi/lo split (3xTF32 needs three MMAs and the
 *   splits).  Shared memory holds G / L and L^-1 at a row stride of an
 *   odd multiple of 4 floats, so a fragment's eight rows fall in distinct
 *   banks: 53.8 KB a node at n = 73, four blocks an SM.
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

namespace {

constexpr int kGrid = 16;                 // the register grid: kGrid x kGrid threads
constexpr int kThreads = kGrid * kGrid;

__host__ __device__ inline int pad8(int n) { return (n + 7) / 8 * 8; }
// The row stride of the tensor-core kernels' matrices, np a multiple of
// 8: np + 4, an odd multiple of 4 floats, so the eight rows of a DMMA
// fragment (row g, column t < 4) fall in 32 distinct banks.
__host__ __device__ inline int tc_ld(int np) { return np + 4; }

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

// ---- the tensor-core factor (chol_linv_tc, chol_trsm_gram with kW > 0)
//
// s: np x np at row stride ld (tc_ld), np a multiple of 8, the lower
// triangle of G on entry with the identity past n.  Left-looking panels
// of width kW (the last may be narrower; all multiples of 8): the panel's
// columns, rows k0.., first take the product of every earlier panel,
// s[i][j] -= sum_{l < k0} L[i][l] L[j][l], one 8 x 8 tile a warp on DMMA
// (tiles above the diagonal skipped); then the panel is eliminated column
// by column on the CUDA cores, one barrier a column, each step updating
// only the panel's later columns; then its columns are scaled.  On exit s
// holds L (lower triangle, 1 / d on the diagonal; the upper triangle is
// garbage) and dinv[k] = d_k.  Ends with a barrier.
template <int kW>
__device__ void tc_factor(float* s, int ld, int np, float tiny, float* dinv) {
  constexpr int kRows = kThreads / kW;   // row slices of a panel's column
  const int t = threadIdx.x, warp = t / 32, lane = t % 32, warps = kThreads / 32;
  const int gq = lane >> 2, tq = lane & 3, jj = t % kW, rr = t / kW;
  for (int k0 = 0; k0 < np; k0 += kW) {
    const int w = min(kW, np - k0);
    if (k0 > 0) {
      const int rt = (np - k0) / 8, ct = w / 8;
      for (int tile = warp; tile < rt * ct; tile += warps) {
        const int ri = tile / ct, cj = tile % ct;
        if (ri < cj) continue;   // above the diagonal: never read
        const int r0 = k0 + 8 * ri, c0 = k0 + 8 * cj;
        float* cp = s + (r0 + gq) * ld + c0 + 2 * tq;
        double d0 = cp[0], d1 = cp[1];
        const float* xa = s + (r0 + gq) * ld + tq;   // L[r0 + g][l0 + t]
        const float* yb = s + (c0 + gq) * ld + tq;   // L[c0 + g][l0 + t]
        for (int l0 = 0; l0 < k0; l0 += 4) mma_f64(d0, d1, -(double)xa[l0], (double)yb[l0]);
        cp[0] = (float)d0;
        cp[1] = (float)d1;
      }
      __syncthreads();
    }
    // thread t takes column c + 1 + t % kW of the panel (the scaling:
    // column k0 + t % kW) and every kRows-th of its rows from t / kW on,
    // no division by a run-time count
    for (int c = k0; c < k0 + w; ++c) {
      const float d = rsqrtf(fmaxf(s[c * ld + c], tiny));
      if (t == 0) dinv[c] = d;
      const int j = c + 1 + jj;
      if (j < k0 + w && t < kRows * kW) {
        const float lj = s[j * ld + c] * d;
        for (int i = j + rr; i < np; i += kRows)
          s[i * ld + j] = fmaf(-(s[i * ld + c] * d), lj, s[i * ld + j]);
      }
      __syncthreads();
    }
    if (jj < w && t < kRows * kW) {
      const int c = k0 + jj;
      for (int i = k0 + rr; i < np; i += kRows) {
        if (i > c) s[i * ld + c] *= dinv[c];
        else if (i == c) s[i * ld + c] = 1.f / dinv[c];
      }
    }
    __syncthreads();
  }
}

// L^-1 into ti (np x np at stride ld, lower triangle and the zeros of each
// panel's diagonal block) from tc_factor's s and dinv, by row panels of
// width kW: rows k0.. first take -L[rows][0:k0] L^-1[0:k0][0:k0], one 8 x
// 8 tile a warp on DMMA (L^-1 is lower triangular, so a tile at columns
// c0.. sums l >= c0 only); the panel's diagonal block starts as the
// identity; then its rows are solved in order on the CUDA cores, row R
// final once scaled by d_R and taken at once from the panel's later rows,
// one barrier a row.  Ends with a barrier.
template <int kW>
__device__ void tc_inverse(const float* s, float* ti, int ld, int np, const float* dinv) {
  constexpr int kRows = kThreads / kW;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32, warps = kThreads / 32;
  const int gq = lane >> 2, tq = lane & 3, jj = t % kW, rr = t / kW;
  for (int k0 = 0; k0 < np; k0 += kW) {
    const int w = min(kW, np - k0);
    if (k0 > 0) {
      const int rt = w / 8, ct = k0 / 8;
      for (int tile = warp; tile < rt * ct; tile += warps) {
        const int r0 = k0 + 8 * (tile / ct), c0 = 8 * (tile % ct);
        double d0 = 0.0, d1 = 0.0;
        const float* xa = s + (r0 + gq) * ld + tq;   // L[r0 + g][l0 + t]
        const float* yb = ti + tq * ld + c0 + gq;    // L^-1[l0 + t][c0 + g]
        for (int l0 = c0; l0 < k0; l0 += 4)
          mma_f64(d0, d1, -(double)xa[l0], (double)yb[l0 * ld]);
        ti[(r0 + gq) * ld + c0 + 2 * tq] = (float)d0;
        ti[(r0 + gq) * ld + c0 + 2 * tq + 1] = (float)d1;
      }
    }
    if (jj < w && t < kRows * kW)
      for (int r = rr; r < w; r += kRows) ti[(k0 + r) * ld + k0 + jj] = r == jj ? 1.f : 0.f;
    __syncthreads();
    // row R's step: a warp a later row of the panel, lanes over columns
    for (int c = 0; c < w; ++c) {
      const int R = k0 + c;
      const float d = dinv[R];
      for (int r2 = R + 1 + warp; r2 < k0 + w; r2 += warps) {
        const float l = s[r2 * ld + R];
        for (int j = lane; j <= R; j += 32)
          ti[r2 * ld + j] = fmaf(-l, ti[R * ld + j] * d, ti[r2 * ld + j]);
      }
      __syncthreads();
      // row R is read by no later step of this panel: scale it in place
      for (int j = t; j <= R; j += blockDim.x) ti[R * ld + j] *= d;
    }
    __syncthreads();
  }
}

// G's lower triangle into s (np x np at stride ld) by asynchronous copies
// (committed by the caller), zeros above it and the identity past n.
__device__ inline void stage_padded(const float* Gb, float* s, int n, int np, int ld) {
  for (int idx = threadIdx.x; idx < np * np; idx += blockDim.x) {
    const int i = idx / np, c = idx % np;
    if (i < n && c <= i) __pipeline_memcpy_async(s + i * ld + c, Gb + i * n + c, sizeof(float));
    else s[i * ld + c] = i == c ? 1.f : 0.f;
  }
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

// Shared memory of chol_trsm_gram: L, later G2 (np x tc_ld(np));
// X (np x tc_ld(pad8(m))); the inverses of L's 8 x 8 diagonal blocks
// (np / 8 x 64); dinv (np).  np = pad8(n).  A is read from device
// memory where the substitution starts each row block (a warp's eight
// rows of a column tile's A^T are one 32-byte sector of A's row), so it
// takes no shared memory: 74.6 KB a node at (132, 73), three blocks an
// SM.
__host__ __device__ inline long long trsm_floats(int m, int n) {
  const long long np = pad8(n), mp = pad8(m);
  return np * tc_ld((int)np) + np * tc_ld((int)mp) + np * 8 + np;
}

// L of G (kW = 0 the elimination in registers, then L into shared
// memory; else tc_factor's panels of kW), the inverses of its 8 x 8
// diagonal blocks, then X = L^-1 A^T by row blocks of 8 on DMMA: a warp takes a column tile of 8 through every row block,
// T = A^T[rows] - L[rows][0:k0] X[0:k0] (K = k0), then X[rows] = the
// block's inverse times T (K = 8), with no block barrier (column tiles
// are independent right-hand sides); then G2 = X X^T on DMMA, a warp an
// 8 x 8 tile of its lower triangle (K = m).  X is held in float32 between
// the products, every sum is float64.
template <int kW, int kS>
__global__ void __launch_bounds__(kThreads, 2)
chol_trsm_gram_kernel(const float* __restrict__ A, const float* __restrict__ G,
                      float* __restrict__ out, int m, int n, float tiny) {
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x, warp = t / 32, lane = t % 32, warps = kThreads / 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int np = pad8(n), mp = pad8(m), ld = tc_ld(np), ldx = tc_ld(mp);
  float* s = smem;                         // L, then G2
  float* xs = s + np * ld;                 // X
  float* dblk = xs + np * ldx;             // the diagonal blocks' inverses
  float* dinv = dblk + np * 8;
  const long long node = blockIdx.x;
  const float* Ab = A + node * m * n;
  if constexpr (kW > 0) {
    stage_padded(G + node * n * n, s, n, np, ld);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    tc_factor<kW>(s, ld, np, tiny, dinv);
  } else {
    __shared__ float lcol[2][kGrid * kS];
    float g[kS][kS];
    load_lower<kS>(G + node * n * n, n, g);
    eliminate<kS>(g, n, tiny, lcol, dinv);
    const int tr = t / kGrid, tc = t % kGrid;
#pragma unroll
    for (int a = 0; a < kS; ++a)
#pragma unroll
      for (int b = 0; b < kS; ++b) {
        const int i = tr + kGrid * a, c = tc + kGrid * b;
        if (i < np && c < np)
          s[i * ld + c] = i >= n ? (i == c ? 1.f : 0.f)
                                 : c < i ? g[a][b] * dinv[c] : c == i ? 1.f / dinv[c] : 0.f;
      }
    for (int i = n + t; i < np; i += kThreads) dinv[i] = 1.f;
    __syncthreads();
  }
  // the inverse of each 8 x 8 diagonal block of L, a thread a column
  for (int w = t; w < np; w += kThreads) {
    const int b0 = w & ~7, c = w & 7;
    float y[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float acc = 0.f;   // y[j] = 0 for j < c
#pragma unroll
      for (int j = 0; j < r; ++j) acc = fmaf(s[(b0 + r) * ld + b0 + j], y[j], acc);
      y[r] = r < c ? 0.f : r == c ? dinv[b0 + r] : -acc * dinv[b0 + r];
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) dblk[b0 * 8 + r * 8 + c] = y[r];
  }
  __syncthreads();
  for (int c0 = 8 * warp; c0 < mp; c0 += 8 * warps) {
    for (int k0 = 0; k0 < np; k0 += 8) {
      const int r = k0 + gq, c = c0 + 2 * tq;
      double d0 = r < n && c < m ? Ab[c * n + r] : 0.0;
      double d1 = r < n && c + 1 < m ? Ab[(c + 1) * n + r] : 0.0;
      const float* la = s + r * ld + tq;             // L[k0 + g][l0 + t]
      const float* xb = xs + tq * ldx + c0 + gq;     // X[l0 + t][c0 + g]
      for (int l0 = 0; l0 < k0; l0 += 4)
        mma_f64(d0, d1, -(double)la[l0], (double)xb[l0 * ldx]);
      xs[r * ldx + c] = (float)d0;
      xs[r * ldx + c + 1] = (float)d1;
      __syncwarp();
      double e0 = 0.0, e1 = 0.0;
#pragma unroll
      for (int kk = 0; kk < 8; kk += 4)
        mma_f64(e0, e1, (double)dblk[k0 * 8 + gq * 8 + kk + tq],
                (double)xs[(k0 + kk + tq) * ldx + c0 + gq]);
      __syncwarp();
      xs[r * ldx + c] = (float)e0;
      xs[r * ldx + c + 1] = (float)e1;
      __syncwarp();
    }
  }
  __syncthreads();
  const int nb = np / 8;
  for (int tile = warp; tile < nb * (nb + 1) / 2; tile += warps) {
    int ti = 0, tj = tile;   // tile -> (ti, tj), tj <= ti, row by row
    while (tj > ti) tj -= ++ti;
    const int i0 = 8 * ti, j0 = 8 * tj;
    double d0 = 0.0, d1 = 0.0;
    const float* xa = xs + (i0 + gq) * ldx + tq;
    const float* xb = xs + (j0 + gq) * ldx + tq;
    for (int kk = 0; kk < mp; kk += 4) mma_f64(d0, d1, (double)xa[kk], (double)xb[kk]);
    const int j = j0 + 2 * tq;
    s[(i0 + gq) * np + j] = s[j * np + i0 + gq] = (float)d0;
    s[(i0 + gq) * np + j + 1] = s[(j + 1) * np + i0 + gq] = (float)d1;
  }
  __syncthreads();
  float* ob = out + node * n * n;
  for (int idx = t; idx < n * n; idx += kThreads) ob[idx] = s[(idx / n) * np + idx % n];
}

// Shared memory of chol_linv_tc: s (G, then L) and ti (L^-1), each np x
// tc_ld(np), and dinv (np).
__host__ __device__ inline long long linv_tc_floats(int n) {
  const long long np = pad8(n);
  return 2 * np * tc_ld((int)np) + np;
}

template <int kW>
__global__ void __launch_bounds__(kThreads, 2)
chol_linv_tc_kernel(const float* __restrict__ G, float* __restrict__ out, int n, float tiny) {
  extern __shared__ __align__(16) float smem[];
  const int np = pad8(n), ld = tc_ld(np);
  float* s = smem;
  float* ti = s + np * ld;
  float* dinv = ti + np * ld;
  const long long node = blockIdx.x;
  stage_padded(G + node * n * n, s, n, np, ld);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  tc_factor<kW>(s, ld, np, tiny, dinv);
  tc_inverse<kW>(s, ti, ld, np, dinv);
  float* ob = out + node * n * n;
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    const int i = idx / n, c = idx % n;
    ob[idx] = c <= i ? ti[i * ld + c] : 0.f;
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
using TrsmKernel = void (*)(const float*, const float*, float*, int, int, float);
using LinvTcKernel = void (*)(const float*, float*, int, float);
using TrisolveKernel = void (*)(const float*, const float*, const float*, float*, int, int,
                                float);

// The probes, by their ids in factor_probes_occupancy
enum Probe { kFactor = 0, kTrsm = 1, kLinvTc = 2, kTrisolve = 3 };

FactorKernel factor_kernel(int n) {
  if (n <= 3 * kGrid) return chol_factor_kernel<3>;
  if (n <= 5 * kGrid) return chol_factor_kernel<5>;
  return nullptr;
}

// width 0: the elimination's factor; 8, 16 or 32: tc_factor's panels
TrsmKernel trsm_kernel(int n, int width) {
  if (n > 5 * kGrid) return nullptr;
  switch (width) {
    case 0: return n <= 3 * kGrid ? chol_trsm_gram_kernel<0, 3> : chol_trsm_gram_kernel<0, 5>;
    case 8: return chol_trsm_gram_kernel<8, 1>;
    case 16: return chol_trsm_gram_kernel<16, 1>;
    case 32: return chol_trsm_gram_kernel<32, 1>;
    default: return nullptr;
  }
}

LinvTcKernel linv_tc_kernel(int width) {
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
  long long floats;   // dynamic shared memory
};

Launch launch_of(int probe, int m, int n, int width) {
  switch (probe) {
    case kFactor: return {(const void*)factor_kernel(n), 0};
    case kTrsm: return {(const void*)trsm_kernel(n, width), trsm_floats(m, n)};
    case kLinvTc: return {(const void*)linv_tc_kernel(width), linv_tc_floats(n)};
    case kTrisolve: return {(const void*)trisolve_kernel(n, width), trisolve_floats(n, width)};
    default: return {nullptr, 0};
  }
}

// The launch's dynamic shared memory, set on its kernel; an error where
// there is no instance for the shape or the node does not fit.
cudaError_t prepare(const Launch& l, size_t* bytes) {
  if (l.kernel == nullptr) return cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *bytes = (size_t)l.floats * sizeof(float);
  if (*bytes > (size_t)optin) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(l.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*bytes);
}

}  // namespace

// A probe's launch (0 chol_factor, 1 chol_trsm_gram, 2 chol_linv_tc, 3
// chol_trisolve_apply) at (m, n), width (chol_trsm_gram: 0 the
// elimination, else the panel width; chol_linv_tc: the panel width;
// chol_trisolve_apply: the solves' block of rows, 1 or 8): its dynamic
// shared memory, threads, the blocks an SM holds, and its registers and
// local memory bytes (spills) a thread; returns the cudaError_t.
extern "C" int factor_probes_occupancy(int probe, int m, int n, int width,
                                       long long* smem_bytes, int* threads, int* blocks_per_sm,
                                       int* regs, long long* local_bytes) {
  const Launch l = launch_of(probe, m, n, width);
  size_t bytes = 0;
  cudaError_t err = prepare(l, &bytes);
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
// factor, 8, 16 or 32 tc_factor's.
extern "C" int chol_trsm_gram_launch(const float* A, const float* G, float* out, int B, int m,
                                     int n, int width, float tiny, void* stream) {
  if (B <= 0 || m <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const Launch l = launch_of(kTrsm, m, n, width);
  size_t bytes = 0;
  cudaError_t err = prepare(l, &bytes);
  if (err != cudaSuccess) return (int)err;
  const TrsmKernel k = trsm_kernel(n, width);
  k<<<B, kThreads, bytes, (cudaStream_t)stream>>>(A, G, out, m, n, tiny);
  return (int)cudaGetLastError();
}

// L^-1 of G (lower triangular, zeros above), panels of `width` on DMMA.
extern "C" int chol_linv_tc_launch(const float* G, float* out, int B, int n, int width,
                                   float tiny, void* stream) {
  if (B <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const Launch l = launch_of(kLinvTc, 0, n, width);
  size_t bytes = 0;
  cudaError_t err = prepare(l, &bytes);
  if (err != cudaSuccess) return (int)err;
  const LinvTcKernel k = linv_tc_kernel(width);
  k<<<B, kThreads, bytes, (cudaStream_t)stream>>>(G, out, n, tiny);
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
  cudaError_t err = prepare(l, &bytes);
  if (err != cudaSuccess) return (int)err;
  const TrisolveKernel k = trisolve_kernel(n, block);
  k<<<B, kThreads, bytes, (cudaStream_t)stream>>>(G, Li, v, out, n, applies, tiny);
  return (int)cudaGetLastError();
}
