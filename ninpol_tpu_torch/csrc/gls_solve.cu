/*
 * GLS per-node solve for NVIDIA Hopper (sm_90a).
 *
 * Replaces ninpol_tpu/ops/pallas_chol.py::gls_solve_fused (its Pallas body
 * _solve_kernel).  It computes what that kernel computes, not its block
 * structure; ninpol_tpu_torch/ops/gls_solve.py holds the contract, the
 * wrapper and the plain PyTorch version (gls_solve_reference).
 *
 * Per node (one thread block per node):
 *   1. load the node's float64 pieces; find each face's local cell slots
 *      (the one-hot face->cell incidences of the TPU kernel);
 *   2. assemble the dense float32 system A (m x n), m = E + 3F (+F Neumann
 *      rows), n = 3E + 1, columns 3e+c per cell gradient, 3E the constant;
 *   3. shifted CholeskyQR2 in float32: column equilibration D, G1 = A^T A +
 *      diag(dead + shift), clamped Cholesky with L1^-1, Q = A L1^-T (in
 *      place over A), G2 = Q^T Q + diag(dead), clamped Cholesky with the
 *      combined factor Lc = L2^-1 L1^-1, so M = D Lc^T Lc D;
 *   4. float64 refinement: y = M e_{n-1}, then `sweeps` times
 *      y += M (e_{n-1} - A^T A y), with A applied structurally from the
 *      unscaled float64 pieces;
 *   5. w = cell rows of A y, wn = sum_f nm_f (Neumann row f . y), rnorm =
 *      ||dy|| / ||y|| (1 when a pivot was clamped: dmax > 3e4).
 *
 * The preconditioner's rounds are a template parameter, as `rounds` is a
 * static argument of the TPU kernel: kRounds = 2 is the above; kRounds = 1
 * (ninpol_tpu's precond_rounds = 1, pallas_chol.py:643-669) stops after
 * L1^-1, so M = D L1^-T L1^-1 D and breakdown reads dinv1 alone.  The
 * launch takes the instance for its `rounds` (>= 2: two rounds).
 *
 * Stage cuts (the second template parameter, kStop; the production kernel
 * is kStop = kAll): an instance that runs the stages up to and including
 * kStop, then writes zero weights and, in rnorm, one float64 checksum per
 * node of the state that stage ends on (the sum of its entries), so that
 * the compiler keeps the work and a test can see where the cut fell.
 * Timing the cuts in turn gives each stage's time inside the kernel
 * (ninpol_tpu_torch/tools/kernel_stages.py), the counterpart of the TPU
 * stage probes in tools/.  Every cut is under `if constexpr`: the
 * production instance is the kernel without them.  The cuts are built
 * only with -DGLS_SOLVE_STAGE_CUTS, into a library of their own with the
 * entry gls_solve_stage_launch; without it the library has the two
 * production instances and the entry gls_solve_launch.
 *
 * What bounds it on an H100: arithmetic and the factorizations' step
 * chains, not memory.  An interior tetrahedral node (E = 24, F = 36: m =
 * 132, n = 73) reads about 6 KB of inputs but does ~1.3 M float32 FMAs
 * in three m n^2 / 2 products (Gram1, Q, Gram2) on the CUDA cores, and
 * two factorizations whose steps are sequential.  Every intermediate (A,
 * the Gram matrices, the factors, the float64 vectors) stays in shared
 * memory, so device memory sees only the inputs and the outputs; a class
 * too large for shared memory puts A and the two slots (below) in a
 * per-node workspace the wrapper allocates, and runs the same code on it.
 *
 * The products run the device code of the unfused kernels
 * (cholqr_device.cuh: register tiles of 4 x 4, float32 FMAs); the two
 * factorizations run blocked_factor.cuh's blocked factor, shared with
 * the factorization probes of factor_probes.cu: G as a packed lower
 * triangle of 8 x 8 float64 blocks (np8 = pad8(n) rows, the identity past
 * n), factored right-looking 8 columns a step by panels of kFactorWidth,
 * a lead warp factoring each diagonal block by shuffles a step ahead of
 * the seven others, which form L^-1's block rows and the trailing update
 * on FP64 m16n8k8; two block barriers a step, 2 np8 / 8 a factorization
 * (20 at n = 73), where the elimination it replaced took one a pivot.
 * The Gram tiles write G straight into the packed form (their upper
 * tiles transposed, the diagonal shift added in float32); chol2's factor
 * Lc = L2^-1 L1^-1 is lower_product's (the same products), rounded once
 * into the float32 square that the sweeps' apply_M reads, which keeps
 * apply_M's warp-a-row reads and its float32 preconditioner as the plain
 * version has it.  Buffers, at (24, 36) (np = padded(n) = 76, np8 = 80;
 * a packed triangle 28,160 B):
 *   small   9,376 B: float64 pieces and vectors, float32 vectors (dinv1
 *           and dinv2 np8 long), ints;
 *   A      40,128 B: A (padded m x np float32), then Q in place, then
 *           L2^-1 packed once Q is read no more;
 *   slot 1 28,160 B: G1 -> L1 -> L1^-T (np x np float32, the Q tiles read
 *           it as consecutive float4s) -> G2 -> L2 -> Lc (np x np float32);
 *   slot 2 28,160 B: L1^-1, alive from chol1 through Q and G2 to Lc;
 * 105,824 B in all, two blocks an SM.  At (12, 24) with Neumann rows (n =
 * 37, np8 = 40) a slot is 7,680 B.  The apply u = Lc v runs a warp per
 * row, Lc^T u a thread per column.  Left for later work: chol1 to gram2
 * as one chol_trsm_gram (X = L1^-1 A^T, G2 = X X^T: no Q, no gram2
 * stage), gram1 on the tensor cores, the floor's input stream, and
 * several nodes a block.
 */
#include <cuda_runtime.h>
#include <math.h>

#include "blocked_factor.cuh"
#include "cholqr_device.cuh"

namespace {

using namespace blocked_factor_device;
using namespace cholqr_device;

constexpr int kThreads = 256;
static_assert(kThreads == kFactorThreads, "blocked_factor runs on the kernel's blocks");
constexpr int kFactorWidth = 16;   // blocked_factor's panel columns
constexpr float kSickDinv = 3e4f;
constexpr size_t kStaticSmemMargin = 64;

// Where a stage-cut instance stops: after the stage of that name, in the
// order the kernel runs them (ops/gls_solve.py::STAGES names them alike).
enum Stop : int {
  kFloor,    // 1. inputs and local incidence
  kRows,     // 2. float32 system rows A
  kGram1,    // 3. equilibration and G1
  kChol1,    //    L1^-1 (packed float64)
  kQ,        //    L1^-T and Q = A L1^-T (two rounds only)
  kGram2,    //    G2 (packed float64; two rounds only)
  kChol2,    //    L2^-1, then Lc = L2^-1 L1^-1 (two rounds only)
  kSweeps,   // 4. float64 refinement sweeps
  kAll       // 5. outputs: the production kernel
};

struct Params {
  const double *dk, *l1, *l2, *t1m, *tt, *lb, *nm;
  const int *pair, *ks;
  const unsigned char *cv, *fv, *isneu, *valid;
  double *w, *wn, *rnorm;
  float *ws;             // per-node workspace in device memory, or null
  long long ws_stride;   // floats per node in ws
  int E, F, with_neumann, sweeps;
  float tiny, shift;
};

struct Layout {
  int n, m, np, rows;     // np: padded(n), the row stride of A and the squares
  int nb;                 // block rows of the packed triangles, pad8(n) / 8
  size_t small_bytes;     // float64 pieces + vectors, float32 vectors, ints
  long long a_floats;     // A (rows x np), later L2^-1's packed triangle
  long long slot_floats;  // a packed float64 triangle or an np x np square
  long long big_floats;   // A's region and the two slots
};

__host__ __device__ inline Layout make_layout(int E, int F, int wneu) {
  Layout lay;
  lay.n = 3 * E + 1;
  lay.m = E + (wneu ? 4 : 3) * F;
  lay.np = padded(lay.n);
  lay.nb = pad8(lay.n) / 8;
  lay.rows = padded(lay.m);   // A's rows, padded to whole tiles
  const size_t n = lay.n;
  // dk; l1, l2, t1m, tt; lb, nm; y, r, dy; tcell; r1, r2, r3, tn
  const size_t nd = 3 * E + 12 * F + (wneu ? 4 * F : 0) + 3 * n + E + 4 * F;
  // D, dead, v, u; dinv1, dinv2 (a pivot for each padded row)
  const size_t nf = 4 * n + 2 * 8 * (size_t)lay.nb;
  const size_t ni = 3 * F;   // I1, I2, Ib
  lay.small_bytes = (nd * 8 + nf * 4 + ni * 4 + 15) / 16 * 16;
  const long long tri = 2LL * 64 * tri_blocks(lay.nb);   // floats
  const long long a = (long long)lay.rows * lay.np, sq = (long long)lay.np * lay.np;
  lay.a_floats = a > tri ? a : tri;
  lay.slot_floats = sq > tri ? sq : tri;
  lay.big_floats = lay.a_floats + 2 * lay.slot_floats;
  return lay;
}

// G = A^T A + diag(dead + diag_add) into lp as a packed lower triangle,
// the identity past n: each thread's register tiles of the upper triangle
// (gram_tile over all m rows of A), written transposed into the lower
// one; the diagonal's add in float32, as G's float32 entries take it.
// Ends with a barrier.
__device__ void gram(const float* A, double* lp, const float* dead, float diag_add, int m,
                     int n, int np, int nb) {
  const int nt = np / kTile;
  for (int t = threadIdx.x; t < nt * (nt + 1) / 2; t += kThreads) {
    int i0, j0;
    upper_tile(t, nt, i0, j0);
    float acc[kTile][kTile] = {};
    gram_tile(A, m, np, i0, j0, acc);
#pragma unroll
    for (int p = 0; p < kTile; ++p)
#pragma unroll
      for (int q = 0; q < kTile; ++q) {
        const int i = i0 + p, j = j0 + q;
        if (i <= j && j < n)
          lp[packed_at(j, i)] = i == j ? acc[p][q] + (dead[i] + diag_add) : acc[p][q];
      }
  }
  const int np8 = 8 * nb;
  for (int idx = threadIdx.x; idx < (np8 - n) * np8; idx += kThreads) {
    const int r = n + idx / np8, c = idx % np8;
    if (c <= r) lp[packed_at(r, c)] = r == c ? 1.0 : 0.0;
  }
  __syncthreads();
}

// The clamped Cholesky factor of the packed G in lp, in place, with L^-1
// into ip and d_k = rsqrt(max(pivot_k, tiny)) into dinv (np8 of them):
// warp 0 factors diagonal block 0, then blocked_factor's steps.  Starts
// after a barrier and ends with one.
__device__ void factor(double* lp, double* ip, int nb, float tiny, float* dinv) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
    const double2 s = row_pair(lp + bo(0, 0), g, 2 * t);
    diag_factor((float)s.x, (float)s.y, lp, ip, 0, tiny, dinv);
  }
  __syncthreads();
  blocked_factor<kFactorWidth, true>(lp, ip, nullptr, nb, tiny, dinv);
}

// out = D Lc^T Lc D rin: float32 preconditioner, float64 in and out, Lc
// lower triangular at stride ld: u = Lc v one warp a row, then Lc^T u one
// thread a column
__device__ void apply_M(const double* rin, double* out, const float* Lc,
                        const float* D, float* v, float* u, int n, int ld) {
  for (int j = threadIdx.x; j < n; j += kThreads)
    v[j] = (float)rin[j] * D[j];
  __syncthreads();
  rows_times(Lc, ld, v, u, n, true);
  __syncthreads();
  for (int k = threadIdx.x; k < n; k += kThreads)
    out[k] = (double)(col_times(Lc, ld, u, k, n, true) * D[k]);
  __syncthreads();
}

// The sum (or max) of v over the lanes of a warp, in every lane.
template <typename T>
__device__ T warp_sum(T v) {
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ float warp_max(float v) {
  for (int off = 16; off > 0; off /= 2)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// This thread's share, in float64, of the sum of the first `rows` x
// `cols` entries of x (row stride ld), or with `lower` of its entries on
// and below the diagonal.
__device__ double part_sum(const float* x, int rows, int cols, int ld, bool lower = false) {
  double s = 0.0;
  for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
    const int r = i / cols, c = i - r * cols;
    if (!lower || c <= r) s += x[r * ld + c];
  }
  return s;
}

// This thread's share of the sum of the n x n matrix whose lower triangle
// lp packs (blocked_factor.cuh): of a lower-triangular one its entries,
// of a symmetric one (`symmetric`) 2 (strict lower) + diagonal.
__device__ double packed_sum(const double* lp, int n, bool symmetric) {
  double s = 0.0;
  for (int i = threadIdx.x; i < n * n; i += kThreads) {
    const int r = i / n, c = i - r * n;
    if (c <= r) s += (symmetric && c < r ? 2.0 : 1.0) * lp[packed_at(r, c)];
  }
  return s;
}

// A stage cut's outputs: zero weights and Neumann weight, and in rnorm
// the block's sum of `part` (each thread's share of the checksum), summed
// a warp at a time into `scratch` (kThreads / 32 doubles of shared memory
// that nothing reads at the cut).
__device__ void cut_outputs(const Params& p, long long b, double part,
                            double* scratch) {
  part = warp_sum(part);
  if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = part;
  for (int e = threadIdx.x; e < p.E; e += kThreads) p.w[b * p.E + e] = 0.0;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int w = 0; w < kThreads / 32; ++w) s += scratch[w];
    p.wn[b] = 0.0;
    p.rnorm[b] = s;
  }
}

struct Node {
  int E, F, n;
  const double *dk, *l1, *l2, *t1m, *tt, *lb;
  const unsigned char* cv;
  const int *I1, *I2, *Ib;
  double *tcell, *r1, *r2, *r3, *tn;
};

// Row images of A y in float64: tcell (cell rows), r1/r2/r3 (the three
// rows of each face), tn (Neumann rows).
__device__ void apply_A(const Node& nd, const double* y) {
  const int E = nd.E, F = nd.F;
  for (int i = threadIdx.x; i < E + F; i += kThreads) {
    if (i < E) {
      const double* d = nd.dk + 3 * i;
      nd.tcell[i] = nd.cv[i]
          ? d[0] * y[3 * i] + d[1] * y[3 * i + 1] + d[2] * y[3 * i + 2] + y[3 * E]
          : 0.0;
      continue;
    }
    const int f = i - E;
    double g1[3] = {0.0, 0.0, 0.0}, g2[3] = {0.0, 0.0, 0.0};
    if (nd.I1[f] >= 0)
      for (int c = 0; c < 3; ++c) g1[c] = y[3 * nd.I1[f] + c];
    if (nd.I2[f] >= 0)
      for (int c = 0; c < 3; ++c) g2[c] = y[3 * nd.I2[f] + c];
    double a = 0.0, b = 0.0, q = 0.0, t = 0.0;
    for (int c = 0; c < 3; ++c) {
      const int o = 3 * f + c;
      const double dd = g2[c] - g1[c];
      a += nd.l2[o] * g2[c] - nd.l1[o] * g1[c];
      b += nd.t1m[o] * dd;
      q += nd.tt[o] * dd;
    }
    if (nd.Ib[f] >= 0)
      for (int c = 0; c < 3; ++c) t -= nd.lb[3 * f + c] * y[3 * nd.Ib[f] + c];
    nd.r1[f] = a;
    nd.r2[f] = b;
    nd.r3[f] = q;
    nd.tn[f] = t;
  }
  __syncthreads();
}

// r = e_{n-1} - A^T (A y), structurally in float64 (overwrites the row images)
__device__ void residual(const Node& nd, const double* y, double* r) {
  apply_A(nd, y);
  const int E = nd.E, F = nd.F, n = nd.n;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    double s = 0.0;
    if (j < 3 * E) {
      const int e = j / 3, c = j - 3 * e;
      s = nd.dk[j] * nd.tcell[e];
      for (int f = 0; f < F; ++f) {
        const int o = 3 * f + c;
        if (nd.I1[f] == e)
          s -= nd.l1[o] * nd.r1[f] + nd.t1m[o] * nd.r2[f] + nd.tt[o] * nd.r3[f];
        if (nd.I2[f] == e)
          s += nd.l2[o] * nd.r1[f] + nd.t1m[o] * nd.r2[f] + nd.tt[o] * nd.r3[f];
        if (nd.Ib[f] == e) s -= nd.lb[o] * nd.tn[f];
      }
    } else {
      for (int e = 0; e < E; ++e) s += nd.tcell[e];
    }
    r[j] = (j == n - 1 ? 1.0 : 0.0) - s;
  }
  __syncthreads();
}

// two blocks an SM, all the interior class's shared memory allows: at
// most 128 registers a thread, which hold the Neumann class (shared
// memory for five) at two as well; at 64 the rounds = 2 instance spills
// and the interior class runs slower
template <int kRounds, int kStop = kAll>
__global__ void __launch_bounds__(kThreads, 2) gls_solve_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_flag[2];   // active, sick
  const int E = p.E, F = p.F;
  const bool wneu = p.with_neumann != 0;
  const Layout lay = make_layout(E, F, p.with_neumann);
  const int n = lay.n, m = lay.m, np = lay.np;
  const int tid = threadIdx.x;
  const long long b = blockIdx.x;

  double* dk = reinterpret_cast<double*>(smem);
  double* l1 = dk + 3 * E;
  double* l2 = l1 + 3 * F;
  double* t1m = l2 + 3 * F;
  double* tt = t1m + 3 * F;
  double* lb = tt + 3 * F;
  double* nm = lb + (wneu ? 3 * F : 0);
  double* y = nm + (wneu ? F : 0);
  double* r = y + n;
  double* dy = r + n;
  double* tcell = dy + n;
  double* r1 = tcell + E;
  double* r2 = r1 + F;
  double* r3 = r2 + F;
  double* tn = r3 + F;
  float* D = reinterpret_cast<float*>(tn + F);
  float* dead = D + n;
  float* v = dead + n;
  float* u = v + n;
  float* dinv1 = u + n;
  float* dinv2 = dinv1 + 8 * lay.nb;
  int* I1 = reinterpret_cast<int*>(dinv2 + 8 * lay.nb);
  int* I2 = I1 + F;
  int* Ib = I2 + F;
  // A's region, then the two slots (the source note's table)
  float* A = p.ws ? p.ws + b * p.ws_stride
                  : reinterpret_cast<float*>(smem + lay.small_bytes);
  float* slot1 = A + lay.a_floats;
  float* slot2 = slot1 + lay.slot_floats;
  double* packed_a = reinterpret_cast<double*>(A);
  double* packed1 = reinterpret_cast<double*>(slot1);
  double* packed2 = reinterpret_cast<double*>(slot2);

  // ---- 1. inputs and local incidence
  const unsigned char* cvb = p.cv + b * E;
  const int* ksb = p.ks + b * E;
  const int* pairb = p.pair + b * 2 * F;
  const unsigned char* fvb = p.fv + b * F;
  const bool neu = p.isneu[b] != 0;
  for (int i = tid; i < 3 * E; i += kThreads) dk[i] = p.dk[b * 3 * E + i];
  for (int i = tid; i < 3 * F; i += kThreads) {
    const long long o = b * 3 * F + i;
    l1[i] = p.l1[o];
    l2[i] = p.l2[o];
    t1m[i] = p.t1m[o];
    tt[i] = p.tt[o];
    if (wneu) lb[i] = p.lb[o];
  }
  if (wneu)
    for (int f = tid; f < F; f += kThreads) nm[f] = p.nm[b * F + f];
  for (int f = tid; f < F; f += kThreads) {
    const int k1 = pairb[2 * f], k2 = pairb[2 * f + 1];
    const bool interior = fvb[f] && k2 >= 0;
    const bool bneu = wneu && neu && fvb[f] && k2 < 0;
    int i1 = -1, i2 = -1, ib = -1;
    for (int e = 0; e < E; ++e) {
      if (!cvb[e]) continue;
      if (interior && ksb[e] == k1) i1 = e;
      if (interior && ksb[e] == k2) i2 = e;
      if (bneu && ksb[e] == k1) ib = e;
    }
    I1[f] = i1;
    I2[f] = i2;
    Ib[f] = ib;
  }
  if (tid < 32) {
    int n_face = 0, n_bface = 0;
    for (int f = tid; f < F; f += 32)
      if (fvb[f]) {
        ++n_face;
        if (pairb[2 * f + 1] < 0) ++n_bface;
      }
    n_face = warp_sum(n_face);
    n_bface = warp_sum(n_bface);
    if (tid == 0) s_flag[0] = p.valid[b] != 0 && !(n_bface >= n_face);
  }
  __syncthreads();
  if (!s_flag[0]) {
    for (int e = tid; e < E; e += kThreads) p.w[b * E + e] = 0.0;
    if (tid == 0) {
      p.wn[b] = 0.0;
      p.rnorm[b] = 0.0;
    }
    return;
  }
  // the cuts' checksums: y, r and dy (3n >= 12 doubles) are free until
  // the sweeps, r and dy after them
  if constexpr (kStop == kFloor) {
    double s = 0.0;   // the float64 pieces dk .. nm lie back to back
    for (int i = tid; i < (int)(y - dk); i += kThreads) s += dk[i];
    for (int f = tid; f < F; f += kThreads) s += I1[f] + I2[f] + Ib[f];
    cut_outputs(p, b, s, y);
    return;
  }

  // ---- 2. float32 system rows
  // A, pad rows and columns included
  for (long long i = tid; i < (long long)lay.rows * np; i += kThreads) A[i] = 0.f;
  __syncthreads();
  for (int e = tid; e < E; e += kThreads) {
    float* row = A + (size_t)e * np;
    for (int c = 0; c < 3; ++c) row[3 * e + c] = (float)dk[3 * e + c];
    row[3 * E] = cvb[e] ? 1.f : 0.f;
  }
  for (int f = tid; f < F; f += kThreads) {
    float* ra = A + (size_t)(E + 3 * f) * np;
    for (int c = 0; c < 3; ++c) {
      const int o = 3 * f + c;
      if (I1[f] >= 0) {
        const int col = 3 * I1[f] + c;
        ra[col] = -(float)l1[o];
        ra[np + col] = -(float)t1m[o];
        ra[2 * np + col] = -(float)tt[o];
      }
      if (I2[f] >= 0) {
        const int col = 3 * I2[f] + c;
        ra[col] = (float)l2[o];
        ra[np + col] = (float)t1m[o];
        ra[2 * np + col] = (float)tt[o];
      }
      if (Ib[f] >= 0)
        A[(size_t)(E + 3 * F + f) * np + 3 * Ib[f] + c] = -(float)lb[o];
    }
  }
  __syncthreads();
  if constexpr (kStop == kRows) {
    cut_outputs(p, b, part_sum(A, m, n, np), y);
    return;
  }

  // ---- 3. shifted CholeskyQR2 preconditioner (float32, its factors'
  // products float64)
  for (int j = tid; j < n; j += kThreads) {
    float s = 0.f;
    for (int i = 0; i < m; ++i) {
      const float a = A[(size_t)i * np + j];
      s = fmaf(a, a, s);
    }
    dead[j] = s == 0.f ? 1.f : 0.f;
    D[j] = s == 0.f ? 0.f : rsqrtf(s);
  }
  __syncthreads();
  for (int i = tid; i < m * np; i += kThreads) {
    const int c = i % np;
    if (c < n) A[i] *= D[c];
  }
  __syncthreads();
  gram(A, packed1, dead, p.shift, m, n, np, lay.nb);   // G1
  if constexpr (kStop == kGram1) {
    cut_outputs(p, b, packed_sum(packed1, n, true), y);
    return;
  }
  factor(packed1, packed2, lay.nb, p.tiny, dinv1);   // L1 over G1, L1^-1
  if constexpr (kStop == kChol1) {
    cut_outputs(p, b, packed_sum(packed2, n, false), y);
    return;
  }
  // M's factor, a float32 square at stride np in slot 1: one round, L1^-1
  // itself; two rounds, Lc
  const float* Lc = slot1;
  if constexpr (kRounds >= 2) {
    // slot 1 <- L1^-T (L1 is dead): the Q tiles read it as consecutive
    // float4s
    for (int i = tid; i < n * np; i += kThreads) {
      const int j = i / np, k = i - j * np;
      slot1[i] = j <= k && k < n ? (float)packed2[packed_at(k, j)] : 0.f;
    }
    __syncthreads();
    {
      // Q = A L1^-T in place over A, `chunk` rows at a time: each thread
      // holds at most one kTile x kTile tile of the chunk in registers until
      // every tile has read the chunk's rows of A.
      const int nt = np / kTile;
      const int chunk = kTile * (kThreads / nt);
      for (int r0 = 0; r0 < m; r0 += chunk) {
        const int tiles = (min(chunk, m - r0) + kTile - 1) / kTile * nt;
        const int r0t = r0 + tid / nt * kTile, k0 = tid % nt * kTile;
        float acc[kTile][kTile];
        if (tid < tiles) q_tile(A, slot1, r0t, k0, n, np, acc);
        __syncthreads();
        if (tid < tiles) store_tile(A, r0t, k0, m, np, acc);
        __syncthreads();
      }
    }
    if constexpr (kStop == kQ) {
      cut_outputs(p, b, part_sum(A, m, n, np), y);
      return;
    }
    gram(A, packed1, dead, 0.f, m, n, np, lay.nb);   // G2 over L1^-T
    if constexpr (kStop == kGram2) {
      cut_outputs(p, b, packed_sum(packed1, n, true), y);
      return;
    }
    factor(packed1, packed_a, lay.nb, p.tiny, dinv2);   // L2 over G2, L2^-1 over Q
    lower_product(packed_a, packed2, slot1, np, n, lay.nb);   // Lc over L2
    if constexpr (kStop == kChol2) {
      cut_outputs(p, b, part_sum(slot1, n, n, np, true), y);
      return;
    }
  } else {
    // slot 1 <- L1^-1 (L1 is dead), its lower triangle: all apply_M reads
    // (the barrier before the sweeps' first apply_M orders it)
    for (int i = tid; i < n * n; i += kThreads) {
      const int r = i / n, c = i - r * n;
      if (c <= r) slot1[r * np + c] = (float)packed2[packed_at(r, c)];
    }
  }
  if (tid < 32) {
    float dmax = 0.f;
    for (int k = tid; k < n; k += 32)
      dmax = fmaxf(dmax, kRounds >= 2 ? fmaxf(dinv1[k], dinv1[k] * dinv2[k])
                                      : dinv1[k]);
    dmax = warp_max(dmax);
    if (tid == 0) s_flag[1] = dmax > kSickDinv;
  }

  // ---- 4. float64 refinement sweeps
  const Node nd{E, F, n, dk, l1, l2, t1m, tt, lb, cvb, I1, I2, Ib,
                tcell, r1, r2, r3, tn};
  for (int j = tid; j < n; j += kThreads) r[j] = j == n - 1 ? 1.0 : 0.0;
  __syncthreads();
  apply_M(r, y, Lc, D, v, u, n, np);
  for (int s = 0; s < p.sweeps; ++s) {
    residual(nd, y, r);
    apply_M(r, dy, Lc, D, v, u, n, np);
    for (int j = tid; j < n; j += kThreads) y[j] += dy[j];
    __syncthreads();
  }
  if constexpr (kStop == kSweeps) {
    double s = 0.0;
    for (int j = tid; j < n; j += kThreads) s += y[j];
    cut_outputs(p, b, s, r);
    return;
  }
  const double* dlast = p.sweeps > 0 ? dy : y;

  // ---- 5. outputs
  apply_A(nd, y);
  for (int e = tid; e < E; e += kThreads) p.w[b * E + e] = tcell[e];
  if (tid < 32) {
    double dy2 = 0.0, y2 = 0.0, wsum = 0.0;
    for (int j = tid; j < n; j += 32) {
      dy2 += dlast[j] * dlast[j];
      y2 += y[j] * y[j];
    }
    if (wneu)
      for (int f = tid; f < F; f += 32) wsum += nm[f] * tn[f];
    dy2 = warp_sum(dy2);
    y2 = warp_sum(y2);
    wsum = warp_sum(wsum);
    if (tid == 0) {
      double rn = sqrt(dy2) / sqrt(fmax(y2, 1e-30));
      if (s_flag[1]) rn = 1.0;
      p.wn[b] = wsum;
      p.rnorm[b] = rn;
    }
  }
}

// Whether a class's A and two slots fit in shared memory beside the rest.
bool fits_in_smem(const Layout& lay) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t all = lay.small_bytes + (size_t)lay.big_floats * 4;
  return all + kStaticSmemMargin <= (size_t)optin;
}

// Dynamic shared memory of a launch: all of it, or without A and the slots
// when they live in the device workspace.
size_t launch_smem(const Layout& lay, bool workspace) {
  return lay.small_bytes + (workspace ? 0 : (size_t)lay.big_floats * sizeof(float));
}

// The dynamic shared memory bytes of a class's launch, its threads, the
// blocks of the kernel's `rounds` instance an SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and the instance's
// registers and local memory (spill) bytes a thread
// (cudaFuncGetAttributes); returns the cudaError_t (0 on success).
template <int kRounds>
int occupancy(const Layout& lay, long long* smem_bytes, int* threads, int* blocks_per_sm,
              int* regs, long long* local_bytes) {
  const size_t smem = launch_smem(lay, !fits_in_smem(lay));
  *smem_bytes = (long long)smem;
  *threads = kThreads;
  cudaError_t err = cudaFuncSetAttribute(
      gls_solve_kernel<kRounds>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, gls_solve_kernel<kRounds>);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (long long)attr.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, gls_solve_kernel<kRounds>, kThreads, smem);
}

// Launch the `rounds` instance cut at kStop; returns the cudaError_t of
// the launch.
template <int kRounds, int kStop>
int launch(const Params& p, int B, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gls_solve_kernel<kRounds, kStop>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  gls_solve_kernel<kRounds, kStop><<<B, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

#ifdef GLS_SOLVE_STAGE_CUTS
// Launch the instance of `rounds` and `stop`, trying the cuts from kStop
// on; the one-round instance has no cut inside the second round.
template <int kRounds, int kStop = kFloor>
int launch_cut(const Params& p, int stop, int B, size_t smem,
               cudaStream_t stream) {
  if (stop != kStop) {
    if constexpr (kStop < kAll)
      return launch_cut<kRounds, kStop + 1>(p, stop, B, smem, stream);
    else
      return (int)cudaErrorInvalidValue;
  }
  if constexpr (kRounds < 2 && kStop >= kQ && kStop <= kChol2)
    return (int)cudaErrorInvalidValue;
  else
    return launch<kRounds, kStop>(p, B, smem, stream);
}
#endif

// Launch the kernel's instance of `rounds` (>= 2: two rounds) cut after
// stage `stop`, on B nodes; returns the cudaError_t of the launch.  The
// production library has only the kAll instances; the stage-cut library
// (built with -DGLS_SOLVE_STAGE_CUTS) has every cut.
int solve_launch(const Params& p, int B, int rounds, int stop,
                 cudaStream_t stream) {
  const Layout lay = make_layout(p.E, p.F, p.with_neumann);
  if (B <= 0 || p.E <= 0 || p.F <= 0 || p.sweeps < 0 ||
      (p.with_neumann && (p.lb == nullptr || p.nm == nullptr)) ||
      lay.np > kTile * kThreads ||   // a Q tile row wider than the block
      (p.ws != nullptr && p.ws_stride < lay.big_floats) ||
      stop < kFloor || stop > kAll)
    return (int)cudaErrorInvalidValue;
  const size_t smem = launch_smem(lay, p.ws != nullptr);
#ifdef GLS_SOLVE_STAGE_CUTS
  return rounds >= 2 ? launch_cut<2>(p, stop, B, smem, stream)
                     : launch_cut<1>(p, stop, B, smem, stream);
#else
  if (stop != kAll) return (int)cudaErrorInvalidValue;
  return rounds >= 2 ? launch<2, kAll>(p, B, smem, stream)
                     : launch<1, kAll>(p, B, smem, stream);
#endif
}

}  // namespace

// Floats of device workspace per node when a class does not fit in shared
// memory; 0 when it does (the kernel then needs no workspace).
extern "C" long long gls_solve_workspace_floats(int E, int F,
                                                int with_neumann) {
  const Layout lay = make_layout(E, F, with_neumann);
  return fits_in_smem(lay) ? 0 : lay.big_floats;
}

// The production instance of `rounds` at a class: its dynamic shared
// memory, threads, blocks an SM, registers and local (spill) bytes a
// thread (occupancy above).
extern "C" int gls_solve_occupancy(int E, int F, int with_neumann, int rounds,
                                   long long* smem_bytes, int* threads, int* blocks_per_sm,
                                   int* regs, long long* local_bytes) {
  const Layout lay = make_layout(E, F, with_neumann);
  return rounds >= 2
             ? occupancy<2>(lay, smem_bytes, threads, blocks_per_sm, regs, local_bytes)
             : occupancy<1>(lay, smem_bytes, threads, blocks_per_sm, regs, local_bytes);
}

#ifdef GLS_SOLVE_STAGE_CUTS
// The kernel's instance of `rounds` cut after stage `stop` (a Stop; kAll:
// the production kernel), on `stream`; returns the cudaError_t of the
// launch (0 on success).  A cut writes zero to w and wn and its checksum
// to rnorm.
extern "C" int gls_solve_stage_launch(
    const double* dk, const double* l1, const double* l2, const double* t1m,
    const double* tt, const double* lb, const double* nm, const int* pair,
    const int* ks, const unsigned char* cv, const unsigned char* fv,
    const unsigned char* isneu, const unsigned char* valid, double* w,
    double* wn, double* rnorm, float* ws, long long ws_stride, int B, int E,
    int F, int with_neumann, int sweeps, int rounds, int stop, double tiny,
    double shift, void* stream) {
  Params p{dk, l1, l2, t1m, tt, lb, nm, pair, ks, cv, fv, isneu, valid,
           w, wn, rnorm, ws, ws_stride, E, F, with_neumann, sweeps,
           (float)tiny, (float)shift};
  return solve_launch(p, B, rounds, stop, (cudaStream_t)stream);
}
#else
// The production kernel (kAll) on `stream`; returns the cudaError_t of
// the launch (0 on success).
extern "C" int gls_solve_launch(
    const double* dk, const double* l1, const double* l2, const double* t1m,
    const double* tt, const double* lb, const double* nm, const int* pair,
    const int* ks, const unsigned char* cv, const unsigned char* fv,
    const unsigned char* isneu, const unsigned char* valid, double* w,
    double* wn, double* rnorm, float* ws, long long ws_stride, int B, int E,
    int F, int with_neumann, int sweeps, int rounds, double tiny, double shift,
    void* stream) {
  Params p{dk, l1, l2, t1m, tt, lb, nm, pair, ks, cv, fv, isneu, valid,
           w, wn, rnorm, ws, ws_stride, E, F, with_neumann, sweeps,
           (float)tiny, (float)shift};
  return solve_launch(p, B, rounds, kAll, (cudaStream_t)stream);
}
#endif
