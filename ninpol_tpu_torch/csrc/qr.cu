/*
 * The kernels of the corrected semi-normal equations (CSNE) GLS solve for
 * NVIDIA Hopper (sm_90a): batched per-node float64 kernels, one thread
 * block per node.  ninpol_tpu_torch/ops/qr.py holds the contracts, the
 * wrappers and the plain PyTorch versions.  The TPU kernels they replace
 * work in double-float32 pairs only because the TPU emulates float64; the
 * H100 has native FP64 (34 TFLOP/s on the FP64 units, 67 TFLOP/s on the
 * tensor cores' DMMA), so these take and return float64.
 *
 * qr_r replaces ninpol_tpu/ops/pallas_qr.py::qr_r_df32 (_qr_step_kernel):
 *   R of the Householder QR of Ar = [A; diag(dead)], the route's m x n A
 *   with an identity row appended for each dead (all-zero) column, with
 *   the TPU kernel's sign convention (R_kk = -||x|| where x_k >= 0) and
 *   beta = 2 / ||v||^2 (0 where v = 0).  The appended rows are never
 *   stored.  Householder on Ar gives a dead column j in closed form: its
 *   x is the unit of row m + j, so R's row j is -e_j, R's column j is zero
 *   above the diagonal, and the reflector moves real row j (negated) to
 *   row m + j, where it stays in the trailing rows of every later column.
 *   So a dead pivot costs nothing: R's row j is written as -e_j and real
 *   row j stays in the trailing set, unnegated (a row's sign changes
 *   neither w nor any later R entry).  The kernel needs m >= n, so that
 *   every pivot falls on a real row.
 *   Bound by memory on an H100: per node the QR of m + (dead) rows,
 *   2 p n^2 - 2/3 n^3 FLOP (~1.15 MFLOP for the interior class, 132 real
 *   rows, n = 73), against ~99 KB moved (A read, R's triangle written):
 *   ~12 FLOP/byte, under the ~20 where FP64 at the DMMA rate turns
 *   operation-bound.  The TPU kernel runs one column per sequential grid
 *   step over a VMEM-resident tile of 128 nodes.  Here two bodies:
 *
 *   qr_r_reg_kernel (the (24, 36) interior class, see reg_tile): the
 *     node's A lives in registers for the whole factorization, lane l of
 *     warp w holding rows l + 32 r (r < kR) of columns w + kWarps c
 *     (c < kC): 117 registers, one block of 512 threads an SM.  A column
 *     step: the warp that owns pivot column k has formed its reflector v
 *     and beta at the end of the step before and put them in shared
 *     memory (double-buffered); after one barrier each warp forms
 *     w_j = v^T a_j for its columns j > k with its FMAs and a butterfly
 *     of shuffles, so every lane has w_j and the rank-1 update needs no
 *     second barrier; the owner of column k + 1 then forms the next
 *     reflector from its registers.  A is never re-read: shared memory
 *     holds v, beta, the dead flags and a 32-row staging buffer for the
 *     coalesced load of A and store of R.  Row slots whose v is all zero
 *     (finished rows) are skipped.  The five shuffles a column a warp
 *     pays for w, and the owner's reflector between two barriers, keep it
 *     far from the bound; a layout of four lanes a column (two shuffles)
 *     needed more registers than two blocks an SM allow and spilled.
 *
 *   qr_r_kernel (every other class): the node's m real rows in shared memory
 *     (or, past the 227 KB a block may use, in a per-node device
 *     workspace), column-major at an odd column stride, 512 threads (256
 *     under kQrNarrow columns).  Per column: w over the trailing rows (the
 *     dead rows before k, then rows k..m-1, from a list), each warp
 *     summing four columns at once, lanes over rows; then the rank-1
 *     update, which also sums the squares of the next column: two
 *     barriers a column.  At (24, 36) its 77.7 KB lets two blocks share an
 *     SM.
 *
 * sne_solve_warp_kernel and sne_solve_kernel replace
 *   pallas_qr.py::sne_solve_df32 (_solve_step_kernel): y with R^T R y = b,
 *   forward substitution (R^T z = b) then backward (R y = z), every
 *   |R_kk| < tiny taken as exactly 1 in both.  Bound by memory: the
 *   triangle of R is read once, n (n + 1) / 2 doubles per node, for n^2
 *   FMAs.  What holds it back is latency: 2n dependent steps a node.
 *
 *   sne_solve_warp_kernel (every n whose triangle fits in the shared
 *     memory a block may use: n <= 240): one warp a node, two a block.
 *     The node's upper triangle is staged once, packed row by row (21.6 KB
 *     at n = 73, so five blocks, ten nodes an SM), by asynchronous copies
 *     that walk the packed entries in order (coalesced, and no byte of
 *     the lower triangle read); each lane inverts the clamped pivots of
 *     its rows once.  Lane l owns rows l + 32 s, their running right-hand
 *     side in registers.  A step: the owner of row k forms z_k (times the
 *     inverted pivot), one shuffle hands it to the warp, and each lane
 *     subtracts its rows' share, reading row k of the triangle (forward:
 *     consecutive entries across the lanes, no bank conflict) or column k
 *     (backward); the next step's loads are issued before the shuffle.
 *     No block barrier, one shuffle, a DMUL and a DFMA on the chain of a
 *     step, where the block-per-node body waited on a device-memory load,
 *     a division and a barrier.  Rows in blocks of four a lane (four
 *     steps a shuffle round) were slower on the card.
 *
 *   sne_solve_kernel (wider nodes): one block of 128 threads a node, R
 *     read from device memory: the running right-hand side in shared
 *     memory, row k read coalesced (forward) or each thread's own row
 *     down the columns (backward), one barrier a step.
 *
 * Each launch function returns a cudaError_t as int (0 on success).
 */
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// qr_r_kernel blocks: 512 threads, or 256 for a node under kQrNarrow
// columns, whose w pass and update leave most of 512 threads idle
constexpr int kQrMaxThreads = 512;
constexpr int kQrNarrow = 48;
constexpr int kQrMaxWarps = kQrMaxThreads / 32;
constexpr int kQrCols = 4;      // columns of w a warp sums at once
// the rank-1 update: rows on kQrRowThreads threads, and the columns
// interleaved over the block's kThreads / kQrRowThreads such groups
constexpr int kQrRowThreads = 128;
constexpr int kSolveThreads = 128;
constexpr int kLoads = 4;       // loads a thread keeps in flight when staging

// Column stride of the staged A: m rounded up to odd, so that a warp
// reading one row across 32 consecutive columns is free of bank conflicts
// (as is one reading 32 consecutive rows of a column).
__host__ __device__ inline int col_stride(int m) { return m | 1; }

// qr_r_kernel's shared memory: A (unless in the workspace), w, the
// per-warp sums, then the dead flags and the dead-row list as ints
__host__ __device__ inline size_t qr_small_bytes(int n) {
  return sizeof(double) * ((size_t)n + kQrMaxWarps) + sizeof(int) * 2 * (size_t)n;
}

__host__ __device__ inline size_t qr_a_doubles(int m, int n) {
  return (size_t)col_stride(m) * n;
}

__device__ inline double warp_sum(double x) {
  for (int off = 16; off > 0; off /= 2) x += __shfl_down_sync(kFull, x, off);
  return x;   // the sum is in lane 0
}

// The same sum in every lane (a butterfly: each pair adds the same two
// values, so every lane ends with the same bits).
__device__ inline double warp_allsum(double x) {
  for (int off = 16; off > 0; off /= 2) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// The reflector of x (sum of squares ss, pivot entry xk): R_kk = alpha,
// v = x - alpha e_k (its pivot entry vk), beta = 2 / ||v||^2 or 0.
struct Reflector {
  double alpha, vk, beta;
};

__device__ inline Reflector reflector(double ss, double xk) {
  const double normx = sqrt(ss);
  Reflector h;
  h.alpha = xk >= 0.0 ? -normx : normx;
  h.vk = xk - h.alpha;
  const double vnorm2 = (ss - xk * xk) + h.vk * h.vk;
  h.beta = vnorm2 > 0.0 ? 2.0 / vnorm2 : 0.0;
  return h;
}

// R's entry (i, j) from the factored value x: zero below the diagonal,
// -e_i on a dead pivot's row.
__device__ inline double r_entry(int i, int j, bool dead_i, double x) {
  if (i > j) return 0.0;
  if (dead_i) return i == j ? -1.0 : 0.0;
  return x;
}

// Copy the row-major m x n matrix src into dst column-major, dst[j * ld + i]
// = src[i][j], each of the block's kThreads threads keeping kLoads loads in
// flight.
template <int kThreads>
__device__ void stage_columns(const double* __restrict__ src, double* dst, int m, int n,
                              int ld) {
  const int count = m * n;
  for (int base = threadIdx.x; base < count; base += kLoads * kThreads) {
    double v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int idx = base + u * kThreads;
      v[u] = idx < count ? src[idx] : 0.0;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int idx = base + u * kThreads;
      if (idx < count) {
        const int i = idx / n;
        dst[(idx - i * n) * ld + i] = v[u];
      }
    }
  }
}

// kWs: A in the workspace; a compile-time choice, so that the
// shared-memory instance addresses shared memory directly.
template <int kThreads, bool kWs>
__global__ void __launch_bounds__(kThreads, 2)
qr_r_kernel(const double* __restrict__ A, double* __restrict__ R,
            double* __restrict__ ws, int m, int n) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kColGroups = kThreads / kQrRowThreads;
  extern __shared__ __align__(16) double smem[];
  const int ld = col_stride(m);
  const long long node = blockIdx.x;
  // A column-major, a[j * ld + i]: in shared memory, or in the workspace
  double* a = kWs ? ws + node * (long long)qr_a_doubles(m, n) : smem;
  double* w = kWs ? smem : smem + qr_a_doubles(m, n);   // v^T A[:, j], j > k
  double* part = w + n;                  // per-warp sums of squares
  int* dead = reinterpret_cast<int*>(part + kQrMaxWarps);
  int* drow = dead + n;                  // the dead columns, ascending
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  stage_columns<kThreads>(A + node * m * n, a, m, n, ld);
  __syncthreads();
  for (int j = warp; j < n; j += kWarps) {
    double s = 0.0;
    for (int i = lane; i < m; i += 32) s = fma(a[j * ld + i], a[j * ld + i], s);
    s = warp_sum(s);
    if (lane == 0) dead[j] = s == 0.0;
  }
  double s = 0.0;                        // column 0's sum of squares
  for (int i = t; i < m; i += kThreads) s = fma(a[i], a[i], s);
  s = warp_sum(s);
  if (lane == 0) part[warp] = s;
  __syncthreads();
  if (t == 0)
    for (int j = 0, c = 0; j < n; ++j)
      if (dead[j]) drow[c++] = j;
  __syncthreads();
  // The trailing rows at column k: the dead rows j < k (drow[0, nd)),
  // then rows k .. m - 1; entry q of that list is row_at(q).
  int nd = 0;
  const auto row_at = [&](int q, int k) { return q < nd ? drow[q] : k + (q - nd); };
  // update threads: row offset r, column group g
  const int r = t % kQrRowThreads, g = t / kQrRowThreads;
  for (int k = 0; k < n; ++k) {
    const int rows = nd + (m - k);
    if (dead[k]) {
      // row k joins the trailing set: the next column's norm runs over
      // the same rows
      ++nd;
      if (k + 1 < n) {
        double s_next = 0.0;
        for (int q = t; q < rows; q += kThreads) {
          const double x = a[(size_t)(k + 1) * ld + row_at(q, k + 1)];
          s_next = fma(x, x, s_next);
        }
        s_next = warp_sum(s_next);
        if (lane == 0) part[warp] = s_next;
      }
      __syncthreads();
      continue;
    }
    double ss = 0.0;
    for (int p = 0; p < kWarps; ++p) ss += part[p];
    const double* col = a + (size_t)k * ld;
    const Reflector h = reflector(ss, col[k]);
    // w_j = v^T a[:, j] for j > k: a warp sums kQrCols columns at once,
    // lanes over consecutive rows of the list, then one shuffle reduction
    // a column
    for (int j0 = k + 1 + warp; j0 < n; j0 += kWarps * kQrCols) {
      double acc[kQrCols] = {};
      for (int q = lane; q < rows; q += 32) {
        const int i = row_at(q, k);
        const double vi = i == k ? h.vk : col[i];
#pragma unroll
        for (int u = 0; u < kQrCols; ++u) {
          const int j = j0 + u * kWarps;
          if (j < n) acc[u] = fma(vi, a[(size_t)j * ld + i], acc[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kQrCols; ++u) acc[u] = warp_sum(acc[u]);
      if (lane == 0) {
#pragma unroll
        for (int u = 0; u < kQrCols; ++u)
          if (j0 + u * kWarps < n) w[j0 + u * kWarps] = acc[u];
      }
    }
    __syncthreads();                     // w complete, part consumed
    // R_kk = alpha, as the reflector leaves it; the rest of column k lies
    // below the diagonal (or on rows that R does not read) and is never
    // read again
    if (t == 0) a[(size_t)k * ld + k] = h.alpha;
    // a[i, j] -= (beta v_i) w_j for the trailing rows i, columns j > k:
    // rows on kQrRowThreads threads, columns interleaved over the
    // kColGroups groups; group 0 also sums the squares of the updated
    // column k + 1 over the next column's trailing rows (all but row k)
    double s_next = 0.0;
    for (int q = r; q < rows; q += kQrRowThreads) {
      const int i = row_at(q, k);
      const double bvi = h.beta * (i == k ? h.vk : col[i]);
#pragma unroll 4
      for (int j = k + 1 + g; j < n; j += kColGroups) a[(size_t)j * ld + i] -= bvi * w[j];
      if (g == 0 && k + 1 < n && i != k) {
        const double x = a[(size_t)(k + 1) * ld + i];
        s_next = fma(x, x, s_next);
      }
    }
    s_next = warp_sum(s_next);
    if (lane == 0) part[warp] = s_next;
    __syncthreads();
  }
  double* Rb = R + node * n * n;
  for (int idx = t; idx < n * n; idx += kThreads) {
    const int i = idx / n, j = idx - i * n;
    Rb[idx] = r_entry(i, j, dead[i], a[(size_t)j * ld + i]);
  }
}

// ---- the register-resident body

// Shared memory of qr_r_reg_kernel: the 32-row staging buffer at the odd
// stride n | 1, v and beta twice, then the dead flags as ints.
__host__ __device__ inline size_t qr_reg_smem_bytes(int n, int kRows) {
  return sizeof(double) * (32 * (size_t)(n | 1) + 2 * (size_t)kRows + 2)
         + sizeof(int) * (size_t)n;
}

// The pivot step of column k by the warp that owns it (every lane): the
// reflector of the column's trailing rows (rows >= k and dead rows) from
// the registers `col`, v into vbuf and beta into *beta_out, and R_kk
// into the column's register for row k.
template <int kR>
__device__ inline void pivot(double (&col)[kR], int k, unsigned dmask, int lane,
                             double* vbuf, double* beta_out) {
  double ss = 0.0, mine = 0.0;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = lane + 32 * r;
    const double x = i >= k || (dmask >> r & 1u) ? col[r] : 0.0;
    ss = fma(x, x, ss);
    if (i == k) mine = col[r];
  }
  ss = warp_allsum(ss);
  const Reflector h = reflector(ss, __shfl_sync(kFull, mine, k % 32));
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = lane + 32 * r;
    const bool trailing = i >= k || (dmask >> r & 1u);
    vbuf[i] = i == k ? h.vk : trailing ? col[r] : 0.0;
    if (i == k) col[r] = h.alpha;
  }
  if (lane == 0) *beta_out = h.beta;
}

template <int kWarps, int kR, int kC>
__global__ void __launch_bounds__(kWarps * 32, 1)
qr_r_reg_kernel(const double* __restrict__ A, double* __restrict__ R, int m, int n) {
  constexpr int kThreads = kWarps * 32;
  constexpr int kRows = 32 * kR;
  extern __shared__ __align__(16) double smem[];
  const int ldn = n | 1;
  double* buf = smem;                      // 32 rows at stride ldn
  double* vbuf = buf + 32 * ldn;           // v, twice (kRows each)
  double* sbeta = vbuf + 2 * kRows;        // beta, twice
  int* dead = reinterpret_cast<int*>(sbeta + 2);
  const long long node = blockIdx.x;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const double* Ab = A + node * m * n;

  // a[c][r]: row lane + 32 r, column warp + kWarps c (zero past m or n)
  double a[kC][kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int rows = min(32, m - 32 * r);
    if (rows > 0) {
      for (int idx = t; idx < rows * n; idx += kThreads) {
        const int ii = idx / n;
        buf[ii * ldn + idx - ii * n] = Ab[(size_t)32 * r * n + idx];
      }
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int j = warp + kWarps * c;
      a[c][r] = lane < rows && j < n ? buf[lane * ldn + j] : 0.0;
    }
    __syncthreads();
  }
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    double s = 0.0;
#pragma unroll
    for (int r = 0; r < kR; ++r) s = fma(a[c][r], a[c][r], s);
    s = warp_allsum(s);
    const int j = warp + kWarps * c;
    if (lane == 0 && j < n) dead[j] = s == 0.0;
  }
  __syncthreads();
  unsigned dmask = 0;                      // this lane's dead rows
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = lane + 32 * r;
    if (i < n && dead[i]) dmask |= 1u << r;
  }

  int p = 0;                               // the buffer of the next reflector
  if (!dead[0] && warp == 0) pivot<kR>(a[0], 0, dmask, lane, vbuf, sbeta);
  __syncthreads();
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    for (int w0 = 0; w0 < kWarps; ++w0) {
      const int k = c * kWarps + w0;
      if (k >= n) break;
      if (!dead[k]) {
        // apply reflector k to this warp's columns j > k
        const double beta = sbeta[p];
        double v[kR];
        unsigned vmask = 0;
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          v[r] = vbuf[p * kRows + lane + 32 * r];
          if (__any_sync(kFull, v[r] != 0.0)) vmask |= 1u << r;
        }
        double s[kC];
#pragma unroll
        for (int cc = 0; cc < kC; ++cc) {
          s[cc] = 0.0;
          if (warp + kWarps * cc > k) {
#pragma unroll
            for (int r = 0; r < kR; ++r)
              if (vmask >> r & 1u) s[cc] = fma(v[r], a[cc][r], s[cc]);
          }
        }
#pragma unroll
        for (int cc = 0; cc < kC; ++cc)
          if (warp + kWarps * cc > k) s[cc] = warp_allsum(s[cc]);
#pragma unroll
        for (int cc = 0; cc < kC; ++cc) {
          if (warp + kWarps * cc > k) {
#pragma unroll
            for (int r = 0; r < kR; ++r)
              if (vmask >> r & 1u) a[cc][r] -= (beta * v[r]) * s[cc];
          }
        }
        p ^= 1;
      }
      // the next pivot, by its owner, from its updated column
      const int k1 = k + 1;
      if (k1 < n && !dead[k1]) {
        if (warp == k1 % kWarps) {
          double* vb = vbuf + p * kRows;
          if (w0 + 1 < kWarps) pivot<kR>(a[c], k1, dmask, lane, vb, sbeta + p);
          else if (c + 1 < kC) pivot<kR>(a[c + 1 < kC ? c + 1 : c], k1, dmask, lane, vb,
                                         sbeta + p);
        }
        __syncthreads();
      }
    }
  }

  // R, 32 rows at a time through the staging buffer
  double* Rb = R + node * n * n;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int rows = min(32, n - 32 * r);
    if (rows > 0) {
      __syncthreads();
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int j = warp + kWarps * c;
        if (j < n) buf[lane * ldn + j] = a[c][r];
      }
      __syncthreads();
      for (int idx = t; idx < rows * n; idx += kThreads) {
        const int ii = idx / n, j = idx - ii * n, i = 32 * r + ii;
        Rb[(size_t)i * n + j] = r_entry(i, j, dead[i], buf[ii * ldn + j]);
      }
    }
  }
}

// The register tile compiled: kRegWarps warps of kRegRows x kRegCols
// slots hold m <= 32 kRegRows rows and n <= kRegWarps kRegCols columns.
// It takes the (24, 36) interior tet class (132 x 73), where it beats
// qr_r_kernel on the card; under kQrNarrow columns qr_r_kernel's 256
// threads were faster (at the (12, 24) Neumann class, 108 x 37, against
// this tile and an 8-warp one of 4 x 5 slots), and a tile of 7 row slots
// spills.  Other classes take qr_r_kernel.
constexpr int kRegWarps = 16, kRegRows = 5, kRegCols = 5;

// Whether the register tile takes an m x n node.
inline bool reg_tile(int m, int n) {
  return n >= kQrNarrow && m <= 32 * kRegRows && n <= kRegWarps * kRegCols;
}

__device__ inline double pivot_value(const double* Rb, int k, int n, double tiny) {
  const double d = Rb[(size_t)k * n + k];
  return fabs(d) < tiny ? 1.0 : d;
}

// sne_solve's body 1: one block a node, R read from device memory.
__global__ void __launch_bounds__(kSolveThreads)
sne_solve_kernel(const double* __restrict__ R, const double* __restrict__ b,
                 double* __restrict__ y, int n, double tiny) {
  extern __shared__ __align__(16) double sv[];
  double* c = sv;        // forward: the running b; backward: y
  double* z = sv + n;    // forward: z; backward: the running z
  const long long node = blockIdx.x;
  const double* Rb = R + node * n * n;
  const int t = threadIdx.x;
  for (int i = t; i < n; i += kSolveThreads) c[i] = b[node * n + i];
  __syncthreads();
  // R^T z = b: z_k = c_k / R_kk, then c_i -= R[k][i] z_k for i > k
  for (int k = 0; k < n; ++k) {
    const double zk = c[k] / pivot_value(Rb, k, n, tiny);
    if (t == 0) z[k] = zk;
    const double* row = Rb + (size_t)k * n;
    for (int i = k + 1 + t; i < n; i += kSolveThreads) c[i] -= row[i] * zk;
    __syncthreads();
  }
  // R y = z: y_k = z_k / R_kk, then z_i -= R[i][k] y_k for i < k
  for (int k = n - 1; k >= 0; --k) {
    const double yk = z[k] / pivot_value(Rb, k, n, tiny);
    if (t == 0) c[k] = yk;
    for (int i = t; i < k; i += kSolveThreads) z[i] -= Rb[(size_t)i * n + k] * yk;
    __syncthreads();
  }
  for (int i = t; i < n; i += kSolveThreads) y[node * n + i] = c[i];
}

// ---- sne_solve's body 2: a warp a node on its staged triangle

// Doubles of a node's packed upper triangle: row i holds columns i..n-1
// from tri_row(i, n) on, so entry (i, j) lies at tri_row(i, n) + j - i.
__host__ __device__ inline long long tri_doubles(int n) { return (long long)n * (n + 1) / 2; }
__host__ __device__ inline int tri_row(int i, int n) { return i * n - i * (i - 1) / 2; }

// Nodes (warps) a block of body 2 holds at most; fewer where their
// triangles would pass the shared memory a block may use.
constexpr int kSneWarps = 2;
constexpr int kSneMaxSlots = 8;   // rows a lane owns at most: n <= 256

// One warp solves one node.  Lane l owns rows i = l + 32 s (s < kS): the
// running right-hand side, then z, then y, in registers x[s].  The node's
// upper triangle is staged once into shared memory with asynchronous
// copies (coalesced: the lanes walk the packed entries in order), and
// each lane's clamped pivots are inverted once.  Forward step k: the
// owner of row k forms z_k = c_k / R_kk (times the inverted pivot), a
// shuffle hands it to every lane, and each lane takes R[k][i] z_k from
// its rows i > k, reading row k of the triangle (consecutive entries
// across the lanes).  Backward step k the same with y_k and column k of
// rows i < k.  Each step's shared loads are issued a step ahead: their
// addresses do not depend on z.  The 2n steps need no block barrier.
template <int kS>
__global__ void __launch_bounds__(32 * kSneWarps)
sne_solve_warp_kernel(const double* __restrict__ R, const double* __restrict__ b,
                      double* __restrict__ y, int B, int n, double tiny) {
  extern __shared__ __align__(16) double smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long node = (long long)blockIdx.x * (blockDim.x / 32) + warp;
  if (node >= B) return;   // the ragged last block: no block barrier follows
  double* tri = smem + (size_t)warp * tri_doubles(n);
  const double* Rb = R + node * n * n;
  {
    const int count = (int)tri_doubles(n);
    int i = 0, j = lane;   // entry p = lane of the packed triangle
    while (j >= n && i < n) { ++i; j += i - n; }
    for (int p = lane; p < count; p += 32) {
      __pipeline_memcpy_async(tri + p, Rb + (size_t)i * n + j, sizeof(double));
      j += 32;
      while (j >= n && i < n) { ++i; j += i - n; }
    }
    __pipeline_commit();
  }
  double x[kS], rinv[kS];
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    const int i = lane + 32 * s;
    x[s] = i < n ? b[node * n + i] : 0.0;
  }
  __pipeline_wait_prior(0);
  __syncwarp();
  int coff[kS];   // column k of row i (i <= k) lies at coff + k
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    const int i = lane + 32 * s;
    const double d = i < n ? tri[tri_row(i, n)] : 1.0;
    rinv[s] = fabs(d) < tiny ? 1.0 : 1.0 / d;
    coff[s] = i < n ? tri_row(i, n) - i : 0;
  }
  double v[kS];   // this lane's entries of the step's row (or column)
  // R^T z = b: row k at rk + i, rk = tri_row(k, n) - k
  int rk = 0;
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    const int i = lane + 32 * s;
    v[s] = i > 0 && i < n ? tri[i] : 0.0;
  }
#pragma unroll
  for (int r = 0; r < kS; ++r) {
    const int kend = min(32, n - 32 * r);
    for (int kk = 0; kk < kend; ++kk) {
      const int k = 32 * r + kk;
      const double zk = __shfl_sync(kFull, x[r] * rinv[r], kk);
      const int rn = rk + n - k - 1;
      double vn[kS];
#pragma unroll
      for (int s = r; s < kS; ++s) {
        const int i = lane + 32 * s;
        vn[s] = i > k + 1 && i < n ? tri[rn + i] : 0.0;
      }
      if (lane == kk) x[r] = zk;
#pragma unroll
      for (int s = r; s < kS; ++s) {
        if (lane + 32 * s > k) x[s] = fma(-v[s], zk, x[s]);
        v[s] = vn[s];
      }
      rk = rn;
    }
  }
  // R y = z: column k of row i at coff + k
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    const int i = lane + 32 * s;
    v[s] = i < n - 1 ? tri[coff[s] + n - 1] : 0.0;
  }
#pragma unroll
  for (int r = kS - 1; r >= 0; --r) {
    for (int kk = min(32, n - 32 * r) - 1; kk >= 0; --kk) {
      const int k = 32 * r + kk;
      const double yk = __shfl_sync(kFull, x[r] * rinv[r], kk);
      double vn[kS];
#pragma unroll
      for (int s = 0; s <= r; ++s) {
        const int i = lane + 32 * s;
        vn[s] = i < k - 1 ? tri[coff[s] + k - 1] : 0.0;
      }
      if (lane == kk) x[r] = yk;
#pragma unroll
      for (int s = 0; s <= r; ++s) {
        if (lane + 32 * s < k) x[s] = fma(-v[s], yk, x[s]);
        v[s] = vn[s];
      }
    }
  }
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    const int i = lane + 32 * s;
    if (i < n) y[node * n + i] = x[s];
  }
}

int smem_optin() {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return optin;
}

// Whether qr_r_kernel keeps A in shared memory (else in the workspace).
bool qr_fits(int m, int n) {
  return qr_small_bytes(n) + sizeof(double) * qr_a_doubles(m, n) <= (size_t)smem_optin();
}

// A qr_r body's kernel, threads and dynamic shared memory for an m x n
// node: path 1 is qr_r_kernel (A in the workspace when `workspace`),
// path 2 the register tile.
struct QrLaunch {
  const void* kernel;
  int threads;
  size_t smem;
};

template <int kThreads>
QrLaunch shared_launch(int m, int n, bool workspace) {
  if (workspace) return {(const void*)qr_r_kernel<kThreads, true>, kThreads, qr_small_bytes(n)};
  return {(const void*)qr_r_kernel<kThreads, false>, kThreads,
          qr_small_bytes(n) + sizeof(double) * qr_a_doubles(m, n)};
}

QrLaunch qr_launch_of(int m, int n, int path, bool workspace) {
  if (path == 2) {
    if (!reg_tile(m, n)) return {nullptr, 0, 0};
    return {(const void*)qr_r_reg_kernel<kRegWarps, kRegRows, kRegCols>, kRegWarps * 32,
            qr_reg_smem_bytes(n, 32 * kRegRows)};
  }
  return n < kQrNarrow ? shared_launch<256>(m, n, workspace)
                       : shared_launch<kQrMaxThreads>(m, n, workspace);
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  if (bytes > (size_t)smem_optin()) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// sne_solve's bodies: the warp body's instance for n (kS = ceil(n / 32)
// rows a lane), and a body's kernel, threads and dynamic shared memory.
using SneWarpKernel = void (*)(const double*, const double*, double*, int, int, double);

SneWarpKernel sne_warp_kernel(int n) {
  switch ((n + 31) / 32) {
    case 1: return sne_solve_warp_kernel<1>;
    case 2: return sne_solve_warp_kernel<2>;
    case 3: return sne_solve_warp_kernel<3>;
    case 4: return sne_solve_warp_kernel<4>;
    case 5: return sne_solve_warp_kernel<5>;
    case 6: return sne_solve_warp_kernel<6>;
    case 7: return sne_solve_warp_kernel<7>;
    case 8: return sne_solve_warp_kernel<8>;
    default: return nullptr;
  }
}

// Whether one node's triangle fits in the shared memory a block may use.
bool sne_fits(int n) {
  return sizeof(double) * (size_t)tri_doubles(n) <= (size_t)smem_optin();
}

struct SneLaunch {
  const void* kernel;
  int threads;
  size_t smem;
};

SneLaunch sne_launch_of(int n, int path) {
  if (path == 1)
    return {(const void*)sne_solve_kernel, kSolveThreads, sizeof(double) * 2 * (size_t)n};
  const SneWarpKernel kernel = sne_warp_kernel(n);
  if (kernel == nullptr || !sne_fits(n)) return {nullptr, 0, 0};
  const size_t node_bytes = sizeof(double) * (size_t)tri_doubles(n);
  const size_t fit = (size_t)smem_optin() / node_bytes;
  const int warps = fit < (size_t)kSneWarps ? (int)fit : kSneWarps;
  return {(const void*)kernel, 32 * warps, node_bytes * warps};
}

// A launch's dynamic shared memory, threads, the blocks an SM holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), and the kernel's
// registers a thread and local memory bytes a thread (spills); returns
// the cudaError_t.
int occupancy_of(const void* kernel, int threads, size_t smem, long long* smem_bytes,
                 int* threads_out, int* blocks_per_sm, int* regs, long long* local_bytes) {
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  *smem_bytes = (long long)smem;
  *threads_out = threads;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (long long)attr.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, threads,
                                                            smem);
}

}  // namespace

// The body qr_r takes by default for an m x n node: 2, the register tile,
// where it takes the node; else 1, qr_r_kernel.
extern "C" int qr_r_path(int m, int n) { return reg_tile(m, n) ? 2 : 1; }

// Doubles of device workspace per node that qr_r_kernel (path 1) needs
// when the node's A does not fit in shared memory; 0 when it fits.
extern "C" long long qr_r_workspace_doubles(int m, int n) {
  return qr_fits(m, n) ? 0 : (long long)qr_a_doubles(m, n);
}

// The launch of qr_r's body `path` (0: the default) on an m x n node, as
// occupancy_of gives it.
extern "C" int qr_r_occupancy(int m, int n, int path, long long* smem_bytes,
                              int* threads, int* blocks_per_sm, int* regs,
                              long long* local_bytes) {
  if (path == 0) path = qr_r_path(m, n);
  const QrLaunch l = qr_launch_of(m, n, path, path == 1 && !qr_fits(m, n));
  return occupancy_of(l.kernel, l.threads, l.smem, smem_bytes, threads, blocks_per_sm, regs,
                      local_bytes);
}

// R (B, n, n) of [A; diag(dead)] for A (B, m, n), m >= n, by body `path`
// (0: the default, 1: qr_r_kernel, 2: the register tile); ws, when not
// null, holds qr_r_workspace_doubles(m, n) doubles a node for path 1.
extern "C" int qr_r_launch(const double* A, double* R, double* ws, int B, int m, int n,
                           int path, void* stream) {
  if (B <= 0 || m <= 0 || n <= 0 || m < n || path < 0 || path > 2)
    return (int)cudaErrorInvalidValue;
  if (path == 0) path = qr_r_path(m, n);
  const QrLaunch l = qr_launch_of(m, n, path, ws != nullptr);
  if (l.kernel == nullptr || (path == 2 && ws != nullptr)) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem(l.kernel, l.smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (path == 2) {
    qr_r_reg_kernel<kRegWarps, kRegRows, kRegCols><<<B, l.threads, l.smem, s>>>(A, R, m, n);
  } else if (l.threads == 256) {
    if (ws) qr_r_kernel<256, true><<<B, 256, l.smem, s>>>(A, R, ws, m, n);
    else qr_r_kernel<256, false><<<B, 256, l.smem, s>>>(A, R, ws, m, n);
  } else {
    if (ws) qr_r_kernel<kQrMaxThreads, true><<<B, kQrMaxThreads, l.smem, s>>>(A, R, ws, m, n);
    else qr_r_kernel<kQrMaxThreads, false><<<B, kQrMaxThreads, l.smem, s>>>(A, R, ws, m, n);
  }
  return (int)cudaGetLastError();
}

// The body sne_solve takes by default at width n: 2, a warp a node on its
// staged triangle, where the triangle fits in the shared memory a block
// may use (n <= 240 on an H100); else 1, sne_solve_kernel, which reads R
// from device memory.
extern "C" int sne_solve_path(int n) {
  return n <= 32 * kSneMaxSlots && sne_fits(n) ? 2 : 1;
}

// As qr_r_occupancy, for sne_solve's body `path` (0: the default) at
// width n.
extern "C" int sne_solve_occupancy(int n, int path, long long* smem_bytes, int* threads,
                                   int* blocks_per_sm, int* regs, long long* local_bytes) {
  if (n <= 0 || path < 0 || path > 2) return (int)cudaErrorInvalidValue;
  const SneLaunch l = sne_launch_of(n, path == 0 ? sne_solve_path(n) : path);
  return occupancy_of(l.kernel, l.threads, l.smem, smem_bytes, threads, blocks_per_sm, regs,
                      local_bytes);
}

// y (B, n) with R^T R y = b for R (B, n, n), b (B, n), by body `path`
// (0: the default, 1: sne_solve_kernel, 2: the warp body).
extern "C" int sne_solve_path_launch(const double* R, const double* b, double* y, int B,
                                     int n, double tiny, int path, void* stream) {
  if (B <= 0 || n <= 0 || path < 0 || path > 2) return (int)cudaErrorInvalidValue;
  if (path == 0) path = sne_solve_path(n);
  const SneLaunch l = sne_launch_of(n, path);
  if (l.kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem(l.kernel, l.smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (path == 1) {
    sne_solve_kernel<<<B, kSolveThreads, l.smem, s>>>(R, b, y, n, tiny);
  } else {
    const int warps = l.threads / 32;
    const SneWarpKernel kernel = sne_warp_kernel(n);
    kernel<<<(B + warps - 1) / warps, l.threads, l.smem, s>>>(R, b, y, B, n, tiny);
  }
  return (int)cudaGetLastError();
}

// sne_solve by its default body.
extern "C" int sne_solve_launch(const double* R, const double* b, double* y, int B,
                                int n, double tiny, void* stream) {
  return sne_solve_path_launch(R, b, y, B, n, tiny, 0, stream);
}
