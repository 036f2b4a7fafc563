/*
 * The kernels of the corrected semi-normal equations (CSNE) GLS solve for
 * NVIDIA Hopper (sm_90a): two batched per-node float64 kernels, one thread
 * block per node.  ninpol_tpu_torch/ops/qr.py holds the contracts, the
 * wrappers and the plain PyTorch versions.  The TPU kernels they replace
 * work in double-float32 pairs only because the TPU emulates float64; the
 * H100 has native FP64 (34 TFLOP/s on the FP64 units, 67 TFLOP/s on the
 * tensor cores' DMMA), so these take and return float64.
 *
 * qr_r_kernel replaces ninpol_tpu/ops/pallas_qr.py::qr_r_df32
 *   (_qr_step_kernel): R of the Householder QR of A (m x n), with the TPU
 *   kernel's sign convention (R_kk = -||x|| where x_k >= 0) and
 *   beta = 2 / ||v||^2 (0 where v = 0).  Bound by memory on an H100: the
 *   route's A has its real rows plus one nonzero row per dead column, so
 *   the work a node needs is the QR of those rows, 2 m n^2 - 2/3 n^3 FLOP
 *   (~1.15 MFLOP for the interior class, 132 real rows, n = 73), against
 *   ~99 KB moved (those rows read, R's triangle written): ~12 FLOP/byte,
 *   under the ~20 where FP64 at the DMMA rate turns operation-bound.  The
 *   TPU kernel runs one column per sequential grid step over a
 *   VMEM-resident tile of 128 nodes; here a block of 512 threads (256 for
 *   nodes under kQrNarrow columns) keeps its node's whole A in shared
 *   memory (119.7 KB at 205 x 73, so one block an SM), column-major at an
 *   odd column stride, staged with four loads in flight a thread.  Per
 *   column k: w = v^T A[:, k+1:], each warp summing four columns at once
 *   over consecutive rows, then one shuffle reduction a column; then the
 *   rank-1 update of rows >= k, columns > k, one row a thread in each
 *   column group of kQrRowThreads threads, which also sums the squares of
 *   the next column, so the next reflector's norm needs no pass of its
 *   own: two barriers a column.  R_kk is set to the reflector's
 *   -sgn ||x|| and the rest of column k, below the diagonal, is left as it
 *   is (the TPU kernel updates it to rounding residue); R is written with
 *   its lower triangle zeroed.  Every column step reads and writes the
 *   trailing matrix in shared memory, so shared-memory bandwidth, not HBM
 *   or FP64, limits this unblocked form.
 *
 * sne_solve_kernel replaces pallas_qr.py::sne_solve_df32
 *   (_solve_step_kernel): y with R^T R y = b, forward substitution
 *   (R^T z = b) then backward (R y = z), every |R_kk| < tiny taken as
 *   exactly 1 in both.  Bound by memory: the triangle of R is read once,
 *   n (n + 1) / 2 doubles per node, for n^2 FMAs.  Column-oriented
 *   substitution with the running right-hand side in shared memory: once
 *   z_k is known, each thread subtracts its own entry's share, reading row k
 *   of R from device memory in one coalesced pass (forward) or its own row
 *   walking down the columns (backward, cached lines).  One barrier per
 *   step, 2n steps, each waiting on a load and a division: latency, not
 *   bytes, limits it.
 *
 * Each launch function returns a cudaError_t as int (0 on success); a node
 * too wide for shared memory returns cudaErrorInvalidValue.
 */
#include <cuda_runtime.h>
#include <math.h>

namespace {

// qr_r blocks: 512 threads, or 256 for a node under kQrNarrow columns,
// whose w pass and update leave most of 512 threads idle
constexpr int kQrMaxThreads = 512;
constexpr int kQrNarrow = 48;
constexpr int kQrMaxWarps = kQrMaxThreads / 32;
constexpr int kQrCols = 4;      // columns of w a warp sums at once
// the rank-1 update: rows on kQrRowThreads threads, and the columns
// interleaved over the block's kThreads / kQrRowThreads such groups
constexpr int kQrRowThreads = 256;
constexpr int kSolveThreads = 128;
constexpr int kLoads = 4;       // loads a thread keeps in flight when staging

// Column stride of the staged A: m rounded up to odd, so that a warp
// reading one row across 32 consecutive columns is free of bank conflicts
// (as is one reading 32 consecutive rows of a column).
__host__ __device__ inline int col_stride(int m) { return m | 1; }

__host__ __device__ inline size_t qr_smem_doubles(int m, int n) {
  return (size_t)col_stride(m) * n + n + kQrMaxWarps;
}

__device__ inline double warp_sum(double x) {
  for (int off = 16; off > 0; off /= 2) x += __shfl_down_sync(0xffffffffu, x, off);
  return x;   // the sum is in lane 0
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

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
qr_r_kernel(const double* __restrict__ A, double* __restrict__ R, int m, int n) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kColGroups = kThreads / kQrRowThreads;
  extern __shared__ __align__(16) double smem[];
  const int ld = col_stride(m);
  double* a = smem;                      // A column-major: a[j * ld + i]
  double* w = a + (size_t)ld * n;        // v^T A[:, j], j > k
  double* part = w + n;                  // per-warp sums of squares
  const long long node = blockIdx.x;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  stage_columns<kThreads>(A + node * m * n, a, m, n, ld);
  __syncthreads();
  double s = 0.0;                        // column 0's sum of squares
  for (int i = t; i < m; i += kThreads) s = fma(a[i], a[i], s);
  s = warp_sum(s);
  if (lane == 0) part[warp] = s;
  __syncthreads();
  // update threads: row offset r, column group g
  const int r = t % kQrRowThreads, g = t / kQrRowThreads;
  for (int k = 0; k < n; ++k) {
    // the reflector of x = a[k:, k], from the sum of squares of x
    double ss = 0.0;
    for (int p = 0; p < kWarps; ++p) ss += part[p];
    const double* col = a + (size_t)k * ld;
    const double xk = col[k];
    const double normx = sqrt(ss);
    const double alpha = xk >= 0.0 ? -normx : normx;
    const double vk = xk - alpha;        // v = x - alpha e_k
    const double vnorm2 = (ss - xk * xk) + vk * vk;
    const double beta = vnorm2 > 0.0 ? 2.0 / vnorm2 : 0.0;
    // w_j = v^T a[:, j] for j > k: a warp sums kQrCols columns at once,
    // lanes over consecutive rows, then one shuffle reduction a column
    for (int j0 = k + 1 + warp; j0 < n; j0 += kWarps * kQrCols) {
      double acc[kQrCols] = {};
      for (int i = k + lane; i < m; i += 32) {
        const double vi = i == k ? vk : col[i];
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
    // below the diagonal and is never read again
    if (t == 0) a[(size_t)k * ld + k] = alpha;
    // a[i, j] -= (beta v_i) w_j for rows i >= k, columns j > k: rows on
    // kQrRowThreads threads, columns interleaved over the kColGroups
    // groups; group 0 also sums the squares of the updated column k + 1
    // below its diagonal, for the next reflector
    double s_next = 0.0;
    for (int i = k + r; i < m; i += kQrRowThreads) {
      const double bvi = beta * (i == k ? vk : col[i]);
#pragma unroll 4
      for (int j = k + 1 + g; j < n; j += kColGroups) a[(size_t)j * ld + i] -= bvi * w[j];
      if (g == 0 && k + 1 < n && i > k) {
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
    Rb[idx] = i <= j ? a[(size_t)j * ld + i] : 0.0;
  }
}

__device__ inline double pivot(const double* Rb, int k, int n, double tiny) {
  const double d = Rb[(size_t)k * n + k];
  return fabs(d) < tiny ? 1.0 : d;
}

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
    const double zk = c[k] / pivot(Rb, k, n, tiny);
    if (t == 0) z[k] = zk;
    const double* row = Rb + (size_t)k * n;
    for (int i = k + 1 + t; i < n; i += kSolveThreads) c[i] -= row[i] * zk;
    __syncthreads();
  }
  // R y = z: y_k = z_k / R_kk, then z_i -= R[i][k] y_k for i < k
  for (int k = n - 1; k >= 0; --k) {
    const double yk = z[k] / pivot(Rb, k, n, tiny);
    if (t == 0) c[k] = yk;
    for (int i = t; i < k; i += kSolveThreads) z[i] -= Rb[(size_t)i * n + k] * yk;
    __syncthreads();
  }
  for (int i = t; i < n; i += kSolveThreads) y[node * n + i] = c[i];
}

// Set the kernel's dynamic shared memory and check it fits the device.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t bytes) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (bytes > (size_t)optin) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int kThreads>
cudaError_t launch_qr(const double* A, double* R, int B, int m, int n, size_t bytes,
                      void* stream) {
  cudaError_t err = prepare(qr_r_kernel<kThreads>, bytes);
  if (err != cudaSuccess) return err;
  qr_r_kernel<kThreads><<<B, kThreads, bytes, (cudaStream_t)stream>>>(A, R, m, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" long long qr_r_smem_bytes(int m, int n) {
  return (long long)(sizeof(double) * qr_smem_doubles(m, n));
}

extern "C" int qr_r_launch(const double* A, double* R, int B, int m, int n,
                           void* stream) {
  if (B <= 0 || m <= 0 || n <= 0 || m < n) return (int)cudaErrorInvalidValue;
  const size_t bytes = sizeof(double) * qr_smem_doubles(m, n);
  return n < kQrNarrow ? (int)launch_qr<256>(A, R, B, m, n, bytes, stream)
                       : (int)launch_qr<kQrMaxThreads>(A, R, B, m, n, bytes, stream);
}

extern "C" int sne_solve_launch(const double* R, const double* b, double* y, int B,
                                int n, double tiny, void* stream) {
  if (B <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const size_t bytes = sizeof(double) * 2 * (size_t)n;
  cudaError_t err = prepare(sne_solve_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  sne_solve_kernel<<<B, kSolveThreads, bytes, (cudaStream_t)stream>>>(R, b, y, n, tiny);
  return (int)cudaGetLastError();
}
