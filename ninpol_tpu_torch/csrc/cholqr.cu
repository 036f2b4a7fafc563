/*
 * The pieces of the unfused shifted-CholeskyQR2 preconditioner for NVIDIA
 * Hopper (sm_90a): four batched per-node float32 kernels, one thread block
 * per node.  ninpol_tpu_torch/ops/cholqr.py holds the contracts, the
 * wrappers and the plain PyTorch versions.  Every product is a chain of
 * float32 FMAs on the CUDA cores: no TF32 tensor-core path, because the
 * preconditioner relies on Gram products accurate to ~eps32.
 *
 * gram_kernel replaces ninpol_tpu/ops/pallas_chol.py::gram_f32
 *   (_gram_kernel): G = A^T A.  Bound by memory on an H100: an interior
 *   node (m = 132, n = 73) reads 38.5 KB and writes 21.3 KB for 0.71 MFLOP
 *   (12 FLOP/byte, under the ~20 FLOP/byte at which FP32 FMAs would
 *   bound it).  A is streamed through shared memory kRows rows at a time
 *   with coalesced loads, at a row stride padded to 4 floats; each thread
 *   owns 4 x 4 tiles of the upper triangle and accumulates a tile over a
 *   chunk in registers (8 shared-memory loads per 16 FMAs; one load per
 *   FMA would make shared memory the limit); the mirrored matrix is
 *   written once.
 *
 * round2_gram_kernel replaces pallas_chol.py::round2_gram_f32
 *   (_round2_kernel): G = (A Li^T)^T (A Li^T).  Li^T stays in shared
 *   memory; each chunk of kRows rows of A becomes kRows rows of Q in
 *   shared memory (4 x 4 register tiles again) and is folded into the Gram
 *   accumulators at once, so Q never reaches device memory (the point of
 *   the TPU kernel).  A and Li read, G written: 81 KB per interior node
 *   for ~2.1 MFLOP (Q as a full product, the Gram on its upper
 *   triangle), so FP32 operations bound it, narrowly.
 *
 * chol_linv_kernel replaces pallas_chol.py::chol_linv_f32 (_chol_kernel):
 *   a right-looking Cholesky elimination with each pivot clamped,
 *   dinv = rsqrt(max(pivot, tiny)), and row k of L^-1 (or of L^-1 P)
 *   formed at step k as (base - sum_{j<k} L[k,j] Li[j,:]) * dinv.  G and
 *   the output rows sit in shared memory (42.6 KB at n = 73).  Only the
 *   lower half of the trailing update is computed: it is all the
 *   elimination reads, so the result equals the TPU kernel's full update.
 *   Column k of L is stored transposed into the dead upper half of row k,
 *   so the column scaling, the trailing update (one column a thread) and
 *   the output row (one column a thread, on other warps) run in one phase
 *   with one barrier per pivot.  Bound by memory (G read, the output
 *   written: 42.6 KB per node at n = 73) but limited in practice by
 *   instruction issue and latency: n dependent steps of short loops.
 *
 * prec_apply_kernel replaces pallas_chol.py::prec_apply_f32
 *   (_prec_apply_kernel): o = Lc^T (Lc v).  Bound by memory (the factor
 *   is read once: 21.3 KB per node at n = 73 for 21.3 kFLOP).  Lc is
 *   staged in shared memory with coalesced loads, u = Lc v runs one warp
 *   per row with a shuffle reduction, and o = Lc^T u one thread per column
 *   over conflict-free shared-memory rows.
 *
 * The device code of these stages lives in cholqr_device.cuh, which the
 * fused solve (gls_solve.cu) runs too.  Each launch function returns a
 * cudaError_t as int (0 on success); a node too wide for shared memory
 * returns cudaErrorInvalidValue.
 */
#include <cuda_runtime.h>
#include <math.h>

#include "cholqr_device.cuh"

namespace {

using namespace cholqr_device;

constexpr int kThreads = 256;
constexpr int kRows = 32;   // rows of A staged per pass (gram, round2)

// Write the upper triangle of g (stride np) to out (n x n) as a full
// symmetric matrix.
__device__ void store_symmetric(const float* g, float* out, int n, int np) {
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    const int i = idx / n, j = idx - i * n;
    out[idx] = i <= j ? g[i * np + j] : g[j * np + i];
  }
}

__device__ void load(const float* src, float* dst, int count) {
  for (int idx = threadIdx.x; idx < count; idx += blockDim.x) dst[idx] = src[idx];
}

__device__ void fill_zero(float* dst, int count) {
  for (int idx = threadIdx.x; idx < count; idx += blockDim.x) dst[idx] = 0.f;
}

// Rows [r0, r0 + rows) of the node's A (n columns) into a (stride np);
// the pad columns of a are zero from the start and never written here.
__device__ void load_rows(const float* Ab, float* a, int r0, int rows, int n,
                          int np) {
  for (int idx = threadIdx.x; idx < rows * n; idx += blockDim.x) {
    const int r = idx / n, c = idx - r * n;
    a[r * np + c] = Ab[(long long)(r0 + r) * n + c];
  }
}

__global__ void __launch_bounds__(kThreads)
gram_kernel(const float* __restrict__ A, float* __restrict__ G, int m, int n) {
  extern __shared__ __align__(16) float smem[];
  const int np = padded(n);
  float* g = smem;                              // np x np accumulators
  float* a = g + np * np;                       // kRows x np rows of A
  const long long node = blockIdx.x;
  const float* Ab = A + node * m * n;
  fill_zero(g, np * np + kRows * np);
  for (int r0 = 0; r0 < m; r0 += kRows) {
    const int rows = min(kRows, m - r0);
    __syncthreads();          // zeroed, or the previous chunk is consumed
    load_rows(Ab, a, r0, rows, n, np);
    __syncthreads();
    gram_accumulate(a, g, rows, np);
  }
  __syncthreads();
  store_symmetric(g, G + node * n * n, n, np);
}

__global__ void __launch_bounds__(kThreads)
round2_gram_kernel(const float* __restrict__ A, const float* __restrict__ Li,
                   float* __restrict__ G, int m, int n) {
  extern __shared__ __align__(16) float smem[];
  const int np = padded(n), nt = np / kTile;
  float* lit = smem;                             // Li^T, np x np
  float* g = lit + np * np;                      // np x np accumulators
  float* a = g + np * np;                        // kRows x np rows of A
  float* q = a + kRows * np;                     // the same rows of Q = A Li^T
  const long long node = blockIdx.x;
  const float* Ab = A + node * m * n;
  const float* Lb = Li + node * n * n;
  // zero everything but the Li^T entries, which are written alongside
  for (int idx = threadIdx.x; idx < np * np; idx += blockDim.x) {
    const int j = idx / np, k = idx - j * np;
    if (j >= n || k >= n) lit[idx] = 0.f;
  }
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    const int k = idx / n, j = idx - k * n;
    lit[j * np + k] = Lb[idx];
  }
  fill_zero(g, np * np + 2 * kRows * np);
  for (int r0 = 0; r0 < m; r0 += kRows) {
    const int rows = min(kRows, m - r0);
    __syncthreads();          // staged and zeroed, or the chunk is consumed
    load_rows(Ab, a, r0, rows, n, np);
    __syncthreads();
    // q[r][k] = sum_j a[r][j] Li[k][j], j in order, a kTile x kTile tile
    // (rows rt, columns kt) a thread; pad columns of q come out zero
    const int rt_count = (rows + kTile - 1) / kTile;
    for (int t = threadIdx.x; t < rt_count * nt; t += blockDim.x) {
      const int r0t = (t / nt) * kTile, k0 = (t % nt) * kTile;
      float acc[kTile][kTile];
      q_tile(a, lit, r0t, k0, n, np, acc);
      store_tile(q, r0t, k0, rows, np, acc);
    }
    __syncthreads();
    gram_accumulate(q, g, rows, np);
  }
  __syncthreads();
  store_symmetric(g, G + node * n * n, n, np);
}

__global__ void __launch_bounds__(kThreads)
chol_linv_kernel(const float* __restrict__ G, const float* __restrict__ P,
                 float* __restrict__ out, int n, float tiny) {
  extern __shared__ __align__(16) float smem[];
  // s: G on entry, eliminated in place (chol_linv_rows); li: the rows of
  // L^-1 (or of L^-1 P)
  float* s = smem;
  float* li = s + n * n;
  const long long node = blockIdx.x;
  const float* Pb = P ? P + node * n * n : nullptr;
  load(G + node * n * n, s, n * n);
  chol_linv_rows(s, li, Pb, n, tiny);
  float* ob = out + node * n * n;
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) ob[idx] = li[idx];
}

constexpr int kApplyThreads = 128;

__global__ void __launch_bounds__(kApplyThreads)
prec_apply_kernel(const float* __restrict__ Lc, const float* __restrict__ v,
                  float* __restrict__ out, int n) {
  extern __shared__ __align__(16) float smem[];
  float* l = smem;            // n x n
  float* vs = l + n * n;      // n
  float* u = vs + n;          // n
  const long long node = blockIdx.x;
  load(Lc + node * n * n, l, n * n);
  load(v + node * n, vs, n);
  __syncthreads();
  rows_times(l, n, vs, u, n, false);
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += kApplyThreads)
    out[node * n + j] = col_times(l, n, u, j, n, false);
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

}  // namespace

extern "C" int gram_f32_launch(const float* A, float* G, int B, int m, int n,
                               void* stream) {
  if (B <= 0 || m <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const size_t np = padded(n);
  const size_t bytes = sizeof(float) * (np * np + kRows * np);
  cudaError_t err = prepare(gram_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  gram_kernel<<<B, kThreads, bytes, (cudaStream_t)stream>>>(A, G, m, n);
  return (int)cudaGetLastError();
}

extern "C" int round2_gram_f32_launch(const float* A, const float* Li, float* G,
                                      int B, int m, int n, void* stream) {
  if (B <= 0 || m <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const size_t np = padded(n);
  const size_t bytes = sizeof(float) * (2 * np * np + 2 * kRows * np);
  cudaError_t err = prepare(round2_gram_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  round2_gram_kernel<<<B, kThreads, bytes, (cudaStream_t)stream>>>(A, Li, G, m, n);
  return (int)cudaGetLastError();
}

extern "C" int chol_linv_f32_launch(const float* G, const float* P, float* out,
                                    int B, int n, float tiny, void* stream) {
  if (B <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const size_t bytes = sizeof(float) * 2 * (size_t)n * n;
  cudaError_t err = prepare(chol_linv_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  chol_linv_kernel<<<B, kThreads, bytes, (cudaStream_t)stream>>>(G, P, out, n, tiny);
  return (int)cudaGetLastError();
}

extern "C" int prec_apply_f32_launch(const float* Lc, const float* v, float* out,
                                     int B, int n, void* stream) {
  if (B <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const size_t bytes = sizeof(float) * ((size_t)n * n + 2 * (size_t)n);
  cudaError_t err = prepare(prec_apply_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  prec_apply_kernel<<<B, kApplyThreads, bytes, (cudaStream_t)stream>>>(Lc, v, out, n);
  return (int)cudaGetLastError();
}
