/*
 * The GLS face table for NVIDIA Hopper (sm_90a): one float64 row of 14
 * columns per face, which the stencil gathers of every GLS route read.
 * ninpol_tpu_torch/ops/face_table.py holds the contract, the wrapper and
 * the plain PyTorch version.  No TPU kernel is replaced: ninpol_tpu builds
 * the table with numpy on the host and uploads it, which the port did too
 * until the build, a few seconds of host time, and its upload dominated a
 * rebuild of the weights after a new permeability field.  Here the face
 * geometry stays on the card from the mesh's load, and each rebuild uploads
 * only the per-cell K and diff_mag and the per-point Neumann values.
 *
 * Row f: [0:3] the normal N and [3:6] the centre (copied from geo),
 *   [6:9] K1 N and [9:12] K2 N for the face's cells c1 = pair[f][0] and
 *   c2 = pair[f][1] (c1 where c2 < 0, a boundary face), K[i][j] =
 *   perm[9 c + 3 i + j], (K N)_i = (K_i0 N_0 + K_i1 N_1) + K_i2 N_2;
 *   [12] eta = max(diff_mag[c1], diff_mag[c2]) (NaN if either is);
 *   [13] the mean of neumann[p] over the face's points p = inpofa[f][j]
 *   >= 0, summed in column order, divided by max(count, 1).
 * Every product, sum and quotient is rounded once and none is contracted
 * into an FMA, so the kernel gives its plain version's table bit for bit.
 *
 * Bound by memory on an H100: ~30 FLOP a face against 184 B of the face's
 * own (geometry 48, pair 8, inpofa 16 read; the row's 112 written) and
 * each cell's K and diff_mag (80 B) and point's Neumann value (8 B) read
 * once: 0.85 GB, 0.25 ms at 3.35 TB/s on tetra_mesh(68) (3.8 M faces).
 * A thread gathers two K rows and up to four values, 376 B a face; the
 * faces of one cell lie close in the table, so L1 and L2 serve most of
 * those gathers.  The design keeps the card's memory busy and every
 * write whole:
 *   - one thread a face, 256 faces a block, the blocks the card holds at
 *     once walking the faces in tiles of 256 (a grid-stride loop): at 60
 *     registers four blocks an SM, 1,024 threads with their gathers in
 *     flight;
 *   - the inputs are read-only for the kernel's life (__ldg: the
 *     non-coherent read-only path);
 *   - a thread writes its row into shared memory as seven 16-byte stores
 *     at a 112-byte stride (eight lanes of a quarter-warp fall on eight
 *     disjoint groups of four banks: no conflict); after a barrier the
 *     block copies its tile, which is contiguous in the table (256 x 112
 *     bytes), with 16-byte stores of consecutive addresses, so every
 *     sector of the table is written once and whole.
 */
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;        // faces a tile, threads a block
constexpr int kCols = 14;            // doubles a row
constexpr int kPairs = kCols / 2;    // 16-byte pieces a row

// K N for the 3 x 3 row-major K at perm + 9 c, each product and sum
// rounded once
__device__ __forceinline__ void k_times_n(const double* __restrict__ perm, int c,
                                          const double* n, double* out) {
  const double* k = perm + 9LL * c;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    out[i] = __dadd_rn(__dadd_rn(__dmul_rn(__ldg(k + 3 * i), n[0]),
                                 __dmul_rn(__ldg(k + 3 * i + 1), n[1])),
                       __dmul_rn(__ldg(k + 3 * i + 2), n[2]));
  }
}

__global__ void __launch_bounds__(kThreads)
face_table_kernel(const double* __restrict__ geo, const int* __restrict__ pair,
                  const int* __restrict__ inpofa, int width,
                  const double* __restrict__ perm, const double* __restrict__ diff_mag,
                  const double* __restrict__ neumann, double* __restrict__ out,
                  long long n_faces) {
  __shared__ double2 tile[kThreads * kPairs];
  for (long long base = (long long)blockIdx.x * kThreads; base < n_faces;
       base += (long long)gridDim.x * kThreads) {
    const long long f = base + threadIdx.x;
    if (f < n_faces) {
      double r[kCols];
#pragma unroll
      for (int j = 0; j < 6; ++j) r[j] = __ldg(geo + 6 * f + j);
      int c1 = __ldg(pair + 2 * f);
      int c2 = __ldg(pair + 2 * f + 1);
      c1 = c1 < 0 ? 0 : c1;
      c2 = c2 < 0 ? c1 : c2;
      k_times_n(perm, c1, r, r + 6);
      k_times_n(perm, c2, r, r + 9);
      const double e1 = __ldg(diff_mag + c1), e2 = __ldg(diff_mag + c2);
      r[12] = (e1 != e1 || e1 > e2) ? e1 : e2;
      double sum = 0.0;
      int count = 0;
      for (int j = 0; j < width; ++j) {
        const int p = __ldg(inpofa + width * f + j);
        double v = 0.0;
        if (p >= 0) {
          v = __ldg(neumann + p);
          ++count;
        }
        sum = j == 0 ? v : __dadd_rn(sum, v);
      }
      r[13] = __ddiv_rn(sum, (double)(count > 1 ? count : 1));
      double2* row = tile + kPairs * threadIdx.x;
#pragma unroll
      for (int j = 0; j < kPairs; ++j) row[j] = double2{r[2 * j], r[2 * j + 1]};
    }
    __syncthreads();
    const long long left = n_faces - base;
    const int pieces = (left < kThreads ? (int)left : kThreads) * kPairs;
    double2* dst = reinterpret_cast<double2*>(out + kCols * base);
    for (int i = threadIdx.x; i < pieces; i += kThreads) dst[i] = tile[i];
    __syncthreads();
  }
}

// Blocks of the launch: the tiles, at most as many blocks as the card
// holds at once
cudaError_t grid_of(long long n_faces, int* blocks) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, face_table_kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  const long long tiles = (n_faces + kThreads - 1) / kThreads;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  *blocks = (int)(tiles < resident ? tiles : resident);
  return cudaSuccess;
}

}  // namespace

// The launch's occupancy: its dynamic shared memory bytes (0: the tile is
// static), threads, blocks an SM holds, registers a thread and local
// memory bytes a thread (spills).
extern "C" int face_table_occupancy(long long* smem_bytes, int* threads, int* blocks_per_sm,
                                    int* regs, long long* local_bytes) {
  *smem_bytes = 0;
  *threads = kThreads;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, face_table_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (long long)attr.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, face_table_kernel,
                                                            kThreads, 0);
}

// The table out (n_faces, 14) of geo (n_faces, 6), pair (n_faces, 2),
// inpofa (n_faces, width), perm (n_cells * 9), diff_mag (n_cells) and
// neumann (n_points); out 16-byte aligned.
extern "C" int face_table_launch(const double* geo, const int* pair, const int* inpofa,
                                 int width, const double* perm, const double* diff_mag,
                                 const double* neumann, double* out, long long n_faces,
                                 void* stream) {
  if (n_faces < 0 || width <= 0) return (int)cudaErrorInvalidValue;
  if (n_faces == 0) return (int)cudaSuccess;
  int blocks = 0;
  cudaError_t err = grid_of(n_faces, &blocks);
  if (err != cudaSuccess) return (int)err;
  face_table_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      geo, pair, inpofa, width, perm, diff_mag, neumann, out, n_faces);
  return (int)cudaGetLastError();
}
