/*
 * The pieces of the unfused shifted-CholeskyQR2 preconditioner for NVIDIA
 * Hopper (sm_90a): four batched per-node float32 kernels, one thread block
 * per node.  ninpol_tpu_torch/ops/cholqr.py holds the contracts, the
 * wrappers and the plain PyTorch versions.  Every product is a chain of
 * float32 FMAs on the CUDA cores: no TF32 tensor-core path, because the
 * preconditioner relies on Gram products accurate to ~eps32.
 *
 * gram_reg_kernel and gram_kernel replace
 *   ninpol_tpu/ops/pallas_chol.py::gram_f32 (_gram_kernel): G = A^T A.
 *   Bound by memory on an H100: an interior node (m = 132, n = 73) reads
 *   38.5 KB and writes 21.3 KB for 0.71 MFLOP (12 FLOP/byte, under the
 *   ~20 FLOP/byte at which FP32 FMAs would bound it).  Each thread owns
 *   4 x 4 tiles of the upper triangle and sums a tile in registers (8
 *   shared-memory loads per 16 FMAs; one load per FMA would make shared
 *   memory the limit).
 *   Up to n = 76 (the tet classes) gram_reg_kernel, round2_gram_reg_kernel's
 *   Gram stage alone: one thread per upper tile (190 at n = 73, so 192
 *   threads; 55 at n = 37, so 64), its 16 sums in registers for all of m,
 *   so no Gram round trip through shared memory and nothing to zero; A
 *   staged row-major at a row stride padded to 4 floats, kRows rows at a
 *   time, by asynchronous copies into two buffers, so that chunk c + 1
 *   arrives while chunk c is folded (one barrier a chunk); G leaves
 *   through a symmetric tile in shared memory, row by row.  The limit is
 *   the block: its launch bounds fit 192 threads, 19 x 19 tiles.  Each
 *   entry sums its rows in order with FMAs, as gram_kernel does across
 *   its chunks, so the two bodies' G are equal bit for bit.
 *   Wider nodes (and the workspace) take gram_kernel: the Gram
 *   accumulators in shared memory, A streamed through it kRows rows at a
 *   time and folded by gram_accumulate; the mirrored matrix is written
 *   once.
 *
 * round2_gram_reg_kernel and round2_gram_kernel replace
 *   pallas_chol.py::round2_gram_f32 (_round2_kernel): G = (A Li^T)^T
 *   (A Li^T), Li lower triangular (the route's L1^-1).  Each chunk of rows
 *   of A becomes the same rows of Q in shared memory and is folded into
 *   the Gram at once, so Q never reaches device memory (the point of the
 *   TPU kernel).  A and Li read, G written: 81 KB per interior node
 *   (m = 132, n = 73) for 1.43 MFLOP counted on the triangles (Q's
 *   m n(n+1)/2 FMAs, the Gram's as many), 17.6 FLOP/byte: bound by memory
 *   on an H100, narrowly (0.79 ms a 32,768-node chunk against 0.70 ms of
 *   FP32 FMAs).  What holds a kernel back is shared-memory traffic and
 *   instruction issue, not the bytes.
 *   Up to n = 76 (the tet classes) round2_gram_reg_kernel: one thread per
 *   upper 4 x 4 tile of the Gram (190 at n = 73, so 192 threads), its
 *   sums in registers for all of m (no Gram round trip through shared
 *   memory); Q on the triangle only (a Q tile at columns k0..k0+3 sums
 *   j <= k0 + 3), in 2 x 4 tiles with column tile u paired with
 *   nt - 1 - u so that every thread's pair costs the same; A staged
 *   transposed by asynchronous copies that overlap the previous chunk's
 *   Gram, so a thread reads its two rows of a column as one float2.  One
 *   buffer each for A^T and Q (two barriers a chunk) keeps the block at
 *   46.2 KB, four blocks an SM; G leaves through a symmetric tile in shared
 *   memory, row by row (as gram_reg_kernel).  The sums run in the shared
 *   body's order, so G equals its G bit for bit.
 *   Wider nodes take round2_gram_kernel: Li^T and the Gram accumulators in
 *   shared memory (or the workspace), kRows rows of Q at a time in 4 x 4
 *   register tiles over all of j, folded by gram_accumulate.
 *
 * chol_linv_reg_kernel and chol_linv_kernel replace
 *   pallas_chol.py::chol_linv_f32 (_chol_kernel): a Cholesky elimination
 *   with each pivot clamped, dinv = rsqrt(max(pivot, tiny)), and L^-1 P
 *   (P lower triangular, the identity without mul_right) formed
 *   right-looking beside it: at pivot k row k of L^-1 P is final, and
 *   every later row takes its share at once.  Only the lower half of the
 *   trailing update counts: it is all the elimination reads, so the result
 *   equals the TPU kernel's full update up to rounding.  Bound by memory
 *   (G and P read, the output written: 42.6 KB per node at n = 73),
 *   limited in practice by instruction issue and latency: n dependent
 *   steps, one barrier each.
 *   Up to n = 80 (the tet classes) chol_linv_reg_kernel keeps G and
 *   L^-1 P in registers, 5 x 5 entries of each a thread on a 16 x 16
 *   grid: per pivot two shared-memory loads and one FMA an entry, three
 *   blocks an SM at 80 registers.
 *   Wider nodes take chol_linv_kernel, the fused kernel's factorization
 *   (chol_linv_rows_inplace) on G, L^-1 P and dinv in shared memory (or
 *   the workspace), every thread a slice of one column's rows at each
 *   pivot: an FMA there costs two loads and a store.
 *
 * prec_apply_warp_kernel and prec_apply_kernel replace
 *   pallas_chol.py::prec_apply_f32 (_prec_apply_kernel): o = Lc^T (Lc v),
 *   Lc lower triangular (the route's L2^-1 L1^-1): its upper triangle is
 *   not read.  Bound by memory: the triangle is read once, 10.8 KB per
 *   node at n = 73, for 10.8 kFMA.
 *   Up to n = 128 prec_apply_warp_kernel: one warp a node, kApplyWarps a
 *   block, no block barrier.  The warp stages its node's triangle, packed
 *   row by row, and v in its slice of shared memory by asynchronous copies
 *   issued back to back and waited once (at n = 73, 11.1 KB a node, so 20
 *   nodes in flight an SM).  Lane l owns rows and columns l + 32 s.  u =
 *   Lc v sums each lane's rows column by column: the lanes of a slot read
 *   32 consecutive rows at one column, at offsets i (i + 1) / 2 + j,
 *   which fall in 32 distinct banks.  o = Lc^T u hands u_i out by a
 *   shuffle and sums each lane's columns of row i, consecutive entries.
 *   Wider nodes (and the workspace) take prec_apply_kernel: the triangle
 *   staged in shared memory (at stride n) by the block, u = Lc v one warp
 *   a row with a shuffle reduction, o = Lc^T u one thread a column.
 *
 * The device code of these stages lives in cholqr_device.cuh, which the
 * fused solve (gls_solve.cu) runs too.  A node whose matrices do not fit
 * in the 227 KB of shared memory a block may use (n past ~152 for
 * round2_gram, ~170 for chol_linv, ~226 for gram, ~240 for prec_apply)
 * runs the same code on a per-node workspace in device memory, which the
 * wrapper allocates (``*_workspace_floats`` gives its size, 0 where the
 * node fits).  Each launch function returns a cudaError_t as int (0 on
 * success).
 */
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

#include "cholqr_device.cuh"

namespace {

using namespace cholqr_device;

constexpr int kThreads = 256;
constexpr int kApplyThreads = 128;
constexpr int kRows = 32;   // rows of A staged per pass (gram, round2)

// Floats a node's matrices take, shared memory or workspace, rounded up to
// whole tiles so that a node's workspace starts on a 16-byte boundary.
__host__ __device__ inline long long round_tile(long long f) {
  return (f + kTile - 1) / kTile * kTile;
}
__host__ __device__ inline long long gram_floats(int n) {
  const long long np = padded(n);
  return np * np + kRows * np;
}
__host__ __device__ inline long long round2_floats(int n) {
  const long long np = padded(n);
  return 2 * np * np + 2 * kRows * np;
}
__host__ __device__ inline long long chol_floats(int n) {
  return round_tile(2LL * n * n + n);
}
__host__ __device__ inline long long apply_floats(int n) {
  return round_tile((long long)n * n + 2LL * n);
}

// The node's matrices: the workspace's slice (kWs), else the block's
// shared memory.  A compile-time choice, so that the shared-memory
// instance addresses shared memory directly.
template <bool kWs>
__device__ inline float* node_base(float* smem, float* ws, long long floats) {
  return kWs ? ws + (long long)blockIdx.x * floats : smem;
}

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

template <bool kWs>
__global__ void __launch_bounds__(kThreads)
gram_kernel(const float* __restrict__ A, float* __restrict__ G, float* ws, int m,
            int n) {
  extern __shared__ __align__(16) float smem[];
  const int np = padded(n);
  float* g = node_base<kWs>(smem, ws, gram_floats(n));   // np x np accumulators
  float* a = g + np * np;                           // kRows x np rows of A
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

template <bool kWs>
__global__ void __launch_bounds__(kThreads)
round2_gram_kernel(const float* __restrict__ A, const float* __restrict__ Li,
                   float* __restrict__ G, float* ws, int m, int n) {
  extern __shared__ __align__(16) float smem[];
  const int np = padded(n), nt = np / kTile;
  float* lit = node_base<kWs>(smem, ws, round2_floats(n));   // Li^T, np x np
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

// ---- the register bodies of round2_gram and gram (path 2)
//
// One block a node, one thread per upper kTile x kTile tile of the Gram,
// whose sums stay in that thread's registers across all of m.  Rows of A
// arrive a chunk at a time by asynchronous copies.  round2_gram's body
// stages them transposed (A^T, so a thread reads its two rows of a column
// as one float2) and overlaps them with the Gram of the chunk before.  Q =
// A Li^T is formed a chunk at a time on the triangle only: a Q tile at
// columns k0..k0+3 sums j <= k0 + 3, since Li^T[j][k] = 0 for j > k; tile
// u is paired with tile nt - 1 - u, so every thread's pair costs the
// same.  A^T and Q have one buffer each (two barriers a chunk), so that
// four blocks share an SM.  gram's body folds rows of A as they are,
// double-buffered.
constexpr int kRegThreads = 192;   // the block's most threads: 190 upper tiles
constexpr int kRegMax = 76;     // the widest n: 19 x 19 tiles

__host__ __device__ inline int reg_tiles(int n) {
  const int nt = padded(n) / kTile;
  return nt * (nt + 1) / 2;
}
__host__ __device__ inline int reg_threads(int n) { return (reg_tiles(n) + 31) / 32 * 32; }
// Q's column units: tile u with tile nt - 1 - u (the middle tile alone
// when nt is odd)
__host__ __device__ inline int r2_units(int n) { return (padded(n) / kTile + 1) / 2; }
// rows of A a chunk holds: a row pair a thread for every unit
__host__ __device__ inline int r2_rows(int n) { return 2 * (reg_threads(n) / r2_units(n)); }
// Li^T (np x np), a chunk of A^T (np x rows) and one of Q (rows x np)
__host__ __device__ inline long long r2_reg_floats(int n) {
  const long long np = padded(n);
  return np * np + 2 * np * r2_rows(n);
}
// gram's two buffers of kRows rows of A (np wide), or the Gram's
// symmetric tile (np x np) that takes their place at the end
__host__ __device__ inline long long gram_reg_floats(int n) {
  const long long np = padded(n);
  return 2 * kRows * np > np * np ? 2 * kRows * np : np * np;
}

// The (row, column) of a thread's elements idx = start, start + step, ...
// of a row-major matrix of width w, without a division per element.
struct Walk {
  int r, c, dr, dc, w;
  __device__ Walk(int start, int step, int width)
      : r(start / width), c(start % width), dr(step / width), dc(step % width), w(width) {}
  __device__ void next() {
    r += dr;
    c += dc;
    if (c >= w) {
      c -= w;
      ++r;
    }
  }
};

// Thread t < reg_tiles(n)'s Gram tile (ti, tj), ti <= tj, counted row by
// row: its first row i0 and column j0.
__device__ inline void upper_tile(int t, int nt, int& i0, int& j0) {
  int ti = 0, rest = t;
  while (rest >= nt - ti) {
    rest -= nt - ti;
    ++ti;
  }
  i0 = ti * kTile;
  j0 = (ti + rest) * kTile;
}

// A thread's Gram tile (i0, j0) and its mirror into s (np x np; a
// diagonal tile is symmetric to the bit: its two products take the same
// operands), then, after a barrier, G (n x n) row by row.
__device__ inline void store_gram(float* s, const float (&g)[kTile][kTile], bool owner, int i0,
                                  int j0, int n, int np, float* Gb) {
  if (owner) {
#pragma unroll
    for (int a = 0; a < kTile; ++a) {
      *reinterpret_cast<float4*>(s + (i0 + a) * np + j0) =
          make_float4(g[a][0], g[a][1], g[a][2], g[a][3]);
      *reinterpret_cast<float4*>(s + (j0 + a) * np + i0) =
          make_float4(g[0][a], g[1][a], g[2][a], g[3][a]);
    }
  }
  __syncthreads();
  Walk w(threadIdx.x, blockDim.x, n);
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x, w.next()) Gb[idx] = s[w.r * np + w.c];
}

// Rows [r0, r0 + rows) of the node's A into at as A^T (at[j * ld + r]),
// one asynchronous 4-byte copy an element, reading A in order.
__device__ inline void copy_rows_transposed(const float* Ab, float* at, int r0, int rows,
                                            int n, int ld) {
  const float* src = Ab + (long long)r0 * n;
  Walk w(threadIdx.x, blockDim.x, n);
  for (int idx = threadIdx.x; idx < rows * n; idx += blockDim.x, w.next())
    __pipeline_memcpy_async(at + w.c * ld + w.r, src + idx, sizeof(float));
}

// Q's rows of one chunk: thread t takes row pair t % pairs and column
// unit t / pairs; each of the unit's tiles sums j in order up to the
// tile's last column (or n).
__device__ inline void r2_q_chunk(const float* at, const float* lit, float* q, int rows,
                                  int n, int np, int ld) {
  const int nt = np / kTile, pairs = ld / 2;
  const int p = threadIdx.x % pairs, u = threadIdx.x / pairs;
  if (u >= (nt + 1) / 2 || 2 * p >= rows) return;
  for (int h = 0; h < 2; ++h) {
    const int tile = h == 0 ? u : nt - 1 - u;
    if (h == 1 && tile == u) break;
    const int k0 = tile * kTile, jend = min(k0 + kTile, n);
    float acc[2][kTile] = {};
#pragma unroll 4
    for (int j = 0; j < jend; ++j) {
      const float2 x = *reinterpret_cast<const float2*>(at + j * ld + 2 * p);
      const float4 y4 = load4(lit + j * np + k0);
      const float y[kTile] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
      for (int c = 0; c < kTile; ++c) {
        acc[0][c] = fmaf(x.x, y[c], acc[0][c]);
        acc[1][c] = fmaf(x.y, y[c], acc[1][c]);
      }
    }
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2)
      *reinterpret_cast<float4*>(q + (2 * p + h2) * np + k0) =
          make_float4(acc[h2][0], acc[h2][1], acc[h2][2], acc[h2][3]);
  }
}

// g += the chunk's rows of Q^T Q (Q: rows of A or of A Li^T, stride np)
// on this thread's tile (i0, j0), rows in order.
__device__ inline void gram_chunk(const float* q, int rows, int np, int i0, int j0,
                                  float (&g)[kTile][kTile]) {
#pragma unroll 4
  for (int r = 0; r < rows; ++r) {
    const float4 x4 = load4(q + r * np + i0), y4 = load4(q + r * np + j0);
    const float x[kTile] = {x4.x, x4.y, x4.z, x4.w};
    const float y[kTile] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
    for (int a = 0; a < kTile; ++a)
#pragma unroll
      for (int b = 0; b < kTile; ++b) g[a][b] = fmaf(x[a], y[b], g[a][b]);
  }
}

__global__ void __launch_bounds__(kRegThreads, 4)
round2_gram_reg_kernel(const float* __restrict__ A, const float* __restrict__ Li,
                       float* __restrict__ G, int m, int n) {
  extern __shared__ __align__(16) float smem[];
  const int np = padded(n), nt = np / kTile, ld = r2_rows(n);
  float* lit = smem;                 // Li^T, np x np; the Gram at the end
  float* at = lit + np * np;         // a chunk of A^T, np x ld
  float* q = at + np * ld;           // the chunk's rows of Q, ld x np
  const int t = threadIdx.x;
  const long long node = blockIdx.x;
  const float* Ab = A + node * m * n;
  // Li^T[j][k] = Li[k][j] for j <= k (Li read in order), zero elsewhere
  {
    const float* Lb = Li + node * n * n;
    Walk w(t, blockDim.x, n);
    for (int idx = t; idx < n * n; idx += blockDim.x, w.next())
      if (w.c <= w.r) __pipeline_memcpy_async(lit + w.c * np + w.r, Lb + idx, sizeof(float));
    Walk z(t, blockDim.x, np);
    for (int idx = t; idx < np * np; idx += blockDim.x, z.next())
      if (z.r > z.c || z.c >= n) lit[idx] = 0.f;
  }
  copy_rows_transposed(Ab, at, 0, min(ld, m), n, ld);
  __pipeline_commit();
  const bool owner = t < reg_tiles(n);
  int i0 = 0, j0 = 0;
  if (owner) upper_tile(t, nt, i0, j0);
  float g[kTile][kTile] = {};
  for (int r0 = 0; r0 < m; r0 += ld) {
    const int rows = min(ld, m - r0);
    __pipeline_wait_prior(0);
    __syncthreads();   // the chunk staged, the last chunk's Q consumed
    r2_q_chunk(at, lit, q, rows, n, np, ld);
    __syncthreads();   // Q written, A^T free
    if (r0 + ld < m) {
      copy_rows_transposed(Ab, at, r0 + ld, min(ld, m - r0 - ld), n, ld);
      __pipeline_commit();
    }
    if (owner) gram_chunk(q, rows, np, i0, j0, g);
  }
  // the Gram's tile and its mirror into Li^T's place, then G
  store_gram(lit, g, owner, i0, j0, n, np, G + node * n * n);
}

// Rows [r0, r0 + rows) of the node's A into a (stride np), one
// asynchronous 4-byte copy an element, reading A in order.
__device__ inline void copy_rows(const float* Ab, float* a, int r0, int rows, int n, int np) {
  const float* src = Ab + (long long)r0 * n;
  Walk w(threadIdx.x, blockDim.x, n);
  for (int idx = threadIdx.x; idx < rows * n; idx += blockDim.x, w.next())
    __pipeline_memcpy_async(a + w.r * np + w.c, src + idx, sizeof(float));
}

// gram's register body: chunk c of kRows rows in buffer c % 2.  At the
// top of chunk c one barrier both publishes its copies and frees the
// other buffer, which then takes chunk c + 1 while c is folded.
__global__ void __launch_bounds__(kRegThreads, 6)
gram_reg_kernel(const float* __restrict__ A, float* __restrict__ G, int m, int n) {
  extern __shared__ __align__(16) float smem[];
  const int np = padded(n), nt = np / kTile, pad = np - n;
  const int t = threadIdx.x;
  const long long node = blockIdx.x;
  const float* Ab = A + node * m * n;
  // the buffers' pad columns, zero throughout (the copies never write them)
  for (int idx = t; idx < 2 * kRows * pad; idx += blockDim.x)
    smem[idx / pad * np + n + idx % pad] = 0.f;
  copy_rows(Ab, smem, 0, min(kRows, m), n, np);
  __pipeline_commit();
  const bool owner = t < reg_tiles(n);
  int i0 = 0, j0 = 0;
  if (owner) upper_tile(t, nt, i0, j0);
  float g[kTile][kTile] = {};
  for (int r0 = 0, c = 0; r0 < m; r0 += kRows, ++c) {
    float* a = smem + (c & 1) * kRows * np;
    __pipeline_wait_prior(0);
    __syncthreads();   // chunk c staged, chunk c - 1 folded
    if (r0 + kRows < m) {
      copy_rows(Ab, smem + ((c + 1) & 1) * kRows * np, r0 + kRows, min(kRows, m - r0 - kRows),
                n, np);
      __pipeline_commit();
    }
    if (owner) gram_chunk(a, min(kRows, m - r0), np, i0, j0, g);
  }
  __syncthreads();   // every chunk folded: the buffers take the Gram's tile
  store_gram(smem, g, owner, i0, j0, n, np, G + node * n * n);
}

template <bool kWs>
__global__ void __launch_bounds__(kThreads)
chol_linv_kernel(const float* __restrict__ G, const float* __restrict__ P,
                 float* __restrict__ out, float* ws, int n, float tiny) {
  extern __shared__ __align__(16) float smem[];
  // s: G, eliminated in place; li: P's lower triangle (the identity
  // without P), then L^-1 P; dinv: the clamped pivots' rsqrt
  float* s = node_base<kWs>(smem, ws, chol_floats(n));
  float* li = s + n * n;
  float* dinv = li + n * n;
  const long long node = blockIdx.x;
  load(G + node * n * n, s, n * n);
  if (P) {
    const float* Pb = P + node * n * n;
    for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
      const int i = idx / n, c = idx - i * n;
      li[idx] = c <= i ? Pb[idx] : 0.f;
    }
  }
  chol_linv_rows_inplace(s, n, li, n, P == nullptr, n, tiny, dinv);
  float* ob = out + node * n * n;
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) ob[idx] = li[idx];
}

// chol_linv's register body: a kGrid x kGrid grid of threads, thread
// (tr, tc) holding entries (tr + kGrid a, tc + kGrid b), a, b < kS, of G
// (g) and of L^-1 P (x, P's lower triangle on entry) in registers, so
// n <= kGrid kS.  Right-looking: at pivot k the raw column k of the
// eliminated G and the raw row k of x, published by their owners at the
// end of pivot k - 1 (double-buffered), give every thread d_k, L[i][k] =
// g[i][k] d_k and x[k][c] d_k; each then updates its entries of rows
// i > k: g[i][j] -= L[i][k] L[j][k] for j > k, x[i][c] -= L[i][k] x[k][c] d_k
// for c <= k, and the owners of row k scale it by d_k, where it is final.
// One barrier a pivot; two loads and one FMA an entry where the shared
// body takes two loads, an FMA and a store; row slots that are all
// finished are skipped.
constexpr int kGrid = 16;
constexpr int kCholRegMax = 5 * kGrid;   // the widest n of the register body

template <int kS>
__global__ void __launch_bounds__(kGrid * kGrid, 3)
chol_linv_reg_kernel(const float* __restrict__ G, const float* __restrict__ P,
                     float* __restrict__ out, int n, float tiny) {
  constexpr int kN = kGrid * kS;
  __shared__ float lcol[2][kN], xrow[2][kN];
  const long long node = blockIdx.x;
  const int t = threadIdx.x, tr = t / kGrid, tc = t % kGrid;
  const float* Gb = G + node * n * n;
  const float* Pb = P ? P + node * n * n : nullptr;
  float g[kS][kS], x[kS][kS];
#pragma unroll
  for (int a = 0; a < kS; ++a)
#pragma unroll
    for (int b = 0; b < kS; ++b) {
      const int i = tr + kGrid * a, c = tc + kGrid * b;
      const bool in = i < n && c < n;
      g[a][b] = in ? Gb[i * n + c] : 0.f;
      x[a][b] = !in || c > i ? 0.f : Pb ? Pb[i * n + c] : (i == c ? 1.f : 0.f);
    }
  if (tc == 0)
#pragma unroll
    for (int a = 0; a < kS; ++a) lcol[0][tr + kGrid * a] = g[a][0];
  if (tr == 0)
#pragma unroll
    for (int b = 0; b < kS; ++b) xrow[0][tc + kGrid * b] = x[0][b];
  __syncthreads();
  for (int k = 0; k < n; ++k) {
    const int p = k & 1;
    const float d = rsqrtf(fmaxf(lcol[p][k], tiny));
    float mult[kS];     // L[c][k] for the trailing columns, x[k][c] d_k else
#pragma unroll
    for (int b = 0; b < kS; ++b) {
      const int c = tc + kGrid * b;
      mult[b] = (c > k ? lcol[p][c] : xrow[p][c]) * d;
    }
#pragma unroll
    for (int a = 0; a < kS; ++a) {
      if (kGrid * a + kGrid - 1 < k) continue;   // every row of the slot is final
      const int i = tr + kGrid * a;
      if (i == k) {
#pragma unroll
        for (int b = 0; b < kS; ++b) x[a][b] *= d;
      } else if (i > k) {
        const float l = lcol[p][i] * d;
#pragma unroll
        for (int b = 0; b < kS; ++b) {
          if (tc + kGrid * b > k) g[a][b] = fmaf(-l, mult[b], g[a][b]);
          else x[a][b] = fmaf(-l, mult[b], x[a][b]);
        }
      }
    }
    // publish the raw column k + 1 and row k + 1 for the next pivot
    const int k1 = k + 1;
    if (k1 < n) {
      if (tc == k1 % kGrid)
#pragma unroll
        for (int b = 0; b < kS; ++b)
          if (tc + kGrid * b == k1)
#pragma unroll
            for (int a = 0; a < kS; ++a) lcol[p ^ 1][tr + kGrid * a] = g[a][b];
      if (tr == k1 % kGrid)
#pragma unroll
        for (int a = 0; a < kS; ++a)
          if (tr + kGrid * a == k1)
#pragma unroll
            for (int b = 0; b < kS; ++b) xrow[p ^ 1][tc + kGrid * b] = x[a][b];
      __syncthreads();
    }
  }
  float* ob = out + node * n * n;
#pragma unroll
  for (int a = 0; a < kS; ++a)
#pragma unroll
    for (int b = 0; b < kS; ++b) {
      const int i = tr + kGrid * a, c = tc + kGrid * b;
      if (i < n && c < n) ob[i * n + c] = c <= i ? x[a][b] : 0.f;
    }
}

// prec_apply's shared body: Lc's lower triangle (at stride n; the upper
// triangle is neither read nor written) and v, then u = Lc v and Lc^T u
// on the triangle.
template <bool kWs>
__global__ void __launch_bounds__(kApplyThreads)
prec_apply_kernel(const float* __restrict__ Lc, const float* __restrict__ v,
                  float* __restrict__ out, float* ws, int n) {
  extern __shared__ __align__(16) float smem[];
  float* l = node_base<kWs>(smem, ws, apply_floats(n));   // n x n
  float* vs = l + n * n;      // n
  float* u = vs + n;          // n
  const long long node = blockIdx.x;
  const float* Lb = Lc + node * n * n;
  Walk w(threadIdx.x, blockDim.x, n);
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x, w.next())
    if (w.c <= w.r) l[idx] = Lb[idx];
  load(v + node * n, vs, n);
  __syncthreads();
  rows_times(l, n, vs, u, n, true);
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += kApplyThreads)
    out[node * n + j] = col_times(l, n, u, j, n, true);
}

// ---- prec_apply's warp body (path 2)
//
// One warp a node, kApplyWarps nodes a block, and no block barrier.  The
// warp's slice of shared memory holds its node's lower triangle, row i's
// first i + 1 entries packed from i (i + 1) / 2 on, then v; both arrive by
// asynchronous copies, issued back to back and waited once.  The lanes
// walk the packed entries in order, 32 a copy (coalesced; row by row,
// the short rows' copies were partly idle and measured slower).  Lane l
// owns rows (for u) and columns (for o) l + 32 s, s < kS, in registers
// whose slot is known at compile time: the loops over slots are
// unrolled, and only the step within a slot's 32 rows or columns is a
// runtime loop.
constexpr int kApplyWarps = 4;
constexpr int kApplyMaxSlots = 4;   // the widest n: 128, 33.5 KB a warp

__host__ __device__ inline long long tri_floats(int n) { return (long long)n * (n + 1) / 2; }
// a warp's slice: the packed triangle and v, rounded up to whole tiles
__host__ __device__ inline long long apply_warp_floats(int n) {
  return round_tile(tri_floats(n) + n);
}

template <int kS>
__global__ void __launch_bounds__(32 * kApplyWarps)
prec_apply_warp_kernel(const float* __restrict__ Lc, const float* __restrict__ v,
                       float* __restrict__ out, int B, int n) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long node = (long long)blockIdx.x * (blockDim.x / 32) + warp;
  if (node >= B) return;   // the ragged last block: no block barrier follows
  float* tri = smem + warp * apply_warp_floats(n);
  float* vs = tri + tri_floats(n);
  const float* Lb = Lc + node * n * n;
  {
    const int count = (int)tri_floats(n);
    int i = 0, j = lane;   // entry p = lane of the packed triangle
    while (j > i) j -= ++i;
    for (int p = lane; p < count; p += 32) {
      __pipeline_memcpy_async(tri + p, Lb + (long long)i * n + j, sizeof(float));
      j += 32;
      while (j > i) j -= ++i;
    }
  }
  for (int j = lane; j < n; j += 32) __pipeline_memcpy_async(vs + j, v + node * n + j, sizeof(float));
  __pipeline_commit();
  int roff[kS];   // where this lane's row i = lane + 32 s starts
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    const int i = lane + 32 * s;
    roff[s] = i * (i + 1) / 2;
  }
  __pipeline_wait_prior(0);
  __syncwarp();
  // u = Lc v, each lane's rows, j in order: at column j the lanes of slot
  // s read rows 32 s .. 32 s + 31, whose offsets i (i + 1) / 2 + j are
  // distinct mod 32 (so are the triangular numbers of any 32 consecutive
  // rows from a multiple of 32): no bank conflict
  float u[kS] = {};
#pragma unroll
  for (int r = 0; r < kS; ++r) {
    const int jend = min(32, n - 32 * r);
    for (int jj = 0; jj < jend; ++jj) {
      const int j = 32 * r + jj;
      const float vj = vs[j];
#pragma unroll
      for (int s = r; s < kS; ++s)
        if (lane + 32 * s < n && (s > r || lane >= jj))
          u[s] = fmaf(tri[roff[s] + j], vj, u[s]);
    }
  }
  // o = Lc^T u: u_i from its owner by a shuffle, each lane's columns of
  // row i (consecutive entries across the lanes), i in order
  float o[kS] = {};
#pragma unroll
  for (int r = 0; r < kS; ++r) {
    const int iend = min(32, n - 32 * r);
    for (int ii = 0; ii < iend; ++ii) {
      const int i = 32 * r + ii;
      const float ui = __shfl_sync(0xffffffffu, u[r], ii);
      const float* row = tri + i * (i + 1) / 2;
#pragma unroll
      for (int s = 0; s <= r; ++s)
        if (s < r || lane <= ii) o[s] = fmaf(row[lane + 32 * s], ui, o[s]);
    }
  }
#pragma unroll
  for (int s = 0; s < kS; ++s)
    if (lane + 32 * s < n) out[node * n + lane + 32 * s] = o[s];
}

using ApplyWarpKernel = void (*)(const float*, const float*, float*, int, int);

// The warp body's instance for n: kS = ceil(n / 32) slots a lane.
ApplyWarpKernel apply_warp_kernel(int n) {
  switch ((n + 31) / 32) {
    case 1: return prec_apply_warp_kernel<1>;
    case 2: return prec_apply_warp_kernel<2>;
    case 3: return prec_apply_warp_kernel<3>;
    case 4: return prec_apply_warp_kernel<4>;
    default: return nullptr;
  }
}

// The four kernels, by their ids in cholqr_occupancy: a kernel's threads
// and its node's floats (a block's, for prec_apply's warp body).
enum Kernel { kGram = 0, kRound2 = 1, kCholLinv = 2, kApply = 3 };

struct Launch {
  const void* kernel;
  int threads;
  long long floats;
};

// The body gram, round2_gram or prec_apply takes by default at width n:
// 2, the register (gram, round2_gram: n <= kRegMax) or warp
// (prec_apply: n <= 32 kApplyMaxSlots) body; else 1, the shared-memory
// body (on the workspace when the node does not fit).
int default_path(int kernel, int n) {
  const int widest = kernel == kApply ? 32 * kApplyMaxSlots : kRegMax;
  return n <= widest ? 2 : 1;
}

// Body `path` (1 or 2) of gram, round2_gram or prec_apply at width n;
// path 2 has no workspace instance.
Launch body_launch(int kernel, int n, int path, bool ws) {
  if (path == 2 && (ws || default_path(kernel, n) != 2)) return {nullptr, 0, 0};
  switch (kernel) {
    case kGram:
      if (path == 2) return {(const void*)gram_reg_kernel, reg_threads(n), gram_reg_floats(n)};
      return {ws ? (const void*)gram_kernel<true> : (const void*)gram_kernel<false>, kThreads,
              gram_floats(n)};
    case kRound2:
      if (path == 2)
        return {(const void*)round2_gram_reg_kernel, reg_threads(n), r2_reg_floats(n)};
      return {ws ? (const void*)round2_gram_kernel<true> : (const void*)round2_gram_kernel<false>,
              kThreads, round2_floats(n)};
    case kApply:
      if (path == 2)
        return {(const void*)apply_warp_kernel(n), 32 * kApplyWarps,
                kApplyWarps * apply_warp_floats(n)};
      return {ws ? (const void*)prec_apply_kernel<true> : (const void*)prec_apply_kernel<false>,
              kApplyThreads, apply_floats(n)};
    default: return {nullptr, 0, 0};
  }
}

// The kernel of a launch: each kernel's default body (chol_linv's
// register body up to n = kCholRegMax), on the workspace when `ws`.
Launch launch_of(int kernel, int n, bool ws) {
  if (kernel != kCholLinv) return body_launch(kernel, n, ws ? 1 : default_path(kernel, n), ws);
  if (!ws && n <= kCholRegMax)
    return {n <= 3 * kGrid ? (const void*)chol_linv_reg_kernel<3>
                           : (const void*)chol_linv_reg_kernel<5>,
            kGrid * kGrid, 0};
  return {ws ? (const void*)chol_linv_kernel<true> : (const void*)chol_linv_kernel<false>,
          kThreads, chol_floats(n)};
}

bool fits(long long floats) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (size_t)floats * sizeof(float) <= (size_t)optin;
}

// The dynamic shared memory of a launch (none on the workspace), set on
// the kernel.
cudaError_t prepare(const Launch& l, bool workspace, size_t* bytes) {
  if (l.kernel == nullptr || (!workspace && !fits(l.floats))) return cudaErrorInvalidValue;
  *bytes = workspace ? 0 : (size_t)l.floats * sizeof(float);
  return cudaFuncSetAttribute(l.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*bytes);
}

// Floats of device workspace per node that a kernel needs at width n; 0
// when the node fits in shared memory.
long long workspace_floats(int kernel, int n) {
  const Launch l = launch_of(kernel, n, false);
  return l.kernel == nullptr || fits(l.floats) ? 0 : l.floats;
}

// A launch's dynamic shared memory, threads, blocks an SM holds,
// registers and local memory bytes a thread; returns the cudaError_t.
int occupancy_of(const Launch& l, bool ws, long long* smem_bytes, int* threads,
                 int* blocks_per_sm, int* regs, long long* local_bytes) {
  size_t bytes = 0;
  cudaError_t err = prepare(l, ws, &bytes);
  if (err != cudaSuccess) return (int)err;
  *smem_bytes = (long long)bytes;
  *threads = l.threads;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, l.kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (long long)attr.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, l.kernel,
                                                            l.threads, bytes);
}

// As cholqr_occupancy, for body `path` (0: the default) of gram,
// round2_gram or prec_apply at width n.
int path_occupancy(int kernel, int n, int path, long long* smem_bytes, int* threads,
                   int* blocks_per_sm, int* regs, long long* local_bytes) {
  if (n <= 0 || path < 0 || path > 2) return (int)cudaErrorInvalidValue;
  if (path == 0) path = default_path(kernel, n);
  const bool ws = path == 1 && workspace_floats(kernel, n) > 0;
  return occupancy_of(body_launch(kernel, n, path, ws), ws, smem_bytes, threads, blocks_per_sm,
                      regs, local_bytes);
}

}  // namespace

extern "C" long long gram_f32_workspace_floats(int n) { return workspace_floats(kGram, n); }
extern "C" long long round2_gram_f32_workspace_floats(int n) {
  return workspace_floats(kRound2, n);
}
extern "C" long long chol_linv_f32_workspace_floats(int n) {
  return workspace_floats(kCholLinv, n);
}
extern "C" long long prec_apply_f32_workspace_floats(int n) {
  return workspace_floats(kApply, n);
}

// A launch of kernel `kernel` (0 gram, 1 round2_gram, 2 chol_linv, 3
// prec_apply) at width n: its dynamic shared memory,
// threads, the blocks an SM holds, and the kernel's registers a thread
// and local memory bytes a thread (spills); returns the cudaError_t.
extern "C" int cholqr_occupancy(int kernel, int n, long long* smem_bytes, int* threads,
                                int* blocks_per_sm, int* regs, long long* local_bytes) {
  const bool ws = workspace_floats(kernel, n) > 0;
  return occupancy_of(launch_of(kernel, n, ws), ws, smem_bytes, threads, blocks_per_sm, regs,
                      local_bytes);
}

// The body gram, round2_gram or prec_apply (kernel id 0, 1, 3) takes by
// default at width n: 2, the register or warp body (n <= 76 for gram and
// round2_gram, n <= 128 for prec_apply); else 1, the shared-memory body.
extern "C" int gram_f32_path(int n) { return default_path(kGram, n); }
extern "C" int round2_gram_f32_path(int n) { return default_path(kRound2, n); }
extern "C" int prec_apply_f32_path(int n) { return default_path(kApply, n); }

extern "C" int gram_f32_occupancy(int n, int path, long long* smem_bytes, int* threads,
                                  int* blocks_per_sm, int* regs, long long* local_bytes) {
  return path_occupancy(kGram, n, path, smem_bytes, threads, blocks_per_sm, regs, local_bytes);
}
extern "C" int round2_gram_f32_occupancy(int n, int path, long long* smem_bytes,
                                         int* threads, int* blocks_per_sm, int* regs,
                                         long long* local_bytes) {
  return path_occupancy(kRound2, n, path, smem_bytes, threads, blocks_per_sm, regs,
                        local_bytes);
}
extern "C" int prec_apply_f32_occupancy(int n, int path, long long* smem_bytes, int* threads,
                                        int* blocks_per_sm, int* regs, long long* local_bytes) {
  return path_occupancy(kApply, n, path, smem_bytes, threads, blocks_per_sm, regs, local_bytes);
}

// Each launch takes ws, a workspace of its kernel's *_workspace_floats(n)
// floats a node, or null to keep the node in shared memory.  A *_path_launch
// takes body `path`: 0 the default (1 when ws is not null), 1 shared memory
// (on ws when not null), 2 the register or warp body (ws null).

// G = A^T A.
extern "C" int gram_f32_path_launch(const float* A, float* G, float* ws, int B, int m, int n,
                                    int path, void* stream) {
  if (B <= 0 || m <= 0 || n <= 0 || path < 0 || path > 2) return (int)cudaErrorInvalidValue;
  if (path == 0) path = ws ? 1 : default_path(kGram, n);
  const Launch l = body_launch(kGram, n, path, ws != nullptr);
  size_t bytes = 0;
  cudaError_t err = prepare(l, ws != nullptr, &bytes);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (path == 2) gram_reg_kernel<<<B, l.threads, bytes, s>>>(A, G, m, n);
  else if (ws) gram_kernel<true><<<B, kThreads, bytes, s>>>(A, G, ws, m, n);
  else gram_kernel<false><<<B, kThreads, bytes, s>>>(A, G, ws, m, n);
  return (int)cudaGetLastError();
}

extern "C" int gram_f32_launch(const float* A, float* G, float* ws, int B, int m, int n,
                               void* stream) {
  return gram_f32_path_launch(A, G, ws, B, m, n, 0, stream);
}

// G = (A Li^T)^T (A Li^T).  Li is read as lower triangular: the register
// body does not read its upper triangle.
extern "C" int round2_gram_f32_path_launch(const float* A, const float* Li, float* G,
                                           float* ws, int B, int m, int n, int path,
                                           void* stream) {
  if (B <= 0 || m <= 0 || n <= 0 || path < 0 || path > 2) return (int)cudaErrorInvalidValue;
  if (path == 0) path = ws ? 1 : default_path(kRound2, n);
  const Launch l = body_launch(kRound2, n, path, ws != nullptr);
  size_t bytes = 0;
  cudaError_t err = prepare(l, ws != nullptr, &bytes);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (path == 2) round2_gram_reg_kernel<<<B, l.threads, bytes, s>>>(A, Li, G, m, n);
  else if (ws) round2_gram_kernel<true><<<B, kThreads, bytes, s>>>(A, Li, G, ws, m, n);
  else round2_gram_kernel<false><<<B, kThreads, bytes, s>>>(A, Li, G, ws, m, n);
  return (int)cudaGetLastError();
}

extern "C" int round2_gram_f32_launch(const float* A, const float* Li, float* G,
                                      float* ws, int B, int m, int n, void* stream) {
  return round2_gram_f32_path_launch(A, Li, G, ws, B, m, n, 0, stream);
}

// P (mul_right) is read as lower triangular: its upper triangle is not read.
extern "C" int chol_linv_f32_launch(const float* G, const float* P, float* out,
                                    float* ws, int B, int n, float tiny, void* stream) {
  if (B <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (ws == nullptr && n <= kCholRegMax) {
    if (n <= 3 * kGrid) chol_linv_reg_kernel<3><<<B, kGrid * kGrid, 0, s>>>(G, P, out, n, tiny);
    else chol_linv_reg_kernel<5><<<B, kGrid * kGrid, 0, s>>>(G, P, out, n, tiny);
    return (int)cudaGetLastError();
  }
  size_t bytes = 0;
  cudaError_t err = prepare(launch_of(kCholLinv, n, ws != nullptr), ws != nullptr, &bytes);
  if (err != cudaSuccess) return (int)err;
  if (ws) chol_linv_kernel<true><<<B, kThreads, bytes, s>>>(G, P, out, ws, n, tiny);
  else chol_linv_kernel<false><<<B, kThreads, bytes, s>>>(G, P, out, ws, n, tiny);
  return (int)cudaGetLastError();
}

// o = Lc^T (Lc v).  Lc is read as lower triangular: no body reads its
// upper triangle.
extern "C" int prec_apply_f32_path_launch(const float* Lc, const float* v, float* out,
                                          float* ws, int B, int n, int path, void* stream) {
  if (B <= 0 || n <= 0 || path < 0 || path > 2) return (int)cudaErrorInvalidValue;
  if (path == 0) path = ws ? 1 : default_path(kApply, n);
  const Launch l = body_launch(kApply, n, path, ws != nullptr);
  size_t bytes = 0;
  cudaError_t err = prepare(l, ws != nullptr, &bytes);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (path == 2) {
    const int warps = l.threads / 32;
    const ApplyWarpKernel kernel = apply_warp_kernel(n);
    kernel<<<(B + warps - 1) / warps, l.threads, bytes, s>>>(Lc, v, out, B, n);
  } else if (ws) {
    prec_apply_kernel<true><<<B, kApplyThreads, bytes, s>>>(Lc, v, out, ws, n);
  } else {
    prec_apply_kernel<false><<<B, kApplyThreads, bytes, s>>>(Lc, v, out, ws, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int prec_apply_f32_launch(const float* Lc, const float* v, float* out,
                                     float* ws, int B, int n, void* stream) {
  return prec_apply_f32_path_launch(Lc, v, out, ws, B, n, 0, stream);
}
