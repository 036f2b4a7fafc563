/*
 * Device code of the float32 shifted-CholeskyQR2 preconditioner, shared by
 * the unfused kernels of cholqr.cu and the fused solve of gls_solve.cu.
 *
 * Every function is called by all threads of a block (blockDim.x of them,
 * a multiple of 32) and works on matrices in shared memory or in device
 * memory through plain pointers, each with its own row stride.  A stride
 * that float4 loads use (the `np` arguments) must be a multiple of kTile
 * floats, and the matrix must start on a 16-byte boundary.  None of them
 * synchronises the block at its end unless it says so: the caller puts
 * the barrier where the next stage needs it.  Every product is a chain of
 * float32 FMAs on the CUDA cores, never TF32: the preconditioner relies on
 * Gram products accurate to ~eps32.
 */
#pragma once

#include <cuda_runtime.h>

namespace cholqr_device {

constexpr int kTile = 4;    // register tile: kTile x kTile entries a thread
constexpr int kElimRows = 4;   // rows of a Cholesky update in flight a thread

// Round n up to the tile width: the row stride of the tiled matrices, so
// every tile starts on a 16-byte boundary (float4 loads).
__host__ __device__ inline int padded(int n) { return (n + kTile - 1) / kTile * kTile; }

__device__ inline float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Upper tile t of an np x np matrix, tiles numbered row by row over the
// kTile x kTile tiles (ti, tj), ti <= tj: its first row and column.
__device__ inline void upper_tile(int t, int nt, int& i0, int& j0) {
  int ti = 0, rest = t;
  while (rest >= nt - ti) { rest -= nt - ti; ++ti; }
  i0 = ti * kTile;
  j0 = (ti + rest) * kTile;
}

// acc[p][q] += sum_{r < rows} a[r][i0 + p] a[r][j0 + q], a at stride np:
// each entry sums its rows in order with FMAs, 8 loads per 16 FMAs.
__device__ inline void gram_tile(const float* a, int rows, int np, int i0, int j0,
                                 float (&acc)[kTile][kTile]) {
  for (int r = 0; r < rows; ++r) {
    const float4 x4 = load4(a + r * np + i0), y4 = load4(a + r * np + j0);
    const float x[kTile] = {x4.x, x4.y, x4.z, x4.w};
    const float y[kTile] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
    for (int p = 0; p < kTile; ++p)
#pragma unroll
      for (int q = 0; q < kTile; ++q) acc[p][q] = fmaf(x[p], y[q], acc[p][q]);
  }
}

// Accumulate rows [0, rows) of a (stride np) into the upper tiles of g
// (np x np): g[i][j] += sum_r a[r][i] a[r][j] for the kTile x kTile tiles
// (ti, tj), ti <= tj (gram_tile); a thread keeps one tile in registers for
// the whole call.  Thread t owns tiles t, t + blockDim, ..., so no two
// threads write one entry, and a thread that calls it again on the same g
// finds its own tiles.
__device__ inline void gram_accumulate(const float* a, float* g, int rows, int np) {
  const int nt = np / kTile;
  for (int t = threadIdx.x; t < nt * (nt + 1) / 2; t += blockDim.x) {
    int i0, j0;
    upper_tile(t, nt, i0, j0);
    float acc[kTile][kTile];
#pragma unroll
    for (int p = 0; p < kTile; ++p) {
      const float4 v = load4(g + (i0 + p) * np + j0);
      acc[p][0] = v.x; acc[p][1] = v.y; acc[p][2] = v.z; acc[p][3] = v.w;
    }
    gram_tile(a, rows, np, i0, j0, acc);
#pragma unroll
    for (int p = 0; p < kTile; ++p)
      *reinterpret_cast<float4*>(g + (i0 + p) * np + j0) =
          make_float4(acc[p][0], acc[p][1], acc[p][2], acc[p][3]);
  }
}

// One kTile x kTile tile of Q = A Li^T: acc[p][c] = sum_{j < n} a[r0 + p][j]
// lit[j][k0 + c], j in order, with a and lit = Li^T both at stride np.
// Threads that share r0 and take consecutive k0 read a as a broadcast and
// lit as consecutive float4s, free of bank conflicts.  Rows r0 .. r0 + 3
// of a are read whatever the caller keeps of them.
__device__ inline void q_tile(const float* a, const float* lit, int r0, int k0,
                              int n, int np, float (&acc)[kTile][kTile]) {
#pragma unroll
  for (int p = 0; p < kTile; ++p)
#pragma unroll
    for (int c = 0; c < kTile; ++c) acc[p][c] = 0.f;
  for (int j = 0; j < n; ++j) {
    const float4 y4 = load4(lit + j * np + k0);
    const float y[kTile] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
    for (int p = 0; p < kTile; ++p) {
      const float x = a[(r0 + p) * np + j];
#pragma unroll
      for (int c = 0; c < kTile; ++c) acc[p][c] = fmaf(x, y[c], acc[p][c]);
    }
  }
}

// Rows r0 + p < rows of a q_tile into q (stride np), columns k0 .. k0 + 3.
__device__ inline void store_tile(float* q, int r0, int k0, int rows, int np,
                                  const float (&acc)[kTile][kTile]) {
#pragma unroll
  for (int p = 0; p < kTile; ++p)
    if (r0 + p < rows)
      *reinterpret_cast<float4*>(q + (r0 + p) * np + k0) =
          make_float4(acc[p][0], acc[p][1], acc[p][2], acc[p][3]);
}

// The clamped Cholesky factorization of the lower triangle of s (n x n,
// stride ld), d_k = rsqrt(max(pivot_k, tiny)), eliminated in place
// (right-looking), with L^-1 P formed in place over li (stride ldl), which
// holds P, lower triangular, on entry (the identity when `identity`: then
// written here).  At step k row k of li is final once scaled by d_k, and
// each later row takes li[i][:] -= L[i][k] li[k][:] at once, so no thread
// waits on a chain of k dependent FMAs.  L's column k is read from s as
// it is eliminated, so nothing is stored in s's upper half; only the
// lower half of the trailing matrix is updated: it is all the elimination
// reads.
//
// Every thread works at every step: column col < n of the step (col <= k:
// the inverse's column; col > k: the trailing matrix's) and one of `parts`
// interleaved slices of its rows i > k, kElimRows rows at a time, every
// load before any store (the compiler cannot move a load of one row above
// the store of the last, so row by row each would wait out the load
// latency), lanes over consecutive columns (only the warp that holds
// column k runs both kinds).  At (n, blockDim) = (73, 256) that is three
// slices of 24 rows at k = 0, where one thread a column would walk all 72.
// Row k of li is read by every slice, so it is scaled in place only after
// the step's barrier.  d_k goes to dinv[k].  Starts and ends with a
// barrier.
__device__ inline void chol_linv_rows_inplace(float* s, int ld, float* li, int ldl,
                                              bool identity, int n, float tiny,
                                              float* dinv) {
  const int t = threadIdx.x;
  const int parts = max(1, (int)blockDim.x / n);
  if (identity)
    for (int idx = t; idx < n * n; idx += blockDim.x) {
      const int i = idx / n, c = idx - i * n;
      li[i * ldl + c] = i == c ? 1.f : 0.f;
    }
  __syncthreads();
  for (int k = 0; k < n; ++k) {
    const float d = rsqrtf(fmaxf(s[k * ld + k], tiny));
    if (t == 0) dinv[k] = d;
    for (int w = t; w < n * parts; w += blockDim.x) {
      const int col = w % n, i0 = k + 1 + w / n;
      // the row's multiplier: li[k][c] d_k for the inverse, L[j][k] for
      // the trailing matrix; each row i takes x[i] -= (s[i][k] d_k) * mult
      const bool inv = col <= k;
      float* x = inv ? li + col : s + col;
      const int xld = inv ? ldl : ld;
      const float mult = (inv ? li[k * ldl + col] : s[col * ld + k]) * d;
      const int first = inv ? 0 : col;   // the trailing matrix's lower half
      int i = i0;
      for (; i + (kElimRows - 1) * parts < n; i += kElimRows * parts) {
        float l[kElimRows], y[kElimRows];
#pragma unroll
        for (int q = 0; q < kElimRows; ++q) {
          l[q] = s[(i + q * parts) * ld + k] * d;
          y[q] = x[(i + q * parts) * xld];
        }
#pragma unroll
        for (int q = 0; q < kElimRows; ++q)
          if (i + q * parts >= first) x[(i + q * parts) * xld] = y[q] - l[q] * mult;
      }
      for (; i < n; i += parts)
        if (i >= first) x[i * xld] -= (s[i * ld + k] * d) * mult;
    }
    __syncthreads();
    for (int c = t; c <= k; c += blockDim.x) li[k * ldl + c] *= d;
  }
  __syncthreads();
}

// u[i] = sum_j l[i][j] v[j] for i < n, over j <= i when `lower` (l lower
// triangular) and j < n otherwise: one warp a row, lanes over j (rows of
// l read consecutively), a shuffle reduction.
__device__ inline void rows_times(const float* l, int ld, const float* v, float* u,
                                  int n, bool lower) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < n; i += blockDim.x / 32) {
    const int end = lower ? i + 1 : n;
    float acc = 0.f;
    for (int j = lane; j < end; j += 32) acc = fmaf(l[i * ld + j], v[j], acc);
    for (int off = 16; off > 0; off /= 2)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) u[i] = acc;
  }
}

// sum_i l[i][j] u[i] over i >= j when `lower`, all i < n otherwise, in
// order: column j of l^T u, for one thread a column (consecutive threads
// read consecutive entries of each row of l).
__device__ inline float col_times(const float* l, int ld, const float* u, int j,
                                  int n, bool lower) {
  float acc = 0.f;
  for (int i = lower ? j : 0; i < n; ++i) acc = fmaf(l[i * ld + j], u[i], acc);
  return acc;
}

}  // namespace cholqr_device
