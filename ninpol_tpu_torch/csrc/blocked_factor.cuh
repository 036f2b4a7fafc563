/*
 * The blocked clamped Cholesky factor on the FP64 tensor cores, shared by
 * the fused solve (gls_solve.cu: both of its factorizations, L1^-1 of G1
 * and Lc = L2^-1 L1^-1 of G2) and kernel 1's factorization probes
 * (factor_probes.cu: chol_linv_tc, chol_trsm_gram's variant C).
 *
 * A matrix lives in shared memory (or a device workspace: every function
 * takes plain pointers) as a packed lower triangle of 8 x 8 float64
 * blocks, np = pad8(n) rows, the identity past n: at n = 73 (np = 80, 10
 * block rows) a triangle takes 28,160 B.  blocked_factor factors it in
 * place, right-looking, 8 columns a step, by panels of kW columns, with
 * L^-1's block rows formed inside the steps (kInv): warp 0 factors each
 * diagonal block and its inverse by float32 shuffles (diag_factor) a step
 * ahead of the other seven warps, which form the panel against that
 * inverse, L^-1's next block row (inverse_tile) and the trailing update on
 * mma.sync.m16n8k8.f64, and meet the lead on a named barrier: two block
 * barriers a step, 2 nb in all (20 a node at n = 73, where the
 * elimination it replaces took one a pivot).  lower_product forms the
 * product of two such lower triangles (the route's Lc = L2^-1 L1^-1) on
 * the same products, rounded once into a float32 matrix.  Every product
 * is float64 (operands widened once where they are staged), so the
 * float32 preconditioner's factors lose nothing to TF32.
 *
 * What bounds it on an H100: the lead warp's chain of 8-pivot shuffle
 * steps (n / 8 of them, each ~600 cycles) and the two barriers a step,
 * not device memory or the tensor cores' rate (0.13 MFLOP a node at n =
 * 73); the design keeps the chain in one warp and the products beside it.
 * Every function is called by all kFactorThreads threads of a block.
 */
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace blocked_factor_device {

constexpr int kFactorThreads = 256, kFactorWarps = kFactorThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

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

// ---- the blocked factor on the tensor cores (gls_solve.cu's chol1 and
// chol2; factor_probes.cu's chol_linv_tc, chol_trsm_gram with kW > 0)
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
// Entry (r, c), c <= r, of a packed lower triangle: its block's offset,
// then row-major within the block.
__device__ __forceinline__ int packed_at(int r, int c) {
  return bo(r >> 3, c >> 3) + (r & 7) * 8 + (c & 7);
}

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
  named_arrive(1, kFactorThreads);
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
  constexpr int kWorkers = kFactorWarps - 1;
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
      if (k == 1 && warp == kFactorWarps - 1 && next_g != nullptr) prefetch_l2(next_g, next_bytes);
      const int ninv = kInv ? k1 / 2 : 0, npt = (nb - k1) / 2;
      for (int it = warp - 1; it < ninv + npt; it += kWorkers) {
        if (it < ninv) inverse_tile(lp, ip, 2 * it, k);
        else panel_tile(lp, nb, k1 + 1 + 2 * (it - ninv), k, inv);
      }
      if (k1 < nb) {
        named_sync(1, kFactorThreads);
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

// One tile of the product C = Lt Rt of two packed lower triangles (the
// route's Lc = L2^-1 L1^-1): C's blocks (i, jb) and (i, jb + 1) (the
// second where jb + 1 <= i), C_ij = sum_{l = j}^{i} Lt_il Rt_lj, computed
// transposed as inverse_tile does: T^T = sum_l Rt_lj^T Lt_il^T (the mma's
// natural K order, two accumulator chains); Rt_l,jb+1 is 0 for l = jb.
// C's entries (r, c), c <= r < n, rounded once into out (row stride ld).
__device__ inline void product_tile(const double* lt, const double* rt, float* out, int ld,
                                    int n, int i, int jb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  double e[2][4] = {{0.0, 0.0, 0.0, 0.0}, {0.0, 0.0, 0.0, 0.0}};
  int q = 0;
#pragma unroll 1
  for (int l = jb; l <= i; ++l, q ^= 1) {
    const bool hi = l > jb;
    const double* a0 = rt + bo(l, jb) + t * 8 + g;
    const double* a1 = rt + bo(l, hi ? jb + 1 : jb) + t * 8 + g;
    const double a[4] = {a0[0], hi ? a1[0] : 0.0, a0[32], hi ? a1[32] : 0.0};
    const double* lk = lt + bo(i, l) + g * 8 + t;
    const double b[2] = {lk[0], lk[4]};
    if (q) mma16(e[1], a, b);
    else mma16(e[0], a, b);
  }
  // e[.][h]: row 8 i + 2 t + (h & 1), column 8 (jb + (h >> 1)) + g
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const int r = 8 * i + 2 * t + (h & 1), c = 8 * (jb + (h >> 1)) + g;
    if (r < n && c <= r) out[r * ld + c] = (float)(e[0][h] + e[1][h]);
  }
}

// C = Lt Rt (product_tile) over every block of C's lower triangle, nb
// block rows, a warp a tile, the longest tiles (the last block rows)
// first.  Ends with a barrier.
__device__ inline void lower_product(const double* lt, const double* rt, float* out, int ld,
                                     int n, int nb) {
  const int warp = threadIdx.x / 32;
  int it = 0;
  for (int i = nb - 1; i >= 0; --i)
    for (int jb = 0; jb <= i; jb += 2, ++it)
      if (it % kFactorWarps == warp) product_tile(lt, rt, out, ld, n, i, jb);
  __syncthreads();
}

}  // namespace blocked_factor_device
