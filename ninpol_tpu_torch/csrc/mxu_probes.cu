/*
 * The tensor-core Gram and Q probes for NVIDIA Hopper (sm_90a): kernel 1's
 * three product stages (G1 = A^T A, Q = A Li^T, G2 = Q^T Q), which run on
 * the CUDA cores in gls_solve.cu and cholqr.cu, as per-node products on
 * the tensor cores.  They are the counterparts of the TPU probes
 * tools/mxu_probe.py and tools/r5_mxu_shapes.py, timed by
 * ninpol_tpu_torch/tools/mxu_probes.py on the route's own float32 inputs
 * beside kernel 1's stage cuts and the unfused Gram kernels.  No route
 * runs them: this library is built apart from the production ones, at the
 * first probe launch.  ninpol_tpu_torch/ops/mxu_probes.py holds the
 * contracts, the wrappers and the plain PyTorch versions.
 *
 * Three precisions, a template parameter of every product:
 *   kDmma    mma.sync.m16n8k8.f64 (sm_90's shape; the A100's m8n8k4 was
 *            slower on Q and the composite): float32 operands widened
 *            exactly, sums in float64, each output rounded once to
 *            float32 (FP64 tensor cores, 67 TFLOP/s);
 *   kTf32x3  mma.sync.m16n8k8.tf32, each operand split as hi = tf32(a),
 *            lo = tf32(a - hi) (cvt.rna), three products lo hi + hi lo +
 *            hi hi into float32 sums (3 x the TF32 work at 495 TFLOP/s);
 *   kBf16    mma.sync.m16n8k16.bf16, operands rounded by cvt.rn.bf16, one
 *            pass into float32 sums: the TPU's DEFAULT on float32 (989
 *            TFLOP/s; the Gram only).
 *
 * gram_kernel<P, kMinor, kST> replaces tools/mxu_probe.py:123 and :138
 *   (node-major), :166 (node-minor: the transposes in and out are its
 *   reads and writes) and r5_mxu_shapes.py:84 (node-minor, any (m, n), a
 *   split row).  One block of 8 warps a node.  A comes in row blocks of
 *   kRows = 32: each block's raw copy (16 bytes a copy where node-major
 *   rows allow) is in flight two blocks ahead, and at its turn is
 *   converted once into a plane that the products read without converting
 *   again: float64 (DMMA), TF32 hi and lo, or bf16 pairs of rows (one
 *   register of a fragment).  n is padded with zeros to 16 (the 16 x 8 MMA
 *   tiles).  A warp owns up to kST 16 x 16 super tiles of the Gram's lower
 *   triangle for the whole kernel, their sums in registers (two 16 x 8
 *   tiles: each A fragment serves two products), so G leaves once,
 *   mirrored.  Plane strides: w + 4 float64s, w + 8 words (w = n padded
 *   to 16), so the Gram's fragments (rows t, columns g) meet no bank
 *   conflict.  Bound by bytes at (132, 73) on a 32,768-node chunk (A's and
 *   G's 0.59 ms, its products on the triangle 0.35 ms of DMMA).
 *
 * q_kernel<P> replaces tools/mxu_probe.py:185: Q = A Li^T, node-major, Li
 *   general.  Persistent blocks of 8 warps (the card's SMs x the blocks an
 *   SM holds, unless the launch gives the grid) walk the nodes blockIdx,
 *   blockIdx + grid, ...; a node's A and its Li arrive each by one
 *   cp.async.bulk of the 16-byte-aligned span that covers it, on an
 *   mbarrier.  Li is converted once a node into an operand plane (below)
 *   and its span is then free, so the next node's Li is in flight while
 *   this one computes.  A warp takes a row tile of 16 rows at a time: its A
 *   fragments for all k from the raw span into registers, converted once
 *   (kKS = 10 k steps, n <= 80; past that in chunks, reloaded per column
 *   tile), then the column tiles against the plane, kQT = 2 chains at
 *   once, so each fragment of Li costs one 8-byte load a product.  Row
 *   tiles go a warp each in passes of 8, and the rest of them (at m = 132
 *   the ninth, its 4 real rows) a column tile a unit over all the warps, so
 *   no warp idles a pass.  The passes write Q, rounded to float32, over
 *   their own rows of A's span, which leave by one bulk store a node (the
 *   at most 3 floats either side of its aligned interior by plain stores);
 *   the units write theirs to device memory.  Two spans of A where two
 *   blocks an SM still fit, so the next node's A is in flight too; else
 *   one, refilled once the store has read it.  Two blocks an SM at (132,
 *   73) (113,688 bytes, one span) and (108, 37), 122-126 registers: a
 *   block's copies, conversions and barriers overlap the other's products.
 *   Bound by bytes (A, Li and Q: 0.96 ms on a 32,768-node (132, 73) chunk,
 *   its DMMA work 0.69 ms).
 *
 * composite_kernel<P, kMinor> replaces tools/mxu_probe.py:215: (G1, G2) =
 *   (A^T A, Q^T Q), Q = A Li^T rounded to float32 (the TPU's
 *   preferred_element_type=f32), node-minor or node-major.  Persistent
 *   blocks of 16 warps, one an SM (n <= kCNarrow = 48, the Neumann class:
 *   8 warps, two an SM, so a block's barriers overlap the other's
 *   products); A's and Li's node streams as q_kernel's
 *   (node-minor: 4-byte asynchronous copies, which the layout's stride
 *   leaves), A double-buffered where two spans fit (the next node's A in
 *   flight for the whole node), else after the last rows are converted.
 *   A node goes in steps of kStep = 48 rows: the step's rows converted once
 *   into A's plane; then G1 += the step's Gram and, at once, the step's Q
 *   (3 row tiles x the column pairs: 16 x 16 units, warp W - 1 - u % W
 *   takes unit u, one each at n = 73) into Q's plane, rounded; a barrier; then G2 += Q's Gram while
 *   the next step's rows are converted; a barrier.  A warp owns one 16 x
 *   16 super tile of both Grams' lower triangles (15 at n <= 80, 6 at n <=
 *   48; one on
 *   the diagonal takes its B fragments from its A fragment), so G1's and
 *   G2's sums live in registers together and no unit waits on an idle
 *   warp.  G1 and G2 leave through the two planes by one bulk store each
 *   (node-minor: by plain 4-byte stores).  216,760 bytes at (132, 73): the
 *   Li plane alone is 53,760, so one block an SM, whose barriers (two a
 *   step) stall the SM's tensor cores.  Bound by its DMMA operations (1.39
 *   ms on the chunk; its bytes 1.00 ms).
 *
 * The operand planes of q_kernel and composite_kernel hold 8-byte entries
 * (Form<P>): a float64 (DMMA) or the TF32 pair (hi, lo) of a float32, so
 * one load fetches both halves of a split.  Row stride w + 4 entries (4
 * modulo 16): a fragment's reads along a row (rows g, columns t) and down
 * a column (rows t, columns g) fall in distinct bank pairs for each half
 * warp.
 *
 * node_transpose_kernel replaces tools/mxu_probe.py:108 (direction 0:
 *   node-minor (T, E, 128) -> node-major (B, E)) and :150 (direction 1,
 *   back), E = rows x columns of a node: 32 x 32 tiles through shared
 *   memory (stride 33), 128 contiguous bytes on both sides.  Bound by
 *   bytes.
 *
 * Node-minor is the TPU's VPU layout, (B / 128, rows, cols, 128) with a
 * node's entry (r, c) at ((tile rows + r) cols + c) 128 + node % 128;
 * node-major (B, rows, cols), the port's.  A node-minor block still takes
 * one node at a time: its 4-byte reads share 32-byte sectors with the
 * tile's other nodes, which the blocks beside it read through L2.
 *
 * Every launch function returns a cudaError_t as int (0 on success).
 */
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace {

using namespace bulk_copy;

constexpr int kWarps = 8, kThreads = 32 * kWarps;
constexpr int kRows = 32;    // rows of A a Gram block step stages
constexpr int kMaxN = 128;   // widest n of the Gram and Q
constexpr int kMaxNComposite = 80;
constexpr int kQWarps = 8, kQThreads = 32 * kQWarps;   // q_kernel: a row tile a warp
constexpr int kKS = 10;      // q_kernel: k steps of A a warp holds (n <= 80 at once)
constexpr int kQT = 2;       // q_kernel: column tiles a warp sums at once
constexpr int kCNarrow = 48;  // composite_kernel: 8 warps (2 blocks an SM) up to this n, else 16
constexpr int kStep = 48;    // composite_kernel: rows of A a step takes (3 row tiles)

enum { kDmma = 0, kTf32x3 = 1, kBf16 = 2 };
enum { kGram = 0, kQ = 1, kComposite = 2, kTranspose = 3 };

__host__ __device__ inline int pad_to(int x, int k) { return (x + k - 1) / k * k; }
// The Gram's planes' row stride (w = n padded to 16).  A Gram fragment
// reads rows t < 4 (bf16: pairs t) at columns g < 8: float64 at w + 4 (4
// or 12 modulo 16 doubles: each half warp's 16 doubles in distinct bank
// pairs), 32-bit words at w + 8 (8 or 24 modulo 32: the four rows 8 banks
// apart).
__host__ __device__ inline int a_ld(int prec, int w) { return prec == kDmma ? w + 4 : w + 8; }
// A Gram plane of kRows rows (floats): float64, TF32 hi and lo, or bf16 pairs
__host__ __device__ inline int plane_floats(int prec, int w) {
  const int ld = a_ld(prec, w);
  return prec == kBf16 ? kRows / 2 * ld : 2 * kRows * ld;
}

// A Gram block's shared memory (floats): A's two raw row blocks, its
// plane, the split's first part (w x w).
struct GramLayout {
  long long ap, part, total;
  __host__ __device__ GramLayout(int prec, int n, int split) {
    const int w = pad_to(n, 16);
    ap = 2LL * kRows * n;
    part = ap + plane_floats(prec, w);
    total = part + (split > 0 ? (long long)w * w : 0);
  }
};

// The 8-byte operand planes' row stride (q_kernel, composite_kernel): w +
// 4 entries, 4 modulo 16.
__host__ __device__ inline int plane_ld(int n) { return pad_to(n, 16) + 4; }
// Floats of a span that covers ``count`` floats from any 4-byte boundary:
// whole 16-byte words, one more than ``count`` needs at most.
__host__ __device__ inline long long span_floats(long long count) { return (count + 3) / 4 * 4 + 4; }

// q_kernel's shared memory (floats): ``nbuf`` spans of A (Q written over
// A), Li's span, Li's plane (n8 x ld entries), three mbarriers (A's two
// spans, Li).
struct QLayout {
  long long araw, lraw, lplane, bars, total;
  __host__ __device__ QLayout(int m, int n, int nbuf) {
    araw = span_floats((long long)m * n);
    lraw = nbuf * araw;
    lplane = lraw + span_floats((long long)n * n);
    bars = lplane + 2LL * pad_to(n, 8) * plane_ld(n);
    total = bars + 6;
  }
};

// composite_kernel's shared memory (floats): ``nbuf`` spans of A, Li's
// span, Li's plane (n8 x ld entries), A's and Q's step planes (kStep x
// ld), three mbarriers (A's two buffers, Li).
struct CompositeLayout {
  long long araw, lraw, lplane, aplane, qplane, bars, total;
  __host__ __device__ CompositeLayout(int m, int n, int nbuf) {
    const long long ld = plane_ld(n);
    araw = span_floats((long long)m * n);
    lraw = nbuf * araw;
    lplane = lraw + span_floats((long long)n * n);
    aplane = lplane + 2LL * pad_to(n, 8) * ld;
    qplane = aplane + 2LL * kStep * ld;
    bars = qplane + 2LL * kStep * ld;
    total = bars + 6;
  }
};

// ---- the three precisions' products

// D = A B + D for one 16 x 8 x 8 tile on the FP64 tensor cores (sm_90's
// shape), the fragments of m16n8k8.tf32 in float64: lane 4 g + t holds a =
// (A[g][t], A[g + 8][t], A[g][t + 4], A[g + 8][t + 4]), b = (B[t][g],
// B[t + 4][g]), c = (D[g][2t], D[g][2t + 1], D[g + 8][2t], D[g + 8][2t + 1]).
__device__ __forceinline__ void mma_f64_16x8x8(double (&c)[4], const double (&a)[4],
                                               const double (&b)[2]) {
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

// D = A B + D for one 16 x 8 x 8 tile in TF32 with float32 sums: lane 4 g +
// t holds a = (A[g][t], A[g + 8][t], A[g][t + 4], A[g + 8][t + 4]), b =
// (B[t][g], B[t + 4][g]), c = (D[g][2t], D[g][2t + 1], D[g + 8][2t],
// D[g + 8][2t + 1]).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
#ifdef CUDA_EMU
  emu_mma_m16n8k8_tf32(c, a, b);
#else
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#endif
}

// D = A B + D for one 16 x 8 x 16 tile in bf16 with float32 sums: lane 4 g +
// t holds a = (A[g][2t..2t+1], A[g + 8][2t..], A[g][2t + 8..], A[g + 8][2t +
// 8..]) and b = (B[2t..2t+1][g], B[2t + 8..2t + 9][g]), two values a
// register, the lower column or row in the low half; c as mma_tf32's.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
#ifdef CUDA_EMU
  emu_mma_m16n8k16_bf16(c, a, b);
#else
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#endif
}

// x rounded to TF32, to nearest with ties away from zero (cvt.rna)
__device__ __forceinline__ uint32_t to_tf32(float x) {
#ifdef CUDA_EMU
  return emu_cvt_rna_tf32(x);
#else
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
#endif
}

// hi = tf32(x), lo = tf32(x - hi): x - hi is exact in float32, and the
// asm keeps the compiler from folding it away
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// (lo, hi) rounded to bf16 (to nearest, ties to even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
#ifdef CUDA_EMU
  return emu_cvt_rn_bf16x2(hi, lo);
#else
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
#endif
}

// The Gram's operands, read as at(r, k): r the output's row (A operand)
// or column (B operand), k the contraction index.  Its planes hold a row
// block converted once (to_plane): DoubleOp float64 for DMMA, SplitOp TF32
// hi and lo, PairOp bf16 pairs along k, p[(k / 2) ks + r rs] = (X(r, k),
// X(r, k + 1)), each pair one register of a fragment.
struct DoubleOp {
  const double* p;
  int rs, ks;
};
struct SplitOp {
  const uint32_t *hi, *lo;
  int rs, ks;
};
struct PairOp {
  const uint32_t* p;
  int rs, ks;
};

__device__ __forceinline__ double dget(const DoubleOp& o, int r, int k) {
  return o.p[r * o.rs + k * o.ks];
}
__device__ __forceinline__ void tget(const SplitOp& o, int r, int k, uint32_t& hi, uint32_t& lo) {
  const int i = r * o.rs + k * o.ks;
  hi = o.hi[i];
  lo = o.lo[i];
}
// k even
__device__ __forceinline__ uint32_t bget(const PairOp& o, int r, int k) {
  return o.p[(k >> 1) * o.ks + r * o.rs];
}

// The sums of one 16 x 16 super tile C[i0 + i][j0 + j] += sum_k X(i0 + i, k)
// Y(j0 + j, k), by the MMA tiles of its precision; ``mask`` (the same for
// the whole warp) says which of them are taken: bit 2 r + c the DMMA tile
// (row r, column c), bit c the TF32/bf16 tile of columns 8c.. (all 16
// rows).  visit(f) calls f(row, col, sum) for each entry of a taken tile.
template <int P>
struct Tile;

// The m16n8k* shapes share their accumulator layout: each super tile
// one row tile of 16 and two column tiles of 8.
template <class T>
struct Tile16 {
  T c[2][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[q][e] = 0;
  }
  template <class F>
  __device__ __forceinline__ void visit(int i0, int j0, int mask, F f) const {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (!(mask >> q & 1)) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) f(i0 + g + 8 * (e >> 1), j0 + 8 * q + 2 * t + (e & 1), c[q][e]);
    }
  }
};

template <>
struct Tile<kDmma> : Tile16<double> {
  static constexpr int kK = 8;
  template <class XO, class YO>
  __device__ __forceinline__ void step(const XO& X, const YO& Y, int i0, int j0, int k0,
                                       int mask) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const double a[4] = {dget(X, i0 + g, k0 + t), dget(X, i0 + g + 8, k0 + t),
                         dget(X, i0 + g, k0 + t + 4), dget(X, i0 + g + 8, k0 + t + 4)};
#pragma unroll
    for (int q = 0; q < 2; ++q)
      if (mask >> q & 1) {
        const int j = j0 + 8 * q + g;
        const double b[2] = {dget(Y, j, k0 + t), dget(Y, j, k0 + t + 4)};
        mma_f64_16x8x8(c[q], a, b);
      }
  }
};

template <>
struct Tile<kTf32x3> : Tile16<float> {
  static constexpr int kK = 8;
  template <class XO, class YO>
  __device__ __forceinline__ void step(const XO& X, const YO& Y, int i0, int j0, int k0,
                                       int mask) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    uint32_t ah[4], al[4];
    tget(X, i0 + g, k0 + t, ah[0], al[0]);
    tget(X, i0 + g + 8, k0 + t, ah[1], al[1]);
    tget(X, i0 + g, k0 + t + 4, ah[2], al[2]);
    tget(X, i0 + g + 8, k0 + t + 4, ah[3], al[3]);
#pragma unroll
    for (int q = 0; q < 2; ++q)
      if (mask >> q & 1) {
        uint32_t bh[2], bl[2];
        tget(Y, j0 + 8 * q + g, k0 + t, bh[0], bl[0]);
        tget(Y, j0 + 8 * q + g, k0 + t + 4, bh[1], bl[1]);
        // the small terms first
        mma_tf32(c[q], al, bh);
        mma_tf32(c[q], ah, bl);
        mma_tf32(c[q], ah, bh);
      }
  }
};

template <>
struct Tile<kBf16> : Tile16<float> {
  static constexpr int kK = 16;
  template <class XO, class YO>
  __device__ __forceinline__ void step(const XO& X, const YO& Y, int i0, int j0, int k0,
                                       int mask) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3, k = k0 + 2 * t;
    const uint32_t a[4] = {bget(X, i0 + g, k), bget(X, i0 + g + 8, k), bget(X, i0 + g, k + 8),
                           bget(X, i0 + g + 8, k + 8)};
#pragma unroll
    for (int q = 0; q < 2; ++q)
      if (mask >> q & 1) {
        const int j = j0 + 8 * q + g;
        const uint32_t b[2] = {bget(Y, j, k), bget(Y, j, k + 8)};
        mma_bf16(c[q], a, b);
      }
  }
};

// The tiles taken of a 16 x 16 super tile at rows i0.., columns j0..:
// bit q for the column tile 8q.. if the rows start below ``rows`` and its
// columns below n8 (n padded to 8).
__device__ __forceinline__ int tile_mask(int i0, int j0, int rows, int n8) {
  int mask = 0;
  if (i0 < rows) {
#pragma unroll
    for (int q = 0; q < 2; ++q)
      if (j0 + 8 * q < n8) mask |= 1 << q;
  }
  return mask;
}

// Entry (r, c) of a node's rows x cols matrix, node-major or node-minor.
template <bool kMinor>
__device__ __forceinline__ long long entry(long long node, int rows, int cols, int r, int c) {
  if (kMinor) return ((((node >> 7) * rows + r) * cols + c) << 7) + (node & 127);
  return (node * rows + r) * cols + c;
}

// Rows [r0, r0 + rows) of the node's m x n A into raw, flat (rows x n),
// by asynchronous copies (committed by the caller): node-major rows are
// contiguous, so 16 bytes a copy where they start 16-byte aligned.
template <bool kMinor>
__device__ void stage_raw(const float* A, long long node, int m, int n, int r0, int rows,
                          float* raw) {
  const int count = rows * n;
  if (kMinor) {
    for (int i = threadIdx.x; i < count; i += kThreads) {
      const int r = i / n;
      __pipeline_memcpy_async(raw + i, A + entry<true>(node, m, n, r0 + r, i - r * n),
                              sizeof(float));
    }
    return;
  }
  const float* src = A + entry<false>(node, m, n, r0, 0);
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    done = count / 4 * 4;
    for (int i = 4 * threadIdx.x; i < done; i += 4 * kThreads)
      __pipeline_memcpy_async(raw + i, src + i, 4 * sizeof(float));
  }
  for (int i = done + threadIdx.x; i < count; i += kThreads)
    __pipeline_memcpy_async(raw + i, src + i, sizeof(float));
}

// A row block from raw (rows x n) into its plane (kRows rows, w columns at
// stride ld, zeros past rows and n): float64, TF32 hi and lo (lo after
// hi), or bf16 pairs of rows.
template <int P>
__device__ void to_plane(const float* raw, int rows, int n, int w, int ld, float* plane) {
  auto at = [&](int r, int c) { return r < rows && c < n ? raw[r * n + c] : 0.f; };
  if (P == kBf16) {
    uint32_t* pb = reinterpret_cast<uint32_t*>(plane);
    for (int i = threadIdx.x; i < kRows / 2 * w; i += kThreads) {
      const int q = i / w, c = i - q * w;
      pb[q * ld + c] = pack_bf16(at(2 * q, c), at(2 * q + 1, c));
    }
    return;
  }
  for (int i = threadIdx.x; i < kRows * w; i += kThreads) {
    const int r = i / w, c = i - r * w;
    const float v = at(r, c);
    if (P == kDmma) {
      reinterpret_cast<double*>(plane)[r * ld + c] = v;
    } else {
      uint32_t* hi = reinterpret_cast<uint32_t*>(plane);
      split_tf32(v, hi[r * ld + c], hi[kRows * ld + r * ld + c]);
    }
  }
}

// The Gram operand of a plane: X(i, k) at row k, column i.
template <int P>
struct PlaneOp;
template <>
struct PlaneOp<kDmma> {
  __device__ static DoubleOp gram(const float* p, int ld) { return {reinterpret_cast<const double*>(p), 1, ld}; }
};
template <>
struct PlaneOp<kTf32x3> {
  __device__ static SplitOp gram(const float* p, int ld) {
    const uint32_t* hi = reinterpret_cast<const uint32_t*>(p);
    return {hi, hi + kRows * ld, 1, ld};
  }
};
template <>
struct PlaneOp<kBf16> {
  __device__ static PairOp gram(const float* p, int ld) { return {reinterpret_cast<const uint32_t*>(p), 1, ld}; }
};

// The warp's Gram super tiles into out (n x n a node), each entry of the
// lower triangle written at (i, j) and (j, i); where ``part`` is not null
// (a split Gram) on top of the first part's float32 sums it holds (w x w,
// each entry written and read by the same thread).  (Writing G through
// shared memory, the block's rows whole, was slower on the card: two more
// barriers and a pass over n^2 entries.)
template <bool kMinor, int P, int kST>
__device__ void store_gram(const Tile<P> (&t)[kST], const int (&gi)[kST], const int (&gj)[kST],
                           const int (&gm)[kST], float* out, long long node, int n,
                           const float* part, int w) {
#pragma unroll
  for (int q = 0; q < kST; ++q) {
    if (!gm[q]) continue;
    t[q].visit(gi[q], gj[q], gm[q], [&](int i, int j, auto v) {
      if (i >= n || j > i) return;
      const float f = part ? part[i * w + j] + (float)v : (float)v;
      out[entry<kMinor>(node, n, n, i, j)] = f;
      out[entry<kMinor>(node, n, n, j, i)] = f;
    });
  }
}

// Row blocks of A: [0, p1) then [p1, m) (p1 = split, or m), kRows at a
// time; block b starts at row r0 and holds the returned count.
struct RowBlocks {
  int m, p1, nb1, nb;
  __host__ __device__ RowBlocks(int m_, int split) : m(m_) {
    p1 = split > 0 ? split : m;
    nb1 = (p1 + kRows - 1) / kRows;
    nb = nb1 + (split > 0 ? (m - split + kRows - 1) / kRows : 0);
  }
  __device__ int rows(int b, int& r0) const {
    r0 = b < nb1 ? b * kRows : p1 + (b - nb1) * kRows;
    return min(kRows, (b < nb1 ? p1 : m) - r0);
  }
};

// G = A^T A, rows [0, split) and [split, m) summed apart (split 0: none).
// One block a node.  Row block b's raw copy is in flight two blocks ahead
// (two raw buffers); at its turn it is converted once into the plane the
// products read.  Three blocks an SM up to n = 80 (at most 85 registers;
// its DMMA instance ran faster that way than with two), two past it.
template <int P, bool kMinor, int kST>
__global__ void __launch_bounds__(kThreads, kST == 2 ? 3 : 2)
    gram_kernel(const float* __restrict__ A, float* __restrict__ G, int m, int n, int split) {
  constexpr int kK = Tile<P>::kK;
  extern __shared__ __align__(16) float smem[];
  const long long node = blockIdx.x;
  const int w = pad_to(n, 16), n8 = pad_to(n, 8), S = w / 16;
  const int ld = a_ld(P, w);
  const RowBlocks rb(m, split);
  const GramLayout lay(P, n, split);
  float* const raw0 = smem;
  float* const raw1 = raw0 + kRows * n;
  float* const Ap = smem + lay.ap;
  float* const part = smem + lay.part;
  const int warp = threadIdx.x / 32;

  // the warp's super tiles of the Gram's lower triangle: s -> (si, sj)
  int gi[kST], gj[kST], gm[kST];
  const int nst = S * (S + 1) / 2;
#pragma unroll
  for (int q = 0; q < kST; ++q) {
    int s = warp + kWarps * q, si = 0;
    gi[q] = gj[q] = gm[q] = 0;
    if (s >= nst) continue;
    while (s > si) s -= ++si;
    gi[q] = 16 * si;
    gj[q] = 16 * s;
    gm[q] = tile_mask(gi[q], gj[q], n8, n8);
  }
  Tile<P> g1[kST];
#pragma unroll
  for (int q = 0; q < kST; ++q) g1[q].zero();

  for (int b = 0; b < 2; ++b) {
    if (b < rb.nb) {
      int r0;
      const int rows = rb.rows(b, r0);
      stage_raw<kMinor>(A, node, m, n, r0, rows, b ? raw1 : raw0);
    }
    __pipeline_commit();
  }

  for (int b = 0; b < rb.nb; ++b) {
    int r0;
    const int rows = rb.rows(b, r0), rp = pad_to(rows, kK);
    float* const raw = (b & 1) ? raw1 : raw0;
    __pipeline_wait_prior(1);
    __syncthreads();   // block b staged; every warp is done with block b - 1's plane
    to_plane<P>(raw, rows, n, w, ld, Ap);
    __syncthreads();   // the plane is ready and raw is free
    if (b + 2 < rb.nb) {
      int s0;
      const int rows2 = rb.rows(b + 2, s0);
      stage_raw<kMinor>(A, node, m, n, s0, rows2, raw);
    }
    __pipeline_commit();
    const auto X = PlaneOp<P>::gram(Ap, ld);
#pragma unroll
    for (int q = 0; q < kST; ++q) {
      if (!gm[q]) continue;
#pragma unroll 2
      for (int k0 = 0; k0 < rp; k0 += kK) g1[q].step(X, X, gi[q], gj[q], k0, gm[q]);
    }
    if (split > 0 && b == rb.nb1 - 1) {   // the first part, rounded
#pragma unroll
      for (int q = 0; q < kST; ++q) {
        if (!gm[q]) continue;
        g1[q].visit(gi[q], gj[q], gm[q], [&](int i, int j, auto v) { part[i * w + j] = (float)v; });
        g1[q].zero();
      }
    }
  }
  store_gram<kMinor>(g1, gi, gj, gm, G, node, n, split > 0 ? part : nullptr, w);
}

// ---- q_kernel and composite_kernel: persistent blocks on 8-byte planes

// An operand in the planes and registers, by precision: a float64 (DMMA)
// or the TF32 pair (hi, lo) of a float32, and the sums' type.
template <int P>
struct Form;
template <>
struct Form<kDmma> {
  typedef double T;
  typedef double C;
  __device__ static T from(float x) { return x; }
};
template <>
struct Form<kTf32x3> {
  typedef uint2 T;
  typedef float C;
  __device__ static T from(float x) {
    uint2 r;
    split_tf32(x, r.x, r.y);
    return r;
  }
};

// D = A B + D for one 16 x 8 x 8 tile of operand entries: one DMMA, or the
// three TF32 products of the pairs, the small terms first.
__device__ __forceinline__ void mma(double (&c)[4], const double (&a)[4], const double (&b)[2]) {
  mma_f64_16x8x8(c, a, b);
}
__device__ __forceinline__ void mma(float (&c)[4], const uint2 (&a)[4], const uint2 (&b)[2]) {
  const uint32_t ah[4] = {a[0].x, a[1].x, a[2].x, a[3].x}, al[4] = {a[0].y, a[1].y, a[2].y, a[3].y};
  const uint32_t bh[2] = {b[0].x, b[1].x}, bl[2] = {b[0].y, b[1].y};
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

// The super tile s at rows i0.., columns j0.. (column tiles by ``mask``,
// as Tile's): s(i, j) += sum_{k0 <= k < k0 + 8} X(i, k) Y(j, k), X(i, k) =
// x[i xr + k xk] and Y(j, k) = y[j yr + k yk] in plane entries.
// ``diag`` (a Gram's super tile on the diagonal: x is y, i0 is j0): column
// tile q's B fragment is rows 8q.. of the A fragment, so it is not loaded.
template <int P>
__device__ __forceinline__ void plane_step(Tile16<typename Form<P>::C>& s,
                                           const typename Form<P>::T* x, int xr, int xk,
                                           const typename Form<P>::T* y, int yr, int yk, int i0,
                                           int j0, int k0, int mask, bool diag = false) {
  typedef typename Form<P>::T T;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const T a[4] = {x[(i0 + g) * xr + (k0 + t) * xk], x[(i0 + g + 8) * xr + (k0 + t) * xk],
                  x[(i0 + g) * xr + (k0 + t + 4) * xk], x[(i0 + g + 8) * xr + (k0 + t + 4) * xk]};
#pragma unroll
  for (int q = 0; q < 2; ++q)
    if (mask >> q & 1) {
      const int j = j0 + 8 * q + g;
      T b[2];
      if (diag) {
        b[0] = a[q];
        b[1] = a[q + 2];
      } else {
        b[0] = y[j * yr + (k0 + t) * yk];
        b[1] = y[j * yr + (k0 + t + 4) * yk];
      }
      mma(s.c[q], a, b);
    }
}

// Rows [0, prow) x columns [0, pcol) of the plane p (stride ld): entry (r,
// c) of x (rows x cols, row-major), zeros past it; a warp a row, a lane a
// column.
template <int P>
__device__ void to_operand_plane(const float* x, int rows, int cols, int prow, int pcol, int ld,
                                 typename Form<P>::T* p) {
  const int lane = threadIdx.x & 31, warps = blockDim.x / 32;
  for (int r = threadIdx.x / 32; r < prow; r += warps) {
    const float* const xr = x + r * cols;
    typename Form<P>::T* const pr = p + r * ld;
    for (int c = lane; c < pcol; c += 32) pr[c] = Form<P>::from(r < rows && c < cols ? xr[c] : 0.f);
  }
}

// The floats of p past its 16-byte boundary.
__device__ __forceinline__ int span_head(const float* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// Thread 0: the 16-byte span that covers x[0, count) into dst, on bar;
// dst[span_head(x)] is then x[0].
__device__ __forceinline__ void load_span(float* dst, const float* x, long long count,
                                          uint64_t* bar) {
  if (threadIdx.x != 0) return;
  const int h = span_head(x);
  bulk_load(dst, x - h, (unsigned)((h + count + 3) / 4 * 16), bar);
}

// The calling thread: x[0, count) from s (s and x equal modulo 16 bytes)
// to device memory, its 16-byte-aligned interior by one bulk store in the
// open group, the at most 3 floats either side of it by plain stores.
__device__ __forceinline__ void store_span(float* x, const float* s, long long count) {
  const long long lo = min((long long)((4 - span_head(x)) & 3), count);
  const long long hi = lo + (count - lo) / 4 * 4;
  for (long long i = 0; i < lo; ++i) x[i] = s[i];
  for (long long i = hi; i < count; ++i) x[i] = s[i];
  if (hi > lo) bulk_store(x + lo, s + lo, (unsigned)(4 * (hi - lo)));
}

// A warp's A fragments of rows r0.. (a row tile) at k steps [kKS c, kKS (c
// + 1)), from the raw rows x (m x n, row-major), zeros past m and n.
template <int P>
__device__ __forceinline__ void load_rows(typename Form<P>::T (&a)[kKS][4], const float* x,
                                          int r0, int c, int m, int n) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int ks = 0; ks < kKS; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + g + 8 * (e & 1), k = 8 * (kKS * c + ks) + t + 4 * (e >> 1);
      a[ks][e] = Form<P>::from(r < m && k < n ? x[r * n + k] : 0.f);
    }
}

// Q's column tiles from j0 up to kQT of them, below ``jend``, of the
// warp's row tile from its fragments ``a`` (chunk ``ch`` of kKS k steps;
// all of k when n8 <= 8 kKS) against Li's plane, each column tile its own
// sums.
template <int P>
__device__ __forceinline__ void q_tiles(typename Form<P>::C (&c)[kQT][4],
                                        const typename Form<P>::T (&a)[kKS][4],
                                        const typename Form<P>::T* Lp, int ld, int n8, int jend,
                                        int j0, int ch) {
  typedef typename Form<P>::T T;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int ks = 0; ks < kKS; ++ks) {
    const int k0 = 8 * (kKS * ch + ks);
    if (k0 >= n8) break;
#pragma unroll
    for (int q = 0; q < kQT; ++q)
      if (j0 + 8 * q < jend) {
        const T* y = Lp + (j0 + 8 * q + g) * ld + k0 + t;
        const T b[2] = {y[0], y[4]};
        mma(c[q], a[ks], b);
      }
  }
}

// Q = A Li^T on B node-major nodes (the file's head says how); ``nbuf``
// spans of A.
template <int P>
__global__ void __launch_bounds__(kQThreads, 2)
    q_kernel(const float* __restrict__ A, const float* __restrict__ Li, float* __restrict__ Q,
             long long B, int m, int n, int nbuf) {
  typedef typename Form<P>::T T;
  typedef typename Form<P>::C C;
  extern __shared__ __align__(16) float smem[];
  const QLayout lay(m, n, nbuf);
  float* const Lraw = smem + lay.lraw;
  T* const Lp = reinterpret_cast<T*>(smem + lay.lplane);
  uint64_t* const bar = reinterpret_cast<uint64_t*>(smem + lay.bars);   // A's two, Li's
  const int warp = threadIdx.x / 32, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int n8 = pad_to(n, 8), nct = n8 / 8, ld = plane_ld(n), chunks = (nct + kKS - 1) / kKS;
  // row tiles [0, full) a warp each, in passes, Q over their rows of A; the
  // rest a column tile a unit, units [k warp, k warp + k), Q to device memory
  const int tiles = (m + 15) / 16, full = chunks == 1 ? tiles / kQWarps * kQWarps : 0;
  const int units = (tiles - full) * nct, k = (units + kQWarps - 1) / kQWarps;
  const long long mn = (long long)m * n, nn = (long long)n * n, staged = min(16LL * full, (long long)m) * n;
  long long node = blockIdx.x;
  if (threadIdx.x == 0) {
    for (int b = 0; b < 3; ++b) mbar_init(&bar[b], 1);
    if (node < B) {   // every copy is issued before the barrier that precedes its wait
      load_span(smem, A + node * mn, mn, &bar[0]);
      load_span(Lraw, Li + node * nn, nn, &bar[2]);
    }
  }
  __syncthreads();
  for (unsigned it = 0; node < B; ++it, node += gridDim.x) {
    const long long next = node + gridDim.x;
    const int buf = nbuf == 2 ? it & 1 : 0;
    mbar_wait(&bar[2], it & 1);
    to_operand_plane<P>(Lraw + span_head(Li + node * nn), n, n, n8, n8, ld, Lp);
    __syncthreads();   // Li's plane is in; its span is free for the next node's
    if (threadIdx.x == 0 && next < B) {
      load_span(Lraw, Li + next * nn, nn, &bar[2]);
      if (nbuf == 2) {   // into the other span, once the last node's Q has left it
        if (it > 0) bulk_wait_read();
        load_span(smem + (buf ^ 1) * lay.araw, A + next * mn, mn, &bar[buf ^ 1]);
      }
    }
    mbar_wait(&bar[buf], (it / nbuf) & 1);
    float* const An = smem + buf * lay.araw + span_head(A + node * mn);   // A, then Q over it
    float* const Qn = Q + node * mn;
    T a[kKS][4];
    for (int r0 = 16 * warp; r0 < 16 * full; r0 += 16 * kQWarps) {
      load_rows<P>(a, An, r0, 0, m, n);
      __syncwarp();   // the warp's fragments are in before Q is written over its rows
      for (int j0 = 0; j0 < n8; j0 += 8 * kQT) {
        C c[kQT][4] = {};
        q_tiles<P>(c, a, Lp, ld, n8, n8, j0, 0);
#pragma unroll
        for (int q = 0; q < kQT; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = r0 + g + 8 * (e >> 1), col = j0 + 8 * q + 2 * t + (e & 1);
            if (r < m && col < n) An[r * n + col] = (float)c[q][e];
          }
      }
    }
    for (int u = k * warp, r0 = -1; u < min(k * (warp + 1), units); ++u) {
      const int r1 = 16 * (full + u / nct), j0 = 8 * (u % nct);
      C c[kQT][4] = {};
      for (int ch = 0; ch < chunks; ++ch) {
        if (chunks > 1 || r1 != r0) load_rows<P>(a, An, r1, ch, m, n);
        q_tiles<P>(c, a, Lp, ld, n8, j0 + 8, j0, ch);   // the one column tile j0
      }
      r0 = r1;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r1 + g + 8 * (e >> 1), col = j0 + 2 * t + (e & 1);
        if (r < m && col < n) Qn[r * n + col] = (float)c[0][e];
      }
    }
    fence_async_shared();
    __syncthreads();   // Q's staged rows are in; every warp is done with A's span and Li's plane
    if (threadIdx.x == 0) {
      if (staged > 0) {
        store_span(Qn, An, staged);
        bulk_commit();
      }
      if (nbuf == 1) {   // one span: the next node's A once Q has left it
        bulk_wait_read();
        if (next < B) load_span(smem, A + next * mn, mn, &bar[0]);
      }
    }
  }
  if (threadIdx.x == 0) bulk_wait();
}

// The node's rows x cols matrix of x into dst: node-major by load_span
// (thread 0, on bar: from dst[span_head]), node-minor by every thread's
// 4-byte asynchronous copies, row-major from dst[0], one committed group.
template <bool kMinor>
__device__ void fetch(float* dst, const float* x, long long node, int rows, int cols,
                      uint64_t* bar) {
  const long long count = (long long)rows * cols;
  if (!kMinor) {
    load_span(dst, x + node * count, count, bar);
    return;
  }
  // entry i = r cols + c of the node at ((tile rows cols + i) 128 + node % 128
  const float* const xn = x + (node >> 7) * count * 128 + (node & 127);
  for (int i = threadIdx.x; i < count; i += blockDim.x)
    __pipeline_memcpy_async(dst + i, xn + (long long)i * 128, sizeof(float));
  __pipeline_commit();
}
// This thread's copies of fetch are in (node-minor; a block barrier then
// shows every thread's), or the phase of bar with this parity (node-major).
template <bool kMinor>
__device__ __forceinline__ void await(uint64_t* bar, unsigned parity) {
  if (kMinor)
    __pipeline_wait_prior(0);
  else
    mbar_wait(bar, parity);
}
// Where fetch put the node's first entry (and where a node-major output
// starts in its staging span).
template <bool kMinor>
__device__ __forceinline__ int head(const float* x, long long node, long long count) {
  return kMinor ? 0 : span_head(x + node * count);
}

// (G1, G2) = (A^T A, Q^T Q), Q = A Li^T rounded to float32, on B nodes
// (the file's head says how); W warps a block.
template <int P, bool kMinor, int W>
__global__ void __launch_bounds__(32 * W, 16 / W)
    composite_kernel(const float* __restrict__ A, const float* __restrict__ Li,
                     float* __restrict__ G1, float* __restrict__ G2, long long B, int m, int n,
                     int nbuf) {
  typedef typename Form<P>::T T;
  typedef typename Form<P>::C C;
  extern __shared__ __align__(16) float smem[];
  const CompositeLayout lay(m, n, nbuf);
  const int n8 = pad_to(n, 8), w = pad_to(n, 16), ld = plane_ld(n), S = w / 16;
  const long long mn = (long long)m * n, nn = (long long)n * n;
  float* const Lraw = smem + lay.lraw;
  T* const Lp = reinterpret_cast<T*>(smem + lay.lplane);
  T* const Ap = reinterpret_cast<T*>(smem + lay.aplane);
  T* const Qp = reinterpret_cast<T*>(smem + lay.qplane);
  uint64_t* const bar = reinterpret_cast<uint64_t*>(smem + lay.bars);   // A's two, Li's
  const int warp = threadIdx.x / 32;
  // the warp's super tile (si, sj) of both Grams' lower triangles (W of
  // them at most)
  int si = 0, sj = warp;
  while (sj > si) sj -= ++si;
  const int gi = 16 * si, gj = 16 * sj, gm = warp < S * (S + 1) / 2 ? tile_mask(gi, gj, n8, n8) : 0;
  if (threadIdx.x == 0)
    for (int b = 0; b < 3; ++b) mbar_init(&bar[b], 1);
  long long node = blockIdx.x;
  if (node < B) {   // every copy is issued before the barrier that precedes its wait
    fetch<kMinor>(smem, A, node, m, n, &bar[0]);
    fetch<kMinor>(Lraw, Li, node, n, n, &bar[2]);
  }
  __syncthreads();
  const int steps = (m + kStep - 1) / kStep;
  for (unsigned it = 0; node < B; ++it, node += gridDim.x) {
    const long long next = node + gridDim.x;
    const int buf = it % nbuf;
    const float* const An = smem + buf * lay.araw + head<kMinor>(A, node, mn);
    if (!kMinor && threadIdx.x == 0) bulk_wait_read();   // the last node's G has left the planes
    await<kMinor>(&bar[2], it & 1);
    await<kMinor>(&bar[buf], (it / nbuf) & 1);
    __syncthreads();
    const int rows0 = min(m, kStep);
    to_operand_plane<P>(Lraw + head<kMinor>(Li, node, nn), n, n, n8, n8, ld, Lp);
    to_operand_plane<P>(An, rows0, n, pad_to(rows0, 16), w, ld, Ap);
    __syncthreads();   // the planes are in; Li's span is free for the next node's
    if (next < B) {
      fetch<kMinor>(Lraw, Li, next, n, n, &bar[2]);
      if (nbuf == 2) fetch<kMinor>(smem + (buf ^ 1) * lay.araw, A, next, m, n, &bar[buf ^ 1]);
    }
    Tile16<C> g1, g2;
    g1.zero();
    g2.zero();
    for (int s = 0; s < steps; ++s) {
      const int rows = min(kStep, m - kStep * s), kp = pad_to(rows, 8), tiles = (rows + 15) / 16;
      // one buffer: A's last rows are in their plane, so its span is free
      if (nbuf == 1 && s == steps - 1 && next < B) fetch<kMinor>(smem, A, next, m, n, &bar[0]);
      if (gm)
#pragma unroll 2
        for (int k0 = 0; k0 < kp; k0 += 8)
          plane_step<P>(g1, Ap, 1, ld, Ap, 1, ld, gi, gj, k0, gm, gi == gj);
      // warp W - 1 - u % W takes unit u of the step's Q: row tile u / S, column pair u % S
      for (int u = W - 1 - warp; u < tiles * S; u += W) {
        const int qi = 16 * (u / S), qj = 16 * (u % S), mask = tile_mask(qi, qj, 16 * tiles, n8);
        Tile16<C> q;
        q.zero();
#pragma unroll 2
        for (int k0 = 0; k0 < n8; k0 += 8) plane_step<P>(q, Ap, ld, 1, Lp, ld, 1, qi, qj, k0, mask);
        q.visit(qi, qj, mask, [&](int i, int j, C v) { Qp[i * ld + j] = Form<P>::from((float)v); });
      }
      __syncthreads();   // the step's Q is in its plane; A's plane is free
      if (gm)
#pragma unroll 2
        for (int k0 = 0; k0 < kp; k0 += 8)
          plane_step<P>(g2, Qp, 1, ld, Qp, 1, ld, gi, gj, k0, gm, gi == gj);
      if (s + 1 < steps) {
        const int r1 = kStep * (s + 1), rows1 = min(kStep, m - r1);
        to_operand_plane<P>(An + r1 * n, rows1, n, pad_to(rows1, 16), w, ld, Ap);
      }
      __syncthreads();   // the next step's rows are in; Q's plane is free
    }
    // G1 and G2 out through the planes, each entry of the lower triangle at
    // (i, j) and (j, i)
    float* const S1 = reinterpret_cast<float*>(Ap) + head<kMinor>(G1, node, nn);
    float* const S2 = reinterpret_cast<float*>(Qp) + head<kMinor>(G2, node, nn);
    if (gm) {
      g1.visit(gi, gj, gm, [&](int i, int j, C v) {
        if (i < n && j <= i) S1[i * n + j] = S1[j * n + i] = (float)v;
      });
      g2.visit(gi, gj, gm, [&](int i, int j, C v) {
        if (i < n && j <= i) S2[i * n + j] = S2[j * n + i] = (float)v;
      });
    }
    if (!kMinor) fence_async_shared();
    __syncthreads();
    if (kMinor) {
      const long long at = (node >> 7) * nn * 128 + (node & 127);
      for (int i = threadIdx.x; i < nn; i += blockDim.x) {
        G1[at + (long long)i * 128] = S1[i];
        G2[at + (long long)i * 128] = S2[i];
      }
    } else if (threadIdx.x == 0) {
      store_span(G1 + node * nn, S1, nn);
      store_span(G2 + node * nn, S2, nn);
      bulk_commit();
    }
  }
  if (!kMinor && threadIdx.x == 0) bulk_wait();
}

// direction 0: x node-minor (T, E, 128) -> y node-major (nodes, E);
// direction 1: x node-major (nodes, E) -> y node-minor (T, E, 128), zeros
// for the tile's slots past ``nodes``.  Block b: 32 nodes x 32 entries.
__global__ void __launch_bounds__(kThreads)
    node_transpose_kernel(const float* __restrict__ x, float* __restrict__ y, long long nodes,
                          int E, int direction) {
  __shared__ float tile[32][33];
  const int eb = (E + 31) / 32;
  const long long nb = blockIdx.x / eb;   // 32-node block
  const int e0 = (int)(blockIdx.x % eb) * 32;
  const long long tt = nb >> 2, n0 = nb * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  if (direction == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = e0 + ty + 8 * q;
      if (e < E) tile[ty + 8 * q][tx] = x[((tt * E + e) << 7) + (n0 & 127) + tx];
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long node = n0 + ty + 8 * q;
      const int e = e0 + tx;
      if (e < E && node < nodes) y[node * E + e] = tile[tx][ty + 8 * q];
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long node = n0 + ty + 8 * q;
      const int e = e0 + tx;
      tile[ty + 8 * q][tx] = e < E && node < nodes ? x[node * E + e] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = e0 + ty + 8 * q;
      if (e < E) y[((tt * E + e) << 7) + (n0 & 127) + tx] = tile[tx][ty + 8 * q];
    }
  }
}

typedef void (*GramKernel)(const float*, float*, int, int, int);
typedef void (*QKernel)(const float*, const float*, float*, long long, int, int, int);
typedef void (*CompositeKernel)(const float*, const float*, float*, float*, long long, int, int,
                                int);

template <int P, bool kMinor>
CompositeKernel composite_instance(int n) {
  return n <= kCNarrow ? composite_kernel<P, kMinor, 8> : composite_kernel<P, kMinor, 16>;
}

// Super tiles a warp holds for the Gram of n columns: 2 up to n = 80 (15
// super tiles over 8 warps), 5 up to 128 (36).
inline int super_tiles(int n) {
  const int S = pad_to(n, 16) / 16, nst = S * (S + 1) / 2;
  return nst <= 2 * kWarps ? 2 : nst <= 5 * kWarps ? 5 : 0;
}

template <int P, bool kMinor>
GramKernel pick(int st) {
  return st == 2 ? gram_kernel<P, kMinor, 2> : st == 5 ? gram_kernel<P, kMinor, 5> : nullptr;
}

// The Gram's instance (any n <= 128, DMMA and TF32 in either layout, bf16
// node-major n <= 80), or nullptr.
GramKernel gram_instance(int prec, int minor, int n) {
  const int st = super_tiles(n);
  if (st == 0) return nullptr;
  if (prec == kBf16) return minor || st != 2 ? nullptr : gram_kernel<kBf16, false, 2>;
  if (prec == kDmma) return minor ? pick<kDmma, true>(st) : pick<kDmma, false>(st);
  return minor ? pick<kTf32x3, true>(st) : pick<kTf32x3, false>(st);
}

int smem_optin() {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return optin;
}

// A probe's launch: its kernel (one of the three forms), threads, dynamic
// shared memory (floats) and A's buffers (the composite); no kernel where
// the probe has no instance.
struct Plan {
  GramKernel gram = nullptr;
  QKernel q = nullptr;
  CompositeKernel composite = nullptr;
  int threads = kThreads, nbuf = 1;
  long long floats = 0;
  const void* kernel() const {
    return gram ? (const void*)gram : q ? (const void*)q : (const void*)composite;
  }
};

Plan plan(int what, int prec, int minor, int m, int n, int split) {
  Plan p;
  if (m <= 0 || n <= 0 || n > kMaxN || prec < kDmma || prec > kBf16) return p;
  if (what == kGram) {
    p.gram = gram_instance(prec, minor, n);
    p.floats = GramLayout(prec, n, split).total;
  } else if (what == kQ && !minor && prec != kBf16) {
    p.q = prec == kDmma ? q_kernel<kDmma> : q_kernel<kTf32x3>;
    p.threads = kQThreads;
    // two spans of A where two blocks an SM still fit
    p.nbuf = 2 * QLayout(m, n, 2).total * (long long)sizeof(float) <= smem_optin() ? 2 : 1;
    p.floats = QLayout(m, n, p.nbuf).total;
  } else if (what == kComposite && prec != kBf16 && n <= kMaxNComposite) {
    if (prec == kDmma)
      p.composite = minor ? composite_instance<kDmma, true>(n) : composite_instance<kDmma, false>(n);
    else
      p.composite = minor ? composite_instance<kTf32x3, true>(n) : composite_instance<kTf32x3, false>(n);
    // 8 warps two blocks an SM, 16 one: two spans of A where those still fit
    const int per_sm = n <= kCNarrow ? 2 : 1;
    p.threads = 32 * 16 / per_sm;
    p.nbuf = per_sm * CompositeLayout(m, n, 2).total * (long long)sizeof(float) <= smem_optin() ? 2 : 1;
    p.floats = CompositeLayout(m, n, p.nbuf).total;
  }
  return p;
}

// The launch's dynamic shared memory, set on its kernel; an error where
// there is no instance or the node does not fit.
cudaError_t prepare(const void* kernel, long long floats, size_t* bytes) {
  if (kernel == nullptr) return cudaErrorInvalidValue;
  *bytes = (size_t)floats * sizeof(float);
  if (*bytes > (size_t)smem_optin()) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
}

}  // namespace

// A launch's dynamic shared memory, threads, the blocks an SM holds, and
// its registers and local memory bytes (spills) a thread: ``what`` 0 the
// Gram, 1 Q, 2 the composite (precision 0 DMMA, 1 TF32x3, 2 bf16; minor
// the node-minor layout) at m x n with the split row, 3 node_transpose;
// returns the cudaError_t.
extern "C" int mxu_probes_occupancy(int what, int prec, int minor, int m, int n, int split,
                                    long long* smem_bytes, int* threads, int* blocks_per_sm,
                                    int* regs, long long* local_bytes) {
  Plan p;
  const void* kernel = (const void*)node_transpose_kernel;
  if (what != kTranspose) {
    p = plan(what, prec, minor, m, n, split);
    kernel = p.kernel();
  }
  size_t bytes = 0;
  cudaError_t err = prepare(kernel, p.floats, &bytes);
  if (err != cudaSuccess) return (int)err;
  *smem_bytes = (long long)bytes;
  *threads = p.threads;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (long long)attr.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, p.threads, bytes);
}

// The product probes on B nodes of m x n A (and n x n Li): ``what`` 0 O1
// = A^T A (split: the row where the second part starts, 0 none), one block
// a node; 1 O1 = A Li^T (node-major; A and O1 equal modulo 16 bytes, as
// torch's allocations are), 2 O1 = A^T A and O2 = Q^T Q, Q = A Li^T, each
// on ``blocks`` persistent blocks (0: the card's SMs x the blocks an SM
// holds), at most B; A whole and Li in shared memory (q: m up to ~475 at n
// = 80; the composite ~270, ~135 with two spans of A).  Node-minor tensors
// (minor) hold ceil(B / 128) tiles of 128, and only the first B nodes'
// slots are written.
extern "C" int mxu_probe_launch(int what, int prec, int minor, const float* A, const float* Li,
                                float* O1, float* O2, long long B, int m, int n, int split,
                                long long blocks, void* stream) {
  if (B <= 0 || m <= 0 || n <= 0 || split < 0 || split >= m || (split && what != kGram) ||
      blocks < 0 ||
      (what == kQ && (reinterpret_cast<uintptr_t>(A) - reinterpret_cast<uintptr_t>(O1)) % 16))
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(what, prec, minor, m, n, split);
  size_t bytes = 0;
  cudaError_t err = prepare(p.kernel(), p.floats, &bytes);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (p.gram) {
    const GramKernel k = p.gram;
    k<<<B, kThreads, bytes, s>>>(A, O1, m, n, split);
    return (int)cudaGetLastError();
  }
  long long grid = blocks;
  if (grid == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, p.kernel(), p.threads, bytes);
    if (err != cudaSuccess) return (int)err;
    grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
  }
  if (grid > B) grid = B;
  if (p.q) {
    const QKernel k = p.q;
    k<<<grid, p.threads, bytes, s>>>(A, Li, O1, B, m, n, p.nbuf);
  } else {
    const CompositeKernel k = p.composite;
    k<<<grid, p.threads, bytes, s>>>(A, Li, O1, O2, B, m, n, p.nbuf);
  }
  return (int)cudaGetLastError();
}

// y = x laid out the other way: direction 0 node-minor (ceil(B / 128),
// E, 128) -> node-major (B, E); 1 back, the last tile's slots past B
// zeroed.
extern "C" int node_transpose_launch(const float* x, float* y, long long B, int E, int direction,
                                     void* stream) {
  if (B <= 0 || E <= 0 || (direction != 0 && direction != 1)) return (int)cudaErrorInvalidValue;
  const long long blocks = (B + 127) / 128 * 4 * ((E + 31) / 32);
  node_transpose_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(x, y, B, E, direction);
  return (int)cudaGetLastError();
}
