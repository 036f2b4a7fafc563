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
 * The Gram G = A^T A replaces tools/mxu_probe.py:123 and :138 (node-major),
 *   :166 (node-minor: the transposes in and out are its reads and writes)
 *   and r5_mxu_shapes.py:84 (node-minor, any (m, n), a split row).  Both
 *   layouts convert A once into planes that the products read without
 *   converting again: float64 (DMMA), TF32 hi and lo, or bf16 pairs of
 *   rows (one register of a fragment); n is padded with zeros to 16 (the
 *   16 x 8 MMA tiles).  Plane strides w + 4 float64s, w + 8 words (w = n
 *   padded to 16), so the fragments (rows t, columns g) meet no bank
 *   conflict.  A warp sums 16 x 16 super tiles of the lower triangle (two
 *   16 x 8 tiles: each A fragment serves two products; on the diagonal the
 *   B fragments are rows of the A fragment, not loaded again) in registers
 *   until its node's last row.
 *
 * gram_major_kernel<P, kST> (node-major): persistent blocks, one an SM, of
 *   kGWarps = 16 MMA warps and kCWarps = 8 converting warps.  A step is a
 *   node (a node too tall for shared memory: chunks of its rows): its rows
 *   arrive by one cp.async.bulk of their 16-byte span into the raw span,
 *   on an mbarrier, a step ahead; the converting warps turn them into the
 *   step's plane (each thread's loads of 32 rows in flight at once) while
 *   the MMA warps run the previous step's products over all its rows with
 *   no barrier between k steps, then refill the raw span.  Two planes, one
 *   block barrier a step.  A node's G is assembled mirrored over its plane
 *   once every MMA warp is done with it, and leaves by one bulk store
 *   (plain stores for the at most 3 floats either side of its aligned
 *   interior) while the next conversion fills first the rows whose entries
 *   lie past G's span.  221,360 bytes at (132, 73) in DMMA: two
 *   136-row planes and a 38,560-byte span.  The products ran at half the
 *   DMMA rate when every warp both converted and multiplied with a barrier
 *   every 32 rows (the two phases do not overlap inside a block), which the
 *   split of roles and the node-sized step remove.  Bound by bytes at (132,
 *   73) on a 32,768-node chunk (A's and G's 0.59 ms, its padded DMMA
 *   products 0.51 ms).
 *
 * gram_minor_kernel<P> (node-minor) takes a group of kGroup = 8
 *   consecutive nodes of one 128-node tile, so every (r, c) entry of A and
 *   of G that it moves is one whole 32-byte sector: A by 16-byte cp.async
 *   copies, kMRows = 8 rows of the group a step, two steps ahead (three
 *   buffers, two at n > 80), each node's rows converted into its own plane;
 *   G by stores of whole sectors (a warp store that fills half of each of
 *   its sectors ran several times slower on the card): each
 *   lane's values through a small buffer of the warps that share the super
 *   tile, then two lanes an entry.  The group's sums do not fit in
 *   registers (8 nodes x 15 super tiles at n = 73 are 245 KB in float64),
 *   so a block of 16 warps takes kSpp = 8 super tiles of every node of the
 *   group (a work item), a warp one super tile of kMNodes = 4 nodes (64
 *   registers of DMMA sums, at 128 a thread; TF32 at 8 nodes a warp
 *   spilled); the group's other super tiles are further items, which
 *   neighbouring blocks run at the same time, so A's second read comes
 *   from L2.  Persistent blocks walk the items.  A split row (its own
 *   instance) rounds the first part's sums into G and adds the second's to
 *   them by atomic additions.
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
 * node-major (B, rows, cols), the port's.  The composite's node-minor
 * blocks take one node at a time: their 4-byte reads share 32-byte
 * sectors with the tile's other nodes, which the blocks beside it read
 * through L2.
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
constexpr int kRows = 32;    // rows of A a node-major Gram step converts
constexpr int kGWarps = 16, kCWarps = 8;   // the node-major Gram's MMA and converting warps
constexpr int kGThreads = 32 * (kGWarps + kCWarps);
constexpr int kGroup = 8;    // nodes a node-minor Gram block takes: a 32-byte sector an entry
constexpr int kMWarps = 16, kMThreads = 32 * kMWarps;   // the node-minor Gram's block
constexpr int kMRows = 8;    // rows of A a node-minor Gram step stages (one k step)
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
// A Gram plane of ``rows`` rows (floats): float64, TF32 hi then lo, or
// bf16 pairs of rows
__host__ __device__ inline int plane_floats(int prec, int w, int rows) {
  const int ld = a_ld(prec, w);
  return prec == kBf16 ? rows / 2 * ld : 2 * rows * ld;
}

// The 8-byte operand planes' row stride (q_kernel, composite_kernel): w +
// 4 entries, 4 modulo 16.
__host__ __device__ inline int plane_ld(int n) { return pad_to(n, 16) + 4; }

// Row blocks of A: [0, p1) then [p1, m) (p1 = split, or m), ``size`` rows
// at a time; block b starts at row r0 and holds the returned count.
struct RowBlocks {
  int m, p1, size, nb1, nb;
  __host__ __device__ RowBlocks(int m_, int split, int size_) : m(m_), size(size_) {
    p1 = split > 0 ? split : m;
    nb1 = (p1 + size - 1) / size;
    nb = nb1 + (split > 0 ? (m - split + size - 1) / size : 0);
  }
  __device__ int rows(int b, int& r0) const {
    r0 = b < nb1 ? b * size : p1 + (b - nb1) * size;
    return min(size, (b < nb1 ? p1 : m) - r0);
  }
};

// The node-major Gram's shared memory (floats): the two planes of
// ``chunk`` rows (padded to the MMA's k; each also G's staging span), the
// span of a chunk's raw rows, the split's first part (w x w), the span's
// mbarrier.
struct GramLayout {
  long long stage, plane, raw, part, bar, total;
  __host__ __device__ GramLayout(int prec, int n, int split, int chunk) {
    const int w = pad_to(n, 16);
    const long long pf = plane_floats(prec, w, pad_to(chunk, prec == kBf16 ? 16 : 8));
    stage = span_floats((long long)n * n);   // G's, over a consumed plane
    plane = pf > stage ? pf : stage;
    raw = 2 * plane;
    part = raw + span_floats((long long)chunk * n);
    bar = part + (split > 0 ? (long long)w * w : 0);
    total = bar + 4;
  }
};

// The node-minor Gram's shared memory (floats): ``nraw`` buffers of a
// step's copy (kMRows x n entries x kGroup nodes), two steps' planes, a
// plane a node at stride ``node`` (8 floats past the plane, so the
// conversion's stores to the group's planes spread over the banks).
struct MinorLayout {
  long long raw, node, plane, slice, total;
  __host__ __device__ MinorLayout(int prec, int n, int nraw) {
    raw = (long long)kMRows * n * kGroup;
    node = plane_floats(prec, pad_to(n, 16), kMRows) + 8;
    plane = nraw * raw;
    slice = plane + 2 * kGroup * node;
    total = slice + kMWarps * 32 * kGroup;
  }
};

// The nodes of a node-minor Gram warp's sums: 64 registers of a super
// tile's float64 sums (TF32 at 8 nodes spilled at 128 registers a thread).
constexpr int kMNodes = 4;

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
// Y(j0 + j, k) (Tile<P>, below), by 16 x 8 MMA tiles of its precision;
// ``mask`` (the same for the whole warp) says which are taken: bit c the
// tile of columns 8c.. .  The m16n8k* shapes share their accumulator
// layout: a super tile is one row tile of 16 and two column tiles of 8.
// visit(f) calls f(row, col, sum) for each entry of a taken tile.
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

// A step of a super tile: its A fragment (rows i0.., k0..) loaded once
// (load), then the taken column tiles against B fragments from Y's rows
// j0.. (mma); on the diagonal (``diag``: Y is X, j0 is i0) column tile q's
// B fragment is rows 8q.. of the A fragment, so it is not loaded.
template <int P>
struct Tile;

template <>
struct Tile<kDmma> : Tile16<double> {
  static constexpr int kK = 8;
  struct Frag {
    double a[4];
  };
  template <class XO>
  __device__ __forceinline__ static Frag load(const XO& X, int i0, int k0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    return {{dget(X, i0 + g, k0 + t), dget(X, i0 + g + 8, k0 + t), dget(X, i0 + g, k0 + t + 4),
             dget(X, i0 + g + 8, k0 + t + 4)}};
  }
  template <class YO>
  __device__ __forceinline__ void mma(const Frag& f, const YO& Y, int j0, int k0, int mask,
                                      bool diag) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
    for (int q = 0; q < 2; ++q)
      if (mask >> q & 1) {
        const int j = j0 + 8 * q + g;
        const double b[2] = {diag ? f.a[q] : dget(Y, j, k0 + t),
                             diag ? f.a[q + 2] : dget(Y, j, k0 + t + 4)};
        mma_f64_16x8x8(c[q], f.a, b);
      }
  }
};

template <>
struct Tile<kTf32x3> : Tile16<float> {
  static constexpr int kK = 8;
  struct Frag {
    uint32_t h[4], l[4];
  };
  template <class XO>
  __device__ __forceinline__ static Frag load(const XO& X, int i0, int k0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    Frag f;
    tget(X, i0 + g, k0 + t, f.h[0], f.l[0]);
    tget(X, i0 + g + 8, k0 + t, f.h[1], f.l[1]);
    tget(X, i0 + g, k0 + t + 4, f.h[2], f.l[2]);
    tget(X, i0 + g + 8, k0 + t + 4, f.h[3], f.l[3]);
    return f;
  }
  template <class YO>
  __device__ __forceinline__ void mma(const Frag& f, const YO& Y, int j0, int k0, int mask,
                                      bool diag) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
    for (int q = 0; q < 2; ++q)
      if (mask >> q & 1) {
        uint32_t bh[2], bl[2];
        if (diag) {
          bh[0] = f.h[q], bh[1] = f.h[q + 2], bl[0] = f.l[q], bl[1] = f.l[q + 2];
        } else {
          tget(Y, j0 + 8 * q + g, k0 + t, bh[0], bl[0]);
          tget(Y, j0 + 8 * q + g, k0 + t + 4, bh[1], bl[1]);
        }
        // the small terms first
        mma_tf32(c[q], f.l, bh);
        mma_tf32(c[q], f.h, bl);
        mma_tf32(c[q], f.h, bh);
      }
  }
};

template <>
struct Tile<kBf16> : Tile16<float> {
  static constexpr int kK = 16;
  struct Frag {
    uint32_t a[4];
  };
  template <class XO>
  __device__ __forceinline__ static Frag load(const XO& X, int i0, int k0) {
    const int g = (threadIdx.x & 31) >> 2, k = k0 + 2 * (threadIdx.x & 3);
    return {{bget(X, i0 + g, k), bget(X, i0 + g + 8, k), bget(X, i0 + g, k + 8),
             bget(X, i0 + g + 8, k + 8)}};
  }
  template <class YO>
  __device__ __forceinline__ void mma(const Frag& f, const YO& Y, int j0, int k0, int mask,
                                      bool diag) {
    const int g = (threadIdx.x & 31) >> 2, k = k0 + 2 * (threadIdx.x & 3);
#pragma unroll
    for (int q = 0; q < 2; ++q)
      if (mask >> q & 1) {
        const int j = j0 + 8 * q + g;
        const uint32_t b[2] = {diag ? f.a[q] : bget(Y, j, k), diag ? f.a[q + 2] : bget(Y, j, k + 8)};
        mma_bf16(c[q], f.a, b);
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

// ---- the Gram: gram_major_kernel and gram_minor_kernel

// v onto a[0, 4) of device memory, the first ``valid`` (at most 4) of
// them, by atomic additions whose result no register holds.
__device__ __forceinline__ void add_nodes(float* a, float4 v, long long valid) {
  if (valid >= 4) {
    atomicAdd(reinterpret_cast<float4*>(a), v);
    return;
  }
  if (valid > 0) atomicAdd(a, v.x);
  if (valid > 1) atomicAdd(a + 1, v.y);
  if (valid > 2) atomicAdd(a + 2, v.z);
}

// Named barrier ``id`` (1-15) of ``count`` threads (a warp's multiple).
__device__ __forceinline__ void named_sync(int id, int count) {
#ifdef CUDA_EMU
  emu_named_barrier(id, count, true);
#else
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
#endif
}

// A plane's entry ``at``: float64, or the TF32 hi with its lo ``lo`` words
// further on.
template <int P>
__device__ __forceinline__ void plane_put(float* plane, int at, int lo, float v) {
  if (P == kDmma) {
    reinterpret_cast<double*>(plane)[at] = v;
  } else {
    uint32_t* const hi = reinterpret_cast<uint32_t*>(plane);
    split_tf32(v, hi[at], hi[lo + at]);
  }
}

// A converting warp's share of kRows rows of a step: load() takes raw rows
// rho(i) (i < kI: cw + kCWarps i, cw the warp among the converting ones;
// bf16 the pairs (2u, 2u + 1), u = cw + kCWarps (i / 2)), columns lane +
// 32 k (k < 4), zeros past rows and n, into registers, all the loads in
// flight at once; put() writes them into the plane (w columns at stride
// ld): float64, TF32 hi and lo (lo prows ld words on), or bf16 pairs, as
// far as the products read it (rows padded to the MMA's k).
template <int P>
struct StepConvert {
  static constexpr int kI = kRows / kCWarps, kC = 4;
  float v[kI][kC];
  __device__ __forceinline__ static int rho(int i) {
    const int cw = threadIdx.x / 32 - kGWarps;
    return P == kBf16 ? 2 * (cw + kCWarps * (i / 2)) + (i & 1) : cw + kCWarps * i;
  }
  __device__ __forceinline__ void load(const float* __restrict__ raw, int rows, int n) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < kI; ++i)
#pragma unroll
      for (int k = 0; k < kC; ++k) {
        const int r = rho(i), c = lane + 32 * k;
        v[i][k] = r < rows && c < n ? raw[r * n + c] : 0.f;
      }
  }
  // rows row0 + r of a plane of ``prows`` rows, r < rp
  __device__ __forceinline__ void put(int rp, int w, int ld, float* __restrict__ plane, int row0,
                                      int prows) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < kI; i += P == kBf16 ? 2 : 1)
#pragma unroll
      for (int k = 0; k < kC; ++k) {
        const int r = rho(i), c = lane + 32 * k;
        if (r >= rp || c >= w) continue;
        if (P == kBf16)
          reinterpret_cast<uint32_t*>(plane)[(row0 + r) / 2 * ld + c] = pack_bf16(v[i][k], v[i + 1][k]);
        else
          plane_put<P>(plane, (row0 + r) * ld + c, prows * ld, v[i][k]);
      }
  }
};

// The Gram operand of a plane of ``rows`` rows: X(i, k) at row k, column i.
template <int P>
struct PlaneOp;
template <>
struct PlaneOp<kDmma> {
  __device__ static DoubleOp gram(const float* p, int ld, int) {
    return {reinterpret_cast<const double*>(p), 1, ld};
  }
};
template <>
struct PlaneOp<kTf32x3> {
  __device__ static SplitOp gram(const float* p, int ld, int rows) {
    const uint32_t* hi = reinterpret_cast<const uint32_t*>(p);
    return {hi, hi + rows * ld, 1, ld};
  }
};
template <>
struct PlaneOp<kBf16> {
  __device__ static PairOp gram(const float* p, int ld, int) {
    return {reinterpret_cast<const uint32_t*>(p), 1, ld};
  }
};

// Super tile s of the Gram's lower triangle, counted row by row: rows i0..,
// columns j0..
__device__ __forceinline__ void super_tile(int s, int& i0, int& j0) {
  int si = 0;
  while (s > si) s -= ++si;
  i0 = 16 * si;
  j0 = 16 * s;
}

// G = A^T A on B node-major nodes, rows [0, split) and [split, m) summed
// apart (split 0: none); the file's head says how.  A node's rows in
// chunks of at most ``chunk`` rows (all of them where a node fits).
template <int P, int kST>
__global__ void __launch_bounds__(kGThreads, 1)
    gram_major_kernel(const float* __restrict__ A, float* __restrict__ G, long long B, int m,
                      int n, int split, int chunk) {
  constexpr int kK = Tile<P>::kK;
  extern __shared__ __align__(16) float smem[];
  const int w = pad_to(n, 16), n8 = pad_to(n, 8), S = w / 16, ld = a_ld(P, w);
  const int prows = pad_to(chunk, P == kBf16 ? 16 : 8);   // a plane's rows
  const RowBlocks rc(m, split, chunk);
  const GramLayout lay(P, n, split, chunk);
  const int nc = rc.nb;
  const long long mn = (long long)m * n, nn = (long long)n * n;
  float* const part = smem + lay.part;
  uint64_t* const bar = reinterpret_cast<uint64_t*>(smem + lay.bar);
  const int warp = threadIdx.x / 32;
  const bool mma_warp = warp < kGWarps, issuer = threadIdx.x == 32 * kGWarps;
  // an MMA warp's super tiles of the Gram's lower triangle: warp, warp +
  // kGWarps, ...
  int gi[kST], gj[kST], gm[kST];
#pragma unroll
  for (int q = 0; q < kST; ++q) {
    const int s = warp + kGWarps * q;
    gi[q] = gj[q] = gm[q] = 0;
    if (!mma_warp || s >= S * (S + 1) / 2) continue;
    super_tile(s, gi[q], gj[q]);
    gm[q] = tile_mask(gi[q], gj[q], n8, n8);
  }
  // The block's steps j: a chunk each, j % nc of node blockIdx + (j / nc)
  // grid, in plane j % 2; its rows arrive by one bulk copy into the raw
  // span, completing the phase j % 2 of the span's mbarrier.
  const long long nodes = (B - blockIdx.x + gridDim.x - 1) / gridDim.x, J = nodes * nc;
  auto node_of = [&](long long it) { return blockIdx.x + it * gridDim.x; };
  auto plane_of = [&](long long j) { return smem + (j & 1) * lay.plane; };
  auto rows_of = [&](long long j, int& rows) {   // step j's first row of A, its rows
    int r0;
    rows = rc.rows((int)(j % nc), r0);
    return A + node_of(j / nc) * mn + (long long)r0 * n;
  };
  auto issue = [&](long long j) {   // the issuer: step j's rows into the raw span
    if (j >= J) return;
    int rows;
    const float* const src = rows_of(j, rows);
    const int h = span_head(src);
    bulk_load(smem + lay.raw, src - h, (unsigned)((h + rows * n + 3) / 4 * 16), bar);
  };
  // the converting warps: step j's chunk from the raw span into plane j %
  // 2, kRows rows at a time, then the span refilled with step j + 1's rows.
  // ``store``: the last node's G, staged over this plane, is being read out
  // by a bulk store, so the rows whose plane entries lie past G's span go
  // first, then (once the store has read G) the others.
  StepConvert<P> cv;
  const int row_floats = P == kDmma ? 2 * ld : P == kBf16 ? ld / 2 : ld;
  auto convert = [&](long long j, bool store) {
    int rows;
    const float* const src = rows_of(j, rows);
    mbar_wait(bar, (unsigned)j & 1);
    const float* const raw = smem + lay.raw + span_head(src);
    auto block = [&](int r0) {
      const int rb = min(kRows, rows - r0);
      cv.load(raw + (long long)r0 * n, rb, n);
      cv.put(pad_to(rb, kK), w, ld, plane_of(j), r0, prows);
    };
    int clear = 0;   // the first row whose plane entries lie past G's span
    while (clear < rows && (long long)clear * row_floats < lay.stage) clear += kRows;
    for (int r0 = clear; r0 < rows; r0 += kRows) block(r0);
    if (store) {
      if (issuer) bulk_wait_read();
      named_sync(2, 32 * kCWarps);
    }
    for (int r0 = 0; r0 < clear && r0 < rows; r0 += kRows) block(r0);
    named_sync(2, 32 * kCWarps);   // every converting warp is done with the span
    if (issuer) issue(j + 1);
  };
  // node it's G in the plane of its last chunk (from the same offset
  // modulo 16 bytes)
  auto staged = [&](long long it) {
    return plane_of(it * nc + nc - 1) + span_head(G + node_of(it) * nn);
  };
  if (issuer) {
    mbar_init(bar, 1);
    issue(0);
  }
  __syncthreads();
  if (!mma_warp) convert(0, false);
  __syncthreads();
  Tile<P> g1[kST];
  for (long long j = 0; j < J; ++j) {
    const long long it = j / nc;
    const int c = (int)(j % nc);
    if (mma_warp) {
      // chunk j's products on plane j % 2, all its k steps at once
      if (c == 0) {
#pragma unroll
        for (int q = 0; q < kST; ++q) g1[q].zero();
      }
      int r0;
      const int rp = pad_to(rc.rows(c, r0), kK);
      const auto X = PlaneOp<P>::gram(plane_of(j), ld, prows);
#pragma unroll 2
      for (int k0 = 0; k0 < rp; k0 += kK)
#pragma unroll
        for (int q = 0; q < kST; ++q)
          if (gm[q]) g1[q].mma(Tile<P>::load(X, gi[q], k0), X, gj[q], k0, gm[q], gi[q] == gj[q]);
      if (split > 0 && c == rc.nb1 - 1) {   // the first part, rounded
#pragma unroll
        for (int q = 0; q < kST; ++q) {
          if (!gm[q]) continue;
          g1[q].visit(gi[q], gj[q], gm[q], [&](int r, int c2, auto v) { part[r * w + c2] = (float)v; });
          g1[q].zero();
        }
      }
      if (c == nc - 1) {   // G mirrored over the plane (and the first part added)
        named_sync(1, 32 * kGWarps);   // every MMA warp is done with the plane
        float* const sg = staged(it);
#pragma unroll
        for (int q = 0; q < kST; ++q) {
          if (!gm[q]) continue;
          g1[q].visit(gi[q], gj[q], gm[q], [&](int r, int c2, auto v) {
            if (r >= n || c2 > r) return;
            sg[r * n + c2] = sg[c2 * n + r] = split > 0 ? part[r * w + c2] + (float)v : (float)v;
          });
        }
        fence_async_shared();
      }
    } else {
      const bool store = j > 0 && c == 0;   // the last node's G leaves the plane this step fills
      if (store && issuer) {
        store_span(G + node_of(it - 1) * nn, staged(it - 1), nn);
        bulk_commit();
      }
      if (j + 1 < J) convert(j + 1, store);   // meanwhile step j + 1's chunk
    }
    __syncthreads();
  }
  if (issuer) {
    store_span(G + node_of(nodes - 1) * nn, staged(nodes - 1), nn);
    bulk_commit();
    bulk_wait();
  }
}

// G = A^T A on B node-minor nodes (the file's head says how): kN nodes a
// warp's sums, kSpp super tiles an item; ``nraw`` buffers of a step's copy
// (two or three: the copies one or two steps ahead); kSplit: split > 0.
template <int P, bool kSplit>
__global__ void __launch_bounds__(kMThreads, 1)
    gram_minor_kernel(const float* __restrict__ A, float* __restrict__ G, long long B, int m,
                      int n, int split, int nraw) {
  constexpr int kN = kMNodes, kSpp = kMWarps * kN / kGroup;
  extern __shared__ __align__(16) float smem[];
  const MinorLayout lay(P, n, nraw);
  const int w = pad_to(n, 16), n8 = pad_to(n, 8), S = w / 16, ld = a_ld(P, w);
  const int nst = S * (S + 1) / 2, passes = (nst + kSpp - 1) / kSpp;
  const RowBlocks rb(m, split, kMRows);
  const int nb = rb.nb;
  // (32-bit step and group counts, which the launch checks: registers are
  // scarce here)
  const int items = (int)((B + kGroup - 1) / kGroup) * passes;
  // the block's steps j: item blockIdx + (j / nb) grid (group item / passes,
  // its super tiles (item % passes) kSpp..), row block j % nb
  const int J = (items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x * nb;
  const int warp = threadIdx.x / 32, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  auto item_of = [&](int j) { return (int)blockIdx.x + j / nb * (int)gridDim.x; };
  auto copy = [&](int j) {   // step j's rows of the group, 16 bytes a copy
    if (j < J) {
      const long long grp = item_of(j) / passes;
      int r0;
      const int rows = rb.rows((int)(j % nb), r0);
      const float* const src = A + (((grp >> 4) * m + r0) * n << 7) + ((grp & 15) << 3);
      float* const dst = smem + (j % nraw) * lay.raw;
#pragma unroll 1
      for (int i = threadIdx.x; i < 2 * rows * n; i += kMThreads)
        __pipeline_memcpy_async(dst + 4 * i, src + ((long long)(i >> 1) << 7) + 4 * (i & 1),
                                4 * sizeof(float));
    }
    __pipeline_commit();
  };
  // step j's rows into the group's planes j % 2: a thread a float4 of the
  // copy (nodes 4h..4h + 3 of an entry (r, c)), thread t starting at
  // (r, 2c + h) = t and stepping kMThreads (dr rows, dx on), no division
  // an entry
  auto convert = [&](int j) {
    int r0;
    const int rows = rb.rows((int)(j % nb), r0);
    const float4* const raw = reinterpret_cast<const float4*>(smem + (j % nraw) * lay.raw);
    float* const pl = smem + lay.plane + (j & 1) * kGroup * lay.node;
    const int span = 2 * w, dr = kMThreads / span, dx = kMThreads - dr * span;
    int r = threadIdx.x / span, x = threadIdx.x - r * span;
#pragma unroll 1
    for (int i = threadIdx.x; i < kMRows * span; i += kMThreads) {
      const int c = x >> 1, h = x & 1;
      const float4 v = r < rows && c < n ? raw[(r * n + c) * 2 + h] : make_float4(0.f, 0.f, 0.f, 0.f);
      float* const p = pl + 4 * h * lay.node;
      const int at = r * ld + c, lo = kMRows * ld;
      plane_put<P>(p, at, lo, v.x);
      plane_put<P>(p + lay.node, at, lo, v.y);
      plane_put<P>(p + 2 * lay.node, at, lo, v.z);
      plane_put<P>(p + 3 * lay.node, at, lo, v.w);
      r += dr;
      x += dx;
      if (x >= span) {
        x -= span;
        ++r;
      }
    }
  };
  for (int s = 0; s < nraw; ++s) copy(s);
  if (nraw == 3)
    __pipeline_wait_prior(2);
  else
    __pipeline_wait_prior(1);
  __syncthreads();
  convert(0);
  Tile<P> acc[kN];
  int gi = 0, gj = 0, gm = 0, kb = 0, grp = 0;
  // The sums into G as whole 32-byte sectors, one slice (q, e) of the
  // super tile's entries at a time: each lane's kN values of its entry into
  // the buffer of the two warps that share the super tile (nodes 0-3 and
  // 4-7), then 16 entries a store, lane 2x + h storing half h (4 nodes)
  // of entry x, at (i, j) and (j, i); ``add``: added to the first part that
  // the same lane stored there (by an atomic addition, whose result no
  // register holds: each address has this one writer); nodes past B not
  // written.
  constexpr int kShare = kGroup / kN;   // warps a super tile
  float* const buf = smem + lay.slice + warp / kShare * 32 * kGroup;
  auto share_sync = [&]() { named_sync(1 + warp / kShare, 32 * kShare); };
  auto store = [&](bool add) {
    const int lane = threadIdx.x & 31, half = lane & 1;
    float* const out = G + ((long long)(grp >> 4) * n * n << 7) + (grp & 15) * kGroup + 4 * half;
    const long long valid = B - (long long)grp * kGroup - 4 * half;   // of the lane's 4 nodes
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (!(gm >> q & 1)) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int k = 0; k < kN; ++k) buf[lane * kGroup + kb + k] = (float)acc[k].c[q][e];
        share_sync();
#pragma unroll
        for (int r = 0; r < 2 / kShare; ++r) {
          const int x = (warp % kShare * (2 / kShare) + r) * 16 + (lane >> 1);
          const int i = gi + (x >> 2) + 8 * (e >> 1), c = gj + 8 * q + 2 * (x & 3) + (e & 1);
          if (i >= n || c > i) continue;
          float* const p = out + (((long long)i * n + c) << 7);
          float* const pt = out + (((long long)c * n + i) << 7);
          const float4 v = reinterpret_cast<const float4*>(buf + x * kGroup)[half];
          if (kSplit && add) {   // one float32 addition, as the plain version's
            add_nodes(p, v, valid);
            if (pt != p) add_nodes(pt, v, valid);
          } else if (valid >= 4) {
            *reinterpret_cast<float4*>(p) = v;
            *reinterpret_cast<float4*>(pt) = v;
          } else {   // the group's last real nodes (at most 3 here) only
            if (valid > 0) p[0] = pt[0] = v.x;
            if (valid > 1) p[1] = pt[1] = v.y;
            if (valid > 2) p[2] = pt[2] = v.z;
          }
        }
        share_sync();
      }
    }
  };
  for (int j = 0; j < J; ++j) {
    const int b = j % nb;
    if (nraw == 3)
      __pipeline_wait_prior(1);
    else
      __pipeline_wait_prior(0);
    __syncthreads();   // step j + 1 is in; step j's planes are converted, step j - 1's read
    copy(j + nraw);
    if (j + 1 < J) convert(j + 1);
    if (b == 0) {   // a new item: the warp's super tile and nodes
      const int item = item_of(j);
      const int s = item % passes * kSpp + warp / kShare;
      grp = item / passes;
      kb = warp % kShare * kN;
      gm = 0;
      if (s < nst) {
        super_tile(s, gi, gj);
        gm = tile_mask(gi, gj, n8, n8);
      }
#pragma unroll
      for (int k = 0; k < kN; ++k) acc[k].zero();
    }
    if (!gm) continue;
    const float* const pl = smem + lay.plane + (j & 1) * kGroup * lay.node;
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      const auto X = PlaneOp<P>::gram(pl + (kb + k) * lay.node, ld, kMRows);
      acc[k].mma(Tile<P>::load(X, gi, 0), X, gj, 0, gm, gi == gj);
    }
    const bool first = kSplit && b == rb.nb1 - 1;   // the first part, rounded, into G
    if (first || b == nb - 1) {
      store(kSplit && !first);
#pragma unroll
      for (int k = 0; k < kN; ++k) acc[k].zero();
    }
  }
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

typedef void (*GramKernel)(const float*, float*, long long, int, int, int, int);
typedef void (*QKernel)(const float*, const float*, float*, long long, int, int, int);
typedef void (*CompositeKernel)(const float*, const float*, float*, float*, long long, int, int,
                                int);

template <int P, bool kMinor>
CompositeKernel composite_instance(int n) {
  return n <= kCNarrow ? composite_kernel<P, kMinor, 8> : composite_kernel<P, kMinor, 16>;
}

// Super tiles a warp of the node-major Gram holds for n columns: the
// instance's kST for up to n = 80 (15 super tiles) or up to 128 (36).
constexpr int kSTNarrow = (15 + kGWarps - 1) / kGWarps, kSTWide = (36 + kGWarps - 1) / kGWarps;

template <int P>
GramKernel major_pick(int n) {
  return n <= 80 ? gram_major_kernel<P, kSTNarrow> : gram_major_kernel<P, kSTWide>;
}

// The node-major Gram's instance (any n <= 128, bf16 n <= 80), or nullptr.
GramKernel gram_major_instance(int prec, int n) {
  if (prec == kBf16) return n <= 80 ? gram_major_kernel<kBf16, kSTNarrow> : nullptr;
  return prec == kDmma ? major_pick<kDmma>(n) : major_pick<kTf32x3>(n);
}

// The node-minor Gram's work items on B nodes: its groups x the items a
// group's super tiles take (kSpp super tiles an item).
long long minor_items(int prec, int n, long long B) {
  const int S = pad_to(n, 16) / 16, spp = kMWarps * kMNodes / kGroup;
  return (B + kGroup - 1) / kGroup * ((S * (S + 1) / 2 + spp - 1) / spp);
}

int smem_optin() {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return optin;
}

// A probe's launch: its kernel (one of the three forms), threads, dynamic
// shared memory (floats), A's buffers (q and the composite: spans; the
// node-minor Gram: step copies) and the node-major Gram's chunk rows; no
// kernel where the probe has no instance.
struct Plan {
  GramKernel gram = nullptr;
  QKernel q = nullptr;
  CompositeKernel composite = nullptr;
  int threads = kThreads, nbuf = 1, chunk = 0;
  long long floats = 0;
  const void* kernel() const {
    return gram ? (const void*)gram : q ? (const void*)q : (const void*)composite;
  }
};

Plan plan(int what, int prec, int minor, int m, int n, int split) {
  Plan p;
  if (m <= 0 || n <= 0 || n > kMaxN || prec < kDmma || prec > kBf16) return p;
  const long long optin = smem_optin();
  if (what == kGram && minor) {
    if (prec == kBf16) return p;
    if (prec == kDmma)
      p.gram = split > 0 ? gram_minor_kernel<kDmma, true> : gram_minor_kernel<kDmma, false>;
    else
      p.gram = split > 0 ? gram_minor_kernel<kTf32x3, true> : gram_minor_kernel<kTf32x3, false>;
    p.threads = kMThreads;
    // the copies two steps ahead where three buffers fit, else one
    p.nbuf = MinorLayout(prec, n, 3).total * (long long)sizeof(float) <= optin ? 3 : 2;
    p.floats = MinorLayout(prec, n, p.nbuf).total;
  } else if (what == kGram) {
    p.gram = gram_major_instance(prec, n);
    p.threads = kGThreads;
    // a block an SM: a node's rows (its longer part) in one chunk where its
    // two planes and its raw span fit, else chunks of as many rows
    const int longer = split > 0 && split > m - split ? split : m - split;
    p.chunk = longer;
    while (p.chunk > 16 && GramLayout(prec, n, split, p.chunk).total * (long long)sizeof(float) > optin)
      p.chunk = (p.chunk - 1) / 16 * 16;
    p.floats = GramLayout(prec, n, split, p.chunk).total;
  } else if (what == kQ && !minor && prec != kBf16) {
    p.q = prec == kDmma ? q_kernel<kDmma> : q_kernel<kTf32x3>;
    p.threads = kQThreads;
    // two spans of A where two blocks an SM still fit
    p.nbuf = 2 * QLayout(m, n, 2).total * (long long)sizeof(float) <= optin ? 2 : 1;
    p.floats = QLayout(m, n, p.nbuf).total;
  } else if (what == kComposite && prec != kBf16 && n <= kMaxNComposite) {
    if (prec == kDmma)
      p.composite = minor ? composite_instance<kDmma, true>(n) : composite_instance<kDmma, false>(n);
    else
      p.composite = minor ? composite_instance<kTf32x3, true>(n) : composite_instance<kTf32x3, false>(n);
    // 8 warps two blocks an SM, 16 one: two spans of A where those still fit
    const int per_sm = n <= kCNarrow ? 2 : 1;
    p.threads = 32 * 16 / per_sm;
    p.nbuf = per_sm * CompositeLayout(m, n, 2).total * (long long)sizeof(float) <= optin ? 2 : 1;
    p.floats = CompositeLayout(m, n, p.nbuf).total;
  }
  return p;
}

// The launch's dynamic shared memory, the larger of the kernel's need and
// ``request`` (bytes), set on its kernel; an error where there is no
// instance or it does not fit.
cudaError_t prepare(const void* kernel, long long floats, long long request, size_t* bytes) {
  if (kernel == nullptr || request < 0) return cudaErrorInvalidValue;
  *bytes = (size_t)(floats * (long long)sizeof(float) > request ? floats * (long long)sizeof(float)
                                                                : request);
  if (*bytes > (size_t)smem_optin()) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
}

}  // namespace

// A launch's dynamic shared memory, threads, the blocks an SM holds, and
// its registers and local memory bytes (spills) a thread: ``what`` 0 the
// Gram, 1 Q, 2 the composite (precision 0 DMMA, 1 TF32x3, 2 bf16; minor
// the node-minor layout) at m x n with the split row, 3 node_transpose;
// at a shared memory request of ``request`` bytes (the larger of it and
// the need is launched); returns the cudaError_t.
extern "C" int mxu_probes_occupancy(int what, int prec, int minor, int m, int n, int split,
                                    long long request, long long* smem_bytes, int* threads,
                                    int* blocks_per_sm, int* regs, long long* local_bytes) {
  Plan p;
  const void* kernel = (const void*)node_transpose_kernel;
  if (what != kTranspose) {
    p = plan(what, prec, minor, m, n, split);
    kernel = p.kernel();
  }
  size_t bytes = 0;
  cudaError_t err = prepare(kernel, p.floats, request, &bytes);
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
// = A^T A (split: the row where the second part starts, 0 none; node-minor
// A 16-byte aligned); 1 O1 = A Li^T (node-major; A and O1 equal modulo 16
// bytes, as torch's allocations are), 2 O1 = A^T A and O2 = Q^T Q, Q = A
// Li^T; each on ``blocks`` persistent blocks (0: the card's SMs x the
// blocks an SM holds), at most the work's units (nodes; the node-minor
// Gram's items); at a shared memory request of ``request`` bytes.  q and
// the composite hold A whole and Li in shared memory (q: m up to ~475 at
// n = 80; the composite ~270, ~135 with two spans of A); the Gram takes
// any m.  Node-minor tensors (minor) hold ceil(B / 128) tiles of 128, and
// only the first B nodes' slots are written.
extern "C" int mxu_probe_launch(int what, int prec, int minor, const float* A, const float* Li,
                                float* O1, float* O2, long long B, int m, int n, int split,
                                long long blocks, long long request, void* stream) {
  if (B <= 0 || m <= 0 || n <= 0 || split < 0 || split >= m || (split && what != kGram) ||
      blocks < 0 ||
      (what == kQ && (reinterpret_cast<uintptr_t>(A) - reinterpret_cast<uintptr_t>(O1)) % 16) ||
      (what == kGram && minor && (reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(O1)) % 16))
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(what, prec, minor, m, n, split);
  size_t bytes = 0;
  cudaError_t err = prepare(p.kernel(), p.floats, request, &bytes);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long units = what == kGram && minor ? minor_items(prec, n, B) : B;
  if (what == kGram && minor && units * RowBlocks(m, split, kMRows).nb >= (1LL << 31))
    return (int)cudaErrorInvalidValue;   // the kernel counts its steps in 32 bits
  long long grid = blocks;
  if (grid == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, p.kernel(), p.threads, bytes);
    if (err != cudaSuccess) return (int)err;
    grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
  }
  if (grid > units) grid = units;
  if (p.gram) {
    const GramKernel k = p.gram;
    k<<<grid, p.threads, bytes, s>>>(A, O1, B, m, n, split, minor ? p.nbuf : p.chunk);
  } else if (p.q) {
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
