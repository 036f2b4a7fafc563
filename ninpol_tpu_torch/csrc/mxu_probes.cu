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
 * mxu_kernel<P, kWhat, kMinor, kST> replaces tools/mxu_probe.py:123 and
 *   :138 (kWhat = kGram, node-major), :166 (kGram, node-minor: the
 *   transposes in and out are its reads and writes), :185 (kQ) and :215
 *   (kComposite, node-minor or node-major), and r5_mxu_shapes.py:84
 *   (kGram, node-minor, any (m, n), a split row).  One block of 8 warps a
 *   node.  A comes in row blocks of kRows = 32: each block's raw copy
 *   (16 bytes a copy where node-major rows allow) is in flight two blocks
 *   ahead, and at its turn is converted once into a plane that the
 *   products read without converting again: float64 (DMMA), TF32 hi and
 *   lo, or bf16 pairs of rows (one register of a fragment).  n is padded
 *   with zeros to 16 (the 16 x 8 MMA tiles).  A warp owns up to kST
 *   16 x 16 super tiles of the Gram's lower triangle for the whole kernel,
 *   their sums in registers (two 16 x 8 tiles: each A fragment serves
 *   two products), so G leaves once, mirrored.  Q = A Li^T is taken a row
 *   block at a time against Li staged whole (converted at each read); the
 *   composite rounds it to float32 into a plane of its own (as the TPU's
 *   preferred_element_type=f32 does) and folds it into G2 in the same
 *   step, so Q never reaches device memory.  Plane strides: w + 4
 *   float64s, w + 8 words (w = n padded to 16), so the Gram's fragments
 *   (rows t, columns g) meet no bank conflict; Q's row reads of a TF32
 *   plane meet 2-way ones.  Bound at (132, 73), a 32,768-node chunk, by
 *   bytes for the Gram (A's and G's 0.59 ms, its products on the triangle
 *   0.35 ms of DMMA) and Q (0.96 ms against 0.69), by DMMA operations for
 *   the composite (1.39 ms against 1.00).
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
 * one node: its 4-byte reads share 32-byte sectors with the tile's other
 * nodes, which the blocks beside it read through L2.
 *
 * Every launch function returns a cudaError_t as int (0 on success).
 */
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8, kThreads = 32 * kWarps;
constexpr int kRows = 32;   // rows of A a block step stages
constexpr int kQT = 2;      // Q super tiles a warp takes a row block (2 x w / 16 <= 16)

enum { kDmma = 0, kTf32x3 = 1, kBf16 = 2 };
enum { kGram = 0, kQ = 1, kComposite = 2, kTranspose = 3 };

__host__ __device__ inline int pad_to(int x, int k) { return (x + k - 1) / k * k; }
// The planes' row stride (w = n padded to 16).  A Gram fragment reads
// rows t < 4 (bf16: pairs t) at columns g < 8: float64 at w + 4 (4 or 12
// modulo 16 doubles: each half warp's 16 doubles in distinct bank pairs),
// 32-bit words at w + 8 (8 or 24 modulo 32: the four rows 8 banks apart).
// Q's row reads of A (rows g, columns t) then fall in distinct banks for
// float64 and meet 2-way conflicts for TF32.
__host__ __device__ inline int a_ld(int prec, int w) { return prec == kDmma ? w + 4 : w + 8; }
// Li's row stride: w + 4, an odd multiple of 4, so rows g < 8 fall in 8
// distinct groups of 4 banks
__host__ __device__ inline int li_ld(int w) { return w + 4; }
// A plane of kRows rows (floats): float64, TF32 hi and lo, or bf16 pairs
__host__ __device__ inline int plane_floats(int prec, int w) {
  const int ld = a_ld(prec, w);
  return prec == kBf16 ? kRows / 2 * ld : 2 * kRows * ld;
}

// A block's shared memory (floats): A's two raw row blocks, its plane, Q's
// plane (kComposite), Li (kQ, kComposite), the split's first part (w x w).
struct Layout {
  long long ap, qp, lis, part, total;
  __host__ __device__ Layout(int what, int prec, int n, int split) {
    const int w = pad_to(n, 16), pf = plane_floats(prec, w);
    ap = 2LL * kRows * n;
    qp = ap + pf;
    lis = qp + (what == kComposite ? pf : 0);
    part = lis + (what != kGram ? (long long)w * li_ld(w) : 0);
    total = part + (split > 0 ? (long long)w * w : 0);
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

// The operands of a product, read as at(r, k): r the output's row (A
// operand) or column (B operand), k the contraction index.  FloatOp is
// float32 in shared memory, converted at each read (Li); the planes hold
// a row block converted once (to_plane): DoubleOp float64 for DMMA,
// SplitOp TF32 hi and lo, PairOp bf16 pairs along k, p[(k / 2) ks + r rs]
// = (X(r, k), X(r, k + 1)), each pair one register of a fragment.
struct FloatOp {
  const float* p;
  int rs, ks;
};
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

__device__ __forceinline__ double dget(const FloatOp& o, int r, int k) {
  return (double)o.p[r * o.rs + k * o.ks];
}
__device__ __forceinline__ double dget(const DoubleOp& o, int r, int k) {
  return o.p[r * o.rs + k * o.ks];
}
__device__ __forceinline__ void tget(const FloatOp& o, int r, int k, uint32_t& hi, uint32_t& lo) {
  split_tf32(o.p[r * o.rs + k * o.ks], hi, lo);
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

// The operand of a plane: the Gram's (X(i, k) at row k, column i) or Q's
// (X(r, j) at row r, column j).
template <int P>
struct PlaneOp;
template <>
struct PlaneOp<kDmma> {
  __device__ static DoubleOp gram(const float* p, int ld) { return {reinterpret_cast<const double*>(p), 1, ld}; }
  __device__ static DoubleOp rows(const float* p, int ld) { return {reinterpret_cast<const double*>(p), ld, 1}; }
};
template <>
struct PlaneOp<kTf32x3> {
  __device__ static SplitOp gram(const float* p, int ld) {
    const uint32_t* hi = reinterpret_cast<const uint32_t*>(p);
    return {hi, hi + kRows * ld, 1, ld};
  }
  __device__ static SplitOp rows(const float* p, int ld) {
    const uint32_t* hi = reinterpret_cast<const uint32_t*>(p);
    return {hi, hi + kRows * ld, ld, 1};
  }
};
template <>
struct PlaneOp<kBf16> {
  __device__ static PairOp gram(const float* p, int ld) { return {reinterpret_cast<const uint32_t*>(p), 1, ld}; }
};

// The node's n x n Li into s (w x ld), zeros past n.
template <bool kMinor>
__device__ void stage_square(const float* Li, long long node, int n, int w, int ld, float* s) {
  for (int idx = threadIdx.x; idx < w * w; idx += kThreads) {
    const int r = idx / w, c = idx - r * w;
    if (r < n && c < n)
      __pipeline_memcpy_async(s + r * ld + c, Li + entry<kMinor>(node, n, n, r, c), sizeof(float));
    else
      s[r * ld + c] = 0.f;
  }
}

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

// kWhat = kGram: O1 = A^T A, rows [0, split) and [split, m) summed apart
//   (split 0: none); kQ: O1 = A Li^T (node-major); kComposite: O1 = A^T A,
//   O2 = Q^T Q with Q = A Li^T rounded to float32.  One block a node.  Row
//   block b's raw copy is in flight two blocks ahead (two raw buffers);
//   at its turn it is converted once into the plane the products read.
//   Q is taken a row block at a time, into a plane of its own for G2
//   (kComposite) or out to device memory (kQ).
// Three blocks an SM for the Gram up to n = 80 (at most 85 registers; its
// DMMA instance ran faster that way than with two), two for the others.
template <int P, int kWhat, bool kMinor, int kST>
__global__ void __launch_bounds__(kThreads, kWhat == kGram && kST == 2 ? 3 : 2)
    mxu_kernel(const float* __restrict__ A, const float* __restrict__ Li, float* __restrict__ O1,
               float* __restrict__ O2, int m, int n, int split) {
  constexpr bool kHasG1 = kWhat != kQ, kHasQ = kWhat != kGram, kHasG2 = kWhat == kComposite;
  constexpr int kK = Tile<P>::kK;
  extern __shared__ __align__(16) float smem[];
  const long long node = blockIdx.x;
  const int w = pad_to(n, 16), n8 = pad_to(n, 8), S = w / 16;
  const int ld = a_ld(P, w), ldl = li_ld(w), pf = plane_floats(P, w);
  const RowBlocks rb(m, split);
  const Layout lay(kWhat, P, n, split);
  float* const raw0 = smem;
  float* const raw1 = raw0 + kRows * n;
  float* const Ap = smem + lay.ap;
  float* const Qp = smem + lay.qp;
  float* const Lis = smem + lay.lis;
  float* const part = smem + lay.part;
  const int warp = threadIdx.x / 32;

  // the warp's super tiles of the Gram's lower triangle: s -> (si, sj)
  int gi[kST], gj[kST], gm[kST];
  const int nst = S * (S + 1) / 2;
#pragma unroll
  for (int q = 0; q < kST; ++q) {
    int s = warp + kWarps * q, si = 0;
    gi[q] = gj[q] = gm[q] = 0;
    if (!kHasG1 || s >= nst) continue;
    while (s > si) s -= ++si;
    gi[q] = 16 * si;
    gj[q] = 16 * s;
    gm[q] = tile_mask(gi[q], gj[q], n8, n8);
  }
  Tile<P> g1[kST], g2[kST];
#pragma unroll
  for (int q = 0; q < kST; ++q) {
    g1[q].zero();
    g2[q].zero();
  }

  if constexpr (kHasQ) stage_square<kMinor>(Li, node, n, w, ldl, Lis);
  if constexpr (kHasG2)
    for (int i = threadIdx.x; i < pf; i += kThreads) Qp[i] = 0.f;
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
    __syncthreads();   // block b staged; every warp is done with block b - 1's planes
    to_plane<P>(raw, rows, n, w, ld, Ap);
    __syncthreads();   // the plane is ready and raw is free
    if (b + 2 < rb.nb) {
      int s0;
      const int rows2 = rb.rows(b + 2, s0);
      stage_raw<kMinor>(A, node, m, n, s0, rows2, raw);
    }
    __pipeline_commit();
    if constexpr (kHasG1) {
      const auto X = PlaneOp<P>::gram(Ap, ld);
#pragma unroll
      for (int q = 0; q < kST; ++q) {
        if (!gm[q]) continue;
#pragma unroll 2
        for (int k0 = 0; k0 < rp; k0 += kK) g1[q].step(X, X, gi[q], gj[q], k0, gm[q]);
      }
    }
    if constexpr (kHasQ) {
      const auto X = PlaneOp<P>::rows(Ap, ld);
      const FloatOp Y{Lis, ldl, 1};
      const int kq = pad_to(n, kK);
#pragma unroll
      for (int q = 0; q < kQT; ++q) {
        const int s = warp + kWarps * q;
        if (s >= 2 * S) break;
        const int i0 = 16 * (s / S), j0 = 16 * (s % S);
        const int mask = tile_mask(i0, j0, rp, n8);
        if (!mask) continue;
        Tile<P> t;
        t.zero();
#pragma unroll 2
        for (int k0 = 0; k0 < kq; k0 += kK) t.step(X, Y, i0, j0, k0, mask);
        if constexpr (kHasG2)
          t.visit(i0, j0, mask, [&](int i, int j, auto v) {
            const float f = (float)v;   // Q rounded to float32
            if (P == kDmma) {
              reinterpret_cast<double*>(Qp)[i * ld + j] = f;
            } else {
              uint32_t* hi = reinterpret_cast<uint32_t*>(Qp);
              split_tf32(f, hi[i * ld + j], hi[kRows * ld + i * ld + j]);
            }
          });
        else
          t.visit(i0, j0, mask, [&](int i, int j, auto v) {
            if (i < rows && j < n) O1[entry<false>(node, m, n, r0 + i, j)] = (float)v;
          });
      }
    }
    if constexpr (kHasG2) {
      __syncthreads();   // Q's row block in its plane
      const auto X = PlaneOp<P>::gram(Qp, ld);
#pragma unroll
      for (int q = 0; q < kST; ++q) {
        if (!gm[q]) continue;
#pragma unroll 2
        for (int k0 = 0; k0 < rp; k0 += kK) g2[q].step(X, X, gi[q], gj[q], k0, gm[q]);
      }
    }
    if (kHasG1 && split > 0 && b == rb.nb1 - 1) {   // the first part, rounded
#pragma unroll
      for (int q = 0; q < kST; ++q) {
        if (!gm[q]) continue;
        g1[q].visit(gi[q], gj[q], gm[q], [&](int i, int j, auto v) { part[i * w + j] = (float)v; });
        g1[q].zero();
      }
    }
  }
  if constexpr (kHasG1)
    store_gram<kMinor>(g1, gi, gj, gm, O1, node, n, split > 0 ? part : nullptr, w);
  if constexpr (kHasG2) store_gram<kMinor>(g2, gi, gj, gm, O2, node, n, nullptr, w);
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

typedef void (*MxuKernel)(const float*, const float*, float*, float*, int, int, int);

// Super tiles a warp holds for the Gram of n columns: 2 up to n = 80 (15
// super tiles over 8 warps), 5 up to 128 (36).
inline int super_tiles(int n) {
  const int S = pad_to(n, 16) / 16, nst = S * (S + 1) / 2;
  return nst <= 2 * kWarps ? 2 : nst <= 5 * kWarps ? 5 : 0;
}

template <int P, int kWhat, bool kMinor>
MxuKernel pick(int st) {
  return st == 2 ? mxu_kernel<P, kWhat, kMinor, 2> : st == 5 ? mxu_kernel<P, kWhat, kMinor, 5> : nullptr;
}

// The instance for a probe (kGram any n <= 128, DMMA and TF32 in either
// layout, bf16 node-major; kQ node-major; kComposite n <= 80 in either
// layout), or nullptr.
MxuKernel mxu_instance(int what, int prec, int minor, int n) {
  const int st = super_tiles(n);
  if (n <= 0 || st == 0 || prec < kDmma || prec > kBf16) return nullptr;
  switch (what) {
    case kGram:
      if (prec == kBf16) return minor || st != 2 ? nullptr : mxu_kernel<kBf16, kGram, false, 2>;
      if (prec == kDmma) return minor ? pick<kDmma, kGram, true>(st) : pick<kDmma, kGram, false>(st);
      return minor ? pick<kTf32x3, kGram, true>(st) : pick<kTf32x3, kGram, false>(st);
    case kQ:
      if (minor || prec == kBf16) return nullptr;
      return prec == kDmma ? mxu_kernel<kDmma, kQ, false, 1> : mxu_kernel<kTf32x3, kQ, false, 1>;
    case kComposite:
      if (prec == kBf16 || st != 2) return nullptr;
      if (prec == kDmma)
        return minor ? mxu_kernel<kDmma, kComposite, true, 2> : mxu_kernel<kDmma, kComposite, false, 2>;
      return minor ? mxu_kernel<kTf32x3, kComposite, true, 2>
                   : mxu_kernel<kTf32x3, kComposite, false, 2>;
    default:
      return nullptr;
  }
}

// The launch's dynamic shared memory, set on its kernel; an error where
// there is no instance or the node does not fit.
cudaError_t prepare(const void* kernel, long long floats, size_t* bytes) {
  if (kernel == nullptr) return cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *bytes = (size_t)floats * sizeof(float);
  if (*bytes > (size_t)optin) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
}

}  // namespace

// A launch's dynamic shared memory, threads, the blocks an SM holds, and
// its registers and local memory bytes (spills) a thread: ``what`` 0 the
// Gram, 1 Q, 2 the composite (precision 0 DMMA, 1 TF32x3, 2 bf16; minor
// the node-minor layout) at n columns with the split row, 3
// node_transpose; returns the cudaError_t.
extern "C" int mxu_probes_occupancy(int what, int prec, int minor, int n, int split,
                                    long long* smem_bytes,
                                    int* threads, int* blocks_per_sm, int* regs,
                                    long long* local_bytes) {
  const void* kernel = what == kTranspose ? (const void*)node_transpose_kernel
                                          : (const void*)mxu_instance(what, prec, minor, n);
  size_t bytes = 0;
  cudaError_t err =
      prepare(kernel, what == kTranspose ? 0 : Layout(what, prec, n, split).total, &bytes);
  if (err != cudaSuccess) return (int)err;
  *smem_bytes = (long long)bytes;
  *threads = kThreads;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (long long)attr.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads, bytes);
}

// The product probes on B nodes of m x n A (and n x n Li; A whole in
// shared memory, so m up to ~600 at n = 80): ``what`` 0
// O1 = A^T A (split: the row where the second part starts, 0 none), 1
// O1 = A Li^T, 2 O1 = A^T A and O2 = Q^T Q, Q = A Li^T; node-minor
// tensors (minor) hold ceil(B / 128) tiles of 128, and only the first B
// nodes' slots are written.
extern "C" int mxu_probe_launch(int what, int prec, int minor, const float* A, const float* Li,
                                float* O1, float* O2, long long B, int m, int n, int split,
                                void* stream) {
  if (B <= 0 || m <= 0 || n <= 0 || split < 0 || split >= m || (split && what != kGram))
    return (int)cudaErrorInvalidValue;
  const MxuKernel k = mxu_instance(what, prec, minor, n);
  size_t bytes = 0;
  cudaError_t err = prepare((const void*)k, Layout(what, prec, n, split).total, &bytes);
  if (err != cudaSuccess) return (int)err;
  k<<<B, kThreads, bytes, (cudaStream_t)stream>>>(A, Li, O1, O2, m, n, split);
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
