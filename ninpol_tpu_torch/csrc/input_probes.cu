/*
 * Kernel 1's input stream for NVIDIA Hopper (sm_90a): how fast its
 * per-node inputs stream in, in four layouts, and whether a block's input
 * copies hide under compute.  The counterparts of the TPU probes
 * tools/r5_layout_probe.py and tools/r5_overlap_probe.py, timed by
 * ninpol_tpu_torch/tools/input_probes.py on the route's own inputs beside
 * kernel 1's floor cut (inputs, local incidence, flags).  No route runs
 * them: this library is built apart from the production ones, at the first
 * probe launch.  ninpol_tpu_torch/ops/input_probes.py holds the contracts,
 * the pack step, the wrappers and the plain PyTorch versions.
 *
 * A node's record is kernel 1's input for that node: dk, l1, l2, t1m, tt,
 * lb, nm (float64), pair, ks (int32), cv, fv, isneu, valid (0/1 bytes).
 * Packed, it is one contiguous row of ``stride`` bytes a node in three
 * regions, the float64 fields, then the int32 ones, then the bytes, each
 * field zero-padded to 16 bytes; a region's bytes are a multiple of 16,
 * so a record may be read in 8- or 16-byte words and copied by
 * cp.async.bulk.  Its sum is the float64 sum of the float64 entries plus
 * the integer sum of the int32 and byte entries (exact in 64 bits).
 *
 * input_sum (replaces tools/r5_layout_probe.py:60, :72, :85, :105): out[b]
 *   = the sum of node b's record, so that every byte is read, as the TPU
 *   bodies reduce their whole block.  Bound by bytes: the design of each
 *   body keeps enough bytes in flight to cover the card's memory latency
 *   (some 16-20 KB an SM at 3.35 TB/s).  Instances (layout):
 *     kNatural  the thirteen tensors as ops/gls_solve.py::gls_solve takes
 *               them (:60, the production layout, no pack step):
 *               persistent blocks, a warp a node, two buffers and two
 *               mbarriers a warp; the node's nine float64 and int32 spans
 *               (dk, l1, l2, t1m, tt, lb, nm, pair, ks) come in by one
 *               cp.async.bulk each, issued by the span's own lane, while
 *               the warp sums the node before from the other buffer; the
 *               byte masks (cv, fv, isneu, valid; not 16-byte aligned at
 *               the tet classes) by plain loads a node ahead, into
 *               registers; a shuffle reduction; no block barrier.  Where
 *               every span is whole 16-byte words at 16-byte boundaries
 *               (the tet classes; kAligned) the spans land back to back
 *               and are summed by two flat loops; else each comes as the
 *               16-byte span that covers it, clipped to its tensor, the
 *               bytes outside a clipped span read by plain loads.  On
 *               the card the warp's instructions a node bound it more
 *               than the copies do: the kAligned form's flat loops, and
 *               the copies issued by nine lanes at once, are what bring it
 *               near the packed record's rate (PERF.md);
 *     kPacked   the packed record in 8-byte words (:72): persistent
 *               blocks, a warp a node, each lane's kPackedWords loads of
 *               a node issued together, the next node's before this
 *               node's shuffle reduction;
 *     kWide     the same record, one block a node, 16-byte loads, a block
 *               reduction (:85, wider rows);
 *     kBulk     the same, one cp.async.bulk (the TMA's 1-D copy) of the
 *               record into shared memory against an mbarrier, summed
 *               there (:85);
 *     kMulti    8 nodes a block, a warp a node, 8-byte loads (:105,
 *               several tiles a step);
 *     kMinor    the record node-minor, (stride / 8, B) 8-byte words
 *               (:105, the TPU's own lane layout): a block of
 *               kMinorWarps warps 32 nodes, warp s words [s W / S,
 *               (s + 1) W / S) of every node, a lane a node, so that a
 *               warp's load is one 256-byte span; kMinorLoads loads in
 *               flight a lane and the next batch issued before this one
 *               is summed; the partials combined in shared memory;
 *     kPrologue kernel 1's prologue as written (gls_solve.cu:394-419):
 *               the thirteen tensors, one block of 256 threads a node,
 *               an element a thread (8-byte doubles, 4-byte ints, 1-byte
 *               masks), a block reduction (:60, what kNatural replaced).
 *   A dynamic shared memory request (``smem_bytes``) sets the blocks an
 *   SM, so an instance can run at kernel 1's occupancy; the persistent
 *   instances (kNatural, kPacked) launch the SMs times the blocks an SM
 *   holds, or ``blocks``.

 * overlap_probe (replaces tools/r5_overlap_probe.py:100): per node, red =
 *   the record's sum (the copy made real: a GPU moves only the bytes that
 *   are read), r = red, and w (E floats) by body:
 *     kTrivial  w = red;
 *     kIndep    w = the dummy work seeded from the argument ``seed``;
 *     kDep      w = the dummy work seeded from red;
 *     kCompute  the dummy work alone, no record read (r = 0).
 *   The dummy work is the TPU probe's: acc = seed 1e-6 over (E, 128)
 *   float32, ``iters`` rounds of x = 0.999 x + acc, w_e = sum_k x[e][k].
 *   ``iters`` and ``seed`` are run-time arguments, so nothing folds; an
 *   empty asm keeps the (E, 128) chains apart, which the compiler would
 *   otherwise merge (they are the same expression).  Two schedules:
 *     kBlock      one node a block: the record copied into shared memory
 *                 by 16-byte loads, a barrier, its sum, then the body, as
 *                 kernel 1 runs; only other blocks on the SM overlap one
 *                 block's copy with its compute;
 *     kPipelined  persistent blocks (SMs x the blocks an SM holds unless
 *                 given), each walking nodes blockIdx, blockIdx + grid,
 *                 ...: two record buffers in shared memory, each with an
 *                 mbarrier; the record of the block's next node is in
 *                 flight by cp.async.bulk while it sums and computes this
 *                 one.
 *   Bound by bytes (the record) or by the FP32 operations of the dummy
 *   work.
 *
 * Every wait on an mbarrier spins a bounded number of times and then
 * traps, so a wrong phase parity ends the launch with an error instead
 * of hanging the card.  Every launch function returns a cudaError_t as int
 * (0 on success).
 */
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace {

using namespace bulk_copy;

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kMultiNodes = kWarps;    // kMulti: a warp a node
constexpr int kPackedWords = 18;       // kPacked: a lane's loads of a node ((24, 36): 566 words)
constexpr int kMinorWarps = 4;         // kMinor: warps a block, word ranges of a node (S)
constexpr int kMinorLoads = 8;         // kMinor: a batch of loads a lane
constexpr int kSpans = 9;              // kNatural: dk, l1, l2, t1m, tt, lb, nm (float64), pair, ks
constexpr int kSpansF64 = 7;
constexpr int kMaskSlots = 2;          // kNatural: mask bytes a lane holds for the next node
constexpr int kSlots = 128;            // the dummy work's columns
constexpr int kMaxE = 2 * 16;          // its rows: two halves of 128 threads, 16 rows each
constexpr int kFields = 13;

enum { kNatural = 0, kPacked = 1, kWide = 2, kBulk = 3, kMulti = 4, kMinor = 5, kPrologue = 6 };
enum { kTrivial = 0, kIndep = 1, kDep = 2, kCompute = 3 };
enum { kBlock = 0, kPipelined = 1 };
enum { kWhatSum = 0, kWhatOverlap = 1 };

// The record's three regions, bytes (each a multiple of 16).
struct Regions {
  int f64, i32, u8;
  __host__ __device__ int stride() const { return f64 + i32 + u8; }
};

// kNatural's spans (p[0..8]): each one's bytes a node (0: absent) and
// offset in a buffer of ``buf`` bytes (room for each covering span); the
// bytes of the float64 spans and of the int32 ones
struct Spans {
  int len[kSpans], off[kSpans], buf, f64, i32;
};

struct SumArgs {
  const void* p[kFields];   // kNatural, kPrologue: dk, l1, l2, t1m, tt, lb, nm, pair, ks, cv,
                            // fv, isneu, valid; else p[0], the record
  long long B;
  int E, F, wneu;
  Regions g;
  Spans sp;
  double* out;
};

struct OverlapArgs {
  const unsigned char* rec;
  long long B;
  Regions g;
  int E, iters;
  float seed;
  float* w;
  double* r;
};

// ---- sums

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// the four bytes of u, added
__device__ __forceinline__ long long byte_sum(uint32_t u) {
  u = (u & 0x00ff00ffu) + ((u >> 8) & 0x00ff00ffu);
  return (long long)((u & 0xffffu) + (u >> 16));
}

// A record's entries from word ``first`` on, every ``step``-th word of
// kBytes (8 or 16) in each region: float64 into d, the integers into n.
template <int kBytes>
__device__ __forceinline__ void sum_record(const unsigned char* rec, Regions g, int first, int step,
                                           double& d, long long& n) {
  const unsigned char* ri = rec + g.f64;
  const unsigned char* rb = ri + g.i32;
  if constexpr (kBytes == 8) {
    const double* pd = reinterpret_cast<const double*>(rec);
#pragma unroll 4
    for (int k = first; k < g.f64 / 8; k += step) d += pd[k];
    const int2* pi = reinterpret_cast<const int2*>(ri);
#pragma unroll 4
    for (int k = first; k < g.i32 / 8; k += step) {
      const int2 v = pi[k];
      n += (long long)v.x + v.y;
    }
    const uint2* pb = reinterpret_cast<const uint2*>(rb);
    for (int k = first; k < g.u8 / 8; k += step) {
      const uint2 v = pb[k];
      n += byte_sum(v.x) + byte_sum(v.y);
    }
  } else {
    const double2* pd = reinterpret_cast<const double2*>(rec);
#pragma unroll 4
    for (int k = first; k < g.f64 / 16; k += step) {
      const double2 v = pd[k];
      d += v.x + v.y;
    }
    const int4* pi = reinterpret_cast<const int4*>(ri);
#pragma unroll 4
    for (int k = first; k < g.i32 / 16; k += step) {
      const int4 v = pi[k];
      n += (long long)v.x + v.y + v.z + v.w;
    }
    const uint4* pb = reinterpret_cast<const uint4*>(rb);
    for (int k = first; k < g.u8 / 16; k += step) {
      const uint4 v = pb[k];
      n += byte_sum(v.x) + byte_sum(v.y) + byte_sum(v.z) + byte_sum(v.w);
    }
  }
}

// (d, n) summed over the block (kThreads), the total in every thread; the
// caller separates two calls by a barrier
__device__ __forceinline__ double block_sum(double d, long long n, double* sd, long long* sn) {
  d = warp_sum(d);
  n = warp_sum(n);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    sd[warp] = d;
    sn[warp] = n;
  }
  __syncthreads();
  d = 0.0;
  n = 0;
#pragma unroll
  for (int q = 0; q < kWarps; ++q) {
    d += sd[q];
    n += sn[q];
  }
  return d + (double)n;
}

// One 8-byte word of a record, word k of its (f64, f64 + i32) region
// bounds in words: a double into d, two int32 or eight bytes into n.  A
// zero word adds nothing in any region.
__device__ __forceinline__ void add_word(unsigned long long w, int k, int wf, int wfi, double& d,
                                         long long& n) {
  const uint32_t lo = (uint32_t)w, hi = (uint32_t)(w >> 32);
  if (k < wf)
    d += __longlong_as_double((long long)w);
  else if (k < wfi)
    n += (long long)(int)lo + (int)hi;
  else
    n += byte_sum(lo) + byte_sum(hi);
}

// ---- input_sum

// kPrologue: kernel 1's prologue as written
__global__ void __launch_bounds__(kThreads) prologue_kernel(SumArgs a) {
  __shared__ double sd[kWarps];
  __shared__ long long sn[kWarps];
  const int tid = threadIdx.x, E = a.E, F = a.F;
  const long long b = blockIdx.x;
  const double* dk = static_cast<const double*>(a.p[0]);
  const double* l1 = static_cast<const double*>(a.p[1]);
  const double* l2 = static_cast<const double*>(a.p[2]);
  const double* t1m = static_cast<const double*>(a.p[3]);
  const double* tt = static_cast<const double*>(a.p[4]);
  const double* lb = static_cast<const double*>(a.p[5]);
  const double* nm = static_cast<const double*>(a.p[6]);
  const int* pair = static_cast<const int*>(a.p[7]);
  const int* ks = static_cast<const int*>(a.p[8]);
  const unsigned char* cv = static_cast<const unsigned char*>(a.p[9]);
  const unsigned char* fv = static_cast<const unsigned char*>(a.p[10]);
  const unsigned char* isneu = static_cast<const unsigned char*>(a.p[11]);
  const unsigned char* valid = static_cast<const unsigned char*>(a.p[12]);
  double d = 0.0;
  long long n = 0;
  for (int i = tid; i < 3 * E; i += kThreads) d += dk[b * 3 * E + i];
  for (int i = tid; i < 3 * F; i += kThreads) {
    const long long o = b * 3 * F + i;
    d += l1[o];
    d += l2[o];
    d += t1m[o];
    d += tt[o];
    if (a.wneu) d += lb[o];
  }
  if (a.wneu)
    for (int f = tid; f < F; f += kThreads) d += nm[b * F + f];
  for (int f = tid; f < F; f += kThreads)
    n += (long long)pair[b * 2 * F + 2 * f] + pair[b * 2 * F + 2 * f + 1] + fv[b * F + f];
  for (int e = tid; e < E; e += kThreads) n += (long long)ks[b * E + e] + cv[b * E + e];
  if (tid == 0) n += isneu[b] + valid[b];
  const double total = block_sum(d, n, sd, sn);
  if (tid == 0) a.out[b] = total;
}

// kNatural.  Node b's bytes [s, e) of a tensor [ts, ts + B len), and the
// 16-byte aligned part [lo, hi) that a bulk copy brings in (lo == hi:
// none): the 16-byte span covering [s, e), less a first or last 16 bytes
// that would reach outside the tensor.  Every byte of [s, e) outside
// [lo, hi) is read by a plain load; the copy lands at a buffer's 16-byte
// boundary, byte p at (p - lo).
struct Span {
  uintptr_t s, e, lo, hi;
};

__device__ __forceinline__ Span span_of(const void* base, int len, long long b, long long B) {
  const uintptr_t ts = reinterpret_cast<uintptr_t>(base), te = ts + (uintptr_t)(B * len);
  const uintptr_t s = ts + (uintptr_t)(b * len), e = s + len;
  uintptr_t lo = s & ~(uintptr_t)15, hi = (e + 15) & ~(uintptr_t)15;
  if (lo < ts) lo += 16;
  if (hi > te) hi -= 16;
  if (hi <= lo) lo = hi = s;
  return {s, e, lo, hi};
}

// Lane k < kSpans of a warp: node b's span k (``len`` bytes of the tensor
// at ``base``; len 0: absent) into ``buf``, completing on ``bar``, lane 0
// expecting the spans' bytes.  kAligned (every span whole 16-byte words
// at 16-byte boundaries): the node's bytes themselves, span k at
// sp.off[k], so the float64 spans and then the int32 ones lie back to
// back; else the covering span, clipped to its tensor (span_of).
template <bool kAligned>
__device__ __forceinline__ void natural_issue(const SumArgs& a, long long b, int len,
                                              const unsigned char* base, unsigned char* buf,
                                              uint64_t* bar) {
  const int lane = threadIdx.x % 32;
  uintptr_t lo = 0, hi = 0;
  if (len) {
    if constexpr (kAligned) {
      lo = reinterpret_cast<uintptr_t>(base + b * len);
      hi = lo + len;
    } else {
      const Span q = span_of(base, len, b, a.B);
      lo = q.lo;
      hi = q.hi;
    }
  }
  const unsigned bytes = (unsigned)(hi - lo);
  unsigned total = bytes;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) total += __shfl_xor_sync(0xffffffffu, total, off);
  if (lane == 0) {
    fence_async_shared();
    mbar_expect(bar, total);
  }
  __syncwarp();
  if (bytes) bulk_copy_in(buf + a.sp.off[lane], reinterpret_cast<const void*>(lo), bytes, bar);
  __syncwarp();
}

// A warp's sum of node b's entries of span k (type T) into acc, the
// covering span's copy in ``buf``: the part it holds from there, the rest
// by plain loads.
template <typename T, typename Acc>
__device__ __forceinline__ void natural_span_sum(const SumArgs& a, int k, long long b,
                                                 const unsigned char* buf, int lane, Acc& acc) {
  const Span q = span_of(a.p[k], a.sp.len[k], b, a.B);
  const uintptr_t p0 = q.s > q.lo ? q.s : q.lo, p1 = q.e < q.hi ? q.e : q.hi;
  const T* x = reinterpret_cast<const T*>(buf + a.sp.off[k] + (p0 - q.lo));
  const int n = (int)((p1 - p0) / sizeof(T));
  for (int j = lane; j < n; j += 32) acc += x[j];
  for (uintptr_t p = q.s + lane * sizeof(T); p < p0; p += 32 * sizeof(T))
    acc += *reinterpret_cast<const T*>(p);
  for (uintptr_t p = p1 + lane * sizeof(T); p < q.e; p += 32 * sizeof(T))
    acc += *reinterpret_cast<const T*>(p);
}

// Mask byte j of node b, j < E + F + 2: cv, fv, isneu, valid.
__device__ __forceinline__ uint32_t mask_byte(const SumArgs& a, long long b, int j) {
  const unsigned char* q = j < a.E       ? static_cast<const unsigned char*>(a.p[9]) + b * a.E + j
                           : j < a.E + a.F ? static_cast<const unsigned char*>(a.p[10]) + b * a.F +
                                                 (j - a.E)
                           : j == a.E + a.F ? static_cast<const unsigned char*>(a.p[11]) + b
                                            : static_cast<const unsigned char*>(a.p[12]) + b;
  return *q;
}

// Node b's first 32 kMaskSlots mask bytes, a lane's share (0 for b >= B).
__device__ __forceinline__ void load_masks(const SumArgs& a, long long b, int lane,
                                           uint32_t (&m)[kMaskSlots]) {
  const int count = b < a.B ? a.E + a.F + 2 : 0;
#pragma unroll
  for (int q = 0; q < kMaskSlots; ++q) {
    const int j = lane + 32 * q;
    m[q] = j < count ? mask_byte(a, b, j) : 0u;
  }
}

// Persistent blocks, a warp a node: the warp walks nodes b, b + step, ...
// with two buffers and two mbarriers of its own; the next node's spans (a
// copy a span, issued by the span's lane) and masks are in flight while
// it sums this one.
template <bool kAligned>
__global__ void __launch_bounds__(kThreads) natural_kernel(SumArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];   // two buffers a warp
  __shared__ uint64_t bars[2 * kWarps];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, warps = blockDim.x / 32;
  const long long step = (long long)gridDim.x * warps;
  long long b = (long long)blockIdx.x * warps + warp;
  if (b >= a.B) return;   // no node for this warp (the kernel has no block barrier)
  uint64_t* bar = bars + 2 * warp;
  unsigned char* bufs = smem + (size_t)warp * 2 * a.sp.buf;
  const int len = lane < kSpans ? a.sp.len[lane] : 0;   // this lane's span
  const unsigned char* base = len ? static_cast<const unsigned char*>(a.p[lane]) : nullptr;
  if (lane == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
  }
  __syncwarp();
  natural_issue<kAligned>(a, b, len, base, bufs, &bar[0]);
  uint32_t m0[kMaskSlots], m1[kMaskSlots];   // the masks of the nodes in buffers 0 and 1
  load_masks(a, b, lane, m0);
  const int masks = a.E + a.F + 2;
  for (int i = 0; b < a.B; b += step, ++i) {
    const int cur = i & 1;
    const unsigned char* buf = bufs + cur * a.sp.buf;
    // the other buffer was last read in the step before, behind its
    // __syncwarp
    if (b + step < a.B) {
      natural_issue<kAligned>(a, b + step, len, base, bufs + (cur ^ 1) * a.sp.buf, &bar[cur ^ 1]);
      if (cur)
        load_masks(a, b + step, lane, m0);
      else
        load_masks(a, b + step, lane, m1);
    }
    mbar_wait(&bar[cur], (i >> 1) & 1);   // this buffer's (i / 2)-th fill
    double d0 = 0.0, d1 = 0.0;
    long long n = 0;
    if constexpr (kAligned) {
      const double* x = reinterpret_cast<const double*>(buf);
      const int nd = a.sp.f64 / 8, ni = a.sp.i32 / 4;
      int j = lane;
      for (; j + 32 < nd; j += 64) {
        d0 += x[j];
        d1 += x[j + 32];
      }
      if (j < nd) d0 += x[j];
      const int* y = reinterpret_cast<const int*>(buf + a.sp.f64);
      for (j = lane; j < ni; j += 32) n += y[j];
    } else {
#pragma unroll
      for (int k = 0; k < kSpans; ++k) {
        if (!a.sp.len[k]) continue;
        if (k < kSpansF64)
          natural_span_sum<double>(a, k, b, buf, lane, k & 1 ? d1 : d0);
        else
          natural_span_sum<int>(a, k, b, buf, lane, n);
      }
    }
#pragma unroll
    for (int q = 0; q < kMaskSlots; ++q) n += cur ? m1[q] : m0[q];
    for (int j = lane + 32 * kMaskSlots; j < masks; j += 32) n += mask_byte(a, b, j);
    __syncwarp();   // this buffer is free for the step after next
    const double d = warp_sum(d0 + d1);
    n = warp_sum(n);
    if (lane == 0) a.out[b] = d + (double)n;
  }
}

// kPacked: word c kPackedWords 32 + lane + 32 j of the node's record into
// v[j] (0 past its ``words``)
__device__ __forceinline__ void packed_load(const unsigned long long* rec, int first, int words,
                                            unsigned long long (&v)[kPackedWords]) {
#pragma unroll
  for (int j = 0; j < kPackedWords; ++j) {
    const int k = first + 32 * j;
    v[j] = k < words ? rec[k] : 0ull;
  }
}

__global__ void __launch_bounds__(kThreads, 2) packed_kernel(SumArgs a) {
  const int lane = threadIdx.x % 32, warps = blockDim.x / 32;
  const int words = a.g.stride() / 8, wf = a.g.f64 / 8, wfi = (a.g.f64 + a.g.i32) / 8;
  const int chunk = 32 * kPackedWords, chunks = (words + chunk - 1) / chunk;
  const long long step = (long long)gridDim.x * warps;
  const unsigned long long* rec = static_cast<const unsigned long long*>(a.p[0]);
  long long b = (long long)blockIdx.x * warps + threadIdx.x / 32;
  if (b >= a.B) return;
  // the warp walks (node, chunk) items: nodes b, b + step, ..., each in
  // chunks of 32 kPackedWords words
  int c = 0;
  unsigned long long cur[kPackedWords], next[kPackedWords];
  packed_load(rec + b * words, lane, words, cur);
  double d0 = 0.0, d1 = 0.0;
  long long n = 0;
  for (;;) {
    long long bn = b;
    int cn = c + 1;
    if (cn == chunks) {
      cn = 0;
      bn = b + step;
    }
    const bool more = bn < a.B;
    if (more) packed_load(rec + bn * words, cn * chunk + lane, words, next);
#pragma unroll
    for (int j = 0; j < kPackedWords; ++j)
      add_word(cur[j], c * chunk + lane + 32 * j, wf, wfi, j & 1 ? d1 : d0, n);
    if (c == chunks - 1) {
      const double d = warp_sum(d0 + d1);
      const long long t = warp_sum(n);
      if (lane == 0) a.out[b] = d + (double)t;
      d0 = d1 = 0.0;
      n = 0;
    }
    if (!more) break;
#pragma unroll
    for (int j = 0; j < kPackedWords; ++j) cur[j] = next[j];
    b = bn;
    c = cn;
  }
}

// kWide: one block a node, 16-byte loads
__global__ void __launch_bounds__(kThreads) wide_kernel(SumArgs a) {
  __shared__ double sd[kWarps];
  __shared__ long long sn[kWarps];
  const long long b = blockIdx.x;
  const unsigned char* rec = static_cast<const unsigned char*>(a.p[0]) + b * a.g.stride();
  double d = 0.0;
  long long n = 0;
  sum_record<16>(rec, a.g, threadIdx.x, kThreads, d, n);
  const double total = block_sum(d, n, sd, sn);
  if (threadIdx.x == 0) a.out[b] = total;
}

__global__ void __launch_bounds__(kThreads) bulk_kernel(SumArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t bar[1];
  __shared__ double sd[kWarps];
  __shared__ long long sn[kWarps];
  const long long b = blockIdx.x;
  const int stride = a.g.stride();
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    bulk_load(smem, static_cast<const unsigned char*>(a.p[0]) + b * stride, stride, bar);
  }
  __syncthreads();
  mbar_wait(bar, 0);
  double d = 0.0;
  long long n = 0;
  sum_record<16>(smem, a.g, threadIdx.x, kThreads, d, n);
  const double total = block_sum(d, n, sd, sn);
  if (threadIdx.x == 0) a.out[b] = total;
}

__global__ void __launch_bounds__(kThreads) multi_kernel(SumArgs a) {
  const int lane = threadIdx.x % 32;
  const long long b = (long long)blockIdx.x * kMultiNodes + threadIdx.x / 32;
  if (b >= a.B) return;   // the last block's tail: whole warps
  double d = 0.0;
  long long n = 0;
  sum_record<8>(static_cast<const unsigned char*>(a.p[0]) + b * a.g.stride(), a.g, lane, 32, d,
                n);
  d = warp_sum(d);
  n = warp_sum(n);
  if (lane == 0) a.out[b] = d + (double)n;
}

// kMinor, a batch: words k, k + 1, ..., k + kMinorLoads - 1 (< hi) of the
// lane's node, word k at x[k B]
__device__ __forceinline__ void minor_load(const unsigned long long* x, long long B, int k,
                                           int hi, unsigned long long (&v)[kMinorLoads]) {
#pragma unroll
  for (int j = 0; j < kMinorLoads; ++j) v[j] = k + j < hi ? x[(long long)(k + j) * B] : 0ull;
}

// node-minor: word k of node b at x[k B + b], 8 bytes
__global__ void __launch_bounds__(kMinorWarps * 32, 8) minor_kernel(SumArgs a) {
  __shared__ double sd[kMinorWarps][32];
  __shared__ long long sn[kMinorWarps][32];
  const int lane = threadIdx.x % 32, s = threadIdx.x / 32;
  const long long B = a.B, b = (long long)blockIdx.x * 32 + lane;
  const int words = a.g.stride() / 8, wf = a.g.f64 / 8, wfi = (a.g.f64 + a.g.i32) / 8;
  const int lo = (int)((long long)words * s / kMinorWarps);
  const int hi = b < B ? (int)((long long)words * (s + 1) / kMinorWarps) : lo;
  const unsigned long long* x = static_cast<const unsigned long long*>(a.p[0]) + b;
  double d0 = 0.0, d1 = 0.0;
  long long n = 0;
  unsigned long long u[kMinorLoads], v[kMinorLoads];
  // two batches in flight: the next issued before this one is summed
  minor_load(x, B, lo, hi, u);
  for (int k = lo; k < hi; k += 2 * kMinorLoads) {
    minor_load(x, B, k + kMinorLoads, hi, v);
#pragma unroll
    for (int j = 0; j < kMinorLoads; ++j) add_word(u[j], k + j, wf, wfi, j & 1 ? d1 : d0, n);
    minor_load(x, B, k + 2 * kMinorLoads, hi, u);
#pragma unroll
    for (int j = 0; j < kMinorLoads; ++j)
      add_word(v[j], k + kMinorLoads + j, wf, wfi, j & 1 ? d1 : d0, n);
  }
  sd[s][lane] = d0 + d1;
  sn[s][lane] = n;
  __syncthreads();
  if (s == 0 && b < B) {
    double d = 0.0;
    long long t = 0;
#pragma unroll
    for (int q = 0; q < kMinorWarps; ++q) {
      d += sd[q][lane];
      t += sn[q][lane];
    }
    a.out[b] = d + (double)t;
  }
}

// ---- overlap_probe

// Keeps a value opaque to the optimizer at no cost in instructions.
__device__ __forceinline__ void opaque(float& v) {
#ifndef CUDA_EMU
  asm volatile("" : "+f"(v));
#endif
}

// The dummy work of one node into w (E floats), by the block: thread t
// takes column t % 128 of rows t / 128, t / 128 + 2, ... (kTiers of them);
// part holds kWarps x kTiers floats of shared memory.  Ends after a
// barrier.
template <int kTiers>
__device__ __forceinline__ void dummy_work(float seed, int iters, int E, float* w, float* part) {
  const int tid = threadIdx.x, half = tid / kSlots, warp = tid / 32;
  const float acc = seed * 1e-6f;
  float x[kTiers];
#pragma unroll
  for (int j = 0; j < kTiers; ++j) x[j] = acc;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < kTiers; ++j) {
      x[j] = x[j] * 0.999f + acc;
      opaque(x[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kTiers; ++j) {
    const float v = warp_sum(half + 2 * j < E ? x[j] : 0.f);
    if (tid % 32 == 0) part[warp * kTiers + j] = v;
  }
  __syncthreads();
  if (tid < E) {
    const int h = tid & 1, j = tid >> 1;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kSlots / 32; ++q) s += part[(h * (kSlots / 32) + q) * kTiers + j];
    w[tid] = s;
  }
}

template <int kBody, int kTiers>
__device__ __forceinline__ void finish(const OverlapArgs& a, long long b, double red,
                                       float* part) {
  float* w = a.w + b * a.E;
  if constexpr (kBody == kTrivial) {
    for (int e = threadIdx.x; e < a.E; e += kThreads) w[e] = (float)red;
  } else {
    dummy_work<kTiers>(kBody == kDep ? (float)red : a.seed, a.iters, a.E, w, part);
  }
  if (threadIdx.x == 0) a.r[b] = red;
}

template <int kBody, int kTiers>
__global__ void __launch_bounds__(kThreads) overlap_block_kernel(OverlapArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double sd[kWarps];
  __shared__ long long sn[kWarps];
  __shared__ float part[kWarps * kTiers];
  const long long b = blockIdx.x;
  double red = 0.0;
  if constexpr (kBody != kCompute) {
    const int stride = a.g.stride();
    const uint4* src = reinterpret_cast<const uint4*>(a.rec + b * stride);
    uint4* dst = reinterpret_cast<uint4*>(smem);
    for (int k = threadIdx.x; k < stride / 16; k += kThreads) dst[k] = src[k];
    __syncthreads();
    double d = 0.0;
    long long n = 0;
    sum_record<16>(smem, a.g, threadIdx.x, kThreads, d, n);
    red = block_sum(d, n, sd, sn);
  }
  finish<kBody, kTiers>(a, b, red, part);
}

template <int kBody, int kTiers>
__global__ void __launch_bounds__(kThreads) overlap_pipelined_kernel(OverlapArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];   // two record buffers
  __shared__ uint64_t bar[2];
  __shared__ double sd[kWarps];
  __shared__ long long sn[kWarps];
  __shared__ float part[kWarps * kTiers];
  constexpr bool kReads = kBody != kCompute;
  const int stride = a.g.stride();
  const long long first = blockIdx.x, step = gridDim.x;
  if (kReads && threadIdx.x == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    if (first < a.B) bulk_load(smem, a.rec + first * stride, stride, &bar[0]);
  }
  __syncthreads();
  int i = 0;
  for (long long b = first; b < a.B; b += step, ++i) {
    double red = 0.0;
    if constexpr (kReads) {
      const int cur = i & 1;
      // the other buffer was last read in the step before, behind its
      // closing barrier
      if (threadIdx.x == 0 && b + step < a.B)
        bulk_load(smem + (cur ^ 1) * stride, a.rec + (b + step) * stride, stride, &bar[cur ^ 1]);
      mbar_wait(&bar[cur], (i >> 1) & 1);   // this buffer's (i / 2)-th fill
      double d = 0.0;
      long long n = 0;
      sum_record<16>(smem + cur * stride, a.g, threadIdx.x, kThreads, d, n);
      red = block_sum(d, n, sd, sn);
    }
    finish<kBody, kTiers>(a, b, red, part);
    __syncthreads();
  }
}

// ---- instances, shared memory, launches

typedef void (*SumKernel)(SumArgs);
typedef void (*OverlapKernel)(OverlapArgs);

SumKernel sum_instance(int layout) {
  switch (layout) {
    case kNatural: return natural_kernel<false>;
    case kPacked: return packed_kernel;
    case kWide: return wide_kernel;
    case kBulk: return bulk_kernel;
    case kMulti: return multi_kernel;
    case kMinor: return minor_kernel;
    case kPrologue: return prologue_kernel;
    default: return nullptr;
  }
}

bool persistent(int layout) { return layout == kNatural || layout == kPacked; }

// kNatural's spans at (E, F), lb and nm only with Neumann rows: bytes a
// node; a buffer holds each covering span (its bytes rounded up to 16, and
// 16 more), or with ``aligned`` the spans back to back
Spans natural_spans(int E, int F, int wneu, bool aligned) {
  const int len[kSpans] = {24 * E, 24 * F, 24 * F, 24 * F, 24 * F, wneu ? 24 * F : 0,
                           wneu ? 8 * F : 0, 8 * F, 4 * E};
  Spans sp;
  sp.buf = sp.f64 = sp.i32 = 0;
  int at = 0;
  for (int k = 0; k < kSpans; ++k) {
    sp.len[k] = len[k];
    (k < kSpansF64 ? sp.f64 : sp.i32) += len[k];
    sp.off[k] = aligned ? at : sp.buf;
    at += len[k];
    if (len[k]) sp.buf += (len[k] + 15) / 16 * 16 + 16;
  }
  return sp;
}

// Whether every present span of kNatural is whole 16-byte words at 16-byte
// boundaries (the tensors at 16-byte boundaries, every span's bytes a
// multiple of 16), so its kAligned instance applies
bool natural_aligned(const void* const* p, const Spans& sp) {
  for (int k = 0; k < kSpans; ++k)
    if (sp.len[k] && (sp.len[k] % 16 || reinterpret_cast<uintptr_t>(p[k]) % 16)) return false;
  return true;
}

template <int kBody>
OverlapKernel overlap_tiers(int schedule, int E) {
  const int tiers = (E + 1) / 2;
#define NINPOL_TIERS(T)                                                              \
  if (tiers <= T)                                                                    \
    return schedule == kBlock ? overlap_block_kernel<kBody, T>                       \
                              : overlap_pipelined_kernel<kBody, T>;
  NINPOL_TIERS(2)
  NINPOL_TIERS(6)
  NINPOL_TIERS(12)
  NINPOL_TIERS(16)
#undef NINPOL_TIERS
  return nullptr;
}

OverlapKernel overlap_instance(int body, int schedule, int E) {
  if (E < 1 || E > kMaxE || (schedule != kBlock && schedule != kPipelined)) return nullptr;
  switch (body) {
    case kTrivial: return overlap_tiers<kTrivial>(schedule, E);
    case kIndep: return overlap_tiers<kIndep>(schedule, E);
    case kDep: return overlap_tiers<kDep>(schedule, E);
    case kCompute: return overlap_tiers<kCompute>(schedule, E);
    default: return nullptr;
  }
}

// A launch's kernel, threads and the dynamic shared memory it needs:
// ``what`` kWhatSum (variant: the layout) or kWhatOverlap (variant:
// body * 2 + schedule) on records of ``stride`` bytes, E rows of dummy work
// (kNatural: its spans at (E, F, wneu), two buffers a warp, as many warps
// as fit, at most kWarps).
struct Plan {
  const void* kernel = nullptr;
  int threads = kThreads;
  long long need = 0;
};

Plan plan(int what, int variant, int stride, int E, int F, int wneu) {
  Plan p;
  if (what == kWhatSum) {
    p.kernel = (const void*)sum_instance(variant);
    if (variant == kMinor) p.threads = kMinorWarps * 32;
    if (variant == kBulk) p.need = stride;
    if (variant == kNatural) {
      int dev = 0, optin = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      const long long pair = 2LL * natural_spans(E, F, wneu, false).buf;
      const long long warps = optin / pair < kWarps ? optin / pair : kWarps;
      p.threads = 32 * (int)(warps > 0 ? warps : 1);
      p.need = (p.threads / 32) * pair;
      // the kAligned instance where the class's spans are whole 16-byte
      // words (the launch checks the tensors' addresses too)
      const Spans sp = natural_spans(E, F, wneu, false);
      bool whole = true;
      for (int k = 0; k < kSpans; ++k) whole = whole && sp.len[k] % 16 == 0;
      if (whole) p.kernel = (const void*)natural_kernel<true>;
    }
  } else if (what == kWhatOverlap) {
    const int body = variant / 2, schedule = variant % 2;
    p.kernel = (const void*)overlap_instance(body, schedule, E);
    if (body != kCompute) p.need = (schedule == kPipelined ? 2LL : 1LL) * stride;
  }
  return p;
}

// The launch's dynamic shared memory, max(need, request), set on its
// kernel; an error where there is no instance or it does not fit.
cudaError_t prepare(const Plan& p, long long request, size_t* bytes) {
  if (p.kernel == nullptr || request < 0) return cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *bytes = (size_t)(p.need > request ? p.need : request);
  if (*bytes > (size_t)optin) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(p.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
}

// A persistent launch's grid: ``blocks``, or with 0 the SMs times the
// blocks an SM holds, at most the blocks that have work (``units`` of
// ``per_block``)
cudaError_t persistent_grid(const Plan& p, size_t bytes, int blocks, long long units,
                            int per_block, long long* grid) {
  long long g = blocks;
  if (g == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, p.kernel, p.threads, bytes);
    if (err != cudaSuccess) return err;
    g = (long long)sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long most = (units + per_block - 1) / per_block;
  *grid = g < most ? g : most;
  return cudaSuccess;
}

bool regions_ok(int f64, int i32, int u8) {
  return f64 >= 0 && i32 >= 0 && u8 >= 0 && f64 % 16 == 0 && i32 % 16 == 0 && u8 % 16 == 0 &&
         f64 + i32 + u8 > 0;
}

}  // namespace

// A launch's dynamic shared memory, threads, the blocks an SM holds, and
// its registers and local memory bytes (spills) a thread: ``what`` 0
// input_sum (variant: layout 0 natural, 1 packed, 2 wide, 3 bulk, 4 multi,
// 5 minor, 6 prologue; natural at (E, F, wneu)), 1 overlap_probe
// (variant: body 0 trivial, 1 indep, 2 dep, 3 compute, times 2, plus
// schedule 0 block, 1 pipelined) on records of ``stride`` bytes with E
// rows of dummy work, at a dynamic shared memory request of ``request``
// bytes; returns the cudaError_t.
extern "C" int input_probes_occupancy(int what, int variant, int stride, int E, int F, int wneu,
                                      long long request, long long* smem_bytes, int* threads,
                                      int* blocks_per_sm, int* regs, long long* local_bytes) {
  const Plan p = plan(what, variant, stride, E, F, wneu);
  size_t bytes = 0;
  cudaError_t err = prepare(p, request, &bytes);
  if (err != cudaSuccess) return (int)err;
  *smem_bytes = (long long)bytes;
  *threads = p.threads;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, p.kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (long long)attr.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, p.kernel, p.threads,
                                                            bytes);
}

// out[b] = the sum of node b's record, b < B: ``layout`` kNatural and
// kPrologue read p[0..12] (dk, l1, l2, t1m, tt, lb, nm, pair, ks, cv, fv,
// isneu, valid; lb and nm null without Neumann rows, wneu 0) at (E, F);
// the others p[0], the packed record (B, f64 + i32 + u8 bytes), node-minor
// for kMinor ((f64 + i32 + u8) / 8, B words of 8 bytes).  The persistent
// layouts (kNatural, kPacked) run ``blocks`` blocks, or with 0 the SMs
// times the blocks an SM holds; the others take 0.
extern "C" int input_sum_launch(int layout, const void* const* p, long long B, int E, int F,
                                int wneu, int f64, int i32, int u8, long long request, int blocks,
                                double* out, void* stream) {
  const bool natural = layout == kNatural || layout == kPrologue;
  if (B <= 0 || p == nullptr || out == nullptr || blocks < 0 ||
      (blocks > 0 && !persistent(layout)))
    return (int)cudaErrorInvalidValue;
  if (natural ? (E <= 0 || F <= 0) : !regions_ok(f64, i32, u8)) return (int)cudaErrorInvalidValue;
  SumArgs a;
  for (int q = 0; q < kFields; ++q) a.p[q] = p[q];
  a.B = B;
  a.E = E;
  a.F = F;
  a.wneu = wneu;
  a.g = Regions{f64, i32, u8};
  a.sp = natural_spans(E, F, wneu, false);
  const bool aligned = layout == kNatural && natural_aligned(p, a.sp);
  if (aligned) a.sp = natural_spans(E, F, wneu, true);
  a.out = out;
  Plan pl = plan(kWhatSum, layout, a.g.stride(), E, F, wneu);
  if (layout == kNatural)
    pl.kernel = aligned ? (const void*)natural_kernel<true> : (const void*)natural_kernel<false>;
  size_t bytes = 0;
  cudaError_t err = prepare(pl, request, &bytes);
  if (err != cudaSuccess) return (int)err;
  long long grid = B;
  if (persistent(layout)) {
    err = persistent_grid(pl, bytes, blocks, B, pl.threads / 32, &grid);
    if (err != cudaSuccess) return (int)err;
  } else if (layout == kMulti) {
    grid = (B + kMultiNodes - 1) / kMultiNodes;
  } else if (layout == kMinor) {
    grid = (B + 31) / 32;
  }
  const SumKernel k = aligned ? natural_kernel<true> : sum_instance(layout);
  k<<<grid, pl.threads, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// overlap_probe on B packed records (B, f64 + i32 + u8 bytes): w (B, E)
// float32 and r (B,) float64 by ``body`` (0 trivial, 1 indep, 2 dep, 3
// compute) and ``schedule`` (0 block, 1 pipelined: ``blocks`` persistent
// blocks, or with 0 the SMs times the blocks an SM holds, at most B), the
// dummy work at ``iters`` rounds from ``seed``, at a dynamic shared memory
// request of ``request`` bytes.
extern "C" int overlap_probe_launch(int body, int schedule, const unsigned char* rec,
                                    long long B, int f64, int i32, int u8, int E, int iters,
                                    float seed, long long request, int blocks, float* w,
                                    double* r, void* stream) {
  if (B <= 0 || iters < 0 || blocks < 0 || !regions_ok(f64, i32, u8) || w == nullptr ||
      r == nullptr || (rec == nullptr && body != kCompute))
    return (int)cudaErrorInvalidValue;
  const Regions g{f64, i32, u8};
  const Plan pl = plan(kWhatOverlap, body * 2 + schedule, g.stride(), E, 0, 0);
  size_t bytes = 0;
  cudaError_t err = prepare(pl, request, &bytes);
  if (err != cudaSuccess) return (int)err;
  long long grid = B;
  if (schedule == kPipelined) {
    err = persistent_grid(pl, bytes, blocks, B, 1, &grid);
    if (err != cudaSuccess) return (int)err;
  }
  const OverlapArgs a{rec, B, g, E, iters, seed, w, r};
  const OverlapKernel k = overlap_instance(body, schedule, E);
  k<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
