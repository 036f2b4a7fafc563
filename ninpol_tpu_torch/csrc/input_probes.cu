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
 *   bodies reduce their whole block.  Bound by bytes.  Instances (layout):
 *     kNatural  the thirteen tensors as ops/gls_solve.py::gls_solve takes
 *               them, one block of 256 threads a node, each tensor read an
 *               element a thread as kernel 1's prologue reads it
 *               (gls_solve.cu:318-331: 8-byte doubles, 4-byte ints, 1-byte
 *               masks), with no incidence search (:60, the production
 *               layout);
 *     kPacked   the packed record, one block a node, 8-byte loads (:72);
 *     kWide     the same, 16-byte loads (:85, wider rows);
 *     kBulk     the same, one cp.async.bulk (the TMA's 1-D copy) of the
 *               record into shared memory against an mbarrier, summed
 *               there (:85);
 *     kMulti    8 nodes a block, a warp a node, 8-byte loads (:105,
 *               several tiles a step);
 *     kMinor    the record node-minor, (stride / 8, B) 8-byte words, one
 *               thread a node: a warp reads 32 nodes' word k in one
 *               256-byte span (:105, the TPU's own lane layout).
 *   A dynamic shared memory request (``smem_bytes``, unused but for
 *   kBulk's record) sets the blocks an SM, so an instance can run at
 *   kernel 1's occupancy.
 *
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
constexpr int kMinorThreads = 128;     // kMinor: one thread a node
constexpr int kMultiNodes = kWarps;    // kMulti: a warp a node
constexpr int kSlots = 128;            // the dummy work's columns
constexpr int kMaxE = 2 * 16;          // its rows: two halves of 128 threads, 16 rows each
constexpr int kFields = 13;

enum { kNatural = 0, kPacked = 1, kWide = 2, kBulk = 3, kMulti = 4, kMinor = 5 };
enum { kTrivial = 0, kIndep = 1, kDep = 2, kCompute = 3 };
enum { kBlock = 0, kPipelined = 1 };
enum { kWhatSum = 0, kWhatOverlap = 1 };

// The record's three regions, bytes (each a multiple of 16).
struct Regions {
  int f64, i32, u8;
  __host__ __device__ int stride() const { return f64 + i32 + u8; }
};

struct SumArgs {
  const void* p[kFields];   // kNatural: dk, l1, l2, t1m, tt, lb, nm, pair, ks, cv, fv, isneu,
                            // valid; else p[0], the record
  long long B;
  int E, F, wneu;
  Regions g;
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

// ---- input_sum

__global__ void __launch_bounds__(kThreads) natural_kernel(SumArgs a) {
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

// kPacked (8-byte loads) and kWide (16)
template <int kBytes>
__global__ void __launch_bounds__(kThreads) packed_kernel(SumArgs a) {
  __shared__ double sd[kWarps];
  __shared__ long long sn[kWarps];
  const long long b = blockIdx.x;
  const unsigned char* rec = static_cast<const unsigned char*>(a.p[0]) + b * a.g.stride();
  double d = 0.0;
  long long n = 0;
  sum_record<kBytes>(rec, a.g, threadIdx.x, kThreads, d, n);
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

// node-minor: word k of node b at x[k B + b], 8 bytes
__global__ void __launch_bounds__(kMinorThreads) minor_kernel(SumArgs a) {
  const long long B = a.B, b = (long long)blockIdx.x * kMinorThreads + threadIdx.x;
  if (b >= B) return;
  const int wf = a.g.f64 / 8, wi = a.g.i32 / 8, wb = a.g.u8 / 8;
  const double* xd = static_cast<const double*>(a.p[0]) + b;
  const int2* xi = static_cast<const int2*>(a.p[0]) + (long long)wf * B + b;
  const uint2* xb = static_cast<const uint2*>(a.p[0]) + (long long)(wf + wi) * B + b;
  double d = 0.0;
  long long n = 0;
#pragma unroll 8
  for (int k = 0; k < wf; ++k) d += xd[k * B];
#pragma unroll 8
  for (int k = 0; k < wi; ++k) {
    const int2 v = xi[k * B];
    n += (long long)v.x + v.y;
  }
  for (int k = 0; k < wb; ++k) {
    const uint2 v = xb[k * B];
    n += byte_sum(v.x) + byte_sum(v.y);
  }
  a.out[b] = d + (double)n;
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
    case kNatural: return natural_kernel;
    case kPacked: return packed_kernel<8>;
    case kWide: return packed_kernel<16>;
    case kBulk: return bulk_kernel;
    case kMulti: return multi_kernel;
    case kMinor: return minor_kernel;
    default: return nullptr;
  }
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
// body * 2 + schedule) on records of ``stride`` bytes, E rows of dummy work.
struct Plan {
  const void* kernel = nullptr;
  int threads = kThreads;
  long long need = 0;
};

Plan plan(int what, int variant, int stride, int E) {
  Plan p;
  if (what == kWhatSum) {
    p.kernel = (const void*)sum_instance(variant);
    if (variant == kMinor) p.threads = kMinorThreads;
    if (variant == kBulk) p.need = stride;
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

bool regions_ok(int f64, int i32, int u8) {
  return f64 >= 0 && i32 >= 0 && u8 >= 0 && f64 % 16 == 0 && i32 % 16 == 0 && u8 % 16 == 0 &&
         f64 + i32 + u8 > 0;
}

}  // namespace

// A launch's dynamic shared memory, threads, the blocks an SM holds, and
// its registers and local memory bytes (spills) a thread: ``what`` 0
// input_sum (variant: layout 0 natural, 1 packed, 2 wide, 3 bulk, 4 multi,
// 5 minor), 1 overlap_probe (variant: body 0 trivial, 1 indep, 2 dep, 3
// compute, times 2, plus schedule 0 block, 1 pipelined) on records of
// ``stride`` bytes with E rows of dummy work, at a dynamic shared memory
// request of ``request`` bytes; returns the cudaError_t.
extern "C" int input_probes_occupancy(int what, int variant, int stride, int E,
                                      long long request, long long* smem_bytes, int* threads,
                                      int* blocks_per_sm, int* regs, long long* local_bytes) {
  const Plan p = plan(what, variant, stride, E);
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

// out[b] = the sum of node b's record, b < B: ``layout`` kNatural reads
// p[0..12] (dk, l1, l2, t1m, tt, lb, nm, pair, ks, cv, fv, isneu, valid;
// lb and nm null without Neumann rows, wneu 0) at (E, F); the others p[0],
// the packed record (B, f64 + i32 + u8 bytes), node-minor for kMinor
// ((f64 + i32 + u8) / 8, B words of 8 bytes).
extern "C" int input_sum_launch(int layout, const void* const* p, long long B, int E, int F,
                                int wneu, int f64, int i32, int u8, long long request,
                                double* out, void* stream) {
  if (B <= 0 || p == nullptr || out == nullptr) return (int)cudaErrorInvalidValue;
  if (layout == kNatural ? (E <= 0 || F <= 0) : !regions_ok(f64, i32, u8))
    return (int)cudaErrorInvalidValue;
  SumArgs a;
  for (int q = 0; q < kFields; ++q) a.p[q] = p[q];
  a.B = B;
  a.E = E;
  a.F = F;
  a.wneu = wneu;
  a.g = Regions{f64, i32, u8};
  a.out = out;
  const Plan pl = plan(kWhatSum, layout, a.g.stride(), 0);
  size_t bytes = 0;
  cudaError_t err = prepare(pl, request, &bytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = layout == kMulti   ? (B + kMultiNodes - 1) / kMultiNodes
                           : layout == kMinor ? (B + kMinorThreads - 1) / kMinorThreads
                                              : B;
  const SumKernel k = sum_instance(layout);
  k<<<blocks, pl.threads, bytes, (cudaStream_t)stream>>>(a);
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
  const Plan pl = plan(kWhatOverlap, body * 2 + schedule, g.stride(), E);
  size_t bytes = 0;
  cudaError_t err = prepare(pl, request, &bytes);
  if (err != cudaSuccess) return (int)err;
  long long grid = B;
  if (schedule == kPipelined) {
    grid = blocks;
    if (grid == 0) {
      int dev = 0, sms = 0, per_sm = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pl.kernel, kThreads, bytes);
      if (err != cudaSuccess) return (int)err;
      grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
    }
    if (grid > B) grid = B;
  }
  const OverlapArgs a{rec, B, g, E, iters, seed, w, r};
  const OverlapKernel k = overlap_instance(body, schedule, E);
  k<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
