// The pieces of the CUDA runtime that the port's kernels use, for running
// a kernel source on the CPU in tests (tests/utils/cuda_emu).  Each warp
// is an OS thread and each of its 32 lanes a fiber (ucontext) on it:
// __syncwarp and the shuffles and votes are a switch between the warp's
// fibers, which run in turn until every lane has reached the call;
// __syncthreads is that, then a barrier of the block's warps.  Blocks run
// one after another, so a block's static __shared__ arrays can be
// function statics.  It checks the kernels' logic (indices, buffer reuse,
// barriers), not their speed; rsqrtf is exact here and approximate on a
// card.  A warp-wide call must be reached by all 32 lanes, as on a card
// with a full mask.
#pragma once
#include <ucontext.h>

#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __align__(x) alignas(x)

struct dim3 { unsigned x = 0, y = 0, z = 0; };
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct double2 { double x, y; };
struct int2 { int x, y; };
struct int4 { int x, y, z, w; };
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaDevAttrMultiProcessorCount = 16, cudaDevAttrMaxSharedMemoryPerBlockOptin = 97 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

constexpr int kEmuSmemOptin = 232448;   // an H100's shared memory a block
constexpr int kEmuSms = 132;            // and its SMs
constexpr size_t kEmuStack = 256 * 1024;  // a lane's fiber stack

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline unsigned char* emu_smem = nullptr;
inline std::barrier<>* emu_block_barrier = nullptr;

// One warp: its scheduler context, its lanes' fibers and where each is.
struct EmuWarp {
  enum State { kReady, kAtWarp, kAtBlock, kDone };
  ucontext_t sched;
  ucontext_t lane[32];
  State state[32];
  double slot[32];
  double slots[8][32];   // emu_gather's values, up to 8 a lane
  std::function<void()> body;
  int warp = 0, cur = 0;
};
inline thread_local EmuWarp* emu_warp = nullptr;
inline thread_local int emu_lane = 0;

// The running lane waits at a warp-wide (kAtWarp) or block-wide (kAtBlock)
// point until its warp's scheduler resumes it.
inline void emu_wait(EmuWarp::State at) {
  EmuWarp* w = emu_warp;
  w->state[w->cur] = at;
  swapcontext(&w->lane[w->cur], &w->sched);
}

inline void __syncthreads() { emu_wait(EmuWarp::kAtBlock); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_wait(EmuWarp::kAtWarp); }

template <typename T>
inline T emu_exchange(T v, int from) {
  emu_warp->slot[emu_lane] = (double)v;
  __syncwarp();
  const T r = from < 32 ? (T)emu_warp->slot[from] : v;
  __syncwarp();
  return r;
}
template <typename T>
inline T __shfl_down_sync(unsigned, T v, int off) { return emu_exchange(v, emu_lane + off); }
template <typename T>
inline T __shfl_xor_sync(unsigned, T v, int mask) { return emu_exchange(v, emu_lane ^ mask); }
template <typename T>
inline T __shfl_sync(unsigned, T v, int src) { return emu_exchange(v, src % 32); }
inline bool __any_sync(unsigned, bool pred) {
  emu_warp->slot[emu_lane] = pred ? 1.0 : 0.0;
  __syncwarp();
  bool any = false;
  for (int l = 0; l < 32; ++l) any = any || emu_warp->slot[l] != 0.0;
  __syncwarp();
  return any;
}

inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }

// the read-only load path, and float64 operations rounded once (an x86-64
// build without -mfma has no FMA to contract them into)
template <typename T>
inline T __ldg(const T* p) { return *p; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __ddiv_rn(double a, double b) { return a / b; }

// mma.sync.aligned.m8n8k4.row.col.f64 (D = A B + D on the FP64 tensor
// cores), with the card's fragments: lane 4 g + t holds a = A[g][t],
// b = B[t][g], c0 = D[g][2t] and c1 = D[g][2t + 1].  The four products
// of an entry are summed in order, each with one rounding.
#define CUDA_EMU 1
inline void emu_mma_m8n8k4_f64(double& c0, double& c1, double a, double b) {
  double av[32], bv[32];
  emu_warp->slot[emu_lane] = a;
  __syncwarp();
  for (int l = 0; l < 32; ++l) av[l] = emu_warp->slot[l];
  __syncwarp();
  emu_warp->slot[emu_lane] = b;
  __syncwarp();
  for (int l = 0; l < 32; ++l) bv[l] = emu_warp->slot[l];
  __syncwarp();
  const int g = emu_lane >> 2, t = emu_lane & 3;
  for (int k = 0; k < 4; ++k) {
    c0 = std::fma(av[4 * g + k], bv[4 * (2 * t) + k], c0);
    c1 = std::fma(av[4 * g + k], bv[4 * (2 * t + 1) + k], c1);
  }
}

inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}
inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, sizeof u);
  return u;
}
inline double __longlong_as_double(long long v) {
  double d;
  std::memcpy(&d, &v, sizeof d);
  return d;
}

// cvt.rna.tf32.f32: to nearest with ties away from zero, keeping 10
// fraction bits (the magnitude plus half the 13 dropped bits' unit, then
// truncated); infinities and NaNs pass
inline uint32_t emu_cvt_rna_tf32(float x) {
  const uint32_t u = __float_as_uint(x);
  if ((u & 0x7f800000u) == 0x7f800000u) return u;
  return (u + 0x1000u) & 0xffffe000u;
}
// one float to bf16, to nearest with ties to even (cvt.rn.bf16.f32)
inline uint32_t emu_bf16_rn(float x) {
  const uint32_t u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (u >> 16) | 0x40u;   // a quiet NaN
  return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
}
// cvt.rn.bf16x2.f32 d, hi, lo: hi in d's upper half, lo in its lower
inline uint32_t emu_cvt_rn_bf16x2(float hi, float lo) {
  return emu_bf16_rn(hi) << 16 | emu_bf16_rn(lo);
}

// Every lane's ``count`` values v into all[q][lane], one warp-wide step.
inline void emu_gather(const double* v, int count, double (*all)[32]) {
  for (int q = 0; q < count; ++q) emu_warp->slots[q][emu_lane] = v[q];
  __syncwarp();
  for (int q = 0; q < count; ++q)
    for (int l = 0; l < 32; ++l) all[q][l] = emu_warp->slots[q][l];
  __syncwarp();
}

// The m16n8k* products, from the PTX ISA's fragment tables: lane 4 g + t
// holds D's entries c = (D[g][2t], D[g][2t + 1], D[g + 8][2t], D[g +
// 8][2t + 1]); A (16 x K) and B (K x 8) are gathered from every lane's
// registers, then each entry adds the K products in order, each rounded
// once (float32 sums for TF32 and bf16, whose products are exact in
// float32; float64 for the FP64 shape).
template <class T>
inline void emu_mma_m16n8(T (&c)[4], const T (*A)[16], const T (*B)[8], int K) {
  const int g = emu_lane >> 2, t = emu_lane & 3;
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e >> 1), col = 2 * t + (e & 1);
    T s = c[e];
    for (int k = 0; k < K; ++k) s = std::fma(A[row][k], B[k][col], s);
    c[e] = s;
  }
}

// mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 (sm_90): the fragments
// of m16n8k8.tf32, in float64.
inline void emu_mma_m16n8k8_f64(double (&c)[4], const double (&a)[4], const double (&b)[2]) {
  const double v[6] = {a[0], a[1], a[2], a[3], b[0], b[1]};
  double all[6][32];
  emu_gather(v, 6, all);
  double A[16][16], B[16][8];
  for (int l = 0; l < 32; ++l) {
    const int g = l >> 2, t = l & 3;
    A[g][t] = all[0][l];
    A[g + 8][t] = all[1][l];
    A[g][t + 4] = all[2][l];
    A[g + 8][t + 4] = all[3][l];
    B[t][g] = all[4][l];
    B[t + 4][g] = all[5][l];
  }
  emu_mma_m16n8(c, A, B, 8);
}

// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32: lane 4 g + t holds
// a = (A[g][t], A[g + 8][t], A[g][t + 4], A[g + 8][t + 4]) and b =
// (B[t][g], B[t + 4][g]); the tensor cores read a TF32 operand's top 19
// bits.
inline void emu_mma_m16n8k8_tf32(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  const double v[6] = {(double)a[0], (double)a[1], (double)a[2], (double)a[3], (double)b[0],
                       (double)b[1]};
  double all[6][32];
  emu_gather(v, 6, all);
  auto tf32 = [](double bits) { return __uint_as_float((uint32_t)bits & 0xffffe000u); };
  float A[16][16], B[16][8];
  for (int l = 0; l < 32; ++l) {
    const int g = l >> 2, t = l & 3;
    A[g][t] = tf32(all[0][l]);
    A[g + 8][t] = tf32(all[1][l]);
    A[g][t + 4] = tf32(all[2][l]);
    A[g + 8][t + 4] = tf32(all[3][l]);
    B[t][g] = tf32(all[4][l]);
    B[t + 4][g] = tf32(all[5][l]);
  }
  emu_mma_m16n8(c, A, B, 8);
}

// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32: two bf16 a
// register, the lower index in the low half; lane 4 g + t holds a =
// ((A[g][2t], A[g][2t + 1]), (A[g + 8][2t], A[g + 8][2t + 1]), (A[g][2t +
// 8], A[g][2t + 9]), (A[g + 8][2t + 8], A[g + 8][2t + 9])) and b =
// ((B[2t][g], B[2t + 1][g]), (B[2t + 8][g], B[2t + 9][g])).
inline void emu_mma_m16n8k16_bf16(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  const double v[6] = {(double)a[0], (double)a[1], (double)a[2], (double)a[3], (double)b[0],
                       (double)b[1]};
  double all[6][32];
  emu_gather(v, 6, all);
  auto lo = [](double r) { return __uint_as_float(((uint32_t)r & 0xffffu) << 16); };
  auto hi = [](double r) { return __uint_as_float((uint32_t)r & 0xffff0000u); };
  float A[16][16], B[16][8];
  for (int l = 0; l < 32; ++l) {
    const int g = l >> 2, t = l & 3;
    for (int q = 0; q < 4; ++q) {   // a's register q: row g + 8 (q & 1), columns 2t + 8 (q >> 1)
      const int row = g + 8 * (q & 1), col = 2 * t + 8 * (q >> 1);
      A[row][col] = lo(all[q][l]);
      A[row][col + 1] = hi(all[q][l]);
    }
    for (int q = 0; q < 2; ++q) {   // b's register q: rows 2t + 8q
      B[2 * t + 8 * q][g] = lo(all[4 + q][l]);
      B[2 * t + 8 * q + 1][g] = hi(all[4 + q][l]);
    }
  }
  emu_mma_m16n8(c, A, B, 16);
}

// <cuda_pipeline.h>'s asynchronous copies, as plain synchronous copies:
// a copy is complete when the call returns, so a missing wait does not
// show here
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t bytes, size_t = 0) {
  std::memcpy(dst, src, bytes);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}

// The mbarrier (a 64-bit word of shared memory) and cp.async.bulk: the
// word holds the current phase's parity (bit 63), the arrivals it was
// initialised with (bits 52-62), the arrivals still pending (bits 32-51)
// and the transaction bytes still pending (bits 0-31, signed); a phase
// completes when both pending counts reach 0, and the next one starts
// with every arrival pending.  Updates are atomic: a block's warps are OS
// threads.  A bulk copy is made at issue and completes its bytes at once.
inline uint64_t emu_mbarrier_word(unsigned phase, unsigned count, unsigned pending, int32_t tx) {
  return (uint64_t)phase << 63 | (uint64_t)count << 52 | (uint64_t)pending << 32 | (uint32_t)tx;
}
inline void emu_mbarrier_init(uint64_t* bar, unsigned count) {
  __atomic_store_n(bar, emu_mbarrier_word(0, count, count, 0), __ATOMIC_SEQ_CST);
}
// ``arrivals`` arrive and ``tx`` transaction bytes are added (expected,
// > 0) or completed (< 0)
inline void emu_mbarrier_update(uint64_t* bar, unsigned arrivals, int32_t tx) {
  uint64_t old = __atomic_load_n(bar, __ATOMIC_SEQ_CST), next;
  do {
    unsigned phase = (unsigned)(old >> 63), count = (unsigned)(old >> 52) & 0x7ffu;
    unsigned pending = (unsigned)(old >> 32) & 0xfffffu;
    const int32_t left = (int32_t)(uint32_t)old + tx;
    if (arrivals > pending) {
      std::fprintf(stderr, "cuda_emu: more arrivals than an mbarrier phase expects\n");
      std::abort();
    }
    pending -= arrivals;
    if (pending == 0 && left == 0) {
      phase ^= 1u;
      pending = count;
    }
    next = emu_mbarrier_word(phase, count, pending, left);
  } while (!__atomic_compare_exchange_n(bar, &old, next, false, __ATOMIC_SEQ_CST,
                                        __ATOMIC_SEQ_CST));
}
inline void emu_mbarrier_arrive(uint64_t* bar) { emu_mbarrier_update(bar, 1, 0); }
inline void emu_mbarrier_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  emu_mbarrier_update(bar, 1, (int32_t)bytes);
}
// mbarrier.try_wait.parity: has the phase of this parity completed?  Not
// yet: the warp's OS thread yields, so a wait for a copy that another
// warp's thread has still to issue (in the same stretch between block
// barriers) lets that thread run.
inline bool emu_mbarrier_try_wait_parity(uint64_t* bar, unsigned parity) {
  const bool done = (unsigned)(__atomic_load_n(bar, __ATOMIC_SEQ_CST) >> 63) != (parity & 1u);
  if (!done) std::this_thread::yield();
  return done;
}
// cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes
inline void emu_cp_async_bulk(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  std::memcpy(dst, src, bytes);
  emu_mbarrier_update(bar, 0, -(int32_t)bytes);
}
// cp.async.bulk.global.shared::cta.bulk_group: the store is made at issue,
// so its bulk group's commit and waits have nothing left to wait for.
// Both ends 16-byte aligned and the bytes a multiple of 16, as the card
// requires; anything else aborts.
inline void emu_cp_async_bulk_store(void* dst, const void* src, unsigned bytes) {
  if (reinterpret_cast<uintptr_t>(dst) % 16 || reinterpret_cast<uintptr_t>(src) % 16 ||
      bytes % 16) {
    std::fprintf(stderr, "cuda_emu: a bulk store of %u bytes is not 16-byte aligned\n", bytes);
    std::abort();
  }
  std::memcpy(dst, src, bytes);
}
// bar.sync / bar.arrive on named barrier ``id`` (1-15) of ``count``
// threads, a warp-wide call: the warp's lanes meet, then lane 0 adds the
// warp's 32 threads to the barrier's count; the arrival that completes it
// resets the count and starts a new generation; a sync waits (spinning,
// as its warp's OS thread) for the generation it arrived in to end.  The
// barrier's counts live across blocks: a completed phase leaves 0.
struct EmuNamedBarrier {
  std::atomic<int> arrived{0};
  std::atomic<unsigned> generation{0};
};
inline EmuNamedBarrier emu_named[16];
inline void emu_named_barrier(int id, int count, bool wait) {
  __syncwarp();
  if (emu_lane == 0) {
    EmuNamedBarrier& b = emu_named[id];
    const unsigned gen = b.generation.load();
    if (b.arrived.fetch_add(32) + 32 == count) {
      b.arrived.store(0);
      b.generation.fetch_add(1);
    } else if (wait) {
      while (b.generation.load() == gen) std::this_thread::yield();
    }
  }
  __syncwarp();
}
inline void __trap() {
  std::fprintf(stderr, "cuda_emu: __trap\n");
  std::abort();
}
// atomicAdd on device memory: float, and sm_90's float4 (a float at a
// time), each word by compare and swap (a block's warps are OS threads);
// returns the old value
inline float atomicAdd(float* a, float v) {
  uint32_t* const w = reinterpret_cast<uint32_t*>(a);
  uint32_t old = __atomic_load_n(w, __ATOMIC_SEQ_CST), next;
  float f;
  do {
    std::memcpy(&f, &old, 4);
    f += v;
    std::memcpy(&next, &f, 4);
  } while (!__atomic_compare_exchange_n(w, &old, next, false, __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST));
  std::memcpy(&f, &old, 4);
  return f;
}
inline float4 atomicAdd(float4* a, float4 v) {
  float* const f = reinterpret_cast<float*>(a);
  return {atomicAdd(f, v.x), atomicAdd(f + 1, v.y), atomicAdd(f + 2, v.z), atomicAdd(f + 3, v.w)};
}
using std::fmaf; using std::fmaxf; using std::sqrt; using std::fmax;
using std::min; using std::max;

inline int cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline int cudaDeviceGetAttribute(int* v, int attr, int) {
  *v = attr == cudaDevAttrMultiProcessorCount ? kEmuSms : kEmuSmemOptin;
  return cudaSuccess;
}
template <typename K> inline int cudaFuncSetAttribute(K, int, int) { return cudaSuccess; }
inline int cudaGetLastError() { return cudaSuccess; }
// registers and local memory are not modelled: both read 0
struct cudaFuncAttributes { int numRegs = 0; size_t localSizeBytes = 0; };
template <typename K> inline int cudaFuncGetAttributes(cudaFuncAttributes* a, K) {
  *a = cudaFuncAttributes();
  return cudaSuccess;
}
// an H100 SM: 228 KB of shared memory (1 KB of it reserved a block),
// 2048 threads
template <typename K>
inline int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, K, int threads,
                                                         size_t smem) {
  *blocks = std::min((int)(233472 / (smem + 1024)), 2048 / threads);
  return cudaSuccess;
}

inline void emu_lane_main() {
  emu_warp->body();
  emu_warp->state[emu_warp->cur] = EmuWarp::kDone;   // uc_link: back to sched
}

// Run one warp of the block on this OS thread: every ready lane until it
// waits or ends, then release the lanes once all wait at the same point
// (a block-wide point after the block's other warps reach it too).
inline void emu_run_warp(EmuWarp* w, char* stacks) {
  emu_warp = w;
  for (int l = 0; l < 32; ++l) {
    getcontext(&w->lane[l]);
    w->lane[l].uc_stack.ss_sp = stacks + (size_t)l * kEmuStack;
    w->lane[l].uc_stack.ss_size = kEmuStack;
    w->lane[l].uc_link = &w->sched;
    makecontext(&w->lane[l], emu_lane_main, 0);
    w->state[l] = EmuWarp::kReady;
  }
  for (;;) {
    for (int l = 0; l < 32; ++l) {
      if (w->state[l] != EmuWarp::kReady) continue;
      w->cur = l;
      emu_lane = l;
      threadIdx.x = w->warp * 32 + l;
      swapcontext(&w->sched, &w->lane[l]);
    }
    int done = 0, at_warp = 0, at_block = 0;
    for (int l = 0; l < 32; ++l) {
      done += w->state[l] == EmuWarp::kDone;
      at_warp += w->state[l] == EmuWarp::kAtWarp;
      at_block += w->state[l] == EmuWarp::kAtBlock;
    }
    if (done == 32) {
      emu_block_barrier->arrive_and_drop();
      return;
    }
    if (at_warp + at_block != 32 || (at_warp && at_block)) {
      std::fprintf(stderr, "cuda_emu: warp %d diverged at a warp-wide call\n", w->warp);
      std::abort();
    }
    if (at_block) emu_block_barrier->arrive_and_wait();
    for (int l = 0; l < 32; ++l) w->state[l] = EmuWarp::kReady;
  }
}

// kernel<<<blocks, threads, smem, stream>>>(args...), rewritten as a call;
// shared memory starts as garbage, as on a card
template <typename K, typename... Args>
void emu_launch(K kernel, long long blocks, int threads, size_t smem, void*, Args... args) {
  blockDim.x = threads;
  gridDim.x = (unsigned)blocks;
  std::vector<unsigned char> buf(smem + 16, 0xCD);
  const size_t mis = reinterpret_cast<size_t>(buf.data()) % 16;
  emu_smem = buf.data() + (mis ? 16 - mis : 0);
  const int warps = threads / 32;
  std::unique_ptr<char[]> stacks(new char[(size_t)warps * 32 * kEmuStack]);
  for (long long b = 0; b < blocks; ++b) {
    std::barrier<> bar(warps);
    emu_block_barrier = &bar;
    std::vector<std::unique_ptr<EmuWarp>> ws;
    std::vector<std::thread> ts;
    for (int w = 0; w < warps; ++w) {
      ws.emplace_back(new EmuWarp());
      ws.back()->warp = w;
      ws.back()->body = [&] { kernel(args...); };
      char* st = stacks.get() + (size_t)w * 32 * kEmuStack;
      EmuWarp* wp = ws.back().get();
      ts.emplace_back([wp, st, b] {
        blockIdx.x = (unsigned)b;
        emu_run_warp(wp, st);
      });
    }
    for (auto& th : ts) th.join();
  }
}
