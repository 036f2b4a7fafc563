// The pieces of the CUDA runtime that the port's kernels use, for running
// a kernel source on the CPU in tests (tests/utils/cuda_emu): each CUDA
// thread is an OS thread, __syncthreads a barrier of the block's threads,
// warp shuffles an exchange through one slot a lane.  Blocks run one after
// another, so a block's static __shared__ arrays can be function statics.
// It checks the kernels' logic (indices, buffer reuse, barriers), not
// their speed; rsqrtf is exact here and approximate on a card.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
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
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaDevAttrMaxSharedMemoryPerBlockOptin = 97 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

constexpr int kEmuSmemOptin = 232448;   // an H100's shared memory a block

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline unsigned char* emu_smem = nullptr;
inline std::barrier<>* emu_block_barrier = nullptr;
struct EmuWarp { std::barrier<> bar{32}; double slot[32]; };
inline thread_local EmuWarp* emu_warp = nullptr;
inline thread_local int emu_lane = 0;

inline void __syncthreads() { emu_block_barrier->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_warp->bar.arrive_and_wait(); }

template <typename T>
inline T emu_exchange(T v, int from) {
  emu_warp->slot[emu_lane] = (double)v;
  emu_warp->bar.arrive_and_wait();
  const T r = from < 32 ? (T)emu_warp->slot[from] : v;
  emu_warp->bar.arrive_and_wait();
  return r;
}
template <typename T>
inline T __shfl_down_sync(unsigned, T v, int off) { return emu_exchange(v, emu_lane + off); }
template <typename T>
inline T __shfl_xor_sync(unsigned, T v, int mask) { return emu_exchange(v, emu_lane ^ mask); }

inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
using std::fmaf; using std::fmaxf; using std::sqrt; using std::fmax;
using std::min; using std::max;

inline int cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline int cudaDeviceGetAttribute(int* v, int, int) { *v = kEmuSmemOptin; return cudaSuccess; }
template <typename K> inline int cudaFuncSetAttribute(K, int, int) { return cudaSuccess; }
inline int cudaGetLastError() { return cudaSuccess; }
// an H100 SM: 228 KB of shared memory (1 KB of it reserved a block),
// 2048 threads
template <typename K>
inline int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, K, int threads,
                                                         size_t smem) {
  *blocks = std::min((int)(233472 / (smem + 1024)), 2048 / threads);
  return cudaSuccess;
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
  for (long long b = 0; b < blocks; ++b) {
    std::barrier<> bar(threads);
    emu_block_barrier = &bar;
    std::vector<std::unique_ptr<EmuWarp>> warps;
    for (int w = 0; w < threads / 32; ++w) warps.emplace_back(new EmuWarp());
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, t] {
        threadIdx.x = t;
        blockIdx.x = (unsigned)b;
        emu_warp = warps[t / 32].get();
        emu_lane = t % 32;
        kernel(args...);
      });
    for (auto& th : ts) th.join();
  }
}
