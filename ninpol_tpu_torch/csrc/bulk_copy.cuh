/*
 * Hopper's bulk copies between device memory and shared memory
 * (cp.async.bulk, the TMA's 1-D form) and the mbarrier a load completes
 * on, shared by the probe libraries: input_probes.cu, factor_probes.cu and
 * mxu_probes.cu.  Both ends of a copy are 16-byte aligned and its bytes a
 * multiple of 16.
 *
 * A load: one thread expects the bytes on an mbarrier and issues the copy
 * (bulk_load; or mbar_expect of several copies' bytes, then each by
 * bulk_copy_in); every thread that reads the destination waits for the
 * barrier's phase.
 * A store: every thread that wrote the source fences (fence_async_shared),
 * a block barrier follows, then one thread issues the store and commits
 * its bulk group; that thread waits for the group's reads (bulk_wait_read)
 * before the source is written again, and for the group itself
 * (bulk_wait) before the block exits.
 *
 * A node's floats that start at any 4-byte boundary arrive by one load
 * of the 16-byte span that covers them (load_span): up to 12 bytes either
 * side of the node are copied too, and the node starts span_head floats
 * into the destination.
 *
 * Every wait on an mbarrier spins a bounded number of times and then
 * traps, so a wrong phase parity ends the launch with an error instead of
 * hanging the card.  Under CUDA_EMU (tests/utils/cuda_emu) each call is the
 * emulator's model.
 */
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace bulk_copy {

constexpr unsigned kSpinLimit = 1u << 22;   // tries of an mbarrier wait before __trap

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
#ifdef CUDA_EMU
  return 0;
#else
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
#endif
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
#ifdef CUDA_EMU
  emu_mbarrier_init(bar, count);
#else
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
#endif
}

// Floats of a span that covers ``count`` floats from any 4-byte boundary:
// whole 16-byte words, one more than ``count`` needs at most.
__host__ __device__ inline long long span_floats(long long count) { return (count + 3) / 4 * 4 + 4; }

// This thread's accesses of shared memory ordered before bulk copies
// (the async proxy) that it issues later, or, behind a block barrier,
// that another thread issues: a load's destination read before, a
// store's source written before.
__device__ __forceinline__ void fence_async_shared() {
#ifndef CUDA_EMU
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
#endif
}

// One thread: the one arrival of ``bar``'s phase, expecting ``bytes`` from
// the bulk copies (bulk_copy_in) that complete on it.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
#ifdef CUDA_EMU
  emu_mbarrier_arrive_expect_tx(bar, bytes);
#else
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
#endif
}

// One thread: copy ``bytes`` from device memory to shared memory,
// completing on ``bar`` (no arrival: mbar_expect counts the bytes).
__device__ __forceinline__ void bulk_copy_in(void* dst, const void* src, unsigned bytes,
                                             uint64_t* bar) {
#ifdef CUDA_EMU
  emu_cp_async_bulk(dst, src, bytes, bar);
#else
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
#endif
}

// One thread: expect ``bytes`` on ``bar`` (its one arrival) and copy them
// from device memory to shared memory, completing on ``bar``.  The fence
// orders the block's earlier accesses of dst (generic proxy) before the
// copy's writes (async proxy).
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  fence_async_shared();
  mbar_expect(bar, bytes);
  bulk_copy_in(dst, src, bytes, bar);
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, unsigned parity) {
#ifdef CUDA_EMU
  return emu_mbarrier_try_wait_parity(bar, parity);
#else
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
#endif
}

// Wait for the phase of ``bar`` with this parity to complete; trap after
// kSpinLimit tries.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  for (unsigned tries = 0; !mbar_try_wait(bar, parity); ++tries)
    if (tries == kSpinLimit) __trap();
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

// One thread: copy ``bytes`` from shared memory to device memory, in the
// current bulk group (bulk_commit closes it).
__device__ __forceinline__ void bulk_store(void* dst, const void* src, unsigned bytes) {
#ifdef CUDA_EMU
  emu_cp_async_bulk_store(dst, src, bytes);
#else
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
#endif
}

__device__ __forceinline__ void bulk_commit() {
#ifndef CUDA_EMU
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
#endif
}

// The issuing thread's committed bulk groups have read their sources.
__device__ __forceinline__ void bulk_wait_read() {
#ifndef CUDA_EMU
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
#endif
}

// The issuing thread's committed bulk groups are complete.
__device__ __forceinline__ void bulk_wait() {
#ifndef CUDA_EMU
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
#endif
}

}  // namespace bulk_copy
