// One-dimensional bulk copies (cp.async.bulk, the TMA engine) between device
// memory and a shared-memory tile, at any base address, completed on an
// mbarrier; shared by K5 (glass.cu) and K6p (elastic.cu).
//
// A tile of `len` floats sits at its source's (or destination's) 16-byte
// phase in shared memory: tile = buf + phase, phase = (address / 4) % 4, so
// both ends of the 16-byte-aligned body line up with device memory and one
// bulk copy moves the body; the at most three floats before it (the head)
// and after it (the tail) go by plain loads or stores from threads 1-6. A
// buffer therefore holds round4(len + 3) floats.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fav {

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Initialises a barrier that one arrival (with its transaction bytes)
// completes, and makes it visible to the async proxy; the caller
// synchronises the block before any thread uses it.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(shared_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Waits for the completion of phase `parity` of the barrier.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(shared_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ int phase16(const void* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// Starts the copy of `len` floats from src into buf + phase16(src), and
// returns that phase. Thread 0 arms the barrier with the body's bytes and
// issues the bulk copy; threads 1-6 copy the head and tail, which are the
// block's after its next barrier. The caller has synchronised the block
// since the buffer was last read.
__device__ __forceinline__ int bulk_load(float* buf, uint64_t* bar, const float* src, int len) {
  const int ph = phase16(src);
  const int head = min((4 - ph) & 3, len);
  const int body = ((len - head) >> 2) << 2;
  const int tail = len - head - body;
  float* tile = buf + ph;
  const int t = threadIdx.x;
  if (t == 0) {
    // the generic proxy's reads of this buffer come before the async proxy's writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(shared_addr(bar)),
                 "r"(body * 4)
                 : "memory");
    if (body > 0) {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
              shared_addr(tile + head)),
          "l"(src + head), "r"(body * 4), "r"(shared_addr(bar))
          : "memory");
    }
  } else if (t <= head) {
    tile[t - 1] = src[t - 1];
  } else if (t <= head + tail) {
    const int e = body + t - 1;  // head + body + (t - 1 - head)
    tile[e] = src[e];
  }
  return ph;
}

// Starts the write of `len` floats, held at buf + phase16(dst), to dst:
// every thread has fenced its writes to the buffer
// (fence.proxy.async.shared::cta) and the block has synchronised. Thread 0
// issues one bulk copy of the 16-byte-aligned body and commits it; threads
// 1-6 store the head and tail.
__device__ __forceinline__ void bulk_store(const float* buf, float* dst, int len) {
  const int ph = phase16(dst);
  const int head = min((4 - ph) & 3, len);
  const int body = ((len - head) >> 2) << 2;
  const int tail = len - head - body;
  const float* tile = buf + ph;
  const int t = threadIdx.x;
  if (t == 0) {
    if (body > 0) {
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst + head),
                   "r"(shared_addr(tile + head)), "r"(body * 4)
                   : "memory");
    }
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  } else if (t <= head) {
    dst[t - 1] = tile[t - 1];
  } else if (t <= head + tail) {
    const int e = body + t - 1;
    dst[e] = tile[e];
  }
}

// Makes this thread's writes to a shared tile visible to a later bulk store.
__device__ __forceinline__ void fence_shared_for_bulk() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Thread 0: waits until this block's committed bulk stores have completed.
__device__ __forceinline__ void bulk_store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Thread 0: waits until this block's committed bulk stores have read their
// shared tiles, so the tiles may be written again.
__device__ __forceinline__ void bulk_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

}  // namespace fav
