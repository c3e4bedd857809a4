// The card's resident blocks of one kernel: the grid of a persistent
// launch, queried once per device and kept in the caller's cache.
#pragma once

#include <atomic>

#include <cuda_runtime.h>

// Blocks of `kernel` (`threads` a block, `smem` bytes of dynamic shared
// memory) that fit on the whole of `device` at once, at most `max_per_sm`
// on each SM (0: no cap).  The first call for a device raises the kernel's
// dynamic shared memory limit to `smem` and queries the card; later calls
// read `cache` (one per kernel, indexed by device).  Returns 0 if the
// limit is refused (cudaGetLastError says why).
//
// Host threads may launch the same kernel at once (a cluster's thread
// hosts share one card), so each entry is atomic: two first calls may both
// query, and both store the same value; no thread reads a torn one.
template <typename Kernel>
int resident_blocks(Kernel kernel, std::atomic<int> (&cache)[64], int device,
                    int threads, int smem, int max_per_sm = 0) {
  std::atomic<int>& entry = cache[device & 63];
  int r = entry.load(std::memory_order_acquire);
  if (r == 0) {
    if (smem > 0 &&
        cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem) != cudaSuccess)
      return 0;
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                  smem);
    if (max_per_sm > 0 && per_sm > max_per_sm) per_sm = max_per_sm;
    r = sms * (per_sm > 0 ? per_sm : 1);
    entry.store(r, std::memory_order_release);
  }
  return r;
}
