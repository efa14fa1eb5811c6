// Per-device launch state shared by the kernels' C launchers.
//
// cudaFuncSetAttribute takes effect on the current device only, and the SM
// count and a kernel's occupancy belong to a device too. So each is kept
// per (kernel, device ordinal), set or queried on a device's first launch
// that needs it, under a lock: ctypes releases the GIL during a call, so
// two host threads may launch at once.

#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>

namespace ede {

// Let `kernel` take `smem` bytes of dynamic shared memory on the current
// device (above 48 KB a launch needs the attribute set first).
inline cudaError_t allow_smem(const void* kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, int> allowed;
  std::lock_guard<std::mutex> lock(mu);
  int& bytes = allowed[{kernel, device}];
  if (smem <= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) bytes = smem;
  return err;
}

// Blocks of `kernel` (`threads` threads, `smem` bytes of dynamic shared
// memory) that the current device holds at once: at least one an SM.
inline cudaError_t resident_blocks(const void* kernel, int threads, int smem,
                                   int* blocks) {
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, int>, int> cache;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(kernel, device, threads, smem);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *blocks = it->second;
    return cudaSuccess;
  }
  int sms, per_sm;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return err;
  *blocks = cache[key] = (per_sm > 1 ? per_sm : 1) * sms;
  return cudaSuccess;
}

}  // namespace ede
