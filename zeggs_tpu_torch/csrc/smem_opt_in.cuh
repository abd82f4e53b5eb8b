// Opting a kernel in to more than 48 KB of dynamic shared memory, once per
// device and safely from several host threads.
//
// cudaFuncSetAttribute acts on the kernel in the current device's context
// only, so a flag kept once per process would skip the opt-in on a second
// card and its launch would be refused there.

#pragma once

#include <cuda_runtime.h>

#include <mutex>

class SmemOptIn {
 public:
  // Let `kernel` launch with `bytes` of dynamic shared memory on the
  // current device; returns a cudaError_t.
  cudaError_t ensure(const void* kernel, size_t bytes) {
    if (bytes <= kDefault) return cudaSuccess;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    std::lock_guard<std::mutex> lock(mu_);
    if (bytes <= set_[dev]) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err == cudaSuccess) set_[dev] = bytes;
    return err;
  }

 private:
  static constexpr size_t kDefault = 48 * 1024;
  static constexpr int kMaxDevices = 64;
  std::mutex mu_;
  size_t set_[kMaxDevices] = {};  // bytes opted into on each device so far
};
