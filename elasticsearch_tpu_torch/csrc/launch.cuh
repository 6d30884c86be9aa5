// Launch helpers shared by the kernels' C entry points.

#pragma once

#include <cuda_runtime.h>

#include <mutex>
#include <utility>
#include <vector>

namespace estpu {

// Lets ``kernel`` take as much dynamic shared memory as a block of this
// device may opt into. The limit is per function and global to the
// process: set per launch to that launch's size, a thread launching with
// less (another query's smaller t_pad) could lower it between another
// thread's setting and its launch, which then fails with
// cudaErrorInvalidValue. It is only ever set to the device's maximum, so
// concurrent launches cannot undo each other; a launch still reserves only
// the bytes it asks for.
//
// The attribute is set once per kernel and device: the first launch pays
// cudaDeviceGetAttribute and cudaFuncSetAttribute, every later one a
// cudaGetDevice and a look-up under a mutex. The first thread sets the
// attribute while it holds the mutex, so no launch of that kernel on that
// device runs before the limit is raised.
inline cudaError_t allow_max_dynamic_smem_once(const void* kernel) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  static std::mutex mu;
  static std::vector<std::pair<const void*, int>> raised;
  std::lock_guard<std::mutex> lock(mu);
  for (const auto& kd : raised)
    if (kd.first == kernel && kd.second == dev) return cudaSuccess;
  int bytes = 0;
  err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) raised.emplace_back(kernel, dev);
  return err;
}

template <typename Kernel>
cudaError_t allow_max_dynamic_smem(Kernel kernel) {
  return allow_max_dynamic_smem_once(reinterpret_cast<const void*>(kernel));
}

}  // namespace estpu
