// Launch helpers shared by the kernels' C entry points.

#pragma once

#include <cuda_runtime.h>

namespace estpu {

// Lets ``kernel`` take as much dynamic shared memory as a block of this
// device may opt into. The limit is per function and global to the
// process: set per launch to that launch's size, a thread launching with
// less (another query's smaller t_pad) could lower it between another
// thread's setting and its launch, which then fails with
// cudaErrorInvalidValue. Every caller sets the same device maximum, so
// concurrent launches cannot undo each other; a launch still reserves only
// the bytes it asks for.
template <typename Kernel>
cudaError_t allow_max_dynamic_smem(Kernel kernel) {
  int dev = 0;
  int bytes = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace estpu
