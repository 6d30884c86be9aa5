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
inline cudaError_t allow_max_dynamic_smem_once(const void* kernel,
                                              bool clusters = false) {
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
  // clusters of 16 exceed the portable size of 8
  if (err == cudaSuccess && clusters)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) raised.emplace_back(kernel, dev);
  return err;
}

template <typename Kernel>
cudaError_t allow_max_dynamic_smem(Kernel kernel) {
  return allow_max_dynamic_smem_once(reinterpret_cast<const void*>(kernel));
}

// A launch of ``blocks`` blocks of ``threads`` in clusters of ``cluster``
// along x, ``smem`` dynamic bytes each; attr must outlive cfg.
inline cudaLaunchConfig_t cluster_config(int blocks, int threads, size_t smem,
                                         int cluster, cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks), 1, 1);
  cfg.blockDim = dim3(static_cast<unsigned>(threads), 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// How many clusters of ``cluster`` blocks (``threads`` threads, ``smem``
// dynamic bytes each) of ``kernel`` the device can hold at once: 0 means
// the cluster cannot be scheduled. Raises the kernel's limits first;
// answers are kept per (kernel, device, cluster, threads, smem).
template <typename Kernel>
cudaError_t max_active_clusters(Kernel kernel, int threads, size_t smem,
                                int cluster, int* out) {
  const void* key = reinterpret_cast<const void*>(kernel);
  cudaError_t err = allow_max_dynamic_smem_once(key, true);
  if (err != cudaSuccess) return err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  struct Entry {
    const void* kernel;
    int dev, cluster, threads;
    size_t smem;
    int n;
  };
  static std::mutex mu;
  static std::vector<Entry> known;
  std::lock_guard<std::mutex> lock(mu);
  for (const auto& e : known)
    if (e.kernel == key && e.dev == dev && e.cluster == cluster &&
        e.threads == threads && e.smem == smem) {
      *out = e.n;
      return cudaSuccess;
    }
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      cluster_config(cluster, threads, smem, cluster, nullptr, attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  if (err != cudaSuccess) {
    // a configuration the device refuses outright cannot be scheduled
    cudaGetLastError();
    n = 0;
  }
  known.push_back(Entry{key, dev, cluster, threads, smem, n});
  *out = n;
  return cudaSuccess;
}

// Launches ``kernel`` in clusters, refusing (cudaErrorInvalidConfiguration)
// a cluster that cudaOccupancyMaxActiveClusters says cannot be scheduled.
template <typename Kernel, typename... Args>
cudaError_t launch_clusters(Kernel kernel, int blocks, int threads,
                            size_t smem, int cluster, cudaStream_t stream,
                            Args... args) {
  int fit = 0;
  cudaError_t err = max_active_clusters(kernel, threads, smem, cluster, &fit);
  if (err != cudaSuccess) return err;
  if (fit <= 0) return cudaErrorInvalidConfiguration;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      cluster_config(blocks, threads, smem, cluster, stream, attr);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace estpu
