// Launching a kernel as thread-block clusters, shared by groupnorm.cu,
// fused_degrade.cu and kmask.cu.
//
// A launch of ctas > 1 goes out with a cluster dimension of ctas along x
// (grid a multiple of ctas); ctas = 1 is a plain launch. Each kernel
// instance gets its attributes once, at its first launch: the non-portable
// cluster size (16 CTAs; the portable limit is 8) and, where it asks for
// more than 48 KB, the dynamic shared memory it may use.

#pragma once

#include <cuda_runtime.h>

namespace mdt {

constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use on an H100

// The attributes every instance needs before its first launch; max_smem > 0
// raises the kernel's dynamic shared memory limit to max_smem bytes.
template <typename K>
cudaError_t prepare_cluster_kernel(K kernel, int max_smem) {
  cudaError_t err = cudaSuccess;
  if (max_smem > 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return err;
}

inline cudaLaunchAttribute cluster_dim_attr(int ctas) {
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = ctas;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  return attr;
}

// Launch Kernel on grid CTAs of threads threads with smem bytes of dynamic
// shared memory, in clusters of ctas CTAs; returns the launch's error.
template <auto Kernel, int MaxSmem = 0, typename... Args>
cudaError_t launch_cluster(int grid, int threads, int smem, int ctas, cudaStream_t st,
                           Args... args) {
  static const cudaError_t prepared = prepare_cluster_kernel(Kernel, MaxSmem);
  if (prepared != cudaSuccess) return prepared;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1] = {cluster_dim_attr(ctas)};
  cfg.attrs = attr;
  cfg.numAttrs = ctas > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, Kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// How many clusters of ctas CTAs (threads threads, smem bytes each) of
// kernel can be resident at once; 0 means the size cannot be scheduled.
template <typename K>
cudaError_t max_active_clusters(K kernel, int max_smem, int ctas, int threads, int smem,
                                int* out) {
  cudaError_t err = prepare_cluster_kernel(kernel, max_smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1] = {cluster_dim_attr(ctas)};
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}

}  // namespace mdt
