// Thread-block clusters of the f32 kernels above head dim 256: the f32 wide
// forward (flash_fwd.cu) and the f32 wide dQ and dK/dV (flash_bwd.cu). Each
// puts the spans of its output's columns on grid.z and launches the span
// blocks of one tile as a cluster, so the scores are formed once a cluster
// instead of once a span block.
//
// The cluster policy: min(spans, 8) blocks (8 is the portable cluster
// limit), grid.z rounded up to a multiple of the cluster. Up to eight spans
// one cluster covers every span and the scores are formed once a tile;
// above eight, each cluster of eight forms the scores itself, and a block
// past D only helps form them. (dQ rounds its cluster up to a power of two,
// because its swap buffers are sized by the cluster at compile time.)

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

// The cluster's blocks for `spans` span blocks.
inline unsigned span_cluster(int spans) { return spans < 8 ? spans : 8; }

// The d-chunks [x, x + y) of the head dim whose partial scores this block
// forms: the cdiv(D, CW) chunks of CW columns split evenly over its
// cluster's blocks.
template <int CW>
__device__ __forceinline__ int2 own_chunks(int D) {
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();
  const int all = (D + CW - 1) / CW;
  const int n = cl.num_blocks(), r = cl.block_rank();
  const int first = r * all / n;
  return make_int2(first, (r + 1) * all / n - first);
}

// Launches kernel with `threads` threads a block, `smem` bytes of dynamic
// shared memory and grid.z (the spans) rounded up to a multiple of
// `cluster`, in clusters of `cluster` blocks along z.
template <typename P>
cudaError_t launch_clusters(void (*kernel)(const P), dim3 grid,
                            unsigned threads, size_t smem, const P& p,
                            cudaStream_t stream, unsigned cluster) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim =
      dim3(grid.x, grid.y, (grid.z + cluster - 1) / cluster * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = cluster;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
