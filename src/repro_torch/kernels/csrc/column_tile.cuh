// The block layout shared by cs_project.cu (K2/K3) and backproject.cu (K4).
//
// A block of kThreads = 256 threads owns 32 output columns and ROWS rows;
// a thread owns one column and accumulates all ROWS rows, and the 8 warps
// split each slab of the contraction between them. The contraction is
// also split over a cluster of SPLIT blocks along grid z. This header
// holds what both kernels do the same way: the broadcast row loads, the
// fixed-order reduction of the warps' and the cluster's partial sums, and
// the cluster launch.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace column_tile {

constexpr int kThreads = 256;  // 8 warps
constexpr int kPad = 4;        // keeps 16-byte alignment of smem rows

// a[i] = row[i] for i < R, as broadcast 16-byte shared loads (the rows of
// a slab step are contiguous; every lane reads the same address).
template <int R>
__device__ __forceinline__ void load_rows(const float* row, float (&a)[R]) {
#pragma unroll
  for (int i = 0; i < R; i += 4) {
    const float4 t = *reinterpret_cast<const float4*>(row + i);
    a[i] = t.x; a[i + 1] = t.y; a[i + 2] = t.z; a[i + 3] = t.w;
  }
}

// Sums every warp's acc (ROWS rows of column `lane`) into v: thread (warp,
// lane) gets rows ROWS/8 * warp + i, the warps added in order; then block
// 0 of the cluster adds the other blocks' v through distributed shared
// memory in rank order. Deterministic. `red` may alias the slab buffers
// once the last slab's barrier has passed. Returns false in every block
// but the cluster's block 0, which alone holds the sums.
template <int ROWS, int SPLIT>
__device__ __forceinline__ bool reduce_partials(const float (&acc)[ROWS],
                                                float (*red)[ROWS][33],
                                                float (&v)[ROWS / 8],
                                                int warp, int lane) {
  constexpr int RPT = ROWS / 8;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) red[warp][r][lane] = acc[r];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    v[i] = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) v[i] += red[w][RPT * warp + i][lane];
  }
  if constexpr (SPLIT == 1) {
    return true;
  } else {
    __shared__ float part[ROWS][32];
#pragma unroll
    for (int i = 0; i < RPT; ++i) part[RPT * warp + i][lane] = v[i];
    cooperative_groups::cluster_group cluster =
        cooperative_groups::this_cluster();
    cluster.sync();  // every block's partial tile is written
    const unsigned rank = cluster.block_rank();
    if (rank == 0) {
      for (unsigned q = 1; q < SPLIT; ++q) {
        const float* other = cluster.map_shared_rank(&part[0][0], q);
#pragma unroll
        for (int i = 0; i < RPT; ++i)
          v[i] += other[(RPT * warp + i) * 32 + lane];
      }
    }
    cluster.sync();  // block 0 is done reading the others' tiles
    return rank == 0;
  }
}

// Launches `kernel` on `grid` blocks of kThreads, in clusters of `split`
// blocks along z (grid.z == split).
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), dim3 grid, int split,
                            cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace column_tile
