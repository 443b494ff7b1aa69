// What cs_project.cu (K2/K3/K5) and backproject.cu (K4/K6) share.
//
// 1. The column layout of the first port, which now serves only
//    backproject at n > 16 (off the main path). A block of kThreads = 256
//    threads owns 32 output columns and ROWS rows; a thread owns one
//    column and accumulates all ROWS rows, and the 8 warps split each slab
//    of the contraction between them. Here: the broadcast row loads (also
//    used by backproject's streamed body) and the fixed-order reduction of
//    the warps' and the cluster's partial sums.
// 2. What the newer bodies are built from: 16-byte cp.async copies into a
//    shared-memory ring (zero-filled past the edges of the arrays), dynamic
//    shared memory above the 48 KB default, and the cluster launch (K2's
//    split of D over 6 blocks at n > 16). Clusters of 4 to 8 blocks reach
//    at most 120 of the H100's 132 SMs (tools/cluster_occupancy.py), which
//    sizes the grids: the streamed bodies at n <= 16 use no cluster.
//
// Every reduction here sums in a fixed order (warps, then cluster ranks,
// in index order): a launch is deterministic, with no atomics.
#pragma once

#include <atomic>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// 16-byte asynchronous copy global -> shared through L2 only; `bytes` is
// 16 or 0, and 0 fills the destination with zeros without reading `src`
// (which must still be a valid address).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const uint32_t d =
      static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Raises `kernel`'s dynamic shared memory limit to `bytes` once per
// device; `done` is the caller's own static, one per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes,
                       std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (bit & done.load(std::memory_order_relaxed)) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

// Launches `kernel` on `grid` blocks of `threads` with `smem_bytes` of
// dynamic shared memory (above 48 KB only after allow_smem), in clusters
// of `split` blocks along z (grid.z == split).
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), dim3 grid,
                            int threads, int split, int smem_bytes,
                            cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes;
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
