"""How many thread-block clusters of each size one GPU runs at once.

    python3 tools/cluster_occupancy.py

For blocks of 256 threads holding as much dynamic shared memory as the
port's kernel bodies (one block an SM at 120 KB, two at 84 KB, several
at 29 KB), prints ``cudaOccupancyMaxActiveClusters`` for cluster sizes 1
to 8 and the number of blocks those clusters hold. A grid of more
clustered blocks than that runs in more than one wave, so this is what
sizes the grids of ``src/repro_torch/kernels/csrc/``. Builds a one-kernel
library with ``nvcc`` into the port's git-ignored build directory; needs
a CUDA device.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.kernels import build  # noqa: E402

SOURCE = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel(int*) {}
// clusters of `size` blocks of `threads` with `smem` bytes of dynamic
// shared memory that can be resident at once, or -(CUDA error) on failure
extern "C" int max_active_clusters(int size, int threads, int smem) {
  cudaError_t e = cudaFuncSetAttribute(
      empty_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(size, 1, 1);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = size;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, empty_kernel, &cfg);
  return e != cudaSuccess ? -static_cast<int>(e) : n;
}
"""


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("tools/cluster_occupancy.py needs a CUDA device")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / "cluster_occupancy.cu"
    lib = build.BUILD_DIR / "libcluster_occupancy.so"
    src.write_text(SOURCE)
    subprocess.run([build._nvcc(), *build.ARCH, "-O3", "-Xcompiler",
                    "-fPIC", "-shared", "-o", str(lib), str(src)],
                   check=True)
    fn = ctypes.CDLL(str(lib)).max_active_clusters
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    props = torch.cuda.get_device_properties(0)
    print(f"{props.name}: {props.multi_processor_count} SMs")
    for kb in (120, 84, 29):
        for size in range(1, 9):
            n = fn(size, 256, kb * 1024)
            print(f"256 threads, {kb} KB: clusters of {size}: {n} "
                  f"({n * size} blocks)")


if __name__ == "__main__":
    main()
