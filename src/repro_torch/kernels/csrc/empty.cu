// An empty kernel: what any launch of one block costs on the card, the
// floor under the latency-bound kernels (K1, K7). chip_smoke.py times it
// by the same CUDA graph replay as the kernels; no path of the port
// launches it.
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int repro_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
