// Error strings for the C entry points of the port's kernels: every entry
// returns cudaGetLastError() and the Python wrapper turns a non-zero code
// into a RuntimeError with this text.
#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
