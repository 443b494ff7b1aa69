// K1 topk_select: per-row top-kappa by |x| (paper eq. 6, and the decode's
// hard threshold eta_kappa), as 32 rounds of threshold bisection.
//
// Replaces: src/repro/kernels/topk_select.py:_topk_kernel (pallas_call at
// topk_select.py:58).
//
// Bound on the H100: bytes. At the main path's compression shape
// (n=130 rows of D=4096 f32) the kernel must read 2.1 MB and write 2.1 MB
// of values plus 0.5 MB of int8 mask, about 4.8 MB or 1.4 us at 3.35 TB/s;
// its 33 compare-and-count passes are 37 M operations, 0.6 us at the
// 67 TFLOP/s f32 rate. In practice it is bound by latency: each pass ends
// in a block-wide count. Design: one block per row, and the row lives in
// registers (VPT values per thread), so x is read from device memory once
// and a pass is VPT register compares, one warp reduction
// (__reduce_add_sync) and ONE block barrier (the per-warp partial counts
// alternate between two shared buffers, so a pass never waits for the
// previous pass's readers). Counts are integers, so the result is exact
// whatever the order. At small n (13 rows in the decode) only n SMs work;
// a later version can split a row over a cluster.
//
// The f32 op sequence is the Pallas kernel's, step for step: hi = max|x|,
// lo = 0, mid = 0.5f * (lo + hi), "cnt > k" moves lo up, the final select
// is |x| >= min(hi, max), and when that selects fewer than k the threshold
// falls back to lo. The masks therefore equal the plain version exactly,
// including rows with fewer than k nonzeros (the fallback selects the
// whole row there).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBisect = 32;  // N_BISECT of the Pallas kernel

// Block-wide sum of one int per thread, one barrier: `red` alternates
// between the two halves of a [2][kWarps] buffer from call to call.
__device__ __forceinline__ int block_count(int v, int* red) {
  v = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += red[w];
  return total;
}

template <int VPT>
__device__ __forceinline__ int count_ge(const float (&v)[VPT], float t) {
  int c = 0;
#pragma unroll
  for (int j = 0; j < VPT; ++j) c += fabsf(v[j]) >= t;
  return c;
}

template <int VPT>
__global__ void __launch_bounds__(kThreads)
topk_select_kernel(const float* __restrict__ x, float* __restrict__ val,
                   int8_t* __restrict__ mask, int d, int k) {
  __shared__ int ired[2][kWarps];
  __shared__ float fred[kWarps];
  const size_t base = static_cast<size_t>(blockIdx.x) * d;

  // lanes past the row end hold NaN: no compare counts them
  float v[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int i = threadIdx.x + j * kThreads;
    v[j] = i < d ? x[base + i] : __int_as_float(0x7fffffff);
  }
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < VPT; ++j)
    if (threadIdx.x + j * kThreads < d) m = fmaxf(m, fabsf(v[j]));
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) fred[threadIdx.x >> 5] = m;
  __syncthreads();
  float amax = fred[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) amax = fmaxf(amax, fred[w]);

  float lo = 0.f, hi = amax;
  for (int it = 0; it < kBisect; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    const int cnt = block_count(count_ge(v, mid), ired[it & 1]);
    if (cnt > k) lo = mid; else hi = mid;
  }
  const float sel_hi = fminf(hi, amax);
  const int cnt_hi = block_count(count_ge(v, sel_hi), ired[kBisect & 1]);
  const float t = cnt_hi >= k ? sel_hi : lo;

#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (i < d) {
      const bool sel = fabsf(v[j]) >= t;
      val[base + i] = v[j] * (sel ? 1.f : 0.f);
      mask[base + i] = sel ? 1 : 0;
    }
  }
}

template <int VPT>
cudaError_t launch(const float* x, float* val, int8_t* mask, int n, int d,
                   int k, cudaStream_t st) {
  topk_select_kernel<VPT><<<n, kThreads, 0, st>>>(x, val, mask, d, k);
  return cudaGetLastError();
}

}  // namespace

// x, val: (n, d) f32 row-major; mask: (n, d) int8; d <= 16384. Launches on
// `stream`.
extern "C" int topk_select_f32(const float* x, float* val, int8_t* mask,
                               int n, int d, int k, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (d <= 4 * kThreads) e = launch<4>(x, val, mask, n, d, k, st);
  else if (d <= 8 * kThreads) e = launch<8>(x, val, mask, n, d, k, st);
  else if (d <= 16 * kThreads) e = launch<16>(x, val, mask, n, d, k, st);
  else if (d <= 32 * kThreads) e = launch<32>(x, val, mask, n, d, k, st);
  else e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
