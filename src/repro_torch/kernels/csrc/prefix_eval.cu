// K7 prefix_eval: R_t of every prefix of the cap-sorted workers, the sweep
// of the greedy P2 scheduler.
//
// Replaces: src/repro/kernels/prefix_eval.py:_prefix_kernel (pallas_call
// at prefix_eval.py:88).
//
// caps, k and out are (B, U) f32 row-major, each row in descending-cap
// order; coefs is (B, 8) f32 = [Ktot, rho1, A, E, N, 0, 0, 0]. For prefix
// j of a row, s1 = j + 1, s2 = k_0 + ... + k_j and b = caps_j, and
//
//   out_j = rho1 (Ktot - s2) / Ktot + A + N / (s2 b)^2 + s1 E
//
// Bound on the H100: bytes. Each element is two loads and a store and
// about ten flops, so at the fleet shape (B=64, U=8192) 6.3 MB move in
// 1.9 us against 0.08 us of f32 work.
//
// Design. One block per row walks U in tiles of kThreads * kItems (the
// Pallas kernel's sequential grid axis becomes this loop) and carries the
// running s2 of the earlier tiles in a register. Inside a tile a thread
// owns kItems consecutive elements and sums them in order; the threads'
// totals are scanned with warp shuffles, the warps' totals in shared
// memory, in a fixed order. Ragged U is masked, not padded. Where every
// partial sum is exact in f32 (whole-number K_i, as in the paper) any
// order gives the same s2, and the formula is then evaluated in the plain
// version's op order with every operation rounded on its own
// (__fadd_rn, __fmul_rn, ...): nvcc would otherwise contract a*b + c into
// an FMA, and the result would no longer equal the plain version.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr int kCoef = 8;

__device__ __forceinline__ float prefix_rt(float s1, float s2, float b,
                                           float ktot, float rho1, float a,
                                           float e, float nn) {
  const float sb = __fmul_rn(s2, b);
  float r = __fdiv_rn(__fmul_rn(rho1, __fsub_rn(ktot, s2)), ktot);
  r = __fadd_rn(r, a);
  r = __fadd_rn(r, __fdiv_rn(nn, __fmul_rn(sb, sb)));
  return __fadd_rn(r, __fmul_rn(s1, e));
}

__global__ void __launch_bounds__(kThreads)
prefix_eval_kernel(const float* __restrict__ caps,
                   const float* __restrict__ k,
                   const float* __restrict__ coefs, float* __restrict__ out,
                   int u) {
  const size_t row = blockIdx.x;
  caps += row * u;
  k += row * u;
  out += row * u;
  const float* c = coefs + row * kCoef;
  const float ktot = c[0], rho1 = c[1], a = c[2], e = c[3], nn = c[4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __shared__ float warp_total[kWarps];

  float carry = 0.f;  // s2 of the tiles before this one
  for (int t0 = 0; t0 < u; t0 += kTile) {
    const int j0 = t0 + threadIdx.x * kItems;
    float part[kItems];  // inclusive sums of this thread's elements
    float run = 0.f;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      run = __fadd_rn(run, j0 + i < u ? k[j0 + i] : 0.f);
      part[i] = run;
    }
    float incl = run;  // inclusive scan of the thread totals in the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl = __fadd_rn(incl, t);
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
    if (lane == 31) warp_total[warp] = incl;
    __syncthreads();
    float before = 0.f, tile = 0.f;  // earlier warps' sum, the tile's sum
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) before = __fadd_rn(before, warp_total[w]);
      tile = __fadd_rn(tile, warp_total[w]);
    }
    const float base = __fadd_rn(carry, __fadd_rn(before, excl));
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int j = j0 + i;
      if (j < u)
        out[j] = prefix_rt(__int2float_rn(j + 1), __fadd_rn(base, part[i]),
                           caps[j], ktot, rho1, a, e, nn);
    }
    carry = __fadd_rn(carry, tile);
    __syncthreads();  // the next tile rewrites warp_total
  }
}

}  // namespace

// caps, k, out: (b, u) f32; coefs: (b, 8) f32. One block per row.
extern "C" int prefix_eval_f32(const float* caps, const float* k,
                               const float* coefs, float* out, int b, int u,
                               void* stream) {
  prefix_eval_kernel<<<b, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      caps, k, coefs, out, u);
  return static_cast<int>(cudaGetLastError());
}
