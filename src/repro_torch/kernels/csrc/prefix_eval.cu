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
// Design. The Pallas kernel walks U in order and carries the running s2
// from tile to tile. Here each row is split into segments, enough for two
// blocks on every SM (B = 64 rows of 8192: four segments of 2048, 256
// blocks), and a block that does not start its row finds its carry, the
// sum of k over the earlier segments, by reading them itself (from L2),
// in a fixed order: no block waits on another, there are no atomics and
// no flags between blocks, and a launch is deterministic. A block issues
// all of its loads (16-byte where the rows allow it) before any
// arithmetic: its segment of k and caps, two tiles of 1024 at once (one
// for a short row), and the earlier k. A thread owns 4 consecutive
// elements of each tile and sums them in order; the threads' totals are
// scanned with warp shuffles, and the warps' totals, with the warps'
// carry partials, meet in shared memory behind one barrier. Where
// every partial sum is exact in f32 (whole-number K_i, as in the paper)
// any order gives the same s2, and the formula is then evaluated in the
// plain version's op order with every operation rounded on its own
// (__fadd_rn, __fmul_rn, ...): nvcc would otherwise contract a*b + c into
// an FMA, and the result would no longer equal the plain version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads * 4;  // a thread owns 4 elements of a tile
constexpr int kCoef = 8;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float prefix_rt(float s1, float s2, float b,
                                           float ktot, float rho1, float a,
                                           float e, float nn) {
  const float sb = __fmul_rn(s2, b);
  float r = __fdiv_rn(__fmul_rn(rho1, __fsub_rn(ktot, s2)), ktot);
  r = __fadd_rn(r, a);
  r = __fadd_rn(r, __fdiv_rn(nn, __fmul_rn(sb, sb)));
  return __fadd_rn(r, __fmul_rn(s1, e));
}

// p[j .. j+3] for the indices below `end` (0 past it). VEC: j and end are
// multiples of 4 and p is 16-byte aligned.
template <bool VEC>
__device__ __forceinline__ void load4(const float* p, int j, int end,
                                      float (&o)[4]) {
  if constexpr (VEC) {
    const float4 t = j < end ? *reinterpret_cast<const float4*>(p + j)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) o[q] = j + q < end ? p[j + q] : 0.f;
  }
}

template <bool VEC, int TILES>
__global__ void __launch_bounds__(kThreads)
prefix_eval_kernel(const float* __restrict__ caps,
                   const float* __restrict__ k,
                   const float* __restrict__ coefs, float* __restrict__ out,
                   int u, int seg) {
  const size_t row = blockIdx.x;
  caps += row * u;
  k += row * u;
  out += row * u;
  const int start = blockIdx.y * seg;
  const int end = min(u, start + seg);
  const float* c = coefs + row * kCoef;
  const float ktot = c[0], rho1 = c[1], a = c[2], e = c[3], nn = c[4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mine = threadIdx.x * 4;
  constexpr int kChunk = kTile * TILES;
  __shared__ float warp_total[TILES][kWarps];
  __shared__ float warp_carry[kWarps];

  // this segment's first chunk, then this thread's part of k_0 + ... +
  // k_{start-1} (its 4 elements of every tile, tiles in order): every
  // load is in flight before the first add
  float kv[TILES][4], cv[TILES][4];
  auto load_chunk = [&](int c0) {
#pragma unroll
    for (int t = 0; t < TILES; ++t) {
      load4<VEC>(k, c0 + t * kTile + mine, end, kv[t]);
      load4<VEC>(caps, c0 + t * kTile + mine, end, cv[t]);
    }
  };
  load_chunk(start);
  float part = 0.f;
#pragma unroll 4
  for (int j = mine; j < start; j += kTile) {
    float t[4];
    load4<VEC>(k, j, start, t);
    part = __fadd_rn(part, __fadd_rn(__fadd_rn(t[0], t[1]),
                                     __fadd_rn(t[2], t[3])));
  }

  float carry = 0.f;  // s2 before the chunk
  for (int c0 = start; c0 < end; c0 += kChunk) {
    if (c0 != start) load_chunk(c0);
    float incl[TILES], excl[TILES];
#pragma unroll
    for (int t = 0; t < TILES; ++t) {
#pragma unroll
      for (int q = 1; q < 4; ++q)
        kv[t][q] = __fadd_rn(kv[t][q - 1], kv[t][q]);
      incl[t] = kv[t][3];  // inclusive scan of the thread totals in the warp
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(kFull, incl[t], o);
        if (lane >= o) incl[t] = __fadd_rn(incl[t], y);
      }
      excl[t] = __shfl_up_sync(kFull, incl[t], 1);
      if (lane == 0) excl[t] = 0.f;
      if (lane == 31) warp_total[t][warp] = incl[t];
    }
    if (c0 == start) {
      // the butterfly leaves the same bits in every lane (a + b == b + a)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        part = __fadd_rn(part, __shfl_xor_sync(kFull, part, o));
      if (lane == 0) warp_carry[warp] = part;
    }
    __syncthreads();
    if (c0 == start) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        carry = __fadd_rn(carry, warp_carry[w]);
    }
#pragma unroll
    for (int t = 0; t < TILES; ++t) {
      float before = 0.f, tile = 0.f;  // earlier warps' sum, the tile's sum
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if (w < warp) before = __fadd_rn(before, warp_total[t][w]);
        tile = __fadd_rn(tile, warp_total[t][w]);
      }
      const float base = __fadd_rn(carry, __fadd_rn(before, excl[t]));
      const int j0 = c0 + t * kTile + mine;
      // only where j < end: a lane past the row would divide by 0 and
      // send its warp down the division's slow path
      float r[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (j0 + q < end)
          r[q] = prefix_rt(__int2float_rn(j0 + q + 1),
                           __fadd_rn(base, kv[t][q]), cv[t][q], ktot, rho1,
                           a, e, nn);
      if constexpr (VEC) {
        if (j0 < end)
          *reinterpret_cast<float4*>(out + j0) =
              make_float4(r[0], r[1], r[2], r[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (j0 + q < end) out[j0 + q] = r[q];
      }
      carry = __fadd_rn(carry, tile);
    }
    if (c0 + kChunk < end) __syncthreads();  // the next chunk rewrites them
  }
}

// Segments a row is split into: enough blocks for two on every SM, none
// shorter than a tile.
int segments(int b, int u) {
  static int sms[kMaxDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  int& n = sms[dev < kMaxDevices ? dev : 0];
  if (n == 0)
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  const int by_card = 2 * n / b > 1 ? 2 * n / b : 1;
  const int by_row = (u + kTile - 1) / kTile;
  return by_card < by_row ? by_card : by_row;
}

template <bool VEC>
void launch(const float* caps, const float* k, const float* coefs,
            float* out, int b, int u, int seg, cudaStream_t st) {
  const dim3 grid(b, (u + seg - 1) / seg);  // rows on x: B may pass 65535
  // one tile for a segment that fits one (the greedy round's U = 10),
  // else two at once, looped over the segment
  if (seg <= kTile)
    prefix_eval_kernel<VEC, 1><<<grid, kThreads, 0, st>>>(caps, k, coefs,
                                                          out, u, seg);
  else
    prefix_eval_kernel<VEC, 2><<<grid, kThreads, 0, st>>>(caps, k, coefs,
                                                          out, u, seg);
}

}  // namespace

// caps, k, out: (b, u) f32; coefs: (b, 8) f32. A row is split over
// `segments` blocks; rows are read and written in 16-byte pieces where
// u % 4 == 0 and every array is 16-byte aligned.
extern "C" int prefix_eval_f32(const float* caps, const float* k,
                               const float* coefs, float* out, int b, int u,
                               void* stream) {
  if (b == 0 || u == 0) return 0;
  const int nseg = segments(b, u);
  const int seg = ((u + nseg - 1) / nseg + 3) / 4 * 4;
  const bool vec = u % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(caps) |
                     reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) launch<true>(caps, k, coefs, out, b, u, seg, st);
  else launch<false>(caps, k, coefs, out, b, u, seg, st);
  return static_cast<int>(cudaGetLastError());
}
