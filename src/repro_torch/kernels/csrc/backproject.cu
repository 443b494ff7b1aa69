// K4 / K6 backproject: out = x + tau * (R Phi), the BIHT/IHT update step.
//
// Replaces: src/repro/kernels/backproject.py:_backproject_kernel (K4,
// pallas_call at backproject.py:99) and
// backproject.py:_backproject_packed_kernel (K6, pallas_call at
// backproject.py:138).
//
// R is (n, S), Phi is (S, D) and x, out are (n, D), all f32 row-major. The
// product contracts over S, so Phi is read down its columns here, unlike
// cs_project which reads it along its rows. K6 takes R as two uint32 bit
// planes (n, S/32), plus and minus, and R = 2 (plus - minus) in {-2, 0, 2}.
//
// Bound on the H100: bytes. At the decode shape (n=13, S=1024, D=4096)
// the kernel reads the 16.8 MB Phi once for 0.11 GFLOP: 5 us of traffic
// against 1.6 us of f32 work. K6 reads 1/16 of K4's residual bytes.
//
// The two kernels are one template: it takes how a residual element is
// loaded (DenseResid or PackedResid) and nothing else differs. The packed
// values are exact floats in the same summation order, so K6 on the
// planes equals K4 on 2 (plus - minus) bit for bit.
//
// Design (the layout of column_tile.cuh). A block owns 32 D columns and
// ROWS rows (16 for n <= 16, the decode; 32 otherwise), a thread one
// column and all ROWS rows. The 8
// warps split each 128-deep slab of S between them, so a thread reads its
// rows of R as broadcast 16-byte shared loads (ROWS FMAs per ROWS/4 + 1
// loads). Each slab is staged in registers one step ahead of the
// multiply, with R loaded along S and Phi along D, so every warp load is
// a 128-byte row segment. S is also split over a cluster of SPLIT blocks
// (4 for the decode, giving 4 * D/32 = 512 blocks to stream Phi; 2
// otherwise). The warps' partial sums meet in shared memory and the
// cluster's in block 0 through distributed shared memory, both summed in a
// fixed order (deterministic), and block 0 alone writes the output.
//
// Accumulation is f32 FMA on the CUDA cores. The epilogue is written as
// __fadd_rn(x, __fmul_rn(tau, acc)) so that nvcc cannot contract it into
// an FMA: the plain version rounds the product before the add.
#include <cuda_runtime.h>
#include <stdint.h>

#include "column_tile.cuh"

namespace {

using column_tile::kPad;
using column_tile::kThreads;

constexpr int kBK = 128;       // S-depth of a slab

// Residual element (row, k) of R (n, S), read through the read-only path.
struct DenseResid {            // K4: f32 R
  const float* r;
  __device__ __forceinline__ float operator()(int row, int k, int s) const {
    return __ldg(r + static_cast<size_t>(row) * s + k);
  }
};

struct PackedResid {           // K6: bit k & 31 of word k >> 5 of each plane
  const uint32_t* plus;
  const uint32_t* minus;
  __device__ __forceinline__ float operator()(int row, int k, int s) const {
    const size_t w = static_cast<size_t>(row) * (s / 32) + (k >> 5);
    const int p = (__ldg(plus + w) >> (k & 31)) & 1;
    const int m = (__ldg(minus + w) >> (k & 31)) & 1;
    return static_cast<float>(2 * (p - m));
  }
};

// One kBK-deep slab of R (ROWS rows) and Phi (kBK rows x 32 columns),
// staged in registers: R element k0 + 32q + lane of rows warp + 8i, and
// Phi row k0 + warp + 8i at column col0 + lane. With the packed planes,
// the 32 lanes of a warp read one word (S % 32 == 0, k0 % 32 == 0).
template <int ROWS, class Resid>
struct Slab {
  static constexpr int KQ = kBK / 32;
  float rr[(ROWS / 8) * KQ], pr[kBK / 8];

  __device__ __forceinline__ void load(const Resid& r,
                                       const float* __restrict__ phi, int n,
                                       int s, int d, int row0, int col0,
                                       int k0, int lane, int warp) {
#pragma unroll
    for (int q = 0; q < KQ; ++q) {
      const int gk = k0 + 32 * q + lane;
#pragma unroll
      for (int i = 0; i < ROWS / 8; ++i) {
        const int gr = row0 + warp + 8 * i;
        rr[q * (ROWS / 8) + i] = (gk < s && gr < n) ? r(gr, gk, s) : 0.f;
      }
    }
    const int gc = col0 + lane;
#pragma unroll
    for (int i = 0; i < kBK / 8; ++i) {
      const int gs = k0 + warp + 8 * i;
      pr[i] = (gs < s && gc < d) ? phi[static_cast<size_t>(gs) * d + gc]
                                 : 0.f;
    }
  }

  __device__ __forceinline__ void store(float (*rs)[ROWS + kPad],
                                        float (*ps)[32], int lane,
                                        int warp) const {
#pragma unroll
    for (int q = 0; q < KQ; ++q)
#pragma unroll
      for (int i = 0; i < ROWS / 8; ++i)
        rs[32 * q + lane][warp + 8 * i] = rr[q * (ROWS / 8) + i];
#pragma unroll
    for (int i = 0; i < kBK / 8; ++i) ps[warp + 8 * i][lane] = pr[i];
  }
};

// Block (x, y, z) owns D columns [32x, 32x + 32), rows [ROWS y, ROWS y +
// ROWS) and the z-th kBK-aligned segment of S; clusters of SPLIT blocks
// along z.
template <int ROWS, int SPLIT, class Resid>
__global__ void __launch_bounds__(kThreads)
backproject_kernel(const float* __restrict__ x, const Resid r,
                   const float* __restrict__ phi, float* __restrict__ out,
                   int n, int s, int d, float tau) {
  constexpr int KW = kBK / 8;    // slab depth per warp
  constexpr int RPT = ROWS / 8;  // rows a thread finishes
  constexpr int RS = kBK * (ROWS + kPad), PS = kBK * 32;
  constexpr int RED = 8 * ROWS * 33;
  // the slab buffers and the warp partials are never live together
  __shared__ __align__(16) float smem[RS + PS > RED ? RS + PS : RED];
  auto rs = reinterpret_cast<float (*)[ROWS + kPad]>(smem);
  auto ps = reinterpret_cast<float (*)[32]>(smem + RS);
  auto red = reinterpret_cast<float (*)[ROWS][33]>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.y * ROWS, col0 = blockIdx.x * 32;
  const int seg = ((s + kBK - 1) / kBK + SPLIT - 1) / SPLIT * kBK;
  const int k_begin = blockIdx.z * seg;
  const int k_end = min(s, k_begin + seg);

  float acc[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) acc[i] = 0.f;

  Slab<ROWS, Resid> slab;
  if (k_begin < k_end)
    slab.load(r, phi, n, s, d, row0, col0, k_begin, lane, warp);
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    slab.store(rs, ps, lane, warp);
    __syncthreads();
    // the next slab's loads fly while this one is multiplied
    if (k0 + kBK < k_end)
      slab.load(r, phi, n, s, d, row0, col0, k0 + kBK, lane, warp);
#pragma unroll 4
    for (int t = 0; t < KW; ++t) {
      const int kk = warp * KW + t;
      float a[ROWS];
      column_tile::load_rows<ROWS>(&rs[kk][0], a);
      const float b = ps[kk][lane];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) acc[i] = fmaf(a[i], b, acc[i]);
    }
    __syncthreads();
  }

  float v[RPT];
  if (!column_tile::reduce_partials<ROWS, SPLIT>(acc, red, v, warp, lane))
    return;
  const int c = col0 + lane;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = row0 + RPT * warp + i;
    if (row < n && c < d) {
      const size_t idx = static_cast<size_t>(row) * d + c;
      out[idx] = __fadd_rn(x[idx], __fmul_rn(tau, v[i]));
    }
  }
}

template <int ROWS, int SPLIT, class Resid>
cudaError_t launch(const float* x, Resid r, const float* phi, float* out,
                   int n, int s, int d, float tau, cudaStream_t st) {
  return column_tile::launch_clusters(
      backproject_kernel<ROWS, SPLIT, Resid>,
      dim3((d + 31) / 32, (n + ROWS - 1) / ROWS, SPLIT), SPLIT, st, x, r,
      phi, out, n, s, d, tau);
}

template <class Resid>
cudaError_t launch_rows(const float* x, Resid r, const float* phi,
                        float* out, int n, int s, int d, float tau,
                        void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return n <= 16 ? launch<16, 4>(x, r, phi, out, n, s, d, tau, st)
                 : launch<32, 2>(x, r, phi, out, n, s, d, tau, st);
}

}  // namespace

extern "C" int backproject_f32(const float* x, const float* r,
                               const float* phi, float* out, int n, int s,
                               int d, float tau, void* stream) {
  return static_cast<int>(launch_rows(x, DenseResid{r}, phi, out, n, s, d,
                                      tau, stream));
}

// plus, minus: (n, s/32) uint32 bit planes, s % 32 == 0.
extern "C" int backproject_packed_f32(const float* x, const uint32_t* plus,
                                      const uint32_t* minus,
                                      const float* phi, float* out, int n,
                                      int s, int d, float tau, void* stream) {
  if (s % 32) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_rows(x, PackedResid{plus, minus}, phi,
                                      out, n, s, d, tau, stream));
}
