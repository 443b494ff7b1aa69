// K2 / K3 / K5 cs_project: C = X Phi^T with an epilogue chosen by `mode`.
//
// Replaces: src/repro/kernels/cs_project.py:_proj_kernel (K2: epilogues
// none, sign, pack) and cs_project.py:_proj_resid_kernel (K3: epilogues
// sign_residual, residual), both launched by the pallas_call at
// cs_project.py:209, and cs_project.py:_proj_pack_resid_kernel (K5, the
// packed BIHT residual, pallas_call at cs_project.py:182).
//
//   none          out = acc                      (n, S) f32
//   sign          out = acc >= 0 ? +1 : -1       (n, S) f32   (eq. 7)
//   pack          word = ballot(acc >= 0) over 32 consecutive S lanes,
//                 LSB-first                       (n, S/32) uint32 bits
//   sign_residual out = y - sign(acc)            (n, S) f32   (BIHT)
//   residual      out = y - acc                  (n, S) f32   (IHT)
//   pack_sign_residual  with y packed (n, S/32) and s = ballot(acc >= 0):
//                 plus = y & ~s, minus = s & ~y   (2, n, S/32) uint32 bits
//                 so that y - sign(acc) = 2 (plus - minus)    (packed BIHT)
//
// X is (n, D) and Phi is (S, D), both row-major, so both operands are read
// along their contiguous D axis. Accumulation is f32 FMA on the CUDA cores:
// TF32 tensor cores would flip signs near zero.
//
// Bound on the H100: at the compression shape (n=130, S=1024, D=4096) the
// product is 1.09 GFLOP on about 19 MB, 16 us of f32 work against 6 us of
// traffic: operations. At the decode shape (n=13) it is 0.11 GFLOP on the
// 16.8 MB Phi: bytes, 5 us. K5 reads the same Phi, 1/32 of K3's y bytes
// and writes 1/16 of its residual bytes: also bytes, 5 us.
//
// Design (the layout of column_tile.cuh). A block owns 32 S columns and
// ROWS rows of X (16 for n <= 16, the decode; 32 otherwise), a thread one
// column and all ROWS rows. The 8 warps split each BK-deep slab of D
// between them, so a thread reads its rows as broadcast 16-byte shared
// loads (ROWS FMAs per ROWS/4 + 1 loads).
// Each slab is staged in registers one step ahead of the multiply, every
// warp load being a 128-byte row segment, so load latency overlaps the
// products. D is also split over a cluster of SPLIT blocks (8 for the
// decode, giving 8 * S/32 = 256 blocks to stream Phi; 2 otherwise). The
// warps' partial sums meet in shared memory and the cluster's in block 0
// through distributed shared memory, both summed in a fixed order
// (deterministic), and block 0 alone runs the epilogue. Lane i of a warp
// holds S column 32j + i, so the pack epilogue is one __ballot_sync per
// word; the packed residual adds one load of the y word and two stores.
// Every mode shares the accumulation, so K5's signs are K3's bit for bit
// at the same n. The epilogue never writes the dense projection in the
// sign, pack and residual modes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "column_tile.cuh"

namespace {

using column_tile::kPad;
using column_tile::kThreads;

enum Mode { kNone = 0, kSign = 1, kPack = 2, kSignResidual = 3,
            kResidual = 4, kPackSignResidual = 5 };

// One BK-deep slab of X (ROWS rows) and Phi (32 rows), staged in
// registers: lane l of warp w loads element k0 + 32q + l of rows w + 8i.
template <int ROWS, int BK>
struct Slab {
  static constexpr int KQ = BK / 32;
  float xr[(ROWS / 8) * KQ], pr[4 * KQ];

  __device__ __forceinline__ void load(const float* __restrict__ x,
                                       const float* __restrict__ phi, int n,
                                       int s, int d, int row0, int col0,
                                       int k0, int lane, int warp) {
#pragma unroll
    for (int q = 0; q < KQ; ++q) {
      const int gk = k0 + 32 * q + lane;
      const bool kin = gk < d;
#pragma unroll
      for (int i = 0; i < ROWS / 8; ++i) {
        const int gr = row0 + warp + 8 * i;
        xr[q * (ROWS / 8) + i] =
            (kin && gr < n) ? x[static_cast<size_t>(gr) * d + gk] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gc = col0 + warp + 8 * i;
        pr[q * 4 + i] =
            (kin && gc < s) ? phi[static_cast<size_t>(gc) * d + gk] : 0.f;
      }
    }
  }

  __device__ __forceinline__ void store(float (*xs)[ROWS + kPad],
                                        float (*ps)[33], int lane,
                                        int warp) const {
#pragma unroll
    for (int q = 0; q < KQ; ++q) {
#pragma unroll
      for (int i = 0; i < ROWS / 8; ++i)
        xs[32 * q + lane][warp + 8 * i] = xr[q * (ROWS / 8) + i];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ps[32 * q + lane][warp + 8 * i] = pr[q * 4 + i];
    }
  }
};

// y is f32 (n, S) for the residual modes and uint32 words (n, S/32) for
// the packed residual; out is f32, uint32 words, or the two word planes.
template <int MODE>
__device__ __forceinline__ void epilogue(float v, int r, int c, int n, int s,
                                         const void* __restrict__ y,
                                         void* __restrict__ out, int lane) {
  if (MODE == kPack || MODE == kPackSignResidual) {
    // all 32 lanes vote; S % 32 == 0, so a word is all in or all out
    const uint32_t bits = __ballot_sync(0xffffffffu, v >= 0.f);
    if (lane != 0 || r >= n || c >= s) return;
    const size_t w = static_cast<size_t>(r) * (s / 32) + c / 32;
    uint32_t* words = static_cast<uint32_t*>(out);
    if (MODE == kPack) {
      words[w] = bits;
    } else {
      const uint32_t yw = static_cast<const uint32_t*>(y)[w];
      words[w] = yw & ~bits;                                  // plus
      words[static_cast<size_t>(n) * (s / 32) + w] = bits & ~yw;  // minus
    }
    return;
  }
  if (r >= n || c >= s) return;
  const size_t idx = static_cast<size_t>(r) * s + c;
  const float* yf = static_cast<const float*>(y);
  const float sgn = v >= 0.f ? 1.f : -1.f;
  float o;
  if (MODE == kNone) o = v;
  else if (MODE == kSign) o = sgn;
  else if (MODE == kSignResidual) o = yf[idx] - sgn;
  else o = yf[idx] - v;
  static_cast<float*>(out)[idx] = o;
}

// Block (x, y, z) owns S columns [32x, 32x + 32), rows [ROWS y, ROWS y +
// ROWS) and the z-th BK-aligned segment of D; clusters of SPLIT blocks
// along z.
template <int ROWS, int BK, int SPLIT, int MODE>
__global__ void __launch_bounds__(kThreads)
cs_project_kernel(const float* __restrict__ x, const float* __restrict__ phi,
                  const void* __restrict__ y, void* __restrict__ out, int n,
                  int s, int d) {
  constexpr int KW = BK / 8;     // slab depth per warp
  constexpr int RPT = ROWS / 8;  // rows a thread finishes
  constexpr int XS = BK * (ROWS + kPad), PS = BK * 33, RED = 8 * ROWS * 33;
  // the slab buffers and the warp partials are never live together
  __shared__ __align__(16) float smem[XS + PS > RED ? XS + PS : RED];
  auto xs = reinterpret_cast<float (*)[ROWS + kPad]>(smem);
  auto ps = reinterpret_cast<float (*)[33]>(smem + XS);
  auto red = reinterpret_cast<float (*)[ROWS][33]>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.y * ROWS, col0 = blockIdx.x * 32;
  const int seg = ((d + BK - 1) / BK + SPLIT - 1) / SPLIT * BK;
  const int k_begin = blockIdx.z * seg;
  const int k_end = min(d, k_begin + seg);

  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;

  Slab<ROWS, BK> slab;
  if (k_begin < k_end)
    slab.load(x, phi, n, s, d, row0, col0, k_begin, lane, warp);
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    slab.store(xs, ps, lane, warp);
    __syncthreads();
    // the next slab's loads fly while this one is multiplied
    if (k0 + BK < k_end)
      slab.load(x, phi, n, s, d, row0, col0, k0 + BK, lane, warp);
#pragma unroll 4
    for (int t = 0; t < KW; ++t) {
      const int kk = warp * KW + t;
      float a[ROWS];
      column_tile::load_rows<ROWS>(&xs[kk][0], a);
      const float b = ps[kk][lane];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(a[r], b, acc[r]);
    }
    __syncthreads();
  }

  float v[RPT];
  if (!column_tile::reduce_partials<ROWS, SPLIT>(acc, red, v, warp, lane))
    return;
#pragma unroll
  for (int i = 0; i < RPT; ++i)
    epilogue<MODE>(v[i], row0 + RPT * warp + i, col0 + lane, n, s, y, out,
                   lane);
}

template <int ROWS, int BK, int SPLIT, int MODE>
cudaError_t launch_mode(const float* x, const float* phi, const void* y,
                        void* out, int n, int s, int d, cudaStream_t st) {
  return column_tile::launch_clusters(
      cs_project_kernel<ROWS, BK, SPLIT, MODE>,
      dim3((s + 31) / 32, (n + ROWS - 1) / ROWS, SPLIT), SPLIT, st, x, phi,
      y, out, n, s, d);
}

template <int MODE>
cudaError_t launch_rows(const float* x, const float* phi, const void* y,
                        void* out, int n, int s, int d, cudaStream_t st) {
  return n <= 16
      ? launch_mode<16, 128, 8, MODE>(x, phi, y, out, n, s, d, st)
      : launch_mode<32, 128, 2, MODE>(x, phi, y, out, n, s, d, st);
}

cudaError_t launch(const float* x, const float* phi, const float* y,
                   void* out, int n, int s, int d, int mode,
                   cudaStream_t st) {
  switch (mode) {
    case kNone:
      return launch_rows<kNone>(x, phi, y, out, n, s, d, st);
    case kSign:
      return launch_rows<kSign>(x, phi, y, out, n, s, d, st);
    case kPack:
      return launch_rows<kPack>(x, phi, y, out, n, s, d, st);
    case kSignResidual:
      return launch_rows<kSignResidual>(x, phi, y, out, n, s, d, st);
    case kResidual:
      return launch_rows<kResidual>(x, phi, y, out, n, s, d, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (n, d), phi: (s, d), y: (n, s) or null, all f32 row-major. out is
// (n, s) f32, or (n, s/32) uint32 words for mode pack (s % 32 == 0).
extern "C" int cs_project_f32(const float* x, const float* phi,
                              const float* y, void* out, int n, int s, int d,
                              int mode, void* stream) {
  return static_cast<int>(launch(x, phi, y, out, n, s, d, mode,
                                 static_cast<cudaStream_t>(stream)));
}

// x: (n, d), phi: (s, d) f32 row-major; y: (n, s/32) uint32 words of the
// packed +-1 measurements; planes: (2, n, s/32) uint32, plus then minus.
extern "C" int cs_project_pack_resid_f32(const float* x, const float* phi,
                                         const uint32_t* y, uint32_t* planes,
                                         int n, int s, int d, void* stream) {
  if (s % 32) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_rows<kPackSignResidual>(
      x, phi, y, planes, n, s, d, static_cast<cudaStream_t>(stream)));
}
