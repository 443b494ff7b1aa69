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
// Accumulation is f32 FMA on the CUDA cores. The epilogue is written as
// __fadd_rn(x, __fmul_rn(tau, acc)) so that nvcc cannot contract it into
// an FMA: the plain version rounds the product before the add.
//
// Each body is one template over how the residual is read (DenseResid for
// K4, PackedResid for K6) and nothing else differs: the packed values are
// exact floats summed in the same order, so K6 on the planes equals K4 on
// 2 (plus - minus) bit for bit. Two bodies, chosen by n:
//
// n <= 16, the streamed body (K4 and K6 in the decode, n = 13, S = 1024,
// D = 4096): bound by bytes, the 16.8 MB Phi read once for 0.11 GFLOP,
// 5 us of traffic against 1.6 us of f32 work. It replaces the column
// layout of column_tile.cuh, whose 512 blocks each walked two 128-deep
// slabs of S behind one register step of prefetch, read Phi as 4-byte
// loads and, in K6, loaded both plane words for every residual element.
// Here a block of 256 threads owns 32 D columns and walks all of S, so
// no cluster and no cross-block sum is needed: D/32 = 128 blocks, one
// wave on 132 SMs (clusters of 4 reach at most 120 SMs). Phi streams through
// a 4-stage ring of 128 S-rows x 32 columns (16 KB a stage, 48 KB in
// flight) filled by 16-byte cp.async copies, a warp's copy being 4 whole
// 128-byte row segments. Before the first stage is waited for, the block
// expands up to 1024 residual rows into shared memory as f32 [S][16] (K4
// copies them; K6 loads one plane word a lane and hands the bits out by
// shuffles), and the owners of the output load their x, so the inner loop
// is the same instructions for both kernels. A thread holds 16 rows x 4
// consecutive columns: per S-row a float4 of Phi, 4 float4 of R and 64
// FMAs; the 32 groups of 8 threads take S-rows g, g + 32, .. of a stage.
// The groups' partial tiles meet in shared memory, summed in group order
// (deterministic). Needs D % 4 == 0 and 16-byte aligned rows of x and Phi.
//
// n > 16, the column layout of column_tile.cuh (not on the main path): a
// block owns 32 D columns and 32 rows, a thread one column and all 32
// rows, the 8 warps split each 128-deep slab of S staged in registers one
// step ahead, and S is split over a cluster of 2.
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
      dim3((d + 31) / 32, (n + ROWS - 1) / ROWS, SPLIT), kThreads, SPLIT, 0,
      st, x, r, phi, out, n, s, d, tau);
}

// ---- n <= 16: the streamed body (see the note at the top) ---------------
namespace streamed {

constexpr int kRows = 16;             // rows held, n <= 16
constexpr int kBD = 32;               // D columns of a block: 8 float4
constexpr int kBS = 128;              // S-rows of a ring stage
constexpr int kStages = 4;
constexpr int kStage = kBS * kBD;     // floats of a stage, 16 KB
constexpr int kGroups = kThreads / (kBD / 4);  // 32 S-row groups
constexpr int kWinPer = 4;            // residual rows a thread expands
constexpr int kWin = kWinPer * kThreads;  // S-rows of residual held
constexpr int kRLD = kRows + 4;       // residual row stride: conflict-free
constexpr int kOut = kRows * kBD / 4; // output float4 of a block: 128
constexpr int kSmemBytes = 4 * (kStages * kStage + kWin * kRLD);
static_assert(kBS % kGroups == 0 && kWin % kBS == 0 &&
              kGroups * kRows * kBD <= kStages * kStage && kOut <= kThreads,
              "tile shape");

// Stage <- Phi rows [k0, k0 + kBS) x columns [col0, col0 + kBD); zeros
// past s and d (d % 4 == 0, so a 16-byte chunk is all in or all out).
__device__ __forceinline__ void load_stage(float* stage,
                                           const float* __restrict__ phi,
                                           int s, int d, int col0, int k0) {
#pragma unroll
  for (int c = 0; c < kStage / 4 / kThreads; ++c) {
    const int id = threadIdx.x + c * kThreads;
    const int row = id / (kBD / 4), q = id % (kBD / 4);
    const int gs = k0 + row, gc = col0 + 4 * q;
    const bool in = gs < s && gc < d;
    column_tile::cp_async16(stage + row * kBD + 4 * q,
                            in ? phi + static_cast<size_t>(gs) * d + gc
                               : phi,
                            in ? 16 : 0);
  }
}

// Window rows w0 + threadIdx.x + j kThreads (j < J) of K4's R, as f32
// rows of kRows, zeros past n and s: every load is made, from a clamped
// address, so that all J * kRows of them fly together; then they are
// stored.
template <int J>
__device__ __forceinline__ void expand_rows(float* rs, const DenseResid& r,
                                            int n, int s, int w0, int j0) {
  float v[J][kRows];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int gs = w0 + threadIdx.x + (j0 + j) * kThreads;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float e = r(min(i, n - 1), min(gs, s - 1), s);
      v[j][i] = (i < n && gs < s) ? e : 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int i = 0; i < kRows; i += 4)
      *reinterpret_cast<float4*>(
          rs + (threadIdx.x + (j0 + j) * kThreads) * kRLD + i) =
          make_float4(v[j][i], v[j][i + 1], v[j][i + 2], v[j][i + 3]);
}

// K6's rows: a warp's 32 S-rows share one word of each plane and row, so
// lane l loads the word of row l % 16 from plane l / 16 (one load a lane)
// and the bits reach their rows' lanes by shuffles. The values are K4's
// 2 (plus - minus), bit for bit.
template <int J>
__device__ __forceinline__ void expand_rows(float* rs, const PackedResid& r,
                                            int n, int s, int w0, int j0) {
  const int lane = threadIdx.x & 31, row = lane % kRows;
  uint32_t word[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int gs0 = w0 + (threadIdx.x & ~31) + (j0 + j) * kThreads;
    const uint32_t* plane = lane < kRows ? r.plus : r.minus;
    word[j] = row < n && gs0 < s
                  ? __ldg(plane + static_cast<size_t>(row) * (s / 32) +
                          gs0 / 32)
                  : 0u;
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    float v[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const uint32_t p = __shfl_sync(0xffffffffu, word[j], i);
      const uint32_t m = __shfl_sync(0xffffffffu, word[j], kRows + i);
      v[i] = static_cast<float>(
          2 * (static_cast<int>((p >> lane) & 1) -
               static_cast<int>((m >> lane) & 1)));
    }
#pragma unroll
    for (int i = 0; i < kRows; i += 4)
      *reinterpret_cast<float4*>(
          rs + (threadIdx.x + (j0 + j) * kThreads) * kRLD + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  }
}

template <class Resid>
__global__ void __launch_bounds__(kThreads, 1)
backproject_stream_kernel(const float* __restrict__ x, const Resid r,
                          const float* __restrict__ phi,
                          float* __restrict__ out, int n, int s, int d,
                          float tau) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                       // [kStages][kBS][kBD]
  float* rs = smem + kStages * kStage;      // [kWin][kRLD] residual window
  const int col0 = blockIdx.x * kBD;
  const int c4 = threadIdx.x % (kBD / 4);   // float4 column of the thread
  const int grp = threadIdx.x / (kBD / 4);  // S-rows grp, grp + kGroups, ..
  const int nkt = (s + kBS - 1) / kBS;

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < nkt) load_stage(ring + t * kStage, phi, s, d, col0, t * kBS);
    column_tile::cp_async_commit();
  }
  // the epilogue's x, loaded while the first copies fly
  const int orow = threadIdx.x / (kBD / 4), ocol = col0 + 4 * c4;
  const bool owner = threadIdx.x < kOut && orow < n && ocol < d;
  const size_t oat = static_cast<size_t>(orow) * d + ocol;
  const float4 xv = owner ? *reinterpret_cast<const float4*>(x + oat)
                          : make_float4(0.f, 0.f, 0.f, 0.f);

  // the first window of residual rows, expanded to f32 while the first
  // Phi copies fly
  if (s > 0) expand_rows<kWinPer>(rs, r, n, s, 0, 0);

  float4 acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int kt = 0; kt < nkt; ++kt) {
    const int wo = kt * kBS % kWin;  // stage's first row in the window
    if (wo == 0 && kt) {
      // S > kWin: the next window, once nobody reads the last
      __syncthreads();
#pragma unroll 1
      for (int j = 0; j < kWinPer; ++j)
        expand_rows<1>(rs, r, n, s, kt * kBS, j);
    }
    column_tile::cp_async_wait<kStages - 2>();
    // stage kt (and the window) is visible to all, and stage kt - 1,
    // which the next copies overwrite, is no longer read
    __syncthreads();
    const int nt = kt + kStages - 1;
    if (nt < nkt)
      load_stage(ring + (nt % kStages) * kStage, phi, s, d, col0, nt * kBS);
    column_tile::cp_async_commit();

    const float* ps = ring + (kt % kStages) * kStage;
#pragma unroll
    for (int m = 0; m < kBS / kGroups; ++m) {
      const int sl = grp + kGroups * m;
      const float4 b =
          *reinterpret_cast<const float4*>(ps + sl * kBD + 4 * c4);
      float a[kRows];
      column_tile::load_rows<kRows>(rs + (wo + sl) * kRLD, a);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        acc[i].x = fmaf(a[i], b.x, acc[i].x);
        acc[i].y = fmaf(a[i], b.y, acc[i].y);
        acc[i].z = fmaf(a[i], b.z, acc[i].z);
        acc[i].w = fmaf(a[i], b.w, acc[i].w);
      }
    }
  }
  column_tile::cp_async_wait<0>();
  __syncthreads();  // the ring is free

  // the groups' partial tiles, summed in group order by the output owners
  float4* red = reinterpret_cast<float4*>(ring);  // [kGroups][kRows][8]
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    red[(grp * kRows + i) * (kBD / 4) + c4] = acc[i];
  __syncthreads();
  if (!owner) return;
  float4 v = red[threadIdx.x];
#pragma unroll 8
  for (int g = 1; g < kGroups; ++g) {
    const float4 o = red[g * kOut + threadIdx.x];
    v.x += o.x; v.y += o.y; v.z += o.z; v.w += o.w;
  }
  *reinterpret_cast<float4*>(out + oat) = make_float4(
      __fadd_rn(xv.x, __fmul_rn(tau, v.x)),
      __fadd_rn(xv.y, __fmul_rn(tau, v.y)),
      __fadd_rn(xv.z, __fmul_rn(tau, v.z)),
      __fadd_rn(xv.w, __fmul_rn(tau, v.w)));
}

template <class Resid>
cudaError_t launch(const float* x, Resid r, const float* phi, float* out,
                   int n, int s, int d, float tau, cudaStream_t st) {
  static std::atomic<uint64_t> smem_set{0};
  if (d % 4) return cudaErrorInvalidValue;
  const cudaError_t e = column_tile::allow_smem(
      backproject_stream_kernel<Resid>, kSmemBytes, smem_set);
  if (e != cudaSuccess) return e;
  backproject_stream_kernel<Resid>
      <<<(d + kBD - 1) / kBD, kThreads, kSmemBytes, st>>>(x, r, phi, out, n,
                                                          s, d, tau);
  return cudaGetLastError();
}

}  // namespace streamed

template <class Resid>
cudaError_t launch_rows(const float* x, Resid r, const float* phi,
                        float* out, int n, int s, int d, float tau,
                        void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return n <= 16 ? streamed::launch(x, r, phi, out, n, s, d, tau, st)
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
