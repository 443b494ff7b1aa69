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
// TF32 tensor cores would flip signs near zero. Every mode at a given n
// runs the same accumulation, so pack equals sign and K5's signs are K3's
// bit for bit. Two bodies, chosen by n:
//
// n > 16, the register-blocked body (K2 at the compression shape n = 130,
// S = 1024, D = 4096: 1.09 GFLOP on ~19 MB, 16 us of f32 work against 6 us
// of traffic, so bound by operations). It replaces the column layout of
// column_tile.cuh, which ran at 18% of the f32 rate: 32-row tiles padded
// 130 rows to 160, a thread read 9 shared loads per 32 FMAs, the
// transposed staging stores had 4-way bank conflicts, and the pipeline was
// one register step deep. Here a block of 512 threads owns 144 rows x 64
// columns (130 rows pad to 144, 10%) as two k-groups of 256 threads, each
// taking half of every 64-deep stage of D. A thread owns 9 rows x 4
// columns (rows tr + 16i, columns tc + 16j) and per 4-deep step reads
// 9 + 4 float4 from shared memory for 144 FMAs, the next step's fragments
// loaded while this step's are multiplied; a warp's loads hit 8 distinct
// 16-byte bank groups (row stride 68 floats). X and Phi stay D-contiguous
// in shared memory, filled by 16-byte cp.async copies into a 3-stage ring,
// one barrier a stage. D is split over a cluster of 6 blocks: 16 column
// tiles x 6 = 96 blocks, one wave. (Clusters of 4 to 8 blocks reach at
// most 120 of the 132 SMs on the H100, so 16 clusters of 8 ran in two
// waves: tools/cluster_occupancy.py.)
// k-group 1 hands its partial tile to k-group 0 through shared memory;
// then rank q sums rows [24q, 24q + 24) of the 6 ranks' tiles through
// distributed shared memory in rank order (deterministic) and runs the
// epilogue on them. Needs D % 4 == 0 and 16-byte aligned rows. What still
// bounds it is FMA issue: about half the f32 rate of its 96 SMs, with or
// without the global copies and with a quarter of the shared loads alike.
//
// n <= 16, the column layout of column_tile.cuh (K3 and K5 in the decode,
// n = 13: 0.11 GFLOP on the 16.8 MB Phi, bound by bytes, 5 us). A block
// owns 32 S columns and 16 rows, a thread one column and all 16 rows; the
// 8 warps split each 128-deep slab of D, staged in registers one step
// ahead, and D is split over a cluster of 8. Lane i of a warp holds S
// column 32j + i, so the pack epilogue is one __ballot_sync per word.
//
// Neither body writes the dense projection in the sign, pack and residual
// modes.
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
      dim3((s + 31) / 32, (n + ROWS - 1) / ROWS, SPLIT), kThreads, SPLIT, 0,
      st, x, phi, y, out, n, s, d);
}

// ---- n > 16: the register-blocked body (see the note at the top) --------
namespace wide {

constexpr int kR = 9, kC = 4;      // a thread's rows and columns
constexpr int kTR = 16, kTC = 16;  // threads of a k-group along rows, columns
constexpr int kGroup = kTR * kTC;  // 256 threads: one k-group
constexpr int kKGroups = 2;        // k-groups of a block, 16 warps in all
constexpr int kBlock = kKGroups * kGroup;
constexpr int kBM = kTR * kR;      // 144 rows of a block
constexpr int kBN = kTC * kC;      // 64 columns of a block
constexpr int kBKG = 32;           // D depth of a stage for one k-group
constexpr int kBK = kKGroups * kBKG;  // D depth of a ring stage
constexpr int kLD = kBK + 4;       // smem row stride: 16-byte groups r % 8
constexpr int kStages = 3;
constexpr int kSplit = 6;          // cluster along z, D split 6 ways
constexpr int kStage = (kBM + kBN) * kLD;  // floats of a stage
constexpr int kRedLD = kBN + 4;    // partial tile row stride
constexpr int kSliceRows = kBM / kSplit;   // rows a rank finishes: 24
constexpr int kSmemBytes = 4 * (kStages * kStage > 2 * kBM * kRedLD
                                    ? kStages * kStage
                                    : 2 * kBM * kRedLD);
static_assert(kBM % kSplit == 0 && kBN % 32 == 0, "tile shape");

// Stage <- D columns [k0, k0 + kBK) of X rows row0.. (smem rows 0..kBM)
// and Phi rows col0.. (smem rows kBM..kBM + kBN); zeros past n, s and d
// (d % 4 == 0, so a 16-byte chunk is all in or all out).
__device__ __forceinline__ void load_stage(float* stage,
                                           const float* __restrict__ x,
                                           const float* __restrict__ phi,
                                           int n, int s, int d, int row0,
                                           int col0, int k0) {
  constexpr int kChunks = (kBM + kBN) * (kBK / 4);
#pragma unroll
  for (int c = 0; c < (kChunks + kBlock - 1) / kBlock; ++c) {
    const int id = threadIdx.x + c * kBlock;
    if (kChunks % kBlock && id >= kChunks) break;
    const int r = id / (kBK / 4), q = id % (kBK / 4);
    const int gk = k0 + 4 * q;
    const bool x_row = r < kBM;
    const int g = x_row ? row0 + r : col0 + r - kBM;
    const bool in = gk < d && g < (x_row ? n : s);
    const float* src = (x_row ? x : phi) + static_cast<size_t>(g) * d + gk;
    column_tile::cp_async16(stage + r * kLD + 4 * q, in ? src : x,
                            in ? 16 : 0);
  }
}

template <int MODE>
__global__ void __launch_bounds__(kBlock, 1)
cs_project_wide_kernel(const float* __restrict__ x,
                       const float* __restrict__ phi,
                       const void* __restrict__ y, void* __restrict__ out,
                       int n, int s, int d) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // k-group kg takes D columns [32 kg, 32 kg + 32) of every stage; in it a
  // warp is 8 row threads x 4 column threads, so its fragment loads hit 8
  // distinct 16-byte bank groups (X) and 4 (Phi)
  const int kg = warp / (kGroup / 32), gw = warp % (kGroup / 32);
  const int tr = (gw & 1) * 8 + (lane >> 2);
  const int tc = (gw >> 1) * 4 + (lane & 3);
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  const int seg = ((d + kBK - 1) / kBK + kSplit - 1) / kSplit * kBK;
  const int k_begin = blockIdx.z * seg;
  const int nkt = (max(0, min(d, k_begin + seg) - k_begin) + kBK - 1) / kBK;

  float acc[kR][kC];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kC; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < nkt)
      load_stage(smem + t * kStage, x, phi, n, s, d, row0, col0,
                 k_begin + t * kBK);
    column_tile::cp_async_commit();
  }
  for (int kt = 0; kt < nkt; ++kt) {
    column_tile::cp_async_wait<kStages - 2>();
    // stage kt has landed for every thread, and stage kt - 1, which the
    // next copies overwrite, is no longer read
    __syncthreads();
    const int nt = kt + kStages - 1;
    if (nt < nkt)
      load_stage(smem + (nt % kStages) * kStage, x, phi, n, s, d, row0,
                 col0, k_begin + nt * kBK);
    column_tile::cp_async_commit();

    const float* xs = smem + (kt % kStages) * kStage + kg * kBKG;
    const float* ps = xs + kBM * kLD;
    float4 a[2][kR], b[2][kC];
    auto load_frag = [&](int buf, int kk) {
#pragma unroll
      for (int i = 0; i < kR; ++i)
        a[buf][i] = *reinterpret_cast<const float4*>(
            xs + (tr + kTR * i) * kLD + 4 * kk);
#pragma unroll
      for (int j = 0; j < kC; ++j)
        b[buf][j] = *reinterpret_cast<const float4*>(
            ps + (tc + kTC * j) * kLD + 4 * kk);
    };
    load_frag(0, 0);
#pragma unroll
    for (int kk = 0; kk < kBKG / 4; ++kk) {
      const int cur = kk & 1;
      if (kk + 1 < kBKG / 4) load_frag(cur ^ 1, kk + 1);
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kC; ++j) {
          float v = acc[i][j];
          v = fmaf(a[cur][i].x, b[cur][j].x, v);
          v = fmaf(a[cur][i].y, b[cur][j].y, v);
          v = fmaf(a[cur][i].z, b[cur][j].z, v);
          acc[i][j] = fmaf(a[cur][i].w, b[cur][j].w, v);
        }
    }
  }
  column_tile::cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the partial tiles now

  // k-group 1 hands its sums to k-group 0, which adds them to its own:
  // the block's partial tile, a warp's stores hitting 32 banks
  float* part = smem;                  // [kBM][kRedLD]
  float* half = smem + kBM * kRedLD;   // k-group 1's, same layout
  if (kg == 1) {
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kC; ++j)
        half[(tr + kTR * i) * kRedLD + tc + kTC * j] = acc[i][j];
  }
  __syncthreads();
  if (kg == 0) {
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const int at = (tr + kTR * i) * kRedLD + tc + kTC * j;
        part[at] = acc[i][j] + half[at];
      }
  }
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  cluster.sync();  // every rank's partial tile is written

  // rank q finishes rows [q kSliceRows, (q + 1) kSliceRows): a warp takes
  // one 32-column half row at a time, lane = S column % 32
  const int q = static_cast<int>(cluster.block_rank());
  const float* parts[kSplit];
#pragma unroll
  for (int p = 0; p < kSplit; ++p) parts[p] = cluster.map_shared_rank(part, p);
  for (int h = warp; h < kSliceRows * (kBN / 32); h += kBlock / 32) {
    const int lr = q * kSliceRows + h / (kBN / 32);
    const int lc = (h % (kBN / 32)) * 32 + lane;
    float v = parts[0][lr * kRedLD + lc];
#pragma unroll
    for (int p = 1; p < kSplit; ++p) v += parts[p][lr * kRedLD + lc];
    epilogue<MODE>(v, row0 + lr, col0 + lc, n, s, y, out, lane);
  }
  cluster.sync();  // no rank leaves while another reads its tile
}

template <int MODE>
cudaError_t launch(const float* x, const float* phi, const void* y,
                   void* out, int n, int s, int d, cudaStream_t st) {
  static std::atomic<uint64_t> smem_set{0};
  if (d % 4) return cudaErrorInvalidValue;
  const cudaError_t e = column_tile::allow_smem(
      cs_project_wide_kernel<MODE>, kSmemBytes, smem_set);
  if (e != cudaSuccess) return e;
  return column_tile::launch_clusters(
      cs_project_wide_kernel<MODE>,
      dim3((s + kBN - 1) / kBN, (n + kBM - 1) / kBM, kSplit), kBlock, kSplit,
      kSmemBytes, st, x, phi, y, out, n, s, d);
}

}  // namespace wide

template <int MODE>
cudaError_t launch_rows(const float* x, const float* phi, const void* y,
                        void* out, int n, int s, int d, cudaStream_t st) {
  return n <= 16
      ? launch_mode<16, 128, 8, MODE>(x, phi, y, out, n, s, d, st)
      : wide::launch<MODE>(x, phi, y, out, n, s, d, st);
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
