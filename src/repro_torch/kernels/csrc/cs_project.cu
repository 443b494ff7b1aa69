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
// bit for bit. Every sum meets in a fixed order, with no float atomics, so
// a second launch or a CUDA graph replay gives the same bits. Both bodies
// read 16-byte pieces of rows: they need D % 4 == 0 and 16-byte aligned
// rows of X and Phi (the wrapper raises otherwise). Two bodies, chosen by n:
//
// n <= 16, the streamed body (K3 and K5 in the decode, and K2 at the
// decode's size: n = 13, S = 1024, D = 4096, 0.11 GFLOP on the 16.8 MB
// Phi, bound by bytes, 5 us at the HBM rate). A block of 256 threads owns
// 32 S rows of Phi (one packed word of every output row) and one of
// `split` equal ranges of D, so the grid is S/32 tiles x split, sized to
// the SMs: 32 x 4 = 128 blocks, one wave, no cluster (clusters of 4 do
// not reach every SM). Phi's 32 rows and X's 16 rows of a 128-deep stage
// of D stream through a 4-stage ring (24 KB a stage) filled by 16-byte
// cp.async copies, a warp copying one whole 512-byte row segment at a
// time, so Phi is read once and X once per S tile (6.8 MB from L2 at the
// decode's shape). Lane l of warp w holds D columns 4l..4l+3 of every
// stage for S rows 4w..4w+3 and all 16 X rows: per stage 4 + 16 float4
// shared loads (consecutive lanes, consecutive 16 bytes) feed 256 FMAs.
// The 32 lanes' partial sums meet in a fixed butterfly of shuffles (62 a
// lane), which leaves each lane two finished sums. The D ranges meet at a
// fixed finisher, the tile's range-0 block: the others store each sum as
// a 64-bit word with a ready mark in its high half (g_parts, one buffer
// on the device), the finisher polls those words, adds the ranges in
// index order, clears the marks and runs the epilogue (a warp per output
// row, lane = S column, so the pack ballot is one __ballot_sync a word).
// A ticket counter cost a fence and an atomic round trip after the last
// block's sums; the marked words cost one load. Launches that share a
// device must not overlap (they share g_parts); the decode's run one
// after another on one stream.
//
// n > 16, the register-blocked body (K2 at the compression shape n = 130,
// S = 1024, D = 4096: 1.09 GFLOP on ~19 MB, 16 us of f32 work against 6 us
// of traffic, so bound by operations). A block of 512 threads owns 144
// rows x 64 columns (130 rows pad to 144, 10%) as two k-groups of 256
// threads, each taking half of every 64-deep stage of D. A thread owns 9
// rows x 4 columns (rows tr + 16i, columns tc + 16j) and per 4-deep step
// reads 9 + 4 float4 from shared memory for 144 FMAs, the next step's
// fragments loaded while this step's are multiplied; a warp's loads hit 8
// distinct 16-byte bank groups (row stride 68 floats). X and Phi stay
// D-contiguous in shared memory, filled by 16-byte cp.async copies into a
// 3-stage ring, one barrier a stage. D is split over a cluster of 6
// blocks: 16 column tiles x 6 = 96 blocks, one wave. (Clusters of 4 to 8
// blocks reach at most 120 of the 132 SMs on the H100, so 16 clusters of
// 8 ran in two waves: tools/cluster_occupancy.py.)
// k-group 1 hands its partial tile to k-group 0 through shared memory;
// then rank q sums rows [24q, 24q + 24) of the 6 ranks' tiles through
// distributed shared memory in rank order (deterministic) and runs the
// epilogue on them. What still bounds it is FMA issue: about half the f32
// rate of its 96 SMs, with or without the global copies and with a
// quarter of the shared loads alike.
//
// Neither body writes the dense projection in the sign, pack and residual
// modes.
#include <algorithm>
#include <cuda_runtime.h>
#include <stdint.h>

#include "column_tile.cuh"

namespace {

enum Mode { kNone = 0, kSign = 1, kPack = 2, kSignResidual = 3,
            kResidual = 4, kPackSignResidual = 5 };

// What the epilogue of output (r, c) reads of y, as bits: the f32 y[r][c]
// for the residual modes, the packed word of (r, c) for the packed one
// (its 32 lanes load the same word), nothing for the others.
template <int MODE>
__device__ __forceinline__ uint32_t load_y(const void* __restrict__ y, int r,
                                           int c, int n, int s) {
  if (r >= n || c >= s) return 0u;
  if (MODE == kPackSignResidual)
    return static_cast<const uint32_t*>(y)[static_cast<size_t>(r) * (s / 32) +
                                           c / 32];
  if (MODE == kSignResidual || MODE == kResidual)
    return __float_as_uint(
        static_cast<const float*>(y)[static_cast<size_t>(r) * s + c]);
  return 0u;
}

// Output (r, c) from its sum v and load_y's yv; out is f32, uint32 words,
// or the two word planes.
template <int MODE>
__device__ __forceinline__ void epilogue(float v, int r, int c, int n, int s,
                                         uint32_t yv, void* __restrict__ out,
                                         int lane) {
  if (MODE == kPack || MODE == kPackSignResidual) {
    // all 32 lanes vote; S % 32 == 0, so a word is all in or all out
    const uint32_t bits = __ballot_sync(0xffffffffu, v >= 0.f);
    if (lane != 0 || r >= n || c >= s) return;
    const size_t w = static_cast<size_t>(r) * (s / 32) + c / 32;
    uint32_t* words = static_cast<uint32_t*>(out);
    if (MODE == kPack) {
      words[w] = bits;
    } else {
      words[w] = yv & ~bits;                                  // plus
      words[static_cast<size_t>(n) * (s / 32) + w] = bits & ~yv;  // minus
    }
    return;
  }
  if (r >= n || c >= s) return;
  const float yf = __uint_as_float(yv);
  const float sgn = v >= 0.f ? 1.f : -1.f;
  float o;
  if (MODE == kNone) o = v;
  else if (MODE == kSign) o = sgn;
  else if (MODE == kSignResidual) o = yf - sgn;
  else o = yf - v;
  static_cast<float*>(out)[static_cast<size_t>(r) * s + c] = o;
}

// ---- n <= 16: the streamed body (see the note at the top) ---------------
namespace streamed {

constexpr int kRows = 16;             // X rows held, n <= 16
constexpr int kBS = 32;               // S rows of a block: one packed word
constexpr int kBK = 128;              // D depth of a stage: 32 lanes x float4
constexpr int kStages = 4;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSW = kBS / kWarps;     // S rows of a warp: 4
constexpr int kAcc = kSW * kRows;     // sums a lane holds: 64
constexpr int kFin = kAcc / 32;       // finished sums a lane holds: 2
constexpr int kOuts = kRows / kWarps; // output rows a warp finishes: 2
constexpr int kStage = (kBS + kRows) * kBK;  // floats of a stage, 24 KB
constexpr int kSmemBytes = 4 * kStages * kStage;
constexpr int kMaxSplit = 8;          // D ranges of an S tile
constexpr int kMaxBlocks = 256;       // blocks of a launch that split D
constexpr long kSpinLimit = 1L << 25; // polls before a missing tile traps
static_assert(kAcc % 32 == 0 && kRows % kFin == 0 && kRows % kWarps == 0,
              "tile shape");

// Partial sums of the blocks that split D, one 64-bit word each: the f32
// sum in the low half, 1 in the high half once written, 0 once the
// tile's finisher has read it. Zero-initialised with the module, and
// every launch leaves it at 0 again.
__device__ unsigned long long g_parts[kMaxBlocks * kRows * kBS];

// Stage <- D columns [k0, k0 + kBK) of Phi rows col0.. (smem rows 0..kBS)
// and of X rows 0..kRows (smem rows kBS..); zeros past s, n and d
// (d % 4 == 0, so a 16-byte chunk is all in or all out).
__device__ __forceinline__ void load_stage(float* stage,
                                           const float* __restrict__ x,
                                           const float* __restrict__ phi,
                                           int n, int s, int d, int col0,
                                           int k0) {
  constexpr int kChunks = (kBS + kRows) * (kBK / 4);
  static_assert(kChunks % kThreads == 0, "whole copies a thread");
#pragma unroll
  for (int c = 0; c < kChunks / kThreads; ++c) {
    const int id = threadIdx.x + c * kThreads;
    const int row = id / (kBK / 4), q = id % (kBK / 4);
    const int gk = k0 + 4 * q;
    const bool phi_row = row < kBS;
    const int g = phi_row ? col0 + row : row - kBS;
    const bool in = gk < d && g < (phi_row ? s : n);
    const float* src = (phi_row ? phi : x) + static_cast<size_t>(g) * d + gk;
    column_tile::cp_async16(stage + row * kBK + 4 * q, in ? src : phi,
                            in ? 16 : 0);
  }
}

// Sums v over the 32 lanes of the warp by recursive halving: at each step
// a lane keeps half of its M values, sends the other half to lane ^ H and
// adds what it receives. The order is fixed; lane l ends holding the full
// sums of v[kFin l + j] in v[j], j < kFin.
template <int H, int M = kAcc>
__device__ __forceinline__ void halve(float (&v)[kAcc], int lane) {
  const bool up = lane & H;
#pragma unroll
  for (int j = 0; j < M / 2; ++j) {
    const float send = up ? v[j] : v[j + M / 2];
    const float keep = up ? v[j + M / 2] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
  if constexpr (H > 1) halve<H / 2, M / 2>(v, lane);
}

__device__ __forceinline__ unsigned long long load_part(
    const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(w) : "l"(p)
               : "memory");
  return w;
}

__device__ __forceinline__ void store_part(unsigned long long* p,
                                           unsigned long long w) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(w)
               : "memory");
}

// Block (x, y) owns S rows [32x, 32x + 32) and D stages [y seg, y seg +
// seg); block (x, 0) finishes the tile.
template <int MODE>
__global__ void __launch_bounds__(kThreads, 1)
cs_project_stream_kernel(const float* __restrict__ x,
                         const float* __restrict__ phi,
                         const void* __restrict__ y, void* __restrict__ out,
                         int n, int s, int d, int seg) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col0 = blockIdx.x * kBS, cc = col0 + lane;
  const int split = gridDim.y, q0 = blockIdx.y;
  const int kt0 = q0 * seg;
  const int nkt = max(0, min((d + kBK - 1) / kBK - kt0, seg));

  // the finisher's y, loaded before the ring fills: loaded after the sums
  // it would be one more round trip on the kernel's tail. Warp w finishes
  // X rows w + kWarps o, lane = S column.
  uint32_t yv[kOuts];
#pragma unroll
  for (int o = 0; o < kOuts; ++o)
    yv[o] = q0 == 0 ? load_y<MODE>(y, warp + kWarps * o, cc, n, s) : 0u;

  float acc[kAcc];  // acc[j kRows + i]: S row kSW warp + j, X row i
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < nkt)
      load_stage(smem + t * kStage, x, phi, n, s, d, col0, (kt0 + t) * kBK);
    column_tile::cp_async_commit();
  }
  for (int kt = 0; kt < nkt; ++kt) {
    column_tile::cp_async_wait<kStages - 2>();
    // stage kt has landed for every thread, and stage kt - 1, which the
    // next copies overwrite, is no longer read
    __syncthreads();
    const int nt = kt + kStages - 1;
    if (nt < nkt)
      load_stage(smem + (nt % kStages) * kStage, x, phi, n, s, d, col0,
                 (kt0 + nt) * kBK);
    column_tile::cp_async_commit();

    const float* ps = smem + (kt % kStages) * kStage + 4 * lane;
    const float* xs = ps + kBS * kBK;
    float4 b[kSW];
#pragma unroll
    for (int j = 0; j < kSW; ++j)
      b[j] = *reinterpret_cast<const float4*>(ps + (kSW * warp + j) * kBK);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(xs + i * kBK);
#pragma unroll
      for (int j = 0; j < kSW; ++j) {
        float v = acc[j * kRows + i];
        v = fmaf(a.x, b[j].x, v);
        v = fmaf(a.y, b[j].y, v);
        v = fmaf(a.z, b[j].z, v);
        acc[j * kRows + i] = fmaf(a.w, b[j].w, v);
      }
    }
  }
  column_tile::cp_async_wait<0>();

  // the lanes' sums: lane l holds S row kSW warp + kFin l / kRows of the
  // tile for X rows kFin l % kRows + j, j < kFin
  halve<16>(acc, lane);
  const int c = kSW * warp + kFin * lane / kRows;
  unsigned long long* parts =
      g_parts + static_cast<size_t>(blockIdx.x) * split * kRows * kBS;
  if (q0 != 0) {
    // each word carries its own ready mark, so no fence or counter is
    // needed: the finisher polls the words themselves
#pragma unroll
    for (int j = 0; j < kFin; ++j) {
      const int i = kFin * lane % kRows + j;
      store_part(parts + (static_cast<size_t>(q0) * kRows + i) * kBS + c,
                 (1ull << 32) | __float_as_uint(acc[j]));
    }
    return;
  }

  // The finisher: its own sums through shared memory, the other ranges'
  // words polled together, all added in range order.
  __syncthreads();   // the ring is free
  float* own = smem;  // [kRows][kBS]
#pragma unroll
  for (int j = 0; j < kFin; ++j)
    own[(kFin * lane % kRows + j) * kBS + c] = acc[j];
  __syncthreads();
  unsigned long long w[kOuts][kMaxSplit];
#pragma unroll
  for (int o = 0; o < kOuts; ++o)
#pragma unroll
    for (int q = 1; q < kMaxSplit; ++q)
      if (q < split)
        w[o][q] = load_part(
            parts + (static_cast<size_t>(q) * kRows + warp + kWarps * o) *
                        kBS + lane);
#pragma unroll
  for (int o = 0; o < kOuts; ++o) {
    const int i = warp + kWarps * o;
    float v = own[i * kBS + lane];
#pragma unroll
    for (int q = 1; q < kMaxSplit; ++q) {
      if (q >= split) break;
      unsigned long long* p =
          parts + (static_cast<size_t>(q) * kRows + i) * kBS + lane;
      // all ranges run in this one wave, so a word is at most a block's
      // run away; a word that never comes is a fault, not a wait
      for (long spins = 0; (w[o][q] >> 32) != 1ull; w[o][q] = load_part(p))
        if (++spins > kSpinLimit) __trap();
      v += __uint_as_float(static_cast<uint32_t>(w[o][q]));
      store_part(p, 0ull);  // read: ready for the next launch
    }
    epilogue<MODE>(v, i, cc, n, s, yv[o], out, lane);
  }
}

template <int MODE>
cudaError_t launch(const float* x, const float* phi, const void* y,
                   void* out, int n, int s, int d, cudaStream_t st) {
  static std::atomic<uint64_t> smem_set{0};
  if (d % 4 || n > kRows) return cudaErrorInvalidValue;
  const int tiles = (s + kBS - 1) / kBS;
  if (tiles == 0) return cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  // one wave: as many D ranges as leave every block an SM of its own,
  // which also lets the finishers wait for their tiles' other ranges
  const int nkt = std::max(1, (d + kBK - 1) / kBK);
  int want = std::min({kMaxSplit, std::max(1, sms / tiles), nkt});
  if (tiles * want > kMaxBlocks) want = 1;
  const int seg = (nkt + want - 1) / want;
  const int split = (nkt + seg - 1) / seg;  // no empty range
  e = column_tile::allow_smem(cs_project_stream_kernel<MODE>, kSmemBytes,
                              smem_set);
  if (e != cudaSuccess) return e;
  cs_project_stream_kernel<MODE><<<dim3(tiles, split), kThreads, kSmemBytes,
                                   st>>>(x, phi, y, out, n, s, d, seg);
  return cudaGetLastError();
}

}  // namespace streamed

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
    epilogue<MODE>(v, row0 + lr, col0 + lc, n, s,
                   load_y<MODE>(y, row0 + lr, col0 + lc, n, s), out, lane);
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
  return n <= streamed::kRows
      ? streamed::launch<MODE>(x, phi, y, out, n, s, d, st)
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
