// K1 topk_select: per-row top-kappa by |x| (paper eq. 6, and the decode's
// hard threshold eta_kappa): the threshold of 32 rounds of bisection,
// found from two order statistics instead of 33 block-wide counts.
//
// Replaces: src/repro/kernels/topk_select.py:_topk_kernel (pallas_call at
// topk_select.py:58).
//
// What is computed. The Pallas kernel (and topk_select_plain) starts at
// lo = 0, hi = amax = max|x|, and 32 times sets mid = 0.5f * (lo + hi) and
// moves lo up to mid when cnt(mid) > k, else hi down to mid, where
// cnt(t) = #{|x| >= t}. It then selects |x| >= min(hi, amax) if that keeps
// at least k entries, else |x| >= lo.
//
// Why two order statistics decide it. Let v(j) be the j-th largest |x| of
// the row, v(j) = +inf for j <= 0 and v(j) = -inf for j > D. For every t,
// cnt(t) > k  <=>  at least k + 1 entries are >= t  <=>  t <= v(k+1), and
// cnt(t) >= k <=>  t <= v(k). So the whole trajectory of lo and hi is a
// function of amax and v(k+1) alone, and the final test of amax, v(k) and
// hi. The kernel finds v(k+1) and v(k) exactly once and replays the 32 f32
// steps on scalars, op for op (__fadd_rn, __fmul_rn): the threshold, and so
// the mask and the values, equal the plain version's bit for bit, ties,
// rows with fewer than k nonzeros, zeros, -0.0, +inf and subnormals
// included (NaN entries are outside the contract).
//
// Finding v(k+1). Non-negative floats up to +inf order as their bit
// patterns, so a radix select over the 31 bits of |x| finds it. Digits:
// bits 30..20 (the exponent and three mantissa bits, so gradient
// magnitudes of one binade spread over 8 bins), 19..10 and 9..0. A digit
// is one shared-memory histogram of the candidates that still match the
// bits found so far, one barrier, each warp's total of the bins it owns, a
// second barrier; then every warp scans the warps' totals in its lanes and
// the 32 x kBpt bins of the warp that holds the rank itself, so no third
// barrier broadcasts the digit. A warp whose entries all fall in one bin
// (zero padding, ties) adds them with one atomic. The second digit also
// keeps each bin's largest and least key, so where the chosen bin holds
// one or two candidates, v(k+1) is one of those keys and the third digit
// is skipped: on rows of 4096 gradient entries the select ends there (a
// bin of one alone still sent some rows to the third digit, and the
// slowest of 13 rows decides a launch). The rank r left within the
// last bin gives the count of entries strictly above v(k+1), k + 1 - r:
// where it is k, v(k) is the least entry above v(k+1) (one min-reduce, or
// the bin's other key); where it is less, v(k) = v(k+1). One warp replays
// the bisection while the others reduce, and the threshold meets them at
// the last barrier.
//
// Bound on the H100: bytes. A row is read once and its values and int8
// mask written once, 9 bytes an element (13 rows of 4096: 0.14 us at
// 3.35 TB/s). The kernel is bound by latency: one block per row (13 of
// 132 SMs at the decode shape) and its chain of barriers: six on such
// rows (the histograms' clearing, two a digit, the reduce), where a
// block-wide count at every bisection step takes 33. Every reduction
// over the 16 warps' partials runs in one warp's lanes (a shuffle scan
// or one __reduce_*_sync): a loop over them in one thread is a chain of
// 16 dependent shared loads. Rows whose address and length allow it are
// read and written in 16-byte pieces.
// Rows longer than 8192 (32 entries a thread, off the main path) spill
// registers.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kAbs = 0x7fffffffu;
constexpr uint32_t kInfKey = 0x7f800000u;  // bits of +inf
constexpr int kBisect = 32;  // N_BISECT of the Pallas kernel
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// the three digits of a key: low bit, bins, offset of their histogram
__host__ __device__ constexpr int digit_shift(int p) {
  return p == 0 ? 20 : p == 1 ? 10 : 0;
}
__host__ __device__ constexpr int digit_bins(int p) {
  return p == 0 ? 2048 : 1024;
}
__host__ __device__ constexpr int hist_offset(int p) {
  return p == 0 ? 0 : p == 1 ? 2048 : 3072;
}
constexpr int kHist = 4096;    // the three histograms
constexpr int kBinMax = 1024;  // the second digit's bins
// where v(k) comes from once v(k+1) is known
constexpr int kAbove = 0;  // the least key above v(k+1)'s bin
constexpr int kSame = 1;   // v(k+1) itself: fewer than k entries above it
constexpr int kGiven = 2;  // Select::vk_key

// element index of register j of this thread: float4 c = tid + (j/4)*T
// holds elements 4c .. 4c+3 (VEC), else element tid + j*T
template <bool VEC>
__device__ __forceinline__ int elem(int j) {
  return VEC ? 4 * (static_cast<int>(threadIdx.x) + (j >> 2) * kThreads) +
                   (j & 3)
             : static_cast<int>(threadIdx.x) + j * kThreads;
}

__device__ __forceinline__ uint32_t key_of(float v) {
  return __float_as_uint(v) & kAbs;
}

struct Shared {
  int hist[kHist];
  uint32_t bin_max[kBinMax];    // the second digit's largest key a bin
  uint32_t bin_min[kBinMax];    // and least
  int warp_total[kWarps];
  uint32_t warp_max[kWarps];    // largest key of each warp (amax)
  uint32_t warp_above[kWarps];  // least key above v(k+1) of each warp
  float lo, sel_hi;             // the replayed bisection's end
};

struct Select {
  uint32_t prefix = 0;  // bits of v(k+1) found so far
  uint32_t pmask = 0;   // which bits those are
  int rank;             // rank of v(k+1) among the candidates matching them
  uint32_t key = 0;     // v(k+1) once found
  int vk_from = kAbove;
  uint32_t vk_key = 0;
};

// bins b0 .. b0+N-1 of the histogram in one 16-byte (N = 4, the first
// digit) or 8-byte (N = 2) shared load
template <int N>
__device__ __forceinline__ void load_bins(const int* h, int b0, int (&c)[N]) {
  static_assert(N == 4 || N == 2, "bins a thread owns at 512 threads");
  if constexpr (N == 4) {
    const int4 t = *reinterpret_cast<const int4*>(h + b0);
    c[0] = t.x; c[1] = t.y; c[2] = t.z; c[3] = t.w;
  } else {
    const int2 t = *reinterpret_cast<const int2*>(h + b0);
    c[0] = t.x; c[1] = t.y;
  }
}

// One digit of the radix select over the keys of the candidates (valid
// entries whose bits match s.prefix under s.pmask). Returns true once
// v(k+1) is known: after the second digit if its bin holds one candidate
// (the bin's largest key is then v(k+1)), and after the third always.
template <int P, int VPT, bool VEC>
__device__ __forceinline__ bool radix_pass(const float (&v)[VPT],
                                           uint32_t valid, Select& s,
                                           Shared& sh) {
  constexpr int kBin = digit_bins(P), kBpt = kBin / kThreads;
  constexpr int kLow = digit_shift(P);
  int* h = sh.hist + hist_offset(P);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the bin of each entry, or kFull where it is no candidate
  uint32_t tag[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const uint32_t key = key_of(v[j]);
    const bool cand = (valid >> j & 1u) && (key & s.pmask) == s.prefix;
    tag[j] = cand ? (key >> kLow) & (kBin - 1) : kFull;
  }
  // a warp whose candidates all hold one digit (zero padding, ties) adds
  // them with one atomic
  const uint32_t t0 = __shfl_sync(kFull, tag[0], 0);
  bool same = true;
#pragma unroll
  for (int j = 0; j < VPT; ++j) same = same && tag[j] == t0;
  if (__all_sync(kFull, same)) {
    if constexpr (P == 1) {  // every entry of the warp is a candidate
      uint32_t hi = 0, lo = kFull;
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        hi = max(hi, key_of(v[j]));
        lo = min(lo, key_of(v[j]));
      }
      hi = __reduce_max_sync(kFull, hi);
      lo = __reduce_min_sync(kFull, lo);
      if (lane == 0 && t0 != kFull) {
        atomicMax(&sh.bin_max[t0], hi);
        atomicMin(&sh.bin_min[t0], lo);
      }
    }
    if (lane == 0 && t0 != kFull) atomicAdd(&h[t0], 32 * VPT);
  } else {
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      if (tag[j] != kFull) {
        atomicAdd(&h[tag[j]], 1);
        if constexpr (P == 1) {
          atomicMax(&sh.bin_max[tag[j]], key_of(v[j]));
          atomicMin(&sh.bin_min[tag[j]], key_of(v[j]));
        }
      }
    }
  }
  __syncthreads();
  // thread t owns bins kBin-kBpt*(t+1) .. kBin-kBpt*t-1: descending with t
  int c[kBpt];
  load_bins<kBpt>(h, kBin - kBpt * (static_cast<int>(threadIdx.x) + 1), c);
  int own = 0;
#pragma unroll
  for (int q = 0; q < kBpt; ++q) own += c[q];
  own = __reduce_add_sync(kFull, own);
  if (lane == 0) sh.warp_total[warp] = own;
  __syncthreads();
  // every warp finds the warp whose bins hold the rank (lane w scans warp
  // w's total), then scans those 32 x kBpt bins itself: no barrier
  // broadcasts the digit
  const int n = lane < kWarps ? sh.warp_total[lane] : 0;
  int winc = n;
#pragma unroll
  for (int o = 1; o < kWarps; o <<= 1) {
    const int y = __shfl_up_sync(kFull, winc, o);
    if (lane >= o) winc += y;
  }
  const int tw = __ffs(__ballot_sync(kFull, winc >= s.rank)) - 1;
  const int before = __shfl_sync(kFull, winc - n, tw);
  const int b0 = kBin - kBpt * (tw * 32 + lane + 1);
  load_bins<kBpt>(h, b0, c);
  int sum = 0;
#pragma unroll
  for (int q = 0; q < kBpt; ++q) sum += c[q];
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  const int hit = __ffs(__ballot_sync(kFull, before + incl >= s.rank)) - 1;
  int r = s.rank - before - (incl - sum), dig = 0, cnt = 0;
#pragma unroll
  for (int q = kBpt - 1; q >= 0; --q) {  // bins b0+kBpt-1 down to b0
    if (cnt == 0) {
      if (r <= c[q]) {
        dig = b0 + q;
        cnt = c[q];
      } else {
        r -= c[q];
      }
    }
  }
  cnt = __shfl_sync(kFull, cnt, hit);
  s.rank = __shfl_sync(kFull, r, hit);
  dig = __shfl_sync(kFull, dig, hit);
  s.prefix |= static_cast<uint32_t>(dig) << kLow;
  s.pmask |= static_cast<uint32_t>(kBin - 1) << kLow;
  if constexpr (P == 1) {
    // a bin of one or two candidates holds v(k+1) as its largest (rank 1)
    // or least (rank 2) key; at rank 2 below a larger key, exactly k
    // entries lie above v(k+1), the least of them that key, and at rank 2
    // of a tie, fewer than k
    if (cnt > 2) return false;
    const uint32_t hi = sh.bin_max[dig], lo = sh.bin_min[dig];
    s.key = s.rank == 1 ? hi : lo;
    s.vk_from = s.rank == 1 ? kAbove : hi > lo ? kGiven : kSame;
    s.vk_key = hi;
    return true;
  }
  s.key = s.prefix;
  s.vk_from = s.rank == 1 ? kAbove : kSame;
  return P == 2;
}

template <int VPT, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
topk_select_kernel(const float* __restrict__ x, float* __restrict__ val,
                   int8_t* __restrict__ mask, int d, int k) {
  __shared__ __align__(16) Shared sh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t base = static_cast<size_t>(blockIdx.x) * d;

  float v[VPT];
  if constexpr (VEC) {
    const float4* xr = reinterpret_cast<const float4*>(x + base);
#pragma unroll
    for (int j = 0; j < VPT; j += 4) {
      const int e = elem<VEC>(j);
      const float4 t = e < d ? xr[e >> 2] : make_float4(0.f, 0.f, 0.f, 0.f);
      v[j] = t.x; v[j + 1] = t.y; v[j + 2] = t.z; v[j + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int e = elem<VEC>(j);
      v[j] = e < d ? x[base + e] : 0.f;
    }
  }
  uint32_t valid = 0;
#pragma unroll
  for (int j = 0; j < VPT; ++j) valid |= (elem<VEC>(j) < d ? 1u : 0u) << j;
  // the histograms and bin_max to 0, bin_min to all ones
  int4* clear = reinterpret_cast<int4*>(sh.hist);
  for (int i = threadIdx.x; i < (kHist + 2 * kBinMax) / 4; i += kThreads) {
    const int fill = i < (kHist + kBinMax) / 4 ? 0 : -1;
    clear[i] = make_int4(fill, fill, fill, fill);
  }
  uint32_t kmax = 0;
#pragma unroll
  for (int j = 0; j < VPT; ++j)
    if (valid >> j & 1u) kmax = max(kmax, key_of(v[j]));
  kmax = __reduce_max_sync(kFull, kmax);
  if (lane == 0) sh.warp_max[warp] = kmax;
  __syncthreads();

  // amax, in warp 0, which replays the bisection
  float amax = 0.f;
  if (warp == 0)
    amax = __uint_as_float(__reduce_max_sync(
        kFull, lane < kWarps ? sh.warp_max[lane] : 0u));

  // v(k+1) by radix select where 1 <= k + 1 <= d
  Select s;
  s.rank = k + 1;
  const bool search = k >= 0 && k < d;
  if (search) {
    radix_pass<0, VPT, VEC>(v, valid, s, sh);
    if (!radix_pass<1, VPT, VEC>(v, valid, s, sh))
      radix_pass<2, VPT, VEC>(v, valid, s, sh);
  }
  const float vk1 = k < 0 ? INFINITY
                          : search ? __uint_as_float(s.key) : -INFINITY;
  if (warp == 0) {
    // the Pallas kernel's 32 steps on scalars, in one warp while the
    // others reduce: cnt(mid) > k <=> mid <= v(k+1). Both midpoints a step
    // can lead to are formed beside its compare.
    float lo = 0.f, hi = amax;
    float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
#pragma unroll
    for (int it = 0; it < kBisect; ++it) {
      const float mid_up = __fmul_rn(0.5f, __fadd_rn(mid, hi));
      const float mid_down = __fmul_rn(0.5f, __fadd_rn(lo, mid));
      const bool up = mid <= vk1;
      lo = up ? mid : lo;
      hi = up ? hi : mid;
      mid = up ? mid_up : mid_down;
    }
    if (lane == 0) {
      sh.lo = lo;
      sh.sel_hi = fminf(hi, amax);
    }
  }
  // v(k) is the least entry above v(k+1) where exactly k entries lie above
  // it (rank 1 in its bin; every entry for k = d): each warp's least key
  // above the bin
  const bool need_above = search ? s.vk_from == kAbove : k == d;
  if (need_above) {
    const uint32_t top = s.prefix | (~s.pmask & kAbs);
    uint32_t above = kInfKey;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const uint32_t key = key_of(v[j]);
      if ((valid >> j & 1u) && (!search || key > top)) above = min(above, key);
    }
    above = __reduce_min_sync(kFull, above);
    if (lane == 0) sh.warp_above[warp] = above;
  }
  __syncthreads();
  float vk = k < 0     ? INFINITY  // v(k)
             : !search ? -INFINITY
             : s.vk_from == kGiven ? __uint_as_float(s.vk_key) : vk1;
  if (need_above)
    vk = __uint_as_float(__reduce_min_sync(
        kFull, lane < kWarps ? sh.warp_above[lane] : kInfKey));
  const float sel_hi = sh.sel_hi;
  const float t = sel_hi <= vk ? sel_hi : sh.lo;  // cnt(sel_hi) >= k ?

  if constexpr (VEC) {
    float4* vr = reinterpret_cast<float4*>(val + base);
    uint32_t* mr = reinterpret_cast<uint32_t*>(mask + base);
#pragma unroll
    for (int j = 0; j < VPT; j += 4) {
      const int e = elem<VEC>(j);
      if (e < d) {
        float o[4];
        uint32_t m = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool sel = fabsf(v[j + q]) >= t;
          o[q] = v[j + q] * (sel ? 1.f : 0.f);
          m |= static_cast<uint32_t>(sel) << (8 * q);
        }
        vr[e >> 2] = make_float4(o[0], o[1], o[2], o[3]);
        mr[e >> 2] = m;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int e = elem<VEC>(j);
      if (e < d) {
        const bool sel = fabsf(v[j]) >= t;
        val[base + e] = v[j] * (sel ? 1.f : 0.f);
        mask[base + e] = sel ? 1 : 0;
      }
    }
  }
}

template <int VPT>
cudaError_t launch(const float* x, float* val, int8_t* mask, int n, int d,
                   int k, bool vec, cudaStream_t st) {
  if (vec)
    topk_select_kernel<VPT, true><<<n, kThreads, 0, st>>>(x, val, mask, d, k);
  else
    topk_select_kernel<VPT, false><<<n, kThreads, 0, st>>>(x, val, mask, d,
                                                           k);
  return cudaGetLastError();
}

}  // namespace

// x, val: (n, d) f32 row-major; mask: (n, d) int8; d <= 16384. Launches on
// `stream`. Rows are read and written in 16-byte pieces where d % 4 == 0
// and x and val are 16-byte aligned (mask 4-byte aligned).
extern "C" int topk_select_f32(const float* x, float* val, int8_t* mask,
                               int n, int d, int k, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(val) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(mask) % 4 == 0;
  cudaError_t e;
  if (d <= 4 * kThreads) e = launch<4>(x, val, mask, n, d, k, vec, st);
  else if (d <= 8 * kThreads) e = launch<8>(x, val, mask, n, d, k, vec, st);
  else if (d <= 16 * kThreads) e = launch<16>(x, val, mask, n, d, k, vec, st);
  else if (d <= 32 * kThreads) e = launch<32>(x, val, mask, n, d, k, vec, st);
  else e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
