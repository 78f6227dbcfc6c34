// Exact per-segment min and max of float64 values in CSR layout: segment s
// holds values[offsets[s] .. offsets[s + 1]). NaN (SQL null) is skipped; a
// segment with no other value reports empty[s] = 1.
//
// Replaces the Pallas kernel hyperspace_tpu/ops/kernels.py::_minmax_kernel
// (launched by _minmax_call from _minmax_rect and segmented_min_max). Mosaic
// has no 64-bit types, so the TPU kernel folds bias-flipped int32 (hi, lo)
// planes of a rectangle padded to the longest segment. Hopper has 64-bit
// integers, so this kernel reads the values themselves, forms the
// order-preserving key in registers and folds it as one int64; it reads no
// padding.
//
// The key: with b the value's bits as int64, key = b for b >= 0 and
// key = b ^ INT64_MAX for b < 0. Signed comparison of keys is the IEEE total
// order (so -0.0 < +0.0, as in the TPU kernel, which compares keys and not
// floats); it is the JAX package's unsigned key with its sign bit flipped.
// INT64_MAX and INT64_MIN are keys of NaN bit patterns only, so they serve as
// the identities of min and max.
//
// Bound: bytes, 8 per value read once; the key and two compares per value
// are far below the card's integer rate. So every SM must stream an equal
// share of the values, whatever the segment lengths: 16 files of 375 000
// values, 8 pieces of 2^20, or thousands of short files in one call.
//
// Design: the grid splits the flat value array, not the segments. Block b
// takes the contiguous range [lo, hi) of about n / grid values and finds
// the segments that overlap it by a block-wide search of `offsets`. Each
// segment's piece inside [lo, hi) is folded by a team: a warp for a piece
// shorter than `long_len`, the whole block for a longer one (at most
// kMaxLong of those fit in a range). Teams read 16 bytes a lane (double2,
// neighbouring lanes on neighbouring addresses, four loads in flight),
// after one scalar to reach 16-byte alignment and before one odd last
// value, so any base address and length go through the kernel. A piece's
// result goes into its segment with atomicMin/atomicMax on int64 keys,
// which are exact in any order, and a piece with a value clears the
// segment's empty flag; a segment cut by block boundaries thus folds its
// pieces with no second pass.
//
// The atomics need outputs that start at the identities (empty = 1), and a
// fill launch before the kernel would cost more than the fixed part of the
// kernel itself. So each call also initialises the outputs of the next
// call (`next_*`, `next_cap` segments), which the caller hands in as the
// outputs of that call: one launch per call.
//
// Geometry: 512 threads (16 warps), at most 2 blocks per SM, and at least
// 4096 values or 256 segments per block, so a small call stays on a few
// blocks and a large one fills every SM once with 64 bytes a thread in
// flight.
//
// The next call's outputs are initialised on the launching stream, so the
// next call must be launched on the same stream, as the build's calls are.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 2;
constexpr long long kValuesPerBlock = 4096;
constexpr long long kSegmentsPerBlock = 256;
// A piece at least this long is folded by the whole block, not one warp.
constexpr long long kLongMin = 4096;
// Most long pieces one block's range can hold (long_len is raised to keep it).
constexpr int kMaxLong = 32;
// double2 loads each lane issues before folding any of them
constexpr int kLoadsInFlight = 4;

__device__ __forceinline__ void fold(double v, long long& mn, long long& mx) {
  if (v != v) return;  // NaN
  long long k = __double_as_longlong(v);
  k = k < 0 ? (k ^ LLONG_MAX) : k;
  mn = k < mn ? k : mn;
  mx = k > mx ? k : mx;
}

// Fold values[a, b) into (mn, mx) with a team of `team` threads, this one
// being `lane`; the team's lanes together cover the range once.
__device__ __forceinline__ void fold_range(const double* __restrict__ values, long long a, long long b,
                                           int lane, int team, long long& mn, long long& mx) {
  if (a >= b) return;
  if (reinterpret_cast<uintptr_t>(values + a) & 15) {
    if (lane == 0) fold(values[a], mn, mx);
    ++a;
  }
  const long long pairs = (b - a) >> 1;
  const double2* p = reinterpret_cast<const double2*>(values + a);
  long long k = lane;
  for (; k + (kLoadsInFlight - 1) * team < pairs; k += kLoadsInFlight * team) {
    double2 x[kLoadsInFlight];
#pragma unroll
    for (int j = 0; j < kLoadsInFlight; ++j) x[j] = __ldg(p + k + j * team);
#pragma unroll
    for (int j = 0; j < kLoadsInFlight; ++j) {
      fold(x[j].x, mn, mx);
      fold(x[j].y, mn, mx);
    }
  }
  for (; k < pairs; k += team) {
    const double2 x = __ldg(p + k);
    fold(x.x, mn, mx);
    fold(x.y, mn, mx);
  }
  if (((b - a) & 1) && lane == 0) fold(values[b - 1], mn, mx);
}

__device__ __forceinline__ void warp_fold(long long& mn, long long& mx) {
  for (int o = 16; o > 0; o >>= 1) {
    const long long omn = __shfl_down_sync(0xffffffffu, mn, o);
    const long long omx = __shfl_down_sync(0xffffffffu, mx, o);
    mn = omn < mn ? omn : mn;
    mx = omx > mx ? omx : mx;
  }
}

// First s in [0, m) with a[s] >= x (m if none), and first s with
// b[s] >= y, by the whole block: each round every thread reads one sample
// for each key, so a search takes ceil(log_kThreads(m)) dependent reads
// instead of log2(m).
__device__ void block_lower_bounds(const long long* __restrict__ a, const long long* __restrict__ b,
                                   int m, long long x, long long y, int& rx, int& ry) {
  int lx = 0, hx = m, ly = 0, hy = m;  // each answer lies in [l, h]
  const int t = threadIdx.x;
  while (hx - lx > kThreads || hy - ly > kThreads) {
    const int sx = (hx - lx + kThreads - 1) / kThreads;
    const int sy = (hy - ly + kThreads - 1) / kThreads;
    const long long px = lx + (long long)t * sx;
    const long long py = ly + (long long)t * sy;
    const bool below_x = px < hx && a[px] < x;  // both reads in flight before the first barrier
    const bool below_y = py < hy && b[py] < y;
    const int cx = __syncthreads_count(below_x);
    const int cy = __syncthreads_count(below_y);
    // samples below the key form a prefix: the answer follows the last of
    // them and is at most the first sample at or above the key
    const int nlx = cx > 0 ? lx + (cx - 1) * sx + 1 : lx;
    const int nly = cy > 0 ? ly + (cy - 1) * sy + 1 : ly;
    hx = min(hx, lx + cx * sx);
    hy = min(hy, ly + cy * sy);
    lx = nlx;
    ly = nly;
  }
  const bool below_x = lx + t < hx && a[lx + t] < x;
  const bool below_y = ly + t < hy && b[ly + t] < y;
  rx = lx + __syncthreads_count(below_x);
  ry = ly + __syncthreads_count(below_y);
}

// Fold one piece's (min, max) into segment s.
__device__ __forceinline__ void put(int s, long long mn, long long mx, long long* __restrict__ mins,
                                    long long* __restrict__ maxs, unsigned char* __restrict__ empty) {
  if (mn == LLONG_MAX) return;  // no value in the piece
  atomicMin(mins + s, mn);
  atomicMax(maxs + s, mx);
  empty[s] = 0;
}

// mins/maxs/empty: n_seg outputs holding LLONG_MAX/LLONG_MIN/1; next_*:
// next_cap outputs of the next call, set here to the same identities.
__global__ void __launch_bounds__(kThreads)
    segmented_min_max_kernel(const double* __restrict__ values, long long n,
                             const long long* __restrict__ offsets, int n_seg, long long chunk,
                             long long long_len, long long* __restrict__ mins,
                             long long* __restrict__ maxs, unsigned char* __restrict__ empty,
                             long long* __restrict__ next_mins, long long* __restrict__ next_maxs,
                             unsigned char* __restrict__ next_empty, int next_cap) {
  __shared__ int s_long[kMaxLong];
  __shared__ int s_n_long;
  __shared__ long long s_mn[kWarps];
  __shared__ long long s_mx[kWarps];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  for (int s = blockIdx.x * kThreads + t; s < next_cap; s += gridDim.x * kThreads) {
    next_mins[s] = LLONG_MAX;
    next_maxs[s] = LLONG_MIN;
    next_empty[s] = 1;
  }
  const long long lo = min(n, (long long)blockIdx.x * chunk);
  const long long hi = min(n, lo + chunk);

  // the segments overlapping [lo, hi): from the first that ends after lo
  // (offsets[s + 1] > lo) to the last that starts before hi
  int first, end;
  block_lower_bounds(offsets + 1, offsets, n_seg, lo + 1, hi, first, end);
  if (t == 0) s_n_long = 0;
  __syncthreads();

  auto piece = [&](int s, long long& a, long long& b) {
    a = max(offsets[s], lo);
    b = min(offsets[s + 1], hi);
  };

  // short pieces, one warp each; long ones are queued for the whole block
  for (int s = first + warp; s < end; s += kWarps) {
    long long a, b;
    piece(s, a, b);
    if (b - a >= long_len) {
      if (lane == 0) s_long[atomicAdd(&s_n_long, 1)] = s;
      continue;
    }
    long long mn = LLONG_MAX, mx = LLONG_MIN;
    fold_range(values, a, b, lane, 32, mn, mx);
    warp_fold(mn, mx);
    if (lane == 0) put(s, mn, mx, mins, maxs, empty);
  }
  __syncthreads();

  for (int j = 0; j < s_n_long; ++j) {
    const int s = s_long[j];
    long long a, b;
    piece(s, a, b);
    long long mn = LLONG_MAX, mx = LLONG_MIN;
    fold_range(values, a, b, t, kThreads, mn, mx);
    warp_fold(mn, mx);
    if (lane == 0) {
      s_mn[warp] = mn;
      s_mx[warp] = mx;
    }
    __syncthreads();
    if (warp == 0) {
      mn = lane < kWarps ? s_mn[lane] : LLONG_MAX;
      mx = lane < kWarps ? s_mx[lane] : LLONG_MIN;
      warp_fold(mn, mx);
      if (lane == 0) put(s, mn, mx, mins, maxs, empty);
    }
    __syncthreads();
  }
}

}  // namespace

// n: values' length; offsets: n_seg + 1 non-decreasing int64 in [0, n];
// mins/maxs/empty: as the previous call's next_* left them (or set so by
// the caller); next_*: next_cap outputs for the next call, initialised here.
extern "C" int hs_segmented_min_max(const double* values, long long n, const long long* offsets,
                                    int n_seg, long long* mins, long long* maxs,
                                    unsigned char* empty, long long* next_mins, long long* next_maxs,
                                    unsigned char* next_empty, int next_cap, int sms, void* stream) {
  if (n_seg <= 0) return 0;
  long long grid = (n + kValuesPerBlock - 1) / kValuesPerBlock;
  const long long by_segments = (n_seg + kSegmentsPerBlock - 1) / kSegmentsPerBlock;
  if (grid < by_segments) grid = by_segments;
  if (grid > (long long)kBlocksPerSm * sms) grid = (long long)kBlocksPerSm * sms;
  if (grid < 1) grid = 1;
  const long long chunk = (n + grid - 1) / grid;
  long long long_len = (chunk + kMaxLong - 1) / kMaxLong;
  if (long_len < kLongMin) long_len = kLongMin;
  segmented_min_max_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      values, n, offsets, n_seg, chunk, long_len, mins, maxs, empty, next_mins, next_maxs, next_empty,
      next_cap);
  return (int)cudaGetLastError();
}

extern "C" const char* hs_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
