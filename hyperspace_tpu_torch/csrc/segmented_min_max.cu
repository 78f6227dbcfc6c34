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
// Bound: bytes, 8 per value read once. One block per segment walks it with a
// block-stride loop, reduces in registers, then across warps with shuffles.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ long long order_key(double v) {
  const long long b = __double_as_longlong(v);
  return b < 0 ? (b ^ LLONG_MAX) : b;
}

__device__ __forceinline__ void warp_fold(long long& mn, long long& mx) {
  for (int o = 16; o > 0; o >>= 1) {
    const long long omn = __shfl_down_sync(0xffffffffu, mn, o);
    const long long omx = __shfl_down_sync(0xffffffffu, mx, o);
    mn = omn < mn ? omn : mn;
    mx = omx > mx ? omx : mx;
  }
}

__global__ void segmented_min_max_kernel(const double* __restrict__ values,
                                         const long long* __restrict__ offsets,
                                         long long* __restrict__ mins, long long* __restrict__ maxs,
                                         unsigned char* __restrict__ empty) {
  const int s = blockIdx.x;
  const long long lo = offsets[s];
  const long long hi = offsets[s + 1];
  long long mn = LLONG_MAX;
  long long mx = LLONG_MIN;
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const double v = values[i];
    if (v != v) continue;  // NaN
    const long long k = order_key(v);
    mn = k < mn ? k : mn;
    mx = k > mx ? k : mx;
  }
  warp_fold(mn, mx);

  __shared__ long long warp_mn[32];
  __shared__ long long warp_mx[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    warp_mn[warp] = mn;
    warp_mx[warp] = mx;
  }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    mn = lane < n_warps ? warp_mn[lane] : LLONG_MAX;
    mx = lane < n_warps ? warp_mx[lane] : LLONG_MIN;
    warp_fold(mn, mx);
    if (lane == 0) {
      mins[s] = mn;
      maxs[s] = mx;
      empty[s] = mn == LLONG_MAX ? 1 : 0;
    }
  }
}

}  // namespace

extern "C" int hs_segmented_min_max(const double* values, const long long* offsets, int n_seg,
                                    long long* mins, long long* maxs, unsigned char* empty,
                                    void* stream) {
  if (n_seg <= 0) return 0;
  segmented_min_max_kernel<<<n_seg, kThreads, 0, (cudaStream_t)stream>>>(values, offsets, mins, maxs,
                                                                          empty);
  return (int)cudaGetLastError();
}

extern "C" const char* hs_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
