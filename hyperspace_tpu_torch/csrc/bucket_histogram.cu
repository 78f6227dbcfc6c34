// Rows per bucket: counts[b] = #{i : ids[i] == b}, for 0 <= b < nb; ids
// outside [0, nb) count nowhere (padding -1, the build's sentinel nb).
//
// Replaces the Pallas kernel hyperspace_tpu/ops/kernels.py::_hist_kernel
// (launched by _hist_call, from bucket_histogram and from
// ops/sort.py::_build_sorted). On the TPU that kernel compares every id of a
// tile against every bucket (a one-hot (nb, tile) matrix) and carries the sum
// across the sequential grid. Here blocks run in parallel, so each block
// keeps a private histogram in shared memory and adds it to the global one
// with one atomic per non-empty bucket at the end.
//
// Bound: bytes. The kernel reads 4 bytes per id and does one compare and at
// most one shared-memory atomic per warp-run of equal ids: the build hands it
// the sorted bucket ids, so most warps hold one or two distinct ids, and
// __match_any_sync folds each group of equal ids into a single atomic of its
// popcount instead of 32 atomics that serialise on one address.
// When nb int32 counters do not fit in the shared memory a block may use, the
// same kernel adds straight into the global counts instead.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
// The largest private histogram a block keeps in shared memory (48 KiB is
// the default limit; above it the launcher raises the kernel's limit).
constexpr int kMaxSharedBytes = 160 * 1024;

__global__ void bucket_histogram_kernel(const int* __restrict__ ids, long long n, int nb,
                                        int* __restrict__ counts, int use_shared) {
  extern __shared__ int hist[];
  if (use_shared) {
    for (int b = threadIdx.x; b < nb; b += blockDim.x) hist[b] = 0;
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // `base` is the same for every thread of the block, so each warp runs the
  // loop the same number of times and every lane joins __match_any_sync.
  for (long long base = (long long)blockIdx.x * blockDim.x; base < n; base += stride) {
    const long long i = base + threadIdx.x;
    const int b = i < n ? ids[i] : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    if (lane == __ffs(peers) - 1 && (unsigned)b < (unsigned)nb) {
      const int c = __popc(peers);
      if (use_shared) {
        atomicAdd(&hist[b], c);
      } else {
        atomicAdd(&counts[b], c);
      }
    }
  }
  if (use_shared) {
    __syncthreads();
    for (int b = threadIdx.x; b < nb; b += blockDim.x) {
      const int c = hist[b];
      if (c != 0) atomicAdd(&counts[b], c);
    }
  }
}

}  // namespace

// counts: nb int32 zeros, allocated and zeroed by the caller.
extern "C" int hs_bucket_histogram(const int* ids, long long n, int nb, int* counts, void* stream) {
  if (n <= 0 || nb <= 0) return 0;
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const size_t shared_bytes = (size_t)nb * sizeof(int);
  const int use_shared = shared_bytes <= (size_t)kMaxSharedBytes;
  if (use_shared && shared_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(bucket_histogram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)shared_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > (long long)sms * kBlocksPerSm) blocks = (long long)sms * kBlocksPerSm;
  bucket_histogram_kernel<<<(unsigned)blocks, kThreads, use_shared ? shared_bytes : 0,
                            (cudaStream_t)stream>>>(ids, n, nb, counts, use_shared);
  return (int)cudaGetLastError();
}

extern "C" const char* hs_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
