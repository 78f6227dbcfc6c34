// Rows per bucket: counts[b] = #{i : ids[i] == b}, for 0 <= b < nb; ids
// outside [0, nb) count nowhere (padding -1, the build's sentinel nb).
//
// Replaces the Pallas kernel hyperspace_tpu/ops/kernels.py::_hist_kernel
// (launched by _hist_call, from bucket_histogram and from
// ops/sort.py::_build_sorted). On the TPU that kernel compares every id of a
// tile against every bucket (a one-hot (nb, tile) matrix) and carries the sum
// across the sequential grid. Here blocks run in parallel, so each block
// keeps a private histogram in shared memory.
//
// Bound: bytes, 4 per id read once; at the build's chunk (1.9M ids) that
// is about 2 us, the order of one launch. So the design counts in one pass
// and one launch, with as little per-id work as the ids allow:
//
// - Each block owns a contiguous tile of the ids. Its threads read them as
//   int4 (16 bytes a thread, neighbouring threads on neighbouring
//   addresses); the few ids before the first 16-byte boundary and after the
//   last go to the first and the last block, so any base address and length
//   go through the kernel.
// - Each thread counts runs of equal ids in registers and adds a run's
//   length to the block's shared histogram only where the run ends: one
//   shared atomic per run. The build hands the kernel sorted ids, so a
//   thread sees one or two runs; random ids cost at most one atomic per id.
// - A block adds each non-zero count of its histogram to `counts` in
//   global memory (a few atomics per block for sorted ids). `counts` must
//   start at zero, and a zeroing launch before the kernel would cost as
//   much as the count itself, so the kernel also zeroes `next`, the buffer
//   the caller hands in as `counts` to its next call: one launch per call.
// - When nb int32 counters do not fit in the shared memory a block may use,
//   the runs go straight to `counts` instead.
//
// Geometry: 256 threads, 4 int4 (16 ids) a thread, all four loads issued
// before the first id is counted, at most 8 blocks per SM: 1.9M ids take
// some 460 blocks, every SM busy with up to 64 KB of loads in flight.
//
// `next` is zeroed on the launching stream, so the next call must be
// launched on the same stream, as the build's calls are.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kVecsPerThread = 4;
constexpr int kBlocksPerSm = 8;
// The largest private histogram a block keeps in shared memory (48 KiB is
// the default limit; above it the launcher raises the kernel's limit).
constexpr int kMaxSharedBytes = 160 * 1024;

struct Runs {
  int cur = -1;  // -1 counts nowhere
  int len = 0;
};

__device__ __forceinline__ void flush(Runs& r, int nb, int* hist) {
  if ((unsigned)r.cur < (unsigned)nb) atomicAdd(hist + r.cur, r.len);
}

__device__ __forceinline__ void add(Runs& r, int id, int nb, int* hist) {
  if (id == r.cur) {
    ++r.len;
  } else {
    flush(r, nb, hist);
    r.cur = id;
    r.len = 1;
  }
}

__global__ void __launch_bounds__(kThreads)
    bucket_histogram_kernel(const int* __restrict__ ids, long long n, int head, long long n4,
                            long long tile4, int nb, int* __restrict__ counts,
                            int* __restrict__ next, int use_shared) {
  extern __shared__ int shared_hist[];
  int* hist = use_shared ? shared_hist : counts;
  const int t = threadIdx.x;
  if (next) {
    for (long long b = (long long)blockIdx.x * kThreads + t; b < nb; b += (long long)gridDim.x * kThreads) {
      next[b] = 0;
    }
  }
  if (use_shared) {
    for (int b = t; b < nb; b += kThreads) hist[b] = 0;
    __syncthreads();
  }

  Runs r;
  const long long tail0 = head + 4 * n4;
  if (blockIdx.x == 0 && t < head) add(r, ids[t], nb, hist);
  if (blockIdx.x + 1 == gridDim.x && tail0 + t < n) add(r, ids[tail0 + t], nb, hist);
  const int4* v = reinterpret_cast<const int4*>(ids + head);
  const long long lo = min(n4, (long long)blockIdx.x * tile4);
  const long long hi = min(n4, lo + tile4);
  for (long long k = lo + t; k < hi; k += (long long)kThreads * kVecsPerThread) {
    int4 q[kVecsPerThread];  // all loads in flight before the first id is counted
#pragma unroll
    for (int j = 0; j < kVecsPerThread; ++j) {
      const long long i = k + (long long)j * kThreads;
      q[j] = i < hi ? __ldg(v + i) : make_int4(-1, -1, -1, -1);
    }
#pragma unroll
    for (int j = 0; j < kVecsPerThread; ++j) {
      add(r, q[j].x, nb, hist);
      add(r, q[j].y, nb, hist);
      add(r, q[j].z, nb, hist);
      add(r, q[j].w, nb, hist);
    }
  }
  flush(r, nb, hist);

  if (use_shared) {
    __syncthreads();
    for (int b = t; b < nb; b += kThreads) {
      const int c = hist[b];
      if (c != 0) atomicAdd(counts + b, c);
    }
  }
}

}  // namespace

// ids: n int32 at any 4-byte-aligned address; counts: nb int32 zeros, to
// which the kernel adds; next: nb int32 the kernel sets to zero (or null);
// sms: the device's SM count.
extern "C" int hs_bucket_histogram(const int* ids, long long n, int nb, int* counts, int* next,
                                   int sms, void* stream) {
  if (n <= 0 || nb <= 0) return 0;
  int head = (int)(((16 - (reinterpret_cast<uintptr_t>(ids) & 15)) & 15) / 4);
  if (head > n) head = (int)n;
  const long long n4 = (n - head) / 4;
  long long grid = (n4 + (long long)kThreads * kVecsPerThread - 1) / ((long long)kThreads * kVecsPerThread);
  if (grid > (long long)sms * kBlocksPerSm) grid = (long long)sms * kBlocksPerSm;
  if (grid < 1) grid = 1;
  const long long tile4 = (n4 + grid - 1) / grid;
  const size_t shared_bytes = (size_t)nb * sizeof(int);
  const int use_shared = shared_bytes <= (size_t)kMaxSharedBytes;
  if (use_shared && shared_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bucket_histogram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  bucket_histogram_kernel<<<(unsigned)grid, kThreads, use_shared ? shared_bytes : 0,
                            (cudaStream_t)stream>>>(ids, n, head, n4, tile4, nb, counts, next,
                                                    use_shared);
  return (int)cudaGetLastError();
}

extern "C" const char* hs_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
