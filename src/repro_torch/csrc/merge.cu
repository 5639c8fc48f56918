// Pair merge of two sorted key columns for Hopper (sm_90a).
//
// Replaces src/repro/kernels/merge_path.py `bitonic_merge_pallas` (kernel
// `bitonic_merge_kernel`, `_compare_exchange`), as composed by
// `ops.merge_runs_tiled`: merge two sorted key columns into one, and say
// for every output slot where it came from (source row, bit 31 set for
// rows of b).  Equal keys come a-first, and within one input by row.
//
// Keys are int64 holding the order-preserving map k ^ (1 << 63) of u64
// keys, so signed order is the u64 order the reference merges in.
//
// Design: rank scatter.  The bitonic network was a TPU choice (no dynamic
// control flow on the VPU, see merge_path.py's docstring).  Here each
// element finds its own output slot: a[i] goes to i + lower_bound(b, a[i])
// and b[j] to j + upper_bound(a, b[j]); the lower/upper pair is the a-first
// tie rule.  One thread per element, one binary search in the other input,
// one store of key and source.  Every slot is written exactly once, so no
// partition pass and no synchronisation between blocks is needed.
//
// What bounds it on the H100: memory.  The function must read both inputs
// (8 bytes per key) and write 16 bytes per output (key and source); the
// binary searches add log2(n) dependent loads per element, whose upper
// levels stay in L2.  Merge-path tiles staged in shared memory, which turn
// the searches into one per tile, are a later design.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// first index in [0, n) with x[idx] >= key (strict=false) or > key (true)
__device__ __forceinline__ int64_t bound(const int64_t* __restrict__ x,
                                         int64_t n, int64_t key,
                                         bool strict) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    const int64_t v = __ldg(x + mid);
    if (strict ? (v <= key) : (v < key)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void merge_pair_kernel(const int64_t* __restrict__ a, int64_t na,
                                  const int64_t* __restrict__ b, int64_t nb,
                                  int64_t* __restrict__ out_keys,
                                  int64_t* __restrict__ out_src) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t < na) {
    const int64_t key = a[t];
    const int64_t pos = t + bound(b, nb, key, false);
    out_keys[pos] = key;
    out_src[pos] = t;
  } else if (t < na + nb) {
    const int64_t j = t - na;
    const int64_t key = b[j];
    const int64_t pos = j + bound(a, na, key, true);
    out_keys[pos] = key;
    out_src[pos] = j | (int64_t{1} << 31);
  }
}

constexpr int kThreads = 256;

}  // namespace

extern "C" {

// a: (na,) int64, b: (nb,) int64, both sorted ascending; na, nb < 2^31.
// out_keys, out_src: (na + nb,) int64.
int merge_pair_launch(const void* a, int64_t na, const void* b, int64_t nb,
                      void* out_keys, void* out_src, void* stream) {
  const int64_t n = na + nb;
  const unsigned int grid =
      static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  merge_pair_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(a), na, static_cast<const int64_t*>(b), nb,
      static_cast<int64_t*>(out_keys), static_cast<int64_t*>(out_src));
  return static_cast<int>(cudaGetLastError());
}

const char* merge_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
