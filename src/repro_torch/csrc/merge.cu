// Pair merge of two sorted key columns for Hopper (sm_90a).
//
// Replaces src/repro/kernels/merge_path.py `bitonic_merge_pallas` (kernel
// `bitonic_merge_kernel`, `_compare_exchange`), as composed by
// `ops.merge_runs_tiled` with the host split `merge_path_partition`: merge
// two sorted key columns into one, and say for every output slot where it
// came from (source row, bit 31 set for rows of b).  Equal keys come
// a-first, and within one input by row.
//
// Keys are int64 holding the order-preserving map k ^ (1 << 63) of u64
// keys, so signed order is the u64 order the reference merges in.
//
// What bounds it on the H100: memory.  The function reads both inputs (8
// bytes a key) and writes 16 bytes an output (key and source).
//
// Design: merge-path tiles, the reference's own decomposition (a split at
// every tile-th output diagonal, then one merge per tile); the bitonic
// network inside a tile was a TPU choice (no dynamic control flow on the
// VPU) and becomes a serial merge per thread.  One block per tile of
// kTile = 2,048 outputs (256 threads x 8):
//   * the tile's two ends on the merge path (how many of the first d
//     outputs come from a: the largest i with a[i - 1] <= b[d - i],
//     a-first ties) are searched once per tile end, not per element.  In a
//     merge of fewer than 2,048 tiles (every merge of the store's load but
//     the largest), warps 0 and 1 of the tile's own block search them, 32
//     points a round, so the merge is one launch and waits on a few rounds
//     of loads; in a larger one a split kernel first searches every end,
//     one thread each, which keeps the tile blocks' start short (each way
//     measured faster than the other on its side of 2,048 tiles on the
//     H100);
//   * the block stages a[i0:i1] and b[j0:j1] in shared memory with
//     coalesced loads, each thread finds its own diagonal by a binary
//     search in shared memory, and merges its 8 items serially: a[i] is
//     taken while a[i] <= b[j], the a-first rule;
//   * keys, then sources, go back through shared memory (padded one slot
//     in 16 against bank conflicts) and out as coalesced 16-byte stores.
// A skewed merge needs no special case: a tile that draws from one input
// only is a copy.  Each input holds at most 2^31 - 1 rows.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kPadded = kTile + kTile / 16;
constexpr int64_t kFromB = int64_t{1} << 31;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// elements of a among the first d outputs of merge(a, b), a-first on ties
template <typename Index>
__device__ __forceinline__ Index merge_path(const int64_t* a, Index na,
                                            const int64_t* b, Index nb,
                                            Index d) {
  Index lo = d > nb ? d - nb : 0;
  Index hi = d < na ? d : na;
  while (lo < hi) {
    const Index mid = lo + ((hi - lo) >> 1);
    if (a[mid] <= b[d - 1 - mid]) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// merge_path over global memory by one warp: each round tests 32 evenly
// spaced points of the remaining range at once (one round of loads), so a
// range of 5M takes five rounds where a binary search takes 23 dependent
// loads.  All lanes return the answer.
__device__ int64_t warp_merge_path(const int64_t* __restrict__ a, int64_t na,
                                   const int64_t* __restrict__ b, int64_t nb,
                                   int64_t d) {
  const int lane = threadIdx.x & 31;
  int64_t lo = d > nb ? d - nb : 0;
  int64_t hi = d < na ? d : na;
  while (hi - lo > 32) {
    const int64_t span = hi - lo;
    const int64_t i = lo + (lane + 1) * span / 33;
    const int c = __popc(__ballot_sync(
        0xffffffffu, __ldg(a + i) <= __ldg(b + (d - 1 - i))));
    // points 0..c-1 lie below the answer, points c..31 at or above it
    const int64_t last_below = lo + c * span / 33;
    const int64_t first_above = lo + (c + 1) * span / 33;
    if (c > 0) lo = last_below + 1;
    if (c < 32) hi = first_above;
  }
  const int64_t i = lo + lane;
  const bool below = i < hi && __ldg(a + i) <= __ldg(b + (d - 1 - i));
  return lo + __popc(__ballot_sync(0xffffffffu, below));
}

// The split pass of a large merge: one thread per tile end, a binary
// search each (many ends in flight hide the chain of loads).
__global__ void merge_split_kernel(const int64_t* __restrict__ a, int64_t na,
                                   const int64_t* __restrict__ b, int64_t nb,
                                   int64_t n_tiles,
                                   int64_t* __restrict__ splits) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t > n_tiles) return;
  splits[t] = merge_path<int64_t>(a, na, b, nb, min64(t * kTile, na + nb));
}

// out[d0 : d0 + len) from the padded staging buffer, as 16-byte stores
// where both ends allow (d0 is even: kTile is)
__device__ __forceinline__ void store_tile(const int64_t* staged, int len,
                                           int64_t* __restrict__ out) {
  const int pairs = len / 2;
  longlong2* out2 = reinterpret_cast<longlong2*>(out);
  for (int p = threadIdx.x; p < pairs; p += kThreads) {
    const int e = 2 * p;
    longlong2 v;
    v.x = staged[e + e / 16];
    v.y = staged[e + 1 + (e + 1) / 16];
    out2[p] = v;
  }
  if ((len & 1) && threadIdx.x == 0)
    out[len - 1] = staged[(len - 1) + (len - 1) / 16];
}

// splits: the tile ends from merge_split_kernel, or null: then warps 0 and
// 1 find them.
__global__ void __launch_bounds__(kThreads)
    merge_tile_kernel(const int64_t* __restrict__ a, int64_t na,
                      const int64_t* __restrict__ b, int64_t nb,
                      const int64_t* __restrict__ splits,
                      int64_t* __restrict__ out_keys,
                      int64_t* __restrict__ out_src) {
  __shared__ int64_t sm[kPadded];
  __shared__ int64_t ends[2];
  const int64_t d0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int len = static_cast<int>(min64(na + nb - d0, kTile));
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int64_t i = splits ? splits[blockIdx.x + warp]
                             : warp_merge_path(a, na, b, nb, d0 + warp * len);
    if ((threadIdx.x & 31) == 0) ends[warp] = i;
  }
  __syncthreads();
  const int64_t i0 = ends[0];
  const int64_t j0 = d0 - i0;
  const int la = static_cast<int>(ends[1] - i0);
  const int lb = len - la;
  for (int x = threadIdx.x; x < len; x += kThreads)
    sm[x] = x < la ? a[i0 + x] : b[j0 + (x - la)];
  __syncthreads();
  const int64_t* sa = sm;
  const int64_t* sb = sm + la;
  const int dt = min(static_cast<int>(threadIdx.x) * kItems, len);
  int ia = merge_path<int>(sa, la, sb, lb, dt);
  int ib = dt - ia;
  int64_t key[kItems], src[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    if (dt + it < len) {
      const bool take_a = ib >= lb || (ia < la && sa[ia] <= sb[ib]);
      key[it] = take_a ? sa[ia] : sb[ib];
      src[it] = take_a ? i0 + ia : (j0 + ib) | kFromB;
      ia += take_a;
      ib += !take_a;
    }
  }
  __syncthreads();
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int e = dt + it;
    if (e < len) sm[e + e / 16] = key[it];
  }
  __syncthreads();
  store_tile(sm, len, out_keys + d0);
  __syncthreads();
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int e = dt + it;
    if (e < len) sm[e + e / 16] = src[it];
  }
  __syncthreads();
  store_tile(sm, len, out_src + d0);
}

}  // namespace

extern "C" {

// a: (na,) int64, b: (nb,) int64, both sorted ascending; na, nb < 2^31,
// na + nb >= 1.  splits: (ceil((na + nb) / kTile) + 1,) int64 scratch for
// a split pass, or null for none; out_keys, out_src: (na + nb,) int64,
// 16-byte aligned.
int merge_pair_launch(const void* a, int64_t na, const void* b, int64_t nb,
                      void* splits, void* out_keys, void* out_src,
                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n_tiles = (na + nb + kTile - 1) / kTile;
  const int64_t* pa = static_cast<const int64_t*>(a);
  const int64_t* pb = static_cast<const int64_t*>(b);
  int64_t* sp = static_cast<int64_t*>(splits);
  if (sp) {
    merge_split_kernel<<<static_cast<unsigned int>(
                             (n_tiles + kThreads) / kThreads),
                         kThreads, 0, s>>>(pa, na, pb, nb, n_tiles, sp);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  merge_tile_kernel<<<static_cast<unsigned int>(n_tiles), kThreads, 0, s>>>(
      pa, na, pb, nb, sp, static_cast<int64_t*>(out_keys),
      static_cast<int64_t*>(out_src));
  return static_cast<int>(cudaGetLastError());
}

int merge_tile_size() { return kTile; }

const char* merge_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
