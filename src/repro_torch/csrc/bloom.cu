// Bloom-filter probe and build kernels for Hopper (sm_90a).
//
// Replaces:
//   * bloom_probe  <- src/repro/kernels/bloom_probe.py `bloom_probe_pallas`
//                     (kernel `bloom_probe_kernel`): per u64 key, the
//                     `hash_pair` double hash, k bit tests, one bool "maybe".
//   * bloom_build  <- src/repro/kernels/bloom_probe.py `hash_pair` as jitted
//                     by `ops.bloom_build_hashes`, plus the host bit pack of
//                     src/repro/core/bloom.py `build_bits`.
//
// Keys arrive as int64 holding the order-preserving map k ^ (1 << 63) (the
// port's device key layout); the hash runs on the original u64 key.  Bits
// are uint32 words, bit (pos & 31) of word (pos >> 5), little-endian: the
// layout of `build_bits` and of the Pallas kernel.  Key bit j of a key is
// pos_j = (h1 + j * h2 mod 2^32) mod m_bits.
//
// Probe.  What bounds it: memory latency, at the read path's shapes.  It
// reads 8 bytes of key, writes one byte, and gathers up to k bitset words
// at random: at 40k-65k keys a launch (0.2-0.5 us of bytes at the memory
// rate) is a few microseconds of launch and round trips.  Every run's
// filter (8.7 MB for the deepest run of a 10M-entry store at 10 bits a
// key, 12.5 MB at 10M keys) fits the 50 MB L2.  The first design gave each
// key a dependent chain of up to k gathers behind a 32-bit `%`; here a key
// gathers its positions two at a time (kProbeBatch), `% m_bits` is
// fastmod, and the grid is sized from the SM count.  Measured slower on
// the H100 and dropped: all k positions at once (more instructions and
// sectors for the absent keys that most launches hold), and two or four
// keys a thread with 16-byte key loads and packed flag stores (fewer
// warps to hide each thread's longer serial work).
// Build.  What bounds it: the function reads 8 bytes a key and writes the
// filter once, but it sets n * k bits at random places.  One global atomic
// OR per bit (the first design) ran at the L2 atomic units' rate, about 88 G
// a second.  Here no key bit costs a global atomic; the bits are set in
// shared memory, slice by slice.  The bit space is cut into slices of
// 2^shift bits (2^12 to 2^16, so 16-bit offsets, about 1,024 slices; more
// bits a slice only past 4,096 slices of 2^16), and `kernels/bloom.py`
// `build_plan` sizes the passes from the filter, the keys and the card:
//   * a bucket pass hashes each key, counts its positions per slice in a
//     shared histogram, reserves one range of each slice's segment per
//     block (one global atomic per block and slice), hashes the keys again
//     to counting-sort the positions by slice in shared memory, and writes
//     them as in-slice offsets in runs, consecutive threads on consecutive
//     slots.  A block stages up to 32K positions (fewer when the keys would
//     not fill the card), so the runs are long and the reservations few;
//   * a set pass gives each slice a block that loads its segment with
//     16-byte loads, sets the bits in shared memory and writes its words
//     once, with plain coalesced stores.
// A segment holds `cap` offsets, sized by the plan far above a slice's
// expected load; a slice that overflows (duplicate keys, not random data)
// is rebuilt by its set block from the keys themselves, so the bits never
// depend on the plan.  `% m_bits` is Lemire's fastmod with a 64-bit magic
// computed once per launch, exact for every 32-bit numerator and divisor.
// OR is order-free, so the words equal `build_plain`'s bit for bit.
// Designs that measured slower on the H100 and were dropped: for filters
// that fit one block's shared memory, a copy of the filter per block ORed
// into a zeroed output with global atomics, the same copies in one cluster
// ORed through distributed shared memory, and atomics on one filter spread
// over a cluster; for the bucket pass, keeping the first hash's positions
// in shared memory and copying each slice's run with one warp.  The bucket
// pass is bound by its shared-memory atomics and accesses at random banks,
// not by the hash, so it hashes twice.
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t mix32(uint32_t x, uint32_t c1,
                                          uint32_t c2) {
  x ^= x >> 16;
  x *= c1;
  x ^= x >> 13;
  x *= c2;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ void hash_pair(int64_t mapped, uint32_t& h1,
                                          uint32_t& h2) {
  const uint64_t key = static_cast<uint64_t>(mapped) ^ 0x8000000000000000ull;
  const uint32_t lo = static_cast<uint32_t>(key);
  const uint32_t hi = static_cast<uint32_t>(key >> 32);
  h1 = mix32(lo ^ mix32(hi, 0x85EBCA6Bu, 0xC2B2AE35u), 0xCC9E2D51u,
             0x1B873593u);
  h2 = mix32(hi ^ mix32(lo, 0x27D4EB2Fu, 0x165667B1u), 0x9E3779B9u,
             0x85EBCA77u) | 1u;
}

// a mod d for 32-bit a and d >= 1, with magic = 2^64 / d rounded up
// (Lemire, Kaser and Kurz, "Faster remainder by direct computation", 2019).
// The high word of the 96-bit product low * d, as hi * d + (lo * d >> 32)
// (it cannot overflow 64 bits), saves the full 64 x 64 high multiply.
__device__ __forceinline__ uint32_t fastmod(uint32_t a, uint64_t magic,
                                            uint32_t d) {
  const uint64_t low = magic * a;
  const uint32_t low_hi = static_cast<uint32_t>(low >> 32);
  const uint32_t low_lo = static_cast<uint32_t>(low);
  return static_cast<uint32_t>(
      (static_cast<uint64_t>(low_hi) * d + __umulhi(low_lo, d)) >> 32);
}

uint64_t fastmod_magic(uint32_t d) { return ~uint64_t{0} / d + 1; }

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// Waits until the kernel before this one on the stream has finished and
// its writes are visible; a no-op unless this kernel was launched by
// launch_dependent.
__device__ __forceinline__ void wait_for_previous_kernel() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// ---------------------------------------------------------------- probe
constexpr int kProbeThreads = 256;  // threads a block, one key each
constexpr int kProbeBlocksPerSm = 2048 / kProbeThreads;
// Bit positions a key gathers together before it tests them.  Two: an
// absent key, the common case on the read path, finds a clear bit within
// its first two positions three times in four at a half-full filter, so
// one round trip of two independent loads settles most keys, where one
// position a trip makes a member wait for k dependent loads and all k at
// once makes every absent key pay for k.
constexpr int kProbeBatch = 2;

// One "maybe" byte a key.  A key's positions are gathered kProbeBatch at a
// time, the batch's loads independent of each other, and the key stops
// after the first batch that finds a clear bit: an absent key (about half
// the filter's bits are set) usually stops after one round trip, a member
// takes ceil(k / kProbeBatch) round trips instead of k.  The grid strides
// over the keys, up to kProbeBlocksPerSm blocks on each SM.
__global__ void __launch_bounds__(kProbeThreads)
    bloom_probe_kernel(const int64_t* __restrict__ keys, int64_t n,
                       const uint32_t* __restrict__ bits, uint32_t m_bits,
                       uint64_t magic, int k, uint8_t* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    uint32_t h1, h2;
    hash_pair(__ldg(keys + i), h1, h2);
    bool maybe = true;
    for (int j0 = 0; maybe && j0 < k; j0 += kProbeBatch) {
      uint32_t pos[kProbeBatch], word[kProbeBatch];
#pragma unroll
      for (int jj = 0; jj < kProbeBatch; ++jj) {
        pos[jj] = fastmod(h1 + static_cast<uint32_t>(j0 + jj) * h2, magic,
                          m_bits);
        word[jj] = j0 + jj < k ? __ldg(bits + (pos[jj] >> 5)) : ~0u;
      }
#pragma unroll
      for (int jj = 0; jj < kProbeBatch; ++jj)
        maybe &= ((word[jj] >> (pos[jj] & 31u)) & 1u) != 0;
    }
    out[i] = maybe;
  }
}

// ---------------------------------------------------------------- build
constexpr int kSetThreads = 256;

// In-place exclusive prefix sum of a[0, n) by the whole block; returns the
// total.  `warp_sums` holds 32 words of shared scratch.
__device__ uint32_t block_exclusive_scan(uint32_t* a, int n,
                                         uint32_t* warp_sums) {
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int begin = min(n, static_cast<int>(threadIdx.x) * per);
  const int end = min(n, begin + per);
  uint32_t mine = 0;
  for (int s = begin; s < end; ++s) mine += a[s];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t incl = mine;
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t up = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    uint32_t v = lane < n_warps ? warp_sums[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t up = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= d) v += up;
    }
    warp_sums[lane] = v;            // inclusive over warps
  }
  __syncthreads();
  uint32_t run = incl - mine + (warp ? warp_sums[warp - 1] : 0);
  for (int s = begin; s < end; ++s) {
    const uint32_t c = a[s];
    a[s] = run;
    run += c;
  }
  const uint32_t total = warp_sums[31];
  __syncthreads();
  return total;
}

// grid: one block per chunk of `kpb` keys (kpb * k <= stage).  Dynamic
// shared memory: stage positions, then cursor[n_slices], then
// delta[n_slices], then 32 words of scan scratch.  fill: (n_slices,) zeroed
// counters; seg: (n_slices, cap) in-slice offsets.
template <typename Off>
__global__ void bloom_bucket_kernel(const int64_t* __restrict__ keys,
                                    int64_t n, int64_t kpb, uint32_t m_bits,
                                    uint64_t magic, int k, int shift,
                                    int n_slices, int stage, uint32_t cap,
                                    unsigned long long* __restrict__ fill,
                                    Off* __restrict__ seg) {
  extern __shared__ uint32_t smem_bucket[];
  uint32_t* pos_of = smem_bucket;                 // positions by slice
  uint32_t* cursor = pos_of + stage;              // count, then slot
  int32_t* delta = reinterpret_cast<int32_t*>(cursor + n_slices);
  uint32_t* warp_sums = cursor + 2 * n_slices;
  for (int s = threadIdx.x; s < n_slices; s += blockDim.x) cursor[s] = 0;
  wait_for_previous_kernel();      // the zeroed fill counters
  __syncthreads();
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * kpb;
  const int64_t hi = min64(n, lo + kpb);
  for (int64_t i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    uint32_t h1, h2;
    hash_pair(keys[i], h1, h2);
    uint32_t x = h1;
    for (int j = 0; j < k; ++j, x += h2)
      atomicAdd(cursor + (fastmod(x, magic, m_bits) >> shift), 1u);
  }
  __syncthreads();
  // one range of each slice's segment for this block; an offset at slot
  // idx of the sorted positions lands at idx + delta[slice]
  for (int s = threadIdx.x; s < n_slices; s += blockDim.x) {
    const uint32_t c = cursor[s];
    const unsigned long long base =
        c ? atomicAdd(fill + s, static_cast<unsigned long long>(c)) : 0ull;
    delta[s] = static_cast<int32_t>(base < cap ? base : cap);
  }
  __syncthreads();
  const uint32_t total = block_exclusive_scan(cursor, n_slices, warp_sums);
  for (int s = threadIdx.x; s < n_slices; s += blockDim.x)
    delta[s] -= static_cast<int32_t>(cursor[s]);
  __syncthreads();
  // the same positions again, counting-sorted by slice
  for (int64_t i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    uint32_t h1, h2;
    hash_pair(keys[i], h1, h2);
    uint32_t x = h1;
    for (int j = 0; j < k; ++j, x += h2) {
      const uint32_t pos = fastmod(x, magic, m_bits);
      pos_of[atomicAdd(cursor + (pos >> shift), 1u)] = pos;
    }
  }
  __syncthreads();
  // consecutive threads write consecutive slots of one slice's run;
  // what falls past the segment's cap is dropped (the set pass sees the
  // overflow in fill)
  const uint32_t mask = (1u << shift) - 1u;
  for (uint32_t idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const uint32_t pos = pos_of[idx];
    const uint32_t s = pos >> shift;
    const int64_t dst = static_cast<int64_t>(idx) + delta[s];
    if (dst < cap)
      seg[static_cast<int64_t>(s) * cap + dst] = static_cast<Off>(pos & mask);
  }
}

// grid: one block per slice; dynamic shared memory: the slice's words.
// Writes every word of `bits` exactly once.
template <typename Off>
__global__ void bloom_set_kernel(const Off* __restrict__ seg,
                                 const unsigned long long* __restrict__ fill,
                                 uint32_t cap, int shift,
                                 const int64_t* __restrict__ keys, int64_t n,
                                 uint32_t m_bits, uint64_t magic, int k,
                                 uint32_t m_words,
                                 uint32_t* __restrict__ bits) {
  extern __shared__ uint32_t slice_words[];
  const uint32_t s = blockIdx.x;
  const uint32_t w0 = s << (shift - 5);
  const uint32_t nw = min(1u << (shift - 5), m_words - w0);
  for (uint32_t w = threadIdx.x; w < nw; w += blockDim.x) slice_words[w] = 0;
  wait_for_previous_kernel();      // the bucket pass's segments
  __syncthreads();
  const unsigned long long c = fill[s];
  if (c <= cap) {
    constexpr int kPer = 16 / sizeof(Off);
    const Off* p = seg + static_cast<int64_t>(s) * cap;
    const uint32_t nvec = static_cast<uint32_t>(c) / kPer;
    const uint4* pv = reinterpret_cast<const uint4*>(p);
    for (uint32_t v = threadIdx.x; v < nvec; v += blockDim.x) {
      union {
        uint4 v;
        Off o[kPer];
      } q;
      q.v = __ldg(pv + v);
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const uint32_t off = q.o[e];
        atomicOr(slice_words + (off >> 5), 1u << (off & 31u));
      }
    }
    for (uint32_t e = nvec * kPer + threadIdx.x; e < c; e += blockDim.x) {
      const uint32_t off = p[e];
      atomicOr(slice_words + (off >> 5), 1u << (off & 31u));
    }
  } else {
    // the segment overflowed: every key's positions in this slice, afresh
    const uint32_t mask = (1u << shift) - 1u;
    for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
      uint32_t h1, h2;
      hash_pair(keys[i], h1, h2);
      uint32_t x = h1;
      for (int j = 0; j < k; ++j, x += h2) {
        const uint32_t pos = fastmod(x, magic, m_bits);
        if ((pos >> shift) == s) {
          const uint32_t off = pos & mask;
          atomicOr(slice_words + (off >> 5), 1u << (off & 31u));
        }
      }
    }
  }
  __syncthreads();
  for (uint32_t w = threadIdx.x; w < nw; w += blockDim.x)
    bits[w0 + w] = slice_words[w];
}

// Lets `Kernel` take `bytes` of dynamic shared memory on the current
// device, setting the attribute only when a launch needs more than before
// (so a steady stream of launches makes no extra runtime call, and the
// launches can be captured in a CUDA graph).
template <auto Kernel>
cudaError_t allow_smem(size_t bytes) {
  static size_t granted[64] = {};   // per kernel and device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (bytes <= 48 * 1024 || (dev < 64 && bytes <= granted[dev]))
    return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < 64) granted[dev] = bytes;
  return err;
}

// Launches `kernel` so that it may be scheduled while the kernel before
// it on `stream` finishes (Hopper's programmatic dependent launch): the
// kernel waits for that one's results in wait_for_previous_kernel, and
// its launch latency overlaps the other's tail.
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), unsigned int grid,
                             int threads, size_t smem, cudaStream_t stream,
                             Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

template <typename Off>
int launch_sliced(const int64_t* keys, int64_t n, uint32_t* bits,
                  uint32_t m_words, int k, int64_t kpb, int shift,
                  int n_slices, int stage, uint32_t cap,
                  unsigned long long* fill, void* seg, cudaStream_t stream) {
  const uint32_t m_bits = m_words * 32u;
  const uint64_t magic = fastmod_magic(m_bits);
  const size_t bucket_smem =
      sizeof(uint32_t) * (static_cast<size_t>(stage) + 2 * n_slices + 32);
  cudaError_t err = allow_smem<bloom_bucket_kernel<Off>>(bucket_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned int blocks = static_cast<unsigned int>((n + kpb - 1) / kpb);
  // a thread for every 8 staged positions, 128 to 1,024 a block
  const int threads = stage >= 8192 ? 1024 : (stage >= 1024 ? stage / 8 : 128);
  err = launch_dependent(bloom_bucket_kernel<Off>, blocks, threads,
                         bucket_smem, stream, keys, n, kpb, m_bits, magic, k,
                         shift, n_slices, stage, cap, fill,
                         static_cast<Off*>(seg));
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t set_smem = size_t{1} << (shift - 3);
  err = allow_smem<bloom_set_kernel<Off>>(set_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_dependent(bloom_set_kernel<Off>,
                         static_cast<unsigned int>(n_slices), kSetThreads,
                         set_smem, stream, static_cast<const Off*>(seg),
                         static_cast<const unsigned long long*>(fill), cap,
                         shift, keys, n, m_bits, magic, k, m_words, bits);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// keys: (n,) int64 order-mapped, n >= 1; bits: (m_words,) uint32; out:
// (n,) uint8; the grid covers the keys, up to kProbeBlocksPerSm blocks on
// each of `sm_count` SMs.
int bloom_probe_launch(const void* keys, int64_t n, const void* bits,
                       int64_t m_words, int k, void* out, int sm_count,
                       void* stream) {
  const int64_t blocks = std::min<int64_t>(
      (n + kProbeThreads - 1) / kProbeThreads,
      static_cast<int64_t>(sm_count) * kProbeBlocksPerSm);
  const uint32_t m_bits = static_cast<uint32_t>(m_words * 32);
  bloom_probe_kernel<<<static_cast<unsigned int>(std::max<int64_t>(blocks, 1)),
                       kProbeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), n,
      static_cast<const uint32_t*>(bits), m_bits, fastmod_magic(m_bits), k,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The shared memory one block may take on `device` (opt-in maximum).
int bloom_smem_optin(int device, int* bytes) {
  return static_cast<int>(cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

// The build.  keys: (n,) int64, n >= 1; bits: (m_words,) uint32, every
// word written; slices of 2^shift bits (12 <= shift <= 20), n_slices of
// them; kpb * k <= stage positions a bucket block; fill: (n_slices,) int64
// zeroed; seg: n_slices * cap offsets, uint16 when shift <= 16 else uint32,
// cap a multiple of 8.
int bloom_build_launch(const void* keys, int64_t n, void* bits,
                              int64_t m_words, int k, int64_t kpb, int shift,
                              int n_slices, int stage, int64_t cap,
                              void* fill, void* seg, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* kp = static_cast<const int64_t*>(keys);
  uint32_t* bp = static_cast<uint32_t*>(bits);
  unsigned long long* fp = static_cast<unsigned long long*>(fill);
  const uint32_t mw = static_cast<uint32_t>(m_words);
  const uint32_t c = static_cast<uint32_t>(cap);
  if (shift <= 16)
    return launch_sliced<uint16_t>(kp, n, bp, mw, k, kpb, shift, n_slices,
                                   stage, c, fp, seg, s);
  return launch_sliced<uint32_t>(kp, n, bp, mw, k, kpb, shift, n_slices,
                                 stage, c, fp, seg, s);
}

const char* bloom_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
