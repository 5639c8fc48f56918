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
// layout of `build_bits` and of the Pallas kernel.
//
// What bounds it on the H100: memory.  A probe reads 8 bytes of key, writes
// one byte, and gathers up to k bitset words at random; the build reads 8
// bytes of key and does k atomic ORs at random.  The TPU kernel held the
// whole bitset in VMEM; here the deepest run's filter (about 12.5 MB at
// 10M keys and 10 bits per key) is far above a block's 227 KB of shared
// memory but inside the 50 MB L2, so the random word accesses are L2
// gathers, left to the hardware cache.  One thread per key; the probe
// stops at the first clear bit.  No padding of the batch: a masked tail
// takes any n.
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

__global__ void bloom_probe_kernel(const int64_t* __restrict__ keys,
                                   int64_t n,
                                   const uint32_t* __restrict__ bits,
                                   uint32_t m_bits, int k,
                                   uint8_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  uint32_t h1, h2;
  hash_pair(keys[i], h1, h2);
  uint8_t maybe = 1;
  for (int j = 0; j < k; ++j) {
    const uint32_t pos = (h1 + static_cast<uint32_t>(j) * h2) % m_bits;
    if (((__ldg(bits + (pos >> 5)) >> (pos & 31u)) & 1u) == 0u) {
      maybe = 0;
      break;
    }
  }
  out[i] = maybe;
}

__global__ void bloom_build_kernel(const int64_t* __restrict__ keys,
                                   int64_t n, uint32_t* __restrict__ bits,
                                   uint32_t m_bits, int k) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  uint32_t h1, h2;
  hash_pair(keys[i], h1, h2);
  for (int j = 0; j < k; ++j) {
    const uint32_t pos = (h1 + static_cast<uint32_t>(j) * h2) % m_bits;
    atomicOr(bits + (pos >> 5), 1u << (pos & 31u));
  }
}

constexpr int kThreads = 256;

unsigned int grid_for(int64_t n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// keys: (n,) int64 order-mapped; bits: (m_words,) uint32; out: (n,) uint8.
int bloom_probe_launch(const void* keys, int64_t n, const void* bits,
                       int64_t m_words, int k, void* out, void* stream) {
  bloom_probe_kernel<<<grid_for(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), n,
      static_cast<const uint32_t*>(bits),
      static_cast<uint32_t>(m_words * 32), k, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// keys: (n,) int64 order-mapped; bits: (m_words,) uint32, zeroed by caller.
int bloom_build_launch(const void* keys, int64_t n, void* bits,
                       int64_t m_words, int k, void* stream) {
  bloom_build_kernel<<<grid_for(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), n, static_cast<uint32_t*>(bits),
      static_cast<uint32_t>(m_words * 32), k);
  return static_cast<int>(cudaGetLastError());
}

const char* bloom_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
