// GQA attention for Hopper (sm_90a): prefill flash attention and paged
// decode attention.
//
// flash_attention_kernel replaces src/repro/kernels/flash_attention.py
// `flash_attention_pallas` (kernel `flash_attention_kernel`): forward
// attention of q (B, Sq, H, dh) over k/v (B, Sk, KH, dh), query head h
// reading KV head h / (H / KH), causal and/or sliding-window mask
// (key kp valid iff kp <= qp when causal, kp > qp - window when window > 0),
// scale dh^-0.5, fp32 online softmax with the reference's -1e30 mask value
// and its 1e-30 floor on the normaliser, output in q's dtype.
//
// paged_attention_kernel replaces src/repro/kernels/paged_attention.py
// `paged_attention_pallas` (kernel `paged_attention_kernel`): one query
// token per sequence, q (B, H, dh) over a page pool k/v (n_phys, page, KH,
// dh) addressed through block_tables (B, P) int32; positions >= lengths[b]
// are masked; fp32 online softmax across pages.
//
// Design.  The TPU kernels walk a sequential grid and carry (m, l, acc) in
// VMEM scratch from one grid step to the next.  Here one thread block owns
// a whole softmax row set and loops over the key tiles itself:
//   * flash: one block per (query tile of 64 rows, head, batch row); the
//     Q tile and one 64-key K/V tile at a time sit in shared memory as fp32
//     (K rows padded by one word so that lanes reading different keys hit
//     different banks).  Each of the 8 warps owns 8 query rows; for a row,
//     lane c scores keys c and c + 32, the warp reduces max and sum with
//     shuffles, and then each lane accumulates dh / 32 output columns.
//     Key tiles that the causal or window mask hides from every row of the
//     query tile are skipped (the reference visits them; they add nothing
//     when a row has a valid key).  A query tile with a row that has no
//     valid key at all visits every tile, which reproduces the reference's
//     uniform average for such rows.  Sq and Sk need not be multiples of
//     the tile: rows past Sq are not written, keys past Sk do not exist.
//   * paged: one block per (KV head, batch row) serves that head's G query
//     heads, so each K/V page is read from memory once per group.  Pages are
//     read through the block table up to ceil(lengths[b] / page) (all P when
//     the length is 0, again the reference's uniform average); each page's
//     K/V for the head is staged in shared memory, and 4 warps take the G
//     heads in turn with the same per-row scheme as flash.
//
// What bounds them on the H100.  Both do their arithmetic in fp32 on the
// CUDA cores, not the tensor cores.  At the serving shapes (B 4, S 512,
// H 32, KH 8, dh 128) flash does ~4.3 GFLOP of causal work over ~8 MB of
// bf16 in and out: far above its memory time, and with fp32 FMAs it runs
// well below the bf16 tensor-core roofline (wgmma tiles are the known next
// step).  Paged decode moves ~8.6 MB of K/V per layer for ~17 MFLOP, so it
// is bound by bytes; with one block per (KV head, batch row) only
// B * KH = 32 blocks are in flight, so it cannot reach the memory rate
// until the pages of a row are split across blocks (flash-decoding).
#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;           // flash: query rows per block, keys per tile
constexpr int kFlashWarps = 8;
constexpr int kRowsPerWarp = kTile / kFlashWarps;
constexpr int kPagedWarps = 4;
constexpr int kMaxDh = 128;
constexpr int kDhPerLane = kMaxDh / 32;
constexpr int kMaxHeadsPerWarp = 8; // paged: G <= kPagedWarps * this
constexpr int kMaxPage = 128;
constexpr float kMasked = -1e30f;   // the reference's mask value

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

// ------------------------------------------------------------------ flash
template <typename T>
__global__ void __launch_bounds__(kFlashWarps * 32)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq,
                       int Sk, int H, int KH, int dh, int causal, int window,
                       float scale) {
  extern __shared__ float smem[];
  const int ldk = dh + 1;
  float* sQ = smem;                  // kTile x dh
  float* sK = sQ + kTile * dh;       // kTile x ldk
  float* sV = sK + kTile * ldk;      // kTile x dh
  float* sP = sV + kTile * dh;       // kFlashWarps x kTile
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < kTile * dh; i += blockDim.x) {
    const int r = i / dh, d = i - r * dh, qi = q0 + r;
    sQ[i] = qi < Sq ? to_f(q[((int64_t(b) * Sq + qi) * H + h) * dh + d])
                    : 0.f;
  }
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDhPerLane];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    m[j] = kMasked;
    l[j] = 0.f;
#pragma unroll
    for (int e = 0; e < kDhPerLane; ++e) acc[j][e] = 0.f;
  }

  // Keys to visit.  Each row's valid range only moves right as the row
  // grows, so the tile's last row decides whether every row has a key.
  const int q_last = min(q0 + kTile, Sq) - 1;
  const int lo_last = window > 0 ? max(0, q_last - window + 1) : 0;
  const int hi_last = causal ? min(Sk - 1, q_last) : Sk - 1;
  int k_begin = 0, k_end = Sk;
  if (lo_last <= hi_last) {
    if (causal) k_end = min(Sk, q_last + 1);
    if (window > 0) k_begin = max(0, q0 - window + 1);
  }

  for (int k0 = k_begin / kTile * kTile; k0 < k_end; k0 += kTile) {
    const int nk = min(kTile, Sk - k0);
    __syncthreads();                 // the previous tile is consumed
    for (int i = tid; i < nk * dh; i += blockDim.x) {
      const int c = i / dh, d = i - c * dh;
      const int64_t g = ((int64_t(b) * Sk + k0 + c) * KH + kh) * dh + d;
      sK[c * ldk + d] = to_f(k[g]);
      sV[c * dh + d] = to_f(v[g]);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const int r = warp + kFlashWarps * j, qi = q0 + r;
      if (qi >= Sq) continue;        // uniform across the warp
      const float* qrow = sQ + r * dh;
      float s[2];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int c = lane + 32 * t, kp = k0 + c;
        if (c < nk) {
          const float* krow = sK + c * ldk;
          float dot = 0.f;
          for (int d = 0; d < dh; ++d) dot = fmaf(qrow[d], krow[d], dot);
          bool ok = true;
          if (causal) ok = ok && kp <= qi;
          if (window > 0) ok = ok && kp > qi - window;
          s[t] = ok ? dot * scale : kMasked;
        } else {
          s[t] = -INFINITY;          // no such key
        }
      }
      const float m_new = fmaxf(m[j], warp_max(fmaxf(s[0], s[1])));
      const float alpha = expf(m[j] - m_new);
      const float p0 = lane < nk ? expf(s[0] - m_new) : 0.f;
      const float p1 = lane + 32 < nk ? expf(s[1] - m_new) : 0.f;
      l[j] = l[j] * alpha + warp_sum(p0 + p1);
      m[j] = m_new;
      float* prow = sP + warp * kTile;
      prow[lane] = p0;
      prow[lane + 32] = p1;
      __syncwarp();
#pragma unroll
      for (int e = 0; e < kDhPerLane; ++e) {
        const int d = lane + 32 * e;
        if (d < dh) {
          float a = acc[j][e] * alpha;
          for (int c = 0; c < nk; ++c) a = fmaf(prow[c], sV[c * dh + d], a);
          acc[j][e] = a;
        }
      }
      __syncwarp();
    }
  }

#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int r = warp + kFlashWarps * j, qi = q0 + r;
    if (qi >= Sq) continue;
    const float inv = 1.f / fmaxf(l[j], 1e-30f);
#pragma unroll
    for (int e = 0; e < kDhPerLane; ++e) {
      const int d = lane + 32 * e;
      if (d < dh)
        out[((int64_t(b) * Sq + qi) * H + h) * dh + d] =
            from_f<T>(acc[j][e] * inv);
    }
  }
}

// ------------------------------------------------------------------ paged
template <typename T>
__global__ void __launch_bounds__(kPagedWarps * 32)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp,
                       const int32_t* __restrict__ block_tables,
                       const int32_t* __restrict__ lengths,
                       T* __restrict__ out, int H, int KH, int dh, int page,
                       int P, float scale) {
  extern __shared__ float smem[];
  const int G = H / KH;
  const int ldk = dh + 1;
  float* sQ = smem;                  // G x dh
  float* sK = sQ + G * dh;           // page x ldk
  float* sV = sK + page * ldk;       // page x dh
  float* sP = sV + page * dh;        // kPagedWarps x page
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = lengths[b];
  const int n_pages = len > 0 ? min(P, (len + page - 1) / page) : P;

  for (int i = tid; i < G * dh; i += blockDim.x)
    sQ[i] = to_f(q[(int64_t(b) * H + kh * G) * dh + i]);
  float m[kMaxHeadsPerWarp], l[kMaxHeadsPerWarp];
  float acc[kMaxHeadsPerWarp][kDhPerLane];
#pragma unroll
  for (int j = 0; j < kMaxHeadsPerWarp; ++j) {
    m[j] = kMasked;
    l[j] = 0.f;
#pragma unroll
    for (int e = 0; e < kDhPerLane; ++e) acc[j][e] = 0.f;
  }

  for (int p = 0; p < n_pages; ++p) {
    const int64_t phys = block_tables[int64_t(b) * P + p];
    __syncthreads();                 // the previous page is consumed
    for (int i = tid; i < page * dh; i += blockDim.x) {
      const int c = i / dh, d = i - c * dh;
      const int64_t g = ((phys * page + c) * KH + kh) * dh + d;
      sK[c * ldk + d] = to_f(kp[g]);
      sV[c * dh + d] = to_f(vp[g]);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kMaxHeadsPerWarp; ++j) {
      const int g = warp + kPagedWarps * j;
      if (g >= G) break;             // uniform across the warp
      const float* qrow = sQ + g * dh;
      float s[kMaxPage / 32];
      float smax = -INFINITY;
#pragma unroll
      for (int t = 0; t < kMaxPage / 32; ++t) {
        const int c = lane + 32 * t;
        s[t] = -INFINITY;
        if (c < page) {
          const float* krow = sK + c * ldk;
          float dot = 0.f;
          for (int d = 0; d < dh; ++d) dot = fmaf(qrow[d], krow[d], dot);
          s[t] = p * page + c < len ? dot * scale : kMasked;
        }
        smax = fmaxf(smax, s[t]);
      }
      const float m_new = fmaxf(m[j], warp_max(smax));
      const float alpha = expf(m[j] - m_new);
      float* prow = sP + warp * page;
      float psum = 0.f;
#pragma unroll
      for (int t = 0; t < kMaxPage / 32; ++t) {
        const int c = lane + 32 * t;
        if (c < page) {
          const float pe = expf(s[t] - m_new);
          prow[c] = pe;
          psum += pe;
        }
      }
      l[j] = l[j] * alpha + warp_sum(psum);
      m[j] = m_new;
      __syncwarp();
#pragma unroll
      for (int e = 0; e < kDhPerLane; ++e) {
        const int d = lane + 32 * e;
        if (d < dh) {
          float a = acc[j][e] * alpha;
          for (int c = 0; c < page; ++c) a = fmaf(prow[c], sV[c * dh + d], a);
          acc[j][e] = a;
        }
      }
      __syncwarp();
    }
  }

#pragma unroll
  for (int j = 0; j < kMaxHeadsPerWarp; ++j) {
    const int g = warp + kPagedWarps * j;
    if (g >= G) break;
    const float inv = 1.f / fmaxf(l[j], 1e-30f);
#pragma unroll
    for (int e = 0; e < kDhPerLane; ++e) {
      const int d = lane + 32 * e;
      if (d < dh)
        out[(int64_t(b) * H + kh * G + g) * dh + d] =
            from_f<T>(acc[j][e] * inv);
    }
  }
}

template <typename T>
int launch_flash(const void* q, const void* k, const void* v, void* out,
                 int B, int Sq, int Sk, int H, int KH, int dh, int causal,
                 int window, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (kTile * dh * 2 + kTile * (dh + 1) + kFlashWarps * kTile);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kTile - 1) / kTile, H, B);
  flash_attention_kernel<T><<<grid, kFlashWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, H, KH, dh,
      causal, window, 1.f / sqrtf(static_cast<float>(dh)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_paged(const void* q, const void* kp, const void* vp,
                 const void* block_tables, const void* lengths, void* out,
                 int B, int H, int KH, int dh, int page, int P,
                 cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((H / KH) * dh + page * (dh + 1) +
                                       page * dh + kPagedWarps * page);
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(KH, B);
  paged_attention_kernel<T><<<grid, kPagedWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int32_t*>(block_tables),
      static_cast<const int32_t*>(lengths), static_cast<T*>(out), H, KH, dh,
      page, P, 1.f / sqrtf(static_cast<float>(dh)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Tensors are contiguous in the
// reference's layouts; 1 <= dh <= 128, H % KH == 0.
// q: (B, Sq, H, dh); k, v: (B, Sk, KH, dh); out: (B, Sq, H, dh).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int Sq, int Sk, int H, int KH,
                           int dh, int causal, int window, int dtype,
                           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_flash<float>(q, k, v, out, B, Sq, Sk, H, KH, dh, causal,
                               window, s);
  return launch_flash<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, KH, dh,
                                     causal, window, s);
}

// q: (B, H, dh); k_pages, v_pages: (n_phys, page, KH, dh);
// block_tables: (B, P) int32; lengths: (B,) int32; out: (B, H, dh).
// page <= 128; H / KH <= 32.
int paged_attention_launch(const void* q, const void* k_pages,
                           const void* v_pages, const void* block_tables,
                           const void* lengths, void* out, int B, int H,
                           int KH, int dh, int page, int P, int dtype,
                           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_paged<float>(q, k_pages, v_pages, block_tables, lengths,
                               out, B, H, KH, dh, page, P, s);
  return launch_paged<__nv_bfloat16>(q, k_pages, v_pages, block_tables,
                                     lengths, out, B, H, KH, dh, page, P, s);
}

const char* attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
