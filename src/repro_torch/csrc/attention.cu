// GQA attention for Hopper (sm_90a): prefill flash attention and paged
// decode attention.
//
// What they replace.
//   * flash_attention_bf16_kernel and flash_attention_f32_kernel replace
//     src/repro/kernels/flash_attention.py `flash_attention_pallas` (kernel
//     `flash_attention_kernel`): forward attention of q (B, Sq, H, dh) over
//     k/v (B, Sk, KH, dh), query head h reading KV head h / (H / KH),
//     causal and/or sliding-window mask (key kp valid iff kp <= qp when
//     causal, kp > qp - window when window > 0), scale dh^-0.5, fp32 online
//     softmax with the reference's -1e30 mask value and its 1e-30 floor on
//     the normaliser, output in q's dtype.
//   * paged_attention_split_kernel + paged_attention_combine_kernel replace
//     src/repro/kernels/paged_attention.py `paged_attention_pallas` (kernel
//     `paged_attention_kernel`): one query token per sequence, q (B, H, dh)
//     over a page pool k/v (n_phys, page, KH, dh) addressed through
//     block_tables (B, P) int32; positions >= lengths[b] are masked; fp32
//     softmax across pages.
//
// The TPU kernels walk a sequential grid and carry (m, l, acc) in VMEM
// scratch from one grid step to the next.  Blocks on the H100 run in no
// order, so a loop inside the block takes the place of the sequential axis.
//
// Masking, shared by both flash kernels.  Key tiles that the causal or
// window mask hides from every row of a query tile are skipped (the
// reference visits them; they add exactly nothing when a row has a valid
// key).  A query tile with a row that has no valid key at all visits every
// tile, which reproduces the reference's uniform average for such rows.
// Keys that do not exist (past Sk) get p = 0; masked keys that exist score
// -1e30.  Sq and Sk need not be multiples of the tile.
//
// bf16 flash.  At the serving shape (B 4, S 512, H 32, KH 8, dh 128,
// causal) it does 8.6 GFLOP over 42 MB of q, k, v and out: its byte bound
// (0.0125 ms) and its bf16 tensor-core bound (0.0087 ms) lie close, while
// the same FLOPs as fp32 FMAs on the CUDA cores need at least 0.13 ms, so
// only the tensor cores can come near the bound.  Design (FlashAttention-2
// layout on mma.sync.m16n8k16, bf16 inputs, fp32 accumulation): a block of
// 4 warps owns 64 query rows of one head; each warp owns 16 rows, and its
// Q fragments stay in registers (ldmatrix).  S = Q K^T accumulates in
// registers; row max and row sum reduce across the lane quad with
// shuffles; P is rounded to bf16 in registers and fed back as the A operand
// of O += P V, with V read by ldmatrix.trans; O stays in fp32 registers
// until the epilogue divides by max(l, 1e-30) and writes bf16 with 16-byte
// stores.  K/V tiles of 64 keys arrive by 16-byte cp.async into a 2-stage
// ring, the next tile's copy in flight while the current one is computed;
// every tile row is dh padded with zeros to DP (16, 32, 64, 128 or 256) and
// XOR-swizzled in 16-byte chunks so that ldmatrix reads no two chunks from
// one bank group.  Rows not 16-byte aligned (dh % 8 != 0) are loaded
// element by element instead.  Up to DP 128, Q waits in the ring's second
// stage until its fragments are in registers, so a block holds 64 KB at
// DP 128 and three blocks share an SM.  At DP 256 the O accumulators alone
// take 128 fp32 registers a thread, and Q's fragments would add 64: Q gets
// its own 32 KB of shared memory beside the 128 KB ring and is re-read by
// ldmatrix at every k-step, and one block runs per SM (160 KB).  On the
// causal diagonal a warp skips the 16-key groups past its last row.  The grid puts the query tile on its slowest
// axis, reversed, so the heaviest causal tiles start first.  The one
// numerical change from the reference: P is rounded to bf16 before the
// P V product (l is summed from the fp32 P).  Each row's result depends
// only on its own (b, h) sequence and is the same from run to run.
//
// f32 flash stays on the CUDA cores (fp32 FMAs):
// TF32 tensor-core products keep about 10 mantissa bits and cannot hold
// float32's 2e-5 contract.  One block owns 64 query rows; 8 warps take 8
// rows each, lane c scoring keys c and c + 32 and owning output columns
// c, c + 32, ... (dh up to 256: 199 KB of shared memory at dh 256).
//
// Paged decode: bound by bytes.  One decode step reads each live K/V row
// once (8.6 MB at the serving shape) for 34 MFLOP.  One block per (KV
// head, batch row) would leave 32 blocks for 132 SMs, so each
// row's pages are split into runs of `pps` pages (flash-decoding): the grid
// is (splits, KH, B), and `pps` and `splits` come from the shape alone
// (kernels/attention.py `paged_splits`, which also ignores B, so that a
// row's rounding never depends on the rest of the batch).  A block serves
// the whole GQA group of its KV head, so each page is read once per group;
// it copies tiles of K and V as they are stored (bf16 or f32, no fp32
// staging) by 16-byte cp.async into a 2-stage ring (64 positions a tile,
// 32 where a row is wider than 512 bytes: f32 at dh > 128), scores them
// with one half-warp per key, runs the online softmax for its split and
// writes (m, l, acc) in fp32 to scratch.  A block holds at most
// kMaxPairs x 128 (head, 16-byte chunk) outputs: G x ceil(dh x size / 16)
// <= 1,024, which the wrapper checks (G 10 at dh 256 is 320 in bf16 and
// 640 in f32).  A block whose first page lies at
// or past its row's ceil(length / page) returns at once (length 0 keeps
// all P pages: the reference's uniform average).  The combine kernel then
// merges each row's live splits in increasing order: an empty split never
// enters the max, there are no float atomics, and the result is
// deterministic.  Each wrapper call is two kernel launches.
#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kMasked = -1e30f;   // the reference's mask value
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, asynchronously; zero-fills when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ------------------------------------------------------------ f32 flash
constexpr int kTile = 64;           // query rows per block, keys per tile
constexpr int kFlashWarps = 8;
constexpr int kRowsPerWarp = kTile / kFlashWarps;
constexpr int kMaxDh = 256;         // both kernels' head-dim limit
constexpr int kDhPerLane = kMaxDh / 32;

// The visited key range [k_begin, k_end) of the query tile [q0, q0 + rows);
// returns whether every row of the tile has a valid key.  Each row's valid
// range only moves right as the row grows, so the tile's last row decides;
// if one row has no key, the tile visits every key.
__device__ __forceinline__ bool key_range(int q0, int rows, int Sq, int Sk,
                                          int causal, int window,
                                          int& k_begin, int& k_end) {
  const int q_last = min(q0 + rows, Sq) - 1;
  const int lo_last = window > 0 ? max(0, q_last - window + 1) : 0;
  const int hi_last = causal ? min(Sk - 1, q_last) : Sk - 1;
  k_begin = 0;
  k_end = Sk;
  if (lo_last > hi_last) return false;
  if (causal) k_end = min(Sk, q_last + 1);
  if (window > 0) k_begin = max(0, q0 - window + 1);
  return true;
}

__global__ void __launch_bounds__(kFlashWarps * 32)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out, int Sq, int Sk, int H,
                           int KH, int dh, int causal, int window,
                           float scale) {
  extern __shared__ float smem_f32[];
  const int ldk = dh + 1;            // padded: lanes on different keys hit
  float* sQ = smem_f32;              // different banks; kTile x dh
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
    sQ[i] = qi < Sq ? q[((int64_t(b) * Sq + qi) * H + h) * dh + d] : 0.f;
  }
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDhPerLane];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    m[j] = kMasked;
    l[j] = 0.f;
#pragma unroll
    for (int e = 0; e < kDhPerLane; ++e) acc[j][e] = 0.f;
  }
  int k_begin, k_end;
  key_range(q0, kTile, Sq, Sk, causal, window, k_begin, k_end);

  for (int k0 = k_begin / kTile * kTile; k0 < k_end; k0 += kTile) {
    const int nk = min(kTile, Sk - k0);
    __syncthreads();                 // the previous tile is consumed
    for (int i = tid; i < nk * dh; i += blockDim.x) {
      const int c = i / dh, d = i - c * dh;
      const int64_t g = ((int64_t(b) * Sk + k0 + c) * KH + kh) * dh + d;
      sK[c * ldk + d] = k[g];
      sV[c * dh + d] = v[g];
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
        out[((int64_t(b) * Sq + qi) * H + h) * dh + d] = acc[j][e] * inv;
    }
  }
}

// ------------------------------------------------------------ bf16 flash
constexpr int kBM = 64;             // query rows per block (16 per warp)
constexpr int kBN = 64;             // keys per K/V tile
constexpr int kMmaWarps = kBM / 16;

// Byte offset of 16-byte chunk c of row r in a tile of C chunks a row.
// The XOR swizzle puts the 8 rows that one ldmatrix phase reads at the same
// logical chunk into 8 different 16-byte bank groups.
template <int C>
__device__ __forceinline__ int chunk_off(int r, int c) {
  int x;
  if constexpr (C >= 8) {
    x = c ^ (r & 7);
  } else {
    x = c ^ ((r / (8 / C)) & (C - 1));
  }
  return (r * C + x) * 16;
}

// The ROWS rows of a tile from global rows `stride` elements apart into a
// swizzled shared tile; rows >= valid and columns >= dh read as 0
// (the tile's pad columns were zeroed once and are never written).
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile(char* dst, const bf16* src,
                                          int64_t stride, int valid, int dh,
                                          bool vec16, int tid) {
  constexpr int C = DP / 8;
  constexpr int kThreads = kMmaWarps * 32;
  if (vec16 && dh == DP) {           // full rows: the loop unrolls
#pragma unroll
    for (int it = 0; it < (ROWS * C + kThreads - 1) / kThreads; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / C, c = i % C;
      const bool ok = r < valid;
      if (ROWS * C % kThreads == 0 || i < ROWS * C)
        cp_async16(smem_u32(dst + chunk_off<C>(r, c)),
                   ok ? src + r * stride + c * 8 : src, ok);
    }
  } else if (vec16) {
    const int cv = dh >> 3;          // chunks that hold data
    for (int i = tid; i < ROWS * cv; i += kThreads) {
      const int r = i / cv, c = i - r * cv;
      const bool ok = r < valid;
      cp_async16(smem_u32(dst + chunk_off<C>(r, c)),
                 ok ? src + r * stride + c * 8 : src, ok);
    }
  } else {
    for (int i = tid; i < ROWS * dh; i += kThreads) {
      const int r = i / dh, d = i - r * dh;
      const bf16 x = r < valid ? src[r * stride + d] : __float2bfloat16(0.f);
      *reinterpret_cast<bf16*>(dst + chunk_off<C>(r, d >> 3) + (d & 7) * 2) =
          x;
    }
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr,
                                                  uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Q's fragments live in registers up to DP 128; at DP 256 they are read
// from shared memory at each k-step (see the header).
template <int DP>
__host__ __device__ constexpr bool q_in_registers() { return DP <= 128; }
template <int DP>
__host__ __device__ constexpr int flash_smem_bytes() {
  return 4 * kBN * DP * 2 + (q_in_registers<DP>() ? 0 : kBM * DP * 2);
}

template <int DP>
__global__ void __launch_bounds__(kMmaWarps * 32, (DP <= 128 ? 3 : 1))
flash_attention_bf16_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            bf16* __restrict__ out, int Sq, int Sk, int H,
                            int KH, int dh, int causal, int window,
                            float scale_log2, int vec16) {
  constexpr int C = DP / 8;          // 16-byte chunks per tile row
  constexpr int TB = kBN * DP * 2;   // bytes per K or V tile
  constexpr int NT = kBN / 8;        // n-tiles of S per warp
  constexpr int DT = DP / 8;         // n-tiles of O per warp
  constexpr bool QREG = q_in_registers<DP>();
  static_assert(kBM <= 2 * kBN, "Q and the output fit in one stage");
  // stage s holds K at smem_mma + 2 s TB and V right after it; Q waits in
  // stage 1 until its fragments are loaded (QREG) or has its own region
  // after the ring; the output leaves via stage 0
  extern __shared__ __align__(128) char smem_mma[];
  char* sQ = smem_mma + (QREG ? 2 : 4) * TB;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBM;   // heaviest first
  const int kh = h / (H / KH);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;   // mma fragment row, column pair
  const int mi = lane >> 3, ri = lane & 7;   // ldmatrix matrix, row

  for (int i = tid; i < flash_smem_bytes<DP>() / 16; i += blockDim.x)
    reinterpret_cast<int4*>(smem_mma)[i] = make_int4(0, 0, 0, 0);
  __syncthreads();

  const int64_t q_stride = int64_t(H) * dh, kv_stride = int64_t(KH) * dh;
  const bf16* qg = q + ((int64_t(b) * Sq + q0) * H + h) * dh;
  const bf16* kg = k + (int64_t(b) * Sk * KH + kh) * dh;
  const bf16* vg = v + (int64_t(b) * Sk * KH + kh) * dh;
  int k_begin, k_end;
  const bool every_row_has_key =
      key_range(q0, kBM, Sq, Sk, causal, window, k_begin, k_end);
  const int kt_begin = k_begin / kBN, kt_end = (k_end + kBN - 1) / kBN;
  const int q_last = min(q0 + kBM, Sq) - 1;
  // With every row holding a key, keys past a warp's last row add exactly
  // nothing (p = 0): on the causal diagonal the warp skips their 16-key
  // groups.  A fully masked row needs them all (its uniform average).
  const bool skip_future = causal && every_row_has_key;
  const int warp_last = q0 + warp * 16 + 15;

  load_tile<DP, kBM>(sQ, qg, q_stride, Sq - q0, dh, vec16, tid);
  load_tile<DP, kBN>(smem_mma, kg + int64_t(kt_begin) * kBN * kv_stride,
                     kv_stride, Sk - kt_begin * kBN, dh, vec16, tid);
  load_tile<DP, kBN>(smem_mma + TB, vg + int64_t(kt_begin) * kBN * kv_stride,
                     kv_stride, Sk - kt_begin * kBN, dh, vec16, tid);
  cp_async_commit();

  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
    o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = kMasked, m1 = kMasked, l0 = 0.f, l1 = 0.f;
  uint32_t qf[QREG ? DP / 16 : 1][4];
  const int qi0 = q0 + warp * 16 + gq, qi1 = qi0 + 8;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int st = (kt - kt_begin) & 1;
    cp_async_wait_all();
    __syncthreads();                 // tile kt landed; stage st^1 is free
    if constexpr (QREG) {
      if (kt == kt_begin) {
#pragma unroll
        for (int ks = 0; ks < DP / 16; ++ks)
          ldmatrix_x4(smem_u32(sQ + chunk_off<C>(warp * 16 + (lane & 15),
                                                 ks * 2 + (lane >> 4))),
                      qf[ks]);
        __syncthreads();             // Q's stage is free for tile kt + 1
      }
    }
    if (kt + 1 < kt_end) {
      const int64_t off = int64_t(kt + 1) * kBN * kv_stride;
      char* nK = smem_mma + (st ^ 1) * 2 * TB;
      load_tile<DP, kBN>(nK, kg + off, kv_stride, Sk - (kt + 1) * kBN, dh,
                         vec16, tid);
      load_tile<DP, kBN>(nK + TB, vg + off, kv_stride, Sk - (kt + 1) * kBN,
                         dh, vec16, tid);
      cp_async_commit();
    }
    const char* cK = smem_mma + st * 2 * TB;
    const char* cV = cK + TB;
    const int k0 = kt * kBN;
    const int groups = skip_future ? min(kBN / 16, (warp_last - k0) / 16 + 1)
                                   : kBN / 16;   // 16-key groups to compute

    // S = Q K^T: 16 rows x kBN keys per warp
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      uint32_t qa[4];                // this k-step's Q fragment
      if constexpr (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[ks][e];
      } else {
        ldmatrix_x4(smem_u32(sQ + chunk_off<C>(warp * 16 + (lane & 15),
                                               ks * 2 + (lane >> 4))),
                    qa);
      }
      uint32_t bk[NT / 2][4];        // this k-step's K fragments, then mma
#pragma unroll
      for (int j = 0; j < NT / 2; ++j)
        if (j < groups)              // uniform across the warp
          ldmatrix_x4(smem_u32(cK + chunk_off<C>(j * 16 + (mi >> 1) * 8 + ri,
                                                 ks * 2 + (mi & 1))),
                      bk[j]);
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        if (j >= groups) continue;
        mma_bf16(s[2 * j], qa, bk[j][0], bk[j][1]);
        mma_bf16(s[2 * j + 1], qa, bk[j][2], bk[j][3]);
      }
    }

    // scale (log2 domain) and mask; only edge tiles test each key
    const bool edge = k0 + kBN > Sk || (causal && k0 + kBN - 1 > q0) ||
                      (window > 0 && k0 <= q_last - window);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int kp = k0 + j * 8 + t4 * 2 + (e & 1);
          const int qi = e < 2 ? qi0 : qi1;
          bool ok = true;
          if (causal) ok = ok && kp <= qi;
          if (window > 0) ok = ok && kp > qi - window;
          x = kp >= Sk ? -INFINITY : (ok ? x : kMasked);
        }
        s[j][e] = x;
      }
    }

    // online softmax: rows gq and gq + 8, reduced across the lane quad
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(~0u, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(~0u, mx1, o_));
    }
    const float a0 = exp2f(m0 - mx0), a1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = exp2f(s[j][0] - m0);
      s[j][1] = exp2f(s[j][1] - m0);
      s[j][2] = exp2f(s[j][2] - m1);
      s[j][3] = exp2f(s[j][3] - m1);
      rs0 += s[j][0] + s[j][1];
      rs1 += s[j][2] + s[j][3];
    }
    l0 = l0 * a0 + rs0;              // lane-partial; reduced at the end
    l1 = l1 * a1 + rs1;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      o[j][0] *= a0;
      o[j][1] *= a0;
      o[j][2] *= a1;
      o[j][3] *= a1;
    }

    // O += P V, P as bf16 A fragments straight from the S accumulators
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      if (kk >= groups) continue;    // p = 0 for all these keys
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      constexpr int VG = DP / 16 < 4 ? DP / 16 : 4;   // V fragments a batch
#pragma unroll
      for (int j0 = 0; j0 < DP / 16; j0 += VG) {
        uint32_t bv[VG][4];
#pragma unroll
        for (int j = 0; j < VG; ++j)
          ldmatrix_x4_trans(
              smem_u32(cV + chunk_off<C>(kk * 16 + (mi & 1) * 8 + ri,
                                         (j0 + j) * 2 + (mi >> 1))),
              bv[j]);
#pragma unroll
        for (int j = 0; j < VG; ++j) {
          mma_bf16(o[2 * (j0 + j)], pa, bv[j][0], bv[j][1]);
          mma_bf16(o[2 * (j0 + j) + 1], pa, bv[j][2], bv[j][3]);
        }
      }
    }
  }

  // epilogue: O / max(l, 1e-30) as bf16 into this warp's rows of stage
  // 0, then out in 16-byte stores (rows past Sq are not written)
  __syncthreads();                   // every warp is done with the tiles
  char* sO = smem_mma;
#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l0 += __shfl_xor_sync(~0u, l0, o_);
    l1 += __shfl_xor_sync(~0u, l1, o_);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int r0 = warp * 16 + gq;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    *reinterpret_cast<uint32_t*>(sO + chunk_off<C>(r0, j) + t4 * 4) =
        pack_bf16(o[j][0] * inv0, o[j][1] * inv0);
    *reinterpret_cast<uint32_t*>(sO + chunk_off<C>(r0 + 8, j) + t4 * 4) =
        pack_bf16(o[j][2] * inv1, o[j][3] * inv1);
  }
  __syncwarp();
  bf16* og = out + ((int64_t(b) * Sq + q0 + warp * 16) * H + h) * dh;
  const int rows = min(16, Sq - q0 - warp * 16);
  if (vec16) {
    const int cv = dh >> 3;
    for (int i = lane; i < rows * cv; i += 32) {
      const int r = i / cv, c = i - r * cv;
      *reinterpret_cast<int4*>(og + r * q_stride + c * 8) =
          *reinterpret_cast<const int4*>(sO +
                                         chunk_off<C>(warp * 16 + r, c));
    }
  } else {
    for (int i = lane; i < rows * dh; i += 32) {
      const int r = i / dh, d = i - r * dh;
      og[r * q_stride + d] = *reinterpret_cast<const bf16*>(
          sO + chunk_off<C>(warp * 16 + r, d >> 3) + (d & 7) * 2);
    }
  }
}

// ------------------------------------------------------------ paged
constexpr int kPagedThreads = 128;
constexpr int kPagedWarps = kPagedThreads / 32;
constexpr int kPagedTile = 64;      // key positions per tile, at the most
constexpr int kMaxGroup = 32;
constexpr int kMaxHeadsPerWarp = kMaxGroup / kPagedWarps;
// (head, 16-byte chunk) outputs per thread; a block holds kMaxPairs x
// kPagedThreads of them (the wrapper checks G x chunks against it)
constexpr int kMaxPairs = 8;
// positions a tile: 64, or 32 where 2 x 2 tiles of 64 would pass 128 KB
__host__ __device__ constexpr int paged_tile(int row_bytes) {
  return row_bytes <= 512 ? kPagedTile : kPagedTile / 2;
}

// Tile rows [0, nk) = key positions [p0, p0 + nk) of row b through the
// block table, as stored, into `dst` (rows of RB bytes).  Unaligned rows
// (vec16 false) go element by element, with the row's pad zeroed.
template <typename T>
__device__ __forceinline__ void load_page_tile(
    char* dst, const T* __restrict__ pool, const int32_t* __restrict__ bt_row,
    int p0, int nk, int page, int KH, int kh, int dh, int NC, bool vec16) {
  constexpr int EPC = 16 / sizeof(T);
  const int tid = threadIdx.x;
  if (vec16) {
#pragma unroll 4
    for (int i = tid; i < nk * NC; i += kPagedThreads) {
      const int r = i / NC, c = i - r * NC;
      const int pos = p0 + r, pg = pos / page;
      const int64_t row = int64_t(bt_row[pg]) * page + (pos - pg * page);
      cp_async16(smem_u32(dst + (r * NC + c) * 16),
                 pool + (row * KH + kh) * dh + c * EPC, true);
    }
  } else {
    const int dpad = NC * EPC;
    for (int i = tid; i < nk * dpad; i += kPagedThreads) {
      const int r = i / dpad, d = i - r * dpad;
      const int pos = p0 + r, pg = pos / page;
      const int64_t row = int64_t(bt_row[pg]) * page + (pos - pg * page);
      reinterpret_cast<T*>(dst + r * NC * 16)[d] =
          d < dh ? pool[(row * KH + kh) * dh + d] : from_f<T>(0.f);
    }
  }
}

// One 16-byte chunk of a tile row as floats: 4 float32 or 8 bfloat16 (the
// array's length names the type).
__device__ __forceinline__ void chunk_to_f(const char* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void chunk_to_f(const char* p, float (&x)[8]) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

template <typename T>
__global__ void __launch_bounds__(kPagedThreads)
paged_attention_split_kernel(const T* __restrict__ q,
                             const T* __restrict__ kpool,
                             const T* __restrict__ vpool,
                             const int32_t* __restrict__ block_tables,
                             const int32_t* __restrict__ lengths,
                             float* __restrict__ part_acc,
                             float* __restrict__ part_ml, int H, int KH,
                             int dh, int page, int P, int pps, int splits,
                             float scale, int vec16) {
  constexpr int EPC = 16 / sizeof(T);
  const int s = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int len = lengths[b];
  const int n_pages = len > 0 ? min(P, (len + page - 1) / page) : P;
  if (s * pps >= n_pages) return;    // nothing live in this split
  const int G = H / KH;
  const int NC = (dh * int(sizeof(T)) + 15) / 16;   // chunks per row
  const int DPAD = NC * EPC;
  const int RB = NC * 16;
  const int tile = paged_tile(RB);
  const int pos_begin = s * pps * page;
  const int pos_end = min((s + 1) * pps, n_pages) * page;
  const int n_tiles = (pos_end - pos_begin + tile - 1) / tile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  extern __shared__ __align__(16) char smem_paged[];
  float* sQ = reinterpret_cast<float*>(smem_paged);  // G x DPAD
  float* sS = sQ + G * DPAD;                          // G x kPagedTile
  float* sAlpha = sS + G * kPagedTile;                // G, padded to 4
  char* sKV = reinterpret_cast<char*>(sAlpha + ((G + 3) & ~3));
  const int TB = tile * RB;                           // one K or V tile
  const int32_t* bt_row = block_tables + int64_t(b) * P;
  const T* qh = q + (int64_t(b) * H + kh * G) * dh;

#pragma unroll 4
  for (int i = tid; i < G * DPAD; i += kPagedThreads) {
    const int g = i / DPAD, d = i - g * DPAD;
    sQ[i] = d < dh ? to_f(qh[g * dh + d]) : 0.f;
  }
  {
    const int nk = min(tile, pos_end - pos_begin);
    load_page_tile<T>(sKV, kpool, bt_row, pos_begin, nk, page, KH, kh, dh,
                      NC, vec16);
    load_page_tile<T>(sKV + TB, vpool, bt_row, pos_begin, nk, page, KH, kh,
                      dh, NC, vec16);
    cp_async_commit();
  }

  // softmax state of heads warp, warp + 4, ... (held by every lane)
  float m_r[kMaxHeadsPerWarp], l_r[kMaxHeadsPerWarp];
#pragma unroll
  for (int j = 0; j < kMaxHeadsPerWarp; ++j) {
    m_r[j] = kMasked;
    l_r[j] = 0.f;
  }
  // P V ownership: (head, chunk) pairs, keys split KS ways when pairs are
  // fewer than threads; each partial is rescaled on its own and summed at
  // the end
  const int items = G * NC;
  const int KS = items >= kPagedThreads ? 1 : kPagedThreads / items;
  const int kpart = KS == 1 ? 0 : tid / items;
  const int pair0 = KS == 1 ? tid : tid % items;
  const bool active = kpart < KS;
  float acc[kMaxPairs][EPC];
#pragma unroll
  for (int j = 0; j < kMaxPairs; ++j)
#pragma unroll
    for (int e = 0; e < EPC; ++e) acc[j][e] = 0.f;

  const int hw = lane >> 4, hl = lane & 15;   // half-warp, lane in it
  constexpr int U = kMaxDh * int(sizeof(T)) / 256;   // chunks a lane, at most
  for (int t = 0; t < n_tiles; ++t) {
    const int p0 = pos_begin + t * tile;
    const int nk = min(tile, pos_end - p0);
    const char* cK = sKV + (t & 1) * 2 * TB;
    const char* cV = cK + TB;
    cp_async_wait_all();
    __syncthreads();                 // tile t landed; the other stage free
    if (t + 1 < n_tiles) {
      char* nK = sKV + ((t + 1) & 1) * 2 * TB;
      const int nk1 = min(tile, pos_end - p0 - tile);
      load_page_tile<T>(nK, kpool, bt_row, p0 + tile, nk1, page, KH, kh, dh,
                        NC, vec16);
      load_page_tile<T>(nK + TB, vpool, bt_row, p0 + tile, nk1, page, KH,
                        kh, dh, NC, vec16);
      cp_async_commit();
    }

    // scores: one half-warp per key, lane hl on chunks hl, hl + 16, ...
    for (int c0 = warp * 2; c0 < nk; c0 += 2 * kPagedWarps) {
      const int c = c0 + hw;
      const bool have = c < nk;
      float kx[U][EPC];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int ch = hl + 16 * u;
        if (have && ch < NC) {
          chunk_to_f(cK + c * RB + ch * 16, kx[u]);
        } else {
#pragma unroll
          for (int e = 0; e < EPC; ++e) kx[u][e] = 0.f;
        }
      }
      const bool live = p0 + c < len;
#pragma unroll 4
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int ch = hl + 16 * u;
          if (ch < NC) {
            const float4* qc =
                reinterpret_cast<const float4*>(sQ + g * DPAD + ch * EPC);
#pragma unroll
            for (int e = 0; e < EPC; e += 4) {
              const float4 q4 = qc[e / 4];
              part = fmaf(kx[u][e], q4.x, part);
              part = fmaf(kx[u][e + 1], q4.y, part);
              part = fmaf(kx[u][e + 2], q4.z, part);
              part = fmaf(kx[u][e + 3], q4.w, part);
            }
          }
        }
#pragma unroll
        for (int o_ = 8; o_ > 0; o_ >>= 1)
          part += __shfl_xor_sync(~0u, part, o_);
        if (have && hl == 0)
          sS[g * kPagedTile + c] = live ? part * scale : kMasked;
      }
    }
    __syncthreads();

    // online softmax, one warp per head
#pragma unroll
    for (int j = 0; j < kMaxHeadsPerWarp; ++j) {
      const int g = warp + kPagedWarps * j;
      if (g >= G) break;             // uniform across the warp
      float* srow = sS + g * kPagedTile;
      const float s0 = lane < nk ? srow[lane] : -INFINITY;
      const float s1 = lane + 32 < nk ? srow[lane + 32] : -INFINITY;
      const float m_new = fmaxf(m_r[j], warp_max(fmaxf(s0, s1)));
      const float alpha = expf(m_r[j] - m_new);
      const float p0v = lane < nk ? expf(s0 - m_new) : 0.f;
      const float p1v = lane + 32 < nk ? expf(s1 - m_new) : 0.f;
      if (lane < nk) srow[lane] = p0v;
      if (lane + 32 < nk) srow[lane + 32] = p1v;
      l_r[j] = l_r[j] * alpha + warp_sum(p0v + p1v);
      m_r[j] = m_new;
      if (lane == 0) sAlpha[g] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + P V over this thread's keys
#pragma unroll
    for (int j = 0; j < kMaxPairs; ++j) {
      const int pair = pair0 + j * kPagedThreads;
      if (active && pair < items) {
        const int g = pair / NC, ch = pair - g * NC;
        const float alpha = sAlpha[g];
#pragma unroll
        for (int e = 0; e < EPC; ++e) acc[j][e] *= alpha;
        const float* prow = sS + g * kPagedTile;
        for (int c = kpart; c < nk; c += KS) {
          float vx[EPC];
          chunk_to_f(cV + c * RB + ch * 16, vx);
          const float p = prow[c];
#pragma unroll
          for (int e = 0; e < EPC; ++e) acc[j][e] = fmaf(p, vx[e], acc[j][e]);
        }
      }
    }
  }

  // the split's partials: (m, l) per head, acc per head in fp32
  const int64_t head0 = int64_t(b) * H + kh * G;
#pragma unroll
  for (int j = 0; j < kMaxHeadsPerWarp; ++j) {
    const int g = warp + kPagedWarps * j;
    if (g >= G) break;
    if (lane == 0) {
      float* ml = part_ml + ((head0 + g) * splits + s) * 2;
      ml[0] = m_r[j];
      ml[1] = l_r[j];
    }
  }
  if (KS == 1) {
#pragma unroll
    for (int j = 0; j < kMaxPairs; ++j) {
      const int pair = pair0 + j * kPagedThreads;
      if (pair < items) {
        const int g = pair / NC, ch = pair - g * NC;
        float* dst = part_acc + ((head0 + g) * splits + s) * dh + ch * EPC;
#pragma unroll
        for (int e = 0; e < EPC; ++e)
          if (ch * EPC + e < dh) dst[e] = acc[j][e];
      }
    }
  } else {
    float* red = reinterpret_cast<float*>(sKV);   // KS x items x EPC
    __syncthreads();                 // every thread is done with the tiles
    if (active) {
#pragma unroll
      for (int e = 0; e < EPC; ++e)
        red[(kpart * items + pair0) * EPC + e] = acc[0][e];
    }
    __syncthreads();
    if (tid < items) {
      const int g = tid / NC, ch = tid - g * NC;
      float* dst = part_acc + ((head0 + g) * splits + s) * dh + ch * EPC;
#pragma unroll
      for (int e = 0; e < EPC; ++e) {
        float x = 0.f;
        for (int kp = 0; kp < KS; ++kp) x += red[(kp * items + tid) * EPC + e];
        if (ch * EPC + e < dh) dst[e] = x;
      }
    }
  }
}

// Merges each row's live splits in increasing order: one block per (head,
// row), one thread per output column (dh rounded up to a warp); the
// splits' (m, l) are read into shared memory once.
template <typename T>
__global__ void __launch_bounds__(kMaxDh)
paged_attention_combine_kernel(const float* __restrict__ part_acc,
                               const float* __restrict__ part_ml,
                               const int32_t* __restrict__ lengths,
                               T* __restrict__ out, int H, int dh, int page,
                               int P, int pps, int splits) {
  extern __shared__ float sml[];     // (m, l) of each live split
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int len = lengths[b];
  const int n_pages = len > 0 ? min(P, (len + page - 1) / page) : P;
  const int n_live = (n_pages + pps - 1) / pps;
  const int64_t head = int64_t(b) * H + h;
  for (int i = d; i < 2 * n_live; i += blockDim.x)
    sml[i] = part_ml[head * splits * 2 + i];
  __syncthreads();
  float M = kMasked;
  for (int s = 0; s < n_live; ++s) M = fmaxf(M, sml[2 * s]);
  float L = 0.f, A = 0.f;
  const float* acc = part_acc + head * splits * dh + d;
#pragma unroll 4
  for (int s = 0; s < n_live; ++s) {
    const float w = expf(sml[2 * s] - M);
    L = fmaf(w, sml[2 * s + 1], L);
    if (d < dh) A = fmaf(w, acc[int64_t(s) * dh], A);
  }
  if (d < dh) out[head * dh + d] = from_f<T>(A / fmaxf(L, 1e-30f));
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
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
  if (dev < 64 && bytes <= granted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < 64) granted[dev] = bytes;
  return err;
}

int launch_flash_f32(const void* q, const void* k, const void* v, void* out,
                     int B, int Sq, int Sk, int H, int KH, int dh, int causal,
                     int window, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (kTile * dh * 2 + kTile * (dh + 1) + kFlashWarps * kTile);
  cudaError_t err = allow_smem<flash_attention_f32_kernel>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kTile - 1) / kTile, H, B);
  flash_attention_f32_kernel<<<grid, kFlashWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Sk, H, KH,
      dh, causal, window, 1.f / sqrtf(static_cast<float>(dh)));
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_flash_bf16(const void* q, const void* k, const void* v, void* out,
                      int B, int Sq, int Sk, int H, int KH, int dh, int causal,
                      int window, cudaStream_t stream) {
  const size_t smem = flash_smem_bytes<DP>();
  cudaError_t err = allow_smem<flash_attention_bf16_kernel<DP>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec16 = dh % 8 == 0 && aligned16(q) && aligned16(k) &&
                    aligned16(v) && aligned16(out);
  const dim3 grid(H, B, (Sq + kBM - 1) / kBM);
  flash_attention_bf16_kernel<DP><<<grid, kMmaWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), Sq, Sk, H, KH, dh,
      causal, window, kLog2e / sqrtf(static_cast<float>(dh)), vec16);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_paged(const void* q, const void* kp, const void* vp,
                 const void* block_tables, const void* lengths,
                 void* part_acc, void* part_ml, void* out, int B, int H,
                 int KH, int dh, int page, int P, int pps, int splits,
                 cudaStream_t stream) {
  const int G = H / KH;
  const int NC = (dh * int(sizeof(T)) + 15) / 16;
  const int dpad = NC * (16 / int(sizeof(T)));
  const size_t tiles = size_t(4) * paged_tile(NC * 16) * NC * 16;  // 2 x (K, V)
  const size_t red = sizeof(float) * kPagedThreads * (16 / sizeof(T));
  const size_t smem = sizeof(float) * (size_t(G) * dpad +
                                       size_t(G) * kPagedTile +
                                       ((G + 3) & ~3)) +
                      (tiles > red ? tiles : red);
  cudaError_t err = allow_smem<paged_attention_split_kernel<T>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec16 = (dh * int(sizeof(T))) % 16 == 0 && aligned16(kp) &&
                    aligned16(vp);
  paged_attention_split_kernel<T>
      <<<dim3(splits, KH, B), kPagedThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(kp),
          static_cast<const T*>(vp), static_cast<const int32_t*>(block_tables),
          static_cast<const int32_t*>(lengths),
          static_cast<float*>(part_acc), static_cast<float*>(part_ml), H, KH,
          dh, page, P, pps, splits, 1.f / sqrtf(static_cast<float>(dh)),
          vec16);
  err = cudaGetLastError();
  if (err != cudaSuccess || out == nullptr) return static_cast<int>(err);
  const int combine_threads = ((dh > 32 ? dh : 32) + 31) / 32 * 32;
  paged_attention_combine_kernel<T>
      <<<dim3(H, B), combine_threads, sizeof(float) * 2 * splits, stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<const int32_t*>(lengths), static_cast<T*>(out), H, dh, page,
      P, pps, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Tensors are contiguous in the
// reference's layouts; 1 <= dh <= 256, H % KH == 0.
// q: (B, Sq, H, dh); k, v: (B, Sk, KH, dh); out: (B, Sq, H, dh).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int Sq, int Sk, int H, int KH,
                           int dh, int causal, int window, int dtype,
                           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_flash_f32(q, k, v, out, B, Sq, Sk, H, KH, dh, causal,
                            window, s);
  if (dh <= 16)
    return launch_flash_bf16<16>(q, k, v, out, B, Sq, Sk, H, KH, dh, causal,
                                 window, s);
  if (dh <= 32)
    return launch_flash_bf16<32>(q, k, v, out, B, Sq, Sk, H, KH, dh, causal,
                                 window, s);
  if (dh <= 64)
    return launch_flash_bf16<64>(q, k, v, out, B, Sq, Sk, H, KH, dh, causal,
                                 window, s);
  if (dh <= 128)
    return launch_flash_bf16<128>(q, k, v, out, B, Sq, Sk, H, KH, dh, causal,
                                  window, s);
  return launch_flash_bf16<256>(q, k, v, out, B, Sq, Sk, H, KH, dh, causal,
                                window, s);
}

// q: (B, H, dh); k_pages, v_pages: (n_phys, page, KH, dh);
// block_tables: (B, P) int32; lengths: (B,) int32; out: (B, H, dh);
// scratch part_acc: (B, H, splits, dh) f32, part_ml: (B, H, splits, 2) f32.
// out == nullptr runs the split pass alone and leaves each live split's
// (acc, m, l) in the part buffers, for a merge across ranks.
// page <= 128; H / KH <= 32; (H / KH) * ceil(dh * size / 16) <= 1024;
// splits * pps >= P.
int paged_attention_launch(const void* q, const void* k_pages,
                           const void* v_pages, const void* block_tables,
                           const void* lengths, void* part_acc,
                           void* part_ml, void* out, int B, int H, int KH,
                           int dh, int page, int P, int pps, int splits,
                           int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_paged<float>(q, k_pages, v_pages, block_tables, lengths,
                               part_acc, part_ml, out, B, H, KH, dh, page, P,
                               pps, splits, s);
  return launch_paged<bf16>(q, k_pages, v_pages, block_tables, lengths,
                            part_acc, part_ml, out, B, H, KH, dh, page, P, pps,
                            splits, s);
}

const char* attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
