// Flash-attention backward for Hopper (sm_90a): the dQ and dK/dV kernels.
//
// Replaces the TPU kernels `_flash_bwd_dq_kernel` (line 253) and
// `_flash_bwd_dkv_kernel` (line 325) of rayfed_tpu/ops/flash_attention.py,
// launched through pl.pallas_call by `_flash_backward_pallas` (line 419).
// Over [BH, T, D] tensors, with the saved per-row lse and
// delta = rowsum(dO ∘ O):
//   P  = exp(scale·Q Kᵀ − lse), zero where the pair is masked,
//   dS = P ∘ (dO Vᵀ − delta),
//   dQ = scale·dS K,   dK = scale·dSᵀ Q,   dV = Pᵀ dO.
// The causal / sliding-window / offset masks are those of the forward.
//
// What bounds it on the H100: each kernel does three (dQ) or four (dK/dV)
// T×T×D products per head and reads each input once, ~2·T·D flops per byte
// at T = 2048, D = 128, far above the card's ~295 flop/byte ridge, so the
// bound is arithmetic.  This first version does the products on the CUDA
// cores in f32 (no tensor cores), like flash_fwd.cu, and so runs at a
// fraction of the bf16 tensor-core bound.  Its design:
//   * Two kernels and no atomics, as on the TPU, so the gradients are
//     deterministic.  dQ: one block per (bh, tile of 64 q rows), looping
//     over 32-row k/v tiles; q, dO, lse and delta stay resident and dQ
//     accumulates in f32 registers.  dK/dV: one block per (bh, tile of 64
//     k/v rows), looping over 32-row q tiles from the first one that can
//     see the block; k and v stay resident and dK, dV accumulate in f32
//     registers.  The loops take the place of the TPU's sequential third
//     grid axis.
//   * Each thread owns 4 resident rows x (2 streamed columns of the score
//     tile, D/16 output columns), so every 128-bit shared-memory read feeds
//     4-8 FMAs; streamed rows are padded so the 16 column threads of a row
//     hit 16 different bank groups.  The two score-shaped products (Q Kᵀ
//     and dO Vᵀ) share one pass over D.
//   * Tiles are classified as the TPU's `_causal_dispatch` does: skipped,
//     unmasked, or masked (diagonal or window edge).  A tile that runs past
//     T is masked too, so any T works.  A q row that sees no key gets
//     dQ = 0 and a key that no query sees gets dK = dV = 0, exactly.
//   * The dK/dV kernel's one P-shaped tile of shared memory holds P for the
//     dV product and then dS for the dK product, so two blocks fit an SM.
//   * Heaviest tiles start first: dQ launches q tiles last-first, dK/dV
//     k tiles first-first.
// Rounding follows the TPU kernels: scores are f32, scaled after the dot;
// P is rounded to dO's dtype before Pᵀ dO, dS to K's/Q's dtype before
// dS K and dSᵀ Q; scale is applied to dQ and dK at the end.
// Tensor cores (mma.sync / wgmma), TMA and pipelining are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BLOCK_R = 64;             // resident rows per block
constexpr int BLOCK_C = 32;             // streamed rows per loop step
constexpr int THREADS = 256;            // 16 x 16: ty picks rows, tx columns
constexpr int ROWS = BLOCK_R / 16;      // resident rows per thread
constexpr int SCOLS = BLOCK_C / 16;     // score columns per thread
constexpr int PSTRIDE = BLOCK_C + 4;    // row stride of the P / dS tile (floats)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back: the TPU kernels' astype before a product.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

__device__ __forceinline__ float component(const float4& x, int u) {
  return u == 0 ? x.x : u == 1 ? x.y : u == 2 ? x.z : x.w;
}

// Rows [row0, row0 + n) of a [t, D] matrix into shared memory as f32 with
// row stride `stride`; rows past t are zero.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, int stride,
                                          const T* __restrict__ src, int row0,
                                          int n, int t) {
  for (int i = threadIdx.x; i < n * D; i += THREADS) {
    const int r = i / D;
    const int c = i % D;
    dst[r * stride + c] =
        row0 + r < t ? to_float(src[(size_t)(row0 + r) * D + c]) : 0.f;
  }
}

// s = A1 · B1ᵀ and dp = A2 · B2ᵀ for this thread's 4 x 2 cells.  A1, A2:
// the resident [BLOCK_R][D] tiles; B1, B2: the streamed [BLOCK_C][D + 4].
template <int D>
__device__ __forceinline__ void dual_scores(const float* a1, const float* a2,
                                            const float* b1, const float* b2,
                                            int ty, int tx,
                                            float (&s)[ROWS][SCOLS],
                                            float (&dp)[ROWS][SCOLS]) {
  constexpr int BSTRIDE = D + 4;
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int j = 0; j < SCOLS; ++j) {
      s[i][j] = 0.f;
      dp[i][j] = 0.f;
    }
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 x[ROWS], y[SCOLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
      x[i] = *reinterpret_cast<const float4*>(a1 + (ty + 16 * i) * D + d);
#pragma unroll
    for (int j = 0; j < SCOLS; ++j)
      y[j] = *reinterpret_cast<const float4*>(b1 + (tx + 16 * j) * BSTRIDE + d);
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < SCOLS; ++j) {
        float a = s[i][j];
        a = fmaf(x[i].x, y[j].x, a);
        a = fmaf(x[i].y, y[j].y, a);
        a = fmaf(x[i].z, y[j].z, a);
        a = fmaf(x[i].w, y[j].w, a);
        s[i][j] = a;
      }
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
      x[i] = *reinterpret_cast<const float4*>(a2 + (ty + 16 * i) * D + d);
#pragma unroll
    for (int j = 0; j < SCOLS; ++j)
      y[j] = *reinterpret_cast<const float4*>(b2 + (tx + 16 * j) * BSTRIDE + d);
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < SCOLS; ++j) {
        float a = dp[i][j];
        a = fmaf(x[i].x, y[j].x, a);
        a = fmaf(x[i].y, y[j].y, a);
        a = fmaf(x[i].z, y[j].z, a);
        a = fmaf(x[i].w, y[j].w, a);
        dp[i][j] = a;
      }
  }
}

// acc[i][·] += Σ_c tile[row_i][c] · b[c][cols of this thread], with tile
// the [BLOCK_R][PSTRIDE] P or dS tile and b a streamed [BLOCK_C][D + 4]
// tile; this thread's columns are tx*4 + 64*g + (0..3).
template <int D>
__device__ __forceinline__ void accumulate(const float* tile, const float* b,
                                           int ty, int tx,
                                           float (&acc)[ROWS][D / 16]) {
  constexpr int BSTRIDE = D + 4;
  constexpr int GROUPS = D / 64;
#pragma unroll 2
  for (int kk = 0; kk < BLOCK_C; kk += 4) {
    float4 pv[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
      pv[i] = *reinterpret_cast<const float4*>(tile + (ty + 16 * i) * PSTRIDE + kk);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int g = 0; g < GROUPS; ++g) {
        const float4 bv =
            *reinterpret_cast<const float4*>(b + (kk + u) * BSTRIDE + 64 * g + 4 * tx);
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const float p = component(pv[i], u);
          acc[i][4 * g + 0] = fmaf(p, bv.x, acc[i][4 * g + 0]);
          acc[i][4 * g + 1] = fmaf(p, bv.y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(p, bv.z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(p, bv.w, acc[i][4 * g + 3]);
        }
      }
  }
}

// `_causal_dispatch` for a (q tile, k/v tile) pair: whether the pair is
// active (some pair of positions is visible) and whether it straddles the
// diagonal or the window edge (some pair is not).
struct TileClass {
  bool active;
  bool straddles;
};

__device__ __forceinline__ TileClass classify(int q_first, int q_last,
                                              int kv_first, int kv_last,
                                              int causal, int window) {
  TileClass c{true, false};
  if (causal) {
    c.active = kv_first <= q_last;
    c.straddles = kv_last > q_first;
    if (window > 0) {
      c.active = c.active && kv_last > q_first - window;
      c.straddles = c.straddles || q_last - kv_first >= window;
    }
  }
  return c;
}

__device__ __forceinline__ bool visible(int q_pos, int k_pos, int causal,
                                        int window) {
  if (!causal) return true;
  return q_pos >= k_pos && (window <= 0 || q_pos - k_pos < window);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) *
         (2 * BLOCK_R * D + 2 * BLOCK_C * (D + 4) + BLOCK_R * PSTRIDE);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (2 * BLOCK_R * D + 2 * BLOCK_C * (D + 4) +
                          BLOCK_R * PSTRIDE + 2 * BLOCK_C);
}

template <typename T, typename TO, int D>
__global__ void __launch_bounds__(THREADS, 2)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ d_o,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, TO* __restrict__ dq,
                        int t_q, int t_k, float scale, int causal,
                        int q_offset, int kv_offset, int window) {
  constexpr int BSTRIDE = D + 4;
  constexpr int OCOLS = D / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);  // [BLOCK_R][D]
  float* sdo = sq + BLOCK_R * D;                // [BLOCK_R][D]
  float* sk = sdo + BLOCK_R * D;                // [BLOCK_C][BSTRIDE]
  float* sv = sk + BLOCK_C * BSTRIDE;           // [BLOCK_C][BSTRIDE]
  float* sds = sv + BLOCK_C * BSTRIDE;          // [BLOCK_R][PSTRIDE]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const size_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BLOCK_R;
  const T* kb = k + bh * t_k * D;
  const T* vb = v + bh * t_k * D;

  load_rows<T, D>(sq, D, q + bh * t_q * D, q0, BLOCK_R, t_q);
  load_rows<T, D>(sdo, D, d_o + bh * t_q * D, q0, BLOCK_R, t_q);
  float row_lse[ROWS], row_delta[ROWS], acc[ROWS][OCOLS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = q0 + ty + 16 * i;
    row_lse[i] = r < t_q ? lse[bh * t_q + r] : 0.f;
    row_delta[i] = r < t_q ? delta[bh * t_q + r] : 0.f;
#pragma unroll
    for (int c = 0; c < OCOLS; ++c) acc[i][c] = 0.f;
  }

  const int q_first = q_offset + q0;
  const int q_last = q_first + BLOCK_R - 1;
  const int num_k = (t_k + BLOCK_C - 1) / BLOCK_C;
  for (int kt = 0; kt < num_k; ++kt) {
    const int k0 = kt * BLOCK_C;
    const int kv_first = kv_offset + k0;
    const TileClass tc = classify(q_first, q_last, kv_first,
                                  kv_first + BLOCK_C - 1, causal, window);
    if (causal && kv_first > q_last) break;  // every later tile is future
    if (!tc.active) continue;                // below the window band
    const bool masked = tc.straddles || k0 + BLOCK_C > t_k;

    __syncthreads();  // the last tile's dS·K is done with sk, sv and sds
    load_rows<T, D>(sk, BSTRIDE, kb, k0, BLOCK_C, t_k);
    load_rows<T, D>(sv, BSTRIDE, vb, k0, BLOCK_C, t_k);
    __syncthreads();

    float s[ROWS][SCOLS], dp[ROWS][SCOLS];
    dual_scores<D>(sq, sdo, sk, sv, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < SCOLS; ++j) {
        const int col = tx + 16 * j;
        float p = expf(s[i][j] * scale - row_lse[i]);
        if (masked && !(k0 + col < t_k &&
                        visible(q_first + ty + 16 * i, kv_first + col, causal,
                                window)))
          p = 0.f;
        sds[(ty + 16 * i) * PSTRIDE + col] =
            round_to<T>(p * (dp[i][j] - row_delta[i]));
      }
    __syncthreads();
    accumulate<D>(sds, sk, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= t_q) continue;
    TO* row = dq + (bh * t_q + r) * D;
#pragma unroll
    for (int g = 0; g < D / 64; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        row[64 * g + 4 * tx + e] = from_float<TO>(acc[i][4 * g + e] * scale);
  }
}

template <typename T, typename TO, int D>
__global__ void __launch_bounds__(THREADS, 2)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ d_o,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, TO* __restrict__ dk,
                         TO* __restrict__ dv, int t_q, int t_k, float scale,
                         int causal, int q_offset, int kv_offset, int window) {
  constexpr int BSTRIDE = D + 4;
  constexpr int OCOLS = D / 16;
  extern __shared__ float4 smem4[];
  float* sk = reinterpret_cast<float*>(smem4);  // [BLOCK_R][D]
  float* sv = sk + BLOCK_R * D;                 // [BLOCK_R][D]
  float* sq = sv + BLOCK_R * D;                 // [BLOCK_C][BSTRIDE]
  float* sdo = sq + BLOCK_C * BSTRIDE;          // [BLOCK_C][BSTRIDE]
  float* sp = sdo + BLOCK_C * BSTRIDE;          // [BLOCK_R][PSTRIDE]: P, then dS
  float* slse = sp + BLOCK_R * PSTRIDE;         // [BLOCK_C]
  float* sdelta = slse + BLOCK_C;               // [BLOCK_C]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const size_t bh = blockIdx.x;
  const int k0 = blockIdx.y * BLOCK_R;
  const T* qb = q + bh * t_q * D;
  const T* dob = d_o + bh * t_q * D;
  const float* lseb = lse + bh * t_q;
  const float* deltab = delta + bh * t_q;

  load_rows<T, D>(sk, D, k + bh * t_k * D, k0, BLOCK_R, t_k);
  load_rows<T, D>(sv, D, v + bh * t_k * D, k0, BLOCK_R, t_k);
  float dk_acc[ROWS][OCOLS], dv_acc[ROWS][OCOLS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int c = 0; c < OCOLS; ++c) {
      dk_acc[i][c] = 0.f;
      dv_acc[i][c] = 0.f;
    }

  const int kv_first = kv_offset + k0;
  const int kv_last = kv_first + BLOCK_R - 1;
  const int num_q = (t_q + BLOCK_C - 1) / BLOCK_C;
  // The first q tile that can see this block: q_last >= kv_first.
  int first = 0;
  if (causal) {
    const int need = kv_first - q_offset - (BLOCK_C - 1);
    first = need > 0 ? (need + BLOCK_C - 1) / BLOCK_C : 0;
  }
  for (int qt = first; qt < num_q; ++qt) {
    const int q0 = qt * BLOCK_C;
    const int q_first = q_offset + q0;
    const TileClass tc = classify(q_first, q_first + BLOCK_C - 1, kv_first,
                                  kv_last, causal, window);
    if (!tc.active) {
      if (causal && window > 0 && kv_last <= q_first - window) break;
      continue;
    }
    const bool masked =
        tc.straddles || q0 + BLOCK_C > t_q || k0 + BLOCK_R > t_k;

    __syncthreads();  // the last tile's products are done with sq, sdo, sp
    load_rows<T, D>(sq, BSTRIDE, qb, q0, BLOCK_C, t_q);
    load_rows<T, D>(sdo, BSTRIDE, dob, q0, BLOCK_C, t_q);
    if (tid < BLOCK_C) {
      const bool in = q0 + tid < t_q;
      slse[tid] = in ? lseb[q0 + tid] : 0.f;
      sdelta[tid] = in ? deltab[q0 + tid] : 0.f;
    }
    __syncthreads();

    // Transposed scores: rows are keys, columns are queries.
    float s[ROWS][SCOLS], dp[ROWS][SCOLS];
    dual_scores<D>(sk, sv, sq, sdo, ty, tx, s, dp);
    float ds[ROWS][SCOLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < SCOLS; ++j) {
        const int col = tx + 16 * j;
        const int row = ty + 16 * i;
        float p = expf(s[i][j] * scale - slse[col]);
        if (masked && !(q0 + col < t_q && k0 + row < t_k &&
                        visible(q_first + col, kv_first + row, causal, window)))
          p = 0.f;
        ds[i][j] = round_to<T>(p * (dp[i][j] - sdelta[col]));
        sp[row * PSTRIDE + col] = round_to<T>(p);
      }
    __syncthreads();
    accumulate<D>(sp, sdo, ty, tx, dv_acc);  // dV += Pᵀ dO
    __syncthreads();
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < SCOLS; ++j)
        sp[(ty + 16 * i) * PSTRIDE + tx + 16 * j] = ds[i][j];
    __syncthreads();
    accumulate<D>(sp, sq, ty, tx, dk_acc);  // dK += dSᵀ Q
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r >= t_k) continue;
    TO* dk_row = dk + (bh * t_k + r) * D;
    TO* dv_row = dv + (bh * t_k + r) * D;
#pragma unroll
    for (int g = 0; g < D / 64; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dk_row[64 * g + 4 * tx + e] = from_float<TO>(dk_acc[i][4 * g + e] * scale);
        dv_row[64 * g + 4 * tx + e] = from_float<TO>(dv_acc[i][4 * g + e]);
      }
  }
}

struct Args {
  const void *q, *k, *v, *d_o, *lse, *delta;
  int bh, t_q, t_k;
  float scale;
  int causal, q_offset, kv_offset, window;
  cudaStream_t stream;
};

template <typename T, typename TO, int D>
cudaError_t launch_dq(const Args& a, void* dq) {
  constexpr size_t smem = dq_smem_bytes<D>();
  auto kernel = flash_bwd_dq_kernel<T, TO, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.t_q + BLOCK_R - 1) / BLOCK_R);
  kernel<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.d_o),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<TO*>(dq), a.t_q, a.t_k, a.scale, a.causal, a.q_offset,
      a.kv_offset, a.window);
  return cudaGetLastError();
}

template <typename T, typename TO, int D>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  auto kernel = flash_bwd_dkv_kernel<T, TO, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.t_k + BLOCK_R - 1) / BLOCK_R);
  kernel<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.d_o),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<TO*>(dk), static_cast<TO*>(dv), a.t_q, a.t_k, a.scale,
      a.causal, a.q_offset, a.kv_offset, a.window);
  return cudaGetLastError();
}

// Picks the instantiation: which kernel (dkv), input dtype, output dtype
// and head dim.
template <int D>
cudaError_t dispatch_types(bool dkv, int bf16_in, int f32_out, const Args& a,
                           void* out0, void* out1) {
  if (!bf16_in)
    return dkv ? launch_dkv<float, float, D>(a, out0, out1)
               : launch_dq<float, float, D>(a, out0);
  if (f32_out)
    return dkv ? launch_dkv<__nv_bfloat16, float, D>(a, out0, out1)
               : launch_dq<__nv_bfloat16, float, D>(a, out0);
  return dkv ? launch_dkv<__nv_bfloat16, __nv_bfloat16, D>(a, out0, out1)
             : launch_dq<__nv_bfloat16, __nv_bfloat16, D>(a, out0);
}

cudaError_t dispatch(bool dkv, int device, int head_dim, int bf16_in,
                     int f32_out, const Args& a, void* out0, void* out1) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (head_dim == 64) return dispatch_types<64>(dkv, bf16_in, f32_out, a, out0, out1);
  if (head_dim == 128) return dispatch_types<128>(dkv, bf16_in, f32_out, a, out0, out1);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, d_o: [bh, t_q, head_dim]; k, v: [bh, t_k, head_dim]; all contiguous,
// f32 (bf16_in == 0) or bf16.  lse, delta: [bh, t_q] f32.  dq: [bh, t_q,
// head_dim]; dk, dv: [bh, t_k, head_dim]; in the input dtype, or f32 when
// f32_out.  window <= 0 means no window.  Each returns a cudaError_t.
extern "C" int rf_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* d_o, const void* lse,
                               const void* delta, void* dq, int device, int bh,
                               int t_q, int t_k, int head_dim, int bf16_in,
                               int f32_out, float scale, int causal,
                               int q_offset, int kv_offset, int window,
                               void* stream) {
  const Args a{q, k, v, d_o, lse, delta, bh, t_q, t_k, scale, causal,
               q_offset, kv_offset, window, static_cast<cudaStream_t>(stream)};
  return dispatch(false, device, head_dim, bf16_in, f32_out, a, dq, nullptr);
}

extern "C" int rf_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* d_o, const void* lse,
                                const void* delta, void* dk, void* dv,
                                int device, int bh, int t_q, int t_k,
                                int head_dim, int bf16_in, int f32_out,
                                float scale, int causal, int q_offset,
                                int kv_offset, int window, void* stream) {
  const Args a{q, k, v, d_o, lse, delta, bh, t_q, t_k, scale, causal,
               q_offset, kv_offset, window, static_cast<cudaStream_t>(stream)};
  return dispatch(true, device, head_dim, bf16_in, f32_out, a, dk, dv);
}

extern "C" const char* rf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
