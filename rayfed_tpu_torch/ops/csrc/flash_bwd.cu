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
// Rounding follows the TPU kernels: scores are f32, scaled after the dot;
// P is rounded to dO's dtype before Pᵀ dO, dS to K's/Q's dtype before
// dS K and dSᵀ Q; scale is applied to dQ and dK at the end.
//
// What bounds it on the H100: each kernel does three (dQ) or four (dK/dV)
// T×T×D products per head and reads each input once, ~2·T·D flops per byte
// at T = 2048, D = 128, far above the card's ~295 flop/byte ridge, so the
// bound is the tensor cores' bf16 rate.  Two kernels and no atomics, as on
// the TPU, so the gradients are deterministic.  Tiles are classified as the
// TPU's `_causal_dispatch` does (flash_tiles.cuh): skipped, unmasked, or
// masked (diagonal or window edge); a tile that runs past T is masked too,
// so any T works.  A q row that sees no key gets dQ = 0 and a key that no
// query sees gets dK = dV = 0, exactly.  The dtype picks the kernel, by a
// fixed rule: bf16 inputs run both on the tensor cores, f32 inputs on the
// CUDA cores in f32 (tensor cores in bf16 or TF32 would break the f32
// tolerance of 1e-4).  There is no fallback from one to the other.
//
// dQ, bf16 inputs: `flash_bwd_dq_wgmma`, on the tensor cores.
//   * One block per (bh, 128 q rows), q tiles last-first (the heaviest
//     causal tiles start first): a producer warpgroup whose one thread
//     issues every TMA load, and two consumer warpgroups of 64 q rows each
//     (setmaxnreg: 24 registers for the producer, 240 for the consumers).
//     Q and dO stay resident (one barrier); each consumer thread keeps the
//     lse and δ of its two rows in registers.  64-key k/v tiles stream
//     through a 3-stage TMA ring (160 KB at D = 128): a tile is less than a
//     microsecond of tensor-core work, shorter than a TMA round trip, so two
//     tiles stay in flight ahead of the consumers.
//   * S = Q·Kᵀ and dP = dO·Vᵀ are wgmma m64n64k16 with every operand K-major
//     in shared memory, issued back to back under one commit.  P, dS and the
//     masks are computed on the f32 accumulators in registers; dS, packed
//     pairwise to bf16, is the register A operand of dQ += dS·K (wgmma
//     m64nDk16, the same K tile read MN-major).  dS never touches shared
//     memory and dQ accumulates in f32 registers across the loop.
// dK/dV, bf16 inputs: `flash_bwd_dkv_wgmma`, on the tensor cores.
//   * One block per (bh, 128 k/v rows), k/v tiles first-first: a producer
//     warp (of a warpgroup that gives its registers away with setmaxnreg)
//     and two consumer warpgroups of 64 keys each.  K and V stay resident;
//     64-row q and dO tiles stream through a 2-stage TMA ring (130 KB at
//     D = 128), from the first q tile that can see the block to the end of
//     the window band.  The producer warp's 32 lanes copy the tile's lse
//     and δ into the stage with plain loads (a bulk copy would need the
//     row offset 16-byte aligned, which a ragged T breaks) and arrive on
//     the stage's "full" barrier beside the TMA bytes.
//   * The scores come out transposed: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, wgmma
//     m64n64k16 with every operand K-major in shared memory.  Pᵀ and dSᵀ
//     then sit in accumulator registers with the layout of a register A
//     operand, so dV += Pᵀ·dO and dK += dSᵀ·Q take them packed to bf16
//     (dO and Q MN-major): no P or dS tile in shared memory.  dK and dV
//     accumulate in f32 registers across the loop.
// f32 inputs: `flash_bwd_dq_kernel` and `flash_bwd_dkv_kernel`, the first
//   versions, f32 in and out, on the CUDA cores.  dQ: one block per (bh,
//   tile of 64 q rows), looping over 32-row k/v tiles; q, dO, lse and delta
//   stay resident and dQ accumulates in f32 registers.  dK/dV: one block
//   per (bh, tile of 64 k/v rows), looping over 32-row q tiles from the
//   first one that can see the block; one P-shaped tile of shared memory
//   holds P for the dV product and then dS for the dK product.  Each
//   thread owns 4 resident rows x (2 streamed columns of the score tile,
//   D/16 output columns); the two score-shaped products share one pass
//   over D.  Heaviest tiles start first: dQ launches q tiles last-first,
//   dK/dV k tiles first-first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "flash_tiles.cuh"
#include "hopper.cuh"

namespace {

constexpr int BLOCK_R = 64;             // resident rows per block
constexpr int BLOCK_C = 32;             // streamed rows per loop step
constexpr int THREADS = 256;            // 16 x 16: ty picks rows, tx columns
constexpr int ROWS = BLOCK_R / 16;      // resident rows per thread
constexpr int SCOLS = BLOCK_C / 16;     // score columns per thread
constexpr int PSTRIDE = BLOCK_C + 4;    // row stride of the P / dS tile (floats)

__device__ __forceinline__ float component(const float4& x, int u) {
  return u == 0 ? x.x : u == 1 ? x.y : u == 2 ? x.z : x.w;
}

// Rows [row0, row0 + n) of a [t, D] matrix into shared memory with row
// stride `stride`; rows past t are zero.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, int stride,
                                          const float* __restrict__ src, int row0,
                                          int n, int t) {
  for (int i = threadIdx.x; i < n * D; i += THREADS) {
    const int r = i / D;
    const int c = i % D;
    dst[r * stride + c] = row0 + r < t ? src[(size_t)(row0 + r) * D + c] : 0.f;
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

using flash::classify;
using flash::TileClass;
using flash::visible;

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

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
    flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ d_o,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, float* __restrict__ dq,
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
  const float* kb = k + bh * t_k * D;
  const float* vb = v + bh * t_k * D;

  load_rows<D>(sq, D, q + bh * t_q * D, q0, BLOCK_R, t_q);
  load_rows<D>(sdo, D, d_o + bh * t_q * D, q0, BLOCK_R, t_q);
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
    load_rows<D>(sk, BSTRIDE, kb, k0, BLOCK_C, t_k);
    load_rows<D>(sv, BSTRIDE, vb, k0, BLOCK_C, t_k);
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
        sds[(ty + 16 * i) * PSTRIDE + col] = p * (dp[i][j] - row_delta[i]);
      }
    __syncthreads();
    accumulate<D>(sds, sk, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= t_q) continue;
    float* row = dq + (bh * t_q + r) * D;
#pragma unroll
    for (int g = 0; g < D / 64; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) row[64 * g + 4 * tx + e] = acc[i][4 * g + e] * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
    flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ d_o,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, float* __restrict__ dk,
                         float* __restrict__ dv, int t_q, int t_k, float scale,
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
  const float* qb = q + bh * t_q * D;
  const float* dob = d_o + bh * t_q * D;
  const float* lseb = lse + bh * t_q;
  const float* deltab = delta + bh * t_q;

  load_rows<D>(sk, D, k + bh * t_k * D, k0, BLOCK_R, t_k);
  load_rows<D>(sv, D, v + bh * t_k * D, k0, BLOCK_R, t_k);
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
    load_rows<D>(sq, BSTRIDE, qb, q0, BLOCK_C, t_q);
    load_rows<D>(sdo, BSTRIDE, dob, q0, BLOCK_C, t_q);
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
        ds[i][j] = p * (dp[i][j] - sdelta[col]);
        sp[row * PSTRIDE + col] = p;
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
    float* dk_row = dk + (bh * t_k + r) * D;
    float* dv_row = dv + (bh * t_k + r) * D;
#pragma unroll
    for (int g = 0; g < D / 64; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dk_row[64 * g + 4 * tx + e] = dk_acc[i][4 * g + e] * scale;
        dv_row[64 * g + 4 * tx + e] = dv_acc[i][4 * g + e];
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

template <int D>
cudaError_t launch_dq(const Args& a, void* dq) {
  constexpr size_t smem = dq_smem_bytes<D>();
  auto kernel = flash_bwd_dq_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.t_q + BLOCK_R - 1) / BLOCK_R);
  kernel<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.d_o),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(dq), a.t_q, a.t_k, a.scale, a.causal, a.q_offset,
      a.kv_offset, a.window);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  auto kernel = flash_bwd_dkv_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.t_k + BLOCK_R - 1) / BLOCK_R);
  kernel<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.d_o),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(dk), static_cast<float*>(dv), a.t_q, a.t_k, a.scale,
      a.causal, a.q_offset, a.kv_offset, a.window);
  return cudaGetLastError();
}

// ------------------------------------------ bf16 dK/dV: wgmma fed by TMA

constexpr int TC_KEYS = 128;     // k/v rows per block: two consumer warpgroups of 64
constexpr int TC_Q = 64;         // q rows per streamed tile
constexpr int TC_STAGES = 2;     // q/dO tiles in flight
constexpr int TC_THREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr uint32_t KV_BOX = TC_KEYS * 128;  // bytes of one [rows][64] box
constexpr uint32_t Q_BOX = TC_Q * 128;

template <int D>
struct DkvTiles {  // each [rows][64] box 1024-byte aligned (16 KB or 8 KB)
  __nv_bfloat16 k[D / 64][TC_KEYS][64];
  __nv_bfloat16 v[D / 64][TC_KEYS][64];
  __nv_bfloat16 q[TC_STAGES][D / 64][TC_Q][64];
  __nv_bfloat16 d_o[TC_STAGES][D / 64][TC_Q][64];
  float lse[TC_STAGES][TC_Q];
  float delta[TC_STAGES][TC_Q];
  uint64_t kv_full;
  uint64_t full[TC_STAGES];   // q, dO (TMA bytes) and lse, δ (32 producer lanes)
  uint64_t empty[TC_STAGES];  // both consumer warpgroups are done with the stage
};

template <int D, typename TO>
__global__ void __launch_bounds__(TC_THREADS, 1)
    flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        TO* __restrict__ dk, TO* __restrict__ dv, int t_q, int t_k, float scale,
                        int causal, int q_offset, int kv_offset, int window) {
  using namespace hopper;
  DkvTiles<D>& sm = aligned_smem<DkvTiles<D>>();
  const int wg = threadIdx.x / 128;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * TC_KEYS;
  const int kv_first = kv_offset + k0;
  const int kv_last = kv_first + TC_KEYS - 1;
  const int num_q = (t_q + TC_Q - 1) / TC_Q;

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(&sm.full[s], 1 + 32);
      mbar_init(&sm.empty[s], 256);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // the producer: warp 0; lane 0 issues every TMA load
    regs_release<24>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      mbar_arrive_expect_tx(&sm.kv_full, sizeof(sm.k) + sizeof(sm.v));
      for (int c = 0; c < D / 64; ++c) {
        tma_load_3d(sm.k[c], &tm_k, &sm.kv_full, 64 * c, k0, bh);
        tma_load_3d(sm.v[c], &tm_v, &sm.kv_full, 64 * c, k0, bh);
      }
    }
    const float* lse_b = lse + (size_t)bh * t_q;
    const float* delta_b = delta + (size_t)bh * t_q;
    int it = 0;  // active tiles so far: stage it % 2, ring pass it / 2
    for (int qt = 0; qt < num_q; ++qt) {
      const int q0 = qt * TC_Q;
      const int q_first = q_offset + q0;
      if (!classify(q_first, q_first + TC_Q - 1, kv_first, kv_last, causal, window).active)
        continue;
      const int s = it % TC_STAGES;
      mbar_wait(&sm.empty[s], ((it / TC_STAGES) & 1) ^ 1);
      if (lane == 0) {
        mbar_arrive_expect_tx(&sm.full[s], sizeof(sm.q[0]) + sizeof(sm.d_o[0]));
        for (int c = 0; c < D / 64; ++c) {
          tma_load_3d(sm.q[s][c], &tm_q, &sm.full[s], 64 * c, q0, bh);
          tma_load_3d(sm.d_o[s][c], &tm_do, &sm.full[s], 64 * c, q0, bh);
        }
      }
      for (int i = lane; i < TC_Q; i += 32) {
        const bool in = q0 + i < t_q;
        sm.lse[s][i] = in ? lse_b[q0 + i] : 0.f;
        sm.delta[s][i] = in ? delta_b[q0 + i] : 0.f;
      }
      mbar_arrive(&sm.full[s]);
      ++it;
    }
    return;
  }

  // A consumer warpgroup: keys cw*64 .. cw*64 + 63 of the block.  This
  // thread holds key rows `row` and `row + 8`; in the transposed score
  // tiles, query columns 8j + 2t + (0, 1) of the q tile.
  regs_claim<240>();
  const int cw = wg - 1;
  const int lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int row = cw * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }
  mbar_wait(&sm.kv_full, 0);

  int it = 0;
  for (int qt = 0; qt < num_q; ++qt) {
    const int q0 = qt * TC_Q;
    const int q_first = q_offset + q0;
    const TileClass tc = classify(q_first, q_first + TC_Q - 1, kv_first, kv_last, causal, window);
    if (!tc.active) continue;
    const bool masked = tc.straddles || q0 + TC_Q > t_q || k0 + TC_KEYS > t_k;
    const int s = it % TC_STAGES;
    mbar_wait(&sm.full[s], (it / TC_STAGES) & 1);

    const uint32_t k_rows = smem_u32(sm.k[0][cw * 64]);
    const uint32_t v_rows = smem_u32(sm.v[0][cw * 64]);
    const uint32_t q_tile = smem_u32(sm.q[s]);
    const uint32_t do_tile = smem_u32(sm.d_o[s]);
    float st[TC_Q / 2], dpt[TC_Q / 2];  // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, f32
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<TC_Q>(st, desc_k_major(k_rows + kk / 4 * KV_BOX, kk % 4),
                     desc_k_major(q_tile + kk / 4 * Q_BOX, kk % 4), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<TC_Q>(dpt, desc_k_major(v_rows + kk / 4 * KV_BOX, kk % 4),
                     desc_k_major(do_tile + kk / 4 * Q_BOX, kk % 4), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // Pᵀ (unrounded, 0 where masked) into st, dSᵀ = Pᵀ∘(dPᵀ − δ) into dpt.
#pragma unroll
    for (int j = 0; j < TC_Q / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t + e;
        const float lse_c = sm.lse[s][col];
        const float delta_c = sm.delta[s][col];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * j + 2 * r + e;
          float p = __expf(st[i] * scale - lse_c);
          if (masked && !(q0 + col < t_q && k0 + row + 8 * r < t_k &&
                          visible(q_first + col, kv_first + row + 8 * r, causal, window)))
            p = 0.f;
          st[i] = p;
          dpt[i] = p * (dpt[i] - delta_c);
        }
      }

    // dV += Pᵀ·dO and dK += dSᵀ·Q, Pᵀ and dSᵀ rounded to bf16 in registers.
    uint32_t pa[TC_Q / 16][4], da[TC_Q / 16][4];
    acc_to_a<TC_Q>(st, pa);
    acc_to_a<TC_Q>(dpt, da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TC_Q / 16; ++kk)
      wgmma_rs_mn<D>(dv_acc, pa[kk], desc_mn_major(do_tile + 16 * kk * 128, Q_BOX), 1);
#pragma unroll
    for (int kk = 0; kk < TC_Q / 16; ++kk)
      wgmma_rs_mn<D>(dk_acc, da[kk], desc_mn_major(q_tile + 16 * kk * 128, Q_BOX), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    mbar_arrive(&sm.empty[s]);
    ++it;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + row + 8 * r;
    if (key >= t_k) continue;
    TO* dk_row = dk + ((size_t)bh * t_k + key) * D;
    TO* dv_row = dv + ((size_t)bh * t_k + key) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      store_pair(dk_row + 8 * j + 2 * t, dk_acc[4 * j + 2 * r] * scale,
                 dk_acc[4 * j + 2 * r + 1] * scale);
      store_pair(dv_row + 8 * j + 2 * t, dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
    }
  }
}

template <int D, typename TO>
cudaError_t launch_dkv_wgmma(const Args& a, void* dk, void* dv) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  cudaError_t err = hopper::encode_rows_map(&tm_q, a.q, a.bh, a.t_q, D, TC_Q);
  if (err == cudaSuccess) err = hopper::encode_rows_map(&tm_do, a.d_o, a.bh, a.t_q, D, TC_Q);
  if (err == cudaSuccess) err = hopper::encode_rows_map(&tm_k, a.k, a.bh, a.t_k, D, TC_KEYS);
  if (err == cudaSuccess) err = hopper::encode_rows_map(&tm_v, a.v, a.bh, a.t_k, D, TC_KEYS);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = sizeof(DkvTiles<D>) + 1024;
  auto kernel = flash_bwd_dkv_wgmma<D, TO>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.t_k + TC_KEYS - 1) / TC_KEYS);
  kernel<<<grid, TC_THREADS, smem, a.stream>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<TO*>(dk), static_cast<TO*>(dv), a.t_q,
      a.t_k, a.scale, a.causal, a.q_offset, a.kv_offset, a.window);
  return cudaGetLastError();
}

// ---------------------------------------------- bf16 dQ: wgmma fed by TMA

constexpr int DQ_ROWS = 128;   // q rows per block: two consumer warpgroups of 64
constexpr int DQ_KEYS = 64;    // keys per streamed k/v tile
constexpr int DQ_STAGES = 3;   // k/v tiles in flight
constexpr uint32_t DQ_KEY_BOX = DQ_KEYS * 128;  // bytes of one [keys][64] box
constexpr uint32_t DQ_ROW_BOX = DQ_ROWS * 128;  // bytes of one [q rows][64] box

template <int D>
struct DqTiles {  // each [rows][64] box 1024-byte aligned (16 KB or 8 KB)
  __nv_bfloat16 q[D / 64][DQ_ROWS][64];
  __nv_bfloat16 d_o[D / 64][DQ_ROWS][64];
  __nv_bfloat16 k[DQ_STAGES][D / 64][DQ_KEYS][64];
  __nv_bfloat16 v[DQ_STAGES][D / 64][DQ_KEYS][64];
  uint64_t q_full;             // q and dO have landed
  uint64_t full[DQ_STAGES];    // the stage's k and v have landed
  uint64_t empty[DQ_STAGES];   // both consumer warpgroups are done with it
};

template <int D, typename TO>
__global__ void __launch_bounds__(TC_THREADS, 1)
    flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       TO* __restrict__ dq, int t_q, int t_k, float scale, int causal,
                       int q_offset, int kv_offset, int window) {
  using namespace hopper;
  DqTiles<D>& sm = aligned_smem<DqTiles<D>>();
  const int wg = threadIdx.x / 128;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * DQ_ROWS;
  const int q_first = q_offset + q0;
  const int q_last = q_first + DQ_ROWS - 1;
  const int num_k = (t_k + DQ_KEYS - 1) / DQ_KEYS;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < DQ_STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 256);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // the producer: one thread issues every TMA load
    regs_release<24>();
    if (threadIdx.x != 0) return;
    mbar_arrive_expect_tx(&sm.q_full, sizeof(sm.q) + sizeof(sm.d_o));
    for (int c = 0; c < D / 64; ++c) {
      tma_load_3d(sm.q[c], &tm_q, &sm.q_full, 64 * c, q0, bh);
      tma_load_3d(sm.d_o[c], &tm_do, &sm.q_full, 64 * c, q0, bh);
    }
    int it = 0;  // active tiles so far: stage it % 3, ring pass it / 3
    for (int kt = 0; kt < num_k; ++kt) {
      const int kv_first = kv_offset + kt * DQ_KEYS;
      if (!classify(q_first, q_last, kv_first, kv_first + DQ_KEYS - 1, causal, window).active)
        continue;
      const int s = it % DQ_STAGES;
      mbar_wait(&sm.empty[s], ((it / DQ_STAGES) & 1) ^ 1);
      mbar_arrive_expect_tx(&sm.full[s], sizeof(sm.k[0]) + sizeof(sm.v[0]));
      for (int c = 0; c < D / 64; ++c) {
        tma_load_3d(sm.k[s][c], &tm_k, &sm.full[s], 64 * c, kt * DQ_KEYS, bh);
        tma_load_3d(sm.v[s][c], &tm_v, &sm.full[s], 64 * c, kt * DQ_KEYS, bh);
      }
      ++it;
    }
    return;
  }

  // A consumer warpgroup: q rows cw*64 .. cw*64 + 63 of the block.  This
  // thread holds rows `row` and `row + 8`, key columns 8j + 2t + (0, 1) of
  // the score tiles.  Rows past t_q read zeros (TMA) and lse = δ = 0: their
  // values stay finite, no row's dQ depends on another row, and they are
  // never stored.
  regs_claim<240>();
  const int cw = wg - 1;
  const int lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int row = cw * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = q0 + row + 8 * r;
    const bool in = q < t_q;
    row_lse[r] = in ? lse[(size_t)bh * t_q + q] : 0.f;
    row_delta[r] = in ? delta[(size_t)bh * t_q + q] : 0.f;
  }
  float acc[D / 2];  // dQ / scale, f32
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  mbar_wait(&sm.q_full, 0);

  const uint32_t q_rows = smem_u32(sm.q[0][cw * 64]);
  const uint32_t do_rows = smem_u32(sm.d_o[0][cw * 64]);
  int it = 0;
  for (int kt = 0; kt < num_k; ++kt) {
    const int k0 = kt * DQ_KEYS;
    const int kv_first = kv_offset + k0;
    const TileClass tc = classify(q_first, q_last, kv_first, kv_first + DQ_KEYS - 1, causal, window);
    if (!tc.active) continue;
    // Keys past t_k read zeros, and then p = exp(−lse), which is inf for a
    // row that sees no key: such tiles are masked, and p is zeroed after the
    // exp.
    const bool masked = tc.straddles || k0 + DQ_KEYS > t_k;
    const int s = it % DQ_STAGES;
    mbar_wait(&sm.full[s], (it / DQ_STAGES) & 1);

    const uint32_t k_tile = smem_u32(sm.k[s]);
    const uint32_t v_tile = smem_u32(sm.v[s]);
    float sc[DQ_KEYS / 2], dp[DQ_KEYS / 2];  // S = Q·Kᵀ and dP = dO·Vᵀ, f32
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<DQ_KEYS>(sc, desc_k_major(q_rows + kk / 4 * DQ_ROW_BOX, kk % 4),
                        desc_k_major(k_tile + kk / 4 * DQ_KEY_BOX, kk % 4), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<DQ_KEYS>(dp, desc_k_major(do_rows + kk / 4 * DQ_ROW_BOX, kk % 4),
                        desc_k_major(v_tile + kk / 4 * DQ_KEY_BOX, kk % 4), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    // dS = P∘(dP − δ) into dp, P = exp(s·scale − lse), 0 where masked.
#pragma unroll
    for (int j = 0; j < DQ_KEYS / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * r + e;
          const int col = k0 + 8 * j + 2 * t + e;
          float p = __expf(sc[i] * scale - row_lse[r]);
          if (masked && !(col < t_k && visible(q_first + row + 8 * r, kv_offset + col, causal,
                                               window)))
            p = 0.f;
          dp[i] = p * (dp[i] - row_delta[r]);
        }

    // dQ += dS·K, dS rounded to bf16 in registers, K MN-major.
    uint32_t da[DQ_KEYS / 16][4];
    acc_to_a<DQ_KEYS>(dp, da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQ_KEYS / 16; ++kk)
      wgmma_rs_mn<D>(acc, da[kk], desc_mn_major(k_tile + 16 * kk * 128, DQ_KEY_BOX), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&sm.empty[s]);
    ++it;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = q0 + row + 8 * r;
    if (q >= t_q) continue;
    TO* dq_row = dq + ((size_t)bh * t_q + q) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store_pair(dq_row + 8 * j + 2 * t, acc[4 * j + 2 * r] * scale,
                 acc[4 * j + 2 * r + 1] * scale);
  }
}

template <int D, typename TO>
cudaError_t launch_dq_wgmma(const Args& a, void* dq) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  cudaError_t err = hopper::encode_rows_map(&tm_q, a.q, a.bh, a.t_q, D, DQ_ROWS);
  if (err == cudaSuccess) err = hopper::encode_rows_map(&tm_do, a.d_o, a.bh, a.t_q, D, DQ_ROWS);
  if (err == cudaSuccess) err = hopper::encode_rows_map(&tm_k, a.k, a.bh, a.t_k, D, DQ_KEYS);
  if (err == cudaSuccess) err = hopper::encode_rows_map(&tm_v, a.v, a.bh, a.t_k, D, DQ_KEYS);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = sizeof(DqTiles<D>) + 1024;
  auto kernel = flash_bwd_dq_wgmma<D, TO>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.t_q + DQ_ROWS - 1) / DQ_ROWS);
  kernel<<<grid, TC_THREADS, smem, a.stream>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<TO*>(dq), a.t_q, a.t_k, a.scale, a.causal,
      a.q_offset, a.kv_offset, a.window);
  return cudaGetLastError();
}

// Picks the instantiation: which kernel (dkv), input dtype, output dtype
// and head dim.  bf16 inputs take the tensor-core kernels, f32 inputs the
// CUDA-core ones, always.
template <int D>
cudaError_t dispatch_types(bool dkv, int bf16_in, int f32_out, const Args& a,
                           void* out0, void* out1) {
  if (!bf16_in) return dkv ? launch_dkv<D>(a, out0, out1) : launch_dq<D>(a, out0);
  if (f32_out)
    return dkv ? launch_dkv_wgmma<D, float>(a, out0, out1) : launch_dq_wgmma<D, float>(a, out0);
  return dkv ? launch_dkv_wgmma<D, __nv_bfloat16>(a, out0, out1)
             : launch_dq_wgmma<D, __nv_bfloat16>(a, out0);
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
// f32 (bf16_in == 0) or bf16 (then 16-byte aligned, for the TMA loads).
// lse, delta: [bh, t_q] f32.  dq: [bh, t_q, head_dim]; dk, dv: [bh, t_k,
// head_dim]; in the input dtype, or f32 when f32_out.  window <= 0 means
// no window.  Each returns a cudaError_t.
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
