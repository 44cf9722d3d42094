// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_fwd_kernel` of
// rayfed_tpu/ops/flash_attention.py (line 84), launched through
// pl.pallas_call by `_flash_forward` (line 174).  It computes the same
// function: o = softmax(scale * Q Kᵀ + mask) V and lse = m + log l per row,
// over [BH, T, D] tensors, with the causal / sliding-window / offset masks
// and the TPU kernel's guards for fully masked rows (o = 0, lse ~ NEG_INF).
// Rounding follows the TPU kernel: scores are f32 from exact products,
// scaled after the dot; p is rounded to V's dtype before P·V; l sums the
// unrounded p.
//
// What bounds it on the H100: at the prefill shape (T = 2048, D = 128) the
// work is ~2·T·D flops per loaded byte, far above the card's ~295 flop/byte
// ridge, so the bound is the tensor cores' bf16 rate.  Two kernels, picked
// by a fixed dtype rule (no fallback from one to the other):
//
// bf16 inputs: `flash_fwd_wgmma`, on the tensor cores.
//   * One block per (bh, 128 q rows): a producer warpgroup whose one thread
//     issues every TMA load, and two consumer warpgroups of 64 q rows each
//     (384 threads; setmaxnreg moves registers from the producer, 24, to the
//     consumers, 240).  Q stays resident; k/v tiles of 128 keys stream
//     through a 2-stage ring (160 KB at D = 128), each stage with a "full"
//     mbarrier (TMA transaction bytes) and an "empty" one (256 consumer
//     arrivals).  TMA reads through 3-D tensor maps (D, T, BH), so a ragged
//     tile reads zeros, not the next head.
//   * S = Q·Kᵀ is wgmma m64n128k16 with both operands K-major in shared
//     memory; the online softmax runs on the f32 accumulator in registers
//     (row max and sum over the 4 threads of a quad); P, packed pairwise to
//     bf16, is the register A operand of O += P·V (wgmma m64nDk16, V
//     MN-major in shared memory).  O stays in registers across tiles.
//   * Tiles are classified as the TPU's `_causal_dispatch` does
//     (flash_tiles.cuh): skipped, unmasked, or masked; a tile that runs past
//     T is masked too, so any T works.  The producer and the consumers walk
//     the same classification, so a skipped tile is never loaded.  The
//     masks and the m_safe / l_safe guards work per row, since a 128-row
//     tile can hold live rows beside fully masked ones.  q tiles are
//     launched last-first, so the heaviest causal tiles start first.
// f32 inputs: `flash_fwd_kernel`, the first version, on the CUDA cores in
//   f32.  Tensor cores in bf16 or TF32 would break the f32 tolerance of
//   1e-4; ring callers use f32 only as an output dtype.  One block per (bh,
//   64 q rows) loops over 32-row k/v tiles staged in shared memory; each
//   thread owns 4 q rows x (2 score columns, D/16 output columns).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "flash_tiles.cuh"
#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BLOCK_Q = 64;
constexpr int BLOCK_K = 32;
constexpr int THREADS = 256;          // 16 x 16: ty picks rows, tx columns
constexpr int ROWS = BLOCK_Q / 16;    // q rows per thread
constexpr int SCOLS = BLOCK_K / 16;   // score columns per thread
constexpr int PSTRIDE = BLOCK_K + 4;  // row stride of the P tile (floats)

__device__ __forceinline__ float component(const float4& x, int u) {
  return u == 0 ? x.x : u == 1 ? x.y : u == 2 ? x.z : x.w;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BLOCK_Q * D + BLOCK_K * (D + 4) + BLOCK_K * D + BLOCK_Q * PSTRIDE);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int t_q, int t_k, float scale,
                     int causal, int q_offset, int kv_offset, int window) {
  constexpr int KSTRIDE = D + 4;
  constexpr int GROUPS = D / 64;  // float4 column groups per thread
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);  // [BLOCK_Q][D]
  float* sk = sq + BLOCK_Q * D;                 // [BLOCK_K][KSTRIDE]
  float* sv = sk + BLOCK_K * KSTRIDE;           // [BLOCK_K][D]
  float* sp = sv + BLOCK_K * D;                 // [BLOCK_Q][PSTRIDE]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const size_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BLOCK_Q;
  const float* qb = q + bh * t_q * D;
  const float* kb = k + bh * t_k * D;
  const float* vb = v + bh * t_k * D;

  for (int i = tid; i < BLOCK_Q * D; i += THREADS) {
    const int r = i / D;
    sq[i] = q0 + r < t_q ? qb[(size_t)(q0 + r) * D + i % D] : 0.f;
  }

  float m[ROWS], l[ROWS], acc[ROWS][4 * GROUPS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * GROUPS; ++c) acc[i][c] = 0.f;
  }

  const int q_first = q_offset + q0;
  const int q_last = q_first + BLOCK_Q - 1;
  const int num_k = (t_k + BLOCK_K - 1) / BLOCK_K;
  for (int kt = 0; kt < num_k; ++kt) {
    const int k0 = kt * BLOCK_K;
    const int kv_first = kv_offset + k0;
    const flash::TileClass tc =
        flash::classify(q_first, q_last, kv_first, kv_first + BLOCK_K - 1, causal, window);
    if (!tc.active) continue;
    const bool masked = tc.straddles || k0 + BLOCK_K > t_k;

    __syncthreads();  // the last tile's P·V is done with sk, sv and sp
    for (int i = tid; i < BLOCK_K * D; i += THREADS) {
      const int r = i / D;
      const int c = i % D;
      const bool in = k0 + r < t_k;
      const size_t g = (size_t)(k0 + r) * D + c;
      sk[r * KSTRIDE + c] = in ? kb[g] : 0.f;
      sv[i] = in ? vb[g] : 0.f;
    }
    __syncthreads();

    float s[ROWS][SCOLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < SCOLS; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[ROWS], kv[SCOLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        qv[i] = *reinterpret_cast<const float4*>(sq + (ty + 16 * i) * D + d);
#pragma unroll
      for (int j = 0; j < SCOLS; ++j)
        kv[j] = *reinterpret_cast<const float4*>(sk + (tx + 16 * j) * KSTRIDE + d);
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < SCOLS; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

    // Online softmax; a row's 32 scores sit on the 16 lanes sharing ty.
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int q_pos = q_first + ty + 16 * i;
      float row_max = NEG_INF;
#pragma unroll
      for (int j = 0; j < SCOLS; ++j) {
        float x = s[i][j] * scale;
        if (masked) {
          const int col = k0 + tx + 16 * j;
          if (!(col < t_k && flash::visible(q_pos, kv_offset + col, causal, window)))
            x = NEG_INF;
        }
        s[i][j] = x;
        row_max = fmaxf(row_max, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_cur = fmaxf(row_max, m[i]);
      // Fully masked rows keep m_cur == NEG_INF: shift by 0 so p = 0.
      const float m_safe = m_cur <= NEG_INF / 2 ? 0.f : m_cur;
      const float correction =
          expf((m[i] <= NEG_INF / 2 ? NEG_INF : m[i]) - m_safe);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < SCOLS; ++j) {
        const float p = expf(s[i][j] - m_safe);
        row_sum += p;
        sp[(ty + 16 * i) * PSTRIDE + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[i] = l[i] * correction + row_sum;
      m[i] = m_cur;
#pragma unroll
      for (int c = 0; c < 4 * GROUPS; ++c) acc[i][c] *= correction;
    }
    __syncthreads();

    // acc += P·V; this thread's columns are tx*4 + 64*g + (0..3).
#pragma unroll 2
    for (int kk = 0; kk < BLOCK_K; kk += 4) {
      float4 pv[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        pv[i] = *reinterpret_cast<const float4*>(sp + (ty + 16 * i) * PSTRIDE + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int g = 0; g < GROUPS; ++g) {
          const float4 vv =
              *reinterpret_cast<const float4*>(sv + (kk + u) * D + 64 * g + 4 * tx);
#pragma unroll
          for (int i = 0; i < ROWS; ++i) {
            const float p = component(pv[i], u);
            acc[i][4 * g + 0] = fmaf(p, vv.x, acc[i][4 * g + 0]);
            acc[i][4 * g + 1] = fmaf(p, vv.y, acc[i][4 * g + 1]);
            acc[i][4 * g + 2] = fmaf(p, vv.z, acc[i][4 * g + 2]);
            acc[i][4 * g + 3] = fmaf(p, vv.w, acc[i][4 * g + 3]);
          }
        }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= t_q) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    float* orow = o + (bh * t_q + r) * D;
#pragma unroll
    for (int g = 0; g < GROUPS; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        orow[64 * g + 4 * tx + e] = acc[i][4 * g + e] / l_safe;
    if (tx == 0) lse[bh * t_q + r] = m[i] + logf(fmaxf(l[i], 1e-37f));
  }
}

// f32 inputs and outputs, on the CUDA cores.
template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                       int t_q, int t_k, float scale, int causal, int q_offset, int kv_offset,
                       int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_fwd_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (t_q + BLOCK_Q - 1) / BLOCK_Q);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), t_q, t_k, scale, causal, q_offset,
      kv_offset, window);
  return cudaGetLastError();
}

// ------------------------------------------- bf16 inputs: wgmma fed by TMA

constexpr int TC_M = 128;        // q rows per block: two consumer warpgroups of 64
constexpr int TC_N = 128;        // keys per k/v tile
constexpr int TC_STAGES = 2;     // k/v tiles in flight
constexpr int TC_THREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr uint32_t Q_BOX = TC_M * 128;   // bytes of one [rows][64] box
constexpr uint32_t KV_BOX = TC_N * 128;

template <int D>
struct FwdTiles {  // each [rows][64] box 1024-byte aligned (16 KB or 8 KB)
  __nv_bfloat16 q[D / 64][TC_M][64];
  __nv_bfloat16 k[TC_STAGES][D / 64][TC_N][64];
  __nv_bfloat16 v[TC_STAGES][D / 64][TC_N][64];
  uint64_t q_full;
  uint64_t full[TC_STAGES];   // the stage's k and v have landed
  uint64_t empty[TC_STAGES];  // both consumer warpgroups are done with it
};

template <int D, typename TO>
__global__ void __launch_bounds__(TC_THREADS, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, TO* __restrict__ o,
                    float* __restrict__ lse, int t_q, int t_k, float scale, int causal,
                    int q_offset, int kv_offset, int window) {
  using namespace hopper;
  FwdTiles<D>& sm = aligned_smem<FwdTiles<D>>();
  const int wg = threadIdx.x / 128;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TC_M;
  const int q_first = q_offset + q0;
  const int q_last = q_first + TC_M - 1;
  const int num_k = (t_k + TC_N - 1) / TC_N;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 256);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // the producer: one thread issues every TMA load
    regs_release<24>();
    if (threadIdx.x != 0) return;
    mbar_arrive_expect_tx(&sm.q_full, sizeof(sm.q));
    for (int c = 0; c < D / 64; ++c) tma_load_3d(sm.q[c], &tm_q, &sm.q_full, 64 * c, q0, bh);
    int it = 0;  // active tiles so far: stage it % 2, ring pass it / 2
    for (int kt = 0; kt < num_k; ++kt) {
      const int kv_first = kv_offset + kt * TC_N;
      if (!flash::classify(q_first, q_last, kv_first, kv_first + TC_N - 1, causal, window)
               .active)
        continue;
      const int s = it % TC_STAGES;
      mbar_wait(&sm.empty[s], ((it / TC_STAGES) & 1) ^ 1);
      mbar_arrive_expect_tx(&sm.full[s], sizeof(sm.k[0]) + sizeof(sm.v[0]));
      for (int c = 0; c < D / 64; ++c) {
        tma_load_3d(sm.k[s][c], &tm_k, &sm.full[s], 64 * c, kt * TC_N, bh);
        tma_load_3d(sm.v[s][c], &tm_v, &sm.full[s], 64 * c, kt * TC_N, bh);
      }
      ++it;
    }
    return;
  }

  // A consumer warpgroup: q rows cw*64 .. cw*64 + 63 of the tile.  This
  // thread holds rows `row` and `row + 8`, columns 8j + 2t + (0, 1).
  regs_claim<240>();
  const int cw = wg - 1;
  const int lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int row = cw * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};
  mbar_wait(&sm.q_full, 0);

  int it = 0;
  for (int kt = 0; kt < num_k; ++kt) {
    const int k0 = kt * TC_N;
    const int kv_first = kv_offset + k0;
    const flash::TileClass tc =
        flash::classify(q_first, q_last, kv_first, kv_first + TC_N - 1, causal, window);
    if (!tc.active) continue;
    const bool masked = tc.straddles || k0 + TC_N > t_k;
    const int s = it % TC_STAGES;
    mbar_wait(&sm.full[s], (it / TC_STAGES) & 1);

    const uint32_t q_rows = smem_u32(sm.q[0][cw * 64]);
    const uint32_t k_tile = smem_u32(sm.k[s]);
    float sc[TC_N / 2];  // S = Q·Kᵀ, f32
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<TC_N>(sc, desc_k_major(q_rows + kk / 4 * Q_BOX, kk % 4),
                     desc_k_major(k_tile + kk / 4 * KV_BOX, kk % 4), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // Online softmax, per row.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q_pos = q_first + row + 8 * r;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < TC_N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * r + e;
          float x = sc[i] * scale;
          if (masked) {
            const int col = k0 + 8 * j + 2 * t + e;
            if (!(col < t_k && flash::visible(q_pos, kv_offset + col, causal, window)))
              x = NEG_INF;
          }
          sc[i] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_cur = fmaxf(mx, m[r]);
      // A row that has seen no key keeps m_cur == NEG_INF: shift by 0 so p = 0.
      const float m_safe = m_cur <= NEG_INF / 2 ? 0.f : m_cur;
      const float correction = __expf((m[r] <= NEG_INF / 2 ? NEG_INF : m[r]) - m_safe);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TC_N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * r + e;
          sc[i] = __expf(sc[i] - m_safe);
          sum += sc[i];
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[r] = l[r] * correction + sum;
      m[r] = m_cur;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j + 2 * r] *= correction;
        acc[4 * j + 2 * r + 1] *= correction;
      }
    }

    // O += P·V, P rounded to bf16 in registers.
    uint32_t pa[TC_N / 16][4];
    acc_to_a<TC_N>(sc, pa);
    const uint32_t v_tile = smem_u32(sm.v[s]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TC_N / 16; ++kk)
      wgmma_rs_mn<D>(acc, pa[kk], desc_mn_major(v_tile + 16 * kk * 128, KV_BOX), 1);
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
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    TO* orow = o + ((size_t)bh * t_q + q) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store_pair(orow + 8 * j + 2 * t, acc[4 * j + 2 * r] / l_safe,
                 acc[4 * j + 2 * r + 1] / l_safe);
    if (t == 0) lse[(size_t)bh * t_q + q] = m[r] + logf(fmaxf(l[r], 1e-37f));
  }
}

template <int D, typename TO>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, void* lse,
                         int bh, int t_q, int t_k, float scale, int causal, int q_offset,
                         int kv_offset, int window, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err = hopper::encode_rows_map(&tm_q, q, bh, t_q, D, TC_M);
  if (err == cudaSuccess) err = hopper::encode_rows_map(&tm_k, k, bh, t_k, D, TC_N);
  if (err == cudaSuccess) err = hopper::encode_rows_map(&tm_v, v, bh, t_k, D, TC_N);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = sizeof(FwdTiles<D>) + 1024;
  auto kernel = flash_fwd_wgmma<D, TO>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (t_q + TC_M - 1) / TC_M);
  kernel<<<grid, TC_THREADS, smem, stream>>>(tm_q, tm_k, tm_v, static_cast<TO*>(o),
                                             static_cast<float*>(lse), t_q, t_k, scale, causal,
                                             q_offset, kv_offset, window);
  return cudaGetLastError();
}

template <typename TO>
cudaError_t launch_wgmma_d(int head_dim, const void* q, const void* k, const void* v, void* o,
                           void* lse, int bh, int t_q, int t_k, float scale, int causal,
                           int q_offset, int kv_offset, int window, cudaStream_t stream) {
  if (head_dim == 64)
    return launch_wgmma<64, TO>(q, k, v, o, lse, bh, t_q, t_k, scale, causal, q_offset,
                                kv_offset, window, stream);
  if (head_dim == 128)
    return launch_wgmma<128, TO>(q, k, v, o, lse, bh, t_q, t_k, scale, causal, q_offset,
                                 kv_offset, window, stream);
  return cudaErrorInvalidValue;
}

// --------------------------------------------------- known-answer probe

// The building blocks of the kernels above and of flash_bwd.cu, at their
// operand shapes, against answers the caller computes with torch: one
// warpgroup TMA-loads head 1 of a ragged [2, t_a, D] tensor `a` (64-row box,
// rows past t_a read as zeros) and head 0 of [1, N, D] tensors `b` and `v`,
// copies the `a` tile out through the 128-byte swizzle, takes
// S = A·Bᵀ (SS, K-major) and O = P·V with P [64, N] from registers (RS, V
// MN-major).
template <int D, int N>
struct ProbeTiles {
  __nv_bfloat16 a[D / 64][64][64];
  __nv_bfloat16 b[D / 64][N][64];
  __nv_bfloat16 v[D / 64][N][64];
  uint64_t full;
};

template <int D, int N>
__global__ void __launch_bounds__(128)
    hopper_probe(const __grid_constant__ CUtensorMap tm_a,
                 const __grid_constant__ CUtensorMap tm_b,
                 const __grid_constant__ CUtensorMap tm_v, const __nv_bfloat16* __restrict__ p,
                 float* __restrict__ s_out, float* __restrict__ o_out,
                 __nv_bfloat16* __restrict__ a_copy) {
  using namespace hopper;
  ProbeTiles<D, N>& sm = aligned_smem<ProbeTiles<D, N>>();
  if (threadIdx.x == 0) {
    mbar_init(&sm.full, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(&sm.full, sizeof(sm.a) + sizeof(sm.b) + sizeof(sm.v));
    for (int c = 0; c < D / 64; ++c) {
      tma_load_3d(sm.a[c], &tm_a, &sm.full, 64 * c, 0, 1);
      tma_load_3d(sm.b[c], &tm_b, &sm.full, 64 * c, 0, 0);
      tma_load_3d(sm.v[c], &tm_v, &sm.full, 64 * c, 0, 0);
    }
  }
  mbar_wait(&sm.full, 0);
  for (int i = threadIdx.x; i < 64 * D; i += 128) {
    const int r = i / D;
    const int c = i % D;
    a_copy[i] = sm.a[c / 64][r][((c % 64 / 8) ^ (r % 8)) * 8 + c % 8];
  }

  const int lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int row = threadIdx.x / 32 * 16 + lane / 4;
  float sc[N / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<N>(sc, desc_k_major(smem_u32(sm.a[kk / 4]), kk % 4),
                desc_k_major(smem_u32(sm.b[kk / 4]), kk % 4), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) s_out[(row + 8 * r) * N + 8 * j + 2 * t + e] = sc[4 * j + 2 * r + e];

  uint32_t pa[N / 16][4];
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int h = 0; h < 4; ++h)
      pa[kk][h] = *reinterpret_cast<const uint32_t*>(p + (row + 8 * (h % 2)) * N + 16 * kk +
                                                     8 * (h / 2) + 2 * t);
  float oc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oc[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    wgmma_rs_mn<D>(oc, pa[kk], desc_mn_major(smem_u32(sm.v[0][16 * kk]), N * 128), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(oc);
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) o_out[(row + 8 * r) * D + 8 * j + 2 * t + e] = oc[4 * j + 2 * r + e];
}

template <int D, int N>
cudaError_t launch_probe(const void* a, const void* b, const void* v, const void* p, void* s_out,
                         void* o_out, void* a_copy, int t_a, cudaStream_t stream) {
  CUtensorMap tm_a, tm_b, tm_v;
  cudaError_t err = hopper::encode_rows_map(&tm_a, a, 2, t_a, D, 64);
  if (err == cudaSuccess) err = hopper::encode_rows_map(&tm_b, b, 1, N, D, N);
  if (err == cudaSuccess) err = hopper::encode_rows_map(&tm_v, v, 1, N, D, N);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = sizeof(ProbeTiles<D, N>) + 1024;
  auto kernel = hopper_probe<D, N>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<1, 128, smem, stream>>>(tm_a, tm_b, tm_v, static_cast<const __nv_bfloat16*>(p),
                                   static_cast<float*>(s_out), static_cast<float*>(o_out),
                                   static_cast<__nv_bfloat16*>(a_copy));
  return cudaGetLastError();
}

}  // namespace

// q, k, v: [bh, t, head_dim] contiguous, f32 (bf16_in == 0) or bf16 (then
// 16-byte aligned); o: [bh, t_q, head_dim] in the input dtype, or f32 when
// f32_out; lse: [bh, t_q] f32.  window <= 0 means no window.  f32 inputs
// take the CUDA-core kernel and bf16 inputs the tensor-core one, always.
// Returns a cudaError_t.
extern "C" int rf_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int device, int bh, int t_q,
                            int t_k, int head_dim, int bf16_in, int f32_out,
                            float scale, int causal, int q_offset,
                            int kv_offset, int window, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16_in) {
    if (head_dim == 64)
      return launch_f32<64>(q, k, v, o, lse, bh, t_q, t_k, scale, causal, q_offset, kv_offset,
                            window, s);
    if (head_dim == 128)
      return launch_f32<128>(q, k, v, o, lse, bh, t_q, t_k, scale, causal, q_offset, kv_offset,
                             window, s);
    return cudaErrorInvalidValue;
  }
  if (f32_out)
    return launch_wgmma_d<float>(head_dim, q, k, v, o, lse, bh, t_q, t_k, scale, causal,
                                 q_offset, kv_offset, window, s);
  return launch_wgmma_d<__nv_bfloat16>(head_dim, q, k, v, o, lse, bh, t_q, t_k, scale, causal,
                                       q_offset, kv_offset, window, s);
}

// The known-answer probe (see `hopper_probe`): a [2, t_a, d], b and v [1, n,
// d], p [64, n], all bf16 and 16-byte aligned; s_out [64, n] and o_out
// [64, d] f32; a_copy [64, d] bf16.  d, n in {64, 128}.
extern "C" int rf_hopper_probe(const void* a, const void* b, const void* v, const void* p,
                               void* s_out, void* o_out, void* a_copy, int device, int t_a,
                               int d, int n, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64 && n == 64) return launch_probe<64, 64>(a, b, v, p, s_out, o_out, a_copy, t_a, s);
  if (d == 64 && n == 128) return launch_probe<64, 128>(a, b, v, p, s_out, o_out, a_copy, t_a, s);
  if (d == 128 && n == 64) return launch_probe<128, 64>(a, b, v, p, s_out, o_out, a_copy, t_a, s);
  if (d == 128 && n == 128)
    return launch_probe<128, 128>(a, b, v, p, s_out, o_out, a_copy, t_a, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* rf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
