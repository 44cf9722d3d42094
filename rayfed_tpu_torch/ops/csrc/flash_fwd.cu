// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_fwd_kernel` of
// rayfed_tpu/ops/flash_attention.py (line 84), launched through
// pl.pallas_call by `_flash_forward` (line 174).  It computes the same
// function: o = softmax(scale * Q Kᵀ + mask) V and lse = m + log l per row,
// over [BH, T, D] tensors, with the causal / sliding-window / offset masks
// and the TPU kernel's guards for fully masked rows (o = 0, lse ~ NEG_INF).
//
// What bounds it on the H100: at the prefill shape (T = 2048, D = 128) the
// work is ~2·T·D flops per loaded byte, far above the card's ~295 flop/byte
// ridge, so the bound is arithmetic.  This first version does the two
// products on the CUDA cores in f32 (no tensor cores), so it runs at a
// fraction of the bf16 tensor-core bound; the design keeps it from being
// bound by shared memory instead:
//   * One block per (bh, tile of 64 q rows); a loop over 32-row k/v tiles
//     takes the place of the TPU's sequential third grid axis.  The running
//     max m, normaliser l and the f32 accumulator live in registers.
//   * Each thread owns 4 q rows x (2 score columns, D/16 output columns), so
//     every 128-bit shared-memory read feeds 4-8 FMAs.  K rows are padded so
//     the 16 column threads of a row hit 16 different bank groups.
//   * Tiles are classified as the TPU's `_causal_dispatch` does: skipped
//     (past the diagonal or below the window band), unmasked, or masked.
//     A tile that runs past T is masked too, so any T works (the TPU's
//     divisor search `_fit_block` does not apply).  q tiles are launched
//     last-first, so the heaviest causal tiles start first.
// Rounding follows the TPU kernel: scores are f32, scaled after the dot; p
// is rounded to V's dtype before P·V; l sums the unrounded p.
// Tensor cores (mma.sync / wgmma), TMA and pipelining are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BLOCK_Q = 64;
constexpr int BLOCK_K = 32;
constexpr int THREADS = 256;          // 16 x 16: ty picks rows, tx columns
constexpr int ROWS = BLOCK_Q / 16;    // q rows per thread
constexpr int SCOLS = BLOCK_K / 16;   // score columns per thread
constexpr int PSTRIDE = BLOCK_K + 4;  // row stride of the P tile (floats)

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

__device__ __forceinline__ float component(const float4& x, int u) {
  return u == 0 ? x.x : u == 1 ? x.y : u == 2 ? x.z : x.w;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BLOCK_Q * D + BLOCK_K * (D + 4) + BLOCK_K * D + BLOCK_Q * PSTRIDE);
}

template <typename T, typename TO, int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, TO* __restrict__ o,
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
  const T* qb = q + bh * t_q * D;
  const T* kb = k + bh * t_k * D;
  const T* vb = v + bh * t_k * D;

  for (int i = tid; i < BLOCK_Q * D; i += THREADS) {
    const int r = i / D;
    sq[i] = q0 + r < t_q ? to_float(qb[(size_t)(q0 + r) * D + i % D]) : 0.f;
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
    // `_causal_dispatch`: the same for every thread of the block.
    const int kv_first = kv_offset + k0;
    const int kv_last = kv_first + BLOCK_K - 1;
    bool active = true;
    bool straddles = false;
    if (causal) {
      active = kv_first <= q_last;
      straddles = kv_last > q_first;
      if (window > 0) {
        active = active && kv_last > q_first - window;
        straddles = straddles || q_last - kv_first >= window;
      }
    }
    if (!active) continue;
    const bool masked = straddles || k0 + BLOCK_K > t_k;

    __syncthreads();  // the last tile's P·V is done with sk, sv and sp
    for (int i = tid; i < BLOCK_K * D; i += THREADS) {
      const int r = i / D;
      const int c = i % D;
      const bool in = k0 + r < t_k;
      const size_t g = (size_t)(k0 + r) * D + c;
      sk[r * KSTRIDE + c] = in ? to_float(kb[g]) : 0.f;
      sv[i] = in ? to_float(vb[g]) : 0.f;
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
          const int k_pos = kv_offset + col;
          bool visible = col < t_k;
          if (causal) {
            visible = visible && q_pos >= k_pos;
            if (window > 0) visible = visible && q_pos - k_pos < window;
          }
          if (!visible) x = NEG_INF;
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
        sp[(ty + 16 * i) * PSTRIDE + tx + 16 * j] = to_float(from_float<T>(p));
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
    TO* orow = o + (bh * t_q + r) * D;
#pragma unroll
    for (int g = 0; g < GROUPS; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        orow[64 * g + 4 * tx + e] = from_float<TO>(acc[i][4 * g + e] / l_safe);
    if (tx == 0) lse[bh * t_q + r] = m[i] + logf(fmaxf(l[i], 1e-37f));
  }
}

template <typename T, typename TO, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int t_q, int t_k, float scale,
                   int causal, int q_offset, int kv_offset, int window,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_fwd_kernel<T, TO, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (t_q + BLOCK_Q - 1) / BLOCK_Q);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<TO*>(o), static_cast<float*>(lse),
      t_q, t_k, scale, causal, q_offset, kv_offset, window);
  return cudaGetLastError();
}

template <typename T, typename TO>
cudaError_t launch_d(int head_dim, const void* q, const void* k, const void* v,
                     void* o, void* lse, int bh, int t_q, int t_k, float scale,
                     int causal, int q_offset, int kv_offset, int window,
                     cudaStream_t stream) {
  if (head_dim == 64)
    return launch<T, TO, 64>(q, k, v, o, lse, bh, t_q, t_k, scale, causal,
                             q_offset, kv_offset, window, stream);
  if (head_dim == 128)
    return launch<T, TO, 128>(q, k, v, o, lse, bh, t_q, t_k, scale, causal,
                              q_offset, kv_offset, window, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v: [bh, t, head_dim] contiguous, f32 (bf16_in == 0) or bf16;
// o: [bh, t_q, head_dim] in the input dtype, or f32 when f32_out; lse:
// [bh, t_q] f32.  window <= 0 means no window.  Returns a cudaError_t.
extern "C" int rf_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int device, int bh, int t_q,
                            int t_k, int head_dim, int bf16_in, int f32_out,
                            float scale, int causal, int q_offset,
                            int kv_offset, int window, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16_in)
    return launch_d<float, float>(head_dim, q, k, v, o, lse, bh, t_q, t_k,
                                  scale, causal, q_offset, kv_offset, window, s);
  if (f32_out)
    return launch_d<__nv_bfloat16, float>(head_dim, q, k, v, o, lse, bh, t_q,
                                          t_k, scale, causal, q_offset,
                                          kv_offset, window, s);
  return launch_d<__nv_bfloat16, __nv_bfloat16>(head_dim, q, k, v, o, lse, bh,
                                                t_q, t_k, scale, causal,
                                                q_offset, kv_offset, window, s);
}

extern "C" const char* rf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
