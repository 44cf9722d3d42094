// RMSNorm for Hopper (sm_90a): the Llama decoder's norm, its forward and its
// backward, one kernel each.
//
// Replaces no Pallas kernel: the JAX package writes the norm as jnp ops
// (rayfed_tpu/models/llama.py `_rms_norm`) and XLA fuses them into the
// programs around it.  PyTorch runs the same formula on the card as about
// ten passes over f32 copies of the row (the cast, the square, the mean,
// two broadcast products, the cast back) and autograd's backward as many
// again.  These kernels compute, per row of `width` elements,
//   forward:  r = rsqrt(Σx²/width + eps),  y = cast((x·r)·scale),
//   backward: x̂ = x·r, g = dy·scale,  dx = r·(g − x̂·Σ(g·x̂)/width),
//             dscale = Σ_rows dy·x̂ (only when the scale needs a gradient),
// in f32 whatever the input's type (f32, bf16 or f16, and the scale's each
// of the three), with y's two products rounded in the order of the PyTorch
// formula (ops/rms_norm.py `rms_norm_plain`).
//
// What bounds them on the H100: bytes.  The forward does ~4 operations an
// element for 4 bytes (bf16 x read, y written), the backward ~8 for 6: three
// orders of magnitude under the card's operations-to-bytes ridge.  So the
// design is about touching each byte once:
//   - a row is read once and held in registers (units of 8 elements, one
//     16-byte load of bf16 or f16, two of f32; two units a thread, at most
//     512 threads a row, so widths up to 8192), so the sum of squares and
//     the output read no second copy; the forward writes y and, when a
//     gradient is wanted, one f32 rstd a row, which the backward reads
//     instead of recomputing the sum;
//   - any other width (not a multiple of 8, or wider than 8192) takes the
//     same kernels' element-by-element form, which reads the row twice
//     (the second read from L2) and holds dscale's partial row in memory;
//   - the row's sums are reduced in f32 within warps (shuffles) and then
//     across the block's warps in a fixed order, so every thread holds the
//     same value and a run gives the same bits each time;
//   - a grid of as many blocks as the card holds at once, each walking rows
//     (blockIdx.x, + gridDim.x, ...): the scale is read from L1, and the
//     backward keeps each thread's columns' share of dscale over its rows,
//     writes one f32 partial row a block, and a second small kernel sums the
//     partials in block order (no atomics: deterministic);
//   - the decode step's few rows take a block each (grid = rows).
// The grid is the caller's: rf_rms_norm_resident gives the blocks the card
// holds at once for a kernel, which the caller asks once and keeps, so a
// launch makes no occupancy query.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kF16 = 2;
constexpr int kVec = 8;            // elements of a unit
constexpr int kWarp = 32;
constexpr int kMaxThreads = 512;   // threads of a row's block
constexpr int kUnits = 2;          // units a thread: width <= 8 · 2 · 512 = 8192
constexpr int kReduceRows = 16;    // partial rows a dscale block sums at once

struct Args {
  const void* x;
  const void* dy;        // backward
  const void* scale;     // [width]
  const float* rstd_in;  // backward: [rows]
  void* out;             // y (forward) or dx (backward)
  float* rstd;           // forward: [rows], or null
  float* part;           // backward: [gridDim.x, width] partials of dscale, or null
  int rows;
  int width;
  float inv_width;       // f32(1 / width)
  float eps;
};

using Kernel = void (*)(Args);

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store_one(__half* p, float v) { *p = __float2half_rn(v); }

__device__ __forceinline__ void load_unit(const float* p, float (&v)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Eight 16-bit elements from one 16-byte load; the low half of a word is
// the lower address.
__device__ __forceinline__ void load_unit(const __nv_bfloat16* p, float (&v)[kVec]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(words[i] << 16);
    v[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load_unit(const __half* p, float (&v)[kVec]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __half2float(__ushort_as_half(static_cast<unsigned short>(words[i] & 0xffffu)));
    v[2 * i + 1] = __half2float(__ushort_as_half(static_cast<unsigned short>(words[i] >> 16)));
  }
}

__device__ __forceinline__ void store_unit(float* p, const float (&v)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ uint32_t bits16(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }
__device__ __forceinline__ uint32_t bits16(__half v) { return __half_as_ushort(v); }

template <typename T>
__device__ __forceinline__ void store_unit(T* p, const float (&v)[kVec]) {
  uint32_t words[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    T lo, hi;
    store_one(&lo, v[2 * i]);
    store_one(&hi, v[2 * i + 1]);
    words[i] = bits16(lo) | (bits16(hi) << 16);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(words[0], words[1], words[2], words[3]);
}

// The sum of v over the block, the same bits in every thread: butterfly
// shuffles within each warp (every lane ends with the same sum), then every
// thread adds the warps' sums in warp order.  `warp_sums` is free again when
// it returns.
__device__ __forceinline__ float block_sum(float v, float* warp_sums) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (threadIdx.x % kWarp == 0) warp_sums[threadIdx.x / kWarp] = v;
  __syncthreads();
  float t = 0.0f;
  const int warps = blockDim.x / kWarp;
  for (int w = 0; w < warps; ++w) t += warp_sums[w];
  __syncthreads();
  return t;
}

// The forward, a row held in registers: width % 8 == 0, width <= 8192,
// every pointer 16-byte aligned.
template <typename T, typename S>
__global__ void __launch_bounds__(kMaxThreads) rms_norm_fwd(Args a) {
  __shared__ float warp_sums[kMaxThreads / kWarp];
  const T* x = static_cast<const T*>(a.x);
  const S* scale = static_cast<const S*>(a.scale);
  T* y = static_cast<T*>(a.out);
  const int units = a.width / kVec;
  for (int row = blockIdx.x; row < a.rows; row += gridDim.x) {
    const long long base = static_cast<long long>(row) * a.width;
    float v[kUnits][kVec];
    float ss = 0.0f;
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      const int u = threadIdx.x + k * blockDim.x;
      if (u < units) {
        load_unit(x + base + u * kVec, v[k]);
#pragma unroll
        for (int i = 0; i < kVec; ++i) ss = __fmaf_rn(v[k][i], v[k][i], ss);
      }
    }
    const float total = block_sum(ss, warp_sums);
    const float r = rsqrtf(__fadd_rn(__fmul_rn(total, a.inv_width), a.eps));
    if (a.rstd != nullptr && threadIdx.x == 0) a.rstd[row] = r;
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      const int u = threadIdx.x + k * blockDim.x;
      if (u < units) {
        float s[kVec];
        load_unit(scale + u * kVec, s);
#pragma unroll
        for (int i = 0; i < kVec; ++i) v[k][i] = __fmul_rn(__fmul_rn(v[k][i], r), s[i]);
        store_unit(y + base + u * kVec, v[k]);
      }
    }
  }
}

// The forward element by element, for any width: the row is read twice.
template <typename T, typename S>
__global__ void __launch_bounds__(kMaxThreads) rms_norm_fwd_any(Args a) {
  __shared__ float warp_sums[kMaxThreads / kWarp];
  const T* x = static_cast<const T*>(a.x);
  const S* scale = static_cast<const S*>(a.scale);
  T* y = static_cast<T*>(a.out);
  for (int row = blockIdx.x; row < a.rows; row += gridDim.x) {
    const long long base = static_cast<long long>(row) * a.width;
    float ss = 0.0f;
    for (int c = threadIdx.x; c < a.width; c += blockDim.x) {
      const float v = to_f32(x[base + c]);
      ss = __fmaf_rn(v, v, ss);
    }
    const float total = block_sum(ss, warp_sums);
    const float r = rsqrtf(__fadd_rn(__fmul_rn(total, a.inv_width), a.eps));
    if (a.rstd != nullptr && threadIdx.x == 0) a.rstd[row] = r;
    for (int c = threadIdx.x; c < a.width; c += blockDim.x)
      store_one(y + base + c, __fmul_rn(__fmul_rn(to_f32(x[base + c]), r), to_f32(scale[c])));
  }
}

// The backward, a row held in registers (the forward's conditions).
template <typename T, typename S>
__global__ void __launch_bounds__(kMaxThreads) rms_norm_bwd(Args a) {
  __shared__ float warp_sums[kMaxThreads / kWarp];
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  const S* scale = static_cast<const S*>(a.scale);
  T* dx = static_cast<T*>(a.out);
  const int units = a.width / kVec;
  float acc[kUnits][kVec];  // this thread's columns of Σ dy·x̂ over the block's rows
#pragma unroll
  for (int k = 0; k < kUnits; ++k)
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[k][i] = 0.0f;
  for (int row = blockIdx.x; row < a.rows; row += gridDim.x) {
    const long long base = static_cast<long long>(row) * a.width;
    const float r = a.rstd_in[row];
    float xh[kUnits][kVec], g[kUnits][kVec];
    float dot = 0.0f;
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      const int u = threadIdx.x + k * blockDim.x;
      if (u < units) {
        float d[kVec], s[kVec];
        load_unit(x + base + u * kVec, xh[k]);
        load_unit(dy + base + u * kVec, d);
        load_unit(scale + u * kVec, s);
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          xh[k][i] = __fmul_rn(xh[k][i], r);
          g[k][i] = __fmul_rn(d[i], s[i]);
          dot = __fmaf_rn(g[k][i], xh[k][i], dot);
          if (a.part != nullptr) acc[k][i] = __fmaf_rn(d[i], xh[k][i], acc[k][i]);
        }
      }
    }
    const float c = __fmul_rn(block_sum(dot, warp_sums), a.inv_width);
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      const int u = threadIdx.x + k * blockDim.x;
      if (u < units) {
#pragma unroll
        for (int i = 0; i < kVec; ++i) g[k][i] = __fmul_rn(r, __fmaf_rn(-xh[k][i], c, g[k][i]));
        store_unit(dx + base + u * kVec, g[k]);
      }
    }
  }
  if (a.part == nullptr) return;
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    const int u = threadIdx.x + k * blockDim.x;
    if (u < units) store_unit(a.part + static_cast<long long>(blockIdx.x) * a.width + u * kVec, acc[k]);
  }
}

// The backward element by element, for any width: x, dy and the scale are
// read twice, and each thread adds its columns' dy·x̂ into the block's
// partial row in memory (only it touches them, in row order).
template <typename T, typename S>
__global__ void __launch_bounds__(kMaxThreads) rms_norm_bwd_any(Args a) {
  __shared__ float warp_sums[kMaxThreads / kWarp];
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  const S* scale = static_cast<const S*>(a.scale);
  T* dx = static_cast<T*>(a.out);
  float* part = a.part == nullptr ? nullptr : a.part + static_cast<long long>(blockIdx.x) * a.width;
  if (part != nullptr)
    for (int c = threadIdx.x; c < a.width; c += blockDim.x) part[c] = 0.0f;
  for (int row = blockIdx.x; row < a.rows; row += gridDim.x) {
    const long long base = static_cast<long long>(row) * a.width;
    const float r = a.rstd_in[row];
    float dot = 0.0f;
    for (int c = threadIdx.x; c < a.width; c += blockDim.x)
      dot = __fmaf_rn(__fmul_rn(to_f32(dy[base + c]), to_f32(scale[c])), __fmul_rn(to_f32(x[base + c]), r), dot);
    const float m = __fmul_rn(block_sum(dot, warp_sums), a.inv_width);
    for (int c = threadIdx.x; c < a.width; c += blockDim.x) {
      const float d = to_f32(dy[base + c]);
      const float xh = __fmul_rn(to_f32(x[base + c]), r);
      store_one(dx + base + c, __fmul_rn(r, __fmaf_rn(-xh, m, __fmul_rn(d, to_f32(scale[c])))));
      if (part != nullptr) part[c] = __fmaf_rn(d, xh, part[c]);
    }
  }
}

// dscale[c] = Σ_p part[p, c] in a fixed order: thread (c, y) sums the rows
// p ≡ y (mod kReduceRows) in order, then one thread a column adds the
// kReduceRows sums in order and casts.
template <typename S>
__global__ void rms_norm_dscale(const float* part, int nparts, int width, S* dscale) {
  __shared__ float sums[kReduceRows][kWarp + 1];
  const int col = blockIdx.x * kWarp + threadIdx.x;
  float t = 0.0f;
  if (col < width)
    for (int p = threadIdx.y; p < nparts; p += kReduceRows) t += part[static_cast<long long>(p) * width + col];
  sums[threadIdx.y][threadIdx.x] = t;
  __syncthreads();
  if (threadIdx.y != 0 || col >= width) return;
  float total = 0.0f;
  for (int w = 0; w < kReduceRows; ++w) total += sums[w][threadIdx.x];
  store_one(dscale + col, total);
}

// Whether a row of `width` fits the registers' form.
bool in_registers(int width) { return width % kVec == 0 && width <= kVec * kUnits * kMaxThreads; }

template <typename T, typename S>
Kernel pick_form(bool backward, bool regs) {
  if (backward) return regs ? rms_norm_bwd<T, S> : rms_norm_bwd_any<T, S>;
  return regs ? rms_norm_fwd<T, S> : rms_norm_fwd_any<T, S>;
}

template <typename T>
Kernel pick_scale(bool backward, bool regs, int scale_dtype) {
  switch (scale_dtype) {
    case kF32: return pick_form<T, float>(backward, regs);
    case kBF16: return pick_form<T, __nv_bfloat16>(backward, regs);
    case kF16: return pick_form<T, __half>(backward, regs);
    default: return nullptr;
  }
}

// The kernel and its threads a block (a whole number of warps) for a row of
// `width`, or cudaErrorInvalidValue.
cudaError_t plan(bool backward, int x_dtype, int scale_dtype, int width, Kernel* kernel, int* threads) {
  if (width <= 0) return cudaErrorInvalidValue;
  const bool regs = in_registers(width);
  switch (x_dtype) {
    case kF32: *kernel = pick_scale<float>(backward, regs, scale_dtype); break;
    case kBF16: *kernel = pick_scale<__nv_bfloat16>(backward, regs, scale_dtype); break;
    case kF16: *kernel = pick_scale<__half>(backward, regs, scale_dtype); break;
    default: *kernel = nullptr;
  }
  if (*kernel == nullptr) return cudaErrorInvalidValue;
  const int lanes = regs ? (width / kVec + kUnits - 1) / kUnits : width;  // threads with work
  *threads = lanes >= kMaxThreads ? kMaxThreads : (lanes + kWarp - 1) / kWarp * kWarp;
  return cudaSuccess;
}

cudaError_t use_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return err;
  return cur == device ? cudaSuccess : cudaSetDevice(device);
}

}  // namespace

// The blocks the card holds at once of the forward (backward = 0) or the
// backward kernel for a row of `width`, or a negative cudaError_t.  A launch
// takes min(rows, this) blocks, and the backward with dscale writes that many
// partial rows.
extern "C" int rf_rms_norm_resident(int backward, int width, int x_dtype, int scale_dtype, int device) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  Kernel kernel;
  int threads, sms = 0, per_sm = 0;
  err = plan(backward != 0, x_dtype, scale_dtype, width, &kernel, &threads);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return sms * (per_sm > 0 ? per_sm : 1);
}

// The forward: y = cast((x·r)·scale) over rows x width, r written to rstd
// when it is not null, on `blocks` blocks.  x, y: of x_dtype (0 f32, 1 bf16,
// 2 f16); scale: [width] of scale_dtype; every pointer 16-byte aligned.
// Returns a cudaError_t.
extern "C" int rf_rms_norm_fwd(void* y, float* rstd, const void* x, const void* scale, int rows, int width,
                               int x_dtype, int scale_dtype, float eps, int blocks, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (rows == 0) return cudaSuccess;
  Kernel kernel;
  int threads;
  err = plan(false, x_dtype, scale_dtype, width, &kernel, &threads);
  if (err != cudaSuccess) return err;
  if (rows < 0 || blocks <= 0 || blocks > rows) return cudaErrorInvalidValue;
  Args a = {};
  a.x = x;
  a.scale = scale;
  a.out = y;
  a.rstd = rstd;
  a.rows = rows;
  a.width = width;
  a.inv_width = 1.0f / static_cast<float>(width);
  a.eps = eps;
  kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

// The backward on `blocks` blocks: dx over rows x width from x, dy (of
// x_dtype), the forward's rstd and the scale; with dscale (of scale_dtype)
// also Σ_rows dy·x̂, through part, f32 [blocks, width].
extern "C" int rf_rms_norm_bwd(void* dx, void* dscale, float* part, const void* dy, const void* x,
                               const float* rstd, const void* scale, int rows, int width, int x_dtype,
                               int scale_dtype, int blocks, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (rows == 0) return cudaSuccess;
  Kernel kernel;
  int threads;
  err = plan(true, x_dtype, scale_dtype, width, &kernel, &threads);
  if (err != cudaSuccess) return err;
  if (rows < 0 || blocks <= 0 || blocks > rows || (dscale != nullptr) != (part != nullptr))
    return cudaErrorInvalidValue;
  Args a = {};
  a.x = x;
  a.dy = dy;
  a.scale = scale;
  a.rstd_in = rstd;
  a.out = dx;
  a.part = part;
  a.rows = rows;
  a.width = width;
  a.inv_width = 1.0f / static_cast<float>(width);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<blocks, threads, 0, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || dscale == nullptr) return err;
  const dim3 grid((width + kWarp - 1) / kWarp), block(kWarp, kReduceRows);
  switch (scale_dtype) {
    case kF32: rms_norm_dscale<<<grid, block, 0, st>>>(part, blocks, width, static_cast<float*>(dscale)); break;
    case kBF16:
      rms_norm_dscale<<<grid, block, 0, st>>>(part, blocks, width, static_cast<__nv_bfloat16*>(dscale));
      break;
    default: rms_norm_dscale<<<grid, block, 0, st>>>(part, blocks, width, static_cast<__half*>(dscale));
  }
  return cudaGetLastError();
}

extern "C" const char* rf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
