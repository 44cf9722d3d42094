// The float fold's fused multiply-add for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is the XLA program the JAX package jits for
// the float packed fold, `_accum_kernel` of rayfed_tpu/fl/streaming.py (line
// 63, `acc + w·x`) and `_packed_reduce_jit` of rayfed_tpu/fl/fedavg.py (line
// 83, the chain `w0·x0 + w1·x1 + ...`), which XLA on the CPU compiles into
// fused multiply-adds.  Each output element is one __fmaf_rn, the correctly
// rounded fused multiply-add, so the bytes equal the plain version's
// (ops/fold.py `fma`: f64 product, TwoSum error, round to odd) on either
// device, and the JAX package's on the CPU.
//
// Two forms, one kernel: out = fma(w, x, acc) (the streamed step and the
// one-shot chain's later terms; out may be acc) and out = fma(w, x, v·y)
// with v·y rounded to f32 first (the one-shot chain's first two terms, as
// XLA contracts them).  x and y are f32 or bf16 wire elements; the weights
// are f32 values on the card, read once per thread.
//
// What bounds it on the H100: bytes.  One FMA per 10 bytes moved (a bf16 x
// read, an f32 accumulator read and written), 2 orders of magnitude under
// the card's flop/byte ridge.  A grid-stride loop of coalesced loads, a few
// blocks per SM, no shared memory: nothing else to hide.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void fold_fma(float* out, const float* acc, const T* x, const float* w, const T* y,
                         const float* v, int64_t n) {
  const float wv = *w;
  const float vv = y != nullptr ? *v : 0.0f;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float addend = y != nullptr ? __fmul_rn(vv, to_f32(y[i])) : acc[i];
    out[i] = __fmaf_rn(wv, to_f32(x[i]), addend);
  }
}

template <typename T>
cudaError_t launch(float* out, const float* acc, const void* x, const float* w, const void* y,
                   const float* v, int64_t n, cudaStream_t s) {
  constexpr int kThreads = 256;
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  fold_fma<T><<<blocks, kThreads, 0, s>>>(out, acc, static_cast<const T*>(x), w,
                                         static_cast<const T*>(y), v, n);
  return cudaGetLastError();
}

}  // namespace

// out, acc: [n] f32 (acc may be out; null when y is given); x, y: [n] f32
// (bf16 == 0) or bf16; w, v: one f32 each on the card (v null when y is).
// All contiguous on `device`.  Returns a cudaError_t.
extern "C" int rf_fold_fma(void* out, const void* acc, const void* x, const void* w,
                           const void* y, const void* v, long long n, int bf16, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0) return cudaSuccess;
  if ((y == nullptr) == (acc == nullptr)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<float*>(out);
  auto* a = static_cast<const float*>(acc);
  auto* wp = static_cast<const float*>(w);
  auto* vp = static_cast<const float*>(v);
  if (bf16) return launch<__nv_bfloat16>(o, a, x, wp, y, vp, n, s);
  return launch<float>(o, a, x, wp, y, vp, n, s);
}

extern "C" const char* rf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
