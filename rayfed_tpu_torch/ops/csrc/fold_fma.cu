// The float fold's exactly rounded fused multiply-adds for Hopper (sm_90a).
//
// Replaces no Pallas kernel.  It stands for XLA programs that the JAX
// package jits and that XLA on the CPU compiles into fused multiply-adds:
// the streamed fold step `_accum_kernel` (rayfed_tpu/fl/streaming.py:63,
// `acc + w·x`), the one-shot fold `_packed_reduce_jit` (rayfed_tpu/fl/
// fedavg.py:83, the chain `w0·x0 + w1·x1 + ...`, the divide and the cast),
// and the two multiply-adds of the codec's `_quantize_kernel` (rayfed_tpu/
// fl/quantize.py:473, the residual `a − scale·(q − zp)`) and
// `_dequantize_kernel` (:507, `ref + scale·(q − zp)`).  Every rounding is a
// named intrinsic (__fmaf_rn, __fmul_rn, __fsub_rn, __fdiv_rn,
// __float2bfloat16_rn), so no -fmad setting can contract or
// reorder one, and the bytes equal the plain versions' (ops/fold.py: the f64
// product, TwoSum, round to odd) on either device, and the JAX package's on
// the CPU.
//
// Subnormals flush as XLA:CPU's programs (DAZ and FTZ) and the TPU flush
// them: every f32 operand read, and every weight, is a zero of its sign when
// it is subnormal (daz), and every result that is tiny after rounding, x86's
// rule (the exact value rounded to 24 bits with an unbounded exponent lies
// below 2^-126), is a zero of its sign.  The flushing is written out here
// (the ftz_* helpers) rather than left to `.ftz` instructions or -ftz=true,
// whose tininess rule is not x86's and which would also change the flash
// kernels built with the same flags: a product, FMA or quotient that rounds
// to exactly ±2^-126 is done once more with one operand scaled by 2^64, where
// the exact value is normal and its rounding decides.
//
// Two kernels:
//   fold_chain: t = acc (the streamed step, or a chain carried on from an
//     earlier launch), else t = w0·x0 (one operand) or t = fma(w0, x0, w1·x1)
//     with w1·x1 rounded first (two or more, as XLA contracts the chain);
//     then t = fma(wk, xk, t) for each further operand; out = t, or
//     cast(t / total) when it finalizes.  Up to kMaxOps operands travel in
//     one launch, as pointers and by-value weights in the kernel's parameter
//     struct.  The step (acc = fma(w, x, acc) in place), the pair
//     (fma(w, x, v·y)), the whole one-shot fold and the finalize of a
//     streamed or striped fold (cast(acc / total), no operand) are its forms.
//   fold_rows: out = fma(±s[r], b − z[r], c) with one scale s[r] and zero
//     point z[r] (optional) a row of `width` elements: the codec's residual
//     and its reference add over the grid's block rows.
//   ftz_binary: out = a + b, a − b, a·b or a / b over [rows, width] f32,
//     each operand whole, one value a row or one value, flushed as above:
//     the round's elementwise passes around the fold (the codec's subtract,
//     add and divide, the compressed-domain finalize's rescale, error
//     feedback), one pass each instead of PyTorch's op and its flushing.
//
// What bounds them on the H100: bytes.  A step moves 10 bytes (bf16 x, f32
// accumulator read and written) for one FMA, the chain 2n + 2 for n FMAs
// and a divide, the rows form 9 to 12 for one FMA and a subtract: two orders
// of magnitude under the card's operations-to-bytes ridge.  So the design is
// about moving them at the memory's rate:
//   - 16-byte loads and stores: a thread takes units of 8 elements (one
//     16-byte load of a bf16 operand, two of an f32 one, one 8-byte
//     load of 8 codes), kUnroll units a thread, all of a unit's loads issued
//     before its first FMA, so at least two vectors are in flight a thread;
//   - a scalar head up to the first element where every operand is 16-byte
//     aligned (chunks of a wire frame start at any element offset) and a
//     scalar tail; operands whose alignments disagree take a scalar kernel,
//     one element a thread, with the same arithmetic;
//   - a grid sized to the work (no grid-stride loop), 256 threads a block;
//   - weights, the divisor and the pointers by value, in constant memory:
//     no thread reads a weight from device memory, no host reads the card;
//   - one launch for the whole one-shot fold (reads each contribution once
//     and writes the output once), and one launch for a run of blocks of
//     the streamed fold, so the host's cost per launch is paid per run.

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxOps = 8;    // operands of one chain launch
constexpr int kVec = 8;       // elements of a unit
constexpr int kUnroll = 2;    // units a thread
constexpr int kThreads = 256;

constexpr float kFltMin = 0x1p-126f;  // the least normal f32
constexpr float kUp = 0x1p64f;        // scales a result near kFltMin into the normal range
constexpr float kTinyUp = 0x1p-62f;   // kFltMin · kUp

// Element types, as the launcher numbers them.
enum Dtype : int { kF32 = 0, kBF16 = 1, kU8 = 3, kI8 = 4 };

struct ChainArgs {
  const void* x[kMaxOps];
  float w[kMaxOps];
  const float* acc;  // the running value to continue from; null: the chain starts here
  void* out;
  float total;       // the finalize's divisor
  int nops;
  int divide;        // 1: out = cast(t / total); 0: out = t (f32)
  long long n;
  long long head;    // scalar elements before the first aligned unit
  long long units;   // aligned units after the head
};

// An operand of ftz_binary: read whole, one value a row, or one value.
enum Broadcast : int { kWhole = 0, kPerRow = 1, kOne = 2 };
enum BinaryOp : int { kAdd = 0, kSub = 1, kMul = 2, kDiv = 3 };

struct BinaryArgs {
  const float* a;
  const float* b;
  float* out;
  int a_mode, b_mode, op;
  long long width;   // elements of a row (the grid's y is the row)
};

struct RowsArgs {
  const void* b;
  const float* c;
  float* out;
  const float* s;    // one scale a row
  const float* z;    // one zero point a row, or null
  int negate;        // fma(−s, ...): the codec's residual
  long long n;
  long long width;   // elements of a row
  long long head;
  long long units;
};

// ---------------------------------------------------------------- flushing

// A subnormal operand reads as a zero of its sign.
__device__ __forceinline__ float daz(float x) { return fabsf(x) < kFltMin ? copysignf(0.0f, x) : x; }

// A result r, a zero of its sign when it is tiny after rounding; `scaled` is
// the same operation with an operand times 2^64, read only when |r| = 2^-126.
#define RF_FLUSHED(r, scaled)                                                  \
  do {                                                                         \
    const float m_ = fabsf(r);                                                 \
    if (m_ < kFltMin || (m_ == kFltMin && fabsf(scaled) < kTinyUp)) r = copysignf(0.0f, r); \
  } while (0)

__device__ __forceinline__ float ftz_fma(float a, float b, float c) {
  float r = __fmaf_rn(a, b, c);
  RF_FLUSHED(r, __fmaf_rn(__fmul_rn(a, kUp), b, __fmul_rn(c, kUp)));
  return r;
}

__device__ __forceinline__ float ftz_mul(float a, float b) {
  float r = __fmul_rn(a, b);
  RF_FLUSHED(r, __fmul_rn(__fmul_rn(a, kUp), b));
  return r;
}

__device__ __forceinline__ float ftz_div(float a, float b) {
  float r = __fdiv_rn(a, b);
  RF_FLUSHED(r, __fdiv_rn(__fmul_rn(a, kUp), b));
  return r;
}

// A sum or difference of two normal values below 2^-126 is exact: flushed as
// it is.
__device__ __forceinline__ float ftz_sub(float a, float b) { return daz(__fsub_rn(a, b)); }
__device__ __forceinline__ float ftz_add(float a, float b) { return daz(__fadd_rn(a, b)); }

// ---------------------------------------------------------------- elements

// Float elements are read flushed (daz); codes are integers.
__device__ __forceinline__ float ld1(const float* p, long long i) { return daz(p[i]); }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p, long long i) { return daz(__bfloat162float(p[i])); }
__device__ __forceinline__ float ld1(const uint8_t* p, long long i) { return __uint2float_rn(p[i]); }
__device__ __forceinline__ float ld1(const int8_t* p, long long i) { return __int2float_rn(p[i]); }

__device__ __forceinline__ void st1(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void st1(__nv_bfloat16* p, long long i, float v) { p[i] = __float2bfloat16_rn(v); }

// A unit of 8 elements from an aligned address.
__device__ __forceinline__ void ld8(const float* p, float (&v)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = daz(a.x); v[1] = daz(a.y); v[2] = daz(a.z); v[3] = daz(a.w);
  v[4] = daz(b.x); v[5] = daz(b.y); v[6] = daz(b.z); v[7] = daz(b.w);
}

__device__ __forceinline__ void ld8(const __nv_bfloat16* p, float (&v)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = daz(f.x);
    v[2 * k + 1] = daz(f.y);
  }
}

__device__ __forceinline__ void ld8(const uint8_t* p, float (&v)[kVec]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const uint8_t* b = reinterpret_cast<const uint8_t*>(&u);
#pragma unroll
  for (int k = 0; k < kVec; ++k) v[k] = __uint2float_rn(b[k]);
}

__device__ __forceinline__ void ld8(const int8_t* p, float (&v)[kVec]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int k = 0; k < kVec; ++k) v[k] = __int2float_rn(b[k]);
}

__device__ __forceinline__ void st8(float* p, const float (&v)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void st8(__nv_bfloat16* p, const float (&v)[kVec]) {
  uint4 u;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
  for (int k = 0; k < kVec; ++k) h[k] = __float2bfloat16_rn(v[k]);
  *reinterpret_cast<uint4*>(p) = u;
}

// ---------------------------------------------------------------- the chain

// One element of the chain, scalar: the head, the tail and the kernel for
// operands whose alignments disagree.
template <typename T, typename O>
__device__ __forceinline__ void chain_one(const ChainArgs& a, long long i) {
  float t;
  int k0;
  if (a.acc != nullptr) {
    t = ld1(a.acc, i);
    k0 = 0;
  } else if (a.nops == 1) {
    t = ftz_mul(a.w[0], ld1(static_cast<const T*>(a.x[0]), i));
    k0 = 1;
  } else {
    t = ftz_fma(a.w[0], ld1(static_cast<const T*>(a.x[0]), i),
                ftz_mul(a.w[1], ld1(static_cast<const T*>(a.x[1]), i)));
    k0 = 2;
  }
#pragma unroll
  for (int k = 0; k < kMaxOps; ++k) {
    if (k >= k0 && k < a.nops) t = ftz_fma(a.w[k], ld1(static_cast<const T*>(a.x[k]), i), t);
  }
  st1(static_cast<O*>(a.out), i, a.divide ? ftz_div(t, a.total) : t);
}

template <typename T, typename O>
__global__ void __launch_bounds__(kThreads) fold_chain(const ChainArgs a) {
  float t[kUnroll][kVec], v[kUnroll][kVec];
  long long at[kUnroll];
  bool live[kUnroll];
  const long long first = static_cast<long long>(blockIdx.x) * kThreads * kUnroll + threadIdx.x;
#pragma unroll
  for (int r = 0; r < kUnroll; ++r) {
    const long long u = first + r * kThreads;
    live[r] = u < a.units;
    at[r] = a.head + u * kVec;
  }
  int k0;
  if (a.acc != nullptr) {
#pragma unroll
    for (int r = 0; r < kUnroll; ++r)
      if (live[r]) ld8(a.acc + at[r], t[r]);
    k0 = 0;
  } else if (a.nops == 1) {
#pragma unroll
    for (int r = 0; r < kUnroll; ++r)
      if (live[r]) ld8(static_cast<const T*>(a.x[0]) + at[r], v[r]);
#pragma unroll
    for (int r = 0; r < kUnroll; ++r)
#pragma unroll
      for (int e = 0; e < kVec; ++e) t[r][e] = ftz_mul(a.w[0], v[r][e]);
    k0 = 1;
  } else {
#pragma unroll
    for (int r = 0; r < kUnroll; ++r) {
      if (live[r]) {
        ld8(static_cast<const T*>(a.x[1]) + at[r], t[r]);
        ld8(static_cast<const T*>(a.x[0]) + at[r], v[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kUnroll; ++r)
#pragma unroll
      for (int e = 0; e < kVec; ++e) t[r][e] = ftz_fma(a.w[0], v[r][e], ftz_mul(a.w[1], t[r][e]));
    k0 = 2;
  }
#pragma unroll
  for (int k = 0; k < kMaxOps; ++k) {
    if (k >= k0 && k < a.nops) {
#pragma unroll
      for (int r = 0; r < kUnroll; ++r)
        if (live[r]) ld8(static_cast<const T*>(a.x[k]) + at[r], v[r]);
#pragma unroll
      for (int r = 0; r < kUnroll; ++r)
#pragma unroll
        for (int e = 0; e < kVec; ++e) t[r][e] = ftz_fma(a.w[k], v[r][e], t[r][e]);
    }
  }
#pragma unroll
  for (int r = 0; r < kUnroll; ++r) {
    if (!live[r]) continue;
    if (a.divide) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) t[r][e] = ftz_div(t[r][e], a.total);
    }
    st8(static_cast<O*>(a.out) + at[r], t[r]);
  }
  // The head and the tail, under kVec elements each, by block 0.
  if (blockIdx.x == 0 && threadIdx.x < 2 * kVec) {
    const long long i = threadIdx.x < kVec ? threadIdx.x : a.head + a.units * kVec + (threadIdx.x - kVec);
    if (threadIdx.x < kVec ? i < a.head : i < a.n) chain_one<T, O>(a, i);
  }
}

template <typename T, typename O>
__global__ void __launch_bounds__(kThreads) fold_chain_scalar(const ChainArgs a) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < a.n) chain_one<T, O>(a, i);
}

// ---------------------------------------------------------------- the rows

template <typename B>
__device__ __forceinline__ void rows_one(const RowsArgs& a, long long i) {
  const long long r = i / a.width;
  const float s = daz(a.negate ? -a.s[r] : a.s[r]);
  float b = ld1(static_cast<const B*>(a.b), i);
  if (a.z != nullptr) b = ftz_sub(b, daz(a.z[r]));
  a.out[i] = ftz_fma(s, b, ld1(a.c, i));
}

template <typename B>
__global__ void __launch_bounds__(kThreads) fold_rows(const RowsArgs a) {
  float b[kUnroll][kVec], c[kUnroll][kVec];
  long long at[kUnroll];
  bool live[kUnroll];
  const long long first = static_cast<long long>(blockIdx.x) * kThreads * kUnroll + threadIdx.x;
#pragma unroll
  for (int r = 0; r < kUnroll; ++r) {
    const long long u = first + r * kThreads;
    live[r] = u < a.units;
    at[r] = a.head + u * kVec;
    if (live[r]) {
      ld8(static_cast<const B*>(a.b) + at[r], b[r]);
      ld8(a.c + at[r], c[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kUnroll; ++r) {
    if (!live[r]) continue;
    // The row of each element: one division a unit, then a step at each
    // row boundary (a unit may cross several rows when they are short).
    long long row = at[r] / a.width;
    long long rem = at[r] - row * a.width;
    float s = daz(a.negate ? -a.s[row] : a.s[row]);
    float z = a.z != nullptr ? daz(a.z[row]) : 0.0f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      if (rem == a.width) {
        ++row;
        rem = 0;
        s = daz(a.negate ? -a.s[row] : a.s[row]);
        z = a.z != nullptr ? daz(a.z[row]) : 0.0f;
      }
      const float d = a.z != nullptr ? ftz_sub(b[r][e], z) : b[r][e];
      c[r][e] = ftz_fma(s, d, c[r][e]);
      ++rem;
    }
    st8(a.out + at[r], c[r]);
  }
  if (blockIdx.x == 0 && threadIdx.x < 2 * kVec) {
    const long long i = threadIdx.x < kVec ? threadIdx.x : a.head + a.units * kVec + (threadIdx.x - kVec);
    if (threadIdx.x < kVec ? i < a.head : i < a.n) rows_one<B>(a, i);
  }
}

template <typename B>
__global__ void __launch_bounds__(kThreads) fold_rows_scalar(const RowsArgs a) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < a.n) rows_one<B>(a, i);
}

// ---------------------------------------------------------------- binary ops

__device__ __forceinline__ float operand(const float* p, int mode, long long row, long long i) {
  return daz(mode == kWhole ? p[i] : mode == kPerRow ? p[row] : p[0]);
}

__global__ void __launch_bounds__(kThreads) ftz_binary(const BinaryArgs p) {
  const long long row = blockIdx.y;
  const long long col = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= p.width) return;
  const long long i = row * p.width + col;
  const float a = operand(p.a, p.a_mode, row, i);
  const float b = operand(p.b, p.b_mode, row, i);
  float r;
  switch (p.op) {
    case kAdd: r = ftz_add(a, b); break;
    case kSub: r = ftz_sub(a, b); break;
    case kMul: r = ftz_mul(a, b); break;
    default: r = ftz_div(a, b); break;
  }
  p.out[i] = r;
}

// ---------------------------------------------------------------- host side

// The first element at which every operand sits on the boundary its unit
// loads need (16 bytes, 8 for a unit of 1-byte codes), or -1 when no
// element below kVec puts them all there.
long long common_head(const void* const* ptrs, const int* sizes, int count) {
  for (int h = 0; h < kVec; ++h) {
    bool ok = true;
    for (int k = 0; k < count && ok; ++k) {
      const uintptr_t align = sizes[k] == 1 ? 8 : 16;
      ok = (reinterpret_cast<uintptr_t>(ptrs[k]) + static_cast<uintptr_t>(h) * sizes[k]) % align == 0;
    }
    if (ok) return h;
  }
  return -1;
}

// Head, units and grid of a launch over n elements; false: the scalar kernel.
bool plan(const void* const* ptrs, const int* sizes, int count, long long n, long long* head,
          long long* units, unsigned* blocks) {
  long long h = common_head(ptrs, sizes, count);
  if (h < 0) {
    *head = n;
    *units = 0;
    *blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    return false;
  }
  if (h > n) h = n;
  *head = h;
  *units = (n - h) / kVec;
  const long long per_block = static_cast<long long>(kThreads) * kUnroll;
  const long long b = (*units + per_block - 1) / per_block;
  *blocks = static_cast<unsigned>(b > 0 ? b : 1);
  return true;
}

// A weight or divisor as the kernel reads it: a subnormal is a zero of its
// sign.
float host_daz(float x) { return std::fabs(x) < kFltMin ? std::copysign(0.0f, x) : x; }

cudaError_t use_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return err;
  return cur == device ? cudaSuccess : cudaSetDevice(device);
}

template <typename T, typename O>
cudaError_t launch_chain(ChainArgs a, cudaStream_t s) {
  const void* ptrs[kMaxOps + 2];
  int sizes[kMaxOps + 2];
  int count = 0;
  for (int k = 0; k < a.nops; ++k) {
    ptrs[count] = a.x[k];
    sizes[count++] = sizeof(T);
  }
  ptrs[count] = a.out;
  sizes[count++] = sizeof(O);
  if (a.acc != nullptr) {
    ptrs[count] = a.acc;
    sizes[count++] = 4;
  }
  unsigned blocks;
  if (plan(ptrs, sizes, count, a.n, &a.head, &a.units, &blocks)) {
    fold_chain<T, O><<<blocks, kThreads, 0, s>>>(a);
  } else {
    fold_chain_scalar<T, O><<<blocks, kThreads, 0, s>>>(a);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t chain_out(const ChainArgs& a, int out_dtype, cudaStream_t s) {
  switch (out_dtype) {
    case kF32: return launch_chain<T, float>(a, s);
    case kBF16: return launch_chain<T, __nv_bfloat16>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t chain(const ChainArgs& a, int wire, int out_dtype, cudaStream_t s) {
  if (a.n <= 0) return cudaSuccess;
  const bool finalize = a.nops == 0 && a.acc != nullptr && a.divide;  // cast(acc / total)
  if ((a.nops < 1 && !finalize) || a.nops > kMaxOps || (a.divide == 0 && out_dtype != kF32))
    return cudaErrorInvalidValue;
  switch (wire) {
    case kF32: return chain_out<float>(a, out_dtype, s);
    case kBF16: return chain_out<__nv_bfloat16>(a, out_dtype, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename B>
cudaError_t launch_rows(RowsArgs a, cudaStream_t s) {
  const void* ptrs[3] = {a.b, a.c, a.out};
  const int sizes[3] = {static_cast<int>(sizeof(B)), 4, 4};
  unsigned blocks;
  if (plan(ptrs, sizes, 3, a.n, &a.head, &a.units, &blocks)) {
    fold_rows<B><<<blocks, kThreads, 0, s>>>(a);
  } else {
    fold_rows_scalar<B><<<blocks, kThreads, 0, s>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// The streamed step: acc = fma(w, x, acc), in place.  acc: [n] f32; x: [n]
// of `wire` (0 f32, 1 bf16).  Returns a cudaError_t.
extern "C" int rf_fold_step(void* acc, const void* x, float w, long long n, int wire, int device,
                            void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  ChainArgs a = {};
  a.x[0] = x;
  a.w[0] = host_daz(w);
  a.acc = static_cast<const float*>(acc);
  a.out = acc;
  a.nops = 1;
  a.n = n;
  return chain(a, wire, kF32, static_cast<cudaStream_t>(stream));
}

// The pair: out = fma(w, x, v·y), v·y rounded first.  out: [n] f32; x, y:
// [n] of `wire`.
extern "C" int rf_fold_pair(void* out, const void* x, float w, const void* y, float v, long long n,
                            int wire, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  ChainArgs a = {};
  a.x[0] = x;
  a.w[0] = host_daz(w);
  a.x[1] = y;
  a.w[1] = host_daz(v);
  a.out = out;
  a.nops = 2;
  a.n = n;
  return chain(a, wire, kF32, static_cast<cudaStream_t>(stream));
}

// One launch of the chain over nops (1..8) operands xs of `wire` with
// weights ws: from acc when it is given (an f32 value carried from an
// earlier launch), else from the chain's first terms; out = t as f32, or,
// with divide, t / total cast to out_dtype (0 f32, 1 bf16).  nops 0 with acc
// and divide is the finalize of a streamed or striped fold: cast(acc / total).
extern "C" int rf_fold_chain(void* out, const void* acc, const void* const* xs, const float* ws,
                             int nops, long long n, int wire, int out_dtype, float total, int divide,
                             int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (nops < 0 || nops > kMaxOps) return cudaErrorInvalidValue;
  ChainArgs a = {};
  for (int k = 0; k < nops; ++k) {
    a.x[k] = xs[k];
    a.w[k] = host_daz(ws[k]);
  }
  a.acc = static_cast<const float*>(acc);
  a.out = out;
  a.total = host_daz(total);
  a.nops = nops;
  a.divide = divide;
  a.n = n;
  return chain(a, wire, out_dtype, static_cast<cudaStream_t>(stream));
}

// The rows form: out[i] = fma(±s[i / width], b[i] − z[i / width], c[i])
// (no subtraction when z is null).  b: [n] of `dtype` (0 f32, 3 uint8,
// 4 int8); c, out: [n] f32; s, z: one f32 a row.
extern "C" int rf_fold_rows(void* out, const void* b, const void* c, const void* s, const void* z,
                            int negate, long long n, long long width, int dtype, int device,
                            void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (n <= 0) return cudaSuccess;
  if (width <= 0) return cudaErrorInvalidValue;
  RowsArgs a = {};
  a.b = b;
  a.c = static_cast<const float*>(c);
  a.out = static_cast<float*>(out);
  a.s = static_cast<const float*>(s);
  a.z = static_cast<const float*>(z);
  a.negate = negate;
  a.n = n;
  a.width = width;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_rows<float>(a, st);
    case kU8: return launch_rows<uint8_t>(a, st);
    case kI8: return launch_rows<int8_t>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

// The binary form: out[r, c] = op(a, b) over rows x width f32 (op 0 add,
// 1 sub, 2 mul, 3 div), each operand read whole (mode 0), one value a row
// (1) or one value (2), operands and result flushed.  rows: 1 to 65535.
extern "C" int rf_ftz_binary(void* out, const void* a, int a_mode, const void* b, int b_mode, int op,
                             long long rows, long long width, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (rows <= 0 || width <= 0) return cudaSuccess;
  if (rows > 65535 || op < kAdd || op > kDiv || a_mode < kWhole || a_mode > kOne || b_mode < kWhole ||
      b_mode > kOne)
    return cudaErrorInvalidValue;
  BinaryArgs p = {};
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.out = static_cast<float*>(out);
  p.a_mode = a_mode;
  p.b_mode = b_mode;
  p.op = op;
  p.width = width;
  const dim3 grid(static_cast<unsigned>((width + kThreads - 1) / kThreads), static_cast<unsigned>(rows));
  ftz_binary<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

// The head a launch over these operands plans (common_head): elements
// folded one by one before every operand sits on its vector boundary, or -1
// for the scalar kernel.  ptrs: count operand addresses; sizes: their
// element sizes in bytes.
extern "C" long long rf_fold_head(const void* const* ptrs, const int* sizes, int count) {
  return common_head(ptrs, sizes, count);
}

extern "C" const char* rf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
