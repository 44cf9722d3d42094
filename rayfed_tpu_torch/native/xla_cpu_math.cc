// Elementwise math whose bits XLA's CPU backend takes from the host, not
// from a program of its own (rayfed_tpu_torch/ops/xla_cpu.py).
//
// - rsqrt: XLA compiles jax.lax.rsqrt into the hardware estimate (rsqrtss,
//   or vrsqrtps when the loop is vectorised) followed by two Newton steps.
//   The estimate's bits are the instruction's own table, so the port reads
//   them from the same instruction; the Newton steps are computed in
//   PyTorch.
// - cos, sin: XLA lowers llvm.cos/llvm.sin to one call of the C library's
//   cosf/sinf per element, whatever the loop's vector width.
// - pow: XLA's compiled pow and its constant folder both take the C
//   library's powf.
// Built without -ffast-math, so the compiler keeps one scalar libm call
// per element (no vector variant).
#include <immintrin.h>
#include <cmath>
#include <cstdint>

extern "C" void rf_rsqrt_estimate(const float* x, float* y, int64_t n) {
  int64_t i = 0;
  for (; i + 8 <= n; i += 8) {
    _mm256_storeu_ps(y + i, _mm256_rsqrt_ps(_mm256_loadu_ps(x + i)));
  }
  for (; i < n; ++i) {
    _mm_store_ss(y + i, _mm_rsqrt_ss(_mm_load_ss(x + i)));
  }
}

extern "C" void rf_libm_cosf(const float* x, float* y, int64_t n) {
  for (int64_t i = 0; i < n; ++i) y[i] = ::cosf(x[i]);
}

extern "C" void rf_libm_sinf(const float* x, float* y, int64_t n) {
  for (int64_t i = 0; i < n; ++i) y[i] = ::sinf(x[i]);
}

extern "C" void rf_libm_powf_base(float base, const float* x, float* y, int64_t n) {
  for (int64_t i = 0; i < n; ++i) y[i] = ::powf(base, x[i]);
}
