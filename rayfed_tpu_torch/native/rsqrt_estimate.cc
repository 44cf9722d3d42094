// The x86 reciprocal square root estimate, as XLA's CPU backend takes it.
//
// XLA compiles jax.lax.rsqrt on the CPU into the hardware estimate
// (rsqrtss, or vrsqrtps when the loop is vectorised) followed by two
// Newton steps.  The estimate's bits are the instruction's own table, so
// the port reads them from the same instruction; the Newton steps are
// computed in PyTorch (rayfed_tpu_torch/models/llama.py).
#include <immintrin.h>
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
