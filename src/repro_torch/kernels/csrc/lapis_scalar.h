// Scalar vocabulary of the elementwise dialect, shared by the kernels the
// region code generator (kernels/codegen.py) writes.  Every helper is
// plain C++ on floats, so the same generated functor compiles for the
// card (nvcc, __host__ __device__) and for the host (g++), which is how
// the CPU tests check a generated body against its plain torch version.
#pragma once
#include <math.h>

#ifdef __CUDACC__
#define LAPIS_HD __host__ __device__ __forceinline__
#else
#define LAPIS_HD inline
#endif

// NaN in, NaN out — as torch.relu / torch.maximum and jax.nn.relu do.
LAPIS_HD float lapis_relu(float x) { return (x != x || x > 0.0f) ? x : 0.0f; }
LAPIS_HD float lapis_maximum(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}
LAPIS_HD float lapis_sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }
LAPIS_HD float lapis_silu(float x) { return x / (1.0f + expf(-x)); }
LAPIS_HD float lapis_rsqrt(float x) { return 1.0f / sqrtf(x); }
LAPIS_HD float lapis_gelu(float x) {
  // tanh approximation (jax.nn.gelu approximate=True,
  // F.gelu(approximate="tanh"))
  const float c = 0.7978845608028654f;  // sqrt(2/pi)
  return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
}
