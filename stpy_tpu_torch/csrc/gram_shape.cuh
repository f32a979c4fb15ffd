// Kernel shapes of the f32 Gram kernels (gram.cu, gram_matvec.cu,
// gram_matmat.cu): the correlation of a squared scaled distance sq, and the
// squared distance itself from one FMA chain.  shape_fn (expf, sqrtf) is
// gram.cu's and gram_matmat.cu's; shape_exp2 is the same function with the
// constant folded into a base-2 exponent, on the special-function unit's
// approximations, for gram_matvec.cu.
//
// Shape codes shared with stpy_tpu_torch/ops/gram.py:SHAPE_CODES; the
// formulas are those of stpy_tpu/ops/pallas_gram.py:_shape_fn.
#pragma once

#include <cuda_runtime.h>

namespace {

template <int SHAPE>
__device__ __forceinline__ float shape_fn(float sq) {
  if (SHAPE == 0) return expf(-0.5f * sq);                  // squared exponential
  const float r = sqrtf(sq + 1e-30f);                       // Matern, eps as the TPU kernel
  if (SHAPE == 1) return expf(-r);                          // nu = 1/2
  if (SHAPE == 2) {                                         // nu = 3/2
    const float k = 1.7320508075688772f * r;
    return (1.0f + k) * expf(-k);
  }
  const float k = 2.23606797749979f * r;                    // nu = 5/2
  return (1.0f + k + k * k / 3.0f) * expf(-k);
}

// 2^a by one MUFU.EX2 (relative error about 2 ulps; subnormal results flush
// to 0, ex2(0) = 1 exactly)
__device__ __forceinline__ float ex2_approx(float a) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(a));
  return r;
}

// sqrt(a) by one MUFU.SQRT (about 1 ulp; sqrt(0) = 0 exactly)
__device__ __forceinline__ float sqrt_approx(float a) {
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(a));
  return r;
}

// shape_fn's correlation, exp(-u) taken as ex2(-u log2(e)) with the constant
// folded in: SE one FMUL and one MUFU.EX2; Matern r = sqrt(sq) (without the
// TPU kernel's 1e-30, whose effect on r is below 1e-15), then k = c r and
// its polynomial times ex2(-c log2(e) r).  sq = 0 gives exactly 1.
template <int SHAPE>
__device__ __forceinline__ float shape_exp2(float sq) {
  constexpr float LOG2E = 1.4426950408889634f;
  if (SHAPE == 0) return ex2_approx((-0.5f * LOG2E) * sq);  // squared exponential
  const float r = sqrt_approx(sq);
  if (SHAPE == 1) return ex2_approx(-LOG2E * r);            // nu = 1/2
  if (SHAPE == 2) {                                         // nu = 3/2
    constexpr float C = 1.7320508075688772f;
    const float e = ex2_approx((-C * LOG2E) * r);
    return fmaf(C * r, e, e);                               // (1 + k) e
  }
  constexpr float C = 2.23606797749979f;                    // nu = 5/2
  const float k = C * r;
  const float e = ex2_approx((-C * LOG2E) * r);
  return fmaf(fmaf(k, 1.0f / 3.0f, 1.0f), k, 1.0f) * e;     // (1 + k + k^2/3) e
}

// sq = max(|x|^2 + |y|^2 - 2 x.y, 0) from norms and dot product that were
// each accumulated by the same fmaf chain over the features in ascending
// order: where x_i == y_j the three sums are bitwise equal and sq is exactly
// 0, so the diagonal of K(x, x) is exactly kappa.
__device__ __forceinline__ float sq_from_chain(float nx, float ny, float dot) {
  return fmaxf(nx + ny - 2.0f * dot, 0.0f);
}

}  // namespace
