// Kernel shapes of the f32 Gram kernels (gram.cu, gram_matvec.cu,
// gram_matmat.cu): the correlation of a squared scaled distance sq, and the
// squared distance itself from one FMA chain.
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

// sq = max(|x|^2 + |y|^2 - 2 x.y, 0) from norms and dot product that were
// each accumulated by the same fmaf chain over the features in ascending
// order: where x_i == y_j the three sums are bitwise equal and sq is exactly
// 0, so the diagonal of K(x, x) is exactly kappa.
__device__ __forceinline__ float sq_from_chain(float nx, float ny, float dot) {
  return fmaxf(nx + ny - 2.0f * dot, 0.0f);
}

}  // namespace
