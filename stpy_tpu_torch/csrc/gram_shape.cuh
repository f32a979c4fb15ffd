// Kernel shapes of the f32 Gram kernels (gram.cu, gram_matvec.cu,
// gram_matmat.cu): the correlation of a squared scaled distance sq, its
// derivatives, and the squared distance itself from one FMA chain.
// shape_fn (expf, sqrtf) is gram.cu's and gram_matmat.cu's; shape_exp2 is
// the same function with the constant folded into a base-2 exponent, on the
// special-function unit's approximations, for gram_matvec.cu.
//
// Shape codes shared with stpy_tpu_torch/ops/gram.py (SHAPE_CODES, SHAPES,
// shape_code): code = family + 4 * kind.  family 0 SE, 1-3 Matern nu = 1/2,
// 3/2, 5/2; kind 0 the kernel k(sq) (codes 0-3, every Gram kernel), kind 1
// k'(sq) sq ("dk_sq", codes 4-7) and kind 2 k'(sq) ("dk", codes 8-11), the
// last two in gram_matvec.cu and gram_matmat.cu only.  The formulas are
// those of stpy_tpu/ops/pallas_gram.py:_shape_fn and
// stpy_tpu/ops/pallas_gram_matvec.py:_dshape_fn, _pshape_fn.  Where sq is
// exactly 0 (a point against itself, see sq_from_chain), "dk_sq" is exactly
// 0 and "dk" is exactly k'(0): -1/2 (SE), -3/2 (nu = 3/2), -5/6 (5/2), and
// for nu = 1/2 -1/2 / 1e-6 through the clamp max(r, 1e-6) of _pshape_fn.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int SHAPE_KINDS = 3;   // k, dk_sq, dk
constexpr int SHAPE_COUNT = 4 * SHAPE_KINDS;

// f(std::integral_constant<int, code>{}) for a shape code known only at run
// time, so that each .cu instantiates its launch for every code in one
// place; false, and f not called, for a code outside 0 .. SHAPE_COUNT - 1
template <int SHAPE = 0, class F>
bool dispatch_shape(int code, F&& f) {
  if constexpr (SHAPE < SHAPE_COUNT) {
    if (code == SHAPE) {
      f(std::integral_constant<int, SHAPE>{});
      return true;
    }
    return dispatch_shape<SHAPE + 1>(code, f);
  } else {
    return false;
  }
}

// the derivative shapes from a Matern family's r, e = exp(-c r), sq:
// dk_sq = k'(sq) sq and dk = k'(sq) (k'(sq) = -c^2/2 e (nu = 3/2),
// -c^2/6 (1 + c r) e (5/2), -e / (2 r) (1/2), with r clamped at 1e-6 there)
template <int FAMILY, int KIND>
__device__ __forceinline__ float matern_deriv(float r, float e, float sq) {
  if (FAMILY == 1) return KIND == 1 ? -0.5f * r * e : (-0.5f * e) / fmaxf(r, 1e-6f);
  if (FAMILY == 2) return KIND == 1 ? (-1.5f * sq) * e : -1.5f * e;
  const float p = (-5.0f / 6.0f) * fmaf(2.23606797749979f, r, 1.0f) * e;
  return KIND == 1 ? p * sq : p;
}

template <int SHAPE>
__device__ __forceinline__ float shape_fn(float sq) {
  constexpr int FAMILY = SHAPE % 4, KIND = SHAPE / 4;
  if (FAMILY == 0) {                                        // squared exponential
    const float e = expf(-0.5f * sq);
    return KIND == 0 ? e : KIND == 1 ? (-0.5f * sq) * e : -0.5f * e;
  }
  const float r = sqrtf(sq + 1e-30f);                       // Matern, eps as the TPU kernel
  if (KIND != 0) {
    // r without the eps for dk_sq's own factor r (nu = 1/2), so that sq = 0
    // gives exactly 0; the eps moves r by at most 1e-15
    constexpr float C = FAMILY == 1 ? 1.0f : FAMILY == 2 ? 1.7320508075688772f
                                                          : 2.23606797749979f;
    const float e = expf(-C * r);
    return matern_deriv<FAMILY, KIND>(KIND == 1 && FAMILY == 1 ? sqrtf(sq) : r, e, sq);
  }
  if (FAMILY == 1) return expf(-r);                         // nu = 1/2
  if (FAMILY == 2) {                                        // nu = 3/2
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

// shape_fn's function, exp(-u) taken as ex2(-u log2(e)) with the constant
// folded in: SE one FMUL and one MUFU.EX2; Matern r = sqrt(sq) (without the
// TPU kernel's 1e-30, whose effect on r is below 1e-15), then k = c r and
// its polynomial times ex2(-c log2(e) r).  sq = 0 gives exactly 1 for k,
// exactly 0 for dk_sq and exactly k'(0) for dk (r = 0 reaches the clamp of
// nu = 1/2 and its IEEE division, not 1/0).
template <int SHAPE>
__device__ __forceinline__ float shape_exp2(float sq) {
  constexpr int FAMILY = SHAPE % 4, KIND = SHAPE / 4;
  constexpr float LOG2E = 1.4426950408889634f;
  if (FAMILY == 0) {                                        // squared exponential
    const float e = ex2_approx((-0.5f * LOG2E) * sq);
    return KIND == 0 ? e : KIND == 1 ? (-0.5f * sq) * e : -0.5f * e;
  }
  const float r = sqrt_approx(sq);
  constexpr float C = FAMILY == 1 ? 1.0f : FAMILY == 2 ? 1.7320508075688772f
                                                        : 2.23606797749979f;
  const float e = ex2_approx((-C * LOG2E) * r);
  if (KIND != 0) return matern_deriv<FAMILY, KIND>(r, e, sq);
  if (FAMILY == 1) return e;                                // nu = 1/2
  if (FAMILY == 2) return fmaf(C * r, e, e);                // nu = 3/2: (1 + k) e
  const float k = C * r;                                    // nu = 5/2
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
