// The double-float Gram's entry as a function of the squared scaled distance
// sq, in FP64 and in stages: t, then e^{-t}, then P(t)·e^{-t}.
//
// Shared by csrc/gram_df.cu (the production Gram, which composes the stages
// as df_entry) and csrc/gram_df_stages.cu (the elementwise stage probe), so
// both run the same device code. The formulas are those of the CPU-x64
// reference stpy_tpu/ops/pallas_gram_df.py:_f64_reference; the TPU kernel
// builds the same stages from f32 error-free transforms (`_df_entry`).
//
// Shape codes shared with stpy_tpu_torch/ops/gram.py:SHAPE_CODES: 0 SE,
// 1/2/3 Matérn ν = 1/2, 3/2, 5/2; and 4, the L1 (Laplace) family of
// csrc/gram_df.cu (stpy_tpu_torch/ops/gram_df.py:L1_CODE), whose argument is
// the L1 distance d1 = Σ|x_c − y_c| of coordinates scaled by 1/γ², its entry
// e^{-d1}. Stage codes shared with stpy_tpu_torch/ops/gram_df_stages.py:
// STAGE_CODES.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int STAGE_ENTRY = 0;   // P(t)·e^{-t} (times kappa in gram_df.cu)
constexpr int STAGE_SQ = 1;      // the squared scaled distance itself
constexpr int STAGE_T = 2;       // t
constexpr int STAGE_EXP = 3;     // e^{-t}
constexpr int STAGE_SL = 4;      // sqrt(sq), the distance (stage probe only)

constexpr int SHAPE_L1 = 4;      // Laplace: the argument is the L1 distance

// The exponent: t = sqrt(2 nu sq) for Matérn (the 1e-300 as _f64_reference),
// t = sq / 2 for SE, whose entry is then e^{-t} as for Matérn-1/2.
template <int SHAPE>
__device__ __forceinline__ double df_t(double sq) {
  if (SHAPE == SHAPE_L1) return sq;
  if (SHAPE == 0) return 0.5 * sq;
  const double nu2 = SHAPE == 1 ? 1.0 : (SHAPE == 2 ? 3.0 : 5.0);   // 2 nu
  return sqrt(nu2 * sq + 1e-300);
}

__device__ __forceinline__ double df_exp(double t) { return exp(-t); }

template <int SHAPE>
__device__ __forceinline__ double df_entry(double sq) {
  const double t = df_t<SHAPE>(sq);
  if (SHAPE <= 1 || SHAPE == SHAPE_L1) return df_exp(t);
  if (SHAPE == 2) return (1.0 + t) * df_exp(t);
  return (1.0 + t + t * t / 3.0) * df_exp(t);
}

// One stage's value at sq (STAGE_ENTRY without kappa).
template <int SHAPE, int STAGE>
__device__ __forceinline__ double df_stage(double sq) {
  if (STAGE == STAGE_SQ) return sq;
  if (STAGE == STAGE_SL) return sqrt(sq);
  if (STAGE == STAGE_T) return df_t<SHAPE>(sq);
  if (STAGE == STAGE_EXP) return df_exp(df_t<SHAPE>(sq));
  return df_entry<SHAPE>(sq);
}

// hi = f32(v), lo = f32(v - hi): the (hi, lo) pair of v.
__device__ __forceinline__ void split_pair(double v, float& h, float& l) {
  h = static_cast<float>(v);
  l = static_cast<float>(v - static_cast<double>(h));
}

__device__ __forceinline__ void store_pair(double v, float* __restrict__ hi,
                                           float* __restrict__ lo, size_t o) {
  float h, l;
  split_pair(v, h, l);
  hi[o] = h;
  lo[o] = l;
}

}  // namespace
