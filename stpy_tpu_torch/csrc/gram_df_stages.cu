// Elementwise stage probe of the double-float Matérn entry: from a squared
// scaled distance given as an f32 (hi, lo) pair, one stage of the entry as an
// f32 (hi, lo) pair -- sqrt(sq), t, e^{-t} or P(t)·e^{-t}.
//
// Replaces benchmarks/exp_r3_batch_p.py:_stage_kernel (its pallas_call in
// run_stage), which feeds exact df squared distances into a copy of the TPU
// kernel's Matérn entry and dumps its stages. Here the stages are the
// production kernel's own device code (csrc/gram_df_entry.cuh, which
// csrc/gram_df.cu composes), evaluated in FP64 on sq = hi + lo, which is
// exact in double. The TPU probe's stage "t2" (Mosaic constant-folding the
// in-kernel f32 split of sqrt(2 nu)) has no counterpart: the card holds
// sqrt(2 nu) as one FP64 value.
//
// What bounds it on an H100: reading two and writing two f32 per entry, and
// the FP64 sqrt and exp (tens of FP64 instructions an entry). Design: one
// thread per entry, grid-stride, coalesced; nothing is shared between
// threads.
#include <cuda_runtime.h>

#include "gram_df_entry.cuh"

namespace {

constexpr int TPB = 256;
constexpr int MAX_BLOCKS = 132 * 16;

template <int SHAPE, int STAGE>
__global__ void __launch_bounds__(TPB)
gram_df_stages_kernel(const float* __restrict__ sqh,
                      const float* __restrict__ sql, float* __restrict__ hi,
                      float* __restrict__ lo, int n) {
  for (int i = blockIdx.x * TPB + threadIdx.x; i < n; i += gridDim.x * TPB) {
    const double sq = static_cast<double>(sqh[i]) + static_cast<double>(sql[i]);
    store_pair(df_stage<SHAPE, STAGE>(sq), hi, lo, i);
  }
}

template <int SHAPE>
int launch(const float* sqh, const float* sql, float* hi, float* lo, int n,
           int stage, cudaStream_t s) {
  const int want = (n + TPB - 1) / TPB;
  const int blocks = want < MAX_BLOCKS ? want : MAX_BLOCKS;
  switch (stage) {
    case STAGE_SL: gram_df_stages_kernel<SHAPE, STAGE_SL><<<blocks, TPB, 0, s>>>(sqh, sql, hi, lo, n); break;
    case STAGE_T: gram_df_stages_kernel<SHAPE, STAGE_T><<<blocks, TPB, 0, s>>>(sqh, sql, hi, lo, n); break;
    case STAGE_EXP: gram_df_stages_kernel<SHAPE, STAGE_EXP><<<blocks, TPB, 0, s>>>(sqh, sql, hi, lo, n); break;
    case STAGE_ENTRY: gram_df_stages_kernel<SHAPE, STAGE_ENTRY><<<blocks, TPB, 0, s>>>(sqh, sql, hi, lo, n); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// shape: a Matérn shape code (1, 2, 3); stage: STAGE_SL, _T, _EXP or _ENTRY.
extern "C" int stpy_gram_df_stages(const float* sqh, const float* sql,
                                   float* hi, float* lo, int n, int shape,
                                   int stage, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (shape) {
    case 1: return launch<1>(sqh, sql, hi, lo, n, stage, s);
    case 2: return launch<2>(sqh, sql, hi, lo, n, stage, s);
    case 3: return launch<3>(sqh, sql, hi, lo, n, stage, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
