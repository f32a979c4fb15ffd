// Double-float Gram: (hi, lo) f32 pair with hi + lo = k(x, y) to f64 accuracy.
//
// Replaces stpy_tpu/ops/pallas_gram_df.py:_gram_df_kernel (the pallas_call in
// _gram_df_pallas).  The TPU has no f64, so that kernel builds the pair from
// f32 error-free transforms.  The H100 has native FP64, so this kernel takes
// float64 coordinates already scaled by 1/gamma (computed in f64 from the f64
// hyperparameters), computes the squared distance, the shape and kappa in
// FP64, and writes hi = (float)k and lo = (float)(k - hi) -- the contract of
// the CPU-x64 reference stpy_tpu/ops/pallas_gram_df.py:_f64_reference.  No
// f32 error-free transform is used, so FMA contraction cannot harm it.
//
// What bounds it on an H100: writing the two (n, m) f32 outputs (2 GiB at
// n = m = 16384) and the FP64 exp per entry.  The squared distance sums
// (x_k - y_k)^2 directly rather than through the norm expansion: at d = 8 it
// costs the same, and the diagonal of K(x, x) comes out exactly kappa.
//
// The L1 family (SHAPE_L1, shape code 4) is the Laplace kernel
// kappa * exp(-||x - y||_1 / gamma^2) of the single tier: the wrapper scales
// the coordinates by 1/gamma^2 in f64, the kernel accumulates |x_c - y_c| in
// FP64 where the other families accumulate (x_c - y_c)^2, and the entry is
// exp(-d1). The TPU kernel has no such family: the JAX package's double tier
// maps laplace to the L2 Matern-1/2 (stpy_tpu/kernels/df_plan.py:56-57).
//
// Design: the layout of csrc/gram.cu in double -- one 64x64 output tile per
// 256-thread block, 4x4 register sub-tiles strided by 16 for coalesced stores,
// 16 features of x and y staged in shared memory per pass, ragged edges masked.
//
// Stages: the entry is csrc/gram_df_entry.cuh's df_entry, and the STAGE
// template argument picks the value the kernel writes -- kappa times the entry
// (STAGE_ENTRY, what stpy_gram_df launches), or the squared distance, t or
// e^{-t} at the same launch (stpy_gram_df_stage). That second entry point is
// the counterpart of the round-3 probes' kernels, which dump those stages of
// the TPU kernel: benchmarks/exp_r3_batch_t.py (d-loop alone, and d-loop plus
// entry), exp_r3_batch_u.py (d-loop plus entry on the worst pairs) and
// exp_r3_batch_x.py:_staged_kernel (every stage at the production launch).
#include <cuda_runtime.h>

#include "gram_df_entry.cuh"

namespace {

constexpr int TILE = 64;
constexpr int KC = 16;
constexpr int TPB = 16;
constexpr int PER = TILE / TPB;

template <int SHAPE, int STAGE>
__global__ void __launch_bounds__(TPB * TPB)
gram_df_kernel(const double* __restrict__ x, const double* __restrict__ y,
               float* __restrict__ hi, float* __restrict__ lo, int n, int m,
               int d, double kappa) {
  __shared__ double xs[TILE][KC + 1];
  __shared__ double ys[TILE][KC + 1];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TPB + tx;
  const int row0 = blockIdx.y * TILE, col0 = blockIdx.x * TILE;

  double sq[PER][PER] = {};
  for (int k0 = 0; k0 < d; k0 += KC) {
    for (int idx = tid; idx < TILE * KC; idx += TPB * TPB) {
      const int r = idx / KC, k = idx % KC, kk = k0 + k;
      xs[r][k] = (row0 + r < n && kk < d) ? x[(size_t)(row0 + r) * d + kk] : 0.0;
      ys[r][k] = (col0 + r < m && kk < d) ? y[(size_t)(col0 + r) * d + kk] : 0.0;
    }
    __syncthreads();
    const int kend = min(KC, d - k0);
    for (int k = 0; k < kend; ++k) {
      double a[PER], b[PER];
#pragma unroll
      for (int i = 0; i < PER; ++i) a[i] = xs[ty + TPB * i][k];
#pragma unroll
      for (int j = 0; j < PER; ++j) b[j] = ys[tx + TPB * j][k];
#pragma unroll
      for (int i = 0; i < PER; ++i)
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          const double t = a[i] - b[j];
          if (SHAPE == SHAPE_L1)
            sq[i][j] += fabs(t);
          else
            sq[i][j] = fma(t, t, sq[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int r = row0 + ty + TPB * i;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int c = col0 + tx + TPB * j;
      if (c >= m) continue;
      const double v = STAGE == STAGE_ENTRY
                           ? kappa * df_entry<SHAPE>(sq[i][j])
                           : df_stage<SHAPE, STAGE>(sq[i][j]);
      store_pair(v, hi, lo, (size_t)r * m + c);
    }
  }
}

template <int STAGE>
int launch(const double* x, const double* y, float* hi, float* lo, int n,
           int m, int d, double kappa, int shape, cudaStream_t s) {
  const dim3 grid((m + TILE - 1) / TILE, (n + TILE - 1) / TILE);
  const dim3 block(TPB, TPB);
  switch (shape) {
    case 0: gram_df_kernel<0, STAGE><<<grid, block, 0, s>>>(x, y, hi, lo, n, m, d, kappa); break;
    case 1: gram_df_kernel<1, STAGE><<<grid, block, 0, s>>>(x, y, hi, lo, n, m, d, kappa); break;
    case 2: gram_df_kernel<2, STAGE><<<grid, block, 0, s>>>(x, y, hi, lo, n, m, d, kappa); break;
    case 3: gram_df_kernel<3, STAGE><<<grid, block, 0, s>>>(x, y, hi, lo, n, m, d, kappa); break;
    case SHAPE_L1: gram_df_kernel<SHAPE_L1, STAGE><<<grid, block, 0, s>>>(x, y, hi, lo, n, m, d, kappa); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int stpy_gram_df(const double* x, const double* y, float* hi, float* lo,
                            int n, int m, int d, double kappa, int shape,
                            void* stream) {
  return launch<STAGE_ENTRY>(x, y, hi, lo, n, m, d, kappa, shape,
                             static_cast<cudaStream_t>(stream));
}

// The value of one stage at every (x_i, y_j) pair, as a (hi, lo) pair.
extern "C" int stpy_gram_df_stage(const double* x, const double* y, float* hi,
                                  float* lo, int n, int m, int d, double kappa,
                                  int shape, int stage, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case STAGE_ENTRY: return launch<STAGE_ENTRY>(x, y, hi, lo, n, m, d, kappa, shape, s);
    case STAGE_SQ: return launch<STAGE_SQ>(x, y, hi, lo, n, m, d, kappa, shape, s);
    case STAGE_T: return launch<STAGE_T>(x, y, hi, lo, n, m, d, kappa, shape, s);
    case STAGE_EXP: return launch<STAGE_EXP>(x, y, hi, lo, n, m, d, kappa, shape, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
