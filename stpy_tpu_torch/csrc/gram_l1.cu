// Laplace Gram K(x, y)[i, j] = kappa * exp(-inv_g2 * sum_c |x_ic - y_jc|), f32.
//
// Replaces stpy_tpu/ops/pallas_gram.py:_gram_l1_kernel (the pallas_call in
// _gram_l1_pallas), reached through gram_laplace.  inv_g2 = 1 / gamma^2 is
// applied to the summed distance, as there.
//
// What bounds it on an H100: an entry costs 2d adds, d absolute values and
// one exp; at the serving shape (d = 8) that is far below the card's f32
// rate, so the kernel is bound by writing the (n, m) f32 output -- 1 GiB at
// n = m = 16384.
//
// Design: the tiling and store path of gram.cu, shared through
// gram_tile.cuh (whole 512-byte rows of float4 streaming stores, y staged
// once for 8 row tiles where d <= 32).  An entry's sum runs over the
// features in ascending order from 0, and its value is
// kappa * expf(-acc * inv_g2), so its bits do not depend on the tiling.  The
// TPU kernel's static unroll over d <= 128 and its pre-transposed y are VMEM
// layout details with no counterpart here.
#include <cuda_runtime.h>

#include "gram_tile.cuh"

namespace {

// a warp's 4 rows against a lane's 8 columns: sum_c |x_ic - y_jc|
struct L1Entry {
  float kappa, inv_g2;
  struct Acc {
    float sum[4][8];
  };
  __device__ __forceinline__ void step(Acc& s, const float (&a)[4],
                                       const float (&b)[8]) const {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s.sum[i][j] += fabsf(a[i] - b[j]);
  }
  __device__ __forceinline__ float value(const Acc& s, int i, int j) const {
    return kappa * expf(-s.sum[i][j] * inv_g2);
  }
};

__global__ void __launch_bounds__(TILE_NT)
gram_l1_kernel(const float* __restrict__ x, const float* __restrict__ y,
               float* __restrict__ out, int n, int m, int d, float kappa,
               float inv_g2) {
  gram_tiles(x, y, out, n, m, d, L1Entry{kappa, inv_g2});
}

}  // namespace

extern "C" int stpy_gram_l1(const float* x, const float* y, float* out, int n,
                            int m, int d, float kappa, float inv_g2,
                            void* stream) {
  gram_l1_kernel<<<gram_tile_grid(n, m), TILE_NT, 0,
                   static_cast<cudaStream_t>(stream)>>>(x, y, out, n, m, d,
                                                        kappa, inv_g2);
  return static_cast<int>(cudaGetLastError());
}
