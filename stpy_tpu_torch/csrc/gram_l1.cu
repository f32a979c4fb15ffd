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
// Design: the tiling of gram.cu.  One 64x64 output tile per 256-thread block;
// each thread owns a 4x4 register sub-tile strided by 16 rows and 16 columns,
// so a half-warp stores 16 consecutive floats.  The x and y tiles are staged
// in shared memory 32 features at a time, any d; ragged n, m and d are masked
// (a masked feature adds |0 - 0| = 0).  The TPU kernel's static unroll over
// d <= 128 and its pre-transposed y are VMEM layout details with no
// counterpart here.
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;   // output rows and columns per block
constexpr int KC = 32;     // features staged per pass
constexpr int TPB = 16;    // threads per block along each axis
constexpr int PER = TILE / TPB;

__global__ void __launch_bounds__(TPB * TPB)
gram_l1_kernel(const float* __restrict__ x, const float* __restrict__ y,
               float* __restrict__ out, int n, int m, int d, float kappa,
               float inv_g2) {
  __shared__ float xs[TILE][KC + 1];
  __shared__ float ys[TILE][KC + 1];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TPB + tx;
  const int row0 = blockIdx.y * TILE, col0 = blockIdx.x * TILE;

  float acc[PER][PER] = {};
  for (int k0 = 0; k0 < d; k0 += KC) {
    for (int idx = tid; idx < TILE * KC; idx += TPB * TPB) {
      const int r = idx / KC, k = idx % KC, kk = k0 + k;
      xs[r][k] = (row0 + r < n && kk < d) ? x[(size_t)(row0 + r) * d + kk] : 0.0f;
      ys[r][k] = (col0 + r < m && kk < d) ? y[(size_t)(col0 + r) * d + kk] : 0.0f;
    }
    __syncthreads();
    const int kend = min(KC, d - k0);
    for (int k = 0; k < kend; ++k) {
      float a[PER], b[PER];
#pragma unroll
      for (int i = 0; i < PER; ++i) a[i] = xs[ty + TPB * i][k];
#pragma unroll
      for (int j = 0; j < PER; ++j) b[j] = ys[tx + TPB * j][k];
#pragma unroll
      for (int i = 0; i < PER; ++i) {
#pragma unroll
        for (int j = 0; j < PER; ++j) acc[i][j] += fabsf(a[i] - b[j]);
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
      out[(size_t)r * m + c] = kappa * expf(-acc[i][j] * inv_g2);
    }
  }
}

}  // namespace

extern "C" int stpy_gram_l1(const float* x, const float* y, float* out, int n,
                            int m, int d, float kappa, float inv_g2,
                            void* stream) {
  const dim3 grid((m + TILE - 1) / TILE, (n + TILE - 1) / TILE);
  const dim3 block(TPB, TPB);
  gram_l1_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, out, n, m, d, kappa, inv_g2);
  return static_cast<int>(cudaGetLastError());
}
