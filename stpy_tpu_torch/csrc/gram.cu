// Fused f32 Gram K(x, y)[i, j] = kappa * shape(max(|x_i|^2 + |y_j|^2 - 2 x_i.y_j, 0)).
//
// Replaces stpy_tpu/ops/pallas_gram.py:_gram_kernel (the pallas_call in
// _gram_pallas).  The coordinates arrive already scaled by 1/gamma (scalar or
// per-dimension), as in stpy_tpu/ops/pallas_gram.py:_gram.
//
// What bounds it on an H100: at the serving shape (d = 8) an entry costs 3d
// FMAs and one exp, far below the card's f32 rate, so the kernel is bound by
// writing the (n, m) f32 output -- 1 GiB at n = m = 16384.
//
// Design: one 64x64 output tile per 256-thread block.  Each thread owns a 4x4
// register sub-tile strided by 16 rows and 16 columns, so the 16 threads of a
// half-warp store 16 consecutive floats (coalesced).  The x and y tiles are
// staged in shared memory 32 features at a time; the ragged edges of n, m and
// d are masked (the TPU kernel pads instead).  The dot product and both norms
// are the same f32 FMA chain, so sq is exactly 0 where x_i == y_j.  No tensor
// cores and no TF32: the Gram feeds a Cholesky, which is why the TPU kernel
// pins its product to HIGHEST.
#include <cuda_runtime.h>

#include "gram_shape.cuh"

namespace {

constexpr int TILE = 64;   // output rows and columns per block
constexpr int KC = 32;     // features staged per pass
constexpr int TPB = 16;    // threads per block along each axis
constexpr int PER = TILE / TPB;

template <int SHAPE>
__global__ void __launch_bounds__(TPB * TPB)
gram_kernel(const float* __restrict__ x, const float* __restrict__ y,
            float* __restrict__ out, int n, int m, int d, float kappa) {
  __shared__ float xs[TILE][KC + 1];
  __shared__ float ys[TILE][KC + 1];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TPB + tx;
  const int row0 = blockIdx.y * TILE, col0 = blockIdx.x * TILE;

  float acc[PER][PER] = {};
  float nx[PER] = {}, ny[PER] = {};
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
        nx[i] = fmaf(a[i], a[i], nx[i]);
        ny[i] = fmaf(b[i], b[i], ny[i]);
#pragma unroll
        for (int j = 0; j < PER; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
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
      const float sq = sq_from_chain(nx[i], ny[j], acc[i][j]);
      out[(size_t)r * m + c] = kappa * shape_fn<SHAPE>(sq);
    }
  }
}

}  // namespace

extern "C" int stpy_gram_f32(const float* x, const float* y, float* out, int n,
                             int m, int d, float kappa, int shape, void* stream) {
  const dim3 grid((m + TILE - 1) / TILE, (n + TILE - 1) / TILE);
  const dim3 block(TPB, TPB);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (shape) {
    case 0: gram_kernel<0><<<grid, block, 0, s>>>(x, y, out, n, m, d, kappa); break;
    case 1: gram_kernel<1><<<grid, block, 0, s>>>(x, y, out, n, m, d, kappa); break;
    case 2: gram_kernel<2><<<grid, block, 0, s>>>(x, y, out, n, m, d, kappa); break;
    case 3: gram_kernel<3><<<grid, block, 0, s>>>(x, y, out, n, m, d, kappa); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* stpy_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
