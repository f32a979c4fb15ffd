// Matrix-free multi-RHS Gram product out = K(x, y) V, V of shape (m, r),
// K[i, j] = kappa * shape(|x_i - y_j|^2) never stored.
//
// Replaces stpy_tpu/ops/pallas_gram_matvec.py:_gram_matmat_kernel (the
// pallas_call in _gram_matmat_pallas), shape "k".  The coordinates arrive
// already scaled by 1/gamma, as in pallas_gram_matvec.gram_matmat.
//
// What bounds it on an H100: per (i, j) pair 2d operations for the squared
// distance, the shape, and 2r for the product with V's row j; at r = 128 the
// product is ~90 % of the work and the inputs are a few MB, so the f32 pipes
// bound it (17 ms per atom at n = m = 65536, d = 8, r = 128).  TF32 stays
// off, as the TPU kernel runs this product at Precision.HIGHEST.
//
// Design: one block of 256 threads owns a 128 x 128 tile of out (rows of x,
// columns of V; a second grid axis walks r in 128-column slabs) and keeps it
// in registers, 8 x 8 per thread.  It walks y in 32-point tiles in ascending
// order; for each it
//   1. computes the 128 x 32 Gram tile with gram.cu's FMA chain (features
//      staged 16 at a time) and stores it transposed in shared memory,
//      columns past m as 0;
//   2. stages the 32 x 128 slab of V (rows past m, columns past r as 0);
//   3. accumulates tile . slab with f32 FMAs, the classic SGEMM register
//      tile: per step two float4 reads of the Gram column and two of the V
//      row, 64 FMAs.
// No atomics and a fixed order, so a rerun gives the same bits.  Ragged n,
// m, r and d are masked, not padded.
#include <cuda_runtime.h>

#include "gram_shape.cuh"

namespace {

constexpr int TM = 128;    // output rows per block
constexpr int TR = 128;    // output columns (RHS) per block
constexpr int TN = 32;     // y points per tile
constexpr int KC = 16;     // features staged per pass
constexpr int NT = 256;    // threads per block
constexpr int KT_LD = TM + 4;   // row stride of the transposed Gram tile (16-byte rows)

template <int SHAPE>
__global__ void __launch_bounds__(NT, 2)
gram_matmat_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   const float* __restrict__ V, float* __restrict__ out,
                   int n, int m, int d, int r, float kappa) {
  __shared__ __align__(16) float kt[TN][KT_LD];   // kt[j][i] = K(x_i, y_j)
  __shared__ __align__(16) float vs[TN][TR];
  __shared__ float xs[TM][KC + 1];
  __shared__ float ys[TN][KC + 1];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.x * TM, c0 = blockIdx.y * TR;

  float acc[8][8] = {};
  for (int col0 = 0; col0 < m; col0 += TN) {
    // 1. Gram tile: thread rows ty + 16a (a < 8), columns tx + 16b (b < 2)
    float dot[8][2] = {};
    float nx[8] = {}, ny[2] = {};
    for (int k0 = 0; k0 < d; k0 += KC) {
      for (int idx = tid; idx < TM * KC; idx += NT) {
        const int i = idx / KC, k = idx % KC, kk = k0 + k;
        xs[i][k] = (row0 + i < n && kk < d) ? x[(size_t)(row0 + i) * d + kk] : 0.0f;
      }
      for (int idx = tid; idx < TN * KC; idx += NT) {
        const int j = idx / KC, k = idx % KC, kk = k0 + k;
        ys[j][k] = (col0 + j < m && kk < d) ? y[(size_t)(col0 + j) * d + kk] : 0.0f;
      }
      __syncthreads();
      const int kend = min(KC, d - k0);
      for (int k = 0; k < kend; ++k) {
        float a[8], b[2];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = xs[ty + 16 * i][k];
#pragma unroll
        for (int j = 0; j < 2; ++j) b[j] = ys[tx + 16 * j][k];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          nx[i] = fmaf(a[i], a[i], nx[i]);
#pragma unroll
          for (int j = 0; j < 2; ++j) dot[i][j] = fmaf(a[i], b[j], dot[i][j]);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) ny[j] = fmaf(b[j], b[j], ny[j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int jj = tx + 16 * j;
      const bool live = col0 + jj < m;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        kt[jj][ty + 16 * i] =
            live ? kappa * shape_fn<SHAPE>(sq_from_chain(nx[i], ny[j], dot[i][j])) : 0.0f;
    }
    // 2. the slab of V
    for (int idx = tid; idx < TN * TR; idx += NT) {
      const int j = idx / TR, c = idx % TR;
      vs[j][c] = (col0 + j < m && c0 + c < r) ? V[(size_t)(col0 + j) * r + c0 + c] : 0.0f;
    }
    __syncthreads();
    // 3. acc += tile . slab: thread rows 4ty + {0..3}, 64 + 4ty + {0..3},
    //    columns 4tx + {0..3}, 64 + 4tx + {0..3}
#pragma unroll 4
    for (int j = 0; j < TN; ++j) {
      const float4 a0 = *reinterpret_cast<const float4*>(&kt[j][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&kt[j][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&vs[j][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&vs[j][64 + 4 * tx]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
    }
    __syncthreads();   // kt and vs are rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = c0 + (c < 4 ? 4 * tx + c : 64 + 4 * tx + c - 4);
      if (col < r) out[(size_t)row * r + col] = acc[i][c];
    }
  }
}

}  // namespace

extern "C" int stpy_gram_matmat(const float* x, const float* y, const float* V,
                                float* out, int n, int m, int d, int r,
                                float kappa, int shape, void* stream) {
  const dim3 grid((n + TM - 1) / TM, (r + TR - 1) / TR);
  const dim3 block(NT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (shape) {
    case 0: gram_matmat_kernel<0><<<grid, block, 0, s>>>(x, y, V, out, n, m, d, r, kappa); break;
    case 1: gram_matmat_kernel<1><<<grid, block, 0, s>>>(x, y, V, out, n, m, d, r, kappa); break;
    case 2: gram_matmat_kernel<2><<<grid, block, 0, s>>>(x, y, V, out, n, m, d, r, kappa); break;
    case 3: gram_matmat_kernel<3><<<grid, block, 0, s>>>(x, y, V, out, n, m, d, r, kappa); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
