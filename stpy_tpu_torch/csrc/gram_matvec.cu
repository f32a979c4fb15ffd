// Matrix-free Gram matvec out[i] = sum_j kappa * shape(|x_i - y_j|^2) * v[j],
// with K never stored.
//
// Replaces stpy_tpu/ops/pallas_gram_matvec.py:_gram_matvec_kernel (the
// pallas_call in _gram_matvec_pallas), shape "k".  The coordinates arrive
// already scaled by 1/gamma (scalar or per-dimension), as in
// pallas_gram_matvec.gram_matvec.
//
// What bounds it on an H100: per (i, j) pair 2d operations for the squared
// distance, the shape (an exp, and a sqrt for Matern) and 2 for the product
// with v; the inputs are O((n + m) d), so the f32 pipes and the SFU bound it,
// not memory (1.4 ms per atom at n = m = 65536, d = 8).
//
// Design: one block owns 64 rows of x and walks every 64-column tile of y
// (staged in shared memory with its slice of v) in ascending order.  Within
// a tile the block computes the 64x64 Gram tile exactly as gram.cu does --
// each of the 256 threads a 4x4 register sub-tile strided by 16 rows and 16
// columns, features staged 32 at a time, norms and dot from one FMA chain
// (gram_shape.cuh), so the diagonal term of K(x, x) v uses exactly kappa --
// and folds it into v in registers: each thread keeps one running f32 sum
// per row.  After the last tile the 16 threads that share a row reduce their
// sums by shuffles in a fixed tree and one writes the row.  No atomics and a
// fixed order everywhere, so a rerun gives the same bits: CG's stagnation
// test and iteration count would otherwise change from run to run.  The
// ragged edges of n, m and d are masked (the TPU kernel pads, and relies on
// zero v entries to cancel the padded columns).
#include <cuda_runtime.h>

#include "gram_shape.cuh"

namespace {

constexpr int TILE = 64;   // rows per block, columns per tile
constexpr int KC = 32;     // features staged per pass
constexpr int TPB = 16;    // threads per block along each axis
constexpr int PER = TILE / TPB;

template <int SHAPE>
__global__ void __launch_bounds__(TPB * TPB)
gram_matvec_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   const float* __restrict__ v, float* __restrict__ out,
                   int n, int m, int d, float kappa) {
  __shared__ float xs[TILE][KC + 1];
  __shared__ float ys[TILE][KC + 1];
  __shared__ float vs[TILE];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TPB + tx;
  const int row0 = blockIdx.x * TILE;

  float rowsum[PER] = {};
  for (int col0 = 0; col0 < m; col0 += TILE) {
    float acc[PER][PER] = {};
    float nx[PER] = {}, ny[PER] = {};
    if (tid < TILE) vs[tid] = (col0 + tid < m) ? v[col0 + tid] : 0.0f;
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
      float part = 0.0f;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        // masked columns carry v = 0, and their shape is finite (x, y = 0)
        part = fmaf(shape_fn<SHAPE>(sq_from_chain(nx[i], ny[j], acc[i][j])),
                    vs[tx + TPB * j], part);
      }
      rowsum[i] += part;
    }
    __syncthreads();   // vs is rewritten by the next tile
  }

  // the 16 threads of a row are the 16 lanes of one half-warp (tx = lane % 16)
#pragma unroll
  for (int i = 0; i < PER; ++i) {
#pragma unroll
    for (int off = TPB / 2; off > 0; off >>= 1)
      rowsum[i] += __shfl_xor_sync(0xffffffffu, rowsum[i], off);
    const int r = row0 + ty + TPB * i;
    if (tx == 0 && r < n) out[r] = kappa * rowsum[i];
  }
}

}  // namespace

extern "C" int stpy_gram_matvec(const float* x, const float* y, const float* v,
                                float* out, int n, int m, int d, float kappa,
                                int shape, void* stream) {
  const dim3 grid((n + TILE - 1) / TILE);
  const dim3 block(TPB, TPB);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (shape) {
    case 0: gram_matvec_kernel<0><<<grid, block, 0, s>>>(x, y, v, out, n, m, d, kappa); break;
    case 1: gram_matvec_kernel<1><<<grid, block, 0, s>>>(x, y, v, out, n, m, d, kappa); break;
    case 2: gram_matvec_kernel<2><<<grid, block, 0, s>>>(x, y, v, out, n, m, d, kappa); break;
    case 3: gram_matvec_kernel<3><<<grid, block, 0, s>>>(x, y, v, out, n, m, d, kappa); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
