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
// Design: a 256-thread block owns 256 columns and RT = 8 tiles of 32 rows
// below one another, taken in turn.  Warp w owns rows 4w .. 4w + 3 of a
// tile; lane l owns columns 4l .. 4l + 3 and
// 128 + 4l .. 128 + 4l + 3, so for each row a warp stores 2 x 512
// contiguous bytes, one float4 a lane, with the streaming hint (st.global.cs:
// the 1 GiB output does not fit in L2 and is not read back by this kernel).
// The x and y tiles are staged in shared memory 32 features at a time, y
// feature-major so that a lane reads its 4 columns as one float4; a row's x
// feature is one broadcast read.  Where d <= 32 the block stages its y
// columns once for all its row tiles: reloading them for every tile, and
// the barriers around the reloads, held the stores back.  The ragged
// edges of n, m and d are masked (the TPU kernel pads instead); where m is
// not a multiple of 4, or past m, the stores are scalar.  The dot product and both norms are the same f32
// FMA chain over the features in ascending order, so sq is exactly 0 where
// x_i == y_j.  No tensor cores and no TF32: the Gram feeds a Cholesky,
// which is why the TPU kernel pins its product to HIGHEST.
#include <cuda_runtime.h>

#include "gram_shape.cuh"

namespace {

constexpr int ROWS = 32;          // output rows per block (4 per warp)
constexpr int COLS = 256;         // output columns per block (8 per lane)
constexpr int RT = 8;             // row tiles per block
constexpr int KC = 32;            // features staged per pass
constexpr int NT = 256;           // threads per block
constexpr int YLD = COLS + 4;     // row stride of the staged y (16-byte rows)

template <int SHAPE>
__global__ void __launch_bounds__(NT)
gram_kernel(const float* __restrict__ x, const float* __restrict__ y,
            float* __restrict__ out, int n, int m, int d, float kappa) {
  __shared__ float xs[ROWS][KC];
  __shared__ __align__(16) float ys[KC][YLD];   // ys[k][c] = y[col0 + c, k0 + k]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int col0 = blockIdx.x * COLS;
  for (int rt = 0; rt < RT; ++rt) {
    const int row0 = (blockIdx.y * RT + rt) * ROWS;
    if (row0 >= n) break;
    float acc[4][8] = {};
    float nx[4] = {}, ny[8] = {};
    for (int k0 = 0; k0 < d; k0 += KC) {
      const int kc = min(KC, d - k0);
      for (int idx = tid; idx < ROWS * kc; idx += NT) {
        const int r = idx / kc, k = idx % kc;
        xs[r][k] = row0 + r < n ? x[(size_t)(row0 + r) * d + k0 + k] : 0.0f;
      }
      if (rt == 0 || d > KC) {
        for (int idx = tid; idx < COLS * kc; idx += NT) {
          const int c = idx / kc, k = idx % kc;
          ys[k][c] = col0 + c < m ? y[(size_t)(col0 + c) * d + k0 + k] : 0.0f;
        }
      }
      __syncthreads();
      for (int k = 0; k < kc; ++k) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xs[4 * warp + i][k];
        const float4 b0 = *reinterpret_cast<const float4*>(&ys[k][4 * lane]);
        const float4 b1 = *reinterpret_cast<const float4*>(&ys[k][128 + 4 * lane]);
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) nx[i] = fmaf(a[i], a[i], nx[i]);
#pragma unroll
        for (int j = 0; j < 8; ++j) ny[j] = fmaf(b[j], b[j], ny[j]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

    const bool vec = m % 4 == 0;   // every row starts on 16 bytes
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + 4 * warp + i;
      if (r >= n) continue;
      float* orow = out + (size_t)r * m;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = col0 + 128 * half + 4 * lane;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int jj = 4 * half + j;
          v[j] = kappa * shape_fn<SHAPE>(sq_from_chain(nx[i], ny[jj], acc[i][jj]));
        }
        if (vec && c + 3 < m) {
          __stcs(reinterpret_cast<float4*>(orow + c), make_float4(v[0], v[1], v[2], v[3]));
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (c + j < m) __stcs(orow + c + j, v[j]);
        }
      }
    }
  }
}

}  // namespace

extern "C" int stpy_gram_f32(const float* x, const float* y, float* out, int n,
                             int m, int d, float kappa, int shape, void* stream) {
  const dim3 grid((m + COLS - 1) / COLS, (n + ROWS * RT - 1) / (ROWS * RT));
  const int block = NT;
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
