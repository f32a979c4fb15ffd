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
// Design: the tiling and store path of gram_tile.cuh (whole 512-byte rows
// of float4 streaming stores, y staged once for 8 row tiles where d <= 32).
// The dot product and both norms are the same f32 FMA chain over the
// features in ascending order, so sq is exactly 0 where x_i == y_j.  No
// tensor cores and no TF32: the Gram feeds a Cholesky, which is why the TPU
// kernel pins its product to HIGHEST.
#include <cuda_runtime.h>

#include "gram_shape.cuh"
#include "gram_tile.cuh"

namespace {

// a warp's 4 rows against a lane's 8 columns: x.y and both squared norms
template <int SHAPE>
struct SqEntry {
  float kappa;
  struct Acc {
    float dot[4][8];
    float nx[4], ny[8];
  };
  __device__ __forceinline__ void step(Acc& s, const float (&a)[4],
                                       const float (&b)[8]) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) s.nx[i] = fmaf(a[i], a[i], s.nx[i]);
#pragma unroll
    for (int j = 0; j < 8; ++j) s.ny[j] = fmaf(b[j], b[j], s.ny[j]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s.dot[i][j] = fmaf(a[i], b[j], s.dot[i][j]);
  }
  __device__ __forceinline__ float value(const Acc& s, int i, int j) const {
    return kappa * shape_fn<SHAPE>(sq_from_chain(s.nx[i], s.ny[j], s.dot[i][j]));
  }
};

template <int SHAPE>
__global__ void __launch_bounds__(TILE_NT)
gram_kernel(const float* __restrict__ x, const float* __restrict__ y,
            float* __restrict__ out, int n, int m, int d, float kappa) {
  gram_tiles(x, y, out, n, m, d, SqEntry<SHAPE>{kappa});
}

}  // namespace

extern "C" int stpy_gram_f32(const float* x, const float* y, float* out, int n,
                             int m, int d, float kappa, int shape, void* stream) {
  const dim3 grid = gram_tile_grid(n, m);
  const int block = TILE_NT;
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
