// Launch variants of csrc/gram_df.cu's kernel on a cross Gram (every tile
// computed), with the production arithmetic of the Matern-5/2 entry, for
// tools/gram_df_variants.py. Each keeps every entry's bits: the same FP64
// d-loop in the same feature order and the same entry code; only the tile,
// the occupancy (__launch_bounds__'s minimum blocks, which caps registers)
// and the split of the work change.
//
// v_kernel<PER, MINB, KC>: 16 x 16 threads, PER x PER entries a thread (a
// 16 PER square tile), at least MINB blocks an SM. two_phase<MINB>: the
// d-loop's 64 x 64 squared distances into shared memory, then one entry a
// thread at a time over the tile, so few registers are live in the exp.
#include <cuda_runtime.h>
#include "../stpy_tpu_torch/csrc/gram_df_entry.cuh"

namespace {

template <int SHAPE, int STAGE, int PER, int MINB, int KC>
__global__ void __launch_bounds__(256, MINB)
v_kernel(const double* __restrict__ x, const double* __restrict__ y,
         float* __restrict__ hi, float* __restrict__ lo, int n, int m,
         int d, double kappa) {
  constexpr int TPB = 16, TILE = TPB * PER;
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
          if (SHAPE == SHAPE_L1) sq[i][j] += fabs(t);
          else sq[i][j] = fma(t, t, sq[i][j]);
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
      const double v = STAGE == STAGE_ENTRY ? kappa * df_entry<SHAPE>(sq[i][j])
                                            : df_stage<SHAPE, STAGE>(sq[i][j]);
      store_pair(v, hi, lo, (size_t)r * m + c);
    }
  }
}

template <int SHAPE, int MINB>
__global__ void __launch_bounds__(256, MINB)
two_phase(const double* __restrict__ x, const double* __restrict__ y,
          float* __restrict__ hi, float* __restrict__ lo, int n, int m, int d,
          double kappa) {
  constexpr int TPB = 16, PER = 4, TILE = 64, KC = 8;
  __shared__ double xs[TILE][KC + 1];
  __shared__ double ys[TILE][KC + 1];
  __shared__ double sqs[TILE][TILE + 1];
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
          sq[i][j] = fma(t, t, sq[i][j]);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < PER; ++i)
#pragma unroll
    for (int j = 0; j < PER; ++j) sqs[ty + TPB * i][tx + TPB * j] = sq[i][j];
  __syncthreads();
#pragma unroll 1
  for (int e = tid; e < TILE * TILE; e += 256) {
    const int rr = e / TILE, cc = e % TILE;
    const int r = row0 + rr, c = col0 + cc;
    if (r < n && c < m)
      store_pair(kappa * df_entry<SHAPE>(sqs[rr][cc]), hi, lo, (size_t)r * m + c);
  }
}

template <int PER, int MINB, int KC>
int launch_v(const double* x, const double* y, float* hi, float* lo, int n,
             int m, int d, double kappa, cudaStream_t s) {
  constexpr int TILE = 16 * PER;
  const dim3 grid((m + TILE - 1) / TILE, (n + TILE - 1) / TILE);
  v_kernel<3, STAGE_ENTRY, PER, MINB, KC><<<grid, dim3(16, 16), 0, s>>>(x, y, hi, lo, n, m, d, kappa);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// variant v: 0-3 PER 4 at MINB 1-4; 4-6 PER 2 at MINB 4, 6, 8; 7-8
// two_phase at MINB 2 and 3.
extern "C" int gram_df_variant(int v, const double* x, const double* y, float* hi,
                           float* lo, int n, int m, int d, double kappa,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (v) {
    case 0: return launch_v<4, 1, 16>(x, y, hi, lo, n, m, d, kappa, s);
    case 1: return launch_v<4, 2, 16>(x, y, hi, lo, n, m, d, kappa, s);
    case 2: return launch_v<4, 3, 16>(x, y, hi, lo, n, m, d, kappa, s);
    case 3: return launch_v<4, 4, 16>(x, y, hi, lo, n, m, d, kappa, s);
    case 4: return launch_v<2, 4, 16>(x, y, hi, lo, n, m, d, kappa, s);
    case 5: return launch_v<2, 6, 16>(x, y, hi, lo, n, m, d, kappa, s);
    case 6: return launch_v<2, 8, 16>(x, y, hi, lo, n, m, d, kappa, s);
    case 7: {
      const dim3 grid((m + 63) / 64, (n + 63) / 64);
      two_phase<3, 2><<<grid, dim3(16, 16), 0, s>>>(x, y, hi, lo, n, m, d, kappa);
      return static_cast<int>(cudaGetLastError());
    }
    case 8: {
      const dim3 grid((m + 63) / 64, (n + 63) / 64);
      two_phase<3, 3><<<grid, dim3(16, 16), 0, s>>>(x, y, hi, lo, n, m, d, kappa);
      return static_cast<int>(cudaGetLastError());
    }
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
