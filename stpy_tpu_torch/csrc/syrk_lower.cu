// Lower-triangle symmetric rank-k update, in place, in IEEE f32:
//   C[i, j] <- C[i, j] - sum_p W[i, p] W[j, p]   for every i >= j,
// C an (m x m) view with leading dimension ldc, W (m x k) with ldw.  The
// strict upper triangle of C is neither read nor written.
//
// Replaces stpy_tpu/ops/pallas_syrk.py:_syrk_lower_kernel (the pallas_call in
// syrk_update_lower), the trailing update of the blocked Cholesky
// chol_blocked_syrk.  The TPU kernel splits W into bf16 halves and runs three
// bf16 MXU passes per tile (v5e has no f32 matrix mode) over a sequential
// (p, p, k) grid, carrying its sum in VMEM scratch across k and copying the
// upper tiles through.  The card computes in f32, so there is no split, and
// only the lower tiles are launched.
//
// What bounds it on an H100: m(m+1)/2 entries times 2k operations against
// reading W once and the lower half of C once each way.  At the fast
// factor's first step (m = 14336, k = 2048) that is 0.42 TFLOP against
// 1.0 GB, so the f32 pipes bound it (6.3 ms at 67 TFLOP/s); TF32 stays off,
// as the TPU kernel keeps f32 quality (bf16x3 ~ Precision.HIGH).
//
// Design: gram_matmat.cu's register-tiled SIMT layout.  One block of 256
// threads owns a 128 x 128 tile (bi, bj), bi >= bj, of C; the 1-D grid
// enumerates only those tiles, decoded by an integer square root with a
// check.  The block walks k in 32-deep slabs in ascending order, staging the
// slab of W's rows of bi and of bj transposed in shared memory, and each
// thread accumulates an 8 x 8 sub-tile with f32 FMAs (two float4 reads of
// each operand per step).  The tile then subtracts its sum from C on the
// entries with i >= j.  Each entry is summed by one thread in a fixed order,
// with no atomics, so a rerun gives the same bits.  Ragged m and k are
// masked, not padded.
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int TM = 128;          // rows and columns of C per block
constexpr int KC = 32;           // depth of one k-slab
constexpr int NT = 256;          // threads per block
constexpr int LD = TM + 4;       // row stride of a staged slab (16-byte rows)

// t -> (bi, bj) with t = bi (bi + 1) / 2 + bj and 0 <= bj <= bi
__device__ __forceinline__ void lower_tile(long long t, int& bi, int& bj) {
  long long i = static_cast<long long>((sqrt(8.0 * static_cast<double>(t) + 1.0) - 1.0) * 0.5);
  while (i * (i + 1) / 2 > t) --i;
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  bi = static_cast<int>(i);
  bj = static_cast<int>(t - i * (i + 1) / 2);
}

__global__ void __launch_bounds__(NT, 2)
syrk_lower_kernel(float* __restrict__ C, const float* __restrict__ W, int m,
                  int k, int ldc, int ldw) {
  __shared__ __align__(16) float as[KC][LD];   // as[p][i] = W[row0 + i, k0 + p]
  __shared__ __align__(16) float bs[KC][LD];   // bs[p][j] = W[col0 + j, k0 + p]
  int bi, bj;
  lower_tile(blockIdx.x, bi, bj);
  const int row0 = bi * TM, col0 = bj * TM;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  float acc[8][8] = {};
  for (int k0 = 0; k0 < k; k0 += KC) {
    // consecutive threads read consecutive p of one row of W (coalesced)
    for (int idx = tid; idx < TM * KC; idx += NT) {
      const int r = idx / KC, p = idx % KC, kk = k0 + p;
      const bool live = kk < k;
      as[p][r] = (live && row0 + r < m) ? W[(size_t)(row0 + r) * ldw + kk] : 0.0f;
      bs[p][r] = (live && col0 + r < m) ? W[(size_t)(col0 + r) * ldw + kk] : 0.0f;
    }
    __syncthreads();
    // thread rows 4ty + {0..3}, 64 + 4ty + {0..3}; columns 4tx + {0..3},
    // 64 + 4tx + {0..3}
#pragma unroll 4
    for (int p = 0; p < KC; ++p) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[p][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[p][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[p][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[p][64 + 4 * tx]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
    }
    __syncthreads();   // the slabs are rewritten by the next pass
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (row >= m) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = col0 + (c < 4 ? 4 * tx + c : 64 + 4 * tx + c - 4);
      if (col <= row) C[(size_t)row * ldc + col] -= acc[i][c];
    }
  }
}

}  // namespace

extern "C" int stpy_syrk_lower(float* C, const float* W, int m, int k, int ldc,
                               int ldw, void* stream) {
  if (m < 0 || k < 0 || ldc < m || ldw < k) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return static_cast<int>(cudaSuccess);
  const long long p = (m + TM - 1) / TM;
  const long long tiles = p * (p + 1) / 2;
  syrk_lower_kernel<<<static_cast<unsigned>(tiles), NT, 0,
                      static_cast<cudaStream_t>(stream)>>>(C, W, m, k, ldc, ldw);
  return static_cast<int>(cudaGetLastError());
}
