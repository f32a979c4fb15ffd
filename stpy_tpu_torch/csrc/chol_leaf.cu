// Lower Cholesky factor of one SPD leaf block of n <= 1024, in place, in one
// launch: A (n x n, leading dimension lda) is overwritten by L with L L^T = A
// and the strict upper triangle set to exactly 0.  Only the lower triangle
// of A is read.  Where a pivot is not positive, sqrtf gives NaN (or 1/0 gives
// inf), which spreads through the rest of the factor, so an indefinite input
// leaves non-finite entries for the jitter ladder's isfinite test.
//
// Replaces stpy_tpu/ops/pallas_chol.py:_chol_leaf_kernel (the pallas_call in
// chol_leaf).  The TPU kernel keeps the whole 1024^2 leaf (4 MB) in VMEM and
// factors it in 128-column panels with iota-one-hot masked rank-1 updates and
// a masked triangular inverse, because XLA's TPU Cholesky is latency-bound at
// leaf sizes.  A Hopper block has 227 KB of shared memory, so the leaf itself
// stays in device memory (it fits the 50 MB L2) and only one panel is staged.
//
// What bounds it on an H100: n^3/3 operations (0.36 GFLOP at n = 1024)
// against 4 MB, a few microseconds of the whole card -- but the panel
// sequence is serial, and one block runs on one SM, 1/132 of the card's f32
// rate: about 0.7 ms at n = 1024 if that SM ran at its peak.  A multi-block
// variant (a cooperative launch with a grid-wide sync between panels) is the
// next design.
//
// Design: one block of 1024 threads, right-looking, 32-column panels.  For
// the panel at column s (R = n - s rows, w <= 32 columns):
//   1. stage A[s:n, s:s+w] transposed in dynamic shared memory
//      (pt[c][r], at most 32 x 1028 floats = 128.5 KB);
//   2. factor it column by column, thread r owning panel row r: pivot
//      d = sqrtf(pt[c][c]), l_r = pt[c][r] * (1/d), and the row's columns
//      c < cc <= min(r, w-1) lose l_r * l_cc -- the diagonal block's factor
//      and the solve of the rows below it in one pass, one barrier per
//      column (a thread's column-c value is written one step late, so no
//      thread reads a column while another writes it);
//   3. write the panel back, with zeros above the diagonal in the panel's
//      rows (inside the panel and to its right);
//   4. A[s+w:, s+w:] -= P2 P2^T on the lower triangle, P2 the panel's rows
//      below its diagonal block: each thread owns 4 x 4 tiles of the
//      trailing lower triangle, reads both operands as float4 from shared
//      memory and updates A in device memory (L2).
// Every entry is summed by one thread in a fixed order: the same bits every
// run.  A ragged n is masked (the last panel is narrower); no padding.
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int NMAX = 1024;       // largest leaf
constexpr int PW = 32;           // panel width
constexpr int LDP = NMAX + 4;    // row stride of the transposed panel (16-byte rows)
constexpr int NT = 1024;         // threads: one per panel row
constexpr int SMEM = static_cast<int>(sizeof(float)) * PW * LDP;

// t -> (bi, bj) with t = bi (bi + 1) / 2 + bj and 0 <= bj <= bi
__device__ __forceinline__ void lower_tile(int t, int& bi, int& bj) {
  int i = static_cast<int>((sqrtf(8.0f * static_cast<float>(t) + 1.0f) - 1.0f) * 0.5f);
  while (i * (i + 1) / 2 > t) --i;
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  bi = i;
  bj = t - i * (i + 1) / 2;
}

__global__ void __launch_bounds__(NT, 1)
chol_leaf_kernel(float* A, int n, int lda) {
  extern __shared__ __align__(16) float pt[];   // pt[c * LDP + r]
  const int tid = threadIdx.x;
  for (int s = 0; s < n; s += PW) {
    const int w = min(PW, n - s), R = n - s;
    // 1. stage: consecutive threads read consecutive columns of one row
    for (int idx = tid; idx < R * PW; idx += NT) {
      const int r = idx / PW, c = idx % PW;
      if (c < w) pt[c * LDP + r] = A[(size_t)(s + r) * lda + s + c];
    }
    // 2. factor the panel
    const int r = tid;
    float pend = 0.0f;   // this row's final value of the previous column
    for (int c = 0; c < w; ++c) {
      __syncthreads();   // column c as updated by step c - 1
      if (c > 0 && r >= c - 1 && r < R) pt[(c - 1) * LDP + r] = pend;
      const float d = sqrtf(pt[c * LDP + c]);   // NaN if the pivot is < 0
      const float inv = 1.0f / d;
      if (r == c) {
        pend = d;
      } else if (r > c && r < R) {
        const float l = pt[c * LDP + r] * inv;
        pend = l;
        const int cend = min(r, w - 1);
        for (int cc = c + 1; cc <= cend; ++cc)
          pt[cc * LDP + r] = fmaf(-l, pt[c * LDP + cc] * inv, pt[cc * LDP + r]);
      }
    }
    __syncthreads();
    if (r >= w - 1 && r < R) pt[(w - 1) * LDP + r] = pend;
    __syncthreads();
    // 3. write back; zeros above the diagonal in the panel's rows
    for (int idx = tid; idx < R * PW; idx += NT) {
      const int rr = idx / PW, c = idx % PW;
      if (c < w) A[(size_t)(s + rr) * lda + s + c] = c <= rr ? pt[c * LDP + rr] : 0.0f;
    }
    const int Rt = R - w;   // trailing rows; 0 for the last panel
    for (int idx = tid; idx < w * Rt; idx += NT) {
      const int rr = idx / Rt, j = idx % Rt;
      A[(size_t)(s + rr) * lda + s + w + j] = 0.0f;
    }
    // 4. trailing update (rows and columns >= s + w, disjoint from 3)
    if (Rt > 0) {
      const int q = (Rt + 3) / 4;
      const int tiles = q * (q + 1) / 2;
      for (int t = tid; t < tiles; t += NT) {
        int bi, bj;
        lower_tile(t, bi, bj);
        const int i0 = w + 4 * bi, j0 = w + 4 * bj;   // panel rows; w = PW here
        float acc[4][4] = {};
#pragma unroll 8
        for (int c = 0; c < PW; ++c) {
          const float4 a4 = *reinterpret_cast<const float4*>(&pt[c * LDP + i0]);
          const float4 b4 = *reinterpret_cast<const float4*>(&pt[c * LDP + j0]);
          const float a[4] = {a4.x, a4.y, a4.z, a4.w};
          const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(a[u], b[v], acc[u][v]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + u;
          if (i >= R) break;
          float* row = A + (size_t)(s + i) * lda + s;
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int j = j0 + v;
            if (j <= i) row[j] -= acc[u][v];
          }
        }
      }
    }
    __syncthreads();   // the next panel reads what step 4 wrote
  }
}

}  // namespace

extern "C" int stpy_chol_leaf(float* A, int n, int lda, void* stream) {
  if (n < 0 || n > NMAX || lda < n) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  // above 48 KB of dynamic shared memory a kernel must opt in
  cudaError_t err = cudaFuncSetAttribute(
      chol_leaf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  chol_leaf_kernel<<<1, NT, SMEM, static_cast<cudaStream_t>(stream)>>>(A, n, lda);
  return static_cast<int>(cudaGetLastError());
}
