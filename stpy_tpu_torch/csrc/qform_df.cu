// Fused double-float quadratic form of the refined predictive variance:
//
//   q[j] = sum_a W0a[a, j] * (2 B[a, j] - (A W0k)[a, j] - s2 W0a[a, j]),
//   A = Th + Tl (c, n),  B = Bh + Bl (c, t),  W0k (n, t),  W0a (c, t),
//
// returned as the f32 pair (qh, ql) = (f32(q), f32(q - qh)) of shape (t,).
// With c = n and W0k = W0a = W0 ~ (A + s2 I)^-1 B this is 2 b'w0 - w0'(A + s2 I)w0,
// which equals b'(A + s2 I)^-1 b up to a term second order in w0's residual;
// a row strip (c < n) gives that strip's share of the column sums.
//
// Replaces stpy_tpu/ops/pallas_qform_df.py:_qform_kernel (the pallas_call in
// _qform_pallas), reached through qform_refined and qform_refined_strip.  The
// TPU kernel emulates the exact product with int8 slices in bf16, ten
// TwoSum-folded passes and a double-float epilogue because the TPU has no
// f64.  Here A is read as one f64 value Th + Tl per element (exact for a df
// pair, or one f64 rounding off), the product runs on the FP64 tensor cores
// (mma.sync m16n8k4 f64, IEEE double products and sums), and u = 2B - acc -
// s2 W0a and W0a * u run in FP64 in the epilogue.  The (c, t) residual is
// never written to device memory.
//
// What bounds it on an H100: operations.  2 c n t FP64 flops (8.8e12 at
// c = n = t = 16384): about 131 ms at the 67 TFLOP/s FP64 tensor-core peak,
// against ~6 GiB of compulsory traffic (2 ms).
//
// Design: one 128x128 tile of (a, j) per 256-thread block, eight warps in a
// 4x2 grid, each warp a 32x64 tile of 2x8 m16n8k4 fragments (64 FP64
// accumulators a thread); m16n8k4 is an f64 shape that sm_90 added over the
// m8n8k4 of sm_80.  Th, Tl and W0k are staged as f32 in shared memory 16 k
// at a time through a three-stage cp.async ring, so two tiles are in
// flight while one is multiplied; each A fragment is converted and summed to
// f64 as it is read.  The row strides (20 floats for A, 136 for W0k) make
// both the fragment reads and the stores free of bank conflicts.  Ragged c, n
// and t are masked by zero-filled copies.  Blocks run along j fastest, so the
// blocks in flight share one row strip of A in L2.  The epilogue reduces
// W0a * u over the tile's rows in a fixed order (shuffles within a warp, then
// the four warps of a column through shared memory) and writes one f64
// partial per (row tile, column); qform_reduce_kernel sums the row tiles in
// order and splits.  No atomics: the result is the same on every run.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;                // rows a per block
constexpr int BN = 128;                // columns j per block
constexpr int BK = 16;                 // contraction depth per stage
constexpr int WARPS_M = 4, WARPS_N = 2;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int WM = BM / WARPS_M;       // rows per warp
constexpr int WN = BN / WARPS_N;       // columns per warp
constexpr int MT = WM / 8;             // 8-row groups per warp along a
constexpr int NT = WN / 8;             // mma fragments per warp along j
constexpr int STAGES = 3;
constexpr int AST = BK + 4;            // A row stride (floats)
constexpr int WST = BN + 8;            // W0k row stride (floats)
constexpr int STAGE_FLOATS = 2 * BM * AST + BK * WST;
constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * 4;
static_assert(WARPS_M * BN * 8 <= SMEM_BYTES, "the epilogue buffer fits the ring");

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // src-size 0 fills the 4 bytes with zeros and reads nothing
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// c += a b for one 16x8x4 f64 fragment, g = lane / 4, q = lane % 4:
// a0 = A[g][q], a1 = A[g + 8][q], b = B[q][g]; (c0, c1) = C[g][2q, 2q + 1],
// (c2, c3) = C[g + 8][2q, 2q + 1].
__device__ __forceinline__ void dmma(double& c0, double& c1, double& c2, double& c3,
                                     double a0, double a1, double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+d"(c0), "+d"(c1), "+d"(c2), "+d"(c3)
      : "d"(a0), "d"(a1), "d"(b));
}

__global__ void __launch_bounds__(THREADS, 1)
qform_df_kernel(const float* __restrict__ th, const float* __restrict__ tl,
                const float* __restrict__ w0k, const float* __restrict__ w0a,
                const float* __restrict__ bh, const float* __restrict__ bl,
                double s2, double* __restrict__ part, int c, int n, int t) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  // stage s: Th rows [BM][AST], Tl rows [BM][AST], W0k rows [BK][WST]
  auto load = [&](int stage, int k0) {
    float* sth = smem + stage * STAGE_FLOATS;
    float* stl = sth + BM * AST;
    float* sw = stl + BM * AST;
#pragma unroll
    for (int l = 0; l < BM * BK / THREADS; ++l) {
      const int idx = tid + THREADS * l, r = idx / BK, k = idx % BK;
      const bool ok = row0 + r < c && k0 + k < n;
      const size_t e = ok ? (size_t)(row0 + r) * n + k0 + k : 0;
      cp_async4(sth + r * AST + k, th + e, ok);
      cp_async4(stl + r * AST + k, tl + e, ok);
    }
#pragma unroll
    for (int l = 0; l < BK * BN / THREADS; ++l) {
      const int idx = tid + THREADS * l, k = idx / BN, col = idx % BN;
      const bool ok = k0 + k < n && col0 + col < t;
      const size_t e = ok ? (size_t)(k0 + k) * t + col0 + col : 0;
      cp_async4(sw + k * WST + col, w0k + e, ok);
    }
  };

  double acc[MT][NT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = 0.0;

  const int ktiles = (n + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load(s, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    // refill the stage that the previous iteration multiplied
    if (kt + STAGES - 1 < ktiles) load((kt + STAGES - 1) % STAGES, (kt + STAGES - 1) * BK);
    cp_async_commit();

    const float* sth = smem + (kt % STAGES) * STAGE_FLOATS;
    const float* stl = sth + BM * AST;
    const float* sw = stl + BM * AST;
#pragma unroll
    for (int k = 0; k < BK; k += 4) {
      double a[MT], b[NT];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int off = (wm * WM + i * 8 + g) * AST + k + q;
        a[i] = static_cast<double>(sth[off]) + static_cast<double>(stl[off]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
        b[j] = static_cast<double>(sw[(k + q) * WST + wn * WN + j * 8 + g]);
      // rows i * 8 + g and (i + 1) * 8 + g form one m16 fragment
#pragma unroll
      for (int i = 0; i < MT; i += 2)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          dmma(acc[i][j][0], acc[i][j][1], acc[i + 1][j][0], acc[i + 1][j][1],
               a[i], a[i + 1], b[j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: W0a * (2B - acc - s2 W0a) summed over this thread's rows, per
  // column it holds, then over the 8 lanes of a column (same q)
  double colsum[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = col0 + wn * WN + j * 8 + 2 * q + e;
      double sum = 0.0;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = row0 + wm * WM + i * 8 + g;
        if (r < c && col < t) {
          const size_t x = (size_t)r * t + col;
          const double w = static_cast<double>(w0a[x]);
          const double b = static_cast<double>(bh[x]) + static_cast<double>(bl[x]);
          sum += w * (2.0 * b - acc[i][j][e] - s2 * w);
        }
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      colsum[j][e] = sum;
    }
  }
  // the four warps of a column, in order of wm (the ring is free now)
  double* red = reinterpret_cast<double*>(smem);
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) red[wm * BN + wn * WN + j * 8 + 2 * q + e] = colsum[j][e];
  }
  __syncthreads();
  if (tid < BN && col0 + tid < t) {
    double s = 0.0;
#pragma unroll
    for (int m = 0; m < WARPS_M; ++m) s += red[m * BN + tid];
    part[(size_t)blockIdx.y * t + col0 + tid] = s;
  }
}

// q[j] = sum over row tiles of part[:, j], in order; split into (hi, lo).
__global__ void qform_reduce_kernel(const double* __restrict__ part, int tiles,
                                    int t, float* __restrict__ qh,
                                    float* __restrict__ ql) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= t) return;
  double s = 0.0;
  for (int r = 0; r < tiles; ++r) s += part[(size_t)r * t + j];
  const float h = static_cast<float>(s);
  qh[j] = h;
  ql[j] = static_cast<float>(s - static_cast<double>(h));
}

}  // namespace

// Rows of part: ceil(c / 128), one per row tile.
extern "C" int stpy_qform_df_row_tiles(int c) { return (c + BM - 1) / BM; }

extern "C" int stpy_qform_df(const float* th, const float* tl, const float* w0k,
                             const float* w0a, const float* bh, const float* bl,
                             double s2, double* part, int c, int n, int t,
                             void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      qform_df_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t + BN - 1) / BN, (c + BM - 1) / BM);
  qform_df_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      th, tl, w0k, w0a, bh, bl, s2, part, c, n, t);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int stpy_qform_df_reduce(const double* part, int tiles, int t,
                                    float* qh, float* ql, void* stream) {
  constexpr int R = 256;
  qform_reduce_kernel<<<(t + R - 1) / R, R, 0, static_cast<cudaStream_t>(stream)>>>(
      part, tiles, t, qh, ql);
  return static_cast<int>(cudaGetLastError());
}
