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
// f64.  Here A is one f64 value Th + Tl per element (exact for a df pair, or
// one f64 rounding off), the product runs on the FP64 tensor cores (IEEE
// double products and sums), and u = 2B - acc - s2 W0a and W0a * u run in
// FP64 in the epilogue.  The (c, t) residual is never written to device
// memory.
//
// What bounds it on an H100: operations.  2 c n t FP64 flops (8.8e12 at
// c = n = t = 16384): about 131 ms at the 67 TFLOP/s FP64 tensor-core peak,
// against ~6 GiB of compulsory traffic (2 ms).
//
// Design, four kernels of one call:
//   * pack_a_kernel and pack_w_kernel write A64 = f64(Th) + f64(Tl) and
//     W64 = f64(W0k) once, zero padded to whole tiles (rows of A to 128, the
//     contraction to 32, the columns of W to 128), each 128 x 32 tile as one
//     contiguous 32 KB block in the order the tensor cores' fragments read
//     it, into the scratch the wrapper allocates (2 x 8 x 16384^2 bytes =
//     4 GiB at c = n = t = 16384).  The main loop then converts nothing,
//     masks nothing and computes no address but a tile's base.
//   * qform_df_kernel: one 128x128 tile of (a, j) per 256-thread block,
//     eight warps in a 4x2 grid, each warp a 32x64 tile of 2x8 fragments of
//     mma.sync.m16n8k16.f64 (the largest f64 shape of sm_90: 16x8x16 per
//     instruction, 64 FP64 accumulators a thread).  The A and W tiles of 32
//     k stream through a ring of three 64 KB stages, each filled by two bulk
//     copies (cp.async.bulk) whose arrival is counted on an mbarrier; one
//     __syncthreads a stage frees it for the next copies.  The k slots of a
//     fragment are assigned so that a thread's values pair up (slot q + 4i
//     holds k = 4q + i), and the packed tiles put each thread's pair of
//     doubles beside its neighbour's: every fragment read is one 16-byte
//     read a lane, consecutive across the warp, free of bank conflicts.
//     Blocks run in groups of 8 row tiles, so the blocks in flight share
//     A's row strips and W's column strips in L2.
//   * The epilogue reduces W0a * u over the tile's rows in a fixed order
//     (the thread's rows in ascending order, shuffles within a warp, then
//     the four warps of a column through shared memory) and writes one f64
//     partial per (row tile, column); qform_reduce_kernel sums the row tiles
//     in order and splits.  No atomics: the result is the same on every run.
#include <cuda_runtime.h>

#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int BM = 128;                // rows a per block
constexpr int BN = 128;                // columns j per block
constexpr int BK = 32;                 // contraction depth per stage
constexpr int KS = BK / 16;            // m16n8k16 steps per stage
constexpr int WARPS_M = 4, WARPS_N = 2;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int WM = BM / WARPS_M;       // rows per warp
constexpr int WN = BN / WARPS_N;       // columns per warp
constexpr int MF = WM / 16;            // m16 fragments per warp
constexpr int NF = WN / 8;             // n8 fragments per warp
constexpr int TILE = BM * BK;          // doubles of a packed A tile, and of a W tile
static_assert(BK * BN == TILE, "A and W tiles are one size");
constexpr int STAGES = 3;
constexpr int SMEM_BYTES = STAGES * 2 * TILE * 8;
constexpr int GROUP = 8;               // row tiles per group of blocks
static_assert(WARPS_M * BN <= 2 * TILE * STAGES, "the epilogue buffer fits the ring");

// c += a b for one 16x8x16 f64 fragment, g = lane / 4, q = lane % 4:
// a[2i + h] = A[g + 8h][slot q + 4i], b[i] = B[slot q + 4i][g];
// (c0, c1) = C[g][2q, 2q + 1], (c2, c3) = C[g + 8][2q, 2q + 1]
// (cute/atom/mma_traits_sm90.hpp: SM90_16x8x16_F64F64F64F64_TN).
__device__ __forceinline__ void dmma16(double (&c)[4], const double (&a)[8],
                                       const double (&b)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]),
        "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// A (rows x cols, Th + Tl) -> packed f64 tiles, one block a (row tile, k
// tile), tile (tm, tk) at (tm * ktiles + tk) * TILE.  Within a tile, double
// ((((wm * KS + ks) * MF + mi) * 4 + c) * 32 + lane) * 2 + h is
// A[wm * WM + mi * 16 + 8h + g][ks * 16 + 4q + c]: fragment values a[2c + h].
__global__ void __launch_bounds__(256)
pack_a_kernel(const float* __restrict__ th, const float* __restrict__ tl,
              double* __restrict__ out, int rows, int cols, int ktiles) {
  __shared__ double tile[BM][BK + 1];
  const int tm = blockIdx.x / ktiles, tk = blockIdx.x % ktiles;
  for (int i = threadIdx.x; i < TILE; i += 256) {
    const int r = tm * BM + i / BK, k = tk * BK + i % BK;
    double v = 0.0;
    if (r < rows && k < cols) {
      const size_t s = (size_t)r * cols + k;
      v = static_cast<double>(th[s]) + static_cast<double>(tl[s]);
    }
    tile[i / BK][i % BK] = v;
  }
  __syncthreads();
  double* o = out + (size_t)blockIdx.x * TILE;
  for (int i = threadIdx.x; i < TILE; i += 256) {
    const int h = i & 1, lane = (i >> 1) & 31, c = (i >> 6) & 3, f = i >> 8;
    const int mi = f % MF, ks = f / MF % KS, wm = f / (MF * KS);
    o[i] = tile[wm * WM + mi * 16 + 8 * h + (lane >> 2)][ks * 16 + 4 * (lane & 3) + c];
  }
}

// W0k (rows x cols) -> packed f64 tiles, one block a (column tile, k tile),
// tile (tn, tk) at (tn * ktiles + tk) * TILE.  Within a tile, double
// (((ks * (BN / 8) + nf) * 2 + c) * 32 + lane) * 2 + h is
// W[ks * 16 + 4q + 2c + h][nf * 8 + g]: fragment values b[2c + h].
__global__ void __launch_bounds__(256)
pack_w_kernel(const float* __restrict__ w, double* __restrict__ out, int rows, int cols,
              int ktiles) {
  __shared__ double tile[BK][BN + 1];
  const int tn = blockIdx.x / ktiles, tk = blockIdx.x % ktiles;
  for (int i = threadIdx.x; i < TILE; i += 256) {
    const int k = tk * BK + i / BN, col = tn * BN + i % BN;
    tile[i / BN][i % BN] =
        k < rows && col < cols ? static_cast<double>(w[(size_t)k * cols + col]) : 0.0;
  }
  __syncthreads();
  double* o = out + (size_t)blockIdx.x * TILE;
  for (int i = threadIdx.x; i < TILE; i += 256) {
    const int h = i & 1, lane = (i >> 1) & 31, c = (i >> 6) & 1, f = i >> 7;
    const int nf = f % (BN / 8), ks = f / (BN / 8);
    o[i] = tile[ks * 16 + 4 * (lane & 3) + 2 * c + h][nf * 8 + (lane >> 2)];
  }
}

__global__ void __launch_bounds__(THREADS, 1)
qform_df_kernel(const double* __restrict__ a64, const double* __restrict__ w64,
                const float* __restrict__ w0a, const float* __restrict__ bh,
                const float* __restrict__ bl, double s2, double* __restrict__ part,
                int c, int t, int ktiles, int tiles_n) {
  extern __shared__ __align__(128) double smem[];
  __shared__ __align__(8) uint64_t full[STAGES];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  // groups of GROUP row tiles, row tiles fastest within a group
  const int tiles_m = (c + BM - 1) / BM;
  const int per_group = GROUP * tiles_n, in_group = blockIdx.x % per_group;
  const int first = blockIdx.x / per_group * GROUP;
  const int rows_g = min(tiles_m - first, GROUP);
  const int tile_m = first + in_group % rows_g, tile_n = in_group / rows_g;
  const int row0 = tile_m * BM, col0 = tile_n * BN;
  const double* ag = a64 + (size_t)tile_m * ktiles * TILE;
  const double* wg = w64 + (size_t)tile_n * ktiles * TILE;

  // stage s: the A tile at smem + 2 s TILE, the W tile after it
  auto load = [&](int s, int kt) {
    mbar_expect_tx(&full[s], 2 * TILE * sizeof(double));
    bulk_copy(smem + 2 * s * TILE, ag + (size_t)kt * TILE, TILE * sizeof(double), &full[s]);
    bulk_copy(smem + (2 * s + 1) * TILE, wg + (size_t)kt * TILE, TILE * sizeof(double),
              &full[s]);
  };
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
    for (int s = 0; s < STAGES && s < ktiles; ++s) load(s, s);
  }
  __syncthreads();

  double acc[MF][NF][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0;

  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    const double2* sa = reinterpret_cast<const double2*>(smem + 2 * s * TILE);
    const double2* sw = reinterpret_cast<const double2*>(smem + (2 * s + 1) * TILE);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      double a[MF][8];
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const double2 v = sa[(((wm * KS + ks) * MF + i) * 4 + cc) * 32 + lane];
          a[i][2 * cc] = v.x;
          a[i][2 * cc + 1] = v.y;
        }
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        const int nf = wn * NF + j;
        const double2 v0 = sw[((ks * (BN / 8) + nf) * 2) * 32 + lane];
        const double2 v1 = sw[((ks * (BN / 8) + nf) * 2 + 1) * 32 + lane];
        const double b[4] = {v0.x, v0.y, v1.x, v1.y};
#pragma unroll
        for (int i = 0; i < MF; ++i) dmma16(acc[i][j], a[i], b);
      }
    }
    __syncthreads();   // every warp is done with stage s
    if (tid == 0 && kt + STAGES < ktiles) load(s, kt + STAGES);
  }

  // epilogue: W0a * (2B - acc - s2 W0a) summed over this thread's rows in
  // ascending order (g, g + 8, g + 16, g + 24 of the warp's 32), per column
  // it holds, then over the 8 lanes of a column (same q)
  double colsum[NF][2];
#pragma unroll
  for (int j = 0; j < NF; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = col0 + wn * WN + j * 8 + 2 * q + e;
      double sum = 0.0;
#pragma unroll
      for (int i = 0; i < 2 * MF; ++i) {
        const int r = row0 + wm * WM + i * 8 + g;
        if (r < c && col < t) {
          const size_t x = (size_t)r * t + col;
          const double w = static_cast<double>(w0a[x]);
          const double b = static_cast<double>(bh[x]) + static_cast<double>(bl[x]);
          sum += w * (2.0 * b - acc[i / 2][j][2 * (i % 2) + e] - s2 * w);
        }
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      colsum[j][e] = sum;
    }
  }
  // the four warps of a column, in order of wm (every copy has landed and
  // been read: the ring is free)
  double* red = smem;
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) red[wm * BN + wn * WN + j * 8 + 2 * q + e] = colsum[j][e];
  }
  __syncthreads();
  if (tid < BN && col0 + tid < t) {
    double s = 0.0;
#pragma unroll
    for (int m = 0; m < WARPS_M; ++m) s += red[m * BN + tid];
    part[(size_t)tile_m * t + col0 + tid] = s;
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

int round_up(int v, int to) { return (v + to - 1) / to * to; }

}  // namespace

// Rows of part: ceil(c / 128), one per row tile.
extern "C" int stpy_qform_df_row_tiles(int c) { return (c + BM - 1) / BM; }

// Doubles of scratch that stpy_qform_df takes: A64 (c to 128 rows, n to 32
// columns) and W64 (n to 32 rows, t to 128 columns).
extern "C" long long stpy_qform_df_scratch(int c, int n, int t) {
  return (long long)round_up(c, BM) * round_up(n, BK) +
         (long long)round_up(n, BK) * round_up(t, BN);
}

extern "C" int stpy_qform_df(const float* th, const float* tl, const float* w0k,
                             const float* w0a, const float* bh, const float* bl,
                             double s2, double* part, double* scratch, int c, int n, int t,
                             void* stream) {
  if (c <= 0 || n < 0 || t <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      qform_df_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles_m = round_up(c, BM) / BM, ktiles = round_up(n, BK) / BK;
  const int tiles_n = round_up(t, BN) / BN;
  double* a64 = scratch;
  double* w64 = scratch + (size_t)tiles_m * ktiles * TILE;
  if (ktiles > 0) {
    pack_a_kernel<<<tiles_m * ktiles, 256, 0, s>>>(th, tl, a64, c, n, ktiles);
    pack_w_kernel<<<tiles_n * ktiles, 256, 0, s>>>(w0k, w64, n, t, ktiles);
  }
  qform_df_kernel<<<tiles_m * tiles_n, THREADS, SMEM_BYTES, s>>>(
      a64, w64, w0a, bh, bl, s2, part, c, t, ktiles, tiles_n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int stpy_qform_df_reduce(const double* part, int tiles, int t,
                                    float* qh, float* ql, void* stream) {
  constexpr int R = 256;
  qform_reduce_kernel<<<(t + R - 1) / R, R, 0, static_cast<cudaStream_t>(stream)>>>(
      part, tiles, t, qh, ql);
  return static_cast<int>(cudaGetLastError());
}
