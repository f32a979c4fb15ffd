// Matrix-free Gram matvec out[i] = sum_j kappa * shape(|x_i - y_j|^2) * v[j],
// with K never stored.
//
// Replaces stpy_tpu/ops/pallas_gram_matvec.py:_gram_matvec_kernel (the
// pallas_call in _gram_matvec_pallas) in all three of its shapes (_SHAPES):
// the kernel "k", and the derivative shapes "dk_sq" = k'(sq) sq (the
// lengthscale gradient) and "dk" = k'(sq) (ARD and coordinate cotangents),
// codes 0-11 of gram_shape.cuh.  The coordinates arrive already scaled by
// 1/gamma (scalar or per-dimension), as in pallas_gram_matvec.gram_matvec.
//
// What bounds it on an H100: operations.  Per (i, j) pair d FMAs of the dot
// product, the squared distance from the norms (an add, an FMA, a max), the
// shape (SE: an FMUL and one MUFU.EX2; Matern adds a MUFU.SQRT and two or
// three FP32 operations) and one FMA with v[j]; the inputs are O((n + m) d).
// At n = m = 65536, d = 8 that is about 14 issue slots a pair on the FP32
// pipes, which also issue the MUFUs.
//
// Design: everything but the pairs' own instructions is taken out of the
// loop.
//   * pad_points_kernel writes y once as rows of DP + 4 floats: the first DP
//     features (DP = 8 or 16, zero past d), the point's squared norm by
//     gram.cu's FMA chain over all d features, v[j], two zeros; past m the
//     rows are zero (v = 0, so they add exactly nothing).
//   * gram_matvec_kernel: each of a block's 256 threads keeps R rows of x
//     (R = 8 at DP = 8, 4 at DP = 16), their first DP features and their norms
//     in registers for the whole kernel.  The block streams its range of y
//     tiles (128 points) through a ring of 4 shared-memory stages, each one
//     bulk copy (cp.async.bulk) whose arrival is counted on an mbarrier; one
//     __syncthreads a tile frees the stage for the next copy.  Every thread
//     reads the same point at a time, so each read is a broadcast float4.
//     Features past 16 are read from x and y in global memory (the cache
//     serves them), so any d > 0 is taken.
//   * The shape is shape_exp2 (gram_shape.cuh): the constant folded into a
//     base-2 exponent on MUFU.EX2, the square root on MUFU.SQRT.  The
//     derivative shapes add an FMUL or two (Matern-1/2's "dk" an IEEE
//     division) to the same loop: one template instance per code.
//   * The norms and the dot come from one FMA chain in ascending features
//     (zero features add nothing), so where x_i == y_j sq is exactly 0 and
//     the diagonal term of K(x, x) v is exactly kappa v_i (kappa k'(0) v_i
//     for "dk", 0 for "dk_sq").
// Each thread sums its rows over its range's points in ascending order, in
// f32.  Where the rows alone give fewer blocks than the card holds, the
// points are split into ranges (`plan`: the count that needs the fewest
// tile-steps on the busiest SM, a function of n, m, d and the SM count) and
// matvec_reduce_kernel adds the ranges' partial sums in order.  No
// atomics and a fixed order everywhere, so a rerun gives the same bits: CG's
// stall test and iteration count would otherwise change from run to run.
#include <cuda_runtime.h>

#include <stdint.h>

#include "async_copy.cuh"
#include "gram_shape.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TJ = 128;        // y points per tile
constexpr int STAGES = 4;      // tiles in the ring
constexpr int DMAX = 16;       // most features held in registers
constexpr int BLOCKS_PER_SM = 2;

__host__ __device__ constexpr int rows_per_thread(int dp) { return dp <= 8 ? 8 : 4; }
int head_features(int d) { return d <= 8 ? 8 : DMAX; }

// y -> rows of dp + 4 floats: features 0..dp-1, |y_j|^2, v_j, 0, 0
__global__ void __launch_bounds__(256)
pad_points_kernel(const float* __restrict__ y, const float* __restrict__ v,
                  float* __restrict__ yh, int m, int d, int dp, int padded) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= padded) return;
  float* row = yh + (size_t)j * (dp + 4);
  float ny = 0.0f;
  for (int k = 0; k < d; ++k) {
    const float b = j < m ? y[(size_t)j * d + k] : 0.0f;
    ny = fmaf(b, b, ny);
    if (k < dp) row[k] = b;
  }
  for (int k = d; k < dp; ++k) row[k] = 0.0f;
  row[dp] = ny;
  row[dp + 1] = j < m ? v[j] : 0.0f;
  row[dp + 2] = row[dp + 3] = 0.0f;
}

template <int SHAPE, int DP, bool TAIL>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
gram_matvec_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   const float* __restrict__ yh, float* __restrict__ out,
                   float* __restrict__ part, int n, int m, int d, int per, int tiles,
                   float kappa) {
  constexpr int R = rows_per_thread(DP);
  constexpr int W = DP + 4;              // floats a point
  constexpr int TILE = TJ * W;           // floats a tile
  __shared__ __align__(128) float ring[STAGES][TILE];
  __shared__ __align__(8) uint64_t full[STAGES];
  const int tid = threadIdx.x;
  const int t0 = blockIdx.y * per;
  const int count = min(tiles, t0 + per) - t0;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    for (int s = 0; s < STAGES && s < count; ++s) {
      mbar_expect_tx(&full[s], TILE * sizeof(float));
      bulk_copy(ring[s], yh + (size_t)(t0 + s) * TILE, TILE * sizeof(float), &full[s]);
    }
  }

  // this thread's rows: row0 + tid + THREADS * r, their first DP features
  // (0 past d and past n) and norms, by the chain pad_points_kernel runs
  const int row0 = blockIdx.x * THREADS * R + tid;
  float xr[R][DP], nx[R], acc[R];
  const float* xrow[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + THREADS * r;
    const bool ok = row < n;
    xrow[r] = x + (size_t)(ok ? row : n - 1) * d;
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < DP; ++k) {
      xr[r][k] = ok && k < d ? xrow[r][k] : 0.0f;
      s = fmaf(xr[r][k], xr[r][k], s);
    }
    if (TAIL) {
      for (int k = DP; k < d; ++k) {
        const float a = ok ? xrow[r][k] : 0.0f;
        s = fmaf(a, a, s);
      }
    }
    nx[r] = s;
    acc[r] = 0.0f;
  }

  for (int it = 0; it < count; ++it) {
    const int st = it % STAGES;
    mbar_wait(&full[st], (it / STAGES) & 1);
    const float* tile = ring[st];
#pragma unroll 4
    for (int jj = 0; jj < TJ; ++jj) {
      const float4* p = reinterpret_cast<const float4*>(tile + jj * W);
      float yk[DP];
#pragma unroll
      for (int q = 0; q < DP / 4; ++q) {
        const float4 b = p[q];
        yk[4 * q] = b.x;
        yk[4 * q + 1] = b.y;
        yk[4 * q + 2] = b.z;
        yk[4 * q + 3] = b.w;
      }
      const float4 nv = p[DP / 4];       // |y_j|^2, v_j
      float dot[R];
#pragma unroll
      for (int r = 0; r < R; ++r) dot[r] = 0.0f;
#pragma unroll
      for (int k = 0; k < DP; ++k)
#pragma unroll
        for (int r = 0; r < R; ++r) dot[r] = fmaf(xr[r][k], yk[k], dot[r]);
      if (TAIL) {
        const float* yrow = y + (size_t)min((t0 + it) * TJ + jj, m - 1) * d;
        for (int k = DP; k < d; ++k) {
          const float b = __ldg(yrow + k);
#pragma unroll
          for (int r = 0; r < R; ++r) dot[r] = fmaf(__ldg(xrow[r] + k), b, dot[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        acc[r] = fmaf(shape_exp2<SHAPE>(sq_from_chain(nx[r], nv.x, dot[r])), nv.y, acc[r]);
    }
    __syncthreads();   // every thread is done with stage st
    if (tid == 0 && it + STAGES < count) {
      mbar_expect_tx(&full[st], TILE * sizeof(float));
      bulk_copy(ring[st], yh + (size_t)(t0 + it + STAGES) * TILE, TILE * sizeof(float),
                &full[st]);
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + THREADS * r;
    if (row >= n) continue;
    if (gridDim.y == 1)
      out[row] = kappa * acc[r];
    else
      part[(size_t)blockIdx.y * n + row] = acc[r];
  }
}

// out[i] = kappa * the sum of the ranges' partial sums, in order
__global__ void __launch_bounds__(256)
matvec_reduce_kernel(const float* __restrict__ part, int ranges, int n, float kappa,
                     float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = part[i];
  for (int r = 1; r < ranges; ++r) s += part[(size_t)r * n + i];
  out[i] = kappa * s;
}

// How a call is cut: DP features in registers, R rows a thread, the y tiles
// and how many ranges of `per` tiles they are split into.  The count of
// ranges is the one (the smallest, on a tie) whose busiest SM runs the
// fewest tile-steps: waves of BLOCKS_PER_SM blocks an SM times tiles a block.
struct Plan {
  int dp, rows, tiles, per, ranges;
  long long head_floats, part_floats;
};

int plan(int n, int m, int d, Plan* p) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  p->dp = head_features(d);
  p->rows = THREADS * rows_per_thread(p->dp);
  p->tiles = (m + TJ - 1) / TJ;
  const long long row_blocks = (n + p->rows - 1) / p->rows;
  const long long slots = (long long)BLOCKS_PER_SM * sms;
  long long best = -1;
  int ranges = 1;
  for (int s = 1; s <= p->tiles && s <= slots; ++s) {
    const long long per = (p->tiles + s - 1) / s;
    const long long cost = (row_blocks * s + slots - 1) / slots * per;
    if (best < 0 || cost < best) best = cost, ranges = s;
  }
  p->per = (p->tiles + ranges - 1) / ranges;
  p->ranges = (p->tiles + p->per - 1) / p->per;
  p->head_floats = (long long)p->tiles * TJ * (p->dp + 4);
  p->part_floats = p->ranges > 1 ? (long long)p->ranges * n : 0;
  return 0;
}

template <int SHAPE, int DP, bool TAIL>
void launch(const Plan& p, const float* x, const float* y, const float* yh, float* out,
            float* part, int n, int m, int d, float kappa, cudaStream_t s) {
  const dim3 grid((n + p.rows - 1) / p.rows, p.ranges);
  gram_matvec_kernel<SHAPE, DP, TAIL><<<grid, THREADS, 0, s>>>(x, y, yh, out, part, n, m, d,
                                                              p.per, p.tiles, kappa);
}

template <int SHAPE>
void launch_shape(const Plan& p, const float* x, const float* y, const float* yh, float* out,
                  float* part, int n, int m, int d, float kappa, cudaStream_t s) {
  if (d > DMAX)
    launch<SHAPE, DMAX, true>(p, x, y, yh, out, part, n, m, d, kappa, s);
  else if (p.dp == DMAX)
    launch<SHAPE, DMAX, false>(p, x, y, yh, out, part, n, m, d, kappa, s);
  else
    launch<SHAPE, 8, false>(p, x, y, yh, out, part, n, m, d, kappa, s);
}

}  // namespace

// Floats of scratch that stpy_gram_matvec takes at this shape (the padded
// points, then the ranges' partial sums); -1 if the device cannot be read.
extern "C" long long stpy_gram_matvec_scratch(int n, int m, int d) {
  Plan p;
  if (n <= 0 || m <= 0 || d <= 0 || plan(n, m, d, &p)) return -1;
  return p.head_floats + p.part_floats;
}

extern "C" int stpy_gram_matvec(const float* x, const float* y, const float* v, float* out,
                                float* scratch, int n, int m, int d, float kappa, int shape,
                                void* stream) {
  if (n <= 0 || m <= 0 || d <= 0 || shape < 0 || shape >= SHAPE_COUNT)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  if (int err = plan(n, m, d, &p)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* yh = scratch;
  float* part = scratch + p.head_floats;
  const int padded = p.tiles * TJ;
  pad_points_kernel<<<(padded + 255) / 256, 256, 0, s>>>(y, v, yh, m, d, p.dp, padded);
  dispatch_shape(shape, [&](auto code) {
    launch_shape<decltype(code)::value>(p, x, y, yh, out, part, n, m, d, kappa, s);
  });
  if (p.ranges > 1)
    matvec_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(part, p.ranges, n, kappa, out);
  return static_cast<int>(cudaGetLastError());
}
