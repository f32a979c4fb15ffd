// Lower Cholesky factor of one SPD leaf block of n <= 1024, in place, in one
// cooperative launch: A (n x n, leading dimension lda) is overwritten by L
// with L L^T = A and the strict upper triangle set to exactly 0.  Only the
// lower triangle of A is read.  Where a pivot is not positive, sqrtf gives
// NaN (or 1/0 gives inf), which spreads through the rest of the factor, so
// an indefinite input leaves non-finite entries for the jitter ladder's
// isfinite test.
//
// Replaces stpy_tpu/ops/pallas_chol.py:_chol_leaf_kernel (the pallas_call in
// chol_leaf).  The TPU kernel keeps the whole 1024^2 leaf (4 MB) in VMEM and
// factors it in 128-column panels with iota-one-hot masked rank-1 updates and
// a masked triangular inverse, because XLA's TPU Cholesky is latency-bound at
// leaf sizes.  On an H100 the leaf stays in device memory (it fits the 50 MB
// L2) and is cut into 32 x 32 tiles, one panel per 32 columns.
//
// What bounds it on an H100: not operations -- n^3/3 (0.36 GFLOP at
// n = 1024) take 5.3 us of the card's f32 rate -- but the chain of panels:
// each panel needs the one before it wholly applied, and each panel's own
// factor is a chain of 32 pivots.  One block would run that chain and every
// trailing update on one SM of 132.  Here every SM works on each panel, and
// the chain's cost is one grid barrier and one panel's critical path (the
// diagonal tile's update and factor, a row tile's update and solve) per 32
// columns.
//
// Design: a grid of G co-resident blocks of 256 threads, launched with
// cudaLaunchCooperativeKernel, G = one block an SM, capped by the most jobs
// one step offers.  The q = ceil(n / 32) tile columns go in
// q + 1 steps p = -1 .. q - 1, one grid barrier between steps
// (cooperative_groups::this_grid().sync()).  At the start of step p,
// panel p (tile column p, rows below its diagonal tile) is final and every
// tile right of it carries the updates of panels < p.  Step p, with
// c = p + 1:
//   * block 0 writes the diagonal tile L_pp, which it factored in step p - 1
//     and kept in shared memory (zeros above its diagonal);
//   * lookahead, one job per tile (i, c), i >= c, on blocks 0 .. q - c - 1:
//     update the diagonal tile (c, c) by panel p (A_cc - P_c P_c^T) and
//     factor it (factor_tile: one warp, a symmetric row a lane, one round
//     of shuffles and an rsqrt per column), every such block redundantly,
//     so no barrier separates the factor from its use; for i > c also
//     update tile (i, c) by panel p and solve its rows against L_cc by
//     forward substitution (solve_rows: a warp per four rows, a lane per
//     column), and write them: panel c is final.  Block 0 takes job i = c
//     and keeps L_cc;
//   * the trailing update on the other blocks, one job per lower tile
//     (i, j), i >= j > c: A_ij -= P_i P_j^T, both 32 x 32 operands staged in
//     shared memory, four entries a thread, each summed by fmaf over the
//     panel's 32 columns in order and subtracted once.
// Every entry is computed by one thread in a fixed order, and the redundant
// factors of L_cc are the same arithmetic: the same bits every run.  The
// strict upper tiles are zeroed once at the start; nothing reads them.  A
// ragged n is masked (the last tile row and column are narrower); no
// padding.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int NMAX = 1024;       // largest leaf
constexpr int TW = 32;           // panel width and tile edge
constexpr int LDT = TW + 1;      // row stride of a tile in shared memory
constexpr int NT = 256;          // threads per block

struct Tiles {
  float keep[TW][LDT];   // block 0: L_cc, factored in one step, written in the next
  float d[TW][LDT];      // the diagonal tile of a lookahead job
  float x[TW][LDT];      // the row tile of a lookahead job
  float pi[TW][LDT];     // panel rows of tile i
  float pj[TW][LDT];     // panel rows of tile j (of the diagonal tile in lookahead)
  float inv[TW];         // 1 / L_cc[k][k]
};

// t -> (bi, bj) with t = bi (bi + 1) / 2 + bj and 0 <= bj <= bi
__device__ __forceinline__ void lower_tile(int t, int& bi, int& bj) {
  int i = static_cast<int>((sqrtf(8.0f * static_cast<float>(t) + 1.0f) - 1.0f) * 0.5f);
  while (i * (i + 1) / 2 > t) --i;
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  bi = i;
  bj = t - i * (i + 1) / 2;
}

// A thread's entries of a staged tile: idx = tid + NT u, row idx / TW,
// column idx % TW.  All loads of a step are issued before any is stored, so
// they wait on device memory once.
constexpr int PER = TW * TW / NT;

// v[u] = A[r0 + r][c0 + k], 0 where r0 + r >= n, k >= kend or (lower) k > r
// (c0 + k < n is the caller's to know: panels left of the last are full)
__device__ __forceinline__ void fetch(float (&v)[PER], const float* A, int lda, int n,
                                      int r0, int c0, int kend, bool lower = false) {
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int idx = threadIdx.x + NT * u, r = idx / TW, k = idx % TW;
    v[u] = (r0 + r < n && k < kend && (!lower || k <= r))
               ? A[(size_t)(r0 + r) * lda + c0 + k] : 0.0f;
  }
}

__device__ __forceinline__ void put(float (*s)[LDT], const float (&v)[PER]) {
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int idx = threadIdx.x + NT * u;
    s[idx / TW][idx % TW] = v[u];
  }
}

// acc[u][v] = sum_k a[ty + 16u][k] b[tx + 16v][k], fmaf in ascending k
__device__ __forceinline__ void tile_products(const float (*a)[LDT],
                                              const float (*b)[LDT],
                                              float acc[2][2]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int v = 0; v < 2; ++v) acc[u][v] = 0.0f;
#pragma unroll
  for (int k = 0; k < TW; ++k) {
    const float a0 = a[ty][k], a1 = a[ty + 16][k];
    const float b0 = b[tx][k], b1 = b[tx + 16][k];
    acc[0][0] = fmaf(a0, b0, acc[0][0]);
    acc[0][1] = fmaf(a0, b1, acc[0][1]);
    acc[1][0] = fmaf(a1, b0, acc[1][0]);
    acc[1][1] = fmaf(a1, b1, acc[1][1]);
  }
}

// s[r][k] -= acc for this thread's four entries (k <= r only if lower)
__device__ __forceinline__ void subtract(float (*s)[LDT], const float acc[2][2],
                                         bool lower) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int r = ty + 16 * u, k = tx + 16 * v;
      if (!lower || k <= r) s[r][k] -= acc[u][v];
    }
}

// Factor the w x w tile d (lower triangle; entries above it are 0) in place
// with warp 0: lane r holds the whole symmetric row r in registers (its
// upper part read from column r).  For column c one batch of independent
// shuffles brings the column's current values to every lane, which forms
// the pivot's reciprocal square root and every l_k = a_kc / pivot itself,
// then drops l_r l_k from its entries k > c: one shuffle round and one
// rsqrt per column on the chain, the shortest of the layouts measured.
// Also inv[c] = 1 / pivot.  A pivot <= 0 gives NaN or inf.
__device__ __forceinline__ void factor_tile(float (*d)[LDT], float* inv, int w) {
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);   // warp-uniform
  if (warp != 0) return;
  const int r = threadIdx.x % 32;
  float row[TW];
#pragma unroll
  for (int k = 0; k < TW; ++k) row[k] = k <= r ? d[r][k] : d[k][r];
  __syncwarp();
#pragma unroll
  for (int c = 0; c < TW; ++c) {
    if (c < w) {
      float v[TW];
#pragma unroll
      for (int k = c; k < TW; ++k) v[k] = __shfl_sync(0xffffffffu, row[c], k);
      const float iv = rsqrtf(v[c]);
      const float piv = v[c] * iv;
      const float l = r == c ? piv : row[c] * iv;
      if (r >= c) d[r][c] = l;
      if (r == 0) inv[c] = iv;
#pragma unroll
      for (int k = c + 1; k < TW; ++k) row[k] = fmaf(-l, v[k] * iv, row[k]);
    }
  }
}

// Solve the rows of x against the factored tile d (x <- x L^-T): warp v
// owns rows 4v .. 4v + 3, lane j column j; for column c each row's
// l = x[.][c] / L[c][c] comes by shuffle from lane c, and lanes j > c lose
// l * L[j][c].  Selects, not branches, keep the chain to one shuffle.
__device__ __forceinline__ void solve_rows(float (*x)[LDT], const float (*d)[LDT],
                                           const float* inv, int w) {
  constexpr int ROWS = TW / (NT / 32);
  const int j = threadIdx.x % 32, r0 = ROWS * (threadIdx.x / 32);
  float xv[ROWS];
#pragma unroll
  for (int u = 0; u < ROWS; ++u) xv[u] = x[r0 + u][j];
#pragma unroll 1
  for (int c = 0; c < w; ++c) {
    const bool own = j == c, lose = j > c && j < w;
    const float ljc = d[j][c], ivc = inv[c];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      const float l = __shfl_sync(0xffffffffu, xv[u], c) * ivc;
      const float f = fmaf(-l, ljc, xv[u]);
      xv[u] = own ? l : xv[u];
      xv[u] = lose ? f : xv[u];
    }
  }
#pragma unroll
  for (int u = 0; u < ROWS; ++u) x[r0 + u][j] = xv[u];
}

__global__ void __launch_bounds__(NT)
chol_leaf_kernel(float* A, int n, int lda) {
  __shared__ Tiles sm;
  const int q = (n + TW - 1) / TW;
  const int G = gridDim.x, tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();

  // the strict upper tiles, (row, col) = (bj, bi + 1)
  for (int t = blockIdx.x; t < q * (q - 1) / 2; t += G) {
    int bi, bj;
    lower_tile(t, bi, bj);
    const int r0 = bj * TW, c0 = (bi + 1) * TW;
    for (int idx = tid; idx < TW * TW; idx += NT) {
      const int r = r0 + idx / TW, k = c0 + idx % TW;
      if (k < n) A[(size_t)r * lda + k] = 0.0f;
    }
  }

  for (int p = -1; p < q; ++p) {
    if (p >= 0 && blockIdx.x == 0) {
      // L_pp, with zeros above its diagonal
      const int r0 = p * TW;
      for (int idx = tid; idx < TW * TW; idx += NT) {
        const int r = idx / TW, k = idx % TW;
        if (r0 + r < n && r0 + k < n)
          A[(size_t)(r0 + r) * lda + r0 + k] = k <= r ? sm.keep[r][k] : 0.0f;
      }
      __syncthreads();   // keep is rewritten below
    }
    if (p == q - 1) break;
    const int c = p + 1, cw = min(TW, n - c * TW);
    const int look = q - c;                     // lookahead jobs: tiles (c..q-1, c)
    const int rest = q - c - 1;
    const int bulk = p >= 0 ? rest * (rest + 1) / 2 : 0;
    // lookahead jobs on the first blocks, the trailing update on the others
    // (on all, where the grid has no more blocks than lookahead jobs)
    for (int job = blockIdx.x; job < look; job += G) {
      const int i = c + job;
      float (*d)[LDT] = job == 0 ? sm.keep : sm.d;
      // the diagonal tile's lower triangle (0 above it and past n), the row
      // tile, and both tiles' panel rows
      float dv[PER], xv[PER], pjv[PER], piv[PER];
      fetch(dv, A, lda, n, c * TW, c * TW, cw, true);
      if (job > 0) fetch(xv, A, lda, n, i * TW, c * TW, cw);
      if (p >= 0) {
        fetch(pjv, A, lda, n, c * TW, p * TW, TW);
        if (job > 0) fetch(piv, A, lda, n, i * TW, p * TW, TW);
      }
      put(d, dv);
      if (job > 0) put(sm.x, xv);
      if (p >= 0) {
        put(sm.pj, pjv);
        if (job > 0) put(sm.pi, piv);
      }
      __syncthreads();
      if (p >= 0) {
        float acc[2][2];
        tile_products(sm.pj, sm.pj, acc);
        subtract(d, acc, true);
        if (job > 0) {
          tile_products(sm.pi, sm.pj, acc);
          subtract(sm.x, acc, false);
        }
        __syncthreads();
      }
      factor_tile(d, sm.inv, cw);
      __syncthreads();
      if (job > 0) {
        solve_rows(sm.x, d, sm.inv, cw);
        __syncthreads();
        for (int idx = tid; idx < TW * TW; idx += NT) {
          const int r = idx / TW, k = idx % TW;
          if (i * TW + r < n && k < cw)
            A[(size_t)(i * TW + r) * lda + c * TW + k] = sm.x[r][k];
        }
      }
      __syncthreads();   // the next job restages the tiles
    }
    const int b0 = G > look ? look : 0;
    for (int b = blockIdx.x - b0; b >= 0 && b < bulk; b += G - b0) {
      int bi, bj;
      lower_tile(b, bi, bj);
      const int i = c + 1 + bi, j = c + 1 + bj;
      float piv[PER], pjv[PER];
      fetch(piv, A, lda, n, i * TW, p * TW, TW);
      if (i != j) fetch(pjv, A, lda, n, j * TW, p * TW, TW);
      put(sm.pi, piv);
      if (i != j) put(sm.pj, pjv);
      __syncthreads();
      float acc[2][2];
      tile_products(sm.pi, i != j ? sm.pj : sm.pi, acc);
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int r = i * TW + ty + 16 * u, k = j * TW + tx + 16 * v;
          if (r < n && k < n && (i != j || k <= r)) A[(size_t)r * lda + k] -= acc[u][v];
        }
      __syncthreads();   // the next job restages the tiles
    }
    grid.sync();
  }
}

// Blocks of the cooperative launch for an n-leaf: one on each SM (the
// occupancy check says at least one fits), capped by the most jobs one step
// offers (step 0's q (q - 1) / 2, step -1's q).  Two blocks an SM fit, but
// a lookahead block that shares its SM with a trailing-update block slows
// the panel chain: 0.35 ms against 0.30 at n = 1024 on an H100.
int leaf_grid(int n, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chol_leaf_kernel, NT, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q = (n + TW - 1) / TW;
  const int work = q * (q - 1) / 2 > q ? q * (q - 1) / 2 : q;
  const int fit = per_sm > 0 ? sms : 0;
  *grid = fit < work ? fit : work;
  return *grid > 0 ? static_cast<int>(cudaSuccess)
                   : static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
}

}  // namespace

// The grid size stpy_chol_leaf launches for an n-leaf on the current device
// (negative: minus the CUDA error).
extern "C" int stpy_chol_leaf_grid(int n) {
  int grid = 0;
  const int err = leaf_grid(n < 1 ? 1 : n, &grid);
  return err ? -err : grid;
}

extern "C" int stpy_chol_leaf(float* A, int n, int lda, void* stream) {
  if (n < 0 || n > NMAX || lda < n) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  int grid = 0;
  const int err = leaf_grid(n, &grid);
  if (err) return err;
  void* args[] = {&A, &n, &lda};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(chol_leaf_kernel), dim3(grid), dim3(NT), args, 0,
      static_cast<cudaStream_t>(stream)));
}
