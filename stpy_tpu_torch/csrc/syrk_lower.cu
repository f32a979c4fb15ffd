// Lower-triangle symmetric rank-k update, in place, float32 in and out:
//   C[i, j] <- C[i, j] - sum_p W[i, p] W[j, p]   for every i >= j,
// C an (m x m) view with leading dimension ldc, W (m x k) with ldw.  The
// strict upper triangle of C is neither read nor written.
//
// Replaces stpy_tpu/ops/pallas_syrk.py:_syrk_lower_kernel (the pallas_call in
// syrk_update_lower), the trailing update of the blocked Cholesky
// chol_blocked_syrk.  The TPU kernel splits W into bf16 halves and runs three
// bf16 MXU passes per tile, hi.hi + hi.lo + lo.hi (v5e has no f32 matrix
// mode), over a sequential (p, p, k) grid, carrying its sum in VMEM scratch
// across k and copying the upper tiles through.  Here the halves are TF32
// (11-bit, against bf16's 8) and the same three terms run on the tensor
// cores, so the product is finer than the reference's; only the lower tiles
// are computed.
//
// What bounds it on an H100: m(m+1)/2 entries times 2k operations against
// reading W once and the lower half of C once each way.  At the fast
// factor's first step (m = 14336, k = 2048) that is 0.42 TFLOP against
// 1.0 GB: 6.3 ms on the f32 pipes, 2.55 ms in three TF32 passes on the
// tensor cores.  The operands are the catch: a 128 x 128 tile reads 256
// rows of W's split (8 bytes an element), 26.5 GB over the 6328 lower tiles
// at that shape, so the tiles that run together must share W's rows in L2.
//
// Design, two kernels of one call:
//   * split_w_kernel writes W's TF32 (hi, lo) by to_tf32's rounding
//     (wgmma_tf32.cuh), one contiguous 16 KB block per 128-row band and
//     32-deep k-tile in the tensor cores' K-major core-matrix order (the
//     layout of gram_matmat.cu's split_v_kernel); rows past m and k past k
//     are 0, so ragged edges need no masks in the product.
//   * syrk_lower_kernel: one persistent block per SM walks the lower tiles
//     (bi, bj) in a grouped order: GROUP row bands at a time, column by
//     column, so the ~132 tiles in flight together touch ~25 bands of W
//     and each k-tile of a band is read from device memory about once.
//     One thread of a producer warpgroup keeps a ring of STAGES k-tiles
//     (Wh, Wl of band bi, then of band bj; a diagonal tile loads its band
//     once) in flight with cp.async.bulk on mbarriers, running ahead into
//     the next tile.  Two consumer warpgroups own the tile's 64-row halves:
//     per 8-deep k-step three wgmma.m64n128k8.f32.tf32.tf32 with both
//     operands from shared memory, Ah.Bh + Ah.Bl + Al.Bh.  Each k-tile's
//     wgmmas are waited for before the next are issued and its stage is
//     released at once, by all 256 consumer threads: a release by one lane
//     puts a branch between wgmma groups, and ptxas then serializes every
//     wgmma (warning C7518), and waiting one group later would hold each
//     stage a k-tile longer.  The tensor cores' f32 accumulation does not
//     round to nearest, so each CHUNK of k-tiles (256 of k) is summed in a
//     fresh accumulator and added in f32 to a per-thread total in
//     registers (one accumulator over all of k is slightly faster and
//     several times less accurate); the epilogue subtracts the totals from
//     C on the entries i >= j, i < m, by direct loads and stores (C's bytes
//     are 0.28 ms of the bound).
// Each entry is summed by one thread in a fixed order with no atomics, so
// two launches give the same bits.
#include <cuda_runtime.h>

#include <stdint.h>

#include "async_copy.cuh"
#include "wgmma_tf32.cuh"

namespace {

constexpr int TM = 128;             // rows of a band of W, rows and columns of a tile
constexpr int TK = 32;              // depth of one k-tile
constexpr int TILE = TM * TK;       // floats of one operand's k-tile (16 KB)
constexpr int STAGES = 3;           // ring depth: 3 x (Ah, Al, Bh, Bl) = 192 KB
constexpr int STAGE_FLOATS = 4 * TILE;
constexpr int CHUNK = 8;            // k-tiles summed on the tensor cores per f32 add
constexpr int GROUP = 8;            // row bands of the grouped tile order
constexpr int NCW = 8;              // consumer warps (two warpgroups)
constexpr int NT = 32 * (NCW + 4);  // plus the producer warpgroup

// the t-th lower tile (bi >= bj) of a p x p grid of tiles in the grouped
// order: row bands [r0, r0 + h) with r0 a multiple of GROUP, taken column by
// column (bj = 0 .. r0 + h - 1), the rows bi >= bj of the group in each
__device__ __forceinline__ void tile_of(int t, int p, int& bi, int& bj) {
  int r0 = 0;
  while (r0 + GROUP < p && (r0 + GROUP) * (r0 + GROUP + 1) / 2 <= t) r0 += GROUP;
  const int h = min(GROUP, p - r0);
  int u = t - r0 * (r0 + 1) / 2;
  if (u < r0 * h) {   // the full columns left of the group's diagonal block
    bj = u / h;
    bi = r0 + u % h;
    return;
  }
  u -= r0 * h;        // the group's own lower triangle, column by column
  int c = 0;
  while (u >= h - c) {
    u -= h - c;
    ++c;
  }
  bj = r0 + c;
  bi = bj + u;
}

// W (m x k, row stride ldw) -> its TF32 (hi, lo) k-tiles, one block a
// (k-tile, band): element (row 8 nb + ni, k 8 ks + 4 kb + ki) of the block at
// ks * 1024 + nb * 64 + kb * 32 + ni * 4 + ki
__global__ void __launch_bounds__(256)
split_w_kernel(const float* __restrict__ W, float* __restrict__ wh, float* __restrict__ wl,
               int m, int k, int ldw, int kt) {
  __shared__ float ws[TM][TK + 4];   // 4 of padding: the reads below are conflict-free
  const int kk = blockIdx.x, band = blockIdx.y, tid = threadIdx.x;
  for (int idx = tid; idx < TM * TK; idx += 256) {
    const int r = idx / TK, c = idx % TK;
    const int row = band * TM + r, col = kk * TK + c;
    ws[r][c] = (row < m && col < k) ? W[(size_t)row * ldw + col] : 0.0f;
  }
  __syncthreads();
  const size_t base = ((size_t)band * kt + kk) * TILE;
  for (int off = tid; off < TILE; off += 256) {
    const int ks = off / 1024, nb = (off / 64) % 16, kb = (off / 32) % 2;
    const int ni = (off / 4) % 8, ki = off % 4;
    const float v = ws[8 * nb + ni][8 * ks + 4 * kb + ki];
    const float hi = __uint_as_float(to_tf32(v));
    wh[base + off] = hi;
    wl[base + off] = __uint_as_float(to_tf32(v - hi));
  }
}

__global__ void __launch_bounds__(NT, 1)
syrk_lower_kernel(float* __restrict__ C, const float* __restrict__ wh,
                  const float* __restrict__ wl, int m, int ldc, int p, int kt, int tiles) {
  extern __shared__ __align__(128) float ring[];   // STAGES x (Ah, Al, Bh, Bl)
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 32 * NCW);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {   // producer warpgroup: one thread issues the copies
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int bi, bj;
        tile_of(t, p, bi, bj);
        const size_t a = (size_t)bi * kt * TILE, b = (size_t)bj * kt * TILE;
        const bool diag = bi == bj;
        const uint32_t bytes = (diag ? 2 : 4) * TILE * sizeof(float);
        for (int kk = 0; kk < kt; ++kk, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
          float* dst = ring + s * STAGE_FLOATS;
          const size_t off = (size_t)kk * TILE;
          mbar_expect_tx(&full[s], bytes);
          bulk_copy(dst, wh + a + off, TILE * sizeof(float), &full[s]);
          bulk_copy(dst + TILE, wl + a + off, TILE * sizeof(float), &full[s]);
          if (!diag) {
            bulk_copy(dst + 2 * TILE, wh + b + off, TILE * sizeof(float), &full[s]);
            bulk_copy(dst + 3 * TILE, wl + b + off, TILE * sizeof(float), &full[s]);
          }
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");

  // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile; a
  // thread's accumulator entry 4c + 2h + e is row 16 (warp % 4) + g + 8h of
  // those, column 8c + 2t + e
  const int ct = threadIdx.x - 128, wg = ct / 128, warp = ct / 32, lane = ct % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int rl = 64 * wg + 16 * (warp % 4) + g;
  float acc[64], tot[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    int bi, bj;
    tile_of(t, p, bi, bj);
    const bool diag = bi == bj;
#pragma unroll
    for (int i = 0; i < 64; ++i) tot[i] = 0.0f;
    for (int kk = 0; kk < kt; ++kk, ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const uint32_t base = smem_u32(ring + s * STAGE_FLOATS);
      const uint32_t ahi = base + wg * 64 * 8 * sizeof(float);   // 64 rows on
      const uint32_t alo = ahi + TILE * sizeof(float);
      const uint32_t bhi = diag ? base : base + 2 * TILE * sizeof(float);
      const uint32_t blo = bhi + TILE * sizeof(float);
      const int keep = kk % CHUNK != 0;
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint32_t step = ks * 8 * TM * sizeof(float);   // 8 of k, 128 rows
        wgmma_tf32_ss(acc, kmajor_desc(ahi + step), kmajor_desc(bhi + step), ks > 0 || keep);
        wgmma_tf32_ss(acc, kmajor_desc(ahi + step), kmajor_desc(blo + step), 1);
        wgmma_tf32_ss(acc, kmajor_desc(alo + step), kmajor_desc(bhi + step), 1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_acc(acc);
      mbar_arrive(&empty[s]);   // by every thread: no branch between wgmmas
      if (kk % CHUNK == CHUNK - 1 || kk == kt - 1) {
#pragma unroll
        for (int i = 0; i < 64; ++i) tot[i] += acc[i];
      }
    }

    const int row0 = bi * TM + rl, col0 = bj * TM + 2 * t4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= m) continue;
      float* crow = C + (size_t)row * ldc;
#pragma unroll
      for (int c = 0; c < 16; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + 8 * c + e;
          if (col <= row) crow[col] -= tot[4 * c + 2 * h + e];
        }
    }
  }
}

}  // namespace

// wh, wl: scratch of ceil(m / 128) * ceil(k / 32) * 4096 floats each
extern "C" int stpy_syrk_lower(float* C, const float* W, float* wh, float* wl, int m, int k,
                               int ldc, int ldw, void* stream) {
  if (m < 0 || k < 0 || ldc < m || ldw < k) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || k == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int p = (m + TM - 1) / TM, kt = (k + TK - 1) / TK;
  split_w_kernel<<<dim3(kt, p), 256, 0, s>>>(W, wh, wl, m, k, ldw, kt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // above 48 KB of dynamic shared memory a kernel must opt in
  const int bytes = STAGES * STAGE_FLOATS * sizeof(float);
  err = cudaFuncSetAttribute(syrk_lower_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = p * (p + 1) / 2;
  syrk_lower_kernel<<<tiles < sms ? tiles : sms, NT, bytes, s>>>(C, wh, wl, m, ldc, p, kt, tiles);
  return static_cast<int>(cudaGetLastError());
}
