// Matrix-free multi-RHS Gram product out = K(x, y) V, V of shape (m, r),
// K[i, j] = kappa * shape(|x_i - y_j|^2) never stored.
//
// Replaces stpy_tpu/ops/pallas_gram_matvec.py:_gram_matmat_kernel (the
// pallas_call in _gram_matmat_pallas) in all three of its shapes: the kernel
// "k" and the derivative shapes "dk_sq" = k'(sq) sq and "dk" = k'(sq)
// (codes 0-11 of gram_shape.cuh, one template instance each; both
// derivatives are <= 0, and the TF32 split takes either sign).  The
// coordinates arrive already scaled by 1/gamma, as in
// pallas_gram_matvec.gram_matmat.
//
// What bounds it on an H100: per (i, j) pair 2d f32 operations and one or
// two special functions for the entry, and 2r for the product with V's row
// j.  At r = 128 the product is ~90 % of the work.  On the f32 FMA pipes
// it alone would need 17.6 ms per atom at n = m = 65536, d = 8; on the
// TF32 tensor cores, at three passes, 6.7 ms.  The TPU kernel
// runs the product at Precision.HIGHEST, and one TF32 pass misses the f32
// bar (2 sqrt(m) eps32 of sum_j |K_ij| |V_jc|) by 30x, so each operand is
// split into TF32 hi + lo (a = hi + lo + O(2^-22 a)) and the product is
// Kh Vh + Kh Vl + Kl Vh, the dropped Kl Vl being 2^-22 relative.  Each
// product so errs by a few 2^-22 relative, against 2^-24 for an f32 FMA:
// summed over dozens of points or more the error stays within
// 2 sqrt(m) eps32 of sum_j |K_ij| |V_jc| (chip_smoke.py phase 2c's bar), but
// over a handful of points it can exceed that bar (the f32 entries' own
// rounding, a few ulps of |x|^2 + |y|^2 in sq, exceeds it there too, in any
// f32 kernel of these entries).  As built, the Gram entries (expf, the FMA
// chain and the split, ~30 operations each) take longer than the tensor
// cores' three passes, and the two overlap only in part.
//
// Design, three kernels of one call:
//   * split_v_kernel writes V's TF32 (hi, lo) transposed, in the order the
//     tensor cores read B: for each 128-column slab and 32-row tile of V a
//     contiguous 16 KB block of 8 x 4 "core matrices" (wgmma's K-major
//     layout without swizzle: 128 contiguous bytes each, the next along K
//     128 bytes on, the next 8 columns 256 bytes on), so one bulk copy
//     moves a tile.  Columns past r and rows past m are 0.
//   * pad_y_kernel writes y's 32-point tiles feature-major, the points'
//     squared norms (gram.cu's FMA chain) as a first row.
//   * gram_matmat_kernel: a block owns 128 rows of x and one 128-column
//     slab.  One thread of a producer warpgroup (its registers cut to 40 by
//     setmaxnreg) keeps a ring of up to 4 stages (Vh, Vl and y tiles, 33 KB
//     at d = 8) in flight with cp.async.bulk, each stage's arrival on a
//     full mbarrier, its release on an empty one.  A stage holds a y tile's
//     norms and first YSTAGE features; the consumers read any further ones
//     from pad_y_kernel's copy in global memory.  Two consumer warpgroups
//     (232 registers) own 64 rows each.  Per 32-point y tile each consumer
//     thread computes the 16 Gram entries its wgmma A fragments hold (rows
//     g and g + 8 of its warp's 16, columns t and t + 4 of each 8-point
//     k-step, with g = lane / 4, t = lane % 4; x's first 8 features in
//     registers) with gram.cu's FMA chain, sq_from_chain and shape_fn,
//     splits each into TF32 (hi, lo) by cvt.rna.tf32.f32's rounding, and
//     issues wgmma.m64n128k8.f32.tf32.tf32 three times per k-step with A
//     from registers: the Gram tile never touches shared memory.  The next
//     tile's entries are computed while this tile's wgmmas run.
//   * The tensor cores' f32 accumulation does not round to nearest, so a
//     sum over all of m would drift: each 256-point chunk of y is summed in
//     a fresh accumulator (scale-d = 0 on its first wgmma) and added in f32
//     to a per-thread total in shared memory, which the epilogue writes
//     once, ragged rows and columns masked.
// A block owns one 128-column slab, so at r > 128 every slab's blocks
// compute the same Gram entries again: r = 576 (the ARD trace term's
// probes (2d + 1) at d = 4, 64 probes) computes each entry five times.
// No atomics and a fixed order, so a rerun gives the same bits.  Ragged n,
// m, r and d are masked, not padded; any d: two stages of y tiles of up to
// YSTAGE features fit the block's 227 KB of shared memory beside the totals.
#include <cuda_runtime.h>

#include <stdint.h>

#include "async_copy.cuh"
#include "gram_shape.cuh"
#include "wgmma_tf32.cuh"

namespace {

constexpr int BM = 128;            // rows of x per block
constexpr int BN = 128;            // columns of V per block (one slab)
constexpr int TK = 32;             // y points per tile
constexpr int TILE = BN * TK;      // floats of one operand's tile (16 KB)
constexpr int MAX_STAGES = 4;      // ring depth, less where the y tiles are wide
constexpr int CHUNK = 8;           // tiles summed on the tensor cores per f32 add
constexpr int XREG = 8;            // features of x a consumer keeps in registers
constexpr int NCW = 8;             // consumer warps (two warpgroups)
constexpr int NT = 32 * (NCW + 4); // plus the producer warpgroup
constexpr int TOTALS = 64 * 32 * NCW;   // the consumers' f32 totals (floats)
constexpr int YSTAGE = 384;        // most features of a y tile staged in the ring

// V (m x r, row-major) -> its TF32 (hi, lo) tiles, one block a (tile, slab)
__global__ void __launch_bounds__(256)
split_v_kernel(const float* __restrict__ V, float* __restrict__ vth, float* __restrict__ vtl,
               int m, int r, int mt) {
  __shared__ float vs[TK][BN + 1];
  const int jt = blockIdx.x, slab = blockIdx.y, tid = threadIdx.x;
  for (int idx = tid; idx < TK * BN; idx += 256) {
    const int kk = idx / BN, nn = idx % BN;
    const int j = jt * TK + kk, c = slab * BN + nn;
    vs[kk][nn] = (j < m && c < r) ? V[(size_t)j * r + c] : 0.0f;
  }
  __syncthreads();
  const size_t base = ((size_t)slab * mt + jt) * TILE;
  for (int off = tid; off < TILE; off += 256) {
    // off = ks * 1024 + nb * 64 + kb * 32 + ni * 4 + ki
    const int ks = off / 1024, nb = (off / 64) % 16, kb = (off / 32) % 2;
    const int ni = (off / 4) % 8, ki = off % 4;
    const float v = vs[8 * ks + 4 * kb + ki][8 * nb + ni];
    const float hi = __uint_as_float(to_tf32(v));
    vth[base + off] = hi;
    vtl[base + off] = __uint_as_float(to_tf32(v - hi));
  }
}

// y (m x d) -> one block per 32-point tile, feature-major: row 0 holds the
// 32 points' squared norms by gram.cu's FMA chain, row k + 1 their feature
// k; point t + 4 q of the tile sits at column 8 t + q, so the 8 points of a
// consumer thread's fragments are two float4 reads.  0 past m.
__global__ void __launch_bounds__(TK)
pad_y_kernel(const float* __restrict__ y, float* __restrict__ yt, int m, int d) {
  const int jl = threadIdx.x, j = blockIdx.x * TK + jl;
  float* tile = yt + (size_t)blockIdx.x * TK * (d + 1) + 8 * (jl % 4) + jl / 4;
  float ny = 0.0f;
  for (int k = 0; k < d; ++k) {
    const float b = j < m ? y[(size_t)j * d + k] : 0.0f;
    ny = fmaf(b, b, ny);
    tile[(k + 1) * TK] = b;
  }
  tile[0] = ny;
}

// The 16 Gram entries of a consumer thread's A fragments for y tile jt,
// split into TF32 (hi, lo): tile point t + 4 q (q < 8), rows x0 (fragment
// slots 0, 2) and x1 (slots 1, 3); k-step q / 2 holds a0 (g, t),
// a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4).  xr0, xr1: the rows'
// first XREG features; ys: the tile's norms and first ds features in shared
// memory, yg: the whole tile in global memory (pad_y_kernel's layout).
template <int SHAPE>
__device__ __forceinline__ void gram_fragments(const float (&xr0)[XREG], const float (&xr1)[XREG],
                                               const float* __restrict__ x0,
                                               const float* __restrict__ x1, float nx0,
                                               float nx1, const float* ys,
                                               const float* __restrict__ yg, int m, int d, int ds,
                                               int jt, int t, float kappa, uint32_t (&ah)[4][4],
                                               uint32_t (&al)[4][4]) {
  float dot0[8], dot1[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) dot0[q] = dot1[q] = 0.0f;
  const float* yp = ys + 8 * t + TK;   // feature k at yp + k * TK
#pragma unroll
  for (int k = 0; k < XREG; ++k) {
    if (k < d) {
      const float4 b0 = *reinterpret_cast<const float4*>(yp + k * TK);
      const float4 b1 = *reinterpret_cast<const float4*>(yp + k * TK + 4);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        dot0[q] = fmaf(xr0[k], b[q], dot0[q]);
        dot1[q] = fmaf(xr1[k], b[q], dot1[q]);
      }
    }
  }
  for (int k = XREG; k < ds; ++k) {
    const float a0 = x0[k], a1 = x1[k];
    const float4 b0 = *reinterpret_cast<const float4*>(yp + k * TK);
    const float4 b1 = *reinterpret_cast<const float4*>(yp + k * TK + 4);
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      dot0[q] = fmaf(a0, b[q], dot0[q]);
      dot1[q] = fmaf(a1, b[q], dot1[q]);
    }
  }
  const float* gp = yg + 8 * t + TK;
  for (int k = ds > XREG ? ds : XREG; k < d; ++k) {   // past the staged features
    const float a0 = x0[k], a1 = x1[k];
    const float4 b0 = __ldg(reinterpret_cast<const float4*>(gp + k * TK));
    const float4 b1 = __ldg(reinterpret_cast<const float4*>(gp + k * TK + 4));
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      dot0[q] = fmaf(a0, b[q], dot0[q]);
      dot1[q] = fmaf(a1, b[q], dot1[q]);
    }
  }
  const float4 n0 = *reinterpret_cast<const float4*>(ys + 8 * t);
  const float4 n1 = *reinterpret_cast<const float4*>(ys + 8 * t + 4);
  const float ny[8] = {n0.x, n0.y, n0.z, n0.w, n1.x, n1.y, n1.z, n1.w};
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    // every entry evaluated (the tile's padding is finite), then masked:
    // no branch in the way of the 16 entries' interleaving
    const bool live = jt * TK + t + 4 * q < m;
    float e0 = kappa * shape_fn<SHAPE>(sq_from_chain(nx0, ny[q], dot0[q]));
    float e1 = kappa * shape_fn<SHAPE>(sq_from_chain(nx1, ny[q], dot1[q]));
    e0 = live ? e0 : 0.0f;
    e1 = live ? e1 : 0.0f;
    const int kk = q / 2, c = 2 * (q % 2);
    ah[kk][c] = to_tf32(e0);
    ah[kk][c + 1] = to_tf32(e1);
    al[kk][c] = to_tf32(e0 - __uint_as_float(ah[kk][c]));
    al[kk][c + 1] = to_tf32(e1 - __uint_as_float(ah[kk][c + 1]));
  }
}

template <int SHAPE>
__global__ void __launch_bounds__(NT, 1)
gram_matmat_kernel(const float* __restrict__ x, const float* __restrict__ yt,
                   const float* __restrict__ vth, const float* __restrict__ vtl,
                   float* __restrict__ out, int n, int m, int d, int ds, int r, int mt,
                   int stages, float kappa) {
  // the consumers' f32 totals, then `stages` x (Vh tile, Vl tile, y tile's
  // first ds + 1 rows)
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES];
  const int ytile = TK * (d + 1), ystaged = TK * (ds + 1), stage_floats = 2 * TILE + ystaged;
  float* ring = smem + TOTALS;
  const int row0 = blockIdx.x * BM, slab = blockIdx.y;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NCW);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {   // producer warpgroup: one thread issues the copies
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (threadIdx.x == 0) {
      const float* gh = vth + (size_t)slab * mt * TILE;
      const float* gl = vtl + (size_t)slab * mt * TILE;
      for (int jt = 0; jt < mt; ++jt) {
        const int s = jt % stages;
        if (jt >= stages) mbar_wait(&empty[s], ((jt / stages) - 1) & 1);
        float* dst = ring + s * stage_floats;
        mbar_expect_tx(&full[s], stage_floats * sizeof(float));
        bulk_copy(dst, gh + (size_t)jt * TILE, TILE * sizeof(float), &full[s]);
        bulk_copy(dst + TILE, gl + (size_t)jt * TILE, TILE * sizeof(float), &full[s]);
        bulk_copy(dst + 2 * TILE, yt + (size_t)jt * ytile, ystaged * sizeof(float), &full[s]);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");

  // consumers: rows i0 = g, i1 = g + 8 of this warp's 16 of the block's 128
  const int ct = threadIdx.x - 128, warp = ct / 32, lane = ct % 32;
  const int g = lane / 4, t = lane % 4;
  const int i0 = row0 + 16 * warp + g, i1 = i0 + 8;
  const float* x0 = x + (size_t)min(i0, n - 1) * d;
  const float* x1 = x + (size_t)min(i1, n - 1) * d;
  float nx0 = 0.0f, nx1 = 0.0f, xr0[XREG], xr1[XREG];
  for (int k = 0; k < d; ++k) {
    const float a0 = x0[k], a1 = x1[k];
    nx0 = fmaf(a0, a0, nx0);
    nx1 = fmaf(a1, a1, nx1);
  }
#pragma unroll
  for (int k = 0; k < XREG; ++k) {
    xr0[k] = k < d ? x0[k] : 0.0f;
    xr1[k] = k < d ? x1[k] : 0.0f;
  }
  float* tot = smem + ct;   // this thread's 64 totals, stride 256
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    acc[i] = 0.0f;
    tot[i * 32 * NCW] = 0.0f;
  }

  // Tile jt's wgmmas read (ah, al) while the next tile's fragments go into
  // (nh, nl), so the Gram entries are computed under the tensor cores' work.
  auto step = [&](int jt, uint32_t(&ah)[4][4], uint32_t(&al)[4][4], uint32_t(&nh)[4][4],
                  uint32_t(&nl)[4][4]) {
    const int s = jt % stages;
    const uint32_t hi = smem_u32(ring + s * stage_floats);
    const uint32_t lo = hi + TILE * sizeof(float);
    const int keep = jt % CHUNK != 0;
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t kstep = kk * 8 * BN * sizeof(float);   // 8 y of 128 columns
      wgmma_tf32(acc, ah[kk], kmajor_desc(hi + kstep), kk > 0 || keep);
      wgmma_tf32(acc, ah[kk], kmajor_desc(lo + kstep), 1);
      wgmma_tf32(acc, al[kk], kmajor_desc(hi + kstep), 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    if (jt + 1 < mt) {
      const int sn = (jt + 1) % stages;
      mbar_wait(&full[sn], ((jt + 1) / stages) & 1);
      gram_fragments<SHAPE>(xr0, xr1, x0, x1, nx0, nx1, ring + sn * stage_floats + 2 * TILE,
                            yt + (size_t)(jt + 1) * ytile, m, d, ds, jt + 1, t, kappa, nh, nl);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (jt % CHUNK == CHUNK - 1 || jt == mt - 1) {
#pragma unroll
      for (int i = 0; i < 64; ++i) tot[i * 32 * NCW] += acc[i];
    }
  };
  uint32_t ah0[4][4], al0[4][4], ah1[4][4], al1[4][4];
  mbar_wait(&full[0], 0);
  gram_fragments<SHAPE>(xr0, xr1, x0, x1, nx0, nx1, ring + 2 * TILE, yt, m, d, ds, 0, t, kappa,
                        ah0, al0);
  for (int jt = 0; jt < mt; jt += 2) {
    step(jt, ah0, al0, ah1, al1);
    if (jt + 1 < mt) step(jt + 1, ah1, al1, ah0, al0);
  }

  // accumulator layout: total 4c + 2h + e is row i0 + 8h, column 8c + 2t + e
  const int col0 = slab * BN + 2 * t;
#pragma unroll
  for (int c = 0; c < 16; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = h ? i1 : i0;
      if (row >= n) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col0 + 8 * c + e;
        if (col < r) out[(size_t)row * r + col] = tot[(4 * c + 2 * h + e) * 32 * NCW];
      }
    }
}

// ring depth for y tiles of ds staged features: as many stages (at most
// MAX_STAGES) as the block's shared memory holds beside the totals; 0 if
// not two
int ring_stages(int ds, int* bytes) {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  const long long stage = (2LL * TILE + TK * (ds + 1LL)) * sizeof(float);
  const long long fixed = TOTALS * (long long)sizeof(float);
  int s = static_cast<int>((limit - 1024LL - fixed) / stage);
  s = s > MAX_STAGES ? MAX_STAGES : s;
  *bytes = static_cast<int>(fixed + s * stage);
  return s >= 2 ? s : 0;
}

template <int SHAPE>
int launch(const float* x, const float* yt, const float* vth, const float* vtl, float* out,
           int n, int m, int d, int r, int mt, float kappa, cudaStream_t s) {
  int bytes = 0;
  const int ds = d < YSTAGE ? d : YSTAGE;
  const int stages = ring_stages(ds, &bytes);
  if (!stages) return static_cast<int>(cudaErrorInvalidValue);
  // above 48 KB of dynamic shared memory a kernel must opt in
  cudaError_t err = cudaFuncSetAttribute(gram_matmat_kernel<SHAPE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + BM - 1) / BM, (r + BN - 1) / BN);
  gram_matmat_kernel<SHAPE><<<grid, NT, bytes, s>>>(x, yt, vth, vtl, out, n, m, d, ds, r, mt,
                                                    stages, kappa);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vth, vtl: scratch of ceil(r / 128) * ceil(m / 32) * 4096 floats each;
// yt: of ceil(m / 32) * 32 * (d + 1) floats
extern "C" int stpy_gram_matmat(const float* x, const float* y, const float* V, float* out,
                                float* vth, float* vtl, float* yt, int n, int m, int d, int r,
                                float kappa, int shape, void* stream) {
  if (n <= 0 || m <= 0 || r <= 0 || d <= 0 || shape < 0 || shape >= SHAPE_COUNT)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mt = (m + TK - 1) / TK;
  split_v_kernel<<<dim3(mt, (r + BN - 1) / BN), 256, 0, s>>>(V, vth, vtl, m, r, mt);
  pad_y_kernel<<<mt, TK, 0, s>>>(y, yt, m, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int status = static_cast<int>(cudaErrorInvalidValue);
  dispatch_shape(shape, [&](auto code) {
    status = launch<decltype(code)::value>(x, yt, vth, vtl, out, n, m, d, r, mt, kappa, s);
  });
  return status;
}
