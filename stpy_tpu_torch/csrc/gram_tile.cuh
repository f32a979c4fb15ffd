// The tiling and the store path shared by the stored f32 Grams (gram.cu,
// gram_l1.cu): out[i, j] = entry.value(...) of an accumulation over the
// features of x_i and y_j in ascending order.
//
// A 256-thread block owns 256 columns and RT = 8 tiles of 32 rows below one
// another, taken in turn.  Warp w owns rows 4w .. 4w + 3 of a tile; lane l
// owns columns 4l .. 4l + 3 and 128 + 4l .. 128 + 4l + 3, so for each row a
// warp stores 2 x 512 contiguous bytes, one float4 a lane, with the
// streaming hint (st.global.cs: an output of 1 GiB does not fit in L2 and
// is not read back by the kernel).  The x and y tiles are staged in shared
// memory 32 features at a time, y feature-major so that a lane reads its 4
// columns as one float4; a row's x feature is one broadcast read.  Where
// d <= 32 the block stages its y columns once for all its row tiles:
// reloading them for every tile, and the barriers around the reloads, held
// the stores back.  The ragged edges of n, m and d are masked (the TPU
// kernels pad instead); where m is not a multiple of 4, or past m, the
// stores are scalar.
//
// An Entry supplies the per-entry arithmetic:
//   struct Acc { ... };   zero-initialised per row tile
//   void step(Acc&, const float (&a)[4], const float (&b)[8]) const;
//     one feature: a[i] of the warp's 4 rows, b[j] of the lane's 8 columns
//   float value(const Acc&, int i, int j) const;   row i, column j
// so an entry's bits depend on the features' order only, not on the tiling.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int TILE_ROWS = 32;          // output rows per tile (4 per warp)
constexpr int TILE_COLS = 256;         // output columns per block (8 per lane)
constexpr int TILE_RT = 8;             // row tiles per block
constexpr int TILE_KC = 32;            // features staged per pass
constexpr int TILE_NT = 256;           // threads per block
constexpr int TILE_YLD = TILE_COLS + 4;  // row stride of the staged y (16-byte rows)

inline dim3 gram_tile_grid(int n, int m) {
  return dim3((m + TILE_COLS - 1) / TILE_COLS,
              (n + TILE_ROWS * TILE_RT - 1) / (TILE_ROWS * TILE_RT));
}

template <class Entry>
__device__ __forceinline__ void gram_tiles(const float* __restrict__ x,
                                           const float* __restrict__ y,
                                           float* __restrict__ out, int n,
                                           int m, int d, const Entry& entry) {
  __shared__ float xs[TILE_ROWS][TILE_KC];
  __shared__ __align__(16) float ys[TILE_KC][TILE_YLD];   // ys[k][c] = y[col0 + c, k0 + k]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int col0 = blockIdx.x * TILE_COLS;
  for (int rt = 0; rt < TILE_RT; ++rt) {
    const int row0 = (blockIdx.y * TILE_RT + rt) * TILE_ROWS;
    if (row0 >= n) break;
    typename Entry::Acc acc{};
    for (int k0 = 0; k0 < d; k0 += TILE_KC) {
      const int kc = min(TILE_KC, d - k0);
      for (int idx = tid; idx < TILE_ROWS * kc; idx += TILE_NT) {
        const int r = idx / kc, k = idx % kc;
        xs[r][k] = row0 + r < n ? x[(size_t)(row0 + r) * d + k0 + k] : 0.0f;
      }
      if (rt == 0 || d > TILE_KC) {
        for (int idx = tid; idx < TILE_COLS * kc; idx += TILE_NT) {
          const int c = idx / kc, k = idx % kc;
          ys[k][c] = col0 + c < m ? y[(size_t)(col0 + c) * d + k0 + k] : 0.0f;
        }
      }
      __syncthreads();
      for (int k = 0; k < kc; ++k) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xs[4 * warp + i][k];
        const float4 b0 = *reinterpret_cast<const float4*>(&ys[k][4 * lane]);
        const float4 b1 = *reinterpret_cast<const float4*>(&ys[k][128 + 4 * lane]);
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
        entry.step(acc, a, b);
      }
      __syncthreads();
    }

    const bool vec = m % 4 == 0;   // every row starts on 16 bytes
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + 4 * warp + i;
      if (r >= n) continue;
      float* orow = out + (size_t)r * m;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = col0 + 128 * half + 4 * lane;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = entry.value(acc, i, 4 * half + j);
        if (vec && c + 3 < m) {
          __stcs(reinterpret_cast<float4*>(orow + c), make_float4(v[0], v[1], v[2], v[3]));
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (c + j < m) __stcs(orow + c + j, v[j]);
        }
      }
    }
  }
}

}  // namespace
