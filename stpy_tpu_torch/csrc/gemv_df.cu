// Double-float GEMV: (Ah + Al)(v + vl) -> (hi, lo) f32 pair of shape (m,).
//
// Replaces stpy_tpu/ops/pallas_gemv_df.py:_gemv_kernel (the pallas_call in
// _gemv_pallas), which stpy_tpu/ops/compensated.py:gemv_df reaches on the TPU.
// That kernel keeps the sum exact with f32 TwoProd/TwoSum trees because the
// TPU has no f64.  Here each product and the whole reduction run in native
// FP64, and the row sum is split into hi = (float)s, lo = (float)(s - hi).
//
// What bounds it on an H100: memory bandwidth.  A call reads Ah and Al once,
// 2*m*k*4 bytes (2 GiB at m = k = 16384); v and vl (k floats each) stay in L2.
//
// Design: one 256-thread block per row.  Threads stride along the row (four
// floats per load when k % 4 == 0, one otherwise) so a warp's loads are
// contiguous, each thread accumulates its share in FP64, and the block
// reduces with warp shuffles and then across its eight warps through shared
// memory.  The order of every addition is fixed by the launch shape: no
// atomics, so the result is the same on every run.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ double warp_sum(double s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  return s;
}

__device__ __forceinline__ double term(float ah, float al, float v, float vl) {
  return (static_cast<double>(ah) + static_cast<double>(al)) *
         (static_cast<double>(v) + static_cast<double>(vl));
}

__global__ void __launch_bounds__(THREADS)
gemv_df_kernel(const float* __restrict__ ah, const float* __restrict__ al,
               const float* __restrict__ v, const float* __restrict__ vl,
               float* __restrict__ oh, float* __restrict__ ol, int k, bool vec4) {
  const size_t row = blockIdx.x;
  const float* a = ah + row * k;
  const float* b = al + row * k;
  double s = 0.0;
  if (vec4) {
    const float4* a4 = reinterpret_cast<const float4*>(a);
    const float4* b4 = reinterpret_cast<const float4*>(b);
    const float4* v4 = reinterpret_cast<const float4*>(v);
    const float4* w4 = reinterpret_cast<const float4*>(vl);
    for (int j = threadIdx.x; j < k / 4; j += THREADS) {
      const float4 p = a4[j], q = b4[j], r = v4[j], t = w4[j];
      s += term(p.x, q.x, r.x, t.x);
      s += term(p.y, q.y, r.y, t.y);
      s += term(p.z, q.z, r.z, t.z);
      s += term(p.w, q.w, r.w, t.w);
    }
  } else {
    for (int j = threadIdx.x; j < k; j += THREADS) s += term(a[j], b[j], v[j], vl[j]);
  }

  __shared__ double part[WARPS];
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x < 32) {
    s = warp_sum(threadIdx.x < WARPS ? part[threadIdx.x] : 0.0);
    if (threadIdx.x == 0) {
      const float h = static_cast<float>(s);
      oh[row] = h;
      ol[row] = static_cast<float>(s - static_cast<double>(h));
    }
  }
}

}  // namespace

extern "C" int stpy_gemv_df(const float* ah, const float* al, const float* v,
                            const float* vl, float* oh, float* ol, int m, int k,
                            void* stream) {
  const bool vec4 = (k % 4 == 0) &&
                    ((reinterpret_cast<size_t>(ah) | reinterpret_cast<size_t>(al) |
                      reinterpret_cast<size_t>(v) | reinterpret_cast<size_t>(vl)) % 16 == 0);
  gemv_df_kernel<<<m, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      ah, al, v, vl, oh, ol, k, vec4);
  return static_cast<int>(cudaGetLastError());
}
