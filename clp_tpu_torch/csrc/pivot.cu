// K2: fused FTRAN + DSE tau + flip flow + rank-1 basis-inverse update,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel clp_tpu/ops/pallas_pivot.py:fused_pivot_update
// (body _pivot_kernel). For the f32 basis inverse binv (m x m, row-major),
// triple = [g_q | rho | f_delta] (m x 3, row-major) and rho = row r of binv:
//     R       = binv @ triple                       -> res (m x 3)
//     factor  = R[:, 0] / abar_r, row r: 1 - 1/abar_r
//     binv'   = binv - gate * factor (x) rho        -> binv_out (m x m)
// scal = [1/abar_r, gate] and r are read from device memory: they come out
// of device argmaxes, and passing them by value would sync every pivot.
//
// Bound on the H100: bytes. binv is read once and written once,
// 2 * 4 m^2 bytes (33.5 MB at m = 2048, ~10 us at 3.35 TB/s), against
// 8 m^2 flops. Design: a block owns K2_ROWS rows. It streams them from
// device memory once into shared memory while it accumulates their three
// dot products against triple (each triple element loaded once per block
// and used for all K2_ROWS rows, which keeps the L2 traffic for triple
// below the binv traffic); a warp-shuffle plus shared-memory reduction in a
// fixed order gives R; then it writes row - gate*factor*rho from the copy
// held on chip, so binv is never read twice. binv_out is a separate buffer:
// the update is out of place, so no block can see another block's writes,
// and rho must not alias binv in any case (the caller passes a copy).

#include <cuda_runtime.h>

#define K2_ROWS 4
#define K2_THREADS 256
#define K2_ACC (K2_ROWS * 3)

__global__ void __launch_bounds__(K2_THREADS)
pivot_kernel(const float* __restrict__ binv, const float* __restrict__ triple,
             const float* __restrict__ rho, const float* __restrict__ scal,
             const int* __restrict__ r_p, int m, float* __restrict__ binv_out,
             float* __restrict__ res) {
  extern __shared__ float rows_s[];  // K2_ROWS x m
  __shared__ float red[K2_THREADS / 32][K2_ACC];
  __shared__ float sums[K2_ACC];
  const int i0 = blockIdx.x * K2_ROWS;
  const int nrows = min(K2_ROWS, m - i0);
  float acc[K2_ACC];
#pragma unroll
  for (int t = 0; t < K2_ACC; ++t) acc[t] = 0.0f;
  for (int k = threadIdx.x; k < m; k += K2_THREADS) {
    const float t0 = triple[3 * k];
    const float t1 = triple[3 * k + 1];
    const float t2 = triple[3 * k + 2];
#pragma unroll
    for (int rr = 0; rr < K2_ROWS; ++rr) {
      if (rr < nrows) {
        const float b = binv[(size_t)(i0 + rr) * m + k];
        rows_s[rr * m + k] = b;
        acc[3 * rr] = fmaf(b, t0, acc[3 * rr]);
        acc[3 * rr + 1] = fmaf(b, t1, acc[3 * rr + 1]);
        acc[3 * rr + 2] = fmaf(b, t2, acc[3 * rr + 2]);
      }
    }
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int t = 0; t < K2_ACC; ++t) {
    float v = acc[t];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][t] = v;
  }
  __syncthreads();
  if (threadIdx.x < K2_ACC) {
    float s = 0.0f;
    for (int w = 0; w < K2_THREADS / 32; ++w) s += red[w][threadIdx.x];
    sums[threadIdx.x] = s;
  }
  __syncthreads();
  const float inv_abar_r = scal[0];
  const float gate = scal[1];
  const int r = *r_p;
  for (int rr = 0; rr < nrows; ++rr) {
    const int i = i0 + rr;
    const float factor = (i == r) ? 1.0f - inv_abar_r : sums[3 * rr] * inv_abar_r;
    const float gf = gate * factor;
    float* dst = binv_out + (size_t)i * m;
    const float* row = rows_s + rr * m;
    for (int k = threadIdx.x; k < m; k += K2_THREADS) dst[k] = row[k] - gf * rho[k];
  }
  if (threadIdx.x < nrows * 3) res[(size_t)i0 * 3 + threadIdx.x] = sums[threadIdx.x];
}

extern "C" int k2_pivot(const float* binv, const float* triple, const float* rho,
                        const float* scal, const int* r, int m, float* binv_out,
                        float* res, cudaStream_t stream) {
  if (m <= 0) return 0;
  const size_t smem = (size_t)K2_ROWS * m * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pivot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (m + K2_ROWS - 1) / K2_ROWS;
  pivot_kernel<<<grid, K2_THREADS, smem, stream>>>(binv, triple, rho, scal, r, m,
                                                   binv_out, res);
  return (int)cudaGetLastError();
}
