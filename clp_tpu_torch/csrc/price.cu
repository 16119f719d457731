// K1: fused dual-simplex PRICE + Harris pass-1 ratios, for Hopper (sm_90a).
//
// Replaces the TPU kernel clp_tpu/ops/pallas_price.py:price_and_ratios
// (body _price_kernel). For a BTRAN row rho (m) and the f32 standard-form
// matrix G (m x nt, row-major) it writes
//     out[0, j] = alpha_j = sum_i rho_i G_ij
//     out[1, j] = (dj_j + sgn_j rel) / (sigma alpha_j)
//                 where elig_j && |sigma alpha_j| > ptol && sgn_j sigma alpha_j > 0,
//                 else +inf.
//
// Bound on the H100: bytes. G is read once, 4 m nt bytes (54.5 MB at the
// 2048 x 6656 staircase, ~16 us at 3.35 TB/s) against 2 m nt flops.
// Design: one thread per column, so a warp reads 32 neighbouring floats of a
// row of G (coalesced along nt). A block is 32 columns x K1_SLICES warps;
// warp s sums rows s, s + K1_SLICES, ..., so the m-reduction is split across
// the block and nt / 32 blocks of 512 threads keep enough loads in flight on
// 132 SMs. rho is staged through shared memory in chunks (any m). The
// slices are summed in a fixed order, so the result is deterministic; the
// same pass writes alpha and the masked ratio, so G is never read twice.
//
// sigma is read from device memory: it is the result of a device argmax,
// and passing it by value would sync the host every pivot.

#include <cuda_runtime.h>
#include <math.h>

#define K1_COLS 32
#define K1_SLICES 16
#define K1_CHUNK 2048

__global__ void __launch_bounds__(K1_COLS * K1_SLICES)
price_kernel(const float* __restrict__ rho, const float* __restrict__ G,
             const float* __restrict__ dj, const int* __restrict__ elig,
             const float* __restrict__ sgn, const float* __restrict__ sigma_p,
             float rel, float ptol, int m, int nt, float* __restrict__ out) {
  __shared__ float rho_s[K1_CHUNK];
  __shared__ float part[K1_SLICES][K1_COLS + 1];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * K1_COLS + tx;
  const int j = blockIdx.x * K1_COLS + tx;
  float acc = 0.0f;
  for (int base = 0; base < m; base += K1_CHUNK) {
    const int len = min(K1_CHUNK, m - base);
    for (int i = tid; i < len; i += K1_COLS * K1_SLICES) rho_s[i] = rho[base + i];
    __syncthreads();
    if (j < nt) {
      const float* g = G + (size_t)base * nt + j;
#pragma unroll 8
      for (int i = ty; i < len; i += K1_SLICES) acc = fmaf(rho_s[i], g[(size_t)i * nt], acc);
    }
    __syncthreads();
  }
  part[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && j < nt) {
    float alpha = 0.0f;
#pragma unroll
    for (int s = 0; s < K1_SLICES; ++s) alpha += part[s][tx];
    const float a = *sigma_p * alpha;
    const float sg = sgn[j];
    const bool ok = elig[j] != 0 && fabsf(a) > ptol && sg * a > 0.0f;
    out[j] = alpha;
    out[nt + j] = ok ? (dj[j] + sg * rel) / a : INFINITY;
  }
}

extern "C" int k1_price(const float* rho, const float* G, const float* dj,
                        const int* elig, const float* sgn, const float* sigma,
                        float rel, float ptol, int m, int nt, float* out,
                        cudaStream_t stream) {
  if (nt <= 0) return 0;
  dim3 block(K1_COLS, K1_SLICES);
  dim3 grid((nt + K1_COLS - 1) / K1_COLS);
  price_kernel<<<grid, block, 0, stream>>>(rho, G, dj, elig, sgn, sigma, rel,
                                           ptol, m, nt, out);
  return (int)cudaGetLastError();
}
