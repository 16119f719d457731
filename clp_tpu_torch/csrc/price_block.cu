// K3: fused block-banded dual-simplex PRICE + Harris pass-1 ratios, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel clp_tpu/ops/pallas_price.py:price_and_ratios_block
// (body _block_price_kernel). A block-banded G, its columns sorted by the
// row window they touch, is held as nb tiles W[b] (H x CB, row-major) that
// cover rows starts[b] .. starts[b] + H - 1 of column block b
// (engine.block_forms). For the padded BTRAN row rho_p (m8) it writes, for
// j = b CB + c,
//     out[j]       = alpha_j = sum_h rho_p[starts[b] + h] W[b, h, c]
//     out[ntp + j] = (dj_j + sgn_j rel) / (sigma alpha_j)
//                    where elig_j && |sigma alpha_j| > ptol && sgn_j sigma alpha_j > 0,
//                    else +inf                                (ntp = nb CB)
// which is K1's function (csrc/price.cu) restricted to the covered windows.
//
// Bound on the H100: bytes. W is read once, 4 nb H CB bytes (7.03 MB at the
// 2048 x 6656 staircase's nb = 52, H = 264, CB = 128; ~2.1 us at 3.35 TB/s
// with the vectors), against 2 nb H CB flops.
// Design: K1's, per column block. A CUDA block takes 32 columns of one tile
// (one thread per column, so a warp reads 32 neighbouring floats of a row
// of W[b]) and K3_SLICES warps that split the H rows; the tile's CB columns
// are spread over ceil(CB / 32) CUDA blocks, so the staircase's 52 tiles
// give 208 blocks for 132 SMs rather than 52. The tile's H-row rho window
// is staged from starts[b] in shared memory in chunks (any H). The slices
// are summed in a fixed order, so the result is deterministic; the same
// pass writes alpha and the masked ratio, so W is never read twice.
//
// sigma and starts are read from device memory: sigma is the result of a
// device argmax, and passing it by value would sync the host every pivot.

#include <cuda_runtime.h>
#include <math.h>

#define K3_COLS 32
#define K3_SLICES 16
#define K3_CHUNK 2048

__global__ void __launch_bounds__(K3_COLS * K3_SLICES)
block_price_kernel(const float* __restrict__ rho_p, const int* __restrict__ starts,
                   const float* __restrict__ W, const float* __restrict__ dj,
                   const int* __restrict__ elig, const float* __restrict__ sgn,
                   const float* __restrict__ sigma_p, float rel, float ptol,
                   int m8, int H, int CB, int col_tiles, float* __restrict__ out,
                   int ntp) {
  __shared__ float rho_s[K3_CHUNK];
  __shared__ float part[K3_SLICES][K3_COLS + 1];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * K3_COLS + tx;
  const int b = blockIdx.x / col_tiles;
  const int c = (blockIdx.x % col_tiles) * K3_COLS + tx;
  const int start = starts[b];
  const float* w = W + (size_t)b * H * CB + c;
  float acc = 0.0f;
  for (int base = 0; base < H; base += K3_CHUNK) {
    const int len = min(K3_CHUNK, H - base);
    for (int i = tid; i < len; i += K3_COLS * K3_SLICES) {
      const int row = start + base + i;
      // block_forms keeps every window inside rho_p; the guard makes a
      // malformed starts read zeros instead of memory past rho_p
      rho_s[i] = (row >= 0 && row < m8) ? rho_p[row] : 0.0f;
    }
    __syncthreads();
    if (c < CB) {
      const float* g = w + (size_t)base * CB;
#pragma unroll 4
      for (int i = ty; i < len; i += K3_SLICES) acc = fmaf(rho_s[i], g[(size_t)i * CB], acc);
    }
    __syncthreads();
  }
  part[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && c < CB) {
    float alpha = 0.0f;
#pragma unroll
    for (int s = 0; s < K3_SLICES; ++s) alpha += part[s][tx];
    const int j = b * CB + c;
    const float a = *sigma_p * alpha;
    const float sg = sgn[j];
    const bool ok = elig[j] != 0 && fabsf(a) > ptol && sg * a > 0.0f;
    out[j] = alpha;
    out[ntp + j] = ok ? (dj[j] + sg * rel) / a : INFINITY;
  }
}

extern "C" int k3_price_block(const float* rho_p, const int* starts, const float* W,
                              const float* dj, const int* elig, const float* sgn,
                              const float* sigma, float rel, float ptol, int m8,
                              int nb, int H, int CB, float* out, cudaStream_t stream) {
  if (nb <= 0 || CB <= 0) return 0;
  const int col_tiles = (CB + K3_COLS - 1) / K3_COLS;
  dim3 block(K3_COLS, K3_SLICES);
  dim3 grid(nb * col_tiles);
  block_price_kernel<<<grid, block, 0, stream>>>(rho_p, starts, W, dj, elig, sgn, sigma,
                                                 rel, ptol, m8, H, CB, col_tiles, out,
                                                 nb * CB);
  return (int)cudaGetLastError();
}
