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
// 2048 x 6656 staircase, 16.3 us at 3.35 TB/s with the vectors) against
// 2 m nt flops (0.8 us at 67 TFLOP/s): tensor cores buy nothing for a
// matrix-vector product. What counts is bytes in flight and even work on
// all 132 SMs.
//
// The design before this one (one thread per column, 4-byte loads on one
// FMA chain, 208 blocks of 32 columns; 38.9 us on the H100 at 700 W) had a
// warp ask for one 128-byte line at a time, about 8 loads in flight per
// thread, and 56 of the 132 SMs with half the work of the rest. This one:
// - a block of 8 warps owns 128 columns, 4 a thread, so each load is 16
//   bytes and a warp reads 512 contiguous bytes of a row; each thread
//   issues 8 such loads (rows w, w + 8, ... of its warp) before the first
//   FMA that needs them, into 4 independent sums;
// - m is split across blocks as well: the grid is ceil(nt / 128) tiles
//   times S row splits, S chosen by ops/price.py:k1_plan from the SM count
//   so the blocks spread evenly over the SMs and are all resident at once
//   (the staircase: 52 tiles x 10 splits, 520 blocks of 256 threads, 4 per
//   SM); blocks are numbered split-major, so the blocks running together
//   read neighbouring rows;
// - the splits are summed in the same launch: each block writes its 128
//   partials to row s of an (S, nt) scratch, fences and counts itself in
//   its tile's counter; the block that counts last adds the S rows in the
//   order s = 0 .. S - 1, runs the epilogue and sets the counter back to 0.
//   The order of arrival never enters the sum, so two launches give the
//   same bits, and nothing else is launched. The wrapper allocates the
//   scratch and counters once per device; one stream uses them at a time;
// - G is loaded with the streaming hint (evict-first in L1 and L2): it is
//   read once per pivot and is larger than the 50 MB L2, so caching it
//   would only push out the basis inverse and the pivot vectors;
// - rho is read through the read-only cache, not staged: no barrier stands
//   between a block's start and its first load of G, and the epilogue's
//   vectors are loaded at the start too (price_epilogue.cuh).
// A row stride nt that is no multiple of 4 (or a G that is not 16-byte
// aligned) breaks the float4 alignment of the rows; the kernel then loads
// the same columns as 4 scalars, with the same order of sums.
//
// sigma is read from device memory: it is the result of a device argmax,
// and passing it by value would sync the host every pivot.

#include "price_epilogue.cuh"

#define K1_COLS 128
#define K1_WARPS 8
#define K1_THREADS (K1_WARPS * 32)
#define K1_BATCH 8

// acc[k] += sum over rows r in [r0, r1) of this warp's (r = r0 + warp,
// r0 + warp + K1_WARPS, ...) of rho[r] * G[r, c + k]; columns >= nt read 0
template <bool VEC>
__device__ __forceinline__ void k1_rows(const float* __restrict__ G, int nt, int c,
                                        const float* __restrict__ rho, int r0, int r1,
                                        float acc[4]) {
  const int warp = threadIdx.x >> 5;
  for (int base = r0 + warp; base < r1; base += K1_WARPS * K1_BATCH) {
    float4 g[K1_BATCH];
    float p[K1_BATCH];
#pragma unroll
    for (int k = 0; k < K1_BATCH; ++k) {
      const int r = base + k * K1_WARPS;
      g[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (r < r1) {
        const float* row = G + (long long)r * nt + c;
        if (VEC) {
          if (c < nt) g[k] = __ldcs(reinterpret_cast<const float4*>(row));
        } else {
          if (c < nt) g[k].x = __ldcs(row);
          if (c + 1 < nt) g[k].y = __ldcs(row + 1);
          if (c + 2 < nt) g[k].z = __ldcs(row + 2);
          if (c + 3 < nt) g[k].w = __ldcs(row + 3);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < K1_BATCH; ++k) {
      const int r = base + k * K1_WARPS;
      p[k] = r < r1 ? __ldg(rho + r) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < K1_BATCH; ++k) {
      acc[0] = fmaf(p[k], g[k].x, acc[0]);
      acc[1] = fmaf(p[k], g[k].y, acc[1]);
      acc[2] = fmaf(p[k], g[k].z, acc[2]);
      acc[3] = fmaf(p[k], g[k].w, acc[3]);
    }
  }
}

__global__ void __launch_bounds__(K1_THREADS, 4)
price_kernel(const float* __restrict__ rho, const float* __restrict__ G, PriceVecs v,
             int m, int nt, int tiles, int splits, int rows_per_split,
             float* __restrict__ part, int* __restrict__ counters, float* __restrict__ out) {
  __shared__ __align__(16) float red[K1_WARPS][K1_COLS];  // float4 stores
  __shared__ int is_last;
  const int tile = blockIdx.x % tiles;
  const int s = blockIdx.x / tiles;
  const int r0 = s * rows_per_split;
  const int r1 = min(m, r0 + rows_per_split);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x;
  const int j = tile * K1_COLS + t;  // the column this thread finishes
  const bool mine = t < K1_COLS && j < nt;
  PtColumn col{};
  if (mine) col = pt_column(j, v);

  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const int c = tile * K1_COLS + 4 * lane;
  if ((nt % 4 == 0) && ((uintptr_t)G % 16 == 0))
    k1_rows<true>(G, nt, c, rho, r0, r1, acc);
  else
    k1_rows<false>(G, nt, c, rho, r0, r1, acc);
  *reinterpret_cast<float4*>(&red[warp][4 * lane]) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  __syncthreads();
  float sum = 0.0f;
  if (mine) {
#pragma unroll
    for (int w = 0; w < K1_WARPS; ++w) sum += red[w][t];
  }
  if (splits == 1) {
    if (mine) pt_epilogue(j, sum, col, v, out, nt);
    return;
  }
  if (mine) part[(long long)s * nt + j] = sum;
  __threadfence();
  __syncthreads();
  if (t == 0) is_last = atomicAdd(counters + tile, 1) == splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  if (mine) {
    float alpha = 0.0f;
    for (int k = 0; k < splits; ++k) alpha += __ldcg(part + (long long)k * nt + j);
    pt_epilogue(j, alpha, col, v, out, nt);
  }
  if (t == 0) counters[tile] = 0;
}

extern "C" int k1_price(const float* rho, const float* G, const void* dj, const void* elig,
                        const void* sgn, const void* sigma, int flags, float rel, float ptol,
                        int m, int nt, int splits, int rows_per_split, float* part,
                        int* counters, float* out, cudaStream_t stream) {
  if (nt <= 0) return 0;
  if (splits < 1 || rows_per_split < 1) return (int)cudaErrorInvalidValue;
  const int tiles = (nt + K1_COLS - 1) / K1_COLS;
  PriceVecs v{dj, elig, sgn, sigma, flags, nt, rel, ptol};
  price_kernel<<<tiles * splits, K1_THREADS, 0, stream>>>(rho, G, v, m, nt, tiles, splits,
                                                          rows_per_split, part, counters, out);
  return (int)cudaGetLastError();
}
