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
// dj, elig and sgn may be shorter than ntp (the engine passes them unpadded):
// a column j >= their length is not eligible, as the zero padding made it.
//
// Bound on the H100: bytes. W is read once, 4 nb H CB bytes (7.03 MB at the
// 2048 x 6656 staircase's nb = 52, H = 264, CB = 128; 2.14 us at 3.35 TB/s
// with the vectors), against 2 nb H CB flops. That is close to what the
// card takes to start and drain any kernel, so K3 is bound by latency: the
// number of dependent trips to memory between its start and its end.
//
// The design before this one (K1's old design per column block; 12.3 us on
// the H100 at 700 W) read starts[b], staged the rho window in shared memory
// and waited at a barrier, three dependent trips before its first load of
// W, and then ran some 4-5 rounds of four 4-byte loads per thread.
// Splitting H across blocks with a cross-block sum, as K1 does, adds three
// trips of its own (the fence, the counter, the partials). This design
// splits the columns instead, so each block owns whole columns and no sum
// leaves the block:
// - a block of 8 warps owns 32 columns of one tile: 8 lanes x float4 cover
//   a 128-byte row segment, so a warp reads 4 rows at once and the block 32
//   (its row slots); the grid is nb x ceil(CB / 32) blocks (the staircase:
//   208, at most 2 on any SM);
// - each thread holds its rows (h = slot, slot + 32, ...: 8-9 of the
//   staircase's 264) in registers, all loads in flight at once, up to
//   K3_BATCH rows a round for a taller H;
// - the loads of W are issued first: their addresses depend on (b, h, c)
//   only, so the read of starts[b] and then of the rho window (through the
//   read-only cache, no barrier) overlaps them; the epilogue's vectors are
//   loaded at the start too (price_epilogue.cuh);
// - the 32 row slots are summed through shared memory in the order
//   0 .. 31, so the result is deterministic, and the epilogue follows.
// Any H and CB work; a CB that is no multiple of 4 loads scalars.
//
// sigma and starts are read from device memory: sigma is the result of a
// device argmax, and passing it by value would sync the host every pivot.
// A window row outside [0, m8) reads as zero, so a malformed starts never
// reads memory past rho_p (block_forms keeps every window inside it).

#include "price_epilogue.cuh"

#define K3_COLS 32
#define K3_LANES 8                      // lanes across a row: K3_COLS / 4
#define K3_THREADS 256
#define K3_SLOTS (K3_THREADS / K3_LANES)  // rows a block reads at once
#define K3_BATCH 12

// acc[k] += sum over h = slot, slot + K3_SLOTS, ... < H of
// rho_p[start + h] * w[h, c + k]; columns >= CB read 0
template <bool VEC>
__device__ __forceinline__ void k3_rows(const float* __restrict__ w, int CB, int c,
                                        const float* __restrict__ rho_p, const int* starts,
                                        int b, int m8, int H, int slot, float acc[4]) {
  const int start = __ldg(starts + b);
  for (int base = slot; base < H; base += K3_SLOTS * K3_BATCH) {
    float4 g[K3_BATCH];
    float p[K3_BATCH];
#pragma unroll
    for (int k = 0; k < K3_BATCH; ++k) {
      const int h = base + k * K3_SLOTS;
      g[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (h < H) {
        const float* row = w + (long long)h * CB + c;
        if (VEC) {
          if (c < CB) g[k] = __ldg(reinterpret_cast<const float4*>(row));
        } else {
          if (c < CB) g[k].x = __ldg(row);
          if (c + 1 < CB) g[k].y = __ldg(row + 1);
          if (c + 2 < CB) g[k].z = __ldg(row + 2);
          if (c + 3 < CB) g[k].w = __ldg(row + 3);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < K3_BATCH; ++k) {
      const int h = base + k * K3_SLOTS;
      const int i = start + h;
      p[k] = (h < H && i >= 0 && i < m8) ? __ldg(rho_p + i) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < K3_BATCH; ++k) {
      acc[0] = fmaf(p[k], g[k].x, acc[0]);
      acc[1] = fmaf(p[k], g[k].y, acc[1]);
      acc[2] = fmaf(p[k], g[k].z, acc[2]);
      acc[3] = fmaf(p[k], g[k].w, acc[3]);
    }
  }
}

__global__ void __launch_bounds__(K3_THREADS, 2)
block_price_kernel(const float* __restrict__ rho_p, const int* __restrict__ starts,
                   const float* __restrict__ W, PriceVecs v, int m8, int H, int CB,
                   int col_tiles, float* __restrict__ out, int ntp) {
  __shared__ __align__(16) float red[K3_SLOTS][K3_COLS];  // float4 stores
  const int b = blockIdx.x / col_tiles;
  const int col0 = (blockIdx.x % col_tiles) * K3_COLS;
  const int t = threadIdx.x;
  const int slot = t / K3_LANES;
  const int quad = t % K3_LANES;
  const int j = b * CB + col0 + t;  // the column this thread finishes
  const bool mine = t < K3_COLS && col0 + t < CB;
  PtColumn col{};
  if (mine) col = pt_column(j, v);

  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const float* w = W + (long long)b * H * CB;
  const int c = col0 + 4 * quad;
  if ((CB % 4 == 0) && ((uintptr_t)W % 16 == 0))
    k3_rows<true>(w, CB, c, rho_p, starts, b, m8, H, slot, acc);
  else
    k3_rows<false>(w, CB, c, rho_p, starts, b, m8, H, slot, acc);
  *reinterpret_cast<float4*>(&red[slot][4 * quad]) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  __syncthreads();
  if (mine) {
    float alpha = 0.0f;
#pragma unroll
    for (int s = 0; s < K3_SLOTS; ++s) alpha += red[s][t];
    pt_epilogue(j, alpha, col, v, out, ntp);
  }
}

extern "C" int k3_price_block(const float* rho_p, const int* starts, const float* W,
                              const void* dj, const void* elig, const void* sgn,
                              const void* sigma, int flags, float rel, float ptol, int m8,
                              int nb, int H, int CB, int n, int col_tiles, float* out,
                              cudaStream_t stream) {
  // col_tiles = ceil(CB / K3_COLS), from ops/price.py:k3_plan
  if (nb <= 0 || CB <= 0) return 0;
  if ((long long)col_tiles * K3_COLS < CB) return (int)cudaErrorInvalidValue;
  PriceVecs v{dj, elig, sgn, sigma, flags, n, rel, ptol};
  block_price_kernel<<<nb * col_tiles, K3_THREADS, 0, stream>>>(
      rho_p, starts, W, v, m8, H, CB, col_tiles, out, nb * CB);
  return (int)cudaGetLastError();
}
