// What K1 (price.cu) and K3 (price_block.cu) share: the fused Harris
// pass-1 ratio epilogue of the JAX package's _price_kernel and
// _block_price_kernel, in f32, reading the vectors as the engine stores
// them, so the wrappers launch no casts.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// how the epilogue's vectors are stored (ops/price.py _kernel_vecs)
#define PT_DJ_F64 1
#define PT_SGN_F64 2
#define PT_SIGMA_F64 4
#define PT_ELIG_BYTE 8

struct PriceVecs {
  const void* dj;     // f32 or f64
  const void* elig;   // int32, or one byte (bool / uint8 / int8)
  const void* sgn;    // f32 or f64
  const void* sigma;  // one f32 or f64 in device memory
  int flags;
  int n;              // entries of dj / elig / sgn; columns >= n are not eligible
  float rel;
  float ptol;
};

__device__ __forceinline__ float pt_load(const void* p, bool f64, int j) {
  return f64 ? (float)__ldg(static_cast<const double*>(p) + j)
             : __ldg(static_cast<const float*>(p) + j);
}

// what the epilogue reads of column j, loaded when a block starts so that
// the epilogue finds it in registers and not one more trip to memory away
struct PtColumn {
  float sigma, d, sg;
  bool el;
};

__device__ __forceinline__ PtColumn pt_column(int j, const PriceVecs& v) {
  PtColumn c{pt_load(v.sigma, v.flags & PT_SIGMA_F64, 0), 0.0f, 1.0f, false};
  if (j < v.n) {
    c.el = (v.flags & PT_ELIG_BYTE) ? __ldg(static_cast<const uint8_t*>(v.elig) + j) != 0
                                    : __ldg(static_cast<const int*>(v.elig) + j) != 0;
    c.sg = pt_load(v.sgn, v.flags & PT_SGN_F64, j);
    c.d = pt_load(v.dj, v.flags & PT_DJ_F64, j);
  }
  return c;
}

// out[j] = alpha; out[nout + j] = (dj_j + sgn_j rel) / (sigma alpha_j) where
// elig_j && |sigma alpha_j| > ptol && sgn_j sigma alpha_j > 0, else +inf
__device__ __forceinline__ void pt_epilogue(int j, float alpha, const PtColumn& c,
                                            const PriceVecs& v, float* __restrict__ out,
                                            int nout) {
  const float a = c.sigma * alpha;
  const bool ok = c.el && fabsf(a) > v.ptol && c.sg * a > 0.0f;
  out[j] = alpha;
  out[nout + j] = ok ? (c.d + c.sg * v.rel) / a : INFINITY;
}
