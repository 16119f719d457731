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
// Bound on the H100: bytes. binv is read once and binv' written once,
// 8 m^2 bytes against 8 m^2 flops (one flop a byte, far below the f32 FMA
// ridge of ~20; tensor cores have nothing to add): 33.6 MB, 10.0 us at
// 3.35 TB/s at m = 2048; 2.15 GB, 0.641 ms at m = 16,384.
//
// Design: one launch at every m up to ops/pivot.py:K2_MAX_M (76,576), binv
// read once and binv' written once, no atomics, no global scratch. The
// geometry is ops/pivot.py:k2_plan's.
// - A CTA owns a column slice of every row it handles. Up to m = 2864 the
//   slice is the whole row and a CTA works alone; above, thread-block
//   clusters of C = 4 or 8 CTAs split each row, CTA j of a cluster taking
//   columns [j w, min(m, (j + 1) w)), w a multiple of 4. A CTA bulk-copies
//   its slices of triple and rho into shared memory once per launch.
// - A CTA walks row tiles of R rows (tiles cluster, cluster + G, ... for G
//   clusters, as many as fit on the card at once) through a ring of S
//   stages. A producer warp, a lane a row, fills each row's slot with a
//   bulk copy (cp.async.bulk ... mbarrier::complete_tx) as soon as the
//   warps of that row have freed it, so later rows are in flight while a
//   row is reduced and written: reads and writes overlap, and no warp that
//   computes issues a copy.
// - Warp w of the 8 that compute works on row w / (8 / R) of a tile: 3
//   running sums per thread, a butterfly shuffle, then the row's warps
//   summed in warp order into the CTA's 3R partials. A CTA working alone
//   has R = 8, a warp per row, and needs no more; there a warp takes its
//   rows of two tiles at once, so triple and rho are read from shared
//   memory once for both (the sums of each row run in the same order as
//   alone). In a cluster, each CTA stores its partials into slot [rank] of
//   every CTA of the cluster (st.async, counted on the receiver's
//   barrier), and every CTA sums the C slots of a row in rank order 0 ..
//   C-1: every CTA gets the same bits, and two launches give the same
//   bits. No cluster barrier stands in the loop (its release would wait
//   for the CTA's streaming stores to drain, which put the stores of every
//   tile on the path of the next): a CTA waits only for its own slots,
//   which are double-buffered, and sends a tile's partials only after the
//   previous tile's have all landed, so no peer still reads the slots it
//   writes.
// - Each warp writes its part of row - gate * factor * rho from the copy
//   the CTA holds, with 16-byte streaming stores.
// Odd m: row i of a slice starts at 4 (i m + c0) bytes, not 16-byte
// aligned, and a bulk copy needs a 16-byte aligned address and size (a
// tensor map, which needs a row stride that is a multiple of 16 bytes,
// cannot serve at all). Each row then copies the 16-byte aligned span that
// holds its slice (at most 3 floats more at each end, inside the 16-byte
// chunks that hold the row's first and last element, so nothing outside
// the allocation's pages is touched) and the kernel reads the row at its
// offset in that span, with 4-byte loads and stores; triple and rho are
// staged the same way. binv_out is a separate buffer (out of place); rho
// must not alias binv.

#include <cuda_runtime.h>
#include <stdint.h>

#define K2_WARPS 8                      // the warps that compute
#define K2_THREADS (K2_WARPS * 32 + 32)  // and one producer warp
#define K2_MAX_CLUSTER 8
#define K2_MAX_STAGES 4
#define K2_PAD 8  // floats a staged row holds beyond w: the aligned span's ends

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// waits for the phase `parity` of a stage's barrier; a copy that has not
// landed after ~2^34 cycles (~10 s) aborts the launch instead of hanging it
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  long long t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > (1LL << 34)) __trap();
  }
}

__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, uint32_t bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t v;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(v));
  return v;
}

__device__ __forceinline__ uint32_t cluster_id() {
  uint32_t v;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(v));
  return v;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t v;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(v));
  return v;
}

__device__ __forceinline__ uint32_t cluster_count() {
  uint32_t v;
  asm volatile("mov.u32 %0, %%nclusterid.x;" : "=r"(v));
  return v;
}

// stores v at `local` in the shared memory of the cluster's CTA `rank` and
// counts its 4 bytes on that CTA's barrier `bar` (the same offsets there)
__device__ __forceinline__ void st_peer(float* local, float v, uint64_t* bar, uint32_t rank) {
  uint32_t addr, rbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(addr) : "r"(smem_u32(local)),
               "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(rbar) : "r"(smem_u32(bar)),
               "r"(rank));
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               ::"r"(addr), "r"(__float_as_uint(v)), "r"(rbar)
               : "memory");
}

// the 16-byte aligned span [lo, lo + bytes) that holds `n` floats from
// `p`; p sits (p % 16) / 4 floats into it
struct Span {
  const char* lo;
  uint32_t bytes;
  int shift;
};

__device__ __forceinline__ Span span_of(const float* p, int n) {
  const uintptr_t a = (uintptr_t)p;
  const uintptr_t lo = a & ~(uintptr_t)15;
  const uintptr_t hi = (a + 4 * (uintptr_t)n + 15) & ~(uintptr_t)15;
  return {(const char*)lo, (uint32_t)(hi - lo), (int)((a & 15) >> 2)};
}

// the producer: bulk-copy row i of this CTA's slice into its slot `dst`
// (w + K2_PAD floats) and arm the slot's barrier with its bytes; a row past
// m (the last tile may be ragged) only completes the barrier's phase
__device__ __forceinline__ void issue_row(const float* __restrict__ binv, int m, int c0, int wl,
                                          int i, float* dst, uint64_t* bar) {
  if (i < m) {
    const Span sp = span_of(binv + (size_t)i * m + c0, wl);
    mbar_expect_tx(bar, sp.bytes);
    bulk_g2s(dst, sp.lo, sp.bytes, bar);
  } else {
    mbar_arrive(bar);
  }
}

// this warp's 3 running sums of its row of the tile against the slice of
// triple (staged interleaved, [g_q, rho, f_delta] per column), over the
// columns sub*32+lane, stepping by 32 * warps-per-row (float4 groups with
// VEC), then summed over the warp (fixed butterfly)
template <bool VEC, int R>
__device__ __forceinline__ void row_sums(const float* row, const float* tv, int wl, int sub,
                                         int lane, float acc[3]) {
  constexpr int WPR = K2_WARPS / R;
  acc[0] = acc[1] = acc[2] = 0.0f;
  if (VEC) {
    const float4* b4 = reinterpret_cast<const float4*>(row);
    const float4* t4 = reinterpret_cast<const float4*>(tv);
#pragma unroll 4
    for (int g = sub * 32 + lane; g < wl / 4; g += 32 * WPR) {
      const float4 b = b4[g];
      const float4 p = t4[3 * g], q = t4[3 * g + 1], v = t4[3 * g + 2];
      // columns 4g .. 4g+3: (p.x p.y p.z) (p.w q.x q.y) (q.z q.w v.x) (v.y v.z v.w)
      acc[0] = fmaf(b.x, p.x, acc[0]);
      acc[1] = fmaf(b.x, p.y, acc[1]);
      acc[2] = fmaf(b.x, p.z, acc[2]);
      acc[0] = fmaf(b.y, p.w, acc[0]);
      acc[1] = fmaf(b.y, q.x, acc[1]);
      acc[2] = fmaf(b.y, q.y, acc[2]);
      acc[0] = fmaf(b.z, q.z, acc[0]);
      acc[1] = fmaf(b.z, q.w, acc[1]);
      acc[2] = fmaf(b.z, v.x, acc[2]);
      acc[0] = fmaf(b.w, v.y, acc[0]);
      acc[1] = fmaf(b.w, v.z, acc[1]);
      acc[2] = fmaf(b.w, v.w, acc[2]);
    }
  } else {
#pragma unroll 4
    for (int j = sub * 32 + lane; j < wl; j += 32 * WPR) {
      const float b = row[j];
      acc[0] = fmaf(b, tv[3 * j], acc[0]);
      acc[1] = fmaf(b, tv[3 * j + 1], acc[1]);
      acc[2] = fmaf(b, tv[3 * j + 2], acc[2]);
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
}

// out_row[j] = row[j] - gf * rho[j] over this warp's columns
template <bool VEC, int R>
__device__ __forceinline__ void row_update(const float* row, const float* rho, int wl, int sub,
                                           int lane, float gf, float* __restrict__ out_row) {
  constexpr int WPR = K2_WARPS / R;
  if (VEC) {
    const float4* b4 = reinterpret_cast<const float4*>(row);
    const float4* p4 = reinterpret_cast<const float4*>(rho);
    float4* o4 = reinterpret_cast<float4*>(out_row);
#pragma unroll 4
    for (int g = sub * 32 + lane; g < wl / 4; g += 32 * WPR) {
      const float4 b = b4[g], p = p4[g];
      __stcs(o4 + g, make_float4(b.x - gf * p.x, b.y - gf * p.y, b.z - gf * p.z,
                                 b.w - gf * p.w));
    }
  } else {
#pragma unroll 4
    for (int j = sub * 32 + lane; j < wl; j += 32 * WPR) __stcs(out_row + j, row[j] - gf * rho[j]);
  }
}

// a CTA working alone: one warp's two rows (of two tiles) at once, each
// summed in the order row_sums takes, so a row's bits do not depend on its
// partner; triple and rho are read once for both
template <bool VEC>
__device__ __forceinline__ void pair_sums(const float* ra, const float* rb, const float* tv,
                                          int wl, int lane, float a[3], float b[3]) {
  a[0] = a[1] = a[2] = b[0] = b[1] = b[2] = 0.0f;
  if (VEC) {
    const float4* a4 = reinterpret_cast<const float4*>(ra);
    const float4* b4 = reinterpret_cast<const float4*>(rb);
    const float4* t4 = reinterpret_cast<const float4*>(tv);
#pragma unroll 4
    for (int g = lane; g < wl / 4; g += 32) {
      const float4 x = a4[g], y = b4[g];
      const float4 p = t4[3 * g], q = t4[3 * g + 1], v = t4[3 * g + 2];
      const float t[12] = {p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w, v.x, v.y, v.z, v.w};
      const float xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          a[c] = fmaf(xs[e], t[3 * e + c], a[c]);
          b[c] = fmaf(ys[e], t[3 * e + c], b[c]);
        }
    }
  } else {
#pragma unroll 4
    for (int j = lane; j < wl; j += 32) {
      const float x = ra[j], y = rb[j];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float t = tv[3 * j + c];
        a[c] = fmaf(x, t, a[c]);
        b[c] = fmaf(y, t, b[c]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a[c] += __shfl_xor_sync(0xffffffffu, a[c], off);
      b[c] += __shfl_xor_sync(0xffffffffu, b[c], off);
    }
}

template <bool VEC>
__device__ __forceinline__ void pair_update(const float* ra, const float* rb, const float* rho,
                                            int wl, int lane, float ga, float gb,
                                            float* __restrict__ oa, float* __restrict__ ob) {
  if (VEC) {
    const float4* a4 = reinterpret_cast<const float4*>(ra);
    const float4* b4 = reinterpret_cast<const float4*>(rb);
    const float4* p4 = reinterpret_cast<const float4*>(rho);
#pragma unroll 4
    for (int g = lane; g < wl / 4; g += 32) {
      const float4 x = a4[g], y = b4[g], p = p4[g];
      __stcs(reinterpret_cast<float4*>(oa) + g,
             make_float4(x.x - ga * p.x, x.y - ga * p.y, x.z - ga * p.z, x.w - ga * p.w));
      __stcs(reinterpret_cast<float4*>(ob) + g,
             make_float4(y.x - gb * p.x, y.y - gb * p.y, y.z - gb * p.z, y.w - gb * p.w));
    }
  } else {
#pragma unroll 4
    for (int j = lane; j < wl; j += 32) {
      const float p = rho[j];
      __stcs(oa + j, ra[j] - ga * p);
      __stcs(ob + j, rb[j] - gb * p);
    }
  }
}

// the consumers' barrier: the K2_WARPS warps that compute, without the producer
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(K2_WARPS * 32) : "memory");
}

template <bool VEC, int R>
__global__ void __launch_bounds__(K2_THREADS, 2)
pivot_kernel(const float* __restrict__ binv, const float* __restrict__ triple,
             const float* __restrict__ rho, const float* __restrict__ scal,
             const int* __restrict__ r_p, int m, int w, int stages,
             float* __restrict__ binv_out, float* __restrict__ res) {
  constexpr int WPR = K2_WARPS / R;
  extern __shared__ __align__(128) float smem[];
  // per row slot [stage][row of the tile]: its copy has landed (full), and
  // the warps of its row are done with it (empty)
  __shared__ __align__(8) uint64_t full[K2_MAX_STAGES][R];
  __shared__ __align__(8) uint64_t empty[K2_MAX_STAGES][R];
  __shared__ __align__(8) uint64_t got[2];  // every rank's partials of a tile have landed
  __shared__ __align__(8) uint64_t vec;     // the slices of triple and rho have landed
  __shared__ float inbox[2][K2_MAX_CLUSTER][3 * R];  // [tile & 1][rank][3 rr + c]
  __shared__ float red[2][K2_WARPS][3];              // [tile & 1][warp]: a warp's sums
  __shared__ float sums[2][3 * R];                   // [tile & 1]: the row sums, all ranks

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const uint32_t rank = cluster_rank();
  const int nclusters = (int)cluster_count();
  const int cid = (int)cluster_id();
  const int csize = (int)cluster_size();
  const int c0 = (int)rank * w;
  const int wl = min(w, m - c0);  // > 0: the plan leaves no slice empty
  const int rstride = w + K2_PAD;
  float* tv = smem;                    // 3 w + K2_PAD: triple's rows c0 .. c0 + wl
  float* rho_s = tv + 3 * w + K2_PAD;  // w + K2_PAD
  float* ring = rho_s + w + K2_PAD;    // stages x R rows x (w + K2_PAD)
  const int ntiles = (m + R - 1) / R;
  const int n = cid < ntiles ? (ntiles - cid + nclusters - 1) / nclusters : 0;
  const uint32_t tile_bytes = (uint32_t)(csize * 3 * R * 4);
  const Span tsp = span_of(triple + 3 * (size_t)c0, 3 * wl);
  const Span rsp = span_of(rho + c0, wl);

  if (warp == K2_WARPS) {  // the producer warp: lane rr < R copies row rr of each tile
    if (lane == 0) {
      for (int s = 0; s < stages; ++s)
        for (int rr = 0; rr < R; ++rr) {
          mbar_init(&full[s][rr], 1);
          mbar_init(&empty[s][rr], WPR);
        }
      mbar_init(&got[0], 1);
      mbar_init(&got[1], 1);
      mbar_init(&vec, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      for (int u = 0; u < n && u < 2; ++u) mbar_expect_tx(&got[u], tile_bytes);
      mbar_expect_tx(&vec, tsp.bytes + rsp.bytes);
      bulk_g2s(tv, tsp.lo, tsp.bytes, &vec);
      bulk_g2s(rho_s, rsp.lo, rsp.bytes, &vec);
    }
    __syncwarp();
    if (lane < R)
      for (int u = 0; u < n && u < stages; ++u)
        issue_row(binv, m, c0, wl, (cid + u * nclusters) * R + lane,
                  ring + (u * R + lane) * rstride, &full[u][lane]);
  }
  __syncthreads();
  if (csize > 1) {  // every peer's barriers are made before anyone sends to them
    cluster_arrive_relaxed();
    cluster_wait();
  }
  if (warp == K2_WARPS) {
    // each lane refills its row's slot once the warps of that row are done
    // with the row it held
    if (lane < R) {
      for (int u = stages; u < n; ++u) {
        const int s = u % stages;
        mbar_wait(&empty[s][lane], (u / stages - 1) & 1);
        issue_row(binv, m, c0, wl, (cid + u * nclusters) * R + lane,
                  ring + (s * R + lane) * rstride, &full[s][lane]);
      }
    }
    return;
  }

  const int rr_w = warp / WPR;  // this warp's row of a tile
  const int sub = warp % WPR;
  const float inv_abar_r = __ldg(scal);
  const float gate = __ldg(scal + 1);
  const int r = __ldg(r_p);
  const float* tvs = tv + tsp.shift;
  const float* rhos = rho_s + rsp.shift;
  mbar_wait(&vec, 0);

  if (R == K2_WARPS && csize == 1) {
    // one CTA holds whole rows and each warp one row of a tile: the warp's
    // sums are its row's, so nothing is exchanged and no warp waits for
    // another but to free a stage. A warp takes its rows of two tiles at
    // once (stages >= 2), reading triple and rho once for both.
    auto row_of = [&](int u) { return (cid + u * nclusters) * R + warp; };
    auto staged = [&](int u, int i) {
      const float* st = ring + ((u % stages) * R + warp) * rstride;
      return st + (VEC ? 0 : (int)(((uintptr_t)(binv + (size_t)i * m) & 15) >> 2));
    };
    auto factor = [&](int i, float s0) { return (i == r) ? 1.0f - inv_abar_r : s0 * inv_abar_r; };
    auto put_res = [&](int i, const float acc[3]) {
      if (lane < 3) res[(size_t)i * 3 + lane] = lane == 0 ? acc[0] : lane == 1 ? acc[1] : acc[2];
    };
    for (int u = 0; u < n; u += 2) {
      const int ia = row_of(u), ib = row_of(u + 1);
      const bool va = ia < m, vb = u + 1 < n && ib < m;
      if (va) mbar_wait(&full[u % stages][warp], (u / stages) & 1);
      if (vb) mbar_wait(&full[(u + 1) % stages][warp], ((u + 1) / stages) & 1);
      float a[3], b[3];
      if (va && vb) {
        pair_sums<VEC>(staged(u, ia), staged(u + 1, ib), tvs, wl, lane, a, b);
        pair_update<VEC>(staged(u, ia), staged(u + 1, ib), rhos, wl, lane,
                         gate * factor(ia, a[0]), gate * factor(ib, b[0]),
                         binv_out + (size_t)ia * m, binv_out + (size_t)ib * m);
        put_res(ia, a);
        put_res(ib, b);
      } else if (va) {
        row_sums<VEC, R>(staged(u, ia), tvs, wl, 0, lane, a);
        row_update<VEC, R>(staged(u, ia), rhos, wl, 0, lane, gate * factor(ia, a[0]),
                           binv_out + (size_t)ia * m);
        put_res(ia, a);
      }
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(&empty[u % stages][warp]);
        if (u + 1 < n) mbar_arrive(&empty[(u + 1) % stages][warp]);
      }
    }
    return;
  }

  // one warp's sums for its row of local tile u, into red[u & 1][warp]
  auto tile_sums = [&](int u) {
    const int i = (cid + u * nclusters) * R + rr_w;
    float acc[3] = {0.0f, 0.0f, 0.0f};
    if (i < m) {
      mbar_wait(&full[u % stages][rr_w], (u / stages) & 1);
      const float* st = ring + (u % stages) * R * rstride + rr_w * rstride;
      const int shift = VEC ? 0 : (int)(((uintptr_t)(binv + (size_t)i * m + c0) & 15) >> 2);
      row_sums<VEC, R>(st + shift, tvs, wl, sub, lane, acc);
    }
    if (lane == 0) {
      red[u & 1][warp][0] = acc[0];
      red[u & 1][warp][1] = acc[1];
      red[u & 1][warp][2] = acc[2];
    }
  };
  // thread k < 3R: this CTA's partial k of local tile u (its row's warps in
  // order), stored into slot [rank][k] of every CTA of the cluster
  auto send = [&](int u, int k) {
    const int rr = k / 3, c = k % 3;
    float s = 0.0f;
#pragma unroll
    for (int q = 0; q < WPR; ++q) s += red[u & 1][rr * WPR + q][c];
    for (int q = 0; q < csize; ++q) st_peer(&inbox[u & 1][rank][k], s, &got[u & 1], (uint32_t)q);
  };

  if (n > 0) {
    tile_sums(0);
    consumers_sync();
    if (tid < 3 * R) send(0, tid);
  }
  for (int u = 0; u < n; ++u) {
    const int st_idx = u % stages;
    const bool more = u + 1 < n;
    if (more) tile_sums(u + 1);
    if (tid < 3 * R) {
      mbar_wait(&got[u & 1], (u >> 1) & 1);
      float s = 0.0f;
#pragma unroll
      for (int q = 0; q < K2_MAX_CLUSTER; ++q)
        if (q < csize) s += inbox[u & 1][q][tid];  // rank order
      sums[u & 1][tid] = s;
    }
    // sums and red of this parity are written; the other parity's readers
    // (the previous iteration) are all done
    consumers_sync();
    // tile u's slots are read: arm them for tile u + 2. No peer sends tile
    // u + 2 before it has this CTA's tile u + 1, sent just below.
    if (tid == 0 && u + 2 < n) mbar_expect_tx(&got[u & 1], tile_bytes);
    if (more && tid < 3 * R) send(u + 1, tid);

    const int i0 = (cid + u * nclusters) * R;
    const int i = i0 + rr_w;
    if (i < m) {
      const float factor =
          (i == r) ? 1.0f - inv_abar_r : sums[u & 1][3 * rr_w] * inv_abar_r;
      const float* st = ring + st_idx * R * rstride + rr_w * rstride;
      const int shift = VEC ? 0 : (int)(((uintptr_t)(binv + (size_t)i * m + c0) & 15) >> 2);
      row_update<VEC, R>(st + shift, rhos, wl, sub, lane, gate * factor,
                         binv_out + (size_t)i * m + c0);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st_idx][rr_w]);
    if (rank == 0 && tid < 3 * min(R, m - i0)) res[(size_t)i0 * 3 + tid] = sums[u & 1][tid];
  }
  // every byte sent to this CTA has landed (it waited for each tile's), and
  // it sends nothing after its last tile, so it may leave without a barrier
}

template <bool VEC, int R>
static int launch(const float* binv, const float* triple, const float* rho, const float* scal,
                  const int* r, int m, int C, int w, int stages, int clusters, int smem,
                  float* binv_out, float* res, cudaStream_t stream) {
  auto kernel = pivot_kernel<VEC, R>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * C);
  cfg.blockDim = dim3(K2_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // as many clusters as are resident at once: the kernel is persistent, and
  // a cluster that waited for a free place would run its tiles after the rest
  static int occ_key[3] = {0, 0, 0};
  static int occ_val = 0;
  if (occ_key[0] != C || occ_key[1] != smem || occ_key[2] != clusters) {
    int active = 0;
    e = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (active < 1) return (int)cudaErrorInvalidConfiguration;
    occ_val = active;
    occ_key[0] = C;
    occ_key[1] = smem;
    occ_key[2] = clusters;
  }
  cfg.gridDim = dim3((clusters < occ_val ? clusters : occ_val) * C);
  e = cudaLaunchKernelEx(&cfg, kernel, binv, triple, rho, scal, r, m, w, stages, binv_out, res);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <bool VEC>
static int dispatch(const float* binv, const float* triple, const float* rho, const float* scal,
                    const int* r, int m, int C, int w, int R, int stages, int clusters, int smem,
                    float* binv_out, float* res, cudaStream_t stream) {
  switch (R) {
    case 1:
      return launch<VEC, 1>(binv, triple, rho, scal, r, m, C, w, stages, clusters, smem,
                            binv_out, res, stream);
    case 2:
      return launch<VEC, 2>(binv, triple, rho, scal, r, m, C, w, stages, clusters, smem,
                            binv_out, res, stream);
    case 4:
      return launch<VEC, 4>(binv, triple, rho, scal, r, m, C, w, stages, clusters, smem,
                            binv_out, res, stream);
    case 8:
      return launch<VEC, 8>(binv, triple, rho, scal, r, m, C, w, stages, clusters, smem,
                            binv_out, res, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// One launch of K2 with the geometry of ops/pivot.py:k2_plan: clusters of C
// CTAs, column slices of w, row tiles of R, S stages, `clusters` clusters at
// most, `smem` bytes of dynamic shared memory.
extern "C" int k2_pivot(const float* binv, const float* triple, const float* rho,
                        const float* scal, const int* r, int m, int C, int w, int R, int stages,
                        int clusters, int smem, float* binv_out, float* res,
                        cudaStream_t stream) {
  if (m <= 0) return 0;
  if (C < 1 || C > K2_MAX_CLUSTER || w < 4 || w % 4 != 0 || (long long)(C - 1) * w >= m ||
      (long long)C * w < m || stages < 2 || stages > K2_MAX_STAGES || clusters < 1 ||
      (long long)smem < 4LL * (4LL * w + 2 * K2_PAD + (long long)stages * R * (w + K2_PAD)))
    return (int)cudaErrorInvalidValue;
  const bool vec = m % 4 == 0 &&
                   ((uintptr_t)binv | (uintptr_t)binv_out | (uintptr_t)triple | (uintptr_t)rho) %
                           16 == 0;
  if (vec)
    return dispatch<true>(binv, triple, rho, scal, r, m, C, w, R, stages, clusters, smem,
                          binv_out, res, stream);
  return dispatch<false>(binv, triple, rho, scal, r, m, C, w, R, stages, clusters, smem,
                         binv_out, res, stream);
}
