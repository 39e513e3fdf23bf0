// The point pass shared by kernel 4 (landmark back-substitution) and
// kernel 5 (the implicit Schur matvec): per point p over its run of the
// point-sorted rows,
//   u_p = sum_k W_k^T x[cam_k]          (x: M x 9 doubles, camera-major),
// then either dl_p = C_p (gl_p - u_p) (kBackSub) or u_p itself, written at
// p.  A point with no rows gets 0.
//
// Bound on the H100: bytes.  Per row it reads W (216 B) and the camera
// index, and gathers x[cam] (M x 72 B, which L2 holds); per point C and gl
// (kBackSub) and the output; ~60 FP64 operations per row.  Tracks are short
// (3.9 rows on average at the Ladybug shape), so a warp per point idles most
// lanes and reads each row at a stride between lanes.  Design, as kernel 2
// (csrc/ba_point_eliminate.cu): one block per row tile of the plan
// (pt_tile: the points whose first row lies in the tile; rows sorted by
// point, so the tile's rows and points are contiguous ranges):
//   1. the block stages the tile's W rows with 16-byte loads (the shared
//      copy starts one double early when W + 27 r0 is not 16-byte aligned,
//      so every pair of doubles stays aligned; each thread issues all its
//      loads before its first store) and the rows' cameras, coalesced;
//   2. one thread per row forms t_k = W_k^T x[cam_k], gathering x through
//      L2 (the row stride of 27 doubles puts a half-warp's lanes on distinct
//      bank pairs);
//   3. one thread per point sums its t_k in row order and applies C_p,
//      reading C_p and gl_p (96 contiguous bytes) itself;
//   4. the block stores its points' outputs, one thread per double.
// A tile that exceeds the shared buffers (a track longer than ~32 rows in
// it) takes the cooperative branch instead: a warp per point, lanes
// striding over the track, warp butterflies for the sums.  Every sum runs
// in an order fixed by the plan, so the results do not change between
// runs.
// Measured on an H100 SXM at the Ladybug shape, kernel 4
// (scripts/port_point_pass_time.py): 0.064 ms against a 0.041 ms bound.
// Staging loads issued one per loop step took 0.114 ms; staging C and gl
// too (12 KB more shared memory, 4 blocks per SM instead of 5) 0.080 ms;
// reading each row's W from device memory in step 2, with no staging,
// 0.137 ms.
#pragma once

#include "ba_common.cuh"

namespace gt {
namespace point_pass {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / kWarp;
constexpr int kTileRows = 128;  // >= the plan's POINT_TILE_ROWS + overhang
constexpr int kTilePts = 128;

// The output of point p from its u and, for kBackSub, C_p and gl_p.
template <bool kBackSub>
__device__ __forceinline__ void point_out(const double u[3], const double* Cp,
                                          const double* gp, double out[3]) {
  if (kBackSub) {
    const double r0 = gp[0] - u[0], r1 = gp[1] - u[1], r2 = gp[2] - u[2];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      out[i] = Cp[3 * i] * r0 + Cp[3 * i + 1] * r1 + Cp[3 * i + 2] * r2;
  } else {
#pragma unroll
    for (int i = 0; i < 3; ++i) out[i] = u[i];
  }
}

// The cooperative branch: one warp handles point p from device memory.
template <bool kBackSub>
__device__ void point_warp(int p, int lane, const int* pt_ptr,
                           const int* obs_cam, const double* W,
                           const double* x, const double* C,
                           const double* gl, double* out) {
  const int s = pt_ptr[p], e = pt_ptr[p + 1];
  double u[3] = {0.0, 0.0, 0.0};
  for (int k = s + lane; k < e; k += kWarp) {
    const double* Wk = W + 27 * (int64_t)k;
    const double* xc = x + 9 * (int64_t)obs_cam[k];
#pragma unroll
    for (int i = 0; i < 9; ++i) {
#pragma unroll
      for (int l = 0; l < 3; ++l) u[l] += Wk[3 * i + l] * xc[i];
    }
  }
#pragma unroll
  for (int l = 0; l < 3; ++l) u[l] = warp_sum(u[l]);
  if (lane == 0) {
    double v[3] = {0.0, 0.0, 0.0};
    if (s != e)
      point_out<kBackSub>(u, kBackSub ? C + 9 * (int64_t)p : C,
                          kBackSub ? gl + 3 * (int64_t)p : gl, v);
#pragma unroll
    for (int i = 0; i < 3; ++i) out[3 * (int64_t)p + i] = v[i];
  }
}

template <bool kBackSub>
__global__ void __launch_bounds__(kThreads) point_pass_kernel(
    const int* __restrict__ pt_ptr, const int* __restrict__ pt_tile,
    const int* __restrict__ obs_cam, const double* __restrict__ W,
    const double* __restrict__ x, const double* __restrict__ C,
    const double* __restrict__ gl, double* __restrict__ out) {
  __shared__ __align__(16) double s_W[kTileRows * 27 + 2];
  __shared__ double s_t[kTileRows * 3];
  __shared__ double s_out[kTilePts * 3];
  __shared__ int s_cam[kTileRows];

  const int t = threadIdx.x;
  const int p0 = pt_tile[blockIdx.x], p1 = pt_tile[blockIdx.x + 1];
  const int r0 = pt_ptr[p0], r1 = pt_ptr[p1];
  const int np = p1 - p0, nr = r1 - r0;

  if (nr > kTileRows || np > kTilePts) {  // uniform over the block
    for (int p = p0 + t / kWarp; p < p1; p += kWarps)
      point_warp<kBackSub>(p, t % kWarp, pt_ptr, obs_cam, W, x, C, gl, out);
    return;
  }

  // 1. stage.  W + 27 r0 - off is 16-byte aligned (27 r0 - off is even, and
  // W itself is 16-byte aligned), so shared index j holds the double at
  // W + 27 r0 - off + j, and row r starts at s_W + off + 27 r.
  // Pairs off .. n/2 - 1 are whole; each thread issues all its loads before
  // its first store, so they are in flight together.
  const int off = r0 & 1;
  const int n = nr * 27 + off;
  const double* Wg = W + 27 * (int64_t)r0 - off;
  {
    constexpr int kSteps = (kTileRows * 27 / 2 + kThreads - 1) / kThreads;
    const double2* src = reinterpret_cast<const double2*>(Wg);
    double2* dst = reinterpret_cast<double2*>(s_W);
    const int hi = n / 2;
    double2 v[kSteps];
#pragma unroll
    for (int q = 0; q < kSteps; ++q) {
      const int j = off + t + q * kThreads;
      if (j < hi) v[q] = __ldg(src + j);
    }
#pragma unroll
    for (int q = 0; q < kSteps; ++q) {
      const int j = off + t + q * kThreads;
      if (j < hi) dst[j] = v[q];
    }
    if (t == 0 && nr > 0) {  // the first and last double of the span
      if (off) s_W[1] = Wg[1];
      if (n & 1) s_W[n - 1] = Wg[n - 1];
    }
  }
  for (int e = t; e < nr; e += kThreads) s_cam[e] = obs_cam[r0 + e];
  __syncthreads();

  // 2. one thread per row
  for (int r = t; r < nr; r += kThreads) {
    const double* Wr = s_W + off + 27 * r;
    const double* xc = x + 9 * (int64_t)s_cam[r];
    double xv[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) xv[i] = __ldg(xc + i);
#pragma unroll
    for (int l = 0; l < 3; ++l) {
      double acc = 0.0;
#pragma unroll
      for (int i = 0; i < 9; ++i) acc += Wr[3 * i + l] * xv[i];
      s_t[3 * r + l] = acc;
    }
  }
  __syncthreads();

  // 3. one thread per point, its rows in order
  for (int lp = t; lp < np; lp += kThreads) {
    const int s = pt_ptr[p0 + lp] - r0, e = pt_ptr[p0 + lp + 1] - r0;
    double u[3] = {0.0, 0.0, 0.0};
    for (int r = s; r < e; ++r) {
#pragma unroll
      for (int l = 0; l < 3; ++l) u[l] += s_t[3 * r + l];
    }
    double v[3] = {0.0, 0.0, 0.0};
    if (s < e)
      point_out<kBackSub>(u, kBackSub ? C + 9 * (int64_t)(p0 + lp) : C,
                          kBackSub ? gl + 3 * (int64_t)(p0 + lp) : gl, v);
#pragma unroll
    for (int i = 0; i < 3; ++i) s_out[3 * lp + i] = v[i];
  }
  __syncthreads();

  // 4. coalesced stores
  for (int e = t; e < np * 3; e += kThreads) out[3 * (int64_t)p0 + e] = s_out[e];
}

}  // namespace point_pass
}  // namespace gt
