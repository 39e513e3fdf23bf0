// Kernel 2: per-point landmark elimination of the Schur step.
//
// Replaces: gtsam_tpu/sfm/ba.py::schur_solve obs_prods (:1086-1099),
// landmark_solve and coupling (:1117-1133), _grouped_reduce (:278) and
// _inv3x3_flat (:431); together they cover the removed Pallas kernel
// linear/pallas_kernels.py::segmented_block_sum on the point side.
//
// Per point p over its run [pt_ptr[p], pt_ptr[p+1]) of the point-sorted
// observations:
//   Hll = sum A_pt^T A_pt,  gl = sum A_pt^T b,
//   lam_eff = lam (or lam * trace(Hll)/3 with diagonal damping),
//   C = (Hll + lam_eff I)^-1 (adjugate),  Cg = C gl;
// and per observation k of the run:
//   W_k = A_cam^T A_pt (9x3),  WC_k = W_k C,  corr_k = W_k Cg.
// A point with no observation gets C = 0 and gl = 0 (so its step is 0).
//
// Bound on the H100: bytes.  Per observation it reads 208 bytes (A_cam,
// A_pt, b) and writes 504 (W, WC, corr) for ~500 FP64 operations, below
// the card's balance point.  Tracks are short (2-4 observations at the
// Ladybug shape), so a warp per point would leave most lanes idle and
// store each row's 63 outputs at a stride between lanes.  Design: one
// block per row tile of the plan (pt_tile: the points whose first row lies
// in the tile).  Rows are sorted by point, so the tile's rows are one
// contiguous range of the inputs and of the outputs:
//   1. the block copies its rows of A_cam, A_pt and b into shared memory
//      with flat, coalesced loads;
//   2. one thread per point sums Hll and gl from shared memory in row
//      order and forms C, gl and Cg there;
//   3. one thread per OUTPUT ELEMENT writes W, WC and corr (and C, gl),
//      recomputing its few products from shared memory, so consecutive
//      threads store consecutive doubles.
// A tile whose rows or points exceed the shared buffers (a track longer
// than ~32 observations lies in it, or many points without observations)
// takes the cooperative branch instead: one warp per point, lanes
// striding over the track, warp butterflies for the 12 sums, outputs
// stored from registers.  Every sum runs in a fixed order, so the results
// do not change between runs.
//
// A_cam and A_pt come as double, or as float in the mixed-precision mode
// (the kernel is templated on their load type; b is always double).  All
// arithmetic is double: a product of two floats is exact in double, so Hll,
// gl, C, W, WC and corr are the exact-Gram values that the JAX package's
// two-float chain _schur_solve_df (gtsam_tpu/sfm/ba.py:777-1037) emulates.
// The staged tile keeps the inputs in their load type, so a float tile
// takes half the shared memory of a double one.
#include "ba_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / gt::kWarp;
constexpr int kTileRows = 128;  // >= the plan's POINT_TILE_ROWS + overhang
constexpr int kTilePts = 128;

// lam_eff damping, C = (Hll + lam_eff I)^-1 and Cg = C g, in place in h.
__device__ __forceinline__ void point_solve(double h[9], const double g[3],
                                            double lam, int diagonal_damping,
                                            double C[9], double Cg[3]) {
  const double lam_eff =
      diagonal_damping ? (h[0] + h[4] + h[8]) / 3.0 * lam : lam;
  h[0] += lam_eff;
  h[4] += lam_eff;
  h[8] += lam_eff;
  gt::inv3x3(h, C);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    Cg[i] = C[3 * i] * g[0] + C[3 * i + 1] * g[1] + C[3 * i + 2] * g[2];
}

// The cooperative branch: one warp eliminates point p from device memory.
template <typename TA>
__device__ void eliminate_point_warp(int p, int lane, const int* pt_ptr,
                                     const TA* A_cam, const TA* A_pt,
                                     const double* b, double lam,
                                     int diagonal_damping, double* W,
                                     double* WC, double* corr, double* C_out,
                                     double* gl_out) {
  const int s = pt_ptr[p], e = pt_ptr[p + 1];
  double h[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0}, g[3] = {0, 0, 0};
  for (int k = s + lane; k < e; k += gt::kWarp) {
    const TA* ap = A_pt + 6 * (int64_t)k;
    const double b0 = b[2 * (int64_t)k], b1 = b[2 * (int64_t)k + 1];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
        h[3 * i + j] += (double)ap[i] * ap[j] + (double)ap[3 + i] * ap[3 + j];
      g[i] += (double)ap[i] * b0 + (double)ap[3 + i] * b1;
    }
  }
#pragma unroll
  for (int i = 0; i < 9; ++i) h[i] = gt::warp_sum(h[i]);
#pragma unroll
  for (int i = 0; i < 3; ++i) g[i] = gt::warp_sum(g[i]);

  if (s == e) {
    if (lane < 9) C_out[9 * (int64_t)p + lane] = 0.0;
    if (lane < 3) gl_out[3 * (int64_t)p + lane] = 0.0;
    return;
  }
  double C[9], Cg[3];
  point_solve(h, g, lam, diagonal_damping, C, Cg);
  if (lane < 9) C_out[9 * (int64_t)p + lane] = C[lane];
  if (lane < 3) gl_out[3 * (int64_t)p + lane] = g[lane];

  for (int k = s + lane; k < e; k += gt::kWarp) {
    const TA* ac = A_cam + 18 * (int64_t)k;
    const TA* ap = A_pt + 6 * (int64_t)k;
    double* Wk = W + 27 * (int64_t)k;
    double* WCk = WC + 27 * (int64_t)k;
    double* ck = corr + 9 * (int64_t)k;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      double w[3];
#pragma unroll
      for (int l = 0; l < 3; ++l) {
        w[l] = (double)ac[i] * ap[l] + (double)ac[9 + i] * ap[3 + l];
        Wk[3 * i + l] = w[l];
      }
#pragma unroll
      for (int l = 0; l < 3; ++l)
        WCk[3 * i + l] = w[0] * C[l] + w[1] * C[3 + l] + w[2] * C[6 + l];
      ck[i] = w[0] * Cg[0] + w[1] * Cg[1] + w[2] * Cg[2];
    }
  }
}

template <typename TA>
__global__ void __launch_bounds__(kThreads) ba_point_eliminate_kernel(
    const int* __restrict__ pt_ptr, const int* __restrict__ pt_tile,
    const TA* __restrict__ A_cam, const TA* __restrict__ A_pt,
    const double* __restrict__ b, double lam, int diagonal_damping,
    double* __restrict__ W, double* __restrict__ WC,
    double* __restrict__ corr, double* __restrict__ C_out,
    double* __restrict__ gl_out) {
  __shared__ TA s_ac[kTileRows * 18];
  __shared__ TA s_ap[kTileRows * 6];
  __shared__ double s_b[kTileRows * 2];
  __shared__ double s_C[kTilePts * 9];
  __shared__ double s_gl[kTilePts * 3];
  __shared__ double s_Cg[kTilePts * 3];
  __shared__ int s_pt[kTileRows];  // tile-local point of each row

  const int t = threadIdx.x;
  const int p0 = pt_tile[blockIdx.x], p1 = pt_tile[blockIdx.x + 1];
  const int r0 = pt_ptr[p0], r1 = pt_ptr[p1];
  const int np = p1 - p0, nr = r1 - r0;

  if (nr > kTileRows || np > kTilePts) {  // uniform over the block
    for (int p = p0 + t / gt::kWarp; p < p1; p += kWarps)
      eliminate_point_warp(p, t % gt::kWarp, pt_ptr, A_cam, A_pt, b, lam,
                           diagonal_damping, W, WC, corr, C_out, gl_out);
    return;
  }

  // 1. stage the tile's rows
  const TA* ac_g = A_cam + 18 * (int64_t)r0;
  const TA* ap_g = A_pt + 6 * (int64_t)r0;
  const double* b_g = b + 2 * (int64_t)r0;
  for (int e = t; e < nr * 18; e += kThreads) s_ac[e] = ac_g[e];
  for (int e = t; e < nr * 6; e += kThreads) s_ap[e] = ap_g[e];
  for (int e = t; e < nr * 2; e += kThreads) s_b[e] = b_g[e];
  __syncthreads();

  // 2. one thread per point
  for (int lp = t; lp < np; lp += kThreads) {
    const int s = pt_ptr[p0 + lp] - r0, e = pt_ptr[p0 + lp + 1] - r0;
    double h[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0}, g[3] = {0, 0, 0};
    for (int r = s; r < e; ++r) {
      const TA* ap = s_ap + 6 * r;
      const double b0 = s_b[2 * r], b1 = s_b[2 * r + 1];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j)
          h[3 * i + j] += (double)ap[i] * ap[j] + (double)ap[3 + i] * ap[3 + j];
        g[i] += (double)ap[i] * b0 + (double)ap[3 + i] * b1;
      }
      s_pt[r] = lp;
    }
    double C[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0}, Cg[3] = {0, 0, 0};
    if (s < e) point_solve(h, g, lam, diagonal_damping, C, Cg);
#pragma unroll
    for (int i = 0; i < 9; ++i) s_C[9 * lp + i] = C[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      s_gl[3 * lp + i] = g[i];
      s_Cg[3 * lp + i] = Cg[i];
    }
  }
  __syncthreads();

  // 3. coalesced stores, one thread per output element
  for (int e = t; e < np * 9; e += kThreads) C_out[9 * (int64_t)p0 + e] = s_C[e];
  for (int e = t; e < np * 3; e += kThreads) gl_out[3 * (int64_t)p0 + e] = s_gl[e];
  double* W_g = W + 27 * (int64_t)r0;
  double* WC_g = WC + 27 * (int64_t)r0;
  double* corr_g = corr + 9 * (int64_t)r0;
  for (int e = t; e < nr * 27; e += kThreads) {
    const int r = e / 27, q = e - 27 * r, i = q / 3, l = q - 3 * i;
    const TA* ac = s_ac + 18 * r;
    const TA* ap = s_ap + 6 * r;
    W_g[e] = (double)ac[i] * ap[l] + (double)ac[9 + i] * ap[3 + l];
  }
  for (int e = t; e < nr * 27; e += kThreads) {
    const int r = e / 27, q = e - 27 * r, i = q / 3, l = q - 3 * i;
    const TA* ac = s_ac + 18 * r;
    const TA* ap = s_ap + 6 * r;
    const double* C = s_C + 9 * s_pt[r];
    double w[3];
#pragma unroll
    for (int m = 0; m < 3; ++m)
      w[m] = (double)ac[i] * ap[m] + (double)ac[9 + i] * ap[3 + m];
    WC_g[e] = w[0] * C[l] + w[1] * C[3 + l] + w[2] * C[6 + l];
  }
  for (int e = t; e < nr * 9; e += kThreads) {
    const int r = e / 9, i = e - 9 * r;
    const TA* ac = s_ac + 18 * r;
    const TA* ap = s_ap + 6 * r;
    const double* Cg = s_Cg + 3 * s_pt[r];
    double w[3];
#pragma unroll
    for (int m = 0; m < 3; ++m)
      w[m] = (double)ac[i] * ap[m] + (double)ac[9 + i] * ap[3 + m];
    corr_g[e] = w[0] * Cg[0] + w[1] * Cg[1] + w[2] * Cg[2];
  }
}

template <typename TA>
int launch_point_eliminate(int T, const int* pt_ptr, const int* pt_tile,
                           const TA* A_cam, const TA* A_pt, const double* b,
                           double lam, int diagonal_damping, double* W,
                           double* WC, double* corr, double* C, double* gl,
                           void* stream) {
  if (T > 0) {
    ba_point_eliminate_kernel<TA><<<T, kThreads, 0, (cudaStream_t)stream>>>(
        pt_ptr, pt_tile, A_cam, A_pt, b, lam, diagonal_damping, W, WC, corr,
        C, gl);
  }
  return (int)cudaGetLastError();
}

}  // namespace

GT_EXPORT int gt_ba_point_eliminate(int T, const int* pt_ptr,
                                    const int* pt_tile, const double* A_cam,
                                    const double* A_pt, const double* b,
                                    double lam, int diagonal_damping,
                                    double* W, double* WC, double* corr,
                                    double* C, double* gl, void* stream) {
  return launch_point_eliminate(T, pt_ptr, pt_tile, A_cam, A_pt, b, lam,
                                diagonal_damping, W, WC, corr, C, gl, stream);
}

// The mixed-precision variant: A_cam and A_pt float, all else double.
GT_EXPORT int gt_ba_point_eliminate_f32(int T, const int* pt_ptr,
                                        const int* pt_tile, const float* A_cam,
                                        const float* A_pt, const double* b,
                                        double lam, int diagonal_damping,
                                        double* W, double* WC, double* corr,
                                        double* C, double* gl, void* stream) {
  return launch_point_eliminate(T, pt_ptr, pt_tile, A_cam, A_pt, b, lam,
                                diagonal_damping, W, WC, corr, C, gl, stream);
}
