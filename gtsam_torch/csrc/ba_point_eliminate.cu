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
// the card's balance point.  Design: one warp per point, lanes striding
// over the observations of the run (any run length, no padding to powers
// of two); the 12 reductions are warp butterflies in registers, so Hll and
// gl never touch device memory; the second pass re-reads the run's
// Jacobians from L1/L2 to emit W, WC and corr.
#include "ba_common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * gt::kWarp)
ba_point_eliminate_kernel(int N, const int* __restrict__ pt_ptr,
                          const double* __restrict__ A_cam,
                          const double* __restrict__ A_pt,
                          const double* __restrict__ b, double lam,
                          int diagonal_damping, double* __restrict__ W,
                          double* __restrict__ WC, double* __restrict__ corr,
                          double* __restrict__ C_out,
                          double* __restrict__ gl_out) {
  const int p = blockIdx.x * kWarpsPerBlock + threadIdx.x / gt::kWarp;
  const int lane = threadIdx.x % gt::kWarp;
  if (p >= N) return;  // whole warp leaves together
  const int s = pt_ptr[p], e = pt_ptr[p + 1];

  double h[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0}, g[3] = {0, 0, 0};
  for (int k = s + lane; k < e; k += gt::kWarp) {
    const double* ap = A_pt + 6 * (int64_t)k;
    const double b0 = b[2 * (int64_t)k], b1 = b[2 * (int64_t)k + 1];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) h[3 * i + j] += ap[i] * ap[j] + ap[3 + i] * ap[3 + j];
      g[i] += ap[i] * b0 + ap[3 + i] * b1;
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
  const double lam_eff =
      diagonal_damping ? (h[0] + h[4] + h[8]) / 3.0 * lam : lam;
  double C[9], Cg[3];
  h[0] += lam_eff;
  h[4] += lam_eff;
  h[8] += lam_eff;
  gt::inv3x3(h, C);
#pragma unroll
  for (int i = 0; i < 3; ++i) Cg[i] = C[3 * i] * g[0] + C[3 * i + 1] * g[1] + C[3 * i + 2] * g[2];
  if (lane < 9) C_out[9 * (int64_t)p + lane] = C[lane];
  if (lane < 3) gl_out[3 * (int64_t)p + lane] = g[lane];

  for (int k = s + lane; k < e; k += gt::kWarp) {
    const double* ac = A_cam + 18 * (int64_t)k;
    const double* ap = A_pt + 6 * (int64_t)k;
    double* Wk = W + 27 * (int64_t)k;
    double* WCk = WC + 27 * (int64_t)k;
    double* ck = corr + 9 * (int64_t)k;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      double w[3];
#pragma unroll
      for (int l = 0; l < 3; ++l) {
        w[l] = ac[i] * ap[l] + ac[9 + i] * ap[3 + l];
        Wk[3 * i + l] = w[l];
      }
#pragma unroll
      for (int l = 0; l < 3; ++l)
        WCk[3 * i + l] = w[0] * C[l] + w[1] * C[3 + l] + w[2] * C[6 + l];
      ck[i] = w[0] * Cg[0] + w[1] * Cg[1] + w[2] * Cg[2];
    }
  }
}

}  // namespace

GT_EXPORT int gt_ba_point_eliminate(int N, const int* pt_ptr,
                                    const double* A_cam, const double* A_pt,
                                    const double* b, double lam,
                                    int diagonal_damping, double* W,
                                    double* WC, double* corr, double* C,
                                    double* gl, void* stream) {
  if (N > 0) {
    const int grid = (N + kWarpsPerBlock - 1) / kWarpsPerBlock;
    ba_point_eliminate_kernel<<<grid, kWarpsPerBlock * gt::kWarp, 0,
                                (cudaStream_t)stream>>>(
        N, pt_ptr, A_cam, A_pt, b, lam, diagonal_damping, W, WC, corr, C, gl);
  }
  return (int)cudaGetLastError();
}
