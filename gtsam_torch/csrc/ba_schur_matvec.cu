// Kernel 5: the implicit Schur matvec of the mixed-precision refinement.
//
// Replaces: gtsam_tpu/sfm/ba.py::schur_solve `matvec` (:1239-1256) and its
// two-float form in _schur_solve_df (:991-1010); GTSAM's
// RegularImplicitSchurFactor::multiplyHessianAdd.
//
//   y = S_red x = Hpp_d x - sum_k WC_k u_{pt(k)},  u_p = sum_{k in p} W_k^T x[cam_k],
//
// with x and y camera-major (M x 9; the JAX package works parameter-major,
// a permutation), Hpp_d the damped camera blocks before their cells' pairs
// are taken off (written by the mixed variant of kernel 3a), and W, WC
// from kernel 2, all double.  So S_red x is formed from the same float
// Jacobians as the float32 S that was factorized, but in double and without
// S's rounding: refining against it recovers the solution of the exact
// Gram system (gtsam_tpu/sfm/ba.py:495-500).
//
// Two launches on one stream:
//   1. the point pass of csrc/ba_point_pass.cuh without C and gl: u (N x 3
//      doubles, scratch from the wrapper);
//   2. the camera pass: one block per camera over the camera CSR (cam_ptr,
//      cam_obs, as kernel 3a): 14 groups of 9 threads, a group takes every
//      14th row of the camera, thread i of it sums WC_k[i, :] u[pt(k)];
//      the 14 partial sums are added in group order, then thread i adds
//      (Hpp_d x)_i.  No atomics: a refinement gives the same bits every
//      time.
// Bound on the H100: bytes.  W and WC (2 x 216 B per row), the row indices,
// Hpp_d, and u written and read again; ~110 FP64 operations per row.
#include "ba_point_pass.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kGroups = 14;  // 14 groups of 9 threads: 126 working threads

__global__ void __launch_bounds__(kThreads) ba_matvec_camera_kernel(
    const int* __restrict__ cam_ptr, const int* __restrict__ cam_obs,
    const int* __restrict__ obs_pt, const double* __restrict__ WC,
    const double* __restrict__ u, const double* __restrict__ Hpp_d,
    const double* __restrict__ x, double* __restrict__ y) {
  __shared__ double red[kGroups][9];
  __shared__ double s_x[9];
  const int c = blockIdx.x;
  const int t = threadIdx.x;
  if (t < 9 * kGroups) {
    const int g = t / 9, i = t % 9;
    double acc = 0.0;
    // unrolled so that several rows' index -> row -> u chains are in flight
#pragma unroll 4
    for (int q = cam_ptr[c] + g; q < cam_ptr[c + 1]; q += kGroups) {
      const int64_t k = cam_obs[q];
      const double* wc = WC + 27 * k + 3 * i;
      const double* up = u + 3 * (int64_t)obs_pt[k];
      acc += wc[0] * up[0] + wc[1] * up[1] + wc[2] * up[2];
    }
    red[g][i] = acc;
  }
  if (t < 9) s_x[t] = x[9 * (int64_t)c + t];
  __syncthreads();
  if (t < 9) {
    double v = 0.0;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) v += red[g][t];
    const double* H = Hpp_d + 81 * (int64_t)c + 9 * t;
    double hx = 0.0;
#pragma unroll
    for (int j = 0; j < 9; ++j) hx += H[j] * s_x[j];
    y[9 * (int64_t)c + t] = hx - v;
  }
}

}  // namespace

// T row tiles of the plan (pt_tile), M cameras; u: N x 3 doubles of scratch.
GT_EXPORT int gt_ba_schur_matvec(int T, int M, const int* pt_ptr,
                                 const int* pt_tile, const int* obs_cam,
                                 const int* obs_pt, const int* cam_ptr,
                                 const int* cam_obs, const double* W,
                                 const double* WC, const double* Hpp_d,
                                 const double* x, double* u, double* y,
                                 void* stream) {
  namespace pp = gt::point_pass;
  if (T > 0) {
    pp::point_pass_kernel<false><<<T, pp::kThreads, 0, (cudaStream_t)stream>>>(
        pt_ptr, pt_tile, obs_cam, W, x, nullptr, nullptr, u);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  if (M > 0) {
    ba_matvec_camera_kernel<<<M, kThreads, 0, (cudaStream_t)stream>>>(
        cam_ptr, cam_obs, obs_pt, WC, u, Hpp_d, x, y);
  }
  return (int)cudaGetLastError();
}
