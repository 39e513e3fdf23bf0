// Kernel 4: landmark back-substitution of the Schur step.
//
// Replaces: gtsam_tpu/sfm/ba.py::schur_solve back-substitution
// (:1264-1272): _wt27_prod, the point _grouped_reduce and the 3x3 _flat_mm.
//
// Per point p over its run of the point-sorted observations:
//   dl_p = C_p (gl_p - sum_k W_k^T dc[cam_k]),
// written at p, which is the original point id (the plan sorts the
// observations by point id).  A point with no observation gets dl = 0.
//
// Bound on the H100: bytes.  It reads W (216 B) and the camera index per
// observation, C and gl per point, and gathers dc (M x 9, in L2); ~60 FP64
// operations per observation.  Design: one warp per point, lanes striding
// over the run, a warp butterfly for the 3-vector sum, so no intermediate
// touches device memory.
#include "ba_common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * gt::kWarp)
ba_back_substitute_kernel(int N, const int* __restrict__ pt_ptr,
                          const int* __restrict__ obs_cam,
                          const double* __restrict__ W,
                          const double* __restrict__ dc,
                          const double* __restrict__ C,
                          const double* __restrict__ gl,
                          double* __restrict__ dl) {
  const int p = blockIdx.x * kWarpsPerBlock + threadIdx.x / gt::kWarp;
  const int lane = threadIdx.x % gt::kWarp;
  if (p >= N) return;  // whole warp leaves together
  const int s = pt_ptr[p], e = pt_ptr[p + 1];
  double u[3] = {0.0, 0.0, 0.0};
  for (int k = s + lane; k < e; k += gt::kWarp) {
    const double* Wk = W + 27 * (int64_t)k;
    const double* x = dc + 9 * (int64_t)obs_cam[k];
#pragma unroll
    for (int i = 0; i < 9; ++i) {
#pragma unroll
      for (int l = 0; l < 3; ++l) u[l] += Wk[3 * i + l] * x[i];
    }
  }
#pragma unroll
  for (int l = 0; l < 3; ++l) u[l] = gt::warp_sum(u[l]);
  if (lane < 3) {
    double out = 0.0;
    if (s != e) {
      const double* Cp = C + 9 * (int64_t)p;
      const double* gp = gl + 3 * (int64_t)p;
      out = Cp[3 * lane] * (gp[0] - u[0]) + Cp[3 * lane + 1] * (gp[1] - u[1]) +
            Cp[3 * lane + 2] * (gp[2] - u[2]);
    }
    dl[3 * (int64_t)p + lane] = out;
  }
}

}  // namespace

GT_EXPORT int gt_ba_back_substitute(int N, const int* pt_ptr,
                                    const int* obs_cam, const double* W,
                                    const double* dc, const double* C,
                                    const double* gl, double* dl,
                                    void* stream) {
  if (N > 0) {
    const int grid = (N + kWarpsPerBlock - 1) / kWarpsPerBlock;
    ba_back_substitute_kernel<<<grid, kWarpsPerBlock * gt::kWarp, 0,
                                (cudaStream_t)stream>>>(N, pt_ptr, obs_cam, W,
                                                        dc, C, gl, dl);
  }
  return (int)cudaGetLastError();
}
