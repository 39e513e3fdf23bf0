// Kernel 1: BAL projection linearization and half-chi2.
//
// Replaces: gtsam_tpu/sfm/bal.py::_projection_residual (:182) linearized by
// gtsam_tpu/graph/factors.py::linearize (:147, jacfwd + vmap) with the unit
// noise model of gtsam_tpu/sfm/ba.py:1319, and error_fn (ba.py:1338).
//
// Per observation k (one thread each): p_c = R^T (p - t); x = p_c/z;
// pixel = f (1 + k1 r2 + k2 r2^2) x; r = pixel - uv.  Jacobians are
// analytic at the right retraction of gtsam_torch/geometry/cameras.py:
// d p_c / d omega = [p_c]x, d p_c / d v = -I, d p_c / d point = R^T, then the
// calibration columns f, k1, k2.  At z <= 1e-8 the residual is the constant
// 1e3 and both Jacobians are exactly zero (the cheirality penalty).
//
// Bound on the H100: bytes.  About 60 FP64 operations against ~232 bytes of
// traffic per observation (indices, uv, the 2x9 + 2x3 Jacobians and b), far
// below the card's ~10 FP64 flop/byte balance point.  Design: one thread per
// observation, each output row written by its own thread in one pass; the
// camera and point parameters are gathered through L2 (1723 cameras fit it).
// The error mode writes one partial sum per block (fixed-order tree in
// shared memory), so the half-chi2 is reproducible from run to run.
#include "ba_common.cuh"

namespace {

constexpr double kCheiralityEps = 1e-8;
constexpr double kPenalty = 1e3;
constexpr int kBlock = 256;

// Residual (and, when Jc != nullptr, the 2x9 / 2x3 Jacobians, row-major)
// of observation k.
__device__ __forceinline__ void project(
    int k, const double* __restrict__ cam_R, const double* __restrict__ cam_t,
    const double* __restrict__ calib, const double* __restrict__ points,
    const int* __restrict__ obs_cam, const int* __restrict__ obs_pt,
    const double* __restrict__ uv, double r[2], double* Jc, double* Jp) {
  const int c = obs_cam[k];
  const int p = obs_pt[k];
  const double* R = cam_R + 9 * (int64_t)c;
  const double d0 = points[3 * (int64_t)p + 0] - cam_t[3 * c + 0];
  const double d1 = points[3 * (int64_t)p + 1] - cam_t[3 * c + 1];
  const double d2 = points[3 * (int64_t)p + 2] - cam_t[3 * c + 2];
  // p_c = R^T d
  const double pc0 = R[0] * d0 + R[3] * d1 + R[6] * d2;
  const double pc1 = R[1] * d0 + R[4] * d1 + R[7] * d2;
  const double pc2 = R[2] * d0 + R[5] * d1 + R[8] * d2;
  if (!(pc2 > kCheiralityEps)) {
    r[0] = kPenalty;
    r[1] = kPenalty;
    if (Jc) {
      for (int i = 0; i < 18; ++i) Jc[i] = 0.0;
      for (int i = 0; i < 6; ++i) Jp[i] = 0.0;
    }
    return;
  }
  const double f = calib[3 * c + 0], k1 = calib[3 * c + 1], k2 = calib[3 * c + 2];
  const double x = pc0 / pc2, y = pc1 / pc2;
  const double r2 = x * x + y * y;
  const double radial = 1.0 + k1 * r2 + k2 * r2 * r2;
  const double g = f * radial;
  r[0] = x * g - uv[2 * (int64_t)k + 0];
  r[1] = y * g - uv[2 * (int64_t)k + 1];
  if (!Jc) return;

  // d pixel / d (x, y) = g I + 2 f (k1 + 2 k2 r2) [x y]^T [x y]
  const double dg = 2.0 * f * (k1 + 2.0 * k2 * r2);
  const double J00 = g + dg * x * x, J01 = dg * x * y, J11 = g + dg * y * y;
  // Mm = d pixel / d p_c = Juv * [[1/z, 0, -x/z], [0, 1/z, -y/z]]
  const double iz = 1.0 / pc2;
  const double m[2][3] = {
      {J00 * iz, J01 * iz, -(J00 * x + J01 * y) * iz},
      {J01 * iz, J11 * iz, -(J01 * x + J11 * y) * iz}};
  const double xy[2] = {x, y};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    double* row = Jc + 9 * i;
    // rotation: Mm [p_c]x
    row[0] = m[i][1] * pc2 - m[i][2] * pc1;
    row[1] = m[i][2] * pc0 - m[i][0] * pc2;
    row[2] = m[i][0] * pc1 - m[i][1] * pc0;
    // translation: -Mm
    row[3] = -m[i][0];
    row[4] = -m[i][1];
    row[5] = -m[i][2];
    // calibration f, k1, k2
    row[6] = radial * xy[i];
    row[7] = f * r2 * xy[i];
    row[8] = f * r2 * r2 * xy[i];
    // point: Mm R^T
#pragma unroll
    for (int j = 0; j < 3; ++j)
      Jp[3 * i + j] = m[i][0] * R[3 * j + 0] + m[i][1] * R[3 * j + 1] +
                      m[i][2] * R[3 * j + 2];
  }
}

__global__ void __launch_bounds__(kBlock) bal_linearize_kernel(
    int K, const double* __restrict__ cam_R, const double* __restrict__ cam_t,
    const double* __restrict__ calib, const double* __restrict__ points,
    const int* __restrict__ obs_cam, const int* __restrict__ obs_pt,
    const double* __restrict__ uv, double* __restrict__ A_cam,
    double* __restrict__ A_pt, double* __restrict__ b) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  double r[2], Jc[18], Jp[6];
  project(k, cam_R, cam_t, calib, points, obs_cam, obs_pt, uv, r, Jc, Jp);
  double* ac = A_cam + 18 * (int64_t)k;
  double* ap = A_pt + 6 * (int64_t)k;
#pragma unroll
  for (int i = 0; i < 18; ++i) ac[i] = Jc[i];
#pragma unroll
  for (int i = 0; i < 6; ++i) ap[i] = Jp[i];
  b[2 * (int64_t)k + 0] = -r[0];
  b[2 * (int64_t)k + 1] = -r[1];
}

__global__ void __launch_bounds__(kBlock) bal_error_kernel(
    int K, const double* __restrict__ cam_R, const double* __restrict__ cam_t,
    const double* __restrict__ calib, const double* __restrict__ points,
    const int* __restrict__ obs_cam, const int* __restrict__ obs_pt,
    const double* __restrict__ uv, double* __restrict__ partial) {
  __shared__ double sh[kBlock];
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  double v = 0.0;
  if (k < K) {
    double r[2];
    project(k, cam_R, cam_t, calib, points, obs_cam, obs_pt, uv, r, nullptr,
            nullptr);
    v = r[0] * r[0] + r[1] * r[1];
  }
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int s = kBlock / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) partial[blockIdx.x] = sh[0];
}

}  // namespace

GT_EXPORT int gt_bal_linearize(int K, const double* cam_R, const double* cam_t,
                               const double* calib, const double* points,
                               const int* obs_cam, const int* obs_pt,
                               const double* uv, double* A_cam, double* A_pt,
                               double* b, void* stream) {
  if (K > 0) {
    const int grid = (K + kBlock - 1) / kBlock;
    bal_linearize_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        K, cam_R, cam_t, calib, points, obs_cam, obs_pt, uv, A_cam, A_pt, b);
  }
  return (int)cudaGetLastError();
}

// partial must hold ceil(K / 256) doubles (ERROR_BLOCK in sfm/ba_kernels.py).
GT_EXPORT int gt_bal_error(int K, const double* cam_R, const double* cam_t,
                           const double* calib, const double* points,
                           const int* obs_cam, const int* obs_pt,
                           const double* uv, double* partial, void* stream) {
  if (K > 0) {
    const int grid = (K + kBlock - 1) / kBlock;
    bal_error_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        K, cam_R, cam_t, calib, points, obs_cam, obs_pt, uv, partial);
  }
  return (int)cudaGetLastError();
}
