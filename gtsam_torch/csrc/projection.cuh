// Projection factors' device math, shared by kernel 1 (bal_linearize.cu,
// BA's Schur form) and kernel 17 (proj_factor.cu, the graph form).
//
// Pose is camera-to-world; p_c = R^T (p - t); x = p_c / z; the residual is
// pixel - uv.  The Jacobians are analytic at the right retraction T Exp(xi)
// of gtsam_torch/geometry/se3.py, tangent [omega; v]: d p_c / d omega =
// [p_c]x, d p_c / d v = -I, d p_c / d point = R^T.  At z <= 1e-8 the
// residual is the constant 1e3 and both Jacobians are exactly zero (the
// cheirality penalty, gtsam_tpu/sfm/bal.py:182).
#pragma once

#include "ba_common.cuh"

namespace proj {

constexpr double kCheiralityEps = 1e-8;
constexpr double kPenalty = 1e3;

__device__ __forceinline__ void penalty(double r[2], double* Jc, int nc,
                                        double* Jp) {
  r[0] = kPenalty;
  r[1] = kPenalty;
  if (Jc) {
    for (int i = 0; i < 2 * nc; ++i) Jc[i] = 0.0;
    for (int i = 0; i < 6; ++i) Jp[i] = 0.0;
  }
}

// PinholeCamera<Cal3Bundler>: R (3x3 row-major), t (3), calib (f, k1, k2),
// point X (3), measurement uv (2).  The residual r and, when Jc is not
// null, the 2x9 camera Jacobian (row-major, columns [omega, v, f, k1, k2])
// and the 2x3 point Jacobian.
__device__ __forceinline__ void project_bal(
    const double* __restrict__ R, const double* __restrict__ t,
    const double* __restrict__ calib, const double* __restrict__ X,
    const double* __restrict__ uv, double r[2], double* Jc, double* Jp) {
  const double d0 = X[0] - t[0];
  const double d1 = X[1] - t[1];
  const double d2 = X[2] - t[2];
  // p_c = R^T d
  const double pc0 = R[0] * d0 + R[3] * d1 + R[6] * d2;
  const double pc1 = R[1] * d0 + R[4] * d1 + R[7] * d2;
  const double pc2 = R[2] * d0 + R[5] * d1 + R[8] * d2;
  if (!(pc2 > kCheiralityEps)) {
    penalty(r, Jc, 9, Jp);
    return;
  }
  const double f = calib[0], k1 = calib[1], k2 = calib[2];
  const double x = pc0 / pc2, y = pc1 / pc2;
  const double r2 = x * x + y * y;
  const double radial = 1.0 + k1 * r2 + k2 * r2 * r2;
  const double g = f * radial;
  r[0] = x * g - uv[0];
  r[1] = y * g - uv[1];
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

// GenericProjectionFactor<Pose3, Point3, Cal3_S2>: body pose R, t; the
// fixed K = (fx, fy, s, u0, v0); ext, when not null, the body-to-sensor
// pose (Rb row-major, then tb: 12 doubles), so the sensor is T * ext and
// p_c = Rb^T (p_b - tb) with p_b = R^T (X - t).  The 2x6 pose Jacobian
// (columns [omega, v] of the body pose's right retraction) and the 2x3
// point Jacobian: with N = Mm Rb^T, d r / d omega = N [p_b]x, d r / d v =
// -N, d r / d X = N R^T.
__device__ __forceinline__ void project_pinhole(
    const double* __restrict__ R, const double* __restrict__ t,
    const double* __restrict__ K, const double* __restrict__ ext,
    const double* __restrict__ X, const double* __restrict__ uv, double r[2],
    double* Jc, double* Jp) {
  const double d0 = X[0] - t[0];
  const double d1 = X[1] - t[1];
  const double d2 = X[2] - t[2];
  const double pb[3] = {R[0] * d0 + R[3] * d1 + R[6] * d2,
                        R[1] * d0 + R[4] * d1 + R[7] * d2,
                        R[2] * d0 + R[5] * d1 + R[8] * d2};
  double pc[3];
  if (ext) {
    const double* Rb = ext;
    const double q0 = pb[0] - ext[9], q1 = pb[1] - ext[10],
                 q2 = pb[2] - ext[11];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      pc[i] = Rb[i] * q0 + Rb[3 + i] * q1 + Rb[6 + i] * q2;
  } else {
#pragma unroll
    for (int i = 0; i < 3; ++i) pc[i] = pb[i];
  }
  if (!(pc[2] > kCheiralityEps)) {
    penalty(r, Jc, 6, Jp);
    return;
  }
  const double fx = K[0], fy = K[1], s = K[2], u0 = K[3], v0 = K[4];
  const double x = pc[0] / pc[2], y = pc[1] / pc[2];
  r[0] = fx * x + s * y + u0 - uv[0];
  r[1] = fy * y + v0 - uv[1];
  if (!Jc) return;

  const double iz = 1.0 / pc[2];
  // Mm = [[fx, s], [0, fy]] * [[1/z, 0, -x/z], [0, 1/z, -y/z]]
  double n[2][3] = {{fx * iz, s * iz, -(fx * x + s * y) * iz},
                    {0.0, fy * iz, -(fy * y) * iz}};
  if (ext) {   // N = Mm Rb^T
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const double m0 = n[i][0], m1 = n[i][1], m2 = n[i][2];
#pragma unroll
      for (int j = 0; j < 3; ++j)
        n[i][j] = m0 * ext[3 * j] + m1 * ext[3 * j + 1] + m2 * ext[3 * j + 2];
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    double* row = Jc + 6 * i;
    row[0] = n[i][1] * pb[2] - n[i][2] * pb[1];
    row[1] = n[i][2] * pb[0] - n[i][0] * pb[2];
    row[2] = n[i][0] * pb[1] - n[i][1] * pb[0];
    row[3] = -n[i][0];
    row[4] = -n[i][1];
    row[5] = -n[i][2];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      Jp[3 * i + j] = n[i][0] * R[3 * j + 0] + n[i][1] * R[3 * j + 1] +
                      n[i][2] * R[3 * j + 2];
  }
}

}  // namespace proj
