// Shared helpers of the bundle-adjustment kernels (float64 throughout).
//
// Every kernel file exposes plain C entry points, loaded with ctypes
// (gtsam_torch/_build.py).  An entry point launches on the stream it is
// given, never synchronises, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define GT_EXPORT extern "C" __attribute__((visibility("default")))

namespace gt {

constexpr int kWarp = 32;

// Butterfly sum over the 32 lanes of a warp; every lane ends with the total.
// The order of additions is fixed, so the result is reproducible.
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Adjugate inverse of a 3x3 matrix, row-major; the same expression order as
// gtsam_tpu/sfm/ba.py::_inv3x3_flat.
__device__ __forceinline__ void inv3x3(const double h[9], double out[9]) {
  const double a = h[0], b = h[1], c = h[2];
  const double d = h[3], e = h[4], f = h[5];
  const double g = h[6], hh = h[7], i = h[8];
  const double A = e * i - f * hh;
  const double B = c * hh - b * i;
  const double C = b * f - c * e;
  const double D = f * g - d * i;
  const double E = a * i - c * g;
  const double F = c * d - a * f;
  const double G = d * hh - e * g;
  const double Hc = b * g - a * hh;
  const double I = a * e - b * d;
  const double inv_det = 1.0 / (a * A + b * D + c * G);
  out[0] = A * inv_det; out[1] = B * inv_det; out[2] = C * inv_det;
  out[3] = D * inv_det; out[4] = E * inv_det; out[5] = F * inv_det;
  out[6] = G * inv_det; out[7] = Hc * inv_det; out[8] = I * inv_det;
}

}  // namespace gt
