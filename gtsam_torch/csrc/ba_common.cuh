// Shared helpers of the bundle-adjustment kernels (float64 throughout).
//
// Every kernel file exposes plain C entry points, loaded with ctypes
// (gtsam_torch/_build.py).  An entry point launches on the stream it is
// given, never synchronises, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

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

// Launch `kernel` cooperatively, in clusters of `cluster` CTAs of `threads`
// threads, as many as the card holds at once with `shm` bytes of dynamic
// shared memory each, and no more than max_ctas (rounded up to whole
// clusters; 0: no cap).  A kernel whose CTAs wait on one another (a grid
// barrier, or flags set by other CTAs) needs them all resident: kernel 8's
// solves, kernels 13 and 14's, kernel 16's loop.  The occupancy query (and
// the shared-memory attribute) runs once a kernel, shape and device; later
// launches take the cached count (the query cost 12-14 us a launch).
// cudaErrorCooperativeLaunchTooLarge: not one CTA of that shape fits.
template <typename... Args, typename... Act>
int launch_levels(void (*kernel)(Args...), int threads, int cluster,
                  size_t shm, int max_ctas, cudaStream_t stream,
                  Act... args) {
  struct Seen {
    void (*fn)(Args...);
    int device, threads, cluster;
    size_t shm;
    int ncl;
  };
  static std::mutex mu;
  static std::vector<Seen> seen;
  cudaError_t e = cudaSuccess;
  int device = 0;
  e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute at[2];
  at[0].id = cudaLaunchAttributeCooperative;
  at[0].val.cooperative = 1;
  at[1].id = cudaLaunchAttributeClusterDimension;
  at[1].val.clusterDim.x = cluster;
  at[1].val.clusterDim.y = 1;
  at[1].val.clusterDim.z = 1;
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = shm;
  cfg.stream = stream;
  cfg.attrs = at;
  cfg.numAttrs = 2;
  int ncl = -1;
  {
    std::lock_guard<std::mutex> hold(mu);
    for (const Seen& x : seen)
      if (x.fn == kernel && x.device == device && x.threads == threads &&
          x.cluster == cluster && x.shm == shm)
        ncl = x.ncl;
  }
  if (ncl < 0) {
    // the opt-in to dynamic shared memory: the most any launch of this
    // kernel on this device has asked for (never lowered, so a launch that
    // takes a cached count still fits), and for any amount (static and
    // dynamic shared memory over 48 KB need it together)
    size_t most = shm;
    {
      std::lock_guard<std::mutex> hold(mu);
      for (const Seen& x : seen)
        if (x.fn == kernel && x.device == device && x.shm > most)
          most = x.shm;
    }
    if (most > 0)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)most);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveClusters(&ncl, kernel, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (ncl < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    std::lock_guard<std::mutex> hold(mu);
    seen.push_back({kernel, device, threads, cluster, shm, ncl});
  }
  const int want = (max_ctas + cluster - 1) / cluster;
  if (max_ctas > 0 && want < ncl) ncl = want;
  cfg.gridDim = dim3(ncl * cluster);
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace gt
