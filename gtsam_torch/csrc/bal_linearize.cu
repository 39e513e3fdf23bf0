// Kernel 1: BAL projection linearization and half-chi2.
//
// Replaces: gtsam_tpu/sfm/bal.py::_projection_residual (:182) linearized by
// gtsam_tpu/graph/factors.py::linearize (:147, jacfwd + vmap) with the unit
// noise model of gtsam_tpu/sfm/ba.py:1319, and error_fn (ba.py:1338).
//
// Per observation k: p_c = R^T (p - t); x = p_c/z;
// pixel = f (1 + k1 r2 + k2 r2^2) x; r = pixel - uv.  Jacobians are
// analytic at the right retraction of gtsam_torch/geometry/cameras.py:
// d p_c / d omega = [p_c]x, d p_c / d v = -I, d p_c / d point = R^T, then the
// calibration columns f, k1, k2.  At z <= 1e-8 the residual is the constant
// 1e3 and both Jacobians are exactly zero (the cheirality penalty).
//
// Bound on the H100: bytes.  About 60 FP64 operations against ~232 bytes of
// traffic per observation (indices, uv, the 2x9 + 2x3 Jacobians and b), far
// below the card's ~10 FP64 flop/byte balance point.  The camera and point
// parameters are gathered through L2 (1723 cameras fit it); rows are sorted
// by point, so points are read almost in order.
//
// Linearization design: one thread per observation computes its row in
// registers, and each warp owns a tile of 32 consecutive rows.  The rows'
// outputs are contiguous spans of A_cam (32 x 18 T), A_pt (32 x 6 T) and
// b (32 x 16 B), so the warp first writes its rows into a shared-memory
// copy of those spans, then copies each span out linearly, one 16-byte
// vector per lane, so every store instruction writes whole 128-byte lines.
// Only __syncwarp orders the two steps.  A partial last tile stores only
// its rows.  The Jacobians' type T is double, or float for the
// mixed-precision mode (gtsam_tpu/graph/factors.py:147-176 with
// out_dtype=f32, b_dtype=f64): every value is computed in double and
// rounded once at the store; b stays double.
//   - double: rows write 16-byte pairs at strides of 144, 48 and 16 bytes,
//     which put the 8 lanes of each quarter-warp on distinct banks; a tile
//     is 6.5 KB, and 128-thread blocks (4 tiles, 26 KB) stay under the
//     48 KB static shared-memory limit.
//   - float: an A_cam row is 72 bytes and an A_pt row 24, not multiples of
//     16, so rows write 8-byte pairs; at strides of 18 and 6 words the 16
//     lanes of each half-warp hit distinct bank pairs.  The spans of a
//     whole tile (2304 and 768 bytes) stay 16-byte aligned, so the copy-out
//     keeps its 16-byte vectors and adds one 8-byte store when a partial
//     tile has an odd number of rows.  A tile is 3.5 KB.
//
// Half-chi2 design: one launch.  Each block of 256 threads owns 1024 rows;
// each thread sums r^2 of 4 of them (256 apart, so every load is
// coalesced), then the block sums its threads (warp butterflies, then the
// 8 warp sums in order) and writes its partial.  The block that finds,
// through __threadfence and an atomic counter, that it finished last sums
// all partials in index order (a fixed strided split over its threads,
// then the same block tree), writes 0.5 * sum and resets the counter to 0.
// The order of every addition depends only on K, so the same inputs give
// the same bits on every call.  At the Ladybug shape 1024-row blocks (537
// of them) took 0.017 ms of device time on an H100 SXM, 256-row blocks
// (2147: more waves, four times the atomics and partials) 0.022 ms
// (scripts/port_kernel1_time.py).
#include "projection.cuh"

namespace {

constexpr int kThreads = 128;         // bal_linearize_kernel: 4 warp tiles
constexpr int kTileRows = gt::kWarp;  // LINEARIZE_TILE_ROWS in ba_kernels.py
constexpr int kErrorThreads = 256;    // bal_error_kernel
constexpr int kErrorRows = 4;         // rows per thread
constexpr int kErrorBlock = kErrorThreads * kErrorRows;  // ERROR_BLOCK

// Residual (and, when Jc != nullptr, the 2x9 / 2x3 Jacobians, row-major)
// of observation k: projection.cuh's Bundler projection, which kernel 17
// shares.
__device__ __forceinline__ void project(
    int k, const double* __restrict__ cam_R, const double* __restrict__ cam_t,
    const double* __restrict__ calib, const double* __restrict__ points,
    const int* __restrict__ obs_cam, const int* __restrict__ obs_pt,
    const double* __restrict__ uv, double r[2], double* Jc, double* Jp) {
  const int c = obs_cam[k];
  const int p = obs_pt[k];
  proj::project_bal(cam_R + 9 * (int64_t)c, cam_t + 3 * c, calib + 3 * c,
                    points + 3 * (int64_t)p, uv + 2 * (int64_t)k, r, Jc, Jp);
}

template <typename T> struct Pair;
template <> struct Pair<double> { using type = double2; };
template <> struct Pair<float> { using type = float2; };

// A warp's 32 rows of A_cam, A_pt (in T) and b, laid out as in device
// memory.
template <typename T>
struct __align__(16) WarpTile {
  T cam[kTileRows * 18];
  T pt[kTileRows * 6];
  double b[kTileRows * 2];
};

// Copies the first `bytes` (a multiple of 8, at most kMaxBytes) of a
// 16-byte-aligned shared span to a 16-byte-aligned global span: one 16-byte
// vector per lane and step, then the last 8 bytes if `bytes` is not a
// multiple of 16.
template <int kMaxBytes>
__device__ __forceinline__ void copy_out(void* dst, const void* src,
                                         int bytes, int lane) {
  constexpr int kSteps = (kMaxBytes + 16 * gt::kWarp - 1) / (16 * gt::kWarp);
  const int n16 = bytes / 16;
  uint4* d = reinterpret_cast<uint4*>(dst);
  const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const int e = lane + gt::kWarp * j;
    if (e < n16) d[e] = s[e];
  }
  if ((bytes & 15) && lane == 0)
    reinterpret_cast<uint2*>(dst)[2 * n16] =
        reinterpret_cast<const uint2*>(src)[2 * n16];
}

template <typename T>
__global__ void __launch_bounds__(kThreads) bal_linearize_kernel(
    int K, const double* __restrict__ cam_R, const double* __restrict__ cam_t,
    const double* __restrict__ calib, const double* __restrict__ points,
    const int* __restrict__ obs_cam, const int* __restrict__ obs_pt,
    const double* __restrict__ uv, T* __restrict__ A_cam,
    T* __restrict__ A_pt, double* __restrict__ b) {
  using P = typename Pair<T>::type;
  __shared__ WarpTile<T> tiles[kThreads / gt::kWarp];
  const int lane = threadIdx.x % gt::kWarp;
  const int k0 = blockIdx.x * kThreads + threadIdx.x - lane;  // tile's row 0
  if (k0 >= K) return;  // uniform over the warp
  WarpTile<T>& s = tiles[threadIdx.x / gt::kWarp];
  const int n = min(kTileRows, K - k0);

  if (lane < n) {
    double r[2], Jc[18], Jp[6];
    project(k0 + lane, cam_R, cam_t, calib, points, obs_cam, obs_pt, uv, r,
            Jc, Jp);
    P* cam = reinterpret_cast<P*>(s.cam) + 9 * lane;
    P* pt = reinterpret_cast<P*>(s.pt) + 3 * lane;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      P v;
      v.x = (T)Jc[2 * i];
      v.y = (T)Jc[2 * i + 1];
      cam[i] = v;
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      P v;
      v.x = (T)Jp[2 * i];
      v.y = (T)Jp[2 * i + 1];
      pt[i] = v;
    }
    reinterpret_cast<double2*>(s.b)[lane] = make_double2(-r[0], -r[1]);
  }
  __syncwarp();

  constexpr int kBytes = (int)sizeof(T);
  copy_out<kTileRows * 18 * kBytes>(A_cam + 18 * (int64_t)k0, s.cam,
                                       n * 18 * kBytes, lane);
  copy_out<kTileRows * 6 * kBytes>(A_pt + 6 * (int64_t)k0, s.pt,
                                      n * 6 * kBytes, lane);
  copy_out<kTileRows * 16>(b + 2 * (int64_t)k0, s.b, n * 16, lane);
}

// Fixed-order sum over a block of kErrorThreads threads; thread 0 gets the
// total.  sh holds one double per warp.
__device__ __forceinline__ double block_sum(double v, double* sh) {
  v = gt::warp_sum(v);
  if (threadIdx.x % gt::kWarp == 0) sh[threadIdx.x / gt::kWarp] = v;
  __syncthreads();
  double total = 0.0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kErrorThreads / gt::kWarp; ++w) total += sh[w];
  }
  __syncthreads();  // sh may be written again
  return total;
}

__global__ void __launch_bounds__(kErrorThreads) bal_error_kernel(
    int K, const double* __restrict__ cam_R, const double* __restrict__ cam_t,
    const double* __restrict__ calib, const double* __restrict__ points,
    const int* __restrict__ obs_cam, const int* __restrict__ obs_pt,
    const double* __restrict__ uv, double* __restrict__ partial,
    int* __restrict__ counter, double* __restrict__ out) {
  __shared__ double sh[kErrorThreads / gt::kWarp];
  __shared__ bool last;
  double v = 0.0;
#pragma unroll
  for (int j = 0; j < kErrorRows; ++j) {
    const int k = blockIdx.x * kErrorBlock + j * kErrorThreads + threadIdx.x;
    if (k < K) {
      double r[2];
      project(k, cam_R, cam_t, calib, points, obs_cam, obs_pt, uv, r, nullptr,
              nullptr);
      v += r[0] * r[0] + r[1] * r[1];
    }
  }
  v = block_sum(v, sh);
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = v;
    __threadfence();  // the partial is visible before the count says so
    last = atomicAdd(counter, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;

  // the last block: every partial of this launch is written
  __threadfence();
  double t = 0.0;
#pragma unroll 4
  for (int i = threadIdx.x; i < (int)gridDim.x; i += kErrorThreads)
    t += __ldcg(partial + i);  // from L2: written by other SMs
  t = block_sum(t, sh);
  if (threadIdx.x == 0) {
    *out = 0.5 * t;
    *counter = 0;  // ready for the next launch on this stream
  }
}

template <typename T>
int launch_linearize(int K, const double* cam_R, const double* cam_t,
                     const double* calib, const double* points,
                     const int* obs_cam, const int* obs_pt, const double* uv,
                     T* A_cam, T* A_pt, double* b, void* stream) {
  if (K > 0) {
    const int grid = (K + kThreads - 1) / kThreads;
    bal_linearize_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        K, cam_R, cam_t, calib, points, obs_cam, obs_pt, uv, A_cam, A_pt, b);
  }
  return (int)cudaGetLastError();
}

}  // namespace

GT_EXPORT int gt_bal_linearize(int K, const double* cam_R, const double* cam_t,
                               const double* calib, const double* points,
                               const int* obs_cam, const int* obs_pt,
                               const double* uv, double* A_cam, double* A_pt,
                               double* b, void* stream) {
  return launch_linearize(K, cam_R, cam_t, calib, points, obs_cam, obs_pt, uv,
                          A_cam, A_pt, b, stream);
}

// The mixed-precision variant: A_cam and A_pt rounded to float, b double.
GT_EXPORT int gt_bal_linearize_f32(int K, const double* cam_R,
                                   const double* cam_t, const double* calib,
                                   const double* points, const int* obs_cam,
                                   const int* obs_pt, const double* uv,
                                   float* A_cam, float* A_pt, double* b,
                                   void* stream) {
  return launch_linearize(K, cam_R, cam_t, calib, points, obs_cam, obs_pt, uv,
                          A_cam, A_pt, b, stream);
}

// partial must hold max(1, ceil(K / 1024)) doubles (ERROR_BLOCK in
// sfm/ba_kernels.py); counter is an int that is 0 between launches (the
// kernel leaves it so); out is one double.  Launches even at K = 0, so out
// is always written.
GT_EXPORT int gt_bal_error(int K, const double* cam_R, const double* cam_t,
                           const double* calib, const double* points,
                           const int* obs_cam, const int* obs_pt,
                           const double* uv, double* partial, int* counter,
                           double* out, void* stream) {
  const int grid = K > 0 ? (K + kErrorBlock - 1) / kErrorBlock : 1;
  bal_error_kernel<<<grid, kErrorThreads, 0, (cudaStream_t)stream>>>(
      K, cam_R, cam_t, calib, points, obs_cam, obs_pt, uv, partial, counter,
      out);
  return (int)cudaGetLastError();
}
