// Kernel 3: assembly of the dense reduced camera matrix S (9M x 9M,
// camera-major: row 9*c + i) and the reduced camera gradient.
//
// Replaces: gtsam_tpu/sfm/ba.py::schur_solve camera reduce (:1103-1108,
// :1134), pair products and cell reduce (:1142-1213), _assemble_S_planes
// (:543) and the Hpp damping (:1217-1221).  The JAX package assembles in a
// parameter-major layout (row i*M + c) to suit TPU tiling; camera-major is a
// symmetric permutation of it, so the Cholesky solution is the same.
//
// (a) ba_camera_assemble: one block per camera over the camera CSR
//     (cam_ptr, cam_obs): Hpp = sum A_cam^T A_cam, damped (Hpp + lam I, or
//     Hpp * (1 + lam) on the diagonal), stored into S's diagonal block;
//     g~ = sum A_cam^T b - sum corr.  Thread t < 81 owns Hpp entry t,
//     threads 81..89 the gradient: no atomics, since ~319 observations hit
//     each camera at Ladybug shape and atomics there would serialise.
// (b) ba_pair_assemble: one block per point; for every DIRECTED pair (a, b)
//     of its observations (the plan's pair list), S[cam_a, cam_b] -=
//     WC_a W_b^T with float64 atomicAdd.  Directed pairs give the full
//     symmetric S and need no special case for a track that sees one camera
//     twice.  Atomic order changes from run to run, so S is reproducible
//     only to rounding.
// The caller zeroes S and launches (a) before (b) on one stream.
//
// Bound on the H100: bytes.  (a) reads A_cam, b and corr once per
// observation (232 B); (b) reads WC and W (432 B per observation, re-read
// through L1/L2 for each pair) and read-modify-writes the touched 9x9
// cells.  The zero-fill of S (1.92 GB at Ladybug shape) is the largest
// single cost and is a plain memset outside these kernels.
#include "ba_common.cuh"

namespace {

constexpr int kCamThreads = 96;   // 81 Hpp entries + 9 gradient entries
constexpr int kPairThreads = 128;

__global__ void __launch_bounds__(kCamThreads) ba_camera_assemble_kernel(
    int M, const int* __restrict__ cam_ptr, const int* __restrict__ cam_obs,
    const double* __restrict__ A_cam, const double* __restrict__ b,
    const double* __restrict__ corr, double lam, int diagonal_damping,
    double* __restrict__ S, double* __restrict__ g) {
  const int c = blockIdx.x;
  const int t = threadIdx.x;
  const int s = cam_ptr[c], e = cam_ptr[c + 1];
  const int64_t n = 9 * (int64_t)M;
  if (t < 81) {
    const int i = t / 9, j = t % 9;
    double acc = 0.0;
    for (int q = s; q < e; ++q) {
      const double* ac = A_cam + 18 * (int64_t)cam_obs[q];
      acc += ac[i] * ac[j] + ac[9 + i] * ac[9 + j];
    }
    if (i == j) acc = diagonal_damping ? acc * (1.0 + lam) : acc + lam;
    S[(9 * (int64_t)c + i) * n + 9 * (int64_t)c + j] = acc;
  } else if (t < 90) {
    const int i = t - 81;
    double gp = 0.0, cr = 0.0;
    for (int q = s; q < e; ++q) {
      const int64_t k = cam_obs[q];
      const double* ac = A_cam + 18 * k;
      gp += ac[i] * b[2 * k] + ac[9 + i] * b[2 * k + 1];
      cr += corr[9 * k + i];
    }
    g[9 * (int64_t)c + i] = gp - cr;
  }
}

__global__ void __launch_bounds__(kPairThreads) ba_pair_assemble_kernel(
    int N, int M, const int* __restrict__ pair_ptr,
    const int* __restrict__ pair_a, const int* __restrict__ pair_b,
    const int* __restrict__ obs_cam, const double* __restrict__ WC,
    const double* __restrict__ W, double* __restrict__ S) {
  const int p = blockIdx.x;
  const int q0 = pair_ptr[p];
  // 64-bit: a track of l >= 5149 observations has l * l * 81 >= 2^31 entries
  const int64_t total = (int64_t)(pair_ptr[p + 1] - q0) * 81;
  const int64_t n = 9 * (int64_t)M;
  for (int64_t w = threadIdx.x; w < total; w += kPairThreads) {
    const int q = q0 + (int)(w / 81);
    const int ent = (int)(w % 81);
    const int i = ent / 9, l = ent % 9;
    const int64_t a = pair_a[q], bb = pair_b[q];
    const double* wc = WC + 27 * a + 3 * i;
    const double* wv = W + 27 * bb + 3 * l;
    const double v = wc[0] * wv[0] + wc[1] * wv[1] + wc[2] * wv[2];
    atomicAdd(S + (9 * (int64_t)obs_cam[a] + i) * n + 9 * (int64_t)obs_cam[bb] + l,
              -v);
  }
}

}  // namespace

GT_EXPORT int gt_ba_camera_assemble(int M, const int* cam_ptr,
                                    const int* cam_obs, const double* A_cam,
                                    const double* b, const double* corr,
                                    double lam, int diagonal_damping,
                                    double* S, double* g, void* stream) {
  if (M > 0) {
    ba_camera_assemble_kernel<<<M, kCamThreads, 0, (cudaStream_t)stream>>>(
        M, cam_ptr, cam_obs, A_cam, b, corr, lam, diagonal_damping, S, g);
  }
  return (int)cudaGetLastError();
}

GT_EXPORT int gt_ba_pair_assemble(int N, int M, const int* pair_ptr,
                                  const int* pair_a, const int* pair_b,
                                  const int* obs_cam, const double* WC,
                                  const double* W, double* S, void* stream) {
  if (N > 0) {
    ba_pair_assemble_kernel<<<N, kPairThreads, 0, (cudaStream_t)stream>>>(
        N, M, pair_ptr, pair_a, pair_b, obs_cam, WC, W, S);
  }
  return (int)cudaGetLastError();
}
