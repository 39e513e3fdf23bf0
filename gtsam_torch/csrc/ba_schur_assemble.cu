// Kernel 3: assembly of the Jacobi-equilibrated reduced camera matrix S
// (9M x 9M, camera-major: row 9*c + i, rows ld entries apart) and the
// reduced camera gradient.
//
// Replaces: gtsam_tpu/sfm/ba.py::schur_solve camera reduce (:1103-1108,
// :1134), pair products and cell reduce (:1142-1213), _assemble_S_planes
// (:543), the Hpp damping (:1217-1221) and the equilibration of
// _dense_spd_solve (:468-470).  The JAX package assembles in a
// parameter-major layout (row i*M + c) to suit TPU tiling; camera-major is a
// symmetric permutation of it, so the Cholesky solution is the same.
//
// The plan groups the directed pairs (a, b) of every point's observations
// by cell (camera of a, camera of b): a CSR over cell_a / cell_b with the
// cells sorted.  Each cell of S is computed by one block and written once,
// already scaled: no atomics, and every sum runs in a fixed order, so two
// assemblies of the same inputs give the same bits.
// (a) ba_camera_assemble: one block per camera c.  Hpp over the camera CSR
//     (cam_ptr, cam_obs), damped (Hpp + lam I, or Hpp * (1 + lam) on the
//     diagonal), minus sum WC_a W_b^T over the pairs of cell (c, c) (a == b,
//     and a != b for a track that sees c twice) gives the diagonal block
//     D_c; s_c = rsqrt(clamp(diag D_c, 1e-12)) and D_c s_c s_c^T go to s
//     and S; g~ = sum A_cam^T b - sum corr.
// (b) ba_pair_assemble: one block per off-diagonal cell (ca, cb), after
//     (a) on the same stream: -sum WC_a W_b^T scaled by s_ca s_cb^T.
// In both, the block's 126 working threads form 14 groups of 9: a group
// takes every 14th observation or pair of the run, each of its threads a
// 3x3 tile of the 9x9 block, and the 14 partial blocks are summed in group
// order in shared memory.  So a cell with hundreds of pairs (604 at the
// Ladybug shape) is spread over the block, not walked by one thread.
// Thread t < 81 then writes entry (t / 9, t % 9): each 9-double row of a
// block is stored by 9 consecutive threads.
//
// Mixed-precision variants: A_cam comes as float and S is stored as float
// (the kernels are templated on both types).  Every sum and the scaling
// run in double; each entry of S is rounded once, at its store (the JAX
// package's "hi-summed cells round once", gtsam_tpu/sfm/ba.py:1227-1233).
// (a) then also writes the damped Hpp_c before its cell's pairs are taken
// off (M x 81 doubles), the diagonal term of the implicit Schur matvec of
// the refinement (csrc/ba_schur_matvec.cu).
//
// Bound on the H100: bytes.  (a) reads A_cam, b and corr (232 B) and, for
// the pairs of the diagonal cells, WC and W (432 B) of every observation;
// (b) reads WC and W of the observations in off-diagonal pairs and writes
// each touched cell (648 B) once.  The zero-fill of the untouched cells of
// S (1.92 GB at Ladybug shape) is a plain memset outside these kernels.
#include "ba_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kGroups = 14;  // 14 groups of 9 threads: 126 working threads
constexpr int kRed = 81 + 81 + 18;  // per group: Hpp, pair sums, gp and corr

// Adds sum WC_a W_b^T over the pairs q = q0 + g, q0 + g + kGroups, ... < q1
// to this thread's 3x3 tile (rows 3 ti.., columns 3 tl..) in acc.
__device__ __forceinline__ void pair_tile(int q0, int q1, int g, int ti,
                                          int tl, const int* cell_a,
                                          const int* cell_b, const double* WC,
                                          const double* W, double acc[9]) {
  for (int q = q0 + g; q < q1; q += kGroups) {
    const double* x = WC + 27 * (int64_t)cell_a[q] + 9 * ti;
    const double* y = W + 27 * (int64_t)cell_b[q] + 9 * tl;
    double xv[9], yv[9];
#pragma unroll
    for (int m = 0; m < 9; ++m) {
      xv[m] = x[m];
      yv[m] = y[m];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int l = 0; l < 3; ++l)
        acc[3 * i + l] += xv[3 * i] * yv[3 * l] + xv[3 * i + 1] * yv[3 * l + 1] +
                          xv[3 * i + 2] * yv[3 * l + 2];
  }
}

// Stores a thread's 3x3 tile into entries 9 * (3 ti + i) + 3 tl + l of red.
__device__ __forceinline__ void put_tile(double* red, int ti, int tl,
                                         const double acc[9]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int l = 0; l < 3; ++l) red[9 * (3 * ti + i) + 3 * tl + l] = acc[3 * i + l];
}

__device__ __forceinline__ double group_sum(const double (*red)[kRed], int e) {
  double v = 0.0;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) v += red[g][e];
  return v;
}

template <typename TA, typename TS>
__global__ void __launch_bounds__(kThreads) ba_camera_assemble_kernel(
    int M, int ld, const int* __restrict__ cam_ptr,
    const int* __restrict__ cam_obs, const TA* __restrict__ A_cam,
    const double* __restrict__ b,
    const double* __restrict__ corr, const int* __restrict__ cell_ptr,
    const int* __restrict__ diag_cell, const int* __restrict__ cell_a,
    const int* __restrict__ cell_b, const double* __restrict__ WC,
    const double* __restrict__ W, double lam, int diagonal_damping,
    TS* __restrict__ S, double* __restrict__ s_out,
    double* __restrict__ g_out, double* __restrict__ Hpp_d) {
  __shared__ double red[kGroups][kRed];
  __shared__ double s_s[9];
  const int c = blockIdx.x;
  const int t = threadIdx.x;
  if (t < 9 * kGroups) {
    const int g = t / 9, ti = (t % 9) / 3, tl = t % 3;
    double h[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
    double pr[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
    double gp[3] = {0, 0, 0}, cr[3] = {0, 0, 0};
    for (int q = cam_ptr[c] + g; q < cam_ptr[c + 1]; q += kGroups) {
      const int64_t k = cam_obs[q];
      const TA* ac = A_cam + 18 * k;
      double x0[3], x1[3], y0[3], y1[3];
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        x0[m] = ac[3 * ti + m];
        x1[m] = ac[9 + 3 * ti + m];
        y0[m] = ac[3 * tl + m];
        y1[m] = ac[9 + 3 * tl + m];
      }
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int l = 0; l < 3; ++l) h[3 * i + l] += x0[i] * y0[l] + x1[i] * y1[l];
      if (tl == 0) {
        const double b0 = b[2 * k], b1 = b[2 * k + 1];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          gp[i] += x0[i] * b0 + x1[i] * b1;
          cr[i] += corr[9 * k + 3 * ti + i];
        }
      }
    }
    const int dc = diag_cell[c];
    if (dc >= 0)
      pair_tile(cell_ptr[dc], cell_ptr[dc + 1], g, ti, tl, cell_a, cell_b, WC,
                W, pr);
    put_tile(red[g], ti, tl, h);
    put_tile(red[g] + 81, ti, tl, pr);
    if (tl == 0) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        red[g][162 + 3 * ti + i] = gp[i];
        red[g][171 + 3 * ti + i] = cr[i];
      }
    }
  }
  __syncthreads();

  const int i = t / 9, l = t % 9;
  double v = 0.0;
  if (t < 81) {
    double hs = group_sum(red, t);
    if (i == l) hs = diagonal_damping ? hs * (1.0 + lam) : hs + lam;
    if (Hpp_d) Hpp_d[81 * (int64_t)c + t] = hs;
    v = hs - group_sum(red, 81 + t);
    if (i == l) {
      // clamp as torch.clamp does: a NaN stays NaN
      const double sc = 1.0 / sqrt(v < 1e-12 ? 1e-12 : v);
      s_s[i] = sc;
      s_out[9 * (int64_t)c + i] = sc;
    }
  } else if (t < 90) {
    const int r = t - 81;
    g_out[9 * (int64_t)c + r] = group_sum(red, 162 + r) - group_sum(red, 171 + r);
  }
  __syncthreads();
  if (t < 81) {
    S[(9 * (int64_t)c + i) * ld + 9 * (int64_t)c + l] =
        (TS)(v * s_s[i] * s_s[l]);
  }
}

template <typename TS>
__global__ void __launch_bounds__(kThreads) ba_pair_assemble_kernel(
    int M, int ld, const int* __restrict__ cell_ptr,
    const int* __restrict__ cell_ca,
    const int* __restrict__ cell_cb, const int* __restrict__ cell_a,
    const int* __restrict__ cell_b, const double* __restrict__ WC,
    const double* __restrict__ W, const double* __restrict__ s,
    TS* __restrict__ S) {
  __shared__ double red[kGroups][kRed];
  const int cell = blockIdx.x;
  const int t = threadIdx.x;
  const int ca = cell_ca[cell], cb = cell_cb[cell];
  if (ca == cb) return;  // diagonal cells are ba_camera_assemble's
  if (t < 9 * kGroups) {
    const int g = t / 9, ti = (t % 9) / 3, tl = t % 3;
    double pr[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
    pair_tile(cell_ptr[cell], cell_ptr[cell + 1], g, ti, tl, cell_a, cell_b,
              WC, W, pr);
    put_tile(red[g], ti, tl, pr);
  }
  __syncthreads();
  if (t < 81) {
    const int i = t / 9, l = t % 9;
    const double v = -group_sum(red, t);
    S[(9 * (int64_t)ca + i) * ld + 9 * (int64_t)cb + l] =
        (TS)(v * s[9 * (int64_t)ca + i] * s[9 * (int64_t)cb + l]);
  }
}

template <typename TA, typename TS>
int launch_camera_assemble(int M, int ld, const int* cam_ptr,
                           const int* cam_obs,
                           const TA* A_cam, const double* b, const double* corr,
                           const int* cell_ptr, const int* diag_cell,
                           const int* cell_a, const int* cell_b,
                           const double* WC, const double* W, double lam,
                           int diagonal_damping, TS* S, double* s, double* g,
                           double* Hpp_d, void* stream) {
  if (M > 0) {
    ba_camera_assemble_kernel<TA, TS>
        <<<M, kThreads, 0, (cudaStream_t)stream>>>(
            M, ld, cam_ptr, cam_obs, A_cam, b, corr, cell_ptr, diag_cell,
            cell_a, cell_b, WC, W, lam, diagonal_damping, S, s, g, Hpp_d);
  }
  return (int)cudaGetLastError();
}

template <typename TS>
int launch_pair_assemble(int U, int M, int ld, const int* cell_ptr,
                         const int* cell_ca, const int* cell_cb,
                         const int* cell_a, const int* cell_b,
                         const double* WC, const double* W, const double* s,
                         TS* S, void* stream) {
  if (U > 0) {
    ba_pair_assemble_kernel<TS><<<U, kThreads, 0, (cudaStream_t)stream>>>(
        M, ld, cell_ptr, cell_ca, cell_cb, cell_a, cell_b, WC, W, s, S);
  }
  return (int)cudaGetLastError();
}

}  // namespace

GT_EXPORT int gt_ba_camera_assemble(
    int M, int ld, const int* cam_ptr, const int* cam_obs, const double* A_cam,
    const double* b, const double* corr, const int* cell_ptr,
    const int* diag_cell, const int* cell_a, const int* cell_b,
    const double* WC, const double* W, double lam, int diagonal_damping,
    double* S, double* s, double* g, void* stream) {
  return launch_camera_assemble(M, ld, cam_ptr, cam_obs, A_cam, b, corr,
                                cell_ptr,
                                diag_cell, cell_a, cell_b, WC, W, lam,
                                diagonal_damping, S, s, g, (double*)nullptr,
                                stream);
}

// The mixed-precision variant: A_cam float, S stored float, and the damped
// Hpp blocks (M x 81 doubles) written to Hpp_d.
GT_EXPORT int gt_ba_camera_assemble_f32(
    int M, int ld, const int* cam_ptr, const int* cam_obs, const float* A_cam,
    const double* b, const double* corr, const int* cell_ptr,
    const int* diag_cell, const int* cell_a, const int* cell_b,
    const double* WC, const double* W, double lam, int diagonal_damping,
    float* S, double* s, double* g, double* Hpp_d, void* stream) {
  return launch_camera_assemble(M, ld, cam_ptr, cam_obs, A_cam, b, corr,
                                cell_ptr,
                                diag_cell, cell_a, cell_b, WC, W, lam,
                                diagonal_damping, S, s, g, Hpp_d, stream);
}

GT_EXPORT int gt_ba_pair_assemble(int U, int M, int ld, const int* cell_ptr,
                                  const int* cell_ca, const int* cell_cb,
                                  const int* cell_a, const int* cell_b,
                                  const double* WC, const double* W,
                                  const double* s, double* S, void* stream) {
  return launch_pair_assemble(U, M, ld, cell_ptr, cell_ca, cell_cb, cell_a,
                              cell_b,
                              WC, W, s, S, stream);
}

// The mixed-precision variant: S stored float.
GT_EXPORT int gt_ba_pair_assemble_f32(int U, int M, int ld,
                                      const int* cell_ptr,
                                      const int* cell_ca, const int* cell_cb,
                                      const int* cell_a, const int* cell_b,
                                      const double* WC, const double* W,
                                      const double* s, float* S,
                                      void* stream) {
  return launch_pair_assemble(U, M, ld, cell_ptr, cell_ca, cell_cb, cell_a,
                              cell_b,
                              WC, W, s, S, stream);
}
