// Kernel 4: landmark back-substitution of the Schur step.
//
// Replaces: gtsam_tpu/sfm/ba.py::schur_solve back-substitution
// (:1264-1272): _wt27_prod, the point _grouped_reduce and the 3x3 _flat_mm
// (and their two-float forms in _schur_solve_df, :1020-1036).
//
// Per point p over its run of the point-sorted observations:
//   dl_p = C_p (gl_p - sum_k W_k^T dc[cam_k]),
// written at p, which is the original point id (the plan sorts the
// observations by point id).  A point with no observation gets dl = 0.
//
// Bound and design: the point pass of csrc/ba_point_pass.cuh with C and gl
// (one block per row tile of the plan, W staged in shared memory with
// 16-byte loads, a thread per row, then a thread per point): 0.064 ms
// against a 0.041 ms bound on an H100 SXM.  Its first version ran a warp
// per point for every tile: at 3.9 rows per track, 28 of 32 lanes idled and
// every row was read at a 216-byte stride between lanes (0.101 ms).
#include "ba_point_pass.cuh"

GT_EXPORT int gt_ba_back_substitute(int T, const int* pt_ptr,
                                    const int* pt_tile, const int* obs_cam,
                                    const double* W, const double* dc,
                                    const double* C, const double* gl,
                                    double* dl, void* stream) {
  if (T > 0) {
    namespace pp = gt::point_pass;
    pp::point_pass_kernel<true><<<T, pp::kThreads, 0, (cudaStream_t)stream>>>(
        pt_ptr, pt_tile, obs_cam, W, dc, C, gl, dl);
  }
  return (int)cudaGetLastError();
}
