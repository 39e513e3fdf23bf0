// Kernel 10: factor and invert one diagonal block of the blocked dense
// Cholesky (float64, and float32 for the mixed mode).
//
// Replaces: gtsam_tpu/linear/dense_blocked.py::blocked_cholesky's panel
// leaf (:83-85): jnp.linalg.cholesky of the panel's diagonal block D and
// the triangular solve that inverts its factor L_D.
//
// One launch per panel of gtsam_torch/linear/dense_blocked.py: D =
// S[o:o+w, o:o+w] (the lower triangle, already updated by the earlier
// panels; w = 128, or less for the last panel) is staged in shared memory
// as the 10 lower 32 x 32 tiles of a 128 x 128 block, the rows and columns
// past w set to the identity, and factored right-looking over its 4 tile
// columns.  L_D goes back into S's lower triangle (the strict upper
// triangle of S is never read or written), L_D^-1 to Dinv[k] (128 x 128
// row-major, zero above the diagonal, the identity past w).  The first
// pivot that is not positive and finite is recorded in *info as its column
// + 1 (LAPACK's convention), once: a later failure leaves an earlier one in
// place.
//
// Bound on the H100: the block's bytes, ~0.08 us on the card (~10 us at
// one SM's share of its bandwidth, the design's one CTA); what sets the
// time is the chain of the 4 diagonal tiles' factorizations, 128
// dependent pivots, each tile's row of tiles below solved and the next
// diagonal tile updated between them.  The design keeps everything else
// off that chain:
//   - a diagonal tile is factored by one warp, a lane per row, the row in
//     registers, each lane's diagonal updated from its own values (one
//     reciprocal square root a pivot), the pivot column passed through
//     shared memory (by shuffles the kernel took 47 us in float64 on an
//     H100, against 36: scripts/port_dense_probe.py);
//   - the tiles below it are solved against it row by row (a lane per row,
//     forward substitution), not multiplied by its inverse, so the tile
//     inverse X_tt (needed only for Dinv) is formed by another warp beside
//     that solve;
//   - the next diagonal tile is updated (warps 0 and 1) and factored at
//     once (warp 0); the tile below it is solved against it as it is
//     factored (warp 1, 4 columns behind, flagged through shared memory),
//     having been solved and updated by the column before, so that the
//     chain from one diagonal tile to the next is an update and a
//     factorization; the other warps solve the other tiles, update the
//     rest of the trailing tiles, compose L_D^-1 tile by tile (X_ij =
//     -X_ii sum_{m=j}^{i-1} L_im X_mj) and write finished tiles to S and
//     Dinv;
//   - the tile products are jobs of a 32 x 16 strip a warp: on the FP64
//     tensor cores (mma.sync m16n8k16) in float64, reading fragments from
//     tiles of row pitch 36 (no bank conflicts), and as 4 x 4 micro-tiles
//     on the CUDA cores in float32 (TF32 is not used: the mixed mode's
//     float64 refinement is sized for float32 rounding).
// One CTA barrier a tile column; 8 warps, so no thread is held to 128
// registers.  The device code is chol_tiles.cuh's factor_block, which
// kernel 7's front kernel (sn_factor.cu) shares.

#include "chol_tiles.cuh"

namespace {

using namespace chol;

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) dense_factor_diag_kernel(
    int n, int ld, int k, T* __restrict__ S, T* __restrict__ Dinv,
    int* __restrict__ info) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T rinv[kNT * kTile];
  __shared__ __align__(16) T lt[kNT * kTile * kLtPitch];
  __shared__ int ready[kNT * 8];
  Block<T> b;
  b.A = reinterpret_cast<T*>(smem);
  b.X = b.A + kTiles * kTileSz<T>;
  b.rinv = rinv;
  b.lt = lt;
  b.ready = ready;
  b.o = k * kNB;
  b.w = min(kNB, n - b.o);
  b.ld = ld;
  b.S = S + (int64_t)b.o * ld + b.o;
  b.D = Dinv + (int64_t)k * kNB * kNB;
  b.info = info;

  factor_block(b);
}

template <typename T>
int launch_factor(int n, int ld, int k, T* S, T* Dinv, int* info,
                  void* stream) {
  const size_t shm = 2 * kTiles * kTileSz<T> * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(
      dense_factor_diag_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shm);
  if (e != cudaSuccess) return (int)e;
  dense_factor_diag_kernel<T><<<1, kThreads, shm, (cudaStream_t)stream>>>(
      n, ld, k, S, Dinv, info);
  return (int)cudaGetLastError();
}

}  // namespace

// S: n x n row-major, rows ld entries apart (lower triangle read and
// written); Dinv: panels x 128 x 128; info: one int, 0 until a pivot fails.
// k: the panel (0 <= k < ceil(n / 128)).
GT_EXPORT int gt_dense_factor_diag(int n, int ld, int k, double* S,
                                   double* Dinv, int* info, void* stream) {
  return launch_factor<double>(n, ld, k, S, Dinv, info, stream);
}

GT_EXPORT int gt_dense_factor_diag_f32(int n, int ld, int k, float* S,
                                       float* Dinv, int* info, void* stream) {
  return launch_factor<float>(n, ld, k, S, Dinv, info, stream);
}
