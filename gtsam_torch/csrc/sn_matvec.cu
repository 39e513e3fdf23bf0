// Kernel 9: the block-sparse symmetric matvec of the refinement residual
// (float64).
//
// Replaces: gtsam_tpu/linear/supernodal.py::matvec (:456-476; plan
// :293-300): y = (H + damping) x on the lower block store, x and y (n x d)
// in the permuted layout.
//
// One warp per variable v.  Its lanes stride over v's row blocks (every
// stored block with row v, in the plan's sorted order) adding B_k x[col_k],
// and over its off-diagonal column blocks adding B_k^T x[row_k]; each sum is
// then folded by a fixed butterfly, and lane i < d writes
// y_i = row_i + col_i + damp_i x_i (damp: lam, or lam * clip(H_vv[i, i]), on
// true dimensions).  No atomics: the same bits on every run.
// Bound on the H100: bytes (the store, ~36 MB at the sphere shape, read
// once; x gathered through L2).
#include "ba_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxD = 12;

__global__ void __launch_bounds__(kThreads) sn_matvec_kernel(
    int n, int d, const double* __restrict__ blocks,
    const double* __restrict__ x, const int* __restrict__ row_ptr,
    const int* __restrict__ row_blk, const int* __restrict__ col_ptr,
    const int* __restrict__ col_blk, const int* __restrict__ block_row,
    const int* __restrict__ block_col, const int* __restrict__ dbc,
    const double* __restrict__ pad_diag, double lam, int diagonal_damping,
    double min_diag, double max_diag, double* __restrict__ y) {
  const int64_t v = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (v >= n) return;
  const int dd = d * d;
  double ar[kMaxD], ac[kMaxD];
#pragma unroll
  for (int i = 0; i < kMaxD; ++i) ar[i] = ac[i] = 0.0;
  for (int k = row_ptr[v] + lane; k < row_ptr[v + 1]; k += 32) {
    const int64_t b = row_blk[k];
    const double* B = blocks + b * dd;
    const double* xc = x + (int64_t)block_col[b] * d;
#pragma unroll
    for (int i = 0; i < kMaxD; ++i) {
      if (i < d) {
        double s = 0.0;
        for (int j = 0; j < d; ++j) s += B[i * d + j] * xc[j];
        ar[i] += s;
      }
    }
  }
  for (int k = col_ptr[v] + lane; k < col_ptr[v + 1]; k += 32) {
    const int64_t b = col_blk[k];
    const double* B = blocks + b * dd;
    const double* xr = x + (int64_t)block_row[b] * d;
#pragma unroll
    for (int j = 0; j < kMaxD; ++j) {
      if (j < d) {
        double s = 0.0;
        for (int i = 0; i < d; ++i) s += B[i * d + j] * xr[i];
        ac[j] += s;
      }
    }
  }
  double out = 0.0;
#pragma unroll
  for (int i = 0; i < kMaxD; ++i) {
    if (i < d) {
      const double r = gt::warp_sum(ar[i]);
      const double c = gt::warp_sum(ac[i]);
      if (lane == i) out = r + c;
    }
  }
  if (lane < d) {
    const int64_t e = v * d + lane;
    double damp = lam;
    if (diagonal_damping)
      damp = lam * fmin(fmax(blocks[(int64_t)dbc[v] * dd + lane * (d + 1)],
                             min_diag), max_diag);
    y[e] = out + damp * (1.0 - pad_diag[e]) * x[e];
  }
}

}  // namespace

// n variables of d <= 12 components; blocks: (B+1) x d*d.
GT_EXPORT int gt_sn_matvec(int n, int d, const double* blocks,
                           const double* x, const int* row_ptr,
                           const int* row_blk, const int* col_ptr,
                           const int* col_blk, const int* block_row,
                           const int* block_col, const int* dbc,
                           const double* pad_diag, double lam,
                           int diagonal_damping, double min_diag,
                           double max_diag, double* y, void* stream) {
  if (d > kMaxD) return (int)cudaErrorInvalidValue;
  const int64_t threads = (int64_t)n * 32;
  if (threads > 0)
    sn_matvec_kernel<<<(unsigned)((threads + kThreads - 1) / kThreads),
                       kThreads, 0, (cudaStream_t)stream>>>(
        n, d, blocks, x, row_ptr, row_blk, col_ptr, col_blk, block_row,
        block_col, dbc, pad_diag, lam, diagonal_damping, min_diag, max_diag,
        y);
  return (int)cudaGetLastError();
}
