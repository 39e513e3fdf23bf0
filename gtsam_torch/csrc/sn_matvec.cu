// Kernel 9: the block-sparse symmetric matvec of the refinement residual
// (float64).
//
// Replaces: gtsam_tpu/linear/supernodal.py::matvec (:456-476; plan
// :293-300): y = (H + damping) x on the lower block store, x and y (n x d)
// in the permuted layout.
//
// The row and column CSRs list H's own blocks only (the solver's set T:
// supernodal.py), so the store's fill, zero by the solver's invariant, is
// never read.  One warp per variable v, cut into 32 / d groups of d lanes
// (five groups of six for d = 6).  v's tasks are its row blocks (every
// block of T in row v: y_v += B x[col]) and then its off-diagonal column
// blocks (y_v += B^T x[row]); group g takes tasks g, g + groups, ...  For a
// row task lane i of the group reads row i of the block, for a column task
// column i, so the group's d lanes read the block's d*d doubles once, all
// within its 288 bytes (d = 6), and each lane forms output component i of
// that task with no reduction; it also reads x of the block's other
// variable (the same d doubles for the group: one broadcast).  The groups'
// partial sums are then folded into the first group's lanes by shuffles in
// a fixed order, and lane i < d writes y_i + damp_i x_i (damp: lam, or
// lam * clip(H_vv[i, i]), on true dimensions).  No atomics: the same bits on
// every run.
// Bound on the H100: bytes, T's blocks read once by row and the
// off-diagonal ones once more by column (sphere stand-in: 7,449 + 4,949
// blocks of 288 B, ~3.7 MB with x, y and the indices, ~0.0011 ms at 3.35
// TB/s); the launch and the chain of dependent index loads (row_ptr ->
// row_blk -> block_col -> x) are the real floor at that size.  The first
// design read every block of the 36 MB store, a lane per block.
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
  const int v = ((int)blockIdx.x * kThreads + (int)threadIdx.x) >> 5;
  if (v >= n) return;   // warp-uniform: the shuffles below see all lanes
  const int lane = threadIdx.x & 31;
  const int groups = gt::kWarp / d;
  const int grp = lane / d;
  const int i = lane - grp * d;
  const int dd = d * d;
  const int r0 = row_ptr[v];
  const int nr = row_ptr[v + 1] - r0;
  const int c0 = col_ptr[v] - nr;   // task t >= nr is column block c0 + t
  const int ntask = nr + col_ptr[v + 1] - col_ptr[v];
  double acc = 0.0;
  if (grp < groups) {
    for (int t = grp; t < ntask; t += groups) {
      const bool row = t < nr;
      const int b = row ? row_blk[r0 + t] : col_blk[c0 + t];
      const int o = row ? block_col[b] : block_row[b];
      const double* B = blocks + (int64_t)b * dd + (row ? i * d : i);
      const int step = row ? 1 : d;
      const double* xo = x + (int64_t)o * d;
      double s = 0.0;
#pragma unroll
      for (int j = 0; j < kMaxD; ++j)
        if (j < d) s += B[j * step] * xo[j];
      acc += s;
    }
  }
  double out = acc;
  for (int g = 1; g < groups; ++g) {
    const double o = __shfl_sync(0xffffffffu, acc, lane + g * d);
    if (lane < d) out += o;
  }
  if (lane < d) {
    const int64_t e = (int64_t)v * d + lane;
    double damp = lam;
    if (diagonal_damping)
      damp = lam * fmin(fmax(blocks[(int64_t)dbc[v] * dd + lane * (d + 1)],
                             min_diag), max_diag);
    y[e] = out + damp * (1.0 - pad_diag[e]) * x[e];
  }
}

}  // namespace

// n variables of d <= 12 components; blocks: (B+1) x d*d, read only at the
// blocks the CSRs list.
GT_EXPORT int gt_sn_matvec(int n, int d, const double* blocks,
                           const double* x, const int* row_ptr,
                           const int* row_blk, const int* col_ptr,
                           const int* col_blk, const int* block_row,
                           const int* block_col, const int* dbc,
                           const double* pad_diag, double lam,
                           int diagonal_damping, double min_diag,
                           double max_diag, double* y, void* stream) {
  if (d > kMaxD) return (int)cudaErrorInvalidValue;
  const int64_t threads = (int64_t)n * gt::kWarp;
  if (threads > 0)
    sn_matvec_kernel<<<(unsigned)((threads + kThreads - 1) / kThreads),
                       kThreads, 0, (cudaStream_t)stream>>>(
        n, d, blocks, x, row_ptr, row_blk, col_ptr, col_blk, block_row,
        block_col, dbc, pad_diag, lam, diagonal_damping, min_diag, max_diag,
        y);
  return (int)cudaGetLastError();
}
