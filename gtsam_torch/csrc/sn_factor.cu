// Kernel 7: the level step of the supernodal Cholesky (float64).
//
// Replaces: gtsam_tpu/linear/supernodal.py::factorize (:372-442): the damping
// (:383-392), the front and panel gathers (:398-403, :429-430), the pivot
// test and first bad column (:404-417), the zeroing of non-finite factor
// entries (:419, :434) and the sorted segment-sum Schur scatter (:436-441).
// Between these launches the level's dense algebra runs in the library
// (cholesky_ex, solve_triangular, bmm), as the JAX package leaves it to XLA.
//
// gt_sn_front_gather: one thread per entry of the level's fronts
// (S x Wd x Wd, Wd = W d) and, in a second launch, of its panels
// (S x Rd x Wd).  A front entry reads its (d x d) block of the working store,
// transposed where the plan's flip says the block is stored the other way;
// a diagonal entry adds the padding identity and the damping (lam, or
// lam * clip(H_cc[k, k], min, max) of the undamped store) on true
// dimensions.  Bound: bytes (the fronts written, the store's blocks read).
// L, Lp and U come from the library in either row-major or column-major
// storage (cholesky_ex leaves column-major factors on the card); the pivot
// check reads only diagonals and acts elementwise, the Schur scatter takes
// a flag.
// gt_sn_pivot_check: one block walks the level's pivots and takes the first
// bad one (a true dimension not finite or not positive, or where
// cholesky_ex's info says the front failed) by a fixed min-tree; the state
// (ok, badcol) keeps the first bad level's.  A second launch zeroes the
// non-finite entries of L and Lp.
// gt_sn_schur_scatter: one thread per entry of each unique target block;
// sums the level's U = Lp Lp^T blocks of its segment in the plan's order
// and subtracts once.  No atomics.
#include "ba_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCheckThreads = 1024;

__global__ void __launch_bounds__(kThreads) sn_front_kernel(
    int64_t total, int S, int W, int d, int n, const double* __restrict__ work,
    const double* __restrict__ blocks, const int* __restrict__ diag_ids,
    const unsigned char* __restrict__ diag_flip,
    const double* __restrict__ diag_pad,
    const unsigned char* __restrict__ valid_diag,
    const int* __restrict__ col_vars, const int* __restrict__ dbc, double lam,
    int diagonal_damping, double min_diag, double max_diag,
    double* __restrict__ front) {
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int Wd = W * d, dd = d * d;
  const int64_t s = idx / ((int64_t)Wd * Wd);
  const int rem = (int)(idx - s * Wd * Wd);
  const int row = rem / Wd, col = rem - row * Wd;
  const int a = row / d, i = row - a * d;
  const int b = col / d, j = col - b * d;
  const int64_t slot = (s * W + a) * W + b;
  const int64_t blk = diag_ids[slot];
  double v = diag_flip[slot] ? work[blk * dd + j * d + i]
                             : work[blk * dd + i * d + j];
  if (row == col) {
    const int64_t e = s * Wd + row;
    double damp = 0.0;
    if (valid_diag[e]) {
      if (diagonal_damping) {
        int c = col_vars[s * W + a];
        c = c < n ? c : n - 1;
        damp = lam * fmin(fmax(blocks[(int64_t)dbc[c] * dd + i * (d + 1)],
                               min_diag), max_diag);
      } else {
        damp = lam;
      }
    }
    v = v + (diag_pad[e] + damp);
  }
  front[idx] = v;
}

__global__ void __launch_bounds__(kThreads) sn_panel_kernel(
    int64_t total, int W, int R, int d, const double* __restrict__ work,
    const int* __restrict__ panel_ids, double* __restrict__ panel) {
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int Wd = W * d, Rd = R * d, dd = d * d;
  const int64_t s = idx / ((int64_t)Rd * Wd);
  const int rem = (int)(idx - s * Rd * Wd);
  const int row = rem / Wd, col = rem - row * Wd;
  const int a = row / d, i = row - a * d;
  const int b = col / d, j = col - b * d;
  const int64_t blk = panel_ids[(s * R + a) * W + b];
  panel[idx] = work[blk * dd + i * d + j];
}

__global__ void __launch_bounds__(kCheckThreads) sn_pivot_kernel(
    int S, int Wd, int d, const double* __restrict__ L,
    const int* __restrict__ info, const unsigned char* __restrict__ valid,
    const int* __restrict__ col_vars, int* __restrict__ state) {
  __shared__ int64_t red[kCheckThreads];
  const int64_t total = (int64_t)S * Wd;
  int64_t first = total;
  for (int64_t f = threadIdx.x; f < total && first == total;
       f += kCheckThreads) {
    const int64_t s = f / Wd;
    const int i = (int)(f - s * Wd);
    const double piv = L[(s * Wd + i) * Wd + i];
    const bool bad = (valid[f] && (!isfinite(piv) || piv <= 0.0)) ||
                     (info[s] > 0 && i == info[s] - 1);
    if (bad) first = f;
  }
  red[threadIdx.x] = first;
  __syncthreads();
  for (int h = kCheckThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) {
      const int64_t o = red[threadIdx.x + h];
      if (o < red[threadIdx.x]) red[threadIdx.x] = o;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0 && red[0] < total) {
    const int64_t f = red[0];
    const int64_t s = f / Wd;
    const int i = (int)(f - s * Wd);
    const int W = Wd / d;
    if (state[0] == 1) state[1] = col_vars[s * W + i / d];
    state[0] = 0;
  }
}

__global__ void __launch_bounds__(kThreads) sn_zero_nonfinite_kernel(
    int64_t nL, double* __restrict__ L, int64_t nP, double* __restrict__ P) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t k = (int64_t)blockIdx.x * kThreads + threadIdx.x; k < nL + nP;
       k += stride) {
    double* p = k < nL ? L + k : P + (k - nL);
    if (!isfinite(*p)) *p = 0.0;
  }
}

__global__ void __launch_bounds__(kThreads) sn_schur_kernel(
    int64_t total, int R, int d, int u_cm, const double* __restrict__ U,
    const int* __restrict__ src, const int* __restrict__ ptr,
    const int* __restrict__ tgt, double* __restrict__ work) {
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int dd = d * d, Rd = R * d;
  const int64_t t = idx / dd;
  const int e = (int)(idx - t * dd);
  const int i = e / d, j = e - i * d;
  double acc = 0.0;
  for (int k = ptr[t]; k < ptr[t + 1]; ++k) {
    const int64_t sk = src[k];
    const int64_t s = sk / ((int64_t)R * R);
    const int rem = (int)(sk - s * R * R);
    const int a = rem / R, b = rem - a * R;
    const int64_t r = a * d + i, c = b * d + j;
    acc += U[s * Rd * Rd + (u_cm ? c * Rd + r : r * Rd + c)];
  }
  work[(int64_t)tgt[t] * dd + e] -= acc;
}

unsigned blocks_for(int64_t total) {
  return (unsigned)((total + kThreads - 1) / kThreads);
}

}  // namespace

// One level: S fronts of W blocks (d wide), R panel rows (0: no panel), n
// variables (col_vars' sentinel).  front: S x Wd x Wd; panel: S x Rd x Wd.
GT_EXPORT int gt_sn_front_gather(
    int S, int W, int R, int d, int n, const double* work,
    const double* blocks, const int* diag_ids, const unsigned char* diag_flip,
    const double* diag_pad, const unsigned char* valid_diag,
    const int* col_vars, const int* dbc, const int* panel_ids, double lam,
    int diagonal_damping, double min_diag, double max_diag, double* front,
    double* panel, void* stream) {
  const int64_t tf = (int64_t)S * W * d * W * d;
  if (tf > 0)
    sn_front_kernel<<<blocks_for(tf), kThreads, 0, (cudaStream_t)stream>>>(
        tf, S, W, d, n, work, blocks, diag_ids, diag_flip, diag_pad,
        valid_diag, col_vars, dbc, lam, diagonal_damping, min_diag, max_diag,
        front);
  int err = (int)cudaGetLastError();
  if (err != 0 || R == 0) return err;
  const int64_t tp = (int64_t)S * R * d * W * d;
  if (tp > 0)
    sn_panel_kernel<<<blocks_for(tp), kThreads, 0, (cudaStream_t)stream>>>(
        tp, W, R, d, work, panel_ids, panel);
  return (int)cudaGetLastError();
}

// L: S x Wd x Wd, Lp: S x Rd x Wd (Rd = 0: none); state: (ok, badcol).
GT_EXPORT int gt_sn_pivot_check(int S, int Wd, int Rd, int d, double* L,
                                double* Lp, const int* info,
                                const unsigned char* valid,
                                const int* col_vars, int* state,
                                void* stream) {
  if (S == 0) return 0;
  sn_pivot_kernel<<<1, kCheckThreads, 0, (cudaStream_t)stream>>>(
      S, Wd, d, L, info, valid, col_vars, state);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int64_t nL = (int64_t)S * Wd * Wd, nP = (int64_t)S * Rd * Wd;
  const int64_t want = (nL + nP + kThreads - 1) / kThreads;
  const unsigned grid = (unsigned)(want < 4096 ? want : 4096);
  sn_zero_nonfinite_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      nL, L, nP, Lp);
  return (int)cudaGetLastError();
}

// U: S x Rd x Rd, each front row-major or (u_cm = 1) column-major; T unique
// targets.
GT_EXPORT int gt_sn_schur_scatter(int S, int R, int d, int T, int u_cm,
                                  const double* U,
                                  const int* src, const int* ptr,
                                  const int* tgt, double* work,
                                  void* stream) {
  const int64_t total = (int64_t)T * d * d;
  if (total > 0)
    sn_schur_kernel<<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
        total, R, d, u_cm, U, src, ptr, tgt, work);
  return (int)cudaGetLastError();
}
