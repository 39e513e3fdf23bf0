// Kernels 13 and 14: the level-scheduled sparse block Cholesky (float64).
//
// Replaces: gtsam_tpu/linear/sparse.py::SparseCholeskySolver.factorize
// (:224-269) and solve_factored (:271-324), which XLA runs as per-level
// batched einsums, scatter-adds, Cholesky and triangular solves.
//
// The block store holds B blocks of d x d (d <= 12) row-major, block b at
// (row[b], col[b]) lower-stored; the plan (linear/sparse.py) lists each
// level's columns, their blocks (the diagonal first), each block's update
// triples (A_ij -= L_ik L_jk^T) sorted by target in the JAX order, and the
// solves' per-column block lists.
//
// gt_sp_level_factor (kernel 13): one launch a leading level, a CTA a
//   column j.  Its warps take the column's blocks: lane (r, c) of a block
//   forms A_rc (+ lam on the true diagonal) less the sum over the block's
//   triples of row r of L_ik times row c of L_jk (each a d-term dot
//   product), in the plan's order.  The diagonal block goes to shared
//   memory, where warp 0 factors it right-looking (a pivot that is not
//   finite and positive marks the column in rec), and every thread then
//   solves one row of a subdiagonal block, x L_jj^T = a, by forward
//   substitution.  A is read, the factor written to L (out of place).
// gt_sp_tail_assemble (kernel 13's second entry): a warp a block of the
//   dense root M's lower triangle: the stored tail block less its late
//   triples (sources in the leading columns), plus lam on the diagonal,
//   written to M and, transposed, to its mirror; blocks with no stored
//   block are zeroed.  M then goes to dense_blocked.blocked_cholesky.
// gt_sp_level_forward / gt_sp_level_backward (kernel 14): a warp a column,
//   lane c a component: the forward job sums row c of each L_jk times y_k
//   (the rows of j's earlier blocks), subtracts it from the right-hand
//   side (the padded g, or through a map the canonical flat vector of a
//   CG loop) and substitutes with L_jj lane by lane through shuffles;
//   without `diag` it forms the dense root's right-hand side instead.  The
//   backward job sums column c of each L_ij times x_i, substitutes with
//   L_jj^T, and writes x both to U (for the later levels) and to the flat
//   delta (un-permuted, un-padded); a dense-root column only copies its x
//   (kernel 11's) to the delta.  Both return at once where `stop` (a CG
//   loop's done word) is set.
//
// No atomics: every sum runs in the plan's order, so a launch gives the
// same bits on every run.  Bound on the H100: at the sphere's sizes a
// level's bytes are ~0.1-5 MB and its FLOPs (2 d^3 a triple) ~0.05-0.2
// GFLOP, a few microseconds at 3.35 TB/s or 34 TFLOP/s; the launches (one
// a level a direction) and the chains of dependent loads bound it, and the
// few-column levels run on a few SMs.
#include "ba_common.cuh"

namespace {

constexpr int kMaxD = 12;
constexpr int kFactorThreads = 128;      // kernel 13: a CTA a column
constexpr int kFactorWarps = kFactorThreads / gt::kWarp;
constexpr int kTailThreads = 256;        // a warp a block of M
constexpr int kSolveThreads = 128;       // kernel 14: a warp a column
constexpr unsigned kFull = 0xffffffffu;

// sum over the triples [t0, t1) of row r of L_ik times row c of L_jk
__device__ __forceinline__ double triple_sum(
    const double* L, const int* __restrict__ tik,
    const int* __restrict__ tjk, int t0, int t1, int d, int r, int c) {
  const int dd = d * d;
  double acc = 0.0;
  for (int t = t0; t < t1; ++t) {
    const double* li = L + (int64_t)tik[t] * dd + r * d;
    const double* lj = L + (int64_t)tjk[t] * dd + c * d;
    double s = 0.0;
#pragma unroll
    for (int m = 0; m < kMaxD; ++m)
      if (m < d) s += li[m] * lj[m];
    acc += s;
  }
  return acc;
}

__global__ void __launch_bounds__(kFactorThreads) sp_level_factor_kernel(
    int d, const int* __restrict__ cols, const int* __restrict__ cptr,
    const int* __restrict__ cblk, const int* __restrict__ tptr,
    const int* __restrict__ tik, const int* __restrict__ tjk,
    const double* __restrict__ A, const double* __restrict__ pad,
    double lam, double* L, int* __restrict__ rec) {
  __shared__ double sD[kMaxD * kMaxD];
  const int q = blockIdx.x;
  const int j = cols[q];
  const int e0 = cptr[q], e1 = cptr[q + 1];
  const int dd = d * d;
  const int warp = threadIdx.x / gt::kWarp, lane = threadIdx.x % gt::kWarp;
  // the column's blocks, a warp each: A (+ damping) less the triples
  for (int e = e0 + warp; e < e1; e += kFactorWarps) {
    const int64_t b = cblk[e];
    const int t0 = tptr[e], t1 = tptr[e + 1];
    for (int idx = lane; idx < dd; idx += gt::kWarp) {
      const int r = idx / d, c = idx - r * d;
      double a = A[b * dd + idx];
      if (e == e0 && r == c) a += lam * (1.0 - pad[(int64_t)j * d + r]);
      a -= triple_sum(L, tik, tjk, t0, t1, d, r, c);
      if (e == e0)
        sD[idx] = a;
      else
        L[b * dd + idx] = a;
    }
  }
  __syncthreads();
  // the diagonal block's Cholesky, right-looking, in warp 0
  if (warp == 0) {
    int bad = -1;
    for (int k = 0; k < d; ++k) {
      const double s = sD[k * d + k];
      if (bad < 0 && !(s > 0.0 && isfinite(s))) bad = k;
      const double piv = sqrt(s);
      __syncwarp();
      if (lane == k) sD[k * d + k] = piv;
      if (lane > k && lane < d) sD[lane * d + k] /= piv;
      __syncwarp();
      for (int idx = lane; idx < dd; idx += gt::kWarp) {
        const int i = idx / d, c = idx - i * d;
        if (c > k && c <= i) sD[idx] -= sD[i * d + k] * sD[c * d + k];
      }
      __syncwarp();
    }
    const int64_t b = cblk[e0];
    for (int idx = lane; idx < dd; idx += gt::kWarp) {
      const int i = idx / d, c = idx - i * d;
      L[b * dd + idx] = c <= i ? sD[idx] : 0.0;
    }
    if (lane == 0) rec[q] = bad >= 0 ? j : -1;
  }
  __syncthreads();
  // the subdiagonal blocks: L_ij = A_ij L_jj^-T, a thread a row
  const int nrow = (e1 - e0 - 1) * d;
  for (int w = threadIdx.x; w < nrow; w += kFactorThreads) {
    const int e = e0 + 1 + w / d, r = w % d;
    double* row = L + (int64_t)cblk[e] * dd + r * d;
    double x[kMaxD];
#pragma unroll
    for (int c = 0; c < kMaxD; ++c) x[c] = c < d ? row[c] : 0.0;
#pragma unroll
    for (int c = 0; c < kMaxD; ++c) {
      if (c < d) {
        x[c] /= sD[c * d + c];
#pragma unroll
        for (int c2 = c + 1; c2 < kMaxD; ++c2)
          if (c2 < d) x[c2] -= x[c] * sD[c2 * d + c];
      }
    }
#pragma unroll
    for (int c = 0; c < kMaxD; ++c)
      if (c < d) row[c] = x[c];
  }
}

__global__ void __launch_bounds__(kTailThreads) sp_tail_assemble_kernel(
    int T, int d, int ld, const int* __restrict__ tmap,
    const int* __restrict__ tbid, const int* __restrict__ lptr,
    const int* __restrict__ lik, const int* __restrict__ ljk,
    const int* __restrict__ tcols, const double* __restrict__ A,
    const double* __restrict__ L, const double* __restrict__ pad,
    double lam, double* __restrict__ M) {
  const int64_t w =
      ((int64_t)blockIdx.x * kTailThreads + threadIdx.x) / gt::kWarp;
  if (w >= (int64_t)T * T) return;
  const int r = (int)(w / T), c = (int)(w % T);
  if (c > r) return;
  const int lane = threadIdx.x % gt::kWarp;
  const int e = tmap[w];
  const int dd = d * d;
  for (int idx = lane; idx < dd; idx += gt::kWarp) {
    const int i = idx / d, k = idx - i * d;
    double v = 0.0;
    if (e >= 0) {
      v = A[(int64_t)tbid[e] * dd + idx];
      if (r == c && i == k) v += lam * (1.0 - pad[(int64_t)tcols[r] * d + i]);
      v -= triple_sum(L, lik, ljk, lptr[e], lptr[e + 1], d, i, k);
    }
    M[(int64_t)(r * d + i) * ld + c * d + k] = v;
    if (r != c) M[(int64_t)(c * d + k) * ld + r * d + i] = v;
  }
}

__global__ void __launch_bounds__(kSolveThreads) sp_level_forward_kernel(
    int J, int d, int diag, const int* __restrict__ cols,
    const int* __restrict__ orow, const int* __restrict__ dbid,
    const int* __restrict__ fptr, const int* __restrict__ fbid,
    const int* __restrict__ fsrc, const double* __restrict__ L,
    const double* __restrict__ rhs, const int* __restrict__ rhs_map,
    const double* Y, double* out, const int* stop) {
  if (stop != nullptr && *stop) return;
  const int64_t q =
      ((int64_t)blockIdx.x * kSolveThreads + threadIdx.x) / gt::kWarp;
  if (q >= J) return;   // warp-uniform
  const int lane = threadIdx.x % gt::kWarp;
  const int dd = d * d;
  const int64_t j = cols[q];
  double acc = 0.0;
  if (lane < d) {
    double s = 0.0;
    for (int e = fptr[q]; e < fptr[q + 1]; ++e) {
      const double* Lb = L + (int64_t)fbid[e] * dd + lane * d;
      const double* y = Y + (int64_t)fsrc[e] * d;
      double u = 0.0;
#pragma unroll
      for (int c = 0; c < kMaxD; ++c)
        if (c < d) u += Lb[c] * y[c];
      s += u;
    }
    const int m = rhs_map != nullptr ? rhs_map[j * d + lane]
                                     : (int)(j * d + lane);
    acc = (m >= 0 ? rhs[m] : 0.0) - s;
  }
  if (diag) {
    const double* Ld = L + (int64_t)dbid[q] * dd;
    for (int k = 0; k < d; ++k) {
      if (lane == k) acc /= Ld[k * d + k];
      const double yk = __shfl_sync(kFull, acc, k);
      if (lane > k && lane < d) acc -= Ld[lane * d + k] * yk;
    }
  }
  if (lane < d) out[(int64_t)orow[q] * d + lane] = acc;
}

__global__ void __launch_bounds__(kSolveThreads) sp_level_backward_kernel(
    int J, int d, const int* __restrict__ cols,
    const int* __restrict__ xrow, const int* __restrict__ dbid,
    const int* __restrict__ bptr, const int* __restrict__ bbid,
    const int* __restrict__ bsrc, const double* __restrict__ L,
    const double* __restrict__ Y, double* U, const int* __restrict__ out_map,
    double* __restrict__ delta, const int* stop) {
  if (stop != nullptr && *stop) return;
  const int64_t q =
      ((int64_t)blockIdx.x * kSolveThreads + threadIdx.x) / gt::kWarp;
  if (q >= J) return;   // warp-uniform
  const int lane = threadIdx.x % gt::kWarp;
  const int dd = d * d;
  const int64_t j = cols[q];
  const int db = dbid[q];
  double x = 0.0;
  if (db >= 0) {
    if (lane < d) {
      double s = 0.0;
      for (int e = bptr[q]; e < bptr[q + 1]; ++e) {
        const double* Lb = L + (int64_t)bbid[e] * dd + lane;
        const double* xi = U + (int64_t)bsrc[e] * d;
        double u = 0.0;
#pragma unroll
        for (int r = 0; r < kMaxD; ++r)
          if (r < d) u += Lb[r * d] * xi[r];
        s += u;
      }
      x = Y[j * d + lane] - s;
    }
    const double* Ld = L + (int64_t)db * dd;
    for (int k = d - 1; k >= 0; --k) {
      if (lane == k) x /= Ld[k * d + k];
      const double xk = __shfl_sync(kFull, x, k);
      if (lane < k) x -= Ld[k * d + lane] * xk;
    }
    if (lane < d) U[(int64_t)xrow[q] * d + lane] = x;
  } else if (lane < d) {
    x = U[(int64_t)xrow[q] * d + lane];
  }
  if (lane < d) {
    const int m = out_map[j * d + lane];
    if (m >= 0) delta[m] = x;
  }
}

int warps_grid(int64_t warps) {
  return (int)((warps * gt::kWarp + kSolveThreads - 1) / kSolveThreads);
}

}  // namespace

// One leading level of J columns; store blocks of d x d (d <= 12); cols,
// cptr (J + 1) the level's slices, cblk, tptr, tik, tjk the whole plan's;
// A the assembled store (read), L the factor (its earlier levels read, this
// level's blocks written), rec (J) the pivot records.
GT_EXPORT int gt_sp_level_factor(int J, int d, const int* cols,
                                 const int* cptr, const int* cblk,
                                 const int* tptr, const int* tik,
                                 const int* tjk, const double* A,
                                 const double* pad, double lam, double* L,
                                 int* rec, void* stream) {
  if (d > kMaxD) return (int)cudaErrorInvalidValue;
  if (J > 0)
    sp_level_factor_kernel<<<J, kFactorThreads, 0, (cudaStream_t)stream>>>(
        d, cols, cptr, cblk, tptr, tik, tjk, A, pad, lam, L, rec);
  return (int)cudaGetLastError();
}

// The dense root: T tail columns, M (T d x T d, rows ld apart).
GT_EXPORT int gt_sp_tail_assemble(int T, int d, int ld, const int* tmap,
                                  const int* tbid, const int* lptr,
                                  const int* lik, const int* ljk,
                                  const int* tcols, const double* A,
                                  const double* L, const double* pad,
                                  double lam, double* M, void* stream) {
  if (d > kMaxD) return (int)cudaErrorInvalidValue;
  const int64_t threads = (int64_t)T * T * gt::kWarp;
  if (threads > 0)
    sp_tail_assemble_kernel<<<(unsigned)((threads + kTailThreads - 1) /
                                         kTailThreads),
                              kTailThreads, 0, (cudaStream_t)stream>>>(
        T, d, ld, tmap, tbid, lptr, lik, ljk, tcols, A, L, pad, lam, M);
  return (int)cudaGetLastError();
}

// J jobs (a level's columns, or the dense root's with diag = 0); Y, out:
// rows of d; rhs_map: null (rhs is the padded (n, d) g) or a map of
// (column, component) to rhs's entries (-1: zero); stop: null or the done
// word.
GT_EXPORT int gt_sp_level_forward(int J, int d, int diag, const int* cols,
                                  const int* orow, const int* dbid,
                                  const int* fptr, const int* fbid,
                                  const int* fsrc, const double* L,
                                  const double* rhs, const int* rhs_map,
                                  const double* Y, double* out,
                                  const int* stop, void* stream) {
  if (d > kMaxD) return (int)cudaErrorInvalidValue;
  if (J > 0)
    sp_level_forward_kernel<<<warps_grid(J), kSolveThreads, 0,
                              (cudaStream_t)stream>>>(
        J, d, diag, cols, orow, dbid, fptr, fbid, fsrc, L, rhs, rhs_map, Y,
        out, stop);
  return (int)cudaGetLastError();
}

// J jobs (a level's columns, with the dense root's to copy in the first
// backward launch); U: rows of d (x of every column); delta: the flat
// tangent vector.
GT_EXPORT int gt_sp_level_backward(int J, int d, const int* cols,
                                   const int* xrow, const int* dbid,
                                   const int* bptr, const int* bbid,
                                   const int* bsrc, const double* L,
                                   const double* Y, double* U,
                                   const int* out_map, double* delta,
                                   const int* stop, void* stream) {
  if (d > kMaxD) return (int)cudaErrorInvalidValue;
  if (J > 0)
    sp_level_backward_kernel<<<warps_grid(J), kSolveThreads, 0,
                               (cudaStream_t)stream>>>(
        J, d, cols, xrow, dbid, bptr, bbid, bsrc, L, Y, U, out_map, delta,
        stop);
  return (int)cudaGetLastError();
}
