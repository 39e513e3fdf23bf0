// Kernel 7n: the narrow route of kernel 7's level step (float64).
//
// Replaces: gtsam_tpu/linear/supernodal.py::factorize (:372-442) on the
// levels whose fronts fit one 32-column tile (W d <= 32) with panels of at
// most 64 rows (linear/supernodal_kernels.py::narrow_route): the damped
// front gather (:398-403), the Cholesky and the pivot test (:404-417), the
// panel A L^-T (:429-434), U = Lp Lp^T and the sorted segment-sum scatter
// (:436-441); and kernel 8's tile inverses (:583).  The wide kernels of
// sn_factor.cu take every other level, unchanged.
//
// gt_sn_narrow_front: one launch a level, a CTA a chunk of fronts (the
// level's chunk plan, narrow_plan: the fronts sorted by their first row
// variable, so that a chunk's fronts share targets), a warp a front,
// `warps` fronts of the chunk at a time.  A warp gathers its front's lower
// triangle (with the flips, the padding identity and the damping, lam or
// lam * clip(H_cc[k, k], min, max) of the undamped store, on true
// dimensions) and its panel (non-finite entries zeroed) into shared
// memory, kBatch entries a lane at a time (their block ids, then their
// entries, in flight together); factors the front right-looking, a lane a
// row, the column's entries passed by shuffles, and records the first bad
// pivot (where the pivot is not positive, or a true dimension's L_kk is
// not finite) as its permuted column, or -1; forms L^-1 by substitution
// on the identity, a row at a time and a lane a column;
// writes L and L^-1 column-major (non-finite entries zeroed) and the
// front's one tile inverse for kernel 8 (L^-1, the identity past W d);
// turns the panel into Lp = A L^-T in place, a lane a row and its columns
// right to left, and writes it (Lp^T row-major).  Then the CTA adds those
// fronts' blocks of U = Lp Lp^T (b <= a), front after front in plan order,
// into the chunk's rows in shared memory, a row a (chunk, target): groups
// of d^2 threads, thread q of group g taking entry q of the blocks whose
// rows r have r % groups == g (a W d-deep dot each), so that each row sums
// its blocks in plan order with no atomics.  Last the chunk's rows go to
// the partial buffer.
// gt_sn_narrow_scatter: a thread an entry of a target block sums the
// target's chunk rows in chunk order, eight loads in flight, and subtracts
// the sum from the working store once.  No atomics: the same inputs give
// the same bits.
// Bound on the H100 (the graph-form BA's 21,636 one-point fronts, W d = 9,
// R d = 36): ~0.39 GFLOP of FP64 (0.011 ms at 34 TFLOP/s) against ~0.33 GB
// that must move (0.10 ms at 3.35 TB/s), of which the tile inverses, 8 KB
// a front with their identity padding, are 0.18 GB: bytes bound it.  At
// 9 x 36 the products are too small to fill the FP64 tensor cores' 16 x 8
// x 16 tiles, so they run on the FP64 units from shared memory; the
// chunks keep the scatter's sums short (a camera block sums one row a
// chunk, not one a point).
#include <algorithm>

#include "ba_common.cuh"

namespace {

constexpr int kMaxWd = 32;           // a front: one of kernel 8's tiles
constexpr int kMaxRd = 64;           // a panel's rows: two a lane
constexpr int kMaxWarps = 8;         // the fronts of a CTA at once
constexpr int kTile = 32;            // kernel 8's tile
constexpr int kBatch = 4;            // a lane's gather loads in flight
constexpr int kScatterThreads = 256;
constexpr int kScatterBatch = 8;     // chunk rows a thread loads at once

__device__ __forceinline__ double finite_or_zero(double v) {
  return isfinite(v) ? v : 0.0;
}

// A front's buffers: row pitch (odd, so that a warp's rows fall on
// different banks) and doubles a warp: the front (then L), L^-1 and the
// panel (then Lp), row-major, then its nblk chunk rows of U's blocks
// (ints, two a double).
__host__ __device__ __forceinline__ int pitch(int Wd) { return Wd | 1; }
__host__ __device__ __forceinline__ int warp_doubles(int Wd, int Rd,
                                                     int nblk) {
  return (2 * Wd + Rd) * pitch(Wd) + (nblk + 1) / 2;
}

__global__ void __launch_bounds__(kMaxWarps * 32) sn_narrow_front_kernel(
    int W, int R, int d, int n, const double* __restrict__ work,
    const double* __restrict__ blocks, const int* __restrict__ diag_ids,
    const unsigned char* __restrict__ diag_flip,
    const double* __restrict__ diag_pad,
    const unsigned char* __restrict__ valid_diag,
    const int* __restrict__ col_vars, const int* __restrict__ dbc,
    const int* __restrict__ panel_ids, const int* __restrict__ order,
    const int* __restrict__ cptr, const int* __restrict__ rptr,
    const int* __restrict__ urow, double lam, int diagonal_damping,
    double min_diag, double max_diag, double* __restrict__ Lout,
    double* __restrict__ Xout, double* __restrict__ LpOut,
    double* __restrict__ tiles, double* __restrict__ part,
    int* __restrict__ rec) {
  extern __shared__ __align__(16) double sm[];
  const int Wd = W * d, Rd = R * d, dd = d * d, pf = pitch(Wd);
  const int nblk = R * (R + 1) / 2, per = warp_doubles(Wd, Rd, nblk);
  const int warps = blockDim.x >> 5, nthreads = blockDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p0 = cptr[blockIdx.x], p1 = cptr[blockIdx.x + 1];
  const int r0 = R ? rptr[blockIdx.x] : 0;
  const int nrows = R ? rptr[blockIdx.x + 1] - r0 : 0;
  double* F = sm + warp * per;     // the front, then L (lower)
  double* X = F + Wd * pf;         // L^-1 (lower)
  double* A = X + Wd * pf;         // the panel, then Lp
  int* ur = reinterpret_cast<int*>(A + Rd * pf);   // U's blocks' rows
  double* rows = sm + warps * per; // the chunk's rows, d^2 entries each
  const int groups = max(1, nthreads / dd);
  for (int e = threadIdx.x; e < nrows * dd; e += nthreads) rows[e] = 0.0;

  for (int q0 = p0; q0 < p1; q0 += warps) {
    const int p = q0 + warp;
    if (p < p1) {
      const int s = order[p];
      for (int ab = lane; ab < nblk; ab += 32)
        ur[ab] = urow[(int64_t)p * nblk + ab];
      // the front's lower triangle, damped as the plain version damps it,
      // and the panel A (Rd x Wd), kBatch entries a lane at a time: their
      // block ids, then their entries, in flight together
      for (int e0 = lane; e0 < Wd * Wd; e0 += 32 * kBatch) {
        int64_t src[kBatch];
        int dst[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = e0 + 32 * u, r = e / Wd, c = e - r * Wd;
          dst[u] = -1;
          if (e < Wd * Wd && c <= r) {
            const int a = r / d, i = r - a * d, b = c / d, j = c - b * d;
            const int64_t id = ((int64_t)s * W + a) * W + b;
            src[u] = (int64_t)diag_ids[id] * dd +
                     (diag_flip[id] ? j * d + i : i * d + j);
            dst[u] = r * pf + c;
          }
        }
        double v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          v[u] = dst[u] >= 0 ? work[src[u]] : 0.0;
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (dst[u] < 0) continue;
          const int r = dst[u] / pf, c = dst[u] - r * pf;
          if (r == c) {
            const int a = r / d, i = r - a * d;
            const int64_t ed = (int64_t)s * Wd + r;
            double damp = 0.0;
            if (valid_diag[ed]) {
              if (diagonal_damping) {
                int cv = col_vars[(int64_t)s * W + a];
                cv = cv < n ? cv : n - 1;
                damp = lam * fmin(fmax(blocks[(int64_t)dbc[cv] * dd +
                                              i * (d + 1)],
                                       min_diag), max_diag);
              } else {
                damp = lam;
              }
            }
            v[u] = v[u] + (diag_pad[ed] + damp);
          }
          F[dst[u]] = v[u];
        }
      }
      for (int e0 = lane; e0 < Rd * Wd; e0 += 32 * kBatch) {
        int64_t src[kBatch];
        int dst[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = e0 + 32 * u, r = e / Wd, c = e - r * Wd;
          dst[u] = -1;
          if (e < Rd * Wd) {
            const int a = r / d, i = r - a * d, b = c / d, j = c - b * d;
            src[u] = (int64_t)panel_ids[((int64_t)s * R + a) * W + b] * dd +
                     i * d + j;
            dst[u] = r * pf + c;
          }
        }
        double v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          v[u] = dst[u] >= 0 ? work[src[u]] : 0.0;
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (dst[u] >= 0) A[dst[u]] = finite_or_zero(v[u]);
      }
      __syncwarp();
      // right-looking Cholesky, a lane a row, the rows' entries of column
      // k passed by shuffles; the first bad pivot (true dimensions: a mask)
      const unsigned valid = __ballot_sync(
          0xffffffffu, lane < Wd && valid_diag[(int64_t)s * Wd + lane]);
      int first = -1;
      for (int k = 0; k < Wd; ++k) {
        const double piv = F[k * pf + k];
        const double lkk = sqrt(piv), inv = 1.0 / lkk;
        if (first < 0 &&
            (!(piv > 0.0) || ((valid >> k & 1u) && !isfinite(lkk))))
          first = k;
        double l = 0.0;
        if (lane > k && lane < Wd) {
          l = F[lane * pf + k] * inv;
          F[lane * pf + k] = l;
        }
        if (lane == k) F[k * pf + k] = lkk;
        for (int j = k + 1; j < Wd; ++j) {
          const double lj = __shfl_sync(0xffffffffu, l, j);
          if (lane >= j && lane < Wd) F[lane * pf + j] -= l * lj;
        }
        __syncwarp();
      }
      if (lane < Wd)
        for (int j = 0; j <= lane; ++j)
          F[lane * pf + j] = finite_or_zero(F[lane * pf + j]);
      __syncwarp();
      // L^-1 on the identity: row r, a lane a column j <= r (a lane reads
      // only its own column of L^-1 and the finished L)
      for (int r = 0; r < Wd; ++r) {
        if (lane <= r) {
          double acc = lane == r ? 1.0 : 0.0;
          for (int m = lane; m < r; ++m)
            acc -= F[r * pf + m] * X[m * pf + lane];
          X[r * pf + lane] = acc / F[r * pf + r];
        }
      }
      __syncwarp();
      if (lane < Wd)
        for (int j = 0; j <= lane; ++j)
          X[lane * pf + j] = finite_or_zero(X[lane * pf + j]);
      __syncwarp();
      // L and L^-1 column-major, the tile inverse row-major, the record
      const int64_t fo = (int64_t)s * Wd * Wd;
      for (int e = lane; e < Wd * Wd; e += 32) {
        const int c = e / Wd, r = e - c * Wd;
        Lout[fo + e] = r >= c ? F[r * pf + c] : 0.0;
        Xout[fo + e] = r >= c ? X[r * pf + c] : 0.0;
      }
      // the tile inverse, a pair of entries a lane, 16 bytes a store
      double2* T = reinterpret_cast<double2*>(tiles) +
                   (int64_t)s * kTile * kTile / 2;
      for (int e = lane; e < kTile * kTile / 2; e += 32) {
        const int r = e / (kTile / 2), c = 2 * (e % (kTile / 2));
        double x[2];
#pragma unroll
        for (int u = 0; u < 2; ++u)
          x[u] = r < Wd && c + u < Wd
                     ? (c + u <= r ? X[r * pf + c + u] : 0.0)
                     : (r == c + u ? 1.0 : 0.0);
        T[e] = make_double2(x[0], x[1]);
      }
      if (lane == 0)
        rec[s] = first < 0 ? -1 : col_vars[(int64_t)s * W + first / d];
      // Lp = A L^-T in place: row r's column j needs its columns k <= j
      for (int r = lane; r < Rd; r += 32) {
        double* a = A + r * pf;
        for (int j = Wd - 1; j >= 0; --j) {
          double acc = 0.0;
          for (int k = 0; k <= j; ++k) acc += a[k] * X[j * pf + k];
          a[j] = finite_or_zero(acc);
        }
      }
      __syncwarp();
      if (R) {
        const int64_t po = (int64_t)s * Wd * Rd;
        for (int e = lane; e < Wd * Rd; e += 32) {
          const int j = e / Rd, r = e - j * Rd;
          LpOut[po + e] = A[r * pf + j];
        }
      }
    }
    __syncthreads();
    // the wave's blocks of U into the chunk's rows, front after front:
    // thread q of group g takes entry q of each block whose chunk row r has
    // r % groups == g
    const int nw = min(warps, p1 - q0);
    for (int idx = threadIdx.x; idx < groups * dd && R; idx += nthreads) {
      const int g = idx / dd, q = idx - g * dd, i = q / d, j = q - i * d;
      for (int k = 0; k < nw; ++k) {
        const double* Lp = sm + k * per + 2 * Wd * pf;
        const int* uk = reinterpret_cast<const int*>(Lp + Rd * pf);
        int ab = 0;
        for (int a = 0; a < R; ++a)
          for (int b = 0; b <= a; ++b, ++ab) {
            const int r = uk[ab];
            if (r < 0 || r % groups != g) continue;
            const double* x = Lp + (a * d + i) * pf;
            const double* y = Lp + (b * d + j) * pf;
            double acc = 0.0;
            for (int m = 0; m < Wd; ++m) acc += x[m] * y[m];
            rows[r * dd + q] += acc;
          }
      }
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < nrows * dd; e += nthreads)
    part[(int64_t)r0 * dd + e] = rows[e];
}

__global__ void __launch_bounds__(kScatterThreads) sn_narrow_scatter_kernel(
    int T, int d, const int* __restrict__ tptr, const int* __restrict__ trow,
    const int* __restrict__ tgt, const double* __restrict__ part,
    double* __restrict__ work) {
  const int dd = d * d;
  const int64_t total = (int64_t)T * dd;
  for (int64_t idx = (int64_t)blockIdx.x * kScatterThreads + threadIdx.x;
       idx < total; idx += (int64_t)gridDim.x * kScatterThreads) {
    const int t = (int)(idx / dd), q = (int)(idx - (int64_t)t * dd);
    const int kb = tptr[t], ke = tptr[t + 1];
    double acc = 0.0;
    for (int k0 = kb; k0 < ke; k0 += kScatterBatch) {
      double v[kScatterBatch];
#pragma unroll
      for (int u = 0; u < kScatterBatch; ++u)
        v[u] = k0 + u < ke ? part[(int64_t)trow[k0 + u] * dd + q] : 0.0;
#pragma unroll
      for (int u = 0; u < kScatterBatch; ++u)
        if (k0 + u < ke) acc += v[u];
    }
    double* w = work + (int64_t)tgt[t] * dd + q;
    *w = *w - acc;
  }
}

}  // namespace

// One narrow level: fronts of W blocks and R panel row blocks (0: no
// panel) of width d, W d <= 32 and R d <= 64, n variables (col_vars'
// sentinel); the chunk plan (order, cptr over nchunks chunks, rptr, urow:
// narrow_plan's), `warps` fronts of a CTA at once, rows_max the most rows
// of a chunk.  L, X: S x Wd x Wd, each front column-major (L, L^-1); Lp:
// S x Wd x Rd (Lp^T row-major; unused when R = 0); tiles: S x 32 x 32, each
// front's tile inverse row-major; part: the chunk rows, d^2 doubles each;
// rec: S ints.
GT_EXPORT int gt_sn_narrow_front(
    int nchunks, int W, int R, int d, int n, int warps, int rows_max,
    const double* work, const double* blocks, const int* diag_ids,
    const unsigned char* diag_flip, const double* diag_pad,
    const unsigned char* valid_diag, const int* col_vars, const int* dbc,
    const int* panel_ids, const int* order, const int* cptr, const int* rptr,
    const int* urow, double lam, int diagonal_damping, double min_diag,
    double max_diag, double* L, double* X, double* Lp, double* tiles,
    double* part, int* rec, void* stream) {
  if (nchunks == 0) return 0;
  const int Wd = W * d, Rd = R * d;
  if (Wd > kMaxWd || Rd > kMaxRd || warps < 1 || warps > kMaxWarps)
    return (int)cudaErrorInvalidValue;
  const size_t shm = ((size_t)warps * warp_doubles(Wd, Rd, R * (R + 1) / 2) +
                      (size_t)rows_max * d * d) * sizeof(double);
  cudaError_t e = cudaFuncSetAttribute(
      sn_narrow_front_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shm);
  if (e != cudaSuccess) return (int)e;
  sn_narrow_front_kernel<<<nchunks, warps * 32, shm, (cudaStream_t)stream>>>(
      W, R, d, n, work, blocks, diag_ids, diag_flip, diag_pad, valid_diag,
      col_vars, dbc, panel_ids, order, cptr, rptr, urow, lam,
      diagonal_damping, min_diag, max_diag, L, X, Lp, tiles, part, rec);
  return (int)cudaGetLastError();
}

// A narrow level's scatter: T targets (tgt, rows of work, d^2 entries
// each), target t's chunk rows of part trow[tptr[t]:tptr[t+1]], in chunk
// order.
GT_EXPORT int gt_sn_narrow_scatter(int T, int d, const int* tptr,
                                   const int* trow, const int* tgt,
                                   const double* part, double* work,
                                   void* stream) {
  if (T == 0) return 0;
  const long long total = (long long)T * d * d;
  const int grid = (int)std::min<long long>(
      (total + kScatterThreads - 1) / kScatterThreads, 65535);
  sn_narrow_scatter_kernel<<<grid, kScatterThreads, 0,
                             (cudaStream_t)stream>>>(T, d, tptr, trow, tgt,
                                                     part, work);
  return (int)cudaGetLastError();
}
