// Kernel 8: forward and backward substitution of the supernodal factor
// (float64).
//
// Replaces: gtsam_tpu/linear/supernodal.py::_solve_padded (:572-605): per
// level the rhs gather, the front triangular solves (lax triangular_solve),
// the panel products and the sorted segment-sum / unique scatter of the
// results.
//
// gt_sn_forward_level: one CTA per front.  rhs = (g - acc)[col_vars] into
// shared memory; y = L^-1 rhs by blocked substitution: per 32-column tile
// the CTA copies the diagonal tile of L into shared memory with coalesced
// loads, a warp solves it with shuffles (its chain of 32 dependent steps
// then waits on shared memory, not on global loads), and the CTA updates
// the rows below it from L in global memory; y is written out and c = P y
// computed.
// gt_sn_segment_add: acc[fwd_tgt] += the sum of c's rows over each sorted
// segment, one thread per (target, component); targets are unique.
// gt_sn_backward_level: one CTA per front.  x[row_vars] staged, then
// rhs = y - P^T x_r, x = L^-T rhs by the same blocked substitution from the
// last tile up, stored at the front's true columns (unique).  L and P are
// column-major per front, as cholesky_ex and solve_triangular leave them on
// the card, and every product over them reads along that stored dimension:
// a thread per output where the output runs along it (the forward step),
// else a warp per eight outputs, their loads in flight together since one
// CTA per front leaves the SM latency-bound, and a fixed butterfly sum (the
// backward step).  No atomics.
// Bound on the H100: the factor's bytes (L and P read once per solve);
// levels with one front leave 131 of 132 SMs idle, so the top levels are
// latency-bound.
#include "ba_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 32;        // diagonal tile of the blocked substitution
constexpr int kTileLd = 33;      // its shared-memory row stride
constexpr int kCols = 8;         // outputs per warp pass of warp_dots

// tile[r][c] = L(j0 + r, j0 + c) for c <= r < nb; consecutive threads load
// consecutive rows of one column of the column-major L.
__device__ __forceinline__ void stage_tile(const double* __restrict__ L,
                                           int Wd, int j0, int nb,
                                           double* tile) {
  for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
    const int r = e & (kTile - 1), c = e / kTile;
    if (r < nb && c <= r)
      tile[r * kTileLd + c] = L[(int64_t)(j0 + c) * Wd + j0 + r];
  }
}

// store(o, sum_k A[o * lda + k] v[k]) for o < count: a warp per kCols
// outputs at a time, its lanes over k (each load one contiguous run of A),
// the kCols outputs' loads in flight together, each summed by a fixed
// butterfly.
template <typename Store>
__device__ __forceinline__ void warp_dots(const double* __restrict__ A,
                                          int lda, const double* v, int len,
                                          int count, Store store) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o0 = warp * kCols; o0 < count; o0 += kWarps * kCols) {
    double p[kCols];
#pragma unroll
    for (int u = 0; u < kCols; ++u) p[u] = 0.0;
    for (int k = lane; k < len; k += 32) {
      const double vk = v[k];
#pragma unroll
      for (int u = 0; u < kCols; ++u)
        if (o0 + u < count) p[u] += A[(int64_t)(o0 + u) * lda + k] * vk;
    }
#pragma unroll
    for (int u = 0; u < kCols; ++u) p[u] = gt::warp_sum(p[u]);
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < kCols; ++u)
        if (o0 + u < count) store(o0 + u, p[u]);
    }
  }
}

// y <- L^-1 y in shared memory, L (Wd x Wd, lower, column-major) in global:
// per 32-column tile the CTA stages the diagonal tile, warp 0 solves it
// with shuffles, then the rows below subtract it, one thread per row (a
// warp reads consecutive rows of each column of L).
__device__ void forward_subst(const double* __restrict__ L, int Wd,
                              double* y, double* tile) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j0 = 0; j0 < Wd; j0 += kTile) {
    const int nb = min(kTile, Wd - j0);
    stage_tile(L, Wd, j0, nb, tile);
    __syncthreads();
    if (warp == 0) {
      double v = lane < nb ? y[j0 + lane] : 0.0;
      for (int j = 0; j < nb; ++j) {
        const double yj = __shfl_sync(kFull, v, j) / tile[j * kTileLd + j];
        if (lane == j) v = yj;
        if (lane > j && lane < nb) v -= tile[lane * kTileLd + j] * yj;
      }
      if (lane < nb) y[j0 + lane] = v;
    }
    __syncthreads();
    for (int i = j0 + nb + threadIdx.x; i < Wd; i += kThreads) {
      double acc = 0.0;
      for (int j = 0; j < nb; ++j)
        acc += L[(int64_t)(j0 + j) * Wd + i] * y[j0 + j];
      y[i] -= acc;
    }
    __syncthreads();
  }
}

// x <- L^-T x in shared memory, from the last tile up; the columns above
// each tile subtract it (warp_dots: column i of L is contiguous).
__device__ void backward_subst(const double* __restrict__ L, int Wd,
                               double* x, double* tile) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j1 = Wd; j1 > 0; j1 -= kTile) {
    const int j0 = max(0, j1 - kTile), nb = j1 - j0;
    stage_tile(L, Wd, j0, nb, tile);
    __syncthreads();
    if (warp == 0) {
      double v = lane < nb ? x[j0 + lane] : 0.0;
      for (int j = nb - 1; j >= 0; --j) {
        const double xj = __shfl_sync(kFull, v, j) / tile[j * kTileLd + j];
        if (lane == j) v = xj;
        if (lane < j) v -= tile[j * kTileLd + lane] * xj;
      }
      if (lane < nb) x[j0 + lane] = v;
    }
    __syncthreads();
    warp_dots(L + j0, Wd, x + j0, nb, j0,
              [&](int i, double p) { x[i] -= p; });
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads) sn_forward_kernel(
    int W, int R, int d, int n, const double* __restrict__ g,
    const double* __restrict__ acc, const double* __restrict__ L,
    const double* __restrict__ P, const int* __restrict__ col_vars,
    double* __restrict__ y, double* __restrict__ c) {
  extern __shared__ double sh[];
  const int64_t s = blockIdx.x;
  const int Wd = W * d, Rd = R * d;
  double* tile = sh;                  // kTile x kTileLd
  double* ys = sh + kTile * kTileLd;  // Wd
  for (int r = threadIdx.x; r < Wd; r += kThreads) {
    const int a = r / d, i = r - a * d;
    const int cv = col_vars[s * W + a];
    ys[r] = cv < n ? g[(int64_t)cv * d + i] - acc[(int64_t)cv * d + i] : 0.0;
  }
  __syncthreads();
  forward_subst(L + s * Wd * Wd, Wd, ys, tile);
  for (int r = threadIdx.x; r < Wd; r += kThreads) y[s * Wd + r] = ys[r];
  if (R == 0) return;
  // c = P y, one thread per panel row (consecutive rows of P's columns)
  const double* Ps = P + s * Rd * Wd;
  for (int r = threadIdx.x; r < Rd; r += kThreads) {
    double v = 0.0;
    for (int j = 0; j < Wd; ++j) v += Ps[(int64_t)j * Rd + r] * ys[j];
    c[s * Rd + r] = v;
  }
}

__global__ void __launch_bounds__(kThreads) sn_segment_kernel(
    int64_t total, int d, const double* __restrict__ c,
    const int* __restrict__ src, const int* __restrict__ ptr,
    const int* __restrict__ tgt, double* __restrict__ acc) {
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int64_t t = idx / d;
  const int i = (int)(idx - t * d);
  double v = 0.0;
  for (int k = ptr[t]; k < ptr[t + 1]; ++k) v += c[(int64_t)src[k] * d + i];
  acc[(int64_t)tgt[t] * d + i] += v;
}

__global__ void __launch_bounds__(kThreads) sn_backward_kernel(
    int W, int R, int d, int n, const double* __restrict__ y,
    const double* __restrict__ L, const double* __restrict__ P,
    const int* __restrict__ row_vars, const int* __restrict__ col_vars,
    double* __restrict__ x) {
  extern __shared__ double sh[];
  const int64_t s = blockIdx.x;
  const int Wd = W * d, Rd = R * d;
  double* tile = sh;                    // kTile x kTileLd
  double* xs = sh + kTile * kTileLd;    // Wd
  double* xr = xs + Wd;                 // Rd
  for (int r = threadIdx.x; r < Rd; r += kThreads) {
    const int a = r / d, i = r - a * d;
    xr[r] = x[(int64_t)row_vars[s * R + a] * d + i];
  }
  __syncthreads();
  // rhs = y - P^T x_r (warp_dots: column j of P is contiguous)
  warp_dots(P + s * Rd * Wd, Rd, xr, Rd, Wd,
            [&](int j, double v) { xs[j] = y[s * Wd + j] - v; });
  __syncthreads();
  backward_subst(L + s * Wd * Wd, Wd, xs, tile);
  for (int r = threadIdx.x; r < Wd; r += kThreads) {
    const int a = r / d, i = r - a * d;
    const int cv = col_vars[s * W + a];
    if (cv < n) x[(int64_t)cv * d + i] = xs[r];
  }
}

}  // namespace

// S fronts of W blocks (d wide), R panel rows (0: none, P and c unused), n
// variables.  g: n x d; acc: (n+1) x d; L: S x Wd x Wd and P: S x Rd x Wd,
// each front column-major (as cholesky_ex and solve_triangular leave them);
// y: S x Wd; c: S x Rd.
GT_EXPORT int gt_sn_forward_level(int S, int W, int R, int d, int n,
                                  const double* g, const double* acc,
                                  const double* L, const double* P,
                                  const int* col_vars, double* y, double* c,
                                  void* stream) {
  if (S == 0) return 0;
  const size_t shm =
      ((size_t)kTile * kTileLd + (size_t)W * d) * sizeof(double);
  sn_forward_kernel<<<S, kThreads, shm, (cudaStream_t)stream>>>(
      W, R, d, n, g, acc, L, P, col_vars, y, c);
  return (int)cudaGetLastError();
}

// T unique targets; c: rows of d, indexed by src.
GT_EXPORT int gt_sn_segment_add(int T, int d, const double* c, const int* src,
                                const int* ptr, const int* tgt, double* acc,
                                void* stream) {
  const int64_t total = (int64_t)T * d;
  if (total > 0)
    sn_segment_kernel<<<(unsigned)((total + kThreads - 1) / kThreads),
                        kThreads, 0, (cudaStream_t)stream>>>(total, d, c, src,
                                                             ptr, tgt, acc);
  return (int)cudaGetLastError();
}

// x: (n+1) x d, updated in place at the level's columns; L and P as above.
GT_EXPORT int gt_sn_backward_level(int S, int W, int R, int d, int n,
                                   const double* y, const double* L,
                                   const double* P, const int* row_vars,
                                   const int* col_vars, double* x,
                                   void* stream) {
  if (S == 0) return 0;
  const size_t shm =
      ((size_t)kTile * kTileLd + (size_t)(W + R) * d) * sizeof(double);
  sn_backward_kernel<<<S, kThreads, shm, (cudaStream_t)stream>>>(
      W, R, d, n, y, L, P, row_vars, col_vars, x);
  return (int)cudaGetLastError();
}
