// Kernel 12: the level step of the multifrontal QR (float64).
//
// Replaces: gtsam_tpu/linear/supernodal.py::factorize_qr (:759-826): the
// gathers of each front from the pool of whitened Jacobian rows and the
// children's R_sep (:788-791), the damping and padding rows (:793-799), the
// batched QR (:800), the pivot test and first bad column (:801-812), the
// zeroing of non-finite factor entries (:813-820) and the R_sep scatter
// for the parent (:822-825); and kernel 8's inverses of the fronts' 32 x 32
// diagonal tiles (which the JAX package leaves to its triangular solves).
//
// gt_sn_front_qr: one CTA (16 warps) per front of the level, one launch.
// The CTA assembles its front, m x C column-major in a scratch the solver
// keeps (m its true rows, C = (W + R) d): zeros, then each factor slot's
// rdim x d block of the pool (a warp a slot), each child's R_sep rows
// (the block upper triangle, a warp a row), and the W d damping rows
// (sqrt(lam) on true dimensions, 1 on padding).  Then Householder QR
// column by column, as LAPACK's dlarfg and dlarf: for column k, with x0 =
// A_kk and sigma = sum_{i>k} A_ik^2, beta = -sign(x0) hypot(x0,
// sqrt(sigma)), tau = (beta - x0) / beta and v = (1, A_{k+1..,k} / (x0 -
// beta)) (sigma = 0: tau = 0, beta = x0); v goes to shared memory, and each
// warp takes the trailing columns j = w (mod 16): w_j = v^T A_{k..,j} (its
// lanes' partial sums in row order, then a butterfly), A_{k..,j} -= tau w_j
// v.  R's row k is negated where beta < 0, so R's diagonal is
// non-negative (R^T R unchanged): L = R^T is then the Cholesky factor of
// A^T A up to rounding, what kernel 8 and the tile inverses expect.  The
// warp that updates column k + 1 also sums its new squares below row k + 1
// (sigma of the next step), so a step has no block-wide reduction.  Every
// sum runs in a fixed order: two launches give the same bits.  Last, the
// outputs, from the front: R's frontal block and panel row-major (L and Lp
// column-major per front, what level_table keeps), R_sep (upper
// triangular, row-major) for the parent, the first bad pivot (a true
// dimension whose |R_kk| is not finite or <= tol) as its permuted column,
// and the inverses of L's 32 x 32 diagonal tiles (chol_tiles.cuh's
// invert_tile, a warp a tile, the identity past the front's width).
// Widths may be odd (W d, R d at d = 3): every access is one 8-byte
// entry.
// Bound on the H100: the fronts' FP64 operations, 2 m C^2 - 2 C^3 / 3 a
// front, at the card's rate, or at the S-SM share of the level's fronts;
// one CTA a front holds a one-front level to one SM, and each step of this
// unblocked design reads the trailing columns twice and writes them once
// through L1 and L2, so the one-front levels are bound by one SM's memory
// traffic.  A blocked (compact-WY) design on the FP64 tensor cores, and a
// split of few-front levels over several SMs, are the redesign's work.
#include <algorithm>

#include "chol_tiles.cuh"

namespace {

constexpr int kQrWarps = 16;
constexpr int kQrThreads = 32 * kQrWarps;
constexpr int kInvWarps = 4;     // the warps that invert the tiles
constexpr int kTile = chol::kTile;
constexpr int kPitch = chol::kLtPitch;      // == chol::kLd<double>
static_assert(kPitch == chol::kLd<double>, "a tile's pitch");
// a warp's tile buffers: L_tt^T (below-diagonal entries), its inverse and
// the reciprocals of its diagonal
constexpr int kInvDoubles = 2 * kTile * kPitch + kTile;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ double finite_or_zero(double v) {
  return isfinite(v) ? v : 0.0;
}

__global__ void __launch_bounds__(kQrThreads, 1) sn_front_qr_kernel(
    int W, int R, int d, int rmax, int front0,
    const double* __restrict__ pool, const int* __restrict__ sptr,
    const int* __restrict__ spool, const int* __restrict__ spos,
    const int* __restrict__ srow0, const int* __restrict__ srows,
    const int* __restrict__ cptr, const int* __restrict__ crow0,
    const int* __restrict__ cr, const int* __restrict__ cfront,
    const int* __restrict__ mptr, const int* __restrict__ cmap,
    const int* __restrict__ mrows, const long long* __restrict__ foff,
    const unsigned char* __restrict__ valid_diag,
    const int* __restrict__ col_vars, const long long* __restrict__ roff,
    const int* __restrict__ rld, double sqrt_lam, double tol,
    double* __restrict__ Fall, double* rsep, double* __restrict__ Lt,
    double* __restrict__ Pt, double* __restrict__ tiles,
    int* __restrict__ rec) {
  extern __shared__ __align__(16) double sm[];
  __shared__ double s_x0, s_sigma, s_tau, s_scale;
  __shared__ int s_flip;
  const int s = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int Wd = W * d, Rd = R * d, C = Wd + Rd;
  const int m = mrows[s];
  double* F = Fall + foff[s];
  auto at = [&](int i, int j) -> double& { return F[(int64_t)j * m + i]; };

  // 1. the front: zeros, then the factor rows, the children's rows and the
  // damping rows (disjoint rows)
  const int64_t mc = (int64_t)m * C;
  for (int64_t e = tid; e < mc; e += kQrThreads) F[e] = 0.0;
  __syncthreads();
  for (int q = sptr[s] + warp; q < sptr[s + 1]; q += kQrWarps) {
    const int r0 = srow0[q], c0 = spos[q] * d;
    const double* src = pool + (int64_t)spool[q] * rmax * d;
    for (int e = lane; e < srows[q] * d; e += 32) {
      const int i = e / d, c = e - i * d;
      at(r0 + i, c0 + c) = src[e];
    }
  }
  for (int q = cptr[s]; q < cptr[s + 1]; ++q) {
    const int rcd = cr[q] * d, r0 = crow0[q], f = cfront[q], ld = rld[f];
    const double* src = rsep + roff[f];
    const int* map = cmap + mptr[q];
    for (int a = warp; a < rcd; a += kQrWarps)
      for (int b = a + lane; b < rcd; b += 32) {
        const int k = b / d;
        at(r0 + a, map[k] * d + (b - k * d)) = src[(int64_t)a * ld + b];
      }
  }
  for (int t = tid; t < Wd; t += kQrThreads)
    at(m - Wd + t, t) = valid_diag[(int64_t)s * Wd + t] ? sqrt_lam : 1.0;
  __syncthreads();

  // 2. Householder, column by column
  double* v = sm;
  const int kmax = min(m, C);
  if (warp == 0) {
    double sq = 0.0;
    for (int i = 1 + lane; i < m; i += 32) sq += at(i, 0) * at(i, 0);
    sq = gt::warp_sum(sq);
    if (lane == 0) {
      s_sigma = sq;
      s_x0 = at(0, 0);
    }
  }
  __syncthreads();
  for (int k = 0; k < kmax; ++k) {
    if (tid == 0) {
      const double x0 = s_x0, sg = s_sigma;
      double beta = x0, tau = 0.0, scale = 0.0;
      if (sg != 0.0) {
        beta = -copysign(hypot(x0, sqrt(sg)), x0);
        tau = (beta - x0) / beta;
        scale = 1.0 / (x0 - beta);
      }
      s_tau = tau;
      s_scale = scale;
      s_flip = beta < 0.0;
      at(k, k) = fabs(beta);
    }
    __syncthreads();
    const double tau = s_tau, scale = s_scale;
    const bool flip = s_flip;
    for (int i = k + 1 + tid; i < m; i += kQrThreads) v[i] = at(i, k) * scale;
    if (tid == 0) v[k] = 1.0;
    __syncthreads();
    for (int j = k + 1 + ((warp - (k + 1) % kQrWarps) + kQrWarps) % kQrWarps;
         j < C; j += kQrWarps) {
      double* cj = F + (int64_t)j * m;
      const bool next = j == k + 1;
      double f = 0.0;
      if (tau != 0.0) {
        double dot = 0.0;
        for (int i = k + lane; i < m; i += 32) dot += v[i] * cj[i];
        f = tau * gt::warp_sum(dot);
      }
      if (f != 0.0 || next) {
        double sq = 0.0, x0n = 0.0;
        for (int i = k + lane; i < m; i += 32) {
          const double a = cj[i] - f * v[i];
          cj[i] = a;
          if (i == k + 1) x0n = a;
          if (i > k + 1) sq += a * a;
        }
        if (next) {
          sq = gt::warp_sum(sq);
          x0n = __shfl_sync(kFull, x0n, 1);
          if (lane == 0) {
            s_sigma = sq;
            s_x0 = x0n;
          }
        }
      }
      if (flip && lane == 0) cj[k] = -cj[k];
    }
    __syncthreads();
  }

  // 3. the first bad pivot among the true dimensions
  if (warp == 0) {
    int first = -1;
    for (int t0 = 0; t0 < Wd && first < 0; t0 += 32) {
      const int t = t0 + lane;
      bool bad = false;
      if (t < Wd && valid_diag[(int64_t)s * Wd + t]) {
        const double p = t < kmax ? at(t, t) : 0.0;
        bad = !(isfinite(p) && p > tol);
      }
      const unsigned b = __ballot_sync(kFull, bad);
      if (b) first = t0 + __ffs(b) - 1;
    }
    if (lane == 0) rec[s] = first < 0 ? -1 : col_vars[(int64_t)s * W + first / d];
  }
  // 4. R's frontal block and panel, row-major (rows past kmax are zero),
  // and R_sep for the parent
  double* Lo = Lt + (int64_t)s * Wd * Wd;
  for (int64_t e = tid; e < (int64_t)Wd * Wd; e += kQrThreads) {
    const int r = (int)(e / Wd), c = (int)(e - (int64_t)r * Wd);
    Lo[e] = c >= r && r < kmax ? finite_or_zero(at(r, c)) : 0.0;
  }
  if (R > 0) {
    double* Po = Pt + (int64_t)s * Wd * Rd;
    for (int64_t e = tid; e < (int64_t)Wd * Rd; e += kQrThreads) {
      const int r = (int)(e / Rd), c = (int)(e - (int64_t)r * Rd);
      Po[e] = r < kmax ? finite_or_zero(at(r, Wd + c)) : 0.0;
    }
    double* Ro = rsep + roff[front0 + s];
    for (int64_t e = tid; e < (int64_t)Rd * Rd; e += kQrThreads) {
      const int a = (int)(e / Rd), b = (int)(e - (int64_t)a * Rd);
      Ro[e] = b >= a && Wd + a < kmax ? at(Wd + a, Wd + b) : 0.0;
    }
  }
  __syncthreads();   // v is read no more: its shared memory takes the tiles

  // 5. the inverses of L's 32 x 32 diagonal tiles (L = R^T: L_rc = R_cr)
  const int nt = (Wd + kTile - 1) / kTile;
  if (warp < kInvWarps) {
    double* buf = sm + warp * kInvDoubles;
    chol::Block<double> b{};
    b.lt = buf;
    b.X = buf + kTile * kPitch;
    b.rinv = b.X + kTile * kPitch;
    for (int q = warp; q < nt; q += kInvWarps) {
      const int o = q * kTile, r = o + lane;
      for (int kk = 0; kk < kTile; ++kk) {
        const int c = o + kk;
        buf[kk * kPitch + lane] =
            lane > kk && r < Wd && c < kmax ? finite_or_zero(at(c, r)) : 0.0;
      }
      b.rinv[lane] =
          1.0 / (r < Wd ? (r < kmax ? finite_or_zero(at(r, r)) : 0.0) : 1.0);
      __syncwarp();
      chol::invert_tile(b, 0);
      __syncwarp();
      double* T = tiles + ((int64_t)s * nt + q) * kTile * kTile;
      for (int i = 0; i < kTile; ++i)
        T[i * kTile + lane] = b.X[i * kPitch + lane];
      __syncwarp();
    }
  }
}

}  // namespace

// One level of S fronts (W column blocks, R row blocks of width d; the
// level's first front is front0 of the factorization), its plan as
// supernodal_kernels.QRLevel holds it: mmax, the most rows of a front
// (shared memory: mmax doubles), at most QR_MAX_ROWS; pool: P x rmax x d
// Jacobian rows; roff, rld: every front's R_sep offset and width in rsep;
// F: the scratch (the fronts at foff); Lt: S x Wd x Wd, Pt: S x Wd x Rd
// (unused when R = 0), tiles: S x ceil(Wd / 32) x 32 x 32, rec: S ints.
GT_EXPORT int gt_sn_front_qr(
    int S, int W, int R, int d, int rmax, int front0, int mmax,
    const double* pool, const int* sptr, const int* spool, const int* spos,
    const int* srow0, const int* srows, const int* cptr, const int* crow0,
    const int* cr, const int* cfront, const int* mptr, const int* cmap,
    const int* mrows, const long long* foff, const unsigned char* valid_diag,
    const int* col_vars, const long long* roff, const int* rld,
    double sqrt_lam, double tol, double* F, double* rsep, double* Lt,
    double* Pt, double* tiles, int* rec, void* stream) {
  if (S == 0) return 0;
  const size_t shm = std::max((size_t)mmax * sizeof(double),
                              (size_t)kInvWarps * kInvDoubles *
                                  sizeof(double));
  cudaError_t e = cudaFuncSetAttribute(
      sn_front_qr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shm);
  if (e != cudaSuccess) return (int)e;
  sn_front_qr_kernel<<<S, kQrThreads, shm, (cudaStream_t)stream>>>(
      W, R, d, rmax, front0, pool, sptr, spool, spos, srow0, srows, cptr,
      crow0, cr, cfront, mptr, cmap, mrows, foff, valid_diag, col_vars, roff,
      rld, sqrt_lam, tol, F, rsep, Lt, Pt, tiles, rec);
  return (int)cudaGetLastError();
}
