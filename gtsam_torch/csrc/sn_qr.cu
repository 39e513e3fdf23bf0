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
// gt_sn_front_qr: one launch a level, K CTAs (16 warps each) a front, the
// front's column tiles of kNb columns dealt round-robin to its K CTAs
// (tile j to CTA j mod K; the wrapper picks K = the level's share of the
// SMs, at most the front's tiles: several SMs a front on few-front levels,
// one CTA a front where the fronts outnumber the SMs).  Each front lives
// m x C column-major in a scratch the solver keeps (m its true rows, C =
// (W + R) d, its leading dimension m rounded up to 16 so that no 128-byte
// line holds two columns).  A CTA gathers its own columns: zeros, then
// each factor slot's entries of the pool, each child's R_sep rows (the
// block upper triangle) and the W d damping rows (sqrt(lam) on true
// dimensions, 1 on padding) that land in them.
//
// Then blocked Householder with compact-WY updates (LAPACK's dgeqrf,
// dlarft, dlarfb): panel p is column tile p, kNb = 16 columns (32 measured
// 2.5x slower on the sphere: its panel fits in shared memory only up to
// 772 rows, and the column chain then runs through L2;
// scripts/port_qr_probe.py).  Its owner factors it column by column as
// dlarfg and dlarf do: for column k, x0 = A_kk, sigma = sum_{i>k} A_ik^2,
// beta = -sign(x0) hypot(x0, sqrt(sigma)), tau = (beta - x0) / beta, v =
// (1, A_{k+1..,k} / (x0 - beta)) in place below the diagonal (sigma = 0:
// tau = 0, beta = x0), and a warp a column of the panel's other columns
// (w = v^T a, four sums a lane in a fixed order and a butterfly, a -= tau
// w v; the warp on column k + 1 also sums its next sigma), two CTA
// barriers a column (every thread computes dlarfg alike and scales v; one
// barrier with v scaled a step late, and groups of warps on a column's
// rows as the columns run out, measured no faster).  The panel is in
// shared memory where its h x kNb entries fit (h = m - k0, up to 1,744
// rows), else in place in the scratch through L1 and L2.  R's row k is
// negated where beta < 0, in the panel and, by the trailing update, in
// every later tile, so R's diagonal is non-negative (R^T R unchanged; the
// flip is R's, V and T keep their signs): L = R^T is what kernel 8 and
// the tile inverses expect.  Then G = V^T V (a product) and T by dlarft's
// recurrence, T_{0:i,i} = -tau_i T_{0:i,0:i} G_{0:i,i}, T_ii = tau_i (tau
// = 0 leaves T's row and column zero).  Each later tile j takes the panel
// as A_j -= V (T^T (V^T A_j)): W = V^T A_j and A_j + V (-T^T W) are
// products on the FP64 tensor cores (mma.sync m16n8k16, kernels 7 and
// 10's fragments) with the operands loaded straight from L2, each warp a
// fixed set of 16-row granules (an early load of the next granule's
// operands measured no faster, and spilled); the warps' partial W are
// summed in warp order, T^T W on the CUDA cores.
// Several CTAs a front run as a dataflow, with no barrier across them: the
// owner of panel p publishes it (V in place, T and the flips in the
// scratch, then a flag of this launch's number, release at GPU scope), and
// a CTA with a tile past p waits for that flag (acquire) before it applies
// panel p to its tiles in order.  Look-ahead: the owner of tile p + 1
// applies panel p to it first and factors panel p + 1 at once, so the
// panel chain, a one-front level's critical path, overlaps the rest of
// panel p's update.  Every sum runs in an order fixed by the front's
// shape alone (the granules' warps, the warps' order, the panel's lanes),
// never by K or by timing: two launches, and any K, give the same bits.
// K > 1 launches cooperatively, so that a front's CTAs are resident
// together; the flags are the only traffic between them.
//
// Last, each CTA writes R's frontal block and panel row-major for its own
// columns (L and Lp column-major per front, what level_table keeps,
// non-finite entries zeroed) and R_sep (upper triangular, row-major) for
// the parent; once the last panel's flag is seen (it orders every panel
// before it), CTA 0 records the first bad pivot (a true dimension whose
// |R_kk| is not finite or <= tol) as its permuted column, and the CTAs
// share out the inverses of L's 32 x 32 diagonal tiles (chol_tiles.cuh's
// invert_tile, a warp a tile, the identity past the front's width).
// Widths may be odd (W d, R d at d = 3) and a front may have fewer rows
// than columns (kmax = min(m, C) reflectors): every access is one 8-byte
// entry, masked at the front's edges.
// Bound on the H100: the fronts' FP64 operations, 2 m C^2 - 2 C^3 / 3 a
// front, at the FP64 tensor cores' rate, or at the level's share of the
// SMs.  What holds a level back is its fronts' panel chain, one panel
// after another: on the sphere's one-front levels ~95 us a panel, of
// which its 16 column steps (two barriers and two passes over ~1,000
// rows each) take ~38, the look-ahead tile's update ~21 (two passes of
// L2 round trips) and G and T ~14 (scripts/port_qr_probe.py's cuts); the
// trailing updates off the chain (V and a tile read twice a panel from
// L2, the tile written once) hide behind it.
#include <algorithm>

#include "chol_tiles.cuh"

namespace {

constexpr int kNb = 16;                  // a panel's (a column tile's) width
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kGran = 16;                // a granule's rows (an mma's depth)
constexpr int kMB = kNb / 16;            // 16-row blocks of W's reflectors
constexpr int kN8 = kNb / 8;             // 8-column blocks of a tile
constexpr int kTP = kNb + 1;             // pitch of the kNb x kNb arrays
constexpr int kSq = kNb * kTP;
constexpr int kPanelBlock = kNb * kNb + kNb;   // T and the flips, published
constexpr int kInvWarps = 4;             // the warps that invert the tiles
constexpr int kTile = chol::kTile;
constexpr int kPitch = chol::kLtPitch;   // == chol::kLd<double>
static_assert(kPitch == chol::kLd<double>, "a tile's pitch");
static_assert(kNb == 16 || kNb == 32, "a panel is 16 or 32 columns");
// a warp's tile buffers: L_tt^T (below-diagonal entries), its inverse and
// the reciprocals of its diagonal
constexpr int kInvDoubles = 2 * kTile * kPitch + kTile;
constexpr unsigned kFull = 0xffffffffu;
// dynamic shared memory (doubles): T twice (this panel's and the next's),
// W (or G), -T^T W, tau, the flips twice, x0 and sigma; the rest is one
// region for the panel, the warps' partial products or the tile buffers
constexpr int kShmBytes = 232448;
constexpr int kSmall = 4 * kSq + 3 * kNb + 2;
constexpr int kRegion = kShmBytes / 8 - kSmall;
static_assert(kRegion >= kWarps * kSq, "the partial products fit");
static_assert(kRegion >= kInvWarps * kInvDoubles, "the tile buffers fit");

__device__ __forceinline__ double finite_or_zero(double v) {
  return isfinite(v) ? v : 0.0;
}

__device__ __forceinline__ void mma16816(double (&c)[4], const double (&a)[8],
                                         const double (&b)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, {%0, %1, %2, %3};"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// A flag of this launch: set (release, GPU scope) by thread 0 once the
// CTA's writes before it are done; awaited (acquire) by thread 0 of
// another CTA of the front, then a CTA barrier.
__device__ __forceinline__ void publish(int* flag, int seq) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(flag), "r"(seq)
                 : "memory");
  }
}
// A wait that outlasts kStall cycles (seconds: a front's panels take
// milliseconds) can only be a fault; it traps, so the launch fails and
// the caller's next synchronisation raises, instead of hanging the card.
constexpr long long kStall = 20000000000LL;
__device__ __forceinline__ void await(const int* flag, int seq) {
  if (threadIdx.x == 0) {
    const long long t0 = clock64();
    int v;
    while (true) {
      asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
                   : "=r"(v)
                   : "l"(flag)
                   : "memory");
      if (v == seq) break;
      if (clock64() - t0 > kStall) __trap();
      __nanosleep(64);
    }
  }
  __syncthreads();
}

// One front as a CTA sees it: its scratch (column-major, leading dimension
// ld), true rows m, columns C, reflectors kmax.
struct Front {
  double* F;
  int64_t ld;
  int m, C, kmax;
  __device__ double* col(int c) const { return F + (int64_t)c * ld; }
  // V of the panel at rows k0.., its wp reflectors: unit diagonal, zero
  // above it and past the front's rows (read from L2: another CTA may
  // have written it)
  __device__ __forceinline__ double v(int k0, int wp, int r, int i) const {
    const int rr = r - k0;
    if (i >= wp || r >= m || rr < i) return 0.0;
    if (rr == i) return 1.0;
    return __ldcg(col(k0 + i) + r);
  }
  // entry (r, c0 + c) of a tile tw wide, zero past the front's edges
  __device__ __forceinline__ double a(int c0, int tw, int r, int c) const {
    return r < m && c < tw ? __ldcg(col(c0 + c) + r) : 0.0;
  }
};

// out (kNb x kNb, pitch kTP) = V^T B over the rows k0..m-1 of panel
// (k0, wp): B the tile (c0, tw), or V itself (kBisV: G = V^T V).  Warp w
// takes granules w, w + 16, ...; its partial goes to `part`, and the
// partials are summed in warp order.  Ends with a CTA barrier.
template <bool kBisV>
__device__ void gram(const Front& f, int k0, int wp, int c0, int tw,
                     double* part, double* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  double acc[kMB][kN8][4];
#pragma unroll
  for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
    for (int nb = 0; nb < kN8; ++nb)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[mb][nb][v] = 0.0;
  const int ngran = (f.m - k0 + kGran - 1) / kGran;
#pragma unroll 1
  for (int gi = warp; gi < ngran; gi += kWarps) {
    const int r0 = k0 + kGran * gi;
    double a[kMB][8], b[kN8][4];
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
      for (int v = 0; v < 8; ++v)
        a[mb][v] = f.v(k0, wp, r0 + q + 4 * (v >> 1), 16 * mb + g + 8 * (v & 1));
#pragma unroll
    for (int nb = 0; nb < kN8; ++nb)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        b[nb][v] = kBisV ? f.v(k0, wp, r0 + q + 4 * v, 8 * nb + g)
                         : f.a(c0, tw, r0 + q + 4 * v, 8 * nb + g);
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
      for (int nb = 0; nb < kN8; ++nb) mma16816(acc[mb][nb], a[mb], b[nb]);
  }
  double* mine = part + warp * kSq;
#pragma unroll
  for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
    for (int nb = 0; nb < kN8; ++nb)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        mine[(16 * mb + g + 8 * (v >> 1)) * kTP + 8 * nb + 2 * q + (v & 1)] =
            acc[mb][nb][v];
  __syncthreads();
  for (int e = threadIdx.x; e < kNb * kNb; e += kThreads) {
    const int o = (e / kNb) * kTP + e % kNb;
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) s += part[w * kSq + o];
    out[o] = s;
  }
  __syncthreads();
}

// Tile (c0, tw) += V Bw over the rows k0..m-1 (Bw = -T^T V^T A, kNb x
// kNb in shared memory), each row of the panel's block times its flip
// sgn; a warp's granules as in gram.  Ends with a CTA barrier.
__device__ void apply_update(const Front& f, int k0, int wp, int c0, int tw,
                             const double* Bw, const double* sgn) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  double bw[kMB][kN8][4];
#pragma unroll
  for (int ks = 0; ks < kMB; ++ks)
#pragma unroll
    for (int nb = 0; nb < kN8; ++nb)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        bw[ks][nb][v] = Bw[(16 * ks + q + 4 * v) * kTP + 8 * nb + g];
  const int ngran = (f.m - k0 + kGran - 1) / kGran;
#pragma unroll 1
  for (int gi = warp; gi < ngran; gi += kWarps) {
    const int r0 = k0 + kGran * gi;
    double c[kN8][4];
#pragma unroll
    for (int nb = 0; nb < kN8; ++nb)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        c[nb][v] = f.a(c0, tw, r0 + g + 8 * (v >> 1), 8 * nb + 2 * q + (v & 1));
#pragma unroll
    for (int ks = 0; ks < kMB; ++ks) {
      double a[8];
#pragma unroll
      for (int v = 0; v < 8; ++v)
        a[v] = f.v(k0, wp, r0 + g + 8 * (v & 1), 16 * ks + q + 4 * (v >> 1));
#pragma unroll
      for (int nb = 0; nb < kN8; ++nb) mma16816(c[nb], a, bw[ks][nb]);
    }
#pragma unroll
    for (int nb = 0; nb < kN8; ++nb)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int r = r0 + g + 8 * (v >> 1), cc = 8 * nb + 2 * q + (v & 1);
        if (r < f.m && cc < tw) {
          const int rr = r - k0;
          f.col(c0 + cc)[r] = rr < kNb ? c[nb][v] * sgn[rr] : c[nb][v];
        }
      }
  }
  __syncthreads();
}

struct Shared {
  double* T[2];      // T of panels p (even, odd), pitch kTP
  double* W;         // W = V^T A, or G = V^T V
  double* Bw;        // -T^T W
  double* tau;
  double* flip[2];   // each panel row's sign: -1 where R's row is negated
  double* xs;        // x0 and sigma of the next column
  double* region;
};

// Tile j (its columns tw wide) takes panel p (T and flips in shared
// memory's buffer p & 1).
__device__ void apply_panel(const Front& f, const Shared& sh, int p, int j) {
  const int k0 = p * kNb, c0 = j * kNb;
  const int wp = min(kNb, f.kmax - k0), tw = min(kNb, f.C - c0);
  gram<false>(f, k0, wp, c0, tw, sh.region, sh.W);
  const double* T = sh.T[p & 1];
  for (int e = threadIdx.x; e < kNb * kNb; e += kThreads) {
    const int i = e / kNb, c = e % kNb;
    double s = 0.0;
    for (int l = 0; l <= i; ++l) s += T[l * kTP + i] * sh.W[l * kTP + c];
    sh.Bw[i * kTP + c] = -s;
  }
  __syncthreads();
  apply_update(f, k0, wp, c0, tw, sh.Bw, sh.flip[p & 1]);
}

// Factor panel p (tile p, already updated by panels 0..p-1) and form its
// T in shared memory's buffer p & 1; with K > 1, publish T, the flips and
// the flag.
__device__ void factor_panel(const Front& f, const Shared& sh, int p,
                             double* Tg, int* flag, int seq, bool share) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = p * kNb;
  const int tw = min(kNb, f.C - k0), wp = min(kNb, f.kmax - k0);
  const int h = f.m - k0;
  const bool in_smem = (int64_t)h * tw <= kRegion;
  double* P = in_smem ? sh.region : f.col(k0) + k0;
  const int64_t ldp = in_smem ? h : f.ld;
  double* flip = sh.flip[p & 1];
  if (in_smem) {
#pragma unroll 4
    for (int c = 0; c < tw; ++c)
      for (int i = tid; i < h; i += kThreads)
        P[c * h + i] = f.col(k0 + c)[k0 + i];
    __syncthreads();
  }
  if (warp == 0) {
    double sq = 0.0;
    for (int i = 1 + lane; i < h; i += 32) sq += P[i] * P[i];
    sq = gt::warp_sum(sq);
    if (lane == 0) {
      sh.xs[0] = P[0];
      sh.xs[1] = sq;
    }
  }
  if (tid < kNb) {
    sh.tau[tid] = 0.0;
    flip[tid] = 1.0;
  }
  __syncthreads();
  for (int k = 0; k < wp; ++k) {
    const double x0 = sh.xs[0], sg = sh.xs[1];
    double beta = x0, tau = 0.0, scale = 0.0;
    if (sg != 0.0) {
      beta = -copysign(hypot(x0, sqrt(sg)), x0);
      tau = (beta - x0) / beta;
      scale = 1.0 / (x0 - beta);
    }
    double* vk = P + k * ldp;
    for (int i = k + 1 + tid; i < h; i += kThreads) vk[i] *= scale;
    if (tid == 0) {
      vk[k] = fabs(beta);
      sh.tau[k] = tau;
      flip[k] = beta < 0.0 ? -1.0 : 1.0;
    }
    __syncthreads();
    const bool neg = beta < 0.0;
    for (int j = k + 1 + warp; j < tw; j += kWarps) {
      double* cj = P + j * ldp;
      const bool next = j == k + 1;
      double fw = 0.0;
      if (tau != 0.0) {
        double d[4] = {lane == 0 ? cj[k] : 0.0, 0.0, 0.0, 0.0};
        int i = k + 1 + lane;
        for (; i + 96 < h; i += 128)
#pragma unroll
          for (int u = 0; u < 4; ++u) d[u] += vk[i + 32 * u] * cj[i + 32 * u];
        for (; i < h; i += 32) d[0] += vk[i] * cj[i];
        fw = tau * gt::warp_sum((d[0] + d[1]) + (d[2] + d[3]));
      }
      if (fw != 0.0 || next) {
        double q[4] = {0.0, 0.0, 0.0, 0.0}, x0n = 0.0;
        int i = k + 1 + lane;
        if (lane == 0) {
          cj[k] -= fw;
          if (i < h) {
            x0n = cj[i] - fw * vk[i];
            cj[i] = x0n;
          }
          i += 32;
        }
        for (; i + 96 < h; i += 128)
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const double a = cj[i + 32 * u] - fw * vk[i + 32 * u];
            cj[i + 32 * u] = a;
            q[u] += a * a;
          }
        for (; i < h; i += 32) {
          const double a = cj[i] - fw * vk[i];
          cj[i] = a;
          q[0] += a * a;
        }
        if (next) {
          const double sq = gt::warp_sum((q[0] + q[1]) + (q[2] + q[3]));
          if (lane == 0) {
            sh.xs[0] = x0n;
            sh.xs[1] = sq;
          }
        }
      }
      if (neg && lane == 0) cj[k] = -cj[k];
    }
    __syncthreads();
  }
  if (in_smem) {
    for (int e = tid; e < h * tw; e += kThreads) {
      const int c = e / h, i = e - c * h;
      f.col(k0 + c)[k0 + i] = P[e];
    }
    __syncthreads();
  }
  // G = V^T V, then T column by column (a lane a row of T)
  gram<true>(f, k0, wp, 0, 0, sh.region, sh.W);
  double* T = sh.T[p & 1];
  if (warp == 0) {
    for (int i = 0; i < kNb; ++i) {
      const double ti = sh.tau[i];
      double s = 0.0;
      if (lane < i)
        for (int l = lane; l < i; ++l)
          s += T[lane * kTP + l] * sh.W[l * kTP + i];
      if (lane < kNb)
        T[lane * kTP + i] = lane < i ? -ti * s : (lane == i ? ti : 0.0);
      __syncwarp();
    }
  }
  if (share) {
    __syncthreads();
    for (int e = tid; e < kNb * kNb; e += kThreads)
      Tg[e] = T[(e / kNb) * kTP + e % kNb];
    if (tid < kNb) Tg[kNb * kNb + tid] = flip[tid];
    publish(flag, seq);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1) sn_front_qr_kernel(
    int K, int seq, int W, int R, int d, int rmax, int front0,
    const double* __restrict__ pool,
    const int* __restrict__ sptr, const int* __restrict__ spool,
    const int* __restrict__ spos, const int* __restrict__ srow0,
    const int* __restrict__ srows, const int* __restrict__ cptr,
    const int* __restrict__ crow0, const int* __restrict__ cr,
    const int* __restrict__ cfront, const int* __restrict__ mptr,
    const int* __restrict__ cmap, const int* __restrict__ mrows,
    const long long* __restrict__ foff,
    const unsigned char* __restrict__ valid_diag,
    const int* __restrict__ col_vars, const long long* __restrict__ roff,
    const int* __restrict__ rld, double sqrt_lam, double tol,
    double* __restrict__ Fall, double* rsep, double* __restrict__ Lt,
    double* __restrict__ Pt, double* __restrict__ tiles,
    int* __restrict__ rec, int* __restrict__ flags) {
  extern __shared__ __align__(16) double sm[];
  const int s = blockIdx.x / K, rank = blockIdx.x - s * K;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int Wd = W * d, Rd = R * d, C = Wd + Rd;
  Front f;
  f.m = mrows[s];
  f.ld = (f.m + 15) & ~15;
  f.F = Fall + foff[s];
  f.C = C;
  f.kmax = min(f.m, C);
  const int nt = (C + kNb - 1) / kNb;          // column tiles
  const int np = (f.kmax + kNb - 1) / kNb;     // panels
  auto own = [&](int c) { return (c / kNb) % K == rank; };
  Shared sh;
  sh.T[0] = sm;
  sh.T[1] = sm + kSq;
  sh.W = sm + 2 * kSq;
  sh.Bw = sm + 3 * kSq;
  sh.tau = sm + 4 * kSq;
  sh.flip[0] = sh.tau + kNb;
  sh.flip[1] = sh.flip[0] + kNb;
  sh.xs = sh.flip[1] + kNb;
  sh.region = sm + kSmall;
  // the panels' T and flips (after the level's fronts), and the flags, of
  // this front
  const int S = gridDim.x / K;
  const int64_t toff =
      foff[S - 1] + (int64_t)((mrows[S - 1] + 15) & ~15) * C;
  double* Tg = Fall + toff + (int64_t)s * nt * kPanelBlock;
  int* fl = flags + (int64_t)s * nt;

  // 1. this CTA's columns of the front: zeros, then the factor rows, the
  // children's rows and the damping rows (disjoint rows)
  for (int t = rank; t < nt; t += K) {
    const int c0 = t * kNb, tw = min(kNb, C - c0);
    for (int e = tid; e < f.m * tw; e += kThreads) {
      const int c = e / f.m, i = e - c * f.m;
      f.col(c0 + c)[i] = 0.0;
    }
  }
  __syncthreads();
  for (int q = sptr[s] + warp; q < sptr[s + 1]; q += kWarps) {
    const int r0 = srow0[q], c0 = spos[q] * d;
    if (K > 1) {   // a slot's d columns may straddle two tiles
      bool any = false;
      for (int c = 0; c < d; ++c) any |= own(c0 + c);
      if (!any) continue;
    }
    const double* src = pool + (int64_t)spool[q] * rmax * d;
    for (int e = lane; e < srows[q] * d; e += 32) {
      const int i = e / d, c = e - i * d;
      if (own(c0 + c)) f.col(c0 + c)[r0 + i] = src[e];
    }
  }
  for (int q = cptr[s]; q < cptr[s + 1]; ++q) {
    const int rcd = cr[q] * d, r0 = crow0[q], fr = cfront[q], ld = rld[fr];
    const double* src = rsep + roff[fr];
    const int* map = cmap + mptr[q];
    for (int a = warp; a < rcd; a += kWarps)
      for (int b = a + lane; b < rcd; b += 32) {
        const int k = b / d, c = map[k] * d + (b - k * d);
        if (own(c)) f.col(c)[r0 + a] = src[(int64_t)a * ld + b];
      }
  }
  for (int t = tid; t < Wd; t += kThreads)
    if (own(t))
      f.col(t)[f.m - Wd + t] =
          valid_diag[(int64_t)s * Wd + t] ? sqrt_lam : 1.0;
  __syncthreads();

  // 2. blocked Householder: panel 0, then each panel applied to every
  // later tile, tile p + 1 first (and panel p + 1 factored at once)
  const bool share = K > 1;
  if (rank == 0 && np > 0)
    factor_panel(f, sh, 0, Tg, fl, seq, share);
  for (int p = 0; p < np; ++p) {
    int j = p + 1 + ((rank - (p + 1) % K) % K + K) % K;   // first own tile
    if (j >= nt) continue;
    if (p % K != rank) {
      await(fl + p, seq);
      const double* src = Tg + (int64_t)p * kPanelBlock;
      for (int e = tid; e < kNb * kNb; e += kThreads)
        sh.T[p & 1][(e / kNb) * kTP + e % kNb] = __ldcg(src + e);
      if (tid < kNb) sh.flip[p & 1][tid] = __ldcg(src + kNb * kNb + tid);
      __syncthreads();
    }
    for (; j < nt; j += K) {
      apply_panel(f, sh, p, j);
      if (j == p + 1 && j < np)
        factor_panel(f, sh, j, Tg + (int64_t)j * kPanelBlock, fl + j, seq,
                     share);
    }
  }
  // every panel's tile is final once the last panel's flag is seen
  if (share && np > 0 && (np - 1) % K != rank) await(fl + np - 1, seq);

  // 3. R's frontal block and panel, row-major (rows past kmax are zero),
  // and R_sep for the parent, for this CTA's columns
  double* Lo = Lt + (int64_t)s * Wd * Wd;
  double* Po = R > 0 ? Pt + (int64_t)s * Wd * Rd : nullptr;
  double* Ro = R > 0 ? rsep + roff[front0 + s] : nullptr;
  for (int t = rank; t < nt; t += K) {
    const int c0 = t * kNb, tw = min(kNb, C - c0);
    for (int e = tid; e < Wd * tw; e += kThreads) {
      const int r = e / tw, c = c0 + e % tw;
      const double x = r < f.kmax ? finite_or_zero(f.col(c)[r]) : 0.0;
      if (c < Wd)
        Lo[(int64_t)r * Wd + c] = c >= r ? x : 0.0;
      else
        Po[(int64_t)r * Rd + c - Wd] = x;
    }
    for (int e = tid; e < Rd * tw; e += kThreads) {
      const int a = e / tw, c = c0 + e % tw, b = c - Wd;
      if (b >= 0)
        Ro[(int64_t)a * Rd + b] =
            b >= a && Wd + a < f.kmax ? f.col(c)[Wd + a] : 0.0;
    }
  }

  // 4. the first bad pivot among the true dimensions
  if (rank == 0 && warp == 0) {
    int first = -1;
    for (int t0 = 0; t0 < Wd && first < 0; t0 += 32) {
      const int t = t0 + lane;
      bool bad = false;
      if (t < Wd && valid_diag[(int64_t)s * Wd + t]) {
        const double p = t < f.kmax ? __ldcg(f.col(t) + t) : 0.0;
        bad = !(isfinite(p) && p > tol);
      }
      const unsigned b = __ballot_sync(kFull, bad);
      if (b) first = t0 + __ffs(b) - 1;
    }
    if (lane == 0)
      rec[s] = first < 0 ? -1 : col_vars[(int64_t)s * W + first / d];
  }

  // 5. the inverses of L's 32 x 32 diagonal tiles (L = R^T: L_rc = R_cr),
  // tile q by CTA q mod K
  const int nti = (Wd + kTile - 1) / kTile;
  if (warp < kInvWarps) {
    double* buf = sh.region + warp * kInvDoubles;
    chol::Block<double> b{};
    b.lt = buf;
    b.X = buf + kTile * kPitch;
    b.rinv = b.X + kTile * kPitch;
    for (int qt = rank + K * warp; qt < nti; qt += K * kInvWarps) {
      const int o = qt * kTile, r = o + lane;
      for (int kk = 0; kk < kTile; ++kk) {
        const int c = o + kk;
        buf[kk * kPitch + lane] =
            lane > kk && r < Wd && c < f.kmax
                ? finite_or_zero(__ldcg(f.col(r) + c)) : 0.0;
      }
      b.rinv[lane] = 1.0 / (r < Wd ? (r < f.kmax
                                          ? finite_or_zero(__ldcg(f.col(r) + r))
                                          : 0.0)
                                   : 1.0);
      __syncwarp();
      chol::invert_tile(b, 0);
      __syncwarp();
      double* T = tiles + ((int64_t)s * nti + qt) * kTile * kTile;
      for (int i = 0; i < kTile; ++i)
        T[i * kTile + lane] = b.X[i * kPitch + lane];
      __syncwarp();
    }
  }
}

}  // namespace

// One level of S fronts (W column blocks, R row blocks of width d; the
// level's first front is front0 of the factorization), its plan as
// supernodal_kernels.QRLevel holds it; K: CTAs a front (K > 1 launches
// cooperatively: S K CTAs must fit on the card at once); seq: this
// launch's number, never 0 and never a number an earlier launch gave the
// same flags; pool: P x rmax x d Jacobian rows; roff, rld: every front's
// R_sep offset and width in rsep; F: the scratch, the fronts at foff
// (leading dimension m rounded up to 16), then, after the last front,
// each front's ceil(C / kNb) panels' T and flips; Lt: S x Wd x Wd, Pt: S x
// Wd x Rd (unused when R = 0), tiles: S x ceil(Wd / 32) x 32 x 32, rec: S
// ints; flags: S x ceil(C / kNb) ints.
GT_EXPORT int gt_sn_front_qr(
    int S, int W, int R, int d, int rmax, int front0, int K, int seq,
    const double* pool, const int* sptr, const int* spool,
    const int* spos, const int* srow0, const int* srows, const int* cptr,
    const int* crow0, const int* cr, const int* cfront, const int* mptr,
    const int* cmap, const int* mrows, const long long* foff,
    const unsigned char* valid_diag, const int* col_vars,
    const long long* roff, const int* rld, double sqrt_lam, double tol,
    double* F, double* rsep, double* Lt, double* Pt, double* tiles, int* rec,
    int* flags, void* stream) {
  if (S == 0) return 0;
  if (K < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      sn_front_qr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kShmBytes);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeCooperative;
  at[0].val.cooperative = 1;
  cfg.gridDim = dim3((unsigned)(S * K));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kShmBytes;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = at;
  cfg.numAttrs = K > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, sn_front_qr_kernel, K, seq, W, R, d, rmax,
                         front0, pool, sptr, spool, spos, srow0, srows,
                         cptr, crow0, cr, cfront, mptr, cmap, mrows, foff,
                         valid_diag, col_vars, roff, rld, sqrt_lam, tol, F,
                         rsep, Lt, Pt, tiles, rec, flags);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
