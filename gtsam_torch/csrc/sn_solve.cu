// Kernel 8: forward and backward substitution of the supernodal factor
// (float64), all levels of a solve in one launch per direction.
//
// Replaces: gtsam_tpu/linear/supernodal.py::_solve_padded (:572-605): per
// level the rhs gather, the front triangular solves (lax triangular_solve),
// the panel products and the sorted segment-sum / unique scatter of the
// results.
//
// The inverses of every front's 32x32 diagonal tiles of L (padded slots
// invert to the identity) come from kernel 7's front kernel, once per
// factorization: the solves apply a tile as a 32x32 product, with no
// division and no chain of 32 dependent steps.
// gt_sn_forward: levels bottom-up, one cooperative launch with a grid
// barrier between levels.  A front first gathers its rhs: g at its columns
// less, per column, the sum of the lower levels' c rows that target it
// (the plan's gather CSR: per level a segment, summed first and then added
// to the running total, in the order of the JAX plan's sorted segment sum).
// Then it walks right-looking over its tiles on the stacked panel
// [L_D; P]: the tile's owner forms y_t = Linv_t r_t (a warp per two rows
// of Linv_t, butterfly sums), then every row below subtracts tile t's 32
// columns times y_t.  The panel rows' accumulated updates are c = P y,
// written to the all-levels c buffer for the levels above.
// gt_sn_backward: levels top-down, one cooperative launch.  A front stages
// x at its rows, forms rhs = y - P^T x_r once for all its columns (a warp
// per four columns of P, which are contiguous), then walks from its last
// tile up: x_t = Linv_t^T r_t, then every row above subtracts
// L[tile, i]^T x_t (column i of L is contiguous there); x is stored at the
// front's true columns.
// The launch is in thread-block clusters of 8 CTAs: a level whose
// fronts are few gives each front several CTAs of a cluster, which own its
// 32-row chunks in turn; a tile's owner writes its solution into every
// sharing CTA's shared memory (distributed shared memory) before a cluster
// barrier.  A row's update is split over up to 8 lanes, and where the
// owned rows take one pass, each thread loads its columns of tile t + 1
// while tile t's solution is formed and shared, so a tile step waits on
// barriers and arithmetic rather than on memory.
// L and P are column-major per front, as cholesky_ex and solve_triangular
// leave them; the wrapper's level table holds their addresses.  Any W*d and
// R*d (odd ones at a store width d = 3): a pair of a front's entries is read
// 16 bytes at a time where it is 16-byte aligned, 8 where not.  No atomics:
// every sum runs in a fixed order.  Values written in this launch by other
// CTAs (c in the forward, x in the backward) are read past L1 (ld.cg)
// after the grid barrier.
// Bound on the H100: the function's bytes (L's lower triangles and P read
// once per solve, with the vectors and index arrays), ~0.018 ms per
// direction at the sphere shape; the chain of tiles (up to 12 a front, 8
// levels), each a few barriers long, makes it latency-bound instead.
#include <cooperative_groups.h>

#include <type_traits>

#include "ba_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;        // diagonal tile of the blocked substitution
constexpr int kTileSq = kTile * kTile;

// One level of the factor: a row of the wrapper's level table (int64).
struct Level {
  long long S, W, R;      // fronts, column blocks, row blocks
  long long Wd, Rd;       // W d, R d
  long long L, P;         // addresses of L (S, Wd, Wd) and P (S, Rd, Wd)
  long long y_off, c_off;         // doubles into y and c
  long long tile_off;             // tiles into Linv
  long long slot_off, row_off;    // entries into cols and rows
};
static_assert(sizeof(Level) == 12 * sizeof(long long), "table row");

// ---------------------------------------------------------------------------
// The per-front passes.

// A row update is split over Q lanes (1, 2, 4 or 8): lane `sub` of a
// row's group takes 32 / Q of the tile's 32 columns, and the group sums its
// partials by a fixed butterfly.  A thread's loads go out in batches of at
// most kBatch, each batch in flight together before its sums.
constexpr int kBatch = 8;
constexpr unsigned kFull = 0xffffffffu;

// sum over the columns j = sub, sub + Q, ... (< nb) of col[j * ld] y[j]:
// column-major storage, so the group's loads of one column are one run.
template <int Q>
__device__ __forceinline__ double strided_part(const double* __restrict__ col,
                                               int64_t ld, const double* y,
                                               int nb, int sub) {
  constexpr int n = kTile / Q;
  constexpr int B = n < kBatch ? n : kBatch;
  double acc = 0.0;
#pragma unroll
  for (int g = 0; g < n; g += B) {
    double a[B];
#pragma unroll
    for (int k = 0; k < B; ++k) {
      const int j = sub + Q * (g + k);
      a[k] = j < nb ? col[j * ld] : 0.0;
    }
#pragma unroll
    for (int k = 0; k < B; ++k) acc += a[k] * y[sub + Q * (g + k)];
  }
  return acc;
}

// e[0] and e[1], zero past the first `avail` of them: one 16-byte load
// where e is 16-byte aligned, else 8-byte ones (an odd W*d puts every
// other column of a front, and every other front, on an 8-byte boundary).
__device__ __forceinline__ double2 load_pair(const double* e, int avail) {
  if (avail >= 2 && !(reinterpret_cast<uintptr_t>(e) & 15))
    return *reinterpret_cast<const double2*>(e);
  return make_double2(avail > 0 ? e[0] : 0.0, avail > 1 ? e[1] : 0.0);
}

// sum over j in [sub * 32 / Q, (sub + 1) * 32 / Q) (< nb) of row[j] y[j]:
// a contiguous run, read 16 bytes at a time where it is aligned.
template <int Q>
__device__ __forceinline__ double contiguous_part(
    const double* __restrict__ row, const double* y, int nb, int sub) {
  constexpr int n = kTile / Q;
  constexpr int B = n / 2 < kBatch ? n / 2 : kBatch;
  const int k0 = sub * n;
  double acc = 0.0;
#pragma unroll
  for (int g = 0; g < n / 2; g += B) {
    double2 a[B];
#pragma unroll
    for (int m = 0; m < B; ++m) {
      const int k = k0 + 2 * (g + m);
      a[m] = load_pair(row + k, nb - k);
    }
#pragma unroll
    for (int m = 0; m < B; ++m) {
      const int k = k0 + 2 * (g + m);
      acc += a[m].x * y[k] + a[m].y * y[k + 1];
    }
  }
  return acc;
}

// store(o, sum_k A[col(o) * lda + k] v[k]) for o < count: a warp per
// kCols outputs at a time, its lanes over k (each load one contiguous run
// of A), kUnroll runs of the kCols outputs' loads in flight together, each
// output summed by a fixed butterfly.
template <int kCols, int kUnroll, typename Col, typename Store>
__device__ __forceinline__ void warp_dots(const double* __restrict__ A,
                                          int lda, const double* v, int len,
                                          int count, Col col, Store store) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o0 = warp * kCols; o0 < count; o0 += kWarps * kCols) {
    const double* a_u[kCols];
#pragma unroll
    for (int u = 0; u < kCols; ++u)
      a_u[u] = A + (int64_t)col(o0 + u < count ? o0 + u : o0) * lda;
    double p[kCols];
#pragma unroll
    for (int u = 0; u < kCols; ++u) p[u] = 0.0;
    for (int k0 = lane; k0 < len; k0 += 32 * kUnroll) {
      double a[kUnroll][kCols];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q)
#pragma unroll
        for (int u = 0; u < kCols; ++u) {
          const int k = k0 + 32 * q;
          a[q][u] = (k < len && o0 + u < count) ? a_u[u][k] : 0.0;
        }
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        const int k = k0 + 32 * q;
        const double vk = k < len ? v[k] : 0.0;
#pragma unroll
        for (int u = 0; u < kCols; ++u) p[u] += a[q][u] * vk;
      }
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

// How a front's rows are shared out.  Alone, a CTA owns every row; in a
// cluster split, the front's 32-row chunks (tile t's rows are chunk t, the
// panel's rows follow L_D's) go round the cluster's C CTAs, and tile t's
// owner (rank t % C) forms its solution and writes it into every CTA's
// shared memory before a cluster barrier.
struct Split {
  int C, rank, base;   // CTAs sharing the front, this CTA's rank among
                       // them, the first one's rank in the cluster
  bool cluster;
  // calls f(r) for every owned row r in [lo, hi), a thread per row
  template <typename F>
  __device__ __forceinline__ void rows(int lo, int hi, F f) const {
    if (lo >= hi) return;
    const int c0 = lo / kTile;
    const int k0 = c0 <= rank ? 0 : (c0 - rank + C - 1) / C;
    for (int m = k0 * kTile + threadIdx.x;; m += kThreads) {
      const int ch = rank + C * (m / kTile);
      const int r = ch * kTile + (m & (kTile - 1));
      if (ch * kTile >= hi) break;
      if (r >= lo && r < hi) f(r);
    }
  }
  // the number of owned rows in [0, hi), and the o-th of them
  __device__ __forceinline__ int count(int hi) const {
    const int nch = (hi + kTile - 1) / kTile;
    const int mine = rank < nch ? (nch - rank + C - 1) / C : 0;
    if (mine == 0) return 0;
    const int last = (rank + C * (mine - 1)) * kTile;
    return (mine - 1) * kTile + min(kTile, hi - last);
  }
  __device__ __forceinline__ int row(int o) const {
    return (rank + C * (o / kTile)) * kTile + (o & (kTile - 1));
  }
  // done(r, sum) for every owned row r in [lo, hi), the sum of part(Q, r,
  // sub) over a group of Q lanes (fixed butterfly); Q is the most of
  // 8, 4, 2, 1 that covers the rows in one pass of the CTA, if any does
  template <int Q, typename Part, typename Done>
  __device__ __forceinline__ void rows_by(int lo, int hi, Part part,
                                          Done done) const {
    constexpr int kGroups = kThreads / Q;
    const int o0 = count(lo), n = count(hi) - o0;
    const int grp = threadIdx.x / Q, sub = threadIdx.x % Q;
    for (int b = 0; b < n; b += kGroups) {
      const int o = b + grp;
      const int r = o < n ? row(o0 + o) : 0;
      double acc =
          o < n ? part(std::integral_constant<int, Q>(), r, sub) : 0.0;
#pragma unroll
      for (int off = Q / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(kFull, acc, off);
      if (o < n && sub == 0) done(r, acc);
    }
  }
  template <typename Part, typename Done>
  __device__ __forceinline__ void rows_q(int lo, int hi, Part part,
                                         Done done) const {
    if (lo >= hi) return;
    const int n = count(hi) - count(lo);
    if (n * 8 <= kThreads) rows_by<8>(lo, hi, part, done);
    else if (n * 4 <= kThreads) rows_by<4>(lo, hi, part, done);
    else if (n * 2 <= kThreads) rows_by<2>(lo, hi, part, done);
    else rows_by<1>(lo, hi, part, done);
  }
  __device__ __forceinline__ void sync() const {
    if (cluster) cg::this_cluster().sync(); else __syncthreads();
  }
  // buf[w + u kWarps] = p[u] in every CTA of the split, from warp w of
  // the tile's owner (every lane holds the butterfly sums; lane q writes
  // into the q-th CTA); a sync() makes them visible
  template <int kRows>
  __device__ __forceinline__ void put(double* buf, int w,
                                      const double (&p)[kRows]) const {
    const int lane = threadIdx.x & 31;
    if (lane < C) {
      double* dst =
          cluster ? cg::this_cluster().map_shared_rank(buf, base + lane)
                  : buf;
#pragma unroll
      for (int u = 0; u < kRows; ++u) dst[w + u * kWarps] = p[u];
    }
  }
};

// v (Wd + Rd, shared) holds the front's rhs over the owned rows of
// [0, Wd) and zeros over the owned rows of [Wd, Wd + Rd); on return the
// owned rows hold y = L_D^-1 rhs and c = P y.  Tile t: its owner forms
// y_t = Linv_t r_t (warp w rows w and w + 16, butterfly sums), then every
// owned row below takes tile t's columns.  QP > 0: the owned rows below
// tile 0 take one pass at QP lanes a row, so each thread keeps its row and
// loads its columns of tile t + 1 while tile t's solution is formed and
// shared; QP = 0: rows_q per tile.
template <int QP>
__device__ void front_forward(const double* __restrict__ L, int Wd,
                              const double* __restrict__ P, int Rd,
                              const double* __restrict__ Linv, double* v,
                              const Split& sp, double (*ybuf)[kTile]) {
  constexpr int kRows = kTile / kWarps;
  constexpr int Q = QP > 0 ? QP : 1, n = kTile / Q;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nt = (Wd + kTile - 1) / kTile;
  double li[kRows];
  if (sp.rank < nt) {
    const double* Lt = Linv + (int64_t)sp.rank * kTileSq;
#pragma unroll
    for (int u = 0; u < kRows; ++u)
      li[u] = Lt[(warp + u * kWarps) * kTile + lane];
  }
  const int grp = threadIdx.x / Q, sub = threadIdx.x % Q;
  bool has = false;
  int r = 0;
  if (QP > 0) {
    const int o0 = sp.count(min(kTile, Wd));
    has = grp < sp.count(Wd + Rd) - o0;
    r = has ? sp.row(o0 + grp) : 0;
  }
  const double* rcol = r < Wd ? L + r : P + (r - Wd);
  const int64_t ld = r < Wd ? Wd : Rd;
  double pre[n];
  // this thread's columns of tile t in row r, if r lies below the tile
  auto load = [&](int t) {
    const int j0 = t * kTile, nb = min(kTile, Wd - j0);
    const bool below = has && r >= j0 + nb;
#pragma unroll
    for (int k = 0; k < n; ++k) {
      const int j = sub + Q * k;
      pre[k] = below && j < nb ? rcol[(j0 + j) * ld] : 0.0;
    }
  };
  if (QP > 0) load(0);
  for (int t = 0; t < nt; ++t) {
    const int j0 = t * kTile, nb = min(kTile, Wd - j0);
    const bool owner = t % sp.C == sp.rank;
    if (owner) {
      const double rk = lane < nb ? v[j0 + lane] : 0.0;
      double p[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) p[u] = gt::warp_sum(li[u] * rk);
      sp.put(ybuf[t & 1], warp, p);
      if (t + sp.C < nt) {
        const double* Lt = Linv + (int64_t)(t + sp.C) * kTileSq;
#pragma unroll
        for (int u = 0; u < kRows; ++u)
          li[u] = Lt[(warp + u * kWarps) * kTile + lane];
      }
    }
    sp.sync();
    const double* yt = ybuf[t & 1];
    if (owner && threadIdx.x < nb) v[j0 + threadIdx.x] = yt[threadIdx.x];
    if (QP > 0) {
      double acc = 0.0;
#pragma unroll
      for (int k = 0; k < n; ++k) acc += pre[k] * yt[sub + Q * k];
#pragma unroll
      for (int off = Q / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(kFull, acc, off);
      if (has && r >= j0 + nb && sub == 0) {
        if (r < Wd) v[r] -= acc; else v[r] += acc;
      }
      if (t + 1 < nt) load(t + 1);
    } else {
      sp.rows_q(
          j0 + nb, Wd + Rd,
          [&](auto q, int r, int sub) {
            constexpr int Qr = decltype(q)::value;
            return r < Wd ? strided_part<Qr>(L + (int64_t)j0 * Wd + r, Wd,
                                             yt, nb, sub)
                          : strided_part<Qr>(P + (int64_t)j0 * Rd + (r - Wd),
                                             Rd, yt, nb, sub);
          },
          [&](int r, double u) {
            if (r < Wd) v[r] -= u; else v[r] += u;
          });
    }
    __syncthreads();
  }
}

// v (Wd, shared) holds rhs = y - P^T x_r over the owned rows; on return
// they hold x = L_D^-T rhs.  From the last tile up: its owner forms
// x_t = Linv_t^T r_t (warp w columns w and w + 16 of Linv_t, lanes over its
// rows, butterfly sums), then every owned row above takes tile t's rows of
// L (row i of L^T, column i of L, is contiguous).  QP as in front_forward,
// over the owned rows above the last tile.
template <int QP>
__device__ void front_backward(const double* __restrict__ L, int Wd,
                               const double* __restrict__ Linv, double* v,
                               const Split& sp, double (*xbuf)[kTile]) {
  constexpr int kRows = kTile / kWarps;
  constexpr int Q = QP > 0 ? QP : 1, n = kTile / Q;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nt = (Wd + kTile - 1) / kTile;
  // the owned tiles are t = rank (mod C), taken from the last one down
  const int t_last = nt - 1 - ((nt - 1 - sp.rank) % sp.C + sp.C) % sp.C;
  double li[kRows];
  if (t_last >= 0) {
    const double* Lt = Linv + (int64_t)t_last * kTileSq;
#pragma unroll
    for (int u = 0; u < kRows; ++u)
      li[u] = Lt[lane * kTile + warp + u * kWarps];
  }
  const int grp = threadIdx.x / Q, sub = threadIdx.x % Q;
  bool has = false;
  int i = 0;
  if (QP > 0) {
    has = grp < sp.count((nt - 1) * kTile);
    i = has ? sp.row(grp) : 0;
  }
  const double* lrow = L + (int64_t)i * Wd + sub * n;
  double2 pre[n / 2];
  // this thread's columns of tile t in row i of L^T, if i lies above it
  auto load = [&](int t) {
    const int j0 = t * kTile, nb = min(kTile, Wd - j0);
    const bool above = has && i < j0;
#pragma unroll
    for (int m = 0; m < n / 2; ++m) {
      const int k = sub * n + 2 * m;
      const double* e = lrow + j0 + 2 * m;
      pre[m] = above ? load_pair(e, nb - k) : make_double2(0.0, 0.0);
    }
  };
  if (QP > 0) load(nt - 1);
  for (int t = nt - 1; t >= 0; --t) {
    const int j0 = t * kTile, nb = min(kTile, Wd - j0);
    const bool owner = t % sp.C == sp.rank;
    if (owner) {
      const double rk = lane < nb ? v[j0 + lane] : 0.0;
      double p[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) p[u] = gt::warp_sum(li[u] * rk);
      sp.put(xbuf[t & 1], warp, p);
      if (t - sp.C >= 0) {
        const double* Lt = Linv + (int64_t)(t - sp.C) * kTileSq;
#pragma unroll
        for (int u = 0; u < kRows; ++u)
          li[u] = Lt[lane * kTile + warp + u * kWarps];
      }
    }
    sp.sync();
    const double* xt = xbuf[t & 1];
    if (owner && threadIdx.x < nb) v[j0 + threadIdx.x] = xt[threadIdx.x];
    if (QP > 0) {
      double acc = 0.0;
#pragma unroll
      for (int m = 0; m < n / 2; ++m) {
        const int k = sub * n + 2 * m;
        acc += pre[m].x * xt[k] + pre[m].y * xt[k + 1];
      }
#pragma unroll
      for (int off = Q / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(kFull, acc, off);
      if (has && i < j0 && sub == 0) v[i] -= acc;
      if (t > 0) load(t - 1);
    } else {
      sp.rows_q(
          0, j0,
          [&](auto q, int i, int sub) {
            return contiguous_part<decltype(q)::value>(
                L + (int64_t)i * Wd + j0, xt, nb, sub);
          },
          [&](int i, double u) { v[i] -= u; });
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// All levels, one cooperative launch per direction.  Launched in clusters
// of C CTAs (a power of two), a level gives each front the most CTAs of a
// cluster, Cs = C, C/2, ..., that still lets all its fronts run at once
// (the cluster's C / Cs groups each take a front); when even Cs = 2 does
// not, or C is 1, each front gets a CTA and the CTAs loop over the fronts.
// Every group of a cluster steps through the same rounds of fronts: a
// group with no front in a round still meets its cluster's barriers.

struct Round {
  Split sp;
  int first, step;   // this group's front in the first round, and the step
};

__device__ __forceinline__ Round level_split(int S) {
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks();
  const int ncl = gridDim.x / C;
  int Cs = C;
  while (Cs > 1 && ncl * (C / Cs) < S) Cs >>= 1;
  if (Cs <= 1) return Round{Split{1, 0, 0, false}, (int)blockIdx.x,
                            (int)gridDim.x};
  const int groups = C / Cs, rank = (int)cl.block_rank();
  const int g = rank / Cs;
  return Round{Split{Cs, rank % Cs, g * Cs, true},
               (int)(blockIdx.x / C) * groups + g, ncl * groups};
}

// The fronts of a level that this CTA works on: body(s) for each; in a
// cluster split, the rounds run in step over the cluster (a group without
// a front in a round calls idle(), which meets the same barriers).
template <typename Body, typename Idle>
__device__ __forceinline__ void for_fronts(const Round& rd, int S, Body body,
                                           Idle idle) {
  if (!rd.sp.cluster) {
    for (int s = rd.first; s < S; s += rd.step) body(s);
    return;
  }
  const int g0 = rd.first - rd.sp.base / rd.sp.C;   // the cluster's first
  for (int s0 = g0; s0 < S; s0 += rd.step) {
    const int s = s0 + rd.sp.base / rd.sp.C;
    if (s < S) body(s); else idle();
  }
}

__global__ void __launch_bounds__(kThreads) sn_forward_kernel(
    int nlev, int d, int n, const Level* __restrict__ table,
    const double* __restrict__ g, const double* __restrict__ Linv,
    const int* __restrict__ cols, const int* __restrict__ gat_ptr,
    const int* __restrict__ gat_seg, const int* __restrict__ gat_src,
    double* y, double* c) {
  extern __shared__ double v[];   // Wd + Rd of the widest front
  // a tile's solution, written by the tile's owner into every CTA that
  // shares the front (double-buffered)
  __shared__ double ybuf[2][kTile];
  cg::grid_group grid = cg::this_grid();
  for (int k = 0; k < nlev; ++k) {
    const Level lv = table[k];
    const int W = (int)lv.W, Wd = (int)lv.Wd, Rd = (int)lv.Rd;
    const int nt = (Wd + kTile - 1) / kTile;
    const Round rd = level_split((int)lv.S);
    const Split& sp = rd.sp;
    for_fronts(rd, (int)lv.S, [&](int s) {
      // rhs = g[col] - sum over the lower levels' c rows that target col
      sp.rows(0, Wd, [&](int r) {
        const int a = r / d, i = r - a * d;
        const int64_t q = lv.slot_off + (int64_t)s * W + a;
        const int cv = cols[q];
        double acc = 0.0;
        for (int e = gat_ptr[q]; e < gat_ptr[q + 1]; ++e) {
          double sg = 0.0;
#pragma unroll 4
          for (int m = gat_seg[e]; m < gat_seg[e + 1]; ++m)
            sg += __ldcg(c + (int64_t)gat_src[m] * d + i);
          acc += sg;
        }
        v[r] = cv < n ? g[(int64_t)cv * d + i] - acc : 0.0;
      });
      sp.rows(Wd, Wd + Rd, [&](int r) { v[r] = 0.0; });
      __syncthreads();
      const double* P = reinterpret_cast<const double*>(lv.P);
      const double* Ls = reinterpret_cast<const double*>(lv.L) +
                         (int64_t)s * Wd * Wd;
      const double* Ps = Rd ? P + (int64_t)s * Rd * Wd : nullptr;
      const double* Li = Linv + (lv.tile_off + (int64_t)s * nt) * kTileSq;
      const int rows = sp.count(Wd + Rd) - sp.count(min(kTile, Wd));
      if (rows * 8 <= kThreads)
        front_forward<8>(Ls, Wd, Ps, Rd, Li, v, sp, ybuf);
      else if (rows * 4 <= kThreads)
        front_forward<4>(Ls, Wd, Ps, Rd, Li, v, sp, ybuf);
      else if (rows * 2 <= kThreads)
        front_forward<2>(Ls, Wd, Ps, Rd, Li, v, sp, ybuf);
      else
        front_forward<0>(Ls, Wd, Ps, Rd, Li, v, sp, ybuf);
      sp.rows(0, Wd, [&](int r) { y[lv.y_off + (int64_t)s * Wd + r] = v[r]; });
      sp.rows(Wd, Wd + Rd, [&](int r) {
        c[lv.c_off + (int64_t)s * Rd + (r - Wd)] = v[r];
      });
      sp.sync();
    }, [&] { for (int t = 0; t <= nt; ++t) sp.sync(); });
    if (k + 1 < nlev) grid.sync();
  }
}

__global__ void __launch_bounds__(kThreads) sn_backward_kernel(
    int nlev, int d, int n, const Level* __restrict__ table,
    const double* __restrict__ y, const double* __restrict__ Linv,
    const int* __restrict__ cols, const int* __restrict__ rows, double* x) {
  extern __shared__ double sh[];  // xs: Wd, xr: Rd of the widest front
  __shared__ double xbuf[2][kTile];   // as ybuf in sn_forward_kernel
  cg::grid_group grid = cg::this_grid();
  for (int k = nlev - 1; k >= 0; --k) {
    const Level lv = table[k];
    const int W = (int)lv.W, R = (int)lv.R, Wd = (int)lv.Wd, Rd = (int)lv.Rd;
    const int nt = (Wd + kTile - 1) / kTile;
    double* xs = sh;
    double* xr = sh + Wd;
    const Round rd = level_split((int)lv.S);
    const Split& sp = rd.sp;
    for_fronts(rd, (int)lv.S, [&](int s) {
      for (int r = threadIdx.x; r < Rd; r += kThreads) {
        const int a = r / d, i = r - a * d;
        const int rv = rows[lv.row_off + (int64_t)s * R + a];
        xr[r] = rv < n ? __ldcg(x + (int64_t)rv * d + i) : 0.0;
      }
      __syncthreads();
      const double* ys = y + lv.y_off + (int64_t)s * Wd;
      if (Rd) {
        // rhs = y - P^T x_r at the owned columns (column j of P is
        // contiguous)
        warp_dots<4, 4>(
            reinterpret_cast<const double*>(lv.P) + (int64_t)s * Rd * Wd, Rd,
            xr, Rd, sp.count(Wd), [&](int o) { return sp.row(o); },
            [&](int o, double p) {
              const int j = sp.row(o);
              xs[j] = ys[j] - p;
            });
      } else {
        sp.rows(0, Wd, [&](int r) { xs[r] = ys[r]; });
      }
      __syncthreads();
      const double* Ls = reinterpret_cast<const double*>(lv.L) +
                         (int64_t)s * Wd * Wd;
      const double* Li = Linv + (lv.tile_off + (int64_t)s * nt) * kTileSq;
      const int rows = sp.count((nt - 1) * kTile);
      if (rows * 8 <= kThreads)
        front_backward<8>(Ls, Wd, Li, xs, sp, xbuf);
      else if (rows * 4 <= kThreads)
        front_backward<4>(Ls, Wd, Li, xs, sp, xbuf);
      else
        front_backward<0>(Ls, Wd, Li, xs, sp, xbuf);
      sp.rows(0, Wd, [&](int r) {
        const int a = r / d, i = r - a * d;
        const int cv = cols[lv.slot_off + (int64_t)s * W + a];
        if (cv < n) x[(int64_t)cv * d + i] = xs[r];
      });
      sp.sync();
    }, [&] { for (int t = 0; t <= nt; ++t) sp.sync(); });
    if (k > 0) grid.sync();
  }
}

}  // namespace

// n variables of width d; max_front: the most Wd + Rd of a front (doubles
// of dynamic shared memory); cluster: CTAs a cluster (8; 1 gives every
// front a CTA of its own, for timing the split against).  g: n x d; cols:
// every level's col_vars, flattened in level order (sentinel n); gat_ptr
// over those slots -> gat_seg -> gat_src, d-rows of c; y, c: every level's
// y (S x Wd) and c (S x Rd) at the table's offsets.
GT_EXPORT int gt_sn_forward(int nlev, int d, int n, int max_front,
                            int cluster, const long long* table,
                            const double* g, const double* Linv,
                            const int* cols, const int* gat_ptr,
                            const int* gat_seg, const int* gat_src, double* y,
                            double* c, void* stream) {
  if (nlev == 0) return 0;
  return gt::launch_levels(sn_forward_kernel, kThreads, cluster,
                           (size_t)max_front * sizeof(double), 0,
                           (cudaStream_t)stream, nlev, d, n,
                           reinterpret_cast<const Level*>(table), g, Linv,
                           cols, gat_ptr, gat_seg, gat_src, y, c);
}

// x: n x d, every variable written once (at its front's true columns);
// rows: every level's row_vars, flattened in level order (sentinel n).
GT_EXPORT int gt_sn_backward(int nlev, int d, int n, int max_front,
                             int cluster, const long long* table,
                             const double* y, const double* Linv,
                             const int* cols, const int* rows, double* x,
                             void* stream) {
  if (nlev == 0) return 0;
  return gt::launch_levels(sn_backward_kernel, kThreads, cluster,
                           (size_t)max_front * sizeof(double), 0,
                           (cudaStream_t)stream, nlev, d, n,
                           reinterpret_cast<const Level*>(table), y, Linv,
                           cols, rows, x);
}
