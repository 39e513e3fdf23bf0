// Kernel 7: the level step of the supernodal Cholesky (float64).
//
// Replaces: gtsam_tpu/linear/supernodal.py::factorize (:372-442): the damping
// (:383-392), the front and panel gathers (:398-403, :429-430), the batched
// Cholesky (:404), the pivot test and first bad column (:404-417), the
// zeroing of non-finite factor entries (:419, :434) and the sorted
// segment-sum Schur scatter (:436-441).  The panel Lp = A L^-T (:431) is a
// batched product with the inverse this kernel writes, and U = Lp Lp^T
// (:436) another, both in the library (torch.bmm), as the JAX package
// leaves its products to XLA.
//
// gt_sn_front_factor: one CTA (8 warps) per front of the level, one launch.
// The CTA gathers its front from the working store into the level's L^-1
// output, used as its working buffer (row-major: the lower 128-column
// blocks and the whole diagonal blocks, with the flips, the padding
// identity and the damping, lam or lam * clip(H_cc[k, k], min, max) of the
// undamped store, on true dimensions), and its panel, transposed, into At.
// Then it factors the front right-looking in 128-column blocks: each
// diagonal block D is factored and inverted in shared memory by kernel
// 10's code (chol_tiles.cuh::factor_block, identity past the front's
// width), the blocks below it become L_ik = A_ik L_D^-T and the trailing
// blocks A_ij -= L_ik L_jk^T, both products of 128 x 128 blocks on the
// FP64 tensor cores (mma.sync m16n8k16, kernel 10's fragments), streamed
// through three shared-memory buffers 32 columns at a time (cp.async) from
// the working buffer, which L2 holds.  Last it composes L^-1 block by block
// (X_ij = -X_ii sum_{m=j}^{i-1} L_im X_mj).  L and L^-1 are written
// column-major per front (what level_table reads), zero above the diagonal
// and non-finite entries zeroed, and the front's first bad pivot (a true
// dimension whose L_kk is not finite or not positive) as its permuted
// column, or -1.  No atomics.
// Bound on the H100: the FP64 tensor-core operations of the products and
// factorizations at the card's rate (or the fronts' bytes); one CTA a front
// holds a level of S fronts to S of the 132 SMs, and the diagonal blocks'
// pivots are a chain of Wd steps (kernel 10: ~74 ns a pivot).  On an H100
// (scripts/port_front_probe.py) a 384-column front takes ~0.53 ms: the
// products ~0.27 (their tensor-core instructions ~0.18: a thread's 32
// sums and the fragments fill its registers, and a third buffer for the
// copies gained nothing), the three diagonal blocks ~0.15, the gathers of
// front and panel ~0.07.  The gathers are latency-bound at one CTA: each
// lane loads its block ids, then all of a block's rows, before it stores.
// gt_sn_pivot_check: one block reduces the first-bad records of every front
// of a factorization (level after level) to state = (ok, badcol): the first
// bad pivot of the first bad level, by a fixed min-tree.
// gt_sn_schur_scatter: one thread per entry of each unique target block;
// sums the level's U = Lp Lp^T blocks of its segment in the plan's order
// and subtracts once.  No atomics.
#include "chol_tiles.cuh"

namespace {

constexpr int kElemThreads = 256;
constexpr int kCheckThreads = 1024;
constexpr int kNB = chol::kNB;
constexpr int kTile = chol::kTile;
constexpr int kNT = chol::kNT;
constexpr int kWarps = chol::kWarps;
constexpr int kLd = chol::kLd<double>;
constexpr int kTileSz = chol::kTileSz<double>;
constexpr int kRowBatch = 8;   // a gather's rows of a block in flight at once

// An operand of a block product: entry (r, c) at p[r * ld + c] for r < rows
// and c < cols, zero outside, and (tri) zero above its diagonal (c > r;
// kUpperZero) or below it (c < r; kLowerZero), whose all-zero tiles the
// product skips.
enum Tri { kDense, kUpperZero, kLowerZero };
struct Opnd {
  const double* p;
  int64_t ld;
  int rows, cols;
  int tri;
};

// Tile row `rt` of an operand, by slab `kt` (both in 32s), is all zero.
__device__ __forceinline__ bool zero_tile(int tri, int rt, int kt) {
  return tri == kUpperZero ? kt > rt : tri == kLowerZero && kt < rt;
}

// Queue the copy of columns k0 .. k0 + 31 of rows 0 .. kRows - 1 of o into
// the kRows / 32 tiles at dst (row pitch kLd), zero outside o: 16 bytes a
// cp.async (widths are even, so a pair is whole or absent), 16 threads a
// row.
template <int kRows>
__device__ __forceinline__ void stage_slab(const Opnd& o, int k0,
                                           double* dst) {
#pragma unroll
  for (int q = 0; q < kRows * kTile / 2 / chol::kThreads; ++q) {
    const int z = threadIdx.x + chol::kThreads * q;
    const int r = z >> 4, c = 2 * (z & 15);
    const int valid = r < o.rows ? max(0, min(2, o.cols - k0 - c)) : 0;
    const double* src = valid ? o.p + r * o.ld + k0 + c : o.p;
    const unsigned d = (unsigned)__cvta_generic_to_shared(
        dst + (r >> 5) * kTileSz + (r & 31) * kLd + c);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
                 "l"(src), "r"(8 * valid)
                 : "memory");
  }
}

__device__ __forceinline__ void commit_slabs() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void await_slabs() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// acc[u] += A B_u^T over one 32-deep slab, for the warp's two strips u:
// A its 32 x 32 tile of the A slab (row-major, pitch kLd), B_u columns
// c_u .. c_u + 15 of tile B[u] of the B slab (n x k, the same pitch), on
// the FP64 tensor cores (mma.sync m16n8k16, kernel 10's fragment layout:
// acc[u][4 (2 mb + nb) + v] is entry (16 mb + g + 8 (v / 2),
// c_u + 8 nb + 2 q + v % 2), g = lane / 4, q = lane % 4).  One k step at a
// time.
__device__ __forceinline__ void mma_slab(double (&acc)[2][16],
                                         const double* A,
                                         const double* const (&B)[2],
                                         const int (&c)[2],
                                         const bool (&live)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll 1
  for (int k0 = 0; k0 < kTile; k0 += 16) {
    double a[2][8];
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int v = 0; v < 8; ++v)
        a[mb][v] = A[(16 * mb + g + 8 * (v & 1)) * kLd + k0 + q + 4 * (v >> 1)];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (!live[u]) continue;
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        const double* Bp = B[u] + (c[u] + 8 * nb + g) * kLd + k0 + q;
        const double b0 = Bp[0], b1 = Bp[4], b2 = Bp[8], b3 = Bp[12];
#pragma unroll
        for (int mb = 0; mb < 2; ++mb) {
          double* d = acc[u] + 4 * (2 * mb + nb);
          asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
              "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
              "{%12, %13, %14, %15}, {%0, %1, %2, %3};"
              : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
              : "d"(a[mb][0]), "d"(a[mb][1]), "d"(a[mb][2]), "d"(a[mb][3]),
                "d"(a[mb][4]), "d"(a[mb][5]), "d"(a[mb][6]), "d"(a[mb][7]),
                "d"(b0), "d"(b1), "d"(b2), "d"(b3));
        }
      }
    }
  }
}

// C = sum over t < n of A_t B_t^T (term(t, A, B) names the operands; each
// 128 x 128, as deep as the fewer of A_t's and B_t's columns), then
// epi(r, c, value) for every entry.  C is formed in two halves, so that a
// thread holds 32 sums, not 64 (which spilled): halves of its rows (A's
// rows; kRowHalves, for a product written over A) or of its columns (B's
// rows; for one written over B), each half reading only what it has not
// yet overwritten; a half past A's or B's rows is skipped.  The 32-deep
// slabs of all the terms stream through three buffers of shared memory:
// the next two slabs' copies are in flight while the tensor cores take
// this one.
// A warp holds one 32 x 32 tile of a row half, or two 32 x 16 strips of a
// column half.  `lower`: only C's tiles on and below its diagonal are
// needed (the others come out zero).  Ends with a CTA barrier, so the
// epilogue's writes are seen by the next product's loads.
template <bool kRowHalves, typename G, typename F>
__device__ void product(int n, G term, double* smem, F epi,
                        bool lower = false) {
  constexpr int kH = kNB / 2;                      // a half's rows or columns
  constexpr int kAR = kRowHalves ? kH : kNB;       // A rows staged
  constexpr int kBR = kRowHalves ? kNB : kH;       // B rows staged
  constexpr int kBuf = (kAR + kBR) / kTile * kTileSz;
  constexpr int kStages = 3;                       // slabs in flight
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int at = kRowHalves ? warp >> 2 : warp >> 1;   // its A tile
  const int bt = kRowHalves ? warp & 3 : 0;            // its first B tile
  const int c[2] = {kRowHalves ? 0 : 16 * (warp & 1),
                    kRowHalves ? 16 : 16 * (warp & 1)};
  for (int h = 0; h < 2; ++h) {
    Opnd A, B;
    term(0, A, B);
    if ((kRowHalves ? A.rows : B.rows) <= h * kH) break;
    auto half = [&](Opnd o) {    // the half's rows of o
      o.p += (int64_t)h * kH * o.ld;
      o.rows -= h * kH;
      return o;
    };
    // the slabs in order: term t, columns k0 .. k0 + 31
    struct Slab {
      int t, k0;
      Opnd A, B;
    };
    auto next = [&](Slab& x) {
      x.k0 += kTile;
      if (x.k0 >= min(x.A.cols, x.B.cols)) {
        x.k0 = 0;
        if (++x.t < n) term(x.t, x.A, x.B);
      }
    };
    // queue a slab's copies into buffer `slot` (or nothing past the last
    // slab), as one commit group either way
    auto stage = [&](const Slab& x, int slot) {
      if (x.t < n) {
        double* buf = smem + kBuf * slot;
        if (kRowHalves) {
          stage_slab<kAR>(half(x.A), x.k0, buf);
          stage_slab<kBR>(x.B, x.k0, buf + kAR / kTile * kTileSz);
        } else {
          stage_slab<kAR>(x.A, x.k0, buf);
          stage_slab<kBR>(half(x.B), x.k0, buf + kAR / kTile * kTileSz);
        }
      }
      commit_slabs();
    };
    double acc[2][16];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[u][i] = 0.0;
    Slab cur{0, 0, A, B}, ahead = cur;
    stage(ahead, 0);
    next(ahead);
    stage(ahead, 1);
    next(ahead);
    // slab i is in buffer i % kStages; the copies of slab i + 2 go out
    // before slab i is taken
    for (int i = 0; cur.t < n; ++i) {
      stage(ahead, (i + 2) % kStages);
      next(ahead);
      await_slabs<kStages - 1>();
      __syncthreads();
      const double* buf = smem + kBuf * (i % kStages);
      const double* Bs = buf + kAR / kTile * kTileSz;
      const double* const Bt[2] = {Bs + bt * kTileSz,
                                   Bs + (kRowHalves ? bt : 1) * kTileSz};
      // the tiles of A and B this warp takes, by their place in the block
      const int kt = cur.k0 / kTile;
      const int ra = kRowHalves ? 2 * h + at : at;
      const int rb[2] = {kRowHalves ? bt : 2 * h, kRowHalves ? bt : 2 * h + 1};
      const bool za = zero_tile(cur.A.tri, ra, kt);
      const bool live[2] = {
          !za && !zero_tile(cur.B.tri, rb[0], kt) && !(lower && rb[0] > ra),
          !za && !zero_tile(cur.B.tri, rb[1], kt) && !(lower && rb[1] > ra)};
      mma_slab(acc, buf + at * kTileSz, Bt, c, live);
      __syncthreads();
      next(cur);
    }
    // the strips' places in C
    const int r0 = kRowHalves ? h * kH + kTile * at : kTile * at;
    const int col[2] = {kRowHalves ? kTile * bt : h * kH,
                        kRowHalves ? kTile * bt : h * kH + kTile};
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int mb = i >> 3, nb = (i >> 2) & 1, v = i & 3;
        epi(r0 + 16 * mb + g + 8 * (v >> 1),
            col[u] + c[u] + 8 * nb + 2 * q + (v & 1), acc[u][i]);
      }
  }
  __syncthreads();
}

__device__ __forceinline__ double finite_or_zero(double v) {
  return isfinite(v) ? v : 0.0;
}

__global__ void __launch_bounds__(chol::kThreads, 1) sn_front_factor_kernel(
    int W, int R, int d, int n, const double* __restrict__ work,
    const double* __restrict__ blocks, const int* __restrict__ diag_ids,
    const unsigned char* __restrict__ diag_flip,
    const double* __restrict__ diag_pad,
    const unsigned char* __restrict__ valid_diag,
    const int* __restrict__ col_vars, const int* __restrict__ dbc,
    const int* __restrict__ panel_ids, double lam, int diagonal_damping,
    double min_diag, double max_diag, double* __restrict__ Lout,
    double* __restrict__ Xout, double* __restrict__ At,
    double* __restrict__ Dinv, int* __restrict__ rec) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double rinv[kNT * kTile];
  __shared__ __align__(16) double lt[kNT * kTile * chol::kLtPitch];
  __shared__ int ready[kNT * 8];
  __shared__ int info;          // factor_tile's record (unused here)
  __shared__ int first[kNT + 1];   // a block's first bad pivot per tile row;
                                   // [kNT]: the front's, or -1
  const int s = blockIdx.x;
  const int Wd = W * d, Rd = R * d, dd = d * d;
  const int nb = (Wd + kNB - 1) / kNB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t fo = (int64_t)s * Wd * Wd;
  double* Wk = Xout + fo;   // the working front (row-major), then L^-1
  double* Lo = Lout + fo;   // L, column-major
  double* Ds = Dinv + (int64_t)s * nb * kNB * kNB;
  auto width = [&](int k) { return min(kNB, Wd - k * kNB); };
  auto at = [&](int i, int j) {   // block (i, j) of the row-major view
    return Wk + (int64_t)i * kNB * Wd + j * kNB;
  };
  double* dsm = reinterpret_cast<double*>(smem);

  // the front's lower blocks and whole diagonal blocks (rows whose
  // diagonal block reaches past a column are gathered up to it too): a
  // warp per block row a and a lane per column, two 32-column chunks at a
  // time, each lane's store ids loaded first and then all of its d rows'
  // entries, so that a chunk costs two trips to memory, and the stores are
  // whole rows; the damping as the plain version adds it
  for (int a = warp; a < W; a += kWarps) {
    const int cend = min(Wd, ((a + 1) * d - 1) / kNB * kNB + kNB);
    const int64_t row = ((int64_t)s * W + a) * W;
    for (int c0 = lane; c0 < cend; c0 += 2 * 32) {
      int blk[2], off[2], step[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = c0 + 32 * u, b = c / d, j = c - b * d;
        const bool in = c < cend;
        blk[u] = in ? diag_ids[row + b] : 0;
        const bool fl = in && diag_flip[row + b];
        off[u] = fl ? j * d : j;     // entry (i, j) at off + i * step
        step[u] = fl ? 1 : d;
      }
      for (int i0 = 0; i0 < d; i0 += kRowBatch) {
        double v[2][kRowBatch];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int i = 0; i < kRowBatch; ++i)
            v[u][i] = c0 + 32 * u < cend && i0 + i < d
                          ? work[(int64_t)blk[u] * dd + off[u] +
                                 (i0 + i) * step[u]]
                          : 0.0;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int c = c0 + 32 * u;
          if (c >= cend) continue;
#pragma unroll
          for (int i = 0; i < kRowBatch; ++i) {
            const int r = a * d + i0 + i;
            if (i0 + i >= d) continue;
            double x = v[u][i];
            if (r == c) {
              const int64_t e = (int64_t)s * Wd + r;
              double damp = 0.0;
              if (valid_diag[e]) {
                if (diagonal_damping) {
                  int cv = col_vars[(int64_t)s * W + a];
                  cv = cv < n ? cv : n - 1;
                  damp = lam * fmin(fmax(blocks[(int64_t)dbc[cv] * dd +
                                                (i0 + i) * (d + 1)],
                                         min_diag), max_diag);
                } else {
                  damp = lam;
                }
              }
              x = x + (diag_pad[e] + damp);
            }
            Wk[(int64_t)r * Wd + c] = x;
          }
        }
      }
    }
  }
  // the panel, transposed (At[c][r] = A(r, c)): a warp per block column b
  // and a lane per row, as the front
  if (R > 0) {
    double* Ats = At + (int64_t)s * Wd * Rd;
    for (int b = warp; b < W; b += kWarps) {
      for (int r0 = lane; r0 < Rd; r0 += 2 * 32) {
        int blk[2], off[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int r = r0 + 32 * u, a = r / d, i = r - a * d;
          blk[u] = r < Rd ? panel_ids[((int64_t)s * R + a) * W + b] : 0;
          off[u] = i * d;
        }
        for (int j0 = 0; j0 < d; j0 += kRowBatch) {
          double v[2][kRowBatch];
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int j = 0; j < kRowBatch; ++j)
              v[u][j] = r0 + 32 * u < Rd && j0 + j < d
                            ? work[(int64_t)blk[u] * dd + off[u] + j0 + j]
                            : 0.0;
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int r = r0 + 32 * u;
            if (r >= Rd) continue;
#pragma unroll
            for (int j = 0; j < kRowBatch; ++j)
              if (j0 + j < d)
                Ats[(int64_t)(b * d + j0 + j) * Rd + r] =
                    finite_or_zero(v[u][j]);
          }
        }
      }
    }
  }
  // L's blocks above the diagonal blocks (column-major: column c, rows
  // above its block)
  for (int c = kNB + warp; c < Wd; c += kWarps)
    for (int r = lane; r < c / kNB * kNB; r += 32)
      Lo[(int64_t)c * Wd + r] = 0.0;
  if (threadIdx.x == 0) {
    info = 0;
    first[kNT] = -1;
  }
  __syncthreads();

  for (int k = 0; k < nb; ++k) {
    const int o = k * kNB, w = width(k);
    double* Dk = Ds + (int64_t)k * kNB * kNB;
    chol::Block<double> b;
    b.A = dsm;
    b.X = b.A + chol::kTiles * kTileSz;
    b.rinv = rinv;
    b.lt = lt;
    b.ready = ready;
    b.S = at(k, k);
    b.D = Dk;
    b.info = &info;
    b.ld = Wd;
    b.o = o;
    b.w = w;
    chol::factor_block(b);
    __syncthreads();
    // the block's first bad pivot, from L_D's diagonal in shared memory
    if (warp < kNT) {
      const int r = kTile * warp + lane;
      const double p = b.a(warp, warp)[lane * kLd + lane];
      const bool bad = r < w && valid_diag[(int64_t)s * Wd + o + r] &&
                       !(p > 0.0 && isfinite(p));
      const unsigned m = __ballot_sync(0xffffffffu, bad);
      if (lane == 0) first[warp] = m ? kTile * warp + __ffs(m) - 1 : kNB;
    }
    // L_D into L (column-major, zero above the diagonal) from its tiles, a
    // lane per row
    for (int q = warp; q < kNB * kNT; q += kWarps) {
      const int C = q / kNT, r = kTile * (q % kNT) + lane;
      if (C < w && r < w) {
        const double v =
            r >= C ? b.a(r / kTile, C / kTile)[lane * kLd + C % kTile] : 0.0;
        Lo[(int64_t)(o + C) * Wd + o + r] = finite_or_zero(v);
      }
    }
    __syncthreads();
    // L_D^-1 into L^-1's diagonal block, column-major, over the block's
    // place in the working buffer (no longer read): transposed through
    // shared memory (pitch kNB + 1), every global access a row
    for (int q = warp; q < kNB * kNT; q += kWarps) {
      const int r = q / kNT, C = kTile * (q % kNT) + lane;
      dsm[C * (kNB + 1) + r] = Dk[r * kNB + C];
    }
    __syncthreads();
    for (int q = warp; q < kNB * kNT; q += kWarps) {
      const int C = q / kNT, r = kTile * (q % kNT) + lane;
      if (C < w && r < w)
        Wk[(int64_t)(o + C) * Wd + o + r] =
            finite_or_zero(dsm[C * (kNB + 1) + r]);
    }
    __syncthreads();
    if (threadIdx.x == 0 && first[kNT] < 0) {
      int f = kNB;
      for (int t = 0; t < kNT; ++t) f = min(f, first[t]);
      if (f < kNB) first[kNT] = o + f;
    }
    // the blocks below: L_ik = A_ik L_D^-T, into the working buffer (in
    // place) and into L, column-major
    for (int i = k + 1; i < nb; ++i) {
      const int wi = width(i);
      double* Aik = at(i, k);
      product<true>(
          1,
          [&](int, Opnd& A, Opnd& B) {
            A = Opnd{Aik, Wd, wi, w, kDense};
            B = Opnd{Dk, kNB, w, w, kUpperZero};     // L_D^-1
          },
          dsm,
          [&](int r, int c, double v) {
            if (r < wi && c < w) {
              Aik[(int64_t)r * Wd + c] = v;
              Lo[(int64_t)(o + c) * Wd + i * kNB + r] = finite_or_zero(v);
            }
          });
    }
    // the trailing blocks: A_ij -= L_ik L_jk^T (j <= i; of a diagonal
    // block, the tiles that its factorization reads)
    for (int j = k + 1; j < nb; ++j) {
      const int wj = width(j);
      for (int i = j; i < nb; ++i) {
        const int wi = width(i);
        double* Aij = at(i, j);
        product<false>(
            1,
            [&](int, Opnd& A, Opnd& B) {
              A = Opnd{at(i, k), Wd, wi, w, kDense};
              B = Opnd{at(j, k), Wd, wj, w, kDense};
            },
            dsm,
            [&](int r, int c, double v) {
              if (r < wi && c < wj) Aij[(int64_t)r * Wd + c] -= v;
            },
            i == j);
      }
    }
  }

  // L^-1 below its diagonal blocks, column by column of blocks: X_ij (i > j)
  // lies column-major at block (j, i) of the row-major view, which the
  // factorization never used; first Y = sum_{m=j}^{i-1} L_im X_mj there
  // (L_im row-major at block (i, m), X_mj column-major at (j, m)), then
  // X_ij = -X_ii Y in place (X_ii row-major in Dinv)
  for (int j = 0; j + 1 < nb; ++j) {
    const int wj = width(j);
    for (int i = j + 1; i < nb; ++i) {
      const int wi = width(i);
      double* Xij = at(j, i);
      product<false>(
          i - j,
          [&](int t, Opnd& A, Opnd& B) {
            const int m = j + t, wm = width(m);
            A = Opnd{at(i, m), Wd, wi, wm, kDense};
            // X_jj^T (m = j) is zero below its diagonal
            B = Opnd{at(j, m), Wd, wj, wm, m == j ? kLowerZero : kDense};
          },
          dsm,
          [&](int r, int c, double v) {
            if (r < wi && c < wj) Xij[(int64_t)c * Wd + r] = v;
          });
      product<false>(
          1,
          [&](int, Opnd& A, Opnd& B) {
            A = Opnd{Ds + (int64_t)i * kNB * kNB, kNB, wi, wi, kUpperZero};
            B = Opnd{Xij, Wd, wj, wi, kDense};
          },
          dsm,
          [&](int r, int c, double v) {
            if (r < wi && c < wj) Xij[(int64_t)c * Wd + r] = finite_or_zero(-v);
          });
    }
  }
  // L^-1 above its diagonal blocks (the row-major view's lower blocks,
  // which held L): zero
  for (int r = kNB + warp; r < Wd; r += kWarps)
    for (int c = lane; c < r / kNB * kNB; c += 32)
      Wk[(int64_t)r * Wd + c] = 0.0;
  if (threadIdx.x == 0) {
    const int f = first[kNT];
    rec[s] = f < 0 ? -1 : col_vars[(int64_t)s * W + f / d];
  }
}

__global__ void __launch_bounds__(kCheckThreads) sn_pivot_kernel(
    int N, const int* __restrict__ rec, int* __restrict__ state) {
  __shared__ int red[kCheckThreads];
  int first = N;
  for (int f = threadIdx.x; f < N; f += kCheckThreads)
    if (rec[f] >= 0) {
      first = f;
      break;
    }
  red[threadIdx.x] = first;
  __syncthreads();
  for (int h = kCheckThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] = min(red[threadIdx.x],
                                                red[threadIdx.x + h]);
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const int f = red[0];
    state[0] = f < N ? 0 : 1;
    state[1] = f < N ? rec[f] : -1;
  }
}

__global__ void __launch_bounds__(kElemThreads) sn_schur_kernel(
    int64_t total, int R, int d, int u_cm, const double* __restrict__ U,
    const int* __restrict__ src, const int* __restrict__ ptr,
    const int* __restrict__ tgt, double* __restrict__ work) {
  const int64_t idx = (int64_t)blockIdx.x * kElemThreads + threadIdx.x;
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

}  // namespace

// One level: S fronts of W blocks (d wide), R panel rows (0: no panel), n
// variables (col_vars' sentinel).  L, X: S x Wd x Wd, each front
// column-major (L and L^-1); At: S x Wd x Rd (the panel transposed; unused
// when R = 0); Dinv: S x ceil(Wd / 128) x 128 x 128 scratch; rec: S ints.
GT_EXPORT int gt_sn_front_factor(
    int S, int W, int R, int d, int n, const double* work,
    const double* blocks, const int* diag_ids, const unsigned char* diag_flip,
    const double* diag_pad, const unsigned char* valid_diag,
    const int* col_vars, const int* dbc, const int* panel_ids, double lam,
    int diagonal_damping, double min_diag, double max_diag, double* L,
    double* X, double* At, double* Dinv, int* rec, void* stream) {
  if (S == 0) return 0;
  const size_t shm = 2 * chol::kTiles * kTileSz * sizeof(double);
  cudaError_t e = cudaFuncSetAttribute(
      sn_front_factor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shm);
  if (e != cudaSuccess) return (int)e;
  sn_front_factor_kernel<<<S, chol::kThreads, shm, (cudaStream_t)stream>>>(
      W, R, d, n, work, blocks, diag_ids, diag_flip, diag_pad, valid_diag,
      col_vars, dbc, panel_ids, lam, diagonal_damping, min_diag, max_diag, L,
      X, At, Dinv, rec);
  return (int)cudaGetLastError();
}

// rec: N first-bad records (every front of a factorization, level after
// level; -1: none); state: (ok, badcol), written whole.
GT_EXPORT int gt_sn_pivot_check(int N, const int* rec, int* state,
                                void* stream) {
  sn_pivot_kernel<<<1, kCheckThreads, 0, (cudaStream_t)stream>>>(N, rec,
                                                                 state);
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
    sn_schur_kernel<<<(unsigned)((total + kElemThreads - 1) / kElemThreads),
                      kElemThreads, 0, (cudaStream_t)stream>>>(
        total, R, d, u_cm, U, src, ptr, tgt, work);
  return (int)cudaGetLastError();
}
