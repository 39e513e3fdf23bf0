// Kernel 7: the level step of the supernodal Cholesky (float64).
//
// Replaces: gtsam_tpu/linear/supernodal.py::factorize (:372-442): the damping
// (:383-392), the front and panel gathers (:398-403, :429-430), the batched
// Cholesky (:404), the pivot test and first bad column (:404-417), the
// zeroing of non-finite factor entries (:419, :434), the panel Lp = A L^-T
// (:431-434), U = Lp Lp^T (:436) and the sorted segment-sum Schur scatter
// (:436-441); and kernel 8's inverses of the fronts' 32 x 32 diagonal tiles
// (:583, which the JAX package leaves to its triangular solves).
//
// gt_sn_front_factor: one launch a level, ctas CTAs (8 warps each) a front
// (the plan's supernodal_kernels.front_ctas: the level's share of the SMs;
// 1 where the level fills half the card).  The front's CTAs gather it from
// the working store into the level's L^-1 output, used as its working
// buffer (row-major, rows ldx apart: the lower 128-column blocks and the
// whole diagonal blocks, with the flips, the padding identity and the
// damping, lam or lam * clip(H_cc[k, k], min, max) of the undamped store,
// on true dimensions), and its panel, transposed, into At (rows lda
// apart), a warp a block row or 256 panel rows of a block column.  Then
// they factor the front right-looking in 128-column blocks: each diagonal
// block D is factored and inverted in shared memory by kernel 10's code
// (chol_tiles.cuh::factor_block, identity past the front's width), the
// blocks below it become L_ik = A_ik L_D^-T and the trailing blocks A_ij
// -= L_ik L_jk^T, both products of 128 x 128 blocks on the FP64 tensor
// cores (mma.sync m16n8k16, kernel 10's fragments), streamed through three
// shared-memory buffers 32 columns at a time (cp.async) from the working
// buffer, which L2 holds.  Last they compose L^-1 block by block (Y_ij =
// sum_{m=j}^{i-1} L_im X_mj, then X_ij = -X_ii Y_ij).  Row half h of
// block (i, j) of L is CTA (2 tid(i, j) + h) % ctas's: its updates and its
// solve run there in step order (a product's row half is the same sums
// whether or not the other half is formed beside it); a diagonal block's
// factorization and block (i, j) of L^-1 are their first half's owner's.
// So every entry's sums run over the same slabs in the same order
// whatever ctas, and the outputs are the one-CTA route's bit for bit.  A
// finished half or block is passed on by a flag (release at GPU scope by
// its owner, acquire by a reader) holding the launch's number; every CTA
// walks the steps in one order (each step's diagonal block, its solves,
// its trailing blocks column by column, the next diagonal block first:
// look-ahead) and waits only on jobs earlier in it, so the front's CTAs
// cannot stall each other (a cooperative launch keeps them all
// resident); a sum of L^-1 waits for its D_i only before its scale.  L
// and L^-1 are written column-major per front (what level_table reads),
// zero above the diagonal and non-finite entries zeroed, and the front's
// first bad pivot (a true dimension whose L_kk is not finite or not
// positive) as its permuted column, or -1.  Each diagonal block's L_D^-1
// holds the inverses of L's 32 x 32 diagonal tiles on its own diagonal
// (L_D is block lower triangular in tiles), the identity past the front's
// width: they are copied into kernel 8's packed tile buffer.  No atomics.
// Bound on the H100: the FP64 tensor-core operations of the products and
// factorizations at the card's rate (or the fronts' bytes); a level of S
// fronts holds S * ctas of the 132 SMs (the one-SM bound over ctas), and
// the diagonal blocks are a chain of nb = ceil(Wd / 128) factorizations at
// kernel 10's ~35-50 us a block, each after its step's solve and update of
// the next block (each a half product on two CTAs).  On an H100
// (scripts/port_front_probe.py, one CTA) a 384-column front takes ~0.53
// ms: the products ~0.27, the three diagonal blocks ~0.15, the gathers
// ~0.07; split (scripts/port_split_probe.py) the sfm root (576 columns)
// took ~0.53 ms at whole-block jobs (15 CTAs) against one CTA's 1.59.
// gt_sn_pivot_check: one block reduces the first-bad records of every front
// of a factorization (level after level) to state = (ok, badcol): the first
// bad pivot of the first bad level, by a fixed min-tree.
// gt_sn_schur_update: the level's tail in one cooperative launch of CTAs
// that share out the level's output tiles, whatever its count of fronts,
// with a grid barrier between the phases:
//   1. the panel: Lp^T = L^-1 A^T of every front, in 64 x 64 tiles, from
//      the front kernel's L^-1 and At, non-finite entries zeroed; written
//      as (S, Wd, Rd) row-major, which is Lp column-major per front (what
//      level_table keeps, and kernel 8 reads), and, for an odd Rd, again
//      at the even pitch Rd + 1 (zero past Rd) as U's operand;
//   2. U = Lp Lp^T: only the tiles, and within them the 16 x 8 product
//      blocks, that hold an entry of a d x d block on or below the block
//      diagonal (the blocks the plan scatters), into a scratch of the
//      solver's (S, Rd, Rd) that L2 holds; on the direct route (a level of
//      one front whose every target takes one block) the tiles subtract
//      their entries from their targets themselves, old - (0 + u): the
//      scatter's bits for a sum of one block, with no U, no scatter and
//      one grid barrier less;
//   3. the scatter: a thread per row of each unique target block sums its
//      segment's U blocks in the plan's order and subtracts once.
// A product phase of few tiles (a level of one or two fronts) splits each
// tile's depth into k-chunks, a CTA each, and sums their partial tiles in
// chunk order after a barrier.  Either pitch and either route give the
// same bits where the k-chunks are the same.  (A 96-wide tile, a multiple
// of d = 3 and 6 whose d x d blocks never straddle two tiles, measured
// slower than 64 on every level of the sphere and the stand-in:
// scripts/port_update_probe.py's "fitted" variant.)
// Both products are C = P^T Q of operands stored k-major (P[k][m]: L^-1 is
// column-major, At and Lp^T row-major), staged by cp.async 32 rows deep
// through a ring of three shared-memory buffers (a 64-column slab each,
// pitch 68: a half-warp's fragment loads hit 16 distinct banks) and
// multiplied on the FP64 tensor cores (mma.sync m16n8k16), a warp a 32 x 32
// quadrant; the panel skips the 16 x 16 blocks of L^-1 above its diagonal.
// Values written in this launch by other CTAs are read past L1 (cp.async.cg,
// ld.cg).  The front kernel leaves L^-1 and At at even row pitches, so
// every staged pair is one 16-byte copy; on odd pitches (d = 3; contiguous
// operands from elsewhere) pairs move 8 bytes at a time where they are not
// 16-byte aligned (copy_pair, store_pair, ldcg_pair), the pair past an odd
// width's last entry zero or not stored.  No atomics: every sum runs in a
// fixed order.
// Bound on the H100: the products' FP64 tensor-core operations (L^-1's
// triangle and U's block triangle counted once), ~2.6 GFLOP a sphere
// factorization (0.040 ms) against ~0.12 GB moved (0.035 ms), 10.4 GFLOP a
// w10000 stand-in factorization (0.155 ms).  On an H100
// (scripts/port_update_probe.py) the stand-in's 18 launches take ~2.0 ms
// on odd pitches: ~0.73 the panel, ~1.0 U, ~0.25 the scatter, ~0.07 the
// launches and barriers; the copies, not the products, take most (the
// time with no copies ~0.9, with no products ~1.6): each tile's chain of
// slabs waits on L2.
#include <cooperative_groups.h>

#include <algorithm>

#include "chol_tiles.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCheckThreads = 1024;
constexpr int kNB = chol::kNB;
constexpr int kTile = chol::kTile;
constexpr int kNT = chol::kNT;
constexpr int kWarps = chol::kWarps;
constexpr int kLd = chol::kLd<double>;
constexpr int kTileSz = chol::kTileSz<double>;
constexpr int kRowBatch = 8;   // a gather's rows of a block in flight at once
constexpr int kPanelRows = 256;   // a warp's panel rows of a block column

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

// Queue the copy of the pair src[0], src[1] into dst (16-byte aligned),
// the first `valid` (0, 1 or 2) of them read and the rest zeroed: one
// 16-byte cp.async where src is 16-byte aligned; else (an odd width puts
// every other row of an operand, and every other front, on an 8-byte
// boundary) two loads past L1 and stores into dst, which the barrier
// before the slab's use orders like the copies.
__device__ __forceinline__ void copy_pair(double* dst, const double* src,
                                          int valid) {
  if (valid == 2 && !(reinterpret_cast<uintptr_t>(src) & 15)) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
                 "l"(src)
                 : "memory");
    return;
  }
  dst[0] = valid > 0 ? __ldcg(src) : 0.0;
  dst[1] = valid > 1 ? __ldcg(src + 1) : 0.0;
}

// Queue the copy of columns k0 .. k0 + 31 of rows 0 .. kRows - 1 of o into
// the kRows / 32 tiles at dst (row pitch kLd), zero outside o: a pair of
// columns a thread (copy_pair), 16 threads a row.
template <int kRows>
__device__ __forceinline__ void stage_slab(const Opnd& o, int k0,
                                           double* dst) {
#pragma unroll
  for (int q = 0; q < kRows * kTile / 2 / chol::kThreads; ++q) {
    const int z = threadIdx.x + chol::kThreads * q;
    const int r = z >> 4, c = 2 * (z & 15);
    const int valid = r < o.rows ? max(0, min(2, o.cols - k0 - c)) : 0;
    copy_pair(dst + (r >> 5) * kTileSz + (r & 31) * kLd + c,
              valid ? o.p + r * o.ld + k0 + c : o.p, valid);
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
// needed (the others come out zero).  Only the halves h0 .. h1 - 1 are
// formed: a half's entries are the same sums whatever else is formed.
// Ends with a CTA barrier, so the epilogue's writes are seen by the next
// product's loads.
template <bool kRowHalves, typename G, typename F>
__device__ void product(int n, G term, double* smem, F epi,
                        bool lower = false, int h0 = 0, int h1 = 2) {
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
  for (int h = h0; h < h1; ++h) {
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

// The split route's flags (ctas > 1): set (release, GPU scope) by thread 0
// once the CTA's writes before it are done, awaited (acquire) by thread 0,
// then a CTA barrier; a flag holds the number of the launch that set it.
// A wait that outlasts kStall cycles (seconds: a front takes milliseconds)
// can only be a fault: it traps, so the launch fails and the caller's next
// synchronisation raises, instead of hanging the card.  GT_SN_RACE_DELAYS
// (a test build of this file only, _build.TEST_BUILDS) sleeps before every
// publish and await in every CTA but a front's first, so that a missing
// wait shows as other bits.
constexpr long long kStall = 20000000000LL;

__device__ __forceinline__ void race_delay(int me) {
#ifdef GT_SN_RACE_DELAYS
  if (me != 0 && threadIdx.x == 0) {
    const unsigned h = (unsigned)clock64() * 2654435761u ^ blockIdx.x;
    __nanosleep(2000u + (h >> 20) % 16u * 1000u);
  }
#else
  (void)me;
#endif
}

__device__ __forceinline__ void publish(int* flag, int seq, int me) {
  race_delay(me);
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(flag), "r"(seq)
                 : "memory");
  }
}

// Thread 0: until flag holds seq (no barrier).
__device__ __forceinline__ void spin(const int* flag, int seq) {
  const long long t0 = clock64();
  int v;
  while (true) {
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
                 : "=r"(v)
                 : "l"(flag)
                 : "memory");
    if (v == seq) break;
    if (clock64() - t0 > kStall) __trap();
    __nanosleep(32);
  }
}

// A front's flags (ints): fB, a diagonal block factored and inverted; fS,
// a row half of a block below it solved (at 2 tid(i, j) + h); fU, the
// second row half of a diagonal block updated by its last step; fX, a
// block of L^-1 composed (at tid(i, j)); each CTA's gather and end; then
// the diagonal blocks' first bad pivots, stored as -1 - f (negative: never
// a launch's number).
__host__ __device__ __forceinline__ int front_flags(int nb, int ctas) {
  return 3 * nb + 3 * (nb * (nb + 1) / 2) + 2 * ctas;
}

__global__ void __launch_bounds__(chol::kThreads, 1) sn_front_factor_kernel(
    int W, int R, int d, int n, int ctas, int seq, int ldx, int lda,
    const double* __restrict__ work, const double* __restrict__ blocks,
    const int* __restrict__ diag_ids,
    const unsigned char* __restrict__ diag_flip,
    const double* __restrict__ diag_pad,
    const unsigned char* __restrict__ valid_diag,
    const int* __restrict__ col_vars, const int* __restrict__ dbc,
    const int* __restrict__ panel_ids, double lam, int diagonal_damping,
    double min_diag, double max_diag, double* __restrict__ Lout,
    double* __restrict__ Xout, double* __restrict__ At,
    double* __restrict__ Dinv, double* __restrict__ tiles,
    int* __restrict__ rec, int* __restrict__ flags) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double rinv[kNT * kTile];
  __shared__ __align__(16) double lt[kNT * kTile * chol::kLtPitch];
  __shared__ int ready[kNT * 8];
  __shared__ int info;          // factor_tile's record (unused here)
  __shared__ int first[kNT];    // a block's first bad pivot per tile row
  const int s = blockIdx.x / ctas, me = blockIdx.x - s * ctas;
  const int Wd = W * d, Rd = R * d, dd = d * d;
  const int nb = (Wd + kNB - 1) / kNB, nlow = nb * (nb + 1) / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the front's warps over its CTAs, for the gathers and the zero fills
  const int gw = me * kWarps + warp, nw = ctas * kWarps;
  // the working front (row-major, rows ldx apart), then L^-1
  // (column-major); L, column-major
  double* Wk = Xout + (int64_t)s * ldx * ldx;
  double* Lo = Lout + (int64_t)s * Wd * Wd;
  double* Ds = Dinv + (int64_t)s * nb * kNB * kNB;
  double* Ts = tiles + (int64_t)s * ((Wd + kTile - 1) / kTile) * kTile * kTile;
  int* fB = flags + (int64_t)s * front_flags(nb, ctas);
  int* fS = fB + nb;
  int* fU = fS + 2 * nlow;
  int* fX = fU + nb;
  int* fG = fX + nlow;
  int* fE = fG + ctas;
  int* bad = fE + ctas;
  const bool split = ctas > 1;
  auto width = [&](int k) { return min(kNB, Wd - k * kNB); };
  // a block's row halves (a second where it is more than 64 rows)
  auto halves = [&](int i) { return width(i) > kNB / 2 ? 2 : 1; };
  auto at = [&](int i, int j) {   // block (i, j) of the row-major view
    return Wk + (int64_t)i * kNB * ldx + j * kNB;
  };
  auto tid = [](int i, int j) { return chol::tid_of(i, j); };
  // row half h of block (i, j) of L is this CTA's: all its updates and its
  // solve run here, in step order; a diagonal block's factorization and a
  // block of L^-1 are their first half's owner's
  auto own = [&](int i, int j, int h) {
    return (2 * tid(i, j) + h) % ctas == me;
  };
  auto post = [&](int* f) {
    if (split) publish(f, seq, me);
  };
  // await the flags f(0) .. f(m - 1)
  auto wait = [&](int m, auto f) {
    if (!split) return;
    race_delay(me);
    if (threadIdx.x == 0)
      for (int q = 0; q < m; ++q) spin(f(q), seq);
    __syncthreads();
  };
  auto all = [&](int* f) {   // every CTA of the front at f (warp 0)
    if (!split) return;
    publish(f + me, seq, me);
    race_delay(me);
    if (warp == 0)
      for (int c = lane; c < ctas; c += 32) spin(f + c, seq);
    __syncthreads();
  };
  double* dsm = reinterpret_cast<double*>(smem);

  // the front's lower blocks and whole diagonal blocks (rows whose
  // diagonal block reaches past a column are gathered up to it too): a
  // warp per block row a and a lane per column, two 32-column chunks at a
  // time, each lane's store ids loaded first and then all of its d rows'
  // entries, so that a chunk costs two trips to memory, and the stores are
  // whole rows; the damping as the plain version adds it.  The block rows
  // are dealt out over the warps of the front's CTAs.
  for (int a = gw; a < W; a += nw) {
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
            Wk[(int64_t)r * ldx + c] = x;
          }
        }
      }
    }
  }
  // the panel, transposed (At[c][r] = A(r, c), rows lda apart, the
  // columns past Rd zero): a warp per block column b and kPanelRows rows
  // (a job), a lane per row, as the front
  if (R > 0) {
    double* Ats = At + (int64_t)s * Wd * lda;
    for (int r = gw * 32 + lane; r < Wd; r += nw * 32)
      for (int c = Rd; c < lda; ++c) Ats[(int64_t)r * lda + c] = 0.0;
    const int chunks = (Rd + kPanelRows - 1) / kPanelRows;
    for (int q = gw; q < W * chunks; q += nw) {
      const int b = q % W, rb = q / W * kPanelRows;
      for (int r0 = rb + lane; r0 < min(Rd, rb + kPanelRows); r0 += 2 * 32) {
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
                Ats[(int64_t)(b * d + j0 + j) * lda + r] =
                    finite_or_zero(v[u][j]);
          }
        }
      }
    }
  }
  // L's blocks above the diagonal blocks (column-major: column c, rows
  // above its block)
  for (int c = kNB + gw; c < Wd; c += nw)
    for (int r = lane; r < c / kNB * kNB; r += 32)
      Lo[(int64_t)c * Wd + r] = 0.0;
  if (threadIdx.x == 0) info = 0;
  __syncthreads();
  all(fG);

  // Step k, diagonal block D = (k, k): factored and inverted in shared
  // memory (kernel 10's code), its first bad pivot, L_D^-1's diagonal
  // tiles for kernel 8, L_D into L and L_D^-1 over D's place
  auto factor = [&](int k) {
    const int o = k * kNB, w = width(k);
    double* Dk = Ds + (int64_t)k * kNB * kNB;
    if (k > 0 && halves(k) == 2) wait(1, [&](int) { return fU + k; });
    chol::Block<double> b;
    b.A = dsm;
    b.X = b.A + chol::kTiles * kTileSz;
    b.rinv = rinv;
    b.lt = lt;
    b.ready = ready;
    b.S = at(k, k);
    b.D = Dk;
    b.info = &info;
    b.ld = ldx;
    b.o = o;
    b.w = w;
    chol::factor_block(b);
    __syncthreads();
    // the block's first bad pivot, from L_D's diagonal in shared memory
    if (warp < kNT) {
      const int r = kTile * warp + lane;
      const double p = b.a(warp, warp)[lane * kLd + lane];
      const bool bd = r < w && valid_diag[(int64_t)s * Wd + o + r] &&
                      !(p > 0.0 && isfinite(p));
      const unsigned m = __ballot_sync(0xffffffffu, bd);
      if (lane == 0) first[warp] = m ? kTile * warp + __ffs(m) - 1 : kNB;
    }
    // L_D^-1's 32 x 32 diagonal tiles, in shared memory, into kernel 8's
    // buffer (tile 4 k + t of the front, row-major), a warp per row
    for (int q = warp; q < (w + kTile - 1) / kTile * kTile; q += kWarps) {
      const int t = q / kTile, r = q % kTile;
      Ts[((int64_t)(k * kNT + t) * kTile + r) * kTile + lane] =
          b.x(t, t)[r * kLd + lane];
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
        Wk[(int64_t)(o + C) * ldx + o + r] =
            finite_or_zero(dsm[C * (kNB + 1) + r]);
    }
    if (threadIdx.x == 0) {
      int f = kNB;
      for (int t = 0; t < kNT; ++t) f = min(f, first[t]);
      bad[k] = -1 - f;
    }
    __syncthreads();
    post(fB + k);
  };
  // row half h of a block below D: L_ik = A_ik L_D^-T, into the working
  // buffer (in place) and into L, column-major
  auto solve = [&](int i, int k, int h) {
    const int o = k * kNB, w = width(k), wi = width(i);
    const double* Dk = Ds + (int64_t)k * kNB * kNB;
    double* Aik = at(i, k);
    wait(1, [&](int) { return fB + k; });
    product<true>(
        1,
        [&](int, Opnd& A, Opnd& B) {
          A = Opnd{Aik, ldx, wi, w, kDense};
          B = Opnd{Dk, kNB, w, w, kUpperZero};     // L_D^-1
        },
        dsm,
        [&](int r, int c, double v) {
          if (r < wi && c < w) {
            Aik[(int64_t)r * ldx + c] = v;
            Lo[(int64_t)(o + c) * Wd + i * kNB + r] = finite_or_zero(v);
          }
        },
        false, h, h + 1);
    post(fS + 2 * tid(i, k) + h);
  };
  // row half h of a trailing block: A_ij -= L_ik L_jk^T (j <= i; of a
  // diagonal block, the tiles that its factorization reads), from L_ik's
  // half h and the whole L_jk
  auto update = [&](int i, int j, int k, int h) {
    const int w = width(k), wi = width(i), wj = width(j);
    double* Aij = at(i, j);
    wait(1 + halves(j), [&](int q) {
      return fS + (q ? 2 * tid(j, k) + q - 1 : 2 * tid(i, k) + h);
    });
    product<true>(
        1,
        [&](int, Opnd& A, Opnd& B) {
          A = Opnd{at(i, k), ldx, wi, w, kDense};
          B = Opnd{at(j, k), ldx, wj, w, kDense};
        },
        dsm,
        [&](int r, int c, double v) {
          if (r < wi && c < wj) Aij[(int64_t)r * ldx + c] -= v;
        },
        i == j, h, h + 1);
    if (i == j && h == 1 && k == j - 1) post(fU + j);
  };
  // The factorization, right-looking in 128-column blocks: every CTA walks
  // the steps in order and takes its own jobs (the diagonal block, then
  // the row halves of the blocks below it, then those of the trailing
  // blocks column by column, the next diagonal block first), each
  // awaiting the blocks it reads.  A job waits only on jobs earlier in
  // this order, so the front's CTAs cannot stall each other.
  for (int k = 0; k < nb; ++k) {
    if (own(k, k, 0)) factor(k);
    for (int i = k + 1; i < nb; ++i)
      for (int h = 0; h < halves(i); ++h)
        if (own(i, k, h)) solve(i, k, h);
    for (int j = k + 1; j < nb; ++j)
      for (int i = j; i < nb; ++i)
        for (int h = 0; h < halves(i); ++h)
          if (own(i, j, h)) update(i, j, k, h);
  }

  // L^-1 below its diagonal blocks, block by block in row order: X_ij (i >
  // j) lies column-major at block (j, i) of the row-major view, which the
  // factorization never used; first Y = sum_{m=j}^{i-1} L_im X_mj there
  // (L_im row-major at block (i, m), X_mj column-major at (j, m)), then
  // X_ij = -X_ii Y in place (X_ii row-major in Dinv); the owner of block
  // (i, j) composes it
  for (int i = 1; i < nb; ++i) {
    const int wi = width(i);
    for (int j = 0; j < i; ++j) {
      if (!own(i, j, 0)) continue;
      const int wj = width(j), hi = halves(i), nl = (i - j) * hi;
      double* Xij = at(j, i);
      // the sum: L_ij .. L_i,i-1 solved (each half), X_jj factored,
      // X_j+1,j .. X_i-1,j composed; then the scale: D_i factored
      wait(nl + i - j, [&](int q) {
        return q < nl ? fS + 2 * tid(i, j + q / hi) + q % hi
                      : q == nl ? fB + j : fX + tid(j + q - nl, j);
      });
      product<false>(
          i - j,
          [&](int t, Opnd& A, Opnd& B) {
            const int m = j + t, wm = width(m);
            A = Opnd{at(i, m), ldx, wi, wm, kDense};
            // X_jj^T (m = j) is zero below its diagonal
            B = Opnd{at(j, m), ldx, wj, wm, m == j ? kLowerZero : kDense};
          },
          dsm,
          [&](int r, int c, double v) {
            if (r < wi && c < wj) Xij[(int64_t)c * ldx + r] = v;
          });
      wait(1, [&](int) { return fB + i; });
      product<false>(
          1,
          [&](int, Opnd& A, Opnd& B) {
            A = Opnd{Ds + (int64_t)i * kNB * kNB, kNB, wi, wi, kUpperZero};
            B = Opnd{Xij, ldx, wj, wi, kDense};
          },
          dsm,
          [&](int r, int c, double v) {
            if (r < wi && c < wj)
              Xij[(int64_t)c * ldx + r] = finite_or_zero(-v);
          });
      post(fX + tid(i, j));
    }
  }
  all(fE);
  // L^-1 above its diagonal blocks (the row-major view's lower blocks,
  // which held L): zero
  for (int r = kNB + gw; r < Wd; r += nw)
    for (int c = lane; c < r / kNB * kNB; c += 32)
      Wk[(int64_t)r * ldx + c] = 0.0;
  if (me == 0 && threadIdx.x == 0) {
    int f = -1;
    for (int k = 0; k < nb && f < 0; ++k) {
      const int b = -1 - __ldcg(bad + k);
      if (b < kNB) f = k * kNB + b;
    }
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

// -- the level's tail: panel, U's block-lower tiles and the scatter ---------

constexpr int kUT = 64;                    // a CTA's output tile
// a warp a 32 x 32 quadrant of the tile
constexpr int kUThreads = (kUT / 32) * (kUT / 32) * 32;
constexpr int kUPitch = kUT + 4;           // shared row pitch of a slab
constexpr int kUSlab = kTile * kUPitch;    // one operand's 32-row slab
constexpr int kUStages = 3;                // slabs in flight
constexpr int kUShm = kUStages * 2 * kUSlab * (int)sizeof(double);
constexpr int kUTileSq = kUT * kUT;        // a partial tile in the scratch
constexpr int kMaxD = 12;                  // the widest block the scatter takes
constexpr int kMaxChunks = 8;              // k-chunks of a split product's tile

// Queue the copy of rows k0 .. k0 + 31 (< K) and columns c0 .. c0 + kUT - 1
// (< cols) of a k-major operand (entry (k, c) at p[k * ld + c]) into dst
// (pitch kUPitch), zero outside: a pair of columns a thread (copy_pair),
// kUT / 2 threads a row.
__device__ __forceinline__ void stage_kslab(const double* p, int64_t ld,
                                            int K, int cols, int k0, int c0,
                                            double* dst) {
  constexpr int kPairs = kTile * kUT / 2;
#pragma unroll
  for (int q = 0; q < (kPairs + kUThreads - 1) / kUThreads; ++q) {
    const int z = threadIdx.x + kUThreads * q;
    if (kPairs % kUThreads != 0 && z >= kPairs) break;
    const int r = z / (kUT / 2), c = 2 * (z % (kUT / 2));
    const int valid = k0 + r < K ? max(0, min(2, cols - c0 - c)) : 0;
    copy_pair(dst + r * kUPitch + c,
              valid ? p + (int64_t)(k0 + r) * ld + c0 + c : p, valid);
  }
}

// Store v0, v1 at p[0], p[1] (only v0 where `two` is false): one 16-byte
// store where p is 16-byte aligned, else 8-byte ones.
__device__ __forceinline__ void store_pair(double* p, double v0, double v1,
                                           bool two) {
  if (two && !(reinterpret_cast<uintptr_t>(p) & 15)) {
    *reinterpret_cast<double2*>(p) = make_double2(v0, v1);
  } else {
    p[0] = v0;
    if (two) p[1] = v1;
  }
}

// p[0], p[1] read past L1: one 16-byte load where p is 16-byte aligned.
__device__ __forceinline__ double2 ldcg_pair(const double* p) {
  if (!(reinterpret_cast<uintptr_t>(p) & 15))
    return __ldcg(reinterpret_cast<const double2*>(p));
  return make_double2(__ldcg(p), __ldcg(p + 1));
}

enum UpdateProduct { kPanel, kLowerU };

// The kUT x kUT tile (m0, n0) of C = P^T Q over k in [k0, k1), P and Q
// k-major (rows ldp, ldq apart; pcols and qcols columns, zero past them),
// then epi(r, c, two values) for the pairs (r, c), (r, c + 1) of every
// 16 x 8 block the warps formed.  Blocks past C's rows (pcols) or columns
// (qcols), and k16 steps past k1, are skipped.  kPanel: P is L^-1
// (P[k][m] = L^-1[m][k], zero for k > m), whose 16 x 16 blocks above the
// diagonal are skipped.  kLowerU: P = Q, and only the blocks holding an
// entry (r, c) with c / d <= r / d are formed; a tile on the diagonal
// stages its one operand once.  Warp (wm, wn) forms quadrant (32 wm,
// 32 wn): acc[mb][nb][v] is entry (32 wm + 16 mb + g + 8 (v / 2),
// 32 wn + 8 nb + 2 q + v % 2), g = lane / 4, q = lane % 4 (kernel 10's
// fragment layout).  Ends with a CTA barrier.
template <int kMode, typename F>
__device__ __forceinline__ void tile_product(const double* P, int64_t ldp,
                                             int pcols, const double* Q,
                                             int64_t ldq, int qcols, int k0,
                                             int k1, int m0, int n0, int d,
                                             double* smem, F epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int r0 = m0 + 32 * (warp / (kUT / 32));
  const int c0 = n0 + 32 * (warp % (kUT / 32));
  const bool same = kMode == kLowerU && m0 == n0;
  unsigned live = 0u;   // bit 4 mb + nb: the block is formed
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
      if (r0 + 16 * mb < pcols && c0 + 8 * nb < qcols &&
          (kMode != kLowerU || (c0 + 8 * nb) / d <= (r0 + 16 * mb + 15) / d))
        live |= 1u << (4 * mb + nb);
  double acc[2][4][4];
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[mb][nb][v] = 0.0;
  const int nslab = (k1 - k0 + kTile - 1) / kTile;
  auto stage = [&](int i) {
    if (i < nslab) {
      double* buf = smem + (i % kUStages) * 2 * kUSlab;
      stage_kslab(P, ldp, k1, pcols, k0 + kTile * i, m0, buf);
      if (!same)
        stage_kslab(Q, ldq, k1, qcols, k0 + kTile * i, n0, buf + kUSlab);
    }
    commit_slabs();
  };
  stage(0);
  stage(1);
  for (int i = 0; i < nslab; ++i) {
    stage(i + 2);
    await_slabs<kUStages - 1>();
    __syncthreads();
    const double* buf = smem + (i % kUStages) * 2 * kUSlab;
    const double* As = buf + (r0 - m0);
    const double* Bs = buf + (same ? 0 : kUSlab) + (c0 - n0);
    if (live) {
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int kk = 16 * ks, kabs = k0 + kTile * i + kk;
        // the m16 blocks this k16 step reaches: none past k1; kPanel:
        // only those whose last row is at or below the step's first k
        unsigned rows = kabs < k1 ? 3u : 0u;
        if (kMode == kPanel) {
#pragma unroll
          for (int mb = 0; mb < 2; ++mb)
            if (kabs > r0 + 16 * mb + 15) rows &= ~(1u << mb);
        }
        if (!rows) continue;
        double a[2][8], b[4][4];
#pragma unroll
        for (int mb = 0; mb < 2; ++mb)
#pragma unroll
          for (int v = 0; v < 8; ++v)
            a[mb][v] = As[(kk + q + 4 * (v >> 1)) * kUPitch + 16 * mb + g +
                          8 * (v & 1)];
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int v = 0; v < 4; ++v)
            b[nb][v] = Bs[(kk + q + 4 * v) * kUPitch + 8 * nb + g];
#pragma unroll
        for (int mb = 0; mb < 2; ++mb)
#pragma unroll
          for (int nb = 0; nb < 4; ++nb) {
            if (!(rows >> mb & 1u) || !(live >> (4 * mb + nb) & 1u))
              continue;
            double* c = acc[mb][nb];
            asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
                "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
                "{%12, %13, %14, %15}, {%0, %1, %2, %3};"
                : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
                : "d"(a[mb][0]), "d"(a[mb][1]), "d"(a[mb][2]), "d"(a[mb][3]),
                  "d"(a[mb][4]), "d"(a[mb][5]), "d"(a[mb][6]), "d"(a[mb][7]),
                  "d"(b[nb][0]), "d"(b[nb][1]), "d"(b[nb][2]),
                  "d"(b[nb][3]));
          }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (live >> (4 * mb + nb) & 1u)
          epi(r0 + 16 * mb + g + 8 * h, c0 + 8 * nb + 2 * q,
              acc[mb][nb][2 * h], acc[mb][nb][2 * h + 1]);
}

// U's tiles of one front: the pairs (mt, nt) with nt <= mt + 1 (nt < ntn),
// row after row; a front has u_tiles(ntn) of them.
__device__ __host__ __forceinline__ int u_tiles(int ntn) {
  int per = 0;
  for (int m = 0; m < ntn; ++m) per += m + 2 < ntn ? m + 2 : ntn;
  return per;
}
// Tile u of a front's U tiles: false where it holds no entry (r, c) of U's
// block-lower triangle (c / d <= r / d).
__device__ __forceinline__ bool u_tile(int u, int ntn, int Rd, int d,
                                       int& mt, int& nt) {
  for (mt = 0; u >= min(mt + 2, ntn); ++mt) u -= min(mt + 2, ntn);
  nt = u;
  return (kUT * nt) / d <= min(kUT * mt + kUT - 1, Rd - 1) / d;
}

// Sum the partial tiles of each tile's k-chunks in chunk order, a thread a
// pair of entries over the whole grid: S fronts of `per` tiles, nk chunks
// a tile in the scratch; where(s, t, m0, n0, nv) gives tile t's place in
// the product and the count nv (<= kMaxChunks) of its chunks that were
// formed (false: the tile was not); fin(s, r, c, v0, v1) stores the sums
// of entries (r, c), (r, c + 1).  A pair's chunks are loaded at once.
template <typename Where, typename Fin>
__device__ __forceinline__ void reduce_chunks(int S, int per, int nk,
                                              const double* __restrict__ part,
                                              Where where, Fin fin) {
  constexpr int kPairs = kUTileSq / 2;
  const int64_t total = (int64_t)S * per * kPairs;
  for (int64_t idx = (int64_t)blockIdx.x * kUThreads + threadIdx.x;
       idx < total; idx += (int64_t)gridDim.x * kUThreads) {
    const int tile = (int)(idx / kPairs), e = 2 * (int)(idx % kPairs);
    const int s = tile / per;
    int m0, n0, nv;
    if (!where(s, tile - s * per, m0, n0, nv)) continue;
    const double* p = part + (int64_t)tile * nk * kUTileSq + e;
    double2 v[kMaxChunks];
#pragma unroll
    for (int k = 0; k < kMaxChunks; ++k)
      if (k < nv)
        v[k] = ldcg_pair(p + (int64_t)k * kUTileSq);
    double2 acc = make_double2(0.0, 0.0);
#pragma unroll
    for (int k = 0; k < kMaxChunks; ++k)
      if (k < nv) {
        acc.x += v[k].x;
        acc.y += v[k].y;
      }
    fin(s, m0 + e / kUT, n0 + e % kUT, acc.x, acc.y);
  }
}

// The scratch of a launch (doubles, in this order): U (S x Rd x Rd; none
// on the direct route), the partial tiles of the split products, and U's
// operand Lp^T at the even pitch ldu where it differs from Rd.
__host__ __device__ __forceinline__ int64_t update_u_size(int S, int Rd,
                                                          int direct) {
  return direct ? 0 : (int64_t)S * Rd * Rd;
}

__global__ void __launch_bounds__(kUThreads, 2)
    sn_schur_update_kernel(int S, int Wd, int Rd, int d, int T, int ck1,
                           int ck2, int ldx, int lda, int ldu, int direct,
                           const double* __restrict__ X,
                           const double* __restrict__ At,
                           const int* __restrict__ uoff,
                           const int* __restrict__ ptr,
                           const int* __restrict__ tgt,
                           const int* __restrict__ utgt,
                           double* __restrict__ Lp, double* __restrict__ U,
                           double* work) {
  extern __shared__ __align__(16) double usm[];
  cg::grid_group grid = cg::this_grid();
  const int mtn = (Wd + kUT - 1) / kUT, ntn = (Rd + kUT - 1) / kUT;
  const int slabs = (Wd + kTile - 1) / kTile;
  const int nk1 = (slabs + ck1 - 1) / ck1, nk2 = (slabs + ck2 - 1) / ck2;
  const int per = u_tiles(ntn);
  const int jobs1 = S * mtn * ntn * nk1, jobs2 = S * per * nk2;
  const int R = Rd / d, dd = d * d;
  // the partial tiles of split products, past U; U's operand past them
  // where its pitch is not Rd's
  double* part = U + update_u_size(S, Rd, direct);
  const int64_t psz = (int64_t)max(nk1 > 1 ? jobs1 : 0, nk2 > 1 ? jobs2 : 0)
                      * kUTileSq;
  double* Lu = ldu == Rd ? Lp : part + psz;
  // the panel's entry pair (r, c), (r, c + 1) of front s: into Lp^T (pitch
  // Rd, kernel 8's) and into U's operand at pitch ldu, whose columns past
  // Rd stay zero
  auto panel_out = [&](int s, int r, int c, double v0, double v1) {
    if (r >= Wd || c >= Rd) return;
    v0 = finite_or_zero(v0);
    v1 = c + 1 < Rd ? finite_or_zero(v1) : 0.0;
    store_pair(Lp + ((int64_t)s * Wd + r) * Rd + c, v0, v1, c + 1 < Rd);
    if (Lu != Lp)
      store_pair(Lu + ((int64_t)s * Wd + r) * ldu + c, v0, v1, c + 1 < ldu);
  };
  // the direct route (one front, each target block one source): U's entry
  // (r, c) of block (a, b), b <= a, taken from its target at once, as the
  // scatter takes a sum of one block
  auto subtract = [&](int r, int c, double v) {
    if (r >= Rd || c >= Rd) return;
    const int a = r / d, b = c / d;
    if (b > a) return;
    const int t = utgt[a * R + b];
    if (t < 0) return;
    double* w = work + (int64_t)t * dd + (r - a * d) * d + c - b * d;
    *w = *w - (0.0 + v);
  };
  auto u_out = [&](int s, int r, int c, double v0, double v1) {
    if (direct) {
      subtract(r, c, v0);
      subtract(r, c + 1, v1);
    } else if (r < Rd && c < Rd) {
      store_pair(U + ((int64_t)s * Rd + r) * Rd + c, v0, v1, c + 1 < Rd);
    }
  };
  // 1. Lp^T = L^-1 At: rows m take L^-1's columns k <= m only; each tile's
  // k range in nk1 chunks of ck1 slabs (a job each, the deepest row tiles
  // first), whose partial tiles are summed in order after a barrier when
  // nk1 > 1; At's columns past Rd (up to lda) are zero
  auto panel_slabs = [&](int mt) {
    return min((kUT / 32) * (mt + 1), slabs);
  };
  auto panel_job = [&](int j) {
    const int tile = j / nk1, kc = j - tile * nk1;
    const int mt = mtn - 1 - tile / (S * ntn), rem = tile % (S * ntn);
    const int s = rem / ntn, nt = rem - s * ntn;
    if (kc * ck1 >= panel_slabs(mt)) return;
    const int k0 = kTile * kc * ck1;
    const int k1 = min(min(Wd, kUT * mt + kUT), k0 + kTile * ck1);
    double* Ps = part + ((int64_t)(s * mtn + mt) * ntn + nt) * nk1 * kUTileSq
                 + (int64_t)kc * kUTileSq;
    tile_product<kPanel>(
        X + (int64_t)s * ldx * ldx, ldx, Wd, At + (int64_t)s * Wd * lda, lda,
        lda, k0, k1, kUT * mt, kUT * nt, d, usm,
        [&](int r, int c, double v0, double v1) {
          if (nk1 > 1)
            store_pair(Ps + (r - kUT * mt) * kUT + c - kUT * nt, v0, v1,
                       true);
          else
            panel_out(s, r, c, v0, v1);
        });
  };
  // 2. U's block-lower tiles: U[a][b] = sum_k Lp^T[k][a] Lp^T[k][b], each
  // tile's k range in nk2 chunks of ck2 slabs
  auto u_job = [&](int j) {
    const int tile = j / nk2, kc = j - tile * nk2;
    const int s = tile / per;
    int mt, nt;
    if (!u_tile(tile - s * per, ntn, Rd, d, mt, nt)) return;
    const int k0 = kTile * kc * ck2, k1 = min(Wd, k0 + kTile * ck2);
    const double* Ls = Lu + (int64_t)s * Wd * ldu;
    double* Ps = part + ((int64_t)tile * nk2 + kc) * kUTileSq;
    tile_product<kLowerU>(
        Ls, ldu, ldu, Ls, ldu, ldu, k0, k1, kUT * mt, kUT * nt, d, usm,
        [&](int r, int c, double v0, double v1) {
          if (nk2 > 1)
            store_pair(Ps + (r - kUT * mt) * kUT + c - kUT * nt, v0, v1,
                       true);
          else
            u_out(s, r, c, v0, v1);
        });
  };
  for (int j = blockIdx.x; j < jobs1; j += gridDim.x) panel_job(j);
  if (nk1 > 1) {
    grid.sync();
    reduce_chunks(
        S, mtn * ntn, nk1, part,
        [&](int, int t, int& m0, int& n0, int& nv) {
          const int mt = t / ntn;
          m0 = kUT * mt;
          n0 = kUT * (t - mt * ntn);
          nv = (panel_slabs(mt) + ck1 - 1) / ck1;
          return true;
        },
        panel_out);
  }
  grid.sync();
  for (int j = blockIdx.x; j < jobs2; j += gridDim.x) u_job(j);
  if (nk2 > 1) {
    grid.sync();
    reduce_chunks(
        S, per, nk2, part,
        [&](int, int t, int& m0, int& n0, int& nv) {
          int mt, nt;
          const bool formed = u_tile(t, ntn, Rd, d, mt, nt);
          m0 = kUT * mt;
          n0 = kUT * nt;
          nv = nk2;
          return formed;
        },
        // the pairs outside U's block-lower triangle are never read
        u_out);
  }
  if (direct) return;
  grid.sync();
  // 3. the scatter, a thread per row of a target block: its old row and
  // the first source's row loaded at once (d <= kMaxD contiguous entries
  // each), each entry's sources summed in the plan's order, the row
  // stored; uoff: a source block's first entry in U
  const int64_t rows = (int64_t)T * d;
  for (int64_t idx = (int64_t)blockIdx.x * kUThreads + threadIdx.x;
       idx < rows; idx += (int64_t)gridDim.x * kUThreads) {
    const int64_t t = idx / d;
    const int i = (int)(idx - t * d);
    const int kb = ptr[t], ke = ptr[t + 1];
    double* w = work + (int64_t)tgt[t] * dd + i * d;
    double old[kMaxD], acc[kMaxD];
#pragma unroll
    for (int j = 0; j < kMaxD; ++j) {
      acc[j] = 0.0;
      if (j < d) old[j] = w[j];
    }
    for (int k = kb; k < ke; ++k) {
      const double* u = U + uoff[k] + i * Rd;
#pragma unroll
      for (int j = 0; j < kMaxD; ++j)
        if (j < d) acc[j] += __ldcg(u + j);
    }
#pragma unroll
    for (int j = 0; j < kMaxD; ++j)
      if (j < d) w[j] = old[j] - acc[j];
  }
}

}  // namespace

// One level: S fronts of W blocks (d wide), R panel rows (0: no panel), n
// variables (col_vars' sentinel).  L: S x Wd x Wd, each front column-major;
// X: S x ldx x ldx (ldx >= Wd), each front's L^-1 column-major with columns
// ldx apart (the working front before it); At: S x Wd x Rd at row pitch
// lda >= Rd (the panel transposed, the columns past Rd zero; unused when
// R = 0); Dinv: S x ceil(Wd / 128) x 128 x 128 scratch; tiles: the
// level's S x ceil(Wd / 32) inverses of L's 32 x 32 diagonal tiles, 32 x 32
// row-major each (kernel 8's order); rec: S ints.  ctas CTAs a front (1:
// S CTAs, a plain launch; more: one cooperative launch of S * ctas CTAs,
// which the card must hold at once, one an SM); flags: S *
// front_flags(ceil(Wd / 128), ctas) ints, seq this launch's number (larger
// than any that a flag holds).
GT_EXPORT int gt_sn_front_factor(
    int S, int W, int R, int d, int n, int ctas, int seq, int ldx, int lda,
    const double* work,
    const double* blocks, const int* diag_ids, const unsigned char* diag_flip,
    const double* diag_pad, const unsigned char* valid_diag,
    const int* col_vars, const int* dbc, const int* panel_ids, double lam,
    int diagonal_damping, double min_diag, double max_diag, double* L,
    double* X, double* At, double* Dinv, double* tiles, int* rec, int* flags,
    void* stream) {
  if (S == 0) return 0;
  if (ctas < 1 || ldx < W * d || lda < R * d)
    return (int)cudaErrorInvalidValue;
  const size_t shm = 2 * chol::kTiles * kTileSz * sizeof(double);
  cudaError_t e = cudaFuncSetAttribute(
      sn_front_factor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shm);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeCooperative;
  at[0].val.cooperative = 1;
  cfg.gridDim = dim3((unsigned)(S * ctas));
  cfg.blockDim = dim3(chol::kThreads);
  cfg.dynamicSmemBytes = shm;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = at;
  cfg.numAttrs = ctas > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, sn_front_factor_kernel, W, R, d, n, ctas, seq,
                         ldx, lda, work, blocks, diag_ids, diag_flip, diag_pad,
                         valid_diag, col_vars, dbc, panel_ids, lam,
                         diagonal_damping, min_diag, max_diag, L, X, At,
                         Dinv, tiles, rec, flags);
  if (e != cudaSuccess) return (int)e;
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

// One level's tail: S fronts of W column blocks and R row blocks of width d
// <= 12 (Wd = W d, Rd = R d), X the front kernel's L^-1 (S x ldx x ldx,
// each front column-major with columns ldx apart), At its panels
// transposed (S x Wd x Rd at row pitch lda >= Rd, the columns past Rd
// zero); the level's scatter plan: uoff, the first entry in U of each
// summed block, in T segments ptr, with unique target rows tgt of work;
// ck1, ck2: the slabs of a k-chunk of the panel's and U's products (as
// deep as Wd: no split); ldu: the row pitch of U's operand
// (Rd: Lp itself; Rd + 1 for an odd Rd: an even-pitched copy in the
// scratch); direct (S = 1, each target one block; utgt: the target row of
// U's block (a, b), R x R, -1 for none): U's tiles subtract their blocks
// from work themselves, no U and no scatter.  Lp: S x Wd x Rd (Lp^T
// row-major), U: the scratch (update_u_size, then the split products'
// partial tiles, then U's operand where ldu != Rd).  One cooperative
// launch of as many CTAs as the phases have work for and the card holds
// at once.
GT_EXPORT int gt_sn_schur_update(int S, int W, int R, int d, int T, int ck1,
                                 int ck2, int ldx, int lda, int ldu,
                                 int direct, const double* X,
                                 const double* At, const int* uoff,
                                 const int* ptr, const int* tgt,
                                 const int* utgt, double* Lp, double* U,
                                 double* work, void* stream) {
  if (S == 0 || R == 0) return 0;
  const int Rd = R * d;
  if (d > kMaxD || ldx < W * d || lda < Rd || (ldu != Rd && ldu != Rd + 1) ||
      (direct && S != 1))
    return (int)cudaErrorInvalidValue;
  // the co-resident CTAs of each device, found once
  static int cap[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (cap[dev] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaFuncSetAttribute(sn_schur_update_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kUShm);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, sn_schur_update_kernel, kUThreads, kUShm);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    cap[dev] = sms * per_sm;
  }
  const int Wd = W * d;
  const int mtn = (Wd + kUT - 1) / kUT, ntn = (Rd + kUT - 1) / kUT;
  const int slabs = (Wd + kTile - 1) / kTile;
  const long long nk1 = (slabs + ck1 - 1) / ck1, nk2 = (slabs + ck2 - 1) / ck2;
  const long long tiles1 = (long long)S * mtn * ntn;
  const long long tiles2 = (long long)S * u_tiles(ntn);
  const long long scatter =
      direct ? 0 : ((long long)T * d + kUThreads - 1) / kUThreads;
  const long long jobs = std::max({tiles1 * nk1, tiles2 * nk2, scatter});
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeCooperative;
  at[0].val.cooperative = 1;
  cfg.gridDim = dim3((unsigned)std::min((long long)cap[dev], jobs));
  cfg.blockDim = dim3(kUThreads);
  cfg.dynamicSmemBytes = kUShm;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, sn_schur_update_kernel, S, Wd, Rd, d, T, ck1,
                         ck2, ldx, lda, ldu, direct, X, At, uoff, ptr, tgt,
                         utgt, Lp, U, work);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
