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
// gt_sp_level_factor (kernel 13): one cooperative launch over every leading
//   level, a CTA of 512 threads a job (a column j; job q = CTA + k grid, in
//   level order; 192 KB of shared memory, one CTA an SM).  The job's
//   first round of triple ids is loaded while warp 0 waits on the flags of
//   the columns its triples read (wsrc; a lane a column, backing off).
//   Then its triples (its blocks', block after block) go in rounds that fit
//   in shared memory, pipelined: while a round's products are formed, the
//   next round's source blocks L_ik and L_jk are staged by cp.async
//   (16-byte, past L1; 8-byte ld.cg for odd d), the ids of the round after
//   it loaded, and the previous round's products summed.  The threads form
//   lane groups of d^2, a thread an entry (r, c) throughout, so no lane
//   carries two chains: a group takes every G-th triple of a round and
//   forms its products (row r of L_ik times row c of L_jk, a d-term dot
//   product, in column order; 16-byte loads at d = 6); then a group takes
//   every G-th block of the round and adds the block's products to its sum
//   in triple order, a partial sum carried into the next round in shared
//   memory where the block's triples go on.  Each block becomes A (+ lam
//   on the true diagonal) less its sum: the arithmetic of a factorization
//   a launch a level, in its order, so its bits.  The diagonal block goes
//   to shared memory, where warp 0 factors it right-looking, a row a lane
//   in registers by shuffles (a pivot that is not finite and positive
//   marks the column in rec), and every thread then solves one row of a
//   subdiagonal block (two in flight), x L_jj^T = a, by forward
//   substitution.  After a barrier, one thread stores the factorization's
//   epoch into the column's flag with release semantics at GPU scope
//   (cumulative over the CTA's writes).  A is read, the factor written to
//   L (out of place).
// gt_sp_tail_assemble (kernel 13's second entry): a warp a stored block of
//   the dense root M's lower triangle: the stored tail block less its late
//   triples (sources in the leading columns), plus lam on the diagonal.
//   The warp stages a trip of triples' L_ik and L_jk in its slice of
//   shared memory (576 doubles: 8 triples at d = 6, at most 16), every
//   entry's copy queued at once by cp.async (coalesced along each block,
//   so a trip waits on one round of loads), then forms the products'
//   entries a lane each (at d = 6, 16-byte reads of the slice, and the
//   entries past the 32nd of every triple of the trip at once), the
//   triples in lptr order (the bits do not depend on the launch); the
//   block goes through the slice to M and, transposed, to its mirror, both
//   a lane an entry along M's rows.  Warps of the launch's last CTAs zero
//   the entries of M's blocks with no stored block, a row of M each.  M
//   then goes to dense_blocked.blocked_cholesky.
// gt_sp_level_forward / gt_sp_level_backward (kernel 14): one launch a
//   direction over every level, a warp a job, the jobs in the direction's
//   order (level by level; a warp takes jobs w, w + W, ... of W warps).
//   The forward job of leading column j sums L_jk y_k over the rows of j's
//   earlier blocks, subtracts it from the right-hand side (the padded g,
//   or through a map the canonical flat vector of a CG loop) and
//   substitutes with L_jj lane by lane through shuffles; the last jobs
//   (past ndiag) form the dense root's right-hand side instead, with no
//   substitution.  The backward job sums L_ij^T x_i over j's subdiagonal
//   blocks, substitutes with L_jj^T, and writes x both to U and to the flat
//   delta (un-permuted, un-padded); a dense-root column only copies its x
//   (kernel 11's, written before the launch) to the delta.  Both return at
//   once where `stop` (a CG loop's done word) is set, before any write.
//
// Kernel 14's columns pass their rows on by flags, one int a column (a
//   row of Y forward, of U backward) in a buffer the solver keeps: the
//   producer warp writes its d entries, __syncwarp, and one lane stores
//   the solve's epoch with release semantics at GPU scope; a consumer's
//   lanes poll the flags of the job's sources with acquire loads until
//   each holds the epoch, then read those rows past L1 (ld.cg).  The epoch
//   is a new number every solve (the wrapper's argument), so no launch
//   resets the flags and a stopped launch leaves none that a later solve
//   could take for its own.  Every source precedes its job in the order,
//   and the cooperative launch keeps every warp resident, so the lowest
//   unfinished job can always run: no wait lasts.  A job's L blocks do not
//   depend on the solve: the warp queues their copies into its slice of
//   shared memory (cp.async; the diagonal block first, then as many of its
//   list as fit; a longer list's later blocks a slice at a time after the
//   wait) and takes the reciprocals of L_jj's diagonal before it polls.
//   The job's list is split over floor(32 / d) lane groups of d lanes
//   (lane c of a group component c of the product), whose partial sums are
//   added in group order by shuffles; a group reads its blocks' source
//   rows eight at a time, a lane an entry, shared by shuffles; the
//   substitution stays in group 0 and multiplies by the reciprocals.
//
// Kernel 13's flags: one int a column in a buffer the solver keeps, the
//   epoch a new number every factorization, as kernel 14's below; the jobs
//   are taken in level order and every source lies in an earlier level,
//   so the lowest unfinished job can always run.
//
// No atomics: every sum runs in an order fixed by the plan (kernel 13: a
// block's products in triple order, as a launch a level sums them: the
// same bits), so a launch gives the same bits on every
// run, whatever the grid.  Bound on the H100:
// at the sphere's sizes kernel 13 moves ~85 MB (25 us at 3.35 TB/s) and
// does ~0.1 GFLOP (2 d^3 a triple); the chain of columns through the
// elimination tree (38 levels on the sphere, a hand-off through L2, a
// diagonal Cholesky and its row solves each) and the top columns' ~1,100
// triples on one SM (staged at one SM's share of L2's rate) bound it.
// Kernel 14
// moves ~10 MB a direction (3 us): the chain of its levels (38 hand-offs
// through L2 on the sphere) bounds it.
#include "ba_common.cuh"

namespace {

constexpr int kMaxD = 12;
constexpr int kFactorThreads = 512;      // kernel 13: a CTA a column
constexpr int kFactorShm = 192 * 1024;   // its rounds' staged blocks
constexpr int kMetaBlocks = 512;         // a job's block ids kept in shared
constexpr int kTailThreads = 128;        // a warp a stored block of M
constexpr int kTailWarps = kTailThreads / gt::kWarp;
constexpr int kTailSlice = 576;          // doubles of shared memory a warp
constexpr int kTailSlots = (kMaxD * kMaxD + gt::kWarp - 1) / gt::kWarp;
constexpr int kSolveThreads = 128;       // kernel 14: a warp a job
constexpr int kSolveWarps = kSolveThreads / gt::kWarp;
constexpr int kSlice = 1024;             // doubles of shared memory a warp
constexpr int kBatch = 8;                // list blocks a group a trip to L2
constexpr long long kStall = 4000000000LL;
constexpr unsigned kFull = 0xffffffffu;

// An int load with acquire, a store with release, at GPU scope.
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// Wait until the flag of every column in wsrc[w0 .. w1) holds `epoch`: the
// lanes of warp 0 poll them, lane l columns l, l + 32, ..., each backing
// off from 64 ns to 512 ns between loads, so that the CTAs that wait (most
// of the grid, while the top levels run) load the flags' few L2 lines
// lightly; a wait of kStall cycles can only be a fault and traps (see
// await_sources).
__device__ __forceinline__ void await_columns(const int* flags, int epoch,
                                              const int* __restrict__ wsrc,
                                              int w0, int w1) {
  if (threadIdx.x < gt::kWarp) {
    for (int w = w0 + threadIdx.x; w < w1; w += gt::kWarp) {
      const int k = wsrc[w];
      const long long t0 = clock64();
      unsigned ns = 64;
      while (ld_acquire(flags + k) != epoch) {
        if (clock64() - t0 > kStall) __trap();
        __nanosleep(ns);
        ns = min(2 * ns, 512u);
      }
    }
  }
  __syncthreads();
}

// Queue the copies of a round's source blocks: n_t triples, triple t's
// L_ik to S + t 2 dd, its L_jk dd further, their block ids read from sIk /
// sJk (the round's, in shared memory).  Lane group grp (of G) takes
// triples grp, grp + G, ..., its thread ent the same pieces of each.  Past
// L1 (the blocks were written in this launch by other SMs): 16-byte
// cp.async.cg, committed as one group, where dd is even (piece ent: 16
// bytes of L_ik, or of L_jk past dd / 2); else 8-byte ld.cg loads, stored
// at once (entry ent of both blocks).
__device__ __forceinline__ void stage_round(double* S, const double* L,
                                            const int* sIk, const int* sJk,
                                            int n_t, int dd, int G, int grp,
                                            int ent) {
  if (grp < G) {
    if ((dd & 1) == 0) {
      const int h = dd / 2;
      const int which = ent / h, off = 2 * (ent - which * h);
      const int* ids = which ? sJk : sIk;
      for (int t = grp; t < n_t; t += G) {
        const unsigned dst = (unsigned)__cvta_generic_to_shared(
            S + t * 2 * dd + which * dd + off);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
                     "l"(L + (int64_t)ids[t] * dd + off)
                     : "memory");
      }
    } else {
      for (int t = grp; t < n_t; t += G) {
        const double a = __ldcg(L + (int64_t)sIk[t] * dd + ent);
        const double b = __ldcg(L + (int64_t)sJk[t] * dd + ent);
        S[t * 2 * dd + ent] = a;
        S[t * 2 * dd + dd + ent] = b;
      }
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// A round's products: lane group grp takes triples grp, grp + G, ... of
// the n_t staged in Sc, its thread ent entry (er, ec) of each, row er of
// L_ik times row ec of L_jk summed in column order, into Pc.  D: 6 (the
// pose graphs' width: 16-byte loads), or 0 (any d).
template <int D>
__device__ __forceinline__ void round_products(const double* Sc, double* Pc,
                                               int n_t, int d, int G,
                                               int grp, int ent, int er,
                                               int ec) {
  const int dd = d * d;
#pragma unroll 2
  for (int t = grp; t < n_t; t += G) {
    const double* li = Sc + t * 2 * dd + er * d;
    const double* lj = Sc + t * 2 * dd + dd + ec * d;
    double s = 0.0;
    if (D == 6) {
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const double2 a = reinterpret_cast<const double2*>(li)[m];
        const double2 b = reinterpret_cast<const double2*>(lj)[m];
        s += a.x * b.x;
        s += a.y * b.y;
      }
    } else {
#pragma unroll
      for (int m = 0; m < kMaxD; ++m)
        if (m < d) s += li[m] * lj[m];
    }
    Pc[t * dd + ent] = s;
  }
}

__global__ void __launch_bounds__(kFactorThreads) sp_level_factor_kernel(
    int J, int d, int epoch, const int* __restrict__ cols,
    const int* __restrict__ cptr, const int* __restrict__ cblk,
    const int* __restrict__ tptr, const int* __restrict__ tik,
    const int* __restrict__ tjk, const int* __restrict__ wptr,
    const int* __restrict__ wsrc, const double* __restrict__ A,
    const double* __restrict__ pad, double lam, double* L,
    int* __restrict__ rec, int* flags) {
  extern __shared__ __align__(16) double smem[];
  __shared__ double sD[kMaxD * kMaxD];
  // the partial sum a block carries from one round into the next (two:
  // read in a round, written for the next)
  __shared__ double sCarry[2][kMaxD * kMaxD];
  // the job's block ids and triple pointers (its first kMetaBlocks)
  __shared__ int sBlk[kMetaBlocks], sTp[kMetaBlocks + 1];
  const int dd = d * d;
  // a round: `cap` triples (at most one a thread, whose ids that thread
  // prefetches); two buffers of their two staged blocks (S), block ids
  // (sIk, sJk) and products (Pb): the round's and the next's
  const int cap = min(kFactorShm / (6 * dd * (int)sizeof(double) +
                                    4 * (int)sizeof(int)),
                      kFactorThreads);
  int* ids = (int*)(smem + cap * 6 * dd);
  auto S = [&](int b) { return smem + b * cap * 2 * dd; };
  auto Pb = [&](int b) { return smem + cap * 4 * dd + b * cap * dd; };
  auto sIk = [&](int b) { return ids + b * 2 * cap; };
  auto sJk = [&](int b) { return ids + b * 2 * cap + cap; };
  // lane groups of dd threads, a thread an entry (er, ec) throughout
  const int G = kFactorThreads / dd;
  const int grp = threadIdx.x / dd, ent = threadIdx.x - grp * dd;
  const int er = ent / d, ec = ent - er * d;
  const bool live = grp < G;
  const int warp = threadIdx.x / gt::kWarp, lane = threadIdx.x % gt::kWarp;
  for (int q = blockIdx.x; q < J; q += gridDim.x) {
    const int j = cols[q];
    const int e0 = cptr[q], e1 = cptr[q + 1];
    for (int i = threadIdx.x; i <= min(e1 - e0, kMetaBlocks);
         i += kFactorThreads) {
      if (i < min(e1 - e0, kMetaBlocks)) sBlk[i] = cblk[e0 + i];
      sTp[i] = tptr[e0 + i];
    }
    // the first round's triple ids, in flight during the wait
    const int T0 = tptr[e0], T1 = tptr[e1];
    int nik = 0, njk = 0;
    if (T0 + (int)threadIdx.x < min(T1, T0 + cap)) {
      nik = tik[T0 + threadIdx.x];
      njk = tjk[T0 + threadIdx.x];
    }
    auto blk = [&](int e) {
      return e - e0 < kMetaBlocks ? sBlk[e - e0] : cblk[e];
    };
    auto tp = [&](int e) {
      return e - e0 <= kMetaBlocks ? sTp[e - e0] : tptr[e];
    };
    await_columns(flags, epoch, wsrc, wptr[q], wptr[q + 1]);
    // the column's triples in rounds, two in the pipeline: while a round's
    // products (a thread an entry of its group's triples) and sums (each
    // block's products in triple order, carried across a round's end in
    // sCarry) run, the next round's blocks are staged and the one after's
    // triple ids loaded
    if (T0 < T1) {
      if ((int)threadIdx.x < min(T1 - T0, cap)) {
        sIk(0)[threadIdx.x] = nik;
        sJk(0)[threadIdx.x] = njk;
      }
      __syncthreads();
      stage_round(S(0), L, sIk(0), sJk(0), min(T1 - T0, cap), dd, G, grp,
                  ent);
      const int tn = T0 + cap + (int)threadIdx.x;
      if (tn < min(T1, T0 + 2 * cap)) {
        nik = tik[tn];
        njk = tjk[tn];
      }
    }
    int eb = e0;                 // the first block not summed to its end
    // the sums of round rs (its triples [sa, sa + sn), products in Pc):
    // a group a block, each block's products added in triple order to its
    // sum, four loads ahead of the adds; a partial sum carried into the
    // next round (sCarry[rs & 1]) where the block's triples go on
    auto sums = [&](int rs, int sa, int sn, const double* Pc) {
      while (tp(eb + 1) <= sa) ++eb;
      int ee = eb;
      while (ee < e1 && tp(ee) < sa + sn) ++ee;
      if (!live) return;
      for (int e = eb + grp; e < ee; e += G) {
        const int t0 = tp(e), t1 = tp(e + 1);
        double acc = t0 < sa ? sCarry[(rs & 1) ^ 1][ent] : 0.0;
        const int u0 = max(t0, sa) - sa, u1 = min(t1, sa + sn) - sa;
        int u = u0;
        for (; u + 4 <= u1; u += 4) {
          double v[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) v[k] = Pc[(u + k) * dd + ent];
#pragma unroll
          for (int k = 0; k < 4; ++k) acc += v[k];
        }
        for (; u < u1; ++u) acc += Pc[u * dd + ent];
        if (t1 > sa + sn)
          sCarry[rs & 1][ent] = acc;
        else
          L[(int64_t)blk(e) * dd + ent] = acc;
      }
    };
    // round r: its products overlap the sums of round r - 1 (two product
    // buffers), one barrier between rounds (a round's products, staged
    // blocks and carried partial are read only after the next barrier)
    int pa = 0, pn = 0;          // the round whose sums are pending
    int r = 0;
    for (int ta = T0; ta < T1; ta += cap, ++r) {
      const int nt = min(T1 - ta, cap), cur = r & 1;
      asm volatile("cp.async.wait_all;" ::: "memory");
      if (ta + cap < T1 && (int)threadIdx.x < min(T1 - ta - cap, cap)) {
        sIk(cur ^ 1)[threadIdx.x] = nik;
        sJk(cur ^ 1)[threadIdx.x] = njk;
      }
      __syncthreads();
      if (ta + cap < T1) {
        stage_round(S(cur ^ 1), L, sIk(cur ^ 1), sJk(cur ^ 1),
                    min(T1 - ta - cap, cap), dd, G, grp, ent);
        const int tn = ta + 2 * cap + (int)threadIdx.x;
        if (tn < min(T1, ta + 3 * cap)) {
          nik = tik[tn];
          njk = tjk[tn];
        }
      }
      if (live) {
        if (d == 6)
          round_products<6>(S(cur), Pb(cur), nt, d, G, grp, ent, er, ec);
        else
          round_products<0>(S(cur), Pb(cur), nt, d, G, grp, ent, er, ec);
      }
      if (r > 0) sums(r - 1, pa, pn, Pb(cur ^ 1));
      pa = ta;
      pn = nt;
    }
    // the last round's sums read products and a carried partial that
    // other groups wrote in the loop's last trip: a barrier first
    if (r > 0) {
      __syncthreads();
      sums(r - 1, pa, pn, Pb((r - 1) & 1));
    }
    __syncthreads();
    // A (+ damping on the diagonal) less the sums (a block without
    // triples: nothing), four blocks a group in flight; the diagonal block
    // to shared memory
    if (live) {
      for (int e4 = e0 + grp; e4 < e1; e4 += 4 * G) {
        double a[4], acc[4];
        int64_t at[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = min(e4 + u * G, e1 - 1);
          at[u] = (int64_t)blk(e) * dd + ent;
          a[u] = A[at[u]];
          acc[u] = tp(e) < tp(e + 1) ? L[at[u]] : 0.0;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = e4 + u * G;
          if (e >= e1) break;
          if (e == e0 && er == ec)
            a[u] += lam * (1.0 - pad[(int64_t)j * d + er]);
          a[u] -= acc[u];
          if (e == e0)
            sD[ent] = a[u];
          else
            L[at[u]] = a[u];
        }
      }
    }
    __syncthreads();
    // the diagonal block's Cholesky, right-looking, in warp 0: lane i
    // keeps row i in registers and takes the rows it needs by shuffles
    if (warp == 0) {
      const int64_t bd = blk(e0);
      double a[kMaxD];
#pragma unroll
      for (int c = 0; c < kMaxD; ++c)
        a[c] = c < d && lane < d ? sD[lane * d + c] : 0.0;
      int bad = -1;
#pragma unroll
      for (int k = 0; k < kMaxD; ++k) {
        if (k < d) {
          const double s = __shfl_sync(kFull, a[k], k);
          if (bad < 0 && !(s > 0.0 && isfinite(s))) bad = k;
          const double piv = sqrt(s);
          if (lane == k) a[k] = piv;
          if (lane > k && lane < d) a[k] /= piv;
#pragma unroll
          for (int c = k + 1; c < kMaxD; ++c) {
            if (c < d) {
              const double v = __shfl_sync(kFull, a[k], c);
              if (lane >= c && lane < d) a[c] -= a[k] * v;
            }
          }
        }
      }
      if (lane < d) {
#pragma unroll
        for (int c = 0; c < kMaxD; ++c) {
          if (c < d) {
            sD[lane * d + c] = a[c];
            L[bd * dd + lane * d + c] = c <= lane ? a[c] : 0.0;
          }
        }
      }
      if (lane == 0) rec[q] = bad >= 0 ? j : -1;
    }
    __syncthreads();
    // the subdiagonal blocks: L_ij = A_ij L_jj^-T, a thread a row, two rows
    // in flight a thread
    const int nrow = (e1 - e0 - 1) * d;
    for (int w = threadIdx.x; w < nrow; w += 2 * kFactorThreads) {
      double* row[2];
      double x[2][kMaxD];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int wr = min(w + h * kFactorThreads, nrow - 1);
        row[h] = L + (int64_t)blk(e0 + 1 + wr / d) * dd + (wr % d) * d;
#pragma unroll
        for (int c = 0; c < kMaxD; ++c) x[h][c] = c < d ? row[h][c] : 0.0;
      }
#pragma unroll
      for (int c = 0; c < kMaxD; ++c) {
        if (c < d) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            x[h][c] /= sD[c * d + c];
#pragma unroll
            for (int c2 = c + 1; c2 < kMaxD; ++c2)
              if (c2 < d) x[h][c2] -= x[h][c] * sD[c2 * d + c];
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (w + h * kFactorThreads < nrow) {
#pragma unroll
          for (int c = 0; c < kMaxD; ++c)
            if (c < d) row[h][c] = x[h][c];
        }
      }
    }
    // the column done: __syncthreads orders every thread's writes before
    // thread 0's release at GPU scope (cumulative), then the flag
    __syncthreads();
    if (threadIdx.x == 0) st_release(flags + j, epoch);
  }
}

__device__ __forceinline__ void copy_async8(double* dst, const double* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(d), "l"(src)
               : "memory");
}

// Row i of L_ik times row k of L_jk of a trip's triple u (staged at sw +
// u * 2 dd and + dd): a d-term dot product in column order (16-byte reads
// at kD = 6; kD = 0: any d).
template <int kD>
__device__ __forceinline__ double dot_rows(const double* sw, int u, int d,
                                           int i, int k) {
  const int dd = d * d;
  const double* li = sw + u * 2 * dd + i * d;
  const double* lj = sw + u * 2 * dd + dd + k * d;
  double sm = 0.0;
  if (kD == 6) {
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const double2 a = reinterpret_cast<const double2*>(li)[m];
      const double2 b = reinterpret_cast<const double2*>(lj)[m];
      sm += a.x * b.x;
      sm += a.y * b.y;
    }
  } else {
#pragma unroll
    for (int m = 0; m < kMaxD; ++m)
      if (m < d) sm += li[m] * lj[m];
  }
  return sm;
}

template <int kD>
__global__ void __launch_bounds__(kTailThreads, 8) sp_tail_assemble_kernel(
    int T, int dr, int ld, int nb, int blk_ctas, const int* __restrict__ tmap,
    const int* __restrict__ tbid, const int* __restrict__ tpos,
    const int* __restrict__ lptr, const int* __restrict__ lik,
    const int* __restrict__ ljk, const int* __restrict__ tcols,
    const double* __restrict__ A, const double* __restrict__ L,
    const double* __restrict__ pad, double lam, double* __restrict__ M) {
  __shared__ __align__(16) double sL[kTailWarps][kTailSlice];
  const int d = kD ? kD : dr;
  const int lane = threadIdx.x % gt::kWarp, wi = threadIdx.x / gt::kWarp;
  if ((int)blockIdx.x >= blk_ctas) {
    // the zero fill: a warp a row of M, its entries in blocks with no
    // stored block
    const int64_t row =
        (int64_t)((int)blockIdx.x - blk_ctas) * kTailWarps + wi;
    if (row >= (int64_t)T * d) return;
    const int r = (int)(row / d);
    double* out = M + row * ld;
#pragma unroll 8
    for (int col = lane; col < T * d; col += gt::kWarp) {
      const int c = col / d;
      if ((r >= c ? tmap[r * T + c] : tmap[c * T + r]) < 0) out[col] = 0.0;
    }
    return;
  }
  const int e = (int)blockIdx.x * kTailWarps + wi;
  if (e >= nb) return;
  const int r = tpos[e] / T, c = tpos[e] - (tpos[e] / T) * T;
  const int dd = d * d, per = min(gt::kWarp / 2, kTailSlice / (2 * dd));
  double* sw = sL[wi];
  double acc[kTailSlots];
#pragma unroll
  for (int s = 0; s < kTailSlots; ++s) acc[s] = 0.0;
  const int t1 = lptr[e + 1];
  for (int tb = lptr[e]; tb < t1; tb += per) {
    const int nt = min(per, t1 - tb);
    // stage the trip's L_ik and L_jk (blocks 2u and 2u + 1 of the slice):
    // the ids a lane each, then every entry's copy queued at once
    // (cp.async, coalesced along each block), so a trip waits on one
    // round of loads
    const int bid = lane < 2 * nt
        ? (lane & 1 ? ljk[tb + lane / 2] : lik[tb + lane / 2]) : 0;
    __syncwarp();
    int u2 = lane / dd, w = lane - (lane / dd) * dd;
    for (int q = lane; q < kTailSlice; q += gt::kWarp) {
      const int b = __shfl_sync(kFull, bid, u2 < gt::kWarp ? u2 : 0);
      if (q < nt * 2 * dd) copy_async8(sw + q, L + (int64_t)b * dd + w);
      w += gt::kWarp;
      while (w >= dd) {
        w -= dd;
        ++u2;
      }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncwarp();
    // entry (i, k) of each triple's product, a lane an entry, added in
    // triple order
#pragma unroll
    for (int s = 0; s < (kD == 6 ? 1 : kTailSlots); ++s) {
      const int idx = lane + s * gt::kWarp;
      if (idx < dd) {
        const int i = idx / d, k = idx - (idx / d) * d;
        for (int u = 0; u < nt; ++u) acc[s] += dot_rows<kD>(sw, u, d, i, k);
      }
    }
    if (kD == 6) {
      // entries 32-35 (row 5, columns 2-5): lane 4u + j forms triple u's
      // entry 32 + j, all of the trip's at once; lanes 0-3 add them in
      // triple order
      const int j = lane & 3;
      const double sm = (lane >> 2) < nt
          ? dot_rows<6>(sw, lane >> 2, 6, 5, 2 + j) : 0.0;
      for (int u = 0; u < nt; ++u) {
        const double t = __shfl_sync(kFull, sm, 4 * u + j);
        if (lane < 4) acc[1] += t;
      }
    }
  }
  // the block, A less the sum (lam on the true diagonal), into the warp's
  // slice; then M's block rows and, transposed, its mirror's, a lane an
  // entry along each row
  __syncwarp();
#pragma unroll
  for (int s = 0; s < kTailSlots; ++s) {
    const int idx = lane + s * gt::kWarp;
    if (idx < dd) {
      const int i = idx / d, k = idx - (idx / d) * d;
      double v = A[(int64_t)tbid[e] * dd + idx];
      if (r == c && i == k) v += lam * (1.0 - pad[(int64_t)tcols[r] * d + i]);
      sw[idx] = v - acc[s];
    }
  }
  __syncwarp();
  for (int idx = lane; idx < dd; idx += gt::kWarp) {
    const int i = idx / d, k = idx - (idx / d) * d;
    M[(int64_t)(r * d + i) * ld + c * d + k] = sw[idx];
  }
  if (r != c) {
    for (int idx = lane; idx < dd; idx += gt::kWarp) {
      const int k = idx / d, i = idx - (idx / d) * d;
      M[(int64_t)(c * d + k) * ld + r * d + i] = sw[i * d + k];
    }
  }
}

// Queue the copies of blocks bid[e0 + k0 .. e0 + k1) of a job's list into
// the warp's slice at dst, block after block.
__device__ __forceinline__ void stage_list(double* dst, const double* L,
                                           int dd, const int* __restrict__ bid,
                                           int e0, int k0, int k1, int lane) {
  for (int i = lane; i < (k1 - k0) * dd; i += gt::kWarp) {
    const int k = i / dd;
    copy_async8(dst + i, L + (int64_t)bid[e0 + k0 + k] * dd + (i - k * dd));
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until every source row of the job below nflag (rows past it are
// written before the launch) is done in this launch: lane l polls the
// flags of src[e0 + l], src[e0 + l + 32], ... until each holds `epoch`.
// A wait of kStall cycles (seconds; a solve takes well under a
// millisecond) can only be a fault: it traps, so the launch fails and the
// caller's next synchronisation raises, instead of hanging the card.
__device__ __forceinline__ void await_sources(const int* flags, int nflag,
                                              int epoch,
                                              const int* __restrict__ src,
                                              int e0, int e1, int lane) {
  for (int e = e0 + lane; e < e1; e += gt::kWarp) {
    const int k = src[e];
    if (k >= nflag) continue;
    const long long t0 = clock64();
    while (ld_acquire(flags + k) != epoch) {
      if (clock64() - t0 > kStall) __trap();
      __nanosleep(32);
    }
  }
  __syncwarp();
}

// Lane c of group grp's share of a job's list product: over the group's
// blocks (k = grp, grp + G, ... of each chunk, chunk after chunk) the sum
// of entries at, at + step, ... (row c of the block forward, column c
// backward) times row src[e0 + k] of V.  The list's L blocks are in the
// warp's slice Lh, cap at a time: the first chunk staged before the wait,
// each later one (a long list) after the chunk before it, in one
// cp.async round.  The rows of V are read kBatch blocks a group at a
// time, each lane one entry (its component) past L1 and the group sharing
// them by shuffles, so a batch costs one trip to L2.  The order of the
// sum depends on the list's length and d only.
__device__ __forceinline__ double list_sum(double* Lh, int cap,
                                           const double* __restrict__ L,
                                           const int* __restrict__ bid,
                                           const int* __restrict__ src,
                                           int e0, int n, const double* V,
                                           int d, int G, int grp, int c,
                                           int at, int step, int lane) {
  const int dd = d * d;
  const bool in = grp < G;
  const int g0 = in ? grp : 0;   // lanes past the groups: group 0's values
  double s = 0.0;
  for (int c0 = 0; c0 < n; c0 += cap) {
    const int c1 = min(n, c0 + cap);
    if (c0 > 0) {                // the next chunk, once this one is read
      __syncwarp();
      stage_list(Lh, L, dd, bid, e0, c0, c1, lane);
      asm volatile("cp.async.wait_all;" ::: "memory");
      __syncwarp();
    }
    for (int kb = c0; kb < c1; kb += kBatch * G) {
      double v[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int k = kb + b * G + grp;
        v[b] = in && k < c1 ? __ldcg(V + (int64_t)src[e0 + k] * d + c) : 0.0;
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (kb + b * G >= c1) break;   // warp-uniform
        const int k = kb + b * G + grp;
        const bool ok = in && k < c1;
        const double* Lb = Lh + (ok ? (k - c0) * dd + at : 0);
        double u = 0.0;
#pragma unroll
        for (int m = 0; m < kMaxD; ++m) {
          if (m < d) {
            const double vm = __shfl_sync(kFull, v[b], g0 * d + m);
            if (ok) u += Lb[m * step] * vm;
          }
        }
        if (ok) s += u;
      }
    }
  }
  return s;
}

// The sum over the lane groups of s, in group order: every lane gets its
// component's total (lanes past the groups too).
__device__ __forceinline__ double group_sum(double s, int G, int d,
                                            int c) {
  double tot = 0.0;
  for (int g = 0; g < G; ++g) tot += __shfl_sync(kFull, s, g * d + c);
  return tot;
}

__global__ void __launch_bounds__(kSolveThreads) sp_level_forward_kernel(
    int J, int ndiag, int d, int nflag, int epoch,
    const int* __restrict__ cols, const int* __restrict__ orow,
    const int* __restrict__ dbid, const int* __restrict__ fptr,
    const int* __restrict__ fbid, const int* __restrict__ fsrc,
    const double* __restrict__ L, const double* __restrict__ rhs,
    const int* __restrict__ rhs_map, double* Y, double* rt, int* flags,
    const int* stop) {
  __shared__ double slices[kSolveWarps][kSlice];
  if (stop != nullptr && *stop) return;
  const int warp = threadIdx.x / gt::kWarp, lane = threadIdx.x % gt::kWarp;
  const int dd = d * d;
  const int G = gt::kWarp / d;                   // lane groups
  const int grp = lane / d, c = lane - grp * d;  // c < d for every lane
  double* sl = slices[warp];
  const int nwarps = gridDim.x * kSolveWarps;
  for (int q = blockIdx.x * kSolveWarps + warp; q < J; q += nwarps) {
    const bool diag = q < ndiag;
    const int e0 = fptr[q], n = fptr[q + 1] - e0;
    const int64_t j = cols[q];
    // before the wait: the diagonal block and the list's first chunk into
    // the slice, the rhs, and 1 / L_jj's diagonal (lane k: entry k)
    const int off = diag ? dd : 0, cap = (kSlice - off) / dd;
    double rinv = 1.0;
    if (diag) {
      const double* Ld = L + (int64_t)dbid[q] * dd;
      for (int i = lane; i < dd; i += gt::kWarp) copy_async8(sl + i, Ld + i);
      if (lane < d) rinv = 1.0 / Ld[lane * (d + 1)];
    }
    stage_list(sl + off, L, dd, fbid, e0, 0, min(n, cap), lane);
    double b = 0.0;
    if (lane < d) {
      const int m = rhs_map != nullptr ? rhs_map[j * d + lane]
                                       : (int)(j * d + lane);
      b = m >= 0 ? rhs[m] : 0.0;
    }
    await_sources(flags, nflag, epoch, fsrc, e0, e0 + n, lane);
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncwarp();
    const double s = list_sum(sl + off, cap, L, fbid, fsrc, e0, n, Y, d, G,
                              grp, c, c * d, 1, lane);
    double acc = b - group_sum(s, G, d, c);
    if (diag) {
      for (int k = 0; k < d; ++k) {
        if (lane == k) acc *= rinv;
        const double yk = __shfl_sync(kFull, acc, k);
        if (lane > k && lane < d) acc -= sl[lane * d + k] * yk;
      }
      const int r = orow[q];
      if (lane < d) Y[(int64_t)r * d + lane] = acc;
      __syncwarp();
      if (lane == 0) st_release(flags + r, epoch);
    } else if (lane < d) {
      rt[(int64_t)orow[q] * d + lane] = acc;
    }
    __syncwarp();   // the slice is read before the next job stages it
  }
}

__global__ void __launch_bounds__(kSolveThreads) sp_level_backward_kernel(
    int J, int d, int nflag, int epoch, const int* __restrict__ cols,
    const int* __restrict__ xrow, const int* __restrict__ dbid,
    const int* __restrict__ bptr, const int* __restrict__ bbid,
    const int* __restrict__ bsrc, const double* __restrict__ L,
    const double* Y, double* U, const int* __restrict__ out_map,
    double* __restrict__ delta, int* flags, const int* stop) {
  __shared__ double slices[kSolveWarps][kSlice];
  if (stop != nullptr && *stop) return;
  const int warp = threadIdx.x / gt::kWarp, lane = threadIdx.x % gt::kWarp;
  const int dd = d * d;
  const int G = gt::kWarp / d;
  const int grp = lane / d, c = lane - grp * d;
  double* sl = slices[warp];
  const int nwarps = gridDim.x * kSolveWarps;
  for (int q = blockIdx.x * kSolveWarps + warp; q < J; q += nwarps) {
    const int64_t j = cols[q];
    const int db = dbid[q];
    double x = 0.0;
    if (db >= 0) {
      const int e0 = bptr[q], n = bptr[q + 1] - e0;
      const int cap = (kSlice - dd) / dd;
      const double* Ld = L + (int64_t)db * dd;
      for (int i = lane; i < dd; i += gt::kWarp) copy_async8(sl + i, Ld + i);
      stage_list(sl + dd, L, dd, bbid, e0, 0, min(n, cap), lane);
      const double rinv = lane < d ? 1.0 / Ld[lane * (d + 1)] : 1.0;
      // y: the forward launch's, written before this one
      const double yj = lane < d ? Y[j * d + lane] : 0.0;
      await_sources(flags, nflag, epoch, bsrc, e0, e0 + n, lane);
      asm volatile("cp.async.wait_all;" ::: "memory");
      __syncwarp();
      const double s = list_sum(sl + dd, cap, L, bbid, bsrc, e0, n, U, d, G,
                                grp, c, c, d, lane);
      x = yj - group_sum(s, G, d, c);
      for (int k = d - 1; k >= 0; --k) {
        if (lane == k) x *= rinv;
        const double xk = __shfl_sync(kFull, x, k);
        if (lane < k) x -= sl[k * d + lane] * xk;
      }
      const int r = xrow[q];
      if (lane < d) U[(int64_t)r * d + lane] = x;
      __syncwarp();
      if (lane == 0) st_release(flags + r, epoch);
    } else if (lane < d) {
      x = U[(int64_t)xrow[q] * d + lane];   // kernel 11's
    }
    if (lane < d) {
      const int m = out_map[j * d + lane];
      if (m >= 0) delta[m] = x;
    }
    __syncwarp();
  }
}

}  // namespace

// Every leading level's J columns (jobs in level order); store blocks of
// d x d (d <= 12); cols, cptr (J + 1), cblk, tptr, tik, tjk the plan's;
// wptr (J + 1), wsrc the columns each job waits on; A the assembled store
// (read), L the factor (written), rec (J) the pivot records; flags (nflag
// ints, one a column) set to epoch as each column is done.
GT_EXPORT int gt_sp_level_factor(int J, int d, int nflag, int epoch,
                                 const int* cols, const int* cptr,
                                 const int* cblk, const int* tptr,
                                 const int* tik, const int* tjk,
                                 const int* wptr, const int* wsrc,
                                 const double* A, const double* pad,
                                 double lam, double* L, int* rec, int* flags,
                                 void* stream) {
  if (d > kMaxD || nflag < 0) return (int)cudaErrorInvalidValue;
  if (J == 0) return 0;
  return gt::launch_levels(sp_level_factor_kernel, kFactorThreads, 1,
                           kFactorShm, J, (cudaStream_t)stream, J, d, epoch,
                           cols, cptr, cblk, tptr, tik, tjk, wptr, wsrc, A,
                           pad, lam, L, rec, flags);
}

// The dense root: T tail columns, M (T d x T d, rows ld apart); nb stored
// tail blocks, block e at tail position tpos[e] = r T + c (r >= c).
GT_EXPORT int gt_sp_tail_assemble(int T, int d, int ld, int nb,
                                  const int* tmap, const int* tbid,
                                  const int* tpos, const int* lptr,
                                  const int* lik, const int* ljk,
                                  const int* tcols, const double* A,
                                  const double* L, const double* pad,
                                  double lam, double* M, void* stream) {
  if (d > kMaxD) return (int)cudaErrorInvalidValue;
  const int blk_ctas = (nb + kTailWarps - 1) / kTailWarps;
  const int zero_ctas = (T * d + kTailWarps - 1) / kTailWarps;
  const int grid = blk_ctas + zero_ctas;
  const cudaStream_t st = (cudaStream_t)stream;
  if (grid > 0 && d == 6)
    sp_tail_assemble_kernel<6><<<grid, kTailThreads, 0, st>>>(
        T, d, ld, nb, blk_ctas, tmap, tbid, tpos, lptr, lik, ljk, tcols, A, L,
        pad, lam, M);
  else if (grid > 0)
    sp_tail_assemble_kernel<0><<<grid, kTailThreads, 0, st>>>(
        T, d, ld, nb, blk_ctas, tmap, tbid, tpos, lptr, lik, ljk, tcols, A, L,
        pad, lam, M);
  return (int)cudaGetLastError();
}

// J jobs of every level in the forward order: the first ndiag (the
// leading levels' columns) substitute and write rows of Y, each setting
// its column's flag (flags: nflag ints, a row of Y each) to epoch; the
// rest (the dense root's columns) write their right-hand sides to rt.
// rhs_map: null (rhs is the padded (n, d) g) or a map of (column,
// component) to rhs's entries (-1: zero); stop: null or the done word.
GT_EXPORT int gt_sp_level_forward(int J, int ndiag, int d, int nflag,
                                  int epoch, const int* cols,
                                  const int* orow, const int* dbid,
                                  const int* fptr, const int* fbid,
                                  const int* fsrc, const double* L,
                                  const double* rhs, const int* rhs_map,
                                  double* Y, double* rt, int* flags,
                                  const int* stop, void* stream) {
  if (d > kMaxD) return (int)cudaErrorInvalidValue;
  if (J == 0) return 0;
  return gt::launch_levels(sp_level_forward_kernel, kSolveThreads, 1, 0,
                           (J + kSolveWarps - 1) / kSolveWarps,
                           (cudaStream_t)stream, J, ndiag, d, nflag, epoch,
                           cols, orow, dbid, fptr, fbid, fsrc, L, rhs,
                           rhs_map, Y, rt, flags, stop);
}

// J jobs of every level in the backward order (the dense root's columns,
// dbid -1, only copied; their rows of U, at nflag and past, are kernel
// 11's); U: rows of d (x of every column), each leading row setting its
// flag to epoch; delta: the flat tangent vector.
GT_EXPORT int gt_sp_level_backward(int J, int d, int nflag, int epoch,
                                   const int* cols, const int* xrow,
                                   const int* dbid, const int* bptr,
                                   const int* bbid, const int* bsrc,
                                   const double* L, const double* Y,
                                   double* U, const int* out_map,
                                   double* delta, int* flags,
                                   const int* stop, void* stream) {
  if (d > kMaxD) return (int)cudaErrorInvalidValue;
  if (J == 0) return 0;
  return gt::launch_levels(sp_level_backward_kernel, kSolveThreads, 1, 0,
                           (J + kSolveWarps - 1) / kSolveWarps,
                           (cudaStream_t)stream, J, d, nflag, epoch, cols,
                           xrow, dbid, bptr, bbid, bsrc, L, Y, U, out_map,
                           delta, flags, stop);
}
