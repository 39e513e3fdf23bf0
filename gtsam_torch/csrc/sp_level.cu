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
// No atomics: every sum runs in an order fixed by the plan, so a launch
// gives the same bits on every run.  Bound on the H100: at the sphere's
// sizes a level's bytes are ~0.1-5 MB and its FLOPs (2 d^3 a triple) ~0.05-
// 0.2 GFLOP, a few microseconds at 3.35 TB/s or 34 TFLOP/s; kernel 13's
// launches (one a level) and the chains of dependent loads bound it, and
// the few-column levels run on a few SMs.  Kernel 14 moves ~10 MB a
// direction (3 us): the chain of its levels (38 hand-offs through L2 on
// the sphere) bounds it.
#include "ba_common.cuh"

namespace {

constexpr int kMaxD = 12;
constexpr int kFactorThreads = 128;      // kernel 13: a CTA a column
constexpr int kFactorWarps = kFactorThreads / gt::kWarp;
constexpr int kTailThreads = 256;        // a warp a block of M
constexpr int kSolveThreads = 128;       // kernel 14: a warp a job
constexpr int kSolveWarps = kSolveThreads / gt::kWarp;
constexpr int kSlice = 1024;             // doubles of shared memory a warp
constexpr int kBatch = 8;                // list blocks a group a trip to L2
constexpr long long kStall = 4000000000LL;
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

__device__ __forceinline__ void copy_async8(double* dst, const double* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(d), "l"(src)
               : "memory");
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
