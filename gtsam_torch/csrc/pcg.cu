// Kernels 15 and 16: preconditioned conjugate gradients on the Gauss-Newton
// normal equations, matrix-free (float64).
//
// Replaces: gtsam_tpu/linear/pcg.py: PCGSolver.system's block-Jacobi
// diagonal (:57-85), _matvec (:87-97) and the while_loop body (:130-140,
// :228-238), which XLA runs as per-batch einsums, scatter-adds and dot
// products.
//
// The whitened Jacobian rows of every factor slot are a pool (Q, rmax,
// dmax), rows past a factor's rdim and columns past a variable's dimension
// zero; vectors are flat in the canonical tangent layout (variable v at
// var_off[v], var_dim[v] entries).  The plan (linear/pcg.py) lists each
// factor's slots (fptr) and each variable's slots (vptr, vslot) in a fixed
// order.
//
// gt_pcg_jacobi (kernel 15's second entry): a thread an entry (v, i, k) of
//   the diagonal: the sum over v's slots of column i of A_q times column k,
//   plus 1 on the padded diagonal.
// gt_pcg_matvec (kernel 15): a warp a variable v, whose slots it takes in
//   chunks of floor(32 / S) (S = max(rmax, dmax) lanes a slot), in order:
//   lane (i, r) of slot q = the chunk's i-th forms row r of u_f = the sum
//   of A_s p over the slots s of q's factor f (each factor's u is formed
//   once a slot of it, so a binary factor's twice), then lane (i, c) forms
//   component c of A_q^T u_f from the u rows by shuffles, and lane c adds
//   the chunk's slots' components in slot order (shuffles).  Ap_v = lam
//   p_v + that sum; p_v . Ap_v (a warp butterfly) goes into the CTA's
//   partial, and the last CTA (a completion ticket) sums the partials in
//   CTA order into st[PAP].
// gt_pcg_step (kernel 16): a thread a variable (DIRECTION: an entry), the
//   phase a launch argument: INIT (M^-1 of each variable's true block by
//   Gauss-Jordan with partial pivoting, x = 0, r = g, z, p, gamma, r.r, the
//   tolerance and the stop test), UPDATE (alpha from the state, x, r, z =
//   M^-1 r, r.z, r.r; the last CTA: beta, gamma, the iteration count, the
//   stop test into the done word), FINISH (r.z and beta with z from a
//   preconditioner outside) and DIRECTION (p = z + beta p).  Every phase
//   but INIT, and the matvec, return at once where the done word is set.
// gt_pcg_loop (kernel 16's loop): one cooperative launch that runs a group
//   of those phases (a bit mask: INIT, MATVEC, UPDATE, FINISH, DIRECTION)
//   in that order, and with `loop` again and again until the done word is
//   set: a block-Jacobi solve is one launch (INIT, then every iteration's
//   matvec, UPDATE and DIRECTION), the subgraph preconditioner's start
//   [INIT] and its iteration two ([MATVEC, UPDATE] and [FINISH,
//   DIRECTION]) around its tree solve.
//   The CTAs take the phases' chunks grid-stride: the matvec's chunks of 4
//   variables (a warp each) and the steps' chunks of 128 (a thread each),
//   the old launches' CTAs, with the same bodies (matvec_vars, step_vars);
//   each chunk writes its partial dot products, the grid syncs, and every
//   CTA sums the partials in chunk order as the old last CTA did and
//   updates its own copy of the state (update_state), so every CTA takes
//   the same alpha, beta and stop; CTA 0 writes the state back at the end.
//   Three grid syncs an iteration (after the matvec, UPDATE and DIRECTION).
//
// No atomic sums: each dot product is summed per variable in component
// order (the matvec: by a butterfly), in a chunk by a warp butterfly and
// then warp by warp, and across the chunks in chunk order (by the last CTA
// of a phase's launch, or by every CTA of the loop); the chunks depend on
// the sizes only, not on the grid, so the same inputs give the same bits,
// and the loop the phases' bits.  Bound on the H100: bytes (the pool read
// once a matvec: ~2.9 MB on the sphere, ~1 us); a phase a launch is bound
// by the launches (three an iteration with block-Jacobi, each behind a
// host wrapper call), the loop by its grid syncs and the matvec's chains.
// The matvec's warps each walk a chain of dependent index loads (slot,
// factor, its slots, their variables) with every lane of a slot at work,
// 2,500 warps on the sphere over the whole card.
#include <cooperative_groups.h>

#include "ba_common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxD = 12;
constexpr int kMaxR = 12;
constexpr int kVarThreads = 128;
constexpr int kVarWarps = kVarThreads / gt::kWarp;
constexpr int kInit = 0, kUpdate = 1, kFinish = 2, kDirection = 3;
constexpr unsigned kFull = 0xffffffffu;
// the state: st (doubles), ist (ints); linear/sparse_kernels.py holds the
// same indices
constexpr int kGamma = 0, kPAp = 1, kRR = 2, kTol2 = 3, kBeta = 4;
constexpr int kDone = 0, kIt = 1;
// gt_pcg_loop's phase bits (linear/sparse_kernels.py holds the same)
constexpr int kBitInit = 1, kBitMatvec = 2, kBitUpdate = 4, kBitFinish = 8,
              kBitDirection = 16;

// The sum of v over the CTA, in a fixed order; every thread gets it.
__device__ __forceinline__ double cta_sum(double v, double* sh) {
  v = gt::warp_sum(v);
  const int warp = threadIdx.x / gt::kWarp;
  __syncthreads();
  if ((threadIdx.x % gt::kWarp) == 0) sh[warp] = v;
  __syncthreads();
  double s = 0.0;
#pragma unroll
  for (int w = 0; w < kVarWarps; ++w) s += sh[w];
  return s;
}

// Each CTA's partial sums (n of them) to part[n * blockIdx + k]; true in
// the last CTA to finish, whose `sums` then hold the totals over the CTAs
// in CTA order (the ticket is reset for the next launch on the stream).
template <int n>
__device__ bool last_cta(double (&vals)[n], double* part, int* ticket,
                         double (&sums)[n]) {
  __shared__ double sh[kVarWarps];
  __shared__ bool last;
  for (int k = 0; k < n; ++k) vals[k] = cta_sum(vals[k], sh);
  if (threadIdx.x == 0) {
    for (int k = 0; k < n; ++k) part[n * blockIdx.x + k] = vals[k];
    __threadfence();  // the partials are visible before the ticket says so
    last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
  for (int k = 0; k < n; ++k) {
    double s = 0.0;
    for (int i = threadIdx.x; i < (int)gridDim.x; i += kVarThreads)
      s += __ldcg(part + n * i + k);  // from L2: written by other SMs
    sums[k] = cta_sum(s, sh);
  }
  if (threadIdx.x == 0) *ticket = 0;
  return true;
}

__global__ void __launch_bounds__(kVarThreads) pcg_jacobi_kernel(
    int nv, int dmax, int rmax, const int* __restrict__ vptr,
    const int* __restrict__ vslot, const int* __restrict__ var_dim,
    const double* __restrict__ pool, double* __restrict__ diag) {
  const int64_t t = (int64_t)blockIdx.x * kVarThreads + threadIdx.x;
  const int dd = dmax * dmax;
  if (t >= (int64_t)nv * dd) return;
  const int v = (int)(t / dd), ik = (int)(t % dd);
  const int i = ik / dmax, k = ik - i * dmax;
  double s = 0.0;
  for (int e = vptr[v]; e < vptr[v + 1]; ++e) {
    const double* A = pool + (int64_t)vslot[e] * rmax * dmax;
    double u = 0.0;
    for (int r = 0; r < rmax; ++r) u += A[r * dmax + i] * A[r * dmax + k];
    s += u;
  }
  if (i == k && i >= var_dim[v]) s += 1.0;
  diag[t] = s;
}

// Ap of matvec chunk c's variables (4, a warp each): the matvec's body.
// Returns p_v . Ap_v in lane 0 of variable v's warp (0 elsewhere).  p and
// Ap carry no __restrict__: the loop writes them in the same launch.
__device__ __forceinline__ double matvec_vars(
    int chunk, int nv, int dmax, int rmax, const int* __restrict__ vptr,
    const int* __restrict__ vslot, const int* __restrict__ slot_fac,
    const int* __restrict__ fptr, const int* __restrict__ slot_var,
    const int* __restrict__ var_off, const int* __restrict__ var_dim,
    const double* __restrict__ pool, const double* p, double lam,
    double* Ap) {
  const int lane = threadIdx.x % gt::kWarp;
  const int v = chunk * kVarWarps + threadIdx.x / gt::kWarp;
  const int rd = rmax * dmax;
  const int S = max(rmax, dmax);         // lanes a slot
  const int K = gt::kWarp / S;           // slots a chunk
  const int i = lane / S, r = lane - i * S;
  const int i0 = i < K ? i : 0;          // lanes past the chunk: slot 0's
  double dot = 0.0;
  if (v < nv) {
    const int e1 = vptr[v + 1];
    double y = 0.0;                      // lanes < dmax: component lane
    for (int e0 = vptr[v]; e0 < e1; e0 += K) {
      const bool live = i < K && e0 + i < e1;
      const int q = live ? vslot[e0 + i] : 0;
      double u = 0.0;                    // row r of u_f (r < rmax)
      if (live && r < rmax) {
        const int f = slot_fac[q];
        for (int s = fptr[f]; s < fptr[f + 1]; ++s) {
          const double* As = pool + (int64_t)s * rd + r * dmax;
          const int sv = slot_var[s];
          const double* ps = p + var_off[sv];
          const int ds = var_dim[sv];
          double t = 0.0;
          for (int c = 0; c < ds; ++c) t += As[c] * ps[c];
          u += t;
        }
      }
      // component r of A_q^T u_f (r < dmax)
      const double* Aq = pool + (int64_t)q * rd + r;
      double w = 0.0;
      for (int k = 0; k < rmax; ++k) {
        const double uk = __shfl_sync(kFull, u, i0 * S + k);
        if (live && r < dmax) w += Aq[k * dmax] * uk;
      }
      const int nk = min(K, e1 - e0);
      for (int k = 0; k < nk; ++k) y += __shfl_sync(kFull, w, k * S + r);
    }
    const int o = var_off[v], dv = var_dim[v];
    double pa = 0.0;
    if (lane < dv) {
      const double val = lam * p[o + lane] + y;
      Ap[o + lane] = val;
      pa = p[o + lane] * val;
    }
    pa = gt::warp_sum(pa);
    if (lane == 0) dot = pa;
  }
  return dot;
}

__global__ void __launch_bounds__(kVarThreads) pcg_matvec_kernel(
    int nv, int dmax, int rmax, const int* __restrict__ vptr,
    const int* __restrict__ vslot, const int* __restrict__ slot_fac,
    const int* __restrict__ fptr, const int* __restrict__ slot_var,
    const int* __restrict__ var_off, const int* __restrict__ var_dim,
    const double* __restrict__ pool, const double* p, double lam,
    double* Ap, double* part, int* ticket, double* st, const int* ist) {
  if (ist[kDone]) return;   // every CTA: the ticket stays untouched
  double dot[1] = {matvec_vars(blockIdx.x, nv, dmax, rmax, vptr, vslot,
                               slot_fac, fptr, slot_var, var_off, var_dim,
                               pool, p, lam, Ap)};
  double sums[1];
  if (last_cta<1>(dot, part, ticket, sums) && threadIdx.x == 0)
    st[kPAp] = sums[0];
}

// M^-1 of one variable's true block (diag + lam I, dv x dv) by
// Gauss-Jordan with partial pivoting, into Minv (dmax x dmax, zero outside
// the block).
__device__ void invert_block(const double* __restrict__ D, int dmax, int dv,
                             double lam, double* __restrict__ Minv) {
  double a[kMaxD][kMaxD], b[kMaxD][kMaxD];
  for (int i = 0; i < dv; ++i)
    for (int k = 0; k < dv; ++k) {
      a[i][k] = D[i * dmax + k] + (i == k ? lam : 0.0);
      b[i][k] = i == k ? 1.0 : 0.0;
    }
  for (int k = 0; k < dv; ++k) {
    int piv = k;
    for (int i = k + 1; i < dv; ++i)
      if (fabs(a[i][k]) > fabs(a[piv][k])) piv = i;
    if (piv != k)
      for (int c = 0; c < dv; ++c) {
        double t = a[k][c]; a[k][c] = a[piv][c]; a[piv][c] = t;
        t = b[k][c]; b[k][c] = b[piv][c]; b[piv][c] = t;
      }
    const double inv = 1.0 / a[k][k];
    for (int c = 0; c < dv; ++c) {
      a[k][c] *= inv;
      b[k][c] *= inv;
    }
    for (int i = 0; i < dv; ++i) {
      if (i == k) continue;
      const double f = a[i][k];
      for (int c = 0; c < dv; ++c) {
        a[i][c] -= f * a[k][c];
        b[i][c] -= f * b[k][c];
      }
    }
  }
  for (int i = 0; i < dmax; ++i)
    for (int k = 0; k < dmax; ++k)
      Minv[i * dmax + k] = i < dv && k < dv ? b[i][k] : 0.0;
}

// The CG state, as st and ist hold it.
struct State {
  double gamma, pap, rr, tol2, beta;
  int done, it;
};

__device__ __forceinline__ State load_state(const double* st,
                                            const int* ist) {
  return {st[kGamma], st[kPAp], st[kRR], st[kTol2], st[kBeta], ist[kDone],
          ist[kIt]};
}

__device__ __forceinline__ void store_state(const State& s, double* st,
                                            int* ist) {
  st[kGamma] = s.gamma;
  st[kPAp] = s.pap;
  st[kRR] = s.rr;
  st[kTol2] = s.tol2;
  st[kBeta] = s.beta;
  ist[kDone] = s.done;
  ist[kIt] = s.it;
}

// A phase's variable part for step chunk c's variables (128, a thread
// each): INIT, UPDATE (alpha from the state) or FINISH; acc gets the
// thread's r.z and r.r.  x, r, z, p, Ap and Minv carry no __restrict__:
// the loop writes them in the same launch.
__device__ __forceinline__ void step_vars(
    int phase, int chunk, int nv, int dmax,
    const int* __restrict__ var_off,
    const int* __restrict__ var_dim, const double* __restrict__ diag,
    double* Minv, const double* __restrict__ g, double* x, double* r,
    double* z, double* p, const double* Ap, double lam, int jacobi,
    double alpha, double (&acc)[2]) {
  const int v = chunk * kVarThreads + threadIdx.x;
  acc[0] = acc[1] = 0.0;   // r.z, r.r
  if (v >= nv) return;
  const int o = var_off[v], dv = var_dim[v];
  const double* Mv = Minv + (int64_t)v * dmax * dmax;
  double rv[kMaxD];
  if (phase == kInit) {
    if (jacobi) invert_block(diag + (int64_t)v * dmax * dmax, dmax, dv, lam,
                             Minv + (int64_t)v * dmax * dmax);
#pragma unroll
    for (int c = 0; c < kMaxD; ++c) {
      if (c < dv) {
        rv[c] = g[o + c];
        x[o + c] = 0.0;
        r[o + c] = rv[c];
        if (!jacobi) p[o + c] = 0.0;
      }
    }
  } else if (phase == kUpdate) {
#pragma unroll
    for (int c = 0; c < kMaxD; ++c) {
      if (c < dv) {
        x[o + c] += alpha * p[o + c];
        rv[c] = r[o + c] - alpha * Ap[o + c];
        r[o + c] = rv[c];
      }
    }
  } else {   // kFinish: z from the preconditioner outside
#pragma unroll
    for (int c = 0; c < kMaxD; ++c)
      if (c < dv) acc[0] += r[o + c] * z[o + c];
  }
  if (phase != kFinish) {
#pragma unroll
    for (int c = 0; c < kMaxD; ++c)
      if (c < dv) acc[1] += rv[c] * rv[c];
    if (jacobi) {
#pragma unroll
      for (int c = 0; c < kMaxD; ++c) {
        if (c < dv) {
          double s = 0.0;
#pragma unroll
          for (int k = 0; k < kMaxD; ++k)
            if (k < dv) s += Mv[c * dmax + k] * rv[k];
          z[o + c] = s;
          if (phase == kInit) p[o + c] = s;
          acc[0] += rv[c] * s;
        }
      }
    }
  }
}

// The state after a phase whose sums over the variables are rz (r.z) and
// rr (r.r): the tolerance, beta, gamma, the iteration count and the stop.
__device__ __forceinline__ void update_state(int phase, double rz, double rr,
                                             double tol, int max_it,
                                             int jacobi, int first,
                                             State& s) {
  if (phase == kInit) {
    s.rr = rr;
    s.tol2 = tol * tol * fmax(rr, 1e-300);
    s.beta = 0.0;
    if (jacobi) s.gamma = rz;
    s.it = 0;
    s.done = !(rr > s.tol2) || max_it <= 0;
  } else if (phase == kUpdate) {
    s.it += 1;
    s.rr = rr;
    if (jacobi) {
      s.beta = rz / fmax(s.gamma, 1e-300);
      s.gamma = rz;
    }
    s.done = !(rr > s.tol2) || s.it >= max_it;
  } else {
    s.beta = first ? 0.0 : rz / fmax(s.gamma, 1e-300);
    s.gamma = rz;
  }
}

__global__ void __launch_bounds__(kVarThreads) pcg_step_kernel(
    int phase, int nv, int dmax, int ntot, const int* __restrict__ var_off,
    const int* __restrict__ var_dim, const double* __restrict__ diag,
    double* Minv, const double* __restrict__ g, double* x, double* r,
    double* z, double* p, const double* Ap, double lam, double tol,
    int max_it, int jacobi, int first, double* part, int* ticket, double* st,
    int* ist) {
  if (phase != kInit && ist[kDone]) return;   // every CTA
  if (phase == kDirection) {
    const int i = blockIdx.x * kVarThreads + threadIdx.x;
    if (i < ntot) p[i] = z[i] + st[kBeta] * p[i];
    return;
  }
  double acc[2];
  step_vars(phase, blockIdx.x, nv, dmax, var_off, var_dim, diag, Minv, g, x,
            r, z, p, Ap, lam, jacobi,
            phase == kUpdate ? st[kGamma] / fmax(st[kPAp], 1e-300) : 0.0,
            acc);
  double sums[2];
  if (!last_cta<2>(acc, part, ticket, sums) || threadIdx.x != 0) return;
  State s = load_state(st, ist);
  update_state(phase, sums[0], sums[1], tol, max_it, jacobi, first, s);
  store_state(s, st, ist);
}

// The sum of the n-wide partials part[n * i + k] over the chunks i <
// nchunk, in the order the last CTA of a phase's launch sums them; every
// thread gets it.
__device__ __forceinline__ double chunk_total(const double* part, int n,
                                              int k, int nchunk,
                                              double* sh) {
  double s = 0.0;
  for (int i = threadIdx.x; i < nchunk; i += kVarThreads)
    s += __ldcg(part + n * i + k);   // from L2: written by other SMs
  return cta_sum(s, sh);
}

__global__ void __launch_bounds__(kVarThreads) pcg_loop_kernel(
    int groups, int loop, int nv, int dmax, int rmax, int ntot,
    const int* __restrict__ vptr, const int* __restrict__ vslot,
    const int* __restrict__ slot_fac, const int* __restrict__ fptr,
    const int* __restrict__ slot_var, const int* __restrict__ var_off,
    const int* __restrict__ var_dim, const double* __restrict__ pool,
    const double* __restrict__ diag, double* Minv,
    const double* __restrict__ g, double* x, double* r, double* z, double* p,
    double* Ap, double lam, double tol, int max_it, int jacobi, int first,
    double* part, double* st, int* ist) {
  __shared__ double sh[kVarWarps];
  cg::grid_group grid = cg::this_grid();
  const int nmv = max((nv + kVarWarps - 1) / kVarWarps, 1);
  const int nst = max((nv + kVarThreads - 1) / kVarThreads, 1);
  double* pmv = part;          // a partial a matvec chunk
  double* pst = part + nmv;    // two a step chunk
  State s;
  double acc[2];
  // one phase of step_vars over every step chunk, its partials summed by
  // every CTA into its state
  auto step = [&](int phase, double alpha) {
    for (int c = blockIdx.x; c < nst; c += gridDim.x) {
      step_vars(phase, c, nv, dmax, var_off, var_dim, diag, Minv, g, x, r, z,
                p, Ap, lam, jacobi, alpha, acc);
      const double rz = cta_sum(acc[0], sh), rr = cta_sum(acc[1], sh);
      if (threadIdx.x == 0) {
        pst[2 * c] = rz;
        pst[2 * c + 1] = rr;
      }
    }
    grid.sync();
    const double rz = chunk_total(pst, 2, 0, nst, sh);
    const double rr = chunk_total(pst, 2, 1, nst, sh);
    update_state(phase, rz, rr, tol, max_it, jacobi, first, s);
  };
  if (groups & kBitInit) {
    s = load_state(st, ist);
    step(kInit, 0.0);
  } else {
    s = load_state(st, ist);   // the launch before this one wrote it
    if (s.done) return;        // every CTA, before any sync
  }
  while (!s.done) {
    if (groups & kBitMatvec) {
      for (int c = blockIdx.x; c < nmv; c += gridDim.x) {
        const double d = cta_sum(
            matvec_vars(c, nv, dmax, rmax, vptr, vslot, slot_fac, fptr,
                        slot_var, var_off, var_dim, pool, p, lam, Ap), sh);
        if (threadIdx.x == 0) pmv[c] = d;
      }
      grid.sync();
      s.pap = chunk_total(pmv, 1, 0, nmv, sh);
    }
    if (groups & kBitUpdate) {
      step(kUpdate, s.gamma / fmax(s.pap, 1e-300));
      if (s.done) break;       // the phases after it return at once
    }
    if (groups & kBitFinish) step(kFinish, 0.0);
    if (groups & kBitDirection) {
      const int stride = gridDim.x * kVarThreads;
      for (int i = blockIdx.x * kVarThreads + threadIdx.x; i < ntot;
           i += stride)
        p[i] = z[i] + s.beta * p[i];
      if (loop) grid.sync();   // the next matvec reads p
    }
    if (!loop) break;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) store_state(s, st, ist);
}

int var_grid(int n) { return (n + kVarThreads - 1) / kVarThreads; }

}  // namespace

// nv variables, the pool (Q x rmax x dmax), diag (nv x dmax x dmax).
GT_EXPORT int gt_pcg_jacobi(int nv, int dmax, int rmax, const int* vptr,
                            const int* vslot, const int* var_dim,
                            const double* pool, double* diag, void* stream) {
  if (dmax > kMaxD || rmax > kMaxR) return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)nv * dmax * dmax;
  if (n > 0)
    pcg_jacobi_kernel<<<(unsigned)((n + kVarThreads - 1) / kVarThreads),
                        kVarThreads, 0, (cudaStream_t)stream>>>(
        nv, dmax, rmax, vptr, vslot, var_dim, pool, diag);
  return (int)cudaGetLastError();
}

// Ap = (J^T J + lam) p and st[PAP] = p.Ap; part: a partial a CTA
// (ceil(nv / 4)), ticket: zero between launches.
GT_EXPORT int gt_pcg_matvec(int nv, int dmax, int rmax, const int* vptr,
                            const int* vslot, const int* slot_fac,
                            const int* fptr, const int* slot_var,
                            const int* var_off, const int* var_dim,
                            const double* pool, const double* p, double lam,
                            double* Ap, double* part, int* ticket, double* st,
                            const int* ist, void* stream) {
  if (dmax > kMaxD || rmax > kMaxR) return (int)cudaErrorInvalidValue;
  pcg_matvec_kernel<<<max((nv + kVarWarps - 1) / kVarWarps, 1),
                      kVarThreads, 0, (cudaStream_t)stream>>>(
      nv, dmax, rmax, vptr, vslot, slot_fac, fptr, slot_var, var_off,
      var_dim, pool, p, lam, Ap, part, ticket, st, ist);
  return (int)cudaGetLastError();
}

// One phase of the CG loop over nv variables (ntot flat entries); part:
// two partials a CTA (2 ceil(nv / 128)).
GT_EXPORT int gt_pcg_step(int phase, int nv, int dmax, int ntot,
                          const int* var_off, const int* var_dim,
                          const double* diag, double* Minv, const double* g,
                          double* x, double* r, double* z, double* p,
                          const double* Ap, double lam, double tol,
                          int max_it, int jacobi, int first, double* part,
                          int* ticket, double* st, int* ist, void* stream) {
  if (dmax > kMaxD) return (int)cudaErrorInvalidValue;
  const int grid = max(phase == kDirection ? var_grid(ntot) : var_grid(nv),
                       1);
  pcg_step_kernel<<<grid, kVarThreads, 0, (cudaStream_t)stream>>>(
      phase, nv, dmax, ntot, var_off, var_dim, diag, Minv, g, x, r, z, p, Ap,
      lam, tol, max_it, jacobi, first, part, ticket, st, ist);
  return (int)cudaGetLastError();
}

// A group of the CG loop's phases (groups: kBit* bits, run in the order
// INIT, MATVEC, UPDATE, FINISH, DIRECTION; with loop, again until the done
// word is set) in one cooperative launch over nv variables (ntot flat
// entries); the matvec's plan and pool as gt_pcg_matvec's, the steps'
// vectors as gt_pcg_step's; part: ceil(nv / 4) + 2 ceil(nv / 128)
// partials.  The grid is as many CTAs as the card holds at once, up to the
// most chunks of a phase.
GT_EXPORT int gt_pcg_loop(int groups, int loop, int nv, int dmax, int rmax,
                          int ntot, const int* vptr, const int* vslot,
                          const int* slot_fac, const int* fptr,
                          const int* slot_var, const int* var_off,
                          const int* var_dim, const double* pool,
                          const double* diag, double* Minv, const double* g,
                          double* x, double* r, double* z, double* p,
                          double* Ap, double lam, double tol, int max_it,
                          int jacobi, int first, double* part, double* st,
                          int* ist, void* stream) {
  if (dmax > kMaxD || rmax > kMaxR) return (int)cudaErrorInvalidValue;
  if (loop && !(groups & kBitUpdate)) return (int)cudaErrorInvalidValue;
  const int most = max(max((nv + kVarWarps - 1) / kVarWarps, var_grid(nv)),
                       max(var_grid(ntot), 1));
  return gt::launch_levels(pcg_loop_kernel, kVarThreads, 1, 0, most,
                           (cudaStream_t)stream, groups, loop, nv, dmax, rmax,
                           ntot, vptr, vslot, slot_fac, fptr, slot_var,
                           var_off, var_dim, pool, diag, Minv, g, x, r, z, p,
                           Ap, lam, tol, max_it, jacobi, first, part, st, ist);
}
