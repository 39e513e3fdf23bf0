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
//   but INIT, and the matvec, return at once where the done word is set, so
//   the host launches a fixed number of iterations between two reads of
//   it.
//
// No atomic sums: each dot product is summed per variable in component
// order (the matvec: by a butterfly), in the CTA by a warp butterfly and
// then warp by warp, and across CTAs in CTA order by the last one; the
// grid depends on the sizes only, so the same inputs give the same bits.
// Bound on the H100: bytes (the pool read once a matvec: ~2.9 MB on the
// sphere, ~1 us), far below a launch; the loop is bound by its launches
// (three an iteration with block-Jacobi).  The matvec's warps each walk a
// chain of dependent index loads (slot, factor, its slots, their
// variables) with every lane of a slot at work, 2,500 warps on the sphere
// over the whole card.
#include "ba_common.cuh"

namespace {

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

__global__ void __launch_bounds__(kVarThreads) pcg_matvec_kernel(
    int nv, int dmax, int rmax, const int* __restrict__ vptr,
    const int* __restrict__ vslot, const int* __restrict__ slot_fac,
    const int* __restrict__ fptr, const int* __restrict__ slot_var,
    const int* __restrict__ var_off, const int* __restrict__ var_dim,
    const double* __restrict__ pool, const double* __restrict__ p,
    double lam, double* __restrict__ Ap, double* part, int* ticket,
    double* st, const int* ist) {
  if (ist[kDone]) return;   // every CTA: the ticket stays untouched
  const int lane = threadIdx.x % gt::kWarp;
  const int v = blockIdx.x * kVarWarps + threadIdx.x / gt::kWarp;
  const int rd = rmax * dmax;
  const int S = max(rmax, dmax);         // lanes a slot
  const int K = gt::kWarp / S;           // slots a chunk
  const int i = lane / S, r = lane - i * S;
  const int i0 = i < K ? i : 0;          // lanes past the chunk: slot 0's
  double dot[1] = {0.0};
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
    if (lane == 0) dot[0] = pa;
  }
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

__global__ void __launch_bounds__(kVarThreads) pcg_step_kernel(
    int phase, int nv, int dmax, int ntot, const int* __restrict__ var_off,
    const int* __restrict__ var_dim, const double* __restrict__ diag,
    double* __restrict__ Minv, const double* __restrict__ g,
    double* __restrict__ x, double* __restrict__ r, double* __restrict__ z,
    double* __restrict__ p, const double* __restrict__ Ap, double lam,
    double tol, int max_it, int jacobi, int first, double* part,
    int* ticket, double* st, int* ist) {
  if (phase != kInit && ist[kDone]) return;   // every CTA
  if (phase == kDirection) {
    const int i = blockIdx.x * kVarThreads + threadIdx.x;
    if (i < ntot) p[i] = z[i] + st[kBeta] * p[i];
    return;
  }
  const int v = blockIdx.x * kVarThreads + threadIdx.x;
  double acc[2] = {0.0, 0.0};   // r.z, r.r
  if (v < nv) {
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
      const double alpha = st[kGamma] / fmax(st[kPAp], 1e-300);
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
  double sums[2];
  if (!last_cta<2>(acc, part, ticket, sums) || threadIdx.x != 0) return;
  const double rz = sums[0], rr = sums[1];
  if (phase == kInit) {
    st[kRR] = rr;
    st[kTol2] = tol * tol * fmax(rr, 1e-300);
    st[kBeta] = 0.0;
    if (jacobi) st[kGamma] = rz;
    ist[kIt] = 0;
    ist[kDone] = !(rr > st[kTol2]) || max_it <= 0;
  } else if (phase == kUpdate) {
    const int it = ist[kIt] + 1;
    ist[kIt] = it;
    st[kRR] = rr;
    if (jacobi) {
      st[kBeta] = rz / fmax(st[kGamma], 1e-300);
      st[kGamma] = rz;
    }
    ist[kDone] = !(rr > st[kTol2]) || it >= max_it;
  } else {
    st[kBeta] = first ? 0.0 : rz / fmax(st[kGamma], 1e-300);
    st[kGamma] = rz;
  }
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
