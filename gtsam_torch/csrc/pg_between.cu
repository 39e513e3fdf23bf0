// Kernel 6: SE3 between / prior factors of the pose graph -- linearization,
// block-store assembly and the half-chi2 (float64 throughout), with robust
// losses and constrained noise.
//
// Replaces: gtsam_tpu/graph/factors.py::linearize (:147-176, via jacfwd of
// _between_residual :186 and _prior_residual :208) for SE3 batches, the
// assembly of gtsam_tpu/linear/supernodal.py::system (:320-368), and
// gtsam_tpu/graph/graph.py::BoundGraph.error (:108-126) for those batches.
//
// The factor math: with r = Log(Z^-1 Ti^-1 Tj),
//   A_j = R_w Jr^-1(r),  A_i = -R_w Jr^-1(r) Ad(Tj^-1 Ti),  b = -R_w r
// (a prior: A = R_w Jr^-1(r) with r = Log(Z^-1 Ti)), Jr^-1 the exact SE(3)
// right-Jacobian inverse with its Q(omega, v) block, Taylor series below
// theta^2 = 5e-3 (gtsam_torch/geometry/se3.py::right_jacobian_inverse, the
// plain version's formulas).  R_w is unit, diagonal or a full 6x6 square-root
// information, one model for the batch (stride 0) or one a factor.
//
// gt_pg_linearize: a CTA is one warp and owns 16 consecutive factors, a
// lane pair each (3 CTAs for 50 factors; 310 for the sphere stand-in's
// 4,949, so every SM takes two or three).  The CTA's noise models are
// copied to shared memory by cp.async at the start, while phase 1 runs.
// Phase 1: both lanes of a pair compute r and Jr^-1 (the sequential part:
// compose, SO(3) log, the coefficients), then each forms one whitened
// Jacobian in registers, A = sgn R_w Jr^-1 Ad(P): lane 0 A_j (P = I, sgn
// 1; a prior's A) and b, lane 1 A_i (P = Tj^-1 Ti, sgn -1), with the same
// instructions, and leaves a copy in shared memory (79 doubles a factor:
// an odd stride keeps a half-warp's lanes on distinct banks); a ballot
// gathers the flips.  Phase 2: each lane computes the Gram block of its
// own Jacobian (sign A^T A, from registers, one triangle mirrored) and its
// gv row (sign A^T b), and three rows of the pair's (0, 1) block (sign
// A_i^T A_j, out of shared memory), and writes them, compact, over the
// Jacobians (121 doubles a factor, once every lane has read them).  Then
// the CTA copies its span of H ((N, npair, d*d), factor-major, the (0, 1)
// block transposed where flip says the plan stores it so, zero outside
// the leading 6x6) and of gv ((N, arity, d)) out: lane l takes entry q =
// l, l + 32, ... of every factor's blocks, its place in the buffer worked
// out once, so a store instruction writes 256 contiguous bytes of one
// factor's span (whole 32-byte sectors at d = 6).  The first design (a
// thread a factor, 128-thread CTAs: 39 at the sphere) stored each
// factor's 960 bytes from one thread; a lane an entry of the span, each a
// 6-term dot product out of shared memory, spent half the kernel's time
// in those loads and the entries' index arithmetic
// (scripts/port_pg_probe.py).
// gt_pg_assemble (replaces system's segment sums and scatter, :352-367):
// one launch over H's own blocks T (the store rows that receive a
// contribution, and the diagonal blocks; the plan's asm_blk) and g.  A warp
// takes one block of T: lane l owns entries l, l + 32, ... of it, so each
// 288-byte contribution row (d = 6) is read with coalesced loads, summed in
// the plan's asm_ptr order (four rows' loads in flight), the identity of
// the padded dimensions added on the diagonal, and the block written with
// whole-line stores.  Thread blocks past T's take g, a thread per entry.
// Indices are 32-bit, from the block and warp ids; the grid follows |T| and
// n, never the store's B rows.  The store's fill (zero by the solver's
// invariant, supernodal.py) is neither read nor written.  No atomics: the
// same bits on every run.
// gt_pg_error: a grid over the factors, as bal_linearize.cu's half-chi2.
// A CTA is one warp, a factor a lane; the warp sums its lanes' ||R_w r||^2
// by a butterfly and writes its partial.  The CTA that finds, through
// __threadfence and an atomic ticket, that it finished last sums all
// partials in index order (a fixed strided split over its lanes, then the
// butterfly), writes sign * 0.5 * sum and resets the ticket to 0.  The
// grid is ceil(N / 32), a function of N alone, so the order of every
// addition is too and two calls give the same bits; no value is summed by
// atomics.  The first design ran one 512-thread CTA on one SM.
//
// The loss branch (robust losses, IRLS; gtsam_tpu/graph/factors.py:167-171
// and base/noise.py:83-98): both kernels take a loss code (enum Loss, the
// CODES of gtsam_torch/base/losses.py; 0: none) and its parameter.  Each
// kernel is a template on whether the batch has a loss (the error's also
// on constrained noise), so the loss-free launch runs the code it ran
// before the branch: a first design with the branch inline cost the
// loss-free calls 0.3-0.9 us a launch on an H100 (scripts/port_pg_probe.py
// against the older source).  Inside the robust instantiation the loss
// is a runtime switch on a grid-uniform value (no divergence) in two
// __noinline__ functions, loss_weight and loss_rho (pg_losses.cuh, which
// the Pose2 variant in pg_pose2.cu shares); a template per loss
// would make ten copies of each kernel.  ptxas on sm_90a: 164 registers
// (linearize) and 80 (error), 0 spills, in every instantiation.  In
// linearize lane 0 of a pair, which whitens r, takes sqrt(w(||R_w r||))
// and hands it to lane 1 by __shfl_sync; each lane scales its whitened
// Jacobian M, and lane 0 its b, before they go to shared memory, so phase
// 2's Gram products and the (0, 1) block carry w with no change.  A weight of 0 (Tukey beyond c, a GNC outlier) leaves
// zero blocks.  In the error each lane's value is twice its factor's
// error: ||R_w r||^2, 2 rho(||R_w r||) under a loss, or ||R_w r||^2 +
// mu r^2 over the hard rows of kind 3, constrained noise (a diagonal
// whose zeros mark hard rows; linearize whitens it as a diagonal, so the
// hard rows are zero, as the JAX package's whiten gives them); the last
// CTA's 0.5 stays the one halving, and doubling is exact, so the
// loss-free path's bits are unchanged.
//
// Bound on the H100: linearize by bytes, ~1.3 KB a between factor (H and
// gv written: 1,056 bytes at d = 6) against ~3,200 FP64 operations; error
// by bytes too (~0.3 KB read a factor), though at the sphere's size both
// are a few microseconds of a launch's latency and one factor's chain of
// dependent FP64 operations (the SO(3) log's atan2, sin and cos);
// assemble by bytes: T's contribution rows read and T's blocks written
// once (sphere stand-in: 14,848 and 7,449 rows of 288 B, ~6.7 MB with g
// and the indices, ~0.002 ms at 3.35 TB/s), where the first design wrote
// the whole 36 MB store on every call.
#include "pg_losses.cuh"

namespace {

using namespace pg;

constexpr int kLinFactors = 16;                // factors a CTA of linearize
constexpr int kLinThreads = 2 * kLinFactors;   // a lane pair a factor: a warp
constexpr int kSlot = 36;                      // a 6x6 Jacobian
constexpr int kFactorDoubles = 2 * kSlot + 7;  // A_0, A_1, b; odd
constexpr int kOutDoubles = 3 * kSlot + 13;    // 3 blocks, 2 gv rows; odd
constexpr int kErrorThreads = gt::kWarp;       // ERROR_BLOCK (Python)
constexpr int kMaxD = 12;                      // store width d <= 12
constexpr double kSmall = 1e-10;     // so3.py _SMALL (theta^2)
constexpr double kJrSmall = 5e-3;    // se3.py _JR_SMALL (theta^2)

struct Pose {
  double R[9];
  double t[3];
};

__device__ __forceinline__ void load_pose(const double* R, const double* t,
                                          int64_t k, Pose& p) {
#pragma unroll
  for (int i = 0; i < 9; ++i) p.R[i] = R[9 * k + i];
#pragma unroll
  for (int i = 0; i < 3; ++i) p.t[i] = t[3 * k + i];
}

// a^T b (3x3, row-major)
__device__ __forceinline__ void mtm(const double* a, const double* b,
                                    double* c) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      c[3 * i + j] = a[i] * b[j] + a[3 + i] * b[3 + j] + a[6 + i] * b[6 + j];
}

__device__ __forceinline__ void mm3(const double* a, const double* b,
                                    double* c) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      c[3 * i + j] = a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j] +
                     a[3 * i + 2] * b[6 + j];
}

// a^T v
__device__ __forceinline__ void mtv(const double* a, const double* v,
                                    double* o) {
#pragma unroll
  for (int i = 0; i < 3; ++i) o[i] = a[i] * v[0] + a[3 + i] * v[1] + a[6 + i] * v[2];
}

// between(A, B) = A^-1 B: R = Ra^T Rb, t = Ra^T tb - Ra^T ta (se3.py order)
__device__ __forceinline__ void between(const Pose& a, const Pose& b, Pose& o) {
  mtm(a.R, b.R, o.R);
  double u[3], w[3];
  mtv(a.R, b.t, u);
  mtv(a.R, a.t, w);
#pragma unroll
  for (int i = 0; i < 3; ++i) o.t[i] = u[i] + (-w[i]);
}

__device__ __forceinline__ void hat(const double* w, double* W) {
  W[0] = 0.0;   W[1] = -w[2]; W[2] = w[1];
  W[3] = w[2];  W[4] = 0.0;   W[5] = -w[0];
  W[6] = -w[1]; W[7] = w[0];  W[8] = 0.0;
}

// so3.py logmap: Shepperd's quaternion, then 2 atan2(|v|, w) v / |v|
__device__ void so3_log(const double* m, double* w) {
  const double m00 = m[0], m01 = m[1], m02 = m[2];
  const double m10 = m[3], m11 = m[4], m12 = m[5];
  const double m20 = m[6], m21 = m[7], m22 = m[8];
  const double tr = m00 + m11 + m22;
  double p, a, b, c, e;
  if (tr > 0.0) {
    p = 1.0 + tr; a = p; b = m21 - m12; c = m02 - m20; e = m10 - m01;
  } else if (m00 > m11 && m00 > m22) {
    p = 1.0 + m00 - m11 - m22; a = m21 - m12; b = p; c = m01 + m10; e = m02 + m20;
  } else if (m11 > m22) {
    p = 1.0 - m00 + m11 - m22; a = m02 - m20; b = m01 + m10; c = p; e = m12 + m21;
  } else {
    p = 1.0 - m00 - m11 + m22; a = m10 - m01; b = m02 + m20; c = m12 + m21; e = p;
  }
  const double s = sqrt(fmax(p, 1e-30)) * 2.0;
  double q0 = a / s, q1 = b / s, q2 = c / s, q3 = e / s;
  const double nq = sqrt(q0 * q0 + q1 * q1 + q2 * q2 + q3 * q3);
  q0 /= nq; q1 /= nq; q2 /= nq; q3 /= nq;
  const double sg = q0 < 0.0 ? -1.0 : 1.0;
  const double qw = q0 * sg;
  const double v0 = q1 * sg, v1 = q2 * sg, v2 = q3 * sg;
  const double nv2 = v0 * v0 + v1 * v1 + v2 * v2;
  double scale;
  if (nv2 < kSmall) {
    scale = 2.0 / fmax(qw, 1e-30) * (1.0 + nv2 / 3.0);
  } else {
    const double nv = sqrt(nv2);
    scale = 2.0 * atan2(nv, qw) / nv;
  }
  w[0] = v0 * scale; w[1] = v1 * scale; w[2] = v2 * scale;
}

// se3.py logmap: [w; Jl^-1(w) t], Jl^-1 = I - W/2 + E W^2 (so3.py)
__device__ void se3_log(const Pose& T, double* xi) {
  double w[3];
  so3_log(T.R, w);
  const double th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  double E;
  if (th2 < kSmall) {
    E = 1.0 / 12.0 + th2 / 720.0;
  } else {
    const double th = sqrt(th2);
    double sn, cs;
    sincos(th, &sn, &cs);
    const double A = sn / th;
    const double B = (1.0 - cs) / th2;
    E = (1.0 - 0.5 * A / B) / th2;
  }
  double W[9], WW[9];
  hat(w, W);
  mm3(W, W, WW);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    double acc = 0.0;
#pragma unroll
    for (int j = 0; j < 3; ++j)
      acc += ((i == j ? 1.0 : 0.0) - 0.5 * W[3 * i + j] + E * WW[3 * i + j]) *
             T.t[j];
    xi[3 + i] = acc;
    xi[i] = w[i];
  }
}

// r and, for a between factor, Tj^-1 Ti
__device__ __forceinline__ void residual(const double* R, const double* t,
                                         const int* rows, const double* ZR,
                                         const double* Zt, int arity,
                                         int64_t k, double* r, Pose& Tji) {
  Pose Ti, Z, E;
  load_pose(R, t, rows[arity * k], Ti);
  load_pose(ZR, Zt, k, Z);
  if (arity == 2) {
    Pose Tj, Tij;
    load_pose(R, t, rows[arity * k + 1], Tj);
    between(Ti, Tj, Tij);
    between(Z, Tij, E);
    between(Tj, Ti, Tji);
  } else {
    between(Z, Ti, E);
  }
  se3_log(E, r);
}

// R_w x for x (6,) -> out (6,)
__device__ __forceinline__ void whiten_vec(int kind, const double* nz,
                                           const double* x, double* o) {
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    if (kind == 0) {
      o[i] = x[i];
    } else if (kind == 1) {
      o[i] = x[i] * nz[i];
    } else {
      double acc = 0.0;
#pragma unroll
      for (int j = 0; j < 6; ++j) acc += nz[6 * i + j] * x[j];
      o[i] = acc;
    }
  }
}

// Jr^-1 blocks: Jw (3x3) and Q2 = -Jw Q Jw (se3.py right_jacobian_inverse)
__device__ void jr_inverse(const double* xi, double* Jw, double* Q2) {
  const double* w = xi;
  const double* v = xi + 3;
  const double x = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  double a1, a2, a3, E;
  if (x < kJrSmall) {
    // the plain version's series in Horner form, by constant reciprocals:
    // no division on the chain (0.6 us of a sphere launch on an H100,
    // scripts/port_pg_probe.py)
    a1 = 1.0 / 6 + x * (-1.0 / 120 + x * (1.0 / 5040 - x * (1.0 / 362880)));
    a2 = 1.0 / 24 + x * (-1.0 / 720 + x * (1.0 / 40320 - x * (1.0 / 3628800)));
    a3 = 1.0 / 120 +
         x * (-1.0 / 2520 + x * (1.0 / 120960 - x * (1.0 / 9979200)));
    E = 1.0 / 12 + x * (1.0 / 720 + x * (1.0 / 30240 + x * (1.0 / 1209600)));
  } else {
    const double th = sqrt(x);
    double s, c, sh, ch;
    sincos(th, &s, &c);
    sincos(0.5 * th, &sh, &ch);
    a1 = (th - s) / (x * th);
    a2 = (x + 2 * c - 2) / (2 * x * x);
    a3 = (2 * th - 3 * s + th * c) / (2 * x * x * th);
    E = 1 / x - ch / (2 * th * sh);
  }
  double W[9], V[9], WW[9], WV[9], VW[9], WVW[9], T1[9], T2[9], Q[9];
  hat(w, W);
  hat(v, V);
  mm3(W, W, WW);
  mm3(W, V, WV);
  mm3(V, W, VW);
  mm3(WV, W, WVW);
  mm3(W, WV, T1);    // W W V
  mm3(VW, W, T2);    // V W W
  double T3[9], T4[9];
  mm3(WVW, W, T3);   // W V W W
  mm3(W, WVW, T4);   // W W V W
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    Q[i] = -0.5 * V[i] + a1 * (WV[i] + VW[i] - WVW[i]) -
           a2 * (T1[i] + T2[i] - 3 * WVW[i]) + a3 * (T3[i] + T4[i]);
    Jw[i] = ((i % 4 == 0) ? 1.0 : 0.0) + 0.5 * W[i] + E * WW[i];
  }
  double JQ[9];
  mm3(Jw, Q, JQ);
  mm3(JQ, Jw, Q2);
#pragma unroll
  for (int i = 0; i < 9; ++i) Q2[i] = -Q2[i];
}

// out (6x6, row-major) = R_w A for A = sgn [[D, 0], [C, D]] (D, C 3x3)
__device__ __forceinline__ void whiten_into(int kind, const double* nz,
                                            const double* D, const double* C,
                                            double sgn, double* out) {
  double A[36];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      A[6 * i + j] = sgn * D[3 * i + j];
      A[6 * i + 3 + j] = 0.0;
      A[6 * (3 + i) + j] = sgn * C[3 * i + j];
      A[6 * (3 + i) + 3 + j] = sgn * D[3 * i + j];
    }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    double w[6];
    if (kind == 2) {
#pragma unroll
      for (int l = 0; l < 6; ++l) w[l] = nz[6 * i + l];
    }
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      double v = A[6 * i + j];
      if (kind == 1) {
        v *= nz[i];
      } else if (kind == 2) {
        v = 0.0;
#pragma unroll
        for (int l = 0; l < 6; ++l) v += w[l] * A[6 * l + j];
      }
      out[6 * i + j] = v;
    }
  }
}

// 8-byte copy from global to shared memory that bypasses the registers
__device__ __forceinline__ void copy_async8(double* dst, const double* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src)
               : "memory");
}

// kLoss: the batch has a loss (the IRLS branch); the loss-free
// instantiation is the code of kernel 6 without the branch.  kJac: the
// Jacobian mode (the QR path's): each lane writes its whitened (and
// reweighted) Jacobian M into H, read as the pool rows (N, arity, rmax, d),
// and the launch ends there; the Gram mode (kJac false) is unchanged.
template <bool kLoss, bool kJac = false>
__global__ void __launch_bounds__(kLinThreads) pg_linearize_kernel(
    int N, int arity, int d, int rmax, const double* __restrict__ R,
    const double* __restrict__ t, const int* __restrict__ rows,
    const double* __restrict__ ZR, const double* __restrict__ Zt, int kind,
    int stride, const double* __restrict__ noise, double sign, int loss,
    double lparam, const unsigned char* __restrict__ flip,
    double* __restrict__ H, double* __restrict__ gv) {
  // a factor's A_0 (A_i, or a prior's A), A_1 (A_j) and b, kFactorDoubles
  // apart; then its 6x6 blocks and gv rows, kOutDoubles apart
  __shared__ double sBuf[kLinFactors * kOutDoubles];
  __shared__ double sN[kLinFactors * kSlot];   // the factors' noise models
  const int lane = threadIdx.x;
  const int64_t k0 = (int64_t)blockIdx.x * kLinFactors;
  const int64_t left = (int64_t)N - k0;
  const int nf = left < kLinFactors ? (int)left : kLinFactors;
  const int f = lane >> 1, half = lane & 1;
  const int64_t k = k0 + f;
  // lane 0 of a pair forms A_j (a prior's A) and b, lane 1 A_i
  const bool forms = f < nf && (half == 0 || arity == 2);
  const int slot = half == 0 ? arity - 1 : 0;

  // the CTA's noise models, fetched while phase 1 computes r and Jr^-1
  const int m = kind == 0 ? 0 : kind == 1 ? 6 : kSlot;   // doubles a model
  const int nn = stride == 0 ? m : nf * m;
  const double* src = noise + (stride == 0 ? 0 : k0 * m);
  for (int e = lane; e < nn; e += kLinThreads) copy_async8(sN + e, src + e);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // phase 1: a lane pair a factor
  double r[6], D[9], C[9];
  if (f < nf) {
    Pose P;
    residual(R, t, rows, ZR, Zt, arity, k, r, P);
    if (half == 0 || arity == 1) {   // A_j: Ad(I)
#pragma unroll
      for (int i = 0; i < 9; ++i) P.R[i] = (i % 4 == 0) ? 1.0 : 0.0;
#pragma unroll
      for (int i = 0; i < 3; ++i) P.t[i] = 0.0;
    }
    double Jw[9], Q2[9];
    jr_inverse(r, Jw, Q2);
    // Jr^-1 Ad(P), Jr^-1 = [[Jw, 0], [Q2, Jw]], Ad = [[R, 0], [hat(t) R, R]]:
    // [[Jw R, 0], [Q2 R + Jw hat(t) R, Jw R]]
    double tR[9], t_hat[9], JtR[9];
    hat(P.t, t_hat);
    mm3(t_hat, P.R, tR);
    mm3(Jw, P.R, D);
    mm3(Q2, P.R, C);
    mm3(Jw, tR, JtR);
#pragma unroll
    for (int i = 0; i < 9; ++i) C[i] += JtR[i];
  }
  // factor g's (0, 1) block is stored transposed where bit 2 g + 1 is set
  const unsigned flips = __ballot_sync(
      0xffffffffu, half == 1 && f < nf && arity == 2 && flip[k] != 0);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
  double M[36];   // this lane's whitened (and reweighted) Jacobian
  if (kLoss) {
    // lane 0 of a pair whitens r and takes the IRLS weight's square root
    // sqrt(w(||R_w r||)), which its partner gets by a shuffle
    const double* nz = sN + (stride == 0 ? 0 : f * m);
    double wr[6], sw = 1.0;
    if (half == 0 && f < nf) {
      whiten_vec(kind, nz, r, wr);
      double d2 = 0.0;
#pragma unroll
      for (int i = 0; i < 6; ++i) d2 += wr[i] * wr[i];
      sw = sqrt(loss_weight(loss, lparam, sqrt(d2)));
    }
    sw = __shfl_sync(0xffffffffu, sw, lane & ~1);
    if (forms) {
      double* s = sBuf + f * kFactorDoubles;
      whiten_into(kind, nz, D, C, half == 0 ? 1.0 : -1.0, M);
#pragma unroll
      for (int i = 0; i < 36; ++i) {
        M[i] *= sw;
        s[kSlot * slot + i] = M[i];
      }
      if (half == 0) {
#pragma unroll
        for (int i = 0; i < 6; ++i) s[2 * kSlot + i] = -(wr[i] * sw);
      }
    }
  } else if (forms) {
    const double* nz = sN + (stride == 0 ? 0 : f * m);
    double* s = sBuf + f * kFactorDoubles;
    whiten_into(kind, nz, D, C, half == 0 ? 1.0 : -1.0, M);
#pragma unroll
    for (int i = 0; i < 36; ++i) s[kSlot * slot + i] = M[i];
    if (half == 0) {
      double wr[6];
      whiten_vec(kind, nz, r, wr);
#pragma unroll
      for (int i = 0; i < 6; ++i) s[2 * kSlot + i] = -wr[i];
    }
  }
  if constexpr (kJac) {
    // slot `slot`'s rows 0..5 of the pool, zero past column 6
    if (forms) {
      double* o = H + ((k * arity + slot) * rmax) * d;
#pragma unroll
      for (int i = 0; i < 6; ++i)
        for (int j = 0; j < d; ++j) o[i * d + j] = j < 6 ? M[6 * i + j] : 0.0;
    }
    return;
  }
  __syncwarp();

  // phase 2: each lane's share of its factor's blocks, in registers: the
  // Gram block of its own Jacobian (sign M^T M) and its gv row (sign M^T
  // b), and rows 3 half .. 3 half + 2 of the (0, 1) block (sign A_i^T A_j,
  // out of shared memory); then into the buffer, compact
  double b[6], cx[18];
  if (f < nf) {
    const double* s = sBuf + f * kFactorDoubles;
#pragma unroll
    for (int i = 0; i < 6; ++i) b[i] = s[2 * kSlot + i];
    if (arity == 2) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        double x[6];
#pragma unroll
        for (int q = 0; q < 6; ++q) x[q] = s[6 * q + 3 * half + a];
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          double acc = 0.0;
#pragma unroll
          for (int q = 0; q < 6; ++q) acc += x[q] * s[kSlot + 6 * q + j];
          cx[6 * a + j] = sign * acc;
        }
      }
    }
  }
  __syncwarp();   // the Jacobians are read: the buffer takes the outputs
  if (f < nf) {
    double* o = sBuf + f * kOutDoubles;
    if (forms) {
#pragma unroll
      for (int a = 0; a < 6; ++a)
#pragma unroll
        for (int j = a; j < 6; ++j) {
          double acc = 0.0;
#pragma unroll
          for (int q = 0; q < 6; ++q) acc += M[6 * q + a] * M[6 * q + j];
          o[2 * kSlot * slot + 6 * a + j] = sign * acc;
          o[2 * kSlot * slot + 6 * j + a] = sign * acc;
        }
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        double acc = 0.0;
#pragma unroll
        for (int q = 0; q < 6; ++q) acc += M[6 * q + i] * b[q];
        o[3 * kSlot + 6 * slot + i] = sign * acc;
      }
    }
    if (arity == 2) {
      const bool tr = (flips >> (2 * f + 1)) & 1u;
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const int i = 3 * half + a;
          o[kSlot + (tr ? 6 * j + i : 6 * i + j)] = cx[6 * a + j];
        }
    }
  }
  __syncwarp();

  // the CTA's span of H, entry q of each factor's npair d x d blocks by
  // lane q % 32 (its place in the buffer worked out once), then of gv
  const int npair = arity == 2 ? 3 : 1;
  const int dd = d * d, npd = npair * dd;
  // q / d = (q * magic) >> 16 for every q < d^2 (d <= kMaxD)
  const unsigned magic = (65536u + d - 1) / d;
  double* Hs = H + k0 * npd;
  for (int q = lane; q < npd; q += kLinThreads) {
    const int p = (q >= dd) + (q >= 2 * dd);
    const int qq = q - p * dd;
    const int i = (int)(((unsigned)qq * magic) >> 16), j = qq - i * d;
    const bool pad = i >= 6 || j >= 6;
    const int at = pad ? 0 : kSlot * p + 6 * i + j;
#pragma unroll 4
    for (int g = 0; g < nf; ++g)
      Hs[g * npd + q] = pad ? 0.0 : sBuf[g * kOutDoubles + at];
  }
  const int ng = arity * d;
  double* Gs = gv + k0 * ng;
  for (int q = lane; q < ng; q += kLinThreads) {
    const int sl = q >= d, i = q - sl * d;
    const bool pad = i >= 6;
    const int at = pad ? 0 : 3 * kSlot + 6 * sl + i;
    for (int g = 0; g < nf; ++g)
      Gs[g * ng + q] = pad ? 0.0 : sBuf[g * kOutDoubles + at];
  }
}

// kExt: the batch has a loss or constrained noise; the other
// instantiation is the code of kernel 6 without either
template <bool kExt>
__global__ void __launch_bounds__(kErrorThreads) pg_error_kernel(
    int N, int arity, const double* __restrict__ R,
    const double* __restrict__ t, const int* __restrict__ rows,
    const double* __restrict__ ZR, const double* __restrict__ Zt, int kind,
    int stride, const double* __restrict__ noise, double sign, int loss,
    double lparam, double mu, double* __restrict__ partial,
    int* __restrict__ counter, double* __restrict__ out) {
  __shared__ bool last;
  const int64_t k = (int64_t)blockIdx.x * kErrorThreads + threadIdx.x;
  // each lane's value is twice its factor's error: ||R_w r||^2, plus
  // mu r^2 on the hard rows of a constrained model, or 2 rho(||R_w r||)
  // (doubling and the last CTA's halving are exact)
  double v = 0.0;
  if (k < N) {
    double r[6], wr[6];
    Pose Tji;
    residual(R, t, rows, ZR, Zt, arity, k, r, Tji);
    const double* nz = kind == 0 ? nullptr : noise + (int64_t)stride * k;
    whiten_vec(kExt && kind == kConstrained ? 1 : kind, nz, r, wr);
#pragma unroll
    for (int i = 0; i < 6; ++i) v += wr[i] * wr[i];
    if (kExt && loss != kLossNone) {
      v = 2.0 * loss_rho(loss, lparam, sqrt(v));
    } else if (kExt) {   // constrained: mu r^2 on the hard rows
      double h = 0.0;
#pragma unroll
      for (int i = 0; i < 6; ++i) h += nz[i] == 0.0 ? r[i] * r[i] : 0.0;
      v += mu * h;
    }
  }
  v = gt::warp_sum(v);
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = v;
    __threadfence();  // the partial is visible before the ticket says so
    last = atomicAdd(counter, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;

  // the last CTA: every partial of this launch is written
  __threadfence();
  double s = 0.0;
#pragma unroll 8
  for (int i = threadIdx.x; i < (int)gridDim.x; i += kErrorThreads)
    s += __ldcg(partial + i);  // from L2: written by other SMs
  s = gt::warp_sum(s);
  if (threadIdx.x == 0) {
    *out = sign * (0.5 * s);
    *counter = 0;  // ready for the next launch on this stream
  }
}

constexpr int kAsmThreads = 256;               // 8 warps: 8 blocks of T
constexpr int kAsmWarps = kAsmThreads / gt::kWarp;
constexpr int kAsmSlots = (kMaxD * kMaxD + gt::kWarp - 1) / gt::kWarp;

__global__ void __launch_bounds__(kAsmThreads) pg_assemble_kernel(
    int nt, int n, int d, int blk_ctas, const double* __restrict__ hc,
    const double* __restrict__ gc, const int* __restrict__ asm_src,
    const int* __restrict__ asm_ptr, const int* __restrict__ asm_blk,
    const int* __restrict__ asm_diag, const int* __restrict__ g_src,
    const int* __restrict__ g_ptr, const double* __restrict__ pad_diag,
    double* __restrict__ blocks, double* __restrict__ g) {
  if ((int)blockIdx.x >= blk_ctas) {   // g: one thread per entry
    const int t = ((int)blockIdx.x - blk_ctas) * kAsmThreads + threadIdx.x;
    if (t >= n * d) return;
    const int v = t / d;
    const int i = t - v * d;
    double acc = 0.0;
    for (int k = g_ptr[v]; k < g_ptr[v + 1]; ++k)
      acc += gc[(int64_t)g_src[k] * d + i];
    g[t] = acc;
    return;
  }
  const int w = (int)blockIdx.x * kAsmWarps + (threadIdx.x >> 5);
  if (w >= nt) return;
  const int lane = threadIdx.x & 31;
  const int dd = d * d;
  const int k1 = asm_ptr[w + 1];
  double acc[kAsmSlots];
#pragma unroll
  for (int r = 0; r < kAsmSlots; ++r) acc[r] = 0.0;
  // the rows in plan order; the unroll only issues their loads early
#pragma unroll 4
  for (int k = asm_ptr[w]; k < k1; ++k) {
    const double* row = hc + (int64_t)asm_src[k] * dd;
#pragma unroll
    for (int r = 0; r < kAsmSlots; ++r) {
      const int e = lane + r * gt::kWarp;
      if (e < dd) acc[r] += row[e];
    }
  }
  const int col = asm_diag[w];
  double* out = blocks + (int64_t)asm_blk[w] * dd;
#pragma unroll
  for (int r = 0; r < kAsmSlots; ++r) {
    const int e = lane + r * gt::kWarp;
    if (e < dd) {
      double a = acc[r];
      if (col >= 0 && e % (d + 1) == 0) a += pad_diag[col * d + e / (d + 1)];
      out[e] = a;
    }
  }
}

}  // namespace

// N factors of arity 1 (prior) or 2 (between); 6 <= d <= 12 the store's
// block width; kind 0 unit, 1 diagonal, 2 gaussian, 3 constrained noise (a
// diagonal whose zeros are hard rows), `stride` doubles apart (0: one model
// shared by every factor); loss: a code of enum Loss (0: none) and its
// parameter.  H: N x npair x d*d, gv: N x arity x d.
GT_EXPORT int gt_pg_linearize(int N, int arity, int d, const double* R,
                              const double* t, const int* rows,
                              const double* ZR, const double* Zt, int kind,
                              int stride, const double* noise, double sign,
                              int loss, double lparam,
                              const unsigned char* flip, double* H,
                              double* gv, void* stream) {
  if (d < 6 || d > kMaxD || loss < kLossNone || loss > kLossDeadZone)
    return (int)cudaErrorInvalidValue;
  if (kind == kConstrained) kind = 1;   // hard rows whiten to 0
  const int grid = (N + kLinFactors - 1) / kLinFactors;
  const cudaStream_t st = (cudaStream_t)stream;
  if (N > 0 && loss != kLossNone)
    pg_linearize_kernel<true><<<grid, kLinThreads, 0, st>>>(
        N, arity, d, 0, R, t, rows, ZR, Zt, kind, stride, noise, sign, loss,
        lparam, flip, H, gv);
  else if (N > 0)
    pg_linearize_kernel<false><<<grid, kLinThreads, 0, st>>>(
        N, arity, d, 0, R, t, rows, ZR, Zt, kind, stride, noise, sign, loss,
        lparam, flip, H, gv);
  return (int)cudaGetLastError();
}

// The Jacobian mode: A (N x arity x rmax x d), slot s of factor n's rows
// 0..5 written (zero past column 6), rmax >= 6, 6 <= d <= 12; no sign (the
// QR factors the rows themselves).
GT_EXPORT int gt_pg_jacobians(int N, int arity, int d, int rmax,
                              const double* R, const double* t,
                              const int* rows, const double* ZR,
                              const double* Zt, int kind, int stride,
                              const double* noise, int loss, double lparam,
                              double* A, void* stream) {
  if (d < 6 || d > kMaxD || rmax < 6 || loss < kLossNone ||
      loss > kLossDeadZone)
    return (int)cudaErrorInvalidValue;
  if (kind == kConstrained) kind = 1;   // hard rows whiten to 0
  const int grid = (N + kLinFactors - 1) / kLinFactors;
  const cudaStream_t st = (cudaStream_t)stream;
  if (N > 0 && loss != kLossNone)
    pg_linearize_kernel<true, true><<<grid, kLinThreads, 0, st>>>(
        N, arity, d, rmax, R, t, rows, ZR, Zt, kind, stride, noise, 1.0,
        loss, lparam, nullptr, A, nullptr);
  else if (N > 0)
    pg_linearize_kernel<false, true><<<grid, kLinThreads, 0, st>>>(
        N, arity, d, rmax, R, t, rows, ZR, Zt, kind, stride, noise, 1.0,
        loss, lparam, nullptr, A, nullptr);
  return (int)cudaGetLastError();
}

// partial must hold max(1, ceil(N / 32)) doubles (ERROR_BLOCK in
// linear/supernodal_kernels.py); counter is an int that is 0 between
// launches (the kernel leaves it so); out is one double.  Launches even at
// N = 0, so out is always written.
GT_EXPORT int gt_pg_error(int N, int arity, const double* R, const double* t,
                          const int* rows, const double* ZR, const double* Zt,
                          int kind, int stride, const double* noise,
                          double sign, int loss, double lparam, double mu,
                          double* partial, int* counter, double* out,
                          void* stream) {
  if (loss < kLossNone || loss > kLossDeadZone)
    return (int)cudaErrorInvalidValue;
  const int grid = N > 0 ? (N + kErrorThreads - 1) / kErrorThreads : 1;
  const cudaStream_t st = (cudaStream_t)stream;
  if (loss != kLossNone || kind == kConstrained)
    pg_error_kernel<true><<<grid, kErrorThreads, 0, st>>>(
        N, arity, R, t, rows, ZR, Zt, kind, stride, noise, sign, loss,
        lparam, mu, partial, counter, out);
  else
    pg_error_kernel<false><<<grid, kErrorThreads, 0, st>>>(
        N, arity, R, t, rows, ZR, Zt, kind, stride, noise, sign, loss,
        lparam, mu, partial, counter, out);
  return (int)cudaGetLastError();
}

// nt blocks of T (asm_blk: their store rows), n variables, d <= 12.
GT_EXPORT int gt_pg_assemble(int nt, int n, int d, const double* hc,
                             const double* gc, const int* asm_src,
                             const int* asm_ptr, const int* asm_blk,
                             const int* asm_diag, const int* g_src,
                             const int* g_ptr, const double* pad_diag,
                             double* blocks, double* g, void* stream) {
  if (d > kMaxD) return (int)cudaErrorInvalidValue;
  const int blk_ctas = (nt + kAsmWarps - 1) / kAsmWarps;
  const int g_ctas = (n * d + kAsmThreads - 1) / kAsmThreads;
  if (blk_ctas + g_ctas > 0)
    pg_assemble_kernel<<<blk_ctas + g_ctas, kAsmThreads, 0,
                         (cudaStream_t)stream>>>(
        nt, n, d, blk_ctas, hc, gc, asm_src, asm_ptr, asm_blk, asm_diag,
        g_src, g_ptr, pad_diag, blocks, g);
  return (int)cudaGetLastError();
}
