// Kernel 6, Pose2 variant: SE(2) between / prior factors of the 2D pose
// graph -- linearization into the solver's contribution buffer and the
// half-chi2 (float64 throughout), with robust losses and constrained noise.
//
// Replaces: gtsam_tpu/graph/factors.py::linearize (:147-176, via jacfwd of
// _between_residual("SE2") :194-196 and _prior_residual :208) for SE2
// batches, and gtsam_tpu/graph/graph.py::BoundGraph.error (:108-126) for
// those batches.  (pg_assemble, pg_between.cu, sums the buffer into the
// store at any width, d = 3 included.)
//
// The factor math, in the tangent order [vx, vy, w]: with
// r = Log(Z^-1 Ti^-1 Tj) (logmap wraps w by atan2(sin w, cos w)),
//   A_j = R_w Jr^-1(r),  A_i = -R_w Jr^-1(r) Ad(Tj^-1 Ti),  b = -R_w r
// (a prior: A = R_w Jr^-1(r) with r = Log(Z^-1 Ti)), where
//   Jr^-1 = [[1 - w g, -w/2, g vx + vy/2], [w/2, 1 - w g, g vy - vx/2],
//            [0, 0, 1]],  g = 1/w - cot(w/2)/2
// (its series below w^2 = 5e-3) and Ad(P) = [[c, -s, y], [s, c, -x],
// [0, 0, 1]] (gtsam_torch/geometry/se2.py, the plain version's formulas).
// R_w is unit, diagonal (constrained: its zeros the hard rows, weight 0) or
// a full 3x3 square-root information, one for the batch (stride 0) or one
// a factor.  The exact SE(2) chart, as the JAX package's retract.
//
// gt_pg2_linearize: a CTA is one warp and owns 32 consecutive factors, a
// lane each: at d = 3 a factor's blocks are 27 doubles and its gv rows 6,
// where SE3's are 108 and 12, so a lane holds a whole factor in registers
// (its two 3x3 Jacobians and b; 3,125 CTAs for 100,000 factors).  Each
// lane loads its poses, measurement and noise model, forms r, Jr^-1, the
// whitened (and reweighted) Jacobians and b, then sign A_s1^T A_s2 of its
// slot pairs and sign A_s^T b, and leaves them compact in shared memory
// (33 doubles a factor: an odd stride keeps the lanes on distinct banks),
// the (0, 1) block transposed where flip says the plan stores it so.  The
// CTA then copies its span of H ((N, npair, d*d), factor-major, zero
// outside the leading 3x3) and of gv ((N, arity, d)) out: the warp walks
// the span in order, a lane an entry, so each store instruction writes
// 256 contiguous bytes.
// gt_pg2_error: a grid over the factors, a lane a factor, as pg_between.cu's
// error: the warp's butterfly sum of its lanes' values into its partial,
// the last CTA (an atomic completion ticket) summing the partials in index
// order; the grid is ceil(N / 32), so the order of every addition depends
// on N alone and two calls give the same bits.  No value is summed by
// atomics.
// Both kernels are templates on whether the batch has a loss (the error's
// also on constrained noise), as pg_between.cu's: the loss-free launch runs
// code without the branch (pg_losses.cuh's loss_weight and loss_rho, a
// runtime switch on a grid-uniform code).  Under a loss each lane scales
// its whitened Jacobians and b by sqrt(w(||R_w r||)); in the error each
// lane's value is twice its factor's error (||R_w r||^2, 2 rho(||R_w r||),
// or ||R_w r||^2 + mu r^2 over the hard rows of a constrained model), and
// the last CTA's 0.5 halves it.
//
// Bound on the H100: bytes.  A between factor reads two poses and a
// measurement (72 bytes, plus its rows and noise model) and writes
// 264 bytes of H and gv at d = 3, against ~600 FP64 operations (the
// trigonometry of three composes, a log and Jr^-1, and the 3x3 products);
// its error reads the same and writes nothing but the sum.
#include "pg_losses.cuh"

namespace {

using namespace pg;

constexpr int kP2Factors = gt::kWarp;   // LINEARIZE2_FACTORS: a lane each
constexpr int kP2Out = 3 * 9 + 2 * 3;   // 3 blocks, 2 gv rows; odd
constexpr int kErrorThreads = gt::kWarp;   // ERROR_BLOCK (Python)
constexpr int kMaxD = 12;                  // store width 3 <= d <= 12
constexpr double kSmall = 1e-10;     // se2.py _SMALL (w^2)
constexpr double kJrSmall = 5e-3;    // se2.py _JR_SMALL (w^2)

struct Pose2 {
  double x, y, th;
};

__device__ __forceinline__ Pose2 load_pose2(const double* p, int64_t k) {
  return Pose2{p[3 * k], p[3 * k + 1], p[3 * k + 2]};
}

// inverse, compose and between in se2.py's order of operations
__device__ __forceinline__ Pose2 inverse(const Pose2& p) {
  double s, c;
  sincos(p.th, &s, &c);
  return Pose2{-(c * p.x + s * p.y), -(-s * p.x + c * p.y), -p.th};
}

__device__ __forceinline__ Pose2 compose(const Pose2& a, const Pose2& b) {
  double s, c;
  sincos(a.th, &s, &c);
  return Pose2{a.x + c * b.x - s * b.y, a.y + s * b.x + c * b.y, a.th + b.th};
}

__device__ __forceinline__ Pose2 between(const Pose2& a, const Pose2& b) {
  return compose(inverse(a), b);
}

// se2.py logmap: w wrapped by atan2(sin w, cos w), then V(w)^-1 t
__device__ __forceinline__ void log_pose2(const Pose2& p, double* r) {
  double sn, cs;
  sincos(p.th, &sn, &cs);
  const double w = atan2(sn, cs);
  const double w2 = w * w;
  double A, B;
  if (w2 < kSmall) {
    A = 1.0 - w2 / 6.0;
    B = 0.5 * w;
  } else {
    double s, c;
    sincos(w, &s, &c);
    A = s / w;
    B = (1.0 - c) / w;
  }
  const double det = A * A + B * B;
  r[0] = (A * p.x + B * p.y) / det;
  r[1] = (-B * p.x + A * p.y) / det;
  r[2] = w;
}

// r and, for a between factor, P = Tj^-1 Ti
__device__ __forceinline__ void residual2(const double* x, const int* rows,
                                          const double* Z, int arity,
                                          int64_t k, double* r, Pose2& P) {
  const Pose2 Ti = load_pose2(x, rows[arity * k]);
  const Pose2 Zk = load_pose2(Z, k);
  if (arity == 2) {
    const Pose2 Tj = load_pose2(x, rows[arity * k + 1]);
    log_pose2(between(Zk, between(Ti, Tj)), r);
    P = between(Tj, Ti);
  } else {
    log_pose2(between(Zk, Ti), r);
  }
}

// R_w x for x (3,): kind 0 unit, 1 diagonal, 2 a 3x3 square root
__device__ __forceinline__ void whiten3(int kind, const double* nz,
                                        const double* x, double* o) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (kind == 0) {
      o[i] = x[i];
    } else if (kind == 1) {
      o[i] = x[i] * nz[i];
    } else {
      o[i] = nz[3 * i] * x[0] + nz[3 * i + 1] * x[1] + nz[3 * i + 2] * x[2];
    }
  }
}

// M = R_w A (3x3, row-major)
__device__ __forceinline__ void whiten33(int kind, const double* nz,
                                         const double* A, double* M) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const double col[3] = {A[j], A[3 + j], A[6 + j]};
    double o[3];
    whiten3(kind, nz, col, o);
#pragma unroll
    for (int i = 0; i < 3; ++i) M[3 * i + j] = o[i];
  }
}

// Jr^-1(r) (se2.py right_jacobian_inverse)
__device__ __forceinline__ void jr_inverse2(const double* r, double* J) {
  const double w = r[2], x = w * w;
  double g;
  if (x < kJrSmall) {
    g = w * (1.0 / 12 + x * (1.0 / 720 + x * (1.0 / 30240 + x * (1.0 / 1209600))));
  } else {
    double s, c;
    sincos(0.5 * w, &s, &c);
    g = 1.0 / w - 0.5 * c / s;
  }
  const double a = 1.0 - w * g;
  J[0] = a;        J[1] = -0.5 * w; J[2] = g * r[0] + 0.5 * r[1];
  J[3] = 0.5 * w;  J[4] = a;        J[5] = g * r[1] - 0.5 * r[0];
  J[6] = 0.0;      J[7] = 0.0;      J[8] = 1.0;
}

// sign P^T Q (3x3 each, row-major) into o, transposed where tr
__device__ __forceinline__ void gram(const double* P, const double* Q,
                                     double sign, bool tr, double* o) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const double v =
          sign * (P[i] * Q[j] + P[3 + i] * Q[3 + j] + P[6 + i] * Q[6 + j]);
      o[tr ? 3 * j + i : 3 * i + j] = v;
    }
}

// kLoss: the batch has a loss (the IRLS branch); the loss-free
// instantiation runs code without it.  kJac: the Jacobian mode (the QR
// path's): each lane writes its factor's whitened (and reweighted)
// Jacobians into H, read as the pool rows (N, arity, rmax, d), and the
// launch ends there; the Gram mode (kJac false) is unchanged.
template <bool kLoss, bool kJac = false>
__global__ void __launch_bounds__(kP2Factors) pg2_linearize_kernel(
    int N, int arity, int d, int rmax, const double* __restrict__ x,
    const int* __restrict__ rows, const double* __restrict__ Z, int kind,
    int stride, const double* __restrict__ noise, double sign, int loss,
    double lparam, const unsigned char* __restrict__ flip,
    double* __restrict__ H, double* __restrict__ gv) {
  // factor g's blocks (pairs 0, 1, 2: 9 doubles each) and gv rows (slots
  // 0, 1: 3 each), kP2Out apart
  __shared__ double sOut[kP2Factors * kP2Out];
  const int lane = threadIdx.x;
  const int64_t k0 = (int64_t)blockIdx.x * kP2Factors;
  const int64_t left = (int64_t)N - k0;
  const int nf = left < kP2Factors ? (int)left : kP2Factors;
  const int64_t k = k0 + lane;
  if (lane < nf) {
    double r[3], J[9];
    Pose2 P{0.0, 0.0, 0.0};
    residual2(x, rows, Z, arity, k, r, P);
    jr_inverse2(r, J);
    const double* nz = kind == 0 ? nullptr : noise + (int64_t)stride * k;
    double wr[3], M1[9];
    whiten3(kind, nz, r, wr);
    whiten33(kind, nz, J, M1);   // A_j, or a prior's A
    double sw = 1.0;
    if (kLoss) {
      const double d2 = wr[0] * wr[0] + wr[1] * wr[1] + wr[2] * wr[2];
      sw = sqrt(loss_weight(loss, lparam, sqrt(d2)));
#pragma unroll
      for (int i = 0; i < 9; ++i) M1[i] *= sw;
    }
    double b[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) b[i] = -(wr[i] * sw);
    double M0[9];
    if (arity == 2) {
      // A_i = -R_w Jr^-1 Ad(P)
      double s, c;
      sincos(P.th, &s, &c);
      const double Ad[9] = {c, -s, P.y, s, c, -P.x, 0.0, 0.0, 1.0};
      double JA[9];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
          JA[3 * i + j] = -(J[3 * i] * Ad[j] + J[3 * i + 1] * Ad[3 + j] +
                            J[3 * i + 2] * Ad[6 + j]);
      whiten33(kind, nz, JA, M0);
      if (kLoss) {
#pragma unroll
        for (int i = 0; i < 9; ++i) M0[i] *= sw;
      }
    }
    double* o = sOut + lane * kP2Out;
    if constexpr (kJac) {
      // slot arity - 1 takes M1, slot 0 of a between factor M0; rows 0..2
      // of the pool, zero past column 3
      double* a = H + k * arity * rmax * d;
      double* a1 = a + (arity - 1) * rmax * d;
#pragma unroll
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < d; ++j) a1[i * d + j] = j < 3 ? M1[3 * i + j] : 0.0;
      if (arity == 2) {
#pragma unroll
        for (int i = 0; i < 3; ++i)
          for (int j = 0; j < d; ++j) a[i * d + j] = j < 3 ? M0[3 * i + j] : 0.0;
      }
    } else if (arity == 2) {
      gram(M0, M0, sign, false, o);
      gram(M0, M1, sign, flip[k] != 0, o + 9);
      gram(M1, M1, sign, false, o + 18);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        o[27 + i] = sign * (M0[i] * b[0] + M0[3 + i] * b[1] + M0[6 + i] * b[2]);
        o[30 + i] = sign * (M1[i] * b[0] + M1[3 + i] * b[1] + M1[6 + i] * b[2]);
      }
    } else {
      gram(M1, M1, sign, false, o);
#pragma unroll
      for (int i = 0; i < 3; ++i)
        o[27 + i] = sign * (M1[i] * b[0] + M1[3 + i] * b[1] + M1[6 + i] * b[2]);
    }
  }
  if constexpr (kJac) return;
  __syncwarp();

  // the CTA's spans of H and gv, in order, a lane an entry: entry e of the
  // span is entry q = e % npd of factor e / npd
  const int npair = arity == 2 ? 3 : 1;
  const int dd = d * d, npd = npair * dd, ng = arity * d;
  double* Hs = H + k0 * npd;
  for (int e = lane; e < nf * npd; e += kP2Factors) {
    const int g = e / npd, q = e - g * npd;
    const int p = q / dd, qq = q - p * dd;
    const int i = qq / d, j = qq - i * d;
    Hs[e] = i < 3 && j < 3 ? sOut[g * kP2Out + 9 * p + 3 * i + j] : 0.0;
  }
  double* Gs = gv + k0 * ng;
  for (int e = lane; e < nf * ng; e += kP2Factors) {
    const int g = e / ng, q = e - g * ng;
    const int sl = q / d, i = q - sl * d;
    Gs[e] = i < 3 ? sOut[g * kP2Out + 27 + 3 * sl + i] : 0.0;
  }
}

// kExt: the batch has a loss or constrained noise; the other instantiation
// runs code without either
template <bool kExt>
__global__ void __launch_bounds__(kErrorThreads) pg2_error_kernel(
    int N, int arity, const double* __restrict__ x,
    const int* __restrict__ rows, const double* __restrict__ Z, int kind,
    int stride, const double* __restrict__ noise, double sign, int loss,
    double lparam, double mu, double* __restrict__ partial,
    int* __restrict__ counter, double* __restrict__ out) {
  __shared__ bool last;
  const int64_t k = (int64_t)blockIdx.x * kErrorThreads + threadIdx.x;
  // twice the factor's error (doubling and the last CTA's halving are
  // exact)
  double v = 0.0;
  if (k < N) {
    double r[3], wr[3];
    Pose2 P{0.0, 0.0, 0.0};
    residual2(x, rows, Z, arity, k, r, P);
    const double* nz = kind == 0 ? nullptr : noise + (int64_t)stride * k;
    whiten3(kExt && kind == kConstrained ? 1 : kind, nz, r, wr);
    v = wr[0] * wr[0] + wr[1] * wr[1] + wr[2] * wr[2];
    if (kExt && loss != kLossNone) {
      v = 2.0 * loss_rho(loss, lparam, sqrt(v));
    } else if (kExt) {   // constrained: mu r^2 on the hard rows
      double h = 0.0;
#pragma unroll
      for (int i = 0; i < 3; ++i) h += nz[i] == 0.0 ? r[i] * r[i] : 0.0;
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

}  // namespace

// N factors of arity 1 (prior) or 2 (between) over the poses x (n x 3);
// 3 <= d <= 12 the store's block width; kind 0 unit, 1 diagonal, 2
// gaussian, 3 constrained (a diagonal whose zeros are hard rows), models
// `stride` doubles apart (0: one shared by every factor); loss: a code of
// enum Loss (0: none) and its parameter.  H: N x npair x d*d, gv: N x
// arity x d.
GT_EXPORT int gt_pg2_linearize(int N, int arity, int d, const double* x,
                               const int* rows, const double* Z, int kind,
                               int stride, const double* noise, double sign,
                               int loss, double lparam,
                               const unsigned char* flip, double* H,
                               double* gv, void* stream) {
  if (d < 3 || d > kMaxD || loss < kLossNone || loss > kLossDeadZone)
    return (int)cudaErrorInvalidValue;
  if (kind == kConstrained) kind = 1;   // hard rows whiten to 0
  const int grid = (N + kP2Factors - 1) / kP2Factors;
  const cudaStream_t st = (cudaStream_t)stream;
  if (N > 0 && loss != kLossNone)
    pg2_linearize_kernel<true><<<grid, kP2Factors, 0, st>>>(
        N, arity, d, 0, x, rows, Z, kind, stride, noise, sign, loss, lparam,
        flip, H, gv);
  else if (N > 0)
    pg2_linearize_kernel<false><<<grid, kP2Factors, 0, st>>>(
        N, arity, d, 0, x, rows, Z, kind, stride, noise, sign, loss, lparam,
        flip, H, gv);
  return (int)cudaGetLastError();
}

// The Jacobian mode: A (N x arity x rmax x d), slot s of factor n's rows
// 0..2 written (zero past column 3), rmax >= 3, 3 <= d <= 12; no sign.
GT_EXPORT int gt_pg2_jacobians(int N, int arity, int d, int rmax,
                               const double* x, const int* rows,
                               const double* Z, int kind, int stride,
                               const double* noise, int loss, double lparam,
                               double* A, void* stream) {
  if (d < 3 || d > kMaxD || rmax < 3 || loss < kLossNone ||
      loss > kLossDeadZone)
    return (int)cudaErrorInvalidValue;
  if (kind == kConstrained) kind = 1;   // hard rows whiten to 0
  const int grid = (N + kP2Factors - 1) / kP2Factors;
  const cudaStream_t st = (cudaStream_t)stream;
  if (N > 0 && loss != kLossNone)
    pg2_linearize_kernel<true, true><<<grid, kP2Factors, 0, st>>>(
        N, arity, d, rmax, x, rows, Z, kind, stride, noise, 1.0, loss,
        lparam, nullptr, A, nullptr);
  else if (N > 0)
    pg2_linearize_kernel<false, true><<<grid, kP2Factors, 0, st>>>(
        N, arity, d, rmax, x, rows, Z, kind, stride, noise, 1.0, loss,
        lparam, nullptr, A, nullptr);
  return (int)cudaGetLastError();
}

// partial must hold max(1, ceil(N / 32)) doubles (ERROR_BLOCK in
// linear/supernodal_kernels.py); counter is an int that is 0 between
// launches (the kernel leaves it so); out is one double.  Launches even at
// N = 0, so out is always written.
GT_EXPORT int gt_pg2_error(int N, int arity, const double* x, const int* rows,
                           const double* Z, int kind, int stride,
                           const double* noise, double sign, int loss,
                           double lparam, double mu, double* partial,
                           int* counter, double* out, void* stream) {
  if (loss < kLossNone || loss > kLossDeadZone)
    return (int)cudaErrorInvalidValue;
  const int grid = N > 0 ? (N + kErrorThreads - 1) / kErrorThreads : 1;
  const cudaStream_t st = (cudaStream_t)stream;
  if (loss != kLossNone || kind == kConstrained)
    pg2_error_kernel<true><<<grid, kErrorThreads, 0, st>>>(
        N, arity, x, rows, Z, kind, stride, noise, sign, loss, lparam, mu,
        partial, counter, out);
  else
    pg2_error_kernel<false><<<grid, kErrorThreads, 0, st>>>(
        N, arity, x, rows, Z, kind, stride, noise, sign, loss, lparam, mu,
        partial, counter, out);
  return (int)cudaGetLastError();
}
