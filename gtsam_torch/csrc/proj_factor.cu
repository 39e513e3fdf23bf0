// Kernels 17 and 18: the graph form's projection factors -- linearization
// into the supernodal solver's contribution buffer (or, in the Jacobian
// mode, the whitened rows into the QR and PCG pool) and the half-chi2,
// float64 throughout, with robust losses and constrained noise.
//
// Replaces: gtsam_tpu/graph/factors.py::linearize (:147-176, jacfwd + vmap)
// of the ProjectionBal batch of gtsam_tpu/sfm/bal.py::to_graph (:150, the
// residual _projection_residual :182) and of the GenericProjection batch
// of gtsam_tpu/slam/factors.py::generic_projection_factors (:23), its
// Jacobian rows (gtsam_tpu/linear/supernodal.py:769), and
// gtsam_tpu/graph/graph.py::BoundGraph.error (:108) of those batches.
// (pg_assemble, pg_between.cu, sums the buffer into the store, at d = 9
// here.)  No TPU kernel: the JAX package writes these in jnp.
//
// Two cameras, a template on the camera's tangent width kCam:
//   9: BalCamera + Point3 (projection.cuh's project_bal, kernel 1's math);
//   6: SE3 + Point3 with a fixed Cal3_S2 K and an optional body-to-sensor
//      extrinsic (project_pinhole).
// Per factor: r (2), the camera's 2 x kCam and the point's 2 x 3 Jacobian
// (zero, with r = 1e3, behind the camera), whitened by R_w (unit, diagonal,
// constrained: a diagonal whose zeros are hard rows of weight 0, or a 2x2
// square-root information; one for the batch or one a factor) and, under
// a loss, scaled by sqrt(w(||R_w r||)) (pg_losses.cuh); b = -R_w r.
//
// proj_linearize_kernel<kCam, kLoss, kJac>: a CTA is one warp and owns 32
// consecutive factors, a lane each, as pg_pose2.cu's.  A lane forms its
// factor's whitened Jacobians in registers (24 doubles at kCam = 9), then
// sign A_c^T A_c (kCam x kCam), sign A_c^T A_p (kCam x 3, or its transpose
// where flip says the plan stores the pair so), sign A_p^T A_p and the
// gradient rows sign A^T b, compact in shared memory (129 doubles a factor
// at kCam = 9, 73 at 6: odd strides keep the lanes on distinct banks;
// 33 KB at 9).  The CTA copies its span of H ((N, 3, d*d), factor-major,
// each block zero outside its leading dims) and of gv ((N, 2, d)) out in
// order, a lane an entry, so each store instruction writes 256 contiguous
// bytes.  The Jacobian mode (kJac) writes each lane's whitened rows into
// the pool (N, 2, rmax, d) -- rows 0-1 of each slot, zero past the slot's
// width -- and ends there.
// proj_error_kernel<kCam, kExt>: a lane a factor (twice its error:
// ||R_w r||^2, 2 rho(||R_w r||), or ||R_w r||^2 + mu r^2 on the hard rows
// of a constrained model), the warp's butterfly sum into a CTA partial,
// the last CTA (an atomic completion ticket) summing the partials in index
// order: the order of every addition depends on N alone.
// No value is summed by atomics, so the same inputs give the same bits.
//
// Bound on the H100: bytes.  At d = 9 a factor writes 3 * 81 + 18 doubles
// of H and gv (2,088 bytes) and reads 228 (its camera, point,
// measurement, rows), against ~740 FP64 operations; the padding of the
// point's 3x3 and 9x3 blocks to 9x9 is most of those bytes (the JAX
// package's store layout, gtsam_tpu/linear/supernodal.py:99-111).
#include "pg_losses.cuh"
#include "projection.cuh"

namespace {

using namespace pg;

constexpr int kFactors = gt::kWarp;        // PROJ_FACTORS (Python)
constexpr int kErrorThreads = gt::kWarp;   // ERROR_BLOCK (Python)
constexpr int kMaxD = 12;                  // the store width kCam <= d <= 12

// the cameras' inputs; calib for kCam = 9, K and ext for kCam = 6
struct Cams {
  const double* R;       // (nc, 3, 3)
  const double* t;       // (nc, 3)
  const double* calib;   // (nc, 3) f, k1, k2
  const double* K;       // (5,) fx, fy, s, u0, v0
  const double* ext;     // (12,) Rb, tb; null: none
};

template <int kCam>
struct Out {
  static constexpr int kCC = kCam * kCam;    // camera-camera block
  static constexpr int kCP = 3 * kCam;       // camera-point block
  static constexpr int kPP = 9;              // point-point block
  static constexpr int kGC = kCC + kCP + kPP;   // camera gradient row
  static constexpr int kGP = kGC + kCam;        // point gradient row
  static constexpr int kStride = (kGP + 3) | 1;
};

template <int kCam>
__device__ __forceinline__ void residual(const Cams& cams, int64_t k,
                                         const double* __restrict__ pts,
                                         const int* __restrict__ rows,
                                         const double* __restrict__ uv,
                                         double r[2], double* Jc, double* Jp) {
  const int64_t c = rows[2 * k], p = rows[2 * k + 1];
  if constexpr (kCam == 9) {
    proj::project_bal(cams.R + 9 * c, cams.t + 3 * c, cams.calib + 3 * c,
                      pts + 3 * p, uv + 2 * k, r, Jc, Jp);
  } else {
    proj::project_pinhole(cams.R + 9 * c, cams.t + 3 * c, cams.K, cams.ext,
                          pts + 3 * p, uv + 2 * k, r, Jc, Jp);
  }
}

// R_w x for x (2,): kind 0 unit, 1 diagonal, 2 a 2x2 square root
__device__ __forceinline__ void whiten2(int kind, const double* nz,
                                        double x0, double x1, double o[2]) {
  if (kind == 0) {
    o[0] = x0;
    o[1] = x1;
  } else if (kind == 1) {
    o[0] = x0 * nz[0];
    o[1] = x1 * nz[1];
  } else {
    o[0] = nz[0] * x0 + nz[1] * x1;
    o[1] = nz[2] * x0 + nz[3] * x1;
  }
}

// J (2 x n, row-major) <- R_w J, scaled by sw
template <int n>
__device__ __forceinline__ void whiten_rows(int kind, const double* nz,
                                            double sw, double* J) {
#pragma unroll
  for (int j = 0; j < n; ++j) {
    double o[2];
    whiten2(kind, nz, J[j], J[n + j], o);
    J[j] = o[0] * sw;
    J[n + j] = o[1] * sw;
  }
}

template <int kCam, bool kLoss, bool kJac>
__global__ void __launch_bounds__(kFactors) proj_linearize_kernel(
    int N, int d, int rmax, Cams cams, const double* __restrict__ pts,
    const int* __restrict__ rows, const double* __restrict__ uv, int kind,
    int stride, const double* __restrict__ noise, double sign, int loss,
    double lparam, const unsigned char* __restrict__ flip,
    double* __restrict__ H, double* __restrict__ gv) {
  using O = Out<kCam>;
  __shared__ double sOut[kJac ? 1 : kFactors * O::kStride];
  __shared__ unsigned char sFlip[kFactors];
  const int lane = threadIdx.x;
  const int64_t k0 = (int64_t)blockIdx.x * kFactors;
  const int64_t left = (int64_t)N - k0;
  const int nf = left < kFactors ? (int)left : kFactors;
  const int64_t k = k0 + lane;
  if (lane < nf) {
    double r[2], Jc[2 * kCam], Jp[6];
    residual<kCam>(cams, k, pts, rows, uv, r, Jc, Jp);
    const double* nz = kind == 0 ? nullptr : noise + (int64_t)stride * k;
    double wr[2];
    whiten2(kind, nz, r[0], r[1], wr);
    double sw = 1.0;
    if (kLoss) sw = sqrt(loss_weight(loss, lparam,
                                     sqrt(wr[0] * wr[0] + wr[1] * wr[1])));
    whiten_rows<kCam>(kind, nz, sw, Jc);
    whiten_rows<3>(kind, nz, sw, Jp);
    if constexpr (kJac) {
      double* a = H + k * 2 * rmax * d;
      double* p = a + rmax * d;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < kCam; ++j) a[i * d + j] = Jc[kCam * i + j];
        for (int j = kCam; j < d; ++j) a[i * d + j] = 0.0;
#pragma unroll
        for (int j = 0; j < 3; ++j) p[i * d + j] = Jp[3 * i + j];
        for (int j = 3; j < d; ++j) p[i * d + j] = 0.0;
      }
    } else {
      const double b0 = -(wr[0] * sw), b1 = -(wr[1] * sw);
      const bool tr = flip[k] != 0;
      double* o = sOut + lane * O::kStride;
#pragma unroll
      for (int i = 0; i < kCam; ++i) {
#pragma unroll
        for (int j = 0; j < kCam; ++j)
          o[kCam * i + j] =
              sign * (Jc[i] * Jc[j] + Jc[kCam + i] * Jc[kCam + j]);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const double v =
              sign * (Jc[i] * Jp[j] + Jc[kCam + i] * Jp[3 + j]);
          o[O::kCC + (tr ? kCam * j + i : 3 * i + j)] = v;
        }
        o[O::kGC + i] = sign * (Jc[i] * b0 + Jc[kCam + i] * b1);
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j)
          o[O::kCC + O::kCP + 3 * i + j] =
              sign * (Jp[i] * Jp[j] + Jp[3 + i] * Jp[3 + j]);
        o[O::kGP + i] = sign * (Jp[i] * b0 + Jp[3 + i] * b1);
      }
      sFlip[lane] = tr;
    }
  }
  if constexpr (!kJac) {
    __syncwarp();

    // the CTA's spans of H and gv, in order, a lane an entry: entry e of the
    // span is entry q = e % npd of factor e / npd
    const int dd = d * d, npd = 3 * dd, ng = 2 * d;
    double* Hs = H + k0 * npd;
    for (int e = lane; e < nf * npd; e += kFactors) {
      const int g = e / npd, q = e - g * npd;
      const int p = q / dd, qq = q - p * dd;
      const int i = qq / d, j = qq - i * d;
      const double* o = sOut + g * O::kStride;
      double v = 0.0;
      if (p == 0) {
        if (i < kCam && j < kCam) v = o[kCam * i + j];
      } else if (p == 1) {
        if (sFlip[g]) {
          if (i < 3 && j < kCam) v = o[O::kCC + kCam * i + j];
        } else if (i < kCam && j < 3) {
          v = o[O::kCC + 3 * i + j];
        }
      } else if (i < 3 && j < 3) {
        v = o[O::kCC + O::kCP + 3 * i + j];
      }
      Hs[e] = v;
    }
    double* Gs = gv + k0 * ng;
    for (int e = lane; e < nf * ng; e += kFactors) {
      const int g = e / ng, q = e - g * ng;
      const int sl = q / d, i = q - sl * d;
      const double* o = sOut + g * O::kStride;
      Gs[e] = sl == 0 ? (i < kCam ? o[O::kGC + i] : 0.0)
                      : (i < 3 ? o[O::kGP + i] : 0.0);
    }
  }
}

// kExt: the batch has a loss or constrained noise; the other instantiation
// runs code without either
template <int kCam, bool kExt>
__global__ void __launch_bounds__(kErrorThreads) proj_error_kernel(
    int N, Cams cams, const double* __restrict__ pts,
    const int* __restrict__ rows, const double* __restrict__ uv, int kind,
    int stride, const double* __restrict__ noise, double sign, int loss,
    double lparam, double mu, double* __restrict__ partial,
    int* __restrict__ counter, double* __restrict__ out) {
  __shared__ bool last;
  const int64_t k = (int64_t)blockIdx.x * kErrorThreads + threadIdx.x;
  // twice the factor's error (doubling and the last CTA's halving are
  // exact)
  double v = 0.0;
  if (k < N) {
    double r[2], wr[2];
    residual<kCam>(cams, k, pts, rows, uv, r, nullptr, nullptr);
    const double* nz = kind == 0 ? nullptr : noise + (int64_t)stride * k;
    whiten2(kExt && kind == kConstrained ? 1 : kind, nz, r[0], r[1], wr);
    v = wr[0] * wr[0] + wr[1] * wr[1];
    if (kExt && loss != kLossNone) {
      v = 2.0 * loss_rho(loss, lparam, sqrt(v));
    } else if (kExt) {   // constrained: mu r^2 on the hard rows
      v += mu * ((nz[0] == 0.0 ? r[0] * r[0] : 0.0) +
                 (nz[1] == 0.0 ? r[1] * r[1] : 0.0));
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

template <int kCam, bool kJac>
int launch_linearize(int N, int d, int rmax, const Cams& cams,
                     const double* pts, const int* rows, const double* uv,
                     int kind, int stride, const double* noise, double sign,
                     int loss, double lparam, const unsigned char* flip,
                     double* H, double* gv, void* stream) {
  if (d < kCam || d > kMaxD || (kJac && rmax < 2) || loss < kLossNone ||
      loss > kLossDeadZone)
    return (int)cudaErrorInvalidValue;
  if (kind == kConstrained) kind = 1;   // hard rows whiten to 0
  const int grid = (N + kFactors - 1) / kFactors;
  const cudaStream_t st = (cudaStream_t)stream;
  if (N > 0 && loss != kLossNone)
    proj_linearize_kernel<kCam, true, kJac><<<grid, kFactors, 0, st>>>(
        N, d, rmax, cams, pts, rows, uv, kind, stride, noise, sign, loss,
        lparam, flip, H, gv);
  else if (N > 0)
    proj_linearize_kernel<kCam, false, kJac><<<grid, kFactors, 0, st>>>(
        N, d, rmax, cams, pts, rows, uv, kind, stride, noise, sign, loss,
        lparam, flip, H, gv);
  return (int)cudaGetLastError();
}

template <int kCam>
int launch_error(int N, const Cams& cams, const double* pts, const int* rows,
                 const double* uv, int kind, int stride, const double* noise,
                 double sign, int loss, double lparam, double mu,
                 double* partial, int* counter, double* out, void* stream) {
  if (loss < kLossNone || loss > kLossDeadZone)
    return (int)cudaErrorInvalidValue;
  const int grid = N > 0 ? (N + kErrorThreads - 1) / kErrorThreads : 1;
  const cudaStream_t st = (cudaStream_t)stream;
  if (loss != kLossNone || kind == kConstrained)
    proj_error_kernel<kCam, true><<<grid, kErrorThreads, 0, st>>>(
        N, cams, pts, rows, uv, kind, stride, noise, sign, loss, lparam, mu,
        partial, counter, out);
  else
    proj_error_kernel<kCam, false><<<grid, kErrorThreads, 0, st>>>(
        N, cams, pts, rows, uv, kind, stride, noise, sign, loss, lparam, mu,
        partial, counter, out);
  return (int)cudaGetLastError();
}

Cams bal_cams(const double* R, const double* t, const double* calib) {
  return Cams{R, t, calib, nullptr, nullptr};
}

Cams pinhole_cams(const double* R, const double* t, const double* K,
                  const double* ext) {
  return Cams{R, t, nullptr, K, ext};
}

}  // namespace

// N factors (rows: N x 2, the camera's and the point's rows) over the
// cameras R (nc x 3 x 3), t (nc x 3), calib (nc x 3) and the points
// (np x 3), measurements uv (N x 2); 9 <= d <= 12 the store's width; kind
// 0 unit, 1 diagonal, 2 gaussian, 3 constrained, models `stride` doubles
// apart (0: one shared by every factor); loss: a code of enum Loss (0:
// none) and its parameter.  H: N x 3 x d*d, gv: N x 2 x d.
GT_EXPORT int gt_proj_linearize(int N, int d, const double* R,
                                const double* t, const double* calib,
                                const double* pts, const int* rows,
                                const double* uv, int kind, int stride,
                                const double* noise, double sign, int loss,
                                double lparam, const unsigned char* flip,
                                double* H, double* gv, void* stream) {
  return launch_linearize<9, false>(N, d, 0, bal_cams(R, t, calib), pts, rows,
                                    uv, kind, stride, noise, sign, loss,
                                    lparam, flip, H, gv, stream);
}

// The SE3 + Cal3_S2 camera: K (5), ext (12) or null; 6 <= d <= 12.
GT_EXPORT int gt_proj3_linearize(int N, int d, const double* R,
                                 const double* t, const double* pts,
                                 const int* rows, const double* uv,
                                 const double* K, const double* ext, int kind,
                                 int stride, const double* noise, double sign,
                                 int loss, double lparam,
                                 const unsigned char* flip, double* H,
                                 double* gv, void* stream) {
  return launch_linearize<6, false>(N, d, 0, pinhole_cams(R, t, K, ext), pts,
                                    rows, uv, kind, stride, noise, sign, loss,
                                    lparam, flip, H, gv, stream);
}

// The Jacobian mode: A (N x 2 x rmax x d), slot s of factor n's rows 0-1
// written (zero past the slot's width), rmax >= 2; no sign.
GT_EXPORT int gt_proj_jacobians(int N, int d, int rmax, const double* R,
                                const double* t, const double* calib,
                                const double* pts, const int* rows,
                                const double* uv, int kind, int stride,
                                const double* noise, int loss, double lparam,
                                double* A, void* stream) {
  return launch_linearize<9, true>(N, d, rmax, bal_cams(R, t, calib), pts,
                                   rows, uv, kind, stride, noise, 1.0, loss,
                                   lparam, nullptr, A, nullptr, stream);
}

GT_EXPORT int gt_proj3_jacobians(int N, int d, int rmax, const double* R,
                                 const double* t, const double* pts,
                                 const int* rows, const double* uv,
                                 const double* K, const double* ext, int kind,
                                 int stride, const double* noise, int loss,
                                 double lparam, double* A, void* stream) {
  return launch_linearize<6, true>(N, d, rmax, pinhole_cams(R, t, K, ext),
                                   pts, rows, uv, kind, stride, noise, 1.0,
                                   loss, lparam, nullptr, A, nullptr, stream);
}

// partial must hold max(1, ceil(N / 32)) doubles (ERROR_BLOCK in
// linear/supernodal_kernels.py); counter is an int that is 0 between
// launches (the kernel leaves it so); out is one double.  Launches even at
// N = 0, so out is always written.
GT_EXPORT int gt_proj_error(int N, const double* R, const double* t,
                            const double* calib, const double* pts,
                            const int* rows, const double* uv, int kind,
                            int stride, const double* noise, double sign,
                            int loss, double lparam, double mu,
                            double* partial, int* counter, double* out,
                            void* stream) {
  return launch_error<9>(N, bal_cams(R, t, calib), pts, rows, uv, kind,
                         stride, noise, sign, loss, lparam, mu, partial,
                         counter, out, stream);
}

GT_EXPORT int gt_proj3_error(int N, const double* R, const double* t,
                             const double* pts, const int* rows,
                             const double* uv, const double* K,
                             const double* ext, int kind, int stride,
                             const double* noise, double sign, int loss,
                             double lparam, double mu, double* partial,
                             int* counter, double* out, void* stream) {
  return launch_error<6>(N, pinhole_cams(R, t, K, ext), pts, rows, uv, kind,
                         stride, noise, sign, loss, lparam, mu, partial,
                         counter, out, stream);
}
