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
// proj_gram_kernel<kCam, kLoss> (the Gram mode): a CTA of 256 threads owns
// a chunk of 256 of the batch's factors, in the order of a plan built on
// the host (linear/supernodal_kernels.py::proj_gram_plan: the factors
// sorted by their point's first camera, then by point, so a point's
// observations share a chunk and a chunk holds few cameras), a thread
// each.  While a thread linearizes its factor, the CTA stages the chunk's
// plan in shared memory; the thread then stages its factor's whitened
// Jacobians and b there (27 doubles at kCam = 9, 21 at 6; 55 KB at 9).
// The chunk's rows -- one for each camera, (camera, point) pair and point
// its factors name, and for each camera and point gradient row -- are
// consecutive rows of H and of gv, and their entries go to the threads in
// turn: an entry is the sum over the row's factors, in the plan's order,
// of the per-factor product (sign A_c^T A_c, sign A_c^T A_p, or its
// transpose where the row's flip says the store holds the pair so, sign
// A_p^T A_p, sign A^T b), zero outside the block's leading dims.  A
// camera's blocks of one chunk are summed there, so the assembly
// (pg_assemble) reads one row a chunk for it in place of one a factor: at
// the dubrovnik-16-22106 stand-in at most 197 in place of ~4,800.
// proj_jacobians_kernel<kCam, kLoss> (the Jacobian mode): a CTA is one
// warp and owns 32 consecutive factors, a lane each, which writes its
// whitened rows into the pool (N, 2, rmax, d) -- rows 0-1 of each slot,
// zero past the slot's width.
// proj_error_kernel<kCam, kExt>: a lane a factor (twice its error:
// ||R_w r||^2, 2 rho(||R_w r||), or ||R_w r||^2 + mu r^2 on the hard rows
// of a constrained model), the warp's butterfly sum into a CTA partial,
// the last CTA (an atomic completion ticket) summing the partials in index
// order: the order of every addition depends on N alone.
// No value is summed by atomics, so the same inputs give the same bits.
//
// Bound on the H100: bytes.  A factor reads 228 bytes (its camera, point,
// measurement, rows); the Gram mode writes its plan's rows, 81 doubles a
// row of H at d = 9 (one a chunk and camera, a camera-point pair, a point:
// ~1.3 a factor at the stand-in), against ~740 FP64 operations a factor.
// (A row a factor and block wrote 3 * 81 + 18 doubles a factor, 2,088
// bytes, most of it the padding of the point's 3x3 and 9x3 blocks to 9x9:
// the JAX package's store layout, gtsam_tpu/linear/supernodal.py:99-111.)
#include "pg_losses.cuh"
#include "projection.cuh"

namespace {

using namespace pg;

constexpr int kFactors = gt::kWarp;        // PROJ_FACTORS (Python)
constexpr int kChunk = 256;                // PROJ_CHUNK (Python)
constexpr int kChunkWarps = kChunk / gt::kWarp;
constexpr int kRows = 5 * kChunk;          // a chunk's rows (and members)
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

// Factor k's whitened Jacobians Jc (2 x kCam), Jp (2 x 3), row-major, and
// b = -R_w r, all scaled by sqrt(w(||R_w r||)) under a loss.
template <int kCam, bool kLoss>
__device__ __forceinline__ void whitened(const Cams& cams, int64_t k,
                                         const double* __restrict__ pts,
                                         const int* __restrict__ rows,
                                         const double* __restrict__ uv,
                                         int kind, int stride,
                                         const double* __restrict__ noise,
                                         int loss, double lparam, double* Jc,
                                         double* Jp, double b[2]) {
  double r[2];
  residual<kCam>(cams, k, pts, rows, uv, r, Jc, Jp);
  const double* nz = kind == 0 ? nullptr : noise + (int64_t)stride * k;
  double wr[2];
  whiten2(kind, nz, r[0], r[1], wr);
  double sw = 1.0;
  if (kLoss)
    sw = sqrt(loss_weight(loss, lparam, sqrt(wr[0] * wr[0] + wr[1] * wr[1])));
  whiten_rows<kCam>(kind, nz, sw, Jc);
  whiten_rows<3>(kind, nz, sw, Jp);
  b[0] = -(wr[0] * sw);
  b[1] = -(wr[1] * sw);
}

// The Jacobian mode: a lane a factor, its rows into the pool.
template <int kCam, bool kLoss>
__global__ void __launch_bounds__(kFactors) proj_jacobians_kernel(
    int N, int d, int rmax, Cams cams, const double* __restrict__ pts,
    const int* __restrict__ rows, const double* __restrict__ uv, int kind,
    int stride, const double* __restrict__ noise, int loss, double lparam,
    double* __restrict__ A) {
  const int64_t k = (int64_t)blockIdx.x * kFactors + threadIdx.x;
  if (k >= N) return;
  double Jc[2 * kCam], Jp[6], b[2];
  whitened<kCam, kLoss>(cams, k, pts, rows, uv, kind, stride, noise, loss,
                        lparam, Jc, Jp, b);
  double* a = A + k * 2 * rmax * d;
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
}

// A factor's staged rows in proj_gram_kernel's shared memory: Jc's two
// rows, Jp's two, then b (odd strides keep the lanes on distinct banks).
template <int kCam>
struct Stage {
  static constexpr int kP = 2 * kCam;          // Jp's first row
  static constexpr int kB = kP + 6;            // b0, b1
  static constexpr int kStride = (kB + 2) | 1;
  // then the chunk's plan: a row's code and output row (at most kRows
  // rows), its factors' positions (kRows)
  static constexpr int kBytes = kChunk * kStride * 8 + 3 * kRows * 4;
};

// The Gram mode: CTA c owns the chunk order[c * kChunk ..] of the batch,
// a thread a factor; each thread stages its factor's whitened rows, then
// the threads take the entries of the chunk's rows of the plan (staged
// in shared memory while the factors are linearized) in turn, a thread an
// entry: an entry of a row of H (kinds 0-2: camera-camera, camera-point,
// point-point) is the sum over the row's members (chunk positions
// mem[mptr[r] ..], ascending) of sign (a_0 b_0 + a_1 b_1) for the entry's
// two Jacobian columns, the per-factor product; a camera-point row with
// flip set transposed; zero outside the leading dims.  A row of gv (kinds
// 3-4) likewise with b.  A chunk's rows of H, and its rows of gv, are
// consecutive rows of H and gv (the plan lists them so), so each store
// instruction of a warp writes 256 contiguous bytes.
template <int kCam, bool kLoss>
__global__ void __launch_bounds__(kChunk, 2) proj_gram_kernel(
    int N, int d, Cams cams, const double* __restrict__ pts,
    const int* __restrict__ rows, const double* __restrict__ uv, int kind,
    int stride, const double* __restrict__ noise, double sign, int loss,
    double lparam, const int* __restrict__ order,
    const int* __restrict__ cptr, const int* __restrict__ rkind,
    const int* __restrict__ mptr, const int* __restrict__ mem,
    const int* __restrict__ rout, const unsigned char* __restrict__ flip,
    double* __restrict__ H, double* __restrict__ gv) {
  using S = Stage<kCam>;
  extern __shared__ double sJ[];   // kChunk factors, S::kStride each
  int* sCode = reinterpret_cast<int*>(sJ + kChunk * S::kStride);
  int* sOut = sCode + kRows;
  int* sMem = sOut + kRows;
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int64_t q = (int64_t)c * kChunk + tid;
  const int nf = min((int64_t)kChunk, (int64_t)N - (int64_t)c * kChunk);
  // the chunk's plan into shared memory, its loads in flight while the
  // factors are linearized: a row's kind | flip << 3 | its first member's
  // offset << 4, its output row, and its members' positions
  __shared__ int sNh;   // the chunk's rows of H: its rows before the first
                        // of kind 3 (a chunk has rows of every kind)
  const int r0 = cptr[c], nr = cptr[c + 1] - r0, mbase = mptr[r0];
  for (int k = tid; k < nr; k += kChunk) {
    const int kd = rkind[r0 + k];
    sCode[k] = kd | (flip[r0 + k] ? 8 : 0) | ((mptr[r0 + k] - mbase) << 4);
    sOut[k] = rout[r0 + k];
    if (kd >= 3 && rkind[r0 + k - 1] < 3) sNh = k;
  }
  for (int k = tid; k < 5 * nf; k += kChunk) sMem[k] = mem[mbase + k];
  if (q < N) {
    double Jc[2 * kCam], Jp[6], b[2];
    whitened<kCam, kLoss>(cams, order[q], pts, rows, uv, kind, stride, noise,
                          loss, lparam, Jc, Jp, b);
    double* x = sJ + tid * S::kStride;
#pragma unroll
    for (int i = 0; i < 2 * kCam; ++i) x[i] = Jc[i];
#pragma unroll
    for (int i = 0; i < 6; ++i) x[S::kP + i] = Jp[i];
    x[S::kB] = b[0];
    x[S::kB + 1] = b[1];
  }
  __syncthreads();

  // the chunk's rows of H (its first nh rows, kinds 0-2) are consecutive
  // rows of H from sOut[0], its rows of gv from sOut[nh]: the threads take
  // their entries in turn, thread t entries t, t + kChunk, ..., so each
  // warp's stores are 256 contiguous bytes
  const int nh = sNh;
  const int dd = d * d;
  double* Hc = H + (int64_t)sOut[0] * dd;
  int r = tid / dd, e = tid - (tid / dd) * dd;
  const int rq = kChunk / dd, rr = kChunk - rq * dd;
  for (int f = tid; f < nh * dd; f += kChunk) {
    const int code = sCode[r];
    const int kd = code & 7;
    const int m0 = code >> 4, m1 = sCode[r + 1] >> 4;
    int i = e / d, j = e - (e / d) * d;
    if (code & 8) {   // entry (i, j) of the transpose: the product's (j, i)
      const int t = i;
      i = j;
      j = t;
    }
    // column i of the first slot's rows (at ao, ao + as), column j of the
    // second's (bo, bo + bs)
    const bool cam1 = kd < 2, cam2 = kd == 0;
    const int w1 = cam1 ? kCam : 3, w2 = cam2 ? kCam : 3;
    const int ao = (cam1 ? 0 : S::kP) + i, as = w1;
    const int bo = (cam2 ? 0 : S::kP) + j, bs = w2;
    double acc = 0.0;
    if (i < w1 && j < w2) {
      for (int m = m0; m < m1; ++m) {
        const double* x = sJ + sMem[m] * S::kStride;
        acc += sign * (x[ao] * x[bo] + x[ao + as] * x[bo + bs]);
      }
    }
    Hc[f] = acc;
    r += rq;
    e += rr;
    if (e >= dd) {
      e -= dd;
      ++r;
    }
  }
  double* Gc = gv + (int64_t)sOut[nh] * d;
  r = nh + tid / d;
  e = tid - (tid / d) * d;
  const int gq = kChunk / d, gr = kChunk - gq * d;
  for (int f = tid; f < (nr - nh) * d; f += kChunk) {
    const int code = sCode[r];
    const bool cam = (code & 7) == 3;
    const int m0 = code >> 4;
    const int m1 = r + 1 < nr ? sCode[r + 1] >> 4 : 5 * nf;
    const int w = cam ? kCam : 3, ao = cam ? 0 : S::kP;
    double acc = 0.0;
    if (e < w) {
      for (int m = m0; m < m1; ++m) {
        const double* x = sJ + sMem[m] * S::kStride;
        acc += sign * (x[ao + e] * x[S::kB] + x[ao + w + e] * x[S::kB + 1]);
      }
    }
    Gc[f] = acc;
    r += gq;
    e += gr;
    if (e >= d) {
      e -= d;
      ++r;
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

template <int kCam>
int launch_jacobians(int N, int d, int rmax, const Cams& cams,
                     const double* pts, const int* rows, const double* uv,
                     int kind, int stride, const double* noise, int loss,
                     double lparam, double* A, void* stream) {
  if (d < kCam || d > kMaxD || rmax < 2 || loss < kLossNone ||
      loss > kLossDeadZone)
    return (int)cudaErrorInvalidValue;
  if (kind == kConstrained) kind = 1;   // hard rows whiten to 0
  const int grid = (N + kFactors - 1) / kFactors;
  const cudaStream_t st = (cudaStream_t)stream;
  if (N > 0 && loss != kLossNone)
    proj_jacobians_kernel<kCam, true><<<grid, kFactors, 0, st>>>(
        N, d, rmax, cams, pts, rows, uv, kind, stride, noise, loss, lparam,
        A);
  else if (N > 0)
    proj_jacobians_kernel<kCam, false><<<grid, kFactors, 0, st>>>(
        N, d, rmax, cams, pts, rows, uv, kind, stride, noise, loss, lparam,
        A);
  return (int)cudaGetLastError();
}

template <int kCam, bool kLoss>
void gram(int grid, cudaStream_t st, int N, int d, const Cams& cams,
          const double* pts, const int* rows, const double* uv, int kind,
          int stride, const double* noise, double sign, int loss,
          double lparam, const int* order, const int* cptr, const int* rkind,
          const int* mptr, const int* mem, const int* rout,
          const unsigned char* flip, double* H, double* gv) {
  constexpr int shm = Stage<kCam>::kBytes;
  cudaFuncSetAttribute(proj_gram_kernel<kCam, kLoss>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, shm);
  proj_gram_kernel<kCam, kLoss><<<grid, kChunk, shm, st>>>(
      N, d, cams, pts, rows, uv, kind, stride, noise, sign, loss, lparam,
      order, cptr, rkind, mptr, mem, rout, flip, H, gv);
}

template <int kCam>
int launch_gram(int N, int d, const Cams& cams, const double* pts,
                const int* rows, const double* uv, int kind, int stride,
                const double* noise, double sign, int loss, double lparam,
                const int* order, const int* cptr, const int* rkind,
                const int* mptr, const int* mem, const int* rout,
                const unsigned char* flip, double* H, double* gv,
                void* stream) {
  if (d < kCam || d > kMaxD || loss < kLossNone || loss > kLossDeadZone)
    return (int)cudaErrorInvalidValue;
  if (kind == kConstrained) kind = 1;   // hard rows whiten to 0
  const int grid = (N + kChunk - 1) / kChunk;
  const cudaStream_t st = (cudaStream_t)stream;
  if (N > 0 && loss != kLossNone)
    gram<kCam, true>(grid, st, N, d, cams, pts, rows, uv, kind, stride,
                     noise, sign, loss, lparam, order, cptr, rkind, mptr,
                     mem, rout, flip, H, gv);
  else if (N > 0)
    gram<kCam, false>(grid, st, N, d, cams, pts, rows, uv, kind, stride,
                      noise, sign, loss, lparam, order, cptr, rkind, mptr,
                      mem, rout, flip, H, gv);
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
// none) and its parameter.  The Gram plan (linear/supernodal_kernels.py,
// GramPlan): order (N), cptr (ceil(N / kChunk) + 1), rkind, mptr, mem,
// rout and flip of its rows; H: its rows of kinds 0-2 (d*d each), gv: of
// kinds 3-4 (d each).
GT_EXPORT int gt_proj_linearize(int N, int d, const double* R,
                                const double* t, const double* calib,
                                const double* pts, const int* rows,
                                const double* uv, int kind, int stride,
                                const double* noise, double sign, int loss,
                                double lparam, const int* order,
                                const int* cptr, const int* rkind,
                                const int* mptr, const int* mem,
                                const int* rout, const unsigned char* flip,
                                double* H, double* gv, void* stream) {
  return launch_gram<9>(N, d, bal_cams(R, t, calib), pts, rows, uv, kind,
                        stride, noise, sign, loss, lparam, order, cptr,
                        rkind, mptr, mem, rout, flip, H, gv, stream);
}

// The SE3 + Cal3_S2 camera: K (5), ext (12) or null; 6 <= d <= 12.
GT_EXPORT int gt_proj3_linearize(int N, int d, const double* R,
                                 const double* t, const double* pts,
                                 const int* rows, const double* uv,
                                 const double* K, const double* ext, int kind,
                                 int stride, const double* noise, double sign,
                                 int loss, double lparam, const int* order,
                                 const int* cptr, const int* rkind,
                                 const int* mptr, const int* mem,
                                 const int* rout, const unsigned char* flip,
                                 double* H, double* gv, void* stream) {
  return launch_gram<6>(N, d, pinhole_cams(R, t, K, ext), pts, rows, uv,
                        kind, stride, noise, sign, loss, lparam, order, cptr,
                        rkind, mptr, mem, rout, flip, H, gv, stream);
}

// The Jacobian mode: A (N x 2 x rmax x d), slot s of factor n's rows 0-1
// written (zero past the slot's width), rmax >= 2; no sign.
GT_EXPORT int gt_proj_jacobians(int N, int d, int rmax, const double* R,
                                const double* t, const double* calib,
                                const double* pts, const int* rows,
                                const double* uv, int kind, int stride,
                                const double* noise, int loss, double lparam,
                                double* A, void* stream) {
  return launch_jacobians<9>(N, d, rmax, bal_cams(R, t, calib), pts, rows,
                             uv, kind, stride, noise, loss, lparam, A,
                             stream);
}

GT_EXPORT int gt_proj3_jacobians(int N, int d, int rmax, const double* R,
                                 const double* t, const double* pts,
                                 const int* rows, const double* uv,
                                 const double* K, const double* ext, int kind,
                                 int stride, const double* noise, int loss,
                                 double lparam, double* A, void* stream) {
  return launch_jacobians<6>(N, d, rmax, pinhole_cams(R, t, K, ext), pts,
                             rows, uv, kind, stride, noise, loss, lparam, A,
                             stream);
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
