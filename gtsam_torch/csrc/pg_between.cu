// Kernel 6: SE3 between / prior factors of the pose graph -- linearization,
// block-store assembly and the half-chi2 (float64 throughout).
//
// Replaces: gtsam_tpu/graph/factors.py::linearize (:147-176, via jacfwd of
// _between_residual :186 and _prior_residual :208) for SE3 batches, the
// assembly of gtsam_tpu/linear/supernodal.py::system (:320-368), and
// gtsam_tpu/graph/graph.py::BoundGraph.error (:108-126) for those batches.
//
// gt_pg_linearize: one thread per factor.  With r = Log(Z^-1 Ti^-1 Tj),
//   A_j = R_w Jr^-1(r),  A_i = -R_w Jr^-1(r) Ad(Tj^-1 Ti),  b = -R_w r
// (a prior: A = R_w Jr^-1(r) with r = Log(Z^-1 Ti)), Jr^-1 the exact SE(3)
// right-Jacobian inverse with its Q(omega, v) block, Taylor series below
// theta^2 = 5e-3 (gtsam_torch/geometry/se3.py::right_jacobian_inverse, the
// plain version's formulas).  R_w is unit, diagonal or a full 6x6 square-root
// information.  The thread writes sign A_s1^T A_s2 for each slot pair
// (s1 <= s2; the (0, 1) block transposed where flip says the plan stores it
// so) and sign A_s^T b into the contribution buffer, factor-major.
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
// gt_pg_error: one block; each thread sums its strided factors, then a
// fixed shared-memory tree.
//
// Bound on the H100: linearize by FP64 operations (~2,000 a between factor)
// against 0.5 KB of traffic; assemble by bytes: T's contribution rows read
// and T's blocks written once (sphere stand-in: 14,848 and 7,449 rows of
// 288 B, ~6.7 MB with g and the indices, ~0.002 ms at 3.35 TB/s), where the
// first design wrote the whole 36 MB store on every call.
#include "ba_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kErrorThreads = 512;   // ERROR_THREADS in supernodal_kernels.py
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
    const double A = sin(th) / th;
    const double B = (1.0 - cos(th)) / th2;
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
    a1 = 1.0 / 6 - x / 120 + x * x / 5040 - x * x * x / 362880;
    a2 = 1.0 / 24 - x / 720 + x * x / 40320 - x * x * x / 3628800;
    a3 = 1.0 / 120 - x / 2520 + x * x / 120960 - x * x * x / 9979200;
    E = 1.0 / 12 + x / 720 + x * x / 30240 + x * x * x / 1209600;
  } else {
    const double th = sqrt(x);
    const double s = sin(th), c = cos(th);
    a1 = (th - s) / (x * th);
    a2 = (x + 2 * c - 2) / (2 * x * x);
    a3 = (2 * th - 3 * s + th * c) / (2 * x * x * th);
    E = 1 / x - cos(0.5 * th) / (2 * th * sin(0.5 * th));
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

// A = R_w M for the 6x6 M (row-major), in place
__device__ __forceinline__ void whiten_mat(int kind, const double* nz,
                                           double* M) {
  if (kind == 0) return;
  if (kind == 1) {
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j < 6; ++j) M[6 * i + j] *= nz[i];
    return;
  }
  double col[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
#pragma unroll
    for (int i = 0; i < 6; ++i) col[i] = M[6 * i + j];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      double acc = 0.0;
#pragma unroll
      for (int l = 0; l < 6; ++l) acc += nz[6 * i + l] * col[l];
      M[6 * i + j] = acc;
    }
  }
}

// out (d x d block at H) = sign * A^T B, transposed if flip; zero padding
__device__ __forceinline__ void store_pair(const double* A, const double* B,
                                           double sign, bool flip, int d,
                                           double* H) {
  for (int i = 0; i < d; ++i)
    for (int j = 0; j < d; ++j) {
      double v = 0.0;
      if (i < 6 && j < 6) {
        const int a = flip ? j : i, b = flip ? i : j;
        double acc = 0.0;
#pragma unroll
        for (int r = 0; r < 6; ++r) acc += A[6 * r + a] * B[6 * r + b];
        v = sign * acc;
      }
      H[d * i + j] = v;
    }
}

__global__ void __launch_bounds__(kThreads) pg_linearize_kernel(
    int N, int arity, int d, const double* __restrict__ R,
    const double* __restrict__ t, const int* __restrict__ rows,
    const double* __restrict__ ZR, const double* __restrict__ Zt, int kind,
    int stride, const double* __restrict__ noise, double sign,
    const unsigned char* __restrict__ flip, double* __restrict__ H,
    double* __restrict__ gv) {
  const int64_t k = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (k >= N) return;
  double r[6];
  Pose Tji;
  residual(R, t, rows, ZR, Zt, arity, k, r, Tji);
  const double* nz = kind == 0 ? nullptr : noise + (int64_t)stride * k;
  double Jw[9], Q2[9];
  jr_inverse(r, Jw, Q2);
  double Aj[36];   // Jr^-1 = [[Jw, 0], [Q2, Jw]]
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      Aj[6 * i + j] = Jw[3 * i + j];
      Aj[6 * i + 3 + j] = 0.0;
      Aj[6 * (3 + i) + j] = Q2[3 * i + j];
      Aj[6 * (3 + i) + 3 + j] = Jw[3 * i + j];
    }
  double b[6], wr[6];
  whiten_vec(kind, nz, r, wr);
#pragma unroll
  for (int i = 0; i < 6; ++i) b[i] = -wr[i];
  const int npair = arity == 2 ? 3 : 1;
  double* Hk = H + (int64_t)npair * d * d * k;
  double* gk = gv + (int64_t)arity * d * k;
  if (arity == 1) {
    whiten_mat(kind, nz, Aj);
    store_pair(Aj, Aj, sign, false, d, Hk);
  } else {
    // A_i = -Jr^-1 Ad(Tji), Ad = [[R, 0], [hat(t) R, R]]:
    // [[Jw R, 0], [Q2 R + Jw hat(t) R, Jw R]]
    double tR[9], t_hat[9], JR[9], QR[9], JtR[9], Ai[36];
    hat(Tji.t, t_hat);
    mm3(t_hat, Tji.R, tR);
    mm3(Jw, Tji.R, JR);
    mm3(Q2, Tji.R, QR);
    mm3(Jw, tR, JtR);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        Ai[6 * i + j] = -JR[3 * i + j];
        Ai[6 * i + 3 + j] = -0.0;
        Ai[6 * (3 + i) + j] = -(QR[3 * i + j] + JtR[3 * i + j]);
        Ai[6 * (3 + i) + 3 + j] = -JR[3 * i + j];
      }
    whiten_mat(kind, nz, Ai);
    whiten_mat(kind, nz, Aj);
    store_pair(Ai, Ai, sign, false, d, Hk);
    store_pair(Ai, Aj, sign, flip[k] != 0, d, Hk + d * d);
    store_pair(Aj, Aj, sign, false, d, Hk + 2 * d * d);
    for (int i = 0; i < d; ++i) {
      double acc = 0.0;
      if (i < 6) {
#pragma unroll
        for (int q = 0; q < 6; ++q) acc += Ai[6 * q + i] * b[q];
        acc *= sign;
      }
      gk[i] = acc;
    }
    gk += d;
  }
  for (int i = 0; i < d; ++i) {
    double acc = 0.0;
    if (i < 6) {
#pragma unroll
      for (int q = 0; q < 6; ++q) acc += Aj[6 * q + i] * b[q];
      acc *= sign;
    }
    gk[i] = acc;
  }
}

__global__ void __launch_bounds__(kErrorThreads) pg_error_kernel(
    int N, int arity, const double* __restrict__ R,
    const double* __restrict__ t, const int* __restrict__ rows,
    const double* __restrict__ ZR, const double* __restrict__ Zt, int kind,
    int stride, const double* __restrict__ noise, double sign,
    double* __restrict__ out) {
  __shared__ double red[kErrorThreads];
  double acc = 0.0;
  for (int64_t k = threadIdx.x; k < N; k += kErrorThreads) {
    double r[6], wr[6];
    Pose Tji;
    residual(R, t, rows, ZR, Zt, arity, k, r, Tji);
    whiten_vec(kind, kind == 0 ? nullptr : noise + (int64_t)stride * k, r, wr);
#pragma unroll
    for (int i = 0; i < 6; ++i) acc += wr[i] * wr[i];
  }
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int h = kErrorThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = sign * (0.5 * red[0]);
}

constexpr int kAsmThreads = 256;               // 8 warps: 8 blocks of T
constexpr int kAsmWarps = kAsmThreads / gt::kWarp;
constexpr int kMaxD = 12;                       // store width d <= 12
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

// N factors of arity 1 (prior) or 2 (between); d >= 6 the store's block
// width; kind 0 unit, 1 diagonal, 2 gaussian noise, `stride` doubles apart
// (0: one model shared by every factor).  H: N x npair x d*d, gv: N x arity x d.
GT_EXPORT int gt_pg_linearize(int N, int arity, int d, const double* R,
                              const double* t, const int* rows,
                              const double* ZR, const double* Zt, int kind,
                              int stride, const double* noise, double sign,
                              const unsigned char* flip, double* H,
                              double* gv, void* stream) {
  if (N > 0)
    pg_linearize_kernel<<<(N + kThreads - 1) / kThreads, kThreads, 0,
                          (cudaStream_t)stream>>>(N, arity, d, R, t, rows, ZR,
                                                  Zt, kind, stride, noise,
                                                  sign, flip, H, gv);
  return (int)cudaGetLastError();
}

GT_EXPORT int gt_pg_error(int N, int arity, const double* R, const double* t,
                          const int* rows, const double* ZR, const double* Zt,
                          int kind, int stride, const double* noise,
                          double sign, double* out, void* stream) {
  pg_error_kernel<<<1, kErrorThreads, 0, (cudaStream_t)stream>>>(
      N, arity, R, t, rows, ZR, Zt, kind, stride, noise, sign, out);
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
