// Kernel 10: factor and invert one diagonal block of the blocked dense
// Cholesky (float64, and float32 for the mixed mode).
//
// Replaces: gtsam_tpu/linear/dense_blocked.py::blocked_cholesky's panel
// leaf (:83-85): jnp.linalg.cholesky of the panel's diagonal block D and
// the triangular solve that inverts its factor L_D.
//
// One launch per panel of gtsam_torch/linear/dense_blocked.py, on its
// critical path: D = S[o:o+w, o:o+w] (the lower triangle, already updated
// by the earlier panels; w = 128, or less for the last panel) is staged in
// shared memory as the 10 lower 32 x 32 tiles of a 128 x 128 block, the
// rows and columns past w set to the identity.  Right-looking over its 4
// tile columns: warp 0 factors the diagonal tile (a lane per row, the row
// in registers, the pivot column shared by shuffles, one reciprocal square
// root a step) and inverts it (a lane per column, right-looking forward
// substitution); the CTA forms the tiles below as
// A_it X_tt^T and updates the trailing tiles, a 4 x 4 micro-tile of a
// 32-deep product per thread.  Then L_D^-1 is composed tile by tile:
// X_ij = -X_ii sum_{m=j}^{i-1} L_im X_mj, by distance i - j.  L_D goes back
// into S's lower triangle (the strict upper triangle of S is never read or
// written), L_D^-1 to Dinv[k] (128 x 128 row-major, zero above the
// diagonal, the identity past w).  The first pivot that is not positive and
// finite is recorded in *info as its column + 1 (LAPACK's convention), once:
// a later failure leaves an earlier one in place.
// Bound on the H100: the block's bytes, ~0.1 us; what sets its time is
// the chain of 4 tile factorizations and inversions by one warp and the
// CTA barriers between the tile steps.
#include <cmath>

#include "ba_common.cuh"

namespace {

constexpr int kNB = 128;            // panel width
constexpr int kTile = 32;
constexpr int kNT = kNB / kTile;    // tile rows / columns of the block
constexpr int kLd = kTile + 1;      // shared row stride of a tile
constexpr int kTileSz = kTile * kLd;
constexpr int kTiles = kNT * (kNT + 1) / 2;   // lower tiles of the block
constexpr int kThreads = 512;

__host__ __device__ constexpr int tid_of(int i, int j) {
  return i * (i + 1) / 2 + j;
}

// the tile row of lower tile q (q = tid_of(i, j))
__host__ __device__ constexpr int tile_row(int q) {
  return q < 1 ? 0 : q < 3 ? 1 : q < 6 ? 2 : 3;
}
static_assert(kNT == 4, "tile_row covers 4 tile rows");

// Factor the lower triangle of one staged tile in place; a lane per row,
// the row in registers.  Each step takes one reciprocal square root of the
// pivot: L_kk = p rsqrt(p), the column below is scaled by rsqrt(p), which
// also goes to rinv[k] for invert_tile.
template <typename T>
__device__ void factor_tile(T* a, T* rinv, int col0, int* info) {
  const int lane = threadIdx.x & 31;
  T row[kTile];
#pragma unroll
  for (int j = 0; j < kTile; ++j) row[j] = j <= lane ? a[lane * kLd + j] : T(0);
#pragma unroll
  for (int k = 0; k < kTile; ++k) {
    const T p = __shfl_sync(0xffffffffu, row[k], k);
    if (!(p > T(0)) || isinf(p)) {
      if (lane == 0 && *info == 0) *info = col0 + k + 1;
    }
    const T rs = rsqrt(p);
    if (lane == k) {
      row[k] = p * rs;
      rinv[k] = rs;
    } else if (lane > k) {
      row[k] *= rs;
    }
    const T l = row[k];
#pragma unroll
    for (int j = k + 1; j < kTile; ++j) {
      const T lj = __shfl_sync(0xffffffffu, l, j);
      if (lane >= j) row[j] -= l * lj;
    }
  }
#pragma unroll
  for (int j = 0; j < kTile; ++j)
    if (j <= lane) a[lane * kLd + j] = row[j];
  __syncwarp();
}

// x = inverse of the factored tile a (lower), written whole (zeros above
// the diagonal); a lane per column of x, right-looking, so that the updates
// of a step are independent of each other.  rinv: the reciprocals of a's
// diagonal (factor_tile).
template <typename T>
__device__ void invert_tile(const T* a, const T* rinv, T* x) {
  const int lane = threadIdx.x & 31;
  T v[kTile];
#pragma unroll
  for (int i = 0; i < kTile; ++i) v[i] = i == lane ? T(1) : T(0);
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    v[j] *= rinv[j];
#pragma unroll
    for (int i = j + 1; i < kTile; ++i) v[i] -= a[i * kLd + j] * v[j];
  }
#pragma unroll
  for (int i = 0; i < kTile; ++i) x[i * kLd + lane] = v[i];
  __syncwarp();
}

// The 4 x 4 micro-tile (r0, c0) of the 32-deep product A B (kTransB: A B^T)
// added into acc.
template <bool kTransB, typename T>
__device__ __forceinline__ void micro_mm(const T* A, const T* B, int r0,
                                         int c0, T acc[4][4]) {
#pragma unroll 8
  for (int m = 0; m < kTile; ++m) {
    T a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = A[(r0 + i) * kLd + m];
      b[i] = kTransB ? B[(c0 + i) * kLd + m] : B[m * kLd + c0 + i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
  }
}

// This thread's job among `count` output tiles: (slot, r0, c0), or false.
__device__ __forceinline__ bool job(int count, int& slot, int& r0, int& c0) {
  const int u = threadIdx.x;
  slot = u >> 6;
  const int micro = u & 63;
  r0 = (micro >> 3) * 4;
  c0 = (micro & 7) * 4;
  return slot < count;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) dense_factor_diag_kernel(
    int n, int ld, int k, T* __restrict__ S, T* __restrict__ Dinv,
    int* __restrict__ info) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* A = reinterpret_cast<T*>(smem);       // kTiles tiles of L_D
  T* X = A + kTiles * kTileSz;             // kTiles tiles of L_D^-1
  __shared__ T rinv[kTile];                // 1 / L_tt's diagonal
  const int o = k * kNB, w = min(kNB, n - o);
  const int warp = threadIdx.x >> 5;

  // stage D's lower tiles, the identity past w: every load of the thread
  // in flight at once, then the stores
  constexpr int kPer = kTile * kTile / kThreads;   // elements a tile, each
  T v[kTiles * kPer];
#pragma unroll
  for (int q = 0; q < kTiles; ++q)
#pragma unroll
    for (int h = 0; h < kPer; ++h) {
      const int i = tile_row(q), j = q - tid_of(i, 0);
      const int e = threadIdx.x + h * kThreads, r = e >> 5, c = e & 31;
      const int R = i * kTile + r, C = j * kTile + c;
      v[q * kPer + h] = R < w && C <= R ? S[(int64_t)(o + R) * ld + o + C]
                        : R == C      ? T(1) : T(0);
    }
#pragma unroll
  for (int q = 0; q < kTiles; ++q)
#pragma unroll
    for (int h = 0; h < kPer; ++h) {
      const int e = threadIdx.x + h * kThreads;
      A[q * kTileSz + (e >> 5) * kLd + (e & 31)] = v[q * kPer + h];
    }
  __syncthreads();

  for (int t = 0; t < kNT; ++t) {
    if (warp == 0) {
      factor_tile(A + tid_of(t, t) * kTileSz, rinv, o + t * kTile, info);
      invert_tile(A + tid_of(t, t) * kTileSz, rinv,
                  X + tid_of(t, t) * kTileSz);
    }
    __syncthreads();
    if (t + 1 == kNT) break;
    // the tiles below: A_it <- A_it X_tt^T (staged: every thread reads
    // whole rows of A_it)
    int slot, r0, c0;
    T acc[4][4] = {};
    const bool mine = job(kNT - 1 - t, slot, r0, c0);
    const int ip = t + 1 + slot;
    if (mine)
      micro_mm<true>(A + tid_of(ip, t) * kTileSz,
                     X + tid_of(t, t) * kTileSz, r0, c0, acc);
    __syncthreads();
    if (mine) {
      T* out = A + tid_of(ip, t) * kTileSz;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) out[(r0 + i) * kLd + c0 + j] = acc[i][j];
    }
    __syncthreads();
    // the trailing tiles (i, j), t < j <= i: A_ij -= A_it A_jt^T, in place
    // (each thread owns its micro-tile; A_it and A_jt are only read)
    const int m = kNT - 1 - t;
    if (job(m * (m + 1) / 2, slot, r0, c0)) {
      int i = t + 1, j = t + 1;
      for (int s = 0; s < slot; ++s)
        if (j < i) ++j; else { ++i; j = t + 1; }
      T sub[4][4] = {};
      micro_mm<true>(A + tid_of(i, t) * kTileSz, A + tid_of(j, t) * kTileSz,
                     r0, c0, sub);
      T* out = A + tid_of(i, j) * kTileSz;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) out[(r0 + a) * kLd + c0 + b] -= sub[a][b];
    }
    __syncthreads();
  }

  // L_D^-1 below the diagonal tiles, by distance d = i - j
  for (int d = 1; d < kNT; ++d) {
    int slot, r0, c0;
    const bool mine = job(kNT - d, slot, r0, c0);
    const int i = d + slot, j = slot;
    if (mine) {   // X_ij <- sum_{m=j}^{i-1} L_im X_mj (X_mj is final)
      T acc[4][4] = {};
      for (int m = j; m < i; ++m)
        micro_mm<false>(A + tid_of(i, m) * kTileSz, X + tid_of(m, j) * kTileSz,
                        r0, c0, acc);
      T* out = X + tid_of(i, j) * kTileSz;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) out[(r0 + a) * kLd + c0 + b] = acc[a][b];
    }
    __syncthreads();
    T acc[4][4] = {};
    if (mine)      // X_ij <- -X_ii X_ij (staged)
      micro_mm<false>(X + tid_of(i, i) * kTileSz, X + tid_of(i, j) * kTileSz,
                      r0, c0, acc);
    __syncthreads();
    if (mine) {
      T* out = X + tid_of(i, j) * kTileSz;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) out[(r0 + a) * kLd + c0 + b] = -acc[a][b];
    }
    __syncthreads();
  }

  // L_D into S's lower triangle, L_D^-1 into Dinv[k]
  for (int i = 0, q = 0; i < kNT; ++i)
    for (int j = 0; j <= i; ++j, ++q)
      for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
        const int r = e >> 5, c = e & 31;
        const int R = i * kTile + r, C = j * kTile + c;
        if (R < w && C <= R)
          S[(int64_t)(o + R) * ld + o + C] = A[q * kTileSz + r * kLd + c];
      }
  T* out = Dinv + (int64_t)k * kNB * kNB;
  for (int e = threadIdx.x; e < kNB * kNB; e += kThreads) {
    const int R = e / kNB, C = e - R * kNB;
    const int i = R / kTile, j = C / kTile, r = R % kTile, c = C % kTile;
    out[e] = (j < i || (j == i && c <= r))
                 ? X[tid_of(i, j) * kTileSz + r * kLd + c] : T(0);
  }
}

template <typename T>
int launch_factor(int n, int ld, int k, T* S, T* Dinv, int* info,
                  void* stream) {
  const size_t shm = 2 * kTiles * kTileSz * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(
      dense_factor_diag_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shm);
  if (e != cudaSuccess) return (int)e;
  dense_factor_diag_kernel<T><<<1, kThreads, shm, (cudaStream_t)stream>>>(
      n, ld, k, S, Dinv, info);
  return (int)cudaGetLastError();
}

}  // namespace

// S: n x n row-major, rows ld entries apart (lower triangle read and
// written); Dinv: panels x 128 x 128; info: one int, 0 until a pivot fails.
// k: the panel (0 <= k < ceil(n / 128)).
GT_EXPORT int gt_dense_factor_diag(int n, int ld, int k, double* S,
                                   double* Dinv, int* info, void* stream) {
  return launch_factor<double>(n, ld, k, S, Dinv, info, stream);
}

GT_EXPORT int gt_dense_factor_diag_f32(int n, int ld, int k, float* S,
                                       float* Dinv, int* info, void* stream) {
  return launch_factor<float>(n, ld, k, S, Dinv, info, stream);
}
