// Kernel 10's device code: the factorization and inversion of one 128 x 128
// diagonal block by one CTA of 8 warps (dense_factor.cu describes the
// design), shared by kernel 10 and by kernel 7's front kernel
// (sn_factor.cu), which factors each 128-column block of a front with it.
// factor_block(b) is the whole of it: b names the block's source and
// outputs and the CTA's shared memory.
#pragma once

#include <cmath>

#include "ba_common.cuh"

namespace chol {

constexpr int kNB = 128;            // panel width
constexpr int kTile = 32;
constexpr int kNT = kNB / kTile;    // tile rows / columns of the block
constexpr int kTiles = kNT * (kNT + 1) / 2;   // lower tiles of the block
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

// Shared row pitch of a tile: float64 36 (a half-warp's share of an mma
// fragment, 4 rows x 4 columns, falls in 16 distinct 8-byte banks),
// float32 33 (a column of 32 in 32 distinct banks).
template <typename T>
constexpr int kLd = sizeof(T) == 8 ? 36 : 33;
template <typename T>
constexpr int kTileSz = kTile * kLd<T>;

// Row pitch of the transposed diagonal tiles (16-byte rows in both types).
constexpr int kLtPitch = 36;

__host__ __device__ constexpr int tid_of(int i, int j) {
  return i * (i + 1) / 2 + j;
}

template <typename T>
struct Block {
  T* A;         // kTiles tiles: D, then L_D
  T* X;         // kTiles tiles of L_D^-1
  T* rinv;      // kNT x 32: the reciprocals of L_tt's diagonal
  T* lt;        // kNT x 32 x kLtPitch: L_tt^T, below-diagonal entries
  int* ready;   // kNT x 8: rows 4 r .. 4 r + 3 of LT_t and rinv_t written
  T* S;         // S's row o, column o
  T* D;         // Dinv[k]
  int* info;
  int64_t ld;
  int o, w;
  __device__ T* a(int i, int j) const { return A + tid_of(i, j) * kTileSz<T>; }
  __device__ T* x(int i, int j) const { return X + tid_of(i, j) * kTileSz<T>; }
  __device__ T* ltt(int t) const { return lt + t * kTile * kLtPitch; }
  __device__ T* dinv(int i, int j) const {
    return D + (i * kTile) * kNB + j * kTile;
  }
};

// A flag in shared memory: set with release semantics by lane 0 once its
// warp's writes before it are ordered by __syncwarp (a predicated store,
// no branch), awaited with acquire loads by the lanes of another warp.
__device__ __forceinline__ void signal(int* f) {
  asm volatile(
      "{\n .reg .pred p;\n setp.eq.u32 p, %2, 0;\n"
      " @p st.release.cta.shared.b32 [%0], %1;\n}"
      ::"r"((unsigned)__cvta_generic_to_shared(f)), "r"(1),
      "r"(threadIdx.x & 31)
      : "memory");
}
__device__ __forceinline__ void await(const int* f) {
  int v;
  do {
    asm volatile("ld.acquire.cta.shared.b32 %0, [%1];"
                 : "=r"(v)
                 : "r"((unsigned)__cvta_generic_to_shared(f))
                 : "memory");
  } while (v == 0);
}

template <typename T>
struct Vec16;
template <>
struct Vec16<double> { using V = double2; };
template <>
struct Vec16<float> { using V = float4; };

// e[m] = row[m] for m in (j, 32) (and a few entries before), every lane
// reading the same 16 bytes at a time: row is a 16-byte aligned row of a
// transposed tile, j a constant once the caller's loop is unrolled.
template <typename T>
__device__ __forceinline__ void load_below(const T* row, int j, T e[kTile]) {
  constexpr int kV = 16 / sizeof(T);
  using V = typename Vec16<T>::V;
#pragma unroll
  for (int m = (j + 1) / kV * kV; m < kTile; m += kV) {
    const V v = *reinterpret_cast<const V*>(row + m);
    const T* f = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int h = 0; h < kV; ++h) e[m + h] = f[h];
  }
}

// Factor diagonal tile t in place; a lane per row, the row left of the
// diagonal in registers and the diagonal apart.  Each step takes one
// reciprocal square root of the pivot: L_kk = p rsqrt(p), the column below
// is scaled by rsqrt(p), which also goes to rinv.  A lane updates its own
// diagonal from its own column entry, so the chain from one pivot to the
// next is a shuffle, the square root, a product and an FMA.  The column's
// entries reach the rows below through shared memory, as row k of the
// tile's transpose (LT, kept for the row solves and the inverse), which
// every lane reads 16 bytes at a time, where a shuffle a value (~1000 a
// tile in float64) cost ~6 cycles of a warp's issue each on an H100.
// Every 4 columns it flags them written (b.ready), so a row
// solve against the tile can follow it (solve_rows<true>).  No branch
// inside the loop, so the compiler can overlap a step's updates with the
// next step's chain.
template <typename T>
__device__ void factor_tile(const Block<T>& b, int t) {
  constexpr int ld = kLd<T>;
  const int lane = threadIdx.x & 31;
  T* a = b.a(t, t);
  T* rinv = b.rinv + t * kTile;
  T* lt = b.ltt(t);
  T row[kTile];
#pragma unroll
  for (int j = 0; j < kTile; ++j) row[j] = j < lane ? a[lane * ld + j] : T(0);
  T dg = a[lane * ld + lane], lkk = T(0);
  int fail = kTile;
#pragma unroll
  for (int k = 0; k < kTile; ++k) {
    const T p = __shfl_sync(kFull, dg, k);
    fail = fail == kTile && (!(p > T(0)) || isinf(p)) ? k : fail;
    const T rs = rsqrt(p);
    const T l = lane > k ? row[k] * rs : T(0);   // L[lane][k]
    dg -= l * l;
    row[k] = lane > k ? l : row[k];
    lkk = lane == k ? p * rs : lkk;
    if (lane == k) rinv[k] = rs;
    lt[k * kLtPitch + lane] = l;
    __syncwarp();
    if (k % 4 == 3) signal(b.ready + t * 8 + k / 4);
    T lj[kTile];
    load_below(lt + k * kLtPitch, k, lj);
#pragma unroll
    for (int j = k + 1; j < kTile; ++j)
      if (lane > j) row[j] -= l * lj[j];
  }
  if (fail < kTile && lane == 0 && *b.info == 0)
    *b.info = b.o + t * kTile + fail + 1;
#pragma unroll
  for (int j = 0; j < kTile; ++j)
    if (j < lane) a[lane * ld + j] = row[j];
  a[lane * ld + lane] = lkk;
}

// Tile (i, t) <- A_it L_tt^-T: a lane per row, forward substitution against
// L_tt with its reciprocal diagonal, L_tt's column j read as row j of its
// transpose.  kFollow: while factor_tile(t) runs, each 4 columns once it
// flags them.
template <bool kFollow, typename T>
__device__ void solve_rows(const Block<T>& b, int i, int t) {
  constexpr int ld = kLd<T>;
  const int lane = threadIdx.x & 31;
  const T* lt = b.ltt(t);
  const T* ri = b.rinv + t * kTile;
  T* out = b.a(i, t) + lane * ld;
  T v[kTile];
#pragma unroll
  for (int j = 0; j < kTile; ++j) v[j] = out[j];
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    if (kFollow && j % 4 == 0) await(b.ready + t * 8 + j / 4);
    v[j] *= ri[j];
    T c[kTile];
    load_below(lt + j * kLtPitch, j, c);
#pragma unroll
    for (int m = j + 1; m < kTile; ++m) v[m] -= c[m] * v[j];
  }
#pragma unroll
  for (int j = 0; j < kTile; ++j) out[j] = v[j];
}

// X_tt = L_tt^-1, written whole (zeros above the diagonal): a lane per
// column, right-looking (L_tt's columns read from its transpose), so that
// the updates of a step are independent of each other.  The last tile's inverse also goes straight to Dinv.
template <typename T>
__device__ void invert_tile(const Block<T>& b, int t) {
  constexpr int ld = kLd<T>;
  const int lane = threadIdx.x & 31;
  const T* lt = b.ltt(t);
  const T* ri = b.rinv + t * kTile;
  T v[kTile];
#pragma unroll
  for (int i = 0; i < kTile; ++i) v[i] = i == lane ? T(1) : T(0);
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    v[j] *= ri[j];
    T c[kTile];
    load_below(lt + j * kLtPitch, j, c);
#pragma unroll
    for (int i = j + 1; i < kTile; ++i) v[i] -= c[i] * v[j];
  }
  T* x = b.x(t, t);
  T* g = b.dinv(t, t);
#pragma unroll
  for (int i = 0; i < kTile; ++i) {
    x[i * ld + lane] = v[i];
    if (t == kNT - 1) g[i * kNB + lane] = v[i];
  }
}

// One warp's share of a tile product: the 32 x 16 strip of columns
// c0 .. c0 + 15 of sum A B' over 32-deep tiles A (row-major) and B' = B^T
// (kTransB) or B.  `each(c0, f)` calls f(row, column, value) for the
// lane's entries.
template <typename T>
struct Strip;

template <>
struct Strip<double> {   // FP64 tensor cores: mma.sync m16n8k16, sm_90's
  static constexpr int ld = kLd<double>;
  // d[4 (2 mb + nb) + v] is entry (16 mb + g + 8 (v / 2),
  // c0 + 8 nb + 2 q + v % 2); g = lane / 4, q = lane % 4
  double d[16];
  __device__ Strip() {
#pragma unroll
    for (int i = 0; i < 16; ++i) d[i] = 0.0;
  }
  template <bool kTransB>
  __device__ void add(const double* A, const double* B, int c0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int k0 = 0; k0 < kTile; k0 += 16) {
      double a[2][8], bb[2][4];
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int v = 0; v < 8; ++v)
          a[mb][v] = A[(16 * mb + g + 8 * (v & 1)) * ld + k0 + q +
                       4 * (v >> 1)];
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int k = k0 + q + 4 * v, n = c0 + 8 * nb + g;
          bb[nb][v] = kTransB ? B[n * ld + k] : B[k * ld + n];
        }
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          double* c = d + 4 * (2 * mb + nb);
          asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
              "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
              "{%12, %13, %14, %15}, {%0, %1, %2, %3};"
              : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
              : "d"(a[mb][0]), "d"(a[mb][1]), "d"(a[mb][2]), "d"(a[mb][3]),
                "d"(a[mb][4]), "d"(a[mb][5]), "d"(a[mb][6]), "d"(a[mb][7]),
                "d"(bb[nb][0]), "d"(bb[nb][1]), "d"(bb[nb][2]),
                "d"(bb[nb][3]));
        }
    }
  }
  template <typename F>
  __device__ void each(int c0, F f) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int mb = i >> 3, nb = (i >> 2) & 1, v = i & 3;
      f(16 * mb + g + 8 * (v >> 1), c0 + 8 * nb + 2 * q + (v & 1), d[i]);
    }
  }
};

template <>
struct Strip<float> {    // CUDA cores: a 4 x 4 micro-tile a lane
  static constexpr int ld = kLd<float>;
  float d[4][4];
  __device__ Strip() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) d[i][j] = 0.f;
  }
  template <bool kTransB>
  __device__ void add(const float* A, const float* B, int c0) {
    const int lane = threadIdx.x & 31;
    const int r0 = 4 * (lane >> 2), cc = c0 + 4 * (lane & 3);
#pragma unroll 8
    for (int m = 0; m < kTile; ++m) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = A[(r0 + i) * ld + m];
        bb[i] = kTransB ? B[(cc + i) * ld + m] : B[m * ld + cc + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) d[i][j] += a[i] * bb[j];
    }
  }
  template <typename F>
  __device__ void each(int c0, F f) const {
    const int lane = threadIdx.x & 31;
    const int r0 = 4 * (lane >> 2), cc = c0 + 4 * (lane & 3);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) f(r0 + i, cc + j, d[i][j]);
  }
};

// Strip c0 of tile (i, j) less L_it L_jt^T.
template <typename T>
__device__ __forceinline__ void update_strip(const Block<T>& b, int i, int j,
                                             int t, int c0) {
  constexpr int ld = kLd<T>;
  Strip<T> s;
  s.template add<true>(b.a(i, t), b.a(j, t), c0);
  T* out = b.a(i, j);
  s.each(c0, [&](int r, int c, T v) { out[r * ld + c] -= v; });
}

// The jobs a warp takes from a phase's list.
enum Kind : signed char {
  kSolve,      // tile (i, t) <- A_it L_tt^-T
  kInvert,     // X_tt <- L_tt^-1
  kUpdate,     // strip c0 of A_ij -= L_it L_jt^T
  kSum,        // strip c0 of X_ij <- sum_{m=j}^{i-1} L_im X_mj
  kScale,      // strip c0 of X_ij <- -X_ii X_ij
  kScaleOut,   // the same, into Dinv only
  kWriteL,     // tile (i, j) of L_D into S
  kWriteX,     // tile (i, j) of L_D^-1 into Dinv
};

struct Job {
  signed char kind, i, j, t, c0;
};

// The lists of the phases after the first (tiles 0 and (1, 0) done).  In
// phase t < 3 warps 0 and 1 update tile (t + 1, t + 1) by column t and
// warp 0 factors it; warp 1 solves tile (t + 2, t), updates tile
// (t + 2, t + 1) by column t (warp 2 the other strip, once the solve is
// done) and solves it against tile t + 1 as warp 0 factors that (not
// listed).  Beside them warps 2-7 run S(t), then, once
// warp 1's solve of (t + 2, t) is done, U(t): the rest of the trailing
// update by column t, the composition of L_D^-1 (X_ij = -X_ii Y_ij, Y_ij
// = sum_{m=j}^{i-1} L_im X_mj) and the writes, each where its tiles are
// ready.  Then A and B on all warps: the last row of tiles of L_D^-1.  A
// job reads only tiles that an earlier list, or the chain of an earlier
// phase, finished.
__constant__ Job kJobs[] = {
    // S(0)
    {kSolve, 3, 0, 0, 0}, {kInvert, 0, 0, 0, 0}, {kWriteL, 0, 0, 0, 0},
    {kWriteL, 1, 0, 0, 0},
    // U(0)
    {kUpdate, 3, 1, 0, 0}, {kUpdate, 3, 1, 0, 16}, {kUpdate, 2, 2, 0, 0},
    {kUpdate, 2, 2, 0, 16}, {kUpdate, 3, 2, 0, 0}, {kUpdate, 3, 2, 0, 16},
    {kUpdate, 3, 3, 0, 0}, {kUpdate, 3, 3, 0, 16}, {kSum, 1, 0, 0, 0},
    {kSum, 1, 0, 0, 16}, {kWriteL, 2, 0, 0, 0}, {kWriteL, 3, 0, 0, 0},
    {kWriteX, 0, 0, 0, 0},
    // S(1)
    {kInvert, 1, 1, 1, 0}, {kWriteL, 1, 1, 0, 0}, {kWriteL, 2, 1, 0, 0},
    // U(1)
    {kUpdate, 3, 3, 1, 0}, {kUpdate, 3, 3, 1, 16}, {kScale, 1, 0, 0, 0},
    {kScale, 1, 0, 0, 16}, {kSum, 2, 1, 0, 0}, {kSum, 2, 1, 0, 16},
    {kWriteX, 1, 1, 0, 0}, {kWriteL, 3, 1, 0, 0},
    // S(2)
    {kInvert, 2, 2, 2, 0}, {kSum, 2, 0, 0, 0}, {kSum, 2, 0, 0, 16},
    {kWriteL, 2, 2, 0, 0}, {kWriteL, 3, 2, 0, 0}, {kWriteX, 1, 0, 0, 0},
    // U(2)
    {kScale, 2, 1, 0, 0}, {kScale, 2, 1, 0, 16}, {kScale, 2, 0, 0, 0},
    {kScale, 2, 0, 0, 16}, {kSum, 3, 2, 0, 0}, {kSum, 3, 2, 0, 16},
    {kWriteX, 2, 2, 0, 0},
    // A
    {kInvert, 3, 3, 3, 0}, {kSum, 3, 1, 0, 0}, {kSum, 3, 1, 0, 16},
    {kSum, 3, 0, 0, 0}, {kSum, 3, 0, 0, 16}, {kWriteL, 3, 3, 0, 0},
    {kWriteX, 2, 1, 0, 0}, {kWriteX, 2, 0, 0, 0},
    // B
    {kScaleOut, 3, 0, 0, 0}, {kScaleOut, 3, 0, 0, 16},
    {kScaleOut, 3, 1, 0, 0}, {kScaleOut, 3, 1, 0, 16},
    {kScaleOut, 3, 2, 0, 0}, {kScaleOut, 3, 2, 0, 16},
};
// first job of S(0), U(0), S(1), U(1), S(2), U(2), A, B, and the end
__constant__ int kPhase[] = {0, 4, 17, 20, 28, 34, 41, 49, 55};
static_assert(sizeof(kJobs) / sizeof(Job) == 55, "kPhase ends the list");

template <typename T>
__device__ void run(const Block<T>& b, const Job jb) {
  constexpr int ld = kLd<T>;
  const int lane = threadIdx.x & 31;
  const int i = jb.i, j = jb.j, c0 = jb.c0;
  switch (jb.kind) {
    case kSolve:
      solve_rows<false>(b, i, jb.t);
      break;
    case kInvert:
      invert_tile(b, jb.t);
      break;
    case kUpdate:
      update_strip(b, i, j, jb.t, c0);
      break;
    case kSum: {
      Strip<T> s;
      for (int m = j; m < i; ++m)
        s.template add<false>(b.a(i, m), b.x(m, j), c0);
      T* out = b.x(i, j);
      s.each(c0, [&](int r, int c, T v) { out[r * ld + c] = v; });
      break;
    }
    case kScale:
    case kScaleOut: {
      Strip<T> s;
      s.template add<false>(b.x(i, i), b.x(i, j), c0);
      __syncwarp();   // the strip is read whole before it is overwritten
      if (jb.kind == kScale) {
        T* out = b.x(i, j);
        s.each(c0, [&](int r, int c, T v) { out[r * ld + c] = -v; });
      } else {
        T* out = b.dinv(i, j);
        s.each(c0, [&](int r, int c, T v) { out[r * kNB + c] = -v; });
      }
      break;
    }
    case kWriteL: {
      const T* src = b.a(i, j);
      const int C = j * kTile + lane;
#pragma unroll 4
      for (int r = 0; r < kTile; ++r) {
        const int R = i * kTile + r;
        if (R < b.w && C <= R) b.S[R * b.ld + C] = src[r * ld + lane];
      }
      break;
    }
    case kWriteX: {
      const T* src = b.x(i, j);
      T* out = b.dinv(i, j);
#pragma unroll 4
      for (int r = 0; r < kTile; ++r) out[r * kNB + lane] = src[r * ld + lane];
      break;
    }
  }
}

// Jobs first .. end - 1 of phase ph's list, worker `me` of `workers`.
template <typename T>
__device__ void run_phase(const Block<T>& b, int ph, int me, int workers) {
  for (int q = kPhase[ph] + me; q < kPhase[ph + 1]; q += workers)
    run(b, kJobs[q]);
}

// Named barriers: warps 0 and 1 (the chain); warp 1 arriving (its solve of
// tile (t + 2, t) done) and warps 2-7 waiting, before U(t);
__device__ __forceinline__ void pair_barrier() {
  asm volatile("bar.sync 1, 64;" ::: "memory");
}
__device__ __forceinline__ void solved_arrive() {
  asm volatile("bar.arrive 2, %0;" ::"n"(kThreads - 32) : "memory");
}
__device__ __forceinline__ void solved_wait() {
  asm volatile("bar.sync 2, %0;" ::"n"(kThreads - 32) : "memory");
}
// warp 2 arriving (its strip of tile (t + 2, t + 1)'s update done), warp
// 1 waiting
__device__ __forceinline__ void strip_arrive() {
  asm volatile("bar.arrive 3, 64;" ::: "memory");
}
__device__ __forceinline__ void strip_wait() {
  asm volatile("bar.sync 3, 64;" ::: "memory");
}

// Stage the block at b.S (its lower triangle, rows ld apart, w x w; the
// identity past w), factor it into L_D (written back to b.S's lower
// triangle) and invert it into b.D (128 x 128 row-major, zero above the
// diagonal, the identity past w).  Called by all 8 warps of the CTA; the
// caller synchronizes before it reads b's tiles or outputs.
template <typename T>
__device__ __forceinline__ void factor_block(const Block<T>& b) {
  constexpr int tld = kLd<T>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x < kNT * 8) b.ready[threadIdx.x] = 0;
  __syncthreads();

  // D's lower tiles, the identity past w, a warp per tile row and a lane
  // per column: warp 0 stages tile 0 and factors it at once, warp 1 stages
  // tile (1, 0) and solves it as warp 0 goes, warps 2-7 zero Dinv's tiles
  // above the diagonal (first, so that tiles 0 and (1, 0) lead the SM's
  // loads) and stage the other 8 (every load in flight, then the stores).
  auto entry = [&](int i, int j, int r) {
    const int R = i * kTile + r, C = j * kTile + lane;
    return R < b.w && C <= R ? b.S[R * b.ld + C] : R == C ? T(1) : T(0);
  };
  if (warp < 2) {
    T v[kTile];
#pragma unroll
    for (int r = 0; r < kTile; ++r) v[r] = entry(warp, 0, r);
    T* a = b.a(warp, 0);
#pragma unroll
    for (int r = 0; r < kTile; ++r) a[r * tld + lane] = v[r];
    __syncwarp();
    if (warp == 0)
      factor_tile(b, 0);
    else
      solve_rows<true>(b, 1, 0);
  } else {
    constexpr int kRows = (kTiles - 2) * kTile, kW = kWarps - 2;
    constexpr int kPer = (kRows + kW - 1) / kW;
    constexpr int kZero = kNT * (kNT - 1) / 2 * kTile;   // upper tile rows
    for (int z = warp - 2; z < kZero; z += kW) {
      const int q = z / kTile, i = q < 3 ? 0 : q < 5 ? 1 : 2;
      const int j = i + 1 + q - (i == 0 ? 0 : i == 1 ? 3 : 5);
      b.dinv(i, j)[(z % kTile) * kNB + lane] = T(0);
    }
    T v[kPer];
#pragma unroll
    for (int s = 0; s < kPer; ++s) {
      const int z = warp - 2 + kW * s;   // tile row z of tiles 2 .. 9
      if (z < kRows) {
        const int q = 2 + z / kTile, i = q < 3 ? 1 : q < 6 ? 2 : 3;
        v[s] = entry(i, q - tid_of(i, 0), z % kTile);
      }
    }
#pragma unroll
    for (int s = 0; s < kPer; ++s) {
      const int z = warp - 2 + kW * s;
      if (z < kRows)
        b.A[(kTileSz<T>) * (2 + z / kTile) + (z % kTile) * tld + lane] = v[s];
    }
  }
  __syncthreads();

  for (int t = 0; t + 1 < kNT; ++t) {
    // the chain: tile (t + 1, t + 1) updated by column t (a strip each of
    // warps 0 and 1) and factored by warp 0; warp 1 meanwhile solves tile
    // (t + 2, t), updates tile (t + 2, t + 1) by column t and solves it as
    // warp 0 factors tile t + 1; beside them S(t), then U(t) on warps 2-7
    const bool below = t + 2 < kNT;
    if (warp < 2) {
      update_strip(b, t + 1, t + 1, t, 16 * warp);
      pair_barrier();
      if (warp == 0) {
        factor_tile(b, t + 1);
      } else if (below) {
        solve_rows<false>(b, t + 2, t);
        solved_arrive();
        update_strip(b, t + 2, t + 1, t, 0);
        strip_wait();
        solve_rows<true>(b, t + 2, t + 1);
      } else {
        solved_arrive();
      }
    } else {
      run_phase(b, 2 * t, warp - 2, kWarps - 2);      // S(t)
      solved_wait();
      if (warp == 2 && below) {   // the other strip of (t + 2, t + 1)
        update_strip(b, t + 2, t + 1, t, 16);
        strip_arrive();
      }
      run_phase(b, 2 * t + 1, warp - 2, kWarps - 2);  // U(t)
    }
    __syncthreads();
  }
  run_phase(b, 6, warp, kWarps);   // A
  __syncthreads();
  run_phase(b, 7, warp, kWarps);   // B
}

}  // namespace chol
