// Kernel 11: forward and backward substitution with the blocked dense
// Cholesky factor (float64, and float32 for the mixed mode), one
// cooperative launch per direction.
//
// Replaces: gtsam_tpu/linear/dense_blocked.py::blocked_cho_solve's panel
// loops, fwd (:121-130) and bwd (:134-144): per panel a masked full-row
// matvec and a triangular solve of the diagonal block.
//
// L is n x n row-major, rows ld entries apart (only its lower triangle is
// read); Dinv holds each 128-wide panel's L_D^-1 (kernel 10).  CTA b owns
// the panels b, b + G, ... (G CTAs, one panel each at n <= 128 G) and keeps
// their right-hand sides in shared memory.
// gt_dense_forward: for k = 0, 1, ...: panel k's owner forms
//   y_k = L_D^-1 r_k and writes it to y; every CTA that owns a panel i > k
//   reads y_k as soon as it is written and subtracts L_ik y_k from its rhs,
//   reading panel k's column strip of L once (right-looking).
// gt_dense_backward: for k = P-1, ..., 0: the owner forms x_k = L_D^-T r_k
//   into x; every CTA that owns a panel j < k subtracts L_kj^T x_k from it,
//   reading panel k's row strip once.
// The output is the only channel between CTAs, and each entry is its own
// flag: the wrapper fills y (x) with kPending, a NaN that no arithmetic
// gives (every NaN the kernel writes is made the canonical one first), the
// owner stores each entry once with a relaxed store at device scope, and
// one warp of a consumer polls the 128 entries it needs with relaxed loads
// until none is pending.  So a panel step's critical path holds one trip
// through L2 (the stores reaching it and the polls seeing them) and two
// CTA barriers (the polled values to the CTA; the rhs complete before the
// owner's product), with no fence and no flag.  A CTA loads its next
// block of L into registers before it waits.
// Block products: a warp per 8 rows, a lane taking 16 bytes of a row at
// a time (two entries in float64, four in float32), reduced by a
// transposing butterfly (forward, and the owner's L_D^-1 or L_D^-T
// product, for which the backward stages Dinv transposed); in the
// backward, a thread per 16 bytes of a row and 16 (float64) or 8 (float32)
// rows, each thread adding its partial sums into its own shared-memory
// slots across the steps, the row groups' slots summed in order only when
// the owner needs its rhs.  Entries are loaded one at a time: 16-byte
// loads where L is aligned for them took as long or longer on an H100
// (scripts/port_dense_probe.py).  No atomics: every
// sum runs in a fixed order, so the same inputs give the same bits.  The
// cooperative launch keeps every CTA resident, so a wait always ends.
// Bound on the H100: L's lower triangle read once a direction, n^2 / 2
// entries (0.287 ms in float64, 0.144 ms in float32 at n = 15,507); a step
// whose blocks the card delivers faster than that is bound by the chain's
// latency: the owner's product and one trip through L2 a panel.
#include "ba_common.cuh"

namespace {

constexpr int kNB = 128;
constexpr int kPitch = kNB + 1;                // shared row pitch of Dinv
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kNB / kWarps;     // 8
constexpr unsigned kFull = 0xffffffffu;

// A thread takes kVec consecutive entries of a row (16 bytes).  Backward
// column layout: kColThreads threads across a row, kGroups row groups of
// kGroupRows rows (float64: 64 x 8 of 16 rows; float32: 32 x 16 of 8
// rows).
template <typename T>
constexpr int kVec = 16 / sizeof(T);
template <typename T>
constexpr int kColThreads = kNB / kVec<T>;
template <typename T>
constexpr int kGroups = kThreads / kColThreads<T>;
template <typename T>
constexpr int kGroupRows = kNB / kGroups<T>;

// kPending: an entry not yet written (the wrappers fill the output with
// it; gtsam_torch/linear/dense_kernels.py::PENDING holds the same words).
// kNaN: what every NaN result is stored as.
template <typename T>
struct Word;
template <>
struct Word<double> {
  using U = unsigned long long;
  static constexpr U kPending = 0x7ff4dead5eed0001ull;
  static constexpr U kNaN = 0x7ff8000000000000ull;
  static __device__ U bits(double v) { return __double_as_longlong(v); }
  static __device__ double value(U u) { return __longlong_as_double(u); }
};
template <>
struct Word<float> {
  using U = unsigned int;
  static constexpr U kPending = 0x7fa5eed1u;
  static constexpr U kNaN = 0x7fc00000u;
  static __device__ U bits(float v) { return __float_as_uint(v); }
  static __device__ float value(U u) { return __uint_as_float(u); }
};

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long u) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(u)
               : "memory");
}
__device__ __forceinline__ void st_relaxed(unsigned* p, unsigned u) {
  asm volatile("st.relaxed.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(u)
               : "memory");
}
__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long u;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(u) : "l"(p)
               : "memory");
  return u;
}
__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned u;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];" : "=r"(u) : "l"(p)
               : "memory");
  return u;
}

// Store one entry of a panel's solution for the other CTAs.
template <typename T>
__device__ __forceinline__ void publish(T* p, T v) {
  using W = Word<T>;
  st_relaxed(reinterpret_cast<typename W::U*>(p),
             v != v ? W::kNaN : W::bits(v));
}

// v[j] = entry lane + 32 j of a panel's solution at src (0 at or past
// `valid`), once it is written; called by one warp.
template <typename T>
__device__ __forceinline__ void poll4(const T* src, int valid, T v[4]) {
  using W = Word<T>;
  using U = typename W::U;
  const int lane = threadIdx.x & 31;
  const U* s = reinterpret_cast<const U*>(src);
  bool done[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    done[j] = lane + 32 * j >= valid;
    v[j] = T(0);
  }
  while (!(done[0] && done[1] && done[2] && done[3])) {
    U u[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (!done[j]) u[j] = ld_relaxed(s + lane + 32 * j);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (!done[j] && u[j] != W::kPending) {
        v[j] = W::value(u[j]);
        done[j] = true;
      }
  }
}

// Row layout: lane l of warp w takes entries (8w + a, col_of(l, j)) of a
// block, a < 8, j < 4: kVec consecutive columns at a time.
template <typename T>
__device__ __forceinline__ int col_of(int lane, int j) {
  return kVec<T> * lane + (j / kVec<T>) * 32 * kVec<T> + j % kVec<T>;
}

// reg[4 a + j] <- M's entry (8w + a, col_of(lane, j)), rows ldm apart, 0
// at or past `rows`.
template <typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ M,
                                          int64_t ldm, int rows, T reg[32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int a = 0; a < kRowsPerWarp; ++a) {
    const int r = warp * kRowsPerWarp + a;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      reg[a * 4 + j] =
          r < rows ? __ldg(M + r * ldm + col_of<T>(lane, j)) : T(0);
  }
}

// store(r, sum_c M[r][c] v[c]) for the 128 rows of a row-layout block,
// called by one lane of each row; m(a, j) gives the lane's entry (a, j) of
// M, vv[j] = v[col_of(lane, j)].  The 8 rows' partials of a warp are
// summed by a butterfly that halves the values a lane holds at each of its
// first three steps (offsets 16, 8, 4), then over the 4 lanes left.
template <typename T, typename Entry, typename Store>
__device__ __forceinline__ void dot_rows(Entry m, const T vv[4],
                                         Store store) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T p[8];
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    T s = T(0);
#pragma unroll
    for (int j = 0; j < 4; ++j) s += m(a, j) * vv[j];
    p[a] = s;
  }
  const bool u1 = lane & 16, u2 = lane & 8, u3 = lane & 4;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const T send = u1 ? p[a] : p[a + 4];
    const T keep = u1 ? p[a + 4] : p[a];
    p[a] = keep + __shfl_xor_sync(kFull, send, 16);
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const T send = u2 ? p[a] : p[a + 2];
    const T keep = u2 ? p[a + 2] : p[a];
    p[a] = keep + __shfl_xor_sync(kFull, send, 8);
  }
  {
    const T send = u3 ? p[0] : p[1];
    const T keep = u3 ? p[1] : p[0];
    p[0] = keep + __shfl_xor_sync(kFull, send, 4);
  }
  p[0] += __shfl_xor_sync(kFull, p[0], 2);
  p[0] += __shfl_xor_sync(kFull, p[0], 1);
  if ((lane & 3) == 0)
    store(warp * kRowsPerWarp + 4 * u1 + 2 * u2 + u3, p[0]);
}

// The owner's product with its panel's staged Dinv (or Dinv^T), read from
// shared memory as it goes, or (a later panel of the CTA) from device
// memory (trans: Dinv^T from Dinv's columns): no register array, so the
// prefetched block of L stays in registers beside it.
template <typename T, typename Store>
__device__ __forceinline__ void dot_dinv(const T* staged, const T* g,
                                         bool trans, const T vv[4],
                                         Store store) {
  const int lane = threadIdx.x & 31, w8 = (threadIdx.x >> 5) * kRowsPerWarp;
  if (staged != nullptr)
    dot_rows<T>([&](int a, int j) {
      return staged[(w8 + a) * kPitch + col_of<T>(lane, j)];
    }, vv, store);
  else
    dot_rows<T>([&](int a, int j) {
      const int r = w8 + a, c = col_of<T>(lane, j);
      return __ldg(g + (trans ? c * kNB + r : r * kNB + c));
    }, vv, store);
}

// Column layout: thread t takes columns kVec (t % kColThreads) + h
// (h < kVec) and rows kGroupRows (t / kColThreads) + i of a block;
// reg[i kVec + h] <- that entry, 0 at or past `rows`.
template <typename T>
__device__ __forceinline__ void load_cols(const T* __restrict__ M,
                                          int64_t ldm, int rows, T reg[32]) {
  const int c = kVec<T> * (threadIdx.x % kColThreads<T>);
  const int r0 = kGroupRows<T> * (threadIdx.x / kColThreads<T>);
#pragma unroll
  for (int i = 0; i < kGroupRows<T>; ++i)
#pragma unroll
    for (int h = 0; h < kVec<T>; ++h)
      reg[i * kVec<T> + h] =
          r0 + i < rows ? __ldg(M + (r0 + i) * ldm + c + h) : T(0);
}

// The last panel CTA me owns (me < P).
__device__ __forceinline__ int last_owned(int P, int G, int me) {
  return me + (P - 1 - me) / G * G;
}

__device__ __forceinline__ int rows_of(int n, int p) {
  return min(kNB, n - p * kNB);
}

__device__ __forceinline__ int owned_of(int P, int G) {
  return (P + G - 1) / G;
}

// Shared memory: Dinv of the CTA's first panel (transposed for the
// backward; row pitch kPitch), `owned` rhs panels, and (backward) each
// owned panel's kGroups x 128 partial sums.
template <typename T>
struct Shared {
  T* dinv;
  T* rhs;
  T* part;
  __device__ Shared(unsigned char* s, int owned)
      : dinv(reinterpret_cast<T*>(s)), rhs(dinv + kNB * kPitch),
        part(rhs + owned * kNB) {}
};

template <bool kTrans, typename T>
__device__ void stage(int n, int P, const T* __restrict__ Dinv,
                      const T* __restrict__ src, Shared<T> sh, bool parts) {
  const int G = gridDim.x, me = blockIdx.x;
  for (int e = threadIdx.x; e < kNB * kNB; e += kThreads) {
    const int r = e / kNB, c = e % kNB;
    sh.dinv[kTrans ? c * kPitch + r : r * kPitch + c] =
        Dinv[(int64_t)me * kNB * kNB + e];
  }
  for (int p = me, m = 0; p < P; p += G, ++m)
    for (int r = threadIdx.x; r < kNB; r += kThreads)
      sh.rhs[m * kNB + r] = p * kNB + r < n ? src[p * kNB + r] : T(0);
  if (parts)
    for (int e = threadIdx.x; e < owned_of(P, G) * kGroups<T> * kNB;
         e += kThreads)
      sh.part[e] = T(0);
  __syncthreads();
}

// vk (shared) <- panel k's solution at out, polled by warp 0; then a
// barrier.  Two buffers in turn: a warp reads step k's values before it
// meets step k + 1's barrier, after which warp 0 may fill the other.
template <typename T>
__device__ __forceinline__ void receive(const T* out, int n, int k, T* vk) {
  if ((threadIdx.x >> 5) == 0) {
    T v[4];
    poll4(out + (int64_t)k * kNB, n - k * kNB, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) vk[(threadIdx.x & 31) + 32 * j] = v[j];
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) dense_forward_kernel(
    int n, int ld, int P, const T* __restrict__ L,
    const T* __restrict__ Dinv, const T* __restrict__ b, T* y,
    const int* stop) {
  if (stop != nullptr && *stop) return;   // a CG loop is done: every CTA
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T vk[2][kNB];
  const int G = gridDim.x, me = blockIdx.x, lane = threadIdx.x & 31;
  const Shared<T> sh(smem, owned_of(P, G));
  const int last = last_owned(P, G, me);
  stage<false>(n, P, Dinv, b, sh, false);
  T reg[32];
  // this CTA's first panel's block in column strip 0
  if (me > 0)
    load_rows(L + (int64_t)me * kNB * ld, ld, rows_of(n, me), reg);
  for (int k = 0; k < P; ++k) {
    if (k % G == me) {   // y_k = L_D^-1 r_k
      const int m = k / G;
      __syncthreads();   // r_k complete
      T vv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = sh.rhs[m * kNB + col_of<T>(lane, j)];
      dot_dinv(m == 0 ? sh.dinv : nullptr, Dinv + (int64_t)k * kNB * kNB,
               false, vv, [&](int r, T s) {
                 if (k * kNB + r < n) publish(y + k * kNB + r, s);
               });
    }
    if (last <= k) break;   // no panel of this CTA below k
    T* v = vk[k & 1];
    receive(y, n, k, v);
    T vv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) vv[j] = v[col_of<T>(lane, j)];
    for (int p = me, m = 0; p < P; p += G, ++m) {
      if (p <= k) continue;
      if (m > 0)
        load_rows(L + (int64_t)p * kNB * ld + k * kNB, ld,
                            rows_of(n, p), reg);
      T* r = sh.rhs + m * kNB;
      dot_rows<T>([&](int a, int j) { return reg[a * 4 + j]; }, vv,
                  [&](int i, T s) { r[i] -= s; });
    }
    if (me > k + 1)   // the next step's block, ahead of the wait
      load_rows(L + (int64_t)me * kNB * ld + (k + 1) * kNB, ld,
                          rows_of(n, me), reg);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) dense_backward_kernel(
    int n, int ld, int P, const T* __restrict__ L,
    const T* __restrict__ Dinv, const T* __restrict__ y, T* x,
    const int* stop) {
  if (stop != nullptr && *stop) return;   // a CG loop is done: every CTA
  constexpr int kG = kGroups<T>, kR = kGroupRows<T>, kV = kVec<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T vk[2][kNB];
  const int G = gridDim.x, me = blockIdx.x, lane = threadIdx.x & 31;
  const int c = kV * (threadIdx.x % kColThreads<T>);
  const int g = threadIdx.x / kColThreads<T>;
  const Shared<T> sh(smem, owned_of(P, G));
  stage<true>(n, P, Dinv, y, sh, true);
  T reg[32];
  // this CTA's first panel's block in row strip P - 1
  if (me < P - 1)
    load_cols(L + (int64_t)(P - 1) * kNB * ld + me * kNB, ld,
                        rows_of(n, P - 1), reg);
  for (int k = P - 1; k >= 0; --k) {
    if (k % G == me) {   // x_k = L_D^-T r_k, r_k = its rhs less its partials
      const int m = k / G;
      __syncthreads();   // every partial of r_k added
      T vv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cc = col_of<T>(lane, j);
        const T* q = sh.part + m * kG * kNB + cc;
        T s = T(0);
#pragma unroll
        for (int gg = 0; gg < kG; ++gg) s += q[gg * kNB];
        vv[j] = sh.rhs[m * kNB + cc] - s;
      }
      dot_dinv(m == 0 ? sh.dinv : nullptr, Dinv + (int64_t)k * kNB * kNB,
               true, vv, [&](int r, T s) {
                 if (k * kNB + r < n) publish(x + k * kNB + r, s);
               });
    }
    if (me >= k) break;     // no panel of this CTA above k
    const T* v = vk[k & 1];
    receive(x, n, k, vk[k & 1]);
    for (int p = me, m = 0; p < P; p += G, ++m) {
      if (p >= k) break;
      if (m > 0)
        load_cols(L + (int64_t)k * kNB * ld + p * kNB, ld,
                            rows_of(n, k), reg);
      T* q = sh.part + (m * kG + g) * kNB + c;   // this thread's own slots
#pragma unroll
      for (int h = 0; h < kV; ++h) {
        T s = T(0);
#pragma unroll
        for (int i = 0; i < kR; ++i) s += reg[i * kV + h] * v[kR * g + i];
        q[h] += s;
      }
    }
    if (me < k - 1)   // the next step's block, ahead of the wait
      load_cols(L + (int64_t)(k - 1) * kNB * ld + me * kNB, ld,
                          rows_of(n, k - 1), reg);
  }
}

// Launch `kernel` cooperatively: min(P, the CTAs the card holds at once)
// CTAs, each with Dinv, its rhs panels and (with `groups` > 0) their
// partial sums in dynamic shared memory.
template <typename T>
int launch_solve(void (*kernel)(int, int, int, const T*, const T*, const T*,
                                T*, const int*),
                 int groups, int n, int ld, cudaStream_t stream, const T* L,
                 const T* Dinv, const T* in, T* out, const int* stop) {
  const int P = (n + kNB - 1) / kNB;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int owned = (P + min(P, sms) - 1) / min(P, sms);
  const size_t shm = ((size_t)kNB * kPitch +
                      (size_t)owned * kNB * (1 + groups)) * sizeof(T);
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)shm);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    shm);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeCooperative;
  at[0].val.cooperative = 1;
  cfg.gridDim = dim3(min(P, sms * per_sm));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = shm;
  cfg.stream = stream;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, n, ld, P, L, Dinv, in, out, stop);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int forward(int n, int ld, const T* L, const T* Dinv, const T* b, T* y,
            const int* stop, void* stream) {
  return launch_solve<T>(dense_forward_kernel<T>, 0, n, ld,
                         (cudaStream_t)stream, L, Dinv, b, y, stop);
}

template <typename T>
int backward(int n, int ld, const T* L, const T* Dinv, const T* y, T* x,
             const int* stop, void* stream) {
  return launch_solve<T>(dense_backward_kernel<T>, kGroups<T>, n, ld,
                         (cudaStream_t)stream, L, Dinv, y, x, stop);
}

}  // namespace

// L: n x n row-major factor (lower triangle), rows ld entries apart;
// Dinv: ceil(n / 128) x 128 x 128; b, y: n, y filled with kPending.
// y = L^-1 b.  stop: null, or a word where the launch returns at once when
// it is set (the done word of a CG loop, linear/pcg.py).
GT_EXPORT int gt_dense_forward(int n, int ld, const double* L,
                               const double* Dinv, const double* b, double* y,
                               const int* stop, void* stream) {
  return forward<double>(n, ld, L, Dinv, b, y, stop, stream);
}

GT_EXPORT int gt_dense_forward_f32(int n, int ld, const float* L,
                                   const float* Dinv, const float* b,
                                   float* y, const int* stop, void* stream) {
  return forward<float>(n, ld, L, Dinv, b, y, stop, stream);
}

// y, x: n, x filled with kPending.  x = L^-T y.  stop: as above.
GT_EXPORT int gt_dense_backward(int n, int ld, const double* L,
                                const double* Dinv, const double* y,
                                double* x, const int* stop, void* stream) {
  return backward<double>(n, ld, L, Dinv, y, x, stop, stream);
}

GT_EXPORT int gt_dense_backward_f32(int n, int ld, const float* L,
                                    const float* Dinv, const float* y,
                                    float* x, const int* stop, void* stream) {
  return backward<float>(n, ld, L, Dinv, y, x, stop, stream);
}
