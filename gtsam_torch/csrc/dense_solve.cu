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
//   y_k = L_D^-1 r_k, writes it to y and publishes it (flags[k]); every CTA
//   that owns a panel i > k waits for that flag, then subtracts L_ik y_k
//   from its rhs, reading panel k's column strip of L once (right-looking).
// gt_dense_backward: for k = P-1, ..., 0: the owner forms x_k = L_D^-T r_k
//   into x and publishes it; every CTA that owns a panel j < k subtracts
//   L_kj^T x_k from it, reading panel k's row strip once.
// A CTA waits only for the panel it needs next, not for the whole grid (a
// grid barrier a panel, the first design, took 0.64 / 0.76 ms a direction
// in float64 on an H100), and loads its next block of L into registers
// before it waits.  A block product is a warp per 8 rows (lanes along the
// row, one 128- or 256-byte load a row) reduced by a transposing butterfly
// (forward), or a thread per column and 32 rows with the 4 row groups'
// partials summed in order through shared memory (backward).  No atomics:
// every sum runs in a fixed order, so the same inputs give the same bits.
// The cooperative launch keeps every CTA resident, so a wait always ends.
// Bound on the H100: L's lower triangle read once a direction, n^2 / 2
// entries (0.287 ms in float64, 0.144 ms in float32 at n = 15,507); the
// chain of P - 1 publications, each a block product, a fence and a flag
// away from the next, adds a latency floor of a few microseconds a panel.
#include "ba_common.cuh"

namespace {

constexpr int kNB = 128;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kNB / kWarps;     // 8
constexpr int kGroups = kThreads / kNB;        // 4 row groups (backward)
constexpr int kGroupRows = kNB / kGroups;      // 32
constexpr unsigned kFull = 0xffffffffu;

// A load through the read-only path from device memory (kGlobal), or a
// plain load (shared memory).
template <bool kGlobal, typename T>
__device__ __forceinline__ T load1(const T* p) {
  if constexpr (kGlobal) return __ldg(p); else return *p;
}

// Row layout: lane l of warp w holds M[8w + a][l + 32 j] (a < 8, j < 4),
// rows at or past `rows` read as 0.
template <bool kGlobal, typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ M,
                                          int64_t ldm, int rows, T reg[32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int a = 0; a < kRowsPerWarp; ++a) {
    const int r = warp * kRowsPerWarp + a;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      reg[a * 4 + j] =
          r < rows ? load1<kGlobal>(M + r * ldm + lane + 32 * j) : T(0);
  }
}

// store(r, sum_c M[r][c] v[c]) for the 128 rows of a row-layout block,
// called by one lane of each row.  The 8 rows' partials of a warp are
// summed by a butterfly that halves the values a lane holds at each of
// its first three steps (offsets 16, 8, 4), then over the 4 lanes left.
template <typename T, typename Store>
__device__ __forceinline__ void dot_rows(const T reg[32], const T* v,
                                         Store store) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T p[8];
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    T s = T(0);
#pragma unroll
    for (int j = 0; j < 4; ++j) s += reg[a * 4 + j] * v[lane + 32 * j];
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

// Column layout: warp w takes columns 32 (w % 4) + lane and rows
// 32 (w / 4) + i (i < 32) of M, rows at or past `rows` read as 0.
template <bool kGlobal, typename T>
__device__ __forceinline__ void load_cols(const T* __restrict__ M,
                                          int64_t ldm, int rows, T reg[32]) {
  const int warp = threadIdx.x >> 5;
  const int c = 32 * (warp % kGroups) + (threadIdx.x & 31);
  const int r0 = kGroupRows * (warp / kGroups);
#pragma unroll
  for (int i = 0; i < kGroupRows; ++i)
    reg[i] = r0 + i < rows ? load1<kGlobal>(M + (r0 + i) * ldm + c) : T(0);
}

// store(c, sum_r M[r][c] v[r]) for the 128 columns of a column-layout
// block, called by threads 0-127; part: kGroups x 128 of shared scratch.
// Ends with a barrier of the CTA.
template <typename T, typename Store>
__device__ __forceinline__ void dot_cols(const T reg[32], const T* v, T* part,
                                         Store store) {
  const int warp = threadIdx.x >> 5;
  const int c = 32 * (warp % kGroups) + (threadIdx.x & 31);
  const int g = warp / kGroups;
  T s = T(0);
#pragma unroll
  for (int i = 0; i < kGroupRows; ++i) s += reg[i] * v[kGroupRows * g + i];
  part[g * kNB + c] = s;
  __syncthreads();
  if (threadIdx.x < kNB) {
    T t = part[threadIdx.x];
#pragma unroll
    for (int q = 1; q < kGroups; ++q) t += part[q * kNB + threadIdx.x];
    store(threadIdx.x, t);
  }
  __syncthreads();
}

// Panel k's solution is published by its owner through flags[k] (0 until
// then; the wrapper zeroes the flags for each launch): every thread that
// wrote a value fences it to device scope, the CTA meets a barrier, and one
// thread stores the flag with release semantics.  A consumer's first thread
// spins on the flag with acquire loads; the CTA then reads the values past
// L1.
__device__ __forceinline__ void publish(int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(flag), "r"(1)
                 : "memory");
}

__device__ __forceinline__ void await(const int* flag) {
  if (threadIdx.x == 0) {
    int v = 0;
    do {
      asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
                   : "=r"(v)
                   : "l"(flag)
                   : "memory");
    } while (v == 0);
  }
  __syncthreads();
}

// The last panel CTA me owns (me < P).
__device__ __forceinline__ int last_owned(int P, int G, int me) {
  return me + (P - 1 - me) / G * G;
}

__device__ __forceinline__ int rows_of(int n, int p) {
  return min(kNB, n - p * kNB);
}

// Shared memory: Dinv of the CTA's first panel, then `owned` rhs panels.
template <typename T>
struct Shared {
  T* dinv;
  T* rhs;
  __device__ Shared(unsigned char* s)
      : dinv(reinterpret_cast<T*>(s)), rhs(dinv + kNB * kNB) {}
};

template <typename T>
__device__ void stage(int n, int P, const T* __restrict__ Dinv,
                      const T* __restrict__ src, Shared<T> sh) {
  const int G = gridDim.x, me = blockIdx.x;
  if (me < P)
    for (int e = threadIdx.x; e < kNB * kNB; e += kThreads)
      sh.dinv[e] = Dinv[(int64_t)me * kNB * kNB + e];
  for (int p = me, m = 0; p < P; p += G, ++m)
    for (int r = threadIdx.x; r < kNB; r += kThreads)
      sh.rhs[m * kNB + r] = p * kNB + r < n ? src[p * kNB + r] : T(0);
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) dense_forward_kernel(
    int n, int ld, int P, const T* __restrict__ L,
    const T* __restrict__ Dinv, const T* __restrict__ b, T* y,
    int* __restrict__ flags) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T vk[kNB];
  const Shared<T> sh(smem);
  const int G = gridDim.x, me = blockIdx.x;
  const int last = last_owned(P, G, me);
  stage(n, P, Dinv, b, sh);
  T reg[32];
  // this CTA's first panel's block in column strip 0
  if (me > 0 && me < P)
    load_rows<true>(L + (int64_t)me * kNB * ld, ld, rows_of(n, me), reg);
  for (int k = 0; k < P; ++k) {
    if (k % G == me) {   // y_k = L_D^-1 r_k
      const int m = k / G;
      T dreg[32];
      if (m == 0)
        load_rows<false>(sh.dinv, kNB, kNB, dreg);
      else
        load_rows<true>(Dinv + (int64_t)k * kNB * kNB, kNB, kNB, dreg);
      dot_rows(dreg, sh.rhs + m * kNB, [&](int r, T s) {
        if (k * kNB + r < n) y[k * kNB + r] = s;
      });
      publish(flags + k);
    }
    if (last <= k) break;   // no panel of this CTA below k
    await(flags + k);
    for (int c = threadIdx.x; c < kNB; c += kThreads)
      vk[c] = k * kNB + c < n ? __ldcg(y + k * kNB + c) : T(0);
    __syncthreads();
    for (int p = me, m = 0; p < P; p += G, ++m) {
      if (p <= k) continue;
      if (m > 0)
        load_rows<true>(L + (int64_t)p * kNB * ld + k * kNB, ld,
                        rows_of(n, p), reg);
      T* r = sh.rhs + m * kNB;
      dot_rows(reg, vk, [&](int i, T s) { r[i] -= s; });
    }
    if (me > k + 1)   // the next step's block, ahead of the wait
      load_rows<true>(L + (int64_t)me * kNB * ld + (k + 1) * kNB, ld,
                      rows_of(n, me), reg);
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) dense_backward_kernel(
    int n, int ld, int P, const T* __restrict__ L,
    const T* __restrict__ Dinv, const T* __restrict__ y, T* x,
    int* __restrict__ flags) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T vk[kNB];
  __shared__ T part[kGroups * kNB];
  const Shared<T> sh(smem);
  const int G = gridDim.x, me = blockIdx.x;
  stage(n, P, Dinv, y, sh);
  T reg[32];
  // this CTA's first panel's block in row strip P - 1
  if (me < P - 1)
    load_cols<true>(L + (int64_t)(P - 1) * kNB * ld + me * kNB, ld,
                    rows_of(n, P - 1), reg);
  for (int k = P - 1; k >= 0; --k) {
    if (k % G == me) {   // x_k = L_D^-T r_k
      const int m = k / G;
      T dreg[32];
      if (m == 0)
        load_cols<false>(sh.dinv, kNB, kNB, dreg);
      else
        load_cols<true>(Dinv + (int64_t)k * kNB * kNB, kNB, kNB, dreg);
      dot_cols(dreg, sh.rhs + m * kNB, part, [&](int c, T s) {
        if (k * kNB + c < n) x[k * kNB + c] = s;
      });
      publish(flags + k);
    }
    if (me >= k) break;     // no panel of this CTA above k
    await(flags + k);
    for (int r = threadIdx.x; r < kNB; r += kThreads)
      vk[r] = k * kNB + r < n ? __ldcg(x + k * kNB + r) : T(0);
    __syncthreads();
    for (int p = me, m = 0; p < P; p += G, ++m) {
      if (p >= k) break;
      if (m > 0)
        load_cols<true>(L + (int64_t)k * kNB * ld + p * kNB, ld,
                        rows_of(n, k), reg);
      T* r = sh.rhs + m * kNB;
      dot_cols(reg, vk, part, [&](int c, T s) { r[c] -= s; });
    }
    if (me < k - 1)   // the next step's block, ahead of the wait
      load_cols<true>(L + (int64_t)(k - 1) * kNB * ld + me * kNB, ld,
                      rows_of(n, k - 1), reg);
    __syncthreads();
  }
}

// Launch `kernel` cooperatively: min(P, the CTAs the card holds at once)
// CTAs, each with Dinv and its rhs panels in dynamic shared memory.
template <typename T, typename... Act>
int launch_solve(void (*kernel)(int, int, int, const T*, const T*, const T*,
                                T*, int*),
                 int n, int ld, cudaStream_t stream, Act... args) {
  const int P = (n + kNB - 1) / kNB;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int owned = (P + min(P, sms) - 1) / min(P, sms);
  const size_t shm = ((size_t)kNB * kNB + (size_t)owned * kNB) * sizeof(T);
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
  e = cudaLaunchKernelEx(&cfg, kernel, n, ld, P, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// L: n x n row-major factor (lower triangle), rows ld entries apart;
// Dinv: ceil(n / 128) x 128 x 128; b, y: n; flags: ceil(n / 128) ints,
// zero.  y = L^-1 b.
GT_EXPORT int gt_dense_forward(int n, int ld, const double* L,
                               const double* Dinv, const double* b, double* y,
                               int* flags, void* stream) {
  return launch_solve<double>(dense_forward_kernel<double>, n, ld,
                              (cudaStream_t)stream, L, Dinv, b, y, flags);
}

GT_EXPORT int gt_dense_forward_f32(int n, int ld, const float* L,
                                   const float* Dinv, const float* b,
                                   float* y, int* flags, void* stream) {
  return launch_solve<float>(dense_forward_kernel<float>, n, ld,
                             (cudaStream_t)stream, L, Dinv, b, y, flags);
}

// y, x: n; flags as above.  x = L^-T y.
GT_EXPORT int gt_dense_backward(int n, int ld, const double* L,
                                const double* Dinv, const double* y,
                                double* x, int* flags, void* stream) {
  return launch_solve<double>(dense_backward_kernel<double>, n, ld,
                              (cudaStream_t)stream, L, Dinv, y, x, flags);
}

GT_EXPORT int gt_dense_backward_f32(int n, int ld, const float* L,
                                    const float* Dinv, const float* y,
                                    float* x, int* flags, void* stream) {
  return launch_solve<float>(dense_backward_kernel<float>, n, ld,
                             (cudaStream_t)stream, L, Dinv, y, x, flags);
}
