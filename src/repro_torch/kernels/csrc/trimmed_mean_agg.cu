// Coordinate-wise trimmed mean / median (Byzantine-robust aggregation)
// for Hopper (sm_90a).
//
//     out[n] = mean of the order statistics of rank lo..hi-1 of x[:, n]
//              x: (C, N) row-major; lo = trim, hi = C - trim
//
// Median is lo = (C-1)/2, hi = C - lo: one middle value for odd C, the
// mean of the two middle values for even C. Replaces the TPU kernel
// repro/kernels/robust_agg.py::_trimmed_kernel (pallas_call at
// robust_agg.py:190). Inputs are float32 or bfloat16; the sort and the sum
// run in float32 and the result is stored in the input's type. A column
// that holds a NaN comes back NaN (the TPU kernel's min/max network
// spreads a NaN to every rank); +-inf sort as ordinary values.
//
// What bounds it: memory. Each x element is read once and each output
// written once: C*N*sizeof(T) + N*sizeof(T) bytes, 1 MB at C = 32,
// N = 7900 f32: 0.31 us at an H100 SXM's 3.35 TB/s (data sheet). On the
// main path (C = 4..32, N = 7900) the call is short enough that the
// launch and the latency of its dependent steps decide its time: the
// first port gave one thread to one column (7900 threads, 247 one-warp
// blocks on 132 SMs) and sorted it with a bitonic network through shared
// memory, 240 compare-exchanges at C = 32, each a round trip: 7.0 us in a
// CUDA graph (NVIDIA H100 80GB HBM3, 700 W).
//
// Design for C <= 64 (trimmed_reg_kernel): the same bitonic network, in
// registers. One thread owns one column and loads it (C independent
// coalesced loads, all in flight at once) into a register array padded to
// Cp = 4, 8, 16, 32 or 64 with +inf; the network (240 compare-exchanges at
// Cp = 32, 2 instructions each, 16 independent a stage) is unrolled at
// compile time, so its indices are immediates and no value goes through
// memory; ranks lo..hi-1 are summed in ascending order as one chain,
// acc += sorted[r] from acc = 0, and divided by hi - lo. The same sorted
// values added in the same order as the first port's kernel: the same
// bits (equal values are the same number, but for -0 and +0, whose order
// moves no sum). A NaN anywhere in a column makes the column NaN; +-inf
// sort as ordinary values. One-warp blocks: 247 at N = 7900.
//
// What the probes showed (NVIDIA H100 80GB HBM3, 700.00 W; CUDA graph,
// C = 32, N = 7900 f32; PERF.md section 6): the first port 6.95-7.07 us;
// rank selection (a (C, 16) tile a block staged in shared memory, each
// thread ranking R = 2 of a column's values by C compares, 494 blocks of
// 8 warps) 3.45-3.59 us, with R = 4 3.18-3.26 us: filling the card with
// C^2 compares a column cost more than it hid; the register network
// 2.24-2.29 us, 1.53-1.57 at C = 8, 1.46-1.48 at C = 4, where fedavg_agg
// reads the same bytes in 2.08 us at C = 32: the launch and one pass over
// the bytes, not the network, are what is left.
//
// Above C = 64 the first port's kernel runs (trimmed_mean_kernel), the
// column in shared memory:
//  * one thread owns one column; the thread copies its column into shared
//    memory, padded to Cp = next power of two with +inf (the pad sorts
//    above every kept rank, as on the TPU), and sorts it with a bitonic
//    network over runtime loops, laid out [row][thread] (no barrier, no
//    bank conflicts, coalesced loads);
//  * shared memory per block is Cp * threads * 4 bytes: threads shrink
//    from 256 to 32 as Cp grows (32 KB per block up to Cp = 256), and
//    while the grid would leave SMs idle; above 48 KB (Cp >= 512) the
//    kernel opts in to more dynamic shared memory. kMaxClients = 1024
//    keeps a 32-thread block at 128 KB.
// Both kernels sort and sum in float32 and store the input's type.
//
// C interface (bound with ctypes): every pointer and the stream is a
// void*; the launch runs on the caller's stream, does not synchronize and
// allocates nothing. The return value is cudaGetLastError() after the
// launch (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxClients = 1024;
constexpr int kMaxThreads = 256;
constexpr int kMinThreads = 32;
constexpr int kSmemBudget = 32 * 1024;   // bytes per block below Cp = 512

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The bitonic network over the padded row count Cp (a power of two).
template <typename T>
__global__ void trimmed_mean_kernel(const T* __restrict__ x,
                                    T* __restrict__ out, int C, int Cp,
                                    int64_t N, int lo, int hi) {
  extern __shared__ float s[];  // [Cp][blockDim.x]
  const int T_ = blockDim.x;
  const int64_t n = static_cast<int64_t>(blockIdx.x) * T_ + threadIdx.x;
  if (n >= N) return;  // no barrier below: each thread owns its column
  float* col = s + threadIdx.x;  // row r of this thread's column: col[r*T_]

  bool has_nan = false;
  for (int c = 0; c < C; ++c) {
    const float v = to_f32(x[static_cast<int64_t>(c) * N + n]);
    has_nan |= isnan(v);
    col[c * T_] = v;
  }
  for (int c = C; c < Cp; ++c) col[c * T_] = INFINITY;

  // merge phase k = 2^kb, compare distance j = 2^jb; pair (i, i^j),
  // ascending where bit k of i is clear
  int lg = 0;
  while ((1 << lg) < Cp) ++lg;
  for (int kb = 1; kb <= lg; ++kb) {
    for (int jb = kb - 1; jb >= 0; --jb) {
      for (int i = 0; i < Cp; ++i) {
        const int l = i ^ (1 << jb);
        if (l <= i) continue;
        const float a = col[i * T_];
        const float b = col[l * T_];
        const float mn = fminf(a, b), mx = fmaxf(a, b);
        const bool asc = (i & (1 << kb)) == 0;
        col[i * T_] = asc ? mn : mx;
        col[l * T_] = asc ? mx : mn;
      }
    }
  }

  float acc = 0.f;
  for (int r = lo; r < hi; ++r) acc += col[r * T_];
  acc /= static_cast<float>(hi - lo);
  out[n] = from_f32<T>(has_nan ? NAN : acc);
}

constexpr int kRegClients = 64;   // the register kernel's largest C

// One thread per column, the column in registers, padded to CP (a power
// of two, at most 64) with +inf; the network and the sum unroll at
// compile time, so every index is an immediate and nothing goes through
// memory between the loads and the store.
template <typename T, int CP>
__global__ void __launch_bounds__(32)
    trimmed_reg_kernel(const T* __restrict__ x, T* __restrict__ out, int C,
                       int64_t N, int lo, int hi) {
  const int64_t n = static_cast<int64_t>(blockIdx.x) * 32 + threadIdx.x;
  if (n >= N) return;
  float v[CP];
  bool has_nan = false;
#pragma unroll
  for (int i = 0; i < CP; ++i) {
    v[i] = i < C ? to_f32(x[static_cast<int64_t>(i) * N + n]) : INFINITY;
    has_nan |= isnan(v[i]);
  }
  // merge phase k, compare distance j; pair (i, i^j), ascending where
  // bit k of i is clear
#pragma unroll
  for (int k = 2; k <= CP; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1)
#pragma unroll
      for (int i = 0; i < CP; ++i) {
        const int l = i ^ j;
        if (l <= i) continue;
        const float a = v[i], b = v[l];
        const bool asc = (i & k) == 0;
        v[i] = asc ? fminf(a, b) : fmaxf(a, b);
        v[l] = asc ? fmaxf(a, b) : fminf(a, b);
      }
  float acc = 0.f;
#pragma unroll
  for (int r = 0; r < CP; ++r)
    if (r >= lo && r < hi) acc += v[r];
  acc /= static_cast<float>(hi - lo);
  out[n] = from_f32<T>(has_nan ? NAN : acc);
}

template <typename T, int CP>
int launch_reg(const T* x, T* out, int C, int64_t N, int lo, int hi,
               cudaStream_t stream) {
  const int64_t blocks = (N + 31) / 32;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  trimmed_reg_kernel<T, CP>
      <<<static_cast<unsigned int>(blocks), 32, 0, stream>>>(x, out, C, N,
                                                             lo, hi);
  return static_cast<int>(cudaGetLastError());
}

// Threads per block: at most the shared-memory budget allows, and fewer
// (down to one warp) while the grid would not give every SM two blocks.
int threads_for(int Cp, int64_t N) {
  int threads = kMaxThreads;
  while (threads > kMinThreads &&
         (static_cast<int64_t>(Cp) * threads * 4 > kSmemBudget ||
          (N + threads - 1) / threads < 2 * 132))
    threads >>= 1;
  return threads;
}

template <typename T>
int launch_sort(const T* x, T* out, int C, int Cp, int64_t N, int lo,
                int hi, cudaStream_t stream) {
  const int threads = threads_for(Cp, N);
  const size_t smem = static_cast<size_t>(Cp) * threads * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        trimmed_mean_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int64_t blocks = (N + threads - 1) / threads;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  trimmed_mean_kernel<T>
      <<<static_cast<unsigned int>(blocks), threads, smem, stream>>>(
          x, out, C, Cp, N, lo, hi);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* xv, void* outv, int C, int64_t N, int lo, int hi,
           void* sv) {
  if (C < 1 || C > kMaxClients || N < 1 || lo < 0 || hi > C || hi <= lo)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* x = static_cast<const T*>(xv);
  T* out = static_cast<T*>(outv);
  const cudaStream_t stream = static_cast<cudaStream_t>(sv);
  if (C <= 4) return launch_reg<T, 4>(x, out, C, N, lo, hi, stream);
  if (C <= 8) return launch_reg<T, 8>(x, out, C, N, lo, hi, stream);
  if (C <= 16) return launch_reg<T, 16>(x, out, C, N, lo, hi, stream);
  if (C <= 32) return launch_reg<T, 32>(x, out, C, N, lo, hi, stream);
  if (C <= kRegClients)
    return launch_reg<T, 64>(x, out, C, N, lo, hi, stream);
  int Cp = 1;
  while (Cp < C) Cp <<= 1;
  return launch_sort<T>(x, out, C, Cp, N, lo, hi, stream);
}

}  // namespace

extern "C" int trimmed_mean_agg_f32(const void* x, void* out, int C,
                                    int64_t N, int lo, int hi, void* stream) {
  return launch<float>(x, out, C, N, lo, hi, stream);
}

extern "C" int trimmed_mean_agg_bf16(const void* x, void* out, int C,
                                     int64_t N, int lo, int hi,
                                     void* stream) {
  return launch<__nv_bfloat16>(x, out, C, N, lo, hi, stream);
}
