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
// written once: C*N*sizeof(T) + N*sizeof(T) bytes. The sorting network
// does ~Cp*log2(Cp)^2/4 compare-exchanges per column (240 at C = 32),
// i.e. ~4 operations per f32 byte read at C = 32 -- below the card's
// ~20 f32 operations per byte, so the bytes bound it up to C ~ 2^10.
// On the main path (C = 4..32, N = 7900) the call moves 0.1-1 MB, which
// the card streams in well under a microsecond: the launch is the real
// cost, as for fedavg_agg.
//
// Design (not the TPU structure, which sorted (C, BLOCK) VMEM tiles with
// vectorized min/max over reshaped slices, one grid step after another):
//  * one thread owns one column; a block owns `threads` neighbouring
//    columns, and blocks are independent (nothing carries between them);
//  * the thread copies its column into shared memory, padded to
//    Cp = next power of two with +inf (the pad sorts above every kept
//    rank, as on the TPU), and sorts it with a bitonic network;
//  * shared memory is laid out [row][thread]: a thread only ever touches
//    its own column, so no barrier is needed, neighbouring threads hit
//    neighbouring banks (no conflicts), and the loads x[c*N + n] of a
//    warp are coalesced;
//  * rows lo..hi-1 of the sorted column are summed in f32 and divided by
//    hi - lo; the NaN check is a flag kept while loading, so the network
//    itself uses plain fminf/fmaxf;
//  * up to Cp = 64 the network is unrolled at compile time (one kernel
//    per Cp), so a stage's independent compare-exchanges overlap instead
//    of waiting on each other's shared-memory round trips; larger Cp
//    loops at run time. On an H100 the unrolled kernel takes 6.9-7.0 us
//    at C = 32, N = 7900 against 17.8 us for the runtime loop, and 2.3
//    against 3.6 us at C = 8 (device time in a CUDA graph; PERF.md);
//  * shared memory per block is Cp * threads * 4 bytes: threads shrink
//    from 256 to 32 as Cp grows (32 KB per block up to Cp = 256), and
//    while the grid would leave SMs idle (N = 7900 runs 247 one-warp
//    blocks on the 132 SMs); above 48 KB (Cp >= 512) the kernel opts in
//    to more dynamic shared memory. kMaxClients = 1024 keeps a 32-thread
//    block at 128 KB.
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

template <int V>
struct Log2 {
  static constexpr int value = 1 + Log2<V / 2>::value;
};
template <>
struct Log2<1> {
  static constexpr int value = 0;
};
template <>
struct Log2<0> {
  static constexpr int value = 0;
};

// CP > 0: the padded row count is a compile-time constant and the network
// unrolls fully (indices and directions become immediates, and the 2..32
// independent compare-exchanges of a stage overlap); CP == 0: runtime
// loops over the padded row count `cp`.
template <typename T, int CP>
__global__ void trimmed_mean_kernel(const T* __restrict__ x,
                                    T* __restrict__ out, int C, int cp,
                                    int64_t N, int lo, int hi) {
  extern __shared__ float s[];  // [Cp][blockDim.x]
  const int Cp = CP > 0 ? CP : cp;
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

  // bitonic network: merge phase k = 2^kb, compare distance j = 2^jb;
  // pair (i, i^j), ascending where bit k of i is clear
  int lg = Log2<CP>::value;
  if (CP == 0)
    while ((1 << lg) < Cp) ++lg;
#pragma unroll
  for (int kb = 1; kb <= lg; ++kb) {
#pragma unroll
    for (int jb = kb - 1; jb >= 0; --jb) {
#pragma unroll
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

template <typename T, int CP>
int launch_cp(const T* x, T* out, int C, int Cp, int64_t N, int lo, int hi,
              cudaStream_t stream) {
  const int threads = threads_for(Cp, N);
  const size_t smem = static_cast<size_t>(Cp) * threads * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        trimmed_mean_kernel<T, CP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int64_t blocks = (N + threads - 1) / threads;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  trimmed_mean_kernel<T, CP>
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
  int Cp = 1;
  while (Cp < C) Cp <<= 1;
  switch (Cp) {
    case 2: return launch_cp<T, 2>(x, out, C, Cp, N, lo, hi, stream);
    case 4: return launch_cp<T, 4>(x, out, C, Cp, N, lo, hi, stream);
    case 8: return launch_cp<T, 8>(x, out, C, Cp, N, lo, hi, stream);
    case 16: return launch_cp<T, 16>(x, out, C, Cp, N, lo, hi, stream);
    case 32: return launch_cp<T, 32>(x, out, C, Cp, N, lo, hi, stream);
    case 64: return launch_cp<T, 64>(x, out, C, Cp, N, lo, hi, stream);
    default: return launch_cp<T, 0>(x, out, C, Cp, N, lo, hi, stream);
  }
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
