// Fused FedAvg parameter aggregation (paper Eq. 5) for Hopper (sm_90a).
//
//     out[n] = sum_c w[c] * x[c, n]        x: (C, N) row-major, w: (C,) f32
//
// Replaces the TPU kernel repro/kernels/fedavg_agg.py::_fedavg_kernel
// (pallas_call at fedavg_agg.py:50). Inputs are float32 or bfloat16; the
// sum is accumulated in float32 and stored in the input's type.
//
// What bounds it: memory. Each x element is read once and used for one
// multiply-add, so the work is C*N*sizeof(T) bytes in, N*sizeof(T) out,
// about half an operation per f32 byte -- well below the card's ratio of
// compute to bandwidth (~20 f32 operations per byte). On the main path
// (N = 7900 f32, C = 2..8) the whole call moves ~0.1-0.3 MB, which the
// card streams in well under a microsecond, so the launch itself is the
// real cost; fusing launches is later work.
//
// Design, for a bandwidth-bound column reduction on Hopper (not the TPU
// structure, which staged (C, 16384) VMEM tiles on one core in order):
//  * one thread owns VEC neighbouring output columns and loops over the C
//    rows with a float32 accumulator per column; neighbouring threads read
//    neighbouring addresses of each row, so every warp load is coalesced;
//  * VEC = 16 bytes / sizeof(T) (float4 for f32, 8 x bf16) when N is a
//    multiple of VEC and the pointers are 16-byte aligned, else VEC = 1;
//  * the C weights are staged once per block in shared memory;
//  * the grid is ceil(N / (VEC * threads)) independent blocks (no order,
//    no carry between them), and the ragged edge is masked. N is not
//    padded: the TPU wrapper's pad copies the whole (C, N) matrix
//    whenever N is not a block multiple, which is every main-path call.
//
// C interface (bound with ctypes): every pointer and the stream is a
// void*; the launch runs on the caller's stream, does not synchronize and
// allocates nothing. The return value is cudaGetLastError() after the
// launch (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// The weights live in static-limit dynamic shared memory (48 KB).
constexpr int kMaxClients = 48 * 1024 / sizeof(float);

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

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    fedavg_agg_kernel(const T* __restrict__ x, const float* __restrict__ w,
                      T* __restrict__ out, int C, int64_t N) {
  extern __shared__ float sw[];
  for (int c = threadIdx.x; c < C; c += blockDim.x) sw[c] = w[c];
  __syncthreads();

  const int64_t col =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * VEC;
  if (col >= N) return;  // ragged edge (VEC > 1 only when N % VEC == 0)

  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;

  const T* p = x + col;
  for (int c = 0; c < C; ++c, p += N) {
    const Pack<T, VEC> v = *reinterpret_cast<const Pack<T, VEC>*>(p);
    const float wc = sw[c];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] += wc * to_f32(v.v[j]);
  }

  Pack<T, VEC> o;
#pragma unroll
  for (int j = 0; j < VEC; ++j) o.v[j] = from_f32<T>(acc[j]);
  *reinterpret_cast<Pack<T, VEC>*>(out + col) = o;
}

template <typename T, int VEC>
int launch(const void* x, const void* w, void* out, int C, int64_t N,
           void* stream) {
  const int64_t per_block = static_cast<int64_t>(kThreads) * VEC;
  const int64_t blocks = (N + per_block - 1) / per_block;
  fedavg_agg_kernel<T, VEC>
      <<<static_cast<unsigned int>(blocks), kThreads, C * sizeof(float),
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(x), static_cast<const float*>(w),
          static_cast<T*>(out), C, N);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* w, void* out, int C, int64_t N,
             void* stream) {
  if (C < 1 || C > kMaxClients || N < 1 || N > (int64_t{1} << 40))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned =
      (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
      (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (N % kVec == 0 && aligned)
    return launch<T, kVec>(x, w, out, C, N, stream);
  return launch<T, 1>(x, w, out, C, N, stream);
}

}  // namespace

extern "C" int fedavg_agg_f32(const void* x, const void* w, void* out, int C,
                              int64_t N, void* stream) {
  return dispatch<float>(x, w, out, C, N, stream);
}

extern "C" int fedavg_agg_bf16(const void* x, const void* w, void* out, int C,
                               int64_t N, void* stream) {
  return dispatch<__nv_bfloat16>(x, w, out, C, N, stream);
}
