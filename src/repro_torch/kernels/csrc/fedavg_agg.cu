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
// (N = 7900 f32, C = 2..32) the whole call moves 0.1-1 MB, which the
// card streams in 0.05-0.3 us; what it takes instead is the launch, the
// latency of the loads each thread waits on, and how many SMs issue them.
//
// Design, for a bandwidth-bound column reduction on Hopper (not the TPU
// structure, which staged (C, 16384) VMEM tiles on one core in order):
//  * VEC neighbouring output columns per thread: VEC = 16 bytes /
//    sizeof(T) (float4 for f32, 8 x bf16) when N is a multiple of VEC and
//    the pointers are 16-byte aligned, else VEC = 1 (any N, any pointer);
//    neighbouring threads read neighbouring addresses of each row, so
//    every warp load is coalesced; the ragged edge is masked, N is not
//    padded (the TPU wrapper's pad copies the whole matrix);
//  * C <= 4 (the first port's kernel): each of 256 threads walks all C
//    rows for its columns, so a block covers 256 * VEC columns (8 blocks
//    at N = 7900 f32); the C weights are staged once per block in shared
//    memory;
//  * C > 4: the first port's kernel ran 8 blocks at N = 7900, 8 of 132
//    SMs, whose threads each walked all C rows (3.6 us at C = 32, w @ x
//    2.0). Now the loads are split over the rows as well as the columns:
//    a block covers 32 * VEC columns (62 blocks at N = 7900 f32), and for
//    each chunk of 64 rows its 8 warps load up to 8 rows each, all of a
//    thread's 16-byte loads in flight together, into shared memory
//    (32 KB). Measured on the card, it is the faster of the two from
//    C = 8 up and the slower at C = 2 and 4, hence the split at 4;
//  * the sum keeps one fixed order: after each chunk the first warp adds
//    its rows in the order c = 0, 1, ..., C - 1, the same multiply-adds
//    in the same order as one thread walking all rows. No atomics, no
//    partial sums: both kernels give the first port's bits at every C,
//    so no federated run moves by a bit (partial sums of row groups,
//    added in a fixed order, ran C = 32 in 1.9 us in place of 2.1, but
//    moved the 32-client runs' training trajectories);
//  * blocks are independent (no order, no carry between them).
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
constexpr int kRowGroups = kThreads / 32;  // warps loading rows, C > 4
constexpr int kChunk = 64;                 // rows staged at a time, C > 4
constexpr int kSplitAbove = 4;             // C <= 4: the first port's kernel
// the wrapper's limit on C (the first port's kernel staged the weights in
// at most 48 KB)
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

// v by value: one 16-byte load of the pack, not VEC loads of its elements
template <typename T, int VEC>
__device__ __forceinline__ void fma_pack(float (&acc)[VEC],
                                         const Pack<T, VEC> v, float wc) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] += wc * to_f32(v.v[j]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_pack(T* out, const float (&acc)[VEC]) {
  Pack<T, VEC> o;
#pragma unroll
  for (int j = 0; j < VEC; ++j) o.v[j] = from_f32<T>(acc[j]);
  *reinterpret_cast<Pack<T, VEC>*>(out) = o;
}

// C <= 4 (the first port's kernel): each of the 256 threads walks all C
// rows for its VEC columns.
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
  for (int c = 0; c < C; ++c, p += N)
    fma_pack<T, VEC>(acc, *reinterpret_cast<const Pack<T, VEC>*>(p), sw[c]);
  store_pack<T, VEC>(out + col, acc);
}

// C > 4: the loads are split over the rows as well as the columns. A block
// covers 32 * VEC columns; per chunk of 64 rows, warp g loads rows g,
// g + 8, ..., g + 56 (up to eight 16-byte loads in flight a thread) into
// shared memory, and the first warp then adds the rows in the order
// c = 0, 1, ..., C - 1: the multiply-adds of fedavg_agg_kernel in its
// order, so both kernels give the same bits for the same inputs.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    fedavg_rows_kernel(const T* __restrict__ x, const float* __restrict__ w,
                       T* __restrict__ out, int C, int64_t N) {
  __shared__ Pack<T, VEC> tile[kChunk][32];
  __shared__ float sw[kChunk];
  const int g = threadIdx.x / 32, t = threadIdx.x % 32;
  const int64_t col = (static_cast<int64_t>(blockIdx.x) * 32 + t) * VEC;
  const bool in = col < N;  // ragged edge (VEC > 1 only when N % VEC == 0)

  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
  for (int c0 = 0; c0 < C; c0 += kChunk) {
    const int rows = min(kChunk, C - c0);
    if (c0 > 0) __syncthreads();          // the last chunk has been added
    if (threadIdx.x < rows) sw[threadIdx.x] = w[c0 + threadIdx.x];
    if (in) {
      const T* p = x + static_cast<int64_t>(c0) * N + col;
#pragma unroll
      for (int i = 0; i < kChunk / kRowGroups; ++i) {
        const int r = g + i * kRowGroups;
        if (r < rows)
          tile[r][t] = *reinterpret_cast<const Pack<T, VEC>*>(p + r * N);
      }
    }
    __syncthreads();
    if (g == 0 && in) {
#pragma unroll 8
      for (int r = 0; r < rows; ++r) fma_pack<T, VEC>(acc, tile[r][t], sw[r]);
    }
  }
  if (g == 0 && in) store_pack<T, VEC>(out + col, acc);
}

template <typename T, int VEC>
int launch(const void* x, const void* w, void* out, int C, int64_t N,
           void* stream) {
  const bool split = C > kSplitAbove;
  const int64_t per_block = static_cast<int64_t>(split ? 32 : kThreads) * VEC;
  const dim3 grid(static_cast<unsigned int>((N + per_block - 1) / per_block));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  const float* wt = static_cast<const float*>(w);
  T* ot = static_cast<T*>(out);
  if (split)
    fedavg_rows_kernel<T, VEC><<<grid, kThreads, 0, st>>>(xt, wt, ot, C, N);
  else
    fedavg_agg_kernel<T, VEC><<<grid, kThreads, C * sizeof(float), st>>>(
        xt, wt, ot, C, N);
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
