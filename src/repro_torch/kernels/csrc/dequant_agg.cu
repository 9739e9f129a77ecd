// Fused dequantize + weighted FedAvg reduce for Hopper (sm_90a).
//
//     out[n] = sum_c (s[c] * w[c]) * float(q[c, n])
//
//     q: (C, N) int8 row-major (the QSGD wire format), s, w: (C,) float32
//     scale and normalized weight per client, out: (N,) float32.
//
// Replaces the TPU kernel repro/kernels/comm_agg.py::_dequant_agg_kernel
// (pallas_call at comm_agg.py:58). The scale x weight product is folded
// first, in float32, as the TPU wrapper and its plain version do, and the
// sum is accumulated in float32.
//
// What bounds it: memory. Each int8 element is read once and used for one
// multiply-add, so the call moves C*N + 8*C bytes in and 4*N bytes out;
// at the main path's (32, 7900) that is ~0.29 MB, which the card streams
// in well under a microsecond, so the launch is the real cost.
//
// Design, for a bandwidth-bound column reduction of bytes on Hopper (not
// the TPU structure, which staged (C, 16384) int8 VMEM tiles in order):
//  * one thread owns VEC = 4 neighbouring output columns and loops over
//    the C rows with a float32 accumulator per column; a warp reads 128
//    consecutive bytes of each row, so every load is coalesced;
//  * rows start at c*N bytes. N = 7900 is a multiple of 4 but not of 16,
//    so a 16-byte load would be misaligned on every other row: the vector
//    path loads char4 (4 bytes) and is taken only when N % 4 == 0 and the
//    pointers are aligned; otherwise VEC = 1 (one byte per thread per
//    row). The ragged edge is masked; nothing is read past the end;
//  * the C products s[c]*w[c] are computed once per block into shared
//    memory;
//  * the grid is ceil(N / (VEC * threads)) independent blocks.
//
// C interface (bound with ctypes): every pointer and the stream is a
// void*; the launch runs on the caller's stream, does not synchronize and
// allocates nothing. The return value is cudaGetLastError() after the
// launch (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
// s*w lives in static-limit dynamic shared memory (48 KB).
constexpr int kMaxClients = 48 * 1024 / sizeof(float);

template <int VEC>
struct alignas(VEC) Bytes {
  int8_t v[VEC];
};

template <int VEC>
struct alignas(4 * VEC) Floats {
  float v[VEC];
};

template <int VEC>
__global__ void __launch_bounds__(kThreads)
    dequant_agg_kernel(const int8_t* __restrict__ q,
                       const float* __restrict__ s,
                       const float* __restrict__ w, float* __restrict__ out,
                       int C, int64_t N) {
  extern __shared__ float sw[];
  for (int c = threadIdx.x; c < C; c += blockDim.x) sw[c] = s[c] * w[c];
  __syncthreads();

  const int64_t col =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * VEC;
  if (col >= N) return;  // ragged edge (VEC > 1 only when N % VEC == 0)

  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;

  const int8_t* p = q + col;
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    const Bytes<VEC> v =
        *reinterpret_cast<const Bytes<VEC>*>(p + static_cast<int64_t>(c) * N);
    const float swc = sw[c];
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      acc[j] += swc * static_cast<float>(v.v[j]);
  }

  Floats<VEC> o;
#pragma unroll
  for (int j = 0; j < VEC; ++j) o.v[j] = acc[j];
  *reinterpret_cast<Floats<VEC>*>(out + col) = o;
}

template <int VEC>
int launch(const void* q, const void* s, const void* w, void* out, int C,
           int64_t N, void* stream) {
  const int64_t per_block = static_cast<int64_t>(kThreads) * VEC;
  const int64_t blocks = (N + per_block - 1) / per_block;
  dequant_agg_kernel<VEC>
      <<<static_cast<unsigned int>(blocks), kThreads, C * sizeof(float),
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int8_t*>(q), static_cast<const float*>(s),
          static_cast<const float*>(w), static_cast<float*>(out), C, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dequant_agg(const void* q, const void* s, const void* w,
                           void* out, int C, int64_t N, void* stream) {
  if (C < 1 || C > kMaxClients || N < 1 || N > (int64_t{1} << 40))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = (reinterpret_cast<uintptr_t>(q) % 4 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (N % 4 == 0 && aligned) return launch<4>(q, s, w, out, C, N, stream);
  return launch<1>(q, s, w, out, C, N, stream);
}
