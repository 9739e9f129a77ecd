// Masked gossip mixing (DESIGN.md §15) for Hopper (sm_90a).
//
//     out[c, n] = sum_j mix[c, j] * x[j, n]
//
//     x: (C, N) row-major, float32 or bfloat16; mix: (C, C) row-major f32
//
// Replaces the TPU kernel repro/kernels/gossip_mix.py::_gossip_kernel
// (pallas_call at gossip_mix.py:59). The sum is accumulated in float32 and
// stored in x's type. Products are plain float32 fused multiply-adds: no
// tensor core and no TF32, so the result holds to a float32 matmul.
//
// What bounds it: memory. At the churn path's shapes (C = 8..32, N = 7900)
// the call reads 2*C*N + C*C values and does 2*C*C*N operations, 2..8
// operations per f32 byte, below the card's ~20 f32 operations per byte;
// at C = 32 the bytes take ~0.6 us and the operations ~0.24 us at the
// published peaks, so the launch itself is the real cost there.
//
// Design, a plain tiled product (not the TPU structure, which kept the
// whole (C, C) mix and a (C, 8192) tile in VMEM and ran one jnp.dot on
// the MXU per grid step, in order):
//  * each block owns a BM x BN = 32 x 64 tile of the output and walks
//    j in chunks of BK = 32, staging mix[rows, chunk] and x[chunk, cols]
//    in shared memory (12.4 KB); each of its 128 threads keeps a 4 x 4
//    tile of float32 accumulators in registers;
//  * the x tile is loaded along rows, neighbouring threads on
//    neighbouring columns, so every warp load is coalesced; the mix tile
//    is padded by one column so the accumulator reads are free of bank
//    conflicts;
//  * out-of-range rows, columns and chunk entries are loaded as 0, which
//    adds an exact 0 to each sum: any 1 <= C <= 1024 and N >= 1 work, the
//    ragged tiles are masked on store, and an identity row (a dead
//    client) returns that client's row bit for bit on finite inputs;
//  * the grid is (ceil(N / 64), ceil(C / 32)) independent blocks.
// Faster forms (wgmma on split-f32 operands, fusing the AFL consensus
// average into the same pass) are later work.
//
// C interface (bound with ctypes): every pointer and the stream is a
// void*; the launch runs on the caller's stream, does not synchronize and
// allocates nothing. The return value is cudaGetLastError() after the
// launch (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 32;       // output rows per block
constexpr int kBN = 64;       // output columns per block
constexpr int kBK = 32;       // mixing chunk
constexpr int kTM = 4;        // rows per thread
constexpr int kTN = 4;        // columns per thread
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);   // 128
constexpr int kMaxClients = 1024;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gossip_mix_kernel(const T* __restrict__ x, const float* __restrict__ mix,
                      T* __restrict__ out, int C, int64_t N) {
  __shared__ float s_mix[kBM][kBK + 1];
  __shared__ __align__(16) float s_x[kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);          // column group 0..15
  const int ty = tid / (kBN / kTN);          // row group 0..7
  const int row0 = blockIdx.y * kBM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * kBN;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < C; k0 += kBK) {
    // mix[row0 .. row0+BM, k0 .. k0+BK]: 1024 values, 8 per thread
#pragma unroll
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int r = e / kBK, k = e % kBK;
      const int gr = row0 + r, gk = k0 + k;
      s_mix[r][k] = (gr < C && gk < C)
                        ? mix[static_cast<int64_t>(gr) * C + gk] : 0.f;
    }
    // x[k0 .. k0+BK, col0 .. col0+BN]: 2048 values, 16 per thread
#pragma unroll
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int k = e / kBN, n = e % kBN;
      const int gk = k0 + k;
      const int64_t gn = col0 + n;
      s_x[k][n] = (gk < C && gn < N) ? to_f32(x[gk * N + gn]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = s_mix[ty * kTM + i][k];
      const float4 b = *reinterpret_cast<const float4*>(&s_x[k][tx * kTN]);
      const float bv[kTN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j)
          acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row0 + ty * kTM + i;
    if (r >= C) break;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int64_t n = col0 + tx * kTN + j;
      if (n < N) out[r * N + n] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* mix, void* out, int C, int64_t N,
           void* stream) {
  if (C < 1 || C > kMaxClients || N < 1 || N > (int64_t{1} << 40))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t col_blocks = (N + kBN - 1) / kBN;
  if (col_blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(col_blocks),
                  static_cast<unsigned int>((C + kBM - 1) / kBM));
  gossip_mix_kernel<T><<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(mix),
      static_cast<T*>(out), C, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gossip_mix_f32(const void* x, const void* mix, void* out,
                              int C, int64_t N, void* stream) {
  return launch<float>(x, mix, out, C, N, stream);
}

extern "C" int gossip_mix_bf16(const void* x, const void* mix, void* out,
                               int C, int64_t N, void* stream) {
  return launch<__nv_bfloat16>(x, mix, out, C, N, stream);
}
