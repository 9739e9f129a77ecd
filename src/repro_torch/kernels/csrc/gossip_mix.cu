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
// published peaks, so what a call costs is the launch and one round trip
// to memory: how soon every load is in flight and how many warps wait on
// it.
//
// Every output is one chain of fused multiply-adds over j = 0 .. C - 1,
// starting from 0.f, in all three kernels below: the first port's order, so
// every output keeps the first port's bits and no federated run moves.
// Out-of-range loads are exact zeros (a zero term leaves the chain's
// value as it is), so an identity row (a dead client) returns that
// client's row bit for bit on finite inputs.
//
// Both kernels for C <= 32 (the churn path) issue each thread's 16-byte
// loads of x (float4, or 8 bf16, where N is a multiple of the vector and
// the pointers are 16-byte aligned; element loads otherwise) and its mix
// values before the first store to shared memory, so all of a block's
// loads are in flight together, and meet at one barrier.
//
// C <= 8 (gossip_small_kernel): the row tile is 8 rows, so no padding row
// is loaded or multiplied at C = 8. A block owns the 8 rows of a 64-column
// slab (124 blocks of 128 threads at N = 7900 f32); each thread runs the
// chain for one row and one vector of columns out of shared memory (the
// mix rows padded by one float: no bank conflicts).
//
// 8 < C <= 32 (gossip_rows_kernel): the row tile is 32 rows. Each thread
// keeps 4 rows of the mix in registers (128 floats) and computes them for
// one vector of columns, so each x vector read from shared memory feeds
// 16 multiply-adds. A block owns the 32 rows of a 64-column slab: 8 row
// groups x 16 vectors, 4 loads of x a thread, 124 blocks of 128 threads
// at N = 7900 f32. Measured at C = 32 (PERF.md section 6): 32-column slabs
// (247 blocks of 64 threads) took 3.2-3.5 us in a CUDA graph, 64-column
// ones 2.8, 128-column ones 3.7; 2 rows a thread 3.4-3.5; one thread per
// row and vector (the mix in shared memory) 3.5-3.6. A variant without
// the multiply-adds, the same loads and stores, took 2.8-3.0 at 32
// columns: the call is its launch and one round trip of 2 MB.
//
// C > 32 (gossip_mix_kernel, the first port's kernel, up to 1024 clients):
// each block owns a 32 x 64 output tile and walks j in chunks of 32,
// staging mix[rows, chunk] and x[chunk, cols] in shared memory (12.4 KB);
// each of its 128 threads keeps a 4 x 4 tile of accumulators; the ragged
// tiles are masked on store; grid (ceil(N / 64), ceil(C / 32)).
//
// C interface (bound with ctypes): every pointer and the stream is a
// void*; the launch runs on the caller's stream, does not synchronize and
// allocates nothing. The return value is cudaGetLastError() after the
// launch (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the tiled kernel for C > 32
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

// ---- C <= 8 ----------------------------------------------------------------

template <typename T>
constexpr int kVec = 16 / sizeof(T);         // columns a 16-byte vector holds
constexpr int kSmallRows = 8;
constexpr int kSmallCols = 64;               // columns a block owns

template <typename T, bool VEC>
__global__ void __launch_bounds__(kSmallRows * kSmallCols / kVec<T>)
    gossip_small_kernel(const T* __restrict__ x,
                        const float* __restrict__ mix, T* __restrict__ out,
                        int C, int64_t N) {
  constexpr int CP = kSmallRows;
  constexpr int V = kVec<T>;
  constexpr int G = kSmallCols / V;          // vectors per row of the slab
  constexpr int kT = CP * G;                 // threads: one vector each
  constexpr int kMixPer = (CP * CP + kT - 1) / kT;
  __shared__ float s_mix[CP][CP + 1];
  __shared__ __align__(16) float s_x[CP][G * V];

  const int tid = threadIdx.x;
  const int r = tid / G;                     // row of x loaded, of out kept
  const int g = tid % G;                     // vector of the slab
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kSmallCols + g * V;

  // every global load first: one vector of x, then this thread's mix
  float xv[V];
  if (VEC) {
    if (r < C && col < N) {
      const T* src = x + r * N + col;
      if constexpr (sizeof(T) == 4) {
        const float4 v = *reinterpret_cast<const float4*>(src);
        xv[0] = v.x; xv[1] = v.y; xv[2] = v.z; xv[3] = v.w;
      } else {
        const uint4 v = *reinterpret_cast<const uint4*>(src);
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
        for (int k = 0; k < V; ++k) xv[k] = to_f32(e[k]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) xv[k] = 0.f;
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k)
      xv[k] = (r < C && col + k < N) ? to_f32(x[r * N + col + k]) : 0.f;
  }
  float mv[kMixPer];
#pragma unroll
  for (int m = 0; m < kMixPer; ++m) {
    const int e = tid + m * kT, mr = e / CP, mj = e % CP;
    mv[m] = (e < CP * CP && mr < C && mj < C) ? mix[mr * C + mj] : 0.f;
  }

#pragma unroll
  for (int k = 0; k < V; ++k) s_x[r][g * V + k] = xv[k];
#pragma unroll
  for (int m = 0; m < kMixPer; ++m) {
    const int e = tid + m * kT;
    if (e < CP * CP) s_mix[e / CP][e % CP] = mv[m];
  }
  __syncthreads();

  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.f;
#pragma unroll
  for (int j = 0; j < CP; ++j) {             // j >= C adds exact zeros
    const float m = s_mix[r][j];
#pragma unroll
    for (int k = 0; k < V; k += 4) {
      const float4 b = *reinterpret_cast<const float4*>(&s_x[j][g * V + k]);
      acc[k] = fmaf(m, b.x, acc[k]);
      acc[k + 1] = fmaf(m, b.y, acc[k + 1]);
      acc[k + 2] = fmaf(m, b.z, acc[k + 2]);
      acc[k + 3] = fmaf(m, b.w, acc[k + 3]);
    }
  }

  if (r >= C) return;
  T* dst = out + r * N + col;
  if (VEC) {
    if (col >= N) return;
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
      uint4 v;
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
      for (int k = 0; k < V; ++k) e[k] = from_f32<T>(acc[k]);
      *reinterpret_cast<uint4*>(dst) = v;
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (col + k < N) dst[k] = from_f32<T>(acc[k]);
  }
}

// 16-byte loads and stores: N a multiple of the vector, both pointers
// 16-byte aligned
template <typename T>
bool vec_ok(const T* x, const T* out, int64_t N) {
  return N % kVec<T> == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0
         && reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

template <typename T, bool VEC>
int launch_small_as(const T* x, const float* mix, T* out, int C,
                    int64_t N, cudaStream_t stream) {
  const int64_t blocks = (N + kSmallCols - 1) / kSmallCols;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  gossip_small_kernel<T, VEC>
      <<<static_cast<unsigned int>(blocks), kSmallRows * kSmallCols / kVec<T>,
         0, stream>>>(x, mix, out, C, N);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_small(const T* x, const float* mix, T* out, int C, int64_t N,
                 cudaStream_t stream) {
  return vec_ok(x, out, N)
             ? launch_small_as<T, true>(x, mix, out, C, N, stream)
             : launch_small_as<T, false>(x, mix, out, C, N, stream);
}

// ---- 8 < C <= 32 ------------------------------------------------------------

constexpr int kRowsPer = 4;                  // rows a thread computes
constexpr int kRowGroups = 32 / kRowsPer;    // 8

constexpr int kRowsCols = 64;                // columns a block owns

template <typename T>
constexpr int kRowsThreads = kRowGroups * kRowsCols / kVec<T>;

template <typename T, bool VEC>
__global__ void __launch_bounds__(kRowsThreads<T>)
    gossip_rows_kernel(const T* __restrict__ x,
                       const float* __restrict__ mix, T* __restrict__ out,
                       int C, int64_t N) {
  constexpr int V = kVec<T>;
  constexpr int G = kRowsCols / V;           // vectors per row of the slab
  constexpr int kT = kRowsThreads<T>;
  constexpr int kLoads = 32 * G / kT;        // x vectors a thread loads: 4
  __shared__ __align__(16) float s_x[32][kRowsCols];

  const int tid = threadIdx.x;
  const int g = tid % G;                     // vector of the slab
  const int rg = tid / G;                    // row group: rows 4 rg .. + 3
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kRowsCols + g * V;

  // every global load first: 4 vectors of x (rows rg + 8 l), then 4 rows
  // of the mix
  float xv[kLoads][V];
#pragma unroll
  for (int l = 0; l < kLoads; ++l) {
    const int r = rg + kRowGroups * l;
    if (VEC) {
      if (r < C && col < N) {
        const T* src = x + r * N + col;
        if constexpr (sizeof(T) == 4) {
          const float4 v = *reinterpret_cast<const float4*>(src);
          xv[l][0] = v.x; xv[l][1] = v.y; xv[l][2] = v.z; xv[l][3] = v.w;
        } else {
          const uint4 v = *reinterpret_cast<const uint4*>(src);
          const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
          for (int k = 0; k < V; ++k) xv[l][k] = to_f32(e[k]);
        }
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) xv[l][k] = 0.f;
      }
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k)
        xv[l][k] = (r < C && col + k < N) ? to_f32(x[r * N + col + k]) : 0.f;
    }
  }
  float m[kRowsPer][32];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const int r = kRowsPer * rg + i;
#pragma unroll
    for (int j = 0; j < 32; ++j)
      m[i][j] = (r < C && j < C) ? mix[r * C + j] : 0.f;
  }

#pragma unroll
  for (int l = 0; l < kLoads; ++l)
#pragma unroll
    for (int k = 0; k < V; ++k) s_x[rg + kRowGroups * l][g * V + k] = xv[l][k];
  __syncthreads();

  float acc[kRowsPer][V];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
    for (int k = 0; k < V; ++k) acc[i][k] = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) {             // j >= C adds exact zeros
#pragma unroll
    for (int k = 0; k < V; k += 4) {
      const float4 b = *reinterpret_cast<const float4*>(&s_x[j][g * V + k]);
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) {
        acc[i][k] = fmaf(m[i][j], b.x, acc[i][k]);
        acc[i][k + 1] = fmaf(m[i][j], b.y, acc[i][k + 1]);
        acc[i][k + 2] = fmaf(m[i][j], b.z, acc[i][k + 2]);
        acc[i][k + 3] = fmaf(m[i][j], b.w, acc[i][k + 3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const int r = kRowsPer * rg + i;
    if (r >= C) break;
    T* dst = out + r * N + col;
    if (VEC) {
      if (col >= N) break;
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      } else {
        uint4 v;
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
        for (int k = 0; k < V; ++k) e[k] = from_f32<T>(acc[i][k]);
        *reinterpret_cast<uint4*>(dst) = v;
      }
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k)
        if (col + k < N) dst[k] = from_f32<T>(acc[i][k]);
    }
  }
}

template <typename T, bool VEC>
int launch_rows_as(const T* x, const float* mix, T* out, int C, int64_t N,
                   cudaStream_t stream) {
  const int64_t blocks = (N + kRowsCols - 1) / kRowsCols;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  gossip_rows_kernel<T, VEC>
      <<<static_cast<unsigned int>(blocks), kRowsThreads<T>, 0, stream>>>(
          x, mix, out, C, N);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rows(const T* x, const float* mix, T* out, int C, int64_t N,
                cudaStream_t stream) {
  return vec_ok(x, out, N)
             ? launch_rows_as<T, true>(x, mix, out, C, N, stream)
             : launch_rows_as<T, false>(x, mix, out, C, N, stream);
}

// ---- C > 32 ----------------------------------------------------------------

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
int launch(const void* xp, const void* mixp, void* outp, int C, int64_t N,
           void* stream_p) {
  if (C < 1 || C > kMaxClients || N < 1 || N > (int64_t{1} << 40))
    return static_cast<int>(cudaErrorInvalidValue);
  const T* x = static_cast<const T*>(xp);
  const float* mix = static_cast<const float*>(mixp);
  T* out = static_cast<T*>(outp);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_p);
  if (C <= kSmallRows) return launch_small<T>(x, mix, out, C, N, stream);
  if (C <= 32) return launch_rows<T>(x, mix, out, C, N, stream);
  const int64_t col_blocks = (N + kBN - 1) / kBN;
  if (col_blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(col_blocks),
                  static_cast<unsigned int>((C + kBM - 1) / kBM));
  gossip_mix_kernel<T><<<grid, kThreads, 0, stream>>>(x, mix, out, C, N);
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
