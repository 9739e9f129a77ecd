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
// in well under a microsecond, so what it takes instead is the launch,
// the latency of the loads each thread waits on, and how many SMs issue
// them.
//
// Design, for a bandwidth-bound column reduction of bytes on Hopper (not
// the TPU structure, which staged (C, 16384) int8 VMEM tiles in order):
//  * the first port gave each of 128 threads 4 columns and walked all C
//    rows, 4 loads in flight at a time: 16 blocks at N = 7900, on 16 of
//    132 SMs, and C/4 load latencies in a row (3.2 us at C = 32). Now a
//    block covers 32 * VEC columns (62 blocks at N = 7900) and splits the
//    rows over its warps: one warp for every 8 rows, up to 8 warps, each
//    on whole batches of 8 consecutive rows (C = 8: 1 warp, C = 32: 4,
//    C = 64: 8, C = 12288: 8 warps of 1536 rows);
//  * VEC = 4 neighbouring columns a thread. Rows start at c*N bytes, and
//    N = 7900 is a multiple of 4 but not of 16, so a 16-byte load would
//    be misaligned on every other row: the vector path loads one 32-bit
//    word a row and is taken only when N % 4 == 0 and the pointers are
//    aligned; otherwise VEC = 1 (one byte a thread a row, any N, any
//    view). A warp reads 32 * VEC consecutive bytes of a row, so every
//    load is coalesced. The ragged edge is masked; nothing is read past
//    the end;
//  * a thread issues the 8 loads of a batch before it uses any, each
//    row's address one add from the last, with no predicate on them (a
//    short last batch takes a plain loop), and keeps each word packed
//    until its multiply-adds: predicated loads, a multiply per address,
//    or bytes unpacked on arrival made the loads go out one after another
//    on the card (~0.1 us a row). The first batch goes out before s*w is
//    staged in shared memory, so the two latencies overlap;
//  * the warps' float32 partial sums are then added through shared
//    memory (apart from s*w, so one barrier suffices) in one fixed order,
//    warp 0 first. This reassociates the sum against the plain version
//    (the gate is 1e-6 of sum_c |s_c w_c q[c, n]|, and the kernel is off
//    the federated round path), but without atomics: one input gives one
//    result, bit for bit, on every run;
//  * blocks are independent (no order, no carry between them).
//
// C interface (bound with ctypes): every pointer and the stream is a
// void*; the launch runs on the caller's stream, does not synchronize and
// allocates nothing. The return value is cudaGetLastError() after the
// launch (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kBatch = 8;         // loads a thread has in flight
constexpr int kRowsPerWarp = 8;   // rows a warp takes before another is added
constexpr int kMaxGroups = 8;     // warps a block, each on its own rows
// the wrapper's limit on C: s*w is staged in at most 48 KB of shared memory
constexpr int kMaxClients = 48 * 1024 / sizeof(float);

// A thread's VEC int8 values of one row, loaded as one word and kept
// packed until they are used (a char array is unpacked into a register a
// byte as soon as it arrives, which makes the thread wait for the load).
template <int VEC>
struct WordOf;
template <>
struct WordOf<1> {
  using type = int8_t;
};
template <>
struct WordOf<4> {
  using type = int32_t;
};
template <int VEC>
using Word = typename WordOf<VEC>::type;

template <int VEC>
struct alignas(4 * VEC) Floats {
  float v[VEC];
};

template <int VEC>
__device__ __forceinline__ void fma_row(float (&acc)[VEC], Word<VEC> v,
                                        float swc) {
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    acc[j] += swc * static_cast<float>(static_cast<int8_t>(v >> (8 * j)));
}

// Warp g of a block adds rows [g * per, (g + 1) * per) of its 32 * VEC
// columns into a float32 partial sum, kBatch loads in flight at a time;
// warp 0 then adds the other warps' partial sums in the order g = 1, 2,
// ... through shared memory.
template <int VEC>
__global__ void __launch_bounds__(32 * kMaxGroups)
    dequant_agg_kernel(const int8_t* __restrict__ q,
                       const float* __restrict__ s,
                       const float* __restrict__ w, float* __restrict__ out,
                       int C, int per, int64_t N) {
  // s*w for every row; the warps' partial sums apart, so that no warp
  // waits for the others to finish with s*w before it writes its own
  extern __shared__ float smem[];
  __shared__ Floats<VEC> part[kMaxGroups - 1][32];
  const int groups = blockDim.x / 32;
  const int g = threadIdx.x / 32, t = threadIdx.x % 32;
  const int64_t col = (static_cast<int64_t>(blockIdx.x) * 32 + t) * VEC;
  const bool in = col < N;  // ragged edge (VEC > 1 only when N % VEC == 0)
  const int lo = g * per, hi = min(C, lo + per);
  const int8_t* r = q + col + static_cast<int64_t>(lo) * N;

  // the first whole batch goes out before s*w is staged
  const bool first = in && lo + kBatch <= hi;
  Word<VEC> v0[kBatch];
  if (first) {
#pragma unroll
    for (int i = 0; i < kBatch; ++i, r += N)
      v0[i] = *reinterpret_cast<const Word<VEC>*>(r);
  }
  for (int c = threadIdx.x; c < C; c += blockDim.x) smem[c] = s[c] * w[c];
  __syncthreads();

  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
  if (in && lo < hi) {
    int c = lo;
    if (first) {
#pragma unroll
      for (int i = 0; i < kBatch; ++i) fma_row<VEC>(acc, v0[i], smem[c + i]);
      c += kBatch;
    }
    // whole batches: the kBatch loads go out before the first is used,
    // each row's address one add from the last
    for (; c + kBatch <= hi; c += kBatch) {
      Word<VEC> v[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i, r += N)
        v[i] = *reinterpret_cast<const Word<VEC>*>(r);
#pragma unroll
      for (int i = 0; i < kBatch; ++i) fma_row<VEC>(acc, v[i], smem[c + i]);
    }
    for (; c < hi; ++c, r += N)                  // a short last batch
      fma_row<VEC>(acc, *reinterpret_cast<const Word<VEC>*>(r), smem[c]);
  }

  if (groups > 1) {
    if (g > 0) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) part[g - 1][t].v[j] = acc[j];
    }
    __syncthreads();
    if (g > 0) return;
    for (int h = 1; h < groups; ++h) {
      const Floats<VEC> o = part[h - 1][t];
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] += o.v[j];
    }
  }
  if (in) {
    Floats<VEC> o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) o.v[j] = acc[j];
    *reinterpret_cast<Floats<VEC>*>(out + col) = o;
  }
}

template <int VEC>
int launch(const void* q, const void* s, const void* w, void* out, int C,
           int64_t N, void* stream) {
  // one warp for every kRowsPerWarp rows, up to kMaxGroups, each warp on
  // whole batches of rows
  const int batches = (C + kBatch - 1) / kBatch;
  const int groups =
      std::min(kMaxGroups, (C + kRowsPerWarp - 1) / kRowsPerWarp);
  const int per = kBatch * ((batches + groups - 1) / groups);
  const int64_t per_block = 32 * VEC;
  const int64_t blocks = (N + per_block - 1) / per_block;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * C;
  // above 48 KB of shared memory a block needs the kernel's consent
  static bool opted_in = false;
  if (smem + sizeof(Floats<VEC>) * 32 * (kMaxGroups - 1) > 48 * 1024 &&
      !opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        dequant_agg_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(float) * kMaxClients));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  dequant_agg_kernel<VEC>
      <<<static_cast<unsigned int>(blocks), 32 * groups, smem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int8_t*>(q), static_cast<const float*>(s),
          static_cast<const float*>(w), static_cast<float*>(out), C, per, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dequant_agg(const void* q, const void* s, const void* w,
                           void* out, int C, int64_t N, void* stream) {
  if (C < 1 || C > kMaxClients || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = (reinterpret_cast<uintptr_t>(q) % 4 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (N % 4 == 0 && aligned) return launch<4>(q, s, w, out, C, N, stream);
  return launch<1>(q, s, w, out, C, N, stream);
}
