// Chunked Mamba2 / SSD scan for Hopper (sm_90a).
//
//     h_t = exp(a_t) * h_{t-1} + dt_t * x_t B_t^T,   y_t = h_t C_t
//
//     x, y: (B, S, H, DH); a (log-decay), dt: (B, S, H) float32;
//     Bm, Cm: (B, S, N), shared by the H heads; h: (DH, N) per (b, h).
//     x, Bm, Cm and y are all float32 or all bfloat16.
//
// Replaces the TPU kernel repro/kernels/ssm_scan.py::_ssd_kernel
// (pallas_call at ssm_scan.py:84) and computes what it computes, chunk by
// chunk of Q rows, with cs = cumsum(a) inside the chunk:
//     W = (C B^T) o exp(cs_i - cs_j) [i >= j] o dt_j          (Q x Q)
//     y = W x + exp(cs) o (C state^T)                          (Q x DH)
//     state = exp(cs_last) state + (x o exp(cs_last - cs) dt)^T B
// all in float32, the (DH, N) state carried from chunk to chunk.
//
// What bounds it: memory, on paper. At zamba2-1.2b's prefill (B = 2,
// S = 4096, H = 64, DH = 64, N = 64, Q = 128) it moves about 140 MB
// (x and y in bfloat16 are 67 MB each; Bm, Cm, a, dt the rest): 42 us at
// 3.35 TB/s; its 26 GFLOP take 26 us at the tensor cores' bf16 peak. This
// first kernel uses float32 fused multiply-adds on one block per (b, h),
// so its time is that of B*H = 128 blocks each walking S / Q = 32 chunks
// in order; tensor-core tiles and splitting the chunks over more blocks
// (the state passing as a second pass) are later work.
//
// Design (not the TPU structure, which ran a (B*H, n_chunks) grid with the
// chunk axis sequential and the state in VMEM scratch):
//  * one block of 256 threads per (b, h); a loop over the chunks in order
//    takes the place of the sequential grid axis, and the state stays in
//    shared memory for the whole sequence;
//  * Bm and Cm are read by batch index: the reference materialises them
//    broadcast over the H heads (ssm_scan.py:79-81), H copies here;
//  * per chunk, x, Bm, Cm, the Q x Q matrix W, the state, cs, dt and the
//    decay-to-end weights live in dynamic shared memory, rows padded by one
//    float so the strided reads are free of bank conflicts: 184 KB at
//    Q = 128, DH = 64, N = 64 (the wrapper raises above 227 KB);
//  * the decay exp(cs_i - cs_j) is computed only where i >= j: above the
//    diagonal the exponent is positive and may overflow, and inf * 0 is
//    NaN;
//  * cs is an inclusive scan over the chunk by one warp;
//  * thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16*r and
//    columns tx + 16*c of each product, so a warp's shared-memory reads
//    are broadcasts or consecutive words.
// DH is a template parameter (32, 64); Q <= 128 and N <= 128 at run time.
//
// C interface (bound with ctypes): every pointer and the stream is a
// void*; the launch runs on the caller's stream, does not synchronize and
// allocates nothing. The return value is cudaGetLastError() after the
// launch (0 = launched), or cudaErrorInvalidValue for a shape the kernel
// does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQMax = 128;       // chunk rows
constexpr int kNMax = 128;       // state width
constexpr int kR = kQMax / 16;   // chunk rows per thread
constexpr int kNC = kNMax / 16;  // state columns per thread
constexpr int kMaxSmem = 232448;

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

size_t smem_floats(int DH, int N, int Q) {
  return size_t(Q) * (DH + 1) + 2 * size_t(Q) * (N + 1)
         + size_t(Q) * (Q + 1) + size_t(DH) * (N + 1) + 3 * size_t(Q);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    ssd_kernel(const T* __restrict__ x, const float* __restrict__ a,
               const float* __restrict__ dt, const T* __restrict__ Bm,
               const T* __restrict__ Cm, T* __restrict__ y, int S, int H,
               int N, int Q) {
  constexpr int LX = DH + 1;
  constexpr int kP = DH / 16;      // x / state columns (rows) per thread
  const int LN = N + 1, LW = Q + 1;
  extern __shared__ float sm[];
  float* x_s = sm;                 // Q x LX
  float* b_s = x_s + Q * LX;       // Q x LN
  float* c_s = b_s + Q * LN;       // Q x LN
  float* w_s = c_s + Q * LN;       // Q x LW
  float* st_s = w_s + Q * LW;      // DH x LN, the carried state
  float* cs_s = st_s + DH * LN;    // Q: cumsum of a
  float* dt_s = cs_s + Q;          // Q
  float* u_s = dt_s + Q;           // Q: exp(cs_last - cs) * dt

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.x / H, h = blockIdx.x % H;

  for (int e = tid; e < DH * LN; e += kThreads) st_s[e] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int64_t row0 = int64_t(b) * S + c0;       // (b, c0) in (B, S)
    for (int e = tid; e < Q * DH; e += kThreads) {
      const int i = e / DH, p = e % DH;
      x_s[i * LX + p] = to_f32(x[((row0 + i) * H + h) * DH + p]);
    }
    for (int e = tid; e < Q * N; e += kThreads) {
      const int i = e / N, n = e % N;
      b_s[i * LN + n] = to_f32(Bm[(row0 + i) * N + n]);
      c_s[i * LN + n] = to_f32(Cm[(row0 + i) * N + n]);
    }
    for (int i = tid; i < Q; i += kThreads) {
      cs_s[i] = a[(row0 + i) * H + h];
      dt_s[i] = dt[(row0 + i) * H + h];
    }
    __syncthreads();

    if (tid < 32) {                 // inclusive scan of a over the chunk
      const int per = (Q + 31) / 32;
      float loc[kQMax / 32];
      float run = 0.f;
#pragma unroll
      for (int t = 0; t < kQMax / 32; ++t) {
        const int i = tid * per + t;
        if (t < per && i < Q) run += cs_s[i];
        loc[t] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
#pragma unroll
      for (int t = 0; t < kQMax / 32; ++t) {
        const int i = tid * per + t;
        if (t < per && i < Q) cs_s[i] = excl + loc[t];
      }
    }
    __syncthreads();
    const float cs_last = cs_s[Q - 1];
    for (int i = tid; i < Q; i += kThreads)
      u_s[i] = expf(cs_last - cs_s[i]) * dt_s[i];

    {                               // W = (C B^T) o L o dt
      float g[kR][kR];
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int c = 0; c < kR; ++c) g[r][c] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[kR], bv[kR];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const int i = ty + 16 * r;
          cv[r] = i < Q ? c_s[i * LN + n] : 0.f;
          const int j = tx + 16 * r;
          bv[r] = j < Q ? b_s[j * LN + n] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kR; ++r)
#pragma unroll
          for (int c = 0; c < kR; ++c) g[r][c] = fmaf(cv[r], bv[c], g[r][c]);
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int i = ty + 16 * r;
#pragma unroll
        for (int c = 0; c < kR; ++c) {
          const int j = tx + 16 * c;
          if (i < Q && j < Q) {
            const float l = i >= j ? g[r][c] * expf(cs_s[i] - cs_s[j]) : 0.f;
            w_s[i * LW + j] = l * dt_s[j];
          }
        }
      }
    }
    __syncthreads();

    {                               // y = W x + exp(cs) o (C state^T)
      float yi[kR][kP], ye[kR][kP];
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int c = 0; c < kP; ++c) yi[r][c] = ye[r][c] = 0.f;
      for (int j = 0; j < Q; ++j) {
        float wv[kR], xv[kP];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const int i = ty + 16 * r;
          wv[r] = i < Q ? w_s[i * LW + j] : 0.f;
        }
#pragma unroll
        for (int c = 0; c < kP; ++c) xv[c] = x_s[j * LX + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < kR; ++r)
#pragma unroll
          for (int c = 0; c < kP; ++c) yi[r][c] = fmaf(wv[r], xv[c], yi[r][c]);
      }
      for (int n = 0; n < N; ++n) {
        float cv[kR], sv[kP];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const int i = ty + 16 * r;
          cv[r] = i < Q ? c_s[i * LN + n] : 0.f;
        }
#pragma unroll
        for (int c = 0; c < kP; ++c) sv[c] = st_s[(tx + 16 * c) * LN + n];
#pragma unroll
        for (int r = 0; r < kR; ++r)
#pragma unroll
          for (int c = 0; c < kP; ++c) ye[r][c] = fmaf(cv[r], sv[c], ye[r][c]);
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int i = ty + 16 * r;
        if (i < Q) {
          const float e = expf(cs_s[i]);
          const int64_t out = ((row0 + i) * H + h) * DH;
#pragma unroll
          for (int c = 0; c < kP; ++c)
            y[out + tx + 16 * c] = from_f32<T>(yi[r][c] + e * ye[r][c]);
        }
      }
    }

    {                               // the state, decayed to the chunk end
      float sn[kP][kNC];
#pragma unroll
      for (int r = 0; r < kP; ++r)
#pragma unroll
        for (int c = 0; c < kNC; ++c) sn[r][c] = 0.f;
      for (int qq = 0; qq < Q; ++qq) {
        const float uq = u_s[qq];
        float xu[kP], bv[kNC];
#pragma unroll
        for (int r = 0; r < kP; ++r) xu[r] = x_s[qq * LX + ty + 16 * r] * uq;
#pragma unroll
        for (int c = 0; c < kNC; ++c) {
          const int n = tx + 16 * c;
          bv[c] = n < N ? b_s[qq * LN + n] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kP; ++r)
#pragma unroll
          for (int c = 0; c < kNC; ++c) sn[r][c] = fmaf(xu[r], bv[c], sn[r][c]);
      }
      const float dec = expf(cs_last);
#pragma unroll
      for (int r = 0; r < kP; ++r)
#pragma unroll
        for (int c = 0; c < kNC; ++c) {
          const int n = tx + 16 * c;
          if (n < N) sn[r][c] += dec * st_s[(ty + 16 * r) * LN + n];
        }
      __syncthreads();              // every read of the old state is done
#pragma unroll
      for (int r = 0; r < kP; ++r)
#pragma unroll
        for (int c = 0; c < kNC; ++c) {
          const int n = tx + 16 * c;
          if (n < N) st_s[(ty + 16 * r) * LN + n] = sn[r][c];
        }
    }
  }
}

template <typename T, int DH>
int launch(const void* x, const float* a, const float* dt, const void* Bm,
           const void* Cm, void* y, int B, int S, int H, int N, int Q,
           cudaStream_t stream) {
  const size_t smem = smem_floats(DH, N, Q) * sizeof(float);
  static bool attr_set = false;   // once per instantiation, before any
  if (!attr_set) {                // CUDA-graph capture of a launch
    cudaError_t e = cudaFuncSetAttribute(
        ssd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return int(e);
    attr_set = true;
  }
  ssd_kernel<T, DH><<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(x), a, dt, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), S, H, N, Q);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const float* a, const float* dt, const void* Bm,
             const void* Cm, void* y, int B, int S, int H, int DH, int N,
             int Q, cudaStream_t stream) {
  if (DH == 32)
    return launch<T, 32>(x, a, dt, Bm, Cm, y, B, S, H, N, Q, stream);
  if (DH == 64)
    return launch<T, 64>(x, a, dt, Bm, Cm, y, B, S, H, N, Q, stream);
  return int(cudaErrorInvalidValue);
}

bool shape_ok(int B, int S, int H, int DH, int N, int Q) {
  return B > 0 && H > 0 && S > 0 && Q > 0 && Q <= kQMax && S % Q == 0
         && N > 0 && N <= kNMax && (DH == 32 || DH == 64)
         && int64_t(B) * H <= 2147483647
         && smem_floats(DH, N, Q) * sizeof(float) <= size_t(kMaxSmem);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, Bm, Cm, y); a and dt are float32
int ssm_scan(const void* x, const void* a, const void* dt, const void* Bm,
             const void* Cm, void* y, int B, int S, int H, int DH, int N,
             int Q, int dtype, void* stream) {
  if (!shape_ok(B, S, H, DH, N, Q)) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* dtf = static_cast<const float*>(dt);
  if (dtype == 0)
    return dispatch<float>(x, af, dtf, Bm, Cm, y, B, S, H, DH, N, Q, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, af, dtf, Bm, Cm, y, B, S, H, DH, N, Q,
                                   st);
  return int(cudaErrorInvalidValue);
}

// Dynamic shared memory of one block at (DH, N, Q), and how many such
// blocks one SM holds at once (float32 inputs).
int ssm_scan_occupancy(int DH, int N, int Q, int* blocks, int* smem) {
  if (!shape_ok(1, Q, 1, DH, N, Q)) return int(cudaErrorInvalidValue);
  *smem = int(smem_floats(DH, N, Q) * sizeof(float));
  cudaError_t e;
  if (DH == 32) {
    e = cudaFuncSetAttribute(ssd_kernel<float, 32>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             *smem);
    if (e != cudaSuccess) return int(e);
    return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, ssd_kernel<float, 32>, kThreads, *smem));
  }
  e = cudaFuncSetAttribute(ssd_kernel<float, 64>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (e != cudaSuccess) return int(e);
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, ssd_kernel<float, 64>, kThreads, *smem));
}

}  // extern "C"
