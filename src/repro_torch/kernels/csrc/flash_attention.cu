// Blockwise online-softmax (flash) attention for Hopper (sm_90a).
//
//     out[b, s, h, :] = sum_t softmax_t(scale * q[b, s, h] . k[b, t, hk]
//                                       + mask[s, t]) * v[b, t, hk, :]
//
//     q: (B, S, H, D), k, v: (B, T, Hk, D), out: (B, S, H, D), row-major,
//     all float32 or all bfloat16; hk = h / (H / Hk) (grouped-query
//     attention: H / Hk query heads share one key/value head);
//     mask: t <= s when causal, t > s - window when window > 0.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_flash_kernel
// (pallas_call at flash_attention.py:104). The same arithmetic: scores,
// softmax statistics and the output accumulator in float32, masked
// scores set to the finite -1e30 (so a row whose first visited tile is
// fully masked accumulates terms that the next tile's rescale
// exp(m_prev - m_cur) multiplies by an exact 0, never exp(-inf + inf)),
// key tiles that the causal or window mask removes entirely skipped, and
// one normalised store, out = acc / max(l, 1e-30).
//
// What bounds it: operations. At zamba2-1.2b's prefill (B*H = 64,
// S = T = 4096, D = 64, causal) the call does 4*B*H*S*S*D/2 = 137 GFLOP
// and moves 134 MB: 139 us at the tensor cores' bf16 peak, 40 us of
// memory. This first kernel multiplies with plain float32 fused
// multiply-adds (no tensor cores), whose peak of 67 TFLOP/s puts its
// floor near 2 ms; mma.sync / wgmma tiles with TMA loads are later work.
//
// Design (not the TPU structure, which ran a (BH, n_q, n_k) grid in
// order with the (max, sum, acc) state in VMEM scratch across k steps):
//  * one block of 128 threads per (b*h, 64-row query tile); the loop over
//    key tiles runs inside the block and the running max, sum and float32
//    accumulator stay in registers for the whole loop;
//  * the query tile and one 64-row key tile, then the value tile in the
//    same buffer, are staged in shared memory as float32 with rows padded
//    to D + 1 floats, so the strided reads below are free of bank
//    conflicts; the 64 x 64 probability tile goes through shared memory
//    between the two products;
//  * thread (ty, tx) = (tid / 8, tid % 8) owns query rows 4*ty .. 4*ty+3,
//    key columns tx + 8*j (j < 8) of each score tile and output columns
//    tx + 8*m (m < D / 8); the row max and row sum are reduced over the
//    8 lanes of a row with warp shuffles;
//  * query tiles are issued last-first, so under a causal mask the
//    longest rows start first;
//  * dynamic shared memory: (2 * 64 * (D + 1) + 64 * 65) floats, 49.9 KB
//    at D = 64, 82.7 KB at D = 128, 148 KB at D = 256; the kernel raises
//    its limit with cudaFuncSetAttribute before the first launch.
// D is a template parameter (32, 64, 96, 128, 256); S and T must be
// multiples of 64 (the wrapper checks and raises).
//
// C interface (bound with ctypes): every pointer and the stream is a
// void*; the launch runs on the caller's stream, does not synchronize and
// allocates nothing. The return value is cudaGetLastError() after the
// launch (0 = launched), or cudaErrorInvalidValue for a head dim or a
// grid the kernel does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // key rows per tile
constexpr int kThreads = 128;
constexpr int kTM = 4;           // query rows per thread
constexpr int kTN = 8;           // key columns per thread (stride 8)
constexpr int kLP = kBK + 1;     // padded row of the probability tile
constexpr float kNegInf = -1.0e30f;

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

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(kBQ + kBK) * (D + 1) + size_t(kBQ) * kLP);
}

// rows [row0, row0 + 64) of a (B, L, heads, D) tensor at (b, head) into a
// padded float32 tile
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int b, int L, int heads, int head,
                                          int row0) {
  constexpr int LD = D + 1;
  for (int e = threadIdx.x; e < kBK * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int64_t off =
        ((int64_t(b) * L + row0 + r) * heads + head) * D + c;
    dst[r * LD + c] = to_f32(src[off]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int S, int T_,
                 int H, int Hk, int causal, int window, float scale) {
  constexpr int LD = D + 1;
  constexpr int kTD = D / 8;     // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                 // kBQ x LD
  float* kv_s = q_s + kBQ * LD;      // kBK x LD: the key tile, then values
  float* p_s = kv_s + kBK * LD;      // kBQ x kLP

  const int tid = threadIdx.x;
  const int tx = tid % kTN, ty = tid / kTN;
  const int qt = gridDim.x - 1 - blockIdx.x;     // heaviest tiles first
  const int q0 = qt * kBQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int hk = h / (H / Hk);

  load_tile<T, D>(q_s, q, b, S, H, h, q0);

  float acc[kTM][kTD];
  float m_i[kTM], l_i[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int m = 0; m < kTD; ++m) acc[i][m] = 0.f;
  }

  const int nk = T_ / kBK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    if (causal && k0 > q0 + kBQ - 1) break;      // above the diagonal
    if (window > 0 && k0 + kBK - 1 <= q0 - window) continue;  // out of window
    __syncthreads();             // the last tile's P.V is done with kv_s, p_s
    load_tile<T, D>(kv_s, k, b, T_, Hk, hk, k0);
    __syncthreads();

    float s[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qv[kTM], kv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) qv[i] = q_s[(ty * kTM + i) * LD + c];
#pragma unroll
      for (int j = 0; j < kTN; ++j) kv[j] = kv_s[(tx + kTN * j) * LD + c];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int qpos = q0 + ty * kTM + i;
      float mx = m_i[i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int kpos = k0 + tx + kTN * j;
        bool ok = true;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        const float sv = ok ? s[i][j] * scale : kNegInf;
        s[i][j] = sv;
        mx = fmaxf(mx, sv);
      }
#pragma unroll
      for (int off = kTN / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float alpha = expf(m_i[i] - mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const float p = expf(s[i][j] - mx);
        s[i][j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = kTN / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_i[i] = l_i[i] * alpha + sum;
      m_i[i] = mx;
#pragma unroll
      for (int m = 0; m < kTD; ++m) acc[i][m] *= alpha;
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        p_s[(ty * kTM + i) * kLP + tx + kTN * j] = s[i][j];
    }

    __syncthreads();             // every thread is done with the key tile
    load_tile<T, D>(kv_s, v, b, T_, Hk, hk, k0);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i) pv[i] = p_s[(ty * kTM + i) * kLP + j];
#pragma unroll
      for (int m = 0; m < kTD; ++m) {
        const float vv = kv_s[j * LD + tx + kTN * m];
#pragma unroll
        for (int i = 0; i < kTM; ++i) acc[i][m] = fmaf(pv[i], vv, acc[i][m]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const float l = fmaxf(l_i[i], 1e-30f);
    const int64_t row =
        ((int64_t(b) * S + q0 + ty * kTM + i) * H + h) * D;
#pragma unroll
    for (int m = 0; m < kTD; ++m)
      out[row + tx + kTN * m] = from_f32<T>(acc[i][m] / l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int T_, int H, int Hk, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  static bool attr_set = false;          // once per instantiation
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (e != cudaSuccess) return int(e);
    attr_set = true;
  }
  const int64_t bh = int64_t(B) * H;
  if (bh > 65535) return int(cudaErrorInvalidValue);    // grid.y limit
  dim3 grid(S / kBQ, unsigned(bh));
  flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, T_, H, Hk, causal,
      window, scale);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int S, int T_, int H, int Hk, int D, int causal, int window,
             float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, out, B, S, T_, H, Hk, causal, window,
                           scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, B, S, T_, H, Hk, causal, window,
                           scale, stream);
    case 96:
      return launch<T, 96>(q, k, v, out, B, S, T_, H, Hk, causal, window,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, B, S, T_, H, Hk, causal, window,
                            scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, out, B, S, T_, H, Hk, causal, window,
                            scale, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

template <typename T, int D>
int occupancy(int* blocks) {
  const size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (e != cudaSuccess) return int(e);
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, flash_kernel<T, D>, kThreads, smem));
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int B, int S, int T, int H, int Hk, int D, int causal,
                    int window, float scale, int dtype, void* stream) {
  if (S % kBQ || T % kBK || S <= 0 || T <= 0 || Hk <= 0 || H % Hk)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, B, S, T, H, Hk, D, causal, window,
                           scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, S, T, H, Hk, D, causal,
                                   window, scale, st);
  return int(cudaErrorInvalidValue);
}

// Resident blocks per SM at head dim D (64 or 128), float32 or bfloat16,
// and the dynamic shared memory of one block.
int flash_attention_occupancy(int D, int dtype, int* blocks, int* smem) {
  if (D == 64) *smem = int(smem_bytes<64>());
  else if (D == 128) *smem = int(smem_bytes<128>());
  else return int(cudaErrorInvalidValue);
  if (dtype == 0)
    return D == 64 ? occupancy<float, 64>(blocks)
                   : occupancy<float, 128>(blocks);
  return D == 64 ? occupancy<__nv_bfloat16, 64>(blocks)
                 : occupancy<__nv_bfloat16, 128>(blocks);
}

}  // extern "C"
