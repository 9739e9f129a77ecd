// Blockwise online-softmax (flash) attention for Hopper (sm_90a).
//
//     out[b, s, h, :] = sum_t softmax_t(scale * q[b, s, h] . k[b, t, hk]
//                                       + mask[s, t]) * v[b, t, hk, :]
//
//     q: (B, S, H, d), k, v: (B, T, Hk, d), out: (B, S, H, d), row-major,
//     all float32 or all bfloat16; hk = h / (H / Hk) (grouped-query
//     attention: H / Hk query heads share one key/value head);
//     mask: t <= s when causal, t > s - window when window > 0.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_flash_kernel
// (pallas_call at flash_attention.py:104). The same arithmetic in both
// instantiations: scores, softmax statistics and the output accumulator
// in float32, masked scores set to the finite -1e30 (so a row whose first
// visited tile is fully masked accumulates terms that the next tile's
// rescale multiplies by an exact 0, never exp(-inf + inf)), key tiles
// that the causal or window mask removes entirely skipped, and one
// normalised store, out = acc / max(l, 1e-30).
//
// What bounds it: operations. At zamba2-1.2b's prefill (B*H = 64,
// S = T = 4096, d = 64, causal) the call does 4*B*H*S*S*d/2 = 137 GFLOP
// and moves 134 MB: 139 us at the tensor cores' bf16 peak (989 TFLOP/s),
// 40 us of memory. On the float32 pipe outside the tensor cores (67
// TFLOP/s) the same work needs 2 ms, so bfloat16 runs on the tensor cores.
//
// bfloat16: a warp-specialised wgmma kernel (namespace tc).
//  * One block of 384 threads per (b*h, 128-row query tile): two consumer
//    warpgroups of 64 query rows each and one producer warpgroup, which
//    gives its registers to the consumers (setmaxnreg: 24 and 240 a
//    thread). Query tiles are issued last-first over the slowest grid
//    axis, so under a causal mask the longest rows of every head start in
//    the first wave.
//  * One thread of the producer loads the query tile once and then the
//    key and value tiles by TMA (cp.async.bulk.tensor, rank-4 maps of the
//    (B, L, heads, d) layout built on the host per call and passed as
//    __grid_constant__ parameters, so a CUDA graph captures them by
//    value) into a 2-stage ring, each tile completing on its own
//    mbarrier; the consumers free a stage on a third mbarrier. Tiles are
//    64 columns of 128 bytes in the 128-byte swizzle that wgmma reads.
//  * S = Q K^T: wgmma m64nBKk16, A and B from shared memory (both
//    K-major), f32 accumulators in registers. The mask, the running max
//    and sum stay in registers; a row's max is reduced over the 4 lanes
//    that hold it; exp2 takes scale * log2(e) inside its argument (one
//    FMA and ex2.approx a score).
//  * O += P V: wgmma m64nDPk16 with A = P from registers (the score
//    accumulator's layout is the A fragment's) and B = the value tile,
//    which is (keys, d) with d contiguous: the transposed ("MN-major")
//    operand. P is split in two, P_hi = bf16(P) and P_lo = bf16(P - P_hi),
//    and both go through the tensor cores into the same f32 accumulator:
//    rounding P once to bf16 (2^-9 relative per term) breaks the
//    elementwise bf16 gate (2^-7 |want| + 1e-5) where an output cancels
//    to near zero; the split carries P to about 2^-17 for 1.5x the
//    tensor-core work of a plain bf16 flash kernel. l sums the f32 P.
//  * Head dims: any d % 8 == 0 up to 256. The shared-memory tiles are DP
//    = 64 * ceil(d / 64) wide; TMA fills the columns beyond d with zeros,
//    which change neither Q K^T nor the kept columns of P V. S and T are
//    multiples of 64; a query tile or key tile that runs past S or T is
//    zero-filled by TMA, its rows not stored, its keys masked.
//  * Key tile BK = 128 for DP <= 128 and 64 above, so that the
//    accumulators (S: BK / 2, O: DP / 2, P_hi and P_lo: BK / 4 registers
//    each a thread) fit a consumer's 240 registers without spilling.
//  * The softmax and the products of one warpgroup do not overlap; the
//    two warpgroups of a block overlap each other's.
//  Shared memory: Q 128 x DP, 2 x (K, V) BK x DP bf16, plus 1 KB to align
//  the ring to the swizzle's 1024-byte period: 81 KB at d = 64, 161 KB
//  at d = 128, 193 KB at d = 256; one block per SM.
//
// float32: the first port's SIMT kernel (namespace simt), kept for the
// gated f32 prefills, whose 1e-5 kernel gate TF32 tensor cores would not
// hold:
//  * one block of 128 threads per (b*h, 64-row query tile); the loop over
//    key tiles runs inside the block and the running max, sum and float32
//    accumulator stay in registers for the whole loop;
//  * the query tile and one 64-row key tile, then the value tile in the
//    same buffer, are staged in shared memory as float32 with rows padded
//    to D + 1 floats, so the strided reads below are free of bank
//    conflicts; the 64 x 64 probability tile goes through shared memory
//    between the two products (12 shared loads per 32 FMAs: it is bound
//    by shared-memory loads, near a third of the f32 pipe);
//  * thread (ty, tx) = (tid / 8, tid % 8) owns query rows 4*ty .. 4*ty+3,
//    key columns tx + 8*j (j < 8) of each score tile and output columns
//    tx + 8*m (m < D / 8); the row max and row sum are reduced over the
//    8 lanes of a row with warp shuffles;
//  * dynamic shared memory: (2 * 64 * (D + 1) + 64 * 65) floats, 49.9 KB
//    at D = 64, 82.7 KB at D = 128, 148 KB at D = 256.
//  D is a template parameter (32, 64, 96, 128, 256).
//
// Both kernels raise their dynamic shared-memory limit with
// cudaFuncSetAttribute before their first launch.
//
// C interface (bound with ctypes): every pointer and the stream is a
// void*; the launch runs on the caller's stream, does not synchronize and
// allocates nothing. The return value is cudaGetLastError() after the
// launch (0 = launched), or cudaErrorInvalidValue for a shape the kernel
// does not take (the wrapper checks first and raises).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace simt {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // key rows per tile
constexpr int kThreads = 128;
constexpr int kTM = 4;           // query rows per thread
constexpr int kTN = 8;           // key columns per thread (stride 8)
constexpr int kLP = kBK + 1;     // padded row of the probability tile
constexpr float kNegInf = -1.0e30f;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(kBQ + kBK) * (D + 1) + size_t(kBQ) * kLP);
}

// rows [row0, row0 + 64) of a (B, L, heads, D) tensor at (b, head) into a
// padded float32 tile
template <int D>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src, int b,
                                          int L, int heads, int head,
                                          int row0) {
  constexpr int LD = D + 1;
  for (int e = threadIdx.x; e < kBK * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int64_t off =
        ((int64_t(b) * L + row0 + r) * heads + head) * D + c;
    dst[r * LD + c] = src[off];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int S,
                 int T_, int H, int Hk, int causal, int window, float scale) {
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

  load_tile<D>(q_s, q, b, S, H, h, q0);

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
    load_tile<D>(kv_s, k, b, T_, Hk, hk, k0);
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
    load_tile<D>(kv_s, v, b, T_, Hk, hk, k0);
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
      out[row + tx + kTN * m] = acc[i][m] / l;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int T_, int H, int Hk, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  static bool attr_set = false;          // once per instantiation
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (e != cudaSuccess) return int(e);
    attr_set = true;
  }
  const int64_t bh = int64_t(B) * H;
  if (bh > 65535) return int(cudaErrorInvalidValue);    // grid.y limit
  dim3 grid(S / kBQ, unsigned(bh));
  flash_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, T_, H, Hk,
      causal, window, scale);
  return int(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int S, int T_, int H, int Hk, int D, int causal, int window,
             float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<32>(q, k, v, out, B, S, T_, H, Hk, causal, window,
                        scale, stream);
    case 64:
      return launch<64>(q, k, v, out, B, S, T_, H, Hk, causal, window,
                        scale, stream);
    case 96:
      return launch<96>(q, k, v, out, B, S, T_, H, Hk, causal, window,
                        scale, stream);
    case 128:
      return launch<128>(q, k, v, out, B, S, T_, H, Hk, causal, window,
                         scale, stream);
    case 256:
      return launch<256>(q, k, v, out, B, S, T_, H, Hk, causal, window,
                         scale, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

template <int D>
int occupancy(int* blocks) {
  const size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (e != cudaSuccess) return int(e);
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, flash_kernel<D>, kThreads, smem));
}

}  // namespace simt

namespace tc {

constexpr int kBQ = 128;             // query rows per block
constexpr int kConsumers = 2;        // warpgroups of 64 query rows
constexpr int kThreads = 128 * (kConsumers + 1);  // + a producer warpgroup
constexpr int kProducerRegs = 24;    // setmaxnreg: 24 * 128 + 240 * 256
constexpr int kConsumerRegs = 240;   // registers of the 65,536 an SM has
constexpr int kStages = 2;            // the key/value ring
constexpr int kBox = 64;             // TMA box: 64 columns x 64 rows
constexpr int kBoxBytes = kBox * kBox * 2;
constexpr float kNegInf = -1.0e30f;

template <int DP>
struct Cfg {
  static constexpr int BK = DP <= 128 ? 128 : 64;   // keys per tile
  static constexpr int kQBytes = kBQ * DP * 2;
  static constexpr int kTileBytes = BK * DP * 2;     // one K or V tile
  static constexpr int kSmem = kQBytes + kStages * 2 * kTileBytes + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one 64 x 64 box of a rank-4 (d, heads, L, B) map into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving reads of an accumulator above the wait
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D(64 x 64) (+)= A(64 x 16, shared, K-major) * B(64 x 16, shared,
// K-major)^T; scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64 x 128) (+)= A(64 x 16, shared, K-major) * B(128 x 16, shared,
// K-major)^T; scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64 x 64) += A(64 x 16, registers) * B(16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 128) += A(64 x 16, registers) * B(16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 192) += A(64 x 16, registers) * B(16 x 192, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 256) += A(64 x 16, registers) * B(16 x 256, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int BK>
__device__ __forceinline__ void qk(float (&s)[BK / 2], uint64_t da,
                                   uint64_t db, int scale_d) {
  if constexpr (BK == 64) wgmma_ss_n64(s, da, db, scale_d);
  else wgmma_ss_n128(s, da, db, scale_d);
}

template <int DP>
__device__ __forceinline__ void pv(float (&o)[DP / 2],
                                   const uint32_t (&a)[4], uint64_t db) {
  if constexpr (DP == 64) wgmma_rs_n64(o, a, db);
  else if constexpr (DP == 128) wgmma_rs_n128(o, a, db);
  else if constexpr (DP == 192) wgmma_rs_n192(o, a, db);
  else wgmma_rs_n256(o, a, db);
}

// two bf16 values as one register of an A fragment, the lower column first
__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Shared-memory addresses of one block: the query tile, the key and value
// rings, and the barriers (query full; per stage key full, value full,
// empty)
struct Ring {
  uint32_t q, k, v, bar;
  __device__ uint32_t bar_q() const { return bar; }
  __device__ uint32_t bar_k(int s) const { return bar + 8 * (1 + s); }
  __device__ uint32_t bar_v(int s) const {
    return bar + 8 * (1 + kStages + s);
  }
  __device__ uint32_t bar_e(int s) const {
    return bar + 8 * (1 + 2 * kStages + s);
  }
};

// What one block computes: query rows q0 .. q0 + 127 of head h of batch
// b against key tiles kt_begin .. kt_begin + ntiles - 1
struct Work {
  int b, h, hk, q0, kt_begin, ntiles;
  int S, T, H, d, causal, window;
  float scale_log2;
};

template <int DP>
__device__ __forceinline__ void produce(const Ring& ring, const Work& w,
                                        const CUtensorMap* tq,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv) {
  using C = Cfg<DP>;
  constexpr int BK = C::BK, KC = DP / 64;
  mbar_expect_tx(ring.bar_q(), C::kQBytes);
  for (int c = 0; c < KC; ++c)
    for (int r = 0; r < kBQ / kBox; ++r)
      tma_load(ring.q + c * kBQ * 128 + r * kBoxBytes, tq, ring.bar_q(),
               c * 64, w.h, w.q0 + r * kBox, w.b);
  for (int i = 0; i < w.ntiles; ++i) {
    const int s = i % kStages, n = i / kStages;
    const int k0 = (w.kt_begin + i) * BK;
    if (i >= kStages) mbar_wait(ring.bar_e(s), (n - 1) & 1);
    mbar_expect_tx(ring.bar_k(s), C::kTileBytes);
    for (int c = 0; c < KC; ++c)
      for (int r = 0; r < BK / kBox; ++r)
        tma_load(ring.k + s * C::kTileBytes + c * BK * 128 + r * kBoxBytes,
                 tk, ring.bar_k(s), c * 64, w.hk, k0 + r * kBox, w.b);
    mbar_expect_tx(ring.bar_v(s), C::kTileBytes);
    for (int c = 0; c < KC; ++c)
      for (int r = 0; r < BK / kBox; ++r)
        tma_load(ring.v + s * C::kTileBytes + c * BK * 128 + r * kBoxBytes,
                 tv, ring.bar_v(s), c * 64, w.hk, k0 + r * kBox, w.b);
  }
}

template <int DP>
__device__ __forceinline__ void consume(const Ring& ring, const Work& w,
                                        __nv_bfloat16* __restrict__ out,
                                        int warp, int lane) {
  using C = Cfg<DP>;
  constexpr int BK = C::BK;
  const int S = w.S, T_ = w.T, causal = w.causal, window = w.window;
  const float scale_log2 = w.scale_log2;
  // warpgroup g owns query rows w_lo .. w_lo + 63; this thread holds rows
  // r0 and r0 + 8 of them, columns 8 j + 2 (lane % 4) + {0, 1} of every
  // accumulator (the wgmma D fragment)
  const int g = warp / 4;
  const int w_lo = w.q0 + 64 * g, w_hi = w_lo + 63;
  const int r0 = w_lo + 16 * (warp % 4) + lane / 4, r1 = r0 + 8;
  const int cq = 2 * (lane % 4);
  const bool valid = w_lo < S;

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  mbar_wait(ring.bar_q(), 0);
  for (int i = 0; i < w.ntiles; ++i) {
    const int s = i % kStages, n = i / kStages;
    const int k0 = (w.kt_begin + i) * BK;
    // a tile that masks every row of this warpgroup is waited for and
    // freed, not computed
    const bool skip = !valid || (causal && k0 > w_hi) ||
                      (window > 0 && k0 + BK - 1 <= w_lo - window);
    mbar_wait(ring.bar_k(s), n & 1);
    uint32_t phi[BK / 16][4], plo[BK / 16][4];
    float a0 = 1.f, a1 = 1.f;
    if (!skip) {
      float sc[BK / 2];
      wgmma_fence();
      // k-step kk: 16 columns at 32 bytes into 64-column chunk kk / 4;
      // K-major, 8-row groups 1024 bytes apart
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        qk<BK>(sc,
               desc(ring.q + (kk / 4) * kBQ * 128 + g * 64 * 128 +
                        (kk % 4) * 32,
                    16, 1024),
               desc(ring.k + s * C::kTileBytes + (kk / 4) * BK * 128 +
                        (kk % 4) * 32,
                    16, 1024),
               kk > 0);
      wgmma_commit();
      wgmma_wait();
      pin(sc);

      // a tile with a masked entry for some row of this warpgroup
      const bool masked = (causal && k0 + BK - 1 > w_lo) ||
                          (window > 0 && k0 <= w_hi - window) ||
                          (k0 + BK > T_);
      // the running max in the scaled domain; unmasked scores stay raw
      // and are scaled inside exp2's argument: scale > 0, so the max of
      // the scaled scores is the scaled max, to the bit
      float mx0 = kNegInf, mx1 = kNegInf;
      if (masked) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = k0 + 8 * j + cq + e;
            bool ok0 = col < T_, ok1 = col < T_;
            if (causal) {
              ok0 = ok0 && col <= r0;
              ok1 = ok1 && col <= r1;
            }
            if (window > 0) {
              ok0 = ok0 && col > r0 - window;
              ok1 = ok1 && col > r1 - window;
            }
            sc[4 * j + e] = ok0 ? sc[4 * j + e] * scale_log2 : kNegInf;
            sc[4 * j + 2 + e] = ok1 ? sc[4 * j + 2 + e] * scale_log2
                                    : kNegInf;
            mx0 = fmaxf(mx0, sc[4 * j + e]);
            mx1 = fmaxf(mx1, sc[4 * j + 2 + e]);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
          mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
        }
        mx0 *= scale_log2;
        mx1 *= scale_log2;
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      mx0 = fmaxf(m0, mx0);
      mx1 = fmaxf(m1, mx1);
      a0 = ex2(m0 - mx0);
      a1 = ex2(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      // exp2(x * c - m): x scaled already (c = 1) on a masked tile
      const float c = masked ? 1.f : scale_log2;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const float p00 = ex2(fmaf(sc[4 * j + 0], c, -mx0));
        const float p01 = ex2(fmaf(sc[4 * j + 1], c, -mx0));
        const float p10 = ex2(fmaf(sc[4 * j + 2], c, -mx1));
        const float p11 = ex2(fmaf(sc[4 * j + 3], c, -mx1));
        sum0 += p00 + p01;
        sum1 += p10 + p11;
        // A fragment of k-step j / 2: rows r0, r1 of columns
        // 16 (j / 2) + 8 (j % 2) + cq + {0, 1}; P = P_hi + P_lo
        const int kk = j / 2, hi = (j % 2) * 2;
        const __nv_bfloat162 h0 = __floats2bfloat162_rn(p00, p01);
        const __nv_bfloat162 h1 = __floats2bfloat162_rn(p10, p11);
        const float2 f0 = __bfloat1622float2(h0);
        const float2 f1 = __bfloat1622float2(h1);
        phi[kk][hi] = as_u32(h0);
        phi[kk][hi + 1] = as_u32(h1);
        plo[kk][hi] = as_u32(__floats2bfloat162_rn(p00 - f0.x, p01 - f0.y));
        plo[kk][hi + 1] =
            as_u32(__floats2bfloat162_rn(p10 - f1.x, p11 - f1.y));
      }
      l0 = l0 * a0 + sum0;
      l1 = l1 * a1 + sum1;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        o[4 * j + 0] *= a0;
        o[4 * j + 1] *= a0;
        o[4 * j + 2] *= a1;
        o[4 * j + 3] *= a1;
      }
    }
    mbar_wait(ring.bar_v(s), n & 1);
    if (!skip) {
      // k-step kk: keys 16 kk .. 16 kk + 15, 2048 bytes apart; MN-major,
      // 64-column chunks BK * 128 bytes apart (LBO), 8-key groups 1024
      // (SBO)
      const uint32_t vs = ring.v + s * C::kTileBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        pv<DP>(o, phi[kk], desc(vs + kk * 16 * 128, BK * 128, 1024));
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        pv<DP>(o, plo[kk], desc(vs + kk * 16 * 128, BK * 128, 1024));
      wgmma_commit();
      wgmma_wait();
      pin(o);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.bar_e(s));
  }
  if (!valid) return;            // rows past S (S % 128 == 64)

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* row0 = out + ((int64_t(w.b) * S + r0) * w.H + w.h) * w.d;
  __nv_bfloat16* row1 = out + ((int64_t(w.b) * S + r1) * w.H + w.h) * w.d;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = 8 * j + cq;
    if (col < w.d) {
      *reinterpret_cast<__nv_bfloat162*>(row0 + col) =
          __floats2bfloat162_rn(o[4 * j] / l0, o[4 * j + 1] / l0);
      *reinterpret_cast<__nv_bfloat162*>(row1 + col) =
          __floats2bfloat162_rn(o[4 * j + 2] / l1, o[4 * j + 3] / l1);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    __nv_bfloat16* __restrict__ out, int S, int T_, int H,
                    int Hk, int d, int causal, int window, float scale_log2) {
  constexpr int BK = Cfg<DP>::BK;
  __shared__ __align__(8) uint64_t bars[1 + 3 * kStages];
  extern __shared__ uint8_t smem_raw[];
  Ring ring;
  ring.q = (smem_u32(smem_raw) + 1023u) & ~1023u;   // the swizzle's period
  ring.k = ring.q + Cfg<DP>::kQBytes;                // stage s at + s * tile
  ring.v = ring.k + kStages * Cfg<DP>::kTileBytes;
  ring.bar = smem_u32(bars);

  Work w;
  w.b = blockIdx.x / H;
  w.h = blockIdx.x % H;
  w.hk = w.h / (H / Hk);
  w.q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;         // heaviest first
  w.S = S, w.T = T_, w.H = H, w.d = d;
  w.causal = causal, w.window = window, w.scale_log2 = scale_log2;
  const int q_hi = min(w.q0 + kBQ - 1, S - 1);
  const int nk = (T_ + BK - 1) / BK;
  const int kt_end = causal ? min(nk, q_hi / BK + 1) : nk;
  w.kt_begin = 0;
  if (window > 0 && w.q0 - window + 1 > 0)
    w.kt_begin = (w.q0 - window + 1) / BK;
  w.ntiles = max(0, kt_end - w.kt_begin);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(ring.bar_q(), 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(ring.bar_k(s), 1);
      mbar_init(ring.bar_v(s), 1);
      mbar_init(ring.bar_e(s), 4 * kConsumers);   // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // one branch per role, never rejoined, so that setmaxnreg holds
  if (warp >= 4 * kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == 4 * kConsumers && lane == 0)
      produce<DP>(ring, w, &tq, &tk, &tv);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    consume<DP>(ring, w, out, warp, lane);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function: reached through the
// runtime's entry-point query, so the library links nothing beyond cudart
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// rank-4 map (d, heads, L, B) of a contiguous (B, L, heads, d) bf16 tensor,
// 64 x 64 boxes in the 128-byte swizzle; out-of-bounds reads fill zeros
bool make_map(CUtensorMap* map, const void* ptr, int B, int L, int heads,
              int d) {
  EncodeTiled encode = encode_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(d), cuuint64_t(heads), cuuint64_t(L),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(d) * 2,
                                 cuuint64_t(heads) * d * 2,
                                 cuuint64_t(L) * heads * d * 2};
  const cuuint32_t box[4] = {kBox, 1, kBox, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
int set_smem() {
  static bool done = false;            // once per instantiation
  if (!done) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_tc_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Cfg<DP>::kSmem);
    if (e != cudaSuccess) return int(e);
    done = true;
  }
  return 0;
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int T_, int H, int Hk, int d, int causal, int window,
           float scale, cudaStream_t stream) {
  int e = set_smem<DP>();
  if (e != 0) return e;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, S, H, d) || !make_map(&tk, k, B, T_, Hk, d) ||
      !make_map(&tv, v, B, T_, Hk, d))
    return int(cudaErrorInvalidValue);
  dim3 grid(unsigned(B * H), unsigned((S + kBQ - 1) / kBQ));
  flash_tc_kernel<DP><<<grid, kThreads, Cfg<DP>::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), S, T_, H, Hk, d, causal,
      window, scale * 1.4426950408889634f);
  return int(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int S, int T_, int H, int Hk, int d, int causal, int window,
             float scale, cudaStream_t stream) {
  // grid.x = B * H, grid.y = the 128-row query tiles
  if (d < 8 || d % 8 || d > 256 || int64_t(B) * H > 0x7fffffff ||
      (S + kBQ - 1) / kBQ > 65535)
    return int(cudaErrorInvalidValue);
  const int dp = (d + 63) / 64 * 64;
  switch (dp) {
    case 64:
      return launch<64>(q, k, v, out, B, S, T_, H, Hk, d, causal, window,
                        scale, stream);
    case 128:
      return launch<128>(q, k, v, out, B, S, T_, H, Hk, d, causal, window,
                         scale, stream);
    case 192:
      return launch<192>(q, k, v, out, B, S, T_, H, Hk, d, causal, window,
                         scale, stream);
    default:
      return launch<256>(q, k, v, out, B, S, T_, H, Hk, d, causal, window,
                         scale, stream);
  }
}

template <int DP>
int occupancy(int* blocks, int* smem) {
  int e = set_smem<DP>();
  if (e != 0) return e;
  *smem = Cfg<DP>::kSmem;
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, flash_tc_kernel<DP>, kThreads, Cfg<DP>::kSmem));
}

}  // namespace tc

extern "C" {

// dtype: 0 = float32 (SIMT kernel), 1 = bfloat16 (tensor-core kernel)
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int B, int S, int T, int H, int Hk, int D, int causal,
                    int window, float scale, int dtype, void* stream) {
  if (S % 64 || T % 64 || S <= 0 || T <= 0 || B <= 0 || Hk <= 0 || H % Hk)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return simt::dispatch(q, k, v, out, B, S, T, H, Hk, D, causal, window,
                          scale, st);
  if (dtype == 1)
    return tc::dispatch(q, k, v, out, B, S, T, H, Hk, D, causal, window,
                        scale, st);
  return int(cudaErrorInvalidValue);
}

// Resident blocks per SM and the dynamic shared memory of one block at
// head dim D (64 or 128): the SIMT kernel for float32 (dtype 0), the
// tensor-core kernel for bfloat16 (dtype 1).
int flash_attention_occupancy(int D, int dtype, int* blocks, int* smem) {
  if (D != 64 && D != 128) return int(cudaErrorInvalidValue);
  if (dtype == 1)
    return D == 64 ? tc::occupancy<64>(blocks, smem)
                   : tc::occupancy<128>(blocks, smem);
  *smem = int(D == 64 ? simt::smem_bytes<64>() : simt::smem_bytes<128>());
  return D == 64 ? simt::occupancy<64>(blocks)
                 : simt::occupancy<128>(blocks);
}

}  // extern "C"
