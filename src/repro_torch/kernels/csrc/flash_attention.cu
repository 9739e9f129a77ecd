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
// and moves 134 MB. At an H100 SXM's data-sheet peaks that is 139 us at
// the tensor cores' bf16 rate (989 TFLOP/s) and 40 us of memory; on the
// float32 pipe outside the tensor cores (67 TFLOP/s) the same work needs
// 2 ms, so both types run on the tensor cores: bfloat16 once, float32 as
// three TF32 products (3xTF32), 0.83 ms at the TF32 rate (495 TFLOP/s).
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
// float32: a 3xTF32 tensor-core kernel (namespace tf32x3). One TF32
// product keeps 11 bits of each operand and misses the 1e-5 gate; three
// keep about float32's 21: a = a_hi + a_lo, a_hi rounded to TF32 to
// nearest with ties away (the bits of cvt.rna.tf32.f32, in two integer
// instructions), a_lo = a - a_hi exactly, which the tensor core reads
// truncated to TF32; a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi.
//  * FlashAttention-2's split: one block per (b*h, query tile of BQ rows)
//    with one warp per 16 query rows, so a row's max and sum live in the
//    4 lanes of a quad; the loop over key tiles runs inside the block and
//    the running max, sum and output accumulator stay in registers.
//  * Products on mma.sync.m16n8k8 (tf32). Inside every 8-deep step the
//    depth index is permuted (logical k = t, t + 4 stored at 2t, 2t + 1)
//    in both operands alike, which leaves the sum unchanged: the score
//    accumulator (rows g, g + 8; columns 2t, 2t + 1) is then P's A
//    fragment as it stands, with the value tile's rows taken in the same
//    order, so P never goes through shared memory.
//  * Accumulation: the tensor core truncates what it adds into an
//    accumulator. Q K^T keeps the two small products in an accumulator of
//    their own, added to the hi product's once; each key tile's P V goes
//    into a fresh accumulator and o = o * alpha + that, one rounding a
//    tile. Both into the running o (as a first design did) reached
//    8.8e-6 of the 1e-5 gate at zamba2's shape (the loss grew with the
//    row's 4096 keys); now 1.7-2.0e-6.
//  * The query tile is split once per block, hi and lo interleaved in
//    shared memory so that one 16-byte load gives a row's fragment of
//    both. Key and value tiles arrive by cp.async, each in its own
//    buffer: the next key tile loads while the softmax and P V run, the
//    next value tile while Q K^T runs. Each warp splits the key and value
//    fragments it loads, and P's once a tile.
//  * Rows are padded so fragment loads are free of bank conflicts: Q
//    rows of 2D + 16 floats (16-byte loads), K rows of D + 8 (8-byte
//    loads of a row's pair), V rows of D + 4 (4-byte loads two rows
//    apart).
//  * exp2 with scale * log2(e) folded into the score; masks and window
//    are applied only in the tiles they cut, for each warp's 16 rows.
//  * Tiles: D <= 128 eight warps (BQ = 128) and 64-key tiles, D = 256
//    four warps (BQ = 64) and 32-key tiles, so that the output
//    accumulator (D / 2 registers a thread) fits. One block an SM (the
//    occupancy API on an NVIDIA H100 80GB HBM3, 700 W): 107 KB of shared
//    memory and 231 registers a thread (ptxas, sm_90a) at D = 64, 203 KB
//    and 255 at D = 128, 198 KB at D = 256; no spills.
//  What bounds it: the tensor cores' mma.sync rate. At zamba2's shape
//  (NVIDIA H100 80GB HBM3, 700 W, in a CUDA graph) it takes 3.2-3.3 ms
//  (the first port's SIMT kernel 5.7 ms, SDPA's float32 attention 4.3
//  ms, the bound of three products at the TF32 peak 0.83 ms). Probes of
//  variants (tests/torch_kernel_probe.py): one TF32 product instead of
//  three 1.52 ms, so the two small products cost ~1.8 ms, ~155 TFLOP/s
//  of TF32 work; cvt.rna for the split 4.85 ms; the first design's
//  single accumulators the same time at 8.8e-6 error; four warps a block
//  or 32-key tiles 3-4% slower. wgmma reaches the full TF32 rate, but
//  needs both operands' hi and lo tiles in shared memory, K-major (the
//  value tile transposed).
//  D is a template parameter (32, 64, 96, 128, 256); S and T are
//  multiples of 64; query rows past S (S % BQ == 64) are zero-filled
//  and not stored.
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

namespace tf32x3 {

constexpr float kNegInf = -1.0e30f;

template <int D>
struct Cfg {
  static constexpr int kWarps = D <= 128 ? 8 : 4;  // 16 query rows each
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int BQ = 16 * kWarps;           // query rows per block
  static constexpr int BK = D <= 128 ? 64 : 32;    // keys per tile
  static constexpr int LDQ = 2 * D + 16;           // hi, lo interleaved
  static constexpr int LDK = D + 8;
  static constexpr int LDV = D + 4;
  static constexpr int kSmem = 4 * (BQ * LDQ + BK * LDK + BK * LDV);
};

// v = hi + lo: hi is v rounded to TF32, to nearest with ties away from
// zero (the bits cvt.rna.tf32.f32 gives a finite v, in two integer
// instructions where the cvt takes more), lo = v - hi exactly; the tensor
// core reads the top 19 bits of lo, i.e. truncates it to TF32.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma8(float (&d)[4], const uint32_t (&a)[4],
                                     const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32, the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma8(d, al, bh);
  mma8(d, ah, bl);
  mma8(d, ah, bh);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d =
      static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most the newest group is in flight
__device__ __forceinline__ void cp_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// rows [row0, row0 + ROWS) of a (B, L, heads, D) tensor at (b, head) into
// a tile of row stride LD, by cp.async (16 bytes a copy)
template <int D, int ROWS, int LD, int THREADS>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int b, int L, int heads, int head,
                                          int row0) {
  constexpr int kChunks = D / 4;
  for (int e = threadIdx.x; e < ROWS * kChunks; e += THREADS) {
    const int r = e / kChunks, c = e % kChunks;
    cp_async16(dst + r * LD + 4 * c,
               src + ((int64_t(b) * L + row0 + r) * heads + head) * D + 4 * c);
  }
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
    flash_tf32_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      int S, int T_, int H, int Hk, int causal, int window,
                      float scale_log2) {
  using C = Cfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, LDQ = C::LDQ, LDK = C::LDK,
                LDV = C::LDV, kThreads = C::kThreads;
  constexpr int NT = BK / 8;     // 8-key column tiles of a score tile
  constexpr int ND = D / 8;      // 8-wide steps over the head dim
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                 // BQ x LDQ: split query tile
  float* k_s = q_s + BQ * LDQ;       // BK x LDK
  float* v_s = k_s + BK * LDK;       // BK x LDV

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int qt = gridDim.x - 1 - blockIdx.x;     // heaviest tiles first
  const int q0 = qt * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int hk = h / (H / Hk);

  // the key tiles that some row of [q0, min(q0 + BQ, S)) sees
  const int nk = T_ / BK;
  const int q_last = min(q0 + BQ, S) - 1;
  const int kt_hi = causal ? min(nk, q_last / BK + 1) : nk;
  const int first = q0 - window + 1;   // the oldest key row q0 keeps
  const int kt_lo = (window > 0 && first > 0) ? first / BK : 0;

  if (kt_lo < kt_hi)
    load_tile<D, BK, LDK, kThreads>(k_s, k, b, T_, Hk, hk, kt_lo * BK);
  cp_commit();
  if (kt_lo < kt_hi)
    load_tile<D, BK, LDV, kThreads>(v_s, v, b, T_, Hk, hk, kt_lo * BK);
  cp_commit();

  // the query tile, split once: per 8-wide step of a row, lane t's
  // {hi(2t), hi(2t + 1), lo(2t), lo(2t + 1)} at 16 * step + 4 * t
  for (int e = threadIdx.x; e < BQ * (D / 2); e += kThreads) {
    const int r = e / (D / 2), c = 2 * (e % (D / 2));
    float2 x = make_float2(0.f, 0.f);
    if (q0 + r < S)
      x = *reinterpret_cast<const float2*>(
          q + ((int64_t(b) * S + q0 + r) * H + h) * D + c);
    uint32_t h0, l0, h1, l1;
    split(x.x, h0, l0);
    split(x.y, h1, l1);
    *reinterpret_cast<uint4*>(q_s + r * LDQ + 2 * (c & ~7) + 2 * (c & 7)) =
        make_uint4(h0, h1, l0, l1);
  }

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};   // rows g and g + 8 of this warp
  float l_r[2] = {0.f, 0.f};           // this lane's part of the row sum
  float alpha[2];                      // the rescale of the last max
  const int r0 = 16 * warp;
  const int qpos0 = q0 + r0 + g;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    cp_wait_prior();             // the key tile (and the query tile) landed
    __syncthreads();

    // Q K^T: the hi products and the two small ones in accumulators of
    // their own, added once at the end, so the tensor core's truncation
    // of the small terms' partial sums is relative to their size
    float s[NT][4], sm[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = sm[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < ND; ++ks) {
      const uint4 a0 = *reinterpret_cast<const uint4*>(
          q_s + (r0 + g) * LDQ + 16 * ks + 4 * t);
      const uint4 a1 = *reinterpret_cast<const uint4*>(
          q_s + (r0 + g + 8) * LDQ + 16 * ks + 4 * t);
      const uint32_t ah[4] = {a0.x, a1.x, a0.y, a1.y};
      const uint32_t al[4] = {a0.z, a1.z, a0.w, a1.w};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float2 y = *reinterpret_cast<const float2*>(
            k_s + (8 * n + g) * LDK + 8 * ks + 2 * t);
        uint32_t bh[2], bl[2];
        split(y.x, bh[0], bl[0]);
        split(y.y, bh[1], bl[1]);
        mma8(sm[n], al, bh);
        mma8(sm[n], ah, bl);
        mma8(s[n], ah, bh);
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] += sm[n][e];
    __syncthreads();             // every warp is done with the key tile
    if (kt + 1 < kt_hi)
      load_tile<D, BK, LDK, kThreads>(k_s, k, b, T_, Hk, hk, k0 + BK);
    cp_commit();

    // this warp's rows [qpos0 - g, qpos0 - g + 16) against keys
    // [k0, k0 + BK): does a mask cut this tile?
    const bool cut = (causal && k0 + BK - 1 > qpos0 - g) ||
                     (window > 0 && k0 <= qpos0 - g + 15 - window);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qpos = qpos0 + 8 * i;
      float mx = m_r[i];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float x = s[n][2 * i + j] * scale_log2;
          if (cut) {
            const int kpos = k0 + 8 * n + 2 * t + j;
            const bool ok = (!causal || kpos <= qpos) &&
                            (window <= 0 || kpos > qpos - window);
            x = ok ? x : kNegInf;
          }
          s[n][2 * i + j] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[i] = exp2f(m_r[i] - mx);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float p = exp2f(s[n][2 * i + j] - mx);
          s[n][2 * i + j] = p;
          sum += p;
        }
      l_r[i] = l_r[i] * alpha[i] + sum;
      m_r[i] = mx;
    }

    // P's A fragments, split once: keys 8j + 2t (logical depth t) and
    // 8j + 2t + 1 (t + 4)
    uint32_t ph[NT][4], pl[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      split(s[j][0], ph[j][0], pl[j][0]);
      split(s[j][2], ph[j][1], pl[j][1]);
      split(s[j][1], ph[j][2], pl[j][2]);
      split(s[j][3], ph[j][3], pl[j][3]);
    }
    cp_wait_prior();             // the value tile landed
    __syncthreads();
    // per 8 output columns, this tile's P V into a fresh accumulator, then
    // o = o * alpha + that in one rounding: the tensor core truncates the
    // sums it adds into an accumulator, and over thousands of keys that
    // loss would grow with the row, where here it stays one tile's
    const float* v0 = v_s + 2 * t * LDV + g;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t bh[2], bl[2];
        split(v0[8 * j * LDV + 8 * n], bh[0], bl[0]);
        split(v0[(8 * j + 1) * LDV + 8 * n], bh[1], bl[1]);
        mma3(acc, ph[j], pl[j], bh, bl);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[n][e] = fmaf(o[n][e], alpha[e / 2], acc[e]);
    }
    __syncthreads();             // every warp is done with the value tile
    if (kt + 1 < kt_hi)
      load_tile<D, BK, LDV, kThreads>(v_s, v, b, T_, Hk, hk, k0 + BK);
    cp_commit();
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-30f);
    const int qpos = qpos0 + 8 * i;
    if (qpos >= S) continue;
    float* row = out + ((int64_t(b) * S + qpos) * H + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<float2*>(row + 8 * n) =
          make_float2(o[n][2 * i] / l, o[n][2 * i + 1] / l);
  }
}

template <int D>
int set_smem() {
  static bool done = false;            // once per instantiation
  if (!done) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_tf32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Cfg<D>::kSmem);
    if (e != cudaSuccess) return int(e);
    done = true;
  }
  return 0;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int T_, int H, int Hk, int causal, int window, float scale,
           cudaStream_t stream) {
  using C = Cfg<D>;
  int e = set_smem<D>();
  if (e != 0) return e;
  const int64_t bh = int64_t(B) * H;
  if (bh > 65535) return int(cudaErrorInvalidValue);    // grid.y limit
  // 16-byte copies and 8-byte loads and stores
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
      16)
    return int(cudaErrorInvalidValue);
  dim3 grid((S + C::BQ - 1) / C::BQ, unsigned(bh));
  flash_tf32_kernel<D><<<grid, C::kThreads, C::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, T_, H, Hk,
      causal, window, scale * 1.4426950408889634f);
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
int occupancy(int* blocks, int* smem) {
  int e = set_smem<D>();
  if (e != 0) return e;
  *smem = Cfg<D>::kSmem;
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, flash_tf32_kernel<D>, Cfg<D>::kThreads, Cfg<D>::kSmem));
}

}  // namespace tf32x3

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

// dtype: 0 = float32 (3xTF32 kernel), 1 = bfloat16 (wgmma kernel)
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int B, int S, int T, int H, int Hk, int D, int causal,
                    int window, float scale, int dtype, void* stream) {
  if (S % 64 || T % 64 || S <= 0 || T <= 0 || B <= 0 || Hk <= 0 || H % Hk)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return tf32x3::dispatch(q, k, v, out, B, S, T, H, Hk, D, causal,
                            window, scale, st);
  if (dtype == 1)
    return tc::dispatch(q, k, v, out, B, S, T, H, Hk, D, causal, window,
                        scale, st);
  return int(cudaErrorInvalidValue);
}

// Resident blocks per SM and the dynamic shared memory of one block at
// head dim D (64 or 128): the 3xTF32 kernel for float32 (dtype 0), the
// wgmma kernel for bfloat16 (dtype 1).
int flash_attention_occupancy(int D, int dtype, int* blocks, int* smem) {
  if (D != 64 && D != 128) return int(cudaErrorInvalidValue);
  if (dtype == 1)
    return D == 64 ? tc::occupancy<64>(blocks, smem)
                   : tc::occupancy<128>(blocks, smem);
  return D == 64 ? tf32x3::occupancy<64>(blocks, smem)
                 : tf32x3::occupancy<128>(blocks, smem);
}

}  // extern "C"
