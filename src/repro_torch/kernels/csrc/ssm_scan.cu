// Chunked Mamba2 / SSD scan for Hopper (sm_90a).
//
//     h_t = exp(a_t) * h_{t-1} + dt_t * x_t B_t^T,   y_t = h_t C_t
//
//     x, y: (B, S, H, DH); a (log-decay), dt: (B, S, H) float32;
//     Bm, Cm: (B, S, N), shared by the H heads; h: (DH, N) per (b, h).
//     x, Bm, Cm and y are all float32 or all bfloat16.
//
// Replaces the TPU kernel repro/kernels/ssm_scan.py::_ssd_kernel
// (pallas_call at ssm_scan.py:84). Per chunk of Q rows, with
// cs = cumsum(a) inside the chunk and u = exp(cs_last - cs) * dt:
//     W = (C B^T) o exp(cs_i - cs_j) [i >= j] o dt_j          (Q x Q)
//     y = W x + exp(cs) o (C h_in^T)                           (Q x DH)
//     h_in[next chunk] = exp(cs_last) h_in + (x o u)^T B       (DH x N)
//
// What bounds it: memory. At zamba2-1.2b's prefill (B = 2, S = 4096,
// H = 64, DH = 64, N = 64, Q = 128) the function moves ~140 MB (x and y in
// bfloat16 are 67 MB each): 42 us at 3.35 TB/s; the ~13 GFLOP it needs
// take 13 us at the bf16 tensor cores' peak. The TPU kernel walks the
// chunks in order on one core, carrying the state in VMEM; the first port
// did the same in one block per (b, h) (128 blocks, 8 warps an SM, SIMT
// float32 products, C B^T recomputed per head): 1.95 ms. This design is
// the SSD decomposition of Mamba2's GPU kernels, three passes on the
// caller's stream:
//
//  1. ssd_chunk_state, one block per (b, chunk, h): the chunk's own state
//     S_c = (x o u)^T B (DH x N) into float32 scratch (B, H, nc, DH, N),
//     and exp(cs_last) into (B, H, nc);
//  2. ssd_state_pass, one thread per 4 of the B*H*DH*N state lanes, in
//     order over the chunks only: h_in[0] = 0,
//     h_in[c + 1] = exp(cs_last[c]) h_in[c] + S_c, summed in float32 and
//     stored in x's type (float32 in place over the scratch; bfloat16
//     into a buffer of its own, as pass 3 would round it; each thread
//     loads 8 chunks ahead of its chain);
//  3. ssd_chunk_scan, one block per (b, chunk, h): y from C, B, x and
//     h_in, stored in x's type.
// At zamba2's shape passes 1 and 3 run 4096 blocks of 4 warps each
// (the first port: 128 blocks), 6 and 3 resident an SM in bfloat16. The
// scratch's 67 MB are written once and read once, and h_in's 34 MB
// (bfloat16) written once and read once: ~200 MB of the ~330 MB the
// passes move. No atomics: every output
// is one fixed sequence of operations, so a call repeats bit for bit.
//
// Products: warp-level tensor-core MMAs (mma.sync, 16 x 8 output tiles).
//  * bfloat16: m16n8k16 on bf16 operands with float32 accumulation. x,
//    B and C arrive in bf16 and are exact operands; x o u, h_in and W are
//    float32 and are rounded to bf16 once (2^-9 relative), well inside
//    the 2e-2-of-max|y| gate, and y is rounded to bf16 anyway.
//  * float32: m16n8k8 in TF32 three times per product (3xTF32: a = a_hi +
//    a_lo with both parts TF32, a b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi):
//    each product keeps ~21 bits, about float32's, where one TF32 pass
//    would keep 11 and miss the 1e-4-of-max|y| gate. Inside each 8-deep
//    step the depth index is permuted (logical k = t, t + 4 -> stored
//    2t, 2t + 1) in both operands alike, which leaves the sum unchanged
//    and makes one accumulator tile the A operand of the next product as
//    it stands, as the bf16 layout does without a permutation.
// Every operand tile is copied into shared memory as it lies in memory,
// rows padded, with coalesced 16-byte loads (a and dt are loaded first of
// all). Where the
// depth (k) index runs along a row (C, B and h_in against the state
// width) a fragment load is one 32-bit (bf16 pair) or 64-bit (float pair)
// load; where it runs down the rows (x and B o u against the chunk) bf16
// fragments come from ldmatrix .trans and float32 fragments from scalar
// loads; all free of bank conflicts. Pass 3 keeps W in registers: each
// warp owns 16-row strips of the chunk and, per 16-column block j <= i of
// the strip, computes G = C B^T, weights it by the decay and dt, and
// feeds it straight to W x; the C strip's fragments are loaded once into
// registers (from shared memory in bf16, from global memory in float32,
// whose 3xTF32 pass 3 would otherwise fit one block an SM). The four
// warps take strips (w, ns - 1 - w), so the triangle's work is split
// evenly. The decay exp(cs_i - cs_j) is computed only where i >= j:
// above the diagonal the exponent is positive and may overflow, and
// inf * 0 is NaN.
//
// Measured at zamba2's shape (PERF.md section 6; NVIDIA H100 80GB HBM3,
// 700 W, in a CUDA graph): bfloat16 0.32-0.33 ms (the first port: 1.95),
// of which pass 1 0.11, pass 2 0.035, pass 3 0.175; float32 1.03-1.04 ms.
// Passes 1 and 3 move their bytes at 0.6-0.9 TB/s, and occupancy decides
// their time: staging loads batched in register arrays held pass 3 to
// 0.257 ms; C staged in shared memory helps bfloat16 (0.176 ms against
// 0.215 from global memory) and hurts float32 (1.06 against 0.66: one
// block an SM). Keeping loads in flight across tiles (persistent blocks,
// cp.async double buffering) is the next step.
//
// The envelope: DH = 32 or 64 (a template parameter), N and Q up to 128
// (padded to 16 with zeros in shared memory), S % Q == 0; shared memory
// per block at most 140 KB (float32, N = Q = 128; 64 KB in bf16 at
// zamba2's widths, where registers hold pass 3 to 3 blocks an SM).
//
// C interface (bound with ctypes): every pointer and the stream is a
// void*; the launches run on the caller's stream, do not synchronize and
// allocate nothing (the caller passes the scratch). The return value is
// cudaGetLastError() after the launches (0 = launched), or
// cudaErrorInvalidValue for a shape the kernels do not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;    // passes 1 and 3: four warps
constexpr int kWarps = kThreads / 32;
constexpr int kPassThreads = 256;
constexpr int kQMax = 128;       // chunk rows
constexpr int kNMax = 128;       // state width
constexpr int kNK = kNMax / 16;  // depth steps over the state width
constexpr int kMaxSmem = 232448;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two neighbouring elements (k, k + 1) stored as one pair
__device__ __forceinline__ void store_pair(bf16* p, float v0, float v1) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(v0, v1);
}
__device__ __forceinline__ void store_pair(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// Warp-level products. A (16 x 16) rows g and g + 8, B (16 x 8) column g,
// with g = lane / 4 and t = lane % 4; `rg`, `rg8` and `rn` point at depth
// k0 of a row whose depth index is contiguous.
template <typename T>
struct Mma;

template <>
struct Mma<bf16> {
  struct A { uint32_t r[4]; };
  struct B { uint32_t r[2]; };
  static __device__ __forceinline__ uint32_t ld(const bf16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  static __device__ __forceinline__ A load_a(const bf16* rg, const bf16* rg8,
                                             int t) {
    return {{ld(rg + 2 * t), ld(rg8 + 2 * t), ld(rg + 8 + 2 * t),
             ld(rg8 + 8 + 2 * t)}};
  }
  static __device__ __forceinline__ B load_b(const bf16* rn, int t) {
    return {{ld(rn + 2 * t), ld(rn + 8 + 2 * t)}};
  }
  // two 16 x 8 accumulator tiles (columns 0-7, 8-15) as the A operand
  static __device__ __forceinline__ A from_acc(const float c0[4],
                                               const float c1[4]) {
    return {{pack_bf16(c0[0], c0[1]), pack_bf16(c0[2], c0[3]),
             pack_bf16(c1[0], c1[1]), pack_bf16(c1[2], c1[3])}};
  }
  // From a tile stored with the depth index as rows (base[k * ld + col],
  // 16-byte aligned rows): ldmatrix with .trans, one row address a lane.
  // A (16 x 16) at (m0, k0): the four 8 x 8 blocks (k0, m0), (k0, m0 + 8),
  // (k0 + 8, m0), (k0 + 8, m0 + 8).
  static __device__ __forceinline__ A load_a_rows(const bf16* base, int ld,
                                                  int k0, int m0, int lane) {
    const int q = lane >> 3;
    const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(
        base + (k0 + (lane & 7) + 8 * (q >> 1)) * ld + m0 + 8 * (q & 1)));
    A a;
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
        : "=r"(a.r[0]), "=r"(a.r[1]), "=r"(a.r[2]), "=r"(a.r[3])
        : "r"(addr)
        : "memory");
    return a;
  }
  // B (16 x 8) at (k0, n0): the blocks (k0, n0) and (k0 + 8, n0)
  static __device__ __forceinline__ B load_b_rows(const bf16* base, int ld,
                                                  int k0, int n0, int lane) {
    const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(
        base + (k0 + (lane & 15)) * ld + n0));
    B b;
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];"
        : "=r"(b.r[0]), "=r"(b.r[1])
        : "r"(addr)
        : "memory");
    return b;
  }
  static __device__ __forceinline__ void mma(float d[4], const A& a,
                                             const B& b) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[0]),
          "r"(b.r[1]));
  }
};

// float32 through 3xTF32, two 8-deep halves per 16-deep step. In each
// half the A registers hold (g, 2t), (g + 8, 2t), (g, 2t + 1),
// (g + 8, 2t + 1) and the B registers (2t, g), (2t + 1, g): logical depth
// t and t + 4 stored at 2t and 2t + 1, in both operands.
template <>
struct Mma<float> {
  struct A { float v[8]; };
  struct B { float v[4]; };
  static __device__ __forceinline__ A pack_a(const float v[8]) {
    // v: (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1), then the same at +8
    return {{v[0], v[2], v[1], v[3], v[4], v[6], v[5], v[7]}};
  }
  static __device__ __forceinline__ B load_b(const float* rn, int t) {
    B b;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 p = *reinterpret_cast<const float2*>(rn + 8 * h + 2 * t);
      b.v[2 * h] = p.x;
      b.v[2 * h + 1] = p.y;
    }
    return b;
  }
  static __device__ __forceinline__ A from_acc(const float c0[4],
                                               const float c1[4]) {
    return {{c0[0], c0[2], c0[1], c0[3], c1[0], c1[2], c1[1], c1[3]}};
  }
  // From a tile stored with the depth index as rows (base[k * ld + col]):
  // scalar loads, free of bank conflicts where ld is 4 or 12 modulo 16.
  static __device__ __forceinline__ A load_a_rows(const float* base, int ld,
                                                  int k0, int m0, int lane) {
    const int g = lane >> 2, t = lane & 3;
    A a;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* r0 = base + (k0 + 8 * h + 2 * t) * ld + m0 + g;
      a.v[4 * h] = r0[0];
      a.v[4 * h + 1] = r0[8];
      a.v[4 * h + 2] = r0[ld];
      a.v[4 * h + 3] = r0[ld + 8];
    }
    return a;
  }
  static __device__ __forceinline__ B load_b_rows(const float* base, int ld,
                                                  int k0, int n0, int lane) {
    const int g = lane >> 2, t = lane & 3;
    B b;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* r0 = base + (k0 + 8 * h + 2 * t) * ld + n0 + g;
      b.v[2 * h] = r0[0];
      b.v[2 * h + 1] = r0[ld];
    }
    return b;
  }
  static __device__ __forceinline__ void mma8(float d[4], const uint32_t a[4],
                                              const uint32_t b[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  static __device__ __forceinline__ void mma(float d[4], const A& a,
                                             const B& b) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t ah[4], al[4], bh[2], bl[2];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        ah[k] = tf32(a.v[4 * h + k]);
        al[k] = tf32(a.v[4 * h + k] - __uint_as_float(ah[k]));
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        bh[k] = tf32(b.v[2 * h + k]);
        bl[k] = tf32(b.v[2 * h + k] - __uint_as_float(bh[k]));
      }
      mma8(d, al, bh);               // the small terms first
      mma8(d, ah, bl);
      mma8(d, ah, bh);
    }
  }
};

__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }
__host__ __device__ constexpr int round8(int v) { return (v + 7) / 8 * 8; }

// Row padding (elements) of the tiles stored with the depth index as rows
// (x and B o u in pass 1, x in pass 3), read by load_a_rows / load_b_rows:
// bf16 rows of a multiple of 16 plus 8 (ldmatrix rows in distinct bank
// groups), float32 rows of a multiple of 8 plus 4.
__host__ __device__ constexpr int row_pad(int item) { return item == 2 ? 8 : 4; }

// Shared memory (bytes) of one block of each chunk pass; element size
// `item`, float32 cs and dt (or u) of Qp rows. Pass 3 stages C in shared
// memory in bfloat16; in float32 each warp loads its C strip's fragments
// from global memory (its registers hold them in either case).
size_t state_smem(int item, int DH, int N, int Q) {
  const int Qp = round16(Q), Np = round16(N), pad = row_pad(item);
  return size_t(item) * Qp * (DH + pad + Np + pad) + 8 * size_t(Qp);
}
size_t scan_smem(int item, int DH, int N, int Q) {
  const int Qp = round16(Q), Nk = round16(N);
  const size_t c_rows = item == 2 ? Qp : 0;
  return size_t(item) * ((Qp + c_rows) * (Nk + 8)
                         + size_t(Qp) * (DH + row_pad(item))
                         + size_t(DH) * (Nk + 8)) + 8 * size_t(Qp);
}

// (b, chunk, h) of this block; h fastest, so neighbouring blocks read
// neighbouring parts of one chunk of x and the same chunk of Bm and Cm
struct Chunk {
  int b, c, h, nc;
  int64_t row0;                   // (b, c * Q) in (B, S)
  __device__ Chunk(int S, int H, int Q) {
    nc = S / Q;
    h = blockIdx.x % H;
    const int bc = blockIdx.x / H;
    c = bc % nc;
    b = bc / nc;
    row0 = int64_t(b) * S + int64_t(c) * Q;
  }
};

// a and dt of chunk row threadIdx.x (Qp <= kThreads), loaded at the start
// of a block so their latency overlaps the staging's
struct Gates {
  float a, dt;
  __device__ Gates(const float* a_, const float* dt_, int64_t row0, int H,
                   int h, int Q) {
    const int i = threadIdx.x;
    a = i < Q ? a_[(row0 + i) * H + h] : 0.f;
    dt = i < Q ? dt_[(row0 + i) * H + h] : 0.f;
  }
};

// cs = inclusive cumsum of a over the chunk (warp 0), dts = dt; rows
// Q..Qp-1 get cs[Q - 1] and dt 0. Starts and ends with a barrier, so the
// staging written before it is visible after it.
__device__ void stage_cumsum(const Gates& gates, int Q, int Qp, float* cs,
                             float* dts) {
  const int tid = threadIdx.x;
  if (tid < Qp) {
    cs[tid] = gates.a;
    dts[tid] = gates.dt;
  }
  __syncthreads();
  if (tid < 32) {
    const int per = (Q + 31) / 32;
    float loc[kQMax / 32];
    float run = 0.f;
#pragma unroll
    for (int k = 0; k < kQMax / 32; ++k) {
      const int i = tid * per + k;
      if (k < per && i < Q) run += cs[i];
      loc[k] = run;
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
    for (int k = 0; k < kQMax / 32; ++k) {
      const int i = tid * per + k;
      if (k < per && i < Q) cs[i] = excl + loc[k];
    }
  }
  __syncthreads();
  for (int i = Q + tid; i < Qp; i += kThreads) cs[i] = cs[Q - 1];
  __syncthreads();
}

__device__ void zero_smem(void* p, size_t bytes) {
  uint4* q = static_cast<uint4*>(p);
  for (size_t e = threadIdx.x; e < bytes / 16; e += kThreads)
    q[e] = make_uint4(0, 0, 0, 0);
}

// dst[r * ld + col] = src[r * sstride + col] for r < R, col < ncol, as
// it stands: 16-byte copies where ncol is a multiple of the vector (the
// caller checks the alignment), neighbouring threads on neighbouring 16
// bytes of a row; element copies otherwise.
template <typename T>
__device__ void stage_copy(T* dst, int ld, const T* src, int64_t sstride,
                           int R, int ncol) {
  constexpr int V = 16 / sizeof(T);
  if (ncol % V == 0) {
    const int nvec = ncol / V;
    for (int e = threadIdx.x; e < R * nvec; e += kThreads)
      *reinterpret_cast<uint4*>(dst + (e / nvec) * ld + V * (e % nvec)) =
          *reinterpret_cast<const uint4*>(src + (e / nvec) * sstride
                                          + V * (e % nvec));
  } else {
    for (int e = threadIdx.x; e < R * ncol; e += kThreads)
      dst[(e / ncol) * ld + e % ncol] = src[(e / ncol) * sstride + e % ncol];
  }
}

// ---- pass 1: each chunk's own state ----------------------------------------

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_state(const T* __restrict__ x, const float* __restrict__ a,
                    const float* __restrict__ dt, const T* __restrict__ Bm,
                    float* __restrict__ state, float* __restrict__ decay,
                    int S, int H, int N, int Q) {
  using M = Mma<T>;
  const Chunk ck(S, H, Q);
  const Gates gates(a, dt, ck.row0, H, ck.h, Q);
  const int Qp = round16(Q), Np = round16(N), N8 = round8(N);
  const int LDx = DH + row_pad(sizeof(T)), LDb = Np + row_pad(sizeof(T));
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);          // Qp x LDx: x, depth q rows
  T* bu = xs + Qp * LDx;                       // Qp x LDb: B o u
  float* cs = reinterpret_cast<float*>(bu + Qp * LDb);
  float* u = cs + Qp;                          // dt, then u

  const int tid = threadIdx.x;
  if (Q != Qp || N != Np) {                    // zero padding rows / columns
    zero_smem(smem, size_t(Qp) * (LDx + LDb) * sizeof(T));
    __syncthreads();
  }
  stage_copy(xs, LDx, x + (ck.row0 * H + ck.h) * DH, int64_t(H) * DH, Q, DH);
  stage_copy(bu, LDb, Bm + ck.row0 * N, N, Q, N);
  stage_cumsum(gates, Q, Qp, cs, u);
  const float cs_last = cs[Q - 1];
  for (int i = tid; i < Qp; i += kThreads)
    u[i] = i < Q ? expf(cs_last - cs[i]) * u[i] : 0.f;
  const int64_t bhc = (int64_t(ck.b) * H + ck.h) * ck.nc + ck.c;
  if (tid == 0) decay[bhc] = expf(cs_last);
  __syncthreads();
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  for (int q = warp; q < Q; q += kWarps) {     // B o u, rounded once
    const float uq = u[q];
    for (int n = lane; n < N; n += 32)
      bu[q * LDb + n] = from_f32<T>(to_f32(bu[q * LDb + n]) * uq);
  }
  __syncthreads();

  // S_c (DH x N): items of 16 rows x 32 columns, round robin over warps
  const int ntile = N8 / 8, ngroup = (ntile + 3) / 4;
  float* out = state + bhc * DH * N;
  for (int item = warp; item < (DH / 16) * ngroup; item += kWarps) {
    const int p0 = 16 * (item % (DH / 16)), n0 = 32 * (item / (DH / 16));
    float acc[4][4] = {};
    for (int k0 = 0; k0 < Qp; k0 += 16) {
      const typename M::A af = M::load_a_rows(xs, LDx, k0, p0, lane);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        if (n0 + 8 * nt < N8)
          M::mma(acc[nt], af, M::load_b_rows(bu, LDb, k0, n0 + 8 * nt, lane));
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = n0 + 8 * nt + 2 * t;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float* o = out + (p0 + g + 8 * hh) * N + n;
        const float v0 = acc[nt][2 * hh], v1 = acc[nt][2 * hh + 1];
        if (N % 2 == 0 && n < N) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          if (n < N) o[0] = v0;
          if (n + 1 < N) o[1] = v1;
        }
      }
    }
  }
}

// ---- pass 2: the states entering each chunk --------------------------------

// h_in in HT: float32 in place over the float32 own states (h and own
// then alias), or bfloat16 into its own buffer for the bfloat16 scan,
// whose pass 3 rounds h_in to bf16 for the tensor cores anyway (the same
// rounding of the same float32 value: y keeps its bits, and pass 3 reads
// half the bytes).
template <typename HT>
__global__ void __launch_bounds__(kPassThreads)
    ssd_state_pass(const float* own_states, HT* h, const float* decay,
                   int nc, int lanes4) {
  constexpr int kAhead = 8;
  const int per_bh = (lanes4 + kPassThreads - 1) / kPassThreads;
  const int64_t bh = blockIdx.x / per_bh;
  const int e = (blockIdx.x % per_bh) * kPassThreads + threadIdx.x;
  if (e >= lanes4) return;
  const int64_t at = bh * nc * lanes4 + e;   // float4 lane of chunk 0
  const float4* s = reinterpret_cast<const float4*>(own_states) + at;
  const float* d = decay + bh * nc;
  float4 h_in = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += kAhead) {
    float4 own[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k)
      if (c0 + k < nc) own[k] = s[int64_t(c0 + k) * lanes4];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (c0 + k < nc) {
        HT* o = h + 4 * (at + int64_t(c0 + k) * lanes4);
        store_pair(o, h_in.x, h_in.y);
        store_pair(o + 2, h_in.z, h_in.w);
        const float dk = d[c0 + k];
        h_in.x = fmaf(dk, h_in.x, own[k].x);
        h_in.y = fmaf(dk, h_in.y, own[k].y);
        h_in.z = fmaf(dk, h_in.z, own[k].z);
        h_in.w = fmaf(dk, h_in.w, own[k].w);
      }
    }
  }
}

// ---- pass 3: y of each chunk -----------------------------------------------

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_scan(const T* __restrict__ x, const float* __restrict__ a,
                   const float* __restrict__ dt, const T* __restrict__ Bm,
                   const T* __restrict__ Cm, const T* __restrict__ h_in,
                   T* __restrict__ y, int S, int H, int N, int Q) {
  using M = Mma<T>;
  constexpr int kPT = DH / 8;                  // output column tiles
  constexpr bool kCStaged = sizeof(T) == 2;    // C in shared memory
  const Chunk ck(S, H, Q);
  const Gates gates(a, dt, ck.row0, H, ck.h, Q);
  const int Qp = round16(Q), Nk = round16(N);
  const int LDn = Nk + 8, LDx = DH + row_pad(sizeof(T));
  extern __shared__ __align__(16) unsigned char smem[];
  T* bm = reinterpret_cast<T*>(smem);          // Qp x LDn: B, depth n
  T* xs = bm + Qp * LDn;                       // Qp x LDx: x, depth j rows
  T* hs = xs + Qp * LDx;                       // DH x LDn: h_in, depth n
  T* cm = hs + DH * LDn;                       // Qp x LDn: C (bf16 only)
  float* cs = reinterpret_cast<float*>(cm + (kCStaged ? Qp * LDn : 0));
  float* dts = cs + Qp;

  const int tid = threadIdx.x;
  if (Q != Qp || N != Nk) {
    zero_smem(smem, (size_t(Qp) * (kCStaged ? 2 * LDn : LDn)
                     + size_t(Qp) * LDx + size_t(DH) * LDn) * sizeof(T));
    __syncthreads();
  }
  const int64_t bhc = (int64_t(ck.b) * H + ck.h) * ck.nc + ck.c;
  stage_copy(bm, LDn, Bm + ck.row0 * N, N, Q, N);
  if (kCStaged) stage_copy(cm, LDn, Cm + ck.row0 * N, N, Q, N);
  stage_copy(xs, LDx, x + (ck.row0 * H + ck.h) * DH, int64_t(H) * DH, Q, DH);
  stage_copy(hs, LDn, h_in + bhc * DH * N, N, DH, N);
  stage_cumsum(gates, Q, Qp, cs, dts);         // barriers

  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int ns = Qp / 16, nk = Nk / 16;
  const T* crow = Cm + ck.row0 * N;
  for (int pass = 0; pass < 2; ++pass) {
    // strips w and ns - 1 - w: the triangle's work split evenly
    const int s = pass == 0 ? warp : ns - 1 - warp;
    if (s >= ns || (pass == 1 && s < kWarps)) continue;
    const int i0 = 16 * s;
    const int ig = i0 + g, ig8 = i0 + g + 8;

    // the C strip's fragments, depth n (rows >= Q and columns >= N are
    // zeros): from shared memory in bf16, from global memory in float32
    typename M::A cf[kNK];
#pragma unroll
    for (int kk = 0; kk < kNK; ++kk) {
      if (kk < nk) {
        if constexpr (kCStaged) {
          cf[kk] = M::load_a(cm + ig * LDn + 16 * kk, cm + ig8 * LDn + 16 * kk,
                             t);
        } else {
          float v[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int i = (e & 2) ? ig8 : ig;
            const int n = 16 * kk + 2 * t + (e & 1) + ((e & 4) ? 8 : 0);
            v[e] = (i < Q && n < N) ? to_f32(crow[int64_t(i) * N + n]) : 0.f;
          }
          cf[kk] = M::pack_a(v);
        }
      }
    }

    // inter-chunk: exp(cs_i) (C h_in^T)
    float acc[kPT][4] = {};
#pragma unroll
    for (int kk = 0; kk < kNK; ++kk) {
      if (kk < nk) {
#pragma unroll
        for (int pt = 0; pt < kPT; ++pt)
          M::mma(acc[pt], cf[kk],
                 M::load_b(hs + (8 * pt + g) * LDn + 16 * kk, t));
      }
    }
    const float eg = expf(cs[ig]), eg8 = expf(cs[ig8]);
#pragma unroll
    for (int pt = 0; pt < kPT; ++pt) {
      acc[pt][0] *= eg;
      acc[pt][1] *= eg;
      acc[pt][2] *= eg8;
      acc[pt][3] *= eg8;
    }

    // intra-chunk, one 16-column block of j at a time: W = G o L o dt
    const float csg = cs[ig], csg8 = cs[ig8];
    for (int jb = 0; jb <= s; ++jb) {
      float gt[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < kNK; ++kk) {
        if (kk < nk) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            M::mma(gt[hh], cf[kk],
                   M::load_b(bm + (16 * jb + 8 * hh + g) * LDn + 16 * kk, t));
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e < 2 ? ig : ig8;
          const int j = 16 * jb + 8 * hh + 2 * t + (e & 1);
          const float ci = e < 2 ? csg : csg8;
          gt[hh][e] = (i >= j && j < Q)
                          ? gt[hh][e] * expf(ci - cs[j]) * dts[j] : 0.f;
        }
      }
      const typename M::A wf = M::from_acc(gt[0], gt[1]);
#pragma unroll
      for (int pt = 0; pt < kPT; ++pt)
        M::mma(acc[pt], wf, M::load_b_rows(xs, LDx, 16 * jb, 8 * pt, lane));
    }

    // y rows ig and ig8, columns 8 pt + 2t, + 1
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = hh ? ig8 : ig;
      if (i >= Q) continue;
      T* out = y + ((ck.row0 + i) * H + ck.h) * DH;
#pragma unroll
      for (int pt = 0; pt < kPT; ++pt)
        store_pair(out + 8 * pt + 2 * t, acc[pt][2 * hh],
                   acc[pt][2 * hh + 1]);
    }
  }
}

// ---- launch ------------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
}

template <typename T, int DH>
int launch(const T* x, const float* a, const float* dt, const T* Bm,
           const T* Cm, T* y, float* state, T* h_in, float* decay, int B,
           int S, int H, int N, int Q, int passes, cudaStream_t stream) {
  static bool attr_set = false;   // once per instantiation, before any
  if (!attr_set) {                // CUDA-graph capture of a launch
    cudaError_t e = allow_smem(ssd_chunk_state<T, DH>);
    if (e == cudaSuccess) e = allow_smem(ssd_chunk_scan<T, DH>);
    if (e != cudaSuccess) return int(e);
    attr_set = true;
  }
  const int item = sizeof(T);
  const int nc = S / Q;
  const unsigned int blocks = unsigned(int64_t(B) * nc * H);
  ssd_chunk_state<T, DH><<<blocks, kThreads, state_smem(item, DH, N, Q),
                           stream>>>(x, a, dt, Bm, state, decay, S, H, N, Q);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  const int lanes4 = DH * N / 4;
  const unsigned int pblocks =
      unsigned(int64_t(B) * H * ((lanes4 + kPassThreads - 1) / kPassThreads));
  ssd_state_pass<T><<<pblocks, kPassThreads, 0, stream>>>(state, h_in, decay,
                                                        nc, lanes4);
  e = cudaGetLastError();
  if (e != cudaSuccess || passes < 3) return int(e);
  ssd_chunk_scan<T, DH><<<blocks, kThreads, scan_smem(item, DH, N, Q),
                          stream>>>(x, a, dt, Bm, Cm, h_in, y, S, H, N, Q);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const float* a, const float* dt, const void* Bm,
             const void* Cm, void* y, float* state, void* h_in, float* decay,
             int B, int S, int H, int DH, int N, int Q, int passes,
             cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(Bm);
  const T* ct = static_cast<const T*>(Cm);
  T* yt = static_cast<T*>(y);
  T* ht = static_cast<T*>(h_in);
  if (DH == 32)
    return launch<T, 32>(xt, a, dt, bt, ct, yt, state, ht, decay, B, S, H, N,
                         Q, passes, stream);
  return launch<T, 64>(xt, a, dt, bt, ct, yt, state, ht, decay, B, S, H, N,
                       Q, passes, stream);
}

template <typename T, int DH>
int occupancy(int pass, int* blocks, int smem) {
  cudaError_t e = pass == 1 ? allow_smem(ssd_chunk_state<T, DH>)
                            : allow_smem(ssd_chunk_scan<T, DH>);
  if (e != cudaSuccess) return int(e);
  return int(pass == 1 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                             blocks, ssd_chunk_state<T, DH>, kThreads, smem)
                       : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                             blocks, ssd_chunk_scan<T, DH>, kThreads, smem));
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

bool shape_ok(int B, int S, int H, int DH, int N, int Q, int item) {
  return B > 0 && H > 0 && S > 0 && Q > 0 && Q <= kQMax && S % Q == 0
         && N > 0 && N <= kNMax && (DH == 32 || DH == 64)
         // the grids (a shape past them would not fit in device memory)
         && int64_t(B) * (S / Q) * H <= 2147483647
         && int64_t(B) * H * DH * N / 4 <= 2147483647
         && state_smem(item, DH, N, Q) <= size_t(kMaxSmem)
         && scan_smem(item, DH, N, Q) <= size_t(kMaxSmem);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, Bm, Cm, y); a and dt are float32.
// Scratch, all written here: state, float32 (B, H, S/Q, DH, N), each
// chunk's own state; h_in, the same shape in x's type, the state entering
// each chunk (float32: pass state itself, and h_in replaces the own states
// in place); decay, float32 (B, H, S/Q). passes = 3 runs the whole scan;
// passes = 2 stops after the state passing (y untouched). x, Bm, Cm, y,
// state and h_in must be 16-byte aligned.
int ssm_scan(const void* x, const void* a, const void* dt, const void* Bm,
             const void* Cm, void* y, void* state, void* h_in, void* decay,
             int B, int S, int H, int DH, int N, int Q, int dtype, int passes,
             void* stream) {
  const int item = dtype == 1 ? 2 : 4;
  if ((dtype != 0 && dtype != 1) || (passes != 2 && passes != 3)
      || !shape_ok(B, S, H, DH, N, Q, item) || !aligned16(x)
      || !aligned16(Bm) || !aligned16(Cm) || !aligned16(y)
      || !aligned16(state) || !aligned16(h_in))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* dtf = static_cast<const float*>(dt);
  float* sf = static_cast<float*>(state);
  float* df = static_cast<float*>(decay);
  if (dtype == 0)
    return dispatch<float>(x, af, dtf, Bm, Cm, y, sf, h_in, df, B, S, H, DH,
                           N, Q, passes, st);
  return dispatch<bf16>(x, af, dtf, Bm, Cm, y, sf, h_in, df, B, S, H, DH, N,
                        Q, passes, st);
}

// Dynamic shared memory of one block of pass `pass` (1: ssd_chunk_state,
// 3: ssd_chunk_scan; 2: ssd_state_pass, none) at (DH, N, Q) in `dtype`,
// and how many such blocks one SM holds at once.
int ssm_scan_occupancy(int pass, int dtype, int DH, int N, int Q,
                       int* blocks, int* smem) {
  const int item = dtype == 1 ? 2 : 4;
  if ((dtype != 0 && dtype != 1) || !shape_ok(1, Q, 1, DH, N, Q, item))
    return int(cudaErrorInvalidValue);
  if (pass == 2) {
    *smem = 0;
    return int(dtype == 0 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                                blocks, ssd_state_pass<float>, kPassThreads, 0)
                          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                                blocks, ssd_state_pass<bf16>, kPassThreads,
                                0));
  }
  if (pass != 1 && pass != 3) return int(cudaErrorInvalidValue);
  *smem = int(pass == 1 ? state_smem(item, DH, N, Q)
                        : scan_smem(item, DH, N, Q));
  if (dtype == 0)
    return DH == 32 ? occupancy<float, 32>(pass, blocks, *smem)
                    : occupancy<float, 64>(pass, blocks, *smem);
  return DH == 32 ? occupancy<bf16, 32>(pass, blocks, *smem)
                  : occupancy<bf16, 64>(pass, blocks, *smem);
}

}  // extern "C"
