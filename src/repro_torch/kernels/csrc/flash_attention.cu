// Forward flash attention (online softmax) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fa_kernel` / `flash_attention_call` of
// src/repro/kernels/flash_attention.py, the attention of the LM forward
// (`models/attention.attention(impl="flash")`).  It computes what that kernel
// computes: q [B, H, Sq, D], k and v [B, HK, Sk, D] (H a multiple of HK; the
// kv head of q head h is h / (H / HK), so K and V are never repeated), fp32
// or bf16 in, scores, softmax state and the P @ V sum in fp32, the output in
// the input type.  Query row i sits at position i + (Sk - Sq), so a suffix of
// queries (decode style) attends to the whole kv axis.  Causal keeps
// kpos <= qpos, a window keeps kpos > qpos - window.  Masked scores take the
// finite sentinel -1e30 and their probabilities are set to 0, so a row whose
// first live tile has no live column keeps m = -1e30 and alpha = 1 (never
// exp(-inf + inf)); a row with no live key at all gives 0 (safe divide).
//
// Design shared by both kernels.  The TPU kernel walks kv tiles along a
// sequential grid axis with (m, l, acc) in VMEM scratch.  Hopper blocks run
// in no order, so one thread block owns one (batch, q head, 64-row q tile)
// and walks its kv tiles (64 keys each) in ascending order in a loop inside
// the block; m and l stay in registers, the accumulator stays in fp32
// registers, and the output is stored once.  No atomics: the result is
// bit-identical from launch to launch.  A kv tile is skipped only when none
// of its (row, column) pairs is live: the live keys of a q tile form the
// contiguous range (q_first - window, q_last], so the loop runs over exactly
// the tiles that meet it.  Ragged Sq and Sk are masked at the edges; strides
// are taken for the batch, head and sequence axes (the head dim is
// contiguous), so `[B, S, H, D]` activations are read and written without a
// transposed copy; offsets are 64-bit.  Blocks are issued last q tile first,
// so the longest causal rows start first.  The head dim selects one of three
// instantiations (D <= 64, 128, 256) that size the shared tiles.
//
// fp32 (flash_attention_f32): plain fp32 FFMA, as the Pallas kernel's fp32
// dots.  256 threads; the Q tile is staged once into shared memory
// (transposed, d-major), each K tile (transposed) and V tile synchronously
// through shared memory, and the probabilities through a shared tile between
// the two products.  Thread (ty, tx) owns score rows 4ty..4ty+3 and columns
// 4tx..4tx+3, and output rows 4ty..4ty+3 at columns 4tx + 64j; the row max
// and sum are reduced over the 16 lanes of a row with warp shuffles.  Bound:
// 4 * D operations per live score at 67 TFLOP/s, far above the bytes of q,
// k, v and o at 3.35 TB/s; it is limited by shared-memory reads (two 16-byte
// reads per 16 FFMA) more than by the FFMA rate.
//
// bf16 (flash_attention_bf16, namespace tc): both products on the bf16
// tensor cores with fp32 accumulation, at the Pallas kernel's precision.
// - S = Q K^T: the products of bf16 values are exact in fp32, as in the
//   Pallas kernel's fp32 dot of upcast bf16.  One warpgroup (128 threads)
//   per block issues wgmma.m64n64k16 with Q and K in shared memory.
// - The mask, scale and online softmax run in fp32 registers on the
//   accumulator fragment (the finite -1e30 sentinel, p = 0 on masked pairs,
//   the safe divide), in log2 units for exp2.
// - P V with P split in two: p_hi = bf16(p), p_lo = bf16(p - p_hi), and
//   acc += p_hi V + p_lo V, two wgmma products with P taken from registers
//   (the accumulator fragment repacked as the A operand: no shared-memory
//   round trip) and V in shared memory as the transposed B operand.  Each
//   product of bf16 values is exact, and |p - p_hi - p_lo| <= 2^-16 p, so the
//   output moves by at most 2^-16 max|v|.  A single bf16 P would not do: it
//   moves the output by up to 2^-8 max|v|.
// - Q, K and V stay bf16 in shared memory in the 128-byte swizzled layout
//   wgmma reads (64-column atoms of 64 rows x 128 bytes; the contraction is
//   zero-padded to DMAX); Q is loaded once, and the K/V tiles are
//   double-buffered and copied by cp.async, so the next tile's copy runs
//   while this tile's products and softmax do.  One barrier per tile.
// - The issue slots are the scarce resource, so each thread's copy
//   addresses are worked out once per block, the mask is built only on a
//   tile that crosses an edge, the diagonal or the window's edge (the
//   softmax is compiled for full and partial tiles), the scale is folded
//   into the one FFMA before ex2, and the accumulator is rescaled only when
//   a row max moved.
// Bound: three products of 2 * D operations per live score at 989 TFLOP/s
// (QK^T, p_hi V, p_lo V); the bytes of q, k, v and o at 3.35 TB/s are far
// below it.  What still holds it back: one warpgroup does the softmax
// between its own products (no ping-pong of two warpgroups, no producer
// warp, no TMA), so the tensor cores idle during the softmax and the waits
// unless another block on the SM fills them.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BKV = 64;        // keys per kv tile
constexpr int RM = 4;          // score rows per thread
constexpr int RN = 4;          // score columns per thread
constexpr int THREADS = (BQ / RM) * (BKV / RN);  // 256
constexpr int PPAD = 4;        // pads the probability tile's rows (keeps 16-byte alignment)
constexpr float NEG = -1e30f;  // the finite mask sentinel of the Pallas kernel

struct Params {
  int heads, rep, sq, sk, d, causal, window;  // window <= 0: none
  float scale;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
};

// 8 consecutive fp32 elements of one row (two 16-byte vector loads)
__device__ __forceinline__ void load8(const float* src, float (&x)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(src));
  const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void store4(float* dst, const float (&x)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
}

// dst[d * 64 + row] = src[row * row_stride + d] for d < D, rows < `rows`
// (zeros for the rows past the ragged edge).  Consecutive threads take
// consecutive rows, so the shared-memory writes do not conflict.
template <typename T>
__device__ __forceinline__ void load_tile_transposed(const T* __restrict__ src, long long row_stride,
                                                     int rows, int D, float* __restrict__ dst) {
  const int chunks = D / 8;
  for (int item = threadIdx.x; item < 64 * chunks; item += THREADS) {
    const int row = item & 63, ch = item >> 6;
    float x[8];
    if (row < rows) {
      load8(src + row * row_stride + ch * 8, x);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[(ch * 8 + e) * 64 + row] = x[e];
  }
}

// dst[row * DMAX + d] = src[row * row_stride + d] for d < D (zeros past `rows`)
template <typename T, int DMAX>
__device__ __forceinline__ void load_tile_rows(const T* __restrict__ src, long long row_stride,
                                               int rows, int D, float* __restrict__ dst) {
  const int chunks = D / 8;
  for (int item = threadIdx.x; item < 64 * chunks; item += THREADS) {
    const int row = item / chunks, ch = item - row * chunks;
    float x[8];
    if (row < rows) {
      load8(src + row * row_stride + ch * 8, x);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = 0.f;
    }
    float4* d4 = reinterpret_cast<float4*>(dst + row * DMAX + ch * 8);
    d4[0] = make_float4(x[0], x[1], x[2], x[3]);
    d4[1] = make_float4(x[4], x[5], x[6], x[7]);
  }
}

template <int DMAX>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(DMAX) * BQ + static_cast<size_t>(DMAX) * BKV +
                          static_cast<size_t>(BKV) * DMAX + static_cast<size_t>(BKV) * (BQ + PPAD));
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, Params p) {
  constexpr int JJ = DMAX / 64;  // 4-wide output column groups per thread
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [DMAX][BQ]   q tile, d-major
  float* Kt = Qt + DMAX * BQ;                    // [DMAX][BKV]  k tile, d-major
  float* Vs = Kt + DMAX * BKV;                   // [BKV][DMAX]  v tile
  float* Ps = Vs + BKV * DMAX;                   // [BKV][BQ + PPAD] probabilities, key-major

  const int iq = gridDim.x - 1 - blockIdx.x;  // last q tile first: longest causal rows
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.rep;
  const int q0 = iq * BQ;
  const int rows = min(BQ, p.sq - q0);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int D = p.d;

  const T* qb = q + b * p.q_sb + h * p.q_sh + q0 * p.q_ss;
  const T* kb = k + b * p.k_sb + hk * p.k_sh;
  const T* vb = v + b * p.v_sb + hk * p.v_sh;
  T* ob = o + b * p.o_sb + h * p.o_sh + q0 * p.o_ss;

  // columns >= D of the v tile are never loaded: zero them once
  for (int i = tid; i < BKV * DMAX; i += THREADS) Vs[i] = 0.f;
  load_tile_transposed(qb, p.q_ss, rows, D, Qt);

  // the kv tiles that hold a live (row, key) pair
  const long long q_first = static_cast<long long>(q0) + p.sk - p.sq;  // position of row 0
  const long long q_last = q_first + rows - 1;
  const int nkv = (p.sk + BKV - 1) / BKV;
  int kt_begin = 0, kt_end = nkv;
  if (p.causal) kt_end = q_last < 0 ? 0 : static_cast<int>(min(static_cast<long long>(nkv), q_last / BKV + 1));
  if (p.window > 0) {
    const long long lowest = q_first - p.window + 1;
    if (lowest > 0) kt_begin = static_cast<int>(min(static_cast<long long>(nkv), lowest / BKV));
  }

  float m[RM], l[RM], acc[RM][4 * JJ];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * JJ; ++j) acc[i][j] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BKV;
    const int kv_rows = min(BKV, p.sk - k0);
    __syncthreads();  // the previous tile's Kt, Vs and Ps are read
    load_tile_transposed(kb + k0 * p.k_ss, p.k_ss, kv_rows, D, Kt);
    load_tile_rows<T, DMAX>(vb + k0 * p.v_ss, p.v_ss, kv_rows, D, Vs);
    __syncthreads();

    // scores s = q . k over d, fp32 FFMA
    float s[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + d * BQ + ty * RM);
      const float4 c = *reinterpret_cast<const float4*>(Kt + d * BKV + tx * RN);
      const float av[RM] = {a.x, a.y, a.z, a.w};
      const float cv[RN] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    // mask, online softmax update (row max and sum over the row's 16 lanes)
    bool live[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const long long qpos = q_first + ty * RM + i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int col = tx * RN + j;
        const long long kpos = k0 + col;
        bool ok = (ty * RM + i < rows) && (col < kv_rows);
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.window > 0) ok = ok && kpos > qpos - p.window;
        live[i][j] = ok;
        s[i][j] = ok ? s[i][j] * p.scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        s[i][j] = live[i][j] ? expf(s[i][j] - m_new) : 0.f;
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4 * JJ; ++j) acc[i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < RN; ++j)
      *reinterpret_cast<float4*>(Ps + (tx * RN + j) * (BQ + PPAD) + ty * RM) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc += p @ v, fp32 FFMA over the tile's keys (masked keys have p = 0
    // and zero rows of v)
#pragma unroll 4
    for (int c = 0; c < BKV; ++c) {
      const float4 pc = *reinterpret_cast<const float4*>(Ps + c * (BQ + PPAD) + ty * RM);
      const float pv[RM] = {pc.x, pc.y, pc.z, pc.w};
#pragma unroll
      for (int jj = 0; jj < JJ; ++jj) {
        const float4 vv = *reinterpret_cast<const float4*>(Vs + c * DMAX + jj * 64 + tx * 4);
        const float vr[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][jj * 4 + e] = fmaf(pv[i], vr[e], acc[i][jj * 4 + e]);
      }
    }
  }

  // one store: acc / l, with l == 0 (no live key) dividing by 1
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = ty * RM + i;
    if (row >= rows) continue;
    const float safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int jj = 0; jj < JJ; ++jj) {
      const int d0 = jj * 64 + tx * 4;
      if (d0 >= D) continue;
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = acc[i][jj * 4 + e] / safe;
      store4(ob + row * p.o_ss + d0, x);
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 kernel: both products on the tensor cores (wgmma), softmax in fp32.

namespace tc {

constexpr int NT = 128;               // one warpgroup per block: BQ = 64 query rows
constexpr int TILE_BYTES = 64 * 128;  // one 64-row x 64-column bf16 atom (128-byte rows)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units), layout type 1 in bits 62-63
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// 2^x by the special function unit (relative error ~2^-22; results below
// 2^-126 flush to 0, far below the fp32 sums they join)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// keeps the compiler from moving accesses of an accumulator across a wgmma
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A @ B, m64n64k16, both operands in shared memory (K-major), fp32 accumulate
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d += A @ B, m64n64k16, A from registers (the fragment of mma.m16n8k16 per
// warp), B in shared memory N-major (transposed), fp32 accumulate
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// One thread's share of copying a [64, DMAX] bf16 tile (rows [0, rows),
// columns [0, D); zeros past the edges) into shared memory as DMAX / 64
// atoms of 64 rows x 128 bytes, with 16-byte chunk c of row r at chunk
// c ^ (r % 8): the 128-byte swizzle wgmma reads.  Thread t copies chunk
// cc = t % CH of rows r_t + RSTEP j, so eight consecutive threads copy one
// row's 128 contiguous bytes, and its addresses are worked out once per
// block: a tile costs each thread JN copies and a few adds.
template <int DMAX>
struct TileCopy {
  static constexpr int CH = DMAX / 8;     // 16-byte chunks per row
  static constexpr int RSTEP = NT / CH;   // rows between one thread's chunks
  static constexpr int JN = 64 / RSTEP;   // chunks per thread and tile
  static_assert(RSTEP % 4 == 0, "the swizzle of row r_t + RSTEP j takes two values at most");
  int r_t;
  bool col_ok;
  uint32_t soff[2];  // byte offset in the tile of chunk j = 0 and j = 1

  __device__ __forceinline__ TileCopy(int D) {
    const int cc = threadIdx.x % CH;
    r_t = threadIdx.x / CH;
    col_ok = cc * 8 < D;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = r_t + RSTEP * j;
      soff[j] = (cc / 8) * TILE_BYTES + r * 128 + (((cc % 8) ^ (r % 8)) << 4);
    }
  }

  // src: row 0, column 0 of the tile in global memory
  __device__ __forceinline__ void copy(const __nv_bfloat16* src, long long row_stride, int rows,
                                       uint32_t dst) const {
    const __nv_bfloat16* g = src + r_t * row_stride + (threadIdx.x % CH) * 8;
    const long long step = RSTEP * row_stride;
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      const bool ok = col_ok && r_t + RSTEP * j < rows;
      // chunk j sits RSTEP j rows below chunk j % 2 (a multiple of 8 rows when j is even)
      cp_async16(dst + soff[j % 2] + (j - j % 2) * RSTEP * 128, ok ? g : src, ok);
      g += step;
    }
  }
};

template <int DMAX>
constexpr size_t smem_bytes() {
  // q, then two stages of (k, v); 1024 more to align the atoms to 1024 bytes
  return static_cast<size_t>(5) * (DMAX / 64) * TILE_BYTES + 1024;
}

// The online-softmax step on one 64 x 64 score tile, held as the wgmma
// accumulator fragment s: s[4j + e] is (row r0, key 8j + cq + e) and
// s[4j + 2 + e] is (row r0 + 8, the same key).  Scores are scaled by sl2
// (the softmax scale in log2 units, so that exp2 serves), masked pairs (a
// clear bit of `live`; FULL: none) count as -1e30 in the max and give p = 0,
// m and l take the rescale alpha, and p is split into bf16 A fragments
// p_hi = bf16(p), p_lo = bf16(p - p_hi) for the two PV products: keys
// 16kk .. 16kk + 15 are s[8kk .. 8kk + 7], as a0 (r0, low keys), a1 (r0 + 8,
// low keys), a2 (r0, keys + 8), a3 (r0 + 8, keys + 8).
template <bool FULL>
__device__ __forceinline__ void softmax_tile(const float (&s)[32], uint32_t live, float sl2,
                                             float (&m)[2], float (&l)[2], float (&alpha)[2],
                                             uint32_t (&phi)[4][4], uint32_t (&plo)[4][4]) {
  float mx[2] = {NEG, NEG};  // the row max of the raw scores
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int hr = (i / 2) % 2;  // 0: row r0, 1: row r0 + 8
    mx[hr] = fmaxf(mx[hr], FULL || (live >> i) & 1u ? s[i] : NEG);
  }
  float neg_m[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
    // sl2 > 0, so the max of the scaled scores is the scaled max; a row with
    // no live pair in this tile keeps the sentinel
    const float m_new = fmaxf(m[hr], mx[hr] == NEG ? NEG : mx[hr] * sl2);
    alpha[hr] = exp2_approx(m[hr] - m_new);
    m[hr] = m_new;
    l[hr] *= alpha[hr];
    neg_m[hr] = -m_new;
  }
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int hr = (i / 2) % 2;
    float pv[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float x = exp2_approx(fmaf(s[i + e], sl2, neg_m[hr]));
      pv[e] = FULL || (live >> (i + e)) & 1u ? x : 0.f;
      l[hr] += pv[e];
    }
    const __nv_bfloat162 hi = __floats2bfloat162_rn(pv[0], pv[1]);
    const float2 hf = __bfloat1622float2(hi);
    const __nv_bfloat162 lo = __floats2bfloat162_rn(pv[0] - hf.x, pv[1] - hf.y);
    phi[i / 8][(i % 8) / 2] = *reinterpret_cast<const uint32_t*>(&hi);
    plo[i / 8][(i % 8) / 2] = *reinterpret_cast<const uint32_t*>(&lo);
  }
}

template <int DMAX>
__global__ void __launch_bounds__(NT)
flash_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                            Params p) {
  constexpr int NA = DMAX / 64;  // 64-column atoms (and output slices)
  constexpr int KSTEPS = DMAX / 16;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base;  // q tile, then two stages of (k, v)
  const uint32_t sk[2] = {base + NA * TILE_BYTES, base + 3 * NA * TILE_BYTES};
  const uint32_t sv[2] = {base + 2 * NA * TILE_BYTES, base + 4 * NA * TILE_BYTES};

  const int iq = gridDim.x - 1 - blockIdx.x;  // last q tile first: longest causal rows
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.rep;
  const int q0 = iq * BQ;
  const int rows = min(BQ, p.sq - q0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = 16 * warp + lane / 4;  // this thread's rows r0 and r0 + 8
  const int cq = 2 * (lane % 4);        // and keys / columns 8j + cq, 8j + cq + 1

  const __nv_bfloat16* qb = q + b * p.q_sb + h * p.q_sh + q0 * p.q_ss;
  const __nv_bfloat16* kb = k + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vb = v + b * p.v_sb + hk * p.v_sh;
  __nv_bfloat16* ob = o + b * p.o_sb + h * p.o_sh + q0 * p.o_ss;

  // the kv tiles that hold a live (row, key) pair, as in the fp32 kernel
  const long long q_first = static_cast<long long>(q0) + p.sk - p.sq;
  const long long q_last = q_first + rows - 1;
  const int nkv = (p.sk + BKV - 1) / BKV;
  int kt_begin = 0, kt_end = nkv;
  if (p.causal) kt_end = q_last < 0 ? 0 : static_cast<int>(min(static_cast<long long>(nkv), q_last / BKV + 1));
  if (p.window > 0) {
    const long long lowest = q_first - p.window + 1;
    if (lowest > 0) kt_begin = static_cast<int>(min(static_cast<long long>(nkv), lowest / BKV));
  }

  const float sl2 = p.scale * 1.4426950408889634f;  // the scale in log2 units
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};  // l: this thread's share of the row sums
  float acc[NA][32];
#pragma unroll
  for (int n = 0; n < NA; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[n][i] = 0.f;

  const TileCopy<DMAX> tiles(p.d);
  if (kt_begin < kt_end) {
    tiles.copy(qb, p.q_ss, rows, sq);
    tiles.copy(kb + kt_begin * BKV * p.k_ss, p.k_ss, p.sk - kt_begin * BKV, sk[0]);
    tiles.copy(vb + kt_begin * BKV * p.v_ss, p.v_ss, p.sk - kt_begin * BKV, sv[0]);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int st = (kt - kt_begin) & 1;
    const int k0 = kt * BKV;
    // this tile has landed (own copies) and is visible to wgmma (the async
    // proxy); the barrier covers everyone's copies, and the other stage was
    // last read in the previous iteration, which every thread has finished
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (kt + 1 < kt_end) {  // the next tile's copy overlaps this tile's math
      const int k1 = k0 + BKV;
      tiles.copy(kb + k1 * p.k_ss, p.k_ss, p.sk - k1, sk[st ^ 1]);
      tiles.copy(vb + k1 * p.v_ss, p.v_ss, p.sk - k1, sv[st ^ 1]);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }

    // S = Q K^T: A = q tile, B = k tile, both K-major; the kk-th 16 columns
    // of d lie 32 bytes into atom kk / 4
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const uint32_t off = (kk / 4) * TILE_BYTES + (kk % 4) * 32;
      wgmma_ss(s, desc(sq + off, 16, 1024), desc(sk[st] + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);

    // the mask is needed only on a tile that crosses an edge, the diagonal
    // or the window's edge (uniform across the block)
    const int kv_rows = min(BKV, p.sk - k0);
    const bool full = rows == BQ && kv_rows == BKV && (!p.causal || k0 + BKV - 1 <= q_first) &&
                      (p.window <= 0 || k0 > q_last - p.window);
    float alpha[2];
    uint32_t phi[4][4], plo[4][4];
    if (full) {
      softmax_tile<true>(s, 0u, sl2, m, l, alpha, phi, plo);
    } else {
      uint32_t live = 0;  // bit i: s[i] is a live pair
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int row = r0 + 8 * ((i / 2) % 2), col = 8 * (i / 4) + cq + (i % 2);
        const long long qpos = q_first + row, kpos = k0 + col;
        bool ok = row < rows && col < kv_rows;
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.window > 0) ok = ok && kpos > qpos - p.window;
        live |= static_cast<uint32_t>(ok) << i;
      }
      softmax_tile<false>(s, live, sl2, m, l, alpha, phi, plo);
    }
    // rescale the accumulator where a row max moved (alpha == 1 elsewhere;
    // once the max settles this is skipped)
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < NA; ++n)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[n][i] *= alpha[(i / 2) % 2];
    }

    // acc += p_hi V + p_lo V: V is the N-major B operand; keys 16kk .. lie
    // 2048 bytes (two 8-row groups of 1024 bytes) apart, output slice n in
    // atom n.  An N of 64 is one swizzle atom wide, so the offset between
    // atoms along N is never used: both offsets name the 8-row group stride.
#pragma unroll
    for (int n = 0; n < NA; ++n) fence_regs(acc[n]);
    wgmma_fence();
#pragma unroll
    for (int n = 0; n < NA; ++n)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dv = desc(sv[st] + n * TILE_BYTES + kk * 2048, 1024, 1024);
        wgmma_rs(acc[n], phi[kk], dv);
        wgmma_rs(acc[n], plo[kk], dv);
      }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int n = 0; n < NA; ++n) fence_regs(acc[n]);
  }

  // one store: acc / l, with l == 0 (no live key) dividing by 1
  float den[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    den[hr] = l[hr] == 0.f ? 1.f : l[hr];
  }
#pragma unroll
  for (int n = 0; n < NA; ++n)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int hr = (i / 2) % 2;
      const int row = r0 + 8 * hr, col = n * 64 + 8 * (i / 4) + cq;
      if (row < rows && col < p.d) {
        const __nv_bfloat162 x = __floats2bfloat162_rn(acc[n][i] / den[hr], acc[n][i + 1] / den[hr]);
        *reinterpret_cast<__nv_bfloat162*>(ob + row * p.o_ss + col) = x;
      }
    }
}

template <int DMAX>
int launch_dmax(const void* q, const void* k, const void* v, void* o, int batch,
                const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(flash_attention_bf16_kernel<DMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.sq + BQ - 1) / BQ, p.heads, batch);
  flash_attention_bf16_kernel<DMAX><<<grid, NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

template <typename T, int DMAX>
int launch_dmax(const void* q, const void* k, const void* v, void* o, int batch,
                const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, DMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.sq + BQ - 1) / BQ, p.heads, batch);
  flash_attention_kernel<T, DMAX><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int heads,
           int kv_heads, int sq, int sk, int d, const long long* strides, int causal,
           int window, float scale, void* stream_ptr) {
  if (batch <= 0 || heads <= 0 || sq <= 0) return 0;
  Params p;
  p.heads = heads;
  p.rep = heads / kv_heads;
  p.sq = sq;
  p.sk = sk;
  p.d = d;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_ss = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_ss = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_ss = strides[8];
  p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_ss = strides[11];
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if constexpr (std::is_same<T, float>::value) {
    if (d <= 64) return launch_dmax<T, 64>(q, k, v, o, batch, p, stream);
    if (d <= 128) return launch_dmax<T, 128>(q, k, v, o, batch, p, stream);
    return launch_dmax<T, 256>(q, k, v, o, batch, p, stream);
  } else {
    if (d <= 64) return tc::launch_dmax<64>(q, k, v, o, batch, p, stream);
    if (d <= 128) return tc::launch_dmax<128>(q, k, v, o, batch, p, stream);
    return tc::launch_dmax<256>(q, k, v, o, batch, p, stream);
  }
}

}  // namespace

// Plain C entry points, loaded with ctypes.  `strides` holds 12 element
// strides: (batch, head, sequence) of q, k, v and o; the head dim is
// contiguous.  The caller has checked 8 <= d <= 256, d % 8 == 0, 16-byte
// aligned rows, heads % kv_heads == 0, heads and batch <= 65535.  Each returns
// cudaGetLastError() after the launch: 0 when the launch was accepted.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                   int batch, int heads, int kv_heads, int sq, int sk, int d,
                                   const long long* strides, int causal, int window,
                                   float scale, void* stream) {
  return launch<float>(q, k, v, o, batch, heads, kv_heads, sq, sk, d, strides, causal, window,
                       scale, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                    int batch, int heads, int kv_heads, int sq, int sk, int d,
                                    const long long* strides, int causal, int window,
                                    float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, batch, heads, kv_heads, sq, sk, d, strides, causal,
                               window, scale, stream);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
