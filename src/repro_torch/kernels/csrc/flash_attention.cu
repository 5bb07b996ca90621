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
// in no order, so one thread block owns one (batch, q head, q tile) and
// walks its kv tiles (64 keys each) in ascending order in a loop inside the
// block; m and l stay in registers, the accumulator stays in fp32
// registers, and the output is stored once.  No atomics: the result is
// bit-identical from launch to launch.  A kv tile is skipped only when none
// of its (row, column) pairs is live: the live keys of a q tile form the
// contiguous range (q_first - window, q_last], so the loop runs over exactly
// the tiles that meet it.  Ragged Sq and Sk are masked at the edges; strides
// are taken for the batch, head and sequence axes (the head dim is
// contiguous), so `[B, S, H, D]` activations are read and written without a
// transposed copy; offsets are 64-bit.  Blocks are issued last q tile first,
// so the longest causal rows start first.  The head dim selects one of three
// instantiations (D <= 64, 128, 256) that size the shared tiles.  Both
// kernels build the mask only on a tile that crosses an edge (the ragged
// ends, the diagonal, the window's edge; the softmax is compiled for full
// and partial tiles), fold the scale into the one FFMA before ex2.approx in
// log2 units (relative error ~2^-22), and rescale the accumulator only
// where a row max moved.
//
// fp32 (flash_attention_f32, namespace ffma): plain fp32 FFMA, as the Pallas
// kernel's fp32 dots; no TF32 and no tensor cores.  Bound: 4 * D operations
// per live score at 67 TFLOP/s, far above the bytes of q, k, v and o at
// 3.35 TB/s.  What bounds such a kernel is the issue slots around the FFMAs:
// shared-memory reads, the softmax, copies and barriers.  The design:
// - Register tiles for both products, as the GEMM engine of tile_gemm.cuh.
//   In QK^T a thread owns 8 x 8 scores (8 x 4 at D 128, 4 x 4 at D 256), on
//   rows and keys interleaved across the block, and reads Q and K row-major
//   along d as float4 (rows padded by 16 bytes, so a warp's reads fall in
//   distinct banks): 16 reads per 256 FFMA at D <= 64.  In P V it owns 8
//   output rows x 8 columns and reads per key two float4 of P and two of V:
//   4 reads per 64 FFMA.  P goes through shared memory once per tile, its
//   rows permuted so that each output thread's 8 rows are adjacent.
// - Block shapes by head dim (the accumulator lives across the loop beside
//   the scores, so registers and shared memory bind together): D <= 64, 128
//   query rows and 128 threads, two blocks an SM; D 128, 128 rows and 256
//   threads; D 256, 64 rows and 256 threads.  Every block stays within
//   227 KB of shared memory and 255 registers a thread without spills.
// - Copies by cp.async with each thread's addresses worked out once per
//   block, rows past Sk and columns past D zero-filled by the copy's source
//   size (the ragged last V tile must be zeros: 0 * a stale NaN is NaN).
//   One K buffer and one V buffer: V(kt) lands while QK^T(kt) and the
//   softmax run, K(kt + 1) while P V(kt) runs, so a copy is always in
//   flight and D 256 still fits; two barriers per tile.
// - One grid axis with the q tile slowest, so the longest causal rows of
//   every head start before any shorter ones.
// What still holds it back: the softmax, the P round trip and two barriers
// per tile sit between the products with no second consumer to fill them,
// QK^T runs below P V's FFMA rate at the same read ratio, at D 128 and 256
// the narrower score tiles cost more reads per FFMA, and a grid of few q
// tiles (a decode-style suffix) leaves most SMs idle.
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

#include "wgmma.cuh"

namespace {

constexpr int BQ = 64;         // query rows per block of the bf16 kernel
constexpr int BKV = 64;        // keys per kv tile (both kernels)
constexpr float NEG = -1e30f;  // the finite mask sentinel of the Pallas kernel

struct Params {
  int heads, rep, sq, sk, d, causal, window;  // window <= 0: none
  float scale;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
};


// ---------------------------------------------------------------------------
// The bf16 kernel: both products on the tensor cores (wgmma), softmax in fp32.

namespace tc {

constexpr int NT = 128;               // one warpgroup per block: BQ = 64 query rows
constexpr int TILE_BYTES = 64 * 128;  // one 64-row x 64-column bf16 atom (128-byte rows)

// the descriptor, fence / commit / wait, the register fence and the swizzled
// TileCopy (wgmma.cuh), shared with the GEMM engines' TileTC
using namespace wgmma;

// 2^x by the special function unit (relative error ~2^-22; results below
// 2^-126 flush to 0, far below the fp32 sums they join)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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

// ---------------------------------------------------------------------------
// The fp32 kernel: both products in fp32 FFMA from register tiles.

namespace ffma {

// The block shape of one head-dim bucket: BQ query rows against 64-key
// tiles, NT threads.  In QK^T a thread owns SR score rows x SC keys; in P V
// it owns 8 output rows x 8 columns (two float4 groups).  The accumulator
// (64 registers) lives across the whole kv loop beside the SR x SC scores,
// so the wider head dims take fewer rows or narrower score tiles, and shared
// memory (the Q tile, one K tile, one V tile and the P tile) stays within a
// block's 227 KB; D <= 64 fits two blocks an SM.
template <int DMAX> struct Shape;
template <> struct Shape<64> { static constexpr int BQ = 128, NT = 128, SR = 8, SC = 8, MINB = 2; };
template <> struct Shape<128> { static constexpr int BQ = 128, NT = 256, SR = 8, SC = 4, MINB = 1; };
template <> struct Shape<256> { static constexpr int BQ = 64, NT = 256, SR = 4, SC = 4, MINB = 1; };

template <int DMAX>
struct Layout {
  using S = Shape<DMAX>;
  static constexpr int BQ = S::BQ, NT = S::NT, SR = S::SR, SC = S::SC;
  static constexpr int SRG = BQ / SR;    // score row groups: rows sy + SRG i
  static constexpr int SCG = BKV / SC;   // score key groups: keys sx + SCG j
  static constexpr int OR = 8, OC = 8;   // output rows and columns per thread
  static constexpr int ORG = BQ / OR;    // output row groups: rows oy + ORG i
  static constexpr int OCG = DMAX / OC;  // output column groups: columns 4 ox + 4 OCG h + e
  static_assert(SRG * SCG == NT && ORG * OCG == NT, "every thread owns one score and one output tile");
  static_assert(SCG <= 32 && 32 % SCG == 0, "a score row's lanes lie in one warp");
  static_assert(SR * SC <= 64, "the live mask is one 64-bit word");
  // Row strides in floats.  Q and K are read along d as float4 by lanes on
  // consecutive rows: 16 bytes of padding put those rows 4 banks apart.  V
  // is read along its columns by consecutive lanes (no padding), P along
  // its permuted rows (see prow).
  static constexpr int QS = DMAX + 4, KS = DMAX + 4, VS = DMAX, PS = BQ + 4;
  static constexpr int Q_OFF = 0, K_OFF = Q_OFF + BQ * QS, V_OFF = K_OFF + BKV * KS,
                       P_OFF = V_OFF + BKV * VS, A_OFF = P_OFF + BKV * PS, L_OFF = A_OFF + BQ;
  static constexpr size_t smem_bytes = sizeof(float) * (L_OFF + BQ);
  static_assert(smem_bytes <= 232448, "a block takes at most 227 KB of shared memory");
  static_assert(S::MINB * (smem_bytes + 1024) <= 233472, "MINB blocks fit an SM's shared memory");
  // P's column of query row r: each output thread's 8 rows are adjacent, so
  // P V reads them as two float4
  __device__ __forceinline__ static int prow(int r) { return (r % ORG) * OR + r / ORG; }
};

// One thread's share of copying a tile of R rows x DMAX fp32 columns into
// shared memory (row stride STRIDE floats) by 16-byte cp.async: chunk cc =
// t % CH of rows r_t + RSTEP j.  Rows past `rows` and columns past D are
// zero-filled by a source size of 0, so the ragged last kv tile's V rows are
// zeros (p = 0 there, and 0 * a stale NaN would be NaN).  The addresses are
// worked out once per block.
template <int DMAX, int NT, int STRIDE>
struct TileCopy {
  static constexpr int CH = DMAX / 4, RSTEP = NT / CH;
  static_assert(NT % CH == 0, "whole rows per pass");
  int r_t, goff;   // the thread's first row, and its column
  bool col_ok;
  uint32_t soff;   // byte offset of the thread's first chunk in the tile

  __device__ __forceinline__ explicit TileCopy(int D) {
    const int cc = threadIdx.x % CH;
    r_t = threadIdx.x / CH;
    goff = cc * 4;
    col_ok = goff < D;
    soff = static_cast<uint32_t>((r_t * STRIDE + goff) * 4);
  }

  // src: row 0, column 0 of the tile in global memory
  template <int R>
  __device__ __forceinline__ void copy(const float* src, long long row_stride, int rows,
                                       uint32_t dst) const {
    static_assert(R % RSTEP == 0, "whole passes per tile");
    const float* g = src + r_t * row_stride + goff;
    const long long step = RSTEP * row_stride;
#pragma unroll
    for (int j = 0; j < R / RSTEP; ++j) {
      const bool ok = col_ok && r_t + RSTEP * j < rows;
      tc::cp_async16(dst + soff + j * RSTEP * STRIDE * 4, ok ? g : src, ok);
      g += step;
    }
  }
};

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// The online-softmax step of one tile for the score thread (sx, sy): s holds
// its raw scores, rows sy + SRG i and keys sx + SCG j.  Scores are scaled by
// sl2 (the softmax scale in log2 units, so that exp2 serves) in the one FFMA
// before ex2; masked pairs (a clear bit of `live`; FULL: none) count as
// -1e30 in the max and give p = 0.  m and this thread's share of l take the
// rescale alpha, which lane sx == 0 leaves in `alpha_s` for the output
// threads; p goes to the P tile, as float4 of four rows where the score
// thread's rows are an output thread's (D <= 128).
template <int DMAX, bool FULL>
__device__ __forceinline__ void softmax_tile(float (&s)[Layout<DMAX>::SR][Layout<DMAX>::SC],
                                             unsigned long long live, float sl2, int sx, int sy,
                                             float (&m)[Layout<DMAX>::SR], float (&l)[Layout<DMAX>::SR],
                                             float* __restrict__ Ps, float* __restrict__ alpha_s) {
  using L = Layout<DMAX>;
#pragma unroll
  for (int i = 0; i < L::SR; ++i) {
    float mx = NEG;  // the row max of the raw scores
#pragma unroll
    for (int j = 0; j < L::SC; ++j)
      mx = fmaxf(mx, FULL || (live >> (i * L::SC + j)) & 1ull ? s[i][j] : NEG);
#pragma unroll
    for (int off = L::SCG / 2; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    // sl2 > 0, so the max of the scaled scores is the scaled max; a row with
    // no live pair in this tile keeps the sentinel
    const float m_new = fmaxf(m[i], mx == NEG ? NEG : mx * sl2);
    const float alpha = tc::exp2_approx(m[i] - m_new);
    m[i] = m_new;
    l[i] *= alpha;
    if (sx == 0) alpha_s[sy + L::SRG * i] = alpha;
#pragma unroll
    for (int j = 0; j < L::SC; ++j) {
      const float x = tc::exp2_approx(fmaf(s[i][j], sl2, -m_new));
      s[i][j] = FULL || (live >> (i * L::SC + j)) & 1ull ? x : 0.f;
      l[i] += s[i][j];
    }
  }
  if constexpr (L::SRG == L::ORG && L::SR == L::OR) {
    // prow(sy + SRG i) = 8 sy + i: the thread's rows are adjacent in P
#pragma unroll
    for (int j = 0; j < L::SC; ++j)
#pragma unroll
      for (int i = 0; i < L::SR; i += 4)
        *reinterpret_cast<float4*>(Ps + (sx + L::SCG * j) * L::PS + 8 * sy + i) =
            make_float4(s[i][j], s[i + 1][j], s[i + 2][j], s[i + 3][j]);
  } else {
#pragma unroll
    for (int i = 0; i < L::SR; ++i)
#pragma unroll
      for (int j = 0; j < L::SC; ++j) Ps[(sx + L::SCG * j) * L::PS + L::prow(sy + L::SRG * i)] = s[i][j];
  }
}

// s += Q K^T over d .. d + 3 for the score thread's rows (qrow: Q row sy)
// and keys (krow: K row sx): SR + SC float4 reads feed 4 SR SC FFMA, one d
// at a time over the whole tile (each score still sums d in order)
template <int DMAX>
__device__ __forceinline__ void qk_step(const float* qrow, const float* krow, int d,
                                        float (&s)[Layout<DMAX>::SR][Layout<DMAX>::SC]) {
  using L = Layout<DMAX>;
  float4 a[L::SR], c[L::SC];
#pragma unroll
  for (int i = 0; i < L::SR; ++i) a[i] = *reinterpret_cast<const float4*>(qrow + i * L::SRG * L::QS + d);
#pragma unroll
  for (int j = 0; j < L::SC; ++j) c[j] = *reinterpret_cast<const float4*>(krow + j * L::SCG * L::KS + d);
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int i = 0; i < L::SR; ++i)
#pragma unroll
      for (int j = 0; j < L::SC; ++j) {
        const float ae = e == 0 ? a[i].x : e == 1 ? a[i].y : e == 2 ? a[i].z : a[i].w;
        const float ce = e == 0 ? c[j].x : e == 1 ? c[j].y : e == 2 ? c[j].z : c[j].w;
        s[i][j] = fmaf(ae, ce, s[i][j]);
      }
}

template <int DMAX>
__global__ void __launch_bounds__(Shape<DMAX>::NT, Shape<DMAX>::MINB)
flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o, Params p) {
  using L = Layout<DMAX>;
  constexpr int BQ = L::BQ, SR = L::SR, SC = L::SC, SRG = L::SRG, SCG = L::SCG;
  constexpr int ORG = L::ORG, OCG = L::OCG;
  extern __shared__ float4 smem4[];
  float* const sm = reinterpret_cast<float*>(smem4);
  const float* Qs = sm + L::Q_OFF;  // [BQ][QS]
  const float* Ks = sm + L::K_OFF;  // [BKV][KS]
  const float* Vs = sm + L::V_OFF;  // [BKV][VS]
  float* Ps = sm + L::P_OFF;        // [BKV][PS]: p of key c and query row r at c * PS + prow(r)
  float* alpha_s = sm + L::A_OFF;   // [BQ]: this tile's rescale of each row
  float* l_s = sm + L::L_OFF;       // [BQ]: each row's sum, at the end
  const uint32_t q_dst = tc::smem_u32(Qs), k_dst = tc::smem_u32(Ks), v_dst = tc::smem_u32(Vs);

  // one grid axis, the q tile slowest and the last q tile first: every
  // head's longest causal rows start before any shorter ones
  const int nq = (p.sq + BQ - 1) / BQ;
  const int per_tile = gridDim.x / nq;  // heads x batch
  const int iq = nq - 1 - static_cast<int>(blockIdx.x) / per_tile;
  const int h = static_cast<int>(blockIdx.x) % per_tile % p.heads;
  const int b = static_cast<int>(blockIdx.x) % per_tile / p.heads;
  const int hk = h / p.rep;
  const int q0 = iq * BQ;
  const int rows = min(BQ, p.sq - q0);
  const int tid = threadIdx.x;
  const int sx = tid % SCG, sy = tid / SCG;  // score tile
  const int ox = tid % OCG, oy = tid / OCG;  // output tile
  const int D = p.d;

  const float* qb = q + b * p.q_sb + h * p.q_sh + q0 * p.q_ss;
  const float* kb = k + b * p.k_sb + hk * p.k_sh;
  const float* vb = v + b * p.v_sb + hk * p.v_sh;
  float* ob = o + b * p.o_sb + h * p.o_sh + q0 * p.o_ss;

  // the kv tiles that hold a live (row, key) pair, as in the bf16 kernel
  const long long q_first = static_cast<long long>(q0) + p.sk - p.sq;  // position of row 0
  const long long q_last = q_first + rows - 1;
  const int nkv = (p.sk + BKV - 1) / BKV;
  int kt_begin = 0, kt_end = nkv;
  if (p.causal) kt_end = q_last < 0 ? 0 : static_cast<int>(min(static_cast<long long>(nkv), q_last / BKV + 1));
  if (p.window > 0) {
    const long long lowest = q_first - p.window + 1;
    if (lowest > 0) kt_begin = static_cast<int>(min(static_cast<long long>(nkv), lowest / BKV));
  }

  const float sl2 = p.scale * 1.4426950408889634f;  // the scale in log2 units
  float m[SR], l[SR];  // per score row; l is this thread's share of the row sum
#pragma unroll
  for (int i = 0; i < SR; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
  }
  float acc[8][8];  // output rows oy + ORG i, columns 4 ox + 4 OCG (j / 4) + j % 4
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const TileCopy<DMAX, L::NT, L::QS> qk_copy(D);  // Q and K share a row stride
  const TileCopy<DMAX, L::NT, L::VS> v_copy(D);
  if (kt_begin < kt_end) {
    qk_copy.template copy<BQ>(qb, p.q_ss, rows, q_dst);
    qk_copy.template copy<BKV>(kb + kt_begin * BKV * p.k_ss, p.k_ss, p.sk - kt_begin * BKV, k_dst);
    commit();
  }
  // One K buffer and one V buffer, each refilled while the other operand is
  // multiplied: V(kt) lands during QK^T(kt) and the softmax, K(kt + 1)
  // during P V(kt).  Two barriers per tile.
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BKV;
    const int kv_rows = min(BKV, p.sk - k0);
    wait_all();       // K(kt) (and Q) has landed: own copies ...
    __syncthreads();  // ... and everyone's; P V(kt - 1) is done with V, P and alpha
    v_copy.template copy<BKV>(vb + k0 * p.v_ss, p.v_ss, kv_rows, v_dst);
    commit();

    // S = Q K^T over d, fp32 FFMA; unrolled whole when D fills the bucket
    float s[SR][SC];
#pragma unroll
    for (int i = 0; i < SR; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) s[i][j] = 0.f;
    const float* qrow = Qs + sy * L::QS;
    const float* krow = Ks + sx * L::KS;
    if (D == DMAX) {
#pragma unroll
      for (int d = 0; d < DMAX; d += 4) qk_step<DMAX>(qrow, krow, d, s);
    } else {
#pragma unroll 2
      for (int d = 0; d < D; d += 4) qk_step<DMAX>(qrow, krow, d, s);
    }

    // the mask is needed only on a tile that crosses an edge, the diagonal
    // or the window's edge (uniform across the block)
    const bool full = rows == BQ && kv_rows == BKV && (!p.causal || k0 + BKV - 1 <= q_first) &&
                      (p.window <= 0 || k0 > q_last - p.window);
    if (full) {
      softmax_tile<DMAX, true>(s, 0ull, sl2, sx, sy, m, l, Ps, alpha_s);
    } else {
      unsigned long long live = 0;         // bit i SC + j: s[i][j] is a live pair
      const long long rel = q_first - k0;  // qpos - kpos = rel + row - col
#pragma unroll
      for (int i = 0; i < SR; ++i)
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          const int row = sy + SRG * i, col = sx + SCG * j;
          const long long diff = rel + row - col;
          bool ok = row < rows && col < kv_rows;
          if (p.causal) ok = ok && diff >= 0;
          if (p.window > 0) ok = ok && diff < p.window;
          live |= static_cast<unsigned long long>(ok) << (i * SC + j);
        }
      softmax_tile<DMAX, false>(s, live, sl2, sx, sy, m, l, Ps, alpha_s);
    }

    wait_all();       // V(kt) has landed: own copies ...
    __syncthreads();  // ... and everyone's, with P and alpha; K is free
    if (kt + 1 < kt_end) {
      const int k1 = k0 + BKV;
      qk_copy.template copy<BKV>(kb + k1 * p.k_ss, p.k_ss, p.sk - k1, k_dst);
      commit();
    }

    // rescale the accumulator where a row max moved (alpha == 1 elsewhere;
    // once the maxima settle this is skipped)
    float alpha[8];
    bool moved = false;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      alpha[i] = alpha_s[oy + ORG * i];
      moved |= alpha[i] != 1.f;
    }
    if (moved) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] *= alpha[i];
    }

    // acc += P V over the tile's keys, fp32 FFMA: per key, four float4
    // reads feed 64 FFMA (masked keys have p = 0 and V rows of zeros)
    const float* pk = Ps + oy * 8;
    const float* vk = Vs + 4 * ox;
#pragma unroll 8
    for (int c = 0; c < BKV; ++c) {
      const float4 p0 = *reinterpret_cast<const float4*>(pk + c * L::PS);
      const float4 p1 = *reinterpret_cast<const float4*>(pk + c * L::PS + 4);
      const float4 v0 = *reinterpret_cast<const float4*>(vk + c * L::VS);
      const float4 v1 = *reinterpret_cast<const float4*>(vk + c * L::VS + 4 * OCG);
      const float pr[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      const float vr[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(pr[i], vr[j], acc[i][j]);
    }
  }

  // the row sums: this thread's shares over the row's SCG lanes
#pragma unroll
  for (int i = 0; i < SR; ++i) {
#pragma unroll
    for (int off = SCG / 2; off > 0; off >>= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    if (sx == 0) l_s[sy + SRG * i] = l[i];
  }
  __syncthreads();

  // one store: acc / l, with l == 0 (no live key) dividing by 1; scalar
  // stores, so that no accumulator quad is tied to aligned registers
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = oy + ORG * i;
    if (row >= rows) continue;
    const float den = l_s[row] == 0.f ? 1.f : l_s[row];
    float* dst = ob + row * p.o_ss;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 4 * ox + 4 * OCG * (j / 4) + j % 4;
      if (col < D) dst[col] = acc[i][j] / den;
    }
  }
}

template <int DMAX>
int launch_dmax(const float* q, const float* k, const float* v, float* o, int batch,
                const Params& p, cudaStream_t stream) {
  using L = Layout<DMAX>;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_f32_kernel<DMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((p.sq + L::BQ - 1) / L::BQ) * p.heads * batch;
  flash_attention_f32_kernel<DMAX><<<grid, L::NT, L::smem_bytes, stream>>>(q, k, v, o, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ffma

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
    const float* qf = static_cast<const float*>(q);
    const float* kf = static_cast<const float*>(k);
    const float* vf = static_cast<const float*>(v);
    float* of = static_cast<float*>(o);
    if (d <= 64) return ffma::launch_dmax<64>(qf, kf, vf, of, batch, p, stream);
    if (d <= 128) return ffma::launch_dmax<128>(qf, kf, vf, of, batch, p, stream);
    return ffma::launch_dmax<256>(qf, kf, vf, of, batch, p, stream);
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
