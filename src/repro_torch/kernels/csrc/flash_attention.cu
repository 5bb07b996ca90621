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
// walks its kv tiles (64 keys; 128 in bf16 up to D 128) in ascending order
// in a loop inside the block; m and l stay in registers, the accumulator
// stays in fp32 registers, and the output is stored once.  No atomics: the
// result is bit-identical from launch to launch.  A kv tile is skipped only
// when none of its (row, column) pairs is live: the live keys of a q tile
// form the contiguous range (q_first - window, q_last], so the loop runs over
// exactly the tiles that meet it.  Ragged Sq and Sk are masked at the edges;
// strides are taken for the batch, head and sequence axes (the head dim is
// contiguous), so `[B, S, H, D]` activations are read and written without a
// transposed copy; offsets are 64-bit.  Blocks are issued last q tile first,
// so the longest causal rows start first.  The head dim selects an
// instantiation that sizes the shared tiles (fp32: D <= 64, 128, 256; bf16:
// also 112).  Both kernels build the mask only on a tile that crosses an
// edge (the ragged ends, the diagonal, the window's edge; the softmax is
// compiled for full and partial tiles), fold the scale into the one FFMA
// before ex2.approx in log2 units (relative error ~2^-22), and rescale the
// accumulator only where a row max moved.
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
// tensor cores with fp32 accumulation, at the Pallas kernel's precision, in
// the shape of a Hopper kernel: TMA, a producer and two consumer warpgroups.
// - S = Q K^T: the products of bf16 values are exact in fp32, as in the
//   Pallas kernel's fp32 dot of upcast bf16.  wgmma with Q and K in shared
//   memory, m64n128k16 over 128-key tiles (m64n64k16 over 64-key tiles at D
//   256, where the accumulator and a wider score tile would not fit).
// - The mask, scale and online softmax run in fp32 registers on the
//   accumulator fragment (-inf on pairs that are not live, so the finite
//   -1e30 start of m never meets exp(-inf + inf); the safe divide), in log2
//   units for exp2.
// - P V with P split in two: p_hi = bf16(p), p_lo = bf16(p - p_hi), and
//   acc += p_hi V + p_lo V, two wgmma products with P taken from registers
//   (the accumulator fragment repacked as the A operand: no shared-memory
//   round trip) and V in shared memory as the transposed B operand.  Each
//   product of bf16 values is exact, and |p - p_hi - p_lo| <= 2^-16 p, so the
//   output moves by at most 2^-16 max|v|.  A single bf16 P would not do: it
//   moves the output by up to 2^-8 max|v|.  One wgmma spans the bucket's
//   output columns across 64-column atoms (the atom stride is the leading
//   offset), so D 112 computes 112 columns, not 128.
// - A work item is 128 query rows of one (batch, head).  A persistent block
//   (one an SM) walks items, dealt round by round in alternating directions
//   so that long and short causal items even out; at D 256 a block takes one
//   item (the loop's state would spill).  In a block: a producer warpgroup
//   whose first thread loads each item's Q, once the previous Q is read, and
//   the K and V tiles of its live range by TMA (tensor maps over (D, S,
//   head, batch) built at each launch from the strides; the 128-byte swizzle
//   wgmma reads; zeros past Sk and D) into a ring of 2-4 stages that runs
//   across items, each stage with a full barrier armed with its bytes and an
//   empty one the consumers release; and two consumer warpgroups of 64 rows
//   that share every stage.  So an item's loads run under the previous
//   item's tail and store.  setmaxnreg moves registers to the consumers (24
//   for the producer, 240 each).  They ping-pong on two named barriers: one
//   issues its products while the other runs its softmax.  Within a
//   consumer, S(j) is issued with P(j - 1) V, and the softmax of tile j runs
//   while that product does (wgmma.wait_group 1).
// - Head-dim buckets 64, 112 (D 72-112: 7 k16 steps of QK^T, N 112 in P V),
//   128 and 256.  The bucket's k16 steps run whatever D (the columns past D
//   are TMA's zeros): a step count known only at run time makes ptxas
//   serialise every wgmma of the kernel (C7515).
// - Kept from the earlier design: only the kv tiles of the live range, the
//   last q tile first (the items' order), the mask only on tiles that cross
//   an edge (the softmax compiled for full and partial tiles), the scale
//   folded into one FFMA before ex2, the accumulator rescaled only where a
//   row max moved, one bf16 store (acc times 1 / l).
// Bound: three products of 2 * D operations per live score at 989 TFLOP/s
// (QK^T, p_hi V, p_lo V); the bytes of q, k, v and o at 3.35 TB/s are far
// below it.  What holds it back (PERF.md, a clock64 profile of the kv loop,
// benchmarks/torch_flash_profile.py): each consumer's softmax and split of P
// take longer than the other consumer's products, so the tensor cores wait
// on them, most at D 64; and the issue of an iteration's wgmma stalls behind
// the other consumer's products.  At D 256 two 64 KB stages wait on L2.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "wgmma.cuh"

namespace {

constexpr int BKV = 64;        // keys per kv tile of the fp32 kernel
constexpr float NEG = -1e30f;  // the finite mask sentinel of the Pallas kernel

struct Params {
  int heads, rep, sq, sk, d, causal, window;  // window <= 0: none
  float scale;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
};


// ---------------------------------------------------------------------------
// The bf16 kernel: both products on the tensor cores (wgmma), softmax in fp32.

namespace tc {

// the descriptor, fence / commit, the register fence, mbarriers and TMA
// (wgmma.cuh), shared with the GEMM engines' TileTC
using namespace wgmma;

constexpr int PRODUCER_REGS = 24;  // setmaxnreg of the producer warpgroup

// 2^x by the special function unit (relative error ~2^-22; results below
// 2^-126 flush to 0, far below the fp32 sums they join)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// named barriers 1 and 2 (0 is __syncthreads'), 256 threads: the two consumers
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// d (+)= A @ B, m64n64k16: A [64, 16] and B [64, 16] both K-major in shared
// memory (S = Q K^T: q rows and k rows along d), fp32 accumulate; d is
// zeroed first where `accumulate` is 0
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
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

// d (+)= A @ B, m64n128k16: A [64, 16] and B [128, 16] both K-major in shared
// memory (S = Q K^T: q rows and k rows along d), fp32 accumulate; d is
// zeroed first where `accumulate` is 0
__device__ __forceinline__ void mma_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d += A @ B, m64n64k16: A from registers (the m16n8k16 A fragment per
// warp), B [16, 64] N-major in shared memory (imm-trans-b 1), fp32 accumulate
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
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

// d += A @ B, m64n112k16: A from registers (the m16n8k16 A fragment per
// warp), B [16, 112] N-major in shared memory (imm-trans-b 1), fp32 accumulate
__device__ __forceinline__ void mma_rs(float (&d)[56], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
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
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d += A @ B, m64n128k16: A from registers (the m16n8k16 A fragment per
// warp), B [16, 128] N-major in shared memory (imm-trans-b 1), fp32 accumulate
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d += A @ B, m64n256k16: A from registers (the m16n8k16 A fragment per
// warp), B [16, 256] N-major in shared memory (imm-trans-b 1), fp32 accumulate
__device__ __forceinline__ void mma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}


// One head-dim bucket: DN output columns (the N of the P V wgmma: no column
// past the bucket is computed), NA 64-column atoms a row of Q, K and V
// occupies in shared memory (TMA zero-fills the columns past D), BKV keys a
// kv tile (the N of QK^T), STAGES K/V stages in the ring.
template <int DMAX> struct Bucket;
template <> struct Bucket<64> { static constexpr int DN = 64, NA = 1, BKV = 128; };
template <> struct Bucket<112> { static constexpr int DN = 112, NA = 2, BKV = 128; };
template <> struct Bucket<128> { static constexpr int DN = 128, NA = 2, BKV = 128; };
template <> struct Bucket<256> { static constexpr int DN = 256, NA = 4, BKV = 64; };

template <int DMAX>
struct Layout {
  using B = Bucket<DMAX>;
  static constexpr int DN = B::DN, NA = B::NA, BKV = B::BKV;
  static constexpr int NC = 2;              // consumer warpgroups
  // a block walks items until they run out (one block an SM), except at D
  // 256: the accumulator leaves no registers for the state such a loop
  // carries (ptxas spilled 40 bytes), so a block takes one item there
  static constexpr bool PERSISTENT = DMAX != 256;
  static constexpr int BQ = 64 * NC;        // query rows per block: 64 per consumer
  static constexpr int NT = 128 * (NC + 1);  // the producer warpgroup, then the consumers
  // setmaxnreg of a consumer: all the registers the producer leaves
  static constexpr int CONSUMER_REGS = (65536 / 128 - PRODUCER_REGS) / NC / 8 * 8;
  static constexpr int QK_STEPS = (DMAX + 15) / 16;  // k16 steps of QK^T at D = DMAX
  static constexpr int Q_BYTES = NC * NA * ATOM_BYTES;  // each consumer's 64 rows
  static constexpr int KV_ATOM = BKV * 128;            // one 64-column box of a kv tile
  static constexpr int STAGE_BYTES = 2 * NA * KV_ATOM; // K, then V
  // as many stages as shared memory holds, at most 4
  static constexpr int STAGES = (232448 - 1024 - 256 - Q_BYTES) / STAGE_BYTES < 4
                                    ? (232448 - 1024 - 256 - Q_BYTES) / STAGE_BYTES : 4;
  // Q, the ring, then the barriers: Q's full and empty, a full and an empty one a stage
  static constexpr int BAR_OFF = Q_BYTES + STAGES * STAGE_BYTES;
  static constexpr size_t smem_bytes = 1024 + BAR_OFF + 8 * (2 + 2 * STAGES);
  static_assert(smem_bytes <= 232448, "a block takes at most 227 KB of shared memory");
  static_assert(BKV % 16 == 0 && DN % 8 == 0 && DN <= 64 * NA, "wgmma shapes");
};

// The online-softmax step on one 64-row score tile held as the wgmma
// accumulator fragment s: s[4j + e] is (row r0, key 8j + cq + e) and
// s[4j + 2 + e] is (row r0 + 8, the same key).  Masked pairs hold -inf, so
// they leave the row max alone and give p = 0.  Scores are scaled by sl2
// (the softmax scale in log2 units) in the one FMA before ex2; m and this
// thread's share of l take the rescale alpha, and s is overwritten by p.
template <int NS>
__device__ __forceinline__ void softmax_tile(float (&s)[NS], float sl2, float (&m)[2],
                                             float (&l)[2], float (&alpha)[2]) {
  float mx[2] = {-INFINITY, -INFINITY};  // the row max of the raw scores
#pragma unroll
  for (int i = 0; i < NS; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
  float neg_m[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
    // sl2 > 0, so the max of the scaled scores is the scaled max; a row with
    // no live pair in this tile (mx = -inf) keeps m, and m starts at the
    // finite sentinel, so alpha is never exp(-inf + inf)
    const float m_new = fmaxf(m[hr], mx[hr] * sl2);
    alpha[hr] = exp2_approx(m[hr] - m_new);
    m[hr] = m_new;
    l[hr] *= alpha[hr];
    neg_m[hr] = -m_new;
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    s[i] = exp2_approx(fmaf(s[i], sl2, neg_m[(i / 2) % 2]));
    l[(i / 2) % 2] += s[i];
  }
}

// p split into bf16 A fragments for the two P V products, p_hi = bf16(p) and
// p_lo = bf16(p - p_hi), straight from the accumulator fragment: keys 16kk
// .. 16kk + 15 are s[8kk .. 8kk + 7], as a0 (r0, low keys), a1 (r0 + 8, low
// keys), a2 (r0, keys + 8), a3 (r0 + 8, keys + 8)
template <int NS>
__device__ __forceinline__ void split_p(const float (&s)[NS], uint32_t (&phi)[NS / 8][4],
                                        uint32_t (&plo)[NS / 8][4]) {
#pragma unroll
  for (int i = 0; i < NS; i += 2) {
    const __nv_bfloat162 hi = __floats2bfloat162_rn(s[i], s[i + 1]);
    const uint32_t h = *reinterpret_cast<const uint32_t*>(&hi);
    // hi back in fp32: a bf16 is the upper half of its fp32 (one op each)
    const float2 hf = make_float2(__uint_as_float(h << 16), __uint_as_float(h & 0xffff0000u));
    const __nv_bfloat162 lo = __floats2bfloat162_rn(s[i] - hf.x, s[i + 1] - hf.y);
    phi[i / 8][(i % 8) / 2] = h;
    plo[i / 8][(i % 8) / 2] = *reinterpret_cast<const uint32_t*>(&lo);
  }
}

// S = Q K^T of one kv tile into s: A = the consumer's q rows at qa, B = the
// k tile at kb, both K-major; the kk-th 16 columns of d lie 32 bytes into
// atom kk / 4.  The bucket's QK_STEPS k16 steps, whatever D (columns past D
// are zeros): a step count known only at run time makes ptxas serialise
// every wgmma of the kernel (C7515).
template <int DMAX>
__device__ __forceinline__ void issue_qk(float (&s)[Layout<DMAX>::BKV / 2], uint32_t qa, uint32_t kb) {
  using L = Layout<DMAX>;
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < L::QK_STEPS; ++kk)
    mma_ss(s, desc(qa + (kk / 4) * ATOM_BYTES + (kk % 4) * 32, 16, 1024),
           desc(kb + (kk / 4) * L::KV_ATOM + (kk % 4) * 32, 16, 1024), kk > 0);
  wgmma_commit();
}

// acc += p_hi V + p_lo V of one kv tile: V at vb is the N-major B operand,
// keys 16kk .. 16kk + 15 2048 bytes (two 8-row groups) apart; one wgmma
// spans the DN columns' atoms, their stride the leading offset
template <int DMAX>
__device__ __forceinline__ void issue_pv(float (&acc)[Layout<DMAX>::DN / 2],
                                         uint32_t (&phi)[Layout<DMAX>::BKV / 16][4],
                                         uint32_t (&plo)[Layout<DMAX>::BKV / 16][4], uint32_t vb) {
  using L = Layout<DMAX>;
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < L::BKV / 16; ++kk) {
    const uint64_t dv = desc(vb + kk * 2048, L::KV_ATOM, 1024);
    mma_rs(acc, phi[kk], dv);
    mma_rs(acc, plo[kk], dv);
  }
  wgmma_commit();
}

// rescale the accumulator where a row max moved (alpha == 1 elsewhere; once
// the maxima settle this is skipped)
template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N], const float (&alpha)[2]) {
  if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] *= alpha[(i / 2) % 2];
  }
}

// -inf on the pairs of a score tile that are not live: rows past `rows`,
// keys past kv_rows, and where causal or the window excludes them (qpos -
// kpos = rel + row - col)
template <int NS>
__device__ __forceinline__ void mask_tile(float (&s)[NS], int r0, int cq, int rows, int kv_rows,
                                          long long rel, int causal, int window) {
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int row = r0 + 8 * ((i / 2) % 2), col = 8 * (i / 4) + cq + (i % 2);
    const long long diff = rel + row - col;
    bool ok = row < rows && col < kv_rows;
    if (causal) ok = ok && diff >= 0;
    if (window > 0) ok = ok && diff < window;
    if (!ok) s[i] = -INFINITY;
  }
}

// The softmax of kv tile kt for one consumer's rows (w_first: the position
// of its row 0), after the mask where the tile crosses an edge (the ragged
// ends, the diagonal, the window's edge; uniform across the warpgroup, so the
// softmax is compiled for full and partial tiles)
template <int DMAX>
__device__ __forceinline__ void softmax_kv(float (&s)[Layout<DMAX>::BKV / 2], int kt, const Params& p,
                                           int r0, int cq, int rows, long long w_first, float sl2,
                                           float (&m)[2], float (&l)[2], float (&alpha)[2]) {
  constexpr int BKV = Layout<DMAX>::BKV;
  const int k0 = kt * BKV;
  const int kv_rows = min(BKV, p.sk - k0);
  const bool full = rows == 64 && kv_rows == BKV && (!p.causal || k0 + BKV - 1 <= w_first) &&
                    (p.window <= 0 || k0 > w_first + 63 - p.window);
  if (!full) mask_tile(s, r0, cq, rows, kv_rows, w_first - k0, p.causal, p.window);
  softmax_tile(s, sl2, m, l, alpha);
}

#ifdef FLASH_PROFILE
// A build with -DFLASH_PROFILE=<block> records, in block <block>, the SM
// clock at eight points of each kv-loop iteration (the first 64) of the first
// warp of each consumer (benchmarks/torch_flash_profile.py reads it).
__device__ long long flash_profile[2][64][8];
#define PROFILE_MARK(k) \
  if (profiled && lane == 0 && warp == 0 && j < 64) flash_profile[c][j][k] = clock64();
#else
#define PROFILE_MARK(k)
#endif

// One work item: a q tile of BQ rows of one (batch, q head), and the kv
// tiles [kt_begin, kt_begin + n) of its live range.  Items are numbered with
// the q tile slowest and the last q tile first, so that every head's longest
// causal rows come before any shorter ones and the q heads of one kv head sit
// side by side.
template <int DMAX>
struct Item {
  int q0, h, b, hk, kt_begin, n;

  __device__ __forceinline__ Item(int t, int tiles, const Params& p) {
    using L = Layout<DMAX>;
    const int nq = (p.sq + L::BQ - 1) / L::BQ;
    const int per_tile = tiles / nq;  // heads x batch
    q0 = (nq - 1 - t / per_tile) * L::BQ;
    h = t % per_tile % p.heads;
    b = t % per_tile / p.heads;
    hk = h / p.rep;
    // the kv tiles that hold a live (row, key) pair of the tile's rows
    const long long q_first = static_cast<long long>(q0) + p.sk - p.sq;
    const long long q_last = q_first + min(L::BQ, p.sq - q0) - 1;
    const int nkv = (p.sk + L::BKV - 1) / L::BKV;
    int end = nkv;
    kt_begin = 0;
    if (p.causal) end = q_last < 0 ? 0 : static_cast<int>(min(static_cast<long long>(nkv), q_last / L::BKV + 1));
    if (p.window > 0) {
      const long long lowest = q_first - p.window + 1;
      if (lowest > 0) kt_begin = static_cast<int>(min(static_cast<long long>(nkv), lowest / L::BKV));
    }
    n = max(end - kt_begin, 0);
  }
};

// The item of round r for block g of G: rounds of G items in order, dealt
// to the blocks in alternating directions (g, then G - 1 - g), so that the
// long and the short causal tiles even out over the rounds; -1 past the end.
__device__ __forceinline__ int item_of(int r, int g, int G, int tiles) {
  const int t = r * G + ((r & 1) ? G - 1 - g : g);
  return t < tiles ? t : -1;
}

// A persistent block (one an SM): a producer warpgroup, whose first thread
// loads each item's Q once its previous Q is read and the kv tiles of its
// live range by TMA into a ring of STAGES stages that runs across items (a
// full barrier armed with the stage's bytes, an empty one the 8 consumer
// warps release), and two consumer warpgroups, each owning 64 query rows of
// the item's 128 and sharing every stage.  The next item's Q and first kv
// tiles load while this item's last products, softmax and store run.
template <int DMAX>
__global__ void __launch_bounds__(Layout<DMAX>::NT, 1)
flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                            Params p, int tiles) {
  using L = Layout<DMAX>;
  constexpr int NA = L::NA, NC = L::NC, BKV = L::BKV, STAGES = L::STAGES, DN = L::DN;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base, ring = base + L::Q_BYTES;
  const uint32_t q_full = base + L::BAR_OFF, q_empty = q_full + 8, full = q_empty + 8,
                 empty = full + 8 * STAGES;
  const int g = blockIdx.x, G = gridDim.x;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 4 * NC);  // one arrival a consumer warp
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * NC);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- the producer: its first thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x != 0) return;
    int it = 0, qi = 0;  // kv tiles and Q tiles loaded so far
    for (int r = 0, t; (t = item_of(r, g, G, tiles)) >= 0; ++r) {
      const Item<DMAX> w(t, tiles, p);
      if (w.n == 0) continue;
      // Q's buffer is free once the previous item's last S = Q K^T is done
      if (qi > 0) mbar_wait(q_empty, (qi - 1) & 1);
      ++qi;
      mbar_arrive_expect_tx(q_full, L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int a = 0; a < NA; ++a)
          tma_load_4d(sq + (c * NA + a) * ATOM_BYTES, &tq, 64 * a, w.q0 + 64 * c, w.h, w.b, q_full);
      for (int j = 0; j < w.n; ++j, ++it) {
        const int s = it % STAGES;
        // the stage is free once its previous tile is released
        if (it >= STAGES) mbar_wait(empty + 8 * s, (it / STAGES - 1) & 1);
        const uint32_t st = ring + s * L::STAGE_BYTES, bar = full + 8 * s;
        const int k0 = (w.kt_begin + j) * BKV;
        // the full boxes' bytes, the zero-filled parts past Sk and D included
        mbar_arrive_expect_tx(bar, L::STAGE_BYTES);
#pragma unroll
        for (int a = 0; a < NA; ++a) tma_load_4d(st + a * L::KV_ATOM, &tk, 64 * a, k0, w.hk, w.b, bar);
#pragma unroll
        for (int a = 0; a < NA; ++a)
          tma_load_4d(st + (NA + a) * L::KV_ATOM, &tv, 64 * a, k0, w.hk, w.b, bar);
      }
      if (!L::PERSISTENT) break;
    }
  } else {
    // ---- a consumer: rows 64 c .. 64 c + 63 of each item
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(L::CONSUMER_REGS));
    const int c = wg - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int r0 = 16 * warp + lane / 4;  // this thread's rows r0 and r0 + 8
    const int cq = 2 * (lane % 4);        // and keys / columns 8j + cq, 8j + cq + 1
    const uint32_t qa = sq + c * NA * ATOM_BYTES;
    const float sl2 = p.scale * 1.4426950408889634f;  // the scale in log2 units
    float s[BKV / 2];
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) s[i] = 0.f;
    uint32_t phi[BKV / 16][4], plo[BKV / 16][4];
    float acc[DN / 2];
    int it = 0, qi = 0;  // kv tiles and Q tiles consumed so far

    for (int r = 0, t; (t = item_of(r, g, G, tiles)) >= 0; ++r) {
      const Item<DMAX> w(t, tiles, p);
      const int row0 = w.q0 + 64 * c;
      const int rows = min(64, p.sq - row0);  // <= 0: a ragged tile's empty half
      const long long w_first = static_cast<long long>(row0) + p.sk - p.sq;  // position of row 0
      const int n = w.n;
      float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, alpha[2] = {1.f, 1.f};
#pragma unroll
      for (int i = 0; i < DN / 2; ++i) acc[i] = 0.f;

      // Ping-pong: consumer c issues its products between bar_sync(1 + c)
      // and bar_arrive on the next consumer's barrier, so the two take turns
      // on the tensor cores and one's softmax runs while the other's products
      // do.  Consumer 0 goes first.  Each issues n + 1 times an item and syncs
      // as often; the last consumer leaves out the arrival after its last
      // issue, which no sync would consume.
      if (n > 0) {
        if (c == NC - 1) bar_arrive(1);
        mbar_wait(q_full, qi & 1);
        ++qi;
        mbar_wait(full + 8 * (it % STAGES), (it / STAGES) & 1);
        bar_sync(1 + c);
        issue_qk<DMAX>(s, qa, ring + it % STAGES * L::STAGE_BYTES);
        bar_arrive(1 + (c + 1) % NC);
        wgmma_wait<0>();
        fence_regs(s);
        if (n == 1 && lane == 0) mbar_arrive(q_empty);  // Q is read
        softmax_kv<DMAX>(s, w.kt_begin, p, r0, cq, rows, w_first, sl2, m, l, alpha);
        rescale(acc, alpha);
        split_p(s, phi, plo);
        // Within the warpgroup: S(j) is issued with P(j - 1) V, and the
        // softmax of tile j runs while that product does (wait_group 1)
#ifdef FLASH_PROFILE
        const bool profiled = g == FLASH_PROFILE && r == 0;
#endif
        for (int j = 1; j < n; ++j) {
          const int st = (it + j) % STAGES, prev = (it + j - 1) % STAGES;
          PROFILE_MARK(0)
          mbar_wait(full + 8 * st, ((it + j) / STAGES) & 1);
          PROFILE_MARK(1)
          bar_sync(1 + c);
          PROFILE_MARK(2)
          issue_qk<DMAX>(s, qa, ring + st * L::STAGE_BYTES);
          issue_pv<DMAX>(acc, phi, plo, ring + prev * L::STAGE_BYTES + NA * L::KV_ATOM);
          bar_arrive(1 + (c + 1) % NC);
          PROFILE_MARK(3)
          wgmma_wait<1>();
          fence_regs(s);
          if (j == n - 1 && lane == 0) mbar_arrive(q_empty);  // Q is read
          PROFILE_MARK(4)
          softmax_kv<DMAX>(s, w.kt_begin + j, p, r0, cq, rows, w_first, sl2, m, l, alpha);
          PROFILE_MARK(5)
          wgmma_wait<0>();
          fence_regs(acc);
          PROFILE_MARK(6)
          if (lane == 0) mbar_arrive(empty + 8 * prev);  // tile j - 1 is read
          rescale(acc, alpha);  // by tile j's alpha, before P(j) V joins
          split_p(s, phi, plo);
          PROFILE_MARK(7)
        }
        const int last = (it + n - 1) % STAGES;
        bar_sync(1 + c);
        issue_pv<DMAX>(acc, phi, plo, ring + last * L::STAGE_BYTES + NA * L::KV_ATOM);
        if (c < NC - 1) bar_arrive(2 + c);
        wgmma_wait<0>();
        fence_regs(acc);
        if (lane == 0) mbar_arrive(empty + 8 * last);
        it += n;
      }

      // one store: acc / l as acc * (1 / l), with l == 0 (no live key) giving 1
      float den[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
        l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
        den[hr] = 1.f / (l[hr] == 0.f ? 1.f : l[hr]);
      }
      __nv_bfloat16* ob = o + w.b * p.o_sb + w.h * p.o_sh + static_cast<long long>(row0) * p.o_ss;
#pragma unroll
      for (int i = 0; i < DN / 2; i += 2) {
        const int hr = (i / 2) % 2;
        const int row = r0 + 8 * hr, col = 8 * (i / 4) + cq;
        if (row < rows && col < p.d) {
          const __nv_bfloat162 x = __floats2bfloat162_rn(acc[i] * den[hr], acc[i + 1] * den[hr]);
          *reinterpret_cast<__nv_bfloat162*>(ob + row * p.o_ss + col) = x;
        }
      }
      if (!L::PERSISTENT) break;
    }
  }
}

// q [B, H, S, D] (or k, v with HK heads) as a 4-D tensor map over (D, S,
// head, batch) from its element strides (batch, head, sequence), whose box
// is box_rows rows of 64 columns
inline bool encode_bhsd(CUtensorMap* map, const void* base, int batch, int heads, int seq, int d,
                        const long long* strides, int box_rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t bytes[3] = {static_cast<cuuint64_t>(strides[2]) * 2,
                               static_cast<cuuint64_t>(strides[1]) * 2,
                               static_cast<cuuint64_t>(strides[0]) * 2};
  return encode_bf16(map, base, 4, dims, bytes, box_rows);
}

template <int DMAX>
int launch_dmax(const void* q, const void* k, const void* v, void* o, int batch, int kv_heads,
                const long long* strides, const Params& p, cudaStream_t stream) {
  using L = Layout<DMAX>;
  CUtensorMap tq, tk, tv;
  // an empty kv axis has no tile to load: its maps are q's, never read
  const bool kv = p.sk > 0;
  if (!encode_bhsd(&tq, q, batch, p.heads, p.sq, p.d, strides, 64) ||
      !encode_bhsd(&tk, kv ? k : q, batch, kv ? kv_heads : p.heads, kv ? p.sk : p.sq, p.d,
                   kv ? strides + 3 : strides, L::BKV) ||
      !encode_bhsd(&tv, kv ? v : q, batch, kv ? kv_heads : p.heads, kv ? p.sk : p.sq, p.d,
                   kv ? strides + 6 : strides, L::BKV))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_bf16_kernel<DMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  // one persistent block an SM, at most one an item (one an item at D 256)
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  const long long tiles = static_cast<long long>((p.sq + L::BQ - 1) / L::BQ) * p.heads * batch;
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(tiles < sms || !L::PERSISTENT ? tiles : sms);
  flash_attention_bf16_kernel<DMAX><<<grid, L::NT, L::smem_bytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), p, static_cast<int>(tiles));
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
    if (d <= 64) return tc::launch_dmax<64>(q, k, v, o, batch, kv_heads, strides, p, stream);
    if (d <= 112) return tc::launch_dmax<112>(q, k, v, o, batch, kv_heads, strides, p, stream);
    if (d <= 128) return tc::launch_dmax<128>(q, k, v, o, batch, kv_heads, strides, p, stream);
    return tc::launch_dmax<256>(q, k, v, o, batch, kv_heads, strides, p, stream);
  }
}

}  // namespace

// Plain C entry points, loaded with ctypes.  `strides` holds 12 element
// strides: (batch, head, sequence) of q, k, v and o; the head dim is
// contiguous.  The caller has checked 8 <= d <= 256, d % 8 == 0, 16-byte
// aligned rows, heads % kv_heads == 0, heads and batch <= 65535, and for bf16
// the strides TMA takes (16-byte multiples below 2^40; an axis of size 1
// given any such stride).  Each returns cudaGetLastError() after the launch:
// 0 when the launch was accepted; the bf16 one returns cudaErrorInvalidValue,
// and launches nothing, where the driver refuses a tensor map.
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

#ifdef FLASH_PROFILE
extern "C" int flash_attention_profile_read(long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, tc::flash_profile, sizeof(tc::flash_profile)));
}
#endif

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
