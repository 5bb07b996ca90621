// The tile engines shared by the port's grouped block GEMM kernels.
//
// A thread block owns a tile of fp32 output blocks.  It walks the tasks of
// each output block in ascending order, streams each task's operands
// through shared memory, accumulates in registers and stores its tile once.
// Two kinds of engine do the products:
//
// - The FFMA engines (Tile128, TileRows, Tile64) stream TK = 16 columns of A
//   (rows of B) at a time, and every thread accumulates a register tile with
//   one fmaf per product.  The sum of each output element is therefore one
//   fp32 fmaf chain from 0, over its output block's tasks in ascending order
//   and within a task over k in ascending order (a ragged k edge pads to a
//   multiple of 16 with zeros).  The chain depends neither on the tile shape
//   nor on which FFMA engine runs, so every kernel that runs its tasks
//   through them gives bit-identical results for the same tasks in the same
//   order (block_spmm.cu, fused_block_spmm.cu).  fp32 stores and the
//   adaptive mode always run here; with `low` each operand element is
//   rounded to bf16 before its products.
// - TileTC runs bf16 stores on the tensor cores (wgmma, bf16 products, fp32
//   sums), the card's counterpart of the TPU kernel's bf16 dot with fp32
//   accumulation.  Each output element is one fp32 sum from 0 over the run's
//   tasks in ascending order and within a task over k in ascending 16-wide
//   steps, each step summed inside the tensor core in its own order.  So
//   TileTC is bit-identical to itself (repeat, block_spmm == the fused
//   kernel, every tile it runs), not to the fmaf chain: the two differ in
//   the order of the fp32 sums, within the limit both are held to against
//   the plain version.
//
// Four engines, picked by one rule (pick_engine) in both kernels: TileTC
// for bf16 stores wherever it takes the shape, else Tile128, else TileRows,
// else Tile64.  The kernels' C entry points take an engine id that forces
// one (an FFMA engine on bf16 stores too, for tests and for the earlier
// time), and refuse one that cannot take the shape (engine_takes):
//
// - Tile128, for blocks whose bm and bn are multiples of 128 (the main
//   path's bs 128 leaf is one tile): 256 threads each hold an 8 x 8 register
//   tile, split into four 4 x 4 quadrants 64 rows and 64 columns apart, so
//   a warp's shared-memory reads are two rows of A (broadcasts; A's rows are
//   padded by 16 bytes so the two lie in other banks) or 256 contiguous
//   bytes of B.  A stays row-major in shared memory (no transpose) and is
//   read along k, B along n: each stage of 16 k is 1,024 FFMA a thread fed
//   by 48 shared loads.  The operands arrive by cp.async (16 bytes a thread,
//   as stored: fp32 or bf16) in a ring of three 16-deep stages that runs
//   across task boundaries, so two stages are in flight while the FFMAs
//   run, with one barrier per stage; only the producer walks the task
//   cursor, and a flag beside each stage tells the consumer whether it
//   holds a task and whether to round it.  bf16 stores convert to fp32 as
//   they are read from shared memory, and `low` rounds there too.  Bound on
//   an H100 SXM: 2 * bm * bn * bk FFMA operations per task at 67 TFLOP/s.
//   It reaches 63 % of that on the main path's timing case.  Stage depth,
//   one or two blocks per SM and the warp layout did not move it; register
//   bank conflicts between the FFMAs' operands did (the C tile is stored
//   with scalar stores for that).  What still holds it back: the bank
//   conflicts that remain (the register allocator places the accumulators),
//   and one block per tile walking a whole run however long.
// - TileRows, for every other block of at most 64 rows (bs 8-64, the
//   dropless grouped GEMM's 8-row tiles, ragged or unaligned shapes).  A
//   tile of TM rows packs up to R = TM / bmp consecutive output blocks, bmp
//   being bm rounded up to a multiple of 8, by TN = 32, 64 or 128 columns (the
//   least that holds bn; more tiles past 128).  2 * TN threads each hold
//   four rows by 8 columns (TM 64) or, at TN 128, eight rows by 8 columns
//   (TM 128), the 8 columns as two quads TN / 2 apart; a warp covers 32
//   rows, and the A tile's 16-byte chunks are swizzled so that its reads
//   meet no bank conflict.  So R is 8 at bm 8 (16 at bn above 64), 2 at bs
//   24 and 32, 1 at bs 64, and no FFMA runs on a row past bmp.  A launch
//   may ask for fewer blocks a tile (pick_pack: any R from 1 up): the rows
//   past R blocks then issue no FFMA, and the grid has ceil(num_out / R)
//   tiles of a column, so blocks that share no B run on more SMs.  The tile
//   walks its blocks' runs in steps, and each step names one B operand (the
//   same stack row, and in the fused kernel the same `low` flag): the head
//   task of the lowest-numbered block with tasks left, joined by every
//   block whose head task names the same B.  The others sit the step out
//   and their rows issue no FFMA.  The B panel is staged once per step for
//   every block in it, so the grouped GEMM's 16 tiles of one expert read
//   its weight once, not 16 times.  A step takes run heads only, so each
//   block keeps its own task order.  The operands arrive as in Tile128:
//   16-byte cp.async in a ring of three stages that runs across steps, one
//   barrier per stage; only the producer walks the runs (every thread
//   computes the same steps from the same task arrays and cursors in shared
//   memory, which thread 0 advances), and a flag beside each stage says
//   which blocks take part and whether to round.  A ragged bk or bn (not
//   whole 16-byte chunks) or a stack off a 16-byte boundary takes the same
//   ring with masked scalar loads.  The column tiles of one group are
//   neighbours in the 1-D grid, so its A rows come from device memory once.
//   Bound on an H100 SXM: 2 * bm * bn * bk FFMA operations per task at 67
//   TFLOP/s, the bytes of each distinct operand block at 3.35 TB/s.  What
//   still holds it back: a grouped-GEMM tile that straddles an expert
//   boundary takes two full-depth steps with part of its rows idle in each
//   (chip_smoke.py's moe_layer phase counts the steps and the live share of
//   their rows).  The Morton band pairs the blocks of one block row, which share
//   A and never B, so at bs 32 every step runs one of the tile's two warps.
//   At bs 64 (R 1, 4 x 8 registers) a stage is 512 FFMA a thread against
//   Tile128's 1,024, so the barrier and the copies weigh twice as much.
// - Tile64, for the shapes neither takes (bm above 64 that is not a
//   multiple of 128, such as 96 or 130, or a 128 multiple off a 16-byte
//   boundary): 64 x 64 tiles, 256 threads with a 4 x 4 register tile,
//   staged synchronously through shared memory with masked scalar loads
//   that convert and round as they stage.  Any block size works.
// - TileTC, for bf16 stores with bm >= 64, bk and bn multiples of 8 (rows of
//   whole 16-byte chunks) and 16-byte aligned stacks.  Its row tile is the
//   whole output block up to 256 rows (1 to 4 consumer warpgroups of 64
//   rows; taller blocks take several row tiles), by 128 columns, so each B
//   panel is read once per output block.  One producer warp walks the task
//   cursor and keeps TMA loads in flight in a ring of four 64-deep stages
//   (A [rows, 64 k] K-major and B [64 k, 128 n] N-major, both in the 128-byte
//   swizzle wgmma reads), through a full and an empty mbarrier a stage; the
//   ring runs across task boundaries.  The operands are 3-D tensor maps over
//   the stacks [blocks, rows, cols] with the block taken from the task, so
//   TMA zero-fills the rows past bm and the columns past bk and bn.  Each
//   consumer warpgroup issues wgmma m64n128k16 from shared memory and keeps
//   its 64 x 128 fp32 accumulator in registers across the whole run; the
//   tile is stored once with masked edges.  The column tiles of one output
//   block are neighbours in the 1-D grid, so its A rows come from device
//   memory once and from L2 after.  Bound on an H100 SXM: the larger of 2 *
//   bm * bn * bk operations per task at 989 TFLOP/s and the bytes of each
//   distinct operand block at 3.35 TB/s; on kimi-k2's expert GEMMs (bm 107
//   and 150 rows against [7168, 2048] weights) the weights' bytes.  What
//   holds it back is set out in PERF.md (the producer waits on a stage until
//   every warpgroup's products on it are done; one block an SM).
//
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

#include "wgmma.cuh"

namespace tile_gemm {

constexpr int THREADS = 256;  // Tile64 and Tile128 (TileRows: 2 * TN)
constexpr int TK = 16;        // contraction depth per stage, every engine (fixes the zero padding)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// fp32 -> bf16 (round to nearest even, as a bf16 cast does) -> fp32
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

inline bool aligned16(const void* const* ptrs, int nptrs) {
  for (int i = 0; i < nptrs; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return false;
  return true;
}

// Tile128 needs whole 128 x 128 tiles, rows of whole 16-byte chunks and
// 16-byte aligned stacks.
inline bool use_tile128(int bm, int bk, int bn, const void* const* ptrs, int nptrs) {
  if (bm <= 0 || bn <= 0 || bk <= 0 || bm % 128 || bn % 128 || bk % 8) return false;
  return aligned16(ptrs, nptrs);
}

// TileTC needs bf16 stores, at least one warpgroup's 64 rows, rows of whole
// 16-byte chunks (the tensor maps' strides) and 16-byte aligned stacks.
constexpr int TILETC_MIN_BM = 64;
inline bool use_tiletc(int bm, int bk, int bn, const void* const* ptrs, int nptrs, bool bf16) {
  if (!bf16 || bm < TILETC_MIN_BM || bn <= 0 || bk <= 0 || bk % 8 || bn % 8) return false;
  return aligned16(ptrs, nptrs);
}

// Engine ids of the kernels' C entry points: 0 asks for the rule.
enum Engine : int {
  ENGINE_RULE = 0, ENGINE_TILE64 = 1, ENGINE_TILEROWS = 2, ENGINE_TILE128 = 3, ENGINE_TILETC = 4
};
constexpr int TILEROWS_MAX_BM = 64;

inline bool engine_takes(int engine, int bm, int bk, int bn, const void* const* ptrs, int nptrs,
                         bool bf16) {
  if (bm <= 0 || bn <= 0 || bk <= 0) return false;
  switch (engine) {
    case ENGINE_TILE64: return true;
    case ENGINE_TILEROWS: return bm <= TILEROWS_MAX_BM;
    case ENGINE_TILE128: return use_tile128(bm, bk, bn, ptrs, nptrs);
    case ENGINE_TILETC: return use_tiletc(bm, bk, bn, ptrs, nptrs, bf16);
    default: return false;
  }
}

// The engine for a block shape and store type (bf16: 2-byte stores): the
// same rule in every kernel, so the kernels agree on it; a forced engine
// must take the shape (else -1).
inline int pick_engine(int engine, int bm, int bk, int bn, const void* const* ptrs, int nptrs,
                       bool bf16) {
  if (engine != ENGINE_RULE)
    return engine_takes(engine, bm, bk, bn, ptrs, nptrs, bf16) ? engine : -1;
  if (use_tiletc(bm, bk, bn, ptrs, nptrs, bf16)) return ENGINE_TILETC;
  if (use_tile128(bm, bk, bn, ptrs, nptrs)) return ENGINE_TILE128;
  if (bm > 0 && bm <= TILEROWS_MAX_BM) return ENGINE_TILEROWS;
  return ENGINE_TILE64;
}

// The most output blocks a TileRows tile packs at a block shape: its rows
// (64, or 128 for bn above 64) over bm rounded up to a multiple of 8, as
// TileRows<TN, RM>::pack for the TN the kernels take for bn.
inline int tilerows_pack(int bm, int bn) { return (bn > 64 ? 128 : 64) / ((bm + 7) / 8 * 8); }

// The pack R a launch of `engine` (as picked) runs: 0 asks for the rule's,
// TileRows' full pack and 1 for the other engines.  TileRows takes any R
// from 1 to its full pack (the rows past R blocks issue no FFMA), the other
// engines 1 only; anything else is refused (-1).  The tile autotuner
// (kernels/autotune.py) picks the pair (engine, R) per block shape.
inline int pick_pack(int engine, int pack, int bm, int bn) {
  const int full = engine == ENGINE_TILEROWS ? tilerows_pack(bm, bn) : 1;
  if (pack == 0) return full;
  return pack >= 1 && pack <= full ? pack : -1;
}

// ---------------------------------------------------------------- Tile64

struct Tile64 {
  static constexpr int TM = 64, TN = 64, RM = 4, RN = 4, MIN_BLOCKS = 1, THREADS = tile_gemm::THREADS;
  static constexpr int APAD = 4;  // keeps the transposed A tile's rows 16-byte aligned

  struct Smem {
    __align__(16) float As[TK][TM + APAD];  // A tile, k-major
    __align__(16) float Bs[TK][TN];
  };
  static constexpr size_t smem_bytes = sizeof(Smem);

  struct Acc {
    float v[RM][RN];
  };

  // acc += A[m0:m0+TM, :] @ B[:, n0:n0+TN] for one task's row-major blocks
  // A [bm, bk] and B [bk, bn].
  template <typename T>
  __device__ __forceinline__ static void task(const T* __restrict__ Ab, const T* __restrict__ Bb,
                                              bool low, int m0, int n0, int bm, int bk, int bn,
                                              Smem& s, Acc& acc) {
    const int tid = threadIdx.x;
    const int ty = tid / (TN / RN);
    const int tx = tid % (TN / RN);
    for (int k0 = 0; k0 < bk; k0 += TK) {
#pragma unroll
      for (int r = 0; r < TM * TK / THREADS; ++r) {
        const int l = tid + r * THREADS;
        const int i = l / TK, kk = l % TK;
        const int gi = m0 + i, gk = k0 + kk;
        float x = (gi < bm && gk < bk) ? to_float(Ab[static_cast<int64_t>(gi) * bk + gk]) : 0.f;
        s.As[kk][i] = low ? round_bf16(x) : x;
      }
#pragma unroll
      for (int r = 0; r < TK * TN / THREADS; ++r) {
        const int l = tid + r * THREADS;
        const int kk = l / TN, j = l % TN;
        const int gk = k0 + kk, gj = n0 + j;
        float x = (gk < bk && gj < bn) ? to_float(Bb[static_cast<int64_t>(gk) * bn + gj]) : 0.f;
        s.Bs[kk][j] = low ? round_bf16(x) : x;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < TK; ++kk) {
        const float4 av = *reinterpret_cast<const float4*>(&s.As[kk][ty * RM]);
        const float4 bv = *reinterpret_cast<const float4*>(&s.Bs[kk][tx * RN]);
        const float a[RM] = {av.x, av.y, av.z, av.w};
        const float b[RN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) acc.v[i][j] = fmaf(a[i], b[j], acc.v[i][j]);
      }
      __syncthreads();
    }
  }

  // Walk the cursor's tasks and write the tile into the row-major output block Cb [bm, bn].
  template <typename T, typename Cursor>
  __device__ __forceinline__ static void run(Cursor cur, float* __restrict__ Cb, int m0, int n0,
                                             int bm, int bk, int bn, unsigned char* smem) {
    Smem& s = *reinterpret_cast<Smem*>(smem);
    Acc acc;
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc.v[i][j] = 0.f;
    const T* A;
    const T* B;
    bool low;
    while (cur.next(A, B, low)) task(A, B, low, m0, n0, bm, bk, bn, s, acc);

    const int tid = threadIdx.x;
    const int ty = tid / (TN / RN);
    const int tx = tid % (TN / RN);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int gi = m0 + ty * RM + i;
      if (gi >= bm) continue;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int gj = n0 + tx * RN + j;
        if (gj < bn) Cb[static_cast<int64_t>(gi) * bn + gj] = acc.v[i][j];
      }
    }
  }
};

// --------------------------------------------------------------- Tile128

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src, bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  const int bytes = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem_src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four consecutive stored elements as fp32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// two consecutive stored elements as fp32
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <bool LOW>
__device__ __forceinline__ void maybe_round(float2& v) {
  if (LOW) {
    v.x = round_bf16(v.x);
    v.y = round_bf16(v.y);
  }
}

template <bool LOW>
__device__ __forceinline__ void maybe_round(float4& v) {
  if (LOW) {
    v.x = round_bf16(v.x);
    v.y = round_bf16(v.y);
    v.z = round_bf16(v.z);
    v.w = round_bf16(v.w);
  }
}

struct Tile128 {
  static constexpr int TM = 128, TN = 128, STAGES = 3, THREADS = tile_gemm::THREADS;
  static constexpr int MIN_BLOCKS = 2;  // two blocks an SM: at most 128 registers a thread

  // A rows, k contiguous (row-major, as stored), each row padded by 16
  // bytes so that the two rows a warp reads at once lie in other banks;
  // B rows, n contiguous
  template <typename T>
  struct Stage {
    __align__(16) T As[TM][TK + 16 / sizeof(T)];
    __align__(16) T Bs[TK][TN];
  };
  // the ring, then one flag per stage: 0 past the last task, 1 a task, 2 a low task
  template <typename T>
  static constexpr size_t smem_bytes() { return STAGES * sizeof(Stage<T>) + STAGES * sizeof(int); }

  // One stage: A[0:128, k0:k0+16] and B[k0:k0+16, n0:n0+128] of one task, by
  // 16-byte cp.async (zeros past bk).  bk % 8 == 0, so a chunk lies wholly
  // inside or wholly outside the block.
  template <typename T>
  __device__ __forceinline__ static void load(Stage<T>& st, const T* __restrict__ Ab,
                                              const T* __restrict__ Bb, int m0, int n0, int k0,
                                              int bk, int bn) {
    constexpr int E = 16 / sizeof(T);  // elements per chunk
    constexpr int CH = TM * TK / E;     // chunks per stage and operand (TM == TN)
    constexpr int B_ROW = TN / E;       // chunks per B row
    static_assert(CH % THREADS == 0, "whole chunks per thread");
#pragma unroll
    for (int r = 0; r < CH / THREADS; ++r) {
      const int c = threadIdx.x + r * THREADS;
      const int row = c / (TK / E), kc = (c % (TK / E)) * E;
      const bool ok = k0 + kc < bk;
      cp_async16(&st.As[row][kc], ok ? Ab + static_cast<int64_t>(m0 + row) * bk + k0 + kc : Ab, ok);
    }
#pragma unroll
    for (int r = 0; r < CH / THREADS; ++r) {
      const int c = threadIdx.x + r * THREADS;
      const int row = c / B_ROW, nc = (c % B_ROW) * E;
      const bool ok = k0 + row < bk;
      cp_async16(&st.Bs[row][nc], ok ? Bb + static_cast<int64_t>(k0 + row) * bn + n0 + nc : Bb, ok);
    }
  }

  // acc[i][j] += A[row i, k] * B[k, col j] over the stage's 16 k, ascending.
  // Thread (ty, tx) owns rows 64 (i / 4) + 4 ty + i % 4 and columns
  // 64 (j / 4) + 4 tx + j % 4, i and j in 0..7.  A is read two k at a time
  // (8-byte loads, 16 registers), B one k at a time (two 16-byte loads).
  template <typename T, bool LOW>
  __device__ __forceinline__ static void compute(const Stage<T>& st, float (&acc)[8][8]) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int kq = 0; kq < TK; kq += 2) {
      float2 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        a[i] = load2(&st.As[(i / 4) * 64 + ty * 4 + (i % 4)][kq]);
        maybe_round<LOW>(a[i]);
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        float4 b0 = load4(&st.Bs[kq + kk][tx * 4]);
        float4 b1 = load4(&st.Bs[kq + kk][64 + tx * 4]);
        maybe_round<LOW>(b0);
        maybe_round<LOW>(b1);
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float ai = kk == 0 ? a[i].x : a[i].y;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ai, b[j], acc[i][j]);
        }
      }
    }
  }

  // Walk the cursor's tasks through the stage ring and write the 128 x 128
  // tile at (m0, n0) of the row-major output block Cb [bm, bn].  Only the
  // producer walks the cursor, STAGES - 1 steps of 16 k ahead; it leaves a
  // flag beside each stage (0: no more steps, 1: a step, 2: a low step),
  // which the consumer reads after the barrier that also covers the copy.
  template <typename T, typename Cursor>
  __device__ __forceinline__ static void run(Cursor cur, float* __restrict__ Cb, int m0, int n0,
                                             int bm, int bk, int bn, unsigned char* smem) {
    Stage<T>* ring = reinterpret_cast<Stage<T>*>(smem);
    int* flags = reinterpret_cast<int*>(smem + STAGES * sizeof(Stage<T>));
    const int ksteps = (bk + TK - 1) / TK;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    const T* pA = nullptr;
    const T* pB = nullptr;
    bool plow = false, pmore = true;
    int pk = ksteps;
    auto produce = [&](int stage) {
      if (pmore && pk == ksteps) {
        pmore = cur.next(pA, pB, plow);
        pk = 0;
      }
      if (pmore) load(ring[stage], pA, pB, m0, n0, pk++ * TK, bk, bn);
      if (threadIdx.x == 0) flags[stage] = pmore ? (plow ? 2 : 1) : 0;
      cp_async_commit();  // an empty group past the end keeps the count uniform
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) produce(s);

    for (int stage = 0;; stage = (stage + 1) % STAGES) {
      cp_async_wait<STAGES - 2>();  // this step's stage has landed (own copies) ...
      __syncthreads();              // ... everyone's, with its flag; the previous stage is read
      const int flag = flags[stage];
      if (flag == 0) break;
      produce((stage + STAGES - 1) % STAGES);
      if (flag == 2)
        compute<T, true>(ring[stage], acc);
      else
        compute<T, false>(ring[stage], acc);
    }
    cp_async_wait<0>();

    // scalar stores: a float4 store would tie each accumulator quad to four
    // aligned registers, whose banks the FFMAs' B operands then share
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int64_t row = m0 + (i / 4) * 64 + ty * 4 + (i % 4);
      float* dst = Cb + row * bn + n0 + tx * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dst[j] = acc[i][j];
        dst[64 + j] = acc[i][4 + j];
      }
    }
  }
};

// -------------------------------------------------------------- TileRows

template <typename T>
__device__ __forceinline__ T zero_elem();
template <>
__device__ __forceinline__ float zero_elem<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_elem<__nv_bfloat16>() { return __ushort_as_bfloat16(0); }

// One 16-byte chunk of E = 16 / sizeof(T) elements into shared memory, of
// which the first `n` (0 <= n <= E) come from `src` and the rest are zeros.
// VEC: by cp.async, n is 0 or E and `src` 16-byte aligned; otherwise by
// masked scalar loads (a ragged edge, an unaligned stack).
template <bool VEC, typename T>
__device__ __forceinline__ void stage_chunk(T* dst, const T* src, const T* any, int n) {
  constexpr int E = 16 / sizeof(T);
  if (VEC) {
    cp_async16(dst, n > 0 ? src : any, n > 0);
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) dst[i] = i < n ? src[i] : zero_elem<T>();
  }
}

// The packed walk's view of one kernel's task lists (PackedRuns in
// block_spmm.cu, FusedPackedRuns in fused_block_spmm.cu): for the output
// blocks r < nblk of the tile, begin(r) / end(r) bound the run, skip()
// moves a cursor past the tasks that are off, a(t) / b(t) are task t's
// operand blocks and low(t) its rounding flag, out(r) the output block.

template <int TN_, int RM_>
struct TileRows {
  static constexpr int TN = TN_, RM = RM_;   // RM rows by 8 columns a thread
  static constexpr int TM = 16 * RM, THREADS = 2 * TN, STAGES = 3;
  static constexpr int RSTEP = 8;            // a block's rows round up to a multiple of this
  static constexpr int RMAX = TM / RSTEP;    // output blocks a tile packs at most
  static constexpr int CG = TN / 8;          // column groups: 8 columns a thread
  static constexpr int WXT = RM, WY = 32 / RM;  // a warp: WY thread rows by WXT thread columns
  static constexpr int WX = CG / WXT;        // warps across the columns
  static constexpr int KA = 16 / RM;         // k a thread reads of an A row at once
  static constexpr int MIN_BLOCKS = 512 / THREADS;  // at most 128 registers a thread
  static_assert((RM == 4 || RM == 8) && THREADS / CG * RM == TM && CG % WXT == 0,
                "RM rows a thread, a warp of 32 rows");

  template <typename T>
  struct Stage {
    __align__(16) T As[TM][TK + 16 / sizeof(T)];  // rows of the packed blocks, k contiguous, swizzled
    __align__(16) T Bs[TK][TN];
  };
  // The ring; one flag per stage (0 past the last step, else 1 | low << 1 |
  // (the blocks in the step) << 2); two copies of the run cursors.
  struct Walk {
    int64_t t[2][RMAX];
    int left[2][RMAX];
    int flags[STAGES];
  };
  template <typename T>
  static constexpr size_t smem_bytes() { return STAGES * sizeof(Stage<T>) + sizeof(Walk); }

  // a block's rows in the tile, and the number of blocks the tile packs
  __host__ __device__ static constexpr int rows(int bm) { return (bm + RSTEP - 1) / RSTEP * RSTEP; }
  __host__ __device__ static constexpr int pack(int bm) { return TM / rows(bm); }
  // the tiles of packed output blocks, R (1 <= R <= pack(bm)) a tile
  __host__ __device__ static int64_t groups(int64_t num_out, int R) { return (num_out + R - 1) / R; }
  __host__ __device__ static int tiles_n(int bn) { return (bn + TN - 1) / TN; }
  // The 1-D grid's block b: the group of packed output blocks and the column
  // tile.  The column tiles of a group are neighbours, so the group's A rows
  // are read from device memory once and from L2 by the other tiles.
  __device__ static void tile_of(int64_t b, int bn, int64_t& group, int& ntile) {
    group = b / tiles_n(bn);
    ntile = static_cast<int>(b % tiles_n(bn));
  }

  // The 16-byte chunk c of an A row lies at chunk c ^ swz(row): a warp reads
  // one chunk of the rows RM ty + i of its WY ty at once, which the swizzle
  // and the 16-byte row padding spread over distinct bank groups.
  template <typename T>
  __device__ __forceinline__ static int swz(int row) { return (row >> 3) & (TK * sizeof(T) / 16 - 1); }

  // KA consecutive stored elements of an A row as fp32 (rounded with LOW)
  template <typename T, bool LOW>
  __device__ __forceinline__ static void load_a(const T* p, float (&a)[KA]) {
    if constexpr (KA == 4) {
      float4 v = load4(p);
      maybe_round<LOW>(v);
      a[0] = v.x, a[1] = v.y, a[2] = v.z, a[3] = v.w;
    } else {
      float2 v = load2(p);
      maybe_round<LOW>(v);
      a[0] = v.x, a[1] = v.y;
    }
  }

  // acc[i][j] += A[row RM ty + i, k] * B[k, col j] over the stage's 16 k,
  // ascending; columns 4 tx + j and TN / 2 + 4 tx + j - 4.  A is read KA k
  // at a time, B one k at a time.
  template <typename T, bool LOW>
  __device__ __forceinline__ static void compute(const Stage<T>& st, float (&acc)[RM][8], int ty,
                                                 int tx) {
    constexpr int E = 16 / sizeof(T);
#pragma unroll
    for (int kq = 0; kq < TK; kq += KA) {
      float a[RM][KA];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int row = ty * RM + i;
        load_a<T, LOW>(&st.As[row][((kq / E) ^ swz<T>(row)) * E + kq % E], a[i]);
      }
#pragma unroll
      for (int kk = 0; kk < KA; ++kk) {
        float4 b0 = load4(&st.Bs[kq + kk][tx * 4]);
        float4 b1 = load4(&st.Bs[kq + kk][TN / 2 + tx * 4]);
        maybe_round<LOW>(b0);
        maybe_round<LOW>(b1);
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i][kk], b[j], acc[i][j]);
      }
    }
  }

  // Walk the runs of the tile's nblk packed output blocks in steps through
  // the stage ring and write each block's rows of the TN columns at n0.
  template <typename T, bool VEC, typename Runs>
  __device__ __forceinline__ static void run(const Runs& runs, int nblk, int bm, int bk, int bn,
                                             int n0, unsigned char* smem) {
    constexpr int E = 16 / sizeof(T);   // elements per chunk
    constexpr int A_ROW = TK / E;       // chunks per A row
    constexpr int B_ROW = TN / E;       // chunks per B row
    constexpr int NA = (TM * A_ROW + THREADS - 1) / THREADS;  // A chunks a thread
    constexpr int NB = TK * B_ROW / THREADS;                  // B chunks a thread
    static_assert(TK * B_ROW % THREADS == 0, "whole B chunks per thread");
    Stage<T>* ring = reinterpret_cast<Stage<T>*>(smem);
    Walk& w = *reinterpret_cast<Walk*>(smem + STAGES * sizeof(Stage<T>));
    const int tid = threadIdx.x;
    const int bmp = rows(bm);
    const int ksteps = (bk + TK - 1) / TK;

    // the run cursors: every thread reads copy `par` for a step, thread 0
    // writes the next step's cursors into the other copy (a barrier lies
    // between a step and the next, so no copy is written while it is read)
    if (tid < nblk) {
      int64_t t = runs.begin(tid);
      int left = static_cast<int>(runs.end(tid) - t);
      runs.skip(t, left);
      w.t[0][tid] = t;
      w.left[0][tid] = left;
    }
    __syncthreads();
    int par = 0;

    // the producer's step: B, its flag, the blocks in it, this thread's A chunks
    const T* pB = nullptr;
    const T* pA[NA];
    bool plow = false, pmore = true;
    unsigned pmask = 0;
    int pk = ksteps;
    auto next_step = [&]() -> bool {
      const int64_t* t = w.t[par];
      const int* left = w.left[par];
      int lead = 0;
      while (lead < nblk && left[lead] == 0) ++lead;
      if (lead == nblk) return false;
      pB = runs.b(t[lead]);
      plow = runs.low(t[lead]);
      unsigned mask = 1u << lead;
      for (int r = lead + 1; r < nblk; ++r)
        if (left[r] > 0 && runs.b(t[r]) == pB && runs.low(t[r]) == plow) mask |= 1u << r;
#pragma unroll
      for (int q = 0; q < NA; ++q) {
        const int row = (tid + q * THREADS) / A_ROW;
        const int blk = row / bmp;
        pA[q] = blk < nblk && (mask >> blk & 1u)
                    ? runs.a(t[blk]) + static_cast<int64_t>(row - blk * bmp) * bk
                    : nullptr;
      }
      if (tid == 0)
        for (int r = 0; r < nblk; ++r) {
          int64_t tn = t[r];
          int ln = left[r];
          if (mask >> r & 1u) {
            ++tn;
            --ln;
            runs.skip(tn, ln);
          }
          w.t[par ^ 1][r] = tn;
          w.left[par ^ 1][r] = ln;
        }
      par ^= 1;
      pmask = mask;
      return true;
    };

    // one stage: the step's A rows of the blocks in it (zeros past bm and
    // past bk) and B[k0:k0+16, n0:n0+TN] (zeros past bk and bn)
    auto load = [&](Stage<T>& st, int k0) {
#pragma unroll
      for (int q = 0; q < NA; ++q) {
        const int c = tid + q * THREADS;
        if (c >= TM * A_ROW || pA[q] == nullptr) continue;  // a block outside the step
        const int row = c / A_ROW, kc = (c % A_ROW) * E;
        const int n = row % bmp < bm ? min(max(bk - (k0 + kc), 0), E) : 0;
        stage_chunk<VEC>(&st.As[row][((c % A_ROW) ^ swz<T>(row)) * E], pA[q] + k0 + kc, pB, n);
      }
#pragma unroll
      for (int q = 0; q < NB; ++q) {
        const int c = tid + q * THREADS;
        const int row = c / B_ROW, nc = (c % B_ROW) * E;
        const int n = k0 + row < bk ? min(max(bn - (n0 + nc), 0), E) : 0;
        stage_chunk<VEC>(&st.Bs[row][nc], pB + static_cast<int64_t>(k0 + row) * bn + n0 + nc, pB, n);
      }
    };

    auto produce = [&](int stage) {
      if (pmore && pk == ksteps) {
        pmore = next_step();
        pk = 0;
      }
      if (pmore) load(ring[stage], pk++ * TK);
      if (tid == 0) w.flags[stage] = pmore ? (1 | (plow ? 2 : 0) | static_cast<int>(pmask << 2)) : 0;
      cp_async_commit();  // an empty group past the end keeps the count uniform
    };

    // a warp holds WY x WXT threads: 32 rows by WXT 4-column quads twice
    const int warp = tid / 32, lane = tid % 32;
    const int ty = (warp / WX) * WY + lane / WXT, tx = (warp % WX) * WXT + lane % WXT;
    const int myblk = ty * RM / bmp;  // the block of this thread's RM rows
    float acc[RM][8];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      produce(s);
      __syncthreads();  // the cursors a prologue step wrote, before the next reads them
    }
    for (int stage = 0;; stage = (stage + 1) % STAGES) {
      cp_async_wait<STAGES - 2>();  // this step's stage has landed (own copies) ...
      __syncthreads();              // ... everyone's, with its flag; the previous stage is read
      const int flag = w.flags[stage];
      if (flag == 0) break;
      produce((stage + STAGES - 1) % STAGES);
      if (flag >> (2 + myblk) & 1) {
        if (flag & 2)
          compute<T, true>(ring[stage], acc, ty, tx);
        else
          compute<T, false>(ring[stage], acc, ty, tx);
      }
    }
    cp_async_wait<0>();

    if (myblk >= nblk) return;
    float* Cb = runs.out(myblk);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int rin = ty * RM + i - myblk * bmp;
      if (rin >= bm) continue;
      float* dst = Cb + static_cast<int64_t>(rin) * bn;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + (j < 4 ? tx * 4 + j : TN / 2 + tx * 4 + j - 4);
        if (col < bn) dst[col] = acc[i][j];
      }
    }
  }
};

// ---------------------------------------------------------------- TileTC

// The operand stacks of a TileTC launch as 3-D tensor maps over [blocks,
// rows, cols] (cols innermost): two stacks an operand at most (block_spmm.cu
// one; fused_block_spmm.cu the store and the receive stack), picked per task.
struct TcMaps {
  CUtensorMap a[2];
  CUtensorMap b[2];
};

// cuTensorMapEncodeTiled, taken from the driver through the runtime (no
// link against libcuda); null where the driver does not offer it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                  : nullptr;
  }();
  return fn;
}

// A bf16 stack [blocks, rows, cols] as a tensor map whose box is box_rows
// rows of 64 columns (128-byte rows, the 128-byte swizzle) in one block;
// loads past any edge read zeros.  False where the driver refuses it.
inline bool encode_stack(CUtensorMap* map, const void* base, long long blocks, int rows, int cols,
                         int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr || base == nullptr || blocks <= 0) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(blocks)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2,
                                 static_cast<cuuint64_t>(rows) * cols * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The consumer warpgroups of a TileTC tile for blocks of bm rows: the whole
// block up to 256 rows, four (several row tiles) past it
inline int tiletc_warpgroups(int bm) { return bm >= 256 ? 4 : (bm + 63) / 64; }

// The maps of one launch: A stacks [n, bm, bk] with a box of the tile's
// rows, B stacks [n, bk, bn] with a box of 64 k.  A stack of no blocks (an
// unused receive stack) is mapped as one block at `any`, a device address
// that no task names (the output), so that every map is valid.
inline bool tc_maps(TcMaps& maps, const void* const* a, const long long* na, const void* const* b,
                    const long long* nb, int bm, int bk, int bn, const void* any) {
  const int rows = 64 * tiletc_warpgroups(bm);
  for (int i = 0; i < 2; ++i) {
    const bool a_ok = a[i] != nullptr && na[i] > 0, b_ok = b[i] != nullptr && nb[i] > 0;
    if (!encode_stack(&maps.a[i], a_ok ? a[i] : any, a_ok ? na[i] : 1, bm, bk, rows) ||
        !encode_stack(&maps.b[i], b_ok ? b[i] : any, b_ok ? nb[i] : 1, bk, bn, 64))
      return false;
  }
  return true;
}

// The TileTC task cursor (TcRunCursor in block_spmm.cu, the fused kernel's
// FusedCursor): next(am, ab, bmap, bb) names the next task's stacks (0 or
// 1: TcMaps' a / b) and its blocks in them, in ascending t.

template <int WG>
struct TileTC {
  static constexpr int TM = 64 * WG, TN = 128, KT = 64, STAGES = 4;
  static constexpr int THREADS = 128 * WG + 32, MIN_BLOCKS = 1;  // WG warpgroups, the producer warp
  static constexpr int A_BYTES = TM * 128;                  // TM rows x 64 k (128-byte rows)
  static constexpr int B_BYTES = 2 * wgmma::ATOM_BYTES;     // 64 k x 128 n: two 64-column atoms
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // 1024 to align the ring's atoms; then per stage a full and an empty
  // barrier (8 bytes each) and a flag
  static constexpr size_t smem_bytes = 1024 + STAGES * STAGE_BYTES + STAGES * (16 + 4);
  static_assert(smem_bytes <= 232448, "a block takes at most 227 KB of shared memory");

  __host__ __device__ static int tiles_m(int bm) { return (bm + TM - 1) / TM; }
  __host__ __device__ static int tiles_n(int bn) { return (bn + TN - 1) / TN; }

  // Walk the cursor's tasks and write the TM x TN tile at (m0, n0) of the
  // row-major output block Cb [bm, bn].  The producer fills stage it % STAGES
  // with step it (a task's 64 k) once every warp has released its previous
  // use, arming the stage's full barrier with the bytes of the three boxes
  // and a flag (1: a step; 0: no more), which the consumers read after the
  // barrier completes.  Each consumer warpgroup multiplies its 64 rows of A
  // by the stage's B in four 16-deep wgmma steps, ascending.
  template <typename Cursor>
  __device__ __forceinline__ static void run(Cursor cur, const TcMaps& maps, float* __restrict__ Cb,
                                             int m0, int n0, int bm, int bk, int bn,
                                             unsigned char* smem) {
    using namespace wgmma;
    const uint32_t raw = smem_u32(smem);
    const uint32_t ring = (raw + 1023) & ~1023u;
    const uint32_t full = ring + STAGES * STAGE_BYTES, empty = full + 8 * STAGES;
    volatile int* flags = reinterpret_cast<volatile int*>(smem + (empty + 8 * STAGES - raw));
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (threadIdx.x == 0) {
#pragma unroll
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(full + 8 * s, 1);
        mbar_init(empty + 8 * s, 4 * WG);  // one arrival a consumer warp
      }
      mbar_fence_init();
    }
    __syncthreads();

    if (warp == 4 * WG) {  // the producer warp: one thread walks the tasks
      if (lane != 0) return;
      const int ksteps = (bk + KT - 1) / KT;
      int it = 0, am, ab, bmap, bb;
      auto claim = [&](int s) {  // the stage is free once its previous use is released
        if (it >= STAGES) mbar_wait(empty + 8 * s, (it / STAGES - 1) & 1);
      };
      while (cur.next(am, ab, bmap, bb)) {
        for (int k = 0; k < ksteps; ++k, ++it) {
          const int s = it % STAGES;
          claim(s);
          flags[s] = 1;
          const uint32_t st = ring + s * STAGE_BYTES, bar = full + 8 * s;
          mbar_arrive_expect_tx(bar, STAGE_BYTES);
          tma_load_3d(st, &maps.a[am], k * KT, m0, ab, bar);
          tma_load_3d(st + A_BYTES, &maps.b[bmap], n0, k * KT, bb, bar);
          tma_load_3d(st + A_BYTES + ATOM_BYTES, &maps.b[bmap], n0 + 64, k * KT, bb, bar);
        }
      }
      const int s = it % STAGES;
      claim(s);
      flags[s] = 0;
      mbar_arrive(full + 8 * s);
      return;
    }

    // a consumer warpgroup: rows 64 wg .. 64 wg + 63 of the tile
    const int wg = warp / 4;
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int it = 0;; ++it) {
      const int s = it % STAGES;
      mbar_wait(full + 8 * s, (it / STAGES) & 1);
      if (flags[s] == 0) break;
      // A: this warpgroup's 64 rows, K-major, 32 bytes a 16-k step; B: N-major,
      // 16 k rows (2048 bytes) a step, its two 64-column atoms ATOM_BYTES apart
      const uint32_t a = ring + s * STAGE_BYTES + wg * ATOM_BYTES;
      const uint32_t b = ring + s * STAGE_BYTES + A_BYTES;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
        mma_m64n128k16_ss_tb(acc, desc(a + kk * 32, 16, 1024), desc(b + kk * 2048, ATOM_BYTES, 1024));
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

    // acc[4j + e] is (row r0, column 8j + cq + e), acc[4j + 2 + e] row r0 + 8;
    // bn % 8 == 0, so a column pair is wholly inside or outside the block
    const int r0 = m0 + 64 * wg + 16 * (warp % 4) + lane / 4, cq = 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
      const int col = n0 + 8 * j + cq;
      if (col >= bn) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h;
        if (row < bm)
          *reinterpret_cast<float2*>(Cb + static_cast<int64_t>(row) * bn + col) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
};

}  // namespace tile_gemm
