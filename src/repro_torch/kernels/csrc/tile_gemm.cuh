// The tile engines shared by the port's grouped block GEMM kernels.
//
// One thread block owns one tile of one fp32 output block.  It walks that
// output block's tasks in ascending order (a Cursor hands it each task's A
// and B block and its `low` flag), streams each task's operands through
// shared memory TK = 16 columns of A (rows of B) at a time, and every thread
// accumulates a register tile with one fmaf per product.  The sum of each
// output element is therefore one fp32 fmaf chain from 0, over the tasks in
// ascending order and within a task over k in ascending order (a ragged k
// edge pads to a multiple of 16 with zeros).  The chain depends neither on
// the tile shape nor on the engine, so every kernel that runs its tasks
// through these engines gives bit-identical results for the same tasks in
// the same order (block_spmm.cu, fused_block_spmm.cu), whichever engine the
// block size selects.  With `low` (the adaptive precision mode) each operand
// element is rounded to bf16 before its products.
//
// Two engines, picked by one rule (use_tile128) in both kernels:
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
// - Tile64, for every other shape (bs 8-96, ragged 130 or 70, unaligned
//   rows): 64 x 64 tiles, 256 threads with a 4 x 4 register tile, staged
//   synchronously through shared memory with masked scalar loads that
//   convert and round as they stage.  Any block size works.
//
// Offsets into the block stacks are 64-bit.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace tile_gemm {

constexpr int THREADS = 256;  // both engines
constexpr int TK = 16;        // contraction depth per stage, both engines (fixes the zero padding)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// fp32 -> bf16 (round to nearest even, as a bf16 cast does) -> fp32
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The engine for a block shape: the same rule in every kernel, so the
// kernels agree on it.  Tile128 needs whole 128 x 128 tiles, rows of whole
// 16-byte chunks and 16-byte aligned stacks.
inline bool use_tile128(int bm, int bk, int bn, const void* const* ptrs, int nptrs) {
  if (bm <= 0 || bn <= 0 || bk <= 0 || bm % 128 || bn % 128 || bk % 8) return false;
  for (int i = 0; i < nptrs; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return false;
  return true;
}

// ---------------------------------------------------------------- Tile64

struct Tile64 {
  static constexpr int TM = 64, TN = 64, RM = 4, RN = 4, MIN_BLOCKS = 1;
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
  static constexpr int TM = 128, TN = 128, STAGES = 3;
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

}  // namespace tile_gemm
