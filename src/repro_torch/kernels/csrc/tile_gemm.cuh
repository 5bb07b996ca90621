// The tile engine shared by the port's grouped block GEMM kernels.
//
// One thread block owns one TM x TN tile of one fp32 output block.  It walks
// that output block's tasks in ascending order; for each task it stages the
// operand blocks through shared memory TK columns at a time and every thread
// accumulates an RM x RN register tile with one fmaf per product.  The sum of
// each output element is therefore one fp32 fmaf chain from 0, over the tasks
// in ascending order and within a task over k in ascending order.  Every
// kernel that runs its tasks through this engine gives bit-identical results
// for the same tasks in the same order (block_spmm.cu, fused_block_spmm.cu).
//
// Loads and stores are masked at the ragged edge, so any block size works,
// and block offsets are 64-bit.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace tile_gemm {

constexpr int TM = 64;        // output tile rows
constexpr int TN = 64;        // output tile columns
constexpr int TK = 16;        // contraction depth staged per step
constexpr int RM = 4;         // rows of the per-thread register tile
constexpr int RN = 4;         // columns of the per-thread register tile
constexpr int THREADS = (TM / RM) * (TN / RN);  // 256
constexpr int APAD = 4;       // keeps the transposed A tile's rows 16-byte aligned

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// fp32 -> bf16 (round to nearest even, as a bf16 cast does) -> fp32
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

struct Smem {
  __align__(16) float As[TK][TM + APAD];  // A tile, k-major
  __align__(16) float Bs[TK][TN];
};

struct Acc {
  float v[RM][RN];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) v[i][j] = 0.f;
  }
};

// acc += A[m0:m0+TM, :] @ B[:, n0:n0+TN] for one task's row-major blocks
// A [bm, bk] and B [bk, bn].  With `low`, each operand element is rounded to
// bf16 before its products (the adaptive precision mode).
template <typename T>
__device__ __forceinline__ void accumulate_task(const T* __restrict__ Ab,
                                                const T* __restrict__ Bb,
                                                bool low, int m0, int n0,
                                                int bm, int bk, int bn,
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
      float x = (gi < bm && gk < bk)
                    ? to_float(Ab[static_cast<int64_t>(gi) * bk + gk]) : 0.f;
      s.As[kk][i] = low ? round_bf16(x) : x;
    }
#pragma unroll
    for (int r = 0; r < TK * TN / THREADS; ++r) {
      const int l = tid + r * THREADS;
      const int kk = l / TN, j = l % TN;
      const int gk = k0 + kk, gj = n0 + j;
      float x = (gk < bk && gj < bn)
                    ? to_float(Bb[static_cast<int64_t>(gk) * bn + gj]) : 0.f;
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

// Write the thread's register tile into the row-major output block Cb [bm, bn].
__device__ __forceinline__ void store_tile(float* __restrict__ Cb, const Acc& acc,
                                           int m0, int n0, int bm, int bn) {
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

}  // namespace tile_gemm
