// Grouped block-sparse GEMM for Hopper (sm_90a):  C[c[t]] += A[a[t]] @ B[b[t]].
//
// Replaces the Pallas TPU kernel `_kernel` / `block_spmm_kernel_call` of
// src/repro/kernels/block_spmm.py, the numeric phase of every multiply,
// SpAMM and syrk of the library.  It computes exactly what that kernel
// computes: fp32 or bf16 leaf blocks A [nA, bm, bk] and B [nB, bk, bn], a
// task list sorted by output block, and fp32 output blocks C [num_out, bm, bn]
// accumulated in fp32.
//
// Design.  The TPU kernel carries its accumulator across sequential grid
// steps (zeroed at k == 0 on the first task of each output block).  Hopper
// blocks run in no order, so nothing may carry between them.  Instead the host
// turns the sorted output indices into CSR runs (run_ptr[num_out + 1]), and
// one thread block owns one TM x TN tile of one output block: grid
// (num_out, ceil(bm / TM), ceil(bn / TN)).  The block walks its run's tasks
// in ascending t and each task's k-tiles through shared memory, accumulates
// in fp32 registers, and stores its tile once.  So there are no atomics, no
// zero-initialisation race, the summation order is fixed (bit-identical
// results from launch to launch), and an empty run writes zeros, as the
// reference's segment_sum does.  Any block size works: loads and stores are
// masked at the ragged edge.  Offsets into the block stacks are 64-bit.
//
// Bound on an H100 SXM.  fp32 has no tensor-core path that keeps full fp32
// precision (TF32 would round the inputs), so the products run as plain FFMA:
// 2 * T * bm * bn * bk operations at 67 TFLOP/s.  Each task reuses a bk-long
// panel of A and B for TM * TN outputs, so for bs >= 32 the kernel is
// operation-bound; for small bs the bytes of A, B and C at 3.35 TB/s bound
// it.  This first version is simple: 64 x 64 tiles, 256 threads each holding
// a 4 x 4 register tile, k-tiles of 16 staged through shared memory with no
// asynchronous copies (the tile engine of tile_gemm.cuh, shared with
// fused_block_spmm.cu).  wgmma, TMA and persistent blocks are later work.

#include "tile_gemm.cuh"

namespace {

using namespace tile_gemm;

template <typename T>
__global__ void __launch_bounds__(THREADS)
block_spmm_kernel(const T* __restrict__ A, const T* __restrict__ B,
                  const int64_t* __restrict__ a_idx,
                  const int64_t* __restrict__ b_idx,
                  const int64_t* __restrict__ run_ptr,
                  float* __restrict__ C, int bm, int bk, int bn) {
  __shared__ Smem smem;
  const int64_t out = blockIdx.x;
  const int m0 = blockIdx.y * TM;
  const int n0 = blockIdx.z * TN;
  const int64_t a_stride = static_cast<int64_t>(bm) * bk;
  const int64_t b_stride = static_cast<int64_t>(bk) * bn;

  Acc acc;
  acc.zero();
  const int64_t t_end = run_ptr[out + 1];
  for (int64_t t = run_ptr[out]; t < t_end; ++t)
    accumulate_task(A + a_idx[t] * a_stride, B + b_idx[t] * b_stride, false,
                    m0, n0, bm, bk, bn, smem, acc);
  store_tile(C + out * static_cast<int64_t>(bm) * bn, acc, m0, n0, bm, bn);
}

template <typename T>
int launch(const void* A, const void* B, const void* a_idx, const void* b_idx,
           const void* run_ptr, void* C, long long num_out, int bm, int bk,
           int bn, void* stream) {
  if (num_out <= 0) return 0;
  const dim3 grid(static_cast<unsigned>(num_out), (bm + TM - 1) / TM,
                  (bn + TN - 1) / TN);
  block_spmm_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), static_cast<const T*>(B),
      static_cast<const int64_t*>(a_idx), static_cast<const int64_t*>(b_idx),
      static_cast<const int64_t*>(run_ptr), static_cast<float*>(C), bm, bk, bn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes.  Each returns cudaGetLastError()
// after the launch: 0 when the launch was accepted.
extern "C" int block_spmm_f32(const void* A, const void* B, const void* a_idx,
                              const void* b_idx, const void* run_ptr, void* C,
                              long long num_out, int bm, int bk, int bn,
                              void* stream) {
  return launch<float>(A, B, a_idx, b_idx, run_ptr, C, num_out, bm, bk, bn, stream);
}

extern "C" int block_spmm_bf16(const void* A, const void* B, const void* a_idx,
                               const void* b_idx, const void* run_ptr, void* C,
                               long long num_out, int bm, int bk, int bn,
                               void* stream) {
  return launch<__nv_bfloat16>(A, B, a_idx, b_idx, run_ptr, C, num_out, bm, bk,
                               bn, stream);
}

extern "C" const char* block_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
