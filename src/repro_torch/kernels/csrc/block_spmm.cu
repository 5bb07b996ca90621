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
// in ascending t through a tile engine of tile_gemm.cuh (shared with
// fused_block_spmm.cu), accumulates in fp32 registers, and stores its tile
// once.  So there are no atomics, no zero-initialisation race, the summation
// order is fixed (bit-identical results from launch to launch), and an empty
// run writes zeros, as the reference's segment_sum does.  The engine follows
// the block size (tile_gemm::use_tile128): bm and bn multiples of 128 take
// the 128 x 128 engine (8 x 8 registers a thread, a three-stage cp.async
// ring, one barrier per stage), every other size the masked 64 x 64 engine,
// so any block size works.  Both give the same bits.  Offsets into the
// block stacks are 64-bit.
//
// Bound on an H100 SXM.  fp32 has no tensor-core path that keeps full fp32
// precision (TF32 would round the inputs), so the products run as plain FFMA:
// 2 * T * bm * bn * bk operations at 67 TFLOP/s.  Each task reuses a bk-long
// panel of A and B for TM * TN outputs, so for bs >= 32 the kernel is
// operation-bound; for small bs the bytes of A, B and C at 3.35 TB/s bound
// it.  What still holds the 128 engine back is set out in tile_gemm.cuh;
// bf16 stores convert to fp32 in shared memory and run as FFMA too (no
// tensor-core path yet).

#include "tile_gemm.cuh"

namespace {

using namespace tile_gemm;

// The tasks of one output block's run, in ascending t.
template <typename T>
struct RunCursor {
  const T* A;
  const T* B;
  const int64_t* a_idx;
  const int64_t* b_idx;
  int64_t t, t_end, a_stride, b_stride;

  __device__ __forceinline__ bool next(const T*& Ab, const T*& Bb, bool& low) {
    if (t >= t_end) return false;
    Ab = A + a_idx[t] * a_stride;
    Bb = B + b_idx[t] * b_stride;
    low = false;
    ++t;
    return true;
  }
};

template <typename T, typename Engine>
__global__ void __launch_bounds__(THREADS, Engine::MIN_BLOCKS)
block_spmm_kernel(const T* __restrict__ A, const T* __restrict__ B,
                  const int64_t* __restrict__ a_idx,
                  const int64_t* __restrict__ b_idx,
                  const int64_t* __restrict__ run_ptr,
                  float* __restrict__ C, int bm, int bk, int bn) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t out = blockIdx.x;
  const RunCursor<T> cur{A, B, a_idx, b_idx, run_ptr[out], run_ptr[out + 1],
                         static_cast<int64_t>(bm) * bk, static_cast<int64_t>(bk) * bn};
  Engine::template run<T>(cur, C + out * static_cast<int64_t>(bm) * bn,
                          blockIdx.y * Engine::TM, blockIdx.z * Engine::TN, bm, bk, bn, smem);
}

template <typename T, typename Engine>
int launch_engine(const void* A, const void* B, const void* a_idx, const void* b_idx,
                  const void* run_ptr, void* C, long long num_out, int bm, int bk, int bn,
                  size_t smem, cudaStream_t stream) {
  const auto kernel = block_spmm_kernel<T, Engine>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(num_out), (bm + Engine::TM - 1) / Engine::TM,
                  (bn + Engine::TN - 1) / Engine::TN);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(B),
      static_cast<const int64_t*>(a_idx), static_cast<const int64_t*>(b_idx),
      static_cast<const int64_t*>(run_ptr), static_cast<float*>(C), bm, bk, bn);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* A, const void* B, const void* a_idx, const void* b_idx,
           const void* run_ptr, void* C, long long num_out, int bm, int bk,
           int bn, void* stream_ptr) {
  if (num_out <= 0) return 0;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const void* ptrs[2] = {A, B};
  if (use_tile128(bm, bk, bn, ptrs, 2))
    return launch_engine<T, Tile128>(A, B, a_idx, b_idx, run_ptr, C, num_out, bm, bk, bn,
                                     Tile128::smem_bytes<T>(), stream);
  return launch_engine<T, Tile64>(A, B, a_idx, b_idx, run_ptr, C, num_out, bm, bk, bn,
                                  Tile64::smem_bytes, stream);
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
