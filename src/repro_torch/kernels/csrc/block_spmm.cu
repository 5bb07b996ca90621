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
// one thread block owns one tile of one or more output blocks: it walks their
// runs' tasks in ascending t through a tile engine of tile_gemm.cuh (shared
// with fused_block_spmm.cu), accumulates in fp32 registers, and stores its
// tile once.  So there are no atomics, no zero-initialisation race, the
// summation order is fixed (bit-identical results from launch to launch), and
// an empty run writes zeros, as the reference's segment_sum does.  The engine
// follows the block shape (tile_gemm::pick_engine), or the engine id the
// caller forces (with TileRows' pack R, tile_gemm::pick_pack: the tile
// autotuner's pair):
//
// - Tile128 (bm and bn multiples of 128, aligned): grid (num_out, bm / 128,
//   bn / 128), 8 x 8 registers a thread, a three-stage cp.async ring, one
//   barrier per stage;
// - TileRows (bm <= 64): a 1-D grid of ceil(num_out / R) * ceil(bn / TN)
//   tiles, each packing R consecutive output blocks (at most 16, at bm 8
//   and bn above 64) that walk their runs in steps sharing one staged B panel
//   (PackedRuns below), 4 x 8 or 8 x 8 registers a thread, the same ring;
// - Tile64 (everything else): grid (num_out, ceil(bm / 64), ceil(bn / 64)),
//   the masked synchronous 64 x 64 engine, so any block size works;
// - TileTC (bf16 stores, bm >= 64, bk and bn multiples of 8, aligned): a 1-D
//   grid of num_out * ceil(bm / rows) * ceil(bn / 128) tiles, rows the whole
//   block up to 256, wgmma fed by TMA from one tensor map over each stack
//   (TcRunCursor below names the task's blocks).
//
// The three FFMA engines give the same bits; TileTC gives its own (one fp32
// sum in tensor-core order, tile_gemm.cuh).  Offsets into the block stacks
// are 64-bit.
//
// Bound on an H100 SXM.  fp32 has no tensor-core path that keeps full fp32
// precision (TF32 would round the inputs), so the products run as plain FFMA:
// 2 * T * bm * bn * bk operations at 67 TFLOP/s.  Each task reuses a bk-long
// panel of A and B for its tile's outputs, so for bs >= 32 the kernel is
// operation-bound; for small bs the bytes of A, B and C at 3.35 TB/s bound
// it.  The dropless grouped GEMM (bm 8, one [4096, 1536] expert weight per
// group) is operation-bound only because TileRows stages each expert's B
// panel once for 16 tiles: one tile per task would read 209 GB of weights
// through L2 for 3.2 GB of distinct ones.  bf16 stores run on the tensor
// cores at 989 TFLOP/s, where the bytes bound the tall-skinny expert GEMMs
// (kimi-k2's [107, 7168] x [7168, 2048]: the weights).  What still holds
// each engine back is set out in tile_gemm.cuh.

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

// The tasks of a TileRows tile's packed output blocks out0 .. out0 + nblk - 1.
template <typename T>
struct PackedRuns {
  const T* A;
  const T* B;
  const int64_t* a_idx;
  const int64_t* b_idx;
  const int64_t* run_ptr;
  float* C;
  int64_t out0, a_stride, b_stride, c_stride;

  __device__ __forceinline__ int64_t begin(int r) const { return run_ptr[out0 + r]; }
  __device__ __forceinline__ int64_t end(int r) const { return run_ptr[out0 + r + 1]; }
  __device__ __forceinline__ void skip(int64_t&, int&) const {}
  __device__ __forceinline__ const T* a(int64_t t) const { return A + a_idx[t] * a_stride; }
  __device__ __forceinline__ const T* b(int64_t t) const { return B + b_idx[t] * b_stride; }
  __device__ __forceinline__ bool low(int64_t) const { return false; }
  __device__ __forceinline__ float* out(int r) const { return C + (out0 + r) * c_stride; }
};

// The tasks of one output block's run for TileTC, in ascending t: the
// blocks of the one A and one B stack (map 0).
struct TcRunCursor {
  const int64_t* a_idx;
  const int64_t* b_idx;
  int64_t t, t_end;

  __device__ __forceinline__ bool next(int& am, int& ab, int& bmap, int& bb) {
    if (t >= t_end) return false;
    am = bmap = 0;
    ab = static_cast<int>(a_idx[t]);
    bb = static_cast<int>(b_idx[t]);
    ++t;
    return true;
  }
};

template <typename T, typename Engine>
__global__ void __launch_bounds__(Engine::THREADS, Engine::MIN_BLOCKS)
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

template <typename T, typename Engine, bool VEC>
__global__ void __launch_bounds__(Engine::THREADS, Engine::MIN_BLOCKS)
block_spmm_rows_kernel(const T* __restrict__ A, const T* __restrict__ B,
                       const int64_t* __restrict__ a_idx,
                       const int64_t* __restrict__ b_idx,
                       const int64_t* __restrict__ run_ptr,
                       float* __restrict__ C, int64_t num_out, int bm, int bk, int bn,
                       int R) {
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t group;
  int ntile;
  Engine::tile_of(blockIdx.x, bn, group, ntile);
  const int64_t out0 = group * R;
  const int nblk = static_cast<int>(num_out - out0 < R ? num_out - out0 : R);
  const PackedRuns<T> runs{A, B, a_idx, b_idx, run_ptr, C, out0,
                           static_cast<int64_t>(bm) * bk, static_cast<int64_t>(bk) * bn,
                           static_cast<int64_t>(bm) * bn};
  Engine::template run<T, VEC>(runs, nblk, bm, bk, bn, ntile * Engine::TN, smem);
}

// TileTC: block b of the 1-D grid is (output block, row tile, column tile),
// the column tile fastest
template <int WG>
__global__ void __launch_bounds__(TileTC<WG>::THREADS, TileTC<WG>::MIN_BLOCKS)
block_spmm_tc_kernel(const __grid_constant__ TcMaps maps, const int64_t* __restrict__ a_idx,
                     const int64_t* __restrict__ b_idx, const int64_t* __restrict__ run_ptr,
                     float* __restrict__ C, int bm, int bk, int bn) {
  using Engine = TileTC<WG>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tn = Engine::tiles_n(bn), tm = Engine::tiles_m(bm);
  const int64_t b = blockIdx.x;
  const int nt = static_cast<int>(b % tn), mt = static_cast<int>(b / tn % tm);
  const int64_t out = b / tn / tm;
  Engine::run(TcRunCursor{a_idx, b_idx, run_ptr[out], run_ptr[out + 1]}, maps,
              C + out * static_cast<int64_t>(bm) * bn, mt * Engine::TM, nt * Engine::TN, bm, bk,
              bn, smem);
}

template <int WG>
int launch_tc_wg(const TcMaps& maps, const void* a_idx, const void* b_idx, const void* run_ptr,
                 void* C, long long num_out, int bm, int bk, int bn, cudaStream_t stream) {
  using Engine = TileTC<WG>;
  const auto kernel = block_spmm_tc_kernel<WG>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(Engine::smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = num_out * Engine::tiles_m(bm) * Engine::tiles_n(bn);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned>(tiles), Engine::THREADS, Engine::smem_bytes, stream>>>(
      maps, static_cast<const int64_t*>(a_idx), static_cast<const int64_t*>(b_idx),
      static_cast<const int64_t*>(run_ptr), static_cast<float*>(C), bm, bk, bn);
  return static_cast<int>(cudaGetLastError());
}

// TileTC on bf16 stacks: one tensor map over each (their block counts are
// not passed, so the maps bound the block index at 2^31 - 1, past any task's)
int launch_tc(const void* A, const void* B, const void* a_idx, const void* b_idx,
              const void* run_ptr, void* C, long long num_out, int bm, int bk, int bn,
              cudaStream_t stream) {
  const void* a[2] = {A, nullptr};
  const void* b[2] = {B, nullptr};
  const long long na[2] = {0x7fffffffLL, 0}, nb[2] = {0x7fffffffLL, 0};
  TcMaps maps;
  if (!tc_maps(maps, a, na, b, nb, bm, bk, bn, C)) return static_cast<int>(cudaErrorInvalidValue);
  switch (tiletc_warpgroups(bm)) {
    case 1: return launch_tc_wg<1>(maps, a_idx, b_idx, run_ptr, C, num_out, bm, bk, bn, stream);
    case 2: return launch_tc_wg<2>(maps, a_idx, b_idx, run_ptr, C, num_out, bm, bk, bn, stream);
    case 3: return launch_tc_wg<3>(maps, a_idx, b_idx, run_ptr, C, num_out, bm, bk, bn, stream);
    default: return launch_tc_wg<4>(maps, a_idx, b_idx, run_ptr, C, num_out, bm, bk, bn, stream);
  }
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
  kernel<<<grid, Engine::THREADS, smem, stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(B),
      static_cast<const int64_t*>(a_idx), static_cast<const int64_t*>(b_idx),
      static_cast<const int64_t*>(run_ptr), static_cast<float*>(C), bm, bk, bn);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename Engine, bool VEC>
int launch_rows_tn(const void* A, const void* B, const void* a_idx, const void* b_idx,
                   const void* run_ptr, void* C, long long num_out, int bm, int bk, int bn,
                   int R, cudaStream_t stream) {
  if (R < 1 || R > Engine::pack(bm)) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = block_spmm_rows_kernel<T, Engine, VEC>;
  const size_t smem = Engine::template smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = Engine::groups(num_out, R) * Engine::tiles_n(bn);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(tiles));
  kernel<<<grid, Engine::THREADS, smem, stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(B),
      static_cast<const int64_t*>(a_idx), static_cast<const int64_t*>(b_idx),
      static_cast<const int64_t*>(run_ptr), static_cast<float*>(C), num_out, bm, bk, bn, R);
  return static_cast<int>(cudaGetLastError());
}

// TileRows: TN the least of 32, 64, 128 that holds bn (tiles of 128 past
// it); whole 16-byte chunks by cp.async where every chunk is whole and
// aligned, masked scalar loads otherwise; R output blocks a tile.
template <typename T, bool VEC>
int launch_rows_vec(const void* A, const void* B, const void* a_idx, const void* b_idx,
                    const void* run_ptr, void* C, long long num_out, int bm, int bk, int bn,
                    int R, cudaStream_t stream) {
  if (bn <= 32)
    return launch_rows_tn<T, TileRows<32, 4>, VEC>(A, B, a_idx, b_idx, run_ptr, C, num_out, bm, bk, bn, R, stream);
  if (bn <= 64)
    return launch_rows_tn<T, TileRows<64, 4>, VEC>(A, B, a_idx, b_idx, run_ptr, C, num_out, bm, bk, bn, R, stream);
  return launch_rows_tn<T, TileRows<128, 8>, VEC>(A, B, a_idx, b_idx, run_ptr, C, num_out, bm, bk, bn, R, stream);
}

template <typename T>
int launch_rows(const void* A, const void* B, const void* a_idx, const void* b_idx,
                const void* run_ptr, void* C, long long num_out, int bm, int bk, int bn,
                int R, const void* const* ptrs, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  if (bk % E == 0 && bn % E == 0 && aligned16(ptrs, 2))
    return launch_rows_vec<T, true>(A, B, a_idx, b_idx, run_ptr, C, num_out, bm, bk, bn, R, stream);
  return launch_rows_vec<T, false>(A, B, a_idx, b_idx, run_ptr, C, num_out, bm, bk, bn, R, stream);
}

template <typename T>
int launch(const void* A, const void* B, const void* a_idx, const void* b_idx,
           const void* run_ptr, void* C, long long num_out, int bm, int bk,
           int bn, void* stream_ptr, int engine, int pack) {
  const void* ptrs[2] = {A, B};
  const int picked = pick_engine(engine, bm, bk, bn, ptrs, 2, sizeof(T) == 2);
  if (picked < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int R = pick_pack(picked, pack, bm, bn);
  if (R < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (num_out <= 0) return 0;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if constexpr (sizeof(T) == 2) {
    if (picked == ENGINE_TILETC)
      return launch_tc(A, B, a_idx, b_idx, run_ptr, C, num_out, bm, bk, bn, stream);
  }
  if (picked == ENGINE_TILE128)
    return launch_engine<T, Tile128>(A, B, a_idx, b_idx, run_ptr, C, num_out, bm, bk, bn,
                                     Tile128::smem_bytes<T>(), stream);
  if (picked == ENGINE_TILEROWS)
    return launch_rows<T>(A, B, a_idx, b_idx, run_ptr, C, num_out, bm, bk, bn, R, ptrs, stream);
  return launch_engine<T, Tile64>(A, B, a_idx, b_idx, run_ptr, C, num_out, bm, bk, bn,
                                  Tile64::smem_bytes, stream);
}

}  // namespace

// Plain C entry points, loaded with ctypes.  `engine` is 0 for the rule or
// a tile_gemm::Engine id that forces one; `pack` is 0 for the engine's rule
// or the output blocks a TileRows tile packs (tile_gemm::pick_pack).  An
// engine that cannot take the shape, or a pack it does not take, is refused
// with cudaErrorInvalidValue.  Each returns cudaGetLastError() after the
// launch: 0 when the launch was accepted.
extern "C" int block_spmm_f32(const void* A, const void* B, const void* a_idx,
                              const void* b_idx, const void* run_ptr, void* C,
                              long long num_out, int bm, int bk, int bn,
                              void* stream, int engine, int pack) {
  return launch<float>(A, B, a_idx, b_idx, run_ptr, C, num_out, bm, bk, bn, stream, engine, pack);
}

extern "C" int block_spmm_bf16(const void* A, const void* B, const void* a_idx,
                               const void* b_idx, const void* run_ptr, void* C,
                               long long num_out, int bm, int bk, int bn,
                               void* stream, int engine, int pack) {
  return launch<__nv_bfloat16>(A, B, a_idx, b_idx, run_ptr, C, num_out, bm, bk,
                               bn, stream, engine, pack);
}

extern "C" const char* block_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
