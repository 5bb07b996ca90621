// Fused leaf engine for Hopper (sm_90a): unpack + grouped block GEMM +
// C-accumulate for every worker of the resident runtime in one launch.
//
// Replaces the Pallas TPU kernel `_kernel` / `fused_block_spmm_kernel_call`
// of src/repro/kernels/fused_leaf.py, the numeric phase of every resident
// multiply (dist_multiply, dist_spamm).  It computes what that kernel
// computes, for all P workers at once:
//
//   C[p, c] = sum over the tasks t of worker p with c[p, t] == c and on[p, t]
//             of  opA(p, t) @ opB(p, t)
//
// where an operand is addressed as (src, off): src == 0 reads row `off` of
// the worker's own store [cap, bm, bk]; src == r + 1 reads row `off` of its
// receive buffer r in the stacked receive buffers [R, capU, bm, bk].  The
// concatenated [own | recv ...] operand buffer of the staged path is never
// built.  Stores are fp32 or bf16 (read as they are); accumulation is fp32.
// In adaptive mode a task with low[p, t] set has every fp32 operand element
// rounded to bf16 (round to nearest even) before its products.
//
// Design.  The TPU kernel walks its grid in order and zeroes a revisited
// output row when c[t] != c[t-1].  Hopper blocks run in no order, so here one
// thread block owns one tile of one or more output blocks of one worker.  It
// walks each output block's CSR run of tasks (run_ptr[p, c] ..
// run_ptr[p, c + 1], built on the host once per plan from the plan's sorted
// task_c), skips the tasks whose `on` flag is clear (the delta-plan SpAMM
// mask: no trash-row redirect, so a masked task in the middle of a run cannot
// break the run), selects the store or the receive stack pointer per task,
// and accumulates through a tile engine of tile_gemm.cuh, picked by the same
// rule as block_spmm.cu (tile_gemm::pick_engine) or forced by the caller:
//
// - Tile128 (bm and bn multiples of 128, aligned stores): grid (num_out,
//   m-tiles * n-tiles, P), 8 x 8 registers a thread, three-stage cp.async ring;
// - TileRows (bm <= 64): grid (groups * n-tiles, 1, P), each tile packing R
//   consecutive output blocks of one worker, whose runs step
//   together where their head tasks name the same B operand (the same
//   (src, off) and the same `low` flag; FusedPackedRuns below);
// - Tile64 (everything else): grid (num_out, m-tiles * n-tiles, P), the
//   masked synchronous 64 x 64 engine.
//
// bf16 stores and the adaptive `low` rounding convert to fp32 in the engine,
// as they are read.  Each output element is one fp32 fmaf chain from 0 over
// the run's tasks in ascending order, exactly as block_spmm.cu sums it
// whichever engine runs, so the fused and staged paths, the masked path with
// every task on and the single-device multiply agree bit for bit.  No
// atomics; an empty run writes zeros; the padded tasks past a worker's count
// are never visited.  Any block size and 64-bit offsets everywhere.
//
// Bound on an H100 SXM.  fp32 stays fp32 (plain FFMA, never TF32):
// 2 * T * bm * bn * bk operations at 67 TFLOP/s, where T counts the tasks
// that are on; for the N = 8192 band at bs 128 (104,664 tasks) that is
// 6.55 ms.  The bytes (each referenced operand block read once, the task
// arrays, each output block written once in fp32) at 3.35 TB/s bound it only
// below bs ~ 32.  What still holds it back is what holds the engines back
// (tile_gemm.cuh), and bf16 stores run as FFMA (no tensor-core path yet).

#include "tile_gemm.cuh"

namespace {

using namespace tile_gemm;

struct Dims {
  int64_t num_out;   // output blocks per worker
  int64_t t_cap;     // task slots per worker
  int64_t a_cap, a_rounds, a_capu;
  int64_t b_cap, b_rounds, b_capu;
  int bm, bk, bn, n_tiles_n;
};

// The on tasks of one output block's run of one worker, in ascending t,
// each operand read from the worker's own store (src == 0) or from receive
// buffer src - 1 of its stacked receive buffers.
template <typename T>
struct FusedCursor {
  const T* a_store;
  const T* a_recv;
  const T* b_store;
  const T* b_recv;
  const int64_t* a_src;
  const int64_t* a_off;
  const int64_t* b_src;
  const int64_t* b_off;
  const uint8_t* on;
  const uint8_t* low;
  Dims d;
  int64_t p, task0, t, t_end;

  __device__ __forceinline__ static const T* operand(const T* store, const T* recv, int64_t src,
                                                     int64_t off, int64_t p, int64_t cap,
                                                     int64_t rounds, int64_t capu, int64_t blk) {
    return src == 0 ? store + (p * cap + off) * blk
                    : recv + ((p * rounds + (src - 1)) * capu + off) * blk;
  }

  __device__ __forceinline__ bool next(const T*& Ab, const T*& Bb, bool& is_low) {
    for (; t < t_end; ++t) {
      const int64_t i = task0 + t;
      if (on != nullptr && on[i] == 0) continue;  // uniform across the block
      Ab = operand(a_store, a_recv, a_src[i], a_off[i], p, d.a_cap, d.a_rounds, d.a_capu,
                   static_cast<int64_t>(d.bm) * d.bk);
      Bb = operand(b_store, b_recv, b_src[i], b_off[i], p, d.b_cap, d.b_rounds, d.b_capu,
                   static_cast<int64_t>(d.bk) * d.bn);
      is_low = low != nullptr && low[i] != 0;
      ++t;
      return true;
    }
    return false;
  }
};

// The on tasks of a TileRows tile's packed output blocks out0 .. out0 +
// nblk - 1 of worker p.
template <typename T>
struct FusedPackedRuns {
  FusedCursor<T> f;  // operands and flags of worker p (t, t_end unused)
  const int64_t* runs;
  float* C;
  int64_t out0;

  __device__ __forceinline__ int64_t begin(int r) const { return runs[out0 + r]; }
  __device__ __forceinline__ int64_t end(int r) const { return runs[out0 + r + 1]; }
  __device__ __forceinline__ void skip(int64_t& t, int& left) const {
    if (f.on == nullptr) return;
    while (left > 0 && f.on[f.task0 + t] == 0) {
      ++t;
      --left;
    }
  }
  __device__ __forceinline__ const T* a(int64_t t) const {
    const int64_t i = f.task0 + t;
    return FusedCursor<T>::operand(f.a_store, f.a_recv, f.a_src[i], f.a_off[i], f.p, f.d.a_cap,
                                   f.d.a_rounds, f.d.a_capu, static_cast<int64_t>(f.d.bm) * f.d.bk);
  }
  __device__ __forceinline__ const T* b(int64_t t) const {
    const int64_t i = f.task0 + t;
    return FusedCursor<T>::operand(f.b_store, f.b_recv, f.b_src[i], f.b_off[i], f.p, f.d.b_cap,
                                   f.d.b_rounds, f.d.b_capu, static_cast<int64_t>(f.d.bk) * f.d.bn);
  }
  __device__ __forceinline__ bool low(int64_t t) const {
    return f.low != nullptr && f.low[f.task0 + t] != 0;
  }
  __device__ __forceinline__ float* out(int r) const {
    return C + (f.p * f.d.num_out + out0 + r) * static_cast<int64_t>(f.d.bm) * f.d.bn;
  }
};

template <typename T, typename Engine>
__global__ void __launch_bounds__(Engine::THREADS, Engine::MIN_BLOCKS)
fused_block_spmm_kernel(const T* __restrict__ a_store, const T* __restrict__ a_recv,
                        const T* __restrict__ b_store, const T* __restrict__ b_recv,
                        const int64_t* __restrict__ a_src,
                        const int64_t* __restrict__ a_off,
                        const int64_t* __restrict__ b_src,
                        const int64_t* __restrict__ b_off,
                        const int64_t* __restrict__ run_ptr,
                        const uint8_t* __restrict__ on,
                        const uint8_t* __restrict__ low,
                        float* __restrict__ C, Dims d) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t out = blockIdx.x;
  const int m0 = (blockIdx.y / d.n_tiles_n) * Engine::TM;
  const int n0 = (blockIdx.y % d.n_tiles_n) * Engine::TN;
  const int64_t p = blockIdx.z;
  const int64_t* runs = run_ptr + p * (d.num_out + 1);
  const FusedCursor<T> cur{a_store, a_recv, b_store, b_recv, a_src, a_off, b_src, b_off, on, low,
                           d, p, p * d.t_cap, runs[out], runs[out + 1]};
  Engine::template run<T>(cur, C + (p * d.num_out + out) * static_cast<int64_t>(d.bm) * d.bn,
                          m0, n0, d.bm, d.bk, d.bn, smem);
}

template <typename T, typename Engine, bool VEC>
__global__ void __launch_bounds__(Engine::THREADS, Engine::MIN_BLOCKS)
fused_block_spmm_rows_kernel(const T* __restrict__ a_store, const T* __restrict__ a_recv,
                             const T* __restrict__ b_store, const T* __restrict__ b_recv,
                             const int64_t* __restrict__ a_src,
                             const int64_t* __restrict__ a_off,
                             const int64_t* __restrict__ b_src,
                             const int64_t* __restrict__ b_off,
                             const int64_t* __restrict__ run_ptr,
                             const uint8_t* __restrict__ on,
                             const uint8_t* __restrict__ low,
                             float* __restrict__ C, Dims d) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = Engine::pack(d.bm);
  int64_t group;
  int ntile;
  Engine::tile_of(blockIdx.x, d.bn, group, ntile);
  const int64_t out0 = group * R;
  const int nblk = static_cast<int>(d.num_out - out0 < R ? d.num_out - out0 : R);
  const int64_t p = blockIdx.z;
  const FusedPackedRuns<T> runs{
      FusedCursor<T>{a_store, a_recv, b_store, b_recv, a_src, a_off, b_src, b_off, on, low, d, p,
                     p * d.t_cap, 0, 0},
      run_ptr + p * (d.num_out + 1), C, out0};
  Engine::template run<T, VEC>(runs, nblk, d.bm, d.bk, d.bn, ntile * Engine::TN, smem);
}

template <typename T, typename Engine>
int launch_engine(const void* a_store, const void* a_recv, const void* b_store,
                  const void* b_recv, const void* a_src, const void* a_off,
                  const void* b_src, const void* b_off, const void* run_ptr,
                  const void* on, const void* low, void* C, long long nparts, Dims d,
                  size_t smem, cudaStream_t stream) {
  const int tiles_m = (d.bm + Engine::TM - 1) / Engine::TM;
  const int tiles_n = (d.bn + Engine::TN - 1) / Engine::TN;
  if (nparts > 65535 || static_cast<long long>(tiles_m) * tiles_n > 65535 ||
      d.num_out > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  d.n_tiles_n = tiles_n;
  const auto kernel = fused_block_spmm_kernel<T, Engine>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(d.num_out), static_cast<unsigned>(tiles_m * tiles_n),
                  static_cast<unsigned>(nparts));
  kernel<<<grid, Engine::THREADS, smem, stream>>>(
      static_cast<const T*>(a_store), static_cast<const T*>(a_recv),
      static_cast<const T*>(b_store), static_cast<const T*>(b_recv),
      static_cast<const int64_t*>(a_src), static_cast<const int64_t*>(a_off),
      static_cast<const int64_t*>(b_src), static_cast<const int64_t*>(b_off),
      static_cast<const int64_t*>(run_ptr), static_cast<const uint8_t*>(on),
      static_cast<const uint8_t*>(low), static_cast<float*>(C), d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename Engine, bool VEC>
int launch_rows_tn(const void* a_store, const void* a_recv, const void* b_store,
                   const void* b_recv, const void* a_src, const void* a_off,
                   const void* b_src, const void* b_off, const void* run_ptr,
                   const void* on, const void* low, void* C, long long nparts, Dims d,
                   cudaStream_t stream) {
  const long long tiles = Engine::groups(d.num_out, d.bm) * Engine::tiles_n(d.bn);
  if (nparts > 65535 || tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto kernel = fused_block_spmm_rows_kernel<T, Engine, VEC>;
  const size_t smem = Engine::template smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(tiles), 1, static_cast<unsigned>(nparts));
  kernel<<<grid, Engine::THREADS, smem, stream>>>(
      static_cast<const T*>(a_store), static_cast<const T*>(a_recv),
      static_cast<const T*>(b_store), static_cast<const T*>(b_recv),
      static_cast<const int64_t*>(a_src), static_cast<const int64_t*>(a_off),
      static_cast<const int64_t*>(b_src), static_cast<const int64_t*>(b_off),
      static_cast<const int64_t*>(run_ptr), static_cast<const uint8_t*>(on),
      static_cast<const uint8_t*>(low), static_cast<float*>(C), d);
  return static_cast<int>(cudaGetLastError());
}

// TileRows: TN the least of 32, 64, 128 that holds bn; cp.async where every
// chunk is whole and every store aligned, masked scalar loads otherwise.
template <typename T, bool VEC>
int launch_rows_vec(const void* a_store, const void* a_recv, const void* b_store,
                    const void* b_recv, const void* a_src, const void* a_off,
                    const void* b_src, const void* b_off, const void* run_ptr,
                    const void* on, const void* low, void* C, long long nparts, Dims d,
                    cudaStream_t stream) {
  if (d.bn <= 32)
    return launch_rows_tn<T, TileRows<32, 4>, VEC>(a_store, a_recv, b_store, b_recv, a_src, a_off,
                                                b_src, b_off, run_ptr, on, low, C, nparts, d, stream);
  if (d.bn <= 64)
    return launch_rows_tn<T, TileRows<64, 4>, VEC>(a_store, a_recv, b_store, b_recv, a_src, a_off,
                                                b_src, b_off, run_ptr, on, low, C, nparts, d, stream);
  return launch_rows_tn<T, TileRows<128, 8>, VEC>(a_store, a_recv, b_store, b_recv, a_src, a_off,
                                               b_src, b_off, run_ptr, on, low, C, nparts, d, stream);
}

template <typename T>
int launch(const void* a_store, const void* a_recv, const void* b_store,
           const void* b_recv, const void* a_src, const void* a_off,
           const void* b_src, const void* b_off, const void* run_ptr,
           const void* on, const void* low, void* C, long long nparts,
           long long num_out, long long t_cap, long long a_cap,
           long long a_rounds, long long a_capu, long long b_cap,
           long long b_rounds, long long b_capu, int bm, int bk, int bn,
           void* stream_ptr, int engine) {
  const void* ptrs[4] = {a_store, a_recv, b_store, b_recv};
  const int picked = pick_engine(engine, bm, bk, bn, ptrs, 4);
  if (picked < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (nparts <= 0 || num_out <= 0) return 0;
  const Dims d{num_out, t_cap, a_cap, a_rounds, a_capu, b_cap, b_rounds, b_capu,
               bm, bk, bn, 0};
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (picked == ENGINE_TILE128)
    return launch_engine<T, Tile128>(a_store, a_recv, b_store, b_recv, a_src, a_off, b_src,
                                     b_off, run_ptr, on, low, C, nparts, d,
                                     Tile128::smem_bytes<T>(), stream);
  if (picked == ENGINE_TILEROWS) {
    constexpr int E = 16 / sizeof(T);
    if (bk % E == 0 && bn % E == 0 && aligned16(ptrs, 4))
      return launch_rows_vec<T, true>(a_store, a_recv, b_store, b_recv, a_src, a_off, b_src,
                                      b_off, run_ptr, on, low, C, nparts, d, stream);
    return launch_rows_vec<T, false>(a_store, a_recv, b_store, b_recv, a_src, a_off, b_src,
                                     b_off, run_ptr, on, low, C, nparts, d, stream);
  }
  return launch_engine<T, Tile64>(a_store, a_recv, b_store, b_recv, a_src, a_off, b_src, b_off,
                                  run_ptr, on, low, C, nparts, d, Tile64::smem_bytes, stream);
}

}  // namespace

// Plain C entry points, loaded with ctypes.  `on` and `low` may be null (every
// task on; no rounding).  `engine` is 0 for the rule or a tile_gemm::Engine id
// that forces one; an engine that cannot take the shape is refused with
// cudaErrorInvalidValue.  Each returns cudaGetLastError() after the launch:
// 0 when the launch was accepted.
#define FUSED_ENTRY(NAME, T)                                                    \
  extern "C" int NAME(const void* a_store, const void* a_recv,                 \
                      const void* b_store, const void* b_recv,                 \
                      const void* a_src, const void* a_off, const void* b_src, \
                      const void* b_off, const void* run_ptr, const void* on,  \
                      const void* low, void* C, long long nparts,              \
                      long long num_out, long long t_cap, long long a_cap,     \
                      long long a_rounds, long long a_capu, long long b_cap,   \
                      long long b_rounds, long long b_capu, int bm, int bk,    \
                      int bn, void* stream, int engine) {                      \
    return launch<T>(a_store, a_recv, b_store, b_recv, a_src, a_off, b_src,    \
                     b_off, run_ptr, on, low, C, nparts, num_out, t_cap,       \
                     a_cap, a_rounds, a_capu, b_cap, b_rounds, b_capu, bm, bk, \
                     bn, stream, engine);                                      \
  }

FUSED_ENTRY(fused_block_spmm_f32, float)
FUSED_ENTRY(fused_block_spmm_bf16, __nv_bfloat16)

extern "C" const char* fused_block_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
