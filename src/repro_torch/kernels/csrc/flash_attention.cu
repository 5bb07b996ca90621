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
// Design.  The TPU kernel walks kv tiles along a sequential grid axis with
// (m, l, acc) in VMEM scratch.  Hopper blocks run in no order, so one thread
// block owns one (batch, q head, 64-row q tile) and walks its kv tiles in
// ascending order in a loop inside the block.  The Q tile is staged once into
// shared memory (transposed, d-major), each 64-key K tile (transposed) and V
// tile are staged through shared memory, and the probabilities go through a
// shared tile between the two products.  256 threads: thread (ty, tx) owns
// score rows 4ty..4ty+3 and columns 4tx..4tx+3, and output rows 4ty..4ty+3 at
// columns 4tx + 64j; m and l stay in registers, the row max and row sum are
// reduced over the 16 lanes of a row with warp shuffles, the accumulator
// stays in fp32 registers, and the output is stored once.  No atomics: the
// result is bit-identical from launch to launch.  A kv tile is skipped only
// when none of its (row, column) pairs is live: the live keys of a q tile
// form the contiguous range (q_first - window, q_last], so the loop runs over
// exactly the tiles that meet it.  Ragged Sq and Sk are masked at the edges;
// strides are taken for the batch, head and sequence axes (the head dim is
// contiguous), so `[B, S, H, D]` activations are read and written without a
// transposed copy; offsets are 64-bit.  Blocks are issued last q tile first,
// so the longest causal rows start first.
//
// Bound on an H100 SXM.  Both products run as plain fp32 FFMA (the Pallas
// kernel casts q, k, p and v to fp32; no TF32, no tensor cores here):
// 4 * D operations per live score at 67 TFLOP/s.  At the LM's shapes
// (Sk in the thousands, D >= 64) that is far above the bytes of q, k, v and
// o at 3.35 TB/s, so the kernel is operation-bound, and this first version is
// limited by shared-memory reads (two 16-byte reads per 16 FFMA) more than by
// the FFMA rate.  The head dim selects one of three instantiations (D <= 64,
// 128, 256) sizing the shared tiles (up to 209 KB, dynamic shared memory).
// wgmma for bf16, TMA and warp specialisation are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

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

// 8 consecutive elements of one row, as fp32 (16- or 32-byte vector loads)
__device__ __forceinline__ void load8(const float* src, float (&x)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(src));
  const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* src, float (&x)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(src));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store4(float* dst, const float (&x)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float (&x)[4]) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(x[0], x[1]), __floats2bfloat162_rn(x[2], x[3])};
  *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(h);
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
  if (d <= 64) return launch_dmax<T, 64>(q, k, v, o, batch, p, stream);
  if (d <= 128) return launch_dmax<T, 128>(q, k, v, o, batch, p, stream);
  return launch_dmax<T, 256>(q, k, v, o, batch, p, stream);
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
