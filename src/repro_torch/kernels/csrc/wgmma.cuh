// Hopper's asynchronous building blocks, shared by the port's tensor-core
// kernels: the bf16 flash kernel (flash_attention.cu, namespace tc) and the
// GEMM engines' TileTC (tile_gemm.cuh).
//
// - wgmma: the shared-memory matrix descriptor of the 128-byte swizzle, the
//   fence / commit / wait of an asynchronous warpgroup product, a register
//   fence that keeps the compiler from moving accumulator accesses across
//   one, and m64n128k16 with both operands in shared memory (A K-major, B
//   N-major: a row-major [k, n] tile).
// - The swizzled layout: 64-row x 128-byte atoms (64 bf16 columns), 16-byte
//   chunk c of row r at chunk c ^ (r % 8), atoms 1024-byte aligned.  wgmma
//   reads it, TileCopy writes it by cp.async and TMA writes it with
//   CU_TENSOR_MAP_SWIZZLE_128B.
// - mbarriers and TMA: a transaction barrier in shared memory that a
//   producer arms with the bytes it expects, and a 3-D tensor-map load that
//   completes those bytes on it.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace wgmma {

constexpr int ATOM_BYTES = 64 * 128;  // one 64-row x 64-column bf16 atom (128-byte rows)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units), layout type 1 in bits 62-63.
// K-major: the stride offset is the 8-row group's (1024), the leading one
// unused.  N-major: the leading offset is the stride between 64-column
// atoms along N, the stride offset the 8-row group's along K.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses of an accumulator across a wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A @ B, m64n128k16, A in shared memory K-major, B in shared memory
// N-major (a row-major [16 k, 128 n] slice: imm-trans-b 1), fp32 accumulate
__device__ __forceinline__ void mma_m64n128k16_ss_tb(float (&d)[64], uint64_t desc_a,
                                                     uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
      "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
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
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// One thread's share of copying a [64, DMAX] bf16 tile (rows [0, rows),
// columns [0, D); zeros past the edges) into shared memory as DMAX / 64
// atoms of 64 rows x 128 bytes, with 16-byte chunk c of row r at chunk
// c ^ (r % 8): the 128-byte swizzle wgmma reads.  Thread t of one
// warpgroup copies chunk cc = t % CH of rows r_t + RSTEP j, so eight
// consecutive threads copy one row's 128 contiguous bytes, and its
// addresses are worked out once per block: a tile costs each thread JN
// copies and a few adds.
template <int DMAX>
struct TileCopy {
  static constexpr int NT = 128;          // the copying threads: one warpgroup
  static constexpr int CH = DMAX / 8;     // 16-byte chunks per row
  static constexpr int RSTEP = NT / CH;   // rows between one thread's chunks
  static constexpr int JN = 64 / RSTEP;   // chunks per thread and tile
  static_assert(RSTEP % 4 == 0, "the swizzle of row r_t + RSTEP j takes two values at most");
  int r_t;
  bool col_ok;
  uint32_t soff[2];  // byte offset in the tile of chunk j = 0 and j = 1

  __device__ __forceinline__ TileCopy(int D) {
    const int cc = threadIdx.x % CH;
    r_t = threadIdx.x / CH;
    col_ok = cc * 8 < D;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = r_t + RSTEP * j;
      soff[j] = (cc / 8) * ATOM_BYTES + r * 128 + (((cc % 8) ^ (r % 8)) << 4);
    }
  }

  // src: row 0, column 0 of the tile in global memory
  __device__ __forceinline__ void copy(const __nv_bfloat16* src, long long row_stride, int rows,
                                       uint32_t dst) const {
    const __nv_bfloat16* g = src + r_t * row_stride + (threadIdx.x % CH) * 8;
    const long long step = RSTEP * row_stride;
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      const bool ok = col_ok && r_t + RSTEP * j < rows;
      // chunk j sits RSTEP j rows below chunk j % 2 (a multiple of 8 rows when j is even)
      cp_async16(dst + soff[j % 2] + (j - j % 2) * RSTEP * 128, ok ? g : src, ok);
      g += step;
    }
  }
};

// ---- mbarriers (shared-memory addresses of 8-byte barriers)

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// makes the initialised barriers visible to the async proxy (TMA) and the
// other threads; a __syncthreads follows
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// one arrival, and `bytes` more that the phase waits for (TMA completes them)
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// spins until the phase of parity `parity` has completed (the loop inside one
// asm block, so a warp leaves it converged, as the wgmma that follows needs)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\nbra WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// ---- TMA

// The box at coordinates (c0, c1, c2) (innermost first) of the 3-D tensor
// map `tmap` (a __grid_constant__ kernel parameter) into shared memory at
// `dst`, zeros where the box leaves the tensor; completes its bytes on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* tmap, int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

}  // namespace wgmma
