// Pieces shared by the flash-attention forward and backward kernels
// (flash_fwd.cu, flash_bwd.cu): the 64-row tiling, the bf16 mma.sync
// fragment helpers and the tile loaders. Every tile is 64 rows of one
// (batch, head) slice, read through its sequence stride; rows past the
// sequence end are zero-filled.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;

// D += A·B for one m16n8k16 tile, bf16 inputs, f32 accumulation.
// A (16×16, row major): a[0] rows g, cols 2t..2t+1; a[1] rows g+8;
// a[2] cols 2t+8..; a[3] both. B (16×8, column major): b0 holds k rows
// 2t..2t+1 of column g, b1 k rows 2t+8..2t+9. C element e sits at row
// g + 8·(e / 2), column 2t + e % 2 (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return uint32_t(__bfloat16_as_ushort(lo)) |
         (uint32_t(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The A fragment of rows [r0, r0 + 16) and k-step kk of a tile in shared
// memory (row pitch LD): the operand layout of mma_16816.
template <int LD>
__device__ __forceinline__ void load_a_frag(uint32_t a[4],
                                            const __nv_bfloat16* tile, int r0,
                                            int kk, int g, int t) {
  const __nv_bfloat16* row = tile + (r0 + g) * LD + kk * 16 + 2 * t;
  a[0] = ld32(row);
  a[1] = ld32(row + 8 * LD);
  a[2] = ld32(row + 8);
  a[3] = ld32(row + 8 * LD + 8);
}

// Four accumulator tiles of 16 rows × 8 columns, j = 2kk and 2kk + 1, read
// as the A fragment of one 16-column k-step, each value rounded to bf16.
__device__ __forceinline__ void acc_to_a_frag(uint32_t a[4],
                                              const float lo[4],
                                              const float hi[4]) {
  a[0] = pack_f32(lo[0], lo[1]);
  a[1] = pack_f32(lo[2], lo[3]);
  a[2] = pack_f32(hi[0], hi[1]);
  a[3] = pack_f32(hi[2], hi[3]);
}

// acc[j] += A·tile[k rows kk*16.., columns j*8..] for every 8-column tile j
// of a D-wide row-major tile in shared memory: the B operand read across
// rows (V in P·V, K in dS·K, dO in Pᵀ·dO, Q in dSᵀ·Q).
template <int D, int LD>
__device__ __forceinline__ void mma_rows(float acc[][4], const uint32_t a[4],
                                         const __nv_bfloat16* tile, int kk,
                                         int g, int t) {
  const __nv_bfloat16* base = tile + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const __nv_bfloat16* c = base + j * 8;
    mma_16816(acc[j], a, pack_bf16(c[0], c[LD]), pack_bf16(c[8 * LD], c[9 * LD]));
  }
}

// Copy rows [row0, row0 + 64) of one (batch, head) slice into shared memory
// (row pitch LD), 16 bytes per thread per step; rows past `rows` are zero.
template <int D, int LD>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               long long stride_s, int row0,
                                               int rows) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < 64 * kChunks; c += blockDim.x) {
    int r = c / kChunks;
    int col = (c % kChunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < rows)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride_s + col);
    *reinterpret_cast<uint4*>(dst + r * LD + col) = val;
  }
}

template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, int ld,
                                              const float* src,
                                              long long stride_s, int row0,
                                              int rows) {
  for (int c = threadIdx.x; c < 64 * D; c += blockDim.x) {
    int r = c / D, col = c % D;
    dst[r * ld + col] = row0 + r < rows ? src[(row0 + r) * stride_s + col] : 0.f;
  }
}

}  // namespace flash
