// Pieces shared by the flash-attention forward and backward kernels
// (flash_fwd.cu, flash_bwd.cu): the 64-row tiling of the f32 kernels, the
// f32 tile loader, and the packing of an f32 wgmma accumulator into bf16
// A fragments for the register operand of the next product (P·V, ds·K,
// pᵀ·dO, dsᵀ·Q). f32 tiles are 64 rows of one (batch, head) slice, read
// through its sequence stride; rows past the sequence end are zero-filled.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four accumulator values of each of two 16 × 8 tiles (columns 8j and
// 8j + 8), rounded to bf16, as the m16n8k16 A fragment of one 16-column
// k-step: a[0] rows g, cols 2t..2t+1; a[1] rows g+8; a[2] cols 2t+8..;
// a[3] both (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void acc_to_a_frag(uint32_t a[4],
                                              const float lo[4],
                                              const float hi[4]) {
  a[0] = pack_f32(lo[0], lo[1]);
  a[1] = pack_f32(lo[2], lo[3]);
  a[2] = pack_f32(hi[0], hi[1]);
  a[3] = pack_f32(hi[2], hi[3]);
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
