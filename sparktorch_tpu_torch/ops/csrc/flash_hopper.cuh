// Hopper building blocks of the bf16 flash-attention forward, dq and dk/dv
// kernels (flash_fwd.cu, flash_bwd.cu): mbarriers, TMA tile loads,
// wgmma on shared-memory and register operands, register hand-over
// between warpgroups, and the host-side tensor maps. Everything is
// hand-written PTX; <cuda.h> is included for the tensor-map types only,
// and the driver's encoder is fetched at run time, so the library needs
// no -lcuda.
//
// Shared-memory tiles are written by TMA with the 128-byte swizzle (64
// bf16 columns a row; a head dim of 128 is two such boxes side by side)
// or, for a head dim of 32, the 64-byte swizzle, and read by wgmma
// through descriptors with the matching layout. A tile starts on a
// 1024-byte boundary so the swizzle pattern and the descriptors agree.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// The dynamic shared memory of a block, rounded up to a 1024-byte boundary
// (the launch asks for 1024 bytes of slack).
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic to wait for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed. A wait that
// outlasts ~2^34 cycles (several seconds) means a pipeline fault (a lost
// arrival, a wrong byte count); it traps, so the launch fails with an
// error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(addr, parity)) {
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// ---------------------------------------------------------------------------
// TMA loads (global → shared), completing on an mbarrier
// ---------------------------------------------------------------------------

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---------------------------------------------------------------------------
// Register hand-over between warpgroups (whole warpgroup, compile-time count)
// ---------------------------------------------------------------------------

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Descriptor of a bf16 operand tile in shared memory. `swizzle` is the
// TMA swizzle in bytes (128 or 64), which is also the row pitch of one
// box. K-major (the reduction dim contiguous): `sbo` is the step between
// groups of 8 rows (8·swizzle bytes), `lbo` unused. MN-major (transpose
// bit set): `sbo` steps between groups of 8 reduction rows, `lbo` between
// side-by-side boxes of the M/N dim.
__device__ __forceinline__ uint64_t make_desc(const void* tile, uint32_t lbo,
                                              uint32_t sbo, int swizzle) {
  const uint64_t layout = swizzle == 128 ? 1 : 2;  // B128 or B64
  return uint64_t((smem_u32(tile) & 0x3FFFF) >> 4) |
         (uint64_t((lbo & 0x3FFFF) >> 4) << 16) |
         (uint64_t((sbo & 0x3FFFF) >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers that an asynchronous wgmma reads or writes at this point
// of the program, so the compiler neither reads an accumulator before
// wgmma_wait nor reuses an A fragment's registers while a product may
// still read them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define HOPPER_ACC8(d, i)                                               \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define HOPPER_ACC16(d, i) HOPPER_ACC8(d, i), HOPPER_ACC8(d, i + 8)
#define HOPPER_ACC32(d, i) HOPPER_ACC16(d, i), HOPPER_ACC16(d, i + 16)
#define HOPPER_ACC64(d) HOPPER_ACC32(d, 0), HOPPER_ACC32(d, 32)

#define HOPPER_REGS16                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "      \
  "%8, %9, %10, %11, %12, %13, %14, %15}"
#define HOPPER_REGS32                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "          \
  "%8, %9, %10, %11, %12, %13, %14, %15, "     \
  "%16, %17, %18, %19, %20, %21, %22, %23, "   \
  "%24, %25, %26, %27, %28, %29, %30, %31}"
#define HOPPER_REGS64                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "          \
  "%8, %9, %10, %11, %12, %13, %14, %15, "     \
  "%16, %17, %18, %19, %20, %21, %22, %23, "   \
  "%24, %25, %26, %27, %28, %29, %30, %31, "   \
  "%32, %33, %34, %35, %36, %37, %38, %39, "   \
  "%40, %41, %42, %43, %44, %45, %46, %47, "   \
  "%48, %49, %50, %51, %52, %53, %54, %55, "   \
  "%56, %57, %58, %59, %60, %61, %62, %63}"

// D(64×64) (+)= A·B over k = 16, A and B K-major in shared memory.
// D is overwritten when `accumulate` is 0. Accumulator element 4j + e of
// a thread (warp w, lane 4g + t of the warpgroup) is row 16w + g + 8(e/2),
// column 8j + 2t + e%2: the mma.sync m16n8 layout, tiled.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_ACC32(d, 0)
      : "l"(a), "l"(b), "r"(accumulate));
}

// D(64×N) += A·B over k = 16: A from registers in the m16n8k16 A-fragment
// layout (warp w holds rows 16w..16w+15), B MN-major in shared memory.
// N = 2 × the accumulator's length: 32, 64 or 128.
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " HOPPER_REGS16
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : HOPPER_ACC16(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HOPPER_ACC32(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : HOPPER_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// 2^x with the SFU (ex2.approx: ~2 ulp); the kernels work in base 2 with
// the log2(e) factor folded into the softmax scale.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// Shared-memory layout of one bf16 tile of R rows × D columns
// ---------------------------------------------------------------------------

template <int D>
struct Tile {
  static constexpr int kCols = D < 64 ? D : 64;  // columns of one TMA box
  static constexpr int kBoxes = D / kCols;       // 2 for a head dim of 128
  static constexpr int kSwizzle = kCols * 2;     // bytes: a box row
  static constexpr int kStepsPerBox = kCols / 16;

  // K-major operand (rows = M or N, columns = the reduction dim), rows
  // [row0, row0 + 64) of a tile of `rows` rows, reduction step k (16
  // columns).
  __device__ static uint64_t k_major(const uint8_t* tile, int rows, int row0,
                                     int k) {
    const uint8_t* p = tile + (k / kStepsPerBox) * rows * kSwizzle +
                       row0 * kSwizzle + (k % kStepsPerBox) * 32;
    return make_desc(p, 16, 8 * kSwizzle, kSwizzle);
  }

  // MN-major operand (rows = the reduction dim, columns = N = D), rows
  // [16k, 16k + 16) of a tile of `rows` rows.
  __device__ static uint64_t mn_major(const uint8_t* tile, int rows, int k) {
    return make_desc(tile + k * 16 * kSwizzle, rows * kSwizzle, 8 * kSwizzle,
                     kSwizzle);
  }
};

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched from the driver once.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-D map over a bf16 (b, s, h, d) operand with unit stride over d and
// (batch, seq, head) strides in elements, read in boxes of `rows` rows of
// one (batch, head) and min(d, 64) columns. Rows past s read as zero. The
// stride of a dim of extent 1 never enters an address; it is replaced by
// a valid one.
inline cudaError_t encode_bshd(CUtensorMap* map, const void* base, int b,
                               int s, int h, int d, long long sb,
                               long long ss, long long sh, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (h == 1) sh = d;
  if (s == 1) ss = sh * h;
  if (b == 1) sb = ss * s;
  const cuuint32_t cols = d < 64 ? d : 64;
  const cuuint64_t dims[4] = {cuuint64_t(d), cuuint64_t(h), cuuint64_t(s),
                              cuuint64_t(b)};
  const cuuint64_t strides[3] = {cuuint64_t(sh) * 2, cuuint64_t(ss) * 2,
                                 cuuint64_t(sb) * 2};
  const cuuint32_t box[4] = {cols, 1, cuuint32_t(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// What a kernel needs before its first launch, done once per kernel (the
// caller keeps the result in a function-local static; the port drives one
// card a process): its dynamic shared memory allowed, and, for a kernel
// that hands registers over (`pool` > 0), a launch guard. setmaxnreg.inc
// blocks until the block's register pool (the launch count × threads) has
// room, so a kernel compiled with fewer registers than the hand-over
// assumes would hang; the guard makes that an error instead.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem, int threads, int pool) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess || pool == 0) return err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess) return err;
  const int per_thread = (attr.numRegs + 7) / 8 * 8;
  return per_thread * threads >= pool ? cudaSuccess
                                      : cudaErrorInvalidConfiguration;
}

}  // namespace hopper
