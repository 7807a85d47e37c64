// Flash-attention forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernel `_fwd_body` of sparktorch_tpu/ops/flash_attention.py
// (launched by `_flash_fwd` through `_fwd_kernel` and `_fwd_kernel_lse`): it
// computes O = softmax(Q·Kᵀ·d^-½, optional causal mask)·V with an online
// softmax (running max m, sum l and accumulator in f32), and, when asked,
// lse = m + log l per row.
//
// What bounds it on the card. For one (batch, head) the kernel reads Q, K and V
// once and writes O once: 8·s·d bytes in bf16, against 4·s²·d FLOPs, so s/2
// FLOPs per byte. At the serving shape (s = 128) that is 64, far below the
// H100's ~295 FLOPs per byte in bf16, so the bound is memory; from s ≈ 600 on
// (non-causal) the tensor cores are the bound. The (s × s) logits never reach
// device memory, which is the point of the kernel.
//
// Design (a simple, correct first version; TMA, wgmma and warp specialisation
// come later):
//   * One thread block per (64-row Q tile, batch·head); a loop inside the
//     block walks the 64-row K/V tiles, in place of the TPU grid's sequential
//     k axis. Causal masking stops the loop at the diagonal tile and masks
//     inside it; ragged sequence ends are masked here too, so no shape falls
//     back to dense attention.
//   * Q, K and V are read through their (batch, seq, head) strides, so the
//     head-major transpose and the 128-lane padding of the TPU wrapper are not
//     needed: the model's q/k/v are strided views of one fused qkv product.
//   * bf16: four warps, each owning 16 query rows, run mma.sync m16n8k16 with
//     f32 accumulation for Q·Kᵀ and for P·V; P is rounded to bf16 before P·V,
//     as on the TPU. K and V tiles are staged in shared memory with 8 padding
//     elements per row, which keeps every fragment load free of bank conflicts.
//   * f32: the same tiling with one thread per query row and scalar f32 FMA
//     (never TF32), so f32 matches the plain version to ~1e-6.
//   * l is clamped at 1e-20 before O = acc / l, as on the TPU. O is written in
//     the input dtype.

#include <math_constants.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (b, h, s_q) or null
  int h, s_q, s_k;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale;
  int causal;
};

// Number of K tiles a Q tile visits: causal stops at the diagonal tile.
__device__ __forceinline__ int num_k_tiles(const Params& p, int q_tile) {
  int n = (p.s_k + kBlockK - 1) / kBlockK;
  if (p.causal) n = min(n, (q_tile * kBlockQ + kBlockQ - 1) / kBlockK + 1);
  return n;
}

__device__ __forceinline__ bool masked(const Params& p, int key, int qpos) {
  return key >= p.s_k || (p.causal && key > qpos);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(128)
    flash_fwd_bf16_kernel(const Params p) {
  constexpr int LD = D + 8;  // padded row pitch, in elements
  constexpr int KD = D / 16;  // k-steps over the head dim
  constexpr int ND = D / 8;   // 8-wide column tiles of the output
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockK * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[kBlockK * LD];

  const int q_tile = blockIdx.x;
  const int bh = blockIdx.y;
  const int bi = bh / p.h, hi = bh % p.h;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row group / column pair
  const int q0 = q_tile * kBlockQ;
  const int r0 = warp * 16;  // this warp's first row in the Q tile

  const __nv_bfloat16* qp =
      static_cast<const __nv_bfloat16*>(p.q) + bi * p.q_sb + hi * p.q_sh;
  const __nv_bfloat16* kp =
      static_cast<const __nv_bfloat16*>(p.k) + bi * p.k_sb + hi * p.k_sh;
  const __nv_bfloat16* vp =
      static_cast<const __nv_bfloat16*>(p.v) + bi * p.v_sb + hi * p.v_sh;

  // Q passes through the K buffer once, into registers as A fragments.
  load_tile_bf16<D, LD>(ks, qp, p.q_ss, q0, p.s_q);
  __syncthreads();
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) load_a_frag<LD>(qf[kk], ks, r0, kk, g, t);

  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};  // this thread's part of the row sums

  const int n_tiles = num_k_tiles(p, q_tile);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // every warp is done with the previous tile
    load_tile_bf16<D, LD>(ks, kp, p.k_ss, k0, p.s_k);
    load_tile_bf16<D, LD>(vs, vp, p.v_ss, k0, p.s_k);
    __syncthreads();

    // S = Q·Kᵀ: 16 rows × 64 keys per warp, as 8 column tiles of 8 keys.
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const __nv_bfloat16* krow = ks + (j * 8 + g) * LD + kk * 16 + 2 * t;
        mma_16816(s[j], qf[kk], ld32(krow), ld32(krow + 8));
      }
    }

    // Scale, mask, and the row max over this tile. Element e of tile j sits
    // at row g + 8·(e / 2), column 8·j + 2·t + e % 2.
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        const int key = k0 + j * 8 + 2 * t + (e % 2);
        const int qpos = q0 + r0 + g + 8 * r;
        float x = s[j][e] * p.scale;
        if (masked(p, key, qpos)) x = -CUDART_INF_F;
        s[j][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      // A row with every key masked so far keeps m = -inf; exp then gives 0
      // for its p and its alpha instead of NaN.
      m_use[r] = m_new == -CUDART_INF_F ? 0.f : m_new;
      alpha[r] = expf(m[r] - m_use[r]);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = expf(s[j][e] - m_use[e / 2]);
        s[j][e] = pe;
        l[e / 2] += pe;
      }
    }
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // acc += P·V, P rounded to bf16: the accumulator layout of two
    // neighbouring key tiles is the A-fragment layout of one 16-key k-step.
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t a[4];
      acc_to_a_frag(a, s[2 * kk], s[2 * kk + 1]);
      mma_rows<D, LD>(acc, a, vs, kk, g, t);
    }
  }

  // Finish: full row sums across the four threads of a row, O = acc / l.
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(p.o) + bi * p.o_sb + hi * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    lr = fmaxf(lr, 1e-20f);
    const int qpos = q0 + r0 + g + 8 * r;
    if (qpos >= p.s_q) continue;
    __nv_bfloat16* orow = op + qpos * p.o_ss + 2 * t;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      *reinterpret_cast<uint32_t*>(orow + j * 8) =
          pack_f32(acc[j][2 * r] / lr, acc[j][2 * r + 1] / lr);
    }
    if (p.lse != nullptr && t == 0)
      p.lse[(long long)bh * p.s_q + qpos] = m[r] + logf(lr);
  }
}

// ---------------------------------------------------------------------------
// f32: the same tiling, scalar FMA, one thread per query row
// ---------------------------------------------------------------------------

template <int D>
constexpr int f32_smem_bytes() {
  // Q and K with pitch D + 1 (conflict-free row reads), V, and P (pitch 65).
  return (2 * kBlockQ * (D + 1) + kBlockK * D + kBlockQ * (kBlockK + 1)) *
         int(sizeof(float));
}

template <int D>
__global__ void __launch_bounds__(64) flash_fwd_f32_kernel(const Params p) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBlockQ * (D + 1);
  float* vs = ks + kBlockK * (D + 1);
  float* ps = vs + kBlockK * D;

  const int q_tile = blockIdx.x;
  const int bh = blockIdx.y;
  const int bi = bh / p.h, hi = bh % p.h;
  const int row = threadIdx.x;
  const int q0 = q_tile * kBlockQ;
  const int qpos = q0 + row;

  const float* qp = static_cast<const float*>(p.q) + bi * p.q_sb + hi * p.q_sh;
  const float* kp = static_cast<const float*>(p.k) + bi * p.k_sb + hi * p.k_sh;
  const float* vp = static_cast<const float*>(p.v) + bi * p.v_sb + hi * p.v_sh;
  load_tile_f32<D>(qs, D + 1, qp, p.q_ss, q0, p.s_q);

  float acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.f;
  float m = -CUDART_INF_F, l = 0.f;
  const float* qrow = qs + row * (D + 1);
  float* prow = ps + row * (kBlockK + 1);

  const int n_tiles = num_k_tiles(p, q_tile);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();
    load_tile_f32<D>(ks, D + 1, kp, p.k_ss, k0, p.s_k);
    load_tile_f32<D>(vs, D, vp, p.v_ss, k0, p.s_k);
    __syncthreads();

    float mx = -CUDART_INF_F;
    for (int j = 0; j < kBlockK; ++j) {
      const float* krow = ks + j * (D + 1);
      float dot = 0.f;
#pragma unroll 16
      for (int c = 0; c < D; ++c) dot = fmaf(qrow[c], krow[c], dot);
      float x = dot * p.scale;
      if (masked(p, k0 + j, qpos)) x = -CUDART_INF_F;
      prow[j] = x;
      mx = fmaxf(mx, x);
    }
    const float m_new = fmaxf(m, mx);
    const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;
    const float alpha = expf(m - m_use);
    m = m_new;
    l *= alpha;
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] *= alpha;
    for (int j = 0; j < kBlockK; ++j) {
      const float pj = expf(prow[j] - m_use);
      l += pj;
      const float* vrow = vs + j * D;
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] = fmaf(pj, vrow[c], acc[c]);
    }
  }

  if (qpos >= p.s_q) return;
  const float lc = fmaxf(l, 1e-20f);
  float* orow = static_cast<float*>(p.o) + bi * p.o_sb + hi * p.o_sh + qpos * p.o_ss;
#pragma unroll
  for (int c = 0; c < D; ++c) orow[c] = acc[c] / lc;
  if (p.lse != nullptr) p.lse[(long long)bh * p.s_q + qpos] = m + logf(lc);
}

template <int D>
cudaError_t launch(const Params& p, int bh, bool bf16, cudaStream_t stream) {
  dim3 grid((p.s_q + kBlockQ - 1) / kBlockQ, bh);
  if (bf16) {
    flash_fwd_bf16_kernel<D><<<grid, 128, 0, stream>>>(p);
  } else {
    constexpr int smem = f32_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    flash_fwd_f32_kernel<D><<<grid, 64, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// q, k, v: (b, s, h, d) with unit stride over d; strides in elements.
// o: (b, s_q, h, d); lse: (b, h, s_q) f32 or null. Returns a cudaError_t.
extern "C" int sparktorch_flash_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse, int b,
    int h, int s_q, int s_k, int d, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, float scale, int causal, int bf16,
    void* stream) {
  Params p{q,    k,    v,    o,    lse,  h,    s_q,  s_k,   q_sb,  q_ss,
           q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
           scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch<32>(p, b * h, bf16 != 0, st);
    case 64: return launch<64>(p, b * h, bf16 != 0, st);
    case 128: return launch<128>(p, b * h, bf16 != 0, st);
    default: return cudaErrorInvalidValue;
  }
}
