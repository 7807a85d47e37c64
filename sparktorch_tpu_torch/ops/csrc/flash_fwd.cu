// Flash-attention forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernel `_fwd_body` of sparktorch_tpu/ops/flash_attention.py
// (launched by `_flash_fwd` through `_fwd_kernel` and `_fwd_kernel_lse`): it
// computes O = softmax(Q·Kᵀ·d^-½, optional causal mask)·V with an online
// softmax (running max m, sum l and accumulator in f32), and, when asked,
// lse = m + log l per row.
//
// What bounds it on the card. For one (batch, head) the kernel reads Q, K and V
// once and writes O once: 8·s·d bytes in bf16, against 4·s²·d FLOPs (half
// that when causal), so s/2 FLOPs per byte. At the serving shape (s = 128)
// that is 64, far below the H100's ~295 FLOPs per byte in bf16, so the bound
// is memory; from s ≈ 600 on (non-causal) the tensor cores are, and beside
// them the softmax's exponentials on the SFU (one per query-key pair). The
// (s × s) logits never reach device memory, which is the point of the kernel.
//
// Design, bf16 (a Hopper kernel: TMA, wgmma, warp specialisation):
//   * One block per (128-row Q tile, batch·head): two consumer warpgroups,
//     each owning 64 query rows, and a producer. One producer thread issues
//     TMA loads: Q once, then K and V tiles of 64 keys
//     into a ring of two stages, each stage guarded by "full" mbarriers
//     (separate for K and V, so Q·Kᵀ starts before V lands) and an "empty"
//     mbarrier that the eight consumer warps arrive on once their products
//     have read the stage. Loads of the next tile overlap the products and
//     softmax of this one, and the two consumer warpgroups interleave on the
//     tensor cores.
//   * TMA reads q, k, v through a 4-D tensor map (d, h, s, b) over their real
//     strides, so the model's q/k/v stay strided views of one fused qkv
//     product; rows past the sequence end arrive as zeros. Tiles land with
//     the 128-byte swizzle (64-byte for a head dim of 32; a head dim of 128
//     is two 64-column boxes), which wgmma reads without bank conflicts.
//   * S = Q·Kᵀ is wgmma m64n64k16 with both operands in shared memory
//     (K-major). The online softmax runs on the accumulator in registers
//     (base 2, log2 e folded into the scale). P, rounded to bf16 as on the
//     TPU, is the register A operand of O += P·V (wgmma m64nDk16): the
//     accumulator layout of two neighbouring 8-key column tiles is exactly
//     the A-fragment layout of one 16-key step. V is the shared B operand,
//     MN-major (transpose bit set).
//   * Causal: the loop stops at the diagonal tile and masks inside it (a
//     consumer skips a tile that lies wholly above its rows); the grid walks
//     the Q tiles longest first, so the heaviest blocks do not form a tail.
//     Ragged sequence ends are masked here too, so no shape falls back.
//   * Occupancy: head dims 32 and 64 run two blocks per SM (288 threads, a
//     producer warp, up to 112 registers a thread; 49 KB of shared memory at
//     d = 64), which at the serving shape (one Q tile and two K/V tiles per
//     block) lets one block's loads overlap the other's products. A head dim
//     of 128 runs one block per SM (384 threads, a producer warpgroup that
//     gives its registers back with setmaxnreg, 240 a consumer thread; 97 KB
//     of shared memory).
//   * l is clamped at 1e-20 before O = acc / l, as on the TPU; O is written
//     as bf16 straight from the registers, lse as f32 when asked.
// f32: the simple first design (one thread per query row, scalar f32 FMA,
// never TF32), kept as a correctness path that matches the plain version to
// ~1e-6.

#include <math_constants.h>

#include "flash_common.cuh"
#include "flash_hopper.cuh"

namespace {

using namespace flash;

// The call's arguments: the f32 kernel's parameters, and what the bf16
// kernel's tensor maps are made from.
struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (b, h, s_q) or null
  int b, h, s_q, s_k;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale;
  int causal;
};

// ---------------------------------------------------------------------------
// bf16: TMA, wgmma and warp specialisation
// ---------------------------------------------------------------------------

struct HopperParams {
  CUtensorMap tm_q;  // boxes of kRows rows
  CUtensorMap tm_k;  // boxes of kKeys rows
  CUtensorMap tm_v;
  void* o;
  float* lse;  // (b, h, s_q) or null
  int h, s_q, s_k;
  long long o_sb, o_ss, o_sh;
  float scale_log2;  // d^-½ · log2(e)
  int causal;
};

namespace fwd {

constexpr int kRows = 128;     // Q rows per block, 64 per consumer warpgroup
constexpr int kKeys = 64;      // keys per K/V stage
constexpr int kStages = 2;
constexpr int kConsumerWarps = 8;  // consumer warpgroups 0 and 1
constexpr int kProducerRegs = 24;

// A head dim of 128 runs one block per SM: the producer is a whole third
// warpgroup (one thread works), and setmaxnreg hands its registers to the
// consumers, 240 each (ptxas sizes the block's pool to the launch bound,
// 168 a thread for 384 threads). Head dims 32 and 64 run two blocks per SM
// with a lone producer warp and no hand-over: the launch bound (112 a
// thread) covers the consumers' ~92, while ptxas compiled the consumer
// code of a three-warpgroup block at two blocks per SM to 80 registers,
// spilling, whatever count setmaxnreg asked for.
template <int D>
struct Config {
  static constexpr bool kHandOver = D == 128;
  static constexpr int kThreads = kHandOver ? 384 : 288;
  static constexpr int kMinBlocks = kHandOver ? 1 : 2;
  static constexpr int kConsumerRegs = 240;
  static constexpr int kQBytes = kRows * D * 2;
  static constexpr int kKVBytes = kKeys * D * 2;  // one K or V stage
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBars = kV + kStages * kKVBytes;
  // q_full, k_full[2], v_full[2], empty[2]; 1024 bytes of slack to align
  // the base.
  static constexpr int kSmem = kBars + 8 * 8 + 1024;
  static constexpr int kRegPool = 256 * kConsumerRegs + 128 * kProducerRegs;
};

}  // namespace fwd

template <int D>
__global__ void __launch_bounds__(fwd::Config<D>::kThreads,
                                  fwd::Config<D>::kMinBlocks)
    flash_fwd_bf16_kernel(const __grid_constant__ HopperParams p) {
  using namespace fwd;
  using C = Config<D>;
  using T = hopper::Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::kBars);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + kStages;
  uint64_t* empty = bars + 1 + 2 * kStages;

  const int bh = blockIdx.x;
  const int bi = bh / p.h, hi = bh % p.h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // longest rows first
  int n_tiles = (p.s_k + kKeys - 1) / kKeys;
  if (p.causal) n_tiles = min(n_tiles, (q0 + kRows - 1) / kKeys + 1);

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int i = 0; i < kStages; ++i) {
      hopper::mbar_init(k_full + i, 1);
      hopper::mbar_init(v_full + i, 1);
      hopper::mbar_init(empty + i, kConsumerWarps);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // Producer: one thread keeps the ring full.
    if constexpr (C::kHandOver) hopper::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 256) {
      hopper::mbar_expect_tx(q_full, C::kQBytes);
      for (int j = 0; j < T::kBoxes; ++j)
        hopper::tma_load_4d(smem + C::kQ + j * kRows * T::kSwizzle, &p.tm_q,
                            q_full, j * 64, hi, q0, bi);
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int st = kt % kStages;
        hopper::mbar_wait(empty + st, ((kt / kStages) & 1) ^ 1);
        uint8_t* ks = smem + C::kK + st * C::kKVBytes;
        uint8_t* vs = smem + C::kV + st * C::kKVBytes;
        hopper::mbar_expect_tx(k_full + st, C::kKVBytes);
        for (int j = 0; j < T::kBoxes; ++j)
          hopper::tma_load_4d(ks + j * kKeys * T::kSwizzle, &p.tm_k,
                              k_full + st, j * 64, hi, kt * kKeys, bi);
        hopper::mbar_expect_tx(v_full + st, C::kKVBytes);
        for (int j = 0; j < T::kBoxes; ++j)
          hopper::tma_load_4d(vs + j * kKeys * T::kSwizzle, &p.tm_v,
                              v_full + st, j * 64, hi, kt * kKeys, bi);
      }
    }
  } else {
    // Consumer warpgroup c: query rows [q0 + 64c, q0 + 64c + 64).
    if constexpr (C::kHandOver) hopper::reg_alloc<C::kConsumerRegs>();
    const int c = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int row0 = q0 + c * 64 + warp * 16 + g;  // rows row0 and row0 + 8
    int n_mine = n_tiles;  // tiles after these lie wholly above my rows
    if (p.causal) n_mine = min(n_tiles, (q0 + c * 64 + 63) / kKeys + 1);
    const uint8_t* qs = smem + C::kQ;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running max, base 2
    float l[2] = {0.f, 0.f};  // this thread's part of the row sums

    hopper::mbar_wait(q_full, 0);
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int st = kt % kStages;
      const uint32_t phase = (kt / kStages) & 1;
      // Waited on even when skipped: the empty arrival below must not count
      // towards the stage's previous use.
      hopper::mbar_wait(k_full + st, phase);
      if (kt < n_mine) {
        const uint8_t* ks = smem + C::kK + st * C::kKVBytes;
        const uint8_t* vs = smem + C::kV + st * C::kKVBytes;
        const int k0 = kt * kKeys;

        // S = Q·Kᵀ: 64 rows × 64 keys.
        float s[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = 0.f;
        hopper::wgmma_fence();
#pragma unroll
        for (int k = 0; k < D / 16; ++k)
          hopper::wgmma_ss_n64(s, T::k_major(qs, kRows, c * 64, k),
                               T::k_major(ks, kKeys, 0, k), k > 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);

        // Scale, mask, and the row max over this tile. Element 4j + e sits
        // at row row0 + 8·(e / 2), key k0 + 8j + 2t + e % 2.
        const bool edge = k0 + kKeys > p.s_k ||
                          (p.causal && k0 + kKeys - 1 > q0 + c * 64);
        float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e / 2;
            float x = s[4 * j + e] * p.scale_log2;
            if (edge) {
              const int key = k0 + 8 * j + 2 * t + (e % 2);
              if (key >= p.s_k || (p.causal && key > row0 + 8 * r))
                x = -CUDART_INF_F;
            }
            s[4 * j + e] = x;
            mx[r] = fmaxf(mx[r], x);
          }
        }
        float alpha[2], m_use[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[r], mx[r]);
          // A row with every key masked so far keeps m = -inf; exp then
          // gives 0 for its p and its alpha instead of NaN.
          m_use[r] = m_new == -CUDART_INF_F ? 0.f : m_new;
          alpha[r] = hopper::exp2_approx(m[r] - m_use[r]);
          m[r] = m_new;
          l[r] *= alpha[r];
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const float pe = hopper::exp2_approx(s[i] - m_use[(i / 2) % 2]);
          s[i] = pe;
          l[(i / 2) % 2] += pe;
        }
        uint32_t pf[4][4];  // P in bf16, one A fragment per 16-key step
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          acc_to_a_frag(pf[kk], &s[8 * kk], &s[8 * kk + 4]);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) % 2];

        // O += P·V.
        hopper::mbar_wait(v_full + st, phase);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_rs(o, pf[kk], T::mn_major(vs, kKeys, kk));
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(o);
        hopper::fence_regs(pf);
      }
      if (lane == 0) hopper::mbar_arrive(empty + st);
    }

    // Finish: full row sums across the four threads of a row, O = acc / l.
    __nv_bfloat16* op =
        static_cast<__nv_bfloat16*>(p.o) + bi * p.o_sb + hi * p.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      lr = fmaxf(lr, 1e-20f);
      const int qpos = row0 + 8 * r;
      if (qpos >= p.s_q) continue;
      __nv_bfloat16* orow = op + qpos * p.o_ss + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + j * 8) =
            pack_f32(o[4 * j + 2 * r] / lr, o[4 * j + 2 * r + 1] / lr);
      if (p.lse != nullptr && t == 0)
        p.lse[(long long)bh * p.s_q + qpos] =
            m[r] * 0.6931471805599453f + logf(lr);
    }
  }
}

// Host side of the bf16 kernel: the tensor maps, then the launch.
template <int D>
cudaError_t launch_bf16(const Params& a, cudaStream_t stream) {
  using C = fwd::Config<D>;
  static const cudaError_t setup = hopper::prepare(
      flash_fwd_bf16_kernel<D>, C::kSmem, C::kThreads,
      C::kHandOver ? C::kRegPool : 0);
  if (setup != cudaSuccess) return setup;
  cudaError_t err;
  HopperParams p{};
  if ((err = hopper::encode_bshd(&p.tm_q, a.q, a.b, a.s_q, a.h, D, a.q_sb,
                                 a.q_ss, a.q_sh, fwd::kRows)) != cudaSuccess ||
      (err = hopper::encode_bshd(&p.tm_k, a.k, a.b, a.s_k, a.h, D, a.k_sb,
                                 a.k_ss, a.k_sh, fwd::kKeys)) != cudaSuccess ||
      (err = hopper::encode_bshd(&p.tm_v, a.v, a.b, a.s_k, a.h, D, a.v_sb,
                                 a.v_ss, a.v_sh, fwd::kKeys)) != cudaSuccess)
    return err;
  p.o = a.o;
  p.lse = a.lse;
  p.h = a.h;
  p.s_q = a.s_q;
  p.s_k = a.s_k;
  p.o_sb = a.o_sb;
  p.o_ss = a.o_ss;
  p.o_sh = a.o_sh;
  p.scale_log2 = a.scale * 1.4426950408889634f;
  p.causal = a.causal;
  const dim3 grid(a.b * a.h, (a.s_q + fwd::kRows - 1) / fwd::kRows);
  flash_fwd_bf16_kernel<D><<<grid, C::kThreads, C::kSmem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: one thread per query row, scalar FMA
// ---------------------------------------------------------------------------

// Number of K tiles a Q tile visits: causal stops at the diagonal tile.
__device__ __forceinline__ int num_k_tiles(const Params& p, int q_tile) {
  int n = (p.s_k + kBlockK - 1) / kBlockK;
  if (p.causal) n = min(n, (q_tile * kBlockQ + kBlockQ - 1) / kBlockK + 1);
  return n;
}

__device__ __forceinline__ bool masked(const Params& p, int key, int qpos) {
  return key >= p.s_k || (p.causal && key > qpos);
}

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
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  constexpr int smem = f32_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.s_q + kBlockQ - 1) / kBlockQ, p.b * p.h);
  flash_fwd_f32_kernel<D><<<grid, 64, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Params& a, bool bf16, cudaStream_t stream) {
  return bf16 ? launch_bf16<D>(a, stream) : launch_f32<D>(a, stream);
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
  const Params a{q,    k,    v,    o,    lse,  b,    h,    s_q,  s_k,
                 q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                 o_sb, o_ss, o_sh, scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch<32>(a, bf16 != 0, st);
    case 64: return launch<64>(a, bf16 != 0, st);
    case 128: return launch<128>(a, bf16 != 0, st);
    default: return cudaErrorInvalidValue;
  }
}
