// Flash-attention backward for Hopper (sm_90a), with a plain C interface.
//
// Replaces the two TPU kernels of sparktorch_tpu/ops/flash_attention.py that
// `_flash_bwd_impl` launches: `_bwd_dq_kernel` and `_bwd_dkv_kernel`. Both
// recompute the probabilities block by block from the forward's per-row
// logsumexp, p = exp(Q·Kᵀ·scale − lse), so the (s × s) matrix never reaches
// device memory, and take D = rowsum(dO ∘ O) (computed by the wrapper, as the
// TPU wrapper does outside Pallas):
//   dq kernel:  dp = dO·Vᵀ, ds = p·(dp − D), dQ = scale·Σ_keys ds·K
//   dkv kernel: dV = Σ_queries pᵀ·dO, dK = scale·Σ_queries dsᵀ·Q
// The roundings follow the TPU kernels: ds is rounded to the input dtype
// before ds·K and dsᵀ·Q, p before pᵀ·dO; every product accumulates in f32.
//
// What bounds it on the card. Per (batch, head) the two kernels read Q, K, V
// and dO and write dQ, dK and dV (7·s·d elements) against 6·d (dq) and 8·d
// (dkv) FLOPs per query-key pair the mask keeps: at the training shape
// (s = 8192, d = 64, causal) that is ~1,100 FLOPs per byte, so the tensor
// cores are the bound, with the exponential of every kept pair on the SFU
// beside them; at BERT's s = 128 it is ~50 and memory is.
//
// The TPU split is kept: each output is owned by one block, so no atomics
// and no second pass. Ragged lengths are masked in the kernels (keys past
// s_k, queries past s_q, so a zero-filled padding query adds nothing to dK or
// dV), and q/k/v/dO are read through their (batch, seq, head) strides, so
// views of the fused qkv product need no copy.
//
// dk/dv, bf16 (a Hopper kernel: TMA, wgmma and warp specialisation):
//   * One block per (128-key tile, batch·head), 384 threads: two consumer
//     warpgroups, each owning 64 keys, and one producer warpgroup, of which
//     one warp works. It loads K and V once, then streams Q and dO of each
//     64-query tile from the diagonal on (causal) through a ring of two
//     stages with TMA (4-D maps over the operands' real strides), its lanes
//     copying the tile's lse and D beside them; "full" and "empty"
//     mbarriers guard each stage, so the next tile's loads overlap this
//     tile's products.
//   * Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ are wgmma m64n64k16 with both operands in
//     shared memory (K-major), so each consumer's accumulators hold its own
//     keys' rows. p = exp(Sᵀ·scale − lse) and ds = p·(dPᵀ − D) are computed
//     in registers (lse and D of the tile's queries read from the stage);
//     rounded to bf16 they are the register A operands of dV += pᵀ·dO and
//     dK += dsᵀ·Q (wgmma m64nDk16), with dO and Q as MN-major shared B
//     operands — no scalar shared-memory loads in the loop. dV's product
//     runs on the tensor cores while ds is computed.
//   * dK, dV, Sᵀ and dPᵀ live in registers together (4 × 32 f32 a thread at
//     d = 64, ~192 at d = 128): the consumers take 240 registers and the
//     producer gives its own back (setmaxnreg), one block per SM. The grid
//     walks the key tiles in ascending order, all heads first, so the
//     longest causal blocks (k tile 0 walks every Q tile) start first.
// dq, bf16 (a Hopper kernel: TMA, wgmma and warp specialisation, the
// forward's shape with one more product):
//   * One block per (Q tile, batch·head): consumer warpgroups, each owning
//     64 query rows (three at d ≤ 64, a 192-row tile; two at d = 128), and
//     a producer warp. One producer thread loads Q and dO once, then
//     streams the K and V tiles of 64 keys up to the diagonal (causal)
//     through a ring of two stages, with separate "full" mbarriers for K
//     and V (S = Q·Kᵀ starts before V lands) and an "empty" mbarrier every
//     consumer warp arrives on (four stages measured no faster).
//   * S = Q·Kᵀ and dP = dO·Vᵀ are wgmma m64n64k16 with both operands in
//     shared memory (K-major); p = exp(S·scale − lse) is computed while dP
//     runs (lse and D of a thread's two rows held in registers), then
//     ds = p·(dP − D), rounded to bf16, is the register A operand of
//     dQ += ds·K (wgmma m64nDk16) with the K stage read again as the
//     MN-major B operand — no scalar shared-memory loads in the loop.
//   * S, dP, dQ and the ds fragments live in registers together (ptxas:
//     110 / 122 / 156 a thread at d = 32 / 64 / 128, no spills): one block
//     per SM with no hand-over. Each consumer waits for its own products;
//     the warpgroups' interleaving is the overlap (on the H100 a third
//     warpgroup made the LM shape faster, while letting dQ run on into
//     the next tile's S and dP made it slower). The grid walks the Q tiles
//     longest first, as the forward does; a consumer whose rows are all
//     past s_q skips its products.
// f32 (both kernels): one thread per row of the block's tile, scalar f32 FMA
// (never TF32), a correctness path that matches the plain version to ~1e-6.

#include <math_constants.h>

#include "flash_common.cuh"
#include "flash_hopper.cuh"

namespace {

using namespace flash;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (b, h, s_q)
  const float* delta;  // (b, h, s_q): rowsum(dO ∘ O)
  void* dq;
  void* dk;
  void* dv;
  int h, s_q, s_k;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  float scale;
  int causal;
};

__device__ __forceinline__ bool masked(const Params& p, int key, int qpos) {
  return key >= p.s_k || qpos >= p.s_q || (p.causal && key > qpos);
}

// K tiles a Q tile visits (dq): causal stops at the diagonal tile.
__device__ __forceinline__ int k_tile_end(const Params& p, int q_tile) {
  int n = (p.s_k + kBlockK - 1) / kBlockK;
  if (p.causal) n = min(n, (q_tile * kBlockQ + kBlockQ - 1) / kBlockK + 1);
  return n;
}

// First Q tile a K tile visits (dkv): causal starts at the diagonal tile.
__device__ __forceinline__ int q_tile_begin(const Params& p, int k_tile) {
  return p.causal ? (k_tile * kBlockK) / kBlockQ : 0;
}

template <typename T>
__device__ __forceinline__ const T* slice(const void* base, int bi, int hi,
                                          long long sb, long long sh) {
  return static_cast<const T*>(base) + bi * sb + hi * sh;
}

template <typename T>
__device__ __forceinline__ T* slice_out(void* base, int bi, int hi,
                                        long long sb, long long sh) {
  return static_cast<T*>(base) + bi * sb + hi * sh;
}

// ---------------------------------------------------------------------------
// dq, bf16: TMA, wgmma and warp specialisation
// ---------------------------------------------------------------------------

struct DqParams {
  CUtensorMap tm_q;      // boxes of kRows rows
  CUtensorMap tm_do;
  CUtensorMap tm_k;      // boxes of kKeys rows
  CUtensorMap tm_v;
  const float* lse;      // (b, h, s_q)
  const float* delta;    // (b, h, s_q)
  void* dq;
  int h, s_q, s_k;
  long long dq_sb, dq_ss, dq_sh;
  float scale;
  float scale_log2;  // scale · log2(e)
  int causal;
};

namespace dq {

constexpr int kKeys = 64;  // keys per K/V stage
constexpr int kStages = 2;

// One block per SM, with no register hand-over: consumer warpgroups of 64
// Q rows each and a producer warp. Three consumers at d ≤ 64 (416 threads,
// up to 152 registers a thread) keep the tensor cores busier than two while
// one waits on its exponentials; at d = 128 the consumers need ~156
// registers, so two (288 threads, up to 224).
template <int D>
struct Config {
  static constexpr int kConsumers = D <= 64 ? 3 : 2;
  static constexpr int kRows = 64 * kConsumers;  // Q rows per block
  static constexpr int kThreads = 128 * kConsumers + 32;
  static constexpr int kQBytes = kRows * D * 2;   // Q (or dO)
  static constexpr int kKVBytes = kKeys * D * 2;  // one K or V stage
  static constexpr int kQ = 0;
  static constexpr int kDO = kQBytes;
  static constexpr int kK = 2 * kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBars = kV + kStages * kKVBytes;
  // qdo_full, k_full[kStages], v_full[kStages], empty[kStages]; 1024 bytes
  // of slack to align the base.
  static constexpr int kSmem = kBars + (1 + 3 * kStages) * 8 + 1024;
};

}  // namespace dq

template <int D>
__global__ void __launch_bounds__(dq::Config<D>::kThreads, 1)
    flash_bwd_dq_bf16_kernel(const __grid_constant__ DqParams p) {
  using namespace dq;
  using C = Config<D>;
  using T = hopper::Tile<D>;
  constexpr int kRows = C::kRows;
  constexpr int kConsumerThreads = 128 * C::kConsumers;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::kBars);
  uint64_t* qdo_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + kStages;
  uint64_t* empty = bars + 1 + 2 * kStages;

  const int bh = blockIdx.x;
  const int bi = bh / p.h, hi = bh % p.h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // longest rows first
  int n_tiles = (p.s_k + kKeys - 1) / kKeys;
  if (p.causal) n_tiles = min(n_tiles, (q0 + kRows - 1) / kKeys + 1);

  if (threadIdx.x == 0) {
    hopper::mbar_init(qdo_full, 1);
    for (int i = 0; i < kStages; ++i) {
      hopper::mbar_init(k_full + i, 1);
      hopper::mbar_init(v_full + i, 1);
      hopper::mbar_init(empty + i, kConsumerThreads / 32);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    // Producer: one thread loads Q and dO once, then keeps the K/V ring
    // full.
    if (threadIdx.x == kConsumerThreads) {
      hopper::mbar_expect_tx(qdo_full, 2 * C::kQBytes);
      for (int j = 0; j < T::kBoxes; ++j) {
        hopper::tma_load_4d(smem + C::kQ + j * kRows * T::kSwizzle, &p.tm_q,
                            qdo_full, j * 64, hi, q0, bi);
        hopper::tma_load_4d(smem + C::kDO + j * kRows * T::kSwizzle,
                            &p.tm_do, qdo_full, j * 64, hi, q0, bi);
      }
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
    const int c = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int row0 = q0 + c * 64 + warp * 16 + g;  // rows row0 and row0 + 8
    int n_mine = n_tiles;  // tiles after these lie wholly above my rows
    if (p.causal) n_mine = min(n_tiles, (q0 + c * 64 + 63) / kKeys + 1);
    if (q0 + c * 64 >= p.s_q) n_mine = 0;  // every row of mine is padding

    // This thread's rows: lse in base 2 and D, zero past s_q (such rows
    // are computed but never written).
    float lse_r[2], d_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = row0 + 8 * r;
      const bool ok = qpos < p.s_q;
      const long long at = (long long)bh * p.s_q + qpos;
      lse_r[r] = ok ? p.lse[at] * 1.4426950408889634f : 0.f;
      d_r[r] = ok ? p.delta[at] : 0.f;
    }
    const uint8_t* qs = smem + C::kQ;
    const uint8_t* dos = smem + C::kDO;

    float acc[D / 2];  // dQ before the scale
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    hopper::mbar_wait(qdo_full, 0);
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

        // S = Q·Kᵀ, then dP = dO·Vᵀ once V has landed: my 64 rows × the
        // stage's 64 keys. p is computed while dP runs.
        float s[32], dp[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
        hopper::wgmma_fence();
#pragma unroll
        for (int k = 0; k < D / 16; ++k)
          hopper::wgmma_ss_n64(s, T::k_major(qs, kRows, c * 64, k),
                               T::k_major(ks, kKeys, 0, k), k > 0);
        hopper::wgmma_commit();
        hopper::mbar_wait(v_full + st, phase);
#pragma unroll
        for (int k = 0; k < D / 16; ++k)
          hopper::wgmma_ss_n64(dp, T::k_major(dos, kRows, c * 64, k),
                               T::k_major(vs, kKeys, 0, k), k > 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();
        hopper::fence_regs(s);

        // p = exp(S·scale − lse); masked pairs give 0. Element 4j + e sits
        // at row row0 + 8·(e / 2), key k0 + 8j + 2t + e % 2.
        const bool edge = k0 + kKeys > p.s_k ||
                          (p.causal && k0 + kKeys - 1 > q0 + c * 64);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e / 2;
            float pe = hopper::exp2_approx(
                fmaf(s[4 * j + e], p.scale_log2, -lse_r[r]));
            if (edge) {
              const int key = k0 + 8 * j + 2 * t + (e % 2);
              if (key >= p.s_k || (p.causal && key > row0 + 8 * r)) pe = 0.f;
            }
            s[4 * j + e] = pe;
          }
        }

        // ds = p·(dP − D), rounded to bf16, then dQ += ds·K with K as the
        // MN-major B operand.
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dp);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          dp[i] = s[i] * (dp[i] - d_r[(i / 2) % 2]);
        uint32_t da[4][4];  // ds in bf16, one A fragment per 16-key step
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          acc_to_a_frag(da[kk], &dp[8 * kk], &dp[8 * kk + 4]);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_rs(acc, da[kk], T::mn_major(ks, kKeys, kk));
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        hopper::fence_regs(da);
      }
      if (lane == 0) hopper::mbar_arrive(empty + st);
    }

    __nv_bfloat16* dqp =
        slice_out<__nv_bfloat16>(p.dq, bi, hi, p.dq_sb, p.dq_sh);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = row0 + 8 * r;
      if (qpos >= p.s_q) continue;
      __nv_bfloat16* row = dqp + qpos * p.dq_ss + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(row + j * 8) = pack_f32(
            acc[4 * j + 2 * r] * p.scale, acc[4 * j + 2 * r + 1] * p.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// dk/dv, bf16: TMA, wgmma and warp specialisation
// ---------------------------------------------------------------------------

struct DkvParams {
  CUtensorMap tm_k;      // boxes of kKeys rows
  CUtensorMap tm_v;
  CUtensorMap tm_q;      // boxes of kQueries rows
  CUtensorMap tm_do;
  const float* lse;      // (b, h, s_q)
  const float* delta;    // (b, h, s_q)
  void* dk;
  void* dv;
  int h, s_q, s_k;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  float scale;
  float scale_log2;  // scale · log2(e)
  int causal;
};

namespace dkv {

constexpr int kKeys = 128;     // keys per block, 64 per consumer warpgroup
constexpr int kQueries = 64;   // queries per stage
constexpr int kStages = 2;
// Consumer warpgroups 0 and 1, producer warpgroup 2 (one warp works): 168
// registers a thread at launch, handed over as 240 to each consumer thread
// and 24 to each producer thread (see flash_fwd.cu).
constexpr int kThreads = 384;
constexpr int kConsumerWarps = 8;
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;
constexpr int kRegPool = 256 * kConsumerRegs + 128 * kProducerRegs;

template <int D>
struct Config {
  static constexpr int kKBytes = kKeys * D * 2;     // K (or V)
  static constexpr int kQBytes = kQueries * D * 2;  // Q (or dO) of a stage
  static constexpr int kRowBytes = kQueries * 4;    // lse (or D) of a stage
  static constexpr int kStageTx = 2 * kQBytes;  // TMA bytes of a stage
  static constexpr int kStageBytes =
      (2 * kQBytes + 2 * kRowBytes + 1023) / 1024 * 1024;
  static constexpr int kK = 0;
  static constexpr int kV = kKBytes;
  static constexpr int kStage0 = 2 * kKBytes;  // Q, dO, lse, D
  static constexpr int kBars = kStage0 + kStages * kStageBytes;
  // kv_full, full[2], empty[2]; 1024 bytes of slack to align the base.
  static constexpr int kSmem = kBars + 5 * 8 + 1024;
};

}  // namespace dkv

template <int D>
__global__ void __launch_bounds__(dkv::kThreads, 1)
    flash_bwd_dkv_bf16_kernel(const __grid_constant__ DkvParams p) {
  using namespace dkv;
  using C = Config<D>;
  using T = hopper::Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::kBars);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int bh = blockIdx.x;
  const int bi = bh / p.h, hi = bh % p.h;
  const int k0 = blockIdx.y * kKeys;
  const int n_q = (p.s_q + kQueries - 1) / kQueries;
  // Causal: the first Q tile holding a query at or after the block's first
  // key.
  const int qt_begin = p.causal ? k0 / kQueries : 0;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int i = 0; i < kStages; ++i) {
      // The TMA arrival and one from each producer lane for lse and D.
      hopper::mbar_init(full + i, 1 + 32);
      hopper::mbar_init(empty + i, kConsumerWarps);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // Producer warpgroup, one warp at work: lane 0 issues the TMA loads;
    // every lane copies two of the tile's 64 lse and D values into the
    // stage (zero past s_q).
    hopper::reg_dealloc<kProducerRegs>();
    const int lane = threadIdx.x % 32;
    if (threadIdx.x >= 288) return;
    if (lane == 0) {
      hopper::mbar_expect_tx(kv_full, 2 * C::kKBytes);
      for (int j = 0; j < T::kBoxes; ++j) {
        hopper::tma_load_4d(smem + C::kK + j * kKeys * T::kSwizzle, &p.tm_k,
                            kv_full, j * 64, hi, k0, bi);
        hopper::tma_load_4d(smem + C::kV + j * kKeys * T::kSwizzle, &p.tm_v,
                            kv_full, j * 64, hi, k0, bi);
      }
    }
    const float* lse = p.lse + (long long)bh * p.s_q;
    const float* delta = p.delta + (long long)bh * p.s_q;
    for (int qt = qt_begin, i = 0; qt < n_q; ++qt, ++i) {
      const int st = i % kStages;
      hopper::mbar_wait(empty + st, ((i / kStages) & 1) ^ 1);
      uint8_t* base = smem + C::kStage0 + st * C::kStageBytes;
      if (lane == 0) {
        hopper::mbar_expect_tx(full + st, C::kStageTx);
        for (int j = 0; j < T::kBoxes; ++j) {
          hopper::tma_load_4d(base + j * kQueries * T::kSwizzle, &p.tm_q,
                              full + st, j * 64, hi, qt * kQueries, bi);
          hopper::tma_load_4d(base + C::kQBytes + j * kQueries * T::kSwizzle,
                              &p.tm_do, full + st, j * 64, hi, qt * kQueries,
                              bi);
        }
      }
      float* rows = reinterpret_cast<float*>(base + 2 * C::kQBytes);
      for (int r = lane; r < kQueries; r += 32) {
        const int qpos = qt * kQueries + r;
        rows[r] = qpos < p.s_q ? lse[qpos] : 0.f;
        rows[kQueries + r] = qpos < p.s_q ? delta[qpos] : 0.f;
      }
      hopper::mbar_arrive(full + st);  // releases the stores above
    }
  } else {
    // Consumer warpgroup c: keys [kc, kc + 64).
    hopper::reg_alloc<kConsumerRegs>();
    const int c = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int kc = k0 + c * 64;
    const int key0 = kc + warp * 16 + g;  // this thread's keys: key0, key0 + 8
    // Causal: Q tiles before this one lie wholly before my keys.
    const int qt_mine = p.causal ? kc / kQueries : 0;
    const float lse_scale = 1.4426950408889634f;  // lse to base 2

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    hopper::mbar_wait(kv_full, 0);
    for (int qt = qt_begin, i = 0; qt < n_q; ++qt, ++i) {
      const int st = i % kStages;
      // Waited on even when skipped: the empty arrival below must not count
      // towards the stage's previous use.
      hopper::mbar_wait(full + st, (i / kStages) & 1);
      if (qt >= qt_mine) {
        const uint8_t* qs = smem + C::kStage0 + st * C::kStageBytes;
        const uint8_t* dos = qs + C::kQBytes;
        const float* lse_s =
            reinterpret_cast<const float*>(qs + 2 * C::kQBytes);
        const float* d_s = lse_s + kQueries;
        const int q0 = qt * kQueries;

        // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: my 64 keys × the tile's 64 queries.
        float s[32], dp[32];
#pragma unroll
        for (int i2 = 0; i2 < 32; ++i2) s[i2] = dp[i2] = 0.f;
        hopper::wgmma_fence();
#pragma unroll
        for (int k = 0; k < D / 16; ++k)
          hopper::wgmma_ss_n64(s, T::k_major(smem + C::kK, kKeys, c * 64, k),
                               T::k_major(qs, kQueries, 0, k), k > 0);
#pragma unroll
        for (int k = 0; k < D / 16; ++k)
          hopper::wgmma_ss_n64(dp, T::k_major(smem + C::kV, kKeys, c * 64, k),
                               T::k_major(dos, kQueries, 0, k), k > 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);
        hopper::fence_regs(dp);

        // p = exp(sᵀ·scale − lse); masked pairs give 0. Element 4j + e
        // sits at key key0 + 8·(e / 2), query q0 + 8j + 2t + e % 2.
        const bool edge = q0 + kQueries > p.s_q || kc + 64 > p.s_k ||
                          (p.causal && kc + 63 > q0);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 lse2 =
              *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float lse_q = (e % 2 ? lse2.y : lse2.x) * lse_scale;
            float pe = hopper::exp2_approx(
                fmaf(s[4 * j + e], p.scale_log2, -lse_q));
            if (edge) {
              const int key = key0 + 8 * (e / 2);
              const int qpos = q0 + 8 * j + 2 * t + (e % 2);
              if (key >= p.s_k || qpos >= p.s_q || (p.causal && key > qpos))
                pe = 0.f;
            }
            s[4 * j + e] = pe;
          }
        }

        // dV += pᵀ·dO, p rounded to bf16, runs while ds is computed.
        uint32_t pa[4][4], da[4][4];  // p and ds in bf16, per 16-query step
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          acc_to_a_frag(pa[kk], &s[8 * kk], &s[8 * kk + 4]);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_rs(dv, pa[kk], T::mn_major(dos, kQueries, kk));
        hopper::wgmma_commit();

        // ds = p·(dpᵀ − D), then dK += dsᵀ·Q, ds rounded to bf16.
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 d2 =
              *reinterpret_cast<const float2*>(d_s + 8 * j + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[4 * j + e] =
                s[4 * j + e] * (dp[4 * j + e] - (e % 2 ? d2.y : d2.x));
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          acc_to_a_frag(da[kk], &dp[8 * kk], &dp[8 * kk + 4]);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_rs(dk, da[kk], T::mn_major(qs, kQueries, kk));
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dv);
        hopper::fence_regs(dk);
        hopper::fence_regs(pa);
        hopper::fence_regs(da);
      }
      if (lane == 0) hopper::mbar_arrive(empty + st);
    }

    __nv_bfloat16* dkp =
        slice_out<__nv_bfloat16>(p.dk, bi, hi, p.dk_sb, p.dk_sh);
    __nv_bfloat16* dvp =
        slice_out<__nv_bfloat16>(p.dv, bi, hi, p.dv_sb, p.dv_sh);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key >= p.s_k) continue;
      __nv_bfloat16* krow = dkp + key * p.dk_ss + 2 * t;
      __nv_bfloat16* vrow = dvp + key * p.dv_ss + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(krow + j * 8) = pack_f32(
            dk[4 * j + 2 * r] * p.scale, dk[4 * j + 2 * r + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(vrow + j * 8) =
            pack_f32(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: scalar FMA, one thread per row of the block's tile
// ---------------------------------------------------------------------------

template <int D>
constexpr int f32_smem_bytes() {
  // Four 64-row tiles with pitch D + 1 (conflict-free row reads) and the 64
  // lse and D values of a Q tile.
  return (4 * 64 * (D + 1) + 2 * 64) * int(sizeof(float));
}

__device__ __forceinline__ float dot_rows(const float* a, const float* b,
                                          int d) {
  float acc = 0.f;
#pragma unroll 16
  for (int c = 0; c < d; ++c) acc = fmaf(a[c], b[c], acc);
  return acc;
}

template <int D>
__global__ void __launch_bounds__(64) flash_bwd_dq_f32_kernel(const Params p) {
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + 64 * LD;
  float* ks = dos + 64 * LD;
  float* vs = ks + 64 * LD;

  const int q_tile = blockIdx.x;
  const int bh = blockIdx.y;
  const int bi = bh / p.h, hi = bh % p.h;
  const int row = threadIdx.x;
  const int q0 = q_tile * kBlockQ;
  const int qpos = q0 + row;
  const bool ok = qpos < p.s_q;

  const float* kp = slice<float>(p.k, bi, hi, p.k_sb, p.k_sh);
  const float* vp = slice<float>(p.v, bi, hi, p.v_sb, p.v_sh);
  load_tile_f32<D>(qs, LD, slice<float>(p.q, bi, hi, p.q_sb, p.q_sh), p.q_ss,
                   q0, p.s_q);
  load_tile_f32<D>(dos, LD, slice<float>(p.dout, bi, hi, p.do_sb, p.do_sh),
                   p.do_ss, q0, p.s_q);
  const float lse = ok ? p.lse[(long long)bh * p.s_q + qpos] : 0.f;
  const float dd = ok ? p.delta[(long long)bh * p.s_q + qpos] : 0.f;
  const float* qrow = qs + row * LD;
  const float* dorow = dos + row * LD;

  float acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.f;

  const int n_tiles = k_tile_end(p, q_tile);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();
    load_tile_f32<D>(ks, LD, kp, p.k_ss, k0, p.s_k);
    load_tile_f32<D>(vs, LD, vp, p.v_ss, k0, p.s_k);
    __syncthreads();
    for (int j = 0; j < kBlockK; ++j) {
      if (masked(p, k0 + j, qpos)) continue;
      const float* krow = ks + j * LD;
      const float pj = expf(dot_rows(qrow, krow, D) * p.scale - lse);
      const float ds = pj * (dot_rows(dorow, vs + j * LD, D) - dd);
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] = fmaf(ds, krow[c], acc[c]);
    }
  }
  if (!ok) return;
  float* out = slice_out<float>(p.dq, bi, hi, p.dq_sb, p.dq_sh) + qpos * p.dq_ss;
#pragma unroll
  for (int c = 0; c < D; ++c) out[c] = acc[c] * p.scale;
}

template <int D>
__global__ void __launch_bounds__(64) flash_bwd_dkv_f32_kernel(const Params p) {
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + 64 * LD;
  float* qs = vs + 64 * LD;
  float* dos = qs + 64 * LD;
  float* lse_s = dos + 64 * LD;
  float* d_s = lse_s + 64;

  const int k_tile = blockIdx.x;
  const int bh = blockIdx.y;
  const int bi = bh / p.h, hi = bh % p.h;
  const int row = threadIdx.x;
  const int k0 = k_tile * kBlockK;
  const int key = k0 + row;

  const float* qp = slice<float>(p.q, bi, hi, p.q_sb, p.q_sh);
  const float* dop = slice<float>(p.dout, bi, hi, p.do_sb, p.do_sh);
  load_tile_f32<D>(ks, LD, slice<float>(p.k, bi, hi, p.k_sb, p.k_sh), p.k_ss,
                   k0, p.s_k);
  load_tile_f32<D>(vs, LD, slice<float>(p.v, bi, hi, p.v_sb, p.v_sh), p.v_ss,
                   k0, p.s_k);
  const float* krow = ks + row * LD;
  const float* vrow = vs + row * LD;

  float dk[D], dv[D];
#pragma unroll
  for (int c = 0; c < D; ++c) dk[c] = dv[c] = 0.f;

  const int n_q = (p.s_q + kBlockQ - 1) / kBlockQ;
  for (int qt = q_tile_begin(p, k_tile); qt < n_q; ++qt) {
    const int q0 = qt * kBlockQ;
    __syncthreads();
    load_tile_f32<D>(qs, LD, qp, p.q_ss, q0, p.s_q);
    load_tile_f32<D>(dos, LD, dop, p.do_ss, q0, p.s_q);
    {
      const int qpos = q0 + row;
      const bool ok = qpos < p.s_q;
      lse_s[row] = ok ? p.lse[(long long)bh * p.s_q + qpos] : 0.f;
      d_s[row] = ok ? p.delta[(long long)bh * p.s_q + qpos] : 0.f;
    }
    __syncthreads();
    for (int i = 0; i < kBlockQ; ++i) {
      if (masked(p, key, q0 + i)) continue;
      const float* qrow = qs + i * LD;
      const float* dorow = dos + i * LD;
      const float pi = expf(dot_rows(qrow, krow, D) * p.scale - lse_s[i]);
      const float ds = pi * (dot_rows(dorow, vrow, D) - d_s[i]);
#pragma unroll
      for (int c = 0; c < D; ++c) {
        dv[c] = fmaf(pi, dorow[c], dv[c]);
        dk[c] = fmaf(ds, qrow[c], dk[c]);
      }
    }
  }
  if (key >= p.s_k) return;
  float* dko = slice_out<float>(p.dk, bi, hi, p.dk_sb, p.dk_sh) + key * p.dk_ss;
  float* dvo = slice_out<float>(p.dv, bi, hi, p.dv_sb, p.dv_sh) + key * p.dv_ss;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    dko[c] = dk[c] * p.scale;
    dvo[c] = dv[c];
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, int smem,
                   cudaStream_t stream, const Params& p) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_bf16(const Params& a, int b, cudaStream_t st) {
  using C = dq::Config<D>;
  static const cudaError_t setup =
      hopper::prepare(flash_bwd_dq_bf16_kernel<D>, C::kSmem, C::kThreads, 0);
  if (setup != cudaSuccess) return setup;
  cudaError_t err;
  DqParams p{};
  if ((err = hopper::encode_bshd(&p.tm_q, a.q, b, a.s_q, a.h, D, a.q_sb,
                                 a.q_ss, a.q_sh, C::kRows)) != cudaSuccess ||
      (err = hopper::encode_bshd(&p.tm_do, a.dout, b, a.s_q, a.h, D, a.do_sb,
                                 a.do_ss, a.do_sh, C::kRows)) !=
          cudaSuccess ||
      (err = hopper::encode_bshd(&p.tm_k, a.k, b, a.s_k, a.h, D, a.k_sb,
                                 a.k_ss, a.k_sh, dq::kKeys)) != cudaSuccess ||
      (err = hopper::encode_bshd(&p.tm_v, a.v, b, a.s_k, a.h, D, a.v_sb,
                                 a.v_ss, a.v_sh, dq::kKeys)) != cudaSuccess)
    return err;
  p.lse = a.lse;
  p.delta = a.delta;
  p.dq = a.dq;
  p.h = a.h;
  p.s_q = a.s_q;
  p.s_k = a.s_k;
  p.dq_sb = a.dq_sb;
  p.dq_ss = a.dq_ss;
  p.dq_sh = a.dq_sh;
  p.scale = a.scale;
  p.scale_log2 = a.scale * 1.4426950408889634f;
  p.causal = a.causal;
  const dim3 grid(b * a.h, (a.s_q + C::kRows - 1) / C::kRows);
  flash_bwd_dq_bf16_kernel<D><<<grid, C::kThreads, C::kSmem, st>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const Params& p, int b, bool bf16, cudaStream_t st) {
  if (bf16) return launch_dq_bf16<D>(p, b, st);
  dim3 grid((p.s_q + kBlockQ - 1) / kBlockQ, b * p.h);
  return launch(flash_bwd_dq_f32_kernel<D>, grid, 64, f32_smem_bytes<D>(), st,
                p);
}

template <int D>
cudaError_t launch_dkv_bf16(const Params& a, int b, cudaStream_t st) {
  using C = dkv::Config<D>;
  static const cudaError_t setup =
      hopper::prepare(flash_bwd_dkv_bf16_kernel<D>, C::kSmem, dkv::kThreads,
                      dkv::kRegPool);
  if (setup != cudaSuccess) return setup;
  cudaError_t err;
  DkvParams p{};
  if ((err = hopper::encode_bshd(&p.tm_k, a.k, b, a.s_k, a.h, D, a.k_sb,
                                 a.k_ss, a.k_sh, dkv::kKeys)) != cudaSuccess ||
      (err = hopper::encode_bshd(&p.tm_v, a.v, b, a.s_k, a.h, D, a.v_sb,
                                 a.v_ss, a.v_sh, dkv::kKeys)) != cudaSuccess ||
      (err = hopper::encode_bshd(&p.tm_q, a.q, b, a.s_q, a.h, D, a.q_sb,
                                 a.q_ss, a.q_sh, dkv::kQueries)) !=
          cudaSuccess ||
      (err = hopper::encode_bshd(&p.tm_do, a.dout, b, a.s_q, a.h, D, a.do_sb,
                                 a.do_ss, a.do_sh, dkv::kQueries)) !=
          cudaSuccess)
    return err;
  p.lse = a.lse;
  p.delta = a.delta;
  p.dk = a.dk;
  p.dv = a.dv;
  p.h = a.h;
  p.s_q = a.s_q;
  p.s_k = a.s_k;
  p.dk_sb = a.dk_sb;
  p.dk_ss = a.dk_ss;
  p.dk_sh = a.dk_sh;
  p.dv_sb = a.dv_sb;
  p.dv_ss = a.dv_ss;
  p.dv_sh = a.dv_sh;
  p.scale = a.scale;
  p.scale_log2 = a.scale * 1.4426950408889634f;
  p.causal = a.causal;
  const dim3 grid(b * a.h, (a.s_k + dkv::kKeys - 1) / dkv::kKeys);
  flash_bwd_dkv_bf16_kernel<D><<<grid, dkv::kThreads, C::kSmem, st>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Params& p, int b, bool bf16, cudaStream_t st) {
  if (bf16) return launch_dkv_bf16<D>(p, b, st);
  dim3 grid((p.s_k + kBlockK - 1) / kBlockK, b * p.h);
  return launch(flash_bwd_dkv_f32_kernel<D>, grid, 64, f32_smem_bytes<D>(), st,
                p);
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, void* dk, void* dv, int h, int s_q, int s_k,
                   const long long* st, float scale, int causal) {
  return Params{q,      k,      v,      dout,   lse,    delta,  dq,
                dk,     dv,     h,      s_q,    s_k,    st[0],  st[1],
                st[2],  st[3],  st[4],  st[5],  st[6],  st[7],  st[8],
                st[9],  st[10], st[11], st[12], st[13], st[14], st[15],
                st[16], st[17], st[18], st[19], st[20], scale,  causal};
}

}  // namespace

// q, k, v, dout: (b, s, h, d) with unit stride over d; strides in elements,
// `strides` holding (batch, seq, head) for q, k, v, dout, dq, dk, dv in that
// order (21 values). lse and delta: (b, h, s_q) f32, contiguous. The dq entry
// writes dq; the dkv entry writes dk and dv (the other pointers may be null).
// Each returns a cudaError_t.
extern "C" int sparktorch_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, int b, int h, int s_q,
    int s_k, int d, const long long* strides, float scale, int causal,
    int bf16, void* stream) {
  const Params p = make_params(q, k, v, dout, lse, delta, dq, nullptr, nullptr,
                               h, s_q, s_k, strides, scale, causal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch_dq<32>(p, b, bf16 != 0, st);
    case 64: return launch_dq<64>(p, b, bf16 != 0, st);
    case 128: return launch_dq<128>(p, b, bf16 != 0, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int sparktorch_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int b, int h,
    int s_q, int s_k, int d, const long long* strides, float scale,
    int causal, int bf16, void* stream) {
  const Params p = make_params(q, k, v, dout, lse, delta, nullptr, dk, dv, h,
                               s_q, s_k, strides, scale, causal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch_dkv<32>(p, b, bf16 != 0, st);
    case 64: return launch_dkv<64>(p, b, bf16 != 0, st);
    case 128: return launch_dkv<128>(p, b, bf16 != 0, st);
    default: return cudaErrorInvalidValue;
  }
}
