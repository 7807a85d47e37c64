// Fused softmax cross-entropy for Hopper (sm_90a), with a plain C interface.
//
// Replaces the two TPU kernels of sparktorch_tpu/ops/fused_ce.py:
//   * `_ce_kernel` (launched by `_ce_impl`): per-token loss over logits
//     (t, v), streamed once with a running max m and a rescaled sum-exp l,
//     so the softmax never exists in memory; loss = m + log l − logit[label].
//     The kernel also writes lse = m + log l, the backward's residual (the TPU
//     wrapper re-gathers the picked logit instead; the numbers are the same).
//   * `_ce_bwd_kernel` (launched by `_ce_bwd`): d logits =
//     (exp(s − lse) − onehot(label))·g, written straight into the (t, v)
//     gradient in the logits' dtype.
// A label outside [0, v) picks nothing, as in the TPU kernels.
//
// What bounds it on the card: bytes. The forward reads t·v logits once, the
// backward reads them once and writes the gradient once, with a handful of
// operations per element (one exp each), far below the ~20 f32 operations
// per byte at which the H100's arithmetic would be the limit.
//
// Design: one block of 256 threads per token row. Loads and stores are 16
// bytes a thread where the row allows it; a row that does not start on a
// 16-byte boundary (v = 30,522 in f32) takes its few head elements one at a
// time, and so does the tail, so no vocabulary size falls back to a dense
// path. The forward merges the threads' (m, l) pairs with warp shuffles and
// one pass through shared memory. Logits may be f32 or bf16; everything is
// computed in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Elements of a row before its first 16-byte boundary.
template <typename T>
__device__ __forceinline__ int head_len(const T* x, int v) {
  const int bytes = int((16 - (reinterpret_cast<uintptr_t>(x) & 15)) & 15);
  return min(v, bytes / int(sizeof(T)));
}

// Online (max, sum-exp) of one value.
__device__ __forceinline__ void online_add(float& m, float& l, float x) {
  if (x > m) {
    l = l * expf(m - x) + 1.f;
    m = x;
  } else {
    l += expf(x - m);
  }
}

// Merge another (max, sum-exp) pair into (m, l).
__device__ __forceinline__ void online_merge(float& m, float& l, float m2,
                                             float l2) {
  const float mx = fmaxf(m, m2);
  if (mx == -CUDART_INF_F) return;  // both empty
  l = l * expf(m - mx) + l2 * expf(m2 - mx);
  m = mx;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ce_fwd_kernel(const T* logits, long long stride, const long long* labels,
                  float* loss, float* lse_out, int v) {
  constexpr int N = 16 / sizeof(T);
  const long long row = blockIdx.x;
  const T* x = logits + row * stride;
  float m = -CUDART_INF_F, l = 0.f;

  const int head = head_len(x, v);
  for (int i = threadIdx.x; i < head; i += kThreads) online_add(m, l, to_f(x[i]));
  const int n_vec = (v - head) / N;
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  for (int i = threadIdx.x; i < n_vec; i += kThreads) {
    const uint4 raw = xv[i];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < N; ++k) online_add(m, l, to_f(e[k]));
  }
  for (int i = head + n_vec * N + threadIdx.x; i < v; i += kThreads)
    online_add(m, l, to_f(x[i]));

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
    online_merge(m, l, m2, l2);
  }
  __shared__ float ms[kThreads / 32], ls[kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    ms[warp] = m;
    ls[warp] = l;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) online_merge(m, l, ms[w], ls[w]);
    const long long label = labels[row];
    const float picked =
        (label >= 0 && label < v) ? to_f(x[label]) : 0.f;
    const float lse = m + logf(fmaxf(l, 1e-30f));
    loss[row] = lse - picked;
    lse_out[row] = lse;
  }
}

template <typename T>
__device__ __forceinline__ T grad_at(float s, int col, long long label,
                                     float lse, float g) {
  return from_f<T>((expf(s - lse) - (col == label ? 1.f : 0.f)) * g);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ce_bwd_kernel(const T* logits, long long stride_in,
                  const long long* labels, const float* lse, const float* g,
                  T* grad, long long stride_out, int v) {
  constexpr int N = 16 / sizeof(T);
  const long long row = blockIdx.x;
  const T* x = logits + row * stride_in;
  T* y = grad + row * stride_out;
  const long long label = labels[row];
  const float lr = lse[row], gr = g[row];

  // 16-byte accesses need the input and output rows to share an alignment.
  const bool vec = ((reinterpret_cast<uintptr_t>(x) ^
                     reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  const int head = vec ? head_len(x, v) : v;
  for (int i = threadIdx.x; i < head; i += kThreads)
    y[i] = grad_at<T>(to_f(x[i]), i, label, lr, gr);
  const int n_vec = (v - head) / N;
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  uint4* yv = reinterpret_cast<uint4*>(y + head);
  for (int i = threadIdx.x; i < n_vec; i += kThreads) {
    const uint4 raw = xv[i];
    const T* e = reinterpret_cast<const T*>(&raw);
    uint4 out;
    T* o = reinterpret_cast<T*>(&out);
    const int col0 = head + i * N;
#pragma unroll
    for (int k = 0; k < N; ++k) o[k] = grad_at<T>(to_f(e[k]), col0 + k, label, lr, gr);
    yv[i] = out;
  }
  for (int i = head + n_vec * N + threadIdx.x; i < v; i += kThreads)
    y[i] = grad_at<T>(to_f(x[i]), i, label, lr, gr);
}

}  // namespace

// logits: (t, v) with unit stride over v and row stride `stride` (elements),
// f32 or (bf16 != 0) bf16; labels: (t,) int64. Writes loss and lse, (t,) f32.
extern "C" int sparktorch_ce_fwd(const void* logits, long long stride,
                                 const long long* labels, float* loss,
                                 float* lse, int t, int v, int bf16,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    ce_fwd_kernel<<<t, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(logits), stride, labels, loss, lse, v);
  else
    ce_fwd_kernel<<<t, kThreads, 0, st>>>(static_cast<const float*>(logits),
                                          stride, labels, loss, lse, v);
  return cudaGetLastError();
}

// grad: (t, v) in the logits' dtype, row stride `stride_out`; lse and g:
// (t,) f32.
extern "C" int sparktorch_ce_bwd(const void* logits, long long stride_in,
                                 const long long* labels, const float* lse,
                                 const float* g, void* grad,
                                 long long stride_out, int t, int v, int bf16,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    ce_bwd_kernel<<<t, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(logits), stride_in, labels, lse, g,
        static_cast<__nv_bfloat16*>(grad), stride_out, v);
  else
    ce_bwd_kernel<<<t, kThreads, 0, st>>>(static_cast<const float*>(logits),
                                          stride_in, labels, lse, g,
                                          static_cast<float*>(grad),
                                          stride_out, v);
  return cudaGetLastError();
}
