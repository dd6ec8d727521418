// Shared helpers for the port's hand-written Hopper kernels.
#pragma once

#include <math.h>
#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

// dtype codes shared with the Python wrappers (kernels/_build.py)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;
constexpr int kInt8 = 2;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f32<int8_t>(int8_t x) {
  return (float)x;  // an int8 KV code, exact in fp32
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);  // round to nearest even
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One online-softmax step over a (rows, cols) tile of fp32 scores held in
// shared memory, masked entries being -inf. One warp per row: the row
// max and sum are warp reductions. Scores are replaced by their
// probabilities exp(s - m_new); m, l and the rescale factor alpha of the
// running accumulator are updated per row. A row with no visible key so
// far keeps m = -inf, l = 0 and gets all-zero probabilities.
__device__ __forceinline__ void online_softmax_rows(
    float* p, float* m, float* l, float* alpha, int rows, int cols,
    int n_threads) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += n_threads >> 5) {
    float* pr = p + r * cols;
    float mx = -INFINITY;
    for (int t = lane; t < cols; t += 32) mx = fmaxf(mx, pr[t]);
    mx = warp_max(mx);
    const float m_old = m[r];
    const float m_new = fmaxf(m_old, mx);
    float sum = 0.f;
    for (int t = lane; t < cols; t += 32) {
      const float s = pr[t];
      const float e = (s == -INFINITY) ? 0.f : expf(s - m_new);
      pr[t] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float a = (m_old == -INFINITY) ? 0.f : expf(m_old - m_new);
      l[r] = l[r] * a + sum;
      m[r] = m_new;
      alpha[r] = a;
    }
  }
}

}  // namespace repro
