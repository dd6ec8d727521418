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

// 16 bytes of T as kN fp32 values (unpack) and back (pack, bf16 rounded
// to nearest even). Element 0 sits in the low bits of word x (little
// endian), so a uint4 loaded from T* p holds p[0 .. kN).
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {       // exact: bf16 is fp32's top half
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const unsigned*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};
template <> struct Vec<int8_t> {
  static constexpr int kN = 16;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int b = 0; b < 4; ++b)       // sign-extend byte b
        f[4 * i + b] = (float)((int)(w[i] << (24 - 8 * b)) >> 24);
  }
};

// N contiguous elements of T from p (16-byte aligned, or 8-byte aligned
// when N elements fill 8 bytes) as fp32, through read-only vector loads.
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* p, float* f) {
  constexpr int kBytes = N * (int)sizeof(T);
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i)
      Vec<T>::unpack(__ldg(reinterpret_cast<const uint4*>(p) + i),
                     f + i * Vec<T>::kN);
  } else {
    static_assert(kBytes == 8, "load_f32 reads 8 or a multiple of 16 bytes");
    const uint2 h = __ldg(reinterpret_cast<const uint2*>(p));
    float t[Vec<T>::kN];
    Vec<T>::unpack(make_uint4(h.x, h.y, 0u, 0u), t);
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = t[i];
  }
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
