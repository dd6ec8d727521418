// Row RMSNorm for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * scale
// over the last dim, in fp32, cast to x's type.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py (rmsnorm, kernel
// _rmsnorm_kernel). Same function, in the plain version's order:
// (x * r) * scale with r = 1 / sqrt(sum(x^2) / D + eps); the scale may
// have another type than x and is read as fp32.
//
// Design. One thread block per row: each thread squares and sums a
// strided share of the row in fp32, warps reduce with shuffles and one
// shared-memory step combines the warps; then one pass writes the row.
// Rows are any leading dims flattened, and the grid has one block for
// each, so no row count needs padding to a block multiple (the Pallas
// kernel pads), and D need not be a power of two (3072 at llama3.2-3b
// width). The second pass re-reads the row from L1/L2, not HBM.
//
// Bound on the H100: one read of x and one write of y; at (4096, 3072)
// bf16 that is ~50 MB, ~15 us at 3.35 TB/s. The few operations per
// element are far below the card's rate, so bytes bound it.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int kThreads = 256;

template <typename T, typename S>
__global__ void __launch_bounds__(kThreads) rmsnorm_kernel(
    const T* __restrict__ x,      // (rows, d)
    const S* __restrict__ scale,  // (d,)
    T* __restrict__ out,          // (rows, d)
    int d, float eps) {
  __shared__ float partial[kThreads / 32];
  __shared__ float total;
  const size_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = out + row * d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = to_f32(xr[i]);
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    ss = warp_sum(lane < kThreads / 32 ? partial[lane] : 0.f);
    if (lane == 0) total = ss;
  }
  __syncthreads();

  const float r = 1.0f / sqrtf(total / (float)d + eps);
  for (int i = threadIdx.x; i < d; i += kThreads)
    yr[i] = from_f32<T>(to_f32(xr[i]) * r * to_f32(scale[i]));
}

template <typename T, typename S>
int launch(const void* x, const void* scale, void* out, int rows, int d,
           float eps, cudaStream_t stream) {
  rmsnorm_kernel<T, S><<<rows, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<T*>(out), d, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_x(const void* x, const void* scale, void* out, int rows, int d,
             float eps, int scale_dtype, cudaStream_t stream) {
  if (scale_dtype == kFloat32)
    return launch<T, float>(x, scale, out, rows, d, eps, stream);
  if (scale_dtype == kBFloat16)
    return launch<T, __nv_bfloat16>(x, scale, out, rows, d, eps, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int repro_rmsnorm(const void* x, const void* scale, void* out,
                             int rows, int d, float eps, int dtype,
                             int scale_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return launch_x<float>(x, scale, out, rows, d, eps, scale_dtype, s);
  if (dtype == repro::kBFloat16)
    return launch_x<__nv_bfloat16>(x, scale, out, rows, d, eps, scale_dtype,
                                   s);
  return (int)cudaErrorInvalidValue;
}
