// Row RMSNorm for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * scale
// over the last dim, in fp32, cast to x's type.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py (rmsnorm, kernel
// _rmsnorm_kernel). Same function, in the plain version's order:
// (x * r) * scale with r = 1 / sqrt(sum(x^2) / D + eps), rounded once at
// the end; the scale may have another type than x and is read as fp32.
// Rows are any leading dims flattened; D need not be a power of two
// (3072 at llama3.2-3b width), and no row count needs padding (the
// Pallas kernel pads rows to its block).
//
// Bound on the H100: one read of x and one write of y; at (4096, 3072)
// bf16 that is ~50 MB, ~15 us at 3.35 TB/s. The few operations per
// element are far below the card's rate, so bytes bound it.
//
// Design, two kernels chosen by the wrapper from the tensors' shape and
// addresses (kernels/rmsnorm.py):
//   * rmsnorm_vec_kernel, for rows of whole 16-byte vectors (D a multiple
//     of 8 in bf16, 4 in fp32) at 16-byte aligned addresses, D up to
//     16 x 128 vectors (16384 bf16, 8192 fp32): each of 128 threads
//     loads its kVpt vectors of a row with 16-byte loads and keeps them
//     in registers between the square-sum and the write, so x is read
//     from device memory once; the scale slice of each thread is read
//     once per block into registers, and each block walks a share of
//     the rows (grid chosen by the wrapper: a few blocks per SM, equal
//     row counts). The square-sum is a warp shuffle reduction and one
//     shared-memory step per row (double-buffered: one barrier a row);
//     y is written with 16-byte stores.
//   * rmsnorm_kernel, every other input (a D that is not whole vectors, an
//     unaligned view): one block per row with scalar loads, the second
//     pass re-reading the row from L1/L2.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int kThreads = 256;       // scalar kernel
constexpr int kVecThreads = 128;    // vector kernel
constexpr int kVecWarps = kVecThreads / 32;

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

template <typename T, typename S, int kVpt>
__global__ void __launch_bounds__(kVecThreads) rmsnorm_vec_kernel(
    const T* __restrict__ x,      // (rows, d), 16-byte aligned rows
    const S* __restrict__ scale,  // (d,), 16-byte aligned
    T* __restrict__ out,          // (rows, d), 16-byte aligned rows
    int rows, int d, float eps) {
  constexpr int kN = Vec<T>::kN;    // elements of x in 16 bytes
  __shared__ float partial[2][kVecWarps];
  const int nvec = d / kN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  float w[kVpt][kN];                // this thread's scale slice
#pragma unroll
  for (int v = 0; v < kVpt; ++v) {
    const int c = threadIdx.x + v * kVecThreads;
    if (c < nvec) load_f32<S, kN>(scale + (size_t)c * kN, w[v]);
  }

  int buf = 0;
  for (int r = blockIdx.x; r < rows; r += gridDim.x, buf ^= 1) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)r * d);
    uint4 xv[kVpt];
    float ss = 0.f;
#pragma unroll
    for (int v = 0; v < kVpt; ++v) {
      const int c = threadIdx.x + v * kVecThreads;
      if (c < nvec) xv[v] = __ldg(xr + c);
    }
#pragma unroll
    for (int v = 0; v < kVpt; ++v) {
      const int c = threadIdx.x + v * kVecThreads;
      if (c < nvec) {
        float f[kN];
        Vec<T>::unpack(xv[v], f);
#pragma unroll
        for (int e = 0; e < kN; ++e) ss = fmaf(f[e], f[e], ss);
      }
    }
    ss = warp_sum(ss);
    if (lane == 0) partial[buf][warp] = ss;
    __syncthreads();
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < kVecWarps; ++i) total += partial[buf][i];
    const float rs = 1.0f / sqrtf(total / (float)d + eps);

    uint4* yr = reinterpret_cast<uint4*>(out + (size_t)r * d);
#pragma unroll
    for (int v = 0; v < kVpt; ++v) {
      const int c = threadIdx.x + v * kVecThreads;
      if (c < nvec) {
        float f[kN];
        Vec<T>::unpack(xv[v], f);
#pragma unroll
        for (int e = 0; e < kN; ++e) f[e] = f[e] * rs * w[v][e];
        yr[c] = Vec<T>::pack(f);
      }
    }
  }
}

template <typename T, typename S>
int launch(const void* x, const void* scale, void* out, int rows, int d,
           int grid, float eps, bool vector, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const S* sp = static_cast<const S*>(scale);
  T* yp = static_cast<T*>(out);
  if (!vector) {
    rmsnorm_kernel<T, S><<<rows, kThreads, 0, stream>>>(xp, sp, yp, d, eps);
    return (int)cudaGetLastError();
  }
  const int nvec = d / Vec<T>::kN;
  const int vpt = (nvec + kVecThreads - 1) / kVecThreads;
  if (d % Vec<T>::kN || grid < 1) return (int)cudaErrorInvalidValue;
#define REPRO_RMSNORM_VPT(V)                                               \
  if (vpt <= V) {                                                          \
    rmsnorm_vec_kernel<T, S, V><<<grid, kVecThreads, 0, stream>>>(         \
        xp, sp, yp, rows, d, eps);                                         \
    return (int)cudaGetLastError();                                        \
  }
  REPRO_RMSNORM_VPT(1)
  REPRO_RMSNORM_VPT(2)
  REPRO_RMSNORM_VPT(4)
  REPRO_RMSNORM_VPT(8)
  REPRO_RMSNORM_VPT(16)   // kernels/rmsnorm.py MAX_VECTORS_PER_THREAD
#undef REPRO_RMSNORM_VPT
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_x(const void* x, const void* scale, void* out, int rows, int d,
             int grid, float eps, int scale_dtype, bool vector,
             cudaStream_t stream) {
  if (scale_dtype == kFloat32)
    return launch<T, float>(x, scale, out, rows, d, grid, eps, vector,
                            stream);
  if (scale_dtype == kBFloat16)
    return launch<T, __nv_bfloat16>(x, scale, out, rows, d, grid, eps,
                                    vector, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// vector != 0 takes rmsnorm_vec_kernel on ``grid`` blocks (the caller has
// checked whole, aligned 16-byte vectors); else rmsnorm_kernel, one block
// per row.
extern "C" int repro_rmsnorm(const void* x, const void* scale, void* out,
                             int rows, int d, int grid, float eps, int dtype,
                             int scale_dtype, int vector, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return launch_x<float>(x, scale, out, rows, d, grid, eps, scale_dtype,
                           vector != 0, s);
  if (dtype == repro::kBFloat16)
    return launch_x<__nv_bfloat16>(x, scale, out, rows, d, grid, eps,
                                   scale_dtype, vector != 0, s);
  return (int)cudaErrorInvalidValue;
}
