// Training-mode BatchNorm for Hopper (sm_90a), forward and backward, from
// the batch's statistics, with a ReLU or an add-the-shortcut-then-ReLU
// epilogue fused in. The activations keep their own type (bf16 or fp32)
// in device memory; everything is computed in fp32.
//
// Replaces no TPU kernel: the reference's BatchNorm
// (src/repro/models/resnet.py::batchnorm) is plain array code that XLA
// fuses. What it replaces is the port's composition on the card: a cast
// of x to fp32, cuDNN's fp32 BatchNorm, a cast back, then ReLU and the
// residual add as separate passes, with autograd casting every gradient
// both ways again (kernels.ref.batchnorm_ref, still the CPU path).
//
// Layout: channels_last x (N, C, H, W) is an [M, C] row-major matrix,
// M = N*H*W; statistics are per channel (column) over the M rows.
// The function, per channel, with the plain version's rounding:
//   mean = sum(x) / M, var = sum((x - mean)^2) / M (biased),
//   rstd = 1 / sqrt(var + eps), xhat = (x - mean) * rstd,
//   y = round(xhat * scale + bias)              (one fma, rounded to T)
//   epilogue none: y; relu: max(y, 0);
//   add_relu: round(max(y + sc, 0)), y rounded before the add.
// Backward, g = dy masked by the ReLU (for relu the mask is recomputed
// from x with the forward's arithmetic, so y is not kept; for add_relu it
// is out > 0, out being the block's output):
//   dbias = sum(g), dscale = sum(g * xhat)      (rounded to the params' type)
//   dx = rstd*scale * (g - sum(g)/M - xhat * sum(g*xhat)/M), rounded once;
//   add_relu also writes d_sc = g (exact in T).
// The ops that make y are pinned with the _rn intrinsics, so the backward's
// recomputed mask sees the forward's y to the bit.
//
// Bound on the H100: bytes. Per element in bf16 the forward reads x twice
// (statistics, then apply) and writes y: 6 B; the backward reads dy and x
// twice and writes dx: 10 B; add_relu adds sc (2 B) forward and out twice
// plus d_sc (6 B) backward. ResNet50's 53 calls at batch 256 move ~57 GB
// a step, ~17 ms at 3.35 TB/s; the few operations per element are far
// below the card's rate.
//
// Design, two launches each way on the caller's stream, no host
// synchronise:
//   * Tiling, shared by the four kernels: a grid of (row chunks x channel
//     tiles of kTile = 64 channels); a thread holds one 16-byte vector of
//     channels (8 bf16 or 4 fp32) of a tile and walks the chunk's rows
//     kRows apart, several 16-byte loads in flight. The wrapper
//     (kernels/batchnorm.py) picks each kernel's chunks from M, C and the
//     kernel's resident blocks an SM (repro_batchnorm_occupancy), so that
//     its grid fills the SMs in one wave of equal blocks.
//   * batchnorm_stats_kernel: each thread keeps (count, mean, M2) of its
//     channels by Welford's update; a block merges its threads' with
//     Chan's formula (warp shuffles, then the warps in order through
//     shared memory) and writes one partial per chunk and channel. The
//     last block of a channel tile to finish (an int ticket per tile)
//     merges the tile's partials in a fixed order, writes fp32 mean and
//     rstd and resets the ticket to 0. No E[x^2] - E[x]^2, no float
//     atomics: two calls give equal bits.
//   * batchnorm_apply_kernel: y from x (and sc) with each thread's
//     channel constants in registers.
//   * batchnorm_grad_stats_kernel: per-channel fp32 sums of g and g*xhat,
//     merged the same way (plain sums in a fixed order); the last block of
//     a tile writes sum/M for the apply and dscale, dbias in the params'
//     type.
//   * batchnorm_grad_kernel: dx (and d_sc) from dy, x (and out).
#include "common.cuh"

namespace {

using namespace repro;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                  // channels of a block's tile
constexpr int kSplit = kThreads / kTile;   // threads a channel in the merge
constexpr int kAhead = 8;                  // partials a merging thread loads
                                           // before it merges them

// epilogues (kernels/batchnorm.py ACTS)
constexpr int kNone = 0;
constexpr int kRelu = 1;
constexpr int kAddRelu = 2;

template <typename T>
struct Tiling {
  static constexpr int kV = Vec<T>::kN;              // channels a thread
  static constexpr int kLanes = kTile / kV;          // threads across a tile
  static constexpr int kRows = kThreads / kLanes;    // rows a block pass
  static_assert(kLanes <= 32 && 32 % kLanes == 0, "a warp holds whole rows");
};

// Where a thread sits: its channel vector, its first channel, its row group
// and the rows [r0, r1) of its block's chunk.
template <typename T>
struct Pos {
  int lc, c0, rg, r0, r1;
  bool active;
  __device__ __forceinline__ Pos(int M, int C, int rpc) {
    lc = threadIdx.x % Tiling<T>::kLanes;
    rg = threadIdx.x / Tiling<T>::kLanes;
    c0 = blockIdx.y * kTile + lc * Tiling<T>::kV;
    active = c0 < C;
    r0 = blockIdx.x * rpc;
    r1 = min(r0 + rpc, M);
  }
};

template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

template <typename T>
__device__ __forceinline__ void store16(T* p, const float* f) {
  *reinterpret_cast<uint4*>(p) = Vec<T>::pack(f);
}

// x rounded to T and back
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// ReLU that keeps a NaN, as torch.relu does
__device__ __forceinline__ float relu(float v) {
  return v > 0.f || v != v ? v : 0.f;
}

__device__ __forceinline__ float xhat_of(float x, float mean, float rstd) {
  return __fmul_rn(__fsub_rn(x, mean), rstd);
}

// y before rounding: one fma of xhat, scale and bias
__device__ __forceinline__ float affine(float xh, float w, float b) {
  return __fmaf_rn(xh, w, b);
}

// The gradient that reaches the normalisation: dy where the epilogue's
// ReLU passed its input (``o`` the block's output, for add_relu).
template <typename T, int kAct>
__device__ __forceinline__ float masked(float dy, float xh, float w, float b,
                                        float o) {
  if constexpr (kAct == kRelu) return round_to<T>(affine(xh, w, b)) > 0.f
                                          ? dy : 0.f;
  if constexpr (kAct == kAddRelu) return o > 0.f ? dy : 0.f;
  return dy;
}

// Chan's merge of (nb, mb, qb) into (n, mean, m2) over kN channels.
template <int kN>
__device__ __forceinline__ void chan_merge(int& n, float* mean, float* m2,
                                           int nb, const float* mb,
                                           const float* qb) {
  if (nb == 0) return;
  if (n == 0) {
    n = nb;
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      mean[e] = mb[e];
      m2[e] = qb[e];
    }
    return;
  }
  const int nt = n + nb;
  const float wb = (float)nb / (float)nt;
  const float wab = (float)n * wb;          // n nb / (n + nb)
#pragma unroll
  for (int e = 0; e < kN; ++e) {
    const float d = mb[e] - mean[e];
    mean[e] = fmaf(d, wb, mean[e]);
    m2[e] = m2[e] + qb[e] + d * d * wab;
  }
  n = nt;
}

// The block's last-to-finish test for its channel tile: every thread has
// written its share of the partials; thread 0 takes a ticket.
__device__ __forceinline__ bool last_of_tile(int* tickets) {
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(tickets + blockIdx.y, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (is_last) __threadfence();
  return is_last;
}

// Rows of chunk k
__device__ __forceinline__ int chunk_rows(int k, int M, int rpc) {
  return min(rpc, M - k * rpc);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) batchnorm_stats_kernel(
    const T* __restrict__ x,      // (M, C)
    float* __restrict__ part,     // (2, chunks, C): means, then M2s
    int* __restrict__ tickets,    // (tiles,), zeros
    float* __restrict__ stats,    // (2, C): mean, rstd
    int M, int C, int rpc, float eps) {
  using L = Tiling<T>;
  constexpr int kV = L::kV, kU = 8;
  __shared__ int s_n[kWarps][kTile];
  __shared__ float s_mean[kWarps][kTile];
  __shared__ float s_m2[kWarps][kTile];
  const Pos<T> at(M, C, rpc);
  int n = 0;
  float mean[kV], m2[kV];
#pragma unroll
  for (int e = 0; e < kV; ++e) mean[e] = m2[e] = 0.f;
  if (at.active) {
    for (int r = at.r0 + at.rg; r < at.r1; r += L::kRows * kU) {
      uint4 v[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int rr = r + u * L::kRows;
        v[u] = rr < at.r1 ? load16(x + (size_t)rr * C + at.c0)
                          : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (r + u * L::kRows >= at.r1) break;
        float f[kV];
        Vec<T>::unpack(v[u], f);
        ++n;
        const float inv = 1.f / (float)n;
#pragma unroll
        for (int e = 0; e < kV; ++e) {
          const float d = f[e] - mean[e];
          mean[e] = fmaf(d, inv, mean[e]);
          m2[e] = fmaf(d, f[e] - mean[e], m2[e]);
        }
      }
    }
  }

  // the warp's rows, then the warps in order
#pragma unroll
  for (int o = L::kLanes; o < 32; o <<= 1) {
    float mb[kV], qb[kV];
    const int nb = __shfl_xor_sync(0xffffffffu, n, o);
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      mb[e] = __shfl_xor_sync(0xffffffffu, mean[e], o);
      qb[e] = __shfl_xor_sync(0xffffffffu, m2[e], o);
    }
    chan_merge<kV>(n, mean, m2, nb, mb, qb);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane < L::kLanes) {
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      s_n[warp][lane * kV + e] = n;
      s_mean[warp][lane * kV + e] = mean[e];
      s_m2[warp][lane * kV + e] = m2[e];
    }
  }
  __syncthreads();
  const int K = gridDim.x;
  if (threadIdx.x < kTile) {
    const int t = threadIdx.x, c = blockIdx.y * kTile + t;
    int bn = s_n[0][t];
    float bm = s_mean[0][t], bq = s_m2[0][t];
    for (int w = 1; w < kWarps; ++w)
      chan_merge<1>(bn, &bm, &bq, s_n[w][t], &s_mean[w][t], &s_m2[w][t]);
    if (c < C) {
      part[(size_t)blockIdx.x * C + c] = bm;
      part[((size_t)K + blockIdx.x) * C + c] = bq;
    }
  }
  if (!last_of_tile(tickets)) return;

  // the tile's partials: kSplit threads a channel, each over every
  // kSplit-th chunk in order, then the kSplit in a fixed order
  const int ch = threadIdx.x / kSplit, j = threadIdx.x % kSplit;
  const int c = blockIdx.y * kTile + ch;
  int tn = 0;
  float tm = 0.f, tq = 0.f;
  if (c < C) {
    for (int k0 = j; k0 < K; k0 += kSplit * kAhead) {
      float mk[kAhead], qk[kAhead];     // loads in flight, then merged
      int nk[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int k = k0 + u * kSplit;
        nk[u] = k < K ? chunk_rows(k, M, rpc) : 0;
        mk[u] = k < K ? __ldcg(part + (size_t)k * C + c) : 0.f;
        qk[u] = k < K ? __ldcg(part + ((size_t)K + k) * C + c) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u)
        chan_merge<1>(tn, &tm, &tq, nk[u], &mk[u], &qk[u]);
    }
  }
#pragma unroll
  for (int o = 1; o < kSplit; o <<= 1) {
    const int nb = __shfl_xor_sync(0xffffffffu, tn, o);
    const float mb = __shfl_xor_sync(0xffffffffu, tm, o);
    const float qb = __shfl_xor_sync(0xffffffffu, tq, o);
    chan_merge<1>(tn, &tm, &tq, nb, &mb, &qb);
  }
  if (j == 0 && c < C) {
    const float var = fmaxf(tq / (float)M, 0.f);
    stats[c] = tm;
    stats[C + c] = 1.f / sqrtf(var + eps);
  }
  if (threadIdx.x == 0) tickets[blockIdx.y] = 0;
}

template <typename T, typename S, int kAct>
__global__ void __launch_bounds__(kThreads) batchnorm_apply_kernel(
    const T* __restrict__ x,        // (M, C)
    const T* __restrict__ sc,       // (M, C), add_relu only
    const S* __restrict__ scale,    // (C,)
    const S* __restrict__ bias,     // (C,)
    const float* __restrict__ stats,
    T* __restrict__ y,              // (M, C)
    int M, int C, int rpc) {
  using L = Tiling<T>;
  constexpr int kV = L::kV, kU = 4;
  const Pos<T> at(M, C, rpc);
  if (!at.active) return;
  float mu[kV], rs[kV], w[kV], b[kV];
#pragma unroll
  for (int e = 0; e < kV; ++e) {
    mu[e] = stats[at.c0 + e];
    rs[e] = stats[C + at.c0 + e];
    w[e] = to_f32(scale[at.c0 + e]);
    b[e] = to_f32(bias[at.c0 + e]);
  }
  for (int r = at.r0 + at.rg; r < at.r1; r += L::kRows * kU) {
    uint4 v[kU], s[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int rr = r + u * L::kRows;
      const size_t off = (size_t)rr * C + at.c0;
      v[u] = rr < at.r1 ? load16(x + off) : make_uint4(0u, 0u, 0u, 0u);
      if constexpr (kAct == kAddRelu)
        s[u] = rr < at.r1 ? load16(sc + off) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int rr = r + u * L::kRows;
      if (rr >= at.r1) break;
      float f[kV], g[kV];
      Vec<T>::unpack(v[u], f);
      if constexpr (kAct == kAddRelu) Vec<T>::unpack(s[u], g);
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        const float t = affine(xhat_of(f[e], mu[e], rs[e]), w[e], b[e]);
        if constexpr (kAct == kNone) f[e] = t;
        if constexpr (kAct == kRelu) f[e] = relu(t);
        if constexpr (kAct == kAddRelu) f[e] = relu(round_to<T>(t) + g[e]);
      }
      store16(y + (size_t)rr * C + at.c0, f);
    }
  }
}

template <typename T, typename S, int kAct>
__global__ void __launch_bounds__(kThreads) batchnorm_grad_stats_kernel(
    const T* __restrict__ dy,       // (M, C)
    const T* __restrict__ x,        // (M, C)
    const T* __restrict__ out,      // (M, C), add_relu only
    const S* __restrict__ scale,
    const S* __restrict__ bias,
    const float* __restrict__ stats,
    float* __restrict__ part,       // (2, chunks, C): sum g, sum g xhat
    int* __restrict__ tickets,      // (tiles,), zeros
    float* __restrict__ coef,       // (2, C): sum g / M, sum g xhat / M
    S* __restrict__ dparams,        // (2, C): dscale, dbias
    int M, int C, int rpc) {
  using L = Tiling<T>;
  constexpr int kV = L::kV, kU = 4;
  __shared__ float s_g[kWarps][kTile];
  __shared__ float s_gx[kWarps][kTile];
  const Pos<T> at(M, C, rpc);
  float sg[kV], sgx[kV];
#pragma unroll
  for (int e = 0; e < kV; ++e) sg[e] = sgx[e] = 0.f;
  if (at.active) {
    float mu[kV], rs[kV], w[kV], b[kV];
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      mu[e] = stats[at.c0 + e];
      rs[e] = stats[C + at.c0 + e];
      w[e] = kAct == kRelu ? to_f32(scale[at.c0 + e]) : 0.f;
      b[e] = kAct == kRelu ? to_f32(bias[at.c0 + e]) : 0.f;
    }
    for (int r = at.r0 + at.rg; r < at.r1; r += L::kRows * kU) {
      uint4 dv[kU], xv[kU], ov[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int rr = r + u * L::kRows;
        const size_t off = (size_t)rr * C + at.c0;
        const bool in = rr < at.r1;
        dv[u] = in ? load16(dy + off) : make_uint4(0u, 0u, 0u, 0u);
        xv[u] = in ? load16(x + off) : make_uint4(0u, 0u, 0u, 0u);
        if constexpr (kAct == kAddRelu)
          ov[u] = in ? load16(out + off) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (r + u * L::kRows >= at.r1) break;
        float d[kV], f[kV], o[kV];
        Vec<T>::unpack(dv[u], d);
        Vec<T>::unpack(xv[u], f);
        if constexpr (kAct == kAddRelu) Vec<T>::unpack(ov[u], o);
#pragma unroll
        for (int e = 0; e < kV; ++e) {
          const float xh = xhat_of(f[e], mu[e], rs[e]);
          const float g = masked<T, kAct>(d[e], xh, w[e], b[e],
                                          kAct == kAddRelu ? o[e] : 0.f);
          sg[e] += g;
          sgx[e] = fmaf(g, xh, sgx[e]);
        }
      }
    }
  }

#pragma unroll
  for (int o = L::kLanes; o < 32; o <<= 1) {
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      sg[e] += __shfl_xor_sync(0xffffffffu, sg[e], o);
      sgx[e] += __shfl_xor_sync(0xffffffffu, sgx[e], o);
    }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane < L::kLanes) {
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      s_g[warp][lane * kV + e] = sg[e];
      s_gx[warp][lane * kV + e] = sgx[e];
    }
  }
  __syncthreads();
  const int K = gridDim.x;
  if (threadIdx.x < kTile) {
    const int t = threadIdx.x, c = blockIdx.y * kTile + t;
    float bg = 0.f, bgx = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      bg += s_g[w][t];
      bgx += s_gx[w][t];
    }
    if (c < C) {
      part[(size_t)blockIdx.x * C + c] = bg;
      part[((size_t)K + blockIdx.x) * C + c] = bgx;
    }
  }
  if (!last_of_tile(tickets)) return;

  const int ch = threadIdx.x / kSplit, j = threadIdx.x % kSplit;
  const int c = blockIdx.y * kTile + ch;
  float tg = 0.f, tgx = 0.f;
  if (c < C) {
    for (int k0 = j; k0 < K; k0 += kSplit * kAhead) {
      float gk[kAhead], gxk[kAhead];    // loads in flight, then summed
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int k = k0 + u * kSplit;
        gk[u] = k < K ? __ldcg(part + (size_t)k * C + c) : 0.f;
        gxk[u] = k < K ? __ldcg(part + ((size_t)K + k) * C + c) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        tg += gk[u];
        tgx += gxk[u];
      }
    }
  }
#pragma unroll
  for (int o = 1; o < kSplit; o <<= 1) {
    tg += __shfl_xor_sync(0xffffffffu, tg, o);
    tgx += __shfl_xor_sync(0xffffffffu, tgx, o);
  }
  if (j == 0 && c < C) {
    coef[c] = tg / (float)M;
    coef[C + c] = tgx / (float)M;
    dparams[c] = from_f32<S>(tgx);
    dparams[C + c] = from_f32<S>(tg);
  }
  if (threadIdx.x == 0) tickets[blockIdx.y] = 0;
}

template <typename T, typename S, int kAct>
__global__ void __launch_bounds__(kThreads) batchnorm_grad_kernel(
    const T* __restrict__ dy,
    const T* __restrict__ x,
    const T* __restrict__ out,      // add_relu only
    const S* __restrict__ scale,
    const S* __restrict__ bias,
    const float* __restrict__ stats,
    const float* __restrict__ coef,
    T* __restrict__ dx,
    T* __restrict__ dsc,            // add_relu only
    int M, int C, int rpc) {
  using L = Tiling<T>;
  constexpr int kV = L::kV, kU = 2;
  const Pos<T> at(M, C, rpc);
  if (!at.active) return;
  float mu[kV], rs[kV], a[kV], w[kV], b[kV], mg[kV], mgx[kV];
#pragma unroll
  for (int e = 0; e < kV; ++e) {
    const int c = at.c0 + e;
    mu[e] = stats[c];
    rs[e] = stats[C + c];
    w[e] = to_f32(scale[c]);
    b[e] = kAct == kRelu ? to_f32(bias[c]) : 0.f;
    a[e] = rs[e] * w[e];
    mg[e] = coef[c];
    mgx[e] = coef[C + c];
  }
  for (int r = at.r0 + at.rg; r < at.r1; r += L::kRows * kU) {
    uint4 dv[kU], xv[kU], ov[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int rr = r + u * L::kRows;
      const size_t off = (size_t)rr * C + at.c0;
      const bool in = rr < at.r1;
      dv[u] = in ? load16(dy + off) : make_uint4(0u, 0u, 0u, 0u);
      xv[u] = in ? load16(x + off) : make_uint4(0u, 0u, 0u, 0u);
      if constexpr (kAct == kAddRelu)
        ov[u] = in ? load16(out + off) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int rr = r + u * L::kRows;
      if (rr >= at.r1) break;
      const size_t off = (size_t)rr * C + at.c0;
      float d[kV], f[kV], o[kV], g[kV];
      Vec<T>::unpack(dv[u], d);
      Vec<T>::unpack(xv[u], f);
      if constexpr (kAct == kAddRelu) Vec<T>::unpack(ov[u], o);
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        const float xh = xhat_of(f[e], mu[e], rs[e]);
        g[e] = masked<T, kAct>(d[e], xh, w[e], b[e],
                               kAct == kAddRelu ? o[e] : 0.f);
        f[e] = a[e] * ((g[e] - mg[e]) - xh * mgx[e]);
      }
      store16(dx + off, f);
      if constexpr (kAct == kAddRelu) store16(dsc + off, g);
    }
  }
}

// The plans: (chunks, rows a chunk) of the reduction kernel (``red``) and
// of the elementwise one (``ew``); each grid is (chunks, channel tiles).
struct Plans {
  int red_chunks, red_rpc, ew_chunks, ew_rpc;
};

inline dim3 grid_of(int chunks, int C) {
  return dim3(chunks, (C + kTile - 1) / kTile);
}

template <typename T, typename S, int kAct>
int forward_act(const void* x, const void* sc, const void* scale,
                const void* bias, void* y, float* stats, float* part,
                int* tickets, int M, int C, Plans p, float eps,
                cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  batchnorm_stats_kernel<T>
      <<<grid_of(p.red_chunks, C), kThreads, 0, stream>>>(
          xp, part, tickets, stats, M, C, p.red_rpc, eps);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  batchnorm_apply_kernel<T, S, kAct>
      <<<grid_of(p.ew_chunks, C), kThreads, 0, stream>>>(
          xp, static_cast<const T*>(sc), static_cast<const S*>(scale),
          static_cast<const S*>(bias), stats, static_cast<T*>(y), M, C,
          p.ew_rpc);
  return (int)cudaGetLastError();
}

template <typename T, typename S, int kAct>
int backward_act(const void* dy, const void* x, const void* out,
                 const void* scale, const void* bias, const float* stats,
                 void* dx, void* dsc, void* dparams, float* coef,
                 float* part, int* tickets, int M, int C, Plans p,
                 cudaStream_t stream) {
  const T* dyp = static_cast<const T*>(dy);
  const T* xp = static_cast<const T*>(x);
  const T* op = static_cast<const T*>(out);
  const S* sp = static_cast<const S*>(scale);
  const S* bp = static_cast<const S*>(bias);
  batchnorm_grad_stats_kernel<T, S, kAct>
      <<<grid_of(p.red_chunks, C), kThreads, 0, stream>>>(
          dyp, xp, op, sp, bp, stats, part, tickets, coef,
          static_cast<S*>(dparams), M, C, p.red_rpc);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  batchnorm_grad_kernel<T, S, kAct>
      <<<grid_of(p.ew_chunks, C), kThreads, 0, stream>>>(
          dyp, xp, op, sp, bp, stats, coef, static_cast<T*>(dx),
          static_cast<T*>(dsc), M, C, p.ew_rpc);
  return (int)cudaGetLastError();
}

// Chunks that cover the M rows with none empty
inline bool covers(int M, int chunks, int rpc) {
  return chunks > 0 && rpc > 0 && (long long)chunks * rpc >= M &&
         (long long)(chunks - 1) * rpc < M;
}

// Plans the kernels can run: C whole 16-byte vectors, the tiles within
// the grid's y dimension, both plans covering the rows.
template <typename T>
bool valid(int M, int C, const Plans& p) {
  return M > 0 && C > 0 && C % Tiling<T>::kV == 0 &&
         (C + kTile - 1) / kTile <= 65535 &&
         covers(M, p.red_chunks, p.red_rpc) && covers(M, p.ew_chunks, p.ew_rpc);
}

// Resident blocks an SM of each kernel: statistics, apply, gradient sums,
// dx.
template <typename T, typename S, int kAct>
int occupancy_act(int* out) {
  int e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, batchnorm_stats_kernel<T>, kThreads, 0);
  if (!e) e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out + 1, batchnorm_apply_kernel<T, S, kAct>, kThreads, 0);
  if (!e) e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out + 2, batchnorm_grad_stats_kernel<T, S, kAct>, kThreads, 0);
  if (!e) e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out + 3, batchnorm_grad_kernel<T, S, kAct>, kThreads, 0);
  return e;
}

template <typename T, typename S>
int occupancy_ts(int act, int* out) {
  if (act == kNone) return occupancy_act<T, S, kNone>(out);
  if (act == kRelu) return occupancy_act<T, S, kRelu>(out);
  if (act == kAddRelu) return occupancy_act<T, S, kAddRelu>(out);
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename S>
int forward_ts(const void* x, const void* sc, const void* scale,
               const void* bias, void* y, float* stats, float* part,
               int* tickets, int M, int C, Plans p, float eps, int act,
               cudaStream_t s) {
  if (!valid<T>(M, C, p)) return (int)cudaErrorInvalidValue;
  if (act == kNone)
    return forward_act<T, S, kNone>(x, sc, scale, bias, y, stats, part,
                                    tickets, M, C, p, eps, s);
  if (act == kRelu)
    return forward_act<T, S, kRelu>(x, sc, scale, bias, y, stats, part,
                                    tickets, M, C, p, eps, s);
  if (act == kAddRelu)
    return forward_act<T, S, kAddRelu>(x, sc, scale, bias, y, stats, part,
                                       tickets, M, C, p, eps, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename S>
int backward_ts(const void* dy, const void* x, const void* out,
                const void* scale, const void* bias, const float* stats,
                void* dx, void* dsc, void* dparams, float* coef, float* part,
                int* tickets, int M, int C, Plans p, int act,
                cudaStream_t s) {
  if (!valid<T>(M, C, p)) return (int)cudaErrorInvalidValue;
  if (act == kNone)
    return backward_act<T, S, kNone>(dy, x, out, scale, bias, stats, dx, dsc,
                                     dparams, coef, part, tickets, M, C, p,
                                     s);
  if (act == kRelu)
    return backward_act<T, S, kRelu>(dy, x, out, scale, bias, stats, dx, dsc,
                                     dparams, coef, part, tickets, M, C, p,
                                     s);
  if (act == kAddRelu)
    return backward_act<T, S, kAddRelu>(dy, x, out, scale, bias, stats, dx,
                                        dsc, dparams, coef, part, tickets, M,
                                        C, p, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// out[0..3]: resident blocks an SM of the statistics, apply, gradient-sum
// and dx kernels of this epilogue and these types, for the wrapper's plans.
extern "C" int repro_batchnorm_occupancy(int act, int dtype, int param_dtype,
                                         void* out) {
  int* o = static_cast<int*>(out);
  if (dtype == repro::kFloat32 && param_dtype == repro::kFloat32)
    return occupancy_ts<float, float>(act, o);
  if (dtype == repro::kFloat32 && param_dtype == repro::kBFloat16)
    return occupancy_ts<float, __nv_bfloat16>(act, o);
  if (dtype == repro::kBFloat16 && param_dtype == repro::kFloat32)
    return occupancy_ts<__nv_bfloat16, float>(act, o);
  if (dtype == repro::kBFloat16 && param_dtype == repro::kBFloat16)
    return occupancy_ts<__nv_bfloat16, __nv_bfloat16>(act, o);
  return (int)cudaErrorInvalidValue;
}

// Forward: stats (2, C) fp32 gets mean and rstd, y the normalised x with
// the epilogue ``act`` (0 none, 1 relu, 2 add_relu with the shortcut sc).
// The statistics run on red_chunks chunks of red_rpc rows, the apply on
// ew_chunks of ew_rpc; part holds 2 x red_chunks x C floats of scratch,
// tickets one int a channel tile, zero on entry and on return.
extern "C" int repro_batchnorm_forward(
    const void* x, const void* sc, const void* scale, const void* bias,
    void* y, void* stats, void* part, void* tickets, int M, int C,
    int red_chunks, int red_rpc, int ew_chunks, int ew_rpc, float eps,
    int act, int dtype, int param_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  float* pt = static_cast<float*>(part);
  int* tk = static_cast<int*>(tickets);
  const Plans p{red_chunks, red_rpc, ew_chunks, ew_rpc};
#define REPRO_BN_FORWARD(T, S)                                              \
  return forward_ts<T, S>(x, sc, scale, bias, y, st, pt, tk, M, C, p, eps,  \
                          act, s)
  if (dtype == repro::kFloat32 && param_dtype == repro::kFloat32)
    REPRO_BN_FORWARD(float, float);
  if (dtype == repro::kFloat32 && param_dtype == repro::kBFloat16)
    REPRO_BN_FORWARD(float, __nv_bfloat16);
  if (dtype == repro::kBFloat16 && param_dtype == repro::kFloat32)
    REPRO_BN_FORWARD(__nv_bfloat16, float);
  if (dtype == repro::kBFloat16 && param_dtype == repro::kBFloat16)
    REPRO_BN_FORWARD(__nv_bfloat16, __nv_bfloat16);
#undef REPRO_BN_FORWARD
  return (int)cudaErrorInvalidValue;
}

// Backward: dx (and dsc, for add_relu) from dy, x, the forward's stats
// (and its output ``out``, for add_relu); dparams (2, C) in the params'
// type gets dscale and dbias, coef (2, C) fp32 is scratch, part and
// tickets as in the forward.
extern "C" int repro_batchnorm_backward(
    const void* dy, const void* x, const void* out, const void* scale,
    const void* bias, const void* stats, void* dx, void* dsc, void* dparams,
    void* coef, void* part, void* tickets, int M, int C, int red_chunks,
    int red_rpc, int ew_chunks, int ew_rpc, int act, int dtype,
    int param_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* st = static_cast<const float*>(stats);
  float* cf = static_cast<float*>(coef);
  float* pt = static_cast<float*>(part);
  int* tk = static_cast<int*>(tickets);
  const Plans p{red_chunks, red_rpc, ew_chunks, ew_rpc};
#define REPRO_BN_BACKWARD(T, S)                                             \
  return backward_ts<T, S>(dy, x, out, scale, bias, st, dx, dsc, dparams,   \
                           cf, pt, tk, M, C, p, act, s)
  if (dtype == repro::kFloat32 && param_dtype == repro::kFloat32)
    REPRO_BN_BACKWARD(float, float);
  if (dtype == repro::kFloat32 && param_dtype == repro::kBFloat16)
    REPRO_BN_BACKWARD(float, __nv_bfloat16);
  if (dtype == repro::kBFloat16 && param_dtype == repro::kFloat32)
    REPRO_BN_BACKWARD(__nv_bfloat16, float);
  if (dtype == repro::kBFloat16 && param_dtype == repro::kBFloat16)
    REPRO_BN_BACKWARD(__nv_bfloat16, __nv_bfloat16);
#undef REPRO_BN_BACKWARD
  return (int)cudaErrorInvalidValue;
}
