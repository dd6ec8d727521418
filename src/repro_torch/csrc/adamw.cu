// Multi-tensor AdamW for Hopper (sm_90a): one pass over every leaf of a
// train state, fp32 gradients, master weights and moments, params fp32
// or bf16, clipped by the gradients' global L2 norm.
//
// Replaces no TPU kernel: the reference's AdamW
// (src/repro/train/optimizer.py::adamw_update) is plain array code that
// XLA fuses, and it has no Pallas kernel. What it replaces is the
// port's plain per-leaf loop (train/optimizer.py::adamw_leaves_ref,
// still the CPU path): on the card that loop launched about 21 small
// kernels a leaf (3 for the norm, 18 for the update), 3,381 for
// ResNet50's 161 leaves, and the host's launches, not the card, set its
// time. The arithmetic is that loop's, op for op, each op rounded once
// in fp32 (the _rn intrinsics, so that nothing is contracted into an
// FMA), divisions kept as divisions:
//   g = g * scale; m = b1*m + (1-b1)*g; v = b2*v + (1-b2)*g*g
//   d = (m/bc1) / (sqrt(v/bc2) + eps) [+ wd*master where ndim >= 1]
//   master = master - lr*d; p = master (rounded to p's type)
// with scale = min(clip * (1 / max(gnorm, 1e-12)), 1) (torch's scalar /
// tensor is a reciprocal times the scalar), NaN passed through as
// torch.clamp passes it. Only the norm's summation order differs.
//
// Bound on the H100: bytes. The norm reads every gradient once, the
// update reads it again with m, v and master and writes m, v, master and
// p: 34 B a parameter with fp32 gradients and bf16 params, ~0.26 ms for
// ResNet50's 25,557,032 parameters and ~7.7 ms for gpt-800m's
// 757,386,240 at 3.35 TB/s. Its few operations per element (two
// divisions and a square root) are far below the card's rate.
//
// Design, three launches on the caller's stream, no host synchronise:
//   * Work items: each leaf is cut into chunks of kChunk elements (its
//     last chunk the rest), one thread block a chunk, so a 64-element
//     BatchNorm scale takes one block and a 2.4M-element convolution 144.
//     The table is passed by value in the launch parameters
//     (__grid_constant__, up to 32 KB on Hopper with CUDA 12.1+): per
//     leaf its pointers, element count (64-bit, a layer-stacked leaf may
//     pass 2^31), flags and the number of its first item; a block finds
//     its leaf by a binary search over the first items. The wrapper
//     (kernels/adamw.py) plans the items from the shapes alone and
//     splits a tree of more leaves than one table holds into several
//     launches of each pass.
//   * adamw_norm_kernel: each block sums its chunk's squares in fp64
//     (divided by the leaf's replica count under ZeRO-2) and writes one
//     partial; no float atomics.
//   * adamw_finalize_kernel: one block sums the partials in a fixed
//     order (fp64) and writes gnorm and the clip's scale, so two
//     identical calls give identical bits.
//   * adamw_update_kernel: each block reads the scale, lr and the bias
//     corrections from device memory and updates its chunk, each element
//     read once and written once: 16-byte loads and stores (8 bytes for
//     bf16) where every pointer of the leaf is 16-byte aligned, scalar
//     accesses otherwise.
#include <string.h>

#include "common.cuh"

namespace {

using namespace repro;

constexpr int kThreads = 256;
constexpr long long kChunk = 16384;      // elements of one work item
constexpr int kFinalizeThreads = 1024;
constexpr int kMaxNormLeaves = 1000;
constexpr int kMaxUpdateLeaves = 560;

// leaf flags (kernels/adamw.py)
constexpr int kParamBf16 = 1;
constexpr int kDecay = 2;
constexpr int kVector = 4;

struct NormLeaf {
  const float* g;
  long long numel;
  int first;          // this leaf's first item in the launch
  int flags;
  double div;         // replicas of the leaf's elements (1 without ZeRO-2)
};

struct UpdateLeaf {
  const float* g;
  float* m;
  float* v;
  float* master;
  void* p;
  long long numel;
  int first;
  int flags;
};

struct NormArgs {
  double* partials;   // one per item of this launch
  int n_leaves;
  int pad;
  NormLeaf leaf[kMaxNormLeaves];
};

struct UpdateArgs {
  const float* stats;  // gnorm, scale (adamw_finalize_kernel)
  const float* lr;
  const float* bc1;
  const float* bc2;
  float b1, b2, c1, c2, eps, wd;   // c1 = 1 - b1, c2 = 1 - b2
  int n_leaves;
  int pad;
  UpdateLeaf leaf[kMaxUpdateLeaves];
};

static_assert(sizeof(NormLeaf) == 32, "kernels/adamw.py NORM_LEAF");
static_assert(sizeof(UpdateLeaf) == 56, "kernels/adamw.py UPDATE_LEAF");
static_assert(sizeof(NormArgs) <= 32764, "kernel parameters over 32 KB");
static_assert(sizeof(UpdateArgs) <= 32764, "kernel parameters over 32 KB");

// The last leaf whose first item is <= item (leaves with no element are
// left out of the table by the wrapper, so first items increase).
template <typename Leaf>
__device__ __forceinline__ int find_leaf(const Leaf* leaf, int n, int item) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (leaf[mid].first <= item) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ double warp_sum_d(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The block's sum in a fixed order; valid in thread 0.
template <int kN>
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double part[kN / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = warp_sum_d(v);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  v = 0.0;
  if (warp == 0) {
    for (int i = lane; i < kN / 32; i += 32) v += part[i];
    v = warp_sum_d(v);
  }
  return v;
}

// four consecutive fp32 elements stored as T (8 or 16 aligned bytes)
template <typename T> struct Quad;
template <> struct Quad<float> {
  __device__ __forceinline__ static void store(float* p, const float4& f) {
    *reinterpret_cast<float4*>(p) = f;
  }
};
template <> struct Quad<__nv_bfloat16> {
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float4& f) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(f.x, f.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(f.z, f.w);
    *reinterpret_cast<uint2*>(p) =
        make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                   *reinterpret_cast<const unsigned*>(&hi));
  }
};

__device__ __forceinline__ double sq(float x) {
  const double d = (double)x;
  return d * d;
}

__device__ __forceinline__ double chunk_squares(const float* __restrict__ g,
                                                int n, bool vector) {
  double ss = 0.0;
  int i0 = 0;
  if (vector) {
    const int n4 = n & ~3;
#pragma unroll 4
    for (int i = threadIdx.x * 4; i < n4; i += kThreads * 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(g + i));
      ss += sq(f.x) + sq(f.y) + sq(f.z) + sq(f.w);
    }
    i0 = n4;
  }
  for (int i = i0 + threadIdx.x; i < n; i += kThreads) ss += sq(g[i]);
  return ss;
}

__global__ void __launch_bounds__(kThreads) adamw_norm_kernel(
    const __grid_constant__ NormArgs a) {
  const int item = blockIdx.x;
  const NormLeaf& leaf = a.leaf[find_leaf(a.leaf, a.n_leaves, item)];
  const long long off = (long long)(item - leaf.first) * kChunk;
  const int n = (int)min(kChunk, leaf.numel - off);
  double ss = chunk_squares(leaf.g + off, n, leaf.flags & kVector);
  ss = block_sum<kThreads>(ss);
  if (threadIdx.x == 0) a.partials[item] = ss / leaf.div;
}

// torch.clamp's NaN rule: a NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return isnan(x) ? x : fminf(x, hi);
}

__global__ void __launch_bounds__(kFinalizeThreads) adamw_finalize_kernel(
    const double* __restrict__ partials, int n, float clip,
    float* __restrict__ stats) {
  double s = 0.0;
  for (int i = threadIdx.x; i < n; i += kFinalizeThreads) s += partials[i];
  s = block_sum<kFinalizeThreads>(s);
  if (threadIdx.x == 0) {
    const float gnorm = __fsqrt_rn((float)s);
    stats[0] = gnorm;
    stats[1] = clamp_max(
        __fmul_rn(__frcp_rn(clamp_min(gnorm, 1e-12f)), clip), 1.0f);
  }
}

struct Hyper {
  float scale, lr, bc1, bc2, b1, b2, c1, c2, eps, wd;
};

__device__ __forceinline__ void adamw_element(float g, float& m, float& v,
                                              float& w, const Hyper& h,
                                              bool decay) {
  g = __fmul_rn(g, h.scale);
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(h.c1, g));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(h.c2, __fmul_rn(g, g)));
  float d = __fdiv_rn(__fdiv_rn(m, h.bc1),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.bc2)), h.eps));
  if (decay) d = __fadd_rn(d, __fmul_rn(h.wd, w));
  w = __fsub_rn(w, __fmul_rn(h.lr, d));
}

template <typename P>
__device__ __forceinline__ void update_chunk(
    const float* __restrict__ g, float* __restrict__ m, float* __restrict__ v,
    float* __restrict__ w, P* __restrict__ p, int n, bool vector,
    bool decay, const Hyper& h) {
  int i0 = 0;
  if (vector) {
    const int n4 = n & ~3;
#pragma unroll 2
    for (int i = threadIdx.x * 4; i < n4; i += kThreads * 4) {
      const float4 gf = __ldg(reinterpret_cast<const float4*>(g + i));
      float4 mf = *reinterpret_cast<const float4*>(m + i);
      float4 vf = *reinterpret_cast<const float4*>(v + i);
      float4 wf = *reinterpret_cast<const float4*>(w + i);
      adamw_element(gf.x, mf.x, vf.x, wf.x, h, decay);
      adamw_element(gf.y, mf.y, vf.y, wf.y, h, decay);
      adamw_element(gf.z, mf.z, vf.z, wf.z, h, decay);
      adamw_element(gf.w, mf.w, vf.w, wf.w, h, decay);
      *reinterpret_cast<float4*>(m + i) = mf;
      *reinterpret_cast<float4*>(v + i) = vf;
      *reinterpret_cast<float4*>(w + i) = wf;
      Quad<P>::store(p + i, wf);
    }
    i0 = n4;
  }
  for (int i = i0 + threadIdx.x; i < n; i += kThreads) {
    float mi = m[i], vi = v[i], wi = w[i];
    adamw_element(g[i], mi, vi, wi, h, decay);
    m[i] = mi;
    v[i] = vi;
    w[i] = wi;
    p[i] = from_f32<P>(wi);
  }
}

__global__ void __launch_bounds__(kThreads) adamw_update_kernel(
    const __grid_constant__ UpdateArgs a) {
  const int item = blockIdx.x;
  const UpdateLeaf& leaf = a.leaf[find_leaf(a.leaf, a.n_leaves, item)];
  const long long off = (long long)(item - leaf.first) * kChunk;
  const int n = (int)min(kChunk, leaf.numel - off);
  const Hyper h{a.stats[1], *a.lr, *a.bc1, *a.bc2, a.b1, a.b2, a.c1,
                a.c2, a.eps, a.wd};
  const float* g = leaf.g + off;
  const bool vector = leaf.flags & kVector, decay = leaf.flags & kDecay;
  if (leaf.flags & kParamBf16)
    update_chunk(g, leaf.m + off, leaf.v + off, leaf.master + off,
                 static_cast<__nv_bfloat16*>(leaf.p) + off, n, vector, decay,
                 h);
  else
    update_chunk(g, leaf.m + off, leaf.v + off, leaf.master + off,
                 static_cast<float*>(leaf.p) + off, n, vector, decay, h);
}

}  // namespace

// kChunk, the table sizes and the structs' sizes, which the wrapper
// checks against its own before the first launch.
extern "C" int repro_adamw_layout(long long* out) {
  out[0] = kChunk;
  out[1] = kMaxNormLeaves;
  out[2] = kMaxUpdateLeaves;
  out[3] = (long long)sizeof(NormLeaf);
  out[4] = (long long)sizeof(UpdateLeaf);
  return 0;
}

// One norm launch over ``n_leaves`` NormLeaf entries (host memory) and
// their ``n_items`` items: partials[item] = the item's squares / div.
extern "C" int repro_adamw_norm(const void* leaves, int n_leaves,
                                int n_items, void* partials, void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxNormLeaves || n_items < 1)
    return (int)cudaErrorInvalidValue;
  NormArgs a;
  a.partials = static_cast<double*>(partials);
  a.n_leaves = n_leaves;
  a.pad = 0;
  memcpy(a.leaf, leaves, n_leaves * sizeof(NormLeaf));
  adamw_norm_kernel<<<n_items, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// stats = (gnorm, scale) from the ``n`` partials' sum.
extern "C" int repro_adamw_finalize(const void* partials, int n, float clip,
                                    void* stats, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  adamw_finalize_kernel<<<1, kFinalizeThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(partials), n, clip,
      static_cast<float*>(stats));
  return (int)cudaGetLastError();
}

// One update launch over ``n_leaves`` UpdateLeaf entries (host memory)
// and their ``n_items`` items; lr, bc1 and bc2 are fp32 device scalars.
extern "C" int repro_adamw_update(const void* leaves, int n_leaves,
                                  int n_items, const void* stats,
                                  const void* lr, const void* bc1,
                                  const void* bc2, float b1, float b2,
                                  float c1, float c2, float eps, float wd,
                                  void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxUpdateLeaves || n_items < 1)
    return (int)cudaErrorInvalidValue;
  UpdateArgs a;
  a.stats = static_cast<const float*>(stats);
  a.lr = static_cast<const float*>(lr);
  a.bc1 = static_cast<const float*>(bc1);
  a.bc2 = static_cast<const float*>(bc2);
  a.b1 = b1;
  a.b2 = b2;
  a.c1 = c1;
  a.c2 = c2;
  a.eps = eps;
  a.wd = wd;
  a.n_leaves = n_leaves;
  a.pad = 0;
  memcpy(a.leaf, leaves, n_leaves * sizeof(UpdateLeaf));
  adamw_update_kernel<<<n_items, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
