// Paged decode attention for Hopper (sm_90a): one query token per
// sequence against its paged KV history.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py
// (paged_decode_attention, kernel _decode_kernel). Same function: for
// each sequence b and KV head, the G = H / Kh query heads of the group
// attend over the pool blocks named by tables[b, :], masked to
// kpos < lengths[b] (and kpos > lengths[b] - 1 - window when windowed),
// with an fp32 online softmax; the output is written in q's dtype.
//
// Design. The Pallas kernel walks the block table as a sequential grid
// axis with scalar-prefetched indices and carries (m, l, acc) in VMEM
// across grid steps. On Hopper blocks run in parallel and carry nothing,
// so one thread block owns one (b, kv_head) pair and loops over its own
// table entries j < ceil(len / bs) (from the window's first block when
// windowed) — blocks past the length are never read. The G query rows
// live in shared memory, pre-scaled; each (bs, Dh) K/V block is staged
// in shared memory as fp32 (K rows padded by one float so the score
// loop is free of bank conflicts); m, l and the accumulator stay in
// shared memory across the walk.
//
// int8 pools. The pool's element type is a template parameter apart from
// q's: with an int8 pool each block's (block, kv_head) scale is looked up
// through the same tables[b, j] entry that addresses the block (the trash
// block 0 has a scale row too: idle slots, whose rows are discarded, read
// it, and a live slot reaches block 0 only past its length, where every
// key is masked) and the codes dequantize as code * scale in fp32 while
// the tile is staged, so no fp copy of the pool exists anywhere. The
// walk's scales are gathered into shared memory by all threads at once
// before it starts, so no block iteration waits on a scale load. Whether
// scales are applied is a template parameter too, so a pool without
// scales compiles to a walk with no scale load and no multiply: choosing
// at run time (a branch and a multiply by 1.0f) made the fp walk 23 %
// slower on the H100, where each block iteration of this latency-bound
// loop takes a few microseconds. An int8 pool halves (bf16) or quarters
// (fp32) the bytes the walk reads.
//
// Bound on the H100: device-memory bytes. The kernel reads
// len x Kh x Dh x 2 (K and V) x sizeof(P) per sequence and layer and
// does 4 x G flops per byte-pair read — far below the ~295 flops/byte
// where Hopper's tensor cores, not HBM, would limit — so the products
// run on the CUDA cores in fp32 and the design only has to read each
// K/V byte once. Known weakness: B x Kh thread blocks (64 at B=8, Kh=8)
// cannot fill 132 SMs at small batch; splitting the KV axis across
// blocks with a second reduction pass is the fix, left for later.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int kThreads = 128;

template <typename T, typename P, bool kScaled>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q,          // (B, H, Dh)
    const P* __restrict__ k_pool,     // (n_blocks, bs, Kh, Dh)
    const P* __restrict__ v_pool,     // (n_blocks, bs, Kh, Dh)
    const float* __restrict__ k_scale,  // (n_blocks, Kh), or null
    const float* __restrict__ v_scale,  // (n_blocks, Kh), or null
    const int* __restrict__ tables,   // (B, >= nb), row stride table_stride
    const int* __restrict__ lengths,  // (B,)
    T* __restrict__ out,              // (B, H, Dh)
    int n_kv_heads, int group, int dh, int bs, int nb, int table_stride,
    int window, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int tid = threadIdx.x;
  const int gd = group * dh;
  const int k_stride = dh + 1;

  float* q_s = smem;                    // (G, Dh), pre-scaled
  float* acc_s = q_s + gd;              // (G, Dh)
  float* k_s = acc_s + gd;              // (bs, Dh + 1)
  float* v_s = k_s + bs * k_stride;     // (bs, Dh)
  float* p_s = v_s + bs * dh;           // (G, bs) scores -> probabilities
  float* m_s = p_s + group * bs;        // (G,)
  float* l_s = m_s + group;             // (G,)
  float* a_s = l_s + group;             // (G,)
  float* ks_s = a_s + group;            // (nb,) the walk's K scales
  float* vs_s = ks_s + nb;              // (nb,) and V scales, if kScaled

  const int n_heads = n_kv_heads * group;
  const size_t head0 = (size_t)b * n_heads + (size_t)kh * group;
  const T* q_b = q + head0 * dh;        // the group's G rows are contiguous
  for (int i = tid; i < gd; i += kThreads) {
    q_s[i] = to_f32(q_b[i]) * scale;
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < group; g += kThreads) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }

  const int length = lengths[b];
  int j_end = (length + bs - 1) / bs;
  if (j_end > nb) j_end = nb;
  int lo = -1;                          // visible keys: lo < kpos < length
  int j_begin = 0;
  if (window > 0) {
    lo = length - 1 - window;
    if (lo + 1 > 0) j_begin = (lo + 1) / bs;
  }
  const int* tab = tables + (size_t)b * table_stride;
  const size_t tok_stride = (size_t)n_kv_heads * dh;  // between a block's rows
  if constexpr (kScaled) {
    for (int j = j_begin + tid; j < j_end; j += kThreads) {
      const size_t blk = tab[j];
      ks_s[j] = k_scale[blk * n_kv_heads + kh];
      vs_s[j] = v_scale[blk * n_kv_heads + kh];
    }
  }
  __syncthreads();

  for (int j = j_begin; j < j_end; ++j) {
    const size_t blk = tab[j];
    const size_t base = (blk * bs * n_kv_heads + kh) * dh;
    const P* kb = k_pool + base;
    const P* vb = v_pool + base;
    for (int i = tid; i < bs * dh; i += kThreads) {
      const int t = i / dh, d = i - t * dh;
      float kv = to_f32(kb[t * tok_stride + d]);
      float vv = to_f32(vb[t * tok_stride + d]);
      if constexpr (kScaled) {
        kv *= ks_s[j];
        vv *= vs_s[j];
      }
      k_s[t * k_stride + d] = kv;
      v_s[t * dh + d] = vv;
    }
    __syncthreads();

    for (int i = tid; i < group * bs; i += kThreads) {
      const int g = i / bs, t = i - g * bs;
      const int kpos = j * bs + t;
      float s = -INFINITY;
      if (kpos < length && kpos > lo) {
        const float* qr = q_s + g * dh;
        const float* kr = k_s + t * k_stride;
        float dot = 0.f;
        for (int d = 0; d < dh; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot;
      }
      p_s[i] = s;
    }
    __syncthreads();

    online_softmax_rows(p_s, m_s, l_s, a_s, group, bs, kThreads);
    __syncthreads();

    for (int i = tid; i < gd; i += kThreads) {
      const int g = i / dh, d = i - g * dh;
      const float* pr = p_s + g * bs;
      float pv = 0.f;
      for (int t = 0; t < bs; ++t) pv = fmaf(pr[t], v_s[t * dh + d], pv);
      acc_s[i] = acc_s[i] * a_s[g] + pv;
    }
    __syncthreads();
  }

  T* o_b = out + head0 * dh;
  for (int i = tid; i < gd; i += kThreads) {
    const float l = l_s[i / dh];
    o_b[i] = from_f32<T>(l > 0.f ? acc_s[i] / l : 0.f);
  }
}

template <typename T, typename P>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const float* k_scale, const float* v_scale, const int* tables,
           const int* lengths, void* out, int batch, int n_kv_heads,
           int group, int dh, int bs, int nb, int table_stride, int window,
           float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (2 * (size_t)group * dh + (size_t)bs * (dh + 1) + (size_t)bs * dh +
       (size_t)group * bs + 3 * (size_t)group +
       (k_scale != nullptr ? 2 * (size_t)nb : 0));
  auto kernel = k_scale != nullptr ? paged_decode_kernel<T, P, true>
                                    : paged_decode_kernel<T, P, false>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(batch, n_kv_heads);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(k_pool),
      static_cast<const P*>(v_pool), k_scale, v_scale, tables, lengths,
      static_cast<T*>(out), n_kv_heads, group, dh, bs, nb, table_stride,
      window, scale);
  return (int)cudaGetLastError();
}

// q's type T with a pool of T, or of int8 codes
template <typename T>
int launch_pool(const void* q, const void* k_pool, const void* v_pool,
                const float* k_scale, const float* v_scale,
                const int* tables, const int* lengths, void* out, int batch,
                int n_kv_heads, int group, int dh, int bs, int nb,
                int table_stride, int window, float scale, int pool_dtype,
                int dtype, cudaStream_t stream) {
  if (pool_dtype == dtype)
    return launch<T, T>(q, k_pool, v_pool, k_scale, v_scale, tables, lengths,
                        out, batch, n_kv_heads, group, dh, bs, nb,
                        table_stride, window, scale, stream);
  if (pool_dtype == repro::kInt8)
    return launch<T, int8_t>(q, k_pool, v_pool, k_scale, v_scale, tables,
                             lengths, out, batch, n_kv_heads, group, dh, bs,
                             nb, table_stride, window, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// k_scale / v_scale: (n_blocks, Kh) fp32 scales of an int8 pool, or null
// for a pool of q's type.
extern "C" int repro_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* lengths, void* out, const void* k_scale, const void* v_scale,
    int batch, int n_kv_heads, int group, int dh, int bs, int nb,
    int table_stride, int window, float scale, int dtype, int pool_dtype,
    void* stream) {
  const int* tab = static_cast<const int*>(tables);
  const int* lens = static_cast<const int*>(lengths);
  const float* ksc = static_cast<const float*>(k_scale);
  const float* vsc = static_cast<const float*>(v_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return launch_pool<float>(q, k_pool, v_pool, ksc, vsc, tab, lens, out,
                              batch, n_kv_heads, group, dh, bs, nb,
                              table_stride, window, scale, pool_dtype, dtype,
                              s);
  if (dtype == repro::kBFloat16)
    return launch_pool<__nv_bfloat16>(q, k_pool, v_pool, ksc, vsc, tab, lens,
                                      out, batch, n_kv_heads, group, dh, bs,
                                      nb, table_stride, window, scale,
                                      pool_dtype, dtype, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
