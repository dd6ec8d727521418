// Paged prefill attention for Hopper (sm_90a): a chunk of Sq queries
// against [its npre paged prefix blocks ++ its own suffix K/V].
//
// Replaces the TPU kernel src/repro/kernels/prefill_attention.py
// (paged_prefill_attention, kernel _prefill_kernel). Same function:
// query i of row b sits at global position npre * bs + i and attends,
// causally and with an fp32 online softmax, over the prefix blocks that
// tables[b, :] names in the pool (whole blocks of real tokens, so only a
// window can hide them) and over the suffix keys up to its own position.
//
// Design. One thread block per (query tile, kv_head, b) with
// kTileQ = 16 query positions; the tile's G x 16 query rows (row
// r = i * G + g, so each query position's G heads are one contiguous
// load) are staged in shared memory, pre-scaled, beside their fp32
// accumulators. Inside the block one loop takes the place of the Pallas
// sequential KV grid axis: first the prefix blocks through the block
// table, then the suffix in tiles of bs keys, stopping at the first
// suffix tile past the tile's causal diagonal; tiles wholly outside the
// window are skipped. Each K/V tile is staged once in shared memory (K
// rows padded by one float) and used by all G x 16 rows. Unlike the
// Pallas kernel, Sq needs no divisor walk-down: the ragged last query
// tile and the ragged last suffix tile are masked.
//
// int8 pools. The pool's element type is a template parameter apart from
// q's: with an int8 pool each prefix block's (block, kv_head) scale is
// looked up through the same table entry as the block (the trash block 0
// has a scale row too, which a pad row reads) and the codes dequantize as
// code * scale in fp32 while the tile is staged, so no fp copy of the
// prefix exists anywhere; the suffix K/V stay in q's type. An int8 pool
// halves (bf16) or quarters (fp32) the prefix bytes.
//
// Bound on the H100: at serve shapes (npre = 16 blocks, Sq = 128, B = 8)
// the call moves ~25 MB and does ~4 GFLOP, so against bf16 tensor-core
// peak it is memory-bound (~8 us of bytes vs ~4 us of flops). This first
// kernel does its products with fp32 FMAs on the CUDA cores, whose far
// lower rate makes the operations its real limit; moving QK^T and PV
// onto wgmma is the later optimisation. Re-reading the prefix once per
// query tile costs L2 traffic, not HBM bytes, at these sizes.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int kThreads = 256;
constexpr int kTileQ = 16;

template <typename T, typename P>
__global__ void __launch_bounds__(kThreads) paged_prefill_kernel(
    const T* __restrict__ q,         // (B, Sq, H, Dh)
    const T* __restrict__ k_suf,     // (B, Sq, Kh, Dh)
    const T* __restrict__ v_suf,     // (B, Sq, Kh, Dh)
    const P* __restrict__ k_pool,    // (n_blocks, bs, Kh, Dh)
    const P* __restrict__ v_pool,    // (n_blocks, bs, Kh, Dh)
    const float* __restrict__ k_scale,  // (n_blocks, Kh), or null
    const float* __restrict__ v_scale,  // (n_blocks, Kh), or null
    const int* __restrict__ tables,  // (B, >= npre), row stride table_stride
    T* __restrict__ out,             // (B, Sq, H, Dh)
    int sq, int n_kv_heads, int group, int dh, int bs, int npre,
    int table_stride, int window, float scale) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * kTileQ;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int rows = kTileQ * group;
  const int rd = rows * dh;
  const int k_stride = dh + 1;

  float* q_s = smem;                   // (rows, Dh), pre-scaled
  float* acc_s = q_s + rd;             // (rows, Dh)
  float* k_s = acc_s + rd;             // (bs, Dh + 1)
  float* v_s = k_s + bs * k_stride;    // (bs, Dh)
  float* p_s = v_s + bs * dh;          // (rows, bs)
  float* m_s = p_s + rows * bs;        // (rows,)
  float* l_s = m_s + rows;             // (rows,)
  float* a_s = l_s + rows;             // (rows,)

  const int nq = min(kTileQ, sq - q0);         // valid query positions
  const int n_heads = n_kv_heads * group;
  const int pos_offset = npre * bs;
  const size_t tok_stride = (size_t)n_kv_heads * dh;

  for (int idx = tid; idx < rd; idx += kThreads) {
    const int r = idx / dh, d = idx - r * dh;
    const int i = r / group, g = r - i * group;
    float v = 0.f;
    if (i < nq) {
      const size_t off =
          (((size_t)b * sq + q0 + i) * n_heads + (size_t)kh * group + g) * dh;
      v = to_f32(q[off + d]) * scale;
    }
    q_s[idx] = v;
    acc_s[idx] = 0.f;
  }
  for (int r = tid; r < rows; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }

  const int first_q = pos_offset + q0;
  const int last_q = pos_offset + q0 + nq - 1;
  const int n_suf = (sq + bs - 1) / bs;
  const int* tab = tables + (size_t)b * table_stride;
  __syncthreads();

  for (int step = 0; step < npre + n_suf; ++step) {
    const bool prefix = step < npre;
    size_t base;
    int kpos0, ntok;
    float ks = 1.f, vs = 1.f;
    if (prefix) {
      kpos0 = step * bs;
      ntok = bs;
      if (window > 0 && kpos0 + bs - 1 <= first_q - window) continue;
      const size_t blk = tab[step];
      base = (blk * bs * n_kv_heads + kh) * dh;
      if (k_scale != nullptr) {
        ks = k_scale[blk * n_kv_heads + kh];
        vs = v_scale[blk * n_kv_heads + kh];
      }
    } else {
      const int s0 = (step - npre) * bs;
      kpos0 = pos_offset + s0;
      if (kpos0 > last_q) break;                // past the causal diagonal
      ntok = min(bs, sq - s0);
      if (window > 0 && kpos0 + ntok - 1 <= first_q - window) continue;
      base = (((size_t)b * sq + s0) * n_kv_heads + kh) * dh;
    }
    for (int idx = tid; idx < bs * dh; idx += kThreads) {
      const int t = idx / dh, d = idx - t * dh;
      float kv = 0.f, vv = 0.f;
      if (t < ntok) {
        const size_t off = base + t * tok_stride + d;
        if (prefix) {
          kv = to_f32(k_pool[off]) * ks;
          vv = to_f32(v_pool[off]) * vs;
        } else {
          kv = to_f32(k_suf[off]);
          vv = to_f32(v_suf[off]);
        }
      }
      k_s[t * k_stride + d] = kv;
      v_s[t * dh + d] = vv;
    }
    __syncthreads();

    for (int idx = tid; idx < rows * bs; idx += kThreads) {
      const int r = idx / bs, t = idx - r * bs;
      const int qpos = first_q + r / group;
      const int kpos = kpos0 + t;
      float s = -INFINITY;
      if (r / group < nq && t < ntok && kpos <= qpos &&
          (window <= 0 || kpos > qpos - window)) {
        const float* qr = q_s + r * dh;
        const float* kr = k_s + t * k_stride;
        float dot = 0.f;
        for (int d = 0; d < dh; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot;
      }
      p_s[idx] = s;
    }
    __syncthreads();

    online_softmax_rows(p_s, m_s, l_s, a_s, rows, bs, kThreads);
    __syncthreads();

    for (int idx = tid; idx < rd; idx += kThreads) {
      const int r = idx / dh, d = idx - r * dh;
      const float* pr = p_s + r * bs;
      float pv = 0.f;
      for (int t = 0; t < bs; ++t) pv = fmaf(pr[t], v_s[t * dh + d], pv);
      acc_s[idx] = acc_s[idx] * a_s[r] + pv;
    }
    __syncthreads();
  }

  for (int idx = tid; idx < rd; idx += kThreads) {
    const int r = idx / dh, d = idx - r * dh;
    const int i = r / group, g = r - i * group;
    if (i >= nq) continue;
    const float l = l_s[r];
    const size_t off =
        (((size_t)b * sq + q0 + i) * n_heads + (size_t)kh * group + g) * dh;
    out[off + d] = from_f32<T>(l > 0.f ? acc_s[idx] / l : 0.f);
  }
}

template <typename T, typename P>
int launch(const void* q, const void* k_suf, const void* v_suf,
           const void* k_pool, const void* v_pool, const float* k_scale,
           const float* v_scale, const int* tables, void* out, int batch,
           int sq, int n_kv_heads, int group, int dh, int bs, int npre,
           int table_stride, int window, float scale, cudaStream_t stream) {
  const size_t rows = (size_t)kTileQ * group;
  const size_t smem = sizeof(float) *
      (2 * rows * dh + (size_t)bs * (dh + 1) + (size_t)bs * dh + rows * bs +
       3 * rows);
  auto kernel = paged_prefill_kernel<T, P>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((sq + kTileQ - 1) / kTileQ, n_kv_heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_suf),
      static_cast<const T*>(v_suf), static_cast<const P*>(k_pool),
      static_cast<const P*>(v_pool), k_scale, v_scale, tables,
      static_cast<T*>(out), sq, n_kv_heads, group, dh, bs, npre,
      table_stride, window, scale);
  return (int)cudaGetLastError();
}

// q's type T with a pool of T, or of int8 codes
template <typename T>
int launch_pool(const void* q, const void* k_suf, const void* v_suf,
                const void* k_pool, const void* v_pool, const float* k_scale,
                const float* v_scale, const int* tables, void* out,
                int batch, int sq, int n_kv_heads, int group, int dh, int bs,
                int npre, int table_stride, int window, float scale,
                int pool_dtype, int dtype, cudaStream_t stream) {
  if (pool_dtype == dtype)
    return launch<T, T>(q, k_suf, v_suf, k_pool, v_pool, k_scale, v_scale,
                        tables, out, batch, sq, n_kv_heads, group, dh, bs,
                        npre, table_stride, window, scale, stream);
  if (pool_dtype == repro::kInt8)
    return launch<T, int8_t>(q, k_suf, v_suf, k_pool, v_pool, k_scale,
                             v_scale, tables, out, batch, sq, n_kv_heads,
                             group, dh, bs, npre, table_stride, window, scale,
                             stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// k_scale / v_scale: (n_blocks, Kh) fp32 scales of an int8 pool, or null
// for a pool of q's type.
extern "C" int repro_paged_prefill_attention(
    const void* q, const void* k_suf, const void* v_suf, const void* k_pool,
    const void* v_pool, const void* tables, void* out, const void* k_scale,
    const void* v_scale, int batch, int sq, int n_kv_heads, int group, int dh,
    int bs, int npre, int table_stride, int window, float scale, int dtype,
    int pool_dtype, void* stream) {
  const int* tab = static_cast<const int*>(tables);
  const float* ksc = static_cast<const float*>(k_scale);
  const float* vsc = static_cast<const float*>(v_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return launch_pool<float>(q, k_suf, v_suf, k_pool, v_pool, ksc, vsc, tab,
                              out, batch, sq, n_kv_heads, group, dh, bs, npre,
                              table_stride, window, scale, pool_dtype, dtype,
                              s);
  if (dtype == repro::kBFloat16)
    return launch_pool<__nv_bfloat16>(q, k_suf, v_suf, k_pool, v_pool, ksc,
                                      vsc, tab, out, batch, sq, n_kv_heads,
                                      group, dh, bs, npre, table_stride,
                                      window, scale, pool_dtype, dtype, s);
  return (int)cudaErrorInvalidValue;
}
