// Paged prefill attention for Hopper (sm_90a): a chunk of Sq queries
// against [its npre paged prefix blocks ++ its own suffix K/V].
//
// Replaces the TPU kernel src/repro/kernels/prefill_attention.py
// (paged_prefill_attention, kernel _prefill_kernel). Same function:
// query i of row b sits at global position npre * bs + i and attends,
// causally and with an fp32 online softmax, over the prefix blocks that
// tables[b, :] names in the pool (whole blocks of real tokens, so only a
// window can hide them) and over the suffix keys up to its own position.
// An int8 pool carries (n_blocks, Kh) fp32 scales: a prefix key or value
// is `code * scale` in fp32, looked up through the same table entry as
// its block (the trash block 0 has a scale row too, which a pad row
// reads); the suffix K/V stay in q's type.
//
// Bound on the H100: at the serve run's prefix hit (B=8, Sq=128, npre=16
// blocks of 16, H=24, Kh=8, Dh=128, bf16) the call moves ~24 MB (~20 MB
// on an int8 pool) and does ~4 GFLOP, so it is bound by bytes: ~7 us
// (~6 us int8) against ~4 us of bf16 tensor-core operations.
//
// What held the first design back (kept below for fp32 inputs): one
// thread did a whole Dh-long dot product out of shared memory per score,
// P V ran the same way, over tiles of only bs = 16 keys with three
// barriers each, and the softmax went through shared memory one warp per
// row (common.cuh): no tensor core anywhere, 1.19 ms at the shape above,
// slower than its plain version.
//
// bf16 design (paged_prefill_mma_kernel): the shared tensor-core core of
// attention_mma.cuh. One block of four warps takes one KV head of one
// batch row and 64 packed (query, g) rows, r = i * G + g (G = 3 at
// llama3.2-3b width, so a query position's rows may straddle two warps:
// the causal limit is per row); Q K^T and P V run as mma.sync m16n8k16
// with fp32 accumulators, the online softmax stays in registers and P is
// split into bf16 hi + lo (a single bf16 P makes ~40 % of the outputs
// differ from the fp32 softmax, the split under 1 %). K/V come in tiles
// of 64 keys through a two-stage cp.async ring: first the prefix, a tile
// being 64 / bs pool blocks (4 at bs = 16, 8 at bs = 8) each gathered
// through tables[b, j] (a partial last prefix tile is masked), then the
// suffix, stopping at the block's causal diagonal; tiles wholly before
// the window are skipped. int8 codes are staged as codes (half the bytes)
// and widened to bf16 in shared memory (exact); k_scale multiplies the
// score columns of its block after Q K^T and v_scale the fp32 P columns
// before the split, so no bf16 rounding of a dequantized value enters.
// Grid at the shape above: 6 row tiles x 8 KV heads x 8 rows = 384
// blocks of 128 threads on 132 SMs; a block takes 87 KB of shared memory
// on a bf16 pool and 105 KB on an int8 pool (Q 17 KB, the K/V ring 70 KB,
// the code buffer 18 KB), so two blocks fit on an SM either way. fp32
// inputs keep the FMA kernel: bf16 tensor cores cannot meet the fp32
// gate (rounding q to bf16 alone is ~2e-3).
//
// Left for a later PR: wgmma from shared-memory descriptors, TMA loads
// completing on mbarriers, a producer warp, a persistent grid.
#include <type_traits>

#include "attention_mma.cuh"

namespace {

using namespace repro;

// ---------------------------------------------------------------------------
// fp32: one thread block per (query tile, kv_head, b) with kTileQ = 16
// query positions; the tile's G x 16 query rows (row r = i * G + g) are
// staged in shared memory, pre-scaled, beside their fp32 accumulators.
// One loop walks the prefix blocks through the block table, then the
// suffix in tiles of bs keys, stopping at the first suffix tile past the
// tile's causal diagonal; tiles wholly outside the window are skipped.
// An int8 pool's codes dequantize as code * scale in fp32 while the tile
// is staged. The ragged last query and suffix tiles are masked.
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// bf16: the tensor-core core (attention_mma.cuh); P is the pool's type,
// bf16 or int8 codes
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

template <int DH, typename P>
struct PrefillProblem {
  static constexpr bool kCodes = std::is_same<P, int8_t>::value;
  const bf16* q;
  const bf16* k_suf;
  const bf16* v_suf;
  const P* k_pool;
  const P* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* tab;  // this row's table
  bf16* out;
  int b, sq, kh, n_kv_heads, n_heads, bs, n_pre_tiles;
  int n_rows, group, pos_first, causal, window, t_begin, t_end;
  bool scaled;

  __device__ size_t q_off(int i, int g) const {
    return (((size_t)b * sq + i) * n_heads + (size_t)kh * group + g) * DH;
  }
  __device__ const bf16* q_row(int i, int g) const { return q + q_off(i, g); }
  __device__ bf16* out_row(int i, int g) const { return out + q_off(i, g); }
  __device__ int kpos0(int t) const {
    return t < n_pre_tiles ? t * mma::kKeys
                           : pos_first + (t - n_pre_tiles) * mma::kKeys;
  }
  __device__ int nvalid(int t) const {
    return t < n_pre_tiles
               ? min(mma::kKeys, pos_first - t * mma::kKeys)
               : min(mma::kKeys, sq - (t - n_pre_tiles) * mma::kKeys);
  }
  __device__ bool codes(int t) const { return kCodes && t < n_pre_tiles; }

  __device__ void issue(int t, const mma::Stage<DH>& sm, int s) const {
    using L = mma::Layout<DH>;
    const int n = nvalid(t);
    float* sc = sm.scale + 2 * s * mma::kNT;  // [K, V][kNT] of stage s
    if (t < n_pre_tiles) {
      const int p0 = t * mma::kKeys, block = bs;
      const int* tb = tab;
      const size_t kv_stride = (size_t)n_kv_heads * DH,
                   head = (size_t)kh * DH;
      auto rows = [=](const P* pool) {
        return [=](int r) {
          const int pos = p0 + r;
          return pool + ((size_t)tb[pos / block] * block + pos % block) *
                            kv_stride + head;
        };
      };
      if constexpr (kCodes) {
        mma::stage_rows<DH>(sm.k_codes(), L::kCodeStride, n, rows(k_pool));
        mma::stage_rows<DH>(sm.v_codes(), L::kCodeStride, n, rows(v_pool));
      } else {
        mma::stage_rows<DH>(sm.k(s), L::kStride, n, rows(k_pool));
        mma::stage_rows<DH>(sm.v(s), L::kStride, n, rows(v_pool));
      }
      if (scaled && threadIdx.x < 2 * mma::kNT) {
        // the scale of the block under each 8-key column group (the last
        // real block's under the masked columns of a partial tile)
        const int j = threadIdx.x % mma::kNT;
        const int pos = min(p0 + 8 * j, pos_first - 1);
        const float* src = threadIdx.x < mma::kNT ? k_scale : v_scale;
        mma::cp_async4(sc + threadIdx.x,
                       src + (size_t)tab[pos / bs] * n_kv_heads + kh);
      }
    } else {
      const int s0 = (t - n_pre_tiles) * mma::kKeys;
      const size_t tok = (size_t)n_kv_heads * DH;
      const size_t base = ((size_t)b * sq + s0) * tok + (size_t)kh * DH;
      mma::stage_rows<DH>(sm.k(s), L::kStride, n,
                          [&](int r) { return k_suf + base + r * tok; });
      mma::stage_rows<DH>(sm.v(s), L::kStride, n,
                          [&](int r) { return v_suf + base + r * tok; });
      if (scaled && threadIdx.x < 2 * mma::kNT) sc[threadIdx.x] = 1.f;
    }
  }
};

template <int DH, typename P>
__global__ void __launch_bounds__(mma::kThreads, mma::kMinBlocks) paged_prefill_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k_suf,
    const bf16* __restrict__ v_suf, const P* __restrict__ k_pool,
    const P* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    bf16* __restrict__ out, int sq, int n_kv_heads, int group, int bs,
    int npre, int table_stride, int window, float scale) {
  extern __shared__ __align__(16) unsigned char mma_smem[];
  // the row tiles with the most suffix keys (the last) first
  const int tile = gridDim.x - 1 - blockIdx.x;
  PrefillProblem<DH, P> p;
  p.q = q;
  p.k_suf = k_suf;
  p.v_suf = v_suf;
  p.k_pool = k_pool;
  p.v_pool = v_pool;
  p.k_scale = k_scale;
  p.v_scale = v_scale;
  p.out = out;
  p.b = blockIdx.z;
  p.kh = blockIdx.y;
  p.tab = tables + (size_t)p.b * table_stride;
  p.sq = sq;
  p.n_kv_heads = n_kv_heads;
  p.group = group;
  p.n_heads = n_kv_heads * group;
  p.bs = bs;
  p.pos_first = npre * bs;
  p.n_pre_tiles = (p.pos_first + mma::kKeys - 1) / mma::kKeys;
  p.n_rows = sq * group;
  p.causal = 1;
  p.window = window;
  p.scaled = k_scale != nullptr;
  const int row_begin = tile * mma::kRows;
  const int i_first = row_begin / group;
  const int i_last = min(p.n_rows - 1, row_begin + mma::kRows - 1) / group;
  // suffix tiles up to the causal diagonal of the block's last row
  p.t_end = p.n_pre_tiles +
            min((sq + mma::kKeys - 1) / mma::kKeys, i_last / mma::kKeys + 1);
  p.t_begin = 0;
  if (window > 0) {
    const int first_q = p.pos_first + i_first;
    while (p.t_begin < p.t_end &&
           p.kpos0(p.t_begin) + p.nvalid(p.t_begin) - 1 <= first_q - window)
      ++p.t_begin;
  }
  mma::attend<DH>(p, mma::Stage<DH>(mma_smem), row_begin, scale);
}

template <int DH, typename P>
int launch_mma(const void* q, const void* k_suf, const void* v_suf,
               const void* k_pool, const void* v_pool, const float* k_scale,
               const float* v_scale, const int* tables, void* out, int batch,
               int sq, int n_kv_heads, int group, int bs, int npre,
               int table_stride, int window, float scale,
               cudaStream_t stream) {
  constexpr size_t smem =
      mma::Layout<DH>::bytes(PrefillProblem<DH, P>::kCodes);
  auto kernel = paged_prefill_mma_kernel<DH, P>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq * group + mma::kRows - 1) / mma::kRows, n_kv_heads, batch);
  kernel<<<grid, mma::kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_suf),
      static_cast<const bf16*>(v_suf), static_cast<const P*>(k_pool),
      static_cast<const P*>(v_pool), k_scale, v_scale, tables,
      static_cast<bf16*>(out), sq, n_kv_heads, group, bs, npre, table_stride,
      window, scale);
  return (int)cudaGetLastError();
}

template <typename P>
int launch_bf16_pool(const void* q, const void* k_suf, const void* v_suf,
                     const void* k_pool, const void* v_pool,
                     const float* k_scale, const float* v_scale,
                     const int* tables, void* out, int batch, int sq,
                     int n_kv_heads, int group, int dh, int bs, int npre,
                     int table_stride, int window, float scale,
                     cudaStream_t stream) {
#define REPRO_PREFILL_DH(D)                                                   \
  if (dh == D)                                                               \
    return launch_mma<D, P>(q, k_suf, v_suf, k_pool, v_pool, k_scale,        \
                            v_scale, tables, out, batch, sq, n_kv_heads,     \
                            group, bs, npre, table_stride, window, scale,    \
                            stream);
  REPRO_PREFILL_DH(16)
  REPRO_PREFILL_DH(32)
  REPRO_PREFILL_DH(64)
  REPRO_PREFILL_DH(96)
  REPRO_PREFILL_DH(128)
#undef REPRO_PREFILL_DH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// k_scale / v_scale: (n_blocks, Kh) fp32 scales of an int8 pool (or of a
// pool of q's type), else null. fp32 inputs take the FMA kernel, bf16
// inputs the tensor-core kernel (Dh in {16, 32, 64, 96, 128}, bs a
// multiple of 8, 16-byte aligned tensors).
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
  if (dtype == repro::kFloat32) {
    if (pool_dtype == dtype)
      return launch<float, float>(q, k_suf, v_suf, k_pool, v_pool, ksc, vsc,
                                  tab, out, batch, sq, n_kv_heads, group, dh,
                                  bs, npre, table_stride, window, scale, s);
    if (pool_dtype == repro::kInt8)
      return launch<float, int8_t>(q, k_suf, v_suf, k_pool, v_pool, ksc, vsc,
                                   tab, out, batch, sq, n_kv_heads, group,
                                   dh, bs, npre, table_stride, window, scale,
                                   s);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == repro::kBFloat16 && bs % 8 == 0) {
    if (pool_dtype == dtype)
      return launch_bf16_pool<bf16>(q, k_suf, v_suf, k_pool, v_pool, ksc,
                                    vsc, tab, out, batch, sq, n_kv_heads,
                                    group, dh, bs, npre, table_stride, window,
                                    scale, s);
    if (pool_dtype == repro::kInt8)
      return launch_bf16_pool<int8_t>(q, k_suf, v_suf, k_pool, v_pool, ksc,
                                      vsc, tab, out, batch, sq, n_kv_heads,
                                      group, dh, bs, npre, table_stride,
                                      window, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
