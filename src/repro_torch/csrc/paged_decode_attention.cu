// Paged decode attention for Hopper (sm_90a): one query token per
// sequence against its paged KV history, split across thread blocks
// along the KV axis (flash-decoding) and combined in the same launch.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py
// (paged_decode_attention, kernel _decode_kernel). Same function: for
// each sequence b and KV head, the G = H / Kh query heads of the group
// attend over the pool blocks named by tables[b, :nb], masked to
// kpos < lengths[b] (and kpos > lengths[b] - 1 - window when windowed),
// with an fp32 softmax; the output is written in q's dtype.
//
// Bound on the H100: device-memory bytes. A call reads each visible key
// row of K and V once (len x Kh x Dh x 2 x sizeof(P) per sequence) and
// does 4 x G flops per K/V element pair, far below the ~295 flop/byte
// where the tensor cores would limit; at the serve shapes (B = 8, 64 KV
// heads' worth of ~300 keys) that is ~32 MFLOP, under a microsecond on
// the CUDA cores. So the products run in fp32 FMAs: the tensor-core core
// attention_mma.cuh would buy nothing here, and the design's only job is
// to keep enough bytes in flight to fill the card.
//
// Design. The Pallas kernel walks the table as a sequential grid axis
// and carries (m, l, acc) across grid steps. Here the grid is (B, Kh x
// head chunks, splits): split s owns table columns [s * chunk, (s + 1) *
// chunk), so B x Kh x splits blocks fill the 132 SMs even at B = 8
// (splits and chunk come from host-known numbers, kernels/
// decode_attention.py::decode_splits; lengths are never read on the
// host). Inside a split there is no barrier until the end:
//   * a key row (Dh contiguous elements of the (n_blocks, bs, Kh, Dh)
//     pool) is read by kL lanes, 16 bytes each (ld.global.nc.v4: 8 bf16,
//     4 fp32 or 16 int8 codes), so a warp reads 32 / kL rows at once and
//     each lane keeps kUnroll K and V vectors in flight;
//   * each lane holds its slice of the group's (up to kMaxG) q rows,
//     pre-scaled by scale * log2(e), in registers; q . k is a per-lane
//     FMA chain reduced by xor shuffles over the row's kL lanes;
//   * each row group of lanes runs its own online softmax (base 2) and
//     P V accumulation in registers;
//   * at the end of the split the row groups merge by shuffles and the
//     warps once through shared memory.
// int8 pools: each key's (block, kv_head) scale is looked up through the
// same tables[b, j] entry that addresses it and applied as code * scale
// in fp32; whether scales apply is a template flag, so the fp walk has
// no scale load (a run-time branch cost 23 % in the earlier design).
// Combine. Every block finds, from lengths[b] and the window, the splits
// that hold visible keys; a split whose range lies past the length or
// before the window exits at once, reading no K/V and writing nothing
// (the table is a power-of-two bucket of the longest sequence, so many
// splits of the shorter ones are such). Where one split holds all the
// visible keys it writes the output directly: no scratch, no ticket.
// Otherwise each such split writes its (m, l, acc[G, Dh]) partial in
// fp32 to scratch, fences and takes a ticket on a per-(b, head chunk)
// counter; the block that takes the last ticket merges the partials in
// split order (weights exp2(m_s - M), a partial that saw no key weighing
// 0), writes the output and resets the counter to 0, so the counters
// stay valid for the next launch (and under a CUDA graph). No float
// atomics: equal inputs give equal bits. A sequence with no visible key
// gets zeros (split 0 writes them), as the earlier kernel gave.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxG = 3;        // q heads per block; larger groups take more
constexpr int kMaxSplits = 64;  // kernels/decode_attention.py MAX_SPLITS
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

template <typename T, typename P, bool kScaled, int kDh>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q,          // (B, H, Dh)
    const P* __restrict__ k_pool,     // (n_blocks, bs, Kh, Dh)
    const P* __restrict__ v_pool,     // (n_blocks, bs, Kh, Dh)
    const float* __restrict__ k_scale,  // (n_blocks, Kh), or null
    const float* __restrict__ v_scale,  // (n_blocks, Kh), or null
    const int* __restrict__ tables,   // (B, >= nb), row stride table_stride
    const int* __restrict__ lengths,  // (B,)
    T* __restrict__ out,              // (B, H, Dh)
    float* __restrict__ part,         // partials, when splits > 1
    int* __restrict__ tickets,        // (B x Kh x head chunks,), zeros
    int n_kv_heads, int group, int bs, int nb, int table_stride, int window,
    int splits, int chunk, float scale) {
  constexpr int kN = Vec<P>::kN;               // pool elements in 16 bytes
  static_assert(kDh % kN == 0, "a key row is whole 16-byte vectors");
  constexpr int kV = kDh / kN;                 // vectors in a key row
  static_assert(kV <= 32, "a key row fits one warp");
  constexpr int kL = pow2_at_least(kV);        // lanes per key row
  constexpr int kR = 32 / kL;                  // key rows a warp reads at once
  constexpr int kUnroll = kN >= 16 ? 2 : 4;    // rows in flight per row group
  constexpr int kRound = kWarps * kR * kUnroll;

  __shared__ float red_acc[kWarps][kMaxG][kDh];
  __shared__ float red_m[kWarps][kMaxG], red_l[kWarps][kMaxG];
  __shared__ float comb_w[kMaxSplits][kMaxG];  // combine: split weights
  __shared__ float comb_l[kMaxG];
  __shared__ int is_last;

  const int b = blockIdx.x;
  const int chunks_g = gridDim.y / n_kv_heads;
  const int kh = blockIdx.y / chunks_g;
  const int g0 = (blockIdx.y - kh * chunks_g) * kMaxG;
  const int ng = min(kMaxG, group - g0);
  const int s = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = lane / kL, sub = lane % kL;
  const bool has_vec = sub < kV;

  // visible keys: lo < kpos < length and kpos < nb * bs. Only the
  // splits [s_first, s_last] hold any; the others exit at once, and the
  // combine counts only these.
  const int length = lengths[b];
  const int lo = window > 0 ? length - 1 - window : -1;
  const int span = chunk * bs;               // keys a split owns
  const int k_begin = max(lo + 1, 0), k_end = min(length, nb * bs);
  int s_first = 0, s_last = -1;
  if (k_end > k_begin) {
    s_first = k_begin / span;
    s_last = (k_end - 1) / span;
  }
  const int n_active = s_last - s_first + 1;
  const size_t head0 =
      (size_t)b * n_kv_heads * group + (size_t)kh * group + g0;
  if (n_active <= 0) {                       // no visible key: zeros
    if (s == 0)
      for (int i = threadIdx.x; i < ng * kDh; i += kThreads)
        out[head0 * kDh + i] = from_f32<T>(0.f);
    return;
  }
  if (s < s_first || s > s_last) return;
  // this split's keys: [kb, ke)
  const int kb = max(s * span, k_begin);
  const int ke = min((s + 1) * span, k_end);
  const int n = ke - kb;
  float qr[kMaxG][kN];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < ng && has_vec) {
      load_f32<T, kN>(q + (head0 + g) * kDh + sub * kN, qr[g]);
#pragma unroll
      for (int e = 0; e < kN; ++e) qr[g][e] *= scale * kLog2e;
    } else {
#pragma unroll
      for (int e = 0; e < kN; ++e) qr[g][e] = 0.f;
    }
  }
  float m[kMaxG], l[kMaxG], acc[kMaxG][kN];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kN; ++e) acc[g][e] = 0.f;
  }

  const int* tab = tables + (size_t)b * table_stride;
  const size_t row_stride = (size_t)n_kv_heads * kDh;  // between key rows
  const size_t col = (size_t)kh * kDh + sub * kN;
  for (int base = 0; base < n; base += kRound) {
    uint4 kv[kUnroll], vv[kUnroll];
    float ks[kUnroll], vs[kUnroll];
    bool valid[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + (u * kWarps + warp) * kR + row;
      valid[u] = i < n;
      kv[u] = vv[u] = make_uint4(0u, 0u, 0u, 0u);
      ks[u] = vs[u] = 1.f;
      if (valid[u]) {
        const int kpos = kb + i;
        const int j = kpos / bs;
        const size_t blk = (size_t)__ldg(tab + j);
        if (has_vec) {
          const size_t off = (blk * bs + (kpos - j * bs)) * row_stride + col;
          kv[u] = __ldg(reinterpret_cast<const uint4*>(k_pool + off));
          vv[u] = __ldg(reinterpret_cast<const uint4*>(v_pool + off));
        }
        if constexpr (kScaled) {
          ks[u] = __ldg(k_scale + blk * n_kv_heads + kh);
          vs[u] = __ldg(v_scale + blk * n_kv_heads + kh);
        }
      }
    }
    // scores, log2 units; -inf where the row holds no visible key
    float sc[kUnroll][kMaxG];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[kN];
      Vec<P>::unpack(kv[u], kf);
      if constexpr (kScaled) {
#pragma unroll
        for (int e = 0; e < kN; ++e) kf[e] *= ks[u];
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        float d = 0.f;
        if (g < ng) {           // ng is uniform over the block
#pragma unroll
          for (int e = 0; e < kN; ++e) d = fmaf(qr[g][e], kf[e], d);
#pragma unroll
          for (int o = kL / 2; o > 0; o >>= 1)
            d += __shfl_xor_sync(kFull, d, o);
        }
        sc[u][g] = valid[u] && g < ng ? d : -INFINITY;
      }
    }
    // online softmax of this row group over its kUnroll rows
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= ng) break;
      float mn = m[g];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) mn = fmaxf(mn, sc[u][g]);
      const float alpha = m[g] == -INFINITY ? 0.f : exp2f(m[g] - mn);
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < kN; ++e) acc[g][e] *= alpha;
      m[g] = mn;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float vf[kN];
      Vec<P>::unpack(vv[u], vf);
      if constexpr (kScaled) {
#pragma unroll
        for (int e = 0; e < kN; ++e) vf[e] *= vs[u];
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= ng) break;
        const float p = sc[u][g] == -INFINITY ? 0.f : exp2f(sc[u][g] - m[g]);
        l[g] += p;
#pragma unroll
        for (int e = 0; e < kN; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
  }

  // merge the warp's row groups (xor butterflies: every lane ends equal)
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= ng) break;
    float mx = m[g];
#pragma unroll
    for (int o = kL; o < 32; o <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
    const float f = m[g] == -INFINITY ? 0.f : exp2f(m[g] - mx);
    float lg = l[g] * f;
#pragma unroll
    for (int o = kL; o < 32; o <<= 1) lg += __shfl_xor_sync(kFull, lg, o);
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      float a = acc[g][e] * f;
#pragma unroll
      for (int o = kL; o < 32; o <<= 1) a += __shfl_xor_sync(kFull, a, o);
      acc[g][e] = a;
    }
    if (row == 0 && has_vec) {
#pragma unroll
      for (int e = 0; e < kN; ++e) red_acc[warp][g][sub * kN + e] = acc[g][e];
    }
    if (lane == 0) {
      red_m[warp][g] = mx;
      red_l[warp][g] = lg;
    }
  }
  __syncthreads();

  // merge the warps, in order; then the output, or this split's partial
  const int gd = ng * kDh;
  const int pair = b * gridDim.y + blockIdx.y;
  const size_t n_part = (size_t)gridDim.x * gridDim.y * splits;
  float* part_ml = part + ((size_t)pair * splits) * 2 * kMaxG;
  float* part_acc = part + n_part * 2 * kMaxG +
                    ((size_t)pair * splits) * kMaxG * kDh;
  for (int i = threadIdx.x; i < gd; i += kThreads) {
    const int g = i / kDh, d = i - g * kDh;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red_m[w][g]);
    float lt = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (red_m[w][g] != -INFINITY) {
        const float f = exp2f(red_m[w][g] - mx);
        lt = fmaf(f, red_l[w][g], lt);
        a = fmaf(f, red_acc[w][g][d], a);
      }
    }
    if (n_active == 1) {
      out[(head0 + g) * kDh + d] = from_f32<T>(lt > 0.f ? a / lt : 0.f);
    } else {
      if (d == 0) {
        part_ml[(size_t)s * 2 * kMaxG + 2 * g] = mx;
        part_ml[(size_t)s * 2 * kMaxG + 2 * g + 1] = lt;
      }
      if (mx != -INFINITY) part_acc[((size_t)s * kMaxG + g) * kDh + d] = a;
    }
  }
  if (n_active == 1) return;

  // the last split to finish combines
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(tickets + pair, 1) == n_active - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int i = threadIdx.x; i < n_active * ng; i += kThreads) {
    const int t = i / ng, g = i - t * ng;
    comb_w[t][g] =
        __ldcg(part_ml + (size_t)(s_first + t) * 2 * kMaxG + 2 * g);
  }
  __syncthreads();
  if (threadIdx.x < ng) {
    const int g = threadIdx.x;
    float mx = -INFINITY;
    for (int t = 0; t < n_active; ++t) mx = fmaxf(mx, comb_w[t][g]);
    float lt = 0.f;
    for (int t = 0; t < n_active; ++t) {
      const float mt = comb_w[t][g];
      const float f = mt == -INFINITY ? 0.f : exp2f(mt - mx);
      if (f != 0.f)
        lt = fmaf(f, __ldcg(part_ml + (size_t)(s_first + t) * 2 * kMaxG +
                            2 * g + 1), lt);
      comb_w[t][g] = f;
    }
    comb_l[g] = lt;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < gd; i += kThreads) {
    const int g = i / kDh, d = i - g * kDh;
    float a = 0.f;
    for (int t = 0; t < n_active; ++t) {
      const float f = comb_w[t][g];
      if (f != 0.f)
        a = fmaf(f, __ldcg(part_acc + ((size_t)(s_first + t) * kMaxG + g) *
                                          kDh + d), a);
    }
    const float lt = comb_l[g];
    out[(head0 + g) * kDh + d] = from_f32<T>(lt > 0.f ? a / lt : 0.f);
  }
  if (threadIdx.x == 0) tickets[pair] = 0;
}

template <typename T, typename P, bool kScaled, int kDh>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const float* k_scale, const float* v_scale, const int* tables,
           const int* lengths, void* out, float* part, int* tickets,
           int batch, int n_kv_heads, int group, int bs, int nb,
           int table_stride, int window, int splits, int chunk, float scale,
           cudaStream_t stream) {
  if (splits < 1 || splits > kMaxSplits || group < 1)
    return (int)cudaErrorInvalidValue;
  const int chunks_g = (group + kMaxG - 1) / kMaxG;
  dim3 grid(batch, n_kv_heads * chunks_g, splits);
  paged_decode_kernel<T, P, kScaled, kDh><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(k_pool),
      static_cast<const P*>(v_pool), k_scale, v_scale, tables, lengths,
      static_cast<T*>(out), part, tickets, n_kv_heads, group, bs, nb,
      table_stride, window, splits, chunk, scale);
  return (int)cudaGetLastError();
}

// the head widths instantiated: every width of the configs (16 reduced,
// 64 gpt-117m, 96 gpt-800m, 128 llama3.2-3b) and 32
// (kernels/decode_attention.py D_HEADS)
template <typename T, typename P, bool kScaled>
int launch_dh(int dh, const void* q, const void* k_pool, const void* v_pool,
              const float* k_scale, const float* v_scale, const int* tables,
              const int* lengths, void* out, float* part, int* tickets,
              int batch, int n_kv_heads, int group, int bs, int nb,
              int table_stride, int window, int splits, int chunk,
              float scale, cudaStream_t stream) {
#define REPRO_DECODE_DH(D)                                                   \
  case D:                                                                    \
    return launch<T, P, kScaled, D>(q, k_pool, v_pool, k_scale, v_scale,     \
                                    tables, lengths, out, part, tickets,     \
                                    batch, n_kv_heads, group, bs, nb,        \
                                    table_stride, window, splits, chunk,     \
                                    scale, stream);
  switch (dh) {
    REPRO_DECODE_DH(16)
    REPRO_DECODE_DH(32)
    REPRO_DECODE_DH(64)
    REPRO_DECODE_DH(96)
    REPRO_DECODE_DH(128)
  }
#undef REPRO_DECODE_DH
  return (int)cudaErrorInvalidValue;
}

// q's type T with a pool of T (scaled or not), or of int8 codes (scaled)
template <typename T>
int launch_pool(int pool_dtype, int dtype, int dh, const void* q,
                const void* k_pool, const void* v_pool, const float* k_scale,
                const float* v_scale, const int* tables, const int* lengths,
                void* out, float* part, int* tickets, int batch,
                int n_kv_heads, int group, int bs, int nb, int table_stride,
                int window, int splits, int chunk, float scale,
                cudaStream_t stream) {
  const bool scaled = k_scale != nullptr;
  if (pool_dtype == dtype && !scaled)
    return launch_dh<T, T, false>(dh, q, k_pool, v_pool, k_scale, v_scale,
                                  tables, lengths, out, part, tickets, batch,
                                  n_kv_heads, group, bs, nb, table_stride,
                                  window, splits, chunk, scale, stream);
  if (pool_dtype == dtype)
    return launch_dh<T, T, true>(dh, q, k_pool, v_pool, k_scale, v_scale,
                                 tables, lengths, out, part, tickets, batch,
                                 n_kv_heads, group, bs, nb, table_stride,
                                 window, splits, chunk, scale, stream);
  if (pool_dtype == kInt8 && scaled)
    return launch_dh<T, int8_t, true>(dh, q, k_pool, v_pool, k_scale,
                                      v_scale, tables, lengths, out, part,
                                      tickets, batch, n_kv_heads, group, bs,
                                      nb, table_stride, window, splits,
                                      chunk, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// k_scale / v_scale: (n_blocks, Kh) fp32 scales of an int8 pool, or null
// for a pool of q's type. scratch: fp32 partials of B x Kh x ceil(G /
// 3) x splits x 3 x (Dh + 2) floats (null with one split); tickets: as
// many int32 counters as B x Kh x ceil(G / 3), zero before the call and
// left zero after it.
extern "C" int repro_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* lengths, void* out, const void* k_scale, const void* v_scale,
    void* scratch, void* tickets, int batch, int n_kv_heads, int group,
    int dh, int bs, int nb, int table_stride, int window, int splits,
    int chunk, float scale, int dtype, int pool_dtype, void* stream) {
  const int* tab = static_cast<const int*>(tables);
  const int* lens = static_cast<const int*>(lengths);
  const float* ksc = static_cast<const float*>(k_scale);
  const float* vsc = static_cast<const float*>(v_scale);
  float* part = static_cast<float*>(scratch);
  int* tick = static_cast<int*>(tickets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits > 1 && (part == nullptr || tick == nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype == repro::kFloat32)
    return launch_pool<float>(pool_dtype, dtype, dh, q, k_pool, v_pool, ksc,
                              vsc, tab, lens, out, part, tick, batch,
                              n_kv_heads, group, bs, nb, table_stride, window,
                              splits, chunk, scale, s);
  if (dtype == repro::kBFloat16)
    return launch_pool<__nv_bfloat16>(pool_dtype, dtype, dh, q, k_pool,
                                      v_pool, ksc, vsc, tab, lens, out, part,
                                      tick, batch, n_kv_heads, group, bs, nb,
                                      table_stride, window, splits, chunk,
                                      scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
