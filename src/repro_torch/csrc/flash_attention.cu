// Dense GQA flash attention for Hopper (sm_90a), forward only: causal or
// bidirectional, optional sliding window.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, kernel _flash_kernel). Same function: the Sq queries
// are the last Sq of the Skv key positions (q_off = Skv - Sq); under
// `causal` query position qpos sees keys kpos <= qpos, and with a window
// only kpos > qpos - window; a bidirectional call ignores the window.
// Scores and the softmax are fp32, the output is cast to q's type.
//
// Bound on the H100: at llama3.2-3b prefill width (B=2, S=2048, H=24,
// Kh=8, Dh=128, bf16, causal) the call does ~52 GFLOP over ~67 MB, so it
// is bound by operations: ~52 us at the bf16 tensor-core peak.
//
// What held the first design back (kept below for fp32 inputs): its
// products were fp32 FMAs on the CUDA cores, each operand fed from shared
// memory (flash_kernel's two inner loops), the softmax went through
// shared memory with one warp per row (common.cuh), and each K/V tile was
// loaded once per query head, G times per KV head: 4.6 ms at the shape
// above, 88x its bound, slower than its plain version's einsums.
//
// bf16 design (flash_mma_kernel): the shared tensor-core core of
// attention_mma.cuh. One block of four warps takes one KV head of one
// batch row and 64 packed (query, g) rows, so a K/V tile serves the G
// heads of its KV head; Q K^T and P V run as mma.sync m16n8k16 with fp32
// accumulators, the online softmax stays in registers, P is split into
// bf16 hi + lo (a single bf16 P makes ~40 % of the outputs differ from
// the fp32 softmax, the split under 1 %), and 64-key K/V tiles stream
// through a two-stage cp.async ring. q, k and v are read in the model's
// (B, S, H, Dh) layout through their strides (16-byte aligned rows: the
// wrapper checks). Key tiles wholly past the causal diagonal or wholly
// before the window of the block's rows are skipped, and the blocks with
// the most keys launch first. fp32 inputs keep the FMA kernel: bf16 tensor
// cores cannot meet the fp32 gate (rounding q to bf16 alone is ~2e-3).
//
// Left for a later PR: wgmma from shared-memory descriptors, TMA loads
// completing on mbarriers, a producer warp, a persistent grid.
#include "attention_mma.cuh"

namespace {

using namespace repro;

// ---------------------------------------------------------------------------
// fp32: one thread block per (64-query tile, query head, batch row); q
// staged pre-scaled in shared memory, K/V tiles in shared memory (rows
// padded by one float), a 4 x 4 block of scores per thread as fp32 FMAs,
// the online softmax one warp per row on the score tile in shared memory,
// a 4 x Dh/16 block of the accumulator per thread in registers. Masked
// scores are -inf with an explicit zero probability and a zero rescale
// for a row that has seen no key yet; a ragged last query or key tile is
// masked, not padded (the Pallas kernel asserts Sq % block_q == 0).
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;   // 16 x 16 threads
constexpr int kTileQ = 64;
constexpr int kTileK = 64;

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kTileQ * (DH + 1) + (size_t)kTileK * (DH + 1) +
                          (size_t)kTileK * DH + (size_t)kTileQ * kTileK +
                          3 * (size_t)kTileQ);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) flash_kernel(
    const T* __restrict__ q,   // (B, Sq, H, Dh) through strides
    const T* __restrict__ k,   // (B, Skv, Kh, Dh) through strides
    const T* __restrict__ v,   // (B, Skv, Kh, Dh) through strides
    T* __restrict__ out,       // (B, Sq, H, Dh), contiguous
    int sq, int skv, int n_heads, int group, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, int causal, int window,
    float scale) {
  constexpr int kStride = DH + 1;
  constexpr int kCols = DH / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                     // (kTileQ, DH + 1), pre-scaled
  float* k_s = q_s + kTileQ * kStride;   // (kTileK, DH + 1)
  float* v_s = k_s + kTileK * kStride;   // (kTileK, DH)
  float* p_s = v_s + kTileK * DH;        // (kTileQ, kTileK)
  float* m_s = p_s + kTileQ * kTileK;    // (kTileQ,)
  float* l_s = m_s + kTileQ;             // (kTileQ,)
  float* a_s = l_s + kTileQ;             // (kTileQ,)

  const int q0 = blockIdx.x * kTileQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int nq = min(kTileQ, sq - q0);
  const int first_q = skv - sq + q0;   // global position of query row 0

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + (h / group) * k_sh;
  const T* vb = v + b * v_sb + (h / group) * v_sh;

  for (int idx = tid; idx < kTileQ * DH; idx += kThreads) {
    const int r = idx / DH, d = idx - r * DH;
    q_s[r * kStride + d] =
        r < nq ? to_f32(qb[(q0 + r) * q_ss + d]) * scale : 0.f;
  }
  for (int r = tid; r < kTileQ; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  // keys any row of this tile can see: [k_begin, k_end)
  int k_begin = 0, k_end = skv;
  if (causal) {
    k_end = min(skv, first_q + nq);
    if (window > 0) k_begin = max(0, first_q - window + 1);
  }
  k_begin = k_begin / kTileK * kTileK;
  __syncthreads();

  for (int k0 = k_begin; k0 < k_end; k0 += kTileK) {
    const int nk = min(kTileK, skv - k0);
    for (int idx = tid; idx < kTileK * DH; idx += kThreads) {
      const int t = idx / DH, d = idx - t * DH;
      float kv = 0.f, vv = 0.f;
      if (t < nk) {
        kv = to_f32(kb[(k0 + t) * k_ss + d]);
        vv = to_f32(vb[(k0 + t) * v_ss + d]);
      }
      k_s[t * kStride + d] = kv;
      v_s[t * DH + d] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty + 16 * i) * kStride + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * kStride + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qpos = first_q + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = tx + 16 * j;
        const int kpos = k0 + t;
        bool visible = r < nq && t < nk;
        if (causal)
          visible = visible && kpos <= qpos &&
                    (window <= 0 || kpos > qpos - window);
        p_s[r * kTileK + t] = visible ? s[i][j] : -INFINITY;
      }
    }
    __syncthreads();

    online_softmax_rows(p_s, m_s, l_s, a_s, kTileQ, kTileK, kThreads);
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= a;
    }
    for (int t = 0; t < nk; ++t) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * kTileK + t];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float vv = v_s[t * DH + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= nq) continue;
    const float l = l_s[r];
    T* orow = out + (((size_t)b * sq + q0 + r) * n_heads + h) * DH;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      orow[tx + 16 * j] = from_f32<T>(l > 0.f ? acc[i][j] / l : 0.f);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int sq, int skv, int n_heads, int n_kv_heads,
           const long long* strides, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  auto kernel = flash_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + kTileQ - 1) / kTileQ, n_heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, skv, n_heads,
      n_heads / n_kv_heads, strides[0], strides[1], strides[2], strides[3],
      strides[4], strides[5], strides[6], strides[7], strides[8], causal,
      window, scale);
  return (int)cudaGetLastError();
}

int launch_fp32(const void* q, const void* k, const void* v, void* out,
                int batch, int sq, int skv, int n_heads, int n_kv_heads,
                int d_head, const long long* strides, int causal, int window,
                float scale, cudaStream_t stream) {
  if (d_head == 64)
    return launch<float, 64>(q, k, v, out, batch, sq, skv, n_heads,
                             n_kv_heads, strides, causal, window, scale,
                             stream);
  if (d_head == 128)
    return launch<float, 128>(q, k, v, out, batch, sq, skv, n_heads,
                              n_kv_heads, strides, causal, window, scale,
                              stream);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core core (attention_mma.cuh)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

template <int DH>
struct FlashProblem {
  static constexpr bool scaled = false;
  const bf16* qb;  // q at (b, 0, kh * G, 0)
  const bf16* kb;  // k at (b, 0, kh, 0)
  const bf16* vb;
  bf16* ob;        // out at (b, 0, kh * G, 0)
  long long q_ss, q_sh, k_ss, v_ss, o_ss;
  int n_rows, group, pos_first, causal, window, t_begin, t_end, skv;

  __device__ const bf16* q_row(int i, int g) const {
    return qb + i * q_ss + g * q_sh;
  }
  __device__ bf16* out_row(int i, int g) const {
    return ob + i * o_ss + g * DH;
  }
  __device__ int kpos0(int t) const { return t * mma::kKeys; }
  __device__ int nvalid(int t) const {
    return min(mma::kKeys, skv - t * mma::kKeys);
  }
  __device__ bool codes(int) const { return false; }
  __device__ void issue(int t, const mma::Stage<DH>& sm, int s) const {
    const long long k0 = (long long)t * mma::kKeys;
    const int n = nvalid(t);
    mma::stage_rows<DH>(sm.k(s), mma::Layout<DH>::kStride, n,
                        [&](int r) { return kb + (k0 + r) * k_ss; });
    mma::stage_rows<DH>(sm.v(s), mma::Layout<DH>::kStride, n,
                        [&](int r) { return vb + (k0 + r) * v_ss; });
  }
};

template <int DH>
__global__ void __launch_bounds__(mma::kThreads, mma::kMinBlocks) flash_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out, int sq, int skv,
    int n_heads, int group, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, int causal, int window, float scale) {
  extern __shared__ __align__(16) unsigned char mma_smem[];
  // the row tiles with the most keys (the last, under `causal`) first
  const int tile = gridDim.x - 1 - blockIdx.x;
  const int kh = blockIdx.y, b = blockIdx.z;
  FlashProblem<DH> p;
  p.qb = q + b * q_sb + (long long)kh * group * q_sh;
  p.kb = k + b * k_sb + kh * k_sh;
  p.vb = v + b * v_sb + kh * v_sh;
  p.ob = out + ((long long)b * sq * n_heads + (long long)kh * group) * DH;
  p.q_ss = q_ss;
  p.q_sh = q_sh;
  p.k_ss = k_ss;
  p.v_ss = v_ss;
  p.o_ss = (long long)n_heads * DH;
  p.n_rows = sq * group;
  p.group = group;
  p.pos_first = skv - sq;
  p.causal = causal;
  p.window = causal ? window : -1;
  p.skv = skv;
  const int row_begin = tile * mma::kRows;
  const int first_q = p.pos_first + row_begin / group;
  const int last_q =
      p.pos_first + min(p.n_rows - 1, row_begin + mma::kRows - 1) / group;
  const int n_tiles = (skv + mma::kKeys - 1) / mma::kKeys;
  p.t_begin = 0;
  p.t_end = n_tiles;
  if (causal) {
    p.t_end = min(n_tiles, last_q / mma::kKeys + 1);
    if (p.window > 0) p.t_begin = max(0, first_q - p.window + 1) / mma::kKeys;
  }
  mma::attend<DH>(p, mma::Stage<DH>(mma_smem), row_begin, scale);
}

template <int DH>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               int batch, int sq, int skv, int n_heads, int n_kv_heads,
               const long long* st, int causal, int window, float scale,
               cudaStream_t stream) {
  constexpr size_t smem = mma::Layout<DH>::bytes(false);
  auto kernel = flash_mma_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int group = n_heads / n_kv_heads;
  dim3 grid((sq * group + mma::kRows - 1) / mma::kRows, n_kv_heads, batch);
  kernel<<<grid, mma::kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), sq, skv, n_heads,
      group, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      causal, window, scale);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int batch, int sq, int skv, int n_heads, int n_kv_heads,
                int d_head, const long long* strides, int causal, int window,
                float scale, cudaStream_t stream) {
  if (d_head == 64)
    return launch_mma<64>(q, k, v, out, batch, sq, skv, n_heads, n_kv_heads,
                          strides, causal, window, scale, stream);
  if (d_head == 128)
    return launch_mma<128>(q, k, v, out, batch, sq, skv, n_heads,
                           n_kv_heads, strides, causal, window, scale,
                           stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// strides: q, k and v strides in elements over (batch, seq, head), nine
// in all; the last dim of each has stride 1. fp32 inputs take the FMA
// kernel, bf16 inputs the tensor-core kernel (16-byte aligned rows).
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* out, int batch,
    int sq, int skv, int n_heads, int n_kv_heads, int d_head,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, int causal, int window, float scale, int dtype,
    void* stream) {
  const long long strides[9] = {q_sb, q_ss, q_sh, k_sb, k_ss,
                                k_sh, v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return launch_fp32(q, k, v, out, batch, sq, skv, n_heads, n_kv_heads,
                       d_head, strides, causal, window, scale, s);
  if (dtype == repro::kBFloat16)
    return launch_bf16(q, k, v, out, batch, sq, skv, n_heads, n_kv_heads,
                       d_head, strides, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
