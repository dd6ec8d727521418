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
// Design. One thread block per (64-query tile, query head, batch row);
// the KV head is h / G, so G = H / Kh needs no power-of-two tile. The
// block reads q, k and v in the model's (B, S, H, Dh) layout through
// their strides (the reference transposes to (B, H, S, Dh) first; the
// port does not copy). Its query tile is staged once in shared memory,
// pre-scaled, and one loop over 64-key tiles takes the place of the
// Pallas sequential KV grid axis, skipping tiles wholly past the causal
// diagonal or wholly before the window, as the reference does. Each tile
// stages K and V in shared memory (rows padded by one float against bank
// conflicts); each of the 256 threads computes a 4 x 4 block of scores
// (two fp32 loads per FMA pair instead of two per FMA), one warp per row
// runs the online softmax on the score tile in shared memory, and each
// thread keeps a 4 x Dh/16 block of the output accumulator in registers.
// Masked scores are -inf with an explicit zero probability and a zero
// rescale for a row that has seen no key yet, so a row fully masked
// inside one tile gives no NaN (the reference's -1e30 hides that case).
// A ragged last query or key tile is masked, not padded (the Pallas
// kernel asserts Sq % block_q == 0).
//
// Bound on the H100: at llama3.2-3b prefill width (B=2, S=2048, H=24,
// Kh=8, Dh=128, bf16, causal) the call does ~52 GFLOP over ~67 MB, so it
// is bound by operations: ~52 us at the bf16 tensor-core peak. This
// first kernel does its products as fp32 FMAs on the CUDA cores, fed
// from shared memory, whose rate is its real limit; moving QK^T and PV
// onto wgmma with TMA-fed tiles is the later optimisation.
#include "common.cuh"

namespace {

using namespace repro;

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

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, void* out,
              int batch, int sq, int skv, int n_heads, int n_kv_heads,
              int d_head, const long long* strides, int causal, int window,
              float scale, cudaStream_t stream) {
  if (d_head == 64)
    return launch<T, 64>(q, k, v, out, batch, sq, skv, n_heads, n_kv_heads,
                         strides, causal, window, scale, stream);
  if (d_head == 128)
    return launch<T, 128>(q, k, v, out, batch, sq, skv, n_heads, n_kv_heads,
                          strides, causal, window, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// strides: q, k and v strides in elements over (batch, seq, head), nine
// in all; the last dim of each has stride 1.
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
    return launch_dh<float>(q, k, v, out, batch, sq, skv, n_heads,
                            n_kv_heads, d_head, strides, causal, window,
                            scale, s);
  if (dtype == repro::kBFloat16)
    return launch_dh<__nv_bfloat16>(q, k, v, out, batch, sq, skv, n_heads,
                                    n_kv_heads, d_head, strides, causal,
                                    window, scale, s);
  return (int)cudaErrorInvalidValue;
}
