// Shared tensor-core attention core of the bf16 flash and paged prefill
// kernels (sm_90a). Device code only; each kernel keeps its own entry
// point and supplies a Problem (below) that says where its query rows
// and its K/V tiles come from.
//
// One thread block of four warps takes one KV head and 64 packed
// (query position, g) rows, r = i * G + g, so the G query heads of a KV
// head share every K/V tile; each warp owns one m16 tile of 16 rows. A
// row's query position is pos_first + R / G (R the packed index), so
// neither G nor Dh need be a power of two, and the causal limit is per
// row even where a position's G rows straddle two warps.
//
// Per 64-key tile, with fp32 state in registers (FlashAttention-2):
//   S = Q K^T   mma.sync m16n8k16 bf16 -> fp32; Q fragments loaded once by
//               ldmatrix, K fragments by ldmatrix from the staged tile;
//   scores      S * scale * log2(e) in fp32 (q is never pre-scaled in
//               bf16), times a per-column K scale for int8 pool blocks;
//   mask        -inf with an explicit zero probability; a ragged last
//               key tile is masked, not padded;
//   softmax     online, on the C fragments: row max and sum over the lane
//               quad by __shfl_xor_sync; a row that has seen no key keeps
//               m = -inf and gets rescale factor 0 and output 0, not NaN;
//   O += P V    P (times a per-column V scale for int8 pool blocks) split
//               into P_hi = bf16(P) and P_lo = bf16(P - P_hi), packed
//               straight from the S fragments into A fragments; two
//               mma.sync against the same V fragments (ldmatrix.trans),
//               accumulated in fp32. l sums the fp32 P. A single bf16 P
//               makes ~40 % of the bf16 outputs differ from the fp32
//               softmax (tests/test_torch_attention_numerics.py); the
//               split keeps it under 1 % for 1.5x the tensor-core work.
//
// K/V tiles of 64 keys are staged by 16-byte cp.async into a two-stage
// ring (rows padded by 16 bytes, so ldmatrix is conflict-free): tile t+1
// loads while tile t computes, one __syncthreads per tile. Pool blocks of
// int8 codes are staged as codes (half the bytes) into a one-stage code
// buffer and widened to bf16 (exact: |code| <= 127) into the ring, behind
// a second barrier; their (block, kv_head) scales ride along by 4-byte
// cp.async and stay out of the operands (scores and P columns above), so
// the result is the plain version's fp32 `code * scale`.
#pragma once

#include "common.cuh"

namespace repro {
namespace mma {

constexpr int kThreads = 128;  // four warps, one m16 row tile each
// blocks an SM should hold (the shared memory of two fits at Dh = 128);
// stated in __launch_bounds__, it also keeps ptxas from capping a kernel
// at 128 registers and spilling (prefill at Dh = 64 did)
constexpr int kMinBlocks = 2;
constexpr int kRows = 64;      // packed (query, g) rows per block
constexpr int kKeys = 64;      // keys per K/V tile
constexpr int kNT = kKeys / 8; // n8 tiles of one score row tile
constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
struct Layout {
  static_assert(DH % 16 == 0 && DH <= 128, "Dh: a multiple of 16, <= 128");
  static constexpr int kStride = DH + 8;         // bf16 row: Dh + 16 bytes
  static constexpr int kCodeStride = DH + 16;    // int8 row: Dh + 16 bytes
  static constexpr int kChunks = DH / 8;         // 16-byte chunks, bf16 row
  static constexpr int kCodeChunks = DH / 16;    // 16-byte chunks, int8 row
  static constexpr int kTile = kKeys * kStride;  // bf16 elements, K or V
  static constexpr size_t kQBytes = (size_t)kRows * kStride * 2;
  static constexpr size_t kRingBytes = 2 * 2 * (size_t)kTile * 2;
  static constexpr size_t kScaleBytes = 2 * 2 * kNT * sizeof(float);
  static constexpr size_t kCodeBytes = 2 * (size_t)kKeys * kCodeStride;
  static constexpr size_t bytes(bool codes) {
    return kQBytes + kRingBytes + kScaleBytes + (codes ? kCodeBytes : 0);
  }
};

// The staging buffers of one block, carved from dynamic shared memory.
template <int DH>
struct Stage {
  __nv_bfloat16* q;       // (kRows, kStride); the output tile at the end
  __nv_bfloat16* kv;      // [stage][K, V] (kKeys, kStride)
  float* scale;           // [stage][K, V][kNT]: column scales of a tile
  int8_t* codes;          // [K, V] (kKeys, kCodeStride), int8 pools only

  __device__ __forceinline__ explicit Stage(unsigned char* smem) {
    using L = Layout<DH>;
    q = reinterpret_cast<__nv_bfloat16*>(smem);
    kv = reinterpret_cast<__nv_bfloat16*>(smem + L::kQBytes);
    scale = reinterpret_cast<float*>(smem + L::kQBytes + L::kRingBytes);
    codes = reinterpret_cast<int8_t*>(smem + L::kQBytes + L::kRingBytes +
                                      L::kScaleBytes);
  }
  __device__ __forceinline__ __nv_bfloat16* k(int s) const {
    return kv + (2 * s) * Layout<DH>::kTile;
  }
  __device__ __forceinline__ __nv_bfloat16* v(int s) const {
    return kv + (2 * s + 1) * Layout<DH>::kTile;
  }
  __device__ __forceinline__ float* k_scale(int s) const {
    return scale + (2 * s) * kNT;
  }
  __device__ __forceinline__ float* v_scale(int s) const {
    return scale + (2 * s + 1) * kNT;
  }
  __device__ __forceinline__ int8_t* k_codes() const { return codes; }
  __device__ __forceinline__ int8_t* v_codes() const {
    return codes + kKeys * Layout<DH>::kCodeStride;
  }
};

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; with valid = false the 16 bytes are
// zero-filled and nothing is read (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(__cvta_generic_to_global(src)), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as bf16x2, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<uint32_t*>(&h);
}

// x as bf16 hi + lo: hi = bf16(x), lo = bf16(x - hi) (x - hi is exact in
// fp32), so hi + lo carries ~16 significant bits of x
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  __nv_bfloat162 l = __floats2bfloat162_rn(x0 - __low2float(h),
                                           x1 - __high2float(h));
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

// 16 int8 codes -> 16 bf16 (exact), one 16-byte load and two stores
__device__ __forceinline__ void widen16(__nv_bfloat16* dst,
                                        const int8_t* src) {
  const int4 c = *reinterpret_cast<const int4*>(src);
  const int8_t* b = reinterpret_cast<const int8_t*>(&c);
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = pack_bf16((float)b[2 * i], (float)b[2 * i + 1]);
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(w[0], w[1], w[2], w[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

// Stage the rows [0, n) of a 64-row tile: row r's Dh values start at
// row_ptr(r), 16-byte aligned; rows past n are zero-filled.
template <int DH, typename T, typename RowPtr>
__device__ __forceinline__ void stage_rows(T* dst, int stride, int n,
                                           RowPtr row_ptr) {
  constexpr int kChunks = DH * (int)sizeof(T) / 16;
  constexpr int kPer = 16 / (int)sizeof(T);
  for (int idx = threadIdx.x; idx < kKeys * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx - r * kChunks;
    const bool valid = r < n;
    const T* src = row_ptr(valid ? r : 0) + c * kPer;
    cp_async16(dst + r * stride + c * kPer, src, valid);
  }
}

// ---------------------------------------------------------------------------
// The core
// ---------------------------------------------------------------------------

// Problem interface (one object per block, built by the kernel):
//   int n_rows;            packed rows of this (batch row, kv head): Sq * G
//   int group;             G
//   int pos_first;         position of query index 0
//   int causal, window;    mask rules (window <= 0: none)
//   int t_begin, t_end;    the K/V tiles this block visits
//   bool scaled;           tiles carry column scales (int8 / scaled pools)
//   const bf16* q_row(int i, int g);   bf16* out_row(int i, int g);
//   int kpos0(int t), nvalid(int t);   position of a tile's key 0 and
//                                       its number of real keys
//   bool codes(int t);                 the tile arrives as int8 codes
//   void issue(int t, const Stage&, int s);
//       cp.async the tile into ring stage s (or, for codes, into the
//       code buffer) and its column scales into the stage's scale rows
template <int DH, typename Problem>
__device__ __forceinline__ void attend(const Problem& p, const Stage<DH>& sm,
                                       int row_begin, float scale) {
  using L = Layout<DH>;
  constexpr int S = L::kStride;
  constexpr int KD = DH / 16;  // k16 steps of Q K^T
  constexpr int ND = DH / 8;   // n8 tiles of the output
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;  // fragment row, quad lane
  const float scale_log2 = scale * kLog2e;

  // this thread's two rows (gr, gr + 8 of the warp's tile) and the
  // position range of the warp's real rows
  const int wr0 = row_begin + warp * 16;
  int qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    qpos[h] = p.pos_first + (wr0 + gr + 8 * h) / p.group;
  const int w_first = p.pos_first + wr0 / p.group;
  const int w_last =
      p.pos_first + (min(wr0 + 15, max(p.n_rows - 1, wr0))) / p.group;

  // Q rows (zero past the last) as its own group, then the first tile
  for (int idx = tid; idx < kRows * L::kChunks; idx += kThreads) {
    const int r = idx / L::kChunks, c = idx - r * L::kChunks;
    const int R = row_begin + r;
    const bool valid = R < p.n_rows;
    const int i = valid ? R / p.group : 0;
    cp_async16(sm.q + r * S + c * 8, p.q_row(i, valid ? R - i * p.group : 0) + c * 8,
               valid);
  }
  cp_async_commit();
  if (p.t_begin < p.t_end) p.issue(p.t_begin, sm, 0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    ldmatrix_x4(qf[kk], smem_u32(sm.q + (warp * 16 + (lane & 15)) * S +
                                 kk * 16 + (lane >> 4) * 8));

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  // per-lane ldmatrix offsets (elements) inside a K or V tile
  const int k_off = ((lane & 7) + ((lane >> 4) << 3)) * S + ((lane >> 3) & 1) * 8;
  const int v_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * S + (lane >> 4) * 8;

  for (int t = p.t_begin; t < p.t_end; ++t) {
    const int st = (t - p.t_begin) & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    if (p.codes(t)) {
      for (int idx = tid; idx < 2 * kKeys * L::kCodeChunks; idx += kThreads) {
        const int kv = idx / (kKeys * L::kCodeChunks);
        const int rc = idx - kv * (kKeys * L::kCodeChunks);
        const int r = rc / L::kCodeChunks, c = rc - r * L::kCodeChunks;
        widen16((kv ? sm.v(st) : sm.k(st)) + r * S + c * 16,
                (kv ? sm.v_codes() : sm.k_codes()) + r * L::kCodeStride +
                    c * 16);
      }
      __syncthreads();  // widened tile visible; the code buffer is free
    }
    if (t + 1 < p.t_end) p.issue(t + 1, sm, st ^ 1);
    cp_async_commit();

    // S = Q K^T on this warp's 16 rows x 64 keys
    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const uint32_t kbase = smem_u32(sm.k(st) + k_off);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, kbase + (np * 16 * S + kk * 16) * 2);
        mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }

    // scale (times the K column scales) and mask
    const int kpos0 = p.kpos0(t), nvalid = p.nvalid(t);
    const float* ksc = sm.k_scale(st);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const float f = p.scaled ? scale_log2 * ksc[j] : scale_log2;
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= f;
    }
    const bool need_mask =
        nvalid < kKeys || (p.causal && kpos0 + kKeys - 1 > w_first) ||
        (p.causal && p.window > 0 && kpos0 <= w_last - p.window);
    if (need_mask) {
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * tq + (e & 1);
          const int kp = kpos0 + c, qp = qpos[e >> 1];
          bool vis = c < nvalid;
          if (p.causal)
            vis = vis && kp <= qp && (p.window <= 0 || kp > qp - p.window);
          if (!vis) s[j][e] = -INFINITY;
        }
    }

    // online softmax on the fragments: rows gr (e = 0, 1) and gr + 8
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      const float alpha = m[h] == -INFINITY ? 0.f : exp2f(m[h] - m_new);
      m[h] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          const float pe = s[j][e] == -INFINITY ? 0.f : exp2f(s[j][e] - m_new);
          s[j][e] = pe;
          sum += pe;
        }
      l[h] = l[h] * alpha + sum;  // this lane's partial row sum
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][2 * h] *= alpha;
        o[n][2 * h + 1] *= alpha;
      }
    }
    if (p.scaled) {
      const float* vsc = sm.v_scale(st);
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= vsc[j];
    }

    // O += (P_hi + P_lo) V, k16 steps of 16 keys
    const uint32_t vbase = smem_u32(sm.v(st) + v_off);
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vbase + (kk * 16 * S + dp * 16) * 2);
        mma_bf16(o[2 * dp], hi, b[0], b[1]);
        mma_bf16(o[2 * dp], lo, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], hi, b[2], b[3]);
        mma_bf16(o[2 * dp + 1], lo, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();

  // O / l into this warp's 16 rows of the Q tile, then 16-byte stores
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    inv[h] = lt > 0.f ? 1.f / lt : 0.f;
  }
  __syncwarp();
  __nv_bfloat16* ot = sm.q + warp * 16 * S;
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(ot + (gr + 8 * h) * S + 8 * n + 2 * tq) =
          pack_bf16(o[n][2 * h] * inv[h], o[n][2 * h + 1] * inv[h]);
  __syncwarp();
  for (int idx = lane; idx < 16 * L::kChunks; idx += 32) {
    const int r = idx / L::kChunks, c = idx - r * L::kChunks;
    const int R = wr0 + r;
    if (R >= p.n_rows) continue;
    const int i = R / p.group;
    *reinterpret_cast<uint4*>(p.out_row(i, R - i * p.group) + c * 8) =
        *reinterpret_cast<const uint4*>(ot + r * S + c * 8);
  }
}

}  // namespace mma
}  // namespace repro
