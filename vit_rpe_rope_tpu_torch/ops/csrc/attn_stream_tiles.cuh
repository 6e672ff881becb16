// Pieces shared by the streaming kernels that walk one axis in cp.async
// double-buffered tiles of rounded bf16 operands (attn_stream_fwd.cu and the
// separate passes of attn_stream_bwd.cu): the CTA shape, the ring of
// shared-memory slots, the 16-byte staging of scratch rows and of a padded
// f32 bias tile, a head's rope tables, the logit of one mma fragment
// element and the rotation and rounding of a row's operands.

#pragma once

#include "attn_dense.cuh"
#include "attn_stream.cuh"

namespace attn {

constexpr int RING_WARPS = 8;
constexpr int RING_THREADS = RING_WARPS * 32;
constexpr int OWN_ROWS = 16 * RING_WARPS;  // a CTA's query rows (or keys)
constexpr int STEP = 64;                   // rows of the other axis per staged tile

// Shared memory of one CTA: a ring of two slots, each holding one step's two
// bf16 [64, D] tiles, with a bias its f32 bias tile [BIAS_ROWS, BIAS_LD] and
// STATS floats; and the CTA's own OWN_TILES bf16 [128, D] tiles. HOLD: the
// own tiles are read into registers once, so they share the ring's bytes;
// else they stay, after the ring.
template <int D, int BIAS_ROWS, int BIAS_LD, int STATS, bool HOLD, int OWN_TILES = 2>
struct Ring {
  static constexpr int LD = dense::pitch<D>();
  static constexpr size_t TILE = size_t(STEP) * LD * 2;
  static constexpr size_t BIAS_OFF = 2 * TILE;
  static constexpr size_t STATS_OFF = BIAS_OFF + size_t(BIAS_ROWS) * BIAS_LD * 4;
  static constexpr size_t SLOT = STATS_OFF + size_t(STATS) * 4;
  static constexpr size_t OWN = size_t(OWN_TILES) * OWN_ROWS * LD * 2;
  static constexpr size_t OWN_OFF = HOLD ? 0 : 2 * SLOT;
  static constexpr size_t BYTES = HOLD ? (OWN > 2 * SLOT ? OWN : 2 * SLOT) : 2 * SLOT + OWN;
  static_assert(TILE % 128 == 0 && BIAS_OFF % 16 == 0 && STATS_OFF % 16 == 0 &&
                    SLOT % 128 == 0 && BYTES <= 232448,
                "ring slots must stay aligned and within shared memory");
};

// Whether the A operands of a CTA's own rows stay in registers: up to D =
// 64, but for the many-term polynomial at D <= 32, whose dq and forward
// kernels, given 128 registers by ptxas, spill 8 bytes with them held and
// none without.
template <int D, int PE>
__host__ __device__ constexpr bool hold() {
  return D <= 64 && !(PE == PE_POLY_MORE && D <= 32);
}

// rows x D bf16 rows of contiguous scratch into a tile of pitch LD.
template <int D>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int rows) {
  constexpr int LD = dense::pitch<D>(), CH = D / 8;
  for (int i = threadIdx.x; i < rows * CH; i += RING_THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    dense::cp_async16(dst + r * LD + c, src + (long long)r * D + c, true);
  }
}

// The bias tile rows [r0, r0 + ROWS) x columns [c0, c0 + COLS) of one head
// (rows of `pitch` floats) into dst (pitch LDB); pieces past N rows or past
// the pitch are zero.
template <int ROWS, int COLS, int LDB>
__device__ __forceinline__ void stage_bias(float* dst, const float* bias_h, int pitch,
                                           int n_tokens, int r0, int c0) {
  constexpr int CH = COLS / 4;
  for (int i = threadIdx.x; i < ROWS * CH; i += RING_THREADS) {
    const int r = i / CH, c = (i % CH) * 4;
    const int row = r0 + r, col = c0 + c;
    const bool ok = row < n_tokens && col < pitch;
    dense::cp_async16(dst + r * LDB + c, ok ? bias_h + (long long)row * pitch + col : bias_h, ok);
  }
}

// Head h's [N, D/2] rope table (one table for all heads when cos_heads is 1),
// or null.
template <int D, typename P>
__device__ __forceinline__ const float* head_table(const float* t, const P& p, int h) {
  return t != nullptr ? t + (long long)(p.cos_heads == 1 ? 0 : h) * p.N * (D / 2) : nullptr;
}

// The logit of one fragment element: scale * acc plus the bias (given, when
// materialized; generated at global (row0 + qi, col0 + kj) otherwise, from
// the patch coordinates pq / pk of the two tokens), keys at local indices
// >= n_tokens masked; MASK = false: a key that no mask reaches, without the
// tests (chunk_logit).
template <int PE, bool MASK = true>
__device__ __forceinline__ float frag_logit(float acc, int qi, int kj, int n_tokens,
                                            float scale, const HeadBias& hb, float bias,
                                            Patch pq, Patch pk) {
  if (PE == PE_BIAS)
    return !MASK || kj < n_tokens ? __fadd_rn(__fmul_rn(acc, scale), bias) : NEG_INF;
  float dist;
  bool counts;
  return chunk_logit<PE == PE_BIAS ? PE_NONE : PE, MASK>(acc, qi, kj, n_tokens, scale, hb, pq,
                                                        pk, dist, counts);
}

// Columns [c, c + 4) and [c + D/2, c + D/2 + 4) of one row (src, cos_row and
// sin_row point at column c; the tables are null without rope), zero where
// !valid: rotated with rotate4's op-by-op f32 rounding where tables are
// given, rounded to bf16 into dst (at column c). The one rounding of q, k
// and v that the prologues and the forward's own q tile share, bit for bit.
template <int D, typename T>
__device__ __forceinline__ void round_row(__nv_bfloat16* dst, const T* src,
                                          const float* cos_row, const float* sin_row,
                                          bool valid) {
  using namespace dense;
  constexpr int H2 = D / 2;
  float x1[4] = {}, x2[4] = {}, cs[4] = {1.f, 1.f, 1.f, 1.f}, sn[4] = {};
  if (valid) {
    load4(src, x1);
    load4(src + H2, x2);
    if (cos_row != nullptr) {
      load4(cos_row, cs);
      load4(sin_row, sn);
    }
  }
  if (cos_row != nullptr) rotate4(x1, x2, cs, sn);
  put4(dst, x1);
  put4(dst + H2, x2);
}

}  // namespace attn
