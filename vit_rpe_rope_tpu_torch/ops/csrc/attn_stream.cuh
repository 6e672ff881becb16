// Pieces shared by the streaming attention kernels (attn_stream_fwd.cu,
// attn_stream_bwd.cu, attn_stream_bwd_fused.cu): where a logit's bias comes
// from (a materialized [H, N, N] tensor, or generated per element from the
// polynomial coefficients or the relative table), the key mask in global
// coordinates, the backward kernels' shared-memory layout, and the integer
// arguments of the C entry points.

#pragma once

#include "attn_common.cuh"

namespace attn {

constexpr int MAX_POLY_TERMS = 8;  // degree + 1 of the polynomial bias

// Integer arguments of attn_stream_fwd / attn_stream_bwd_*, in this order.
// The last two are read by attn_stream_bwd_fused.cu only: its keys may be a
// chunk of another length than the queries.
enum Dim {
  DIM_B, DIM_H, DIM_N, DIM_D, DIM_IS_BF16, DIM_COS_HEADS,
  DIM_POLY_TERMS,  // degree + 1, or 0 without a polynomial bias
  DIM_POLY_GRID,   // patch-grid side of the polynomial bias
  DIM_REL_ELL,     // L of the [H, 2L-1] relative table, or 0 without one
  DIM_ROW0,        // global index of this call's first query row
  DIM_COL0,        // global index of this call's first key
  DIM_N_VALID,     // keys at global indices >= n_valid are masked
  DIM_GROUPS,      // backward: batch groups of the dbias pass
  DIM_NK,          // keys of this call (DIM_N counts its query rows)
  DIM_KV_VALID,    // keys at local indices >= kv_valid are masked
  DIM_COUNT
};

// The bias of all heads, as the wrapper hands it over. At most one of bias,
// coeff and table is set.
struct BiasArgs {
  const float* bias;   // [H, N, N]
  const float* coeff;  // [H, poly_terms]
  const float* table;  // [H, 2 * rel_ell - 1]
  int poly_terms, poly_grid, rel_ell;
  int row0, col0, n_valid;
};

// One head's bias, resolved once per CTA.
struct HeadBias {
  const float* bias_h;
  const float* table_h;
  float c[MAX_POLY_TERMS];
  int terms, grid, ell, row0, col0, n_valid;
};

__device__ __forceinline__ HeadBias head_bias(const BiasArgs& a, int h, int n_tokens) {
  HeadBias hb;
  hb.bias_h = a.bias != nullptr ? a.bias + (long long)h * n_tokens * n_tokens : nullptr;
  hb.table_h = a.table != nullptr ? a.table + (long long)h * (2 * a.rel_ell - 1) : nullptr;
  hb.terms = a.coeff != nullptr ? a.poly_terms : 0;
#pragma unroll
  for (int i = 0; i < MAX_POLY_TERMS; ++i)
    hb.c[i] = i < hb.terms ? a.coeff[h * a.poly_terms + i] : 0.f;
  hb.grid = a.poly_grid;
  hb.ell = a.rel_ell;
  hb.row0 = a.row0;
  hb.col0 = a.col0;
  hb.n_valid = a.n_valid;
  return hb;
}

// A token's patch coordinates ((t-1) % grid, (t-1) / grid). The cls token
// (t = 0) gets (-1, 0), from which next_patch steps to token 1's (0, 0).
struct Patch {
  int x, y;
};

__device__ __forceinline__ Patch patch_of(int token, int grid) {
  Patch p;
  p.y = (token - 1) / grid;
  p.x = (token - 1) - p.y * grid;
  return p;
}

// The next token's coordinates, without a division.
__device__ __forceinline__ void next_patch(Patch& p, int grid) {
  if (++p.x == grid) {
    p.x = 0;
    ++p.y;
  }
}

// The polynomial bias between two patch tokens: sum_k c[k] * dist^k over the
// L1 distance of their patch coordinates. Also hands back that distance.
__device__ __forceinline__ float poly_bias(const HeadBias& hb, Patch q, Patch k, float& dist) {
  dist = float(abs(q.x - k.x) + abs(q.y - k.y));
  float bias = 0.f, pw = 1.f;
#pragma unroll
  for (int i = 0; i < MAX_POLY_TERMS; ++i) {
    if (i < hb.terms) bias = __fadd_rn(bias, __fmul_rn(hb.c[i], pw));
    pw = __fmul_rn(pw, dist);
  }
  return bias;
}

// The relative bias of global (row, col): table[row - col + L - 1], clamped
// to the table's ends.
__device__ __forceinline__ float rel_bias(const HeadBias& hb, int row, int col) {
  return hb.table_h[min(max(row - col + hb.ell - 1, 0), 2 * hb.ell - 2)];
}

// Scaled, biased, masked logit of local query row qi against local key kj.
// The polynomial bias is zero on the cls row and column and at padded
// indices. Both generated biases act on global indices (row0 + qi, col0 + kj).
__device__ __forceinline__ float stream_logit(float acc, int qi, int kj, int n_tokens,
                                              float scale, const HeadBias& hb) {
  const int row = hb.row0 + qi, col = hb.col0 + kj;
  if (kj >= n_tokens || col >= hb.n_valid) return NEG_INF;
  float s = __fmul_rn(acc, scale);
  if (hb.bias_h != nullptr) {
    if (qi < n_tokens) s = __fadd_rn(s, hb.bias_h[(long long)qi * n_tokens + kj]);
  } else if (hb.terms > 0) {
    float dist;
    if (row > 0 && col > 0 && row < hb.n_valid)
      s = __fadd_rn(s, poly_bias(hb, patch_of(row, hb.grid), patch_of(col, hb.grid), dist));
  } else if (hb.table_h != nullptr) {
    s = __fadd_rn(s, rel_bias(hb, row, col));
  }
  return s;
}

// Which generated bias a kernel of attn_stream_bwd_fused.cu is compiled for.
enum Pe { PE_NONE, PE_POLY, PE_REL };

// stream_logit for a key chunk of its own length (n_k keys, already cut to
// the chunk's valid width) and no materialized bias. Also says whether the
// element counts towards the bias parameters' gradient (`counts`: a patch
// token against a patch token for the polynomial, a valid row against a
// valid key for the table) and, for the polynomial, at which distance. pq
// and pk are the two tokens' patch coordinates (read for the polynomial
// only): the caller steps them from token to token, since a division per
// logit costs more than the rest of the bias.
template <int PE>
__device__ __forceinline__ float chunk_logit(float acc, int qi, int kj, int n_k, float scale,
                                             const HeadBias& hb, Patch pq, Patch pk,
                                             float& dist, bool& counts) {
  const int row = hb.row0 + qi, col = hb.col0 + kj;
  dist = 0.f;
  counts = false;
  if (kj >= n_k || col >= hb.n_valid) return NEG_INF;
  float s = __fmul_rn(acc, scale);
  if (PE == PE_POLY) {
    counts = row > 0 && col > 0 && row < hb.n_valid;
    if (counts) s = __fadd_rn(s, poly_bias(hb, pq, pk, dist));
  } else if (PE == PE_REL) {
    counts = row < hb.n_valid;
    s = __fadd_rn(s, rel_bias(hb, row, col));
  }
  return s;
}

// Shared memory of one backward CTA: four bf16 [64, D] tiles (q, g, k, v),
// two f32 [64, max(D, 64)] slabs (s and gv, later the accumulators on their
// way out) and two bf16 [64, 64] blocks (p and ds).
template <int D>
struct BwdLayout {
  static constexpr int LDX = ldx<D>();
  static constexpr int SW = D > TK ? D : TK;  // f32 slab width
  static constexpr int LDS = SW + 4;
  static constexpr int LDP = TK + 8;          // bf16 [16, 64] row blocks
  static constexpr size_t TILE_BYTES = size_t(TQ) * LDX * 2;
  static constexpr size_t SLAB_BYTES = size_t(TQ) * LDS * 4;
  static constexpr size_t P_BYTES = size_t(TQ) * LDP * 2;
  static constexpr size_t T0 = 0;  // four bf16 tiles
  static constexpr size_t S_OFF = 4 * TILE_BYTES;
  static constexpr size_t U_OFF = S_OFF + SLAB_BYTES;
  static constexpr size_t P_OFF = U_OFF + SLAB_BYTES;
  static constexpr size_t R_OFF = P_OFF + P_BYTES;
  static constexpr size_t BYTES = R_OFF + P_BYTES;
  static_assert(TILE_BYTES % 128 == 0 && SLAB_BYTES % 128 == 0 &&
                    P_BYTES % 128 == 0,
                "shared-memory sections must stay 128-byte aligned");
};

}  // namespace attn
