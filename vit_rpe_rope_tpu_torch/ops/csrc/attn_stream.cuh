// Pieces shared by the streaming attention kernels (attn_stream_fwd.cu,
// attn_stream_bwd.cu): where a logit's bias comes from (a materialized
// [H, N, N] tensor, or generated per element from the polynomial
// coefficients or the relative table), the key mask in global coordinates,
// and the integer arguments of the C entry points.

#pragma once

#include "attn_common.cuh"

namespace attn {

constexpr int MAX_POLY_TERMS = 8;  // degree + 1 of the polynomial bias

// Integer arguments of attn_stream_fwd / attn_stream_bwd_*, in this order.
enum Dim {
  DIM_B, DIM_H, DIM_N, DIM_D, DIM_IS_BF16, DIM_COS_HEADS,
  DIM_POLY_TERMS,  // degree + 1, or 0 without a polynomial bias
  DIM_POLY_GRID,   // patch-grid side of the polynomial bias
  DIM_REL_ELL,     // L of the [H, 2L-1] relative table, or 0 without one
  DIM_ROW0,        // global index of this call's first query row
  DIM_COL0,        // global index of this call's first key
  DIM_N_VALID,     // keys at global indices >= n_valid are masked
  DIM_GROUPS,      // backward: batch groups of the dbias pass
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

// Scaled, biased, masked logit of local query row qi against local key kj.
// The polynomial bias is sum_k c[k] * dist^k over the L1 distance of the two
// tokens' patch coordinates ((t-1) % grid, (t-1) / grid), zero on the cls
// row and column and at padded indices; the relative bias is
// table[row - col + L - 1]. Both act on global indices (row0 + qi, col0 + kj).
__device__ __forceinline__ float stream_logit(float acc, int qi, int kj, int n_tokens,
                                              float scale, const HeadBias& hb) {
  const int row = hb.row0 + qi, col = hb.col0 + kj;
  if (kj >= n_tokens || col >= hb.n_valid) return NEG_INF;
  float s = __fmul_rn(acc, scale);
  if (hb.bias_h != nullptr) {
    if (qi < n_tokens) s = __fadd_rn(s, hb.bias_h[(long long)qi * n_tokens + kj]);
  } else if (hb.terms > 0) {
    if (row > 0 && col > 0 && row < hb.n_valid) {
      const int yq = (row - 1) / hb.grid, xq = (row - 1) - yq * hb.grid;
      const int yk = (col - 1) / hb.grid, xk = (col - 1) - yk * hb.grid;
      const float dist = float(abs(xq - xk) + abs(yq - yk));
      float bias = 0.f, pw = 1.f;
#pragma unroll
      for (int i = 0; i < MAX_POLY_TERMS; ++i) {
        if (i < hb.terms) bias = __fadd_rn(bias, __fmul_rn(hb.c[i], pw));
        pw = __fmul_rn(pw, dist);
      }
      s = __fadd_rn(s, bias);
    }
  } else if (hb.table_h != nullptr) {
    const int idx = min(max(row - col + hb.ell - 1, 0), 2 * hb.ell - 2);
    s = __fadd_rn(s, hb.table_h[idx]);
  }
  return s;
}

}  // namespace attn
