// Pieces shared by the streaming attention kernels (attn_stream_fwd.cu,
// attn_stream_bwd.cu, attn_stream_bwd_fused.cu): where a logit's bias comes
// from (a materialized [H, N, N] tensor, or generated per element from the
// polynomial coefficients or the relative table), the key mask in global
// coordinates, and the integer arguments of the C entry points.

#pragma once

#include "attn_common.cuh"

namespace attn {

// Terms (degree + 1) of the polynomial bias: at most the JAX package's 128
// lanes. The kernels are compiled twice for the polynomial: up to
// REG_POLY_TERMS terms, held in registers (the code of the eight-term
// kernels, so degrees up to 7 compute the same bits at the same speed), and
// MORE, which reads the terms past the eighth from the coefficient row (and,
// in the backward's parameter sums, accumulates them in shared memory).
constexpr int MAX_POLY_TERMS = 128;
constexpr int REG_POLY_TERMS = 8;

// Columns of one CTA's row of polynomial partial sums in the backward's
// scratch: the terms rounded up to whole groups of REG_POLY_TERMS.
__host__ __device__ constexpr int poly_part_cols(int terms) {
  return terms <= REG_POLY_TERMS ? REG_POLY_TERMS
                                 : (terms + REG_POLY_TERMS - 1) / REG_POLY_TERMS * REG_POLY_TERMS;
}

// Integer arguments of attn_stream_fwd / attn_stream_bwd_*, in this order.
// The last two are read by attn_stream_bwd_fused.cu and by the chunk entry of
// attn_stream_fwd.cu only: their keys may be a chunk of another length than
// the queries.
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
  const float* table_h;
  float c[REG_POLY_TERMS];
  const float* c_more;  // the head's coefficients from REG_POLY_TERMS on
  int terms, grid, ell, row0, col0, n_valid;
};

__device__ __forceinline__ HeadBias head_bias(const BiasArgs& a, int h) {
  HeadBias hb;
  hb.table_h = a.table != nullptr ? a.table + (long long)h * (2 * a.rel_ell - 1) : nullptr;
  hb.terms = a.coeff != nullptr ? a.poly_terms : 0;
#pragma unroll
  for (int i = 0; i < REG_POLY_TERMS; ++i)
    hb.c[i] = i < hb.terms ? a.coeff[h * a.poly_terms + i] : 0.f;
  hb.c_more = a.coeff != nullptr ? a.coeff + h * a.poly_terms + REG_POLY_TERMS : nullptr;
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

// The coordinates n >= 0 tokens on, without a division (one step of the
// loop per row of the grid crossed).
__device__ __forceinline__ void advance(Patch& p, int n, int grid) {
  p.x += n;
  while (p.x >= grid) {
    p.x -= grid;
    ++p.y;
  }
}

// The polynomial bias between two patch tokens: sum_k c[k] * dist^k over the
// L1 distance of their patch coordinates. Also hands back that distance.
// MORE: the head may have more than REG_POLY_TERMS terms.
template <bool MORE>
__device__ __forceinline__ float poly_bias(const HeadBias& hb, Patch q, Patch k, float& dist) {
  dist = float(abs(q.x - k.x) + abs(q.y - k.y));
  float bias = 0.f, pw = 1.f;
#pragma unroll
  for (int i = 0; i < REG_POLY_TERMS; ++i) {
    if (i < hb.terms) bias = __fadd_rn(bias, __fmul_rn(hb.c[i], pw));
    pw = __fmul_rn(pw, dist);
  }
  if (MORE) {
    for (int i = REG_POLY_TERMS; i < hb.terms; ++i) {  // same order, from memory
      bias = __fadd_rn(bias, __fmul_rn(__ldg(hb.c_more + i - REG_POLY_TERMS), pw));
      pw = __fmul_rn(pw, dist);
    }
  }
  return bias;
}

// The relative bias of global (row, col): table[row - col + L - 1], clamped
// to the table's ends.
__device__ __forceinline__ float rel_bias(const HeadBias& hb, int row, int col) {
  return hb.table_h[min(max(row - col + hb.ell - 1, 0), 2 * hb.ell - 2)];
}

// Which bias a kernel of attn_stream_fwd.cu, attn_stream_bwd.cu or
// attn_stream_bwd_fused.cu is compiled for: PE_POLY_MORE is the polynomial
// with more than REG_POLY_TERMS terms, PE_BIAS a materialized [H, N, N]
// bias (not the one-pass backward).
enum Pe { PE_NONE, PE_POLY, PE_REL, PE_POLY_MORE, PE_BIAS };

// Scaled, biased, masked logit of local query row qi against local key kj
// of a key chunk of its own length (n_k keys, already cut to the chunk's
// valid width), with no materialized bias. The polynomial bias is zero on
// the cls row and column and at padded indices; both generated biases act
// on global indices (row0 + qi, col0 + kj). Also says whether the
// element counts towards the bias parameters' gradient (`counts`: a patch
// token against a patch token for the polynomial, a valid row against a
// valid key for the table) and, for the polynomial, at which distance. pq
// and pk are the two tokens' patch coordinates (read for the polynomial
// only): the caller steps them from token to token, since a division per
// logit costs more than the rest of the bias. MASK = false leaves out the
// key mask's tests, for a caller that knows the key lies below n_k and
// n_valid: the same operations otherwise, so the same bits.
template <int PE, bool MASK = true>
__device__ __forceinline__ float chunk_logit(float acc, int qi, int kj, int n_k, float scale,
                                             const HeadBias& hb, Patch pq, Patch pk,
                                             float& dist, bool& counts) {
  const int row = hb.row0 + qi, col = hb.col0 + kj;
  dist = 0.f;
  counts = false;
  if (MASK && (kj >= n_k || col >= hb.n_valid)) return NEG_INF;
  float s = __fmul_rn(acc, scale);
  if (PE == PE_POLY || PE == PE_POLY_MORE) {
    counts = row > 0 && col > 0 && row < hb.n_valid;
    if (counts) s = __fadd_rn(s, poly_bias<PE == PE_POLY_MORE>(hb, pq, pk, dist));
  } else if (PE == PE_REL) {
    counts = row < hb.n_valid;
    s = __fadd_rn(s, rel_bias(hb, row, col));
  }
  return s;
}

}  // namespace attn
