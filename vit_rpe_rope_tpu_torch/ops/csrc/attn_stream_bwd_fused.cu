// One-pass streaming attention backward (dq, dk, dv and the gradient of the
// generated bias' parameters from one sweep over the logits), and the two
// parameter-gradient passes of the separate-pass backward, for Hopper
// (sm_90a).
//
// Replaces: the Pallas kernels `_stream_bwd_fused_kernel` (launched by
// `_bwd_streaming_fused`, `_bwd_fused_segmented` and `streaming_chunk_bwd`),
// `_stream_bwd_dcoeff_kernel` and `_stream_bwd_dtable_kernel` (launched by
// `_bwd_streaming`) of vit_rpe_rope_tpu/ops/flash_attention.py.
//
// Computes, for q, g [B, H, Nq, D] and a key chunk k, v [B, H, Nk, D] (float32
// or bfloat16, any strides with a unit last-dim stride) at global offsets
// (row0, col0), lse and delta = sum_d g * out [B, H, Nq] f32, with the JAX
// kernels' rounding points:
//   qf, kf = bf16(rotate(q)), bf16(rotate(k))    rotation in f32 (Nq == Nk)
//   s      = qf . kf^T * scale + bias            f32; bias generated from the
//            polynomial coefficients or the relative table at global
//            indices; keys >= min(Nk, kv_valid) or at global indices >=
//            n_valid masked to -1e30
//   p      = exp(s - lse),  gv = bf16(g) . bf16(v)^T,  ds = p * (gv - delta)
//   dv     = bf16(p)^T . bf16(g),  dk = scale * bf16(ds)^T . qf
//   dq     = scale * bf16(ds) . kf       all three f32, dq and dk rotated back
//   dcoeff[h, m] = sum_{b,i,j} ds * dist(i, j)^m   over patch tokens i, j
//   dtable[h, i - j + L - 1] += sum_b ds           over valid rows and keys
// from the f32 ds. Padded query rows contribute nothing and masked keys give
// p = exp(-1e30 - lse) = 0, never NaN.
//
// What bounds it on an H100: operations. At the long-sequence shape (B=4,
// H=4, Nq=Nk=4097, D=32, f32) the five products are 85.9 GFLOP, about 87 us at
// 989 TFLOP/s, over 67 MB of reads and writes (20 us at 3.35 TB/s); the
// parameter passes alone run two products (34.4 GFLOP, about 35 us).
//
// Design: the TPU kernel runs a sequential (batch, head, q tile, kv tile)
// grid with dk and dv of a whole (batch, head) resident in VMEM, dq revisited
// per query tile, and the table's gradient flushed by read-modify-write DMAs.
// Here CTAs run in parallel and in no order, and nothing is added atomically,
// so that every result is the same from run to run. Kernels, in this order
// on one stream:
//   prologue   one thread per 8 columns (4 at c, 4 at c + D/2) of a token
//              row: writes qf, kf, bf16 v and bf16 g once per call into
//              bf16 scratch (`round_row`: the bits of the separate passes'
//              and the forward's prologues), rows padded with zeros to a
//              multiple of 128. The kernel before this one rotated and
//              rounded every staged tile itself from strided f32 rows: each
//              query tile once for every 64-key CTA (65 times at N = 4097).
//   sweep      one CTA of 8 warps per (128 keys, head, batch); each warp owns
//              16 keys, its kf and bf16 v rows held as mma A fragments in
//              registers (`hold`). The CTA walks the queries in tiles of 64
//              (qf, gb, their lse and delta) through a two-slot cp.async
//              ring. Per 16-query block a warp forms s^T = kf . qf^T and
//              gv^T = vb . gb^T with mma.sync.m16n8k16 on ldmatrix
//              fragments, p^T and ds^T in the C fragments, and dv +=
//              bf16(p^T) . gb, dk += bf16(ds^T) . qf from them repacked as A
//              operands; a block whose keys and queries are all valid skips
//              the mask tests. dq = ds . kf needs ds, not ds^T, as its A
//              operand: each warp writes its bf16 ds^T once to shared
//              memory (two buffers), and after the next tile's barrier the
//              8 warps form the CTA's [64 queries, D] piece of dq over its
//              128 keys (ldmatrix.trans of ds^T against kf kept in shared
//              memory): one barrier a tile (with a bias, one buffer and
//              the piece formed after a barrier of the tile's own). The
//              sweep runs in
//              thread-block clusters of CLUSTER CTAs along the keys: per
//              query tile each CTA adds its 64 / CLUSTER rows of the tile up
//              over the cluster's pieces, read through distributed shared
//              memory in rank order, and writes them once to the cluster's
//              f32 slab [B, H, NQP, D]. A CTA arrives at the cluster barrier
//              once its piece of a tile is written, and waits on it only
//              after the next tile's products, so the CTAs of a cluster need
//              not run in lockstep (the pieces are double-buffered where
//              shared memory allows, else a second barrier frees the
//              piece before it is rewritten). A key count that is not a
//              multiple of the cluster's keys pads the grid with CTAs that
//              own no keys: they only add rows up. The polynomial sums stay
//              in registers (one per term and thread; the terms past the
//              eighth are summed over the warp per block into a column of
//              shared memory) and are added up over the CTA in a fixed order;
//              the table's gradient is a sum of the f32 ds^T (staged in
//              shared memory) along the 191 diagonals of the 128 x 64 tile
//              (each warp sums the 79 of its 16 keys, then the warps' sums
//              are added in warp order), added into a 256-entry ring whose
//              first 64 entries are final
//              once a query tile is done and leave for the CTA's own row of
//              a scratch [B, H, key tiles, round_up(Nq, 64) + 128]. dk is
//              rotated back, and dk and dv are written once by their owner.
//   dq sum     dq = scale * sum over the clusters' slabs, in cluster order,
//              rotated back.
//   dparam sum dcoeff / dtable = sum over batches and key tiles of the CTAs'
//              partial sums, in that order, in double.
// The slabs are CLUSTER * 128 keys apart (the kernel before this one wrote
// one per 64 keys: 8x the bytes at CLUSTER = 4, 16x at 8); the wrapper bounds
// them by sweeping the keys in segments (`_bwd_fused_segmented`). The
// parameter passes are the sweep without the three gradient products, on
// the separate passes' prologue operands. wgmma / TMA pipelining is later
// work.

#include <type_traits>

#include "attn_stream_tiles.cuh"

namespace {

using namespace attn;

// Sweep CTAs per thread-block cluster, along the keys (flash_attention.py's
// FUSED_CLUSTER, which sizes the slabs). 4 against 1 and 8, in turns on an
// H100 (scripts/torch_kernel_digest.py --time): at (4, 4, 4097, 32) a
// cluster of 8 pads 33 key tiles to 40 CTAs and waits longest on its
// slowest CTA, one CTA per cluster writes 33 slabs (the dq sum 0.11 ms
// against 0.04); on the bounded step's chunks 8 is ahead by 4%.
constexpr int CLUSTER = 4;
static_assert(STEP % CLUSTER == 0, "a query tile splits into whole rows per rank");

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* g;
  const float* lse;    // [B, H, Nq]
  const float* delta;  // [B, H, Nq]
  float* dq;           // f32, strided
  float* dk;
  float* dv;
  float* dq_part;      // [slabs, B, H, NQP, D]
  // qf [B, H, NQP, D], kf and bf16 v [B, H, NKP, D], bf16 g [B, H, NQP, D]
  __nv_bfloat16* ops;
  float* dparam;       // dcoeff [H, poly_terms] or dtable [H, 2 * rel_ell - 1]
  float* dparam_part;  // [B, H, key tiles, poly_part_cols(terms) | row_len]
  const float* cos;    // [cos_heads, Nq, D/2] or null
  const float* sin;
  BiasArgs bias;
  // (batch, head, token) strides of q, k, v, g, dq, dk, dv
  long long qs[3], ks[3], vs[3], gs[3], dqs[3], dks[3], dvs[3];
  int B, H, Nq, Nk, NQP, NKP, kv_valid, cos_heads, D, is_bf16;
  float scale;
};

// 128-key tiles of Nk keys (one sweep CTA each), and the clusters (dq slabs)
// they make.
__host__ __device__ inline int key_tiles(int nk) { return (nk + OWN_ROWS - 1) / OWN_ROWS; }
__host__ __device__ inline int slabs(int nk) { return (key_tiles(nk) + CLUSTER - 1) / CLUSTER; }
// Entries of a CTA's row of table partial sums: the diagonals of every query
// tile, 64 apart.
__host__ __device__ inline int table_row(int nq) { return (nq + STEP - 1) / STEP * STEP + OWN_ROWS; }

// The (batch, head) plane of one operand in the prologue's scratch: 0 qf,
// 1 kf, 2 bf16 v, 3 bf16 g (the separate passes' layout when NQP == NKP).
__device__ __forceinline__ __nv_bfloat16* operand(const Params& p, int which, long long bh,
                                                  int D) {
  const long long q_plane = (long long)p.B * p.H * p.NQP * D;
  const long long k_plane = (long long)p.B * p.H * p.NKP * D;
  switch (which) {
    case 0: return p.ops + bh * p.NQP * D;
    case 1: return p.ops + q_plane + bh * p.NKP * D;
    case 2: return p.ops + q_plane + k_plane + bh * p.NKP * D;
    default: return p.ops + q_plane + 2 * k_plane + bh * p.NQP * D;
  }
}

// qf and bf16 g of one query row (blockIdx.y 0), or kf and bf16 v of one key
// row (blockIdx.y 1), 8 columns of it per thread, into the scratch. Rows past
// Nq / Nk are zero.
template <int D, typename T>
__global__ void __launch_bounds__(256) attn_stream_bwd_fused_prologue_kernel(const Params p) {
  constexpr int H2 = D / 2, PER_ROW = D / 8;
  const bool keys = blockIdx.y == 1;
  const int np = keys ? p.NKP : p.NQP;
  const long long rows = (long long)p.B * p.H * np;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = i / PER_ROW;
  if (row >= rows) return;
  const int c = int(i % PER_ROW) * 4;
  const int n = int(row % np);
  const long long bh = row / np;
  const int b = int(bh / p.H), h = int(bh % p.H);
  const bool valid = n < (keys ? p.Nk : p.Nq);
  const float *cs = nullptr, *sn = nullptr;
  if (p.cos != nullptr) {  // Nq == Nk
    const long long at = ((long long)(p.cos_heads == 1 ? 0 : h) * p.Nq + n) * H2 + c;
    cs = p.cos + at;
    sn = p.sin + at;
  }
  __nv_bfloat16* first = operand(p, keys ? 1 : 0, bh, D) + (long long)n * D + c;
  __nv_bfloat16* second = operand(p, keys ? 2 : 3, bh, D) + (long long)n * D + c;
  if (keys) {
    round_row<D>(first, slice<T>(p.k, p.ks, b, h) + n * p.ks[2] + c, cs, sn, valid);
    round_row<D>(second, slice<T>(p.v, p.vs, b, h) + n * p.vs[2] + c, nullptr, nullptr, valid);
  } else {
    round_row<D>(first, slice<T>(p.q, p.qs, b, h) + n * p.qs[2] + c, cs, sn, valid);
    round_row<D>(second, slice<T>(p.g, p.gs, b, h) + n * p.gs[2] + c, nullptr, nullptr, valid);
  }
}

// Shared memory of one sweep CTA: the ring (two slots of qf, gb [64, D] and
// the tile's lse and delta) and the CTA's own kf [128, D] (kept: dq's B
// operand) and, unless held in registers, bf16 v; with GRADS the bf16 ds^T
// [128 keys, 64 queries] and the dq pieces f32 [64, D]; for the table the
// f32 ds^T [128, 64].
template <int D, int PE, bool GRADS>
struct Sweep {
  static constexpr bool HOLD = hold<D, PE>();
  // dq's product for a tile waits for the next tile's barrier, on a second
  // ds^T buffer; without a bias only: the table's diagonal sums need a
  // barrier of their own and its f32 ds^T leaves no room for the second
  // buffer, and the polynomial kernels would spill with it at D = 32.
  static constexpr bool DEFER = GRADS && PE == PE_NONE;
  // a slot's statistics: lse and delta of its 64 queries and, with the
  // table, the tile's 191 table entries (one per diagonal q - k)
  static constexpr int TAB = PE == PE_REL ? OWN_ROWS + STEP : 0;
  using R = Ring<D, 0, 4, 2 * STEP + TAB, false, HOLD ? 1 : 2>;
  static constexpr int LDT = STEP + 8;  // conflict-free 4-byte stores and ldmatrix rows
  static constexpr int LDU = STEP + 8;  // conflict-free 8-byte stores
  static constexpr int LDQ = D + 4;
  static constexpr size_t DST = size_t(OWN_ROWS) * LDT * 2;
  static constexpr size_t DST_OFF = R::BYTES;
  static constexpr size_t U_OFF = DST_OFF + (GRADS ? (DEFER ? 2 : 1) * DST : 0);
  static constexpr size_t PIECE_OFF = U_OFF + (PE == PE_REL ? size_t(OWN_ROWS) * LDU * 4 : 0);
  static constexpr size_t PIECE = size_t(STEP) * LDQ * 4;
  static constexpr int PIECES = !GRADS ? 0 : PIECE_OFF + 2 * PIECE <= 232448 ? 2 : 1;
  static constexpr size_t BYTES = PIECE_OFF + PIECES * PIECE;
  static_assert(DST_OFF % 128 == 0 && U_OFF % 128 == 0 && PIECE_OFF % 16 == 0 &&
                    PIECE % 16 == 0 && BYTES <= 232448,
                "the sweep's sections must stay aligned and within shared memory");
};

// The thread-block cluster: the two halves of a barrier of all its threads
// (arrive releases what the thread wrote to shared memory before it; wait
// returns once every thread of the cluster has arrived, and acquires it;
// each thread alternates them), the CTA's rank, and the address of a shared
// variable in the CTA of another rank (distributed shared memory, read by
// plain loads).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return int(r);
}
__device__ __forceinline__ const float* cluster_map(const float* p, int rank) {
  unsigned long long out;
  asm volatile("mapa.u64 %0, %1, %2;\n" : "=l"(out) : "l"(p), "r"(rank));
  return reinterpret_cast<const float*>(out);
}

// The A fragment of rows [r0, r0+16) (queries), columns [c0, c0+16) (keys)
// of ds from a row-major bf16 tile of ds^T (keys x queries, pitch LD).
template <int LD>
__device__ __forceinline__ void load_at(uint32_t (&a)[4], const __nv_bfloat16* s, int c0,
                                        int r0) {
  const int lane = threadIdx.x % 32;
  dense::ldsm_x4_trans(a, s + (c0 + (lane & 7) + (lane >> 4) * 8) * LD + r0 +
                              ((lane >> 3) & 1) * 8);
}

// One CTA's sweep over all query tiles against its 128 keys. GRADS: dk, dv
// and dq's pieces and slabs; PE: which parameter sums, if any.
template <int D, int PE, bool GRADS>
__device__ __forceinline__ void sweep(const Params& p) {
  using namespace dense;
  using S = Sweep<D, PE, GRADS>;
  using L = typename S::R;
  constexpr bool POLY = PE == PE_POLY || PE == PE_POLY_MORE;
  constexpr bool MORE = PE == PE_POLY_MORE;
  constexpr bool HOLD = S::HOLD;
  constexpr int LD = L::LD, NT = D / 16;  // 8-column tiles of a warp's half of dq
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* own_k = reinterpret_cast<__nv_bfloat16*>(smem + L::OWN_OFF);
  // held: bf16 v passes through the ring's first slot on its way to registers
  __nv_bfloat16* own_v =
      HOLD ? reinterpret_cast<__nv_bfloat16*>(smem) : own_k + OWN_ROWS * LD;
  __nv_bfloat16* dst_s = reinterpret_cast<__nv_bfloat16*>(smem + S::DST_OFF);
  float* u_s = reinterpret_cast<float*>(smem + S::U_OFF);
  float* piece_s = reinterpret_cast<float*>(smem + S::PIECE_OFF);
  __shared__ float ring[PE == PE_REL ? 4 * STEP : 1];  // the table gradient's diagonals
  __shared__ float red[RING_WARPS][REG_POLY_TERMS];
  __shared__ float more[MORE ? RING_WARPS : 1][MORE ? MAX_POLY_TERMS - REG_POLY_TERMS : 1];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int c0 = kt * OWN_ROWS, wkey = warp * 16, key0 = c0 + wkey;
  const int Nq = p.Nq, Nk = p.Nk, n_kt = key_tiles(Nk);
  const bool owner = kt < n_kt;  // the CTAs that pad a cluster own no keys
  const int nq16 = (Nq + 15) & ~15, n_steps = (nq16 + STEP - 1) / STEP;
  const int n_keys = min(Nk, p.kv_valid);
  const long long bh = (long long)b * p.H + h;
  const HeadBias hb = head_bias(p.bias, h);
  // the warp's keys are unmasked: below kv_valid and, globally, n_valid
  const bool keys_full = key0 + 16 <= min(n_keys, hb.n_valid - hb.col0);
  const __nv_bfloat16* qf = operand(p, 0, bh, D);
  const __nv_bfloat16* gb = operand(p, 3, bh, D);
  const float* lse_bh = p.lse + bh * Nq;
  const float* delta_bh = p.delta + bh * Nq;
  auto stage_step = [&](int t) {  // step t's tiles, lse and delta into slot t % 2
    unsigned char* slot = smem + (t & 1) * L::SLOT;
    const int q0 = t * STEP;
    stage_rows<D>(reinterpret_cast<__nv_bfloat16*>(slot), qf + (long long)q0 * D, STEP);
    stage_rows<D>(reinterpret_cast<__nv_bfloat16*>(slot + L::TILE), gb + (long long)q0 * D,
                  STEP);
    float* st = reinterpret_cast<float*>(slot + L::STATS_OFF);
    for (int i = threadIdx.x; i < STEP; i += RING_THREADS) {
      const bool ok = q0 + i < Nq;
      cp_async4(st + i, ok ? lse_bh + q0 + i : lse_bh, ok);
      cp_async4(st + STEP + i, ok ? delta_bh + q0 + i : delta_bh, ok);
    }
    if (PE == PE_REL) {
      // entry e: the table at global row - col + L - 1 for the tile's
      // query q and key k with q - k + 127 = e, clamped as rel_bias clamps
      const int base = hb.row0 + q0 - hb.col0 - c0 - (OWN_ROWS - 1) + hb.ell - 1;
      for (int i = threadIdx.x; i < OWN_ROWS + STEP - 1; i += RING_THREADS)
        cp_async4(st + 2 * STEP + i, hb.table_h + min(max(base + i, 0), 2 * hb.ell - 2), true);
    }
    cp_async_commit();
  };

  uint32_t ka[HOLD ? D / 16 : 1][4], va[HOLD ? D / 16 : 1][4];
  if (owner) {
    stage_rows<D>(own_k, operand(p, 1, bh, D) + (long long)c0 * D, OWN_ROWS);
    stage_rows<D>(own_v, operand(p, 2, bh, D) + (long long)c0 * D, OWN_ROWS);
    cp_async_commit();
    if (!HOLD) stage_step(0);
    cp_async_wait_all();
    __syncthreads();
    if (HOLD) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        load_a<LD>(ka[kk], own_k, wkey, kk * 16);
        load_a<LD>(va[kk], own_v, wkey, kk * 16);
      }
      __syncthreads();  // the ring may now overwrite bf16 v
      stage_step(0);
    }
  }

  Patch pkey[2] = {};
  if (POLY)
    for (int r = 0; r < 2; ++r) pkey[r] = patch_of(hb.col0 + key0 + g4 + 8 * r, hb.grid);
  Patch pc = {};  // the query column 2 * t4 of the current 16-query block
  if (POLY) pc = patch_of(hb.row0 + 2 * t4, hb.grid);
  float dk[GRADS ? D / 8 : 1][4], dv[GRADS ? D / 8 : 1][4];
#pragma unroll
  for (int n = 0; n < (GRADS ? D / 8 : 1); ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  float pacc[REG_POLY_TERMS];
#pragma unroll
  for (int m = 0; m < REG_POLY_TERMS; ++m) pacc[m] = 0.f;
  if (MORE)
    for (int m = lane; m < MAX_POLY_TERMS - REG_POLY_TERMS; m += 32) more[warp][m] = 0.f;
  if (PE == PE_REL)
    for (int i = threadIdx.x; i < 4 * STEP; i += RING_THREADS) ring[i] = 0.f;
  // Rows rank * 64 / CLUSTER .. of tile t, summed over the cluster's pieces
  // in rank order (the CTAs that own keys), to the cluster's slab.
  auto add_pieces = [&](int t) {
    constexpr int SHARE = STEP / CLUSTER, Q4 = D / 4;
    const int rank = cluster_rank();
    const int ranks = min(CLUSTER, n_kt - (kt - rank));
    const float* piece = piece_s + (S::PIECES > 1 ? t & 1 : 0) * STEP * S::LDQ;
    float* slab = p.dq_part + (((long long)(kt / CLUSTER) * p.B + b) * p.H + h) * p.NQP * D;
    for (int i = threadIdx.x; i < SHARE * Q4; i += RING_THREADS) {
      const int r = rank * SHARE + i / Q4, c = (i % Q4) * 4;
      float4 x = *reinterpret_cast<const float4*>(cluster_map(piece, 0) + r * S::LDQ + c);
#pragma unroll
      for (int src = 1; src < CLUSTER; ++src) {
        if (src < ranks) {
          const float4 o =
              *reinterpret_cast<const float4*>(cluster_map(piece, src) + r * S::LDQ + c);
          x = make_float4(__fadd_rn(x.x, o.x), __fadd_rn(x.y, o.y), __fadd_rn(x.z, o.z),
                          __fadd_rn(x.w, o.w));
        }
      }
      *reinterpret_cast<float4*>(slab + (long long)(t * STEP + r) * D + c) = x;
    }
  };
  // Tile u's piece of dq: once tile u - 1's pieces are added up (every CTA
  // is then done with the buffer of tile u - 2 that u's piece goes to), the
  // CTA's ds [64 queries, 128 keys] . kf [128 keys, D], unscaled (warp w
  // forms rows 16 (w % 4) .. + 16 of the columns of half w / 4), then
  // arrive. The CTA's ds^T of tile u must be in place.
  auto dq_tile = [&](int u) {
    if (u > 0) {
      cluster_wait();
      add_pieces(u - 1);
      if (S::PIECES == 1) {  // every CTA is done reading the one piece
        cluster_arrive();
        cluster_wait();
      }
    }
    if (owner) {
      const __nv_bfloat16* dst_u = dst_s + (S::DEFER ? u & 1 : 0) * (S::DST / 2);
      const int qb = (warp & 3) * 16, c_half = (warp >> 2) * (D / 2);
      float acc[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < OWN_ROWS / 16; ++kk) {
        uint32_t a[4];
        load_at<S::LDT>(a, dst_u, kk * 16, qb);
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          uint32_t bb[4];
          load_b<LD>(bb, own_k, kk * 16, c_half + n * 8);
          mma(acc[n], a, bb[0], bb[1]);
          if (n + 1 < NT) mma(acc[n + 1], a, bb[2], bb[3]);
        }
      }
      float* piece = piece_s + (S::PIECES > 1 ? u & 1 : 0) * STEP * S::LDQ;
#pragma unroll
      for (int n = 0; n < NT; ++n) store_tile(piece, S::LDQ, qb, c_half + n * 8, STEP, acc[n]);
    }
    cluster_arrive();
  };
  float* table_row_g = PE == PE_REL && owner
                           ? p.dparam_part + (bh * n_kt + kt) * (long long)table_row(Nq)
                           : nullptr;

  for (int t = 0; t < n_steps; ++t) {
    const int q0 = t * STEP;
    if (owner) {
      cp_async_wait_all();
      __syncthreads();  // step t has landed; every warp is done with step t - 1
      if (t + 1 < n_steps) stage_step(t + 1);
    }
    if constexpr (S::DEFER) {
      if (t > 0) dq_tile(t - 1);
    }
    if (owner) {
      __nv_bfloat16* dst_t = dst_s + (S::DEFER ? t & 1 : 0) * (S::DST / 2);
      const unsigned char* slot = smem + (t & 1) * L::SLOT;
      const __nv_bfloat16* qs = reinterpret_cast<const __nv_bfloat16*>(slot);
      const __nv_bfloat16* gs = reinterpret_cast<const __nv_bfloat16*>(slot + L::TILE);
      const float* st = reinterpret_cast<const float*>(slot + L::STATS_OFF);
      const int blocks = min(STEP, nq16 - q0) / 16;
#pragma unroll 1
      for (int j = 0; j < blocks; ++j) {
        float s[2][4] = {}, gv[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t a[4], bb[4];
          if (HOLD) {
#pragma unroll
            for (int u = 0; u < 4; ++u) a[u] = ka[kk][u];
          } else {
            load_a<LD>(a, own_k, wkey, kk * 16);
          }
          load_bt<LD>(bb, qs, j * 16, kk * 16);
          mma(s[0], a, bb[0], bb[1]);
          mma(s[1], a, bb[2], bb[3]);
          if (HOLD) {
#pragma unroll
            for (int u = 0; u < 4; ++u) a[u] = va[kk][u];
          } else {
            load_a<LD>(a, own_v, wkey, kk * 16);
          }
          load_bt<LD>(bb, gs, j * 16, kk * 16);
          mma(gv[0], a, bb[0], bb[1]);
          mma(gv[1], a, bb[2], bb[3]);
        }
        Patch pq[2][2] = {};
        if (POLY) {
          pq[0][0] = pc;
          pq[1][0] = pc;
          advance(pq[1][0], 8, hb.grid);
          pq[0][1] = pq[0][0];
          next_patch(pq[0][1], hb.grid);
          pq[1][1] = pq[1][0];
          next_patch(pq[1][1], hb.grid);
          advance(pc, 16, hb.grid);
        }
        // p^T and ds^T in the fragments; the parameter sums from the f32 ds.
        float pt[2][4], dz[2][4], dd[2][4], pw8[2][4];
        // The lane's lse and delta (query columns 2 t4, 2 t4 + 1 of each
        // 8-column tile): two 8-byte loads each without a bias; read per
        // element with one, where registers are scarcer (the polynomial
        // kernels would spill at D = 32).
        float2 lse2[2] = {}, dl2[2] = {};
        if (PE == PE_NONE) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            lse2[nt] = *reinterpret_cast<const float2*>(st + j * 16 + nt * 8 + 2 * t4);
            dl2[nt] = *reinterpret_cast<const float2*>(st + STEP + j * 16 + nt * 8 + 2 * t4);
          }
        }
        auto grads = [&](auto full) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1, c = e & 1;
              const int kj = key0 + g4 + 8 * r;
              const int ql = j * 16 + nt * 8 + 2 * t4 + c, qi = q0 + ql;
              float pr = 0.f, ds = 0.f, dsz = 0.f, dist = 0.f, pw = 0.f;
              // padded query rows carry a zero g in the JAX kernel
              if (decltype(full)::value || qi < Nq) {
                bool counts;
                float x;
                if (PE == PE_REL) {  // chunk_logit's, with the staged table
                  const bool masked = !decltype(full)::value &&
                                      (kj >= n_keys || hb.col0 + kj >= hb.n_valid);
                  counts = !masked && hb.row0 + qi < hb.n_valid;
                  x = masked ? NEG_INF
                             : __fadd_rn(__fmul_rn(s[nt][e], p.scale),
                                         st[2 * STEP + ql - (wkey + g4 + 8 * r) + OWN_ROWS - 1]);
                } else {
                  x = chunk_logit<PE, !decltype(full)::value>(s[nt][e], qi, kj, n_keys, p.scale,
                                                              hb, pq[nt][c], pkey[r], dist,
                                                              counts);
                }
                const float lse = PE == PE_NONE ? (c ? lse2[nt].y : lse2[nt].x) : st[ql];
                const float dl = PE == PE_NONE ? (c ? dl2[nt].y : dl2[nt].x) : st[STEP + ql];
                pr = expf(x - lse);
                ds = __fmul_rn(pr, __fsub_rn(gv[nt][e], dl));
                dsz = counts ? ds : 0.f;
                if (POLY) {
                  pw = 1.f;
#pragma unroll
                  for (int m = 0; m < REG_POLY_TERMS; ++m) {
                    if (!MORE && m == hb.terms) break;
                    pacc[m] += dsz * pw;
                    pw *= dist;
                  }
                }
              }
              dz[nt][e] = dsz;
              if (MORE) {
                dd[nt][e] = dist;
                pw8[nt][e] = pw;
              }
              pt[nt][e] = pr;
              s[nt][e] = ds;
            }
        };
        if (keys_full && q0 + j * 16 + 16 <= Nq)
          grads(std::true_type());
        else
          grads(std::false_type());
        if (PE == PE_REL) {  // the f32 ds^T for the diagonal sums
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int r = 0; r < 2; ++r)
              *reinterpret_cast<float2*>(u_s + (wkey + g4 + 8 * r) * S::LDU + j * 16 + nt * 8 +
                                         2 * t4) = make_float2(dz[nt][2 * r], dz[nt][2 * r + 1]);
        }
        if (MORE) {
          // the terms past the eighth: summed over the warp per block
          for (int m = REG_POLY_TERMS; m < hb.terms; ++m) {
            float x = 0.f;
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                x += dz[nt][e] * pw8[nt][e];
                pw8[nt][e] *= dd[nt][e];
              }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
            if (lane == 0) more[warp][m - REG_POLY_TERMS] += x;
          }
        }
        if constexpr (GRADS) {
          uint32_t pa[4], da[4];
          pack_a(pa, pt[0], pt[1]);
          pack_a(da, s[0], s[1]);
#pragma unroll
          for (int n = 0; n < D / 16; ++n) {
            uint32_t bb[4];
            load_b<LD>(bb, gs, j * 16, n * 16);
            mma(dv[2 * n], pa, bb[0], bb[1]);
            mma(dv[2 * n + 1], pa, bb[2], bb[3]);
            load_b<LD>(bb, qs, j * 16, n * 16);
            mma(dk[2 * n], da, bb[0], bb[1]);
            mma(dk[2 * n + 1], da, bb[2], bb[3]);
          }
          // bf16 ds^T (rows g4, g4 + 8 of the warp's keys) for dq
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int r = 0; r < 2; ++r)
              *reinterpret_cast<uint32_t*>(dst_t + (wkey + g4 + 8 * r) * S::LDT + j * 16 +
                                           nt * 8 + 2 * t4) = pack(s[nt][2 * r], s[nt][2 * r + 1]);
        }
      }
      if (PE == PE_REL) {
        // The warp's diagonals d = query - key + 15 of its 16 keys over the
        // tile's computed query columns, summed in key order, then written
        // over the start of its own rows.
        __syncwarp();
        const int cols = blocks * 16;
        float part[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const int d = lane + 32 * i, lo = 15 - d, hi = cols + 14 - d;
          float sum = 0.f;
#pragma unroll
          for (int kr = 0; kr < 16; ++kr)
            if (d < STEP + 15 && kr >= lo && kr <= hi)
              sum += u_s[(wkey + kr) * S::LDU + d - 15 + kr];
          part[i] = sum;
        }
        __syncwarp();
#pragma unroll
        for (int i = 0; i < 3; ++i)
          if (lane + 32 * i < STEP + 15) u_s[wkey * S::LDU + lane + 32 * i] = part[i];
      }
      if ((GRADS && !S::DEFER) || PE == PE_REL)
        __syncthreads();  // ds^T of all 128 keys is in place
      if (PE == PE_REL) {
        // Diagonal e = query - key + 127 of the tile: the warps' diagonals
        // e - 112 + 16 w, in warp order; entry q0 + e of this CTA's row.
        const int e = threadIdx.x;
        if (e < OWN_ROWS + STEP - 1) {
          float sum = 0.f;
#pragma unroll
          for (int w = 0; w < RING_WARPS; ++w) {
            const int d = e - (OWN_ROWS - 16) + 16 * w;
            if (d >= 0 && d < STEP + 15) sum += u_s[16 * w * S::LDU + d];
          }
          ring[(q0 + e) % (4 * STEP)] += sum;
        }
        // Entries q0 .. q0 + 63 are final: the next tile starts 64 further.
        // (The thread that flushes an entry summed it.)
        if (e < STEP) {
          table_row_g[q0 + e] = ring[(q0 + e) % (4 * STEP)];
          ring[(q0 + e) % (4 * STEP)] = 0.f;
        }
      }
    }
    if constexpr (GRADS && !S::DEFER) dq_tile(t);
  }
  if constexpr (S::DEFER) {
    if (owner) __syncthreads();  // the last tile's ds^T is in place
    dq_tile(n_steps - 1);
  }
  if constexpr (GRADS) {
    cluster_wait();
    add_pieces(n_steps - 1);
    cluster_arrive();  // no CTA leaves while another may still read its pieces
    cluster_wait();
  }
  if (!owner) return;

  if (PE == PE_REL) {
    __syncthreads();  // the ring's other 127 entries are in place
    const int end = n_steps * STEP;
    if (threadIdx.x < OWN_ROWS - 1)
      table_row_g[end + threadIdx.x] = ring[(end + threadIdx.x) % (4 * STEP)];
  }
  if (POLY) {
    // pacc over the warp, then over the warps in order; with MORE the
    // warps' columns of the other terms in the same order.
#pragma unroll
    for (int m = 0; m < REG_POLY_TERMS; ++m) {
      float x = pacc[m];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
      if (lane == 0) red[warp][m] = x;
    }
    __syncthreads();
    const int cols = poly_part_cols(hb.terms);
    float* part = p.dparam_part + (bh * n_kt + kt) * cols;
    for (int m = threadIdx.x; m < cols; m += RING_THREADS) {
      float x = 0.f;
      if (m < REG_POLY_TERMS)
        for (int w = 0; w < RING_WARPS; ++w) x += red[w][m];
      else if (MORE && m < hb.terms)
        for (int w = 0; w < RING_WARPS; ++w) x += more[w][m - REG_POLY_TERMS];
      part[m] = x;
    }
  }
  if constexpr (GRADS) {
    const long long tab = (long long)(p.cos_heads == 1 ? 0 : h) * Nq * (D / 2);
    const float* cos_h = p.cos != nullptr ? p.cos + tab : nullptr;
    const float* sin_h = p.sin != nullptr ? p.sin + tab : nullptr;
    float* dvg = p.dv + b * p.dvs[0] + h * p.dvs[1];
    float* dkg = p.dk + b * p.dks[0] + h * p.dks[1];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) store_tile(dvg, p.dvs[2], key0, n * 8, Nk, dv[n]);
    write_grad<D>(dk, key0, Nk, p.scale, dkg, p.dks[2], nullptr, cos_h, sin_h);
  }
}

// Up to D = 32, two CTAs a multiprocessor: 128 registers a thread, which the
// polynomial instance (161 unbounded) then fits without a spill; not the
// many-term one, which would spill.
template <int D, int PE>
__global__ void __launch_bounds__(RING_THREADS, D <= 32 && PE != PE_POLY_MORE ? 2 : 1)
    attn_stream_bwd_fused_kernel(const Params p) {
  sweep<D, PE, true>(p);
}

template <int D, int PE>
__global__ void __launch_bounds__(RING_THREADS) attn_stream_bwd_dcoeff_kernel(const Params p) {
  sweep<D, PE, false>(p);
}

template <int D>
__global__ void __launch_bounds__(RING_THREADS) attn_stream_bwd_dtable_kernel(const Params p) {
  sweep<D, PE_REL, false>(p);
}

// dq = scale * (sum over the clusters' slabs, in cluster order), rotated
// back with -sin. One thread per (batch, head, row, 4 column pairs of the
// rotation), 16-byte loads and stores.
__global__ void attn_stream_bwd_fused_dq_kernel(const Params p) {
  using namespace dense;
  const int D = p.D, H2 = D / 2, Q = H2 / 4, n_slabs = slabs(p.Nk);
  const long long total = (long long)p.B * p.H * p.Nq * Q;
  const long long slab = (long long)p.B * p.H * p.NQP * D;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int c = int(i % Q) * 4, row = int(i / Q % p.Nq);
    const long long bh = i / Q / p.Nq;
    const int b = int(bh / p.H), h = int(bh % p.H);
    const float* src = p.dq_part + (bh * p.NQP + row) * D + c;
    float x1[4], x2[4];
    load4(src, x1);
    load4(src + H2, x2);
    for (int t = 1; t < n_slabs; ++t) {
      float y1[4], y2[4];
      load4(src + t * slab, y1);
      load4(src + t * slab + H2, y2);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        x1[u] += y1[u];
        x2[u] += y2[u];
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      x1[u] = __fmul_rn(p.scale, x1[u]);
      x2[u] = __fmul_rn(p.scale, x2[u]);
    }
    if (p.cos != nullptr) {
      const long long at = ((long long)(p.cos_heads == 1 ? 0 : h) * p.Nq + row) * H2 + c;
      float cs[4], sn[4];
      load4(p.cos + at, cs);
      load4(p.sin + at, sn);
#pragma unroll
      for (int u = 0; u < 4; ++u) sn[u] = -sn[u];
      rotate4(x1, x2, cs, sn);
    }
    float* out = p.dq + b * p.dqs[0] + h * p.dqs[1] + row * p.dqs[2];
    store4(out + c, x1[0], x1[1], x1[2], x1[3]);
    store4(out + c + H2, x2[0], x2[1], x2[2], x2[3]);
  }
}

// dcoeff[h, m] = sum over batches, then key tiles, of the CTAs' sums.
__global__ void attn_stream_bwd_dcoeff_sum_kernel(const Params p) {
  const int n_kt = key_tiles(p.Nk), terms = p.bias.poly_terms, cols = poly_part_cols(terms);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < p.H * terms;
       i += gridDim.x * blockDim.x) {
    const int h = i / terms, m = i % terms;
    double sum = 0.0;
    for (int b = 0; b < p.B; ++b)
      for (int t = 0; t < n_kt; ++t)
        sum += p.dparam_part[(((long long)b * p.H + h) * n_kt + t) * cols + m];
    p.dparam[i] = float(sum);
  }
}

// dtable[h, idx] = sum over batches, then key tiles, of the entry of each
// CTA's row that holds the diagonal row - col + L - 1 = idx.
__global__ void attn_stream_bwd_dtable_sum_kernel(const Params p) {
  const int n_kt = key_tiles(p.Nk), width = 2 * p.bias.rel_ell - 1;
  const int row_len = table_row(p.Nq);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < (long long)p.H * width; i += (long long)gridDim.x * blockDim.x) {
    const int h = int(i / width), idx = int(i % width);
    // query - key of the diagonal, local to key tile 0
    const int diag = idx - (p.bias.rel_ell - 1) - p.bias.row0 + p.bias.col0;
    double sum = 0.0;
    for (int b = 0; b < p.B; ++b) {
      const float* rows = p.dparam_part + ((long long)b * p.H + h) * n_kt * row_len;
      for (int t = 0; t < n_kt; ++t) {
        const int e = diag + t * OWN_ROWS + OWN_ROWS - 1;
        if (e >= 0 && e < row_len - 1) sum += rows[(long long)t * row_len + e];
      }
    }
    p.dparam[i] = float(sum);
  }
}

enum Pass { PASS_FUSED, PASS_DCOEFF, PASS_DTABLE, PASS_PROLOGUE };

int blocks_for(long long total) {
  return int(total / 256 + 1 < 4096 ? total / 256 + 1 : 4096);
}

// The sweep: in clusters of CLUSTER CTAs along the keys (the grid padded to
// whole clusters) with GRADS, else one CTA per key tile.
template <int D, int PE, bool GRADS, typename K>
cudaError_t launch_sweep(K kernel, const Params& p, cudaStream_t stream) {
  // The PE_POLY_MORE kernels keep the terms past REG_POLY_TERMS in a static
  // column per warp, not in the dynamic layout.
  const size_t smem = Sweep<D, PE, GRADS>::BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int n_kt = key_tiles(p.Nk);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(GRADS ? slabs(p.Nk) * CLUSTER : n_kt, p.H, p.B);
  cfg.blockDim = dim3(RING_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = GRADS ? CLUSTER : 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int D>
cudaError_t launch(const Params& p, Pass pass, cudaStream_t stream) {
  cudaError_t err;
  if (pass == PASS_PROLOGUE || pass == PASS_FUSED) {
    const long long rows = (long long)p.B * p.H * (p.NQP > p.NKP ? p.NQP : p.NKP);
    const dim3 grid(unsigned((rows * (D / 8) + 255) / 256), 2);
    if (p.is_bf16)
      attn_stream_bwd_fused_prologue_kernel<D, __nv_bfloat16><<<grid, 256, 0, stream>>>(p);
    else
      attn_stream_bwd_fused_prologue_kernel<D, float><<<grid, 256, 0, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess || pass == PASS_PROLOGUE) return err;
  }
  const int pe = p.bias.coeff != nullptr
                     ? (p.bias.poly_terms > REG_POLY_TERMS ? PE_POLY_MORE : PE_POLY)
                 : p.bias.table != nullptr ? PE_REL
                                           : PE_NONE;
  if (pass == PASS_DCOEFF)
    err = pe == PE_POLY_MORE
              ? launch_sweep<D, PE_POLY_MORE, false>(
                    attn_stream_bwd_dcoeff_kernel<D, PE_POLY_MORE>, p, stream)
              : launch_sweep<D, PE_POLY, false>(attn_stream_bwd_dcoeff_kernel<D, PE_POLY>, p,
                                                stream);
  else if (pass == PASS_DTABLE)
    err = launch_sweep<D, PE_REL, false>(attn_stream_bwd_dtable_kernel<D>, p, stream);
  else if (pe == PE_POLY)
    err = launch_sweep<D, PE_POLY, true>(attn_stream_bwd_fused_kernel<D, PE_POLY>, p, stream);
  else if (pe == PE_POLY_MORE)
    err = launch_sweep<D, PE_POLY_MORE, true>(attn_stream_bwd_fused_kernel<D, PE_POLY_MORE>, p,
                                              stream);
  else if (pe == PE_REL)
    err = launch_sweep<D, PE_REL, true>(attn_stream_bwd_fused_kernel<D, PE_REL>, p, stream);
  else
    err = launch_sweep<D, PE_NONE, true>(attn_stream_bwd_fused_kernel<D, PE_NONE>, p, stream);
  if (err != cudaSuccess) return err;
  if (pass == PASS_FUSED) {
    const long long total = (long long)p.B * p.H * p.Nq * (D / 8);
    attn_stream_bwd_fused_dq_kernel<<<blocks_for(total), 256, 0, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (pe == PE_POLY || pe == PE_POLY_MORE)
    attn_stream_bwd_dcoeff_sum_kernel<<<1, 256, 0, stream>>>(p);
  else if (pe == PE_REL)
    attn_stream_bwd_dtable_sum_kernel<<<
        blocks_for((long long)p.H * (2 * p.bias.rel_ell - 1)), 256, 0, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch(const Params& p, Pass pass, cudaStream_t stream) {
  switch (p.D) {
    case 16: return launch<16>(p, pass, stream);
    case 32: return launch<32>(p, pass, stream);
    case 64: return launch<64>(p, pass, stream);
    case 128: return launch<128>(p, pass, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The arguments of the C entry points below, unpacked, and one pass launched.
int run(Pass pass, void* const* ptrs, const long long* strides, const int* dims,
        float scale, void* stream) {
  Params p;
  p.q = ptrs[0];
  p.k = ptrs[1];
  p.v = ptrs[2];
  p.g = ptrs[3];
  p.lse = static_cast<const float*>(ptrs[4]);
  p.delta = static_cast<const float*>(ptrs[5]);
  p.dq = static_cast<float*>(ptrs[6]);
  p.dk = static_cast<float*>(ptrs[7]);
  p.dv = static_cast<float*>(ptrs[8]);
  p.dparam = static_cast<float*>(ptrs[10]);
  p.dparam_part = static_cast<float*>(ptrs[11]);
  p.cos = static_cast<const float*>(ptrs[12]);
  p.sin = static_cast<const float*>(ptrs[13]);
  p.bias.bias = nullptr;
  p.bias.coeff = static_cast<const float*>(ptrs[14]);
  p.bias.table = static_cast<const float*>(ptrs[15]);
  p.bias.poly_terms = dims[DIM_POLY_TERMS];
  p.bias.poly_grid = dims[DIM_POLY_GRID];
  p.bias.rel_ell = dims[DIM_REL_ELL];
  p.bias.row0 = dims[DIM_ROW0];
  p.bias.col0 = dims[DIM_COL0];
  p.bias.n_valid = dims[DIM_N_VALID];
  long long* dst[7] = {p.qs, p.ks, p.vs, p.gs, p.dqs, p.dks, p.dvs};
  for (int t = 0; t < 7; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  p.B = dims[DIM_B];
  p.H = dims[DIM_H];
  p.Nq = dims[DIM_N];
  p.Nk = dims[DIM_NK];
  p.NQP = key_tiles(p.Nq) * OWN_ROWS;
  p.NKP = key_tiles(p.Nk) * OWN_ROWS;
  p.kv_valid = dims[DIM_KV_VALID];
  p.D = dims[DIM_D];
  p.is_bf16 = dims[DIM_IS_BF16];
  p.cos_heads = dims[DIM_COS_HEADS];
  p.scale = scale;
  // scratch: the dq slabs first (PASS_FUSED), then the operands
  p.dq_part = pass == PASS_FUSED ? static_cast<float*>(ptrs[9]) : nullptr;
  const long long slab_floats =
      pass == PASS_FUSED ? (long long)slabs(p.Nk) * p.B * p.H * p.NQP * p.D : 0;
  p.ops = reinterpret_cast<__nv_bfloat16*>(static_cast<float*>(ptrs[9]) + slab_floats);
  const bool poly = p.bias.coeff != nullptr, rel = p.bias.table != nullptr;
  if (p.Nq < 1 || p.Nk < 1 || ptrs[9] == nullptr || (poly && rel) ||
      p.bias.poly_terms > MAX_POLY_TERMS ||
      (poly && (p.bias.poly_grid < 1 || p.bias.poly_terms < 1)) ||
      (rel && p.bias.rel_ell < 1) || (p.cos != nullptr && p.Nq != p.Nk) ||
      (pass != PASS_PROLOGUE && (poly || rel) &&
       (p.dparam == nullptr || p.dparam_part == nullptr)) ||
      (pass == PASS_FUSED && (p.dq == nullptr || p.dk == nullptr || p.dv == nullptr)) ||
      (pass == PASS_DCOEFF && !poly) || (pass == PASS_DTABLE && !rel))
    return int(cudaErrorInvalidValue);
  return int(dispatch(p, pass, static_cast<cudaStream_t>(stream)));
}

}  // namespace

// Plain C entry points (bound with ctypes), one per pass, all with the same
// arguments. ptrs holds 16 device pointers: q k v g lse delta dq dk dv scratch
// dparam dparam_part cos sin coeff table (null where absent; dq, dk and dv
// are f32); strides holds 21 element strides: (batch, head, token) of q k v g
// dq dk dv; dims holds the integers of attn::Dim. With NQP, NKP = Nq, Nk
// rounded up to 128, key tiles = ceil(Nk / 128) and slabs = ceil(key tiles /
// CLUSTER): scratch holds f32 dq slabs [slabs, B, H, NQP, D]
// (attn_stream_bwd_fused only), then the bf16 operands qf [B, H, NQP, D], kf
// and bf16 v [B, H, NKP, D], bf16 g [B, H, NQP, D] (with Nq == Nk the
// separate passes' prologue scratch [4, B, H, NQP, D]); dparam_part is f32
// [B, H, key tiles, poly_part_cols(terms)] with coeff (8 columns up to 8
// terms, else the terms rounded up to a multiple of 8), [B, H, key tiles,
// round_up(Nq, 64) + 128] with table. Each returns the CUDA error of its
// launches (0 on success) and does not synchronize.
//
// attn_stream_bwd_fused: the prologue (the operands into the scratch), the
// sweep, the dq sum and, with coeff or table, the parameter sum.
extern "C" int attn_stream_bwd_fused(void* const* ptrs, const long long* strides,
                                     const int* dims, float scale, void* stream) {
  return run(PASS_FUSED, ptrs, strides, dims, scale, stream);
}

// attn_stream_bwd_fused_prologue: the prologue alone.
extern "C" int attn_stream_bwd_fused_prologue(void* const* ptrs, const long long* strides,
                                              const int* dims, float scale, void* stream) {
  return run(PASS_PROLOGUE, ptrs, strides, dims, scale, stream);
}

// attn_stream_bwd_dcoeff / attn_stream_bwd_dtable: the sweep without the
// gradient products and the parameter sum, on operands the scratch already
// holds (the separate passes' prologue's).
extern "C" int attn_stream_bwd_dcoeff(void* const* ptrs, const long long* strides,
                                      const int* dims, float scale, void* stream) {
  return run(PASS_DCOEFF, ptrs, strides, dims, scale, stream);
}

extern "C" int attn_stream_bwd_dtable(void* const* ptrs, const long long* strides,
                                      const int* dims, float scale, void* stream) {
  return run(PASS_DTABLE, ptrs, strides, dims, scale, stream);
}
