// A whole pre-LN transformer block forward, for Hopper (sm_90a), and the
// prologue that rounds the block's four weight matrices to bf16 once.
//
// Replaces: the Pallas kernel `_block_kernel` (launched by `block_forward`)
// of vit_rpe_rope_tpu/ops/block_fused.py.
//
// Computes, for x [B, N, E] (float32 or bfloat16, contiguous) and one
// block's weights (LN and bias vectors float32; Wqkv [3E, E], Wproj [E, E],
// W1 [hidden, E], W2 [E, hidden] rounded to bf16 by the prologue, torch
// layout), per image:
//   h    = LN1(x)                                     f32
//   q, k, v = bf16(h) . bf16(Wqkv)^T                  f32 accumulation
//   q, k rotated (half split, f32, op by op; the cls token, and tokens past
//          the table, unrotated)
//   s    = bf16(q) . bf16(k)^T * scale, keys >= N at -1e30
//   p    = exp(s - max_j s),  den = sum_j p
//   o    = (bf16(p) . bf16(v)) / den
//   x2   = x + (bf16(o) . bf16(Wproj)^T + bproj)
//   f1   = bf16(LN2(x2)) . bf16(W1)^T + b1,  g = 0.5 f1 (1 + erf(f1 / sqrt 2))
//          with erf by Abramowitz & Stegun 7.1.26, as the TPU kernel
//   y    = (x2 + bf16(g) . bf16(W2)^T) + b2
// and writes y in x's dtype. No logits bias, no backward. When the hidden
// width is cut into chunks (below), the fc2 sum is added to x2 one chunk at
// a time: float32 order only.
//
// What bounds it on an H100: operations. At ViT-tiny/4 (B=128, N=65, E=192,
// 6 heads of 32, hidden 768) the five products are 7.8 GFLOP, about 7.9 us at
// 989 TFLOP/s; the activations in and out and the weights are 14.6 MB, about
// 4.4 us at 3.35 TB/s. What sets its time here: every CTA takes in the whole
// block's bf16 weights (0.88 MB at ViT-tiny/4, 3.5 MB at ViT-S/16), so the
// more rows a CTA holds the better, and the CTAs of a cluster share each
// weight tile.
//
// Design: the TPU kernel runs a sequential grid over batch tiles with the
// tile's whole block resident in VMEM. Here one image runs on a thread-block
// cluster of CLUSTER CTAs of 8 warps (launched with cudaLaunchKernelEx; the
// Python plan, block_fused.block_plan, picks the cluster size, rows a CTA,
// the weight tiles' depth, the ring and the layout below, and refuses what
// does not fit in 227 KB a CTA). The image's 16-row tiles are split along
// the tokens: rank r holds tiles r * TILES .. (at most MAX_TILES, a
// template parameter), so LN1, the qkv product, the projection, LN2 and the
// MLP are CTA-local and no LN statistic crosses CTAs. Shared memory of a
// CTA:
//   XRES  f32  [rows, E]   the residual stream
//   HLN  bf16  [rows, E]   LN1's output, then the attention output o, then
//                          LN2's output
//   Q    bf16  [rows, E]   q, rotated, every head
//   K, V bf16  [rows, E]   k (rotated) and v in the order of the mma B
//                          fragments that read them (frag_pos)
//   G    bf16  [rows, CH]  one chunk of the GELU output, over Q, K, V once
//                          every CTA of the cluster is done reading them
//   RING bf16  STAGES (2) x [128 output columns, KT + 8] weight tiles, and a
//                          full and an empty mbarrier a slot
// The prologue kernel rounds the four weight matrices to bf16 once per call
// and lays them out as the ring takes them (tiled_size): each tile one
// contiguous block, so each CTA of a cluster copies its share of a tile's
// rows with one bulk copy (cp.async.bulk) multicast to every CTA of the
// cluster, the cluster reading each tile from L2 once. Warp 0 issues the
// tiles STAGES - 1 ahead; every warp waits on a slot's full barrier and
// arrives on every CTA's empty barrier when done with it (no block-wide
// barrier a tile). Each product keeps its sums in mma.sync.m16n8k16 C
// fragments: warp w owns 16 output columns of each 128-column tile over all
// the CTA's rows, fed by ldmatrix fragments of the activation and of the
// tile; the epilogue works on the fragments (the rotation pairs column d
// with d + Dh/2: the prologue's tiles give each warp the two 8-column
// blocks at d and d + Dh/2 of a head, so both halves sit in its registers).
// After the qkv product a cluster barrier publishes every CTA's K and V;
// the attention of a (16-row tile, head) pair runs on one warp, the pairs
// spread over the 8 warps: scores for all keys in C fragments (up to 13
// blocks of 16 keys, N <= 208), the softmax in registers against the final
// row max, p repacked as the A operand of p . v, the B fragments of K and V
// read as one 16-byte load a lane from the owning CTA's shared memory
// (distributed shared memory through mapa). Each CTA arrives at a second
// cluster barrier once its attention is done and waits on it only before
// the MLP overwrites K and V, after the projection and LN2; a last cluster
// barrier keeps every CTA until no other may still arrive on its barriers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <mutex>

#include "attn_dense.cuh"
#include "cluster.cuh"

namespace {

using namespace attn;
using namespace attn::dense;
using bf16 = __nv_bfloat16;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_TILES = 5;   // 16-row tiles a CTA holds (block_plan's MAX_TILES)
constexpr int SMALL_KEYS = 5;  // key blocks of 16 held in registers: N <= 80
constexpr int MAX_KEYS = 13;   //   and N <= 208 (block_plan's MAX_KEY_BLOCKS)
constexpr int NT = 128;        // output columns of a weight tile, 16 per warp
constexpr int STAGES = 2;      // slots of the weight ring (block_plan's STAGES)
constexpr int MAX_E = 1024;    // embedding widths LN keeps in registers
constexpr int SMEM_LIMIT = 232448;  // shared memory a CTA may use (block_plan's)
static_assert(THREADS == 2 * NT, "two threads load each row of a weight tile");

// Integer arguments of the C entry point, in this order (the Python
// wrapper's _DIMS): shapes, then block_plan's cluster, tile depth, pitches
// (elements) and byte offsets.
enum Dim {
  D_B, D_N, D_E, D_H, D_DH, D_HID, D_IS_BF16, D_HAS_ROPE, D_TAB_ROWS, D_KEY_BLOCKS,
  D_TILES, D_CLUSTER, D_CH, D_KT, D_LDR, D_LDH, D_LDG, D_LDW, D_XRES,
  D_HLN, D_Q, D_K, D_V, D_G, D_RING, D_BAR, D_SMEM, D_COUNT
};

struct Params {
  const void* x;
  void* out;
  const float *n1w, *n1b, *pb, *n2w, *n2b, *b1, *b2;
  const bf16* w;           // Wqkv, Wproj, W1, W2 back to back (the prologue's)
  const float *cos, *sin;  // [TAB_ROWS, DH/2] for tokens 1.., or null
  int d[D_COUNT];
  float eps, scale;
};

// The weight ring: STAGES slots of NT rows (output columns) by KT deep
// (row pitch KT + 8), each with two mbarriers: `full` completes when the
// slot's tile has landed (one local arrive that expects its bytes, and the
// bytes of every CTA's bulk copies), `empty` when every warp of the cluster
// is done with it (WARPS arrivals from each CTA). A tile's rows are copied
// by the cluster's CTAs in turn (row r by rank r % cluster), each row to
// every CTA of the cluster at once (multicast), so the cluster reads each
// weight tile from L2 once. `it` counts the tiles through the ring so far:
// tile it sits in slot it % STAGES, its use it / STAGES of the slot.
struct Ring {
  bf16* base;
  uint64_t *full, *empty;
  int rank, cluster, cluster_id, it;
  uint16_t mask;  // every CTA of the cluster
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// erf by Abramowitz & Stegun 7.1.26 (|error| < 1.5e-7).
__device__ __forceinline__ float erf_as(float x) {
  const float ax = fabsf(x);
  const float t = 1.f / (1.f + 0.3275911f * ax);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float y = 1.f - poly * expf(-ax * ax);
  return x > 0.f ? y : x < 0.f ? -y : 0.f;
}

// mbarriers and bulk copies (PTX ISA, sm_90).
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// One arrival on the barrier at `bar`'s offset in the CTA of `rank`.
__device__ __forceinline__ void mbar_arrive_at(uint64_t* bar, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_addr(bar)), "r"(rank));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(remote) : "memory");
}
// bytes from src (device memory) to dst in this CTA or, with mask, in every
// CTA of the mask (same offset), completing on `bar` there.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar, uint16_t mask) {
  if (mask > 1)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
        " [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar)), "h"(mask)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        "\n" ::"r"(smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

// K and V of a CTA's rows are kept in the order of the mma B fragments that
// read them, so that a lane takes its four registers of a 16 x 16 block in
// one 16-byte load (through distributed shared memory for another CTA's):
// block (row block rb, column block cb) is 256 values at (rb * E / 16 + cb)
// * 256, and its element (n, k) of the B operand at frag_pos(n, k): lane
// 4 (n % 8) + (k % 8) / 2, registers n / 8 * 2 + k / 8 (k pairs). K's n is
// the key (its row), k the head's column; V's n the column, k the key.
__device__ __forceinline__ int frag_pos(int n, int k) {
  return ((n & 7) * 4 + ((k & 7) >> 1)) * 8 + (n >> 3) * 4 + (k >> 3) * 2 + (k & 1);
}

// The first output column of 16-column pair `pair` of a product whose
// columns come in groups of `group` (the head dim for qkv, else 16): a warp's
// two 8-column blocks are at this column and `group / 2` after it.
__device__ __forceinline__ int pair_col(int pair, int group) {
  const int per = group / 16;
  return (pair / per) * group + (pair % per) * 8;
}

// The four weight matrices as the ring takes them, rounded to bf16 by the
// prologue: Wqkv [3E, E] (columns in groups of DH), Wproj [E, E], W1
// [HID, E], W2 [E, HID] (groups of 16), each cut into tiles of NT output
// columns by KT, tile (ct, kt) one contiguous [NT, KT + 8] block in slot row
// order (row r is output column col(ct, r)), zeros past the width, past K
// and in the 8 padding columns, so that a tile (or a CTA's share of its
// rows) is one bulk copy. Elements of a matrix's tiles:
__host__ __device__ inline long long tiled_size(int width, int K, int kt) {
  return (long long)((width + NT - 1) / NT) * ((K + kt - 1) / kt) * NT * (kt + 8);
}

// A product's weights as the ring takes them: W's tiles as the prologue
// lays them out at `tiles` (n_kt_all k tiles a column tile), the product's
// columns from tile ct0 on (width of them), its k from tile kt0 on (K).
struct Operand {
  const bf16* tiles;
  int n_kt_all, ct0, kt0, width, K;
};

// Warp 0: tile j of the product `w`, the ring's tile it0 + j: once every warp
// of the cluster is done with the slot's last tile, one bulk copy of this
// CTA's share of the tile's rows (rank r copies rows r * NT / cluster ..
// (r + 1) * NT / cluster), multicast to every CTA of the cluster. The
// clusters start at different column tiles (their L2 reads spread over the
// weights).
template <int KT>
__device__ __forceinline__ void issue_tile(const Ring& ring, const Operand& w, int it0, int j) {
  constexpr int LDW = KT + 8, SLOT = NT * LDW;
  const int n_ct = (w.width + NT - 1) / NT, n_kt = (w.K + KT - 1) / KT;
  const int it = it0 + j, slot = it % STAGES;
  if (it >= STAGES) mbar_wait(ring.empty + slot, (it / STAGES - 1) & 1);
  if (threadIdx.x % 32 == 0) {
    int ct = j / n_kt + ring.cluster_id % n_ct;
    ct = ct < n_ct ? ct : ct - n_ct;
    const int r0 = ring.rank * NT / ring.cluster, share = (ring.rank + 1) * NT / ring.cluster - r0;
    mbar_expect_tx(ring.full + slot, uint32_t(SLOT * 2));
    const bf16* src = w.tiles + ((long long)(w.ct0 + ct) * w.n_kt_all + w.kt0 + j % n_kt) * SLOT;
    bulk_copy(ring.base + slot * SLOT + r0 * LDW, src + r0 * LDW, uint32_t(share * LDW * 2),
              ring.full + slot, ring.mask);
  }
  __syncwarp();
}

// out[16 MT rows, w.width] = a[rows, w.K] . W^T, a bf16 in shared memory
// (pitch lda), W through the ring: warp 0 issues each tile STAGES - 1 tiles
// ahead (issue_tile); warp w multiplies
// pair ct * 8 + w of each tile over the CTA's MT row tiles. For each 16-row
// tile, `epi(row, c1, c2, x1[2], x2[2])` receives the sums at (row,
// c1..c1+1) and (row, c2..c2+1), c2 = c1 + group / 2, columns from w.ct0 *
// NT on. Ends with a barrier.
template <int MT, int KT, typename Epi>
__device__ __forceinline__ void gemm(const bf16* a, int lda, const Operand& w, int group,
                                     Ring& ring, Epi epi) {
  constexpr int LDW = KT + 8, SLOT = NT * LDW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, K = w.K;
  const int n_ct = (w.width + NT - 1) / NT, n_kt = (K + KT - 1) / KT, total = n_ct * n_kt;
  const int pairs = w.width / 16, it0 = ring.it;
  const int shift = ring.cluster_id % n_ct;
  auto col_tile = [&](int j) {
    const int ct = j / n_kt + shift;
    return ct < n_ct ? ct : ct - n_ct;
  };
  if (warp == 0)
    for (int j = 0; j < STAGES - 1 && j < total; ++j) issue_tile<KT>(ring, w, it0, j);
  float acc[MT][2][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e / 4][e % 4] = 0.f;
  const bf16* a_lane = a + (lane & 15) * lda + (lane >> 4) * 8;
  const int b_lane = (warp * 16 + (lane & 7) + (lane >> 4) * 8) * LDW + ((lane >> 3) & 1) * 8;
  for (int j = 0; j < total; ++j) {
    if (warp == 0 && j + STAGES - 1 < total) issue_tile<KT>(ring, w, it0, j + STAGES - 1);
    const int it = it0 + j, slot = it % STAGES;
    mbar_wait(ring.full + slot, (it / STAGES) & 1);
    const int ct = col_tile(j), kt = j % n_kt;
    const int pair = ct * (NT / 16) + warp;
    if (pair < pairs) {
      const bf16* b_tile = ring.base + slot * SLOT + b_lane;
      const bf16* a_k = a_lane + kt * KT;
      if (kt * KT + KT <= K) {
#pragma unroll
        for (int ks = 0; ks < KT; ks += 16) {
          uint32_t b[4], af[MT][4];
          ldsm_x4(b, b_tile + ks);
#pragma unroll
          for (int i = 0; i < MT; ++i) ldsm_x4(af[i], a_k + i * 16 * lda + ks);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            mma(acc[i][0], af[i], b[0], b[1]);
            mma(acc[i][1], af[i], b[2], b[3]);
          }
        }
      } else {  // the last k tile of a K that is not a multiple of KT
        for (int ks = 0; ks < K - kt * KT; ks += 16) {
          uint32_t b[4], af[MT][4];
          ldsm_x4(b, b_tile + ks);
#pragma unroll
          for (int i = 0; i < MT; ++i) ldsm_x4(af[i], a_k + i * 16 * lda + ks);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            mma(acc[i][0], af[i], b[0], b[1]);
            mma(acc[i][1], af[i], b[2], b[3]);
          }
        }
      }
      if (kt == n_kt - 1) {
        const int c1 = pair_col(pair, group) + 2 * (lane & 3), c2 = c1 + group / 2;
#pragma unroll
        for (int i = 0; i < MT; ++i) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const float x1[2] = {acc[i][0][2 * hf], acc[i][0][2 * hf + 1]};
            const float x2[2] = {acc[i][1][2 * hf], acc[i][1][2 * hf + 1]};
            epi(i * 16 + (lane >> 2) + hf * 8, c1, c2, x1, x2);
          }
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[i][e / 4][e % 4] = 0.f;
        }
      }
    }
    __syncwarp();  // the warp is done reading the slot: one arrival on each CTA's empty
    if (lane < ring.cluster) mbar_arrive_at(ring.empty + slot, lane);
  }
  ring.it += total;
  __syncthreads();
}

// dst = bf16(LayerNorm(xres)) over the CTA's rows, in f32 with the biased
// variance (two passes over the row, kept in registers: a lane holds
// columns 4 lane + 128 j ..); rows of tokens >= N are zeros. One warp per
// row.
__device__ void layer_norm(const Params& p, const float* xres, bf16* dst, int rows, int row0,
                           const float* w, const float* b) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int N = p.d[D_N], E = p.d[D_E], ldr = p.d[D_LDR], ldh = p.d[D_LDH];
  for (int r = warp; r < rows; r += WARPS) {
    bf16* out = dst + r * ldh;
    const float* row = xres + r * ldr;
    const bool valid = row0 + r < N;
    float v[MAX_E / 128][4];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_E / 128; ++j) {
      const int c = lane * 4 + j * 128;
      if (c < E) {
        load4(row + c, v[j]);
        s += (v[j][0] + v[j][1]) + (v[j][2] + v[j][3]);
      }
    }
    const float mean = warp_sum(s) / E;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_E / 128; ++j) {
      if (lane * 4 + j * 128 < E) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float dv = v[j][u] - mean;
          q += dv * dv;
        }
      }
    }
    const float inv = 1.f / sqrtf(warp_sum(q) / E + p.eps);
#pragma unroll
    for (int j = 0; j < MAX_E / 128; ++j) {
      const int c = lane * 4 + j * 128;
      if (c < E) {
        float y[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          y[u] = valid ? __fadd_rn(__fmul_rn(__fmul_rn(v[j][u] - mean, inv), w[c + u]), b[c + u])
                       : 0.f;
        put4(out + c, y);
      }
    }
  }
}

// The attention of the CTA's MT row tiles, every head: o into o_s (HLN). KB:
// key blocks of 16 held in registers (>= the image's). Key block kb lives in
// the CTA of rank kb / TILES, as its block kb % TILES; a lane reads its B
// fragment of a 16 x 16 block of K or V (frag_pos) in one 16-byte load
// through distributed shared memory (the CTA's own too: one code path for
// every rank).
template <int KB, int MT>
__device__ void attention(const Params& p, const bf16* q_s, const bf16* k_s, const bf16* v_s,
                          bf16* o_s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int N = p.d[D_N], H = p.d[D_H], DH = p.d[D_DH], ldh = p.d[D_LDH];
  const int nkb = p.d[D_KEY_BLOCKS], eb = p.d[D_E] / 16;
  for (int pr = warp; pr < MT * H; pr += WARPS) {
    const int i = pr % MT, h = pr / MT;
    float s[KB][2][4];
#pragma unroll
    for (int kb = 0; kb < KB; ++kb)
#pragma unroll
      for (int e = 0; e < 8; ++e) s[kb][e / 4][e % 4] = 0.f;
    for (int dc = 0; dc < DH; dc += 16) {
      uint32_t qa[4];
      ldsm_x4(qa, q_s + (i * 16 + (lane & 15)) * ldh + h * DH + dc + (lane >> 4) * 8);
      int owner = 0, lt = 0;  // the cluster rank that holds key block kb, its block there
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        if (kb < nkb) {
          const int src = owner;  // the rank whose K and V hold the block
          const uint4 b = *reinterpret_cast<const uint4*>(
              cluster_map(k_s + (lt * eb + (h * DH + dc) / 16) * 256, src) + lane * 8);
          mma(s[kb][0], qa, b.x, b.y);
          mma(s[kb][1], qa, b.z, b.w);
        }
        if (++lt == MT) lt = 0, ++owner;
      }
    }
    // scaled, masked, against the final max of rows g and g + 8
    float m[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
      if (kb < nkb) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int key = kb * 16 + (e / 4) * 8 + 2 * t + (e & 1);
          float& x = s[kb][e / 4][e % 4];
          x = key < N ? __fmul_rn(x, p.scale) : NEG_INF;
          m[(e >> 1) & 1] = fmaxf(m[(e >> 1) & 1], x);
        }
      }
    }
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
    }
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
      if (kb < nkb) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float& x = s[kb][e / 4][e % 4];
          x = expf(x - m[(e >> 1) & 1]);
          l[(e >> 1) & 1] += x;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    // o = bf16(p) . v, 16 columns of the head at a time, then / den
    for (int dc = 0; dc < DH; dc += 16) {
      float o[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      int owner = 0, lt = 0;
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        if (kb < nkb) {
          const int src = owner;  // the rank whose K and V hold the block
          const uint4 b = *reinterpret_cast<const uint4*>(
              cluster_map(v_s + (lt * eb + (h * DH + dc) / 16) * 256, src) + lane * 8);
          uint32_t pa[4];  // bf16(p), the A operand over the block's 16 keys
          pack_a(pa, s[kb][0], s[kb][1]);
          mma(o[0], pa, b.x, b.y);
          mma(o[1], pa, b.z, b.w);
        }
        if (++lt == MT) lt = 0, ++owner;
      }
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        bf16* dst = o_s + (i * 16 + g) * ldh + h * DH + dc + nb * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(dst) =
            pack(__fdiv_rn(o[nb][0], l[0]), __fdiv_rn(o[nb][1], l[0]));
        *reinterpret_cast<uint32_t*>(dst + 8 * ldh) =
            pack(__fdiv_rn(o[nb][2], l[1]), __fdiv_rn(o[nb][3], l[1]));
      }
    }
  }
}

// One image's block over a cluster: the CTA of rank r holds 16-row tiles r *
// TILES .. + TILES (tiles past the image are padding, computed and dropped).
// KT: the depth of the weight tiles.
template <int TILES, int KB, int KT>
__global__ void __launch_bounds__(THREADS, 1) block_fused_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ROWS = 16 * TILES;
  const int N = p.d[D_N], E = p.d[D_E], DH = p.d[D_DH], HID = p.d[D_HID], CH = p.d[D_CH];
  const int ldr = p.d[D_LDR], ldh = p.d[D_LDH], ldg = p.d[D_LDG], eb = E / 16;
  float* xres = reinterpret_cast<float*>(smem + p.d[D_XRES]);
  bf16* hln = reinterpret_cast<bf16*>(smem + p.d[D_HLN]);
  bf16* q_s = reinterpret_cast<bf16*>(smem + p.d[D_Q]);
  bf16* k_s = reinterpret_cast<bf16*>(smem + p.d[D_K]);
  bf16* v_s = reinterpret_cast<bf16*>(smem + p.d[D_V]);
  bf16* g_s = reinterpret_cast<bf16*>(smem + p.d[D_G]);
  const int cluster = p.d[D_CLUSTER], rank = cluster_rank();
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + p.d[D_BAR]);
  Ring ring = {reinterpret_cast<bf16*>(smem + p.d[D_RING]),
               bars,
               bars + STAGES,
               rank,
               cluster,
               int(blockIdx.x) / cluster,
               0,
               uint16_t((1u << cluster) - 1)};
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(ring.full + s, 1);
      mbar_init(ring.empty + s, cluster * WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_arrive();  // every CTA's barriers are set up before any copy or arrival
  cluster_wait();
  const int row0 = rank * ROWS;  // the CTA's first token
  const long long img = (long long)(blockIdx.x / cluster) * N * E;
  const bool bf16_io = p.d[D_IS_BF16] != 0;
  const bf16* wqkv = p.w;  // the prologue's tiles of each matrix
  const bf16* wp = wqkv + tiled_size(3 * E, E, KT);
  const bf16* w1 = wp + tiled_size(E, E, KT);
  const bf16* w2 = w1 + tiled_size(HID, E, KT);
  const int e_tiles = (E + KT - 1) / KT, hid_tiles = (HID + KT - 1) / KT;

  // the residual stream of the CTA's rows, rows of tokens >= N zero; each
  // thread issues four loads before it stores any
  const int quads = ROWS * (E / 4);
  for (int i0 = threadIdx.x; i0 < quads; i0 += 4 * THREADS) {
    float v[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * THREADS, r = i / (E / 4), c = (i % (E / 4)) * 4;
      const long long at = img + (long long)(row0 + r) * E + c;
#pragma unroll
      for (int e = 0; e < 4; ++e) v[u][e] = 0.f;
      if (i < quads && row0 + r < N) {
        if (bf16_io)
          load4(static_cast<const bf16*>(p.x) + at, v[u]);
        else
          load4(static_cast<const float*>(p.x) + at, v[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * THREADS, r = i / (E / 4), c = (i % (E / 4)) * 4;
      if (i < quads) store4(xres + r * ldr + c, v[u][0], v[u][1], v[u][2], v[u][3]);
    }
  }
  __syncthreads();
  layer_norm(p, xres, hln, ROWS, row0, p.n1w, p.n1b);
  __syncthreads();

  // q, k (rotated) and v of every head, bf16
  const bool rope = p.d[D_HAS_ROPE] != 0;
  const int H2 = DH / 2, tab_rows = p.d[D_TAB_ROWS];
  gemm<TILES, KT>(hln, ldh, Operand{wqkv, e_tiles, 0, 0, 3 * E, E}, DH, ring,
              [&](int r, int c1, int c2, const float (&x1)[2], const float (&x2)[2]) {
                const int part = c1 / E, c = c1 % E, tok = row0 + r;
                const int block = (r / 16) * eb;  // K's and V's block row
                if (part == 2) {
#pragma unroll
                  for (int u = 0; u < 2; ++u) {
                    v_s[(block + (c + u) / 16) * 256 + frag_pos((c + u) % 16, r % 16)] =
                        __float2bfloat16(x1[u]);
                    v_s[(block + (c + u + H2) / 16) * 256 + frag_pos((c + u + H2) % 16, r % 16)] =
                        __float2bfloat16(x2[u]);
                  }
                  return;
                }
                float y1[2] = {x1[0], x1[1]}, y2[2] = {x2[0], x2[1]};
                if (rope && tok >= 1 && tok <= tab_rows && tok < N) {
                  const int d = c % DH;
#pragma unroll
                  for (int u = 0; u < 2; ++u) {
                    const float cs = p.cos[(long long)(tok - 1) * H2 + d + u];
                    const float sn = p.sin[(long long)(tok - 1) * H2 + d + u];
                    y1[u] = __fsub_rn(__fmul_rn(x1[u], cs), __fmul_rn(x2[u], sn));
                    y2[u] = __fadd_rn(__fmul_rn(x1[u], sn), __fmul_rn(x2[u], cs));
                  }
                }
                uint32_t* dst1;  // where the pairs at columns c and c + Dh/2 go
                uint32_t* dst2;
                if (part == 0) {
                  dst1 = reinterpret_cast<uint32_t*>(q_s + r * ldh + c);
                  dst2 = reinterpret_cast<uint32_t*>(q_s + r * ldh + c + H2);
                } else {
                  dst1 = reinterpret_cast<uint32_t*>(
                      k_s + (block + c / 16) * 256 + frag_pos(r % 16, c % 16));
                  dst2 = reinterpret_cast<uint32_t*>(
                      k_s + (block + (c + H2) / 16) * 256 + frag_pos(r % 16, (c + H2) % 16));
                }
                *dst1 = pack(y1[0], y1[1]);
                *dst2 = pack(y2[0], y2[1]);
              });
  cluster_arrive();  // K and V published to the cluster
  cluster_wait();

  attention<KB, TILES>(p, q_s, k_s, v_s, hln);
  __syncthreads();
  cluster_arrive();  // done reading the cluster's K and V

  // x2 = x + (o . Wproj^T + bproj)
  gemm<TILES, KT>(hln, ldh, Operand{wp, e_tiles, 0, 0, E, E}, 16, ring,
              [&](int r, int c1, int c2, const float (&x1)[2], const float (&x2)[2]) {
                float* row = xres + r * ldr;
#pragma unroll
                for (int u = 0; u < 2; ++u) {
                  row[c1 + u] = __fadd_rn(row[c1 + u], __fadd_rn(x1[u], p.pb[c1 + u]));
                  row[c2 + u] = __fadd_rn(row[c2 + u], __fadd_rn(x2[u], p.pb[c2 + u]));
                }
              });
  layer_norm(p, xres, hln, ROWS, row0, p.n2w, p.n2b);
  __syncthreads();
  cluster_wait();  // every CTA is done with this CTA's K and V: G may take them

  for (int c0 = 0; c0 < HID; c0 += CH) {
    const int cw = min(CH, HID - c0);
    gemm<TILES, KT>(hln, ldh, Operand{w1, e_tiles, c0 / NT, 0, cw, E}, 16, ring,
                [&](int r, int c1, int c2, const float (&x1)[2], const float (&x2)[2]) {
                  float y1[2], y2[2];
#pragma unroll
                  for (int u = 0; u < 2; ++u) {
                    const float f1 = __fadd_rn(x1[u], p.b1[c0 + c1 + u]);
                    const float f2 = __fadd_rn(x2[u], p.b1[c0 + c2 + u]);
                    y1[u] = __fmul_rn(__fmul_rn(0.5f, f1),
                                      1.f + erf_as(__fmul_rn(f1, 0.70710677f)));
                    y2[u] = __fmul_rn(__fmul_rn(0.5f, f2),
                                      1.f + erf_as(__fmul_rn(f2, 0.70710677f)));
                  }
                  *reinterpret_cast<uint32_t*>(g_s + r * ldg + c1) = pack(y1[0], y1[1]);
                  *reinterpret_cast<uint32_t*>(g_s + r * ldg + c2) = pack(y2[0], y2[1]);
                });
    gemm<TILES, KT>(g_s, ldg, Operand{w2, hid_tiles, 0, c0 / KT, E, cw}, 16, ring,
                [&](int r, int c1, int c2, const float (&x1)[2], const float (&x2)[2]) {
                  float* row = xres + r * ldr;
#pragma unroll
                  for (int u = 0; u < 2; ++u) {
                    row[c1 + u] = __fadd_rn(row[c1 + u], x1[u]);
                    row[c2 + u] = __fadd_rn(row[c2 + u], x2[u]);
                  }
                });
  }

  for (int i = threadIdx.x; i < ROWS * (E / 4); i += THREADS) {
    const int r = i / (E / 4), c = (i % (E / 4)) * 4;
    if (row0 + r >= N) continue;
    const float* x = xres + r * ldr + c;
    const float y[4] = {__fadd_rn(x[0], p.b2[c]), __fadd_rn(x[1], p.b2[c + 1]),
                        __fadd_rn(x[2], p.b2[c + 2]), __fadd_rn(x[3], p.b2[c + 3])};
    const long long at = img + (long long)(row0 + r) * E + c;
    if (bf16_io)
      store4(static_cast<bf16*>(p.out) + at, y[0], y[1], y[2], y[3]);
    else
      store4(static_cast<float*>(p.out) + at, y[0], y[1], y[2], y[3]);
  }
  cluster_arrive();  // no CTA leaves while others may still arrive on its barriers
  cluster_wait();
}

struct Weights {
  const float* src[4];  // float32, contiguous
  int width[4], K[4], group[4];
  long long offset[5];  // each matrix's first element in dst; offset[4] the total
  int kt;
  bf16* dst;
};

// One thread per 16-byte piece (8 values) of the tiles, over a grid-stride
// loop.
__global__ void block_fused_prologue_kernel(const Weights w) {
  const int ldw = w.kt + 8;
  for (long long i = (blockIdx.x * (long long)blockDim.x + threadIdx.x) * 8; i < w.offset[4];
       i += (long long)gridDim.x * blockDim.x * 8) {
    int m = 0;
    while (i >= w.offset[m + 1]) ++m;
    const long long local = i - w.offset[m], row = local / ldw;
    const int c = int(local % ldw), r = int(row % NT), n_kt = (w.K[m] + w.kt - 1) / w.kt;
    const int ct = int(row / NT / n_kt), kt = int(row / NT % n_kt);
    const int nb = r / 8, pair = ct * (NT / 16) + (nb >> 1), k = kt * w.kt + c;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (c < w.kt && pair < w.width[m] / 16 && k < w.K[m]) {
      const int col = pair_col(pair, w.group[m]) + (nb & 1) * (w.group[m] / 2) + r % 8;
      const float* src = w.src[m] + (long long)col * w.K[m] + k;
      float lo[4], hi[4];
      load4(src, lo);
      load4(src + 4, hi);
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = lo[u], v[u + 4] = hi[u];
    }
    *reinterpret_cast<uint4*>(w.dst + i) =
        make_uint4(pack(v[0], v[1]), pack(v[2], v[3]), pack(v[4], v[5]), pack(v[6], v[7]));
  }
}

using Kernel = void (*)(Params);

template <int KB, int KT>
Kernel kernel_for(int tiles) {
  switch (tiles) {
    case 1: return block_fused_kernel<1, KB, KT>;
    case 2: return block_fused_kernel<2, KB, KT>;
    case 3: return block_fused_kernel<3, KB, KT>;
    case 4: return block_fused_kernel<4, KB, KT>;
    default: return block_fused_kernel<5, KB, KT>;
  }
}

// Launches of the block kernel that cannot run: no cluster of this size
// and shared memory fits on the card (block_fused_fwd returns it).
constexpr int NO_CLUSTER_FITS = -1;

struct Launchable {
  Kernel kernel;
  int device, cluster, smem, clusters;
};

cudaError_t launch(Kernel kernel, const Params& p, cudaStream_t stream, int* active_clusters) {
  const int smem = p.d[D_SMEM], cluster = p.d[D_CLUSTER];
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(p.d[D_B]) * unsigned(cluster));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  // The attributes once per (instance, device) (every launch stays within
  // them), the occupancy query once per (instance, device, cluster, smem).
  // ctypes releases the GIL around the call, so the caches take a lock.
  static std::mutex lock;
  static Launchable configured[64], seen[64];
  static int n_configured = 0, n_seen = 0;
  std::lock_guard<std::mutex> guard(lock);
  bool known = false;
  for (int i = 0; i < n_configured; ++i)
    known = known || (configured[i].kernel == kernel && configured[i].device == device);
  if (!known) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return err;
    }
    if (n_configured < 64) configured[n_configured++] = {kernel, device, 0, 0, 0};
  }
  int clusters = -1;
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].kernel == kernel && seen[i].device == device && seen[i].cluster == cluster &&
        seen[i].smem == smem)
      clusters = seen[i].clusters;
  if (clusters < 0) {
    if ((err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg)) != cudaSuccess) {
      cudaGetLastError();
      return err;
    }
    if (n_seen < 64) seen[n_seen++] = {kernel, device, cluster, smem, clusters};
  }
  *active_clusters = clusters;
  if (clusters < 1) return cudaError_t(NO_CLUSTER_FITS);
  if ((err = cudaLaunchKernelEx(&cfg, kernel, p)) != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no error for the next one
    return err;
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes); each returns the CUDA error of
// its launch (0 on success) and does not synchronize.
//
// block_fused_prologue: ptrs = Wqkv Wproj W1 W2 (float32, contiguous) and
// the bf16 destination of tiled_size elements each; dims = E, HID, DH, KT.
extern "C" int block_fused_prologue(void* const* ptrs, const int* dims, void* stream) {
  const int E = dims[0], HID = dims[1], DH = dims[2], kt = dims[3];
  if (E < 16 || E % 16 || HID < 16 || HID % 16 || DH < 16 || DH % 16 || E % DH ||
      (kt != 64 && kt != 128))
    return int(cudaErrorInvalidValue);
  Weights w;
  const int width[4] = {3 * E, E, HID, E}, K[4] = {E, E, E, HID}, group[4] = {DH, 16, 16, 16};
  w.offset[0] = 0;
  for (int m = 0; m < 4; ++m) {
    w.src[m] = static_cast<const float*>(ptrs[m]);
    w.width[m] = width[m];
    w.K[m] = K[m];
    w.group[m] = group[m];
    w.offset[m + 1] = w.offset[m] + tiled_size(width[m], K[m], kt);
  }
  w.kt = kt;
  w.dst = static_cast<bf16*>(ptrs[4]);
  const long long blocks = (w.offset[4] / 8 + 255) / 256;
  block_fused_prologue_kernel<<<unsigned(blocks < 2048 ? blocks : 2048), 256, 0,
                                static_cast<cudaStream_t>(stream)>>>(w);
  return int(cudaGetLastError());
}

// block_fused_fwd: ptrs holds 12 device pointers: x out norm1.weight
// norm1.bias proj.bias norm2.weight norm2.bias fc1.bias fc2.bias (float32)
// the prologue's bf16 weights, cos sin (float32 [TAB_ROWS, DH/2] for tokens
// 1.., or null); dims holds the integers of Dim. Writes the number of
// clusters that can be resident at once to *active_clusters; returns -1 if
// none can.
extern "C" int block_fused_fwd(void* const* ptrs, const int* dims, float eps, float scale,
                               void* stream, int* active_clusters) {
  Params p;
  p.x = ptrs[0];
  p.out = ptrs[1];
  p.n1w = static_cast<const float*>(ptrs[2]);
  p.n1b = static_cast<const float*>(ptrs[3]);
  p.pb = static_cast<const float*>(ptrs[4]);
  p.n2w = static_cast<const float*>(ptrs[5]);
  p.n2b = static_cast<const float*>(ptrs[6]);
  p.b1 = static_cast<const float*>(ptrs[7]);
  p.b2 = static_cast<const float*>(ptrs[8]);
  p.w = static_cast<const bf16*>(ptrs[9]);
  p.cos = static_cast<const float*>(ptrs[10]);
  p.sin = static_cast<const float*>(ptrs[11]);
  for (int i = 0; i < D_COUNT; ++i) p.d[i] = dims[i];
  p.eps = eps;
  p.scale = scale;
  const int E = p.d[D_E], DH = p.d[D_DH], kb = p.d[D_KEY_BLOCKS], tiles = p.d[D_TILES];
  const int cluster = p.d[D_CLUSTER], kt = p.d[D_KT];
  if (p.d[D_B] < 1 || p.d[D_N] < 1 || kb * 16 < p.d[D_N] || kb > MAX_KEYS || E % 16 ||
      E > MAX_E || DH % 16 || p.d[D_H] * DH != E || p.d[D_HID] % 16 || p.d[D_CH] % 16 ||
      tiles < 1 || tiles > MAX_TILES || cluster < 1 || cluster > 16 ||
      (cluster - 1) * tiles >= kb || cluster * tiles < kb || (kt != 64 && kt != 128) || p.d[D_LDW] != kt + 8 ||
      (p.d[D_CH] < p.d[D_HID] && p.d[D_CH] % NT) ||
      p.d[D_BAR] % 8 || (p.d[D_HAS_ROPE] && (p.cos == nullptr || p.sin == nullptr)))
    return int(cudaErrorInvalidValue);
  const Kernel kernel =
      kb <= SMALL_KEYS ? (kt == 64 ? kernel_for<SMALL_KEYS, 64>(tiles)
                                   : kernel_for<SMALL_KEYS, 128>(tiles))
                       : (kt == 64 ? kernel_for<MAX_KEYS, 64>(tiles)
                                   : kernel_for<MAX_KEYS, 128>(tiles));
  return int(launch(kernel, p, static_cast<cudaStream_t>(stream), active_clusters));
}
