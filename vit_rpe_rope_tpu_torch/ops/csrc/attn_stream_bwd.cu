// Streaming attention backward in separate passes (dq with dbias, dk/dv) from
// the forward's saved logsumexp, with rope and a materialized or generated
// bias, for Hopper (sm_90a).
//
// Replaces: the Pallas kernels `_stream_bwd_dq_kernel`,
// `_stream_bwd_dkv_kernel` and `_stream_bwd_dbias_kernel` of
// vit_rpe_rope_tpu/ops/flash_attention.py, launched by
// `_bwd_streaming` (which also forms delta).
//
// Computes, for q, k, v, g, out [B, H, N, D] (float32 or bfloat16, any
// strides with a unit last-dim stride) and lse [B, H, N] f32, with the JAX
// kernels' rounding points:
//   qf, kf = bf16(rotate(q)), bf16(rotate(k))    rotation in f32
//   delta  = sum_d g * out                       f32, unrounded g
//   s      = qf . kf^T * scale + bias            f32, bias as in the forward;
//                                                 masked keys at -1e30
//   p      = exp(s - lse)                        f32; no max is recomputed
//   gv     = bf16(g) . bf16(v)^T
//   ds     = p * (gv - delta)                    f32
//   dq     = scale * bf16(ds) . kf               (dq kernel)
//   dv     = bf16(p)^T . bf16(g),  dk = scale * bf16(ds)^T . qf   (dk/dv kernel)
//   dqr/dkr = dq/dk before the inverse rotation (f32), then dq/dk rotated
//            back with -sin, in the input dtype
//   dbias  = sum_batch ds, in batch order        f32 [H, N, N] (dq kernel's
//                                                 dbias instance, sum kernel)
// Padded query rows contribute nothing (their p and ds are set to zero in the
// dk/dv kernel and their rows are not written by the dq kernel) and masked
// keys give p = exp(-1e30 - lse) = 0, never NaN.
//
// What bounds them on an H100: operations at long sequences, bytes at
// ViT-S/16@384. At (B=4, H=4, N=4097, D=32, f32) the dq kernel runs three
// products (51.6 GFLOP, about 52 us at 989 TFLOP/s) and the dk/dv kernel four
// (68.7 GFLOP, about 70 us); both also take one exp per logit (268 M, about
// 70 us on the special-function units). At (16, 6, 577, 64) the products are
// 12-16 us and the bytes (q, k, v, g, out, the bias, the outputs) about 25 us;
// dbias adds the bias read and dbias written (16 MB) and, here, the f32 ds
// slabs, written once by the dq kernel and read once by the sum (128 MB).
//
// Design. Four kernels, launched in this order on one stream:
//   prologue   one thread per 8 columns (4 at c, 4 at c + D/2) of a token
//              row: writes qf, kf, bf16 v and bf16 g once per call into
//              contiguous [4, B, H, NP, D] bf16 scratch (NP = N rounded up to
//              128, zero rows past N) and delta [B, H, N]. The passes before
//              this one rotated and rounded every staged tile themselves:
//              K once for every 64-query CTA of its (batch, head) (10 times
//              at N = 577, 65 at N = 4097) and Q once for every key CTA,
//              from strided f32 rows of the qkv product, synchronously.
//              Rounded once, every tile the passes stage is a plain bf16
//              tile of 16-byte rows, half the bytes of an f32 tile, that
//              cp.async copies without passing through registers. The
//              scratch costs 4 * B * H * NP * D * 2 bytes: 31 MB at
//              (16, 6, 577, 64), 17 MB at (2, 4, 16385, 32).
//   dq         one CTA of 8 warps per (128 query rows, head, batch), or per
//              (128 rows, head, batch group) with dbias; each warp owns 16
//              query rows. The CTA walks the keys in tiles of 64 (kf, vb
//              and, with a bias, the f32 bias tile [128 rows, 64 keys]),
//              double-buffered with cp.async: the next tile loads while the
//              current one is multiplied, one barrier per tile. Per 16-key
//              block a warp forms s = qf . kf^T and gv = gb . vb^T with
//              mma.sync.m16n8k16 on ldmatrix fragments (qf and gb held in
//              registers for D <= 64), p and ds in the C fragments, and
//              dq += bf16(ds) . kf from ds repacked in registers. No f32
//              slab, no p/ds block in shared memory. With dbias each f32
//              ds tile goes from the fragments into the batch group's slab
//              [groups, H, N, pitch] (pitch = N rounded up to 4) in 16-byte
//              pieces, stores that the products do not wait for.
//   dk/dv      one CTA of 8 warps per (128 keys, head, batch); each warp owns
//              16 keys. The CTA walks the queries in tiles of 64 (qf, gb,
//              their lse and delta, and the bias tile [64 queries, 128
//              keys]), double-buffered the same way. Per 16-query block a
//              warp forms s^T = kf . qf^T and gv^T = vb . gb^T, p^T and ds^T
//              in registers (lse and delta per query column), and
//              dv += bf16(p^T) . gb, dk += bf16(ds^T) . qf from the repacked
//              fragments. The bias tile is read transposed from shared
//              memory, not down the columns of the [N, N] bias.
//   sum        dbias = the groups' slabs added in group (batch) order.
// The loops over the other axis end at N rounded up to 16 (592 at N = 577),
// not at whole tiles. A materialized bias reaches the kernels with rows of
// `pitch` floats (the wrapper pads it when N is not a multiple of 4), so that
// its tiles are copied in 16-byte pieces. Generated biases step the patch
// coordinates along a thread's fragment columns instead of dividing per
// logit. Every output tile and slab element has one owner: no atomics, a
// second launch is bit-identical; with one batch group the slab holds the
// same bits as the sum of one slab per batch. wgmma and warp specialisation
// are later work: at these tiles the kernels wait on the exponentials and
// the fragment loads as much as on the products.

#include "attn_stream_tiles.cuh"

namespace {

using namespace attn;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* g;
  const void* out;
  const float* lse;     // [B, H, N]
  float* delta;         // [B, H, N], written by the prologue
  __nv_bfloat16* ops;   // [4, B, H, NP, D]: qf, kf, bf16 v, bf16 g
  void* dq;
  void* dk;
  void* dv;
  float* dqr;           // [B, H, N, D] or null
  float* dkr;
  const float* cos;     // [cos_heads, N, D/2] or null
  const float* sin;
  float* dbias;         // [H, N, N] or null
  float* dbias_part;    // [groups, H, N, pitch] ds slabs, with dbias
  BiasArgs bias;        // bias.bias: [H, N, pitch]
  // (batch, head, token) strides of q, k, v, g, dq, dk, dv, out
  long long qs[3], ks[3], vs[3], gs[3], dqs[3], dks[3], dvs[3], os[3];
  int B, H, N, NP, pitch, cos_heads, is_bf16;
  int groups;           // dbias: batch groups, one slab each
  float scale;
};

// The (batch, head) plane of one operand in the prologue's scratch.
__device__ __forceinline__ const __nv_bfloat16* operand(const Params& p, int which,
                                                        long long bh, int D) {
  return p.ops + ((long long)which * p.B * p.H + bh) * p.NP * D;
}

// qf, kf, bf16 v, bf16 g of one token row (8 columns of it per thread) into
// the scratch, and delta of the row. Rows past N are zero.
template <int D, typename T>
__global__ void __launch_bounds__(256) attn_stream_bwd_prologue_kernel(const Params p) {
  using namespace dense;
  constexpr int H2 = D / 2, PER_ROW = D / 8;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long rows = (long long)p.B * p.H * p.NP;
  const long long row = i / PER_ROW;
  if (row >= rows) return;  // whole warps: rows * PER_ROW is a multiple of 256
  const int c = int(i % PER_ROW) * 4;
  const int n = int(row % p.NP);
  const long long bh = row / p.NP;
  const int b = int(bh / p.H), h = int(bh % p.H);
  const float* cos_h = head_table<D>(p.cos, p, h);
  const float* sin_h = head_table<D>(p.sin, p, h);
  const long long at = (long long)n * H2 + c, plane = rows * D;
  const float* cs = cos_h != nullptr ? cos_h + at : nullptr;
  const float* sn = sin_h != nullptr ? sin_h + at : nullptr;
  const bool valid = n < p.N;
  __nv_bfloat16* dst = p.ops + row * D + c;
  round_row<D>(dst, slice<T>(p.q, p.qs, b, h) + n * p.qs[2] + c, cs, sn, valid);
  round_row<D>(dst + plane, slice<T>(p.k, p.ks, b, h) + n * p.ks[2] + c, cs, sn, valid);
  round_row<D>(dst + 2 * plane, slice<T>(p.v, p.vs, b, h) + n * p.vs[2] + c, nullptr, nullptr,
               valid);
  // g, rounded, and with out the row's delta
  float g1[4] = {}, g2[4] = {}, o1[4] = {}, o2[4] = {};
  if (valid) {
    const T* gg = slice<T>(p.g, p.gs, b, h) + n * p.gs[2] + c;
    const T* og = slice<T>(p.out, p.os, b, h) + n * p.os[2] + c;
    load4(gg, g1);
    load4(gg + H2, g2);
    load4(og, o1);
    load4(og + H2, o2);
  }
  float d = 0.f;
#pragma unroll
  for (int u = 0; u < 4; ++u) d += g1[u] * o1[u];
#pragma unroll
  for (int u = 0; u < 4; ++u) d += g2[u] * o2[u];
#pragma unroll
  for (int off = 1; off < PER_ROW; off <<= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
  if (c == 0 && valid) p.delta[bh * p.N + n] = d;
  put4(dst + 3 * plane, g1);
  put4(dst + 3 * plane + H2, g2);
}

// dq for 128 query rows of one (batch, head), over all keys. DBIAS: the CTA
// takes the batches of group blockIdx.z in order, and adds each batch's f32
// ds to its rows of the group's slab.
template <int D, int PE, bool DBIAS>
__global__ void __launch_bounds__(RING_THREADS) attn_stream_bwd_dq_kernel(const Params p) {
  using namespace dense;
  constexpr bool BIAS = PE == PE_BIAS;
  constexpr bool POLY = PE == PE_POLY || PE == PE_POLY_MORE;
  constexpr bool HOLD = hold<D, PE>();
  constexpr int BLD = STEP + 8;  // conflict-free 8-byte reads of (g, 2t)
  using L = Ring<D, BIAS ? OWN_ROWS : 0, BLD, 0, HOLD>;
  constexpr int LD = L::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* own_q = reinterpret_cast<__nv_bfloat16*>(smem + L::OWN_OFF);
  __nv_bfloat16* own_g = own_q + OWN_ROWS * LD;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int N = p.N, h = blockIdx.y;
  const int q0 = blockIdx.x * OWN_ROWS, wrow = warp * 16, row0 = q0 + wrow;
  const int n16 = (N + 15) & ~15, n_steps = (n16 + STEP - 1) / STEP;
  int b_first = blockIdx.z, b_end = blockIdx.z + 1;
  float* slab = nullptr;
  if (DBIAS) {
    const int per = (p.B + p.groups - 1) / p.groups;
    b_first = blockIdx.z * per;
    b_end = min(p.B, b_first + per);
    slab = p.dbias_part + ((long long)blockIdx.z * p.H + h) * N * p.pitch;
  }
  const float* cos_h = head_table<D>(p.cos, p, h);
  const float* sin_h = head_table<D>(p.sin, p, h);
  const HeadBias hb = head_bias(p.bias, h);
  const float* bias_h = BIAS ? p.bias.bias + (long long)h * N * p.pitch : nullptr;
  Patch prow[2] = {};
  if (POLY)
    for (int r = 0; r < 2; ++r) prow[r] = patch_of(hb.row0 + row0 + g4 + 8 * r, hb.grid);

  for (int b = b_first; b < b_end; ++b) {
    const long long bh = (long long)b * p.H + h;
    const __nv_bfloat16* qf = operand(p, 0, bh, D);
    const __nv_bfloat16* kf = operand(p, 1, bh, D);
    const __nv_bfloat16* vb = operand(p, 2, bh, D);
    const __nv_bfloat16* gb = operand(p, 3, bh, D);
    auto stage_step = [&](int t) {  // step t's tiles into slot t % 2
      unsigned char* slot = smem + (t & 1) * L::SLOT;
      const int k0 = t * STEP;
      stage_rows<D>(reinterpret_cast<__nv_bfloat16*>(slot), kf + (long long)k0 * D, STEP);
      stage_rows<D>(reinterpret_cast<__nv_bfloat16*>(slot + L::TILE), vb + (long long)k0 * D,
                    STEP);
      if (BIAS)
        stage_bias<OWN_ROWS, STEP, BLD>(reinterpret_cast<float*>(slot + L::BIAS_OFF), bias_h,
                                         p.pitch, N, q0, k0);
      cp_async_commit();
    };

    __syncthreads();  // every warp is done with the last batch's tiles
    stage_rows<D>(own_q, qf + (long long)q0 * D, OWN_ROWS);
    stage_rows<D>(own_g, gb + (long long)q0 * D, OWN_ROWS);
    cp_async_commit();
    if (!HOLD) stage_step(0);
    cp_async_wait_all();
    __syncthreads();
    uint32_t qa[HOLD ? D / 16 : 1][4], ga[HOLD ? D / 16 : 1][4];
    if (HOLD) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        load_a<LD>(qa[kk], own_q, wrow, kk * 16);
        load_a<LD>(ga[kk], own_g, wrow, kk * 16);
      }
      __syncthreads();  // the ring may now overwrite the own tiles
      stage_step(0);
    }

    float lse[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = row0 + g4 + 8 * r;
      lse[r] = qi < N ? p.lse[bh * N + qi] : 0.f;
      dl[r] = qi < N ? p.delta[bh * N + qi] : 0.f;
    }
    Patch pc = {};  // the column 2 * t4 of the current 16-key block
    if (POLY) pc = patch_of(hb.col0 + 2 * t4, hb.grid);
    float acc[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

    for (int t = 0; t < n_steps; ++t) {
      cp_async_wait_all();
      __syncthreads();  // step t has landed; every warp is done with step t - 1
      if (t + 1 < n_steps) stage_step(t + 1);
      const unsigned char* slot = smem + (t & 1) * L::SLOT;
      const __nv_bfloat16* ks = reinterpret_cast<const __nv_bfloat16*>(slot);
      const __nv_bfloat16* vs = reinterpret_cast<const __nv_bfloat16*>(slot + L::TILE);
      const float* bs = reinterpret_cast<const float*>(slot + L::BIAS_OFF);
      const int k0 = t * STEP;
      const int blocks = min(STEP, n16 - k0) / 16;
#pragma unroll 1
      for (int j = 0; j < blocks; ++j) {
        float s[2][4] = {}, gv[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t a[4], bb[4];
          if (HOLD) {
#pragma unroll
            for (int u = 0; u < 4; ++u) a[u] = qa[kk][u];
          } else {
            load_a<LD>(a, own_q, wrow, kk * 16);
          }
          load_bt<LD>(bb, ks, j * 16, kk * 16);
          mma(s[0], a, bb[0], bb[1]);
          mma(s[1], a, bb[2], bb[3]);
          if (HOLD) {
#pragma unroll
            for (int u = 0; u < 4; ++u) a[u] = ga[kk][u];
          } else {
            load_a<LD>(a, own_g, wrow, kk * 16);
          }
          load_bt<LD>(bb, vs, j * 16, kk * 16);
          mma(gv[0], a, bb[0], bb[1]);
          mma(gv[1], a, bb[2], bb[3]);
        }
        Patch pk[2][2] = {};
        if (POLY) {
          pk[0][0] = pc;
          pk[1][0] = pc;
          advance(pk[1][0], 8, hb.grid);
          pk[0][1] = pk[0][0];
          next_patch(pk[0][1], hb.grid);
          pk[1][1] = pk[1][0];
          next_patch(pk[1][1], hb.grid);
          advance(pc, 16, hb.grid);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          float2 bias2[2] = {};
          if (BIAS) {
#pragma unroll
            for (int r = 0; r < 2; ++r)
              bias2[r] = *reinterpret_cast<const float2*>(
                  bs + (wrow + g4 + 8 * r) * BLD + j * 16 + nt * 8 + 2 * t4);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, c = e & 1;
            const int qi = row0 + g4 + 8 * r;
            const int kj = k0 + j * 16 + nt * 8 + 2 * t4 + c;
            const float x = frag_logit<PE>(s[nt][e], qi, kj, N, p.scale, hb,
                                           c ? bias2[r].y : bias2[r].x, prow[r], pk[nt][c]);
            const float pr = expf(x - lse[r]);
            s[nt][e] = __fmul_rn(pr, __fsub_rn(gv[nt][e], dl[r]));
          }
        }
        if (DBIAS) {
          add_tile(slab, p.pitch, row0, k0 + j * 16, N, p.pitch, s[0], b == b_first);
          add_tile(slab, p.pitch, row0, k0 + j * 16 + 8, N, p.pitch, s[1], b == b_first);
        }
        uint32_t da[4];
        pack_a(da, s[0], s[1]);
#pragma unroll
        for (int n = 0; n < D / 16; ++n) {
          uint32_t bb[4];
          load_b<LD>(bb, ks, j * 16, n * 16);
          mma(acc[2 * n], da, bb[0], bb[1]);
          mma(acc[2 * n + 1], da, bb[2], bb[3]);
        }
      }
    }

    float* dqr = p.dqr != nullptr ? p.dqr + bh * N * D : nullptr;
    if (p.is_bf16)
      write_grad<D>(acc, row0, N, p.scale,
                    static_cast<__nv_bfloat16*>(p.dq) + b * p.dqs[0] + h * p.dqs[1], p.dqs[2],
                    dqr, cos_h, sin_h);
    else
      write_grad<D>(acc, row0, N, p.scale, static_cast<float*>(p.dq) + b * p.dqs[0] + h * p.dqs[1],
                    p.dqs[2], dqr, cos_h, sin_h);
  }
}

// dk and dv for 128 keys of one (batch, head), over all queries.
template <int D, int PE>
__global__ void __launch_bounds__(RING_THREADS) attn_stream_bwd_dkv_kernel(const Params p) {
  using namespace dense;
  constexpr bool BIAS = PE == PE_BIAS;
  constexpr bool POLY = PE == PE_POLY || PE == PE_POLY_MORE;
  constexpr bool HOLD = hold<D, PE>();
  constexpr int BLD = OWN_ROWS + 4;  // conflict-free reads of (2t, g), transposed
  using L = Ring<D, BIAS ? STEP : 0, BLD, 2 * STEP, HOLD>;
  constexpr int LD = L::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* own_k = reinterpret_cast<__nv_bfloat16*>(smem + L::OWN_OFF);
  __nv_bfloat16* own_v = own_k + OWN_ROWS * LD;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int N = p.N, h = blockIdx.y, b = blockIdx.z;
  const int c0 = blockIdx.x * OWN_ROWS, wkey = warp * 16, key0 = c0 + wkey;
  const int n16 = (N + 15) & ~15, n_steps = (n16 + STEP - 1) / STEP;
  const long long bh = (long long)b * p.H + h;
  const float* cos_h = head_table<D>(p.cos, p, h);
  const float* sin_h = head_table<D>(p.sin, p, h);
  const HeadBias hb = head_bias(p.bias, h);
  const float* bias_h = BIAS ? p.bias.bias + (long long)h * N * p.pitch : nullptr;
  const __nv_bfloat16* qf = operand(p, 0, bh, D);
  const __nv_bfloat16* kf = operand(p, 1, bh, D);
  const __nv_bfloat16* vb = operand(p, 2, bh, D);
  const __nv_bfloat16* gb = operand(p, 3, bh, D);
  const float* lse_bh = p.lse + bh * N;
  const float* delta_bh = p.delta + bh * N;
  auto stage_step = [&](int t) {  // step t's tiles, lse and delta into slot t % 2
    unsigned char* slot = smem + (t & 1) * L::SLOT;
    const int q0 = t * STEP;
    stage_rows<D>(reinterpret_cast<__nv_bfloat16*>(slot), qf + (long long)q0 * D, STEP);
    stage_rows<D>(reinterpret_cast<__nv_bfloat16*>(slot + L::TILE), gb + (long long)q0 * D,
                  STEP);
    if (BIAS)
      stage_bias<STEP, OWN_ROWS, BLD>(reinterpret_cast<float*>(slot + L::BIAS_OFF), bias_h,
                                      p.pitch, N, q0, c0);
    float* st = reinterpret_cast<float*>(slot + L::STATS_OFF);
    for (int i = threadIdx.x; i < STEP; i += RING_THREADS) {
      const bool ok = q0 + i < N;
      cp_async4(st + i, ok ? lse_bh + q0 + i : lse_bh, ok);
      cp_async4(st + STEP + i, ok ? delta_bh + q0 + i : delta_bh, ok);
    }
    cp_async_commit();
  };

  stage_rows<D>(own_k, kf + (long long)c0 * D, OWN_ROWS);
  stage_rows<D>(own_v, vb + (long long)c0 * D, OWN_ROWS);
  cp_async_commit();
  if (!HOLD) stage_step(0);
  cp_async_wait_all();
  __syncthreads();
  uint32_t ka[HOLD ? D / 16 : 1][4], va[HOLD ? D / 16 : 1][4];
  if (HOLD) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      load_a<LD>(ka[kk], own_k, wkey, kk * 16);
      load_a<LD>(va[kk], own_v, wkey, kk * 16);
    }
    __syncthreads();  // the ring may now overwrite the own tiles
    stage_step(0);
  }

  Patch pkey[2] = {};
  if (POLY)
    for (int r = 0; r < 2; ++r) pkey[r] = patch_of(hb.col0 + key0 + g4 + 8 * r, hb.grid);
  Patch pc = {};  // the query column 2 * t4 of the current 16-query block
  if (POLY) pc = patch_of(hb.row0 + 2 * t4, hb.grid);
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int t = 0; t < n_steps; ++t) {
    cp_async_wait_all();
    __syncthreads();  // step t has landed; every warp is done with step t - 1
    if (t + 1 < n_steps) stage_step(t + 1);
    const unsigned char* slot = smem + (t & 1) * L::SLOT;
    const __nv_bfloat16* qs = reinterpret_cast<const __nv_bfloat16*>(slot);
    const __nv_bfloat16* gs = reinterpret_cast<const __nv_bfloat16*>(slot + L::TILE);
    const float* bs = reinterpret_cast<const float*>(slot + L::BIAS_OFF);
    const float* st = reinterpret_cast<const float*>(slot + L::STATS_OFF);
    const int q0 = t * STEP;
    const int blocks = min(STEP, n16 - q0) / 16;
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
      float pt[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, c = e & 1;
          const int kj = key0 + g4 + 8 * r;
          const int ql = j * 16 + nt * 8 + 2 * t4 + c, qi = q0 + ql;
          float pr = 0.f, ds = 0.f;
          if (qi < N) {  // padded query rows carry a zero g in the JAX kernel
            const float bias = BIAS ? bs[ql * BLD + wkey + g4 + 8 * r] : 0.f;
            const float x = frag_logit<PE>(s[nt][e], qi, kj, N, p.scale, hb, bias, pq[nt][c],
                                           pkey[r]);
            pr = expf(x - st[ql]);
            ds = __fmul_rn(pr, __fsub_rn(gv[nt][e], st[STEP + ql]));
          }
          pt[nt][e] = pr;
          s[nt][e] = ds;
        }
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
    }
  }

  float* dkr = p.dkr != nullptr ? p.dkr + bh * N * D : nullptr;
  if (p.is_bf16) {
    __nv_bfloat16* dvg = static_cast<__nv_bfloat16*>(p.dv) + b * p.dvs[0] + h * p.dvs[1];
    __nv_bfloat16* dkg = static_cast<__nv_bfloat16*>(p.dk) + b * p.dks[0] + h * p.dks[1];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) store_tile(dvg, p.dvs[2], key0, n * 8, N, dv[n]);
    write_grad<D>(dk, key0, N, p.scale, dkg, p.dks[2], dkr, cos_h, sin_h);
  } else {
    float* dvg = static_cast<float*>(p.dv) + b * p.dvs[0] + h * p.dvs[1];
    float* dkg = static_cast<float*>(p.dk) + b * p.dks[0] + h * p.dks[1];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) store_tile(dvg, p.dvs[2], key0, n * 8, N, dv[n]);
    write_grad<D>(dk, key0, N, p.scale, dkg, p.dks[2], dkr, cos_h, sin_h);
  }
}

// dbias[h, i, j] = the sum over the groups' slabs, in group (batch) order,
// of slab[., h, i, j].
__global__ void attn_stream_bwd_dbias_sum_kernel(const Params p) {
  dense::sum_slabs(p.dbias, p.dbias_part, (long long)p.H * p.N, p.N, p.pitch, p.groups);
}

enum Pass { PASS_PROLOGUE, PASS_DQ, PASS_DKV };

template <typename K>
cudaError_t launch_bwd(K kernel, dim3 grid, size_t smem, const Params& p, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, RING_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, int PE>
cudaError_t launch_pass(const Params& p, Pass pass, cudaStream_t stream) {
  constexpr bool BIAS = PE == PE_BIAS;
  const int ctas = (p.N + OWN_ROWS - 1) / OWN_ROWS;
  if (pass == PASS_DKV)
    return launch_bwd(attn_stream_bwd_dkv_kernel<D, PE>, dim3(ctas, p.H, p.B),
                      Ring<D, BIAS ? STEP : 0, OWN_ROWS + 4, 2 * STEP, hold<D, PE>()>::BYTES, p,
                      stream);
  const size_t smem = Ring<D, BIAS ? OWN_ROWS : 0, STEP + 8, 0, hold<D, PE>()>::BYTES;
  if (!BIAS || p.dbias == nullptr)
    return launch_bwd(attn_stream_bwd_dq_kernel<D, PE, false>, dim3(ctas, p.H, p.B), smem, p,
                      stream);
  cudaError_t err = launch_bwd(attn_stream_bwd_dq_kernel<D, PE_BIAS, true>,
                               dim3(ctas, p.H, p.groups), smem, p, stream);
  if (err != cudaSuccess) return err;
  const long long quads = (long long)p.H * p.N * (p.pitch / 4);
  const int blocks = int(quads / 256 + 1 < 4096 ? quads / 256 + 1 : 4096);
  attn_stream_bwd_dbias_sum_kernel<<<blocks, 256, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Params& p, Pass pass, cudaStream_t stream) {
  if (pass == PASS_PROLOGUE) {
    const long long threads = (long long)p.B * p.H * p.NP * (D / 8);
    const unsigned blocks = unsigned((threads + 255) / 256);
    if (p.is_bf16)
      attn_stream_bwd_prologue_kernel<D, __nv_bfloat16><<<blocks, 256, 0, stream>>>(p);
    else
      attn_stream_bwd_prologue_kernel<D, float><<<blocks, 256, 0, stream>>>(p);
    return cudaGetLastError();
  }
  if (p.bias.bias != nullptr) return launch_pass<D, PE_BIAS>(p, pass, stream);
  if (p.bias.coeff != nullptr)
    return p.bias.poly_terms > REG_POLY_TERMS ? launch_pass<D, PE_POLY_MORE>(p, pass, stream)
                                              : launch_pass<D, PE_POLY>(p, pass, stream);
  if (p.bias.table != nullptr) return launch_pass<D, PE_REL>(p, pass, stream);
  return launch_pass<D, PE_NONE>(p, pass, stream);
}

cudaError_t dispatch(const Params& p, int head_dim, Pass pass, cudaStream_t stream) {
  switch (head_dim) {
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
  p.delta = static_cast<float*>(ptrs[5]);
  p.dq = ptrs[6];
  p.dk = ptrs[7];
  p.dv = ptrs[8];
  p.dqr = static_cast<float*>(ptrs[9]);
  p.dkr = static_cast<float*>(ptrs[10]);
  p.bias.bias = static_cast<const float*>(ptrs[11]);
  p.cos = static_cast<const float*>(ptrs[12]);
  p.sin = static_cast<const float*>(ptrs[13]);
  p.bias.coeff = static_cast<const float*>(ptrs[14]);
  p.bias.table = static_cast<const float*>(ptrs[15]);
  p.dbias = static_cast<float*>(ptrs[16]);
  p.dbias_part = static_cast<float*>(ptrs[17]);
  p.out = ptrs[18];
  p.ops = static_cast<__nv_bfloat16*>(ptrs[19]);
  p.bias.poly_terms = dims[DIM_POLY_TERMS];
  p.bias.poly_grid = dims[DIM_POLY_GRID];
  p.bias.rel_ell = dims[DIM_REL_ELL];
  p.bias.row0 = dims[DIM_ROW0];
  p.bias.col0 = dims[DIM_COL0];
  p.bias.n_valid = dims[DIM_N_VALID];
  long long* dst[8] = {p.qs, p.ks, p.vs, p.gs, p.dqs, p.dks, p.dvs, p.os};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  p.B = dims[DIM_B];
  p.H = dims[DIM_H];
  p.N = dims[DIM_N];
  p.NP = (p.N + OWN_ROWS - 1) / OWN_ROWS * OWN_ROWS;
  p.pitch = (p.N + 3) / 4 * 4;
  p.cos_heads = dims[DIM_COS_HEADS];
  p.is_bf16 = dims[DIM_IS_BF16];
  p.groups = dims[DIM_GROUPS];
  p.scale = scale;
  const int biases = (p.bias.bias != nullptr) + (p.bias.coeff != nullptr) +
                     (p.bias.table != nullptr);
  if (p.bias.poly_terms > MAX_POLY_TERMS || biases > 1 || p.ops == nullptr ||
      p.delta == nullptr || (pass == PASS_PROLOGUE && p.out == nullptr) ||
      (p.bias.coeff != nullptr && p.bias.poly_grid < 1) ||
      (p.dbias != nullptr &&
       (p.bias.bias == nullptr || p.dbias_part == nullptr || p.groups < 1 || p.groups > p.B ||
        (p.groups - 1) * ((p.B + p.groups - 1) / p.groups) >= p.B)))  // an empty group
    return int(cudaErrorInvalidValue);
  return int(dispatch(p, dims[DIM_D], pass, static_cast<cudaStream_t>(stream)));
}

}  // namespace

// Plain C entry points (bound with ctypes), one per kernel, all with the same
// arguments, launched in this order on one stream: the prologue, the dq pass,
// the dk/dv pass. ptrs holds 20 device pointers: q k v g lse delta dq dk dv
// dqr dkr bias cos sin coeff table dbias dbias_part out ops (null where
// absent): delta [B, H, N] f32 and ops [4, B, H, NP, D] bf16 (NP = N rounded
// up to 128) are written by the prologue and read by the passes; bias, when
// given, is [H, N, pitch] f32 with pitch = N rounded up to 4. strides holds
// 24 element strides: (batch, head, token) of q k v g dq dk dv out. dims
// holds the integers of attn::Dim (DIM_GROUPS: dbias's batch groups of
// ceil(B / groups) batches each, none empty, with a [groups, H, N, pitch]
// dbias_part). Each returns the CUDA error of its launches (0 on success)
// and does not synchronize. With dbias set, attn_stream_bwd_dq launches the
// dq kernel's dbias instance and the fixed-order sum over the groups' slabs.
extern "C" int attn_stream_bwd_prologue(void* const* ptrs, const long long* strides,
                                        const int* dims, float scale, void* stream) {
  return run(PASS_PROLOGUE, ptrs, strides, dims, scale, stream);
}

extern "C" int attn_stream_bwd_dq(void* const* ptrs, const long long* strides,
                                  const int* dims, float scale, void* stream) {
  return run(PASS_DQ, ptrs, strides, dims, scale, stream);
}

extern "C" int attn_stream_bwd_dkv(void* const* ptrs, const long long* strides,
                                   const int* dims, float scale, void* stream) {
  return run(PASS_DKV, ptrs, strides, dims, scale, stream);
}
