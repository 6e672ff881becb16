// Streaming attention forward (online softmax over key tiles) with in-kernel
// rope and a materialized or generated bias, for Hopper (sm_90a).
//
// Replaces: the Pallas kernel `_stream_kernel` of
// vit_rpe_rope_tpu/ops/flash_attention.py, launched by
// `_forward_streaming_impl` on a whole sequence (entry attn_stream_fwd) and
// by `streaming_chunk_fwd` on q rows against one key chunk at global
// offsets (entry attn_stream_chunk_fwd).
//
// Computes, for q [B, H, N, D] and k, v [B, H, NK, D] (float32 or bfloat16,
// any strides with a unit last-dim stride; NK = N on a whole sequence), per
// 64-key tile t, with the JAX kernel's rounding points:
//   s      = bf16(rotate(q)) . bf16(rotate(k_t))^T * scale + bias_t
//            (bias_t: a tile of the [H, N, N] tensor, or generated from the
//            polynomial coefficients or the relative table at global indices
//            (row0 + i, col0 + j); keys at local indices >= kv_valid or at
//            global indices >= n_valid masked to -1e30)
//   m_new  = max(m, rowmax(s));  p = exp(s - m_new);  corr = exp(m - m_new)
//   l      = l * corr + rowsum(p)
//   acc    = acc * corr + bf16(p) . bf16(v_t)       p rounded against the
//                                                    RUNNING max
//   out    = acc / l   (input dtype),   lse = m + log l   (f32 [B, H, N])
//
// A chunk call is the whole-sequence kernel with another key count and
// offsets: its q may be a row slice of a longer sequence and its out and lse
// views into the rows of longer buffers (both taken by their strides). There
// are no rope tables on a chunk (its caller rotates q and k) and no
// materialized bias. The relative index of a padded query row (at or beyond
// n_valid) can leave the table: it is clamped, where the TPU kernel wraps;
// those rows stay finite and never reach a loss.
//
// What bounds it on an H100: operations from N ~ 600 on. At the long-sequence
// shape (B=4, H=4, N=4097, D=32, f32) q+k+v+out is 33.6 MB, about 10 us at
// 3.35 TB/s, against 34.4 GFLOP of products, about 35 us at 989 TFLOP/s.
// A q-chunk of the bounded train step at N = 65,537 (16,384 rows against
// 66,048 keys, H=4, D=32, f32) moves 84 MB, 25 us, against 554 GFLOP, 0.56 ms.
// At ViT-S/16@384 (16, 6, 577, 64, f32) with a materialized bias, bytes: q,
// k, v, out and the bias are 65 MB, 19 us, against 8.2 GFLOP, 8 us.
//
// Design. Two kernels, launched in this order on one stream by each forward
// entry point:
//   prologue   one thread per 8 columns (4 at c, 4 at c + D/2) of a key row:
//              writes kf = bf16(rotate(k)) and vb = bf16(v) once per call
//              into contiguous [2, B, H, NP, D] bf16 scratch (NP = NK rounded
//              up to the 64-key tile, zero rows past NK), with the separate
//              backward passes' rotation and rounding (`round_row`, which
//              both prologues and the CTA's own q share: the same bits as
//              their kf), so that no CTA converts key tiles itself: per CTA,
//              K would be rotated and rounded ceil(N/128) times per (batch,
//              head), 5 times at N = 577, 33 at N = 4097, 128 times per
//              q-chunk of the bounded step. The scratch costs
//              2 * B * H * NP * D * 2 bytes: 16 MB at (16, 6, 577, 64), 8.5 MB
//              at (4, 4, 4097, 32), 34 MB for a chunk's 66,048 keys at
//              (1, 4, ., 32). On a chunk (no tables) it only rounds.
//   forward    one CTA of 8 warps per (128 query rows, head, batch); each
//              warp owns 16 query rows. The CTA rotates and rounds its own q
//              rows once (`round_row`) into shared memory,
//              and each warp reads them as mma A fragments, held in
//              registers for D <= 64 (`hold`: not the many-term polynomial
//              at D <= 32, which would spill). The CTA walks the keys in
//              tiles of 64 (kf, vb and, with a bias, the f32 bias tile [128
//              rows, 64 keys], from a bias padded to rows of `pitch`
//              floats), double-buffered with cp.async 16-byte copies: the
//              next tile loads while the current one is multiplied, one
//              barrier per tile. Per tile a warp forms s = qf . kf^T
//              for its 16 rows with mma.sync.m16n8k16 on ldmatrix fragments
//              (four 16-key blocks, 32 f32 a lane), takes the row max over
//              the tile across the lane quad, computes corr, p and the row
//              sum in registers, rescales its f32 output accumulator
//              fragments by corr in registers (the C layout is known: a
//              lane holds rows g and g + 8) and adds bf16(p) . vb from p
//              repacked as the A operand.
//              No f32 score slab, no output slab, no p block in shared
//              memory. The tile is 64 keys, the twin's STREAM_TILE, so p is
//              rounded against the twin's running max; the loop
//              over keys ends at NK rounded up to 16 (592 at N = 577), not at
//              whole tiles; a tile whose keys are all valid skips the mask
//              tests. Generated biases step the patch coordinates along a
//              thread's fragment columns instead of dividing per logit.
//              The epilogue divides by l and writes out in 16-byte (f32) or
//              8-byte (bf16) row pieces, and lse; padded rows are not
//              written.
// Every output row has one owner: no atomics, a second launch is
// bit-identical. A chunk at (r0, 0) against all keys computes the
// whole-sequence rows bit for bit (the same instance, the same key tiles).
// wgmma, TMA and warp specialisation are later work: at 64-key tiles of
// 16-row warps the kernel waits on the exponentials and the fragment loads as
// much as on the products.

#include <type_traits>

#include "attn_stream_tiles.cuh"

namespace {

using namespace attn;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;           // rows at stride 1, (batch, head) strides ls
  const float* cos;     // [cos_heads, N, D/2] or null
  const float* sin;
  __nv_bfloat16* ops;   // [2, B, H, NP, D]: kf, bf16 v (the prologue's)
  BiasArgs bias;        // bias.bias: [H, N, pitch]
  long long qs[3], ks[3], vs[3], os[3];  // (batch, head, token) strides
  long long ls[2];
  int B, H, N, NP, pitch, cos_heads, is_bf16;
  int NK, kv_valid;  // keys of this call; keys at local index >= kv_valid masked
  float scale;
};

// kf and bf16 v of one key row (8 columns of it per thread) into the
// scratch. Rows past NK are zero.
template <int D, typename T>
__global__ void __launch_bounds__(256) attn_stream_fwd_prologue_kernel(const Params p) {
  constexpr int H2 = D / 2, PER_ROW = D / 8;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long rows = (long long)p.B * p.H * p.NP;
  const long long row = i / PER_ROW;
  if (row >= rows) return;
  const int c = int(i % PER_ROW) * 4;
  const int n = int(row % p.NP);
  const long long bh = row / p.NP;
  const int b = int(bh / p.H), h = int(bh % p.H);
  const float* cos_h = head_table<D>(p.cos, p, h);
  const float* sin_h = head_table<D>(p.sin, p, h);
  const long long at = (long long)n * H2 + c;
  __nv_bfloat16* dst = p.ops + row * D + c;
  round_row<D>(dst, slice<T>(p.k, p.ks, b, h) + n * p.ks[2] + c,
               cos_h != nullptr ? cos_h + at : nullptr, sin_h != nullptr ? sin_h + at : nullptr,
               n < p.NK);
  round_row<D>(dst + rows * D, slice<T>(p.v, p.vs, b, h) + n * p.vs[2] + c, nullptr, nullptr,
               n < p.NK);
}

// The CTA's own 128 query rows, rotated and rounded to bf16, into a tile of
// pitch LD (rows past N zero): 8 columns (4 at c, 4 at c + D/2) per item.
template <int D, typename T>
__device__ __forceinline__ void stage_q(__nv_bfloat16* dst, const Params& p, int b, int h,
                                        int q0, const float* cos_h, const float* sin_h) {
  constexpr int H2 = D / 2, PER_ROW = D / 8, LD = dense::pitch<D>();
  const T* qg = slice<T>(p.q, p.qs, b, h);
  for (int i = threadIdx.x; i < OWN_ROWS * PER_ROW; i += RING_THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * 4, n = q0 + r;
    const long long at = (long long)n * H2 + c;
    round_row<D>(dst + r * LD + c, qg + n * p.qs[2] + c, cos_h != nullptr ? cos_h + at : nullptr,
                 sin_h != nullptr ? sin_h + at : nullptr, n < p.N);
  }
}

// out and lse for 128 query rows of one (batch, head), over all keys.
template <int D, int PE>
__global__ void __launch_bounds__(RING_THREADS) attn_stream_fwd_kernel(const Params p) {
  using namespace dense;
  constexpr bool BIAS = PE == PE_BIAS;
  constexpr bool POLY = PE == PE_POLY || PE == PE_POLY_MORE;
  // Both logit paths (below: with and without the mask tests), but for more
  // than 8 polynomial terms at D = 128, where the second would cost 632
  // bytes of spills (-Xptxas -v).
  constexpr bool TWO_PATHS = !(PE == PE_POLY_MORE && D > 64);
  constexpr bool HOLD = hold<D, PE>();  // qf's A fragments in registers
  constexpr int BLD = STEP + 8;   // conflict-free 8-byte reads of (g, 2t)
  using L = Ring<D, BIAS ? OWN_ROWS : 0, BLD, 0, HOLD, 1>;
  constexpr int LD = L::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* own_q = reinterpret_cast<__nv_bfloat16*>(smem + L::OWN_OFF);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int N = p.N, h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * OWN_ROWS, wrow = warp * 16, row0 = q0 + wrow;
  const int n16 = (p.NK + 15) & ~15, n_steps = (n16 + STEP - 1) / STEP;
  const long long bh = (long long)b * p.H + h;
  const float* cos_h = head_table<D>(p.cos, p, h);
  const float* sin_h = head_table<D>(p.sin, p, h);
  const HeadBias hb = head_bias(p.bias, h);
  // keys [0, valid_keys) are unmasked: below kv_valid and, globally, n_valid
  const int valid_keys = min(p.kv_valid, hb.n_valid - hb.col0);
  const float* bias_h = BIAS ? p.bias.bias + (long long)h * N * p.pitch : nullptr;
  const __nv_bfloat16* kf = p.ops + bh * p.NP * D;
  const __nv_bfloat16* vb = kf + (long long)p.B * p.H * p.NP * D;
  Patch prow[2] = {};
  if (POLY)
    for (int r = 0; r < 2; ++r) prow[r] = patch_of(hb.row0 + row0 + g4 + 8 * r, hb.grid);
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

  if (p.is_bf16)
    stage_q<D, __nv_bfloat16>(own_q, p, b, h, q0, cos_h, sin_h);
  else
    stage_q<D, float>(own_q, p, b, h, q0, cos_h, sin_h);
  if (!HOLD) stage_step(0);
  __syncthreads();
  uint32_t qa[HOLD ? D / 16 : 1][4];
  if (HOLD) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) load_a<LD>(qa[kk], own_q, wrow, kk * 16);
    __syncthreads();  // the ring may now overwrite the own tile
    stage_step(0);
  }

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
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
    float s[STEP / 16][2][4];
#pragma unroll
    for (int j = 0; j < STEP / 16; ++j) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][nt][e] = 0.f;
      if (j >= blocks) continue;  // past NK rounded up to 16: never read
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
        mma(s[j][0], a, bb[0], bb[1]);
        mma(s[j][1], a, bb[2], bb[3]);
      }
    }
    // Scale, bias and mask, and the row max over the tile; a tile whose
    // keys are all valid skips the mask tests (the same values).
    float mx[2] = {NEG_INF, NEG_INF};
    auto logits = [&](auto full) {
#pragma unroll
      for (int j = 0; j < STEP / 16; ++j) {
        if (j >= blocks) continue;
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
            const float bias = c ? bias2[r].y : bias2[r].x;
            s[j][nt][e] = frag_logit<PE, !decltype(full)::value>(
                s[j][nt][e], qi, kj, p.kv_valid, p.scale, hb, bias, prow[r], pk[nt][c]);
            mx[r] = fmaxf(mx[r], s[j][nt][e]);
          }
        }
      }
    };
    if (TWO_PATHS && k0 + STEP <= valid_keys)
      logits(std::true_type());
    else
      logits(std::false_type());
    // The tile's row max across the lane quad, then p, its row sum and the
    // rescaled accumulator, all in registers.
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < STEP / 16; ++j) {
      if (j >= blocks) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pr = expf(s[j][nt][e] - m[e >> 1]);
          s[j][nt][e] = pr;
          sum[e >> 1] += pr;
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * corr[r] + sum[r];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
#pragma unroll
    for (int j = 0; j < STEP / 16; ++j) {
      if (j >= blocks) continue;
      uint32_t pa[4];
      pack_a(pa, s[j][0], s[j][1]);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        uint32_t bb[4];
        load_b<LD>(bb, vs, j * 16, n * 16);
        mma(acc[2 * n], pa, bb[0], bb[1]);
        mma(acc[2 * n + 1], pa, bb[2], bb[3]);
      }
    }
  }

  // Epilogue: normalize, write the input dtype and the rows' logsumexp.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + g4 + 8 * r;
    if (t4 == 0 && qi < N) p.lse[b * p.ls[0] + h * p.ls[1] + qi] = m[r] + logf(l[r]);
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = acc[n][e] / l[e >> 1];
  if (p.is_bf16) {
    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.out) + b * p.os[0] + h * p.os[1];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) store_tile(og, p.os[2], row0, n * 8, N, acc[n]);
  } else {
    float* og = static_cast<float*>(p.out) + b * p.os[0] + h * p.os[1];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) store_tile(og, p.os[2], row0, n * 8, N, acc[n]);
  }
}

template <int D, int PE>
cudaError_t launch_fwd(const Params& p, cudaStream_t stream) {
  auto kernel = attn_stream_fwd_kernel<D, PE>;
  const size_t smem = Ring<D, PE == PE_BIAS ? OWN_ROWS : 0, STEP + 8, 0, hold<D, PE>(), 1>::BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3((p.N + OWN_ROWS - 1) / OWN_ROWS, p.H, p.B), RING_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Params& p, bool prologue, cudaStream_t stream) {
  if (prologue) {
    const long long threads = (long long)p.B * p.H * p.NP * (D / 8);
    const unsigned blocks = unsigned((threads + 255) / 256);
    if (p.is_bf16)
      attn_stream_fwd_prologue_kernel<D, __nv_bfloat16><<<blocks, 256, 0, stream>>>(p);
    else
      attn_stream_fwd_prologue_kernel<D, float><<<blocks, 256, 0, stream>>>(p);
    return cudaGetLastError();
  }
  if (p.bias.bias != nullptr) return launch_fwd<D, PE_BIAS>(p, stream);
  if (p.bias.coeff != nullptr)
    return p.bias.poly_terms > REG_POLY_TERMS ? launch_fwd<D, PE_POLY_MORE>(p, stream)
                                              : launch_fwd<D, PE_POLY>(p, stream);
  if (p.bias.table != nullptr) return launch_fwd<D, PE_REL>(p, stream);
  return launch_fwd<D, PE_NONE>(p, stream);
}

// The arguments all three entry points share. ptrs holds 11 device pointers:
// q k v out lse bias cos sin coeff table ops (null where absent); strides
// holds 12 element strides: (batch, head, token) of q, k, v and out; dims
// holds the integers of attn::Dim (groups unused here).
Params params_of(void* const* ptrs, const long long* strides, const int* dims, float scale) {
  Params p;
  p.q = ptrs[0];
  p.k = ptrs[1];
  p.v = ptrs[2];
  p.out = ptrs[3];
  p.lse = static_cast<float*>(ptrs[4]);
  p.bias.bias = static_cast<const float*>(ptrs[5]);
  p.cos = static_cast<const float*>(ptrs[6]);
  p.sin = static_cast<const float*>(ptrs[7]);
  p.bias.coeff = static_cast<const float*>(ptrs[8]);
  p.bias.table = static_cast<const float*>(ptrs[9]);
  p.ops = static_cast<__nv_bfloat16*>(ptrs[10]);
  p.bias.poly_terms = dims[DIM_POLY_TERMS];
  p.bias.poly_grid = dims[DIM_POLY_GRID];
  p.bias.rel_ell = dims[DIM_REL_ELL];
  p.bias.row0 = dims[DIM_ROW0];
  p.bias.col0 = dims[DIM_COL0];
  p.bias.n_valid = dims[DIM_N_VALID];
  long long* dst[4] = {p.qs, p.ks, p.vs, p.os};
  for (int t = 0; t < 4; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  p.B = dims[DIM_B];
  p.H = dims[DIM_H];
  p.N = dims[DIM_N];
  p.NK = p.kv_valid = dims[DIM_NK];
  p.NP = (p.NK + STEP - 1) / STEP * STEP;
  p.pitch = (p.N + 3) / 4 * 4;
  p.cos_heads = dims[DIM_COS_HEADS];
  p.is_bf16 = dims[DIM_IS_BF16];
  p.scale = scale;
  return p;
}

int run(const Params& p, bool prologue, int head_dim, void* stream) {
  const int biases = (p.bias.bias != nullptr) + (p.bias.coeff != nullptr) +
                     (p.bias.table != nullptr);
  if (p.bias.poly_terms > MAX_POLY_TERMS || biases > 1 || p.ops == nullptr ||
      (p.bias.coeff != nullptr && p.bias.poly_grid < 1))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return int(launch<16>(p, prologue, s));
    case 32: return int(launch<32>(p, prologue, s));
    case 64: return int(launch<64>(p, prologue, s));
    case 128: return int(launch<128>(p, prologue, s));
    default: return int(cudaErrorInvalidValue);
  }
}

// The prologue, then the forward, on one stream.
int prologue_then_forward(const Params& p, int head_dim, void* stream) {
  Params pro = p;
  pro.N = pro.NK;  // the tables' token count
  const int err = run(pro, true, head_dim, stream);
  return err != 0 ? err : run(p, false, head_dim, stream);
}

}  // namespace

// Plain C entry points (bound with ctypes), arguments as params_of. Each
// returns the CUDA error of its launches (0 on success) and does not
// synchronize. ops [2, B, H, NP, D] bf16 (NP = NK rounded up to 64) is
// written by the prologue and read by the forward; the two forward entries
// launch the prologue first.
//
// attn_stream_fwd_prologue: the prologue alone, kf and bf16 v of the NK keys
// (DIM_NK; rotated by cos / sin, [cos_heads, NK, D/2], where given).
extern "C" int attn_stream_fwd_prologue(void* const* ptrs, const long long* strides,
                                        const int* dims, float scale, void* stream) {
  Params p = params_of(ptrs, strides, dims, scale);
  p.N = p.NK;  // the tables' token count
  return run(p, true, dims[DIM_D], stream);
}

// attn_stream_fwd: a whole sequence; keys are the queries' own (NK =
// kv_valid = N), lse is a contiguous [B, H, N] tensor, a materialized bias
// is [H, N, pitch] with pitch = N rounded up to 4.
extern "C" int attn_stream_fwd(void* const* ptrs, const long long* strides,
                               const int* dims, float scale, void* stream) {
  Params p = params_of(ptrs, strides, dims, scale);
  if (p.NK != p.N) return int(cudaErrorInvalidValue);
  p.ls[0] = (long long)p.H * p.N;
  p.ls[1] = p.N;
  return prologue_then_forward(p, dims[DIM_D], stream);
}

// attn_stream_chunk_fwd: N query rows at global row0 against NK keys at
// global col0 (dims DIM_ROW0, DIM_COL0, DIM_N_VALID, DIM_NK, DIM_KV_VALID);
// strides holds 14 entries, the last two the (batch, head) strides of lse.
// The generated biases only: no materialized bias, no rope tables.
extern "C" int attn_stream_chunk_fwd(void* const* ptrs, const long long* strides,
                                     const int* dims, float scale, void* stream) {
  Params p = params_of(ptrs, strides, dims, scale);
  if (p.bias.bias != nullptr || p.cos != nullptr || p.sin != nullptr)
    return int(cudaErrorInvalidValue);
  p.kv_valid = dims[DIM_KV_VALID];
  p.ls[0] = strides[12];
  p.ls[1] = strides[13];
  return prologue_then_forward(p, dims[DIM_D], stream);
}
