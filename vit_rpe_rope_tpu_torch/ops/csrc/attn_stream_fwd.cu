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
//
// Design: the TPU kernel runs a sequential (batch, head, q tile, kv tile)
// grid and carries m, l and acc in VMEM scratch across its innermost axis.
// Here one CTA of 4 warps owns one (batch, head, 64-row query tile) and loops
// over the key tiles itself; each warp owns 16 query rows and each lane pair
// one row's statistics. The output accumulator lives in shared memory as f32:
// each tile the lane pair scales its row by corr, the warp loads the slab as
// WMMA accumulator fragments, adds bf16(p) . V on the tensor cores and stores
// it back (the fragment layout is opaque, so the per-row rescale cannot
// happen in registers). The generated biases are computed per element from
// the token indices; the TPU kernel's pre-framed windows and roll expansions
// exist because Mosaic cannot gather, which is no constraint here. K and V
// stream through shared memory as in attn_fwd.cu. wgmma / TMA pipelining is
// later work.

#include "attn_stream.cuh"

namespace {

using namespace attn;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;        // [B, H, N], rows at stride 1
  const float* cos;  // [cos_heads, N, D/2] or null
  const float* sin;
  BiasArgs bias;
  long long qs[3], ks[3], vs[3], os[3];  // (batch, head, token) strides
  long long ls[2];                       // (batch, head) strides of lse
  int B, H, N, cos_heads;
  int NK, kv_valid;  // keys of this call; keys at local index >= kv_valid masked
  float scale;
};

template <int D>
struct Layout {
  static constexpr int LDX = ldx<D>();  // bf16 q/k/v tile rows
  static constexpr int LDS = TK + 4;    // f32 scores
  static constexpr int LDO = D + 4;     // f32 output accumulator
  static constexpr int LDP = TK + 8;    // bf16 probabilities
  static constexpr size_t TILE_BYTES = size_t(TQ) * LDX * 2;
  static constexpr size_t S_BYTES = size_t(TQ) * LDS * 4;
  static constexpr size_t O_BYTES = size_t(TQ) * LDO * 4;
  static constexpr size_t Q_OFF = 0;
  static constexpr size_t K_OFF = Q_OFF + TILE_BYTES;
  static constexpr size_t V_OFF = K_OFF + TILE_BYTES;
  static constexpr size_t S_OFF = V_OFF + TILE_BYTES;
  static constexpr size_t O_OFF = S_OFF + S_BYTES;
  static constexpr size_t P_OFF = O_OFF + O_BYTES;
  static constexpr size_t BYTES = P_OFF + size_t(TQ) * LDP * 2;
  static_assert(TILE_BYTES % 128 == 0 && S_BYTES % 128 == 0 && O_BYTES % 128 == 0,
                "shared-memory sections must stay 128-byte aligned");
};

template <int D, typename T, bool MORE>
__global__ void __launch_bounds__(THREADS) attn_stream_fwd_kernel(const Params p) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + L::Q_OFF);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem + L::K_OFF);
  __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(smem + L::V_OFF);
  float* s_s = reinterpret_cast<float*>(smem + L::S_OFF);
  float* o_s = reinterpret_cast<float*>(smem + L::O_OFF);
  __nv_bfloat16* p_s = reinterpret_cast<__nv_bfloat16*>(smem + L::P_OFF);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
  const int N = p.N;
  const T* qg = slice<T>(p.q, p.qs, b, h);
  const T* kg = slice<T>(p.k, p.ks, b, h);
  const T* vg = slice<T>(p.v, p.vs, b, h);
  T* og = static_cast<T*>(p.out) + b * p.os[0] + h * p.os[1];
  const long long tab = (long long)(p.cos_heads == 1 ? 0 : h) * N * (D / 2);
  const float* cos_h = p.cos != nullptr ? p.cos + tab : nullptr;
  const float* sin_h = p.sin != nullptr ? p.sin + tab : nullptr;
  const HeadBias hb = head_bias(p.bias, h, N);

  float* s_w = s_s + warp * 16 * L::LDS;
  float* o_w = o_s + warp * 16 * L::LDO;
  __nv_bfloat16* p_w = p_s + warp * 16 * L::LDP;
  const int row_w = q0 + warp * 16;
  const int n_kv = (p.NK + TK - 1) / TK;

  stage_tile<D, T>(q_s, qg, p.qs[2], q0, N, cos_h, sin_h);
  for (int i = lane; i < 16 * L::LDO; i += 32) o_w[i] = 0.f;
  __syncthreads();
  FragA qa[D / 16];
  load_rows<D>(qa, q_s + warp * 16 * L::LDX);

  // Lane l owns row l/2 of the warp's 16 rows and half (l % 2) of each
  // tile's TK columns and of the row's D outputs; the lane pair combines its
  // statistics with one shuffle, so both lanes hold their row's m and l.
  const int my_row = lane >> 1;
  const int half = lane & 1;
  const int col0 = half * (TK / 2);
  const int qi = row_w + my_row;
  float* s_row = s_w + my_row * L::LDS + col0;
  __nv_bfloat16* p_row = p_w + my_row * L::LDP + col0;
  float* o_row = o_w + my_row * L::LDO + half * (D / 2);

  float m = NEG_INF, l = 0.f;
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * TK;
    __syncthreads();  // every warp is done with the previous K and V tiles
    stage_tile<D, T>(k_s, kg, p.ks[2], k0, p.NK, cos_h, sin_h);
    stage_tile<D, T>(v_s, vg, p.vs[2], k0, p.NK, nullptr, nullptr);
    __syncthreads();
    warp_abt<D, L::LDS>(s_w, qa, k_s);
    __syncwarp();
    float mx = NEG_INF;
#pragma unroll 8
    for (int j = 0; j < TK / 2; ++j) {
      const float s = stream_logit<MORE>(s_row[j], qi, k0 + col0 + j, p.kv_valid, p.scale, hb);
      s_row[j] = s;
      mx = fmaxf(mx, s);
    }
    const float m_new = fmaxf(m, fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1)));
    const float corr = expf(m - m_new);
    float sum = 0.f;
#pragma unroll 8
    for (int j = 0; j < TK / 2; ++j) {
      const float e = expf(s_row[j] - m_new);
      sum += e;
      p_row[j] = __float2bfloat16(e);
    }
    l = l * corr + (sum + __shfl_xor_sync(0xffffffffu, sum, 1));
    m = m_new;
#pragma unroll 8
    for (int d = 0; d < D / 2; ++d) o_row[d] *= corr;
    __syncwarp();
    FragC o_acc[D / 16];
#pragma unroll
    for (int n = 0; n < D / 16; ++n)
      wmma::load_matrix_sync(o_acc[n], o_w + n * 16, L::LDO, wmma::mem_row_major);
    warp_ab_acc<D, L::LDP>(o_acc, p_w, v_s);
#pragma unroll
    for (int n = 0; n < D / 16; ++n)
      wmma::store_matrix_sync(o_w + n * 16, o_acc[n], L::LDO, wmma::mem_row_major);
    __syncwarp();
  }

  // Epilogue: normalize, write the input dtype and the row's logsumexp.
  if (half == 0 && qi < N)
    p.lse[b * p.ls[0] + h * p.ls[1] + qi] = m + logf(l);
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const float l_r = __shfl_sync(0xffffffffu, l, 2 * r);
    if (row_w + r >= N) continue;
    T* orow = og + (row_w + r) * p.os[2];
    for (int d = lane; d < D; d += 32) store(orow + d, o_w[r * L::LDO + d] / l_r);
  }
}

template <int D, typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.N + TQ - 1) / TQ, p.H, p.B);
  if (p.bias.poly_terms > REG_POLY_TERMS)
    return launch_kernel(attn_stream_fwd_kernel<D, T, true>, grid, Layout<D>::BYTES, p, stream);
  return launch_kernel(attn_stream_fwd_kernel<D, T, false>, grid, Layout<D>::BYTES, p, stream);
}

template <typename T>
cudaError_t dispatch(const Params& p, int head_dim, cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<16, T>(p, stream);
    case 32: return launch<32, T>(p, stream);
    case 64: return launch<64, T>(p, stream);
    case 128: return launch<128, T>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The arguments both entry points share. ptrs holds 10 device pointers:
// q k v out lse bias cos sin coeff table (null where absent); strides holds
// 12 element strides: (batch, head, token) of q, k, v and out; dims holds the
// integers of attn::Dim (groups unused here).
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
  p.cos_heads = dims[DIM_COS_HEADS];
  p.scale = scale;
  return p;
}

int run(const Params& p, int is_bf16, int head_dim, void* stream) {
  if (p.bias.poly_terms > MAX_POLY_TERMS ||
      (p.bias.coeff != nullptr && p.bias.poly_grid < 1))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? dispatch<__nv_bfloat16>(p, head_dim, s)
                                  : dispatch<float>(p, head_dim, s);
  return int(err);
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns the CUDA error of
// the launch (0 on success) and does not synchronize.
//
// attn_stream_fwd: a whole sequence, arguments as params_of; keys are the
// queries' own (NK = kv_valid = N), lse is a contiguous [B, H, N] tensor.
extern "C" int attn_stream_fwd(void* const* ptrs, const long long* strides,
                               const int* dims, float scale, void* stream) {
  Params p = params_of(ptrs, strides, dims, scale);
  p.NK = p.kv_valid = p.N;
  p.ls[0] = (long long)p.H * p.N;
  p.ls[1] = p.N;
  return run(p, dims[DIM_IS_BF16], dims[DIM_D], stream);
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
  p.NK = dims[DIM_NK];
  p.kv_valid = dims[DIM_KV_VALID];
  p.ls[0] = strides[12];
  p.ls[1] = strides[13];
  return run(p, dims[DIM_IS_BF16], dims[DIM_D], stream);
}
