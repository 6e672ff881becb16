// Dense attention forward with in-kernel rope and an optional materialized
// bias, for Hopper (sm_90a).
//
// Replaces: the Pallas kernel `_attn_kernel` of
// vit_rpe_rope_tpu/ops/flash_attention.py, launched by its driver `_forward`.
//
// Computes, for q, k, v [B, H, N, D] (float32 or bfloat16, any strides with a
// unit last-dim stride):
//   qr, kr = rotate(q), rotate(k)             f32, half-split, cos/sin tables
//                                              [1|H, N, D/2] whose row 0 is the
//                                              identity (cls stays unrotated)
//   s      = bf16(qr) . bf16(kr)^T * scale    f32 accumulation
//          + bias[h]                           optional f32 [H, N, N]
//   p      = exp(s - rowmax(s))               f32; columns >= N masked
//   out    = (bf16(p) . bf16(v)) / rowsum(p)  written in the input dtype
// exactly as the JAX kernel does (bf16 operands, f32 accumulation, p rounded
// against the FINAL row max, the division after the PV product).
//
// What bounds it on an H100: memory. At the serving shape of ViT-S/16@224
// (B=64, H=6, N=197, D=64, f32) q+k+v+out is 77.5 MB, about 23 us at
// 3.35 TB/s, against 3.8 GFLOP of products, about 4 us at 989 TFLOP/s.
//
// Two routes, chosen by the wrapper (flash_attention.dense_resident):
//
// Resident (attn_fwd_resident; every dense shape of the repo's models,
// N <= 208): one CTA per (batch, head) of ceil(N/16) warps, each owning 16
// query rows. Q and K (rotated, rounded to bf16) and V (bf16) of the whole
// head are staged into shared memory once, with 16-byte loads that a thread
// issues together; the padded rows are zeros. One barrier. Each warp then
// forms its whole 16 x N_pad score block in registers with
// mma.sync.m16n8k16 on ldmatrix fragments (104 f32 per thread at N_pad =
// 208), masks the padded keys, takes the row max with quad shuffles, forms
// p = exp(s - max) against that final max (no online rescale, so bf16(p)
// rounds where the JAX kernel rounds it), sums the unrounded p, and repacks
// bf16(p) in registers as the A operand of P.V (attn_dense.cuh): no score
// round trip through shared memory. out = acc / l is written in 16-byte row
// pieces. Why not TMA or wgmma: the kernel is bound by bytes (products are
// ~4 of the 23 us bound), and the f32 rows must be rounded, and K rotated,
// before any product, so a TMA tile copy would still need a second pass
// through shared memory; wgmma wants 64-row warpgroup tiles where a 16-row
// warp tile keeps the padding of N = 65 at 80. Untried: issuing V's loads
// with cp.async so that they overlap the Q.K^T product.
//
// Wide (attn_fwd; the other dense shapes): one CTA of 4 warps per (batch,
// head, 64-row query tile); K and V stream through shared memory in 64-key
// tiles, rotated and rounded on the way in, with WMMA bf16 16x16x16
// products. The softmax takes two passes over the keys: the first finds
// each row's max, the second forms p against the final max, so the PV
// accumulator needs no rescaling. Measured on an H100, it is latency-bound
// (0.2853 ms at the ViT-S/16@224 shape above).

#include "attn_common.cuh"
#include "attn_dense.cuh"

namespace {

using namespace attn;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  const float* bias;  // [H, N, N] or null
  const float* cos;   // [cos_heads, N, D/2] or null
  const float* sin;
  long long qs[3], ks[3], vs[3], os[3];  // (batch, head, token) strides
  int B, H, N, cos_heads;
  float scale;
};

template <int D>
struct Layout {
  static constexpr int LDX = ldx<D>();              // bf16 q/k/v tile rows
  static constexpr int SW = D > TK ? D : TK;        // f32 slab width
  static constexpr int LDS = SW + 4;                // f32 score/output slab
  static constexpr int LDP = TK + 8;                // bf16 probabilities
  static constexpr size_t TILE_BYTES = size_t(TQ) * LDX * 2;
  static constexpr size_t Q_OFF = 0;
  static constexpr size_t K_OFF = Q_OFF + TILE_BYTES;
  static constexpr size_t V_OFF = K_OFF + TILE_BYTES;
  static constexpr size_t S_OFF = V_OFF + TILE_BYTES;
  static constexpr size_t P_OFF = S_OFF + size_t(TQ) * LDS * 4;
  static constexpr size_t BYTES = P_OFF + size_t(TQ) * LDP * 2;
  static_assert(TILE_BYTES % 128 == 0 && (size_t(TQ) * LDS * 4) % 128 == 0,
                "shared-memory sections must stay 128-byte aligned");
};

template <int D, typename T>
__global__ void __launch_bounds__(THREADS) attn_fwd_kernel(const Params p) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + L::Q_OFF);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem + L::K_OFF);
  __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(smem + L::V_OFF);
  float* s_s = reinterpret_cast<float*>(smem + L::S_OFF);
  __nv_bfloat16* p_s = reinterpret_cast<__nv_bfloat16*>(smem + L::P_OFF);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
  const T* qg = static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[1];
  const T* kg = static_cast<const T*>(p.k) + b * p.ks[0] + h * p.ks[1];
  const T* vg = static_cast<const T*>(p.v) + b * p.vs[0] + h * p.vs[1];
  T* og = static_cast<T*>(p.out) + b * p.os[0] + h * p.os[1];
  const long long tab = (long long)(p.cos_heads == 1 ? 0 : h) * p.N * (D / 2);
  const float* cos_h = p.cos != nullptr ? p.cos + tab : nullptr;
  const float* sin_h = p.sin != nullptr ? p.sin + tab : nullptr;
  const float* bias_h = p.bias != nullptr ? p.bias + (long long)h * p.N * p.N : nullptr;

  float* s_w = s_s + warp * 16 * L::LDS;
  __nv_bfloat16* p_w = p_s + warp * 16 * L::LDP;
  const int row_w = q0 + warp * 16;
  const int n_kv = (p.N + TK - 1) / TK;

  stage_tile<D, T>(q_s, qg, p.qs[2], q0, p.N, cos_h, sin_h);
  __syncthreads();
  FragA qa[D / 16];
  load_rows<D>(qa, q_s + warp * 16 * L::LDX);

  // Row statistics: lane l owns row l/2 of the warp's 16 rows and half
  // (l % 2) of each tile's TK columns; the lane pair combines with one
  // shuffle, so both lanes hold their row's max and sum.
  const int my_row = lane >> 1;
  const int col0 = (lane & 1) * (TK / 2);
  const int qi = row_w + my_row;
  const float* s_row = s_w + my_row * L::LDS + col0;

  // Pass 1: row maxima.
  float m = NEG_INF;
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * TK;
    __syncthreads();  // every warp is done with the previous K tile
    stage_tile<D, T>(k_s, kg, p.ks[2], k0, p.N, cos_h, sin_h);
    __syncthreads();
    warp_abt<D, L::LDS>(s_w, qa, k_s);
    __syncwarp();
    float mx = NEG_INF;
#pragma unroll 8
    for (int j = 0; j < TK / 2; ++j)
      mx = fmaxf(mx, logit(s_row[j], qi, k0 + col0 + j, p.N, p.scale, bias_h));
    m = fmaxf(m, fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1)));
    __syncwarp();
  }

  // Pass 2: p = exp(s - max), row sums of unrounded p, O += bf16(p) . V.
  FragC o_acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(o_acc[n], 0.f);
  float l = 0.f;
  __nv_bfloat16* p_row = p_w + my_row * L::LDP + col0;
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * TK;
    __syncthreads();  // every warp is done with the previous K and V tiles
    stage_tile<D, T>(k_s, kg, p.ks[2], k0, p.N, cos_h, sin_h);
    stage_tile<D, T>(v_s, vg, p.vs[2], k0, p.N, nullptr, nullptr);
    __syncthreads();
    warp_abt<D, L::LDS>(s_w, qa, k_s);
    __syncwarp();
    float sum = 0.f;
#pragma unroll 8
    for (int j = 0; j < TK / 2; ++j) {
      const float e = expf(logit(s_row[j], qi, k0 + col0 + j, p.N, p.scale, bias_h) - m);
      sum += e;
      p_row[j] = __float2bfloat16(e);
    }
    l += sum + __shfl_xor_sync(0xffffffffu, sum, 1);
    __syncwarp();
    warp_ab_acc<D, L::LDP>(o_acc, p_w, v_s);
  }

  // Epilogue: normalize after the PV product and write the input dtype.
  __syncwarp();
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(s_w + n * 16, o_acc[n], L::LDS, wmma::mem_row_major);
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const float l_r = __shfl_sync(0xffffffffu, l, 2 * r);
    if (row_w + r >= p.N) continue;
    T* orow = og + (row_w + r) * p.os[2];
    for (int d = lane; d < D; d += 32) store(orow + d, s_w[r * L::LDS + d] / l_r);
  }
}

template <int D, typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = Layout<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + TQ - 1) / TQ, p.H, p.B);
  attn_fwd_kernel<D, T><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
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

// The resident route: one CTA of ceil(N/16) warps per (batch, head); KB is
// the largest block count of the instance's bucket (dense::SMALL_BLOCKS or
// dense::MAX_BLOCKS), which sizes the score registers.
template <int D, int KB, typename T>
__global__ void __launch_bounds__(32 * KB, 1) attn_fwd_resident_kernel(const Params p) {
  using namespace dense;
  constexpr int LD = pitch<D>();
  constexpr int H2 = D / 2;
  constexpr int PER_ROW = D / 8;  // staging items (4 + 4 columns) per row
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = p.N, nkb = (N + 15) / 16, np = nkb * 16;
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* k_s = q_s + np * LD;
  __nv_bfloat16* v_s = k_s + np * LD;

  const int warp = threadIdx.x / 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const T* qg = static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[1];
  const T* kg = static_cast<const T*>(p.k) + b * p.ks[0] + h * p.ks[1];
  const T* vg = static_cast<const T*>(p.v) + b * p.vs[0] + h * p.vs[1];
  T* og = static_cast<T*>(p.out) + b * p.os[0] + h * p.os[1];
  const long long tab = (long long)(p.cos_heads == 1 ? 0 : h) * N * H2;
  const float* cos_h = p.cos != nullptr ? p.cos + tab : nullptr;
  const float* sin_h = p.sin != nullptr ? p.sin + tab : nullptr;
  const float* bias_h = p.bias != nullptr ? p.bias + (long long)h * N * N : nullptr;

  // Stage Q, K (rotated) and V of the whole head: 2 * np threads, D / 16
  // items each of 4 columns at c and their 4 rotation partners at c + D/2.
#pragma unroll 2
  for (int it = 0; it < D / 16; ++it) {
    const int i = it * blockDim.x + threadIdx.x;
    const int r = i / PER_ROW, c = (i % PER_ROW) * 4;
    float q1[4] = {}, q2[4] = {}, k1[4] = {}, k2[4] = {}, v1[4] = {}, v2[4] = {};
    float cs[4] = {1.f, 1.f, 1.f, 1.f}, sn[4] = {};
    if (r < N) {
      load4(qg + r * p.qs[2] + c, q1);
      load4(qg + r * p.qs[2] + c + H2, q2);
      load4(kg + r * p.ks[2] + c, k1);
      load4(kg + r * p.ks[2] + c + H2, k2);
      load4(vg + r * p.vs[2] + c, v1);
      load4(vg + r * p.vs[2] + c + H2, v2);
      if (cos_h != nullptr) {
        load4(cos_h + (long long)r * H2 + c, cs);
        load4(sin_h + (long long)r * H2 + c, sn);
      }
    }
    if (cos_h != nullptr) {
      rotate4(q1, q2, cs, sn);
      rotate4(k1, k2, cs, sn);
    }
    put4(q_s + r * LD + c, q1);
    put4(q_s + r * LD + c + H2, q2);
    put4(k_s + r * LD + c, k1);
    put4(k_s + r * LD + c + H2, k2);
    put4(v_s + r * LD + c, v1);
    put4(v_s + r * LD + c + H2, v2);
  }
  __syncthreads();

  // S = Q_w . K^T: the warp's 16 rows against every key, in registers.
  const int row0 = warp * 16;
  float s[KB][2][4];
#pragma unroll
  for (int j = 0; j < KB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][0][e] = s[j][1][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    load_a<LD>(a, q_s, row0, kk * 16);
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      if (j < nkb) {
        uint32_t bb[4];
        load_bt<LD>(bb, k_s, j * 16, kk * 16);
        mma(s[j][0], a, bb[0], bb[1]);
        mma(s[j][1], a, bb[2], bb[3]);
      }
    }
  }

  // Logits, the final row max (rows g and g+8 of the tile; a row's columns
  // lie in the 4 lanes of a quad), p = exp(s - max) and its unrounded sum.
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < KB; ++j) {
    if (j < nkb) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int qi, kj;
          tile_coords(e, row0, j * 16 + nt * 8, qi, kj);
          const float x = logit(s[j][nt][e], qi, kj, N, p.scale, bias_h);
          s[j][nt][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
    }
  }
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
#pragma unroll
  for (int j = 0; j < KB; ++j) {
    if (j < nkb) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = expf(s[j][nt][e] - mx[e >> 1]);
          s[j][nt][e] = x;
          l[e >> 1] += x;
        }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  // O = bf16(p) . V, p repacked from the score tiles in registers (all of
  // it first, so that the f32 scores and the O accumulator are never live
  // together: at D = 128 they would not fit).
  uint32_t pa[KB][4];
#pragma unroll
  for (int j = 0; j < KB; ++j)
    if (j < nkb) pack_a(pa[j], s[j][0], s[j][1]);
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
  for (int j = 0; j < KB; ++j) {
    if (j < nkb) {
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        uint32_t bb[4];
        load_b<LD>(bb, v_s, j * 16, n * 16);
        mma(o[2 * n], pa[j], bb[0], bb[1]);
        mma(o[2 * n + 1], pa[j], bb[2], bb[3]);
      }
    }
  }

  // Normalize after the PV product; write the input dtype.
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const float c[4] = {o[n][0] / l[0], o[n][1] / l[0], o[n][2] / l[1],
                        o[n][3] / l[1]};
    store_tile(og, p.os[2], row0, n * 8, N, c);
  }
}

template <int D, int KB, typename T>
cudaError_t launch_resident(const Params& p, cudaStream_t stream) {
  const int nkb = (p.N + 15) / 16;
  const size_t smem = size_t(3) * nkb * 16 * dense::pitch<D>() * 2;
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_resident_kernel<D, KB, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  attn_fwd_resident_kernel<D, KB, T><<<dim3(p.H, p.B), 32 * nkb, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, typename T>
cudaError_t bucket(const Params& p, cudaStream_t stream) {
  const int nkb = (p.N + 15) / 16;
  if (nkb <= dense::SMALL_BLOCKS) return launch_resident<D, dense::SMALL_BLOCKS, T>(p, stream);
  if (nkb <= dense::MAX_BLOCKS) return launch_resident<D, dense::MAX_BLOCKS, T>(p, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_resident(const Params& p, int head_dim, cudaStream_t stream) {
  switch (head_dim) {
    case 16: return bucket<16, T>(p, stream);
    case 32: return bucket<32, T>(p, stream);
    case 64: return bucket<64, T>(p, stream);
    case 128: return bucket<128, T>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

Params make_params(const void* q, const void* k, const void* v, void* out,
                   const void* bias, const void* cos, const void* sin, int B,
                   int H, int N, int cos_heads, const long long* strides,
                   float scale) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.bias = static_cast<const float*>(bias);
  p.cos = static_cast<const float*>(cos);
  p.sin = static_cast<const float*>(sin);
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
    p.os[i] = strides[9 + i];
  }
  p.B = B;
  p.H = H;
  p.N = N;
  p.cos_heads = cos_heads;
  p.scale = scale;
  return p;
}

}  // namespace

// Plain C entry points (bound with ctypes), the wide route and the resident
// one (N <= 16 * dense::MAX_BLOCKS; 16-byte aligned rows of q, k, v, out
// and the tables). strides holds 12 element strides: (batch, head, token)
// of q, k, v and out, in that order. Each returns the CUDA error of the
// launch (0 on success); neither synchronizes.
extern "C" int attn_fwd(const void* q, const void* k, const void* v, void* out,
                        const void* bias, const void* cos, const void* sin, int B,
                        int H, int N, int D, int is_bf16, int cos_heads,
                        const long long* strides, float scale, void* stream) {
  const Params p = make_params(q, k, v, out, bias, cos, sin, B, H, N,
                               cos_heads, strides, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? dispatch<__nv_bfloat16>(p, D, s)
                                  : dispatch<float>(p, D, s);
  return int(err);
}

extern "C" int attn_fwd_resident(const void* q, const void* k, const void* v,
                                 void* out, const void* bias, const void* cos,
                                 const void* sin, int B, int H, int N, int D,
                                 int is_bf16, int cos_heads,
                                 const long long* strides, float scale,
                                 void* stream) {
  const Params p = make_params(q, k, v, out, bias, cos, sin, B, H, N,
                               cos_heads, strides, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? dispatch_resident<__nv_bfloat16>(p, D, s)
                                  : dispatch_resident<float>(p, D, s);
  return int(err);
}
