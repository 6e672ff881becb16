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
// exactly as the JAX kernel does (bf16 operands, f32 accumulation, the
// division after the PV product).
//
// What bounds it on an H100: memory. At the serving shape of ViT-S/16@224
// (B=64, H=6, N=197, D=64, f32) q+k+v+out is 77.5 MB, about 23 us at
// 3.35 TB/s, against 3.8 GFLOP of products, about 4 us at 989 TFLOP/s.
//
// Design: the TPU kernel holds every head of a batch block in VMEM with
// 8/128-padded tiles. Here one CTA of 4 warps takes one (batch, head, 64-row
// query tile); each warp owns 16 query rows. K and V stream through shared
// memory in 64-key tiles, rotated and rounded to bf16 on the way in; the
// ragged edge is masked in the kernel, with no padded copies in device
// memory. Products run on the tensor cores through WMMA bf16 16x16x16 with
// f32 accumulation. The softmax takes two passes over the keys: the first
// finds each row's max, the second forms p = exp(s - max) with the final max,
// so bf16(p) is rounded exactly where the JAX kernel rounds it (an online
// softmax would round p against a running max instead), and the PV
// accumulator needs no rescaling and stays in WMMA fragments. The first pass
// costs one extra Q.K^T, which a memory-bound kernel can afford. Each thread
// issues its staging loads in chunks before using them, and each lane pair
// owns one query row's statistics. Measured, the kernel is latency-bound
// (few warps per SM, serial stage/barrier/product steps per tile), far from
// its memory bound: wgmma / TMA pipelining is later work.

#include "attn_common.cuh"

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

}  // namespace

// Plain C entry point (bound with ctypes). strides holds 12 element strides:
// (batch, head, token) of q, k, v and out, in that order. Returns the CUDA
// error of the launch (0 on success); does not synchronize.
extern "C" int attn_fwd(const void* q, const void* k, const void* v, void* out,
                        const void* bias, const void* cos, const void* sin, int B,
                        int H, int N, int D, int is_bf16, int cos_heads,
                        const long long* strides, float scale, void* stream) {
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? dispatch<__nv_bfloat16>(p, D, s)
                                  : dispatch<float>(p, D, s);
  return int(err);
}
