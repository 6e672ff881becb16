// A whole pre-LN transformer block forward, for Hopper (sm_90a).
//
// Replaces: the Pallas kernel `_block_kernel` (launched by `block_forward`)
// of vit_rpe_rope_tpu/ops/block_fused.py.
//
// Computes, for x [B, N, E] (float32 or bfloat16, contiguous) and one
// block's weights (LN and bias vectors float32; Wqkv [3E, E], Wproj [E, E],
// W1 [hidden, E], W2 [E, hidden] in bf16, torch layout), per image:
//   h    = LN1(x)                                     f32
//   q, k, v = bf16(h) . bf16(Wqkv)^T                  f32 accumulation
//   q, k rotated (half split, f32, the cls row of the tables the identity)
//   s    = bf16(q) . bf16(k)^T * scale, keys >= N at -1e30
//   p    = exp(s - max_j s),  den = sum_j p
//   o    = (bf16(p) . bf16(v)) / den
//   x2   = x + sum over heads of bf16(o_h) . bf16(Wproj[:, head])^T, + bproj
//   f1   = bf16(LN2(x2)) . bf16(W1)^T + b1,  g = 0.5 f1 (1 + erf(f1 / sqrt 2))
//          with erf by Abramowitz & Stegun 7.1.26, as the TPU kernel
//   y    = x2 + sum over 128-column chunks of bf16(g) . bf16(W2)^T, + b2
// and writes y in x's dtype. No logits bias, no backward.
//
// What bounds it on an H100: operations. At ViT-tiny/4 (B=128, N=65, E=192,
// 6 heads of 32, hidden 768) the five products are 7.8 GFLOP, about 7.9 us at
// 989 TFLOP/s; the activations in and out and the weights are 14.6 MB, about
// 4.4 us at 3.35 TB/s.
//
// Design: the TPU kernel runs a sequential grid over batch tiles with the
// tile's whole block resident in VMEM. Here one CTA of 8 warps holds one
// image in shared memory (the f32 residual, the bf16 LN output, then either
// one head's q/k/v, logits and probabilities or one MLP chunk; the Python
// wrapper lays it out and refuses images that do not fit in 227 KB), so
// activations touch device memory once in and once out; B = 128 images fill
// 128 of the 132 SMs. The heads loop inside the CTA, each head's projection
// adding into the residual; fc1 -> GELU -> fc2 runs in chunks of 128 hidden
// columns, each chunk's fc2 product adding into the residual. The products
// are WMMA 16x16x16 bf16 tiles with f32 accumulation. Each warp owns a
// 16-column strip of an output and walks its row tiles with one B fragment,
// so the weights stream from L2 once per image, read as bf16 fragments
// straight from memory. wgmma / TMA and clusters (distributed shared memory,
// for images that do not fit one CTA) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int RT = 8;  // row tiles a warp accumulates at once
constexpr float NEG_INF = -1e30f;

// Integer arguments of the C entry point, in this order (the Python
// wrapper's _DIMS): shapes, then the row pitches (elements) and byte offsets
// of smem_layout in ops/block_fused.py.
enum Dim {
  D_B, D_N, D_E, D_H, D_DH, D_HID, D_IS_BF16, D_HAS_ROPE, D_NP, D_CH,
  D_LDR, D_LDH, D_LDD, D_LDQ, D_LDS, D_LDP, D_LDO, D_LDF, D_LDG,
  D_XRES, D_HLN, D_STAGE, D_Q, D_K, D_V, D_O, D_P, D_DEN, D_F1, D_G, D_SMEM,
  D_COUNT
};

struct Params {
  const void* x;
  void* out;
  const float *n1w, *n1b, *pb, *n2w, *n2b, *b1, *b2;
  const bf16 *wqkv, *wp, *w1, *w2;
  const float *cos, *sin;  // [N, DH/2] or null
  int d[D_COUNT];
  float eps, scale;
};

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(bf16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// out[16 * nrt rows, 16 columns] (f32 shared, pitch ldo) = (ACC ? out : 0) +
// A . B, A bf16 row-major [rows, K] in shared memory (pitch lda), B bf16 with
// element (k, n) at b[n * ldb + k] (B_ROW false: a torch-layout weight, read
// straight from memory) or b[k * ldb + n] (B_ROW true). Row tiles go in
// groups of RT, each group reading every B fragment once.
template <bool B_ROW, bool ACC>
__device__ void strip(float* out, int ldo, int nrt, const bf16* a, int lda, const bf16* b,
                      int ldb, int K) {
  using Layout = typename std::conditional<B_ROW, wmma::row_major, wmma::col_major>::type;
  for (int r0 = 0; r0 < nrt; r0 += RT) {
    const int nr = min(RT, nrt - r0);
    FragC acc[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (r < nr) {
        if (ACC)
          wmma::load_matrix_sync(acc[r], out + (r0 + r) * 16 * ldo, ldo, wmma::mem_row_major);
        else
          wmma::fill_fragment(acc[r], 0.f);
      }
    }
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, Layout> bf;
      wmma::load_matrix_sync(bf, B_ROW ? b + (long long)k * ldb : b + k, ldb);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        if (r < nr) {
          FragA af;
          wmma::load_matrix_sync(af, a + (r0 + r) * 16 * lda + k, lda);
          wmma::mma_sync(acc[r], af, bf, acc[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RT; ++r)
      if (r < nr)
        wmma::store_matrix_sync(out + (r0 + r) * 16 * ldo, acc[r], ldo, wmma::mem_row_major);
  }
}

// hln = bf16(LayerNorm(xres)) over rows < N, in f32 with the biased
// variance; rows N .. NP-1 are zeros. One warp per row.
__device__ void layer_norm(const Params& p, const float* xres, bf16* hln, const float* w,
                           const float* b) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int N = p.d[D_N], E = p.d[D_E], NP = p.d[D_NP], ldr = p.d[D_LDR], ldh = p.d[D_LDH];
  for (int r = warp; r < NP; r += WARPS) {
    bf16* dst = hln + r * ldh;
    if (r >= N) {
      for (int c = lane; c < E; c += 32) dst[c] = __float2bfloat16(0.f);
      continue;
    }
    const float* row = xres + r * ldr;
    float s = 0.f;
    for (int c = lane; c < E; c += 32) s += row[c];
    const float mean = warp_sum(s) / E;
    float v = 0.f;
    for (int c = lane; c < E; c += 32) {
      const float dv = row[c] - mean;
      v += dv * dv;
    }
    const float inv = 1.f / sqrtf(warp_sum(v) / E + p.eps);
    for (int c = lane; c < E; c += 32)
      dst[c] = __float2bfloat16(__fadd_rn(__fmul_rn(__fmul_rn(row[c] - mean, inv), w[c]), b[c]));
  }
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

template <typename T>
__global__ void __launch_bounds__(THREADS) block_fused_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = p.d[D_N], E = p.d[D_E], H = p.d[D_H], DH = p.d[D_DH], HID = p.d[D_HID];
  const int NP = p.d[D_NP], CH = p.d[D_CH], nrt = NP / 16, H2 = DH / 2;
  const int ldr = p.d[D_LDR], ldh = p.d[D_LDH], ldd = p.d[D_LDD], ldq = p.d[D_LDQ];
  const int lds = p.d[D_LDS], ldp = p.d[D_LDP], ldo = p.d[D_LDO], ldf = p.d[D_LDF];
  const int ldg = p.d[D_LDG];
  float* xres = reinterpret_cast<float*>(smem + p.d[D_XRES]);
  bf16* hln = reinterpret_cast<bf16*>(smem + p.d[D_HLN]);
  float* stage = reinterpret_cast<float*>(smem + p.d[D_STAGE]);
  bf16* q_s = reinterpret_cast<bf16*>(smem + p.d[D_Q]);
  bf16* k_s = reinterpret_cast<bf16*>(smem + p.d[D_K]);
  bf16* v_s = reinterpret_cast<bf16*>(smem + p.d[D_V]);
  bf16* o_s = reinterpret_cast<bf16*>(smem + p.d[D_O]);
  bf16* p_s = reinterpret_cast<bf16*>(smem + p.d[D_P]);
  float* den = reinterpret_cast<float*>(smem + p.d[D_DEN]);
  float* f1 = reinterpret_cast<float*>(smem + p.d[D_F1]);
  bf16* g_s = reinterpret_cast<bf16*>(smem + p.d[D_G]);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long img = (long long)blockIdx.x * N * E;
  const T* xg = static_cast<const T*>(p.x) + img;
  const bool rope = p.d[D_HAS_ROPE] != 0;

  // the image's residual stream, padded rows zero
  for (int i = threadIdx.x; i < NP * E; i += THREADS) {
    const int r = i / E, c = i % E;
    xres[r * ldr + c] = r < N ? load_f32(xg + (long long)r * E + c) : 0.f;
  }
  __syncthreads();
  layer_norm(p, xres, hln, p.n1w, p.n1b);
  __syncthreads();

  for (int hh = 0; hh < H; ++hh) {
    // q, k, v of this head: [NP, 3 DH] f32 in stage, one 16-column strip
    // per warp (qkv weight rows part * E + head * DH + d)
    for (int s = warp; s < 3 * DH / 16; s += WARPS) {
      const int part = s / (DH / 16), col = (s % (DH / 16)) * 16;
      strip<false, false>(stage + s * 16, ldq, nrt, hln, ldh,
                          p.wqkv + (long long)(part * E + hh * DH + col) * E, E, E);
    }
    __syncthreads();
    // rotate q and k in f32 (op by op, as the twin), round q, k, v to bf16
    for (int i = threadIdx.x; i < NP * H2; i += THREADS) {
      const int r = i / H2, c = i % H2;
      const float* row = stage + r * ldq;
      float cs = 1.f, sn = 0.f;
      if (rope && r < N) {
        cs = p.cos[r * H2 + c];
        sn = p.sin[r * H2 + c];
      }
      const float q1 = row[c], q2 = row[c + H2], k1 = row[DH + c], k2 = row[DH + c + H2];
      q_s[r * ldd + c] = __float2bfloat16(__fsub_rn(__fmul_rn(q1, cs), __fmul_rn(q2, sn)));
      q_s[r * ldd + c + H2] = __float2bfloat16(__fadd_rn(__fmul_rn(q1, sn), __fmul_rn(q2, cs)));
      k_s[r * ldd + c] = __float2bfloat16(__fsub_rn(__fmul_rn(k1, cs), __fmul_rn(k2, sn)));
      k_s[r * ldd + c + H2] = __float2bfloat16(__fadd_rn(__fmul_rn(k1, sn), __fmul_rn(k2, cs)));
      v_s[r * ldd + c] = __float2bfloat16(row[2 * DH + c]);
      v_s[r * ldd + c + H2] = __float2bfloat16(row[2 * DH + c + H2]);
    }
    __syncthreads();
    // s = q . k^T (unscaled) into stage [NP, NP]
    for (int s = warp; s < nrt; s += WARPS)
      strip<false, false>(stage + s * 16, lds, nrt, q_s, ldd, k_s + s * 16 * ldd, ldd, DH);
    __syncthreads();
    // p = exp(s * scale - max) against the final row max, unnormalized
    for (int r = warp; r < NP; r += WARPS) {
      const float* row = stage + r * lds;
      float m = NEG_INF;
      for (int j = lane; j < NP; j += 32)
        m = fmaxf(m, j < N ? __fmul_rn(row[j], p.scale) : NEG_INF);
      m = warp_max(m);
      float sum = 0.f;
      for (int j = lane; j < NP; j += 32) {
        const float pj = expf((j < N ? __fmul_rn(row[j], p.scale) : NEG_INF) - m);
        sum += pj;
        p_s[r * ldp + j] = __float2bfloat16(pj);
      }
      sum = warp_sum(sum);
      if (lane == 0) den[r] = sum;
    }
    __syncthreads();
    // o = p . v into stage [NP, DH], then divided by the row sums
    for (int s = warp; s < DH / 16; s += WARPS)
      strip<true, false>(stage + s * 16, ldo, nrt, p_s, ldp, v_s + s * 16, ldd, NP);
    __syncthreads();
    for (int i = threadIdx.x; i < NP * DH; i += THREADS) {
      const int r = i / DH, c = i % DH;
      o_s[r * ldd + c] = __float2bfloat16(__fdiv_rn(stage[r * ldo + c], den[r]));
    }
    __syncthreads();
    // residual += o . Wproj[:, head cols]^T
    for (int s = warp; s < E / 16; s += WARPS)
      strip<false, true>(xres + s * 16, ldr, nrt, o_s, ldd,
                         p.wp + (long long)s * 16 * E + hh * DH, E, DH);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < NP * E; i += THREADS) {
    const int r = i / E, c = i % E;
    xres[r * ldr + c] += p.pb[c];
  }
  __syncthreads();
  layer_norm(p, xres, hln, p.n2w, p.n2b);
  __syncthreads();

  for (int c0 = 0; c0 < HID; c0 += CH) {
    const int cw = min(CH, HID - c0);
    for (int s = warp; s < cw / 16; s += WARPS)
      strip<false, false>(f1 + s * 16, ldf, nrt, hln, ldh,
                          p.w1 + (long long)(c0 + s * 16) * E, E, E);
    __syncthreads();
    for (int i = threadIdx.x; i < NP * cw; i += THREADS) {
      const int r = i / cw, c = i % cw;
      const float f = f1[r * ldf + c] + p.b1[c0 + c];
      const float g = __fmul_rn(__fmul_rn(0.5f, f), 1.f + erf_as(__fmul_rn(f, 0.70710677f)));
      g_s[r * ldg + c] = __float2bfloat16(g);
    }
    __syncthreads();
    for (int s = warp; s < E / 16; s += WARPS)
      strip<false, true>(xres + s * 16, ldr, nrt, g_s, ldg,
                         p.w2 + (long long)s * 16 * HID + c0, HID, cw);
    __syncthreads();
  }
  T* og = static_cast<T*>(p.out) + img;
  for (int i = threadIdx.x; i < N * E; i += THREADS) {
    const int r = i / E, c = i % E;
    store_out(og + (long long)r * E + c, xres[r * ldr + c] + p.b2[c]);
  }
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int smem = p.d[D_SMEM];
  cudaError_t err = cudaFuncSetAttribute(block_fused_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  block_fused_kernel<T><<<p.d[D_B], THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). ptrs holds 15 device pointers:
// x out norm1.weight norm1.bias proj.bias norm2.weight norm2.bias fc1.bias
// fc2.bias (float32) Wqkv Wproj W1 W2 (bf16, 256-byte aligned) cos sin
// (float32 [N, DH/2] or null); dims holds the integers of Dim. Returns the
// CUDA error of the launch (0 on success) and does not synchronize.
extern "C" int block_fused_fwd(void* const* ptrs, const int* dims, float eps, float scale,
                               void* stream) {
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
  p.wqkv = static_cast<const bf16*>(ptrs[9]);
  p.wp = static_cast<const bf16*>(ptrs[10]);
  p.w1 = static_cast<const bf16*>(ptrs[11]);
  p.w2 = static_cast<const bf16*>(ptrs[12]);
  p.cos = static_cast<const float*>(ptrs[13]);
  p.sin = static_cast<const float*>(ptrs[14]);
  for (int i = 0; i < D_COUNT; ++i) p.d[i] = dims[i];
  p.eps = eps;
  p.scale = scale;
  const int E = p.d[D_E], DH = p.d[D_DH];
  if (p.d[D_B] < 1 || p.d[D_N] < 1 || p.d[D_NP] < p.d[D_N] || p.d[D_NP] % 16 || E % 16 ||
      DH % 16 || p.d[D_H] * DH != E || p.d[D_HID] % 16 || p.d[D_CH] % 16 ||
      (p.d[D_HAS_ROPE] && (p.cos == nullptr || p.sin == nullptr)))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      p.d[D_IS_BF16] ? launch<bf16>(p, s) : launch<float>(p, s);
  return int(err);
}
