// Pieces shared by the attention kernels (attn_fwd.cu, attn_bwd.cu and the
// streaming attn_stream_fwd.cu, attn_stream_bwd.cu): tile sizes, the bf16
// staging of q/k/v/g tiles with the in-kernel rope rotation, the WMMA
// fragment types, the warp-level A.B^T product, the scaled, biased, masked
// logit of the dense kernels, the gradient epilogue and the launch helper.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace attn {

using namespace nvcuda;

constexpr int TQ = 64;  // query rows per tile
constexpr int TK = 64;  // keys per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr float NEG_INF = -1e30f;

// Row pitch (elements) of a bf16 [64, D] tile in shared memory.
template <int D>
__host__ __device__ constexpr int ldx() { return D + 8; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Stage rows [row0, row0 + 64) of one (batch, head) slice into shared memory
// as bf16, rotated first when cos/sin are given. Rows >= N are zero.
// Each thread issues the loads of CHUNK elements before it uses any of them,
// so their latencies overlap. The rotation is rounded op by op (no FMA
// contraction), as PyTorch's elementwise twin rounds it.
template <int D, typename T>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst,
                                           const T* __restrict__ src,
                                           long long stride_n, int row0,
                                           int n_tokens,
                                           const float* __restrict__ cos_h,
                                           const float* __restrict__ sin_h) {
  constexpr int H2 = D / 2;
  constexpr int LDX = ldx<D>();
  constexpr int ITERS = TQ * H2 / THREADS;
  constexpr int CHUNK = ITERS < 8 ? ITERS : 8;
  static_assert(ITERS % CHUNK == 0, "staging loop must split into chunks");
#pragma unroll
  for (int it0 = 0; it0 < ITERS; it0 += CHUNK) {
    float x1[CHUNK], x2[CHUNK], cs[CHUNK], sn[CHUNK];
#pragma unroll
    for (int u = 0; u < CHUNK; ++u) {
      const int i = (it0 + u) * THREADS + threadIdx.x;
      const int r = i / H2, c = i % H2, n = row0 + r;
      x1[u] = 0.f;
      x2[u] = 0.f;
      cs[u] = 1.f;
      sn[u] = 0.f;
      if (n < n_tokens) {
        const T* row = src + n * stride_n;
        x1[u] = to_f32(row[c]);
        x2[u] = to_f32(row[c + H2]);
        if (cos_h != nullptr) {
          cs[u] = cos_h[(long long)n * H2 + c];
          sn[u] = sin_h[(long long)n * H2 + c];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < CHUNK; ++u) {
      const int i = (it0 + u) * THREADS + threadIdx.x;
      const int r = i / H2, c = i % H2;
      float y1 = x1[u], y2 = x2[u];
      if (cos_h != nullptr) {
        y1 = __fsub_rn(__fmul_rn(x1[u], cs[u]), __fmul_rn(x2[u], sn[u]));
        y2 = __fadd_rn(__fmul_rn(x1[u], sn[u]), __fmul_rn(x2[u], cs[u]));
      }
      dst[r * LDX + c] = __float2bfloat16(y1);
      dst[r * LDX + c + H2] = __float2bfloat16(y2);
    }
  }
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBt = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Load one warp's 16 rows of a bf16 [64, D] shared tile as A fragments.
template <int D>
__device__ __forceinline__ void load_rows(FragA (&a)[D / 16],
                                          const __nv_bfloat16* tile_rows) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(a[kk], tile_rows + kk * 16, ldx<D>());
}

// s_w[16][64] = a[16][D] . B^T for a bf16 [64, D] shared tile B (f32
// accumulation), stored row-major with pitch LDS.
template <int D, int LDS>
__device__ __forceinline__ void warp_abt(float* s_w, const FragA (&a)[D / 16],
                                         const __nv_bfloat16* b_s) {
  constexpr int LDX = ldx<D>();
#pragma unroll
  for (int j = 0; j < TK / 16; ++j) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragBt b;
      wmma::load_matrix_sync(b, b_s + j * 16 * LDX + kk * 16, LDX);
      wmma::mma_sync(acc, a[kk], b, acc);
    }
    wmma::store_matrix_sync(s_w + j * 16, acc, LDS, wmma::mem_row_major);
  }
}

// acc[D/16] += p_w[16][64] . B for a bf16 [16, 64] row block p_w (pitch LDP)
// and a bf16 [64, D] shared tile B.
template <int D, int LDP>
__device__ __forceinline__ void warp_ab_acc(FragC (&acc)[D / 16],
                                            const __nv_bfloat16* p_w,
                                            const __nv_bfloat16* b_s) {
  constexpr int LDX = ldx<D>();
#pragma unroll
  for (int kk = 0; kk < TK / 16; ++kk) {
    FragA pa;
    wmma::load_matrix_sync(pa, p_w + kk * 16, LDP);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      FragB b;
      wmma::load_matrix_sync(b, b_s + kk * 16 * LDX + n * 16, LDX);
      wmma::mma_sync(acc[n], pa, b, acc[n]);
    }
  }
}

// Scaled, biased, masked logit of query row qi against key kj.
__device__ __forceinline__ float logit(float acc, int qi, int kj, int n_tokens,
                                       float scale, const float* bias_h) {
  if (kj >= n_tokens) return NEG_INF;
  float s = __fmul_rn(acc, scale);
  if (bias_h != nullptr && qi < n_tokens)
    s = __fadd_rn(s, bias_h[(long long)qi * n_tokens + kj]);
  return s;
}

template <typename T>
__device__ __forceinline__ const T* slice(const void* base, const long long* s,
                                          int b, int h) {
  return static_cast<const T*>(base) + b * s[0] + h * s[1];
}

// scale * acc for one row of a [16, D] f32 slab, written in f32 (before the
// rotation, when dr is given) and, rotated back with -sin, in the input
// dtype. Rows >= N are skipped.
template <int D, typename T>
__device__ __forceinline__ void write_grad_rows(const float* s_w, int ld,
                                                int row_w, int n_tokens,
                                                float scale, T* dst,
                                                long long dst_stride,
                                                float* dr,
                                                const float* cos_h,
                                                const float* sin_h) {
  constexpr int H2 = D / 2;
  const int lane = threadIdx.x % 32;
  for (int r = 0; r < 16; ++r) {
    const int row = row_w + r;
    if (row >= n_tokens) break;
    T* out = dst + row * dst_stride;
    for (int c = lane; c < H2; c += 32) {
      const float x1 = __fmul_rn(scale, s_w[r * ld + c]);
      const float x2 = __fmul_rn(scale, s_w[r * ld + c + H2]);
      if (dr != nullptr) {
        dr[(long long)row * D + c] = x1;
        dr[(long long)row * D + c + H2] = x2;
      }
      float y1 = x1, y2 = x2;
      if (cos_h != nullptr) {
        const float cs = cos_h[(long long)row * H2 + c];
        const float sn = -sin_h[(long long)row * H2 + c];
        y1 = __fsub_rn(__fmul_rn(x1, cs), __fmul_rn(x2, sn));
        y2 = __fadd_rn(__fmul_rn(x1, sn), __fmul_rn(x2, cs));
      }
      store(out + c, y1);
      store(out + c + H2, y2);
    }
  }
}

// Launch `kernel` with `smem` bytes of dynamic shared memory; returns the
// launch's error.
template <typename K, typename P>
cudaError_t launch_kernel(K kernel, dim3 grid, size_t smem, const P& p,
                          cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace attn
