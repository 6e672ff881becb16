// Pieces of the resident dense attention kernels (attn_fwd.cu and
// attn_bwd.cu), which hold a whole (batch, head) in one CTA: the block
// buckets they are built for, the staging of whole heads into shared memory
// with 16-byte loads, the mma.sync.m16n8k16 bf16 products on ldmatrix
// fragments, the 16-byte stores of an accumulator tile and the gradient
// epilogue. The separate-pass streaming backward (attn_stream_bwd.cu) uses
// the same fragments, stores and epilogue, and the cp.async copies here.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16 operands; g = lane / 4,
// t = lane % 4):
//   A [16 x 16], 4 regs of bf16x2: (g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..),
//                                  (g+8, 2t+8..)
//   B [16 x 8],  2 regs:           (k 2t..2t+1, n g), (k 2t+8.., n g)
//   C [16 x 8],  4 f32:            (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)
// so the C tiles of two neighbouring 8-column blocks are, rounded to bf16
// and packed in pairs, the A operand of a product over those 16 columns:
// probabilities and ds go from one product to the next in registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_common.cuh"

namespace attn {
namespace dense {

// A CTA holds the whole padded sequence, 16 rows per warp, so it takes
// ceil(N / 16) warps. The kernels are built for two buckets of that count:
// up to 5 blocks (N <= 80: MNIST's 50, ViT-tiny/4's 65) and up to 13
// (N <= 208: ViT-S/16@224's 197). 13 is the largest count whose 8 score
// registers per block and thread fit beside the rest in the 128 registers
// a thread that ptxas grants a CTA of 13 to 16 warps (it hands out the
// register file for 4 warps at a time: 65,536 / 512; 152 for 13 warps
// fails to launch). flash_attention.dense_resident mirrors this.
constexpr int SMALL_BLOCKS = 5;
constexpr int MAX_BLOCKS = 13;

template <int D>
__host__ __device__ constexpr int pitch() { return D + 8; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a . b (bf16 operands, f32 accumulation).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A operand over 16 columns from the C tiles of its two 8-column halves.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack(c0[0], c0[1]);
  a[1] = pack(c0[2], c0[3]);
  a[2] = pack(c1[0], c1[1]);
  a[3] = pack(c1[2], c1[3]);
}

// A fragment of rows [r0, r0+16), columns [c0, c0+16) of a row-major bf16
// tile with pitch LD.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* s, int r0, int c0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(a, s + (r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8);
}

// B fragments of two 8-row blocks n = [r0, r0+16) of a row-major tile
// [n][k] over k = [c0, c0+16) (an A.B^T product): b[0..1] rows r0..r0+7,
// b[2..3] rows r0+8..r0+15.
template <int LD>
__device__ __forceinline__ void load_bt(uint32_t (&b)[4],
                                        const __nv_bfloat16* s, int r0, int c0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(b, s + (r0 + (lane & 7) + (lane >> 4) * 8) * LD + c0 +
                 ((lane >> 3) & 1) * 8);
}

// B fragments of a row-major tile [k][n] over k = [r0, r0+16) for the two
// 8-column blocks n = [c0, c0+16) (an A.B product): b[0..1] columns
// c0..c0+7, b[2..3] columns c0+8..c0+15.
template <int LD>
__device__ __forceinline__ void load_b(uint32_t (&b)[4],
                                       const __nv_bfloat16* s, int r0, int c0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4_trans(b, s + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + c0 +
                       (lane >> 4) * 8);
}

__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  x[0] = a.x;
  x[1] = a.y;
  x[2] = b.x;
  x[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack(a, b), pack(c, d));
}

// Four bf16 values into shared memory (8 bytes).
__device__ __forceinline__ void put4(__nv_bfloat16* p, const float (&x)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack(x[0], x[1]), pack(x[2], x[3]));
}

// x rotated by (cs, sn) in place, rounded op by op (no FMA contraction), as
// PyTorch's elementwise twin rounds it.
__device__ __forceinline__ void rotate4(float (&x1)[4], float (&x2)[4],
                                        const float (&cs)[4],
                                        const float (&sn)[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float y1 = __fsub_rn(__fmul_rn(x1[u], cs[u]), __fmul_rn(x2[u], sn[u]));
    const float y2 = __fadd_rn(__fmul_rn(x1[u], sn[u]), __fmul_rn(x2[u], cs[u]));
    x1[u] = y1;
    x2[u] = y2;
  }
}

// Store one C tile (rows row0+g and row0+g+8, columns col0+2t, +1) as
// 16-byte (f32) or 8-byte (bf16) row pieces: the lanes of a pair swap
// halves, so that an even lane holds 4 columns of row g and an odd lane 4
// columns of row g+8. Every lane of the warp must call it; rows >= n_rows
// are skipped. Needs dst 16-byte aligned at every 4th column of a row.
template <typename T>
__device__ __forceinline__ void store_tile(T* dst, long long stride,
                                           int row0, int col0, int n_rows,
                                           const float (&c)[4]) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const bool odd = t & 1;
  const float rx = __shfl_xor_sync(0xffffffffu, odd ? c[0] : c[2], 1);
  const float ry = __shfl_xor_sync(0xffffffffu, odd ? c[1] : c[3], 1);
  const int row = row0 + g + (odd ? 8 : 0);
  if (row >= n_rows) return;
  T* p = dst + row * stride + col0 + 2 * (t & ~1);
  if (odd)
    store4(p, rx, ry, c[2], c[3]);
  else
    store4(p, c[0], c[1], rx, ry);
}

// The same pieces added to what dst holds (f32).
__device__ __forceinline__ void add_tile(float* dst, long long stride,
                                         int row0, int col0, int n_rows,
                                         int n_cols, const float (&c)[4],
                                         bool first) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const bool odd = t & 1;
  const float rx = __shfl_xor_sync(0xffffffffu, odd ? c[0] : c[2], 1);
  const float ry = __shfl_xor_sync(0xffffffffu, odd ? c[1] : c[3], 1);
  const int row = row0 + g + (odd ? 8 : 0);
  const int col = col0 + 2 * (t & ~1);
  if (row >= n_rows || col >= n_cols) return;
  float4* p = reinterpret_cast<float4*>(dst + row * stride + col);
  float4 v = odd ? make_float4(rx, ry, c[2], c[3]) : make_float4(c[0], c[1], rx, ry);
  if (!first) {
    const float4 o = *p;
    v = make_float4(__fadd_rn(o.x, v.x), __fadd_rn(o.y, v.y),
                    __fadd_rn(o.z, v.z), __fadd_rn(o.w, v.w));
  }
  *p = v;
}

// Row and column of C element e of the tile at (row0, col0).
__device__ __forceinline__ void tile_coords(int e, int row0, int col0,
                                            int& row, int& col) {
  const int lane = threadIdx.x % 32;
  row = row0 + (lane >> 2) + (e >> 1) * 8;
  col = col0 + 2 * (lane & 3) + (e & 1);
}

// scale * acc of a warp's 16 rows (row0..) in the accumulator layout:
// written in f32 before the rotation (dr, [N, D], when given) and, rotated
// back with -sin, in the output dtype. Rows >= n_rows are skipped.
template <int D, typename T>
__device__ __forceinline__ void write_grad(float (&acc)[D / 8][4], int row0,
                                           int n_rows, float scale, T* dst,
                                           long long stride, float* dr,
                                           const float* cos_h,
                                           const float* sin_h) {
  constexpr int H2 = D / 2, NT = D / 16;  // 8-column tiles per half
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    float x1[4], x2[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x1[e] = __fmul_rn(scale, acc[nt][e]);
      x2[e] = __fmul_rn(scale, acc[nt + NT][e]);
    }
    if (dr != nullptr) {
      store_tile(dr, D, row0, nt * 8, n_rows, x1);
      store_tile(dr, D, row0, H2 + nt * 8, n_rows, x2);
    }
    if (cos_h != nullptr) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int row, col;
        tile_coords(e, row0, nt * 8, row, col);
        float cs = 1.f, sn = 0.f;
        if (row < n_rows) {
          cs = cos_h[(long long)row * H2 + col];
          sn = -sin_h[(long long)row * H2 + col];
        }
        const float y1 = __fsub_rn(__fmul_rn(x1[e], cs), __fmul_rn(x2[e], sn));
        const float y2 = __fadd_rn(__fmul_rn(x1[e], sn), __fmul_rn(x2[e], cs));
        x1[e] = y1;
        x2[e] = y2;
      }
    }
    store_tile(dst, stride, row0, nt * 8, n_rows, x1);
    store_tile(dst, stride, row0, H2 + nt * 8, n_rows, x2);
  }
}


// dst [rows, n] = the sum over `slabs` f32 slabs of [rows, pitch] at src,
// in slab order (the first slab, then each next one added); one thread per
// 4 columns of a padded row, over a grid-stride loop. The dbias sum of the
// resident dense backward and of the separate-pass streaming backward.
__device__ __forceinline__ void sum_slabs(float* dst, const float* src,
                                          long long rows, int n, int pitch,
                                          int slabs) {
  const int quads = pitch / 4;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < rows * quads; i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / quads;
    const int c = int(i % quads) * 4;
    const float* s = src + row * pitch + c;
    float4 acc = *reinterpret_cast<const float4*>(s);
    for (int sl = 1; sl < slabs; ++sl) {
      const float4 o = *reinterpret_cast<const float4*>(s + sl * rows * pitch);
      acc = make_float4(__fadd_rn(acc.x, o.x), __fadd_rn(acc.y, o.y),
                        __fadd_rn(acc.z, o.z), __fadd_rn(acc.w, o.w));
    }
    float* d = dst + row * n + c;
    const float v[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (c + u < n) d[u] = v[u];
  }
}

// 16 bytes (4 bytes) copied from global to shared memory without passing
// through registers; with valid false the destination is zero-filled (src
// must still be a valid address). Completes at cp_async_wait_all.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace dense
}  // namespace attn
