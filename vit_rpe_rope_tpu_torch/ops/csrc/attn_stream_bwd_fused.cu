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
// so that every result is the same from run to run:
//   sweep kernel   one CTA per (batch, head, 64-key tile) loops over all query
//                  tiles. dk and dv of its keys stay in WMMA accumulators. s,
//                  p and ds of a tile are computed once; the CTA's share of
//                  dq, ds . kf for its 64 keys, goes to its own slab of an f32
//                  scratch [key tiles, B, H, Nq, D], written once per query
//                  tile. The polynomial sums stay in registers (one per term
//                  and thread) and are added up over the CTA in a fixed
//                  order. The table's gradient is a sum of ds along the
//                  diagonals of the (64 x 64) tile, 127 of them: they are
//                  added into a 128-entry ring in shared memory, whose first
//                  64 entries are final once a query tile is done (the next
//                  tile starts 64 diagonals further) and leave for the CTA's
//                  own row of a scratch [B, H, key tiles, Nq + 64].
//   dq kernel      dq = scale * sum over the key tiles' slabs, in tile order,
//                  rotated back.
//   dparam kernel  dcoeff / dtable = sum over batches and key tiles of the
//                  CTAs' partial sums, in that order, in double.
// The wrapper bounds the dq scratch by sweeping the keys in segments (the kv
// segmentation of `_bwd_fused_segmented`). The parameter passes are the same sweep without
// the three gradient products. wgmma / TMA pipelining is later work.

#include "attn_stream.cuh"

namespace {

using namespace attn;

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
  float* dq_part;      // [key tiles, B, H, Nq_pad, D]
  float* dparam;       // dcoeff [H, poly_terms] or dtable [H, 2 * rel_ell - 1]
  float* dparam_part;  // [B, H, key tiles, MAX_POLY_TERMS | Nq_pad + 64]
  const float* cos;    // [cos_heads, Nq, D/2] or null
  const float* sin;
  BiasArgs bias;
  // (batch, head, token) strides of q, k, v, g, dq, dk, dv
  long long qs[3], ks[3], vs[3], gs[3], dqs[3], dks[3], dvs[3];
  int B, H, Nq, Nk, kv_valid, cos_heads, D;
  float scale;
};

__host__ __device__ inline int tiles(int n) { return (n + TQ - 1) / TQ; }

using FragAt = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major>;

// One CTA's sweep over all query tiles against its 64 keys. GRADS: dk, dv and
// the dq slab; PE: which parameter sums, if any.
template <int D, typename T, int PE, bool GRADS>
__device__ __forceinline__ void sweep(const Params& p) {
  using L = BwdLayout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem + L::T0);
  __nv_bfloat16* v_s = k_s + TK * L::LDX;
  __nv_bfloat16* q_s = v_s + TK * L::LDX;
  __nv_bfloat16* g_s = q_s + TQ * L::LDX;
  float* s_s = reinterpret_cast<float*>(smem + L::S_OFF);
  float* u_s = reinterpret_cast<float*>(smem + L::U_OFF);
  __nv_bfloat16* pt_s = reinterpret_cast<__nv_bfloat16*>(smem + L::P_OFF);
  __nv_bfloat16* dst_s = reinterpret_cast<__nv_bfloat16*>(smem + L::R_OFF);
  __shared__ float st[2][TQ];               // the query tile's lse and delta
  __shared__ float ring[2 * TQ];            // the table gradient's diagonals
  __shared__ float red[WARPS][MAX_POLY_TERMS];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kt = blockIdx.x, k0 = kt * TK, h = blockIdx.y, b = blockIdx.z;
  const int Nq = p.Nq, Nk = p.Nk;
  const int n_q = tiles(Nq), n_kt = tiles(Nk), nq_pad = n_q * TQ;
  const int n_keys = min(Nk, p.kv_valid);
  const T* qg = slice<T>(p.q, p.qs, b, h);
  const T* kg = slice<T>(p.k, p.ks, b, h);
  const T* vg = slice<T>(p.v, p.vs, b, h);
  const T* gg = slice<T>(p.g, p.gs, b, h);
  const long long bh = (long long)b * p.H + h;
  const long long tab = (long long)(p.cos_heads == 1 ? 0 : h) * Nq * (D / 2);
  const float* cos_h = p.cos != nullptr ? p.cos + tab : nullptr;
  const float* sin_h = p.sin != nullptr ? p.sin + tab : nullptr;
  const HeadBias hb = head_bias(p.bias, h, Nq);

  float* s_w = s_s + warp * 16 * L::LDS;
  float* u_w = u_s + warp * 16 * L::LDS;
  __nv_bfloat16* pt_w = pt_s + warp * 16 * L::LDP;
  __nv_bfloat16* dst_w = dst_s + warp * 16 * L::LDP;
  const int key_w = k0 + warp * 16;

  stage_tile<D, T>(k_s, kg, p.ks[2], k0, Nk, cos_h, sin_h);
  stage_tile<D, T>(v_s, vg, p.vs[2], k0, Nk, nullptr, nullptr);
  if (PE == PE_REL) ring[threadIdx.x] = 0.f;

  // Lane l owns key row l/2 of the warp's 16 keys and half of each query
  // tile's 64 columns.
  const int my_row = lane >> 1;
  const int col0 = (lane & 1) * (TQ / 2);
  const int kj = key_w + my_row;
  const Patch pk = PE == PE_POLY ? patch_of(hb.col0 + kj, hb.grid) : Patch{0, 0};
  const float* s_row = s_w + my_row * L::LDS + col0;
  float* u_row = u_w + my_row * L::LDS + col0;
  __nv_bfloat16* pt_row = pt_w + my_row * L::LDP + col0;
  __nv_bfloat16* dst_row = dst_w + my_row * L::LDP + col0;

  FragC dk_acc[D / 16], dv_acc[D / 16];
  if (GRADS) {
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fill_fragment(dk_acc[n], 0.f);
      wmma::fill_fragment(dv_acc[n], 0.f);
    }
  }
  float pacc[MAX_POLY_TERMS];
#pragma unroll
  for (int m = 0; m < MAX_POLY_TERMS; ++m) pacc[m] = 0.f;

  for (int t = 0; t < n_q; ++t) {
    const int q0 = t * TQ;
    __syncthreads();  // every warp is done with the previous tile's buffers
    stage_tile<D, T>(q_s, qg, p.qs[2], q0, Nq, cos_h, sin_h);
    stage_tile<D, T>(g_s, gg, p.gs[2], q0, Nq, nullptr, nullptr);
    for (int i = threadIdx.x; i < TQ; i += THREADS) {
      const int qi = q0 + i;
      st[0][i] = qi < Nq ? p.lse[bh * Nq + qi] : 0.f;
      st[1][i] = qi < Nq ? p.delta[bh * Nq + qi] : 0.f;
    }
    __syncthreads();
    {
      FragA a[D / 16];
      load_rows<D>(a, k_s + warp * 16 * L::LDX);
      warp_abt<D, L::LDS>(s_w, a, q_s);  // s^T: [16 keys, 64 queries]
      load_rows<D>(a, v_s + warp * 16 * L::LDX);
      warp_abt<D, L::LDS>(u_w, a, g_s);  // gv^T
    }
    __syncwarp();
    Patch pq = PE == PE_POLY ? patch_of(hb.row0 + q0 + col0, hb.grid) : Patch{0, 0};
#pragma unroll 8
    for (int j = 0; j < TQ / 2; ++j) {
      const int qc = col0 + j, qi = q0 + qc;
      float pr = 0.f, ds = 0.f, dsz = 0.f;
      if (qi < Nq) {  // padded query rows carry a zero g in the JAX kernel
        float dist;
        bool counts;
        const float s =
            chunk_logit<PE>(s_row[j], qi, kj, n_keys, p.scale, hb, pq, pk, dist, counts);
        pr = expf(s - st[0][qc]);
        ds = __fmul_rn(pr, __fsub_rn(u_row[j], st[1][qc]));
        dsz = counts ? ds : 0.f;
        if (PE == PE_POLY) {
          float pw = 1.f;
#pragma unroll
          for (int m = 0; m < MAX_POLY_TERMS; ++m) {
            if (m < hb.terms) pacc[m] += dsz * pw;
            pw *= dist;
          }
        }
      }
      if (PE == PE_POLY) next_patch(pq, hb.grid);
      if (PE == PE_REL) u_row[j] = dsz;  // gv^T is used up: keep the f32 ds^T
      if (GRADS) {
        pt_row[j] = __float2bfloat16(pr);
        dst_row[j] = __float2bfloat16(ds);
      }
    }
    if (GRADS) {
      __syncwarp();
      warp_ab_acc<D, L::LDP>(dv_acc, pt_w, g_s);
      warp_ab_acc<D, L::LDP>(dk_acc, dst_w, q_s);
    }
    if (GRADS || PE == PE_REL) __syncthreads();  // ds^T of all 64 keys is in place
    if (GRADS) {
      // This CTA's share of dq for the warp's 16 query rows: ds[16, 64 keys]
      // (read transposed from ds^T) . kf[64 keys, D], unscaled, to the slab.
      FragAt a[TK / 16];
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk)
        wmma::load_matrix_sync(a[kk], dst_s + kk * 16 * L::LDP + warp * 16, L::LDP);
      float* slab = p.dq_part +
                    ((((long long)kt * p.B + b) * p.H + h) * nq_pad + q0 + warp * 16) * D;
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        FragC acc;
        wmma::fill_fragment(acc, 0.f);
#pragma unroll
        for (int kk = 0; kk < TK / 16; ++kk) {
          FragB bm;
          wmma::load_matrix_sync(bm, k_s + kk * 16 * L::LDX + n * 16, L::LDX);
          wmma::mma_sync(acc, a[kk], bm, acc);
        }
        wmma::store_matrix_sync(slab + n * 16, acc, D, wmma::mem_row_major);
      }
    }
    if (PE == PE_REL) {
      // Diagonal e = query - key + 63 of the tile, summed in key order; entry
      // q0 + e of this CTA's row. Entries q0 .. q0 + 63 are final after it.
      float* row = p.dparam_part + ((bh * n_kt) + kt) * (long long)(nq_pad + TQ);
      const int e = threadIdx.x;
      if (e < 2 * TQ - 1) {
        float sum = 0.f;
        const int lo = max(0, TK - 1 - e), hi = min(TK - 1, 2 * TQ - 2 - e);
        for (int kr = lo; kr <= hi; ++kr) sum += u_s[kr * L::LDS + (e - (TK - 1) + kr)];
        ring[(q0 + e) % (2 * TQ)] += sum;
      }
      __syncthreads();
      if (e < TQ) {
        row[q0 + e] = ring[(q0 + e) % (2 * TQ)];
        ring[(q0 + e) % (2 * TQ)] = 0.f;
      }
    }
  }

  if (PE == PE_REL) {
    // (the loop's last barrier made the ring's other 63 entries visible)
    float* row = p.dparam_part + ((bh * n_kt) + kt) * (long long)(nq_pad + TQ);
    if (threadIdx.x < TQ - 1) row[nq_pad + threadIdx.x] = ring[(nq_pad + threadIdx.x) % (2 * TQ)];
  }
  if (PE == PE_POLY) {
#pragma unroll
    for (int m = 0; m < MAX_POLY_TERMS; ++m) {
      float x = pacc[m];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
      if (lane == 0) red[warp][m] = x;
    }
    __syncthreads();
    if (threadIdx.x < MAX_POLY_TERMS) {
      float x = 0.f;
      for (int w = 0; w < WARPS; ++w) x += red[w][threadIdx.x];
      p.dparam_part[((bh * n_kt) + kt) * MAX_POLY_TERMS + threadIdx.x] = x;
    }
  }
  if (!GRADS) return;

  float* dkg = p.dk + b * p.dks[0] + h * p.dks[1];
  float* dvg = p.dv + b * p.dvs[0] + h * p.dvs[1];
  __syncwarp();
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(s_w + n * 16, dv_acc[n], L::LDS, wmma::mem_row_major);
  __syncwarp();
  for (int r = 0; r < 16; ++r) {
    const int row = key_w + r;
    if (row >= Nk) break;
    for (int d = lane; d < D; d += 32) dvg[row * p.dvs[2] + d] = s_w[r * L::LDS + d];
  }
  __syncwarp();
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(s_w + n * 16, dk_acc[n], L::LDS, wmma::mem_row_major);
  __syncwarp();
  write_grad_rows<D, float>(s_w, L::LDS, key_w, Nk, p.scale, dkg, p.dks[2], nullptr,
                            cos_h, sin_h);
}

template <int D, typename T, int PE>
__global__ void __launch_bounds__(THREADS) attn_stream_bwd_fused_kernel(const Params p) {
  sweep<D, T, PE, true>(p);
}

template <int D, typename T>
__global__ void __launch_bounds__(THREADS) attn_stream_bwd_dcoeff_kernel(const Params p) {
  sweep<D, T, PE_POLY, false>(p);
}

template <int D, typename T>
__global__ void __launch_bounds__(THREADS) attn_stream_bwd_dtable_kernel(const Params p) {
  sweep<D, T, PE_REL, false>(p);
}

// dq = scale * (sum over the key tiles' slabs, in tile order), rotated back
// with -sin. One thread per (batch, head, row, column pair of the rotation).
__global__ void attn_stream_bwd_fused_dq_kernel(const Params p) {
  const int D = p.D, H2 = D / 2, n_kt = tiles(p.Nk), nq_pad = tiles(p.Nq) * TQ;
  const long long total = (long long)p.B * p.H * p.Nq * H2;
  const long long slab = (long long)p.B * p.H * nq_pad * D;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int c = int(i % H2), row = int(i / H2 % p.Nq);
    const long long bh = i / H2 / p.Nq;
    const int b = int(bh / p.H), h = int(bh % p.H);
    const float* src = p.dq_part + (bh * nq_pad + row) * D + c;
    float x1 = 0.f, x2 = 0.f;
    for (int t = 0; t < n_kt; ++t) {
      x1 += src[t * slab];
      x2 += src[t * slab + H2];
    }
    x1 = __fmul_rn(p.scale, x1);
    x2 = __fmul_rn(p.scale, x2);
    float y1 = x1, y2 = x2;
    if (p.cos != nullptr) {
      const long long at = ((long long)(p.cos_heads == 1 ? 0 : h) * p.Nq + row) * H2 + c;
      const float cs = p.cos[at], sn = -p.sin[at];
      y1 = __fsub_rn(__fmul_rn(x1, cs), __fmul_rn(x2, sn));
      y2 = __fadd_rn(__fmul_rn(x1, sn), __fmul_rn(x2, cs));
    }
    float* out = p.dq + b * p.dqs[0] + h * p.dqs[1] + row * p.dqs[2];
    out[c] = y1;
    out[c + H2] = y2;
  }
}

// dcoeff[h, m] = sum over batches, then key tiles, of the CTAs' sums.
__global__ void attn_stream_bwd_dcoeff_sum_kernel(const Params p) {
  const int n_kt = tiles(p.Nk), terms = p.bias.poly_terms;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < p.H * terms;
       i += gridDim.x * blockDim.x) {
    const int h = i / terms, m = i % terms;
    double sum = 0.0;
    for (int b = 0; b < p.B; ++b)
      for (int t = 0; t < n_kt; ++t)
        sum += p.dparam_part[(((long long)b * p.H + h) * n_kt + t) * MAX_POLY_TERMS + m];
    p.dparam[i] = float(sum);
  }
}

// dtable[h, idx] = sum over batches, then key tiles, of the entry of each
// CTA's row that holds the diagonal row - col + L - 1 = idx.
__global__ void attn_stream_bwd_dtable_sum_kernel(const Params p) {
  const int n_kt = tiles(p.Nk), width = 2 * p.bias.rel_ell - 1;
  const int row_len = tiles(p.Nq) * TQ + TQ;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < (long long)p.H * width; i += (long long)gridDim.x * blockDim.x) {
    const int h = int(i / width), idx = int(i % width);
    // query - key of the diagonal, local to key tile 0
    const int diag = idx - (p.bias.rel_ell - 1) - p.bias.row0 + p.bias.col0;
    double sum = 0.0;
    for (int b = 0; b < p.B; ++b) {
      const float* rows = p.dparam_part + ((long long)b * p.H + h) * n_kt * row_len;
      for (int t = 0; t < n_kt; ++t) {
        const int e = diag + t * TK + TK - 1;
        if (e >= 0 && e < row_len - 1) sum += rows[(long long)t * row_len + e];
      }
    }
    p.dparam[i] = float(sum);
  }
}

enum Pass { PASS_FUSED, PASS_DCOEFF, PASS_DTABLE };

int blocks_for(long long total) {
  return int(total / 256 + 1 < 4096 ? total / 256 + 1 : 4096);
}

template <int D, typename T>
cudaError_t launch(const Params& p, Pass pass, cudaStream_t stream) {
  const size_t smem = BwdLayout<D>::BYTES;
  const dim3 grid(tiles(p.Nk), p.H, p.B);
  const int pe = p.bias.coeff != nullptr ? PE_POLY : p.bias.table != nullptr ? PE_REL : PE_NONE;
  cudaError_t err;
  if (pass == PASS_DCOEFF)
    err = launch_kernel(attn_stream_bwd_dcoeff_kernel<D, T>, grid, smem, p, stream);
  else if (pass == PASS_DTABLE)
    err = launch_kernel(attn_stream_bwd_dtable_kernel<D, T>, grid, smem, p, stream);
  else if (pe == PE_POLY)
    err = launch_kernel(attn_stream_bwd_fused_kernel<D, T, PE_POLY>, grid, smem, p, stream);
  else if (pe == PE_REL)
    err = launch_kernel(attn_stream_bwd_fused_kernel<D, T, PE_REL>, grid, smem, p, stream);
  else
    err = launch_kernel(attn_stream_bwd_fused_kernel<D, T, PE_NONE>, grid, smem, p, stream);
  if (err != cudaSuccess) return err;
  if (pass == PASS_FUSED) {
    const long long total = (long long)p.B * p.H * p.Nq * (D / 2);
    attn_stream_bwd_fused_dq_kernel<<<blocks_for(total), 256, 0, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (pe == PE_POLY)
    attn_stream_bwd_dcoeff_sum_kernel<<<1, 256, 0, stream>>>(p);
  else if (pe == PE_REL)
    attn_stream_bwd_dtable_sum_kernel<<<
        blocks_for((long long)p.H * (2 * p.bias.rel_ell - 1)), 256, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, Pass pass, cudaStream_t stream) {
  switch (p.D) {
    case 16: return launch<16, T>(p, pass, stream);
    case 32: return launch<32, T>(p, pass, stream);
    case 64: return launch<64, T>(p, pass, stream);
    case 128: return launch<128, T>(p, pass, stream);
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
  p.dq_part = static_cast<float*>(ptrs[9]);
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
  p.kv_valid = dims[DIM_KV_VALID];
  p.D = dims[DIM_D];
  p.cos_heads = dims[DIM_COS_HEADS];
  p.scale = scale;
  const bool poly = p.bias.coeff != nullptr, rel = p.bias.table != nullptr;
  if (p.Nq < 1 || p.Nk < 1 || (poly && rel) || p.bias.poly_terms > MAX_POLY_TERMS ||
      (poly && (p.bias.poly_grid < 1 || p.bias.poly_terms < 1)) ||
      (rel && p.bias.rel_ell < 1) || (p.cos != nullptr && p.Nq != p.Nk) ||
      ((poly || rel) && (p.dparam == nullptr || p.dparam_part == nullptr)) ||
      (pass == PASS_FUSED && (p.dq == nullptr || p.dk == nullptr || p.dv == nullptr ||
                              p.dq_part == nullptr)) ||
      (pass == PASS_DCOEFF && !poly) || (pass == PASS_DTABLE && !rel))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dims[DIM_IS_BF16] ? dispatch<__nv_bfloat16>(p, pass, s)
                                            : dispatch<float>(p, pass, s);
  return int(err);
}

}  // namespace

// Plain C entry points (bound with ctypes), one per kernel, all with the same
// arguments. ptrs holds 16 device pointers: q k v g lse delta dq dk dv dq_part
// dparam dparam_part cos sin coeff table (null where absent; dq, dk and dv are
// f32); strides holds 21 element strides: (batch, head, token) of q k v g dq dk
// dv; dims holds the integers of attn::Dim. Scratch, with Nq_pad = Nq rounded
// up to 64 and key tiles = ceil(Nk / 64): dq_part f32 [key tiles, B, H, Nq_pad,
// D]; dparam_part f32 [B, H, key tiles, 8] with coeff, [B, H, key tiles,
// Nq_pad + 64] with table. Each returns the CUDA error of its launches (0 on
// success) and does not synchronize. attn_stream_bwd_fused also launches the
// dq sum and, with coeff or table, the parameter sum; the other two launch
// their sweep and the parameter sum.
extern "C" int attn_stream_bwd_fused(void* const* ptrs, const long long* strides,
                                     const int* dims, float scale, void* stream) {
  return run(PASS_FUSED, ptrs, strides, dims, scale, stream);
}

extern "C" int attn_stream_bwd_dcoeff(void* const* ptrs, const long long* strides,
                                      const int* dims, float scale, void* stream) {
  return run(PASS_DCOEFF, ptrs, strides, dims, scale, stream);
}

extern "C" int attn_stream_bwd_dtable(void* const* ptrs, const long long* strides,
                                      const int* dims, float scale, void* stream) {
  return run(PASS_DTABLE, ptrs, strides, dims, scale, stream);
}
