// Streaming attention backward in separate passes (dq with dbias, dk/dv) from
// the forward's saved logsumexp, with in-kernel rope and a materialized or
// generated bias, for Hopper (sm_90a).
//
// Replaces: the Pallas kernels `_stream_bwd_dq_kernel`,
// `_stream_bwd_dkv_kernel` and `_stream_bwd_dbias_kernel` of
// vit_rpe_rope_tpu/ops/flash_attention.py, launched by
// `_bwd_streaming`.
//
// Computes, for q, k, v, g [B, H, N, D] (float32 or bfloat16, any strides
// with a unit last-dim stride), lse and delta = sum_d g * out [B, H, N] f32,
// with the JAX kernels' rounding points:
//   qf, kf = bf16(rotate(q)), bf16(rotate(k))    rotation in f32
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
// Padded query rows contribute nothing (their g and delta are zero) and masked
// keys give p = exp(-1e30 - lse) = 0, never NaN.
//
// What bounds them on an H100: operations. At the long-sequence shape (B=4,
// H=4, N=4097, D=32, f32) the dq kernel runs three products (51.6 GFLOP, about
// 52 us at 989 TFLOP/s) and the dk/dv kernel four (68.7 GFLOP, about 70 us)
// over 50 MB and 59 MB of reads and writes (15 and 18 us at 3.35 TB/s). dbias
// adds no product: its bytes bound it (the bias read, dbias written: 16 MB at
// ViT-S/16@384, 6 heads of 577 tokens), plus here the f32 ds slabs, written
// once by the dq kernel and read once by the sum (128 MB at batch 16).
//
// Design: the TPU kernels accumulate dq over an innermost KV grid axis, dk/dv
// over an innermost query axis and dbias over an innermost BATCH axis, each
// in VMEM scratch carried from one grid step to the next. Here CTAs run in
// parallel and in no order, so each CTA owns its output tile and loops over
// the other axis itself:
//   dq kernel     one CTA per (batch, head, 64-query tile), loop over keys;
//   dk/dv kernel  one CTA per (batch, head, 64-key tile), loop over queries.
// dbias is the sum over the batch of the ds that the dq kernel forms anyway,
// in dbias's own [query, key] layout: its dbias instance writes each f32 ds
// tile, through the shared-memory slab it was formed in (coalesced rows), into
// a slab of its batch, [groups, H, N, N]; the sum kernel then adds the slabs
// in batch order, the JAX kernel's order. When the wrapper's byte budget holds
// fewer slabs than batches, each CTA of the dbias instance takes a run of
// batches in order and read-adds-writes its own rows of its group's slab (with
// one group, of dbias itself, and no sum kernel runs). No atomics: dbias does
// not depend on the schedule, and one slab per batch or a single group give
// the same bits. The passes are those of attn_bwd.cu without its statistics
// pass: p comes from the saved lse. Accumulators stay in WMMA fragments (no
// rescaling in a backward). The one-pass backward that shares s, p and ds
// between the gradients is attn_stream_bwd_fused.cu; wgmma / TMA pipelining is
// later work.

#include "attn_stream.cuh"

namespace {

using namespace attn;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* g;
  const float* lse;    // [B, H, N]
  const float* delta;  // [B, H, N]
  void* dq;
  void* dk;
  void* dv;
  float* dqr;          // [B, H, N, D] or null
  float* dkr;
  const float* cos;    // [cos_heads, N, D/2] or null
  const float* sin;
  float* dbias;        // [H, N, N] or null
  float* dbias_part;   // [groups, H, N, N] ds slabs (groups > 1) or null
  BiasArgs bias;
  // (batch, head, token) strides of q, k, v, g, dq, dk, dv
  long long qs[3], ks[3], vs[3], gs[3], dqs[3], dks[3], dvs[3];
  int B, H, N, cos_heads;
  int groups;          // dbias: batch groups, one slab each (1: dbias itself)
  float scale;
};

template <int D>
using Layout = BwdLayout<D>;

// dq for one (batch, head, 64-query tile), over all key tiles. DBIAS: the
// CTA takes the batches of group blockIdx.z in order, and adds each batch's
// f32 ds to its rows of the group's slab (dbias itself with one group).
template <int D, typename T, bool MORE, bool DBIAS>
__global__ void __launch_bounds__(THREADS) attn_stream_bwd_dq_kernel(const Params p) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + L::T0);
  __nv_bfloat16* g_s = q_s + TQ * L::LDX;
  __nv_bfloat16* k_s = g_s + TQ * L::LDX;
  __nv_bfloat16* v_s = k_s + TQ * L::LDX;
  float* s_s = reinterpret_cast<float*>(smem + L::S_OFF);
  float* u_s = reinterpret_cast<float*>(smem + L::U_OFF);
  __nv_bfloat16* ds_s = reinterpret_cast<__nv_bfloat16*>(smem + L::P_OFF);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * TQ, h = blockIdx.y;
  const int N = p.N;
  int b_first = blockIdx.z, b_end = blockIdx.z + 1;
  float* db = nullptr;  // this head's [N, N] of the group's slab, or of dbias
  if (DBIAS) {
    const int per = (p.B + p.groups - 1) / p.groups;
    b_first = blockIdx.z * per;
    b_end = min(p.B, b_first + per);
    db = (p.groups == 1 ? p.dbias : p.dbias_part + (long long)blockIdx.z * p.H * N * N) +
         (long long)h * N * N;
  }
  const long long tab = (long long)(p.cos_heads == 1 ? 0 : h) * N * (D / 2);
  const float* cos_h = p.cos != nullptr ? p.cos + tab : nullptr;
  const float* sin_h = p.sin != nullptr ? p.sin + tab : nullptr;
  const HeadBias hb = head_bias(p.bias, h, N);

  float* s_w = s_s + warp * 16 * L::LDS;
  float* u_w = u_s + warp * 16 * L::LDS;
  __nv_bfloat16* ds_w = ds_s + warp * 16 * L::LDP;
  const int row_w = q0 + warp * 16;
  const int n_kv = (N + TK - 1) / TK;

  // Lane l owns row l/2 of the warp's 16 rows and half (l % 2) of each
  // tile's 64 columns.
  const int my_row = lane >> 1;
  const int col0 = (lane & 1) * (TK / 2);
  const int qi = row_w + my_row;
  float* s_row = s_w + my_row * L::LDS + col0;
  const float* u_row = u_w + my_row * L::LDS + col0;
  __nv_bfloat16* ds_row = ds_w + my_row * L::LDP + col0;

  for (int b = b_first; b < b_end; ++b) {
    const T* qg = slice<T>(p.q, p.qs, b, h);
    const T* kg = slice<T>(p.k, p.ks, b, h);
    const T* vg = slice<T>(p.v, p.vs, b, h);
    const T* gg = slice<T>(p.g, p.gs, b, h);
    T* dqg = static_cast<T*>(p.dq) + b * p.dqs[0] + h * p.dqs[1];
    const long long bh = (long long)b * p.H + h;

    if (DBIAS) __syncthreads();  // every warp is done with the previous batch's tiles
    stage_tile<D, T>(q_s, qg, p.qs[2], q0, N, cos_h, sin_h);
    stage_tile<D, T>(g_s, gg, p.gs[2], q0, N, nullptr, nullptr);
    __syncthreads();

    const float lse = qi < N ? p.lse[bh * N + qi] : 0.f;
    const float delta = qi < N ? p.delta[bh * N + qi] : 0.f;

    FragA qa[D / 16], ga[D / 16];
    load_rows<D>(qa, q_s + warp * 16 * L::LDX);
    load_rows<D>(ga, g_s + warp * 16 * L::LDX);

    FragC dq_acc[D / 16];
#pragma unroll
    for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(dq_acc[n], 0.f);
    for (int t = 0; t < n_kv; ++t) {
      const int k0 = t * TK;
      __syncthreads();  // every warp is done with the previous K and V tiles
      stage_tile<D, T>(k_s, kg, p.ks[2], k0, N, cos_h, sin_h);
      stage_tile<D, T>(v_s, vg, p.vs[2], k0, N, nullptr, nullptr);
      __syncthreads();
      warp_abt<D, L::LDS>(s_w, qa, k_s);
      warp_abt<D, L::LDS>(u_w, ga, v_s);
      __syncwarp();
#pragma unroll 8
      for (int j = 0; j < TK / 2; ++j) {
        const float pr = expf(stream_logit<MORE>(s_row[j], qi, k0 + col0 + j, N, p.scale, hb) - lse);
        const float ds = __fmul_rn(pr, __fsub_rn(u_row[j], delta));
        ds_row[j] = __float2bfloat16(ds);
        if (DBIAS) s_row[j] = ds;  // the f32 tile, in place, for dbias
      }
      __syncwarp();
      if (DBIAS) {  // the warp's 16 rows, a 256-byte row segment at a time
        for (int r = 0; r < 16; ++r) {
          const int row = row_w + r;
          if (row >= N) break;
          float* dst = db + (long long)row * N + k0;
          for (int c = lane; c < TK && k0 + c < N; c += 32) {
            const float x = s_w[r * L::LDS + c];
            dst[c] = b == b_first ? x : __fadd_rn(dst[c], x);
          }
        }
      }
      warp_ab_acc<D, L::LDP>(dq_acc, ds_w, k_s);
    }

    __syncwarp();
#pragma unroll
    for (int n = 0; n < D / 16; ++n)
      wmma::store_matrix_sync(s_w + n * 16, dq_acc[n], L::LDS, wmma::mem_row_major);
    __syncwarp();
    write_grad_rows<D, T>(s_w, L::LDS, row_w, N, p.scale, dqg, p.dqs[2],
                          p.dqr != nullptr ? p.dqr + bh * N * D : nullptr,
                          cos_h, sin_h);
  }
}

// dk and dv for one (batch, head, 64-key tile), over all query tiles.
template <int D, typename T, bool MORE>
__global__ void __launch_bounds__(THREADS) attn_stream_bwd_dkv_kernel(const Params p) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem + L::T0);
  __nv_bfloat16* v_s = k_s + TK * L::LDX;
  __nv_bfloat16* q_s = v_s + TK * L::LDX;
  __nv_bfloat16* g_s = q_s + TQ * L::LDX;
  float* s_s = reinterpret_cast<float*>(smem + L::S_OFF);
  float* u_s = reinterpret_cast<float*>(smem + L::U_OFF);
  __nv_bfloat16* pt_s = reinterpret_cast<__nv_bfloat16*>(smem + L::P_OFF);
  __nv_bfloat16* dst_s = reinterpret_cast<__nv_bfloat16*>(smem + L::R_OFF);
  __shared__ float st[2][TQ];  // the query tile's lse and delta

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = blockIdx.x * TK, h = blockIdx.y, b = blockIdx.z;
  const int N = p.N;
  const T* qg = slice<T>(p.q, p.qs, b, h);
  const T* kg = slice<T>(p.k, p.ks, b, h);
  const T* vg = slice<T>(p.v, p.vs, b, h);
  const T* gg = slice<T>(p.g, p.gs, b, h);
  T* dkg = static_cast<T*>(p.dk) + b * p.dks[0] + h * p.dks[1];
  T* dvg = static_cast<T*>(p.dv) + b * p.dvs[0] + h * p.dvs[1];
  const long long bh = (long long)b * p.H + h;
  const long long tab = (long long)(p.cos_heads == 1 ? 0 : h) * N * (D / 2);
  const float* cos_h = p.cos != nullptr ? p.cos + tab : nullptr;
  const float* sin_h = p.sin != nullptr ? p.sin + tab : nullptr;
  const HeadBias hb = head_bias(p.bias, h, N);

  float* s_w = s_s + warp * 16 * L::LDS;
  float* u_w = u_s + warp * 16 * L::LDS;
  __nv_bfloat16* pt_w = pt_s + warp * 16 * L::LDP;
  __nv_bfloat16* dst_w = dst_s + warp * 16 * L::LDP;
  const int key_w = k0 + warp * 16;
  const int n_q = (N + TQ - 1) / TQ;

  stage_tile<D, T>(k_s, kg, p.ks[2], k0, N, cos_h, sin_h);
  stage_tile<D, T>(v_s, vg, p.vs[2], k0, N, nullptr, nullptr);

  // Lane l owns key row l/2 of the warp's 16 keys and half of each query
  // tile's 64 columns.
  const int my_row = lane >> 1;
  const int col0 = (lane & 1) * (TQ / 2);
  const int kj = key_w + my_row;
  const float* s_row = s_w + my_row * L::LDS + col0;
  const float* u_row = u_w + my_row * L::LDS + col0;
  __nv_bfloat16* pt_row = pt_w + my_row * L::LDP + col0;
  __nv_bfloat16* dst_row = dst_w + my_row * L::LDP + col0;

  FragC dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(dk_acc[n], 0.f);
    wmma::fill_fragment(dv_acc[n], 0.f);
  }
  for (int t = 0; t < n_q; ++t) {
    const int q0 = t * TQ;
    __syncthreads();  // every warp is done with the previous Q and G tiles
    stage_tile<D, T>(q_s, qg, p.qs[2], q0, N, cos_h, sin_h);
    stage_tile<D, T>(g_s, gg, p.gs[2], q0, N, nullptr, nullptr);
    for (int i = threadIdx.x; i < TQ; i += THREADS) {
      const int qi = q0 + i;
      st[0][i] = qi < N ? p.lse[bh * N + qi] : 0.f;
      st[1][i] = qi < N ? p.delta[bh * N + qi] : 0.f;
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
#pragma unroll 8
    for (int j = 0; j < TQ / 2; ++j) {
      const int qc = col0 + j, qi = q0 + qc;
      float pr = 0.f, ds = 0.f;
      if (qi < N) {  // padded query rows carry a zero g in the JAX kernel
        pr = expf(stream_logit<MORE>(s_row[j], qi, kj, N, p.scale, hb) - st[0][qc]);
        ds = __fmul_rn(pr, __fsub_rn(u_row[j], st[1][qc]));
      }
      pt_row[j] = __float2bfloat16(pr);
      dst_row[j] = __float2bfloat16(ds);
    }
    __syncwarp();
    warp_ab_acc<D, L::LDP>(dv_acc, pt_w, g_s);
    warp_ab_acc<D, L::LDP>(dk_acc, dst_w, q_s);
  }

  __syncwarp();
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(s_w + n * 16, dv_acc[n], L::LDS, wmma::mem_row_major);
  __syncwarp();
  for (int r = 0; r < 16; ++r) {
    const int row = key_w + r;
    if (row >= N) break;
    for (int d = lane; d < D; d += 32) store(dvg + row * p.dvs[2] + d, s_w[r * L::LDS + d]);
  }
  __syncwarp();
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(s_w + n * 16, dk_acc[n], L::LDS, wmma::mem_row_major);
  __syncwarp();
  write_grad_rows<D, T>(s_w, L::LDS, key_w, N, p.scale, dkg, p.dks[2],
                        p.dkr != nullptr ? p.dkr + bh * N * D : nullptr,
                        cos_h, sin_h);
}

// dbias[i] = sum over the groups, in group order, of dbias_part[g][i]: with
// one slab per batch, the batch order of the JAX kernel's sum.
__global__ void attn_stream_bwd_dbias_sum_kernel(const Params p) {
  const long long total = (long long)p.H * p.N * p.N;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
#pragma unroll 4
    for (int g = 0; g < p.groups; ++g) s += p.dbias_part[g * total + i];
    p.dbias[i] = s;
  }
}

enum Pass { PASS_DQ, PASS_DKV };

template <int D, typename T>
cudaError_t launch(const Params& p, Pass pass, cudaStream_t stream) {
  const size_t smem = Layout<D>::BYTES;
  const int n_q = (p.N + TQ - 1) / TQ, n_k = (p.N + TK - 1) / TK;
  const bool more = p.bias.poly_terms > REG_POLY_TERMS;
  if (pass == PASS_DKV)
    return launch_kernel(more ? attn_stream_bwd_dkv_kernel<D, T, true>
                              : attn_stream_bwd_dkv_kernel<D, T, false>,
                         dim3(n_k, p.H, p.B), smem, p, stream);
  if (p.dbias == nullptr)
    return launch_kernel(more ? attn_stream_bwd_dq_kernel<D, T, true, false>
                              : attn_stream_bwd_dq_kernel<D, T, false, false>,
                         dim3(n_q, p.H, p.B), smem, p, stream);
  // dbias needs a materialized bias, so no generated polynomial (MORE).
  const cudaError_t err = launch_kernel(attn_stream_bwd_dq_kernel<D, T, false, true>,
                                        dim3(n_q, p.H, p.groups), smem, p, stream);
  if (err != cudaSuccess || p.groups == 1) return err;
  const long long total = (long long)p.H * p.N * p.N;
  const int blocks = int(total / 256 + 1 < 4096 ? total / 256 + 1 : 4096);
  attn_stream_bwd_dbias_sum_kernel<<<blocks, 256, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int head_dim, Pass pass, cudaStream_t stream) {
  switch (head_dim) {
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
  p.N = dims[DIM_N];
  p.cos_heads = dims[DIM_COS_HEADS];
  p.groups = dims[DIM_GROUPS];
  p.scale = scale;
  if (p.bias.poly_terms > MAX_POLY_TERMS ||
      (p.bias.coeff != nullptr && p.bias.poly_grid < 1) ||
      (p.dbias != nullptr &&
       (p.bias.bias == nullptr || p.groups < 1 || p.groups > p.B ||
        (p.groups - 1) * ((p.B + p.groups - 1) / p.groups) >= p.B ||  // an empty group
        (p.groups > 1 && p.dbias_part == nullptr))))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dims[DIM_IS_BF16]
                              ? dispatch<__nv_bfloat16>(p, dims[DIM_D], pass, s)
                              : dispatch<float>(p, dims[DIM_D], pass, s);
  return int(err);
}

}  // namespace

// Plain C entry points (bound with ctypes), one per pass, both with the same
// arguments. ptrs holds 18 device pointers: q k v g lse delta dq dk dv dqr dkr
// bias cos sin coeff table dbias dbias_part (null where absent); strides holds
// 21 element strides: (batch, head, token) of q k v g dq dk dv; dims holds the
// integers of attn::Dim (DIM_GROUPS: dbias's batch groups of ceil(B / groups)
// batches each, none empty, with a [groups, H, N, N] dbias_part when groups >
// 1). Each returns the CUDA
// error of its launches (0 on success) and does not synchronize. With dbias
// set, attn_stream_bwd_dq launches the dq kernel's dbias instance and, with
// more than one group, the fixed-order sum over the groups' slabs.
extern "C" int attn_stream_bwd_dq(void* const* ptrs, const long long* strides,
                                  const int* dims, float scale, void* stream) {
  return run(PASS_DQ, ptrs, strides, dims, scale, stream);
}

extern "C" int attn_stream_bwd_dkv(void* const* ptrs, const long long* strides,
                                   const int* dims, float scale, void* stream) {
  return run(PASS_DKV, ptrs, strides, dims, scale, stream);
}
