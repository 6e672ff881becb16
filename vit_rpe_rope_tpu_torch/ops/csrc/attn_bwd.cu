// Dense attention backward with in-kernel rope and an optional materialized
// bias, for Hopper (sm_90a).
//
// Replaces: the Pallas kernel `_dense_bwd_kernel` of
// vit_rpe_rope_tpu/ops/flash_attention.py, launched by its driver
// `_bwd_dense`.
//
// Computes, for q, k, v, out, g [B, H, N, D] (float32 or bfloat16, any
// strides with a unit last-dim stride), with the JAX kernel's rounding points:
//   qf, kf = bf16(rotate(q)), bf16(rotate(k))   rotation in f32
//   s      = qf . kf^T * scale (+ bias[h])      f32; columns >= N masked
//   pd     = exp(s - rowmax(s)) / rowsum        f32, normalized BEFORE rounding
//   dv     = bf16(pd)^T . bf16(g)
//   gv     = bf16(g) . bf16(v)^T
//   delta  = sum_d g * out                      f32, unrounded g
//   ds     = pd * (gv - delta)                  f32
//   dq     = scale * bf16(ds) . kf,  dk = scale * bf16(ds)^T . qf
//   dqr/dkr = dq/dk before the inverse rotation (f32; rope-mixed frequency
//            gradients), then dq/dk rotated back with -sin, in the input dtype
//   dbias  = sum_batch ds                       f32 [H, N, N], when asked for
//
// What bounds it on an H100: memory. At the ViT-S/16@224 training shape
// (B=64, H=6, N=197, D=64, f32) reading q, k, v, g, out and writing dq, dk,
// dv is 155 MB, about 46 us at 3.35 TB/s, against 9.5 GFLOP of products,
// about 10 us at 989 TFLOP/s.
//
// The TPU kernel holds the full [N, N] softmax of a batch block in VMEM and
// runs the five products in one program, accumulating dbias across its
// sequential batch grid. Two routes here, chosen by the wrapper
// (flash_attention.dense_resident):
//
// Resident (attn_bwd_resident; N <= 208): ONE kernel, one CTA of
// ceil(N/16) warps per (batch, head), or per run of batches when dbias
// slabs would exceed their byte budget. It stages qf, kf, bf16 v and bf16 g
// of the whole head into shared memory once (4 x 208 x 72 x 2 = 120 KB at
// ViT-S/16) and delta from the unrounded g while staging g; then
//   phase A, warps over 16 query rows: s per 16-key block (mma.sync.m16n8k16
//     on ldmatrix fragments) for its row max and sum (online), saved to
//     shared memory; then per block s again, pd, gv, ds = pd * (gv - delta);
//     with a bias each f32 ds tile is added into the batch run's
//     [H, N, pitch] slab in 16-byte pieces; dq += bf16(ds) . kf from ds
//     repacked in registers;
//   one barrier;
//   phase B, warps over 16 keys: s^T and gv^T per 16-query block against
//     the staged q and g, pd^T from the shared (max, sum), dv += bf16(pd^T)
//     . g and dk += scale * bf16(ds^T) . qf in registers (at D = 128 with 13
//     blocks in two sweeps, dv then dk, so the two accumulators need not be
//     live at once).
// Eight products against the JAX kernel's five (s twice in phase A keeps
// the 13-block instances within their 128 registers a thread); the five
// are ~10 us of the 46 us bound. Every output tile has one owner, and a slab element one
// thread through the whole batch run: no atomics, a second launch is
// bit-identical. A last kernel sums the slabs in batch order (the JAX
// kernel's order) into dbias. No kernel recomputes s and gv for dbias.
//
// Wide (attn_bwd; the other dense shapes): the work splits into passes that
// need no cross-CTA reduction:
//   1. dq kernel, one CTA per (batch, head, 64-query tile): a pass over the
//      keys finds each row's max and sum (online), saved with delta to a
//      small [3, B, H, N] f32 buffer; a second pass forms pd, gv and ds per
//      64-key tile and accumulates dq in WMMA fragments.
//   2. dk/dv kernel, one CTA per (batch, head, 64-key tile): loops over the
//      query tiles, recomputes s^T and gv^T from the saved statistics, and
//      accumulates dk and dv in WMMA fragments.
//   3. dbias (only with a bias), one CTA per (query tile, key tile, head,
//      group of 8 batches): recomputes ds for its tile for each batch of the
//      group and sums it in registers; a last kernel sums the groups in a
//      fixed order. No atomics: dbias does not depend on the schedule.
// Products run on the tensor cores through WMMA bf16 16x16x16 with f32
// accumulation; q/k/v/g tiles are staged (rotated, rounded) into shared
// memory as in attn_fwd.cu.

#include "attn_common.cuh"
#include "attn_dense.cuh"

namespace {

using namespace attn;

constexpr int BATCH_GROUP = 8;  // batches summed in registers by one dbias CTA

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* out;
  const void* g;
  void* dq;
  void* dk;
  void* dv;
  float* dqr;         // [B, H, N, D] or null
  float* dkr;
  const float* bias;  // [H, N, N] or null
  const float* cos;   // [cos_heads, N, D/2] or null
  const float* sin;
  float* stats;       // [3, B, H, N]: row max, row sum, delta
  float* dbias;       // [H, N, N] or null
  float* dbias_part;  // wide: [groups, H, N, N] (groups > 1) or null;
                      // resident: [ceil(B / per), H, N, pitch] slabs or null
  // (batch, head, token) strides of q, k, v, out, g, dq, dk, dv
  long long qs[3], ks[3], vs[3], os[3], gs[3], dqs[3], dks[3], dvs[3];
  int B, H, N, cos_heads, groups;
  int per, pitch;  // resident: batches per CTA (and slab), slab row pitch
  float scale;
};

template <int D>
struct Layout {
  static constexpr int LDX = ldx<D>();
  static constexpr int SW = D > TK ? D : TK;  // f32 slab width
  static constexpr int LDS = SW + 4;
  static constexpr int LDP = TK + 8;          // bf16 [16, 64] row blocks
  static constexpr size_t TILE_BYTES = size_t(TQ) * LDX * 2;
  static constexpr size_t SLAB_BYTES = size_t(TQ) * LDS * 4;
  static constexpr size_t P_BYTES = size_t(TQ) * LDP * 2;
  static constexpr size_t T0 = 0;  // four bf16 tiles
  static constexpr size_t S_OFF = 4 * TILE_BYTES;
  static constexpr size_t U_OFF = S_OFF + SLAB_BYTES;
  static constexpr size_t P_OFF = U_OFF + SLAB_BYTES;
  static constexpr size_t R_OFF = P_OFF + P_BYTES;
  static constexpr size_t BYTES = R_OFF + P_BYTES;
  static_assert(TILE_BYTES % 128 == 0 && SLAB_BYTES % 128 == 0 &&
                    P_BYTES % 128 == 0,
                "shared-memory sections must stay 128-byte aligned");
};

// Pass 1 and 2 over the keys for one (batch, head, 64-query tile).
template <int D, typename T>
__global__ void __launch_bounds__(THREADS) attn_bwd_dq_kernel(const Params p) {
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
  const int q0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
  const int N = p.N;
  const T* qg = slice<T>(p.q, p.qs, b, h);
  const T* kg = slice<T>(p.k, p.ks, b, h);
  const T* vg = slice<T>(p.v, p.vs, b, h);
  const T* gg = slice<T>(p.g, p.gs, b, h);
  const T* og = slice<T>(p.out, p.os, b, h);
  T* dqg = static_cast<T*>(p.dq) + b * p.dqs[0] + h * p.dqs[1];
  const long long bh = (long long)b * p.H + h;
  const long long bhn = (long long)p.B * p.H * N;
  const long long tab = (long long)(p.cos_heads == 1 ? 0 : h) * N * (D / 2);
  const float* cos_h = p.cos != nullptr ? p.cos + tab : nullptr;
  const float* sin_h = p.sin != nullptr ? p.sin + tab : nullptr;
  const float* bias_h = p.bias != nullptr ? p.bias + (long long)h * N * N : nullptr;

  float* s_w = s_s + warp * 16 * L::LDS;
  float* u_w = u_s + warp * 16 * L::LDS;
  __nv_bfloat16* ds_w = ds_s + warp * 16 * L::LDP;
  const int row_w = q0 + warp * 16;
  const int n_kv = (N + TK - 1) / TK;

  stage_tile<D, T>(q_s, qg, p.qs[2], q0, N, cos_h, sin_h);
  stage_tile<D, T>(g_s, gg, p.gs[2], q0, N, nullptr, nullptr);

  // Lane l owns row l/2 of the warp's 16 rows and half (l % 2) of each
  // tile's 64 columns; the lane pair combines with one shuffle.
  const int my_row = lane >> 1;
  const int half = lane & 1;
  const int col0 = half * (TK / 2);
  const int qi = row_w + my_row;

  float delta = 0.f;
  if (qi < N) {
    const T* grow = gg + qi * p.gs[2] + half * (D / 2);
    const T* orow = og + qi * p.os[2] + half * (D / 2);
#pragma unroll 8
    for (int d = 0; d < D / 2; ++d) delta += to_f32(grow[d]) * to_f32(orow[d]);
  }
  delta += __shfl_xor_sync(0xffffffffu, delta, 1);
  __syncthreads();

  FragA qa[D / 16];
  load_rows<D>(qa, q_s + warp * 16 * L::LDX);
  const float* s_row = s_w + my_row * L::LDS + col0;
  const float* u_row = u_w + my_row * L::LDS + col0;

  // Pass 1: row max and sum (online over the key tiles).
  float m = NEG_INF, l = 0.f;
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * TK;
    __syncthreads();  // every warp is done with the previous K tile
    stage_tile<D, T>(k_s, kg, p.ks[2], k0, N, cos_h, sin_h);
    __syncthreads();
    warp_abt<D, L::LDS>(s_w, qa, k_s);
    __syncwarp();
    float mx = NEG_INF;
#pragma unroll 8
    for (int j = 0; j < TK / 2; ++j)
      mx = fmaxf(mx, logit(s_row[j], qi, k0 + col0 + j, N, p.scale, bias_h));
    const float m_new = fmaxf(m, fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1)));
    float sum = 0.f;
#pragma unroll 8
    for (int j = 0; j < TK / 2; ++j)
      sum += expf(logit(s_row[j], qi, k0 + col0 + j, N, p.scale, bias_h) - m_new);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * expf(m - m_new) + sum;
    m = m_new;
    __syncwarp();
  }
  if (half == 0 && qi < N) {
    p.stats[bh * N + qi] = m;
    p.stats[bhn + bh * N + qi] = l;
    p.stats[2 * bhn + bh * N + qi] = delta;
  }

  // Pass 2: pd, gv, ds per key tile; dq += bf16(ds) . kf.
  FragA ga[D / 16];
  load_rows<D>(ga, g_s + warp * 16 * L::LDX);
  FragC dq_acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(dq_acc[n], 0.f);
  __nv_bfloat16* ds_row = ds_w + my_row * L::LDP + col0;
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
      const float e = expf(logit(s_row[j], qi, k0 + col0 + j, N, p.scale, bias_h) - m);
      const float pd = __fdiv_rn(e, l);
      ds_row[j] = __float2bfloat16(__fmul_rn(pd, __fsub_rn(u_row[j], delta)));
    }
    __syncwarp();
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

// dk and dv for one (batch, head, 64-key tile), over all query tiles.
template <int D, typename T>
__global__ void __launch_bounds__(THREADS) attn_bwd_dkv_kernel(const Params p) {
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
  __shared__ float st[3][TQ];

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
  const long long bhn = (long long)p.B * p.H * N;
  const long long tab = (long long)(p.cos_heads == 1 ? 0 : h) * N * (D / 2);
  const float* cos_h = p.cos != nullptr ? p.cos + tab : nullptr;
  const float* sin_h = p.sin != nullptr ? p.sin + tab : nullptr;
  const float* bias_h = p.bias != nullptr ? p.bias + (long long)h * N * N : nullptr;

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
      const bool ok = qi < N;
      st[0][i] = ok ? p.stats[bh * N + qi] : 0.f;
      st[1][i] = ok ? p.stats[bhn + bh * N + qi] : 1.f;
      st[2][i] = ok ? p.stats[2 * bhn + bh * N + qi] : 0.f;
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
      float pd = 0.f, ds = 0.f;
      if (qi < N) {  // padded query rows carry a zero g in the JAX kernel
        const float e = expf(logit(s_row[j], qi, kj, N, p.scale, bias_h) - st[0][qc]);
        pd = __fdiv_rn(e, st[1][qc]);
        ds = __fmul_rn(pd, __fsub_rn(u_row[j], st[2][qc]));
      }
      pt_row[j] = __float2bfloat16(pd);
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

// Sum over a group of batches of ds for one (64-query, 64-key) tile of one
// head, into dbias (one group) or its group slot of dbias_part.
template <int D, typename T>
__global__ void __launch_bounds__(THREADS) attn_bwd_dbias_kernel(const Params p) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + L::T0);
  __nv_bfloat16* g_s = q_s + TQ * L::LDX;
  __nv_bfloat16* k_s = g_s + TQ * L::LDX;
  __nv_bfloat16* v_s = k_s + TK * L::LDX;
  float* s_s = reinterpret_cast<float*>(smem + L::S_OFF);
  float* u_s = reinterpret_cast<float*>(smem + L::U_OFF);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int N = p.N;
  const int n_kt = (N + TK - 1) / TK;
  const int q0 = (blockIdx.x / n_kt) * TQ, k0 = (blockIdx.x % n_kt) * TK;
  const int h = blockIdx.y, grp = blockIdx.z;
  const int b_end = min(p.B, (grp + 1) * BATCH_GROUP);
  const long long bhn = (long long)p.B * p.H * N;
  const long long tab = (long long)(p.cos_heads == 1 ? 0 : h) * N * (D / 2);
  const float* cos_h = p.cos != nullptr ? p.cos + tab : nullptr;
  const float* sin_h = p.sin != nullptr ? p.sin + tab : nullptr;
  const float* bias_h = p.bias + (long long)h * N * N;

  float* s_w = s_s + warp * 16 * L::LDS;
  float* u_w = u_s + warp * 16 * L::LDS;
  const int my_row = lane >> 1;
  const int col0 = (lane & 1) * (TK / 2);
  const int qi = q0 + warp * 16 + my_row;
  const float* s_row = s_w + my_row * L::LDS + col0;
  const float* u_row = u_w + my_row * L::LDS + col0;

  float acc[TK / 2];
#pragma unroll
  for (int j = 0; j < TK / 2; ++j) acc[j] = 0.f;
  for (int b = grp * BATCH_GROUP; b < b_end; ++b) {
    __syncthreads();  // every warp is done with the previous batch's tiles
    stage_tile<D, T>(q_s, slice<T>(p.q, p.qs, b, h), p.qs[2], q0, N, cos_h, sin_h);
    stage_tile<D, T>(g_s, slice<T>(p.g, p.gs, b, h), p.gs[2], q0, N, nullptr, nullptr);
    stage_tile<D, T>(k_s, slice<T>(p.k, p.ks, b, h), p.ks[2], k0, N, cos_h, sin_h);
    stage_tile<D, T>(v_s, slice<T>(p.v, p.vs, b, h), p.vs[2], k0, N, nullptr, nullptr);
    __syncthreads();
    {
      FragA a[D / 16];
      load_rows<D>(a, q_s + warp * 16 * L::LDX);
      warp_abt<D, L::LDS>(s_w, a, k_s);
      load_rows<D>(a, g_s + warp * 16 * L::LDX);
      warp_abt<D, L::LDS>(u_w, a, v_s);
    }
    __syncwarp();
    if (qi < N) {
      const long long at = ((long long)b * p.H + h) * N + qi;
      const float m = p.stats[at], l = p.stats[bhn + at], delta = p.stats[2 * bhn + at];
#pragma unroll
      for (int j = 0; j < TK / 2; ++j) {
        const float e = expf(logit(s_row[j], qi, k0 + col0 + j, N, p.scale, bias_h) - m);
        acc[j] += __fmul_rn(__fdiv_rn(e, l), __fsub_rn(u_row[j], delta));
      }
    }
  }
  if (qi >= N) return;
  float* dst = (p.groups == 1 ? p.dbias : p.dbias_part + (long long)grp * p.H * N * N)
               + ((long long)h * N + qi) * N;
#pragma unroll
  for (int j = 0; j < TK / 2; ++j)
    if (k0 + col0 + j < N) dst[k0 + col0 + j] = acc[j];
}

// dbias[i] = sum over the groups, in group order, of dbias_part[g][i].
__global__ void attn_bwd_dbias_sum_kernel(const Params p) {
  const long long total = (long long)p.H * p.N * p.N;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int g = 0; g < p.groups; ++g) s += p.dbias_part[g * total + i];
    p.dbias[i] = s;
  }
}


// ---------------------------------------------------------------------------
// The resident route
// ---------------------------------------------------------------------------

// Shared-memory views of one (batch, head) on the resident route.
struct Resident {
  __nv_bfloat16 *q, *k, *v, *g;  // [np][pitch<D>] bf16 each
  float *m, *l, *delta;          // [np] row max, row sum, delta
};

// Stage qf, kf, bf16 v and bf16 g of one (batch, head) and delta = sum g *
// out per row (f32, unrounded g): 2 * np threads, D / 16 items each of 4
// columns at c and 4 at c + D/2; the D / 8 items of a row lie in
// neighbouring lanes, which add their shares of delta in a fixed order.
template <int D, typename T>
__device__ __forceinline__ void stage_resident(const Resident& sm,
                                               const Params& p, int b, int h,
                                               const float* cos_h,
                                               const float* sin_h) {
  using namespace dense;
  constexpr int LD = pitch<D>();
  constexpr int H2 = D / 2;
  constexpr int PER_ROW = D / 8;
  const int N = p.N;
  const T* qg = slice<T>(p.q, p.qs, b, h);
  const T* kg = slice<T>(p.k, p.ks, b, h);
  const T* vg = slice<T>(p.v, p.vs, b, h);
  const T* gg = slice<T>(p.g, p.gs, b, h);
  const T* og = slice<T>(p.out, p.os, b, h);
#pragma unroll 1
  for (int it = 0; it < D / 16; ++it) {
    const int i = it * blockDim.x + threadIdx.x;
    const int r = i / PER_ROW, c = (i % PER_ROW) * 4;
    float q1[4] = {}, q2[4] = {}, k1[4] = {}, k2[4] = {}, v1[4] = {}, v2[4] = {};
    float g1[4] = {}, g2[4] = {}, o1[4] = {}, o2[4] = {};
    float cs[4] = {1.f, 1.f, 1.f, 1.f}, sn[4] = {};
    if (r < N) {
      load4(qg + r * p.qs[2] + c, q1);
      load4(qg + r * p.qs[2] + c + H2, q2);
      load4(kg + r * p.ks[2] + c, k1);
      load4(kg + r * p.ks[2] + c + H2, k2);
      load4(vg + r * p.vs[2] + c, v1);
      load4(vg + r * p.vs[2] + c + H2, v2);
      load4(gg + r * p.gs[2] + c, g1);
      load4(gg + r * p.gs[2] + c + H2, g2);
      load4(og + r * p.os[2] + c, o1);
      load4(og + r * p.os[2] + c + H2, o2);
      if (cos_h != nullptr) {
        load4(cos_h + (long long)r * H2 + c, cs);
        load4(sin_h + (long long)r * H2 + c, sn);
      }
    }
    float d = 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u) d += g1[u] * o1[u];
#pragma unroll
    for (int u = 0; u < 4; ++u) d += g2[u] * o2[u];
#pragma unroll
    for (int off = 1; off < PER_ROW; off <<= 1)
      d += __shfl_xor_sync(0xffffffffu, d, off);
    if (i % PER_ROW == 0) sm.delta[r] = d;
    if (cos_h != nullptr) {
      rotate4(q1, q2, cs, sn);
      rotate4(k1, k2, cs, sn);
    }
    put4(sm.q + r * LD + c, q1);
    put4(sm.q + r * LD + c + H2, q2);
    put4(sm.k + r * LD + c, k1);
    put4(sm.k + r * LD + c + H2, k2);
    put4(sm.v + r * LD + c, v1);
    put4(sm.v + r * LD + c + H2, v2);
    put4(sm.g + r * LD + c, g1);
    put4(sm.g + r * LD + c + H2, g2);
  }
}

// The scores of the warp's 16 query rows against one 16-key block: two C
// tiles of qf . kf^T.
template <int D>
__device__ __forceinline__ void score_block(float (&s)[2][4], const Resident& sm,
                                            int row0, int j) {
  using namespace dense;
  constexpr int LD = pitch<D>();
#pragma unroll
  for (int e = 0; e < 4; ++e) s[0][e] = s[1][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4], bb[4];
    load_a<LD>(a, sm.q, row0, kk * 16);
    load_bt<LD>(bb, sm.k, j * 16, kk * 16);
    mma(s[0], a, bb[0], bb[1]);
    mma(s[1], a, bb[2], bb[3]);
  }
}

// Phase A for the warp's 16 query rows. First s per 16-key block for the
// row max and sum (online, as the wide dq kernel forms them; saved to
// shared memory); then, per block, s again (the same products, so the same
// bits), pd, gv, ds (added into the slab when given) and dq += bf16(ds) .
// kf. No score block outlives its key block, so that the 13-block
// instances keep within the 128 registers a thread that a CTA of 13 warps
// has (the register file is handed out for 4 warps at a time).
template <int D, int KB, typename T>
__device__ __forceinline__ void query_pass(const Resident& sm, const Params& p,
                                           int b, int h, int nkb,
                                           const float* bias_h,
                                           const float* cos_h,
                                           const float* sin_h, float* slab,
                                           bool first) {
  using namespace dense;
  constexpr int LD = pitch<D>();
  const int N = p.N;
  const int lane = threadIdx.x % 32, g4 = lane >> 2;
  const int row0 = (threadIdx.x / 32) * 16;

  // Row max and sum, online over the key blocks within each lane (its
  // columns of the two rows), then across the 4 lanes of the quad.
  float mx[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll 1
  for (int j = 0; j < nkb; ++j) {
    float s[2][4];
    score_block<D>(s, sm, row0, j);
    float bm[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int qi, kj;
        tile_coords(e, row0, j * 16 + nt * 8, qi, kj);
        s[nt][e] = logit(s[nt][e], qi, kj, N, p.scale, bias_h);
        bm[e >> 1] = fmaxf(bm[e >> 1], s[nt][e]);
      }
    float m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) m_new[r] = fmaxf(mx[r], bm[r]);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[e >> 1] += expf(s[nt][e] - m_new[e >> 1]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l[r] * expf(mx[r] - m_new[r]) + sum[r];
      mx[r] = m_new[r];
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mo = __shfl_xor_sync(0xffffffffu, mx[r], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float m_new = fmaxf(mx[r], mo);
      l[r] = l[r] * expf(mx[r] - m_new) + lo * expf(mo - m_new);
      mx[r] = m_new;
    }
  if ((lane & 3) == 0) {
    sm.m[row0 + g4] = mx[0];
    sm.m[row0 + g4 + 8] = mx[1];
    sm.l[row0 + g4] = l[0];
    sm.l[row0 + g4 + 8] = l[1];
  }
  const float dl[2] = {sm.delta[row0 + g4], sm.delta[row0 + g4 + 8]};

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll 1
  for (int j = 0; j < nkb; ++j) {
    float s[2][4], gv[2][4] = {};
    score_block<D>(s, sm, row0, j);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], bb[4];
      load_a<LD>(a, sm.g, row0, kk * 16);
      load_bt<LD>(bb, sm.v, j * 16, kk * 16);
      mma(gv[0], a, bb[0], bb[1]);
      mma(gv[1], a, bb[2], bb[3]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int qi, kj;
        tile_coords(e, row0, j * 16 + nt * 8, qi, kj);
        const float x = expf(logit(s[nt][e], qi, kj, N, p.scale, bias_h) - mx[e >> 1]);
        const float pd = __fdiv_rn(x, l[e >> 1]);
        s[nt][e] = __fmul_rn(pd, __fsub_rn(gv[nt][e], dl[e >> 1]));
      }
    if (slab != nullptr) {
      add_tile(slab, p.pitch, row0, j * 16, N, p.pitch, s[0], first);
      add_tile(slab, p.pitch, row0, j * 16 + 8, N, p.pitch, s[1], first);
    }
    uint32_t da[4];
    pack_a(da, s[0], s[1]);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      uint32_t bb[4];
      load_b<LD>(bb, sm.k, j * 16, n * 16);
      mma(acc[2 * n], da, bb[0], bb[1]);
      mma(acc[2 * n + 1], da, bb[2], bb[3]);
    }
  }
  const long long bh = (long long)b * p.H + h;
  T* dqg = static_cast<T*>(p.dq) + b * p.dqs[0] + h * p.dqs[1];
  write_grad<D, T>(acc, row0, N, p.scale, dqg, p.dqs[2],
                   p.dqr != nullptr ? p.dqr + bh * N * D : nullptr, cos_h,
                   sin_h);
}

// Phase B for the warp's 16 keys: s^T and (for dk) gv^T per 16-query block,
// pd^T from the saved row statistics, and dv (DV) and / or dk, dkr (DK).
template <int D, int KB, bool DV, bool DK, typename T>
__device__ __forceinline__ void key_pass(const Resident& sm, const Params& p,
                                         int b, int h, int nkb,
                                         const float* bias_h,
                                         const float* cos_h,
                                         const float* sin_h) {
  using namespace dense;
  constexpr int LD = pitch<D>();
  const int N = p.N;
  const int key0 = (threadIdx.x / 32) * 16;
  float dv[DV ? D / 8 : 1][4], dk[DK ? D / 8 : 1][4];
#pragma unroll
  for (int n = 0; n < (DV ? D / 8 : 1); ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[n][e] = 0.f;
#pragma unroll
  for (int n = 0; n < (DK ? D / 8 : 1); ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = 0.f;

#pragma unroll 1
  for (int j = 0; j < nkb; ++j) {
    float st[2][4] = {}, gt[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], bb[4];
      load_a<LD>(a, sm.k, key0, kk * 16);
      load_bt<LD>(bb, sm.q, j * 16, kk * 16);
      mma(st[0], a, bb[0], bb[1]);
      mma(st[1], a, bb[2], bb[3]);
      if constexpr (DK) {
        load_a<LD>(a, sm.v, key0, kk * 16);
        load_bt<LD>(bb, sm.g, j * 16, kk * 16);
        mma(gt[0], a, bb[0], bb[1]);
        mma(gt[1], a, bb[2], bb[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int kj, qi;
        tile_coords(e, key0, j * 16 + nt * 8, kj, qi);
        float pd = 0.f, ds = 0.f;
        if (qi < N) {  // padded query rows carry a zero g in the JAX kernel
          const float x = expf(logit(st[nt][e], qi, kj, N, p.scale, bias_h) - sm.m[qi]);
          pd = __fdiv_rn(x, sm.l[qi]);
          if constexpr (DK) ds = __fmul_rn(pd, __fsub_rn(gt[nt][e], sm.delta[qi]));
        }
        st[nt][e] = pd;
        gt[nt][e] = ds;
      }
    if constexpr (DV) {
      uint32_t a[4];
      pack_a(a, st[0], st[1]);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        uint32_t bb[4];
        load_b<LD>(bb, sm.g, j * 16, n * 16);
        mma(dv[2 * n], a, bb[0], bb[1]);
        mma(dv[2 * n + 1], a, bb[2], bb[3]);
      }
    }
    if constexpr (DK) {
      uint32_t a[4];
      pack_a(a, gt[0], gt[1]);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        uint32_t bb[4];
        load_b<LD>(bb, sm.q, j * 16, n * 16);
        mma(dk[2 * n], a, bb[0], bb[1]);
        mma(dk[2 * n + 1], a, bb[2], bb[3]);
      }
    }
  }
  if constexpr (DV) {
    T* dvg = static_cast<T*>(p.dv) + b * p.dvs[0] + h * p.dvs[1];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) store_tile(dvg, p.dvs[2], key0, n * 8, N, dv[n]);
  }
  if constexpr (DK) {
    const long long bh = (long long)b * p.H + h;
    T* dkg = static_cast<T*>(p.dk) + b * p.dks[0] + h * p.dks[1];
    write_grad<D, T>(dk, key0, N,
                     p.scale, dkg, p.dks[2],
                     p.dkr != nullptr ? p.dkr + bh * N * D : nullptr, cos_h,
                     sin_h);
  }
}

// Two sweeps of phase B where dv and dk together would not fit the
// registers beside the rest: D = 128 in the 13-block bucket.
template <int D, int KB>
__host__ __device__ constexpr bool split_key_pass() {
  return D >= 128 && KB > dense::SMALL_BLOCKS;
}

// One CTA per (head, run of p.per batches): every batch of the run in
// turn, each staged once and run through phases A and B.
template <int D, int KB, typename T>
__global__ void __launch_bounds__(32 * KB, 1) attn_bwd_resident_kernel(const Params p) {
  using namespace dense;
  constexpr int LD = pitch<D>();
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = p.N, nkb = (N + 15) / 16, np = nkb * 16;
  Resident sm;
  sm.q = reinterpret_cast<__nv_bfloat16*>(smem);
  sm.k = sm.q + np * LD;
  sm.v = sm.k + np * LD;
  sm.g = sm.v + np * LD;
  sm.m = reinterpret_cast<float*>(sm.g + np * LD);
  sm.l = sm.m + np;
  sm.delta = sm.l + np;

  const int h = blockIdx.x, run = blockIdx.y;
  const int b0 = run * p.per, b1 = min(p.B, b0 + p.per);
  const long long tab = (long long)(p.cos_heads == 1 ? 0 : h) * N * (D / 2);
  const float* cos_h = p.cos != nullptr ? p.cos + tab : nullptr;
  const float* sin_h = p.sin != nullptr ? p.sin + tab : nullptr;
  const float* bias_h = p.bias != nullptr ? p.bias + (long long)h * N * N : nullptr;
  float* slab = p.dbias_part != nullptr
                    ? p.dbias_part + ((long long)run * p.H + h) * N * p.pitch
                    : nullptr;
  for (int b = b0; b < b1; ++b) {
    if (b > b0) __syncthreads();  // every warp is done with the last batch
    stage_resident<D, T>(sm, p, b, h, cos_h, sin_h);
    __syncthreads();
    query_pass<D, KB, T>(sm, p, b, h, nkb, bias_h, cos_h, sin_h, slab, b == b0);
    __syncthreads();  // every row's (max, sum) is in shared memory
    if constexpr (split_key_pass<D, KB>()) {
      key_pass<D, KB, true, false, T>(sm, p, b, h, nkb, bias_h, cos_h, sin_h);
      key_pass<D, KB, false, true, T>(sm, p, b, h, nkb, bias_h, cos_h, sin_h);
    } else {
      key_pass<D, KB, true, true, T>(sm, p, b, h, nkb, bias_h, cos_h, sin_h);
    }
  }
}

// dbias[h, i, j] = the sum over the slabs, in slab (batch) order, of
// slab[., h, i, j]; one thread per 4 columns of a padded slab row.
__global__ void attn_bwd_slab_sum_kernel(const Params p) {
  dense::sum_slabs(p.dbias, p.dbias_part, (long long)p.H * p.N, p.N, p.pitch,
                   (p.B + p.per - 1) / p.per);
}

template <int D, int KB, typename T>
cudaError_t launch_resident(const Params& p, cudaStream_t stream) {
  const int nkb = (p.N + 15) / 16, np = nkb * 16;
  const size_t smem = size_t(4) * np * dense::pitch<D>() * 2 + size_t(3) * np * 4;
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_resident_kernel<D, KB, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int runs = (p.B + p.per - 1) / p.per;
  attn_bwd_resident_kernel<D, KB, T><<<dim3(p.H, runs), 32 * nkb, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.dbias == nullptr) return err;
  const long long quads = (long long)p.H * p.N * (p.pitch / 4);
  const int blocks = int(quads / 256 + 1 < 4096 ? quads / 256 + 1 : 4096);
  attn_bwd_slab_sum_kernel<<<blocks, 256, 0, stream>>>(p);
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

template <int D, typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = Layout<D>::BYTES;
  const int n_q = (p.N + TQ - 1) / TQ, n_k = (p.N + TK - 1) / TK;
  cudaError_t err = launch_kernel(attn_bwd_dq_kernel<D, T>, dim3(n_q, p.H, p.B),
                                  smem, p, stream);
  if (err != cudaSuccess) return err;
  err = launch_kernel(attn_bwd_dkv_kernel<D, T>, dim3(n_k, p.H, p.B), smem, p,
                      stream);
  if (err != cudaSuccess || p.dbias == nullptr) return err;
  err = launch_kernel(attn_bwd_dbias_kernel<D, T>,
                      dim3(n_q * n_k, p.H, p.groups), smem, p, stream);
  if (err != cudaSuccess || p.groups == 1) return err;
  const long long total = (long long)p.H * p.N * p.N;
  const int blocks = int(total / 256 + 1 < 4096 ? total / 256 + 1 : 4096);
  attn_bwd_dbias_sum_kernel<<<blocks, 256, 0, stream>>>(p);
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

extern "C" int attn_bwd_batch_group() { return BATCH_GROUP; }

// Plain C entry point (bound with ctypes). ptrs holds 16 device pointers:
// q k v out g dq dk dv dqr dkr bias cos sin stats dbias dbias_part (null
// where absent); strides holds 24 element strides: (batch, head, token) of
// q k v out g dq dk dv. groups = ceil(B / attn_bwd_batch_group()). Returns
// the CUDA error of the launches (0 on success); does not synchronize.
extern "C" int attn_bwd(void* const* ptrs, const long long* strides, int B,
                        int H, int N, int D, int is_bf16, int cos_heads,
                        int groups, float scale, void* stream) {
  Params p;
  p.q = ptrs[0];
  p.k = ptrs[1];
  p.v = ptrs[2];
  p.out = ptrs[3];
  p.g = ptrs[4];
  p.dq = ptrs[5];
  p.dk = ptrs[6];
  p.dv = ptrs[7];
  p.dqr = static_cast<float*>(ptrs[8]);
  p.dkr = static_cast<float*>(ptrs[9]);
  p.bias = static_cast<const float*>(ptrs[10]);
  p.cos = static_cast<const float*>(ptrs[11]);
  p.sin = static_cast<const float*>(ptrs[12]);
  p.stats = static_cast<float*>(ptrs[13]);
  p.dbias = static_cast<float*>(ptrs[14]);
  p.dbias_part = static_cast<float*>(ptrs[15]);
  long long* dst[8] = {p.qs, p.ks, p.vs, p.os, p.gs, p.dqs, p.dks, p.dvs};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  p.B = B;
  p.H = H;
  p.N = N;
  p.cos_heads = cos_heads;
  p.groups = groups;
  p.scale = scale;
  if (p.dbias != nullptr &&
      (p.bias == nullptr || (groups > 1 && p.dbias_part == nullptr)))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? dispatch<__nv_bfloat16>(p, D, s)
                                  : dispatch<float>(p, D, s);
  return int(err);
}

// The resident route's entry (N <= 16 * dense::MAX_BLOCKS; 16-byte aligned
// rows of q, k, v, out, g, dq, dk, dv and the tables). ptrs as attn_bwd's,
// with stats unused and dbias_part the [ceil(B / per), H, N, pitch] f32
// slabs (pitch = N rounded up to 4), given with dbias; strides as
// attn_bwd's. per: batches per CTA and slab (1 without dbias). Returns the
// CUDA error of the launches (0 on success); does not synchronize.
extern "C" int attn_bwd_resident(void* const* ptrs, const long long* strides,
                                 int B, int H, int N, int D, int is_bf16,
                                 int cos_heads, int per, float scale,
                                 void* stream) {
  Params p;
  p.q = ptrs[0];
  p.k = ptrs[1];
  p.v = ptrs[2];
  p.out = ptrs[3];
  p.g = ptrs[4];
  p.dq = ptrs[5];
  p.dk = ptrs[6];
  p.dv = ptrs[7];
  p.dqr = static_cast<float*>(ptrs[8]);
  p.dkr = static_cast<float*>(ptrs[9]);
  p.bias = static_cast<const float*>(ptrs[10]);
  p.cos = static_cast<const float*>(ptrs[11]);
  p.sin = static_cast<const float*>(ptrs[12]);
  p.stats = nullptr;
  p.dbias = static_cast<float*>(ptrs[14]);
  p.dbias_part = static_cast<float*>(ptrs[15]);
  long long* dst[8] = {p.qs, p.ks, p.vs, p.os, p.gs, p.dqs, p.dks, p.dvs};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  p.B = B;
  p.H = H;
  p.N = N;
  p.cos_heads = cos_heads;
  p.groups = 0;
  p.per = per;
  p.pitch = (N + 3) / 4 * 4;
  p.scale = scale;
  if (per < 1 || (p.dbias == nullptr) != (p.dbias_part == nullptr) ||
      (p.dbias != nullptr && p.bias == nullptr) ||
      (p.dbias == nullptr && per != 1))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? dispatch_resident<__nv_bfloat16>(p, D, s)
                                  : dispatch_resident<float>(p, D, s);
  return int(err);
}
