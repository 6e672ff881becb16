// Fused multi-tensor AdamW for Hopper (sm_90a): one launch updates every
// float32 leaf of a params dict in place.
//
// Replaces: the Pallas kernel `_adamw_kernel` of
// vit_rpe_rope_tpu/ops/fused_adamw.py, launched by `make_fused_adamw`.
//
// Computes, per element, in float32 and rounded op by op as the JAX kernel
// rounds it (no FMA contraction):
//   mu = b1 * mu + (1 - b1) * g
//   nu = b2 * nu + ((1 - b2) * g) * g
//   p  = p - lr * ((mu / c1) / (sqrt(nu / c2) + eps) + wd * p)
// with lr, c1 = 1 - b1^t and c2 = 1 - b2^t computed by the caller.
//
// What bounds it on an H100: memory. Each element reads p, g, mu, nu and
// writes p, mu, nu: 28 bytes. For ViT-S/16 (21.6 M params) that is 604 MB,
// about 0.18 ms at 3.35 TB/s, against ~15 float32 operations per element.
//
// Design: the TPU kernel packs leaves into 1 MB groups, a VMEM budget, with
// one program per group. Here one launch covers all leaves, one CTA per chunk
// of 4096 elements of a leaf. What stays the same from step to step lives on
// the device: a table of leaf records (p, mu, nu, numel), whose storages the
// optimizer owns, and of chunks (leaf, first element), which the wrapper
// builds once per set of storages. The gradients are new tensors every step,
// so their pointers travel by value in the kernel's argument block (at most
// MAX_GRADS per launch, which keeps the block under the 4 KB every CUDA
// version takes): a step costs no host-to-device copy. A chunk whose four
// pointers are 16-byte aligned (torch allocations are 256-byte aligned and
// chunks start at multiples of 4096 elements) moves as float4 loads and
// stores, each thread issuing all its loads before it uses them; the rest of
// a leaf's last chunk, and any unaligned chunk, goes element by element.
//
// Two entries launch the one kernel. adamw_step takes lr, c1 and c2 by
// value. adamw_step_table reads them, and a live flag, from four floats in
// device memory: a step captured in a CUDA graph then takes the values the
// host writes there before each replay (a by-value argument would stay the
// one of the captured step), and a step whose flag is 0 (a padded step of
// a k-step dispatch) leaves p, mu and nu as they were.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 16;
constexpr int CHUNK = THREADS * PER_THREAD;
constexpr int VEC = 4;                        // floats per 16-byte access
constexpr int VEC_PER_THREAD = PER_THREAD / VEC;
constexpr int MAX_GRADS = 480;                // 3,840 bytes of pointers

struct Leaf {
  float* p;
  float* mu;
  float* nu;
  long long n;
};

struct Grads {
  const float* g[MAX_GRADS];
};

struct Hyper {
  float lr, c1, c2, b1, b2, omb1, omb2, eps, wd;
};

__device__ __forceinline__ void adamw(float& p, float g, float& mu, float& nu,
                                      const Hyper& hp) {
  const float m = __fadd_rn(__fmul_rn(hp.b1, mu), __fmul_rn(hp.omb1, g));
  const float v = __fadd_rn(__fmul_rn(hp.b2, nu), __fmul_rn(__fmul_rn(hp.omb2, g), g));
  const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, hp.c2)), hp.eps);
  const float update = __fadd_rn(__fdiv_rn(__fdiv_rn(m, hp.c1), denom), __fmul_rn(hp.wd, p));
  p = __fsub_rn(p, __fmul_rn(hp.lr, update));
  mu = m;
  nu = v;
}

__device__ __forceinline__ void adamw4(float4& p, const float4 g, float4& mu, float4& nu,
                                       const Hyper& hp) {
  adamw(p.x, g.x, mu.x, nu.x, hp);
  adamw(p.y, g.y, mu.y, nu.y, hp);
  adamw(p.z, g.z, mu.z, nu.z, hp);
  adamw(p.w, g.w, mu.w, nu.w, hp);
}

// chunks: this launch's (leaf, first element) pairs; its leaves' gradients
// are grads.g[leaf - leaf0].
// table: nullptr, or the device floats (lr, c1, c2, live) that replace
// hp's first three; live == 0 makes the launch a no-op.
__global__ void __launch_bounds__(THREADS)
    adamw_kernel(const Leaf* __restrict__ leaves, const long long* __restrict__ chunks,
                 const int leaf0, const Grads grads, Hyper hp,
                 const float* __restrict__ table) {
  if (table != nullptr) {
    if (table[3] == 0.0f) return;
    hp.lr = table[0];
    hp.c1 = table[1];
    hp.c2 = table[2];
  }
  const long long leaf = chunks[2 * blockIdx.x];
  const long long start = chunks[2 * blockIdx.x + 1];
  const Leaf L = leaves[leaf];
  float* p = L.p + start;
  float* mu = L.mu + start;
  float* nu = L.nu + start;
  const float* g = grads.g[leaf - leaf0] + start;
  const int n = int(L.n - start < CHUNK ? L.n - start : CHUNK);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(mu) |
        reinterpret_cast<uintptr_t>(nu) | reinterpret_cast<uintptr_t>(g)) & 15) == 0;
  const int n_vec = aligned ? n / VEC : 0;

  float4 pv[VEC_PER_THREAD], gv[VEC_PER_THREAD], mv[VEC_PER_THREAD], vv[VEC_PER_THREAD];
#pragma unroll
  for (int u = 0; u < VEC_PER_THREAD; ++u) {
    const int j = u * THREADS + threadIdx.x;
    if (j < n_vec) {
      pv[u] = reinterpret_cast<const float4*>(p)[j];
      gv[u] = reinterpret_cast<const float4*>(g)[j];
      mv[u] = reinterpret_cast<const float4*>(mu)[j];
      vv[u] = reinterpret_cast<const float4*>(nu)[j];
    }
  }
#pragma unroll
  for (int u = 0; u < VEC_PER_THREAD; ++u) {
    const int j = u * THREADS + threadIdx.x;
    if (j < n_vec) {
      adamw4(pv[u], gv[u], mv[u], vv[u], hp);
      reinterpret_cast<float4*>(p)[j] = pv[u];
      reinterpret_cast<float4*>(mu)[j] = mv[u];
      reinterpret_cast<float4*>(nu)[j] = vv[u];
    }
  }
  for (int i = n_vec * VEC + threadIdx.x; i < n; i += THREADS) {
    float pi = p[i], mi = mu[i], ni = nu[i];
    adamw(pi, g[i], mi, ni, hp);
    p[i] = pi;
    mu[i] = mi;
    nu[i] = ni;
  }
}

}  // namespace

extern "C" int adamw_chunk() { return CHUNK; }

extern "C" int adamw_max_grads() { return MAX_GRADS; }

namespace {

int launch(const void* leaves, const void* chunks, int n_chunks, int leaf0, int n_grads,
           const void* const* grads, const Hyper& hp, const float* table, void* stream) {
  if (n_grads < 0 || n_grads > MAX_GRADS) return int(cudaErrorInvalidValue);
  if (n_chunks <= 0) return 0;
  Grads gs = {};
  for (int i = 0; i < n_grads; ++i) gs.g[i] = static_cast<const float*>(grads[i]);
  adamw_kernel<<<n_chunks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Leaf*>(leaves), static_cast<const long long*>(chunks), leaf0, gs, hp,
      table);
  return int(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes). leaves: device array of records
// {p, mu, nu, numel} (3 pointers and an int64 each); chunks: device array of
// this launch's n_chunks (leaf, first element) int64 pairs, one per CHUNK
// elements of each of its leaves, which are leaves leaf0 .. leaf0 + n_grads
// - 1; grads: HOST array of those leaves' n_grads (<= MAX_GRADS) gradient
// device pointers, copied into the kernel's arguments. Returns the CUDA
// error of the launch (0 on success); does not synchronize.
extern "C" int adamw_step(const void* leaves, const void* chunks, int n_chunks, int leaf0,
                          int n_grads, const void* const* grads, float lr, float c1, float c2,
                          float b1, float b2, float omb1, float omb2, float eps, float wd,
                          void* stream) {
  const Hyper hp{lr, c1, c2, b1, b2, omb1, omb2, eps, wd};
  return launch(leaves, chunks, n_chunks, leaf0, n_grads, grads, hp, nullptr, stream);
}

// As adamw_step, with lr, c1, c2 and the live flag read on the device from
// table[0..3] (float32, 16-byte aligned) when the kernel runs.
extern "C" int adamw_step_table(const void* leaves, const void* chunks, int n_chunks, int leaf0,
                                int n_grads, const void* const* grads, const void* table,
                                float b1, float b2, float omb1, float omb2, float eps, float wd,
                                void* stream) {
  if (table == nullptr) return int(cudaErrorInvalidValue);
  const Hyper hp{0.0f, 1.0f, 1.0f, b1, b2, omb1, omb2, eps, wd};
  return launch(leaves, chunks, n_chunks, leaf0, n_grads, grads, hp,
                static_cast<const float*>(table), stream);
}
