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
// writes p, mu, nu: 28 bytes. For ViT-S/16 (21.7 M params) that is 608 MB,
// about 0.18 ms at 3.35 TB/s, against ~15 float32 operations per element.
//
// Design: the TPU kernel packs leaves into 1 MB groups, a VMEM budget, with
// one program per group. Here one launch covers all leaves: the caller hands
// a device table of (p, g, mu, nu, numel) per leaf and a table of chunks
// (leaf, first element), 4096 elements each, one CTA per chunk. Neighbouring
// threads touch neighbouring elements, and each thread issues the loads of
// its 16 elements before it uses them.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 16;
constexpr int CHUNK = THREADS * PER_THREAD;

struct Leaf {
  float* p;
  const float* g;
  float* mu;
  float* nu;
  long long n;
};

struct Hyper {
  float lr, c1, c2, b1, b2, omb1, omb2, eps, wd;
};

__global__ void __launch_bounds__(THREADS)
    adamw_kernel(const Leaf* __restrict__ leaves,
                 const long long* __restrict__ chunks, const Hyper hp) {
  const long long leaf = chunks[2 * blockIdx.x];
  const long long start = chunks[2 * blockIdx.x + 1];
  const Leaf L = leaves[leaf];
  float p[PER_THREAD], g[PER_THREAD], mu[PER_THREAD], nu[PER_THREAD];
#pragma unroll
  for (int u = 0; u < PER_THREAD; ++u) {
    const long long i = start + u * THREADS + threadIdx.x;
    if (i < L.n) {
      p[u] = L.p[i];
      g[u] = L.g[i];
      mu[u] = L.mu[i];
      nu[u] = L.nu[i];
    }
  }
#pragma unroll
  for (int u = 0; u < PER_THREAD; ++u) {
    const long long i = start + u * THREADS + threadIdx.x;
    if (i < L.n) {
      const float m = __fadd_rn(__fmul_rn(hp.b1, mu[u]), __fmul_rn(hp.omb1, g[u]));
      const float v = __fadd_rn(__fmul_rn(hp.b2, nu[u]),
                                __fmul_rn(__fmul_rn(hp.omb2, g[u]), g[u]));
      const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, hp.c2)), hp.eps);
      const float update = __fadd_rn(__fdiv_rn(__fdiv_rn(m, hp.c1), denom),
                                     __fmul_rn(hp.wd, p[u]));
      L.p[i] = __fsub_rn(p[u], __fmul_rn(hp.lr, update));
      L.mu[i] = m;
      L.nu[i] = v;
    }
  }
}

}  // namespace

extern "C" int adamw_chunk() { return CHUNK; }

// Plain C entry point (bound with ctypes). leaves: device array of n_leaves
// records {p, g, mu, nu, numel} (4 pointers and an int64 each); chunks:
// device array of n_chunks (leaf, first element) int64 pairs, one per CHUNK
// elements of each leaf. Returns the CUDA error of the launch (0 on
// success); does not synchronize.
extern "C" int adamw_step(const void* leaves, const void* chunks, int n_chunks,
                          float lr, float c1, float c2, float b1, float b2,
                          float omb1, float omb2, float eps, float wd,
                          void* stream) {
  if (n_chunks <= 0) return 0;
  const Hyper hp{lr, c1, c2, b1, b2, omb1, omb2, eps, wd};
  adamw_kernel<<<n_chunks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Leaf*>(leaves), static_cast<const long long*>(chunks), hp);
  return int(cudaGetLastError());
}
