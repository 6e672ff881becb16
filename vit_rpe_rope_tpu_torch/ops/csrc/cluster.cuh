// Thread-block clusters (sm_90), shared by the one-pass streaming backward
// (attn_stream_bwd_fused.cu) and the fused block forward (block_fused.cu):
// the two halves of a barrier of all the cluster's threads (arrive releases
// what the thread wrote to shared memory before it; wait returns once every
// thread of the cluster has arrived, and acquires it; each thread alternates
// them), the CTA's rank, and the address of a shared variable in the CTA of
// another rank (distributed shared memory, read by plain loads).
//
// A CTA must not exit while another CTA of its cluster may still read its
// shared memory: the kernels end each such reading phase with an arrive that
// the owner waits on before it reuses or leaves the memory.

#pragma once

#include <cuda_runtime.h>

namespace attn {

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return int(r);
}
// p (in this CTA's shared memory) as the same variable of the CTA of `rank`.
// A pure address computation (not volatile), so that the compiler may
// compute several before the loads that use them.
template <typename T>
__device__ __forceinline__ const T* cluster_map(const T* p, int rank) {
  unsigned long long out;
  asm("mapa.u64 %0, %1, %2;\n" : "=l"(out) : "l"(p), "r"(rank));
  return reinterpret_cast<const T*>(out);
}

}  // namespace attn
