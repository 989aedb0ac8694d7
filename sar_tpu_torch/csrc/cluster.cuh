// The two halves of a cluster barrier, shared by the cluster-split decode
// kernels (decode_attention.cu: K10; decode_cross.cu: K3/K5; decode_s8.cu:
// K7/K9).
#pragma once

#include "common.cuh"

namespace sar {

// This thread has arrived (relaxed: it publishes nothing); this thread
// waits until every thread of the cluster has.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

}  // namespace sar
