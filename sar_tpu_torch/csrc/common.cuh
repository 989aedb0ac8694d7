// Shared device helpers for the sar_tpu_torch kernels (CUDA C++, sm_90a).
//
// Plain cuda_bf16.h intrinsics only: the library is built with nvcc alone
// (no PyTorch headers), so every bf16 <-> float conversion is explicit and
// round-to-nearest-even, like XLA's.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sar {

// Masked score, as the TPU kernels' NEG: exp(kNeg - max) is exactly 0.
constexpr float kNeg = -1e30f;

// Round an fp32 value through bf16 and back (the compute dtype's rounding).
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Eight bf16 from a 16-byte aligned address, widened to fp32.
__device__ __forceinline__ void load_bf16x8(const __nv_bfloat16* p,
                                            float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Eight fp32 values rounded to bf16, stored to a 16-byte aligned address.
__device__ __forceinline__ void store_bf16x8(__nv_bfloat16* p,
                                             const float* v) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// Reduce over the lanes that differ only in the bits of `width - 1`
// (width a power of two <= 32). Every lane of the warp must call it.
template <int WIDTH>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 1; o < WIDTH; o <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int WIDTH>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 1; o < WIDTH; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide max (IS_MAX) or sum; every thread gets the result. `scratch`
// holds at least 32 floats. Contains __syncthreads(): call from all threads.
template <bool IS_MAX>
__device__ float block_reduce(float v, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  v = IS_MAX ? group_max<32>(v) : group_sum<32>(v);
  __syncthreads();  // a previous call may still be reading scratch
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float r = scratch[0];
  for (int w = 1; w < n_warps; ++w) r = IS_MAX ? fmaxf(r, scratch[w]) : r + scratch[w];
  return r;
}

}  // namespace sar
