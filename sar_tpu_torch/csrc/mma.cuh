// Tensor-core fragment and async-copy helpers shared by the mma.sync
// kernels (flash_attn.cu: K1, K6, K8's attention; flash_enc.cu: K8's LN +
// projection half; decode_s8.cu: K7/K9's s8 products) and the cp.async
// rings of the decode kernels.
#pragma once

#include "common.cuh"

namespace sar {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid (src-size 0).
__device__ __forceinline__ void cp_async16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Every group but the newest N has landed (this thread's copies).
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_but_one() { cp_async_wait<1>(); }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4],
                                        const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4],
                                          const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c (16 x 8, s32) += a (16 x 32, s8, row) . b (32 x 8, s8, col): exact
// integer sums. Fragments (lane = 4g + t): a0 holds row g, bytes k = 4t ..
// 4t+3; a1 row g+8; a2 and a3 the same rows at k + 16; b0 holds column g at
// k = 4t .. 4t+3, b1 at k + 16; c as for the bf16 product.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Fragment layouts (lane = 4g + t): a 16 x 8 fp32 accumulator c[e] holds
// row g + 8*(e >> 1), column 2t + (e & 1); an A fragment (16 x 16) holds
// rows g, g+8 and columns 2t (+1, +8, +9). ldsm_x4 at row (lane & 15),
// column 8*(lane >> 4) of a row-major bf16 tile gives the A fragment of its
// 16 x 16 corner; ldsm_x4_t at the same offsets of a [k][n] tile gives the
// B fragments (b0, b1) of columns 0-7 and (b2, b3) of columns 8-15.

constexpr int kMaxDevices = 64;

// Raises `kernel`'s dynamic shared-memory limit to `bytes` on the current
// device once per process (the setting lasts for the context): `done` holds
// one flag per device. A second call from a racing thread is harmless.
template <typename Kernel>
cudaError_t allow_smem_once(bool* done, int device, Kernel kernel, int bytes) {
  const bool tracked = device >= 0 && device < kMaxDevices;
  if (tracked && done[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && tracked) done[device] = true;
  return err;
}

}  // namespace sar
