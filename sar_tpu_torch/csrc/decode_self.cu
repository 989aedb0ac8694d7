// K9: one s8 decode step of self-attention over head-minor int8 slabs.
//
// Replaces sar_tpu/ops/attic/decode_self.py::self_decode_attention (Pallas
// `_kernel` / `_cell`), a parked experiment with no caller in either
// package. Per sample b and head h, over layer `layer` of the FULL stacked
// cache (kq/vq [L, B, S, H*64] s8, ks/vs [L, B, H, S] f32), with the query
// quantized per (row, head) by the caller (qq [B, H*64] s8, qs [B, H] f32):
//   score_s = float(qq . kq_s) * qs * ks_s       (exact int32 dot, __dp4a)
//   masked for s >= n (the dynamic valid length, pos + 1, read from device
//   memory when given, so one build serves every position), softmax in
//   fp32 normalised before pw_s = p_s * vs_s, re-quantized per (b, h):
//   ps = max(max_s |pw_s|, 1e-8) / 127, pq_s = clamp(rint(pw_s / ps), +-127)
//   (round half to even, exact division: no fast math), and
//   out = float(sum_s pq_s * vq_s) * ps          (exact int32 sum), bf16.
//
// Bound on the H100: bytes of the int8 slab. At whisper-small B=8, L=12,
// max_len 448 and n = max_len one call reads 2*B*n*D = 5.5 MB of kq/vq plus
// 0.23 MB of scales (1.7 us at 3.35 TB/s); with n < max_len only the first
// n rows are needed. Design: K7's skeleton with one query. One block per
// (head, sample) streams its head's 64-byte rows (row stride D) with 16-byte
// loads, four threads per row, each row's partial dot four __dp4a; rows at
// or past n are neither read nor scored. Scores sit in dynamic shared memory
// beside the s8 probabilities; three block reductions (max, sum, max |pw|);
// the int32 P.V partials are summed over the 8 row groups of a warp with
// shuffles and over the 8 warps through shared memory reusing the score
// row. Any max_len is taken: the row loop steps whole warps, so the
// shuffles never see a lane that left early. The slabs are small (448 rows
// against the cross cache's 1536), so 12 * B blocks of one step leave most
// of the card idle at B = 8; batching layers into one launch is for later.
#include "common.cuh"

namespace {

constexpr int HD = 64;
constexpr int NT = 256;
constexpr int RG = NT / 4;  // row groups: 4 threads x 16 int8 columns per row

__device__ __forceinline__ int row_sum4(int v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

__global__ void __launch_bounds__(NT)
self_decode_s8_kernel(const int8_t* __restrict__ qq,   // [B, D]
                      const float* __restrict__ qs,    // [B, H]
                      const int8_t* __restrict__ kq,   // [L, B, S, D]
                      const float* __restrict__ ks,    // [L, B, H, S]
                      const int8_t* __restrict__ vq,
                      const float* __restrict__ vs,
                      const int* __restrict__ n_dev, int n_host,
                      __nv_bfloat16* __restrict__ out,  // [B, D]
                      int B, int S, int D, int H, int layer) {
  extern __shared__ float smem[];
  float* sc = smem;  // [S] scores, then weighted probabilities
  int8_t* pq = reinterpret_cast<int8_t*>(smem + (S > 8 * HD ? S : 8 * HD));  // [S]
  __shared__ float scratch[32];

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int part = tid & 3;
  const int rg = tid >> 2;
  int n = n_dev != nullptr ? *n_dev : n_host;
  n = n < 0 ? 0 : (n > S ? S : n);
  const size_t plane = (size_t)layer * B + b;
  const int8_t* kb = kq + plane * S * D + h * HD + part * 16;
  const int8_t* vb = vq + plane * S * D + h * HD + part * 16;
  const float* ksb = ks + (plane * H + h) * S;
  const float* vsb = vs + (plane * H + h) * S;

  int qw[4];
  {
    const uint4 raw = *reinterpret_cast<const uint4*>(qq + (size_t)b * D + h * HD + part * 16);
    qw[0] = (int)raw.x;
    qw[1] = (int)raw.y;
    qw[2] = (int)raw.z;
    qw[3] = (int)raw.w;
  }
  const float qscale = qs[(size_t)b * H + h];
  float m = -INFINITY;
  for (int s0 = 0; s0 < S; s0 += RG) {
    const int s = s0 + rg;
    int dot = 0;
    if (s < n) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(kb + (size_t)s * D));
      dot = __dp4a((int)raw.x, qw[0], 0);
      dot = __dp4a((int)raw.y, qw[1], dot);
      dot = __dp4a((int)raw.z, qw[2], dot);
      dot = __dp4a((int)raw.w, qw[3], dot);
    }
    dot = row_sum4(dot);  // every lane of the warp takes part
    if (s < S) {
      const float score = s < n ? (float)dot * qscale * ksb[s] : sar::kNeg;
      if (part == 0) sc[s] = score;
      m = fmaxf(m, score);
    }
  }
  m = sar::block_reduce<true>(m, scratch);

  float red = 0.f;
  for (int s = tid; s < S; s += NT) {
    const float e = expf(sc[s] - m);
    sc[s] = e;
    red += e;
  }
  const float tot = sar::block_reduce<false>(red, scratch);
  red = 0.f;
  for (int s = tid; s < S; s += NT) {
    const float pw = (sc[s] / tot) * vsb[s];
    sc[s] = pw;
    red = fmaxf(red, fabsf(pw));
  }
  const float ps = fmaxf(sar::block_reduce<true>(red, scratch), 1e-8f) / 127.f;
  for (int s = tid; s < S; s += NT) {
    const int v = __float2int_rn(sc[s] / ps);
    pq[s] = (int8_t)max(-127, min(127, v));
  }
  __syncthreads();

  int acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0;
  // Rows at or past n have p = 0 exactly, so pq = 0; with n = 0 every
  // score is masked and the softmax is uniform over all S rows, as in the
  // TPU kernel.
  const int n_pv = n > 0 ? n : S;
  for (int s = rg; s < n_pv; s += RG) {
    const int p = pq[s];
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(vb + (size_t)s * D));
    const int8_t* vv = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] += p * (int)vv[i];
  }
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
  int* part_sums = reinterpret_cast<int*>(smem);  // [8 warps][64], over the scores
  const int warp = tid >> 5;
  if ((tid & 31) < 4) {
#pragma unroll
    for (int i = 0; i < 16; ++i) part_sums[warp * HD + part * 16 + i] = acc[i];
  }
  __syncthreads();
  if (tid < HD) {
    int o = 0;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) o += part_sums[w * HD + tid];
    out[(size_t)b * D + h * HD + tid] = __float2bfloat16_rn((float)o * ps);
  }
}

}  // namespace

extern "C" int sar_self_decode_s8(const void* qq, const void* qs, const void* kq,
                                  const void* ks, const void* vq, const void* vs,
                                  const void* n_dev, int n_host, void* out, int L, int B,
                                  int S, int D, int n_heads, int layer, int device,
                                  void* stream) {
  const size_t smem = (size_t)(S > 8 * HD ? S : 8 * HD) * sizeof(float) + (size_t)S;
  if (D != n_heads * HD || S < 1 || layer < 0 || layer >= L || B < 1 || B > 65535 ||
      smem > 232448 - 64 * sizeof(float))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024 - 64 * sizeof(float)) {
    err = cudaFuncSetAttribute(self_decode_s8_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(n_heads, B);
  self_decode_s8_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qq), static_cast<const float*>(qs),
      static_cast<const int8_t*>(kq), static_cast<const float*>(ks),
      static_cast<const int8_t*>(vq), static_cast<const float*>(vs),
      static_cast<const int*>(n_dev), n_host, static_cast<__nv_bfloat16*>(out), B, S, D,
      n_heads, layer);
  return (int)cudaGetLastError();
}
