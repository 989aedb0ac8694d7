// K10: flash-decode attention of one query row per (sample, head).
//
// Replaces sar_tpu/ops/attic/attention.py::decode_attention (Pallas
// `_kernel_full` and `_kernel_masked`, both `_attend`), a parked experiment
// with no caller in either package. Per sample b and head h: q [B, H, 64]
// (pre-scaled) and k/v [B, H, S, 64] bf16,
//   score_s = q . k_s in fp32, masked to -1e30 for s >= n (n = S for the
//   full variant; the masked variant's n is read from device memory when
//   given, so one build serves every length), softmax in fp32 NORMALISED,
//   w_s = bf16(p_s / sum), out = sum_s w_s v_s accumulated in fp32, stored
//   bf16 [B, H, 64].
//
// Bound on the H100: bytes. At whisper-small's cross shape (B=8, H=12,
// S=1500) one call reads 2*B*H*S*64*2 = 36.9 MB of k/v (11.0 us at
// 3.35 TB/s) for 4*B*H*S*64 = 37 MFLOP; the masked variant needs only its
// first n rows. Design: K3's skeleton for bf16 rows. One block per
// (head, sample) streams the 128-byte rows of k, eight threads per row with
// 16-byte loads (32 rows per pass; rows at or past n are not read), the
// partial dot summed over the eight lanes with shuffles. Scores sit in
// dynamic shared memory; two block reductions (max, sum); the normalised
// probabilities are rounded to bf16 in place; the P.V pass reads v the same
// way, and the 32 row groups are summed with shuffles within a warp and
// through shared memory (reusing the score row) across the 8 warps. Both
// TPU variants are one kernel: the full one is n = S. The loop steps whole
// warps, so any S is taken. 96 blocks at whisper-small B=8 leave a third of
// the 132 SMs idle; splitting S across blocks (flash-decoding's split-K) is
// for later.
#include "common.cuh"

namespace {

constexpr int HD = 64;
constexpr int NT = 256;
constexpr int TPR = HD / 8;     // threads per row: 8 bf16 (16 bytes) each
constexpr int RG = NT / TPR;    // row groups per pass

__global__ void __launch_bounds__(NT)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q,  // [B, H, 64]
                        const __nv_bfloat16* __restrict__ k,  // [B, H, S, 64]
                        const __nv_bfloat16* __restrict__ v,
                        const int* __restrict__ n_dev, int n_host,
                        __nv_bfloat16* __restrict__ out,      // [B, H, 64]
                        int H, int S) {
  extern __shared__ float smem[];
  float* sc = smem;  // [S] scores, then bf16-rounded probabilities
  __shared__ float scratch[32];

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int part = tid % TPR;  // columns 8*part .. 8*part+7
  const int rg = tid / TPR;
  int n = n_dev != nullptr ? *n_dev : n_host;
  n = n < 0 ? 0 : (n > S ? S : n);
  const size_t bh = (size_t)b * H + h;
  const __nv_bfloat16* kb = k + bh * S * HD + part * 8;
  const __nv_bfloat16* vb = v + bh * S * HD + part * 8;

  float qf[8];
  sar::load_bf16x8(q + bh * HD + part * 8, qf);
  float m = -INFINITY;
  for (int s0 = 0; s0 < S; s0 += RG) {
    const int s = s0 + rg;
    float dot = 0.f;
    if (s < n) {
      float kf[8];
      sar::load_bf16x8(kb + (size_t)s * HD, kf);
#pragma unroll
      for (int i = 0; i < 8; ++i) dot = fmaf(qf[i], kf[i], dot);
    }
    dot = sar::group_sum<TPR>(dot);  // every lane of the warp takes part
    if (s < S) {
      const float score = s < n ? dot : sar::kNeg;
      if (part == 0) sc[s] = score;
      m = fmaxf(m, score);
    }
  }
  m = sar::block_reduce<true>(m, scratch);

  float lsum = 0.f;
  for (int s = tid; s < S; s += NT) {
    const float e = expf(sc[s] - m);
    sc[s] = e;
    lsum += e;
  }
  const float tot = sar::block_reduce<false>(lsum, scratch);
  for (int s = tid; s < S; s += NT) sc[s] = sar::bf16_round(sc[s] / tot);
  __syncthreads();

  // Rows at or past n have p = 0 exactly; with n = 0 every score is masked
  // and the softmax is uniform over all S rows, as in the TPU kernel.
  const int n_pv = n > 0 ? n : S;
  float acc[8] = {};
  for (int s = rg; s < n_pv; s += RG) {
    const float w = sc[s];
    float vf[8];
    sar::load_bf16x8(vb + (size_t)s * HD, vf);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = fmaf(w, vf[i], acc[i]);
  }
  // Sum over the 4 row groups of this warp (lanes that differ in bits 3-4).
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int o = TPR; o < 32; o <<= 1) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
  __syncthreads();  // every thread has read its last probability
  float* red = smem;  // [8 warps][64]
  const int warp = tid >> 5;
  if ((tid & 31) < TPR) {
#pragma unroll
    for (int i = 0; i < 8; ++i) red[warp * HD + part * 8 + i] = acc[i];
  }
  __syncthreads();
  if (tid < HD) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) o += red[w * HD + tid];
    out[bh * HD + tid] = __float2bfloat16_rn(o);
  }
}

}  // namespace

extern "C" int sar_decode_attention(const void* q, const void* k, const void* v,
                                    const void* n_dev, int n_host, void* out, int B, int H,
                                    int S, int device, void* stream) {
  const size_t smem = (size_t)(S > 8 * HD ? S : 8 * HD) * sizeof(float);
  if (S < 1 || B < 1 || B > 65535 || H < 1 || H > 65535 ||
      smem > 232448 - 32 * sizeof(float))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024 - 32 * sizeof(float)) {
    err = cudaFuncSetAttribute(decode_attention_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(H, B);
  decode_attention_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(n_dev), n_host,
      static_cast<__nv_bfloat16*>(out), H, S);
  return (int)cudaGetLastError();
}
