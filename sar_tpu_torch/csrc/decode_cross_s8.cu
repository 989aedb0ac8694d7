// K7: one decode step of cross-attention with s8 scores over the int8
// head-minor cache, greedy (K = 1) and beam-folded (K = 2..8).
//
// Replaces sar_tpu/ops/decode_cross.py::cross_decode_attention (Pallas
// `_kernel`, the `scores_int8` opt-in). Per sample b, beam k and head h,
// over layer `layer`'s slab of the FULL stacked cache (kq/vq
// [L, B, S_pad, H*64] s8, ks/vs [L, B, H, S_pad] f32), with the query
// quantized per (row, head) by the caller (qq [B, K, H*64] s8, qs
// [B, K*H] f32, row k*H + h):
//   score_s = float(qq . kq_s) * qs * ks_s     (exact int32 dot, __dp4a)
//   masked where ks_s <= 0 (layout padding carries scale 0), softmax in
//   fp32, pw_s = (p_s / sum) * vs_s, re-quantized per (b, k, h) row:
//   ps = max(max_s |pw_s|, 1e-8) / 127, pq_s = clamp(rint(pw_s / ps), +-127)
//   (round half to even, as torch.round and jnp.round; roundf would round
//   halves away from zero and flip entries of pq), and
//   out = float(sum_s pq_s * vq_s) * ps       (exact int32 sum), bf16.
//
// Bound on the H100: bytes of the int8 slab, as K3. At whisper-small B=8
// one call reads 2*B*S_pad*D = 18.9 MB of kq/vq plus 0.8 MB of scales
// (20.1 MB: 6.0 us at 3.35 TB/s) for 4*B*K*S*D = 0.04*K G int8 operations,
// nothing against the 1,979 TOP/s of the tensor cores. Design: K5's
// skeleton. One block per (head, sample) streams its head's 64-byte rows of
// the slab (row stride D) with 16-byte loads, four threads per row, and
// each load feeds all K queries (the slab is read once per step for the K
// beams); a thread keeps its 16 query bytes of each beam as four packed
// int32 words, so a row's partial dot is four __dp4a. Scores, then the
// weighted probabilities, sit in dynamic shared memory ([K][S_pad] fp32),
// beside the s8 probabilities ([K][S_pad]); each query takes three block
// reductions (max, sum, max |pw|). The P.V partials are int32 (IMAD),
// summed over the 8 row groups of a warp with shuffles and over the 8
// warps through shared memory that reuses the score rows: integer sums, so
// the order of summation changes nothing. Tensor-core s8 products
// (mma.sync m16n8k32) and more blocks in flight are left for later.
#include "common.cuh"

namespace {

constexpr int HD = 64;        // head_dim
constexpr int NT = 256;       // threads per block
constexpr int RG = NT / 4;    // row groups: 4 threads x 16 int8 columns per row

// Sum over the 4 lanes of a row (lanes that differ in bits 0-1).
__device__ __forceinline__ int row_sum4(int v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

template <int K>
__global__ void __launch_bounds__(NT)
cross_decode_s8_kernel(const int8_t* __restrict__ qq,    // [B, K, D]
                       const float* __restrict__ qs,     // [B, K*H]
                       const int8_t* __restrict__ kq,    // [L, B, S, D]
                       const float* __restrict__ ks,     // [L, B, H, S]
                       const int8_t* __restrict__ vq,
                       const float* __restrict__ vs,
                       __nv_bfloat16* __restrict__ out,  // [B, K, D]
                       int B, int S, int D, int H, int layer) {
  extern __shared__ float smem[];
  float* sc = smem;  // [K][S] scores, then weighted probabilities
  int8_t* pq = reinterpret_cast<int8_t*>(smem + K * (S > 8 * HD ? S : 8 * HD));  // [K][S]
  __shared__ float scratch[32];
  __shared__ float ps_row[K];

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int part = tid & 3;  // columns 16*part .. 16*part+15 of the head
  const int rg = tid >> 2;   // rows rg, rg+RG, ...
  const size_t plane = (size_t)layer * B + b;
  const int8_t* kb = kq + plane * S * D + h * HD + part * 16;
  const int8_t* vb = vq + plane * S * D + h * HD + part * 16;
  const float* ksb = ks + (plane * H + h) * S;
  const float* vsb = vs + (plane * H + h) * S;

  float m[K];
  {
    int qw[K][4];
    float qscale[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          qq + ((size_t)b * K + k) * D + h * HD + part * 16);
      qw[k][0] = (int)raw.x;
      qw[k][1] = (int)raw.y;
      qw[k][2] = (int)raw.z;
      qw[k][3] = (int)raw.w;
      qscale[k] = qs[((size_t)b * K + k) * H + h];
      m[k] = -INFINITY;
    }
    for (int s = rg; s < S; s += RG) {  // S % RG == 0: no lane leaves early
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(kb + (size_t)s * D));
      const float kscale = ksb[s];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        int dot = __dp4a((int)raw.x, qw[k][0], 0);
        dot = __dp4a((int)raw.y, qw[k][1], dot);
        dot = __dp4a((int)raw.z, qw[k][2], dot);
        dot = __dp4a((int)raw.w, qw[k][3], dot);
        dot = row_sum4(dot);
        const float score = kscale > 0.f ? (float)dot * qscale[k] * kscale : sar::kNeg;
        if ((k & 3) == part) sc[k * S + s] = score;
        m[k] = fmaxf(m[k], score);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) m[k] = sar::block_reduce<true>(m[k], scratch);

  float red_v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) red_v[k] = 0.f;
  for (int s = tid; s < S; s += NT) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float e = expf(sc[k * S + s] - m[k]);
      sc[k * S + s] = e;
      red_v[k] += e;
    }
  }
  float tot[K];
#pragma unroll
  for (int k = 0; k < K; ++k) tot[k] = sar::block_reduce<false>(red_v[k], scratch);

  // pw = p * vs, and each row's max |pw| (the second block reduction).
#pragma unroll
  for (int k = 0; k < K; ++k) red_v[k] = 0.f;
  for (int s = tid; s < S; s += NT) {
    const float vscale = vsb[s];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float pw = (sc[k * S + s] / tot[k]) * vscale;
      sc[k * S + s] = pw;
      red_v[k] = fmaxf(red_v[k], fabsf(pw));
    }
  }
  float ps[K];
#pragma unroll
  for (int k = 0; k < K; ++k)
    ps[k] = fmaxf(sar::block_reduce<true>(red_v[k], scratch), 1e-8f) / 127.f;
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) ps_row[k] = ps[k];
  }
  for (int s = tid; s < S; s += NT) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int v = __float2int_rn(sc[k * S + s] / ps[k]);
      pq[k * S + s] = (int8_t)max(-127, min(127, v));
    }
  }
  __syncthreads();

  // P.V in int32: each 16-byte V load feeds all K rows of probabilities.
  int acc[K][16];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[k][i] = 0;
  for (int s = rg; s < S; s += RG) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(vb + (size_t)s * D));
    const int8_t* vv = reinterpret_cast<const int8_t*>(&raw);
    int vi[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) vi[i] = vv[i];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int p = pq[k * S + s];
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[k][i] += p * vi[i];
    }
  }
  // Sum over the 8 row groups of this warp (lanes that differ in bits 2-4).
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        acc[k][i] += __shfl_xor_sync(0xffffffffu, acc[k][i], o);
  // The score rows were last read before the __syncthreads above; the
  // reduction ([NT / 32 warps][K][HD] int32) reuses them.
  int* red = reinterpret_cast<int*>(smem);
  const int warp = tid >> 5;
  if ((tid & 31) < 4) {
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int i = 0; i < 16; ++i) red[(warp * K + k) * HD + part * 16 + i] = acc[k][i];
  }
  __syncthreads();
  for (int j = tid; j < K * HD; j += NT) {
    const int k = j / HD, c = j % HD;
    int o = 0;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) o += red[(w * K + k) * HD + c];
    out[((size_t)b * K + k) * D + h * HD + c] = __float2bfloat16_rn((float)o * ps_row[k]);
  }
}

template <int K>
int launch_s8(const void* qq, const void* qs, const void* kq, const void* ks,
              const void* vq, const void* vs, void* out, int B, int S_pad, int D,
              int n_heads, int layer, size_t smem, cudaStream_t stream) {
  auto kernel = cross_decode_s8_kernel<K>;
  if (smem > 48 * 1024 - 64 * sizeof(float)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(n_heads, B);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const int8_t*>(qq), static_cast<const float*>(qs),
      static_cast<const int8_t*>(kq), static_cast<const float*>(ks),
      static_cast<const int8_t*>(vq), static_cast<const float*>(vs),
      static_cast<__nv_bfloat16*>(out), B, S_pad, D, n_heads, layer);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sar_cross_decode_s8(const void* qq, const void* qs, const void* kq,
                                   const void* ks, const void* vq, const void* vs,
                                   void* out, int L, int B, int K, int S_pad, int D,
                                   int n_heads, int layer, int device, void* stream) {
  // K rows of S_pad fp32 scores (reused by the [8 warps][K][64] int32
  // reduction) and K rows of S_pad s8 probabilities.
  const size_t smem =
      (size_t)K * (S_pad > 8 * HD ? S_pad : 8 * HD) * sizeof(float) + (size_t)K * S_pad;
  if (D != n_heads * HD || S_pad % RG != 0 || S_pad < RG || layer < 0 ||
      layer >= L || B < 1 || B > 65535 || smem > 232448 - 64 * sizeof(float))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: return launch_s8<1>(qq, qs, kq, ks, vq, vs, out, B, S_pad, D, n_heads, layer, smem, st);
    case 2: return launch_s8<2>(qq, qs, kq, ks, vq, vs, out, B, S_pad, D, n_heads, layer, smem, st);
    case 3: return launch_s8<3>(qq, qs, kq, ks, vq, vs, out, B, S_pad, D, n_heads, layer, smem, st);
    case 4: return launch_s8<4>(qq, qs, kq, ks, vq, vs, out, B, S_pad, D, n_heads, layer, smem, st);
    case 5: return launch_s8<5>(qq, qs, kq, ks, vq, vs, out, B, S_pad, D, n_heads, layer, smem, st);
    case 6: return launch_s8<6>(qq, qs, kq, ks, vq, vs, out, B, S_pad, D, n_heads, layer, smem, st);
    case 7: return launch_s8<7>(qq, qs, kq, ks, vq, vs, out, B, S_pad, D, n_heads, layer, smem, st);
    case 8: return launch_s8<8>(qq, qs, kq, ks, vq, vs, out, B, S_pad, D, n_heads, layer, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
