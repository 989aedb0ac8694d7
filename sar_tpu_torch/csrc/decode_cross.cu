// One decode step of cross-attention over the int8 head-minor cache: K3
// (greedy, below) and K5 (beam-folded, after it).
//
// Replaces sar_tpu/ops/decode_cross.py::cross_decode_attention_exact for
// beam_width 1 (Pallas `_kernel_exact`). Per sample b and head h, over layer
// `layer`'s slab of the FULL stacked cache (kq/vq [L, B, S_pad, H*64] s8,
// ks/vs [L, B, H, S_pad] f32): scores_s = (q . k_s) * ks_s with q bf16 and
// k_s dequantized exactly (int8 -> float), masked where ks_s <= 0 (layout
// padding carries scale 0; real rows have scale >= 1e-8/127), softmax in
// fp32, pw_s = bf16(p_s * vs_s), out = sum_s pw_s * v_s accumulated in fp32
// and stored bf16 [B, H*64]. q and the probabilities are never quantized.
//
// Bound on the H100: bytes of the int8 slab. At whisper-small B=8 one call
// reads 2*B*S_pad*D = 18.9 MB of kq/vq (plus 0.8 MB of scales) for
// 4*B*S_pad*D = 38 MFLOP — about 0.5 FLOP/byte, far below the card's
// ~295 FLOP/byte ridge. Design: one block per (head, sample) streams its
// head's 64-byte rows of the slab (row stride D) with 16-byte loads, four
// threads per row; the layer is an offset into the stacked cache, so no
// per-step slice or copy exists. Scores live in shared memory (S_pad
// floats), the softmax is two block reductions, and the PV pass reads the
// V rows the same way, reducing the 64 row groups through shared memory.
// Each byte of the slab is read exactly once per step.
#include "common.cuh"

namespace {

constexpr int HD = 64;        // head_dim
constexpr int NT = 256;       // threads per block
constexpr int RG = NT / 4;    // row groups: 4 threads x 16 int8 columns per row

__global__ void __launch_bounds__(NT)
cross_decode_exact_kernel(const __nv_bfloat16* __restrict__ q,  // [B, D]
                          const int8_t* __restrict__ kq,        // [L, B, S, D]
                          const float* __restrict__ ks,         // [L, B, H, S]
                          const int8_t* __restrict__ vq,
                          const float* __restrict__ vs,
                          __nv_bfloat16* __restrict__ out,      // [B, D]
                          int B, int S, int D, int H, int layer) {
  extern __shared__ float smem[];
  float* sc = smem;       // [S] scores, then weighted probabilities
  float* red = smem + S;  // [RG][HD] partial outputs
  __shared__ float scratch[32];

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

  float qf[16];
  sar::load_bf16x8(q + (size_t)b * D + h * HD + part * 16, qf);
  sar::load_bf16x8(q + (size_t)b * D + h * HD + part * 16 + 8, qf + 8);

  float mloc = -INFINITY;
  for (int s = rg; s < S; s += RG) {  // S % RG == 0: no lane leaves early
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(kb + (size_t)s * D));
    const int8_t* kv = reinterpret_cast<const int8_t*>(&raw);
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) dot = fmaf(qf[i], (float)kv[i], dot);
    dot = sar::group_sum<4>(dot);
    const float kscale = ksb[s];
    const float score = kscale > 0.f ? dot * kscale : sar::kNeg;
    if (part == 0) sc[s] = score;
    mloc = fmaxf(mloc, score);
  }
  const float m = sar::block_reduce<true>(mloc, scratch);

  float lsum = 0.f;
  for (int s = tid; s < S; s += NT) {
    const float e = expf(sc[s] - m);
    sc[s] = e;
    lsum += e;
  }
  const float sum = sar::block_reduce<false>(lsum, scratch);
  for (int s = tid; s < S; s += NT) sc[s] = sar::bf16_round((sc[s] / sum) * vsb[s]);
  __syncthreads();

  float acc[16] = {};
  for (int s = rg; s < S; s += RG) {
    const float pw = sc[s];
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(vb + (size_t)s * D));
    const int8_t* vv = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = fmaf(pw, (float)vv[i], acc[i]);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) red[rg * HD + part * 16 + i] = acc[i];
  __syncthreads();
  if (tid < HD) {
    float o = 0.f;
    for (int r = 0; r < RG; ++r) o += red[r * HD + tid];
    out[(size_t)b * D + h * HD + tid] = __float2bfloat16_rn(o);
  }
}

// K5: the beam-folded twin of K3 (Pallas `_kernel_exact` with beam_width
// K > 1). q [B, K, D] holds the K beam queries of each sample; the cache
// holds ONE slab per sample, shared by its beams. Same math per (b, k, h)
// as K3. Bound: the same bytes as K3 (the slab is read once for all K
// beams; without the fold a K=4 beam would read 4x), with 4x K3's FLOPs,
// still ~2 FLOP/byte. Design: K3's block per (head, sample) and K3's
// loads; each 16-byte load of a K or V row feeds all K queries, so a
// thread holds K x 16 fp32 q values in the score pass and K x 16
// accumulators in the PV pass. Scores sit in dynamic shared memory
// ([K][S] floats, 24.6 KB at K=4, S_pad=1536; above 48 KB the wrapper
// raises the block's limit). The PV partials are summed over the 8 row
// groups of a warp with shuffles, then over the 8 warps through shared
// memory that reuses the score rows ([8][K][64] floats).
template <int K>
__global__ void __launch_bounds__(NT)
cross_decode_exact_beam_kernel(const __nv_bfloat16* __restrict__ q,  // [B, K, D]
                               const int8_t* __restrict__ kq,        // [L, B, S, D]
                               const float* __restrict__ ks,         // [L, B, H, S]
                               const int8_t* __restrict__ vq,
                               const float* __restrict__ vs,
                               __nv_bfloat16* __restrict__ out,      // [B, K, D]
                               int B, int S, int D, int H, int layer) {
  extern __shared__ float smem[];
  float* sc = smem;  // [K][S] scores, then weighted probabilities
  __shared__ float scratch[32];

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int part = tid & 3;
  const int rg = tid >> 2;
  const size_t plane = (size_t)layer * B + b;
  const int8_t* kb = kq + plane * S * D + h * HD + part * 16;
  const int8_t* vb = vq + plane * S * D + h * HD + part * 16;
  const float* ksb = ks + (plane * H + h) * S;
  const float* vsb = vs + (plane * H + h) * S;

  float m[K], tot[K];
  {
    float qf[K][16];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const __nv_bfloat16* qk = q + ((size_t)b * K + k) * D + h * HD + part * 16;
      sar::load_bf16x8(qk, qf[k]);
      sar::load_bf16x8(qk + 8, qf[k] + 8);
      m[k] = -INFINITY;
    }
    for (int s = rg; s < S; s += RG) {  // S % RG == 0: no lane leaves early
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(kb + (size_t)s * D));
      const int8_t* kv = reinterpret_cast<const int8_t*>(&raw);
      float kf[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) kf[i] = (float)kv[i];
      const float kscale = ksb[s];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < 16; ++i) dot = fmaf(qf[k][i], kf[i], dot);
        dot = sar::group_sum<4>(dot);
        const float score = kscale > 0.f ? dot * kscale : sar::kNeg;
        if ((k & 3) == part) sc[k * S + s] = score;
        m[k] = fmaxf(m[k], score);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) m[k] = sar::block_reduce<true>(m[k], scratch);

  float lsum[K];
#pragma unroll
  for (int k = 0; k < K; ++k) lsum[k] = 0.f;
  for (int s = tid; s < S; s += NT) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float e = expf(sc[k * S + s] - m[k]);
      sc[k * S + s] = e;
      lsum[k] += e;
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) tot[k] = sar::block_reduce<false>(lsum[k], scratch);
  for (int s = tid; s < S; s += NT) {
    const float vscale = vsb[s];
#pragma unroll
    for (int k = 0; k < K; ++k)
      sc[k * S + s] = sar::bf16_round((sc[k * S + s] / tot[k]) * vscale);
  }
  __syncthreads();

  float acc[K][16];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[k][i] = 0.f;
  for (int s = rg; s < S; s += RG) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(vb + (size_t)s * D));
    const int8_t* vv = reinterpret_cast<const int8_t*>(&raw);
    float vf[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) vf[i] = (float)vv[i];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float pw = sc[k * S + s];
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[k][i] = fmaf(pw, vf[i], acc[k][i]);
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
  __syncthreads();  // every thread has read its last probability
  float* red = smem;  // [NT / 32 warps][K][HD]
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
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) o += red[(w * K + k) * HD + c];
    out[((size_t)b * K + k) * D + h * HD + c] = __float2bfloat16_rn(o);
  }
}

template <int K>
int launch_beam(const void* q, const void* kq, const void* ks, const void* vq,
                const void* vs, void* out, int B, int S_pad, int D, int n_heads,
                int layer, size_t smem, cudaStream_t stream) {
  auto kernel = cross_decode_exact_beam_kernel<K>;
  if (smem > 48 * 1024 - 32 * sizeof(float)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(n_heads, B);
  cross_decode_exact_beam_kernel<K><<<grid, NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(kq),
      static_cast<const float*>(ks), static_cast<const int8_t*>(vq),
      static_cast<const float*>(vs), static_cast<__nv_bfloat16*>(out), B, S_pad, D,
      n_heads, layer);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sar_cross_decode_exact_beam(const void* q, const void* kq, const void* ks,
                                           const void* vq, const void* vs, void* out,
                                           int L, int B, int K, int S_pad, int D,
                                           int n_heads, int layer, int device,
                                           void* stream) {
  // K rows of S_pad scores, reused by the [8 warps][K][64] reduction.
  const size_t smem = (size_t)K * (S_pad > 8 * HD ? S_pad : 8 * HD) * sizeof(float);
  if (D != n_heads * HD || S_pad % RG != 0 || S_pad < RG || layer < 0 ||
      layer >= L || B < 1 || B > 65535 || smem > 232448 - 32 * sizeof(float))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 2: return launch_beam<2>(q, kq, ks, vq, vs, out, B, S_pad, D, n_heads, layer, smem, st);
    case 3: return launch_beam<3>(q, kq, ks, vq, vs, out, B, S_pad, D, n_heads, layer, smem, st);
    case 4: return launch_beam<4>(q, kq, ks, vq, vs, out, B, S_pad, D, n_heads, layer, smem, st);
    case 5: return launch_beam<5>(q, kq, ks, vq, vs, out, B, S_pad, D, n_heads, layer, smem, st);
    case 6: return launch_beam<6>(q, kq, ks, vq, vs, out, B, S_pad, D, n_heads, layer, smem, st);
    case 7: return launch_beam<7>(q, kq, ks, vq, vs, out, B, S_pad, D, n_heads, layer, smem, st);
    case 8: return launch_beam<8>(q, kq, ks, vq, vs, out, B, S_pad, D, n_heads, layer, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int sar_cross_decode_exact(const void* q, const void* kq, const void* ks,
                                      const void* vq, const void* vs, void* out,
                                      int L, int B, int S_pad, int D, int n_heads,
                                      int layer, int device, void* stream) {
  const size_t smem = (size_t)(S_pad + RG * HD) * sizeof(float);
  if (D != n_heads * HD || S_pad % RG != 0 || S_pad < RG || layer < 0 ||
      layer >= L || B < 1 || B > 65535 || smem > 48 * 1024 - 32 * sizeof(float))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_heads, B);
  cross_decode_exact_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(kq),
      static_cast<const float*>(ks), static_cast<const int8_t*>(vq),
      static_cast<const float*>(vs), static_cast<__nv_bfloat16*>(out), B, S_pad, D,
      n_heads, layer);
  return (int)cudaGetLastError();
}
