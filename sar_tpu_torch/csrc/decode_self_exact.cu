// K11: one decode step of self-attention over the classic int8 self cache
// (greedy and reordered-beam rows, q [B, H, 1, 64]).
//
// Replaces no TPU kernel: the JAX package's self path is plain jnp
// (sar_tpu/models/whisper.py::_attention_int8), and so was the port's
// (sar_tpu_torch/models/whisper.py::_attention_int8, which stays as this
// kernel's plain version). That plain path upcast the layer's first
// self_len int8 K and V rows to fp32 on every step (a strided copy of
// 4 bytes written per byte read), ran two fp32 batched GEMVs over the
// copies and some eight small elementwise passes: at whisper-small B=128
// the largest device cost of a decode step after K3's cross-attention.
//
// Per sample b and head h, over layer `layer` of the FULL stacked cache
// (kq/vq [L, B, H, T, 64] s8, ks/vs [L, B, H, T] f32; nothing is sliced or
// copied per step, so the pointers stay fixed for CUDA-graph capture), the
// function and rounding points of _attention_int8 with the position mask:
//   score_t = (fp32(q) . fp32(kq_t)) * ks_t  for t <= pos, q bf16 (pre-scaled);
//   p_t = exp(score_t - max) / sum over t <= pos (fp32 softmax);
//   pw_t = bf16(p_t * vs_t);  out = bf16(sum_t pw_t * vq_t), summed in fp32.
// The rows pos < t < self_len that the plain path masks carry a weight of
// exp(finfo.min - max) = 0 exactly in fp32, so the kernel does not read
// them: the same result from fewer bytes. A scale of 0 is no mask here (a
// row of zeros scores 0), unlike the cross kernels' layout padding.
//
// Bound on the H100: bytes. A call reads, per (b, h), rows 0..pos of K and
// V (64 int8 each) and their two fp32 scales, 136 (pos + 1) bytes, plus q
// and out: at whisper-small B=128 and pos = 113 (the mean over a 224-token
// batch), 23.8 MB, 7.1 us at 3.35 TB/s, for 4 * 64 FLOPs per row (~2 FLOP
// per byte, far below the tensor cores' line: the products run on the CUDA
// cores). Design:
//   - one block of 128 threads per (head, sample): 1536 blocks at
//     whisper-small B=128, 1280 at large-v3-turbo B=64, 96 at B=8. A block
//     moves 15.5 KB at the mean pos, so up to 8 blocks an SM keep well over
//     the ~25 KB per SM that the card's latency needs in flight;
//   - the V rows and their scales go to shared memory first with 16-byte
//     (4-byte) cp.async copies, all issued at once, so they land while the
//     scores are computed; the block's V is at most 28 KB (pos = 447), and
//     its shared memory (V, scores, V scales) stays under the 48 KB that
//     needs no opt-in;
//   - the K rows are read straight into registers, four threads of 16
//     bytes a row (a warp reads 8 whole contiguous rows, 512 bytes), U
//     rows a thread in flight, each row's dot product summed over its
//     four lanes by two shuffles;
//   - the scores sit in shared memory; a block-wide max and sum, then each
//     row's pw is rounded to bf16 in place; P.V reads V from shared memory
//     into fp32 [16] partials per thread (rows strided by 32), summed over
//     the warp's row groups by shuffles and over the 4 warps in a fixed
//     order. One launch, no atomics: the same bits on every run.
#include "mma.cuh"

namespace {

constexpr int HD = 64;          // head_dim
constexpr int NT = 128;         // threads per block
constexpr int NW = NT / 32;
constexpr int TPR = 4;          // threads per row of 64 int8
constexpr int EPT = HD / TPR;   // int8 a thread reads of a row (16 bytes)
constexpr int RG = NT / TPR;    // rows per pass
constexpr int U = 4;            // k rows a thread has in flight
constexpr int MAX_LEN = 448;    // the self cache's rows (Whisper's max_target_positions)

// V rows (int8), then the fp32 scores and V scales of `rows` rows.
__host__ __device__ constexpr int dynamic_smem_bytes(int rows) {
  return rows * HD + 2 * 4 * rows;
}
static_assert(dynamic_smem_bytes(MAX_LEN) <= 48 * 1024, "no opt-in needed");

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  sar::cp_async16(static_cast<__nv_bfloat16*>(dst),
                  static_cast<const __nv_bfloat16*>(src), true);
}

__global__ void __launch_bounds__(NT)
self_decode_exact_kernel(const __nv_bfloat16* __restrict__ q,  // [B, H * 64]
                         const int8_t* __restrict__ kq,        // [L, B, H, T, 64]
                         const float* __restrict__ ks,         // [L, B, H, T]
                         const int8_t* __restrict__ vq,
                         const float* __restrict__ vs,
                         __nv_bfloat16* __restrict__ out,      // [B, H * 64]
                         int B, int H, int T, int layer, int pos) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows = pos + 1;
  int8_t* vsm = reinterpret_cast<int8_t*>(smem_raw);           // [rows][64]
  float* sc = reinterpret_cast<float*>(smem_raw + rows * HD);  // [rows]
  float* vsc = sc + rows;                                      // [rows]
  __shared__ float scratch[32];
  __shared__ float red[NW][HD];  // the warps' P.V partials

  const int tid = threadIdx.x;
  const int part = tid % TPR;  // columns EPT*part .. EPT*part+EPT-1 of the head
  const int rg = tid / TPR;
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t plane = ((size_t)layer * B + b) * H + h;
  const int8_t* kb = kq + plane * T * HD;
  const int8_t* vb = vq + plane * T * HD;
  const float* ksb = ks + plane * T;
  const float* vsb = vs + plane * T;

  // One group: rows 0..pos of V (contiguous) and their scales.
  for (int i = tid; i < rows * (HD / 16); i += NT) cp_async16(vsm + i * 16, vb + i * 16);
  for (int i = tid; i < rows; i += NT) sar::cp_async4(vsc + i, vsb + i, true);
  sar::cp_async_commit();

  const __nv_bfloat16* qb = q + ((size_t)b * H + h) * HD + part * EPT;
  float qf[EPT];
  sar::load_bf16x8(qb, qf);
  sar::load_bf16x8(qb + 8, qf + 8);

  // Scores of rows 0..pos; r0 is the same in every thread, so every lane
  // takes part in the shuffles.
  for (int r0 = 0; r0 < rows; r0 += U * RG) {
    uint4 raw[U];
    float kscale[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u * RG + rg;
      raw[u] = r < rows ? __ldg(reinterpret_cast<const uint4*>(kb + (size_t)r * HD + part * EPT))
                        : make_uint4(0u, 0u, 0u, 0u);
      kscale[u] = r < rows ? __ldg(ksb + r) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u * RG + rg;
      const int8_t* kv = reinterpret_cast<const int8_t*>(&raw[u]);
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < EPT; ++e) d = fmaf(qf[e], (float)kv[e], d);
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      if (part == 0 && r < rows) sc[r] = d * kscale[u];
    }
  }
  __syncthreads();

  float m = -INFINITY;
  for (int i = tid; i < rows; i += NT) m = fmaxf(m, sc[i]);
  m = sar::block_reduce<true>(m, scratch);
  float l = 0.f;
  for (int i = tid; i < rows; i += NT) l += expf(sc[i] - m);
  l = sar::block_reduce<false>(l, scratch);
  sar::cp_async_wait<0>();  // V and its scales landed (this thread's copies)
  __syncthreads();          // ... every thread's
  for (int i = tid; i < rows; i += NT) sc[i] = sar::bf16_round((expf(sc[i] - m) / l) * vsc[i]);
  __syncthreads();

  float acc[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) acc[e] = 0.f;
  for (int r = rg; r < rows; r += RG) {
    const uint4 c = *reinterpret_cast<const uint4*>(vsm + r * HD + part * EPT);
    const int8_t* vv = reinterpret_cast<const int8_t*>(&c);
    const float pw = sc[r];
#pragma unroll
    for (int e = 0; e < EPT; ++e) acc[e] = fmaf(pw, (float)vv[e], acc[e]);
  }
  // Sum over the row groups of this warp (lanes that differ in the bits
  // above TPR), then over the warps in order.
#pragma unroll
  for (int e = 0; e < EPT; ++e)
#pragma unroll
    for (int o = TPR; o < 32; o <<= 1) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  if ((tid & 31) < TPR) {
#pragma unroll
    for (int e = 0; e < EPT; ++e) red[tid >> 5][part * EPT + e] = acc[e];
  }
  __syncthreads();
  if (tid < HD) {
    float o = red[0][tid];
#pragma unroll
    for (int w = 1; w < NW; ++w) o += red[w][tid];
    out[((size_t)b * H + h) * HD + tid] = __float2bfloat16_rn(o);
  }
}

}  // namespace

// q [B, H * 64] bf16, the full stacked self cache kq/vq [L, B, H, T, hd]
// s8 and ks/vs [L, B, H, T] f32, out [B, H * 64] bf16; reads rows 0..pos of
// layer `layer`.
extern "C" int sar_self_decode_exact(const void* q, const void* kq, const void* ks,
                                     const void* vq, const void* vs, void* out, int L,
                                     int B, int H, int T, int hd, int layer, int pos,
                                     int device, void* stream) {
  if (hd != HD || T < 1 || T > MAX_LEN || pos < 0 || pos >= T || layer < 0 || layer >= L ||
      B < 1 || B > 65535 || H < 1 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  self_decode_exact_kernel<<<dim3(H, B), NT, dynamic_smem_bytes(pos + 1),
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(kq),
      static_cast<const float*>(ks), static_cast<const int8_t*>(vq),
      static_cast<const float*>(vs), static_cast<__nv_bfloat16*>(out), B, H, T, layer, pos);
  return (int)cudaGetLastError();
}
