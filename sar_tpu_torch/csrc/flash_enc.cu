// Encoder attention on the head-minor residual layout: K1's entry point,
// and K8 (pre-LN + q/k/v projections feeding K1's attention, below).
//
// K1 replaces sar_tpu/ops/flash_enc.py::encoder_attention_hm (Pallas
// `_kernel`): per sample b and head h, non-causal attention of q/k/v
// [B, T_pad, H*64] bf16 (q pre-scaled by 64^-0.5) read straight from the
// residual-stream layout (row stride D, head h at columns 64h..64h+63), key
// columns >= t_valid masked, the unnormalised probabilities rounded to bf16
// for the PV product (as the TPU kernel's `p.astype(qg.dtype)`), softmax in
// fp32 normalised after the PV product, output bf16 in the same layout.
// Query rows >= t_valid are computed like any other row: the caller slices
// them off. It is the tensor-core forward kernel of flash_attn.cu over
// [B, H, T_pad, 64] views of the layout (strides (T_pad*D, 64, D)) with
// Tq = T_pad, Tk = t_valid and no log-sum-exp; the bound and the design are
// described there. The 128-lane head pairs of the TPU kernel are not
// carried over: a block owns one head.
#include "flash_attn.cuh"

namespace {

constexpr int HD = 64;  // head_dim (every Whisper size ships 64)

// K1's attention over q/k/v/o [B, T, n_heads*64] (the layout above).
cudaError_t launch_attention_hm(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                const __nv_bfloat16* v, __nv_bfloat16* o, int B,
                                int T, int D, int n_heads, int t_valid,
                                int device, cudaStream_t stream) {
  sar::FwdParams p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = nullptr;
  p.lq = p.lk = p.lv = p.lo = sar::Layout{(long long)T * D, HD, D};
  p.H = n_heads;
  p.Tq = T;
  p.Tk = t_valid;
  p.causal = 0;
  return sar::flash_fwd_launch(p, B, device, stream);
}

// K8, first launch: the pre-LN + q/k/v projection half of
// sar_tpu/ops/flash_enc.py::encoder_attention_fused (Pallas `_fused_kernel`).
// Per row of x [B, T_pad, D] bf16: mean and the one-pass variance
// mean(x^2) - mean^2 in fp32 (no clamp, as the TPU kernel), then
// h = bf16((x - mean) / sqrt(var + eps) * ln_scale + ln_bias); per output
// column, y = sum_k h_k W[k, col] in fp32 from the bf16 h and W, plus the
// bias (q, v), times hd^-0.5 (q), rounded to bf16 once, into
// qkv [3, B, T_pad, D] (q, k, v planes).
//
// Bound on the H100: FLOPs, 6*B*T*D^2 = 43 GFLOP at whisper-small B=8,
// against 19 MB of x and 3.5 MB of weights. Design: one block per (64-column
// tile of the 3*D outputs, 64-row tile, sample). The block computes its 64
// rows' LN statistics itself (one warp per 8 rows), so h never exists in
// global memory: each 32-wide k slice of the row tile is normalised while it
// is staged into shared memory, beside the matching 32 x 64 slice of W, and
// each thread accumulates a 4 x 4 register tile on the fp32 CUDA cores. The
// statistics are recomputed by each of the 3*D/64 column tiles of a row
// tile (x stays in L2). Tensor-core products, TMA staging and keeping K/V
// on chip across the attention are left for later.
constexpr int PT = 64;    // rows and columns of a projection tile
constexpr int PK = 32;    // k slice staged per step
constexpr int PNT = 256;  // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(PNT)
encoder_ln_qkv_kernel(const __nv_bfloat16* __restrict__ x,
                      const float* __restrict__ ln_scale,
                      const float* __restrict__ ln_bias,
                      const __nv_bfloat16* __restrict__ wq,
                      const __nv_bfloat16* __restrict__ bq,
                      const __nv_bfloat16* __restrict__ wk,
                      const __nv_bfloat16* __restrict__ wv,
                      const __nv_bfloat16* __restrict__ bv,
                      __nv_bfloat16* __restrict__ qkv, int B, int T, int D) {
  __shared__ float mu_s[PT], rstd_s[PT];
  __shared__ __align__(16) float hs[PK][PT];  // h^T: k-major, rows minor
  __shared__ __align__(16) float ws[PK][PT];  // W slice: k-major, columns minor

  const int tid = threadIdx.x;
  const int tiles_per_plane = D / PT;
  const int which = blockIdx.x / tiles_per_plane;  // 0 q, 1 k, 2 v
  const int col0 = (blockIdx.x % tiles_per_plane) * PT;
  const int r0 = blockIdx.y * PT;
  const int b = blockIdx.z;
  const __nv_bfloat16* xb = x + ((size_t)b * T + r0) * D;
  const __nv_bfloat16* w = which == 0 ? wq : which == 1 ? wk : wv;

  // LayerNorm statistics: warp `warp` owns rows 8*warp .. 8*warp+7.
  {
    const int lane = tid & 31, warp = tid >> 5;
    for (int i = 0; i < PT / (PNT / 32); ++i) {
      const int r = warp * (PT / (PNT / 32)) + i;
      float s = 0.f, ss = 0.f;
      for (int c = lane * 8; c < D; c += 32 * 8) {
        float f[8];
        sar::load_bf16x8(xb + (size_t)r * D + c, f);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s += f[j];
          ss = fmaf(f[j], f[j], ss);
        }
      }
      s = sar::group_sum<32>(s);
      ss = sar::group_sum<32>(ss);
      if (lane == 0) {
        const float mean = s / (float)D;
        const float var = ss / (float)D - mean * mean;
        mu_s[r] = mean;
        rstd_s[r] = 1.f / sqrtf(var + 1e-5f);
      }
    }
  }

  const int tx = tid & 15;  // output columns 4tx .. 4tx+3
  const int ty = tid >> 4;  // output rows 4ty .. 4ty+3
  float acc[4][4] = {};
  // Staging: x chunk (row sr, k 8sc..8sc+7) and W chunk (k wr, cols 8wc..).
  const int sr = tid >> 2, sc = tid & 3;
  const int wr = tid >> 3, wc = tid & 7;
  for (int k0 = 0; k0 < D; k0 += PK) {
    __syncthreads();  // statistics written / previous slice consumed
    {
      float f[8];
      sar::load_bf16x8(xb + (size_t)sr * D + k0 + 8 * sc, f);
      const float m = mu_s[sr], rs = rstd_s[sr];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kk = 8 * sc + j;
        hs[kk][sr] = sar::bf16_round((f[j] - m) * rs * ln_scale[k0 + kk] + ln_bias[k0 + kk]);
      }
      sar::load_bf16x8(w + (size_t)(k0 + wr) * D + col0 + 8 * wc, f);
#pragma unroll
      for (int j = 0; j < 8; ++j) ws[wr][8 * wc + j] = f[j];
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < PK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&hs[kk][4 * ty]);
      const float4 bw = *reinterpret_cast<const float4*>(&ws[kk][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv4[4] = {bw.x, bw.y, bw.z, bw.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv4[j], acc[i][j]);
    }
  }

  const __nv_bfloat16* bias = which == 0 ? bq : which == 2 ? bv : nullptr;
  float bb[4] = {0.f, 0.f, 0.f, 0.f};
  if (bias != nullptr) {
#pragma unroll
    for (int j = 0; j < 4; ++j) bb[j] = __bfloat162float(bias[col0 + 4 * tx + j]);
  }
  const float scaling = which == 0 ? 0.125f : 1.f;  // 64^-0.5 for q
  __nv_bfloat16* out = qkv + (((size_t)which * B + b) * T + r0) * D + col0 + 4 * tx;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint2 raw;
    __nv_bfloat162* pair = reinterpret_cast<__nv_bfloat162*>(&raw);
    pair[0] = __floats2bfloat162_rn((acc[i][0] + bb[0]) * scaling, (acc[i][1] + bb[1]) * scaling);
    pair[1] = __floats2bfloat162_rn((acc[i][2] + bb[2]) * scaling, (acc[i][3] + bb[3]) * scaling);
    *reinterpret_cast<uint2*>(out + (size_t)(4 * ty + i) * D) = raw;
  }
}

}  // namespace

// K8: replaces sar_tpu/ops/flash_enc.py::encoder_attention_fused. Two
// launches on one stream: the LN + projection kernel above into the
// caller's qkv scratch [3, B, T_pad, D], then K1's attention (the forward
// kernel of flash_attn.cu) over it into o [B, T_pad, D] (the TPU kernel's
// attention arithmetic exactly).
extern "C" int sar_encoder_attention_fused(
    const void* x, const void* ln_scale, const void* ln_bias, const void* wq,
    const void* bq, const void* wk, const void* wv, const void* bv, void* qkv,
    void* o, int B, int T, int D, int n_heads, int t_valid, int device, void* stream) {
  if (D != n_heads * HD || D % PT != 0 || T % PT != 0 || t_valid < 1 ||
      t_valid > T || B < 1 || B > 65535 || n_heads > 65535 || T / PT > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 pgrid(3 * D / PT, T / PT, B);
  encoder_ln_qkv_kernel<<<pgrid, PNT, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<const __nv_bfloat16*>(wq),
      static_cast<const __nv_bfloat16*>(bq), static_cast<const __nv_bfloat16*>(wk),
      static_cast<const __nv_bfloat16*>(wv), static_cast<const __nv_bfloat16*>(bv),
      static_cast<__nv_bfloat16*>(qkv), B, T, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(qkv);
  const size_t plane = (size_t)B * T * D;
  return (int)launch_attention_hm(q, q + plane, q + 2 * plane,
                                  static_cast<__nv_bfloat16*>(o), B, T, D,
                                  n_heads, t_valid, device, st);
}

extern "C" int sar_encoder_attention_hm(const void* q, const void* k,
                                        const void* v, void* o, int B, int T,
                                        int D, int n_heads, int t_valid,
                                        int device, void* stream) {
  if (D != n_heads * HD || T < 1 || t_valid < 1 || t_valid > T || B < 1 ||
      B > 65535 || n_heads > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_attention_hm(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), B,
      T, D, n_heads, t_valid, device, static_cast<cudaStream_t>(stream));
}
