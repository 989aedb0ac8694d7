// Encoder self-attention on the head-minor residual layout (kernel K1), and
// K8 (pre-LN + q/k/v projections feeding K1's attention, below).
//
// Replaces sar_tpu/ops/flash_enc.py::encoder_attention_hm (Pallas `_kernel`).
// Computes, per sample b and head h, non-causal attention of q/k/v
// [B, T_pad, H*64] bf16 (q pre-scaled by 64^-0.5) read straight from the
// residual-stream layout (row stride D, head h at columns 64h..64h+63), key
// columns >= t_valid masked, softmax in fp32 normalised after the PV product,
// output bf16 in the same layout. Query rows >= t_valid are computed like
// any other row: the caller slices them off.
//
// Bound on the H100: FLOPs. At whisper-small B=8 (T_pad 1536, 12 heads) one
// layer is 4*B*H*T^2*64 = 58 GFLOP against 4*B*T*D*2 = 75 MB of traffic.
// Design: one block per (64-row query tile, head, sample). The query tile
// stays in shared memory; 32-key K/V tiles stream through shared memory with
// an online (running max / running sum) softmax, so the [T, T] score matrix
// never exists and each K/V tile is read once per query tile. The 64-column
// head slice is read with the row stride D, so there is no transpose around
// the kernel. The 128-lane head pairs of the TPU kernel are not carried
// over: a block owns exactly one head. This first version multiplies on the
// fp32 CUDA cores (register-tiled 2x4 scores and 2x8 outputs per thread);
// moving the two products onto the tensor cores (mma.sync / wgmma) is the
// next step for speed.
#include "common.cuh"

namespace {

constexpr int HD = 64;   // head_dim (every Whisper size ships 64)
constexpr int BQ = 64;   // query rows per block
constexpr int BK = 32;   // keys per shared-memory tile
constexpr int NT = 256;  // 32 row pairs x 8 key (or column) groups

__global__ void __launch_bounds__(NT)
encoder_attention_hm_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ o,
                            int T, int D, int t_valid) {
  __shared__ float qs[BQ][HD + 1];
  __shared__ float ks[BK][HD + 1];
  __shared__ __align__(16) float vs[BK][HD];
  __shared__ float ps[BQ][BK + 1];

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t base = (size_t)b * T * D + (size_t)h * HD;  // [b, 0, 64h]

  for (int c = tid; c < BQ * HD / 8; c += NT) {
    const int r = c / (HD / 8), col = (c % (HD / 8)) * 8;
    float f[8];
    sar::load_bf16x8(q + base + (size_t)(q0 + r) * D + col, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) qs[r][col + i] = f[i];
  }

  const int rp = tid >> 3;  // this thread's rows: 2rp, 2rp+1
  const int g = tid & 7;    // keys 4g..4g+3 of a tile; output columns 8g..8g+7
  float m[2] = {-INFINITY, -INFINITY};  // running row max
  float l[2] = {0.f, 0.f};              // running row sum of exp
  float acc[2][8] = {};

  const int n_tiles = (t_valid + BK - 1) / BK;  // tiles past t_valid: all masked
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // previous tile consumed (and the q tile written)
    {
      const int r = tid / (HD / 8), col = (tid % (HD / 8)) * 8;  // 32 x 8 chunks
      float f[8];
      sar::load_bf16x8(k + base + (size_t)(k0 + r) * D + col, f);
#pragma unroll
      for (int i = 0; i < 8; ++i) ks[r][col + i] = f[i];
      sar::load_bf16x8(v + base + (size_t)(k0 + r) * D + col, f);
#pragma unroll
      for (int i = 0; i < 8; ++i) vs[r][col + i] = f[i];
    }
    __syncthreads();

    float s[2][4] = {};
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float a0 = qs[2 * rp][d], a1 = qs[2 * rp + 1][d];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float kv = ks[4 * g + j][d];
        s[0][j] = fmaf(a0, kv, s[0][j]);
        s[1][j] = fmaf(a1, kv, s[1][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (k0 + 4 * g + j >= t_valid) s[i][j] = sar::kNeg;
        mt = fmaxf(mt, s[i][j]);
      }
      mt = sar::group_max<8>(mt);  // the 8 lanes sharing these rows
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[2 * rp + i][4 * g + j] = p;
        ls += p;
      }
      l[i] = l[i] * alpha + sar::group_sum<8>(ls);
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float p0 = ps[2 * rp][kk], p1 = ps[2 * rp + 1][kk];
      const float4 va = *reinterpret_cast<const float4*>(&vs[kk][8 * g]);
      const float4 vb = *reinterpret_cast<const float4*>(&vs[kk][8 * g + 4]);
      const float vv[8] = {va.x, va.y, va.z, va.w, vb.x, vb.y, vb.z, vb.w};
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        acc[0][c] = fmaf(p0, vv[c], acc[0][c]);
        acc[1][c] = fmaf(p1, vv[c], acc[1][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float inv = 1.f / l[i];
    float out[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) out[c] = acc[i][c] * inv;
    sar::store_bf16x8(o + base + (size_t)(q0 + 2 * rp + i) * D + 8 * g, out);
  }
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
// tile (x stays in L2). Tensor-core products (wgmma), TMA staging and
// keeping K/V on chip across the attention are left for later.
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
// caller's qkv scratch [3, B, T_pad, D], then K1's attention kernel over it
// into o [B, T_pad, D] (the TPU kernel's attention arithmetic exactly).
extern "C" int sar_encoder_attention_fused(
    const void* x, const void* ln_scale, const void* ln_bias, const void* wq,
    const void* bq, const void* wk, const void* wv, const void* bv, void* qkv,
    void* o, int B, int T, int D, int n_heads, int t_valid, int device, void* stream) {
  if (D != n_heads * HD || D % PT != 0 || T % PT != 0 || T % BQ != 0 || t_valid < 1 ||
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
  const dim3 agrid(T / BQ, n_heads, B);
  encoder_attention_hm_kernel<<<agrid, NT, 0, st>>>(q, q + plane, q + 2 * plane,
                                                    static_cast<__nv_bfloat16*>(o), T, D,
                                                    t_valid);
  return (int)cudaGetLastError();
}

extern "C" int sar_encoder_attention_hm(const void* q, const void* k,
                                        const void* v, void* o, int B, int T,
                                        int D, int n_heads, int t_valid,
                                        int device, void* stream) {
  if (D != n_heads * HD || T % BQ != 0 || t_valid < 1 || t_valid > T ||
      B < 1 || B > 65535 || n_heads > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(T / BQ, n_heads, B);
  encoder_attention_hm_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), T, D,
      t_valid);
  return (int)cudaGetLastError();
}
