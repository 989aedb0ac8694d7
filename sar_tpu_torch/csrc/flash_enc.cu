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
#include "mma.cuh"

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
// sar_tpu/ops/flash_enc.py::encoder_attention_fused (Pallas `_fused_kernel`,
// its `h_s` LayerNorm and the three projections). Per row of x
// [B, T_pad, D] bf16: mean and the one-pass variance mean(x^2) - mean^2 in
// fp32 (no clamp, as the TPU kernel), then
// h = bf16((x - mean) / sqrt(var + eps) * ln_scale + ln_bias); per output
// column, y = sum_k h_k W[k, col] in fp32 from the bf16 h and W, plus the
// bias (q, v), times hd^-0.5 (q), rounded to bf16 once, into
// qkv [3, B, T_pad, D] (q, k, v planes).
//
// Bound on the H100: operations. It is a [B*T, D] x [D, 3D] product with an
// LN prologue: 6*B*T*D^2 = 42.5 GFLOP at whisper-small B=8 (0.043 ms at
// 989 TFLOP/s) against 19 MB of x, 3.5 MB of weights and the 56.6 MB
// scratch (0.024 ms at 3.35 TB/s). Design, for the tensor cores:
//   - one block of 8 warps per (BM-row tile, sample) keeps its rows' h
//     resident in shared memory, as the TPU kernel's `h_s`: the x tile
//     lands there with 16-byte cp.async copies (x is read from device
//     memory once), each warp computes its rows' statistics once and
//     overwrites them with the bf16 h in place (row stride D + 8, so the 8
//     rows of an ldmatrix phase fall in distinct banks);
//   - the block then walks all 3*D output columns in tiles of BN (a tile
//     never straddles two planes); W, which stays in L2, streams through a
//     cp.async ring of 32 x BN slices, one stage refilled per step;
//   - products with mma.sync m16n8k16 (bf16 operands, fp32 sums): A
//     fragments from the resident h with ldmatrix, B fragments from the
//     [k][n] W slice with ldmatrix.trans (the mma_ab pattern of
//     flash_attn.cu);
//   - the epilogue adds the bias, scales q and rounds once in registers,
//     then a transpose within each quad of lanes gathers 8 adjacent columns
//     per lane for 16-byte stores.
// The tiles (kLnQkvConfigs) were the fastest of the variants timed on an
// H100 at whisper-small and -medium B=8. A block fills an SM's shared memory, so
// one runs per SM; 96-row tiles give 128 blocks for 132 SMs in one wave
// (64 rows: 192 blocks in 1.45 waves; 128 rows: 96 blocks), read W from L2
// two thirds as often as 64-row tiles, and their 48 x 64 warp tiles need
// fewer ldmatrix reads per mma than 32 x 64 ones. Deeper rings, 16 warps
// and a staggered walk over W were slower.
constexpr int kMaxSmem = 232448;  // a block's shared memory on the H100

// A projection configuration: BM rows of h resident per block, output
// columns in tiles of BN, W in BK-row stages through a STAGES-deep ring,
// NW warps as (NW / WC) x WC warp tiles of (BM * WC / NW) x (BN / WC).
struct LnQkvConfig {
  int bm, bn, bk, nw, wc, stages;
};

// In order of preference; the first whose BM divides T_pad, whose BN
// divides D (no tile straddles two of the q/k/v planes) and whose shared
// memory fits is taken (mirrored by ops/flash_enc.py::LN_QKV_CONFIGS).
constexpr LnQkvConfig kLnQkvConfigs[] = {
    {96, 256, 32, 8, 4, 4},  // 48 x 64 warp tiles: whisper-small (D = 768)
    {96, 256, 32, 8, 4, 2},  // 48 x 64: whisper-medium (D = 1024)
    {64, 256, 32, 8, 4, 4},  // 32 x 64
    {64, 128, 32, 8, 4, 4},  // 32 x 32
    {64, 64, 32, 8, 2, 4},   // 16 x 32
};
constexpr int kNumLnQkvConfigs = sizeof(kLnQkvConfigs) / sizeof(kLnQkvConfigs[0]);

// Dynamic shared memory: h [BM][D + 8] and the W ring [STAGES][BK][BN + 8],
// bf16 (the +8 pads put the 8 rows an ldmatrix phase reads in distinct banks).
constexpr int ln_qkv_smem_bytes(const LnQkvConfig& c, int D) {
  return (c.bm * (D + 8) + c.stages * c.bk * (c.bn + 8)) * 2;
}

// The index of the configuration for [T, D], or -1 if none fits.
int ln_qkv_pick(int T, int D) {
  for (int i = 0; i < kNumLnQkvConfigs; ++i) {
    const LnQkvConfig& c = kLnQkvConfigs[i];
    if (T % c.bm == 0 && D % c.bn == 0 && ln_qkv_smem_bytes(c, D) <= kMaxSmem) return i;
  }
  return -1;
}

template <int BM, int BN, int BK, int NW, int WC, int STAGES>
__global__ void __launch_bounds__(NW * 32, 1)
encoder_ln_qkv_kernel(const __nv_bfloat16* __restrict__ x,
                      const float* __restrict__ ln_scale,
                      const float* __restrict__ ln_bias,
                      const __nv_bfloat16* __restrict__ wq,
                      const __nv_bfloat16* __restrict__ bq,
                      const __nv_bfloat16* __restrict__ wk,
                      const __nv_bfloat16* __restrict__ wv,
                      const __nv_bfloat16* __restrict__ bv,
                      __nv_bfloat16* __restrict__ qkv, int B, int T, int D) {
  using bf16 = __nv_bfloat16;
  constexpr int NT = NW * 32;
  constexpr int WR = NW / WC;
  constexpr int MI = BM / (16 * WR);  // 16-row tiles per warp
  constexpr int NF = BN / (8 * WC);   // 8-column tiles per warp
  static_assert(MI >= 1 && BM == 16 * MI * WR, "BM splits into 16-row warp tiles");
  static_assert(NF % 4 == 0, "the epilogue transposes groups of 4 n-tiles");
  constexpr int WLD = BN + 8;      // W slice row stride (elements)
  constexpr int WTILE = BK * WLD;  // elements of one W stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int HLD = D + 8;  // h row stride (elements)
  bf16* hs = reinterpret_cast<bf16*>(smem_raw);  // [BM][D + 8]
  bf16* ws = hs + BM * HLD;                      // [STAGES][BK][BN + 8]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * BM, b = blockIdx.y;
  const int n_kc = D / BK;             // k chunks per column tile
  const int n_it = (3 * D / BN) * n_kc;   // steps of the walk

  // Step `it` of the walk: rows k0..k0+31 of W, the column tile's BN
  // columns, into ring stage it % STAGES.
  auto load_w = [&](int it) {
    const int c0 = (it / n_kc) * BN, k0 = (it % n_kc) * BK;
    const int plane = c0 / D;
    const bf16* w = (plane == 0 ? wq : plane == 1 ? wk : wv) + (size_t)k0 * D + (c0 - plane * D);
    bf16* dst = ws + (it % STAGES) * WTILE;
    for (int c = tid; c < BK * (BN / 8); c += NT) {
      const int r = c / (BN / 8), col = (c % (BN / 8)) * 8;
      sar::cp_async16(dst + r * WLD + col, w + (size_t)r * D + col, true);
    }
  };

  // Group 0: the x tile (where h will be) and W step 0; then steps 1..2.
  const bf16* xb = x + ((size_t)b * T + r0) * D;
  for (int c = tid; c < BM * (D / 8); c += NT) {
    const int r = c / (D / 8), col = (c % (D / 8)) * 8;
    sar::cp_async16(hs + r * HLD + col, xb + (size_t)r * D + col, true);
  }
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_it) load_w(s);
    sar::cp_async_commit();
  }
  sar::cp_async_wait<STAGES - 2>();  // group 0 landed
  __syncthreads();

  // LayerNorm in place: each warp's rows, statistics once per row.
  constexpr int ROWS_PER_WARP = BM / (NT / 32);
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    bf16* row = hs + (warp * ROWS_PER_WARP + i) * HLD;
    float s = 0.f, ss = 0.f;
    for (int c = lane * 8; c < D; c += 32 * 8) {
      float f[8];
      sar::load_bf16x8(row + c, f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s += f[j];
        ss = fmaf(f[j], f[j], ss);
      }
    }
    s = sar::group_sum<32>(s);
    ss = sar::group_sum<32>(ss);
    const float mean = s / (float)D;
    const float var = ss / (float)D - mean * mean;
    const float rstd = 1.f / sqrtf(var + 1e-5f);
    for (int c = lane * 8; c < D; c += 32 * 8) {
      float f[8], sc[8], bi[8];
      sar::load_bf16x8(row + c, f);
      *reinterpret_cast<float4*>(sc) = *reinterpret_cast<const float4*>(ln_scale + c);
      *reinterpret_cast<float4*>(sc + 4) = *reinterpret_cast<const float4*>(ln_scale + c + 4);
      *reinterpret_cast<float4*>(bi) = *reinterpret_cast<const float4*>(ln_bias + c);
      *reinterpret_cast<float4*>(bi + 4) = *reinterpret_cast<const float4*>(ln_bias + c + 4);
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = (f[j] - mean) * rstd * sc[j] + bi[j];
      sar::store_bf16x8(row + c, f);
    }
  }
  __syncthreads();

  const int wr = warp / WC, wc = warp % WC;
  const int row_w = wr * 16 * MI;  // the warp's first row in the tile
  const int col_w = wc * 8 * NF;   // its first column in the column tile
  const bf16* a_base = hs + (row_w + (lane & 15)) * HLD + (lane >> 4) * 8;
  const int b_off = (lane & 15) * WLD + col_w + (lane >> 4) * 8;
  float acc[MI][NF][4] = {};

  // Bias, q's scaling and one rounding; a transpose within each quad of
  // lanes (lane t ends with the 8 columns of n-tile n0 + t) for 16-byte
  // stores of rows g and g + 8.
  auto epilogue = [&](int ct) {
    const int c0 = ct * BN;
    const int plane = c0 / D;
    const int col = c0 - plane * D + col_w;
    const bf16* bias = plane == 0 ? bq : plane == 2 ? bv : nullptr;
    const float scale = plane == 0 ? 0.125f : 1.f;  // 64^-0.5 for q
    float2 bb[NF];
#pragma unroll
    for (int n = 0; n < NF; ++n)
      bb[n] = bias != nullptr
                  ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + col + 8 * n + 2 * t))
                  : make_float2(0.f, 0.f);
    bf16* out = qkv + (((size_t)plane * B + b) * T + r0) * D + col;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row_w + 16 * mi + g + 8 * i;
        uint32_t p[NF];
#pragma unroll
        for (int n = 0; n < NF; ++n)
          p[n] = sar::pack_bf16((acc[mi][n][2 * i] + bb[n].x) * scale,
                                (acc[mi][n][2 * i + 1] + bb[n].y) * scale);
#pragma unroll
        for (int n0 = 0; n0 < NF; n0 += 4) {
          uint32_t o[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            // Lane t sends n-tile n0 + ((t + r) & 3) to lane (t + r) & 3
            // and receives its own n-tile's columns 2s, 2s+1 from lane s.
            const int want = (t + r) & 3, src = (t - r) & 3;
            uint32_t send = p[n0];
#pragma unroll
            for (int j = 1; j < 4; ++j) send = want == j ? p[n0 + j] : send;
            const uint32_t recv = __shfl_sync(0xffffffffu, send, (lane & ~3) | src);
#pragma unroll
            for (int j = 0; j < 4; ++j) o[j] = src == j ? recv : o[j];
          }
          *reinterpret_cast<uint4*>(out + (size_t)row * D + 8 * (n0 + t)) =
              make_uint4(o[0], o[1], o[2], o[3]);
        }
      }
    }
  };

  for (int it = 0; it < n_it; ++it) {
    sar::cp_async_wait<STAGES - 2>();  // step it landed
    __syncthreads();  // ... for every thread; step it - 1's stage is free
    if (it + STAGES - 1 < n_it) load_w(it + STAGES - 1);
    sar::cp_async_commit();
    const int kc = it % n_kc;
    const bf16* wt = ws + (it % STAGES) * WTILE + b_off;
    const bf16* at = a_base + kc * BK;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) sar::ldsm_x4(a[mi], at + mi * 16 * HLD + kk * 16);
#pragma unroll
      for (int dn = 0; dn < NF / 2; ++dn) {
        uint32_t bf[4];
        sar::ldsm_x4_t(bf, wt + kk * 16 * WLD + dn * 16);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          sar::mma(acc[mi][2 * dn], a[mi], bf[0], bf[1]);
          sar::mma(acc[mi][2 * dn + 1], a[mi], bf[2], bf[3]);
        }
      }
    }
    if (kc == n_kc - 1) {
      epilogue(it / n_kc);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int n = 0; n < NF; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][n][e] = 0.f;
    }
  }
}

bool ln_qkv_smem_done[kNumLnQkvConfigs][sar::kMaxDevices] = {};

template <int I>
cudaError_t launch_ln_qkv_config(const void* x, const void* ln_scale, const void* ln_bias,
                                 const void* wq, const void* bq, const void* wk,
                                 const void* wv, const void* bv, void* qkv, int B, int T,
                                 int D, int device, cudaStream_t stream) {
  constexpr LnQkvConfig c = kLnQkvConfigs[I];
  const auto kernel = encoder_ln_qkv_kernel<c.bm, c.bn, c.bk, c.nw, c.wc, c.stages>;
  // The limit is raised to the card's maximum once; each launch asks for
  // what its D needs.
  const cudaError_t err = sar::allow_smem_once(ln_qkv_smem_done[I], device, kernel, kMaxSmem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(T / c.bm, B), c.nw * 32, ln_qkv_smem_bytes(c, D), stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<const __nv_bfloat16*>(wq),
      static_cast<const __nv_bfloat16*>(bq), static_cast<const __nv_bfloat16*>(wk),
      static_cast<const __nv_bfloat16*>(wv), static_cast<const __nv_bfloat16*>(bv),
      static_cast<__nv_bfloat16*>(qkv), B, T, D);
  return cudaGetLastError();
}

bool ln_qkv_bad_shape(int B, int T, int D) {
  return D < 64 || D % 64 != 0 || T < 64 || T % 64 != 0 || B < 1 || B > 65535 ||
         ln_qkv_pick(T, D) < 0;
}

// The LN + projection kernel over a checked shape, on `stream`.
cudaError_t launch_ln_qkv(const void* x, const void* ln_scale, const void* ln_bias,
                          const void* wq, const void* bq, const void* wk,
                          const void* wv, const void* bv, void* qkv, int B, int T,
                          int D, int device, cudaStream_t stream) {
  static_assert(kNumLnQkvConfigs == 5, "one case per configuration");
  switch (ln_qkv_pick(T, D)) {
#define SAR_LN_QKV_CASE(I)                                                                 \
  case I:                                                                                  \
    return launch_ln_qkv_config<I>(x, ln_scale, ln_bias, wq, bq, wk, wv, bv, qkv, B, T, D, \
                                   device, stream);
    SAR_LN_QKV_CASE(0)
    SAR_LN_QKV_CASE(1)
    SAR_LN_QKV_CASE(2)
    SAR_LN_QKV_CASE(3)
    SAR_LN_QKV_CASE(4)
#undef SAR_LN_QKV_CASE
    default:
      return cudaErrorInvalidValue;
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
  if (D != n_heads * HD || ln_qkv_bad_shape(B, T, D) || t_valid < 1 || t_valid > T ||
      n_heads > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = launch_ln_qkv(x, ln_scale, ln_bias, wq, bq, wk, wv, bv, qkv, B, T, D, device, st);
  if (err != cudaSuccess) return (int)err;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(qkv);
  const size_t plane = (size_t)B * T * D;
  return (int)launch_attention_hm(q, q + plane, q + 2 * plane,
                                  static_cast<__nv_bfloat16*>(o), B, T, D,
                                  n_heads, t_valid, device, st);
}

// K8's LN + projection half alone, into qkv [3, B, T_pad, D] (for timing and
// testing it apart from the attention; the fused entry point above is what
// the encoder calls).
extern "C" int sar_encoder_ln_qkv(const void* x, const void* ln_scale,
                                  const void* ln_bias, const void* wq, const void* bq,
                                  const void* wk, const void* wv, const void* bv,
                                  void* qkv, int B, int T, int D, int device,
                                  void* stream) {
  if (ln_qkv_bad_shape(B, T, D)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_ln_qkv(x, ln_scale, ln_bias, wq, bq, wk, wv, bv, qkv, B, T, D,
                            device, static_cast<cudaStream_t>(stream));
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
