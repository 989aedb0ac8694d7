// Fused cross-KV projection + int8 quantization: kernel K2, and K4 (K2 with
// a per-sample LoRA term on V).
//
// K2 replaces sar_tpu/ops/kv_init.py::fused_kv_init without LoRA (Pallas
// `_kernel` -> `_cell_body` -> `_quantize_rows`). For every decoder layer l:
// K = x.Wk[l] and V = x.Wv[l] + bv[l] with fp32 accumulation, rounded to
// bf16 (the compute dtype) and back, then symmetric int8 per (row, head):
// scale = max(max|y|, 1e-8) / 127, q = clip(rint(y / scale), -127, 127).
// Rows >= t_valid are written as 0 with scale 0 (the decode kernel keys its
// padding mask on scale > 0). Outputs are the head-minor cache fields:
// kq/vq [L, B, S_pad, H*64] s8 and ks/vs [L, B, H, S_pad] f32 (head-major).
//
// K4 replaces kv_init.py::fused_kv_init with va/vb (Pallas `_kernel_lora`).
// va [L, Bv, D, R] / vb [L, Bv, R, D] are an adapter bank's cross_v slices,
// Bv = B (one adapter per sample) or 1 (one for the whole batch). With the
// TPU kernel's rounding points:
//   u   = bf16(x[b] @ va[l, b'])             fp32 sum, rounded to bf16
//   V32 = (x[b] @ Wv[l] + bv[l]) + lora_scale * (u @ vb[l, b'])
// then V32 is rounded to bf16 once and quantized as in K2; K is K2's.
//
// Bound on the H100: FLOPs. At whisper-small B=8 (12 layers, 1500 valid of
// S_pad 1536 rows, d_model 768) the two projections are
// 2*2*L*B*S*D*D = 340 GFLOP and the LoRA term adds 4*L*B*S*D*r = 7 GFLOP at
// r=16; the int8 outputs are 226 MB. Design: one block per (head, 64-row
// tile, layer x sample). The block owns exactly one head's 64 output
// columns of BOTH K and V, so the per-(row, head) amax is a reduction inside
// the block (16 lanes of one warp, by shuffles) with no second pass, and the
// bf16 K/V never exist in device memory. The GEMM streams 32-wide d_model
// chunks of the x tile and of the two weight column blocks through shared
// memory (x is read once for K and V); each thread accumulates a 4x4 tile of
// K and of V in fp32 registers on the CUDA cores. K4 streams the matching
// [32, R] chunk of va beside them and accumulates its block's [64, R] tile
// of u in the same loop (4 rows x R/16 rank columns a thread). Every head's
// block recomputes that u tile: R/128 of the block's base products (12% at
// r=16), in exchange for no second launch and no u in device memory. After
// the loop, u is rounded to bf16 and, 16 rank columns at a time, staged with
// the matching rows of vb (this head's 64 columns) in the now idle x and Wk
// buffers; each thread adds its 4x4 tile of u @ vb to an fp32 accumulator
// that joins V after the bias. The TPU kernel's VMEM column groups G are not
// carried over: shared memory holds only [64 x 32] chunks at any d_model.
// Tensor-core products are the next step for speed.
//
// Rounding: rintf (half to even, like jnp.round) and IEEE division (the
// library is compiled without --use_fast_math).
#include "common.cuh"

namespace {

constexpr int HD = 64;   // head_dim: one block owns one head's 64 columns
constexpr int BR = 64;   // rows (encoder positions) per block
constexpr int BD = 32;   // d_model chunk per shared-memory stage
constexpr int NT = 256;  // 16 row quads x 16 column quads
constexpr int RG = 16;   // LoRA rank granule: one rank column per column quad
constexpr int MAX_RC = 4;  // ranks up to 64

// One row's four columns (already summed in fp32) held by this thread; the
// other 60 columns of the (row, head) are held by the 15 lanes with the same
// row quad.
__device__ __forceinline__ void quantize_store(const float y32[4], bool valid,
                                               bool writer, int8_t* dst,
                                               float* scale_dst) {
  float y[4];
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    y[j] = sar::bf16_round(y32[j]);
    amax = fmaxf(amax, fabsf(y[j]));
  }
  amax = sar::group_max<16>(amax);
  const float scale = fmaxf(amax, 1e-8f) / 127.0f;
  char4 qv;
  signed char* qp = reinterpret_cast<signed char*>(&qv);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    qp[j] = valid ? (signed char)fminf(fmaxf(rintf(y[j] / scale), -127.f), 127.f) : 0;
  *reinterpret_cast<char4*>(dst) = qv;
  if (writer) *scale_dst = valid ? scale : 0.f;
}

// RC = LoRA rank / 16 (0: no LoRA, kernel K2).
template <int RC>
__global__ void __launch_bounds__(NT)
fused_kv_init_kernel(const __nv_bfloat16* __restrict__ x,   // [B, S_pad, D]
                     const __nv_bfloat16* __restrict__ wk,  // [L, D, D]
                     const __nv_bfloat16* __restrict__ wv,  // [L, D, D]
                     const __nv_bfloat16* __restrict__ bv,  // [L, D]
                     const __nv_bfloat16* __restrict__ va,  // [L, Bv, D, R]
                     const __nv_bfloat16* __restrict__ vb,  // [L, Bv, R, D]
                     int8_t* __restrict__ kq, float* __restrict__ ks,
                     int8_t* __restrict__ vq, float* __restrict__ vs,
                     int B, int Bv, int S_pad, int D, int H, int t_valid,
                     float lora_scale) {
  constexpr int R = RC * RG;
  __shared__ float xs[BR][BD + 1];
  __shared__ __align__(16) float wks[BD][HD];
  __shared__ __align__(16) float wvs[BD][HD];
  __shared__ float vas[BD][RC > 0 ? R : 1];

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int r0 = blockIdx.y * BR;
  const int l = blockIdx.z / B;
  const int b = blockIdx.z % B;
  const __nv_bfloat16* xb = x + ((size_t)b * S_pad + r0) * D;
  const __nv_bfloat16* wkl = wk + (size_t)l * D * D + h * HD;
  const __nv_bfloat16* wvl = wv + (size_t)l * D * D + h * HD;
  const size_t lora_plane = (size_t)l * Bv + (Bv == 1 ? 0 : b);
  const __nv_bfloat16* val = RC > 0 ? va + lora_plane * D * R : nullptr;
  const __nv_bfloat16* vbl = RC > 0 ? vb + lora_plane * R * D + h * HD : nullptr;

  const int ty = tid >> 4;  // rows 4ty..4ty+3 of the tile
  const int tx = tid & 15;  // columns 4tx..4tx+3 of the head; rank columns tx + 16c
  float ak[4][4] = {}, av[4][4] = {};
  float ua[4][RC > 0 ? RC : 1] = {};

  for (int d0 = 0; d0 < D; d0 += BD) {
    {
      float f[8];
      const int r = tid >> 2, c = (tid & 3) * 8;  // 64 rows x 4 chunks of 8
      sar::load_bf16x8(xb + (size_t)r * D + d0 + c, f);
#pragma unroll
      for (int i = 0; i < 8; ++i) xs[r][c + i] = f[i];
      const int wr = tid >> 3, wc = (tid & 7) * 8;  // 32 rows x 8 chunks of 8
      sar::load_bf16x8(wkl + (size_t)(d0 + wr) * D + wc, f);
#pragma unroll
      for (int i = 0; i < 8; ++i) wks[wr][wc + i] = f[i];
      sar::load_bf16x8(wvl + (size_t)(d0 + wr) * D + wc, f);
#pragma unroll
      for (int i = 0; i < 8; ++i) wvs[wr][wc + i] = f[i];
      if constexpr (RC > 0) {
        if (tid < BD * R / 8) {  // 32 rows x R/8 chunks of 8
          const int vr = tid / (R / 8), vc = (tid % (R / 8)) * 8;
          sar::load_bf16x8(val + (size_t)(d0 + vr) * R + vc, f);
#pragma unroll
          for (int i = 0; i < 8; ++i) vas[vr][vc + i] = f[i];
        }
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BD; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[4 * ty + i][kk];
      const float4 bk = *reinterpret_cast<const float4*>(&wks[kk][4 * tx]);
      const float4 bw = *reinterpret_cast<const float4*>(&wvs[kk][4 * tx]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ak[i][0] = fmaf(a[i], bk.x, ak[i][0]);
        ak[i][1] = fmaf(a[i], bk.y, ak[i][1]);
        ak[i][2] = fmaf(a[i], bk.z, ak[i][2]);
        ak[i][3] = fmaf(a[i], bk.w, ak[i][3]);
        av[i][0] = fmaf(a[i], bw.x, av[i][0]);
        av[i][1] = fmaf(a[i], bw.y, av[i][1]);
        av[i][2] = fmaf(a[i], bw.z, av[i][2]);
        av[i][3] = fmaf(a[i], bw.w, av[i][3]);
      }
      if constexpr (RC > 0) {
#pragma unroll
        for (int c = 0; c < RC; ++c) {
          const float w = vas[kk][tx + RG * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) ua[i][c] = fmaf(a[i], w, ua[i][c]);
        }
      }
    }
    __syncthreads();
  }

  // LoRA term d = u @ vb[:, this head's columns], 16 rank columns at a time
  // through the idle xs (u, bf16-rounded) and wks (vb rows) buffers.
  float dl[4][4] = {};
  if constexpr (RC > 0) {
#pragma unroll
    for (int c = 0; c < RC; ++c) {
#pragma unroll
      for (int i = 0; i < 4; ++i) xs[4 * ty + i][tx] = sar::bf16_round(ua[i][c]);
      if (tid < RG * HD / 8) {  // 16 rows x 8 chunks of 8
        float f[8];
        const int vr = tid >> 3, vc = (tid & 7) * 8;
        sar::load_bf16x8(vbl + (size_t)(RG * c + vr) * D + vc, f);
#pragma unroll
        for (int i = 0; i < 8; ++i) wks[vr][vc + i] = f[i];
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < RG; ++kk) {
        const float4 w = *reinterpret_cast<const float4*>(&wks[kk][4 * tx]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float u = xs[4 * ty + i][kk];
          dl[i][0] = fmaf(u, w.x, dl[i][0]);
          dl[i][1] = fmaf(u, w.y, dl[i][1]);
          dl[i][2] = fmaf(u, w.z, dl[i][2]);
          dl[i][3] = fmaf(u, w.w, dl[i][3]);
        }
      }
      __syncthreads();
    }
  }

  float bias[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) bias[j] = __bfloat162float(bv[(size_t)l * D + h * HD + 4 * tx + j]);
  const size_t plane = (size_t)l * B + b;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + 4 * ty + i;
    const bool valid = row < t_valid;
    const size_t vo = (plane * S_pad + row) * D + h * HD + 4 * tx;
    const size_t so = (plane * H + h) * S_pad + row;
    float v32[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v32[j] = av[i][j] + bias[j];
      if constexpr (RC > 0) v32[j] += lora_scale * dl[i][j];
    }
    quantize_store(ak[i], valid, tx == 0, kq + vo, ks + so);
    quantize_store(v32, valid, tx == 0, vq + vo, vs + so);
  }
}

int check_shapes(int L, int B, int S_pad, int D, int n_heads, int t_valid) {
  if (D != n_heads * HD || D % BD != 0 || S_pad % BR != 0 || t_valid < 1 ||
      t_valid > S_pad || L < 1 || B < 1 || (long long)L * B > 65535 ||
      S_pad / BR > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

template <int RC>
int launch(const void* x, const void* wk, const void* wv, const void* bv,
           const void* va, const void* vb, void* kq, void* ks, void* vq,
           void* vs, int L, int B, int Bv, int S_pad, int D, int n_heads,
           int t_valid, float lora_scale, cudaStream_t stream) {
  const dim3 grid(n_heads, S_pad / BR, L * B);
  fused_kv_init_kernel<RC><<<grid, NT, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wk),
      static_cast<const __nv_bfloat16*>(wv), static_cast<const __nv_bfloat16*>(bv),
      static_cast<const __nv_bfloat16*>(va), static_cast<const __nv_bfloat16*>(vb),
      static_cast<int8_t*>(kq), static_cast<float*>(ks), static_cast<int8_t*>(vq),
      static_cast<float*>(vs), B, Bv, S_pad, D, n_heads, t_valid, lora_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sar_fused_kv_init(const void* x, const void* wk, const void* wv,
                                 const void* bv, void* kq, void* ks, void* vq,
                                 void* vs, int L, int B, int S_pad, int D,
                                 int n_heads, int t_valid, int device,
                                 void* stream) {
  int err = check_shapes(L, B, S_pad, D, n_heads, t_valid);
  if (err != cudaSuccess) return err;
  err = (int)cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return launch<0>(x, wk, wv, bv, nullptr, nullptr, kq, ks, vq, vs, L, B, 1,
                   S_pad, D, n_heads, t_valid, 0.f,
                   static_cast<cudaStream_t>(stream));
}

// rank: the padded LoRA rank, a multiple of 16 up to 64; Bv: 1 or B.
extern "C" int sar_fused_kv_init_lora(const void* x, const void* wk,
                                      const void* wv, const void* bv,
                                      const void* va, const void* vb, void* kq,
                                      void* ks, void* vq, void* vs, int L,
                                      int B, int Bv, int S_pad, int D,
                                      int n_heads, int rank, int t_valid,
                                      float lora_scale, int device,
                                      void* stream) {
  int err = check_shapes(L, B, S_pad, D, n_heads, t_valid);
  if (err != cudaSuccess) return err;
  if (rank < RG || rank > MAX_RC * RG || rank % RG != 0 || (Bv != 1 && Bv != B))
    return (int)cudaErrorInvalidValue;
  err = (int)cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rank / RG) {
    case 1: return launch<1>(x, wk, wv, bv, va, vb, kq, ks, vq, vs, L, B, Bv, S_pad, D, n_heads, t_valid, lora_scale, s);
    case 2: return launch<2>(x, wk, wv, bv, va, vb, kq, ks, vq, vs, L, B, Bv, S_pad, D, n_heads, t_valid, lora_scale, s);
    case 3: return launch<3>(x, wk, wv, bv, va, vb, kq, ks, vq, vs, L, B, Bv, S_pad, D, n_heads, t_valid, lora_scale, s);
    default: return launch<4>(x, wk, wv, bv, va, vb, kq, ks, vq, vs, L, B, Bv, S_pad, D, n_heads, t_valid, lora_scale, s);
  }
}
