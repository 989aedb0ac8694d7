// Encoder self-attention on the head-minor residual layout (kernel K1).
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

}  // namespace

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
