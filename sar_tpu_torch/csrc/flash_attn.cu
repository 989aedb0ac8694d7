// Blockwise multi-head attention for training, forward and backward
// (kernel K6).
//
// Replaces sar_tpu/ops/flash.py::flash_mha, which wraps jax's Pallas TPU
// flash attention (jax/experimental/pallas/ops/tpu/flash_attention.py:
// forward kernel `_flash_attention_kernel_single_batch`, backward kernels
// `_flash_attention_dkv_kernel` and `_flash_attention_dq_kernel`).
// Computes, per sample b and head h, o = softmax(q k^T) v over q [Tq, 64]
// and k/v [Tk, 64] bf16 (q pre-scaled, sm_scale 1), with fp32 scores, an
// optional causal mask on absolute positions (Tq == Tk), the unnormalised
// probabilities rounded to bf16 before the PV product, and the fp32 row
// log-sum-exp saved for the backward. The backward takes di = rowsum(o*do)
// (fp32, computed outside the kernels, as the TPU version does) and
// rebuilds p = exp(s - lse) tile by tile:
//   dv = bf16(p)^T do,  ds = p * (do v^T - di),  dk = bf16(ds)^T q,
//   dq = bf16(ds) k,
// every product accumulated in fp32 and each gradient rounded to bf16 once.
//
// The TPU version pads Tq/Tk to its 128-row tile and masks the pads with
// segment ids (pads attend only to pads). Here the kernels take the valid
// lengths: ragged tiles are loaded as zeros and their keys masked, rows past
// Tq are neither computed into nor stored, so no padded copy exists.
//
// Tensors are [B, H, T, 64] views with any (batch, head, row) strides that
// are multiples of 8 elements and a contiguous last dimension, so the
// [B, T, H*64] projections are read in place (no split-heads copy).
//
// Bound on the H100: FLOPs. At whisper-small B=8, H=12, T=1500 the forward
// is 4*B*H*T^2*64 = 55 GFLOP against 4*B*H*T*64*2 = 74 MB of traffic, the
// backward 2.5x the FLOPs. Design (a first, simple version on the fp32
// CUDA cores, like K1): no atomics, so the gradients are the same from run
// to run; each block owns its output rows and loops over the other axis:
//   forward  — one block per (64-query tile, head, sample), 32-key tiles
//              streamed through shared memory with an online softmax;
//   dK/dV    — one block per (64-key tile, head, sample), 32-query tiles
//              streamed, dk and dv of its 64 keys held in registers;
//   dQ       — one block per (64-query tile, head, sample), 32-key tiles
//              streamed, dq of its 64 rows held in registers.
// Each thread holds a 2x4 tile of scores and a 2x8 tile of outputs. Causal
// blocks skip the key (or query) tiles that lie wholly above the diagonal.
// The backward kernels keep more than 48 KB of tiles in shared memory and
// raise their dynamic limit before launch. Tensor-core products (mma.sync,
// then wgmma + TMA) are the next step for speed.
#include "common.cuh"

namespace {

constexpr int HD = 64;   // head_dim (every Whisper size ships 64)
constexpr int LD = HD + 1;  // padded row of a [rows, 64] fp32 tile
constexpr int NT = 256;  // 32 row pairs x 8 column (or key) groups
constexpr int BQ = 64;   // query rows per forward / dQ block
constexpr int BK = 32;   // keys per streamed tile (forward, dQ)
constexpr int KB = 64;   // keys per dK/dV block
constexpr int QB = 32;   // queries per streamed tile (dK/dV)

// Element strides of one [B, H, T, 64] view.
struct Layout {
  long long b, h, t;
};

struct FwdParams {
  const __nv_bfloat16 *q, *k, *v;
  __nv_bfloat16* o;
  float* lse;  // [B, H, Tq]
  Layout lq, lk, lv, lo;
  int H, Tq, Tk, causal;
};

struct BwdParams {
  const __nv_bfloat16 *q, *k, *v, *dout;
  const float *lse, *di;  // [B, H, Tq]
  __nv_bfloat16 *dq, *dk, *dv;
  Layout lq, lk, lv, ldo, ldq, ldk, ldv;
  int H, Tq, Tk, causal;
};

__device__ __forceinline__ long long offset(const Layout& L, int b, int h,
                                            int r) {
  return (long long)b * L.b + (long long)h * L.h + (long long)r * L.t;
}

// Rows [r0, r0 + R) of a [.., T, 64] view into a padded fp32 tile (row
// stride LD); rows past T are zeros. Call from all NT threads.
template <int R>
__device__ __forceinline__ void load_tile(float* dst,
                                          const __nv_bfloat16* __restrict__ src,
                                          const Layout& L, int b, int h,
                                          int r0, int T) {
  for (int c = threadIdx.x; c < R * (HD / 8); c += NT) {
    const int r = c / (HD / 8), col = (c % (HD / 8)) * 8;
    float f[8];
    if (r0 + r < T) {
      sar::load_bf16x8(src + offset(L, b, h, r0 + r) + col, f);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[r * LD + col + i] = f[i];
  }
}

// ---------------------------------------------------------------------------
// Forward: o and the row log-sum-exp.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT) flash_fwd_kernel(const FwdParams p) {
  __shared__ float qs[BQ * LD];
  __shared__ float ks[BK * LD];
  __shared__ __align__(16) float vs[BK][HD];
  __shared__ float ps[BQ][BK + 1];

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  load_tile<BQ>(qs, p.q, p.lq, b, h, q0, p.Tq);

  const int rp = tid >> 3;  // this thread's rows: 2rp, 2rp+1
  const int g = tid & 7;    // keys 4g..4g+3 of a tile; output columns 8g..8g+7
  float m[2] = {-INFINITY, -INFINITY};  // running row max
  float l[2] = {0.f, 0.f};              // running row sum of exp
  float acc[2][8] = {};

  // Key tiles wholly above the diagonal hold no unmasked entry of this block.
  const int k_end = p.causal ? min(p.Tk, q0 + BQ) : p.Tk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // previous tile consumed (and the q tile written)
    {
      const int r = tid / (HD / 8), col = (tid % (HD / 8)) * 8;  // 32 x 8 chunks
      float f[8] = {}, fv[8] = {};
      if (k0 + r < p.Tk) {
        sar::load_bf16x8(p.k + offset(p.lk, b, h, k0 + r) + col, f);
        sar::load_bf16x8(p.v + offset(p.lv, b, h, k0 + r) + col, fv);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        ks[r * LD + col + i] = f[i];
        vs[r][col + i] = fv[i];
      }
    }
    __syncthreads();

    float s[2][4] = {};
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float a0 = qs[(2 * rp) * LD + d], a1 = qs[(2 * rp + 1) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float kv = ks[(4 * g + j) * LD + d];
        s[0][j] = fmaf(a0, kv, s[0][j]);
        s[1][j] = fmaf(a1, kv, s[1][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + 2 * rp + i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + 4 * g + j;
        if (col >= p.Tk || (p.causal && col > row)) s[i][j] = sar::kNeg;
        mt = fmaxf(mt, s[i][j]);
      }
      mt = sar::group_max<8>(mt);  // the 8 lanes sharing these rows
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - m_new);
        ls += e;
        ps[2 * rp + i][4 * g + j] = sar::bf16_round(e);  // p -> v's dtype
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
    const int row = q0 + 2 * rp + i;
    if (row >= p.Tq) continue;
    const float inv = 1.f / l[i];
    float out[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) out[c] = acc[i][c] * inv;
    sar::store_bf16x8(p.o + offset(p.lo, b, h, row) + 8 * g, out);
    if (g == 0)
      p.lse[((long long)b * p.H + h) * p.Tq + row] = m[i] + logf(l[i]);
  }
}

// ---------------------------------------------------------------------------
// Backward, dK and dV: one block per 64-key tile, query tiles streamed.
// ---------------------------------------------------------------------------
constexpr int DKV_SMEM_FLOATS =
    2 * KB * LD + 2 * QB * LD + 2 * KB * (QB + 1) + 2 * QB;
constexpr int DKV_SMEM_BYTES = DKV_SMEM_FLOATS * 4;

__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(const BwdParams p) {
  extern __shared__ float smem[];
  float* ks = smem;                       // [KB][LD]
  float* vs = ks + KB * LD;               // [KB][LD]
  float* qs = vs + KB * LD;               // [QB][LD]
  float* dos = qs + QB * LD;              // [QB][LD]
  float* ps = dos + QB * LD;              // [KB][QB + 1], bf16-rounded p
  float* dss = ps + KB * (QB + 1);        // [KB][QB + 1], bf16-rounded ds
  float* lses = dss + KB * (QB + 1);      // [QB]
  float* dis = lses + QB;                 // [QB]

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * KB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long row_base = ((long long)b * p.H + h) * p.Tq;
  load_tile<KB>(ks, p.k, p.lk, b, h, k0, p.Tk);
  load_tile<KB>(vs, p.v, p.lv, b, h, k0, p.Tk);

  const int kr = tid >> 3;  // this thread's keys: 2kr, 2kr+1
  const int g = tid & 7;    // queries 4g..4g+3 of a tile; columns 8g..8g+7
  float dk[2][8] = {}, dv[2][8] = {};

  // Query tiles wholly above the diagonal see none of these keys.
  const int q_start = p.causal ? k0 : 0;
  for (int q0 = q_start; q0 < p.Tq; q0 += QB) {
    __syncthreads();  // previous tile consumed
    load_tile<QB>(qs, p.q, p.lq, b, h, q0, p.Tq);
    load_tile<QB>(dos, p.dout, p.ldo, b, h, q0, p.Tq);
    if (tid < QB) {
      const bool live = q0 + tid < p.Tq;
      lses[tid] = live ? p.lse[row_base + q0 + tid] : 0.f;
      dis[tid] = live ? p.di[row_base + q0 + tid] : 0.f;
    }
    __syncthreads();

    // s^T and dp^T: [2 keys] x [4 queries] per thread.
    float s[2][4] = {}, dp[2][4] = {};
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float k_a = ks[(2 * kr) * LD + d], k_b = ks[(2 * kr + 1) * LD + d];
      const float v_a = vs[(2 * kr) * LD + d], v_b = vs[(2 * kr + 1) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float qv = qs[(4 * g + j) * LD + d];
        const float ov = dos[(4 * g + j) * LD + d];
        s[0][j] = fmaf(k_a, qv, s[0][j]);
        s[1][j] = fmaf(k_b, qv, s[1][j]);
        dp[0][j] = fmaf(v_a, ov, dp[0][j]);
        dp[1][j] = fmaf(v_b, ov, dp[1][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = k0 + 2 * kr + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = q0 + 4 * g + j;
        const bool masked = key >= p.Tk || qi >= p.Tq || (p.causal && key > qi);
        const float pe = masked ? 0.f : expf(s[i][j] - lses[4 * g + j]);
        const float ds = pe * (dp[i][j] - dis[4 * g + j]);
        ps[(2 * kr + i) * (QB + 1) + 4 * g + j] = sar::bf16_round(pe);
        dss[(2 * kr + i) * (QB + 1) + 4 * g + j] = sar::bf16_round(ds);
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int qq = 0; qq < QB; ++qq) {
      const float p0 = ps[(2 * kr) * (QB + 1) + qq];
      const float p1 = ps[(2 * kr + 1) * (QB + 1) + qq];
      const float e0 = dss[(2 * kr) * (QB + 1) + qq];
      const float e1 = dss[(2 * kr + 1) * (QB + 1) + qq];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float ov = dos[qq * LD + 8 * g + c];
        const float qv = qs[qq * LD + 8 * g + c];
        dv[0][c] = fmaf(p0, ov, dv[0][c]);
        dv[1][c] = fmaf(p1, ov, dv[1][c]);
        dk[0][c] = fmaf(e0, qv, dk[0][c]);
        dk[1][c] = fmaf(e1, qv, dk[1][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + 2 * kr + i;
    if (key >= p.Tk) continue;
    sar::store_bf16x8(p.dk + offset(p.ldk, b, h, key) + 8 * g, dk[i]);
    sar::store_bf16x8(p.dv + offset(p.ldv, b, h, key) + 8 * g, dv[i]);
  }
}

// ---------------------------------------------------------------------------
// Backward, dQ: one block per 64-query tile, key tiles streamed.
// ---------------------------------------------------------------------------
constexpr int DQ_SMEM_FLOATS = 2 * BQ * LD + 2 * BK * LD + BQ * (BK + 1) + 2 * BQ;
constexpr int DQ_SMEM_BYTES = DQ_SMEM_FLOATS * 4;

__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(const BwdParams p) {
  extern __shared__ float smem[];
  float* qs = smem;                  // [BQ][LD]
  float* dos = qs + BQ * LD;         // [BQ][LD]
  float* ks = dos + BQ * LD;         // [BK][LD]
  float* vs = ks + BK * LD;          // [BK][LD]
  float* dss = vs + BK * LD;         // [BQ][BK + 1], bf16-rounded ds
  float* lses = dss + BQ * (BK + 1); // [BQ]
  float* dis = lses + BQ;            // [BQ]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long row_base = ((long long)b * p.H + h) * p.Tq;
  load_tile<BQ>(qs, p.q, p.lq, b, h, q0, p.Tq);
  load_tile<BQ>(dos, p.dout, p.ldo, b, h, q0, p.Tq);
  if (tid < BQ) {
    const bool live = q0 + tid < p.Tq;
    lses[tid] = live ? p.lse[row_base + q0 + tid] : 0.f;
    dis[tid] = live ? p.di[row_base + q0 + tid] : 0.f;
  }

  const int rp = tid >> 3;  // this thread's rows: 2rp, 2rp+1
  const int g = tid & 7;    // keys 4g..4g+3 of a tile; columns 8g..8g+7
  float dq[2][8] = {};

  const int k_end = p.causal ? min(p.Tk, q0 + BQ) : p.Tk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // previous tile consumed (and the q/do tiles written)
    load_tile<BK>(ks, p.k, p.lk, b, h, k0, p.Tk);
    load_tile<BK>(vs, p.v, p.lv, b, h, k0, p.Tk);
    __syncthreads();

    float s[2][4] = {}, dp[2][4] = {};
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float a0 = qs[(2 * rp) * LD + d], a1 = qs[(2 * rp + 1) * LD + d];
      const float e0 = dos[(2 * rp) * LD + d], e1 = dos[(2 * rp + 1) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float kv = ks[(4 * g + j) * LD + d];
        const float vv = vs[(4 * g + j) * LD + d];
        s[0][j] = fmaf(a0, kv, s[0][j]);
        s[1][j] = fmaf(a1, kv, s[1][j]);
        dp[0][j] = fmaf(e0, vv, dp[0][j]);
        dp[1][j] = fmaf(e1, vv, dp[1][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + 2 * rp + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + 4 * g + j;
        const bool masked = col >= p.Tk || row >= p.Tq || (p.causal && col > row);
        const float pe = masked ? 0.f : expf(s[i][j] - lses[2 * rp + i]);
        dss[(2 * rp + i) * (BK + 1) + 4 * g + j] =
            sar::bf16_round(pe * (dp[i][j] - dis[2 * rp + i]));
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float e0 = dss[(2 * rp) * (BK + 1) + kk];
      const float e1 = dss[(2 * rp + 1) * (BK + 1) + kk];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float kv = ks[kk * LD + 8 * g + c];
        dq[0][c] = fmaf(e0, kv, dq[0][c]);
        dq[1][c] = fmaf(e1, kv, dq[1][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + 2 * rp + i;
    if (row < p.Tq) sar::store_bf16x8(p.dq + offset(p.ldq, b, h, row) + 8 * g, dq[i]);
  }
}

Layout layout_at(const long long* strides, int i) {
  return Layout{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

bool bad_shape(int B, int H, int Tq, int Tk, int causal) {
  return B < 1 || H < 1 || Tq < 1 || Tk < 1 || B > 65535 || H > 65535 ||
         (causal && Tq != Tk);
}

constexpr int kMaxDevices = 64;

// Raises `kernel`'s dynamic shared-memory limit to `bytes` on the current
// device once per process (the setting lasts for the context): `done` holds
// one flag per device. A second call from a racing thread is harmless.
template <typename Kernel>
cudaError_t allow_smem_once(bool* done, int device, Kernel kernel, int bytes) {
  const bool tracked = device >= 0 && device < kMaxDevices;
  if (tracked && done[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && tracked) done[device] = true;
  return err;
}

bool dkv_smem_done[kMaxDevices] = {};
bool dq_smem_done[kMaxDevices] = {};

}  // namespace

// strides: (batch, head, row) element strides of q, k, v, o.
extern "C" int sar_flash_attn_fwd(const void* q, const void* k, const void* v,
                                  void* o, void* lse, const long long* strides,
                                  int B, int H, int Tq, int Tk, int causal,
                                  int device, void* stream) {
  if (bad_shape(B, H, Tq, Tk, causal)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  FwdParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.lq = layout_at(strides, 0);
  p.lk = layout_at(strides, 1);
  p.lv = layout_at(strides, 2);
  p.lo = layout_at(strides, 3);
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.causal = causal;
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

static BwdParams bwd_params(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse, const void* di,
                            const long long* strides, int H, int Tq, int Tk,
                            int causal) {
  BwdParams p = {};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.di = static_cast<const float*>(di);
  p.lq = layout_at(strides, 0);
  p.lk = layout_at(strides, 1);
  p.lv = layout_at(strides, 2);
  p.ldo = layout_at(strides, 3);
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.causal = causal;
  return p;
}

// strides: (batch, head, row) element strides of q, k, v, do, dk, dv.
extern "C" int sar_flash_attn_bwd_dkv(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* di,
                                      void* dk, void* dv,
                                      const long long* strides, int B, int H,
                                      int Tq, int Tk, int causal, int device,
                                      void* stream) {
  if (bad_shape(B, H, Tq, Tk, causal)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem_once(dkv_smem_done, device, flash_bwd_dkv_kernel,
                        DKV_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  BwdParams p = bwd_params(q, k, v, dout, lse, di, strides, H, Tq, Tk, causal);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.ldk = layout_at(strides, 4);
  p.ldv = layout_at(strides, 5);
  const dim3 grid((Tk + KB - 1) / KB, H, B);
  flash_bwd_dkv_kernel<<<grid, NT, DKV_SMEM_BYTES,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// strides: (batch, head, row) element strides of q, k, v, do, dq.
extern "C" int sar_flash_attn_bwd_dq(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* di, void* dq,
                                     const long long* strides, int B, int H,
                                     int Tq, int Tk, int causal, int device,
                                     void* stream) {
  if (bad_shape(B, H, Tq, Tk, causal)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem_once(dq_smem_done, device, flash_bwd_dq_kernel,
                        DQ_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  BwdParams p = bwd_params(q, k, v, dout, lse, di, strides, H, Tq, Tk, causal);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.ldq = layout_at(strides, 4);
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_bwd_dq_kernel<<<grid, NT, DQ_SMEM_BYTES,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
