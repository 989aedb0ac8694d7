// Blockwise multi-head attention on the tensor cores: the forward kernel of
// K6 (training), which also serves K1 (encoder attention) and K8's attention
// half, and K6's two backward kernels.
//
// Replaces sar_tpu/ops/flash.py::flash_mha, which wraps jax's Pallas TPU
// flash attention (jax/experimental/pallas/ops/tpu/flash_attention.py:
// forward `_flash_attention_kernel_single_batch`, backward kernels
// `_flash_attention_dkv_kernel` and `_flash_attention_dq_kernel`), and the
// attention of sar_tpu/ops/flash_enc.py (`_kernel` of encoder_attention_hm,
// and the attention of `_fused_kernel`). Computes, per sample b and head h,
// o = softmax(q k^T) v over q [Tq, 64] and k/v [Tk, 64] bf16 (q pre-scaled,
// sm_scale 1): fp32 scores, keys >= Tk masked, an optional causal mask on
// absolute positions (Tq == Tk), an online softmax with fp32 running max and
// sum, the unnormalised probabilities rounded to bf16 for the PV product
// (fp32 sums), normalised after it, and the fp32 row log-sum-exp written
// when a pointer is given (K6; K1 passes none). The backward takes
// di = rowsum(o*do) (fp32, computed outside the kernels, as the TPU version
// does) and rebuilds p = exp(s - lse) tile by tile:
//   dv = bf16(p)^T do,  ds = p * (do v^T - di),  dk = bf16(ds)^T q,
//   dq = bf16(ds) k,
// every product summed in fp32 and each gradient rounded to bf16 once.
//
// The TPU versions pad to their tiles (K6 with segment ids, K1 to T_pad).
// Here the kernels take the valid lengths: ragged tiles are zero-filled and
// their keys masked, and rows past Tq are not stored. Tensors are
// [B, H, T, 64] views with any (batch, head, row) strides that are multiples
// of 8 elements and a contiguous last dimension, so the [B, T, H*64]
// projections are read in place. K1 is the forward on such views of its
// head-minor q/k/v [B, T_pad, H*64] (strides (T_pad*D, 64, D)) with
// Tq = T_pad (pad rows are computed and sliced off by the caller) and
// Tk = t_valid (flash_enc.cu).
//
// Bound on the H100: operations. At whisper-small B=8, H=12, T=1500 the
// forward is 4*B*H*T^2*64 = 55 GFLOP against 74 MB of traffic (0.056 ms at
// 989 TFLOP/s); dQ does 6 and dK/dV 8 FLOPs per (query, key, column).
// Design, for the tensor cores (mma.sync m16n8k16, bf16 operands, fp32
// sums; the fp32 CUDA cores peak at 67 TFLOP/s):
//   - a block of NW warps owns 16*NW rows of the dimension it writes
//     (forward and dQ: queries; dK/dV: keys); each warp keeps its 16 rows'
//     operand fragments (q; q and do; k and v) in registers, read once
//     with ldmatrix;
//   - the other dimension streams through a two-stage ring of 64-row bf16
//     tiles in shared memory (row stride 72 elements, so the 8 rows one
//     ldmatrix phase reads fall in distinct banks), filled with 16-byte
//     cp.async copies (zero-filled past the valid length) while the
//     previous tile is multiplied;
//   - the first product's fp32 accumulator fragments (scores) are masked,
//     exponentiated and rounded to bf16 in registers, where their layout is
//     the A-operand layout of the second product: nothing passes through
//     shared memory; the second product's B operand comes from
//     ldmatrix.trans;
//   - no atomics (each block owns its output rows), so the gradients are
//     the same from run to run; causal blocks skip the tiles wholly above
//     the diagonal, and only ragged and diagonal tiles do per-element masks.
// wgmma, TMA and warp specialisation are the next step (ROADMAP Queue B).
#include "flash_attn.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using sar::FwdParams;
using sar::Layout;
using sar::cp_async16;
using sar::cp_async4;
using sar::cp_async_commit;
using sar::cp_async_wait_but_one;
using sar::ldsm_x4;
using sar::ldsm_x4_t;
using sar::mma;
using sar::pack_bf16;

constexpr int HD = 64;          // head_dim (every Whisper size ships 64)
constexpr int LDS = HD + 8;     // shared row stride in elements (144 bytes)
constexpr int BN = 64;          // rows of a streamed tile
constexpr int TILE = BN * LDS;  // elements of one streamed tile
// Warps per block, the faster of 4 and 8 at whisper-small's three training
// shapes on the H100: 8 for the forward (and K1) and dK/dV, 4 for dQ (168
// registers a thread: more blocks per SM).
constexpr int FWD_NW = 8;
constexpr int DQ_NW = 4;
constexpr int DKV_NW = 8;

struct BwdParams {
  const bf16 *q, *k, *v, *dout;
  const float *lse, *di;  // [B, H, Tq]
  bf16 *dq, *dk, *dv;
  Layout lq, lk, lv, ldo, ldq, ldk, ldv;
  int H, Tq, Tk, causal;
};

__device__ __forceinline__ long long offset(const Layout& L, int b, int h,
                                            int r) {
  return (long long)b * L.b + (long long)h * L.h + (long long)r * L.t;
}

// Fragment layouts (lane = 4g + t): a 16 x 64 fp32 accumulator c[n][e]
// holds row g + 8*(e >> 1), column 8n + 2t + (e & 1); an A fragment a[kk]
// (16 x 16 at columns 16kk) holds rows g, g+8 and columns 16kk + 2t (+1,
// +8, +9) in the same order, so c's n-tiles 2kk, 2kk+1 are a[kk] as they
// stand.

// Rows [r0, r0 + R) of a [.., T, 64] view into a shared tile (row stride
// LDS); rows past T are zero-filled. Call from every thread of the block.
template <int R>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          const Layout& L, int b, int h,
                                          int r0, int T) {
  for (int c = threadIdx.x; c < R * (HD / 8); c += blockDim.x) {
    const int r = c >> 3, col = (c & 7) * 8;
    const bool valid = r0 + r < T;
    cp_async16(dst + r * LDS + col,
               src + offset(L, b, h, valid ? r0 + r : 0) + col, valid);
  }
}

// The A fragments of rows [r0, r0 + 16) x 64 columns of a shared tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], const bf16* s,
                                       int r0, int lane) {
  const bf16* p = s + (r0 + (lane & 15)) * LDS + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) ldsm_x4(a[kk], p + kk * 16);
}

// c (16 x 64) += a (16 x 64) . tile^T: the 64 rows of the shared tile are
// the product's columns (B from ldmatrix as stored).
__device__ __forceinline__ void mma_abt(float (&c)[8][4],
                                        const uint32_t (&a)[4][4],
                                        const bf16* tile, int lane) {
  const bf16* p =
      tile + ((lane & 7) + ((lane >> 4) << 3)) * LDS + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int nn = 0; nn < 4; ++nn) {
      uint32_t bf[4];
      ldsm_x4(bf, p + nn * 16 * LDS + kk * 16);
      mma(c[2 * nn], a[kk], bf[0], bf[1]);
      mma(c[2 * nn + 1], a[kk], bf[2], bf[3]);
    }
  }
}

// c (16 x 64) += a (16 x 64, bf16 fragments) . tile: the 64 rows of the
// shared tile are the summed dimension (B from ldmatrix.trans).
__device__ __forceinline__ void mma_ab(float (&c)[8][4],
                                       const uint32_t (&a)[4][4],
                                       const bf16* tile, int lane) {
  const bf16* p = tile + (lane & 15) * LDS + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int dn = 0; dn < 4; ++dn) {
      uint32_t bf[4];
      ldsm_x4_t(bf, p + kk * 16 * LDS + dn * 16);
      mma(c[2 * dn], a[kk], bf[0], bf[1]);
      mma(c[2 * dn + 1], a[kk], bf[2], bf[3]);
    }
  }
}

// A 16 x 64 fp32 accumulator rounded to bf16 A fragments.
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4],
                                     const float (&c)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// Rows r0 + g and r0 + g + 8 of a 16 x 64 accumulator, times scale[i],
// rounded to bf16 into a [.., T, 64] view; rows >= T are not stored.
__device__ __forceinline__ void store_rows(bf16* dst, const Layout& L, int b,
                                           int h, int r0, int T,
                                           const float (&c)[8][4],
                                           const float (&scale)[2], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    if (row >= T) continue;
    bf16* out = dst + offset(L, b, h, row) + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * n) = __floats2bfloat162_rn(
          c[n][2 * i] * scale[i], c[n][2 * i + 1] * scale[i]);
  }
}

// ---------------------------------------------------------------------------
// Forward: o and (when asked) the row log-sum-exp. One block per
// (16*NW-query tile, head, sample); 64-key tiles streamed.
// ---------------------------------------------------------------------------
template <int NW>
constexpr int fwd_smem_bytes() {
  return (16 * NW + 4 * BN) * LDS * 2;  // q tile, two stages of k and v
}

template <int NW>
__global__ void __launch_bounds__(32 * NW) flash_fwd_kernel(const FwdParams p) {
  constexpr int BM = 16 * NW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BM][LDS]
  bf16* ks = qs + BM * LDS;                      // [2][BN][LDS]
  bf16* vs = ks + 2 * TILE;                      // [2][BN][LDS]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int r0 = q0 + 16 * warp;  // this warp's first query row
  // Key tiles wholly above the diagonal hold no unmasked entry of this block.
  const int k_end = p.causal ? min(p.Tk, q0 + BM) : p.Tk;
  const int n_tiles = (k_end + BN - 1) / BN;

  load_tile<BM>(qs, p.q, p.lq, b, h, q0, p.Tq);
  load_tile<BN>(ks, p.k, p.lk, b, h, 0, p.Tk);
  load_tile<BN>(vs, p.v, p.lv, b, h, 0, p.Tk);
  cp_async_commit();
  if (n_tiles > 1) {
    load_tile<BN>(ks + TILE, p.k, p.lk, b, h, BN, p.Tk);
    load_tile<BN>(vs + TILE, p.v, p.lv, b, h, BN, p.Tk);
  }
  cp_async_commit();

  uint32_t qa[4][4];
  float m[2] = {-INFINITY, -INFINITY};  // running row max
  float l[2] = {0.f, 0.f};  // this lane's part of the running row sum
  float o[8][4] = {};
  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait_but_one();  // tile j (and the q tile) landed
    __syncthreads();
    if (j == 0) load_a(qa, qs, 16 * warp, lane);
    const bf16* kt = ks + (j & 1) * TILE;
    const bf16* vt = vs + (j & 1) * TILE;
    float s[8][4] = {};
    mma_abt(s, qa, kt, lane);

    const int k0 = j * BN;
    if (k0 + BN > p.Tk || (p.causal && k0 + BN - 1 > r0)) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * n + 2 * t + (e & 1);
          const int row = r0 + g + 8 * (e >> 1);
          if (col >= p.Tk || (p.causal && col > row)) s[n][e] = sar::kNeg;
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mt = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n) mt = fmaxf(mt, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
      mt = sar::group_max<4>(mt);  // the 4 lanes sharing the row
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile
      float ls = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          s[n][e] = expf(s[n][e] - m_new);
          ls += s[n][e];
        }
      l[i] = l[i] * alpha + ls;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        o[n][2 * i] *= alpha;
        o[n][2 * i + 1] *= alpha;
      }
      m[i] = m_new;
    }
    uint32_t pa[4][4];
    to_a(pa, s);  // the unnormalised p, rounded to v's dtype
    mma_ab(o, pa, vt, lane);

    __syncthreads();  // every warp is done with this stage
    if (j + 2 < n_tiles) {
      load_tile<BN>(ks + (j & 1) * TILE, p.k, p.lk, b, h, k0 + 2 * BN, p.Tk);
      load_tile<BN>(vs + (j & 1) * TILE, p.v, p.lv, b, h, k0 + 2 * BN, p.Tk);
    }
    cp_async_commit();
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = sar::group_sum<4>(l[i]);
    inv[i] = 1.f / l[i];
  }
  store_rows(p.o, p.lo, b, h, r0, p.Tq, o, inv, lane);
  if (p.lse != nullptr && t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + g + 8 * i;
      if (row < p.Tq) p.lse[((long long)b * p.H + h) * p.Tq + row] = m[i] + logf(l[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, dQ: one block per (16*NW-query tile, head, sample); 64-key
// tiles streamed.
// ---------------------------------------------------------------------------
template <int NW>
constexpr int dq_smem_bytes() {
  return (2 * 16 * NW + 4 * BN) * LDS * 2;  // q and do tiles, two stages of k, v
}

template <int NW>
__global__ void __launch_bounds__(32 * NW) flash_bwd_dq_kernel(const BwdParams p) {
  constexpr int BM = 16 * NW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BM][LDS]
  bf16* dos = qs + BM * LDS;                     // [BM][LDS]
  bf16* ks = dos + BM * LDS;                     // [2][BN][LDS]
  bf16* vs = ks + 2 * TILE;                      // [2][BN][LDS]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int r0 = q0 + 16 * warp;
  const int k_end = p.causal ? min(p.Tk, q0 + BM) : p.Tk;
  const int n_tiles = (k_end + BN - 1) / BN;

  load_tile<BM>(qs, p.q, p.lq, b, h, q0, p.Tq);
  load_tile<BM>(dos, p.dout, p.ldo, b, h, q0, p.Tq);
  load_tile<BN>(ks, p.k, p.lk, b, h, 0, p.Tk);
  load_tile<BN>(vs, p.v, p.lv, b, h, 0, p.Tk);
  cp_async_commit();
  if (n_tiles > 1) {
    load_tile<BN>(ks + TILE, p.k, p.lk, b, h, BN, p.Tk);
    load_tile<BN>(vs + TILE, p.v, p.lv, b, h, BN, p.Tk);
  }
  cp_async_commit();

  const long long row_base = ((long long)b * p.H + h) * p.Tq;
  float lse[2], di[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    lse[i] = row < p.Tq ? p.lse[row_base + row] : 0.f;
    di[i] = row < p.Tq ? p.di[row_base + row] : 0.f;
  }

  uint32_t qa[4][4], da[4][4];
  float dq[8][4] = {};
  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait_but_one();
    __syncthreads();
    if (j == 0) {
      load_a(qa, qs, 16 * warp, lane);
      load_a(da, dos, 16 * warp, lane);
    }
    const bf16* kt = ks + (j & 1) * TILE;
    const bf16* vt = vs + (j & 1) * TILE;
    float s[8][4] = {}, dp[8][4] = {};
    mma_abt(s, qa, kt, lane);   // s = q k^T
    mma_abt(dp, da, vt, lane);  // dp = do v^T

    const int k0 = j * BN;
    const bool edge = k0 + BN > p.Tk || r0 + 16 > p.Tq || (p.causal && k0 + BN - 1 > r0);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float pe = expf(s[n][e] - lse[i]);
        if (edge) {
          const int col = k0 + 8 * n + 2 * t + (e & 1);
          const int row = r0 + g + 8 * i;
          if (col >= p.Tk || row >= p.Tq || (p.causal && col > row)) pe = 0.f;
        }
        s[n][e] = pe * (dp[n][e] - di[i]);  // ds
      }
    uint32_t dsa[4][4];
    to_a(dsa, s);  // bf16(ds)
    mma_ab(dq, dsa, kt, lane);

    __syncthreads();
    if (j + 2 < n_tiles) {
      load_tile<BN>(ks + (j & 1) * TILE, p.k, p.lk, b, h, k0 + 2 * BN, p.Tk);
      load_tile<BN>(vs + (j & 1) * TILE, p.v, p.lv, b, h, k0 + 2 * BN, p.Tk);
    }
    cp_async_commit();
  }
  const float one[2] = {1.f, 1.f};
  store_rows(p.dq, p.ldq, b, h, r0, p.Tq, dq, one, lane);
}

// ---------------------------------------------------------------------------
// Backward, dK and dV: one block per (16*NW-key tile, head, sample); 64-query
// tiles (with their lse and di) streamed.
// ---------------------------------------------------------------------------
template <int NW>
constexpr int dkv_smem_bytes() {
  // k and v tiles, two stages of q and do, two stages of lse and di
  return (2 * 16 * NW + 4 * BN) * LDS * 2 + 4 * BN * 4;
}

template <int NW>
__global__ void __launch_bounds__(32 * NW) flash_bwd_dkv_kernel(const BwdParams p) {
  constexpr int BM = 16 * NW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [BM][LDS]
  bf16* vs = ks + BM * LDS;                      // [BM][LDS]
  bf16* qs = vs + BM * LDS;                      // [2][BN][LDS]
  bf16* dos = qs + 2 * TILE;                     // [2][BN][LDS]
  float* lses = reinterpret_cast<float*>(dos + 2 * TILE);  // [2][BN]
  float* dis = lses + 2 * BN;                              // [2][BN]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int r0 = k0 + 16 * warp;  // this warp's first key
  const long long row_base = ((long long)b * p.H + h) * p.Tq;
  // Query tiles wholly above the diagonal see none of these keys.
  const int q_start = p.causal ? k0 : 0;
  const int n_tiles = (p.Tq - q_start + BN - 1) / BN;

  auto load_queries = [&](int j, int stage) {
    const int qt0 = q_start + j * BN;
    load_tile<BN>(qs + stage * TILE, p.q, p.lq, b, h, qt0, p.Tq);
    load_tile<BN>(dos + stage * TILE, p.dout, p.ldo, b, h, qt0, p.Tq);
    for (int c = threadIdx.x; c < 2 * BN; c += blockDim.x) {
      const int r = c % BN;
      const bool valid = qt0 + r < p.Tq;
      const long long at = row_base + (valid ? qt0 + r : 0);
      if (c < BN)
        cp_async4(lses + stage * BN + r, p.lse + at, valid);
      else
        cp_async4(dis + stage * BN + r, p.di + at, valid);
    }
  };
  load_tile<BM>(ks, p.k, p.lk, b, h, k0, p.Tk);
  load_tile<BM>(vs, p.v, p.lv, b, h, k0, p.Tk);
  load_queries(0, 0);
  cp_async_commit();
  if (n_tiles > 1) load_queries(1, 1);
  cp_async_commit();

  uint32_t ka[4][4], va[4][4];
  float dk[8][4] = {}, dv[8][4] = {};
  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait_but_one();
    __syncthreads();
    if (j == 0) {
      load_a(ka, ks, 16 * warp, lane);
      load_a(va, vs, 16 * warp, lane);
    }
    const int stage = j & 1;
    const bf16* qt = qs + stage * TILE;
    const bf16* dot = dos + stage * TILE;
    const float* ls = lses + stage * BN;
    const float* ds_i = dis + stage * BN;
    float s[8][4] = {}, dp[8][4] = {};
    mma_abt(s, ka, qt, lane);    // s^T = k q^T
    mma_abt(dp, va, dot, lane);  // dp^T = v do^T

    const int qt0 = q_start + j * BN;
    const bool edge = r0 + 16 > p.Tk || qt0 + BN > p.Tq || (p.causal && r0 + 15 > qt0);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * n + 2 * t + (e & 1);  // query within the tile
        float pe = expf(s[n][e] - ls[qc]);
        if (edge) {
          const int key = r0 + g + 8 * (e >> 1);
          const int qi = qt0 + qc;
          if (key >= p.Tk || qi >= p.Tq || (p.causal && key > qi)) pe = 0.f;
        }
        dp[n][e] = pe * (dp[n][e] - ds_i[qc]);  // ds^T
        s[n][e] = pe;                           // p^T
      }
    uint32_t pa[4][4], dsa[4][4];
    to_a(pa, s);    // bf16(p)^T
    to_a(dsa, dp);  // bf16(ds)^T
    mma_ab(dv, pa, dot, lane);  // dv += p^T do
    mma_ab(dk, dsa, qt, lane);  // dk += ds^T q

    __syncthreads();
    if (j + 2 < n_tiles) load_queries(j + 2, stage);
    cp_async_commit();
  }
  const float one[2] = {1.f, 1.f};
  store_rows(p.dk, p.ldk, b, h, r0, p.Tk, dk, one, lane);
  store_rows(p.dv, p.ldv, b, h, r0, p.Tk, dv, one, lane);
}

Layout layout_at(const long long* strides, int i) {
  return Layout{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

bool bad_shape(int B, int H, int Tq, int Tk, int causal) {
  return B < 1 || H < 1 || Tq < 1 || Tk < 1 || B > 65535 || H > 65535 ||
         (causal && Tq != Tk);
}

using sar::allow_smem_once;
using sar::kMaxDevices;

bool fwd_smem_done[kMaxDevices] = {};
bool dkv_smem_done[kMaxDevices] = {};
bool dq_smem_done[kMaxDevices] = {};

}  // namespace

cudaError_t sar::flash_fwd_launch(const FwdParams& p, int B, int device,
                                  cudaStream_t stream) {
  constexpr int smem = fwd_smem_bytes<FWD_NW>();
  const cudaError_t err =
      allow_smem_once(fwd_smem_done, device, flash_fwd_kernel<FWD_NW>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Tq + 16 * FWD_NW - 1) / (16 * FWD_NW), p.H, B);
  flash_fwd_kernel<FWD_NW><<<grid, 32 * FWD_NW, smem, stream>>>(p);
  return cudaGetLastError();
}

// strides: (batch, head, row) element strides of q, k, v, o.
extern "C" int sar_flash_attn_fwd(const void* q, const void* k, const void* v,
                                  void* o, void* lse, const long long* strides,
                                  int B, int H, int Tq, int Tk, int causal,
                                  int device, void* stream) {
  if (bad_shape(B, H, Tq, Tk, causal)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  FwdParams p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<bf16*>(o);
  p.lse = static_cast<float*>(lse);
  p.lq = layout_at(strides, 0);
  p.lk = layout_at(strides, 1);
  p.lv = layout_at(strides, 2);
  p.lo = layout_at(strides, 3);
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.causal = causal;
  return (int)sar::flash_fwd_launch(p, B, device,
                                    static_cast<cudaStream_t>(stream));
}

static BwdParams bwd_params(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse, const void* di,
                            const long long* strides, int H, int Tq, int Tk,
                            int causal) {
  BwdParams p = {};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dout = static_cast<const bf16*>(dout);
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
  constexpr int smem = dkv_smem_bytes<DKV_NW>();
  err = allow_smem_once(dkv_smem_done, device, flash_bwd_dkv_kernel<DKV_NW>, smem);
  if (err != cudaSuccess) return (int)err;
  BwdParams p = bwd_params(q, k, v, dout, lse, di, strides, H, Tq, Tk, causal);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.ldk = layout_at(strides, 4);
  p.ldv = layout_at(strides, 5);
  const dim3 grid((Tk + 16 * DKV_NW - 1) / (16 * DKV_NW), H, B);
  flash_bwd_dkv_kernel<DKV_NW><<<grid, 32 * DKV_NW, smem,
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
  constexpr int smem = dq_smem_bytes<DQ_NW>();
  err = allow_smem_once(dq_smem_done, device, flash_bwd_dq_kernel<DQ_NW>, smem);
  if (err != cudaSuccess) return (int)err;
  BwdParams p = bwd_params(q, k, v, dout, lse, di, strides, H, Tq, Tk, causal);
  p.dq = static_cast<bf16*>(dq);
  p.ldq = layout_at(strides, 4);
  const dim3 grid((Tq + 16 * DQ_NW - 1) / (16 * DQ_NW), H, B);
  flash_bwd_dq_kernel<DQ_NW><<<grid, 32 * DQ_NW, smem,
                               static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
