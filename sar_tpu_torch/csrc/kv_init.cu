// Fused cross-KV projection + int8 quantization: kernel K2, and K4 (K2 with
// a per-sample LoRA term on V), one template (RC = LoRA rank / 16; 0 is K2).
//
// K2 replaces sar_tpu/ops/kv_init.py::fused_kv_init without LoRA (Pallas
// `_kernel` -> `_cell_body` -> `_quantize_rows`). For every decoder layer l:
// K = x.Wk[l] and V = x.Wv[l] + bv[l] with fp32 sums, the bias added in
// fp32, rounded to bf16 (the compute dtype) once, then symmetric int8 per
// (row, head): scale = max(max|y|, 1e-8) / 127, q = clip(rint(y / scale),
// -127, 127). Rows >= t_valid are written as 0 with scale 0 (the decode
// kernel keys its padding mask on scale > 0). Outputs are the head-minor
// cache fields: kq/vq [L, B, S_pad, H*64] s8 and ks/vs [L, B, H, S_pad] f32
// (head-major).
//
// K4 replaces kv_init.py::fused_kv_init with va/vb (Pallas `_kernel_lora`).
// va [L, Bv, D, R] / vb [L, Bv, R, D] are an adapter bank's cross_v slices,
// Bv = B (one adapter per sample) or 1 (one for the whole batch). With the
// TPU kernel's rounding points:
//   u   = bf16(x[b] @ va[l, b'])             fp32 sum, rounded to bf16
//   V32 = (x[b] @ Wv[l] + bv[l]) + lora_scale * (u @ vb[l, b'])
// then V32 is rounded to bf16 once and quantized as in K2; K is K2's.
//
// Bound on the H100: operations. At whisper-small B=8 (12 layers, 1500 valid
// of S_pad 1536 rows, d_model 768) the two projections are 4*L*B*S*D*D =
// 340 GFLOP (0.34 ms at 989 TFLOP/s); the LoRA term adds 4*L*B*S*D*r = 7
// GFLOP at r=16; the int8 outputs are 226 MB (0.07 ms). Design, for the
// tensor cores:
//   - per layer a [B*S_pad, D] x [D, 2D] product on mma.sync m16n8k16 (bf16
//     operands, fp32 sums): A fragments from the x tile with ldmatrix, B
//     fragments from the [k][n] W tile with ldmatrix.trans (the mma_ab
//     pattern of flash_attn.cu); x and the block's W columns stream through
//     a STAGES-deep cp.async ring of 32-deep k slices;
//   - a block owns BM rows (never two samples: S_pad % BM == 0) and HEADS
//     heads' 64 columns of both K and V; a warp owns 32 rows of ONE head's
//     columns of K or of V, so the per-(row, head) amax is a max over the
//     thread's own accumulators and two shuffles across the quad that
//     shares a row: no shared-memory reduction, no second pass, and the
//     bf16 K/V never exist in device memory;
//   - the grid walks heads fastest, then row tiles, then layers, so the
//     blocks resident at once share their x tiles and one layer's W in L2;
//   - the epilogue in registers: the bias (V), K4's LoRA term, one bf16
//     rounding, the scale and the rounded int8, staged through the idle
//     ring for 16-byte stores; a warp's 32 scales of one head are 32
//     consecutive floats of the head-major scale plane;
//   - K4, two launches: lora_u_kernel sums u = x @ va once per (row, layer)
//     on the CUDA cores, in k order with fmaf, and rounds it to bf16 into
//     the caller's scratch [L, B * S_pad, R]; u is rounded before it
//     multiplies vb, and a u that rounds the other way than the plain
//     version's fp32 sum moves a whole row of V (a tensor-core u, summed in
//     another order, moved int8 values by 2); summed per head block it
//     would be summed H times. The projection kernel then loads its rows of
//     u and vb's [R x 64] rows of its heads into shared memory with its
//     first ring stage, and the V warps multiply them on the tensor cores,
//     one n-tile at a time, added as (acc + bv) + lora_scale * d without
//     contraction.
// The configurations (kKvConfigs) are picked at launch from S_pad and the
// head count and mirrored by ops/kv_init.py::KV_CONFIGS. Of the tiles timed
// on an H100 at whisper-small B=8, 128 rows x one head with a 3-stage ring
// of 32-deep slices was the fastest (4 stages, 2 stages, 64-deep slices,
// and two heads of 64 or 128 rows were slower).
//
// Rounding: rintf (half to even, like jnp.round) and IEEE division (the
// library is compiled without --use_fast_math).
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int HD = 64;       // head_dim: a warp owns one head's 64 columns
constexpr int WM = 32;       // rows of a warp tile
constexpr int BK = 32;       // k slice per ring stage
constexpr int RG = 16;       // LoRA rank granule
constexpr int MAX_RC = 4;    // ranks up to 64
constexpr int kMaxSmem = 232448;

// BM rows per block, HEADS heads per block (K and V of each), a STAGES-deep
// ring; (BM / 32) * 2 * HEADS warps of 32 x 64.
struct KvConfig {
  int bm, heads, stages;
};

// In order of preference; the first whose BM divides S_pad, whose HEADS
// divides the head count and whose shared memory fits is taken.
constexpr KvConfig kKvConfigs[] = {
    {128, 1, 3},  // 8 warps
    {64, 1, 3},   // 4 warps: S_pad not a multiple of 128
};
constexpr int kNumKvConfigs = sizeof(kKvConfigs) / sizeof(kKvConfigs[0]);

// Ring stage (bf16): x [BM][BK + 8], W [BK][HEADS * 128 + 8]; then (K4) vb
// [HEADS][R][64 + 8] and u [BM][R + 8]. The +8 pads put the 8 rows an
// ldmatrix phase reads in distinct banks.
constexpr int stage_elems(const KvConfig& c) {
  return c.bm * (BK + 8) + BK * (c.heads * 2 * HD + 8);
}
constexpr int smem_bytes(const KvConfig& c, int R) {
  return 2 * (c.stages * stage_elems(c) + (R > 0 ? c.heads * R * (HD + 8) + c.bm * (R + 8) : 0));
}

int kv_pick(int S_pad, int H, int R) {
  for (int i = 0; i < kNumKvConfigs; ++i) {
    const KvConfig& c = kKvConfigs[i];
    if (S_pad % c.bm == 0 && H % c.heads == 0 && smem_bytes(c, R) <= kMaxSmem) return i;
  }
  return -1;
}

// K4's first launch: u = bf16(x[b] @ va[l, b']) into u [L, B * S_pad, R],
// each sum an fmaf chain in k order (the plain version's fp32 product). A
// block owns 64 rows of one layer; a thread 8 rows x TN ranks, so each
// shared-memory read feeds TN or 8 fmafs; x and va stream through shared
// memory as fp32 in 32-deep slices.
template <int RC>
struct LoraU {
  static constexpr int R = RC * RG, ROWS = 64, TM = 8, TN = R == 16 ? 4 : 8;
  static constexpr int NT = (ROWS / TM) * (R / TN);
};

template <int RC>
__global__ void __launch_bounds__(LoraU<RC>::NT)
lora_u_kernel(const bf16* __restrict__ x,   // [B, S_pad, D]
              const bf16* __restrict__ va,  // [L, Bv, D, R]
              bf16* __restrict__ u,         // [L, B * S_pad, R]
              int B, int Bv, int S_pad, int D) {
  using P = LoraU<RC>;
  constexpr int R = P::R, TM = P::TM, TN = P::TN, NT = P::NT, RGROUPS = P::ROWS / TM;
  __shared__ float xs[P::ROWS][BK + 1];
  __shared__ __align__(16) float vas[BK][R];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * P::ROWS, l = blockIdx.y;
  const int b = row0 / S_pad;
  const bf16* xb = x + (size_t)row0 * D;
  const bf16* val = va + ((size_t)l * Bv + (Bv == 1 ? 0 : b)) * D * R;
  const int rg = tid % RGROUPS, c0 = (tid / RGROUPS) * TN;  // rows rg + 8i; ranks c0..
  float acc[TM][TN] = {};
  for (int k0 = 0; k0 < D; k0 += BK) {
    for (int c = tid; c < P::ROWS * (BK / 8); c += NT) {
      float f[8];
      const int r = c / (BK / 8), col = (c % (BK / 8)) * 8;
      sar::load_bf16x8(xb + (size_t)r * D + k0 + col, f);
#pragma unroll
      for (int i = 0; i < 8; ++i) xs[r][col + i] = f[i];
    }
    for (int c = tid; c < BK * (R / 8); c += NT) {
      float f[8];
      const int r = c / (R / 8), col = (c % (R / 8)) * 8;
      sar::load_bf16x8(val + (size_t)(k0 + r) * R + col, f);
#pragma unroll
      for (int i = 0; i < 8; ++i) vas[r][col + i] = f[i];
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      float w[TN];
#pragma unroll
      for (int j = 0; j < TN; j += 4)
        *reinterpret_cast<float4*>(w + j) = *reinterpret_cast<const float4*>(&vas[k][c0 + j]);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float xv = xs[rg + RGROUPS * i][k];
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(xv, w[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    bf16* ub = u + ((size_t)l * B * S_pad + row0 + rg + RGROUPS * i) * R + c0;
#pragma unroll
    for (int j = 0; j < TN; j += 2)
      *reinterpret_cast<__nv_bfloat162*>(ub + j) = __floats2bfloat162_rn(acc[i][j], acc[i][j + 1]);
  }
}

// Two blocks of 8 warps per SM (128 registers a thread).
template <int BM, int HEADS, int STAGES, int RC>
__global__ void __launch_bounds__((BM / WM) * 2 * HEADS * 32, 16 / ((BM / WM) * 2 * HEADS))
fused_kv_init_kernel(const bf16* __restrict__ x,   // [B, S_pad, D]
                     const bf16* __restrict__ wk,  // [L, D, D]
                     const bf16* __restrict__ wv,  // [L, D, D]
                     const bf16* __restrict__ bv,  // [L, D]
                     const bf16* __restrict__ u,   // [L, B * S_pad, R] (K4)
                     const bf16* __restrict__ vb,  // [L, Bv, R, D]
                     int8_t* __restrict__ kq, float* __restrict__ ks,
                     int8_t* __restrict__ vq, float* __restrict__ vs,
                     int B, int Bv, int S_pad, int D, int H, int t_valid,
                     float lora_scale) {
  constexpr int R = RC * RG;
  constexpr int NW = (BM / WM) * 2 * HEADS;
  constexpr int NT = NW * 32;
  constexpr int XLD = BK + 8;
  constexpr int WCOLS = HEADS * 2 * HD;  // columns: K h0, V h0, K h1, V h1
  constexpr int WLD = WCOLS + 8;
  constexpr int ALD = R + 8;
  constexpr int VLD = HD + 8;
  constexpr int X_ELEMS = BM * XLD, W_ELEMS = BK * WLD;
  constexpr int STAGE = X_ELEMS + W_ELEMS;
  constexpr int NF = HD / 8;   // n-tiles of a warp's 64 columns
  constexpr int MI = WM / 16;  // m-tiles of a warp's 32 rows
  static_assert(NW * WM * HD <= STAGES * STAGE * 2, "the int8 staging fits the ring");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // [STAGES][STAGE]
  bf16* vbs = ring + STAGES * STAGE;               // [HEADS][R][VLD]
  bf16* us = vbs + HEADS * R * VLD;                // [BM][ALD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h0 = blockIdx.x * HEADS;
  const int row0 = blockIdx.y * BM;  // in the flattened [B * S_pad] rows
  const int b = row0 / S_pad, s0 = row0 % S_pad;
  const int l = blockIdx.z;
  const bf16* xb = x + (size_t)row0 * D;
  const bf16* wkl = wk + (size_t)l * D * D;
  const bf16* wvl = wv + (size_t)l * D * D;
  const size_t lora_plane = (size_t)l * Bv + (Bv == 1 ? 0 : b);

  // Warp (wr, wc): rows 32*wr.., column group wc = 2 * head + (0: K, 1: V).
  const int wr = warp / (2 * HEADS), wc = warp % (2 * HEADS);
  const bool is_v = wc & 1;
  const int head = h0 + wc / 2;

  const int n_k = D / BK;
  auto load_stage = [&](int it) {
    bf16* st = ring + (it % STAGES) * STAGE;
    const int k0 = it * BK;
    for (int c = tid; c < BM * (BK / 8); c += NT) {
      const int r = c / (BK / 8), col = (c % (BK / 8)) * 8;
      sar::cp_async16(st + r * XLD + col, xb + (size_t)r * D + k0 + col, true);
    }
    for (int c = tid; c < BK * (WCOLS / 8); c += NT) {
      const int r = c / (WCOLS / 8), col = (c % (WCOLS / 8)) * 8;
      const int grp = col / HD;
      const bf16* w = (grp & 1 ? wvl : wkl) + (size_t)(k0 + r) * D + (h0 + grp / 2) * HD + col % HD;
      sar::cp_async16(st + X_ELEMS + r * WLD + col, w, true);
    }
  };

  // Group 0: vb's rows of the block's heads and u's rows of the block (K4)
  // and stage 0; then stages 1..S-2.
  if constexpr (R > 0) {
    const bf16* ub = u + ((size_t)l * B * S_pad + row0) * R;
    for (int c = tid; c < BM * (R / 8); c += NT) {
      const int r = c / (R / 8), col = (c % (R / 8)) * 8;
      sar::cp_async16(us + r * ALD + col, ub + (size_t)r * R + col, true);
    }
    const bf16* vbl = vb + lora_plane * R * D;
    for (int c = tid; c < HEADS * R * (HD / 8); c += NT) {
      const int hh = c / (R * (HD / 8)), rem = c % (R * (HD / 8));
      const int r = rem / (HD / 8), col = (rem % (HD / 8)) * 8;
      sar::cp_async16(vbs + (hh * R + r) * VLD + col, vbl + (size_t)r * D + (h0 + hh) * HD + col,
                      true);
    }
  }
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_k) load_stage(s);
    sar::cp_async_commit();
  }

  float acc[MI][NF][4] = {};
  const int a_off = (wr * WM + (lane & 15)) * XLD + (lane >> 4) * 8;
  const int b_off = (lane & 15) * WLD + wc * HD + (lane >> 4) * 8;

  // Each ring stage's products form a 32-deep partial sum (two chained
  // mma) that starts from 0 and joins the fp32 sums with a rounded add: a
  // long mma chain truncates as it accumulates, and its drifted sums,
  // rounded to bf16, land on the other side of a rounding point far more
  // often than an fp32 sum's; an int8 value then moves by 2 where its row's
  // scale moves too.
  for (int it = 0; it < n_k; ++it) {
    sar::cp_async_wait<STAGES - 2>();  // stage it landed
    __syncthreads();                   // ... for every thread; stage it - 1 is free
    if (it + STAGES - 1 < n_k) load_stage(it + STAGES - 1);
    sar::cp_async_commit();
    const bf16* st = ring + (it % STAGES) * STAGE;
    uint32_t a[BK / 16][MI][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) sar::ldsm_x4(a[kk][mi], st + a_off + mi * 16 * XLD + kk * 16);
#pragma unroll
    for (int dn = 0; dn < NF / 2; ++dn) {
      float p[MI][2][4] = {};
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t bf[4];
        sar::ldsm_x4_t(bf, st + X_ELEMS + b_off + kk * 16 * WLD + dn * 16);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          sar::mma(p[mi][0], a[kk][mi], bf[0], bf[1]);
          sar::mma(p[mi][1], a[kk][mi], bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[mi][2 * dn][e] += p[mi][0][e];
          acc[mi][2 * dn + 1][e] += p[mi][1][e];
        }
    }
  }
  sar::cp_async_wait<0>();
  __syncthreads();  // the ring is idle: it stages the int8 tiles below

  const int col0 = head * HD;  // the warp's columns in D
  if (is_v) {
    // (acc + bv) + lora_scale * (bf16(u) @ vb), one n-tile at a time.
    float2 bias[NF];
#pragma unroll
    for (int n = 0; n < NF; ++n)
      bias[n] = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(bv + (size_t)l * D + col0 + 8 * n + 2 * t));
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int n = 0; n < NF; ++n) {
        acc[mi][n][0] += bias[n].x;
        acc[mi][n][1] += bias[n].y;
        acc[mi][n][2] += bias[n].x;
        acc[mi][n][3] += bias[n].y;
      }
    if constexpr (R > 0) {
      // u's A fragments (k = rank) from the warp's rows of u, read again
      // for each n-tile pair rather than held in registers.
      const bf16* uw = us + (wr * WM + (lane & 15)) * ALD + (lane >> 4) * 8;
      const bf16* vbh = vbs + (wc / 2) * R * VLD + (lane & 15) * VLD + (lane >> 4) * 8;
#pragma unroll
      for (int dn = 0; dn < NF / 2; ++dn) {
        float d[MI][2][4] = {};
#pragma unroll
        for (int j = 0; j < R / 16; ++j) {
          uint32_t bf[4];
          sar::ldsm_x4_t(bf, vbh + j * 16 * VLD + dn * 16);
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) {
            uint32_t ua[4];
            sar::ldsm_x4(ua, uw + mi * 16 * ALD + j * 16);
            sar::mma(d[mi][0], ua, bf[0], bf[1]);
            sar::mma(d[mi][1], ua, bf[2], bf[3]);
          }
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[mi][2 * dn + i][e] =
                  __fadd_rn(acc[mi][2 * dn + i][e], __fmul_rn(lora_scale, d[mi][i][e]));
      }
    }
  }

  // Quantize each of the warp's rows over its 64 columns: round once to
  // bf16, the row's amax over the thread's 16 values and its quad, then the
  // int8 values into the warp's 32 x 64 staging tile and the scale.
  int8_t* stage8 = reinterpret_cast<int8_t*>(smem_raw) + warp * WM * HD;
  const size_t plane = (size_t)l * B + b;
  float* sdst = (is_v ? vs : ks) + (plane * H + head) * S_pad + s0 + wr * WM;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * mi + 8 * i + g;  // the row in the warp tile
      const bool valid = s0 + wr * WM + r < t_valid;
      float y[NF][2];
      float amax = 0.f;
#pragma unroll
      for (int n = 0; n < NF; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          y[n][e] = sar::bf16_round(acc[mi][n][2 * i + e]);
          amax = fmaxf(amax, fabsf(y[n][e]));
        }
      amax = sar::group_max<4>(amax);
      const float scale = fmaxf(amax, 1e-8f) / 127.0f;
#pragma unroll
      for (int n = 0; n < NF; ++n) {
        char2 qv;
        qv.x = valid ? (signed char)fminf(fmaxf(rintf(y[n][0] / scale), -127.f), 127.f) : 0;
        qv.y = valid ? (signed char)fminf(fmaxf(rintf(y[n][1] / scale), -127.f), 127.f) : 0;
        *reinterpret_cast<char2*>(stage8 + r * HD + 8 * n + 2 * t) = qv;
      }
      if (t == 0) sdst[r] = valid ? scale : 0.f;
    }
  __syncwarp();
  int8_t* qdst = (is_v ? vq : kq) + (plane * S_pad + s0 + wr * WM) * D + col0;
#pragma unroll
  for (int j = 0; j < WM * HD / 16 / 32; ++j) {
    const int c = lane + 32 * j;  // row c / 4, 16 columns (c % 4) * 16
    *reinterpret_cast<uint4*>(qdst + (size_t)(c / 4) * D + (c % 4) * 16) =
        *reinterpret_cast<const uint4*>(stage8 + (c / 4) * HD + (c % 4) * 16);
  }
}

bool smem_done[kNumKvConfigs][MAX_RC + 1][sar::kMaxDevices] = {};

template <int I, int RC>
int launch_config(const void* x, const void* wk, const void* wv, const void* bv,
                  const void* u, const void* vb, void* kq, void* ks, void* vq, void* vs,
                  int L, int B, int Bv, int S_pad, int D, int H, int t_valid,
                  float lora_scale, int device, cudaStream_t stream) {
  constexpr KvConfig c = kKvConfigs[I];
  const auto kernel = fused_kv_init_kernel<c.bm, c.heads, c.stages, RC>;
  const int smem = smem_bytes(c, RC * RG);
  const cudaError_t err = sar::allow_smem_once(smem_done[I][RC], device, kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H / c.heads, B * S_pad / c.bm, L);
  kernel<<<grid, (c.bm / WM) * 2 * c.heads * 32, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wk), static_cast<const bf16*>(wv),
      static_cast<const bf16*>(bv), static_cast<const bf16*>(u), static_cast<const bf16*>(vb),
      static_cast<int8_t*>(kq), static_cast<float*>(ks), static_cast<int8_t*>(vq),
      static_cast<float*>(vs), B, Bv, S_pad, D, H, t_valid, lora_scale);
  return (int)cudaGetLastError();
}

// K2 (RC = 0), or K4's two launches: u, then the projections.
template <int RC>
int launch(const void* x, const void* wk, const void* wv, const void* bv, const void* va,
           const void* vb, void* u, void* kq, void* ks, void* vq, void* vs, int L, int B,
           int Bv, int S_pad, int D, int H, int t_valid, float lora_scale, int device,
           cudaStream_t stream) {
  static_assert(kNumKvConfigs == 2, "one case per configuration");
  if constexpr (RC > 0) {
    lora_u_kernel<RC><<<dim3(B * S_pad / LoraU<RC>::ROWS, L), LoraU<RC>::NT, 0, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(va), static_cast<bf16*>(u), B,
        Bv, S_pad, D);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  switch (kv_pick(S_pad, H, RC * RG)) {
    case 0:
      return launch_config<0, RC>(x, wk, wv, bv, u, vb, kq, ks, vq, vs, L, B, Bv, S_pad, D,
                                  H, t_valid, lora_scale, device, stream);
    case 1:
      return launch_config<1, RC>(x, wk, wv, bv, u, vb, kq, ks, vq, vs, L, B, Bv, S_pad, D,
                                  H, t_valid, lora_scale, device, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int check_shapes(int L, int B, int S_pad, int D, int n_heads, int t_valid) {
  if (D != n_heads * HD || n_heads < 1 || n_heads > 65535 || S_pad % 64 != 0 ||
      t_valid < 1 || t_valid > S_pad || L < 1 || L > 65535 || B < 1 ||
      (long long)B * S_pad / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
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
  return launch<0>(x, wk, wv, bv, nullptr, nullptr, nullptr, kq, ks, vq, vs, L, B, 1, S_pad, D,
                   n_heads, t_valid, 0.f, device, static_cast<cudaStream_t>(stream));
}

// rank: the padded LoRA rank, a multiple of 16 up to 64; Bv: 1 or B; u: the
// caller's bf16 scratch [L, B * S_pad, rank].
extern "C" int sar_fused_kv_init_lora(const void* x, const void* wk,
                                      const void* wv, const void* bv,
                                      const void* va, const void* vb, void* u, void* kq,
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
#define SAR_KV_CASE(N) \
  case N:              \
    return launch<N>(x, wk, wv, bv, va, vb, u, kq, ks, vq, vs, L, B, Bv, S_pad, D, n_heads, t_valid, lora_scale, device, s);
    SAR_KV_CASE(1)
    SAR_KV_CASE(2)
    SAR_KV_CASE(3)
    SAR_KV_CASE(4)
#undef SAR_KV_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
