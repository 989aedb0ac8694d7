// One decode step of s8 attention over int8 head-minor slabs: K7 (cross
// attention with s8 scores, K = 1..8 beams folded per sample) and K9 (self
// attention of one query over the s8 self cache, masked at a dynamic
// valid length), one kernel body for both.
//
// Replaces sar_tpu/ops/decode_cross.py::cross_decode_attention (Pallas
// `_kernel`, the `scores_int8` opt-in) and
// sar_tpu/ops/attic/decode_self.py::self_decode_attention (Pallas `_kernel`
// / `_cell`, a parked experiment with no caller in either package). Per
// sample b, beam k and head h, over layer `layer`'s slab of the FULL
// stacked cache (kq/vq [L, B, S, H*64] s8, ks/vs [L, B, H, S] f32), with the
// query quantized per (row, head) by the caller (qq [B, K, H*64] s8, qs
// [B, K*H] f32, row k*H + h; K9 is K = 1):
//   score_s = float(qq . kq_s) * qs * ks_s      (exact int32 dot)
//   masked (-1e30) where ks_s <= 0 (K7: layout padding carries scale 0) or
//   s >= n (K9: n = pos + 1, read from device memory when given, so one
//   build serves every position); an fp32 softmax normalised by the global
//   sum before pw_s = p_s * vs_s; pw re-quantized per (b, k, h) row:
//   ps = max(max_s |pw_s|, 1e-8) / 127, pq_s = clamp(rint(pw_s / ps), +-127)
//   (round half to even, exact division: no fast math), and
//   out = float(sum_s pq_s * vq_s) * ps         (exact int32 sum), bf16.
// If every row is masked the softmax is uniform over all S rows, as in the
// TPU kernels (K9 at n = 0 reads every v row).
//
// Bound on the H100: bytes of the int8 slab. K7 at whisper-small B=8 reads
// 2*B*S_pad*D = 18.9 MB of kq/vq plus 0.8 MB of scales per call (6.0 us at
// 3.35 TB/s), K9 at max_len 448 and n = 448 5.9 MB (1.75 us); both do
// 4*B*K*S*D int8 operations, nothing against 1,979 TOP/s. One block per
// (head, sample), as the single-block kernels it replaces ran, gives 96 blocks for
// 132 SMs with one 16-byte load in flight per thread. Design (K3/K5's
// cluster split, csrc/decode_cross.cu, carried over to s8 scores):
//   - a cluster of C <= 8 blocks per (head, sample), C = ceil(S /
//     min_slice), each block owning a slice of ceil(S / C) rows (mirrored
//     by ops/decode_cross.py::s8_cluster_split for K7 and
//     ops/attic/decode_self.py::cluster_split for K9, whose C is fixed by
//     max_len since n is dynamic);
//   - bytes in flight: a lane reads 16 bytes of a row (4 lanes a row, 8
//     rows a warp), U loads per lane issued before any is used; the v
//     slice and its scales go into shared memory by cp.async (a ring of up
//     to RING_ROWS rows in stages of STAGE_ROWS; a longer slice streams
//     through it), so v lands while the scores are computed. A K9 block
//     whose slice starts at or past n > 0 reads no bytes;
//   - exact integer products: from K = SAR_S8_QK_MMA_FROM (and
//     SAR_S8_PV_MMA_FROM) up on the tensor cores, below on __dp4a. The
//     scores as mma.sync m16n8k32 s8 with A = 16 k rows x 32 bytes and B =
//     the K beam queries (both hd-contiguous as stored: the contraction's
//     byte order is permuted the same way on both sides, so lane t's 16
//     contiguous bytes feed it); P.V as V^T . P^T with A = 16 v columns x
//     32 rows, the slice's bytes transposed by hand (__byte_perm, 4 x 4
//     bytes) from the ring, and B = the s8 probabilities, which sit
//     row-contiguous in shared memory. Every sum is an exact int32, so
//     either path gives the same bits;
//   - the softmax and the re-quantization across the cluster in three
//     exchanges through distributed shared memory, no atomics: (1) the
//     warps of each beam form the block's (max m, sum exp(s - m)) and push
//     it into every block; after a cluster barrier each block forms the
//     global M and tot in rank order; (2) each block evaluates its slice's
//     pw = (exp(s - M) / tot) * vs, keeps it in place of the scores, and
//     pushes its max |pw| into every block, so that ps = max(max_s |pw_s|,
//     1e-8) / 127 is the exact maximum over the kernel's own pw (a max is
//     the same in any order); (3) each block quantizes its own slice and
//     pushes its int32 [K][64] P.V partial into rank 0, which adds them
//     (integers: any order, the same bits) and stores bf16. A slice of
//     padding rows posts (-1e30, its row count), a K9 slice past n (-inf,
//     0), which a real row's M turns into 0. K9 with every valid row in
//     rank 0's slice runs rank 0 alone, with no exchange (the other blocks
//     leave at once). Until a repair, exchange 2 rode on exchange 1 as one
//     candidate row per block, which picked the wrong row where two rows'
//     products tie to rounding (ps an ulp short).
//   - a probe build of the same kernel (non-null probe pointers) also
//     writes every row's pw and each row's ps, for the tests that hold ps
//     and the s8 probabilities to the kernel's own pw bit for bit.
// The sizes won a timed sweep of variants of this file built with -D, at
// whisper-small B=8 on an H100 80GB HBM3 at 700 W, before the third
// exchange: after the data, a call's critical path is the exchanges and
// block barriers (~4.5 us of K7's ~13 us at K = 1), so fewer, longer slices that fit in one wave won
// (K7: C = 3 of 512 rows over C = 6 of 256; K9: C = 2 of 224 over 4 or 7),
// 256 threads over 128, 8 loads a lane over 16; the tensor cores win from
// K = 2 (at K = 8 0.0236 ms against __dp4a's 0.0345), __dp4a at K = 1.
#include <cooperative_groups.h>

#include "cluster.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

// Design choices a build may override with -D; these defaults are the
// sweep's picks.
#ifndef SAR_S8_QK_MMA_FROM
#define SAR_S8_QK_MMA_FROM 2
#endif
#ifndef SAR_S8_PV_MMA_FROM
#define SAR_S8_PV_MMA_FROM 2
#endif
#ifndef SAR_S8_CROSS_MIN_SLICE
#define SAR_S8_CROSS_MIN_SLICE 512
#endif
#ifndef SAR_S8_SELF_MIN_SLICE
#define SAR_S8_SELF_MIN_SLICE 256
#endif

#ifndef SAR_S8_THREADS
#define SAR_S8_THREADS 256
#endif
#ifndef SAR_S8_LOADS
#define SAR_S8_LOADS 8
#endif

namespace {

constexpr int HD = 64;             // head_dim
constexpr int NT = SAR_S8_THREADS;  // threads per block
constexpr int NW = NT / 32;
constexpr int U = SAR_S8_LOADS;     // k loads (8 rows of a warp each) a lane has in flight
constexpr int BATCH_ROWS = U * NW * 8;  // rows of one round of k loads
constexpr int KSTEP = 32;          // rows per P.V product step
constexpr int STAGE_ROWS = NW * KSTEP / 2;  // v rows per ring stage: one k-step per warp pair
constexpr int RING_ROWS = 512;     // v rows the ring holds (32 KB)
constexpr int NS = RING_ROWS / STAGE_ROWS;  // v ring stages
constexpr int MAX_CLUSTER = 8;
constexpr int MAX_BEAMS = 8;
// Dynamic shared memory a block may ask for: the card's 232,448 bytes less
// 48 KB for the static arrays (under 10 KB, at K = 8).
constexpr int kMaxDynamicSmem = 232448 - 48 * 1024;
constexpr int kScaleMask = 0;      // K7: rows with ks <= 0 are masked
constexpr int kLengthMask = 1;     // K9: rows at or past n are masked
static_assert(STAGE_ROWS * 4 % NT == 0, "whole 16-byte copies per thread and stage");

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }
// The split of S over a cluster and the shared memory one block needs.
__host__ __device__ constexpr int cluster_size(int S, int min_slice) {
  return ceil_div(S, min_slice) < MAX_CLUSTER ? ceil_div(S, min_slice) : MAX_CLUSTER;
}
__host__ __device__ constexpr int ring_stages(int slice) {
  return ceil_div(slice, STAGE_ROWS) < NS ? ceil_div(slice, STAGE_ROWS) : NS;
}
// s8 probability rows: whole k-steps, plus 16 bytes so that the 8 beams'
// rows start in different banks.
__host__ __device__ constexpr int pq_stride(int slice) {
  return ceil_div(slice, KSTEP) * KSTEP + 16;
}
// The v ring (int8), K rows of slice scores and the slice's v scales
// (fp32), K rows of s8 probabilities, then the C blocks' int32 [K][64] P.V
// partials (read in rank 0).
__host__ __device__ constexpr int dynamic_smem_bytes(int K, int slice, int C) {
  return ring_stages(slice) * STAGE_ROWS * HD + 4 * (K + 1) * slice + K * pq_stride(slice) +
         4 * C * K * HD;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  sar::cp_async16(static_cast<__nv_bfloat16*>(dst),
                  static_cast<const __nv_bfloat16*>(src), valid);
}

// w[i] = byte i of r[0], r[1], r[2], r[3] (a 4 x 4 byte transpose).
__device__ __forceinline__ void transpose4(const uint32_t (&r)[4], uint32_t (&w)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140), t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140), t3 = __byte_perm(r[2], r[3], 0x7362);
  w[0] = __byte_perm(t0, t2, 0x5410);
  w[1] = __byte_perm(t0, t2, 0x7632);
  w[2] = __byte_perm(t1, t3, 0x5410);
  w[3] = __byte_perm(t1, t3, 0x7632);
}

// The ring keeps a row's four 16-byte chunks with chunk c at c ^ ((row >>
// 2) & 3), so that the P.V reads of four rows 4 apart hit other banks.
__device__ __forceinline__ int ring_chunk(int c, int row) { return c ^ ((row >> 2) & 3); }

// Three blocks an SM must hold (the registers a thread may have): K7's 3 x
// 96 blocks at whisper-small B=8 run in one wave.
template <int K, int MASK>
__global__ void __launch_bounds__(NT, 3 * 256 / NT)
s8_decode_kernel(const int8_t* __restrict__ qq,   // [B, K, D]
                 const float* __restrict__ qs,    // [B, K*H]
                 const int8_t* __restrict__ kq,   // [L, B, S, D]
                 const float* __restrict__ ks,    // [L, B, H, S]
                 const int8_t* __restrict__ vq,
                 const float* __restrict__ vs,
                 const int* __restrict__ n_dev, int n_host,  // K9's valid length
                 __nv_bfloat16* __restrict__ out,  // [B, K, D]
                 float* __restrict__ probe_pw,     // [B, K, H, S] or null
                 float* __restrict__ probe_ps,     // [B, K, H] or null
                 int8_t* __restrict__ probe_pq,    // [B, K, H, S] or null
                 int B, int S, int D, int H, int layer, int slice) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int pqs = pq_stride(slice);
  int8_t* ring = reinterpret_cast<int8_t*>(smem_raw);  // [stages][STAGE_ROWS][64]
  float* sc = reinterpret_cast<float*>(smem_raw + ring_stages(slice) * STAGE_ROWS * HD);  // [K][slice]
  float* vsc = sc + K * slice;                                                          // [slice]
  int8_t* pq = reinterpret_cast<int8_t*>(vsc + slice);                                  // [K][pqs]
  int* parts = reinterpret_cast<int*>(pq + K * pqs);                     // [C][K][64]
  // Per beam: this block's (max, sum of exp(s - max)) and its max |pw|,
  // pushed into every block; the global (M, tot, ps).
  __shared__ float2 stats[MAX_CLUSTER][K];
  __shared__ float pmax[MAX_CLUSTER][K];
  __shared__ float3 glob[K];
  __shared__ int red[NW / 2][K][HD];          // the warp pairs' P.V partials

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  int n_valid = S;
  if (MASK == kLengthMask) {
    const int n = n_dev != nullptr ? *n_dev : n_host;
    n_valid = n < 0 ? 0 : (n > S ? S : n);
  }
  // K9 with every valid row in rank 0's slice (and any single-block
  // cluster): the other blocks contribute nothing, so rank 0 runs alone,
  // with no cluster barrier, and they leave at once.
  const bool solo = C == 1 || (MASK == kLengthMask && n_valid > 0 && n_valid <= slice);
  if (solo && rank > 0) return;
  const int CE = solo ? 1 : C;  // the blocks that take part
  if (!solo) sar::cluster_arrive();  // paired with cluster_wait() before the first remote store
  const int lo = min(S, rank * slice), hi = min(S, lo + slice);
  const int rows = hi - lo;
  // Rows [0, nk) of the slice are read and scored, rows [0, nv) of v read;
  // with n = 0 every row is masked and the softmax is uniform over all.
  const int nk = max(0, min(hi, n_valid) - lo);
  const int nv = MASK == kLengthMask && n_valid == 0 ? rows : nk;
  const size_t plane = (size_t)layer * B + b;
  const int8_t* kb = kq + plane * S * D + h * HD;
  const int8_t* vb = vq + plane * S * D + h * HD;
  const float* ksb = ks + (plane * H + h) * S;
  const float* vsb = vs + (plane * H + h) * S;

  // Stage j of the v slice: STAGE_ROWS rows, four 16-byte copies a row.
  auto load_v = [&](int j) {
#pragma unroll
    for (int c2 = 0; c2 < STAGE_ROWS * 4 / NT; ++c2) {
      const int rr = (c2 * NT + tid) >> 2, c = tid & 3;
      const int r = j * STAGE_ROWS + rr;
      cp_async16(ring + ((j % NS) * STAGE_ROWS + rr) * HD + ring_chunk(c, rr) * 16,
                 vb + (size_t)(lo + (r < nv ? r : 0)) * D + c * 16, r < nv);
    }
  };
  // Round s0 of k loads: lane (g, t) of warp w reads bytes 16t .. 16t+15 of
  // rows s0 + 16 (u/2 * NW + w) + 8 (u%2) + g, and each row's scale.
  uint4 raw[U];
  float kscale[U];
  auto row_of = [&](int s0, int u) { return s0 + 16 * ((u / 2) * NW + warp) + 8 * (u % 2) + g; };
  auto load_k = [&](int s0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = row_of(s0, u);
      raw[u] = r < nk ? __ldg(reinterpret_cast<const uint4*>(kb + (size_t)(lo + r) * D + 16 * t))
                      : make_uint4(0, 0, 0, 0);
      kscale[u] = r < nk ? __ldg(ksb + lo + r) : 0.f;
    }
  };
  load_k(0);  // k first: the scores need it before v
  // Group 0: the v scales and stage 0; then one group per further stage.
  const int v_stages = ceil_div(nv, STAGE_ROWS);
  for (int i = tid; i < rows; i += NT) sar::cp_async4(vsc + i, vsb + lo + i, i < nv);
  for (int j = 0; j < NS; ++j) {  // NS groups, some empty
    if (j < v_stages) load_v(j);
    sar::cp_async_commit();
  }

  // mma: the B operand is beam g's bytes 16t .. 16t+15 (zero for g >= K)
  // and the lane's results are beams 2t and 2t+1 of rows g and g+8 of each
  // 16-row unit. __dp4a: every beam's 16 bytes, and a row's sum over its 4
  // lanes.
  constexpr bool QK_MMA = K >= SAR_S8_QK_MMA_FROM;
  constexpr int QW = QK_MMA ? 1 : K;
  uint4 qb[QW];
  float qscale[QK_MMA ? 2 : K];
  if constexpr (QK_MMA) {
    qb[0] = make_uint4(0, 0, 0, 0);
    if (g < K) qb[0] = *reinterpret_cast<const uint4*>(qq + ((size_t)b * K + g) * D + h * HD + 16 * t);
#pragma unroll
    for (int e = 0; e < 2; ++e)
      qscale[e] = 2 * t + e < K ? qs[((size_t)b * K + 2 * t + e) * H + h] : 0.f;
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      qb[k] = *reinterpret_cast<const uint4*>(qq + ((size_t)b * K + k) * D + h * HD + 16 * t);
      qscale[k] = qs[((size_t)b * K + k) * H + h];
    }
  }
  auto store_score = [&](int k, int r, int dot, float kscl, float qscl) {
    float score = (float)dot * qscl * kscl;
    if (MASK == kScaleMask && !(kscl > 0.f)) score = sar::kNeg;
    sc[k * slice + r] = score;
  };
  for (int s0 = 0; s0 < nk; s0 += BATCH_ROWS) {
    if (s0 != 0) load_k(s0);
#pragma unroll
    for (int u = 0; u < U; u += 2) {
      if (row_of(s0, u) - g >= nk) continue;  // warp-uniform: no row of this unit is read
      if constexpr (QK_MMA) {
        int c[4] = {0, 0, 0, 0};
        const uint32_t a0[4] = {raw[u].x, raw[u + 1].x, raw[u].y, raw[u + 1].y};
        const uint32_t a1[4] = {raw[u].z, raw[u + 1].z, raw[u].w, raw[u + 1].w};
        sar::mma_s8(c, a0, qb[0].x, qb[0].y);
        sar::mma_s8(c, a1, qb[0].z, qb[0].w);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = 2 * t + (e & 1), uu = u + (e >> 1);
          const int r = row_of(s0, uu);
          if (k < K && r < nk) store_score(k, r, c[e], kscale[uu], qscale[e & 1]);
        }
      } else {
#pragma unroll
        for (int uu = u; uu < u + 2; ++uu) {
          int dot[K];
#pragma unroll
          for (int k = 0; k < K; ++k) {
            dot[k] = __dp4a((int)raw[uu].x, (int)qb[k].x, 0);
            dot[k] = __dp4a((int)raw[uu].y, (int)qb[k].y, dot[k]);
            dot[k] = __dp4a((int)raw[uu].z, (int)qb[k].z, dot[k]);
            dot[k] = __dp4a((int)raw[uu].w, (int)qb[k].w, dot[k]);
            dot[k] += __shfl_xor_sync(0xffffffffu, dot[k], 1);
            dot[k] += __shfl_xor_sync(0xffffffffu, dot[k], 2);
          }
          const int r = row_of(s0, uu);
#pragma unroll
          for (int k = 0; k < K; ++k)
            if ((k & 3) == t && r < nk) store_score(k, r, dot[k], kscale[uu], qscale[k]);
        }
      }
    }
  }
  for (int i = nk + tid; i < nv; i += NT) {  // K9 at n = 0: every row masked
#pragma unroll
    for (int k = 0; k < K; ++k) sc[k * slice + i] = sar::kNeg;
  }
  sar::cp_async_wait<NS - 1>();  // group 0 (the v scales) landed
  __syncthreads();
  if (!solo) sar::cluster_wait();  // every block of the cluster has started

  // Exchange 1: this block's max m and sum of exp(s - m) per beam. WPB
  // warps share a beam's rows; the block's statistics are pushed into
  // every block of the cluster.
  constexpr int WPB = NW / K > 0 ? NW / K : 1;  // warps per beam
  const int part = warp % WPB;
  __shared__ float wmax[K * WPB];
  __shared__ float wsum[K * WPB];
  for (int k = warp / WPB; k < K; k += NW / WPB) {
    float m = -INFINITY;
    for (int i = part * 32 + lane; i < nv; i += WPB * 32) m = fmaxf(m, sc[k * slice + i]);
    m = sar::group_max<32>(m);
    if (lane == 0) wmax[k * WPB + part] = m;
  }
  __syncthreads();
  for (int k = warp / WPB; k < K; k += NW / WPB) {
    const float* sk = sc + k * slice;
    float m = wmax[k * WPB];
    for (int p = 1; p < WPB; ++p) m = fmaxf(m, wmax[k * WPB + p]);
    float l = 0.f;
    for (int i = part * 32 + lane; i < nv; i += WPB * 32) l += expf(sk[i] - m);
    l = sar::group_sum<32>(l);
    if (lane == 0) wsum[k * WPB + part] = l;
  }
  __syncthreads();
  for (int k = warp; k < K; k += NW) {
    if (lane < CE) {
      float l = wsum[k * WPB], m = wmax[k * WPB];
      for (int p = 1; p < WPB; ++p) {
        l += wsum[k * WPB + p];
        m = fmaxf(m, wmax[k * WPB + p]);
      }
      const float2 own = make_float2(m, l);
      if (solo)
        stats[0][k] = own;
      else
        cluster.map_shared_rank(&stats[0][0], lane)[rank * K + k] = own;
    }
  }
  if (solo)
    __syncthreads();
  else
    cluster.sync();
  // The global max and sum per beam in rank order, the same in every
  // block: a block's rows have sum exp(s - M) = l_r * exp(m_r - M).
  if (tid < K) {
    float M = -INFINITY;
    for (int r = 0; r < CE; ++r) M = fmaxf(M, stats[r][tid].x);
    float tot = 0.f;
    for (int r = 0; r < CE; ++r) tot += stats[r][tid].y * expf(stats[r][tid].x - M);
    glob[tid] = make_float3(M, tot, 0.f);
  }
  __syncthreads();

  // Exchange 2: the slice's pw = (exp(s - M) / tot) * vs, kept in place of
  // its scores, and the block's max |pw| per beam, pushed into every block;
  // ps is the largest over 127, exact whatever the order.
  {
    float gM[K], gtot[K], mx[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      gM[k] = glob[k].x;
      gtot[k] = glob[k].y;
      mx[k] = 0.f;
    }
    for (int i = tid; i < nv; i += NT) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float pw = (expf(sc[k * slice + i] - gM[k]) / gtot[k]) * vsc[i];
        sc[k * slice + i] = pw;
        mx[k] = fmaxf(mx[k], fabsf(pw));
      }
    }
    __shared__ float wpm[NW][K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float m = sar::group_max<32>(mx[k]);
      if (lane == 0) wpm[warp][k] = m;
    }
    __syncthreads();
    if (tid < K * CE) {
      const int k = tid % K, dst = tid / K;
      float m = wpm[0][k];
      for (int w = 1; w < NW; ++w) m = fmaxf(m, wpm[w][k]);
      if (solo)
        pmax[0][k] = m;
      else
        cluster.map_shared_rank(&pmax[0][0], dst)[rank * K + k] = m;
    }
  }
  if (solo)
    __syncthreads();
  else
    cluster.sync();
  if (tid < K) {
    float mx = 0.f;
    for (int r = 0; r < CE; ++r) mx = fmaxf(mx, pmax[r][tid]);
    glob[tid].z = fmaxf(mx, 1e-8f) / 127.f;
  }
  __syncthreads();

  // The slice's pw quantized to s8 (zeros past it, to whole k-steps).
  float gps[K];
#pragma unroll
  for (int k = 0; k < K; ++k) gps[k] = glob[k].z;
  for (int i = tid; i < pqs; i += NT) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      int v = 0;
      if (i < nv) v = __float2int_rn(sc[k * slice + i] / gps[k]);
      pq[k * pqs + i] = (int8_t)max(-127, min(127, v));
    }
  }
  if (probe_pw != nullptr) {
    __syncthreads();  // pq is written
    for (int i = tid; i < rows; i += NT)
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const size_t at = (((size_t)b * K + k) * H + h) * S + lo + i;
        probe_pw[at] = i < nv ? sc[k * slice + i] : 0.f;
        probe_pq[at] = pq[k * pqs + i];
      }
    if (rank == 0 && tid < K) probe_ps[((size_t)b * K + tid) * H + h] = gps[tid];
  }

  // Warp w takes k-step w / 2 of each stage and columns 32 (w % 2) ..
  // 32 (w % 2) + 31; lane (g, t) reads rows 4t .. 4t+3 and 16+4t .. 16+4t+3
  // of the k-step at columns 4g .. 4g+3 of that half and transposes them:
  // w4[hi][i] holds column 4g + i of four rows.
  const int kstep = warp >> 1, half = warp & 1;
  // mma: tiles of columns (4g, 4g+1) and (4g+2, 4g+3) x beams (2t, 2t+1);
  // __dp4a: beam k, column 4g + i, over the lane's rows.
  constexpr bool PV_MMA = K >= SAR_S8_PV_MMA_FROM;
  int acc[PV_MMA ? 2 : K][4] = {};
  // Stage j of the ring: the warp's k-step and column half.
  auto pv_stage = [&](int j) {
    const int s0 = j * STAGE_ROWS + kstep * KSTEP;
    if (s0 >= nv) return;  // warp-uniform
    uint32_t w4[2][4];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      uint32_t r4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = kstep * KSTEP + 16 * hi + 4 * t + e;
        r4[e] = *reinterpret_cast<const uint32_t*>(
            ring + ((j % NS) * STAGE_ROWS + rr) * HD + ring_chunk(2 * half + (g >> 2), rr) * 16 +
            (g & 3) * 4);
      }
      transpose4(r4, w4[hi]);
    }
    if constexpr (PV_MMA) {
      uint32_t b0 = 0, b1 = 0;
      if (g < K) {
        b0 = *reinterpret_cast<const uint32_t*>(pq + g * pqs + s0 + 4 * t);
        b1 = *reinterpret_cast<const uint32_t*>(pq + g * pqs + s0 + 16 + 4 * t);
      }
#pragma unroll
      for (int tile = 0; tile < 2; ++tile) {
        const uint32_t av[4] = {w4[0][2 * tile], w4[0][2 * tile + 1], w4[1][2 * tile],
                                w4[1][2 * tile + 1]};
        sar::mma_s8(acc[tile], av, b0, b1);
      }
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int p0 = *reinterpret_cast<const int*>(pq + k * pqs + s0 + 4 * t);
        const int p1 = *reinterpret_cast<const int*>(pq + k * pqs + s0 + 16 + 4 * t);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[k][i] = __dp4a((int)w4[0][i], p0, acc[k][i]);
          acc[k][i] = __dp4a((int)w4[1][i], p1, acc[k][i]);
        }
      }
    }
  };
  if (v_stages <= NS) {  // the whole slice is in the ring
    sar::cp_async_wait<0>();
    __syncthreads();  // every thread's copies landed; pq is written
    for (int j = 0; j < v_stages; ++j) pv_stage(j);
  } else {
    for (int j = 0; j < v_stages; ++j) {
      sar::cp_async_wait<NS - 1>();  // stage j landed (this thread's copies)
      __syncthreads();               // ... every thread's; pq is written
      pv_stage(j);
      if (j + NS < v_stages) {
        __syncthreads();  // every thread has read stage j
        load_v(j + NS);
      }
      sar::cp_async_commit();
    }
  }
  const int col = 32 * half + 4 * g;
  if constexpr (PV_MMA) {
    // c[e] of tile `tile`: column 4g + 2 tile + (e >> 1), beam 2t + (e & 1).
#pragma unroll
    for (int tile = 0; tile < 2; ++tile)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (2 * t + (e & 1) < K)
          red[kstep][2 * t + (e & 1)][col + 2 * tile + (e >> 1)] = acc[tile][e];
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[k][i] += __shfl_xor_sync(0xffffffffu, acc[k][i], 1);
        acc[k][i] += __shfl_xor_sync(0xffffffffu, acc[k][i], 2);
        if (t == 0) red[kstep][k][col + i] = acc[k][i];
      }
  }
  __syncthreads();
  // Exchange 3: the block's int32 [K][64] P.V partial, pushed into rank 0.
  int* dst = solo ? parts : cluster.map_shared_rank(parts, 0);
  for (int i = tid; i < K * HD; i += NT) {
    int o = 0;
#pragma unroll
    for (int q = 0; q < NW / 2; ++q) o += red[q][i / HD][i % HD];
    dst[rank * K * HD + i] = o;
  }
  if (solo)
    __syncthreads();
  else
    cluster.sync();  // every partial is in rank 0; no block touches another after this
  if (rank == 0) {
    for (int i = tid; i < K * HD; i += NT) {
      int o = 0;
      for (int r = 0; r < CE; ++r) o += parts[r * K * HD + i];
      out[((size_t)b * K + i / HD) * D + h * HD + i % HD] =
          __float2bfloat16_rn((float)o * glob[i / HD].z);
    }
  }
}

bool smem_done[2][MAX_BEAMS + 1][sar::kMaxDevices] = {};

template <int K, int MASK>
int launch(const void* qq, const void* qs, const void* kq, const void* ks, const void* vq,
           const void* vs, const void* n_dev, int n_host, void* out, void* probe_pw,
           void* probe_ps, void* probe_pq, int B, int S, int D, int H, int layer, int device,
           cudaStream_t stream) {
  const auto kernel = s8_decode_kernel<K, MASK>;
  // The limit is raised once; each launch asks for what its slice needs.
  cudaError_t err = sar::allow_smem_once(smem_done[MASK][K], device, kernel, kMaxDynamicSmem);
  if (err != cudaSuccess) return (int)err;
  const int C = cluster_size(S, MASK == kScaleMask ? SAR_S8_CROSS_MIN_SLICE : SAR_S8_SELF_MIN_SLICE);
  const int slice = ceil_div(S, C);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(C, H, B);
  config.blockDim = dim3(NT);
  config.dynamicSmemBytes = dynamic_smem_bytes(K, slice, C);
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = C > 1 ? 1 : 0;  // one block: a plain launch (a cluster of one)
  err = cudaLaunchKernelEx(&config, kernel, static_cast<const int8_t*>(qq),
                           static_cast<const float*>(qs), static_cast<const int8_t*>(kq),
                           static_cast<const float*>(ks), static_cast<const int8_t*>(vq),
                           static_cast<const float*>(vs), static_cast<const int*>(n_dev), n_host,
                           static_cast<__nv_bfloat16*>(out), static_cast<float*>(probe_pw),
                           static_cast<float*>(probe_ps), static_cast<int8_t*>(probe_pq), B, S,
                           D, H, layer, slice);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

bool shape_ok(int L, int B, int K, int S, int D, int H, int layer, int min_slice) {
  return D == H * HD && S >= 1 && layer >= 0 && layer < L && B >= 1 && B <= 65535 &&
         H >= 1 && H <= 65535 && K >= 1 && K <= MAX_BEAMS &&
         dynamic_smem_bytes(K, ceil_div(S, cluster_size(S, min_slice)), cluster_size(S, min_slice)) <=
             kMaxDynamicSmem;
}

}  // namespace

// K7: qq [B, D] (K = 1) or beam-folded [B, K, D], K = 1..8; S_pad a
// multiple of 64.
extern "C" int sar_cross_decode_s8(const void* qq, const void* qs, const void* kq,
                                   const void* ks, const void* vq, const void* vs,
                                   void* out, int L, int B, int K, int S_pad, int D,
                                   int n_heads, int layer, int device, void* stream) {
  if (!shape_ok(L, B, K, S_pad, D, n_heads, layer, SAR_S8_CROSS_MIN_SLICE) || S_pad % HD != 0)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
#define SAR_S8_CASE(N)                                                                     \
  case N:                                                                                  \
    return launch<N, kScaleMask>(qq, qs, kq, ks, vq, vs, nullptr, 0, out, nullptr, nullptr,  \
                                 nullptr, B, S_pad, D, n_heads, layer, device, st);
    SAR_S8_CASE(1)
    SAR_S8_CASE(2)
    SAR_S8_CASE(3)
    SAR_S8_CASE(4)
    SAR_S8_CASE(5)
    SAR_S8_CASE(6)
    SAR_S8_CASE(7)
    SAR_S8_CASE(8)
#undef SAR_S8_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K9: qq [B, D], any max_len S; n from `n_dev` (a device int32) when it is
// not NULL, else `n_host`; clamped to [0, S].
extern "C" int sar_self_decode_s8(const void* qq, const void* qs, const void* kq,
                                  const void* ks, const void* vq, const void* vs,
                                  const void* n_dev, int n_host, void* out, int L, int B,
                                  int S, int D, int n_heads, int layer, int device,
                                  void* stream) {
  if (!shape_ok(L, B, 1, S, D, n_heads, layer, SAR_S8_SELF_MIN_SLICE))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return launch<1, kLengthMask>(qq, qs, kq, ks, vq, vs, n_dev, n_host, out, nullptr, nullptr,
                                nullptr, B, S, D, n_heads, layer, device,
                                static_cast<cudaStream_t>(stream));
}

// K7 (length_mask 0, K = 1..8, S a multiple of 64) or K9 (length_mask not
// 0, K = 1) as above, and also every row's fp32 pw into probe_pw [B, K, H,
// S] (0 past n) and its s8 probability into probe_pq [B, K, H, S] (rows of
// blocks that do not run stay as they were), and each row's ps into
// probe_ps [B, K, H]: the tests' view of the re-quantization.
extern "C" int sar_s8_decode_probe(const void* qq, const void* qs, const void* kq,
                                   const void* ks, const void* vq, const void* vs,
                                   const void* n_dev, int n_host, void* out, void* probe_pw,
                                   void* probe_ps, void* probe_pq, int L, int B, int K, int S, int D,
                                   int n_heads, int layer, int length_mask, int device,
                                   void* stream) {
  const int min_slice = length_mask ? SAR_S8_SELF_MIN_SLICE : SAR_S8_CROSS_MIN_SLICE;
  if (!shape_ok(L, B, K, S, D, n_heads, layer, min_slice) || probe_pw == nullptr ||
      probe_ps == nullptr || probe_pq == nullptr || (length_mask ? K != 1 : S % HD != 0))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (length_mask)
    return launch<1, kLengthMask>(qq, qs, kq, ks, vq, vs, n_dev, n_host, out, probe_pw,
                                  probe_ps, probe_pq, B, S, D, n_heads, layer, device, st);
  switch (K) {
#define SAR_S8_CASE(N)                                                                   \
  case N:                                                                                \
    return launch<N, kScaleMask>(qq, qs, kq, ks, vq, vs, nullptr, 0, out, probe_pw,      \
                                 probe_ps, probe_pq, B, S, D, n_heads, layer, device, st);
    SAR_S8_CASE(1)
    SAR_S8_CASE(2)
    SAR_S8_CASE(3)
    SAR_S8_CASE(4)
    SAR_S8_CASE(5)
    SAR_S8_CASE(6)
    SAR_S8_CASE(7)
    SAR_S8_CASE(8)
#undef SAR_S8_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The cluster size the launches above pick for S rows (K9's rule when
// `length_mask` is not 0), for the smoke run to hold against the Python
// mirror.
extern "C" int sar_s8_cluster_size(int S, int length_mask) {
  return cluster_size(S, length_mask ? SAR_S8_SELF_MIN_SLICE : SAR_S8_CROSS_MIN_SLICE);
}
