// One decode step of cross-attention over the int8 head-minor cache: K3
// (greedy, q [B, D]) and K5 (K beams folded per sample, q [B, K, D]), one
// kernel body for both.
//
// Replaces sar_tpu/ops/decode_cross.py::cross_decode_attention_exact (Pallas
// `_kernel_exact`, beam_width 1 for K3 and K > 1 for K5). Per sample b, beam
// k and head h, over layer `layer`'s slab of the FULL stacked cache (kq/vq
// [L, B, S_pad, H*64] s8, ks/vs [L, B, H, S_pad] f32): score_s = (q . k_s) *
// ks_s with q bf16 and k_s the exact int8 values, summed in fp32, masked
// where ks_s <= 0 (layout padding carries scale 0; real rows have scale >=
// 1e-8/127), an fp32 softmax normalised by the GLOBAL sum, pw_s =
// bf16(p_s * vs_s), out = sum_s pw_s * v_s in fp32, stored bf16 [B, K, D].
// The K beams of a sample share its one slab. If every row is masked the
// softmax is uniform, as in the TPU kernel.
//
// Bound on the H100: bytes. At whisper-small B=8 one call reads 2*B*S_pad*D
// = 18.9 MB of int8 plus 1.2 MB of scales (6.0 us at 3.35 TB/s) for
// 4*B*K*S*D FLOPs, ~2*K FLOP per byte; K beams read the same bytes. One
// block per (head, sample) gave 96 blocks for 132 SMs with one load in
// flight per thread: 14-17% of HBM. Design (K10's, csrc/decode_attention.cu,
// carried over to the int8 slabs):
//   - a cluster of C <= 8 blocks per (head, sample), C = ceil(S_pad / 256)
//     capped at 8, each block owning a slice of ceil(S_pad / C) rows: 576
//     blocks of 256 rows at whisper-small B=8 (mirrored by
//     ops/decode_cross.py::cluster_split);
//   - bytes in flight: a row is one head's 64 int8 (row stride D), read by
//     TPR = 8 threads of 8 bytes; each block first issues its k rows, U
//     loads per thread (its whole slice at whisper-small), with their
//     scales (a reduce-scatter across the TPR lanes of a row gives each
//     lane one beam's dot product), then its v slice and v scales into
//     shared memory with
//     cp.async (a ring of up to NS stages of 64 rows; a longer slice
//     streams through it), so v lands while the scores are computed;
//   - the exact softmax across the cluster: each block pushes its local
//     (max, sum exp(s - max)) per beam into every block's shared memory
//     (remote stores through distributed shared memory), one cluster
//     barrier, and every block forms the global max M and sum in rank
//     order, the same in every block; it rounds its own pw_s =
//     bf16((exp(s - M) / sum) * vs_s) where the TPU kernel does, sums its
//     rows' pw_s * v_s into fp32 [K][64] partials and pushes them into rank
//     0, which adds them in rank order after a second barrier and stores
//     bf16. One launch, no atomics: the same bits on every run. A slice of
//     padding rows only posts (-1e30, n rows), which a real row's M turns
//     into an exact 0.
// The sizes were the fastest of those timed on an H100 at whisper-small
// B=8 for K = 1, 4 and 8: slices of 128 rows (C = 8) and of 384 (C = 4),
// four threads of 16 bytes a row, and 128-thread blocks were slower.
//
// Two forms of K3 (K5 and every K > 1 keep the cluster form):
//   - the cluster form above, for small batches: at B=8 the 96 (head,
//     sample) pairs are fewer than the 132 SMs, so a pair's rows must be
//     split over blocks to fill the card. What bounds it is latency: a
//     block issues all its loads, then computes, then meets two cluster
//     barriers, and a short-lived block leaves the SM's load slots idle
//     while it computes. At whisper-small B=128 (H100, 1980 MHz) K3 took
//     0.1824 ms a call against 0.1147 for its loads alone, 0.1333 with its
//     barriers and 0.1068 to read the same bytes as whole rows: 65% of the
//     gap is the arithmetic that no load overlaps, 25% the barriers, 10%
//     the 64-byte pieces.
//   - the large-batch form (cross_decode_exact_kernel_stream), where the
//     B * H pairs are at least STREAM_PAIRS_PER_SM per SM: the pairs then
//     fill the card by themselves and a split buys no parallelism. One
//     block per SM walks over items of one sample and STREAM_HEADS = G
//     heads (item i: sample i / (H / G), heads G * (i % (H / G)) ..; block
//     k takes items k, k + grid, ...). A producer warp streams each item's
//     k rows, then its v rows, as tiles of SR rows x G * 64 contiguous
//     bytes with the G heads' scales of those rows, two TMA boxes a tile,
//     into a ring of STREAM_STAGES stages under full/empty mbarriers, and
//     runs on into the next item's k rows while the consumers finish this
//     one. The STREAM_WARPS consumer warps keep the item's G x S_pad
//     scores in shared memory for the exact two-pass softmax (the global
//     max, the sum, p = exp(s - max) / sum), then sum pw * v: no cluster,
//     no exchange between blocks, no atomics. Every int8 value becomes fp32
//     by a byte permute and a subtraction (exact), not an I2F. What bounds
//     it is bytes: 0.1074 ms at whisper-small B=128, 2989 GB/s, where whole
//     contiguous rows read at 3005. Its tail is the items' quantization
//     over the SMs (turbo's B=64 x 20 heads: 320 items, 2.4 a block).
//   The rule (stream_heads, mirrored by ops/decode_cross.py): the large-
//   batch form where G divides H, B * H >= STREAM_PAIRS_PER_SM (2) x SMs
//   and the ring, the scores and the partials fit in a block's shared
//   memory; else the cluster form. Timed on an H100 at S_pad 1536 with H =
//   12, 16, 20: the large-batch form is slower at B=8 (96-160 pairs),
//   even at 192 pairs, faster from 256 (1.25x) to B=128 (1.65x).
#include <cooperative_groups.h>
#include <cuda.h>

#include "cluster.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int HD = 64;           // head_dim
constexpr int NT = 256;          // threads per block
constexpr int NW = NT / 32;
constexpr int TPR = 8;           // threads per row of 64 int8
constexpr int EPT = HD / TPR;    // int8 a thread reads of a row
constexpr int RG = NT / TPR;     // rows per pass of the score loop
constexpr int U = 8;             // k rows a thread has in flight
constexpr int STAGE_ROWS = NT * 16 / HD;  // v rows per ring stage (16-byte copies)
constexpr int NS = 8;            // v ring stages (32 KB)
constexpr int MAX_CLUSTER = 8;
constexpr int MIN_SLICE = 256;
constexpr int MAX_BEAMS = 8;
// Dynamic shared memory a block may ask for: the card's 232,448 bytes less
// 48 KB for the static arrays (at most 33 KB, at K = 8).
constexpr int kMaxDynamicSmem = 232448 - 48 * 1024;

using RowChunk = uint2;          // EPT = 8 int8
static_assert(sizeof(RowChunk) == EPT, "one load per thread and row");

// The split of S_pad over a cluster (mirrored by
// ops/decode_cross.py::cluster_split) and the shared memory it needs.
__host__ __device__ constexpr int cluster_size(int S) {
  return (S + MIN_SLICE - 1) / MIN_SLICE < MAX_CLUSTER ? (S + MIN_SLICE - 1) / MIN_SLICE
                                                       : MAX_CLUSTER;
}
__host__ __device__ constexpr int slice_rows(int S) {
  return (S + cluster_size(S) - 1) / cluster_size(S);
}
__host__ __device__ constexpr int ring_stages(int S) {
  return (slice_rows(S) + STAGE_ROWS - 1) / STAGE_ROWS < NS
             ? (slice_rows(S) + STAGE_ROWS - 1) / STAGE_ROWS
             : NS;
}
// The v ring (int8), then K rows of slice scores and the slice's v scales
// (fp32).
__host__ __device__ constexpr int dynamic_smem_bytes(int K, int S) {
  return ring_stages(S) * STAGE_ROWS * HD + 4 * (K + 1) * slice_rows(S);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  sar::cp_async16(static_cast<__nv_bfloat16*>(dst),
                  static_cast<const __nv_bfloat16*>(src), valid);
}

// Max (IS_MAX) or sum over the block of each of K per-thread values; every
// thread gets the K results. `scratch` holds NW * K floats.
template <int K, bool IS_MAX>
__device__ __forceinline__ void block_reduce_k(float (&v)[K], float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = IS_MAX ? sar::group_max<32>(v[k]) : sar::group_sum<32>(v[k]);
  __syncthreads();  // a previous call may still be reading scratch
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) scratch[warp * K + k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float r = scratch[k];
#pragma unroll
    for (int w = 1; w < NW; ++w) r = IS_MAX ? fmaxf(r, scratch[w * K + k]) : r + scratch[w * K + k];
    v[k] = r;
  }
}

// The dot products of one row with the K beams' queries, each summed over
// the TPR lanes that share the row: a reduce-scatter (each step sends half
// of the beams' partial sums to the partner lane and keeps the other half),
// so a lane ends with the whole sum of one beam, `beam`, in v[0], in
// log2(TPR) steps (K = 8: 7 shuffles, not 24). KP: K rounded up to a power
// of two.
template <int KP>
__device__ __forceinline__ void row_dots(float (&v)[KP], int part, int& beam) {
  static_assert(KP <= TPR && (KP & (KP - 1)) == 0, "up to TPR beams, a power of two");
  int n = KP;
  beam = 0;
#pragma unroll
  for (int o = TPR / 2; o >= 1; o >>= 1) {
    if (n > 1) {
      const bool upper = (part & o) != 0;
#pragma unroll
      for (int j = 0; j < n / 2; ++j) {
        const float send = upper ? v[j] : v[j + n / 2];
        const float keep = upper ? v[j + n / 2] : v[j];
        v[j] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
      beam += upper ? n / 2 : 0;
      n /= 2;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
    }
  }
}

__host__ __device__ constexpr int pow2_at_least(int k) { return k <= 1 ? 1 : 2 * pow2_at_least((k + 1) / 2); }

// Blocks an SM must hold (the registers a thread may have): 4 up to K = 2,
// 3 up to K = 4, 2 above.
template <int K>
__global__ void __launch_bounds__(NT, K <= 2 ? 4 : K <= 4 ? 3 : 2)
cross_decode_exact_kernel(const __nv_bfloat16* __restrict__ q,  // [B, K, D]
                          const int8_t* __restrict__ kq,        // [L, B, S, D]
                          const float* __restrict__ ks,         // [L, B, H, S]
                          const int8_t* __restrict__ vq,
                          const float* __restrict__ vs,
                          __nv_bfloat16* __restrict__ out,      // [B, K, D]
                          int B, int S, int D, int H, int layer) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int slice = slice_rows(S);
  int8_t* ring = reinterpret_cast<int8_t*>(smem_raw);  // [stages][STAGE_ROWS][64]
  float* sc = reinterpret_cast<float*>(smem_raw + ring_stages(S) * STAGE_ROWS * HD);  // [K][slice]
  float* vsc = sc + K * slice;                                                      // [slice]
  __shared__ float scratch[NW * K];
  __shared__ float own[K][2];                   // this block's max and sum per beam
  __shared__ float stats[MAX_CLUSTER][K][2];    // every block's, pushed
  __shared__ float red[NW][K][HD];              // the warps' P.V partials
  __shared__ float parts[MAX_CLUSTER][K][HD];   // every block's P.V (rank 0's)

  cg::cluster_group cluster = cg::this_cluster();
  sar::cluster_arrive();  // paired with cluster_wait() before the first remote store
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int part = tid % TPR;  // columns EPT*part .. EPT*part+EPT-1 of the head
  const int rg = tid / TPR;
  const int h = blockIdx.y, b = blockIdx.z;
  const int lo = min(S, rank * slice), hi = min(S, lo + slice);
  const int n = hi - lo;
  const int v_stages = (n + STAGE_ROWS - 1) / STAGE_ROWS;
  const size_t plane = (size_t)layer * B + b;
  const int8_t* kb = kq + plane * S * D + h * HD;
  const int8_t* vb = vq + plane * S * D + h * HD;
  const float* ksb = ks + (plane * H + h) * S;
  const float* vsb = vs + (plane * H + h) * S;

  // Stage j of the v slice: 64 rows, four 16-byte copies a row.
  auto load_v = [&](int j) {
    const int r = j * STAGE_ROWS + tid / 4;
    cp_async16(ring + ((j % NS) * STAGE_ROWS + tid / 4) * HD + (tid % 4) * 16,
               vb + (size_t)(lo + (r < n ? r : 0)) * D + (tid % 4) * 16, r < n);
  };
  RowChunk raw[U];
  float kscale[U];
  auto load_k = [&](int s0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = s0 + u * RG + rg;
      raw[u] = s < hi ? __ldg(reinterpret_cast<const RowChunk*>(kb + (size_t)s * D + part * EPT))
                      : RowChunk{};
      kscale[u] = s < hi ? __ldg(ksb + s) : 0.f;
    }
  };
  load_k(lo);  // k first: the score pass needs it before v
  // Group 0: the v scales and stage 0; then one group per further stage.
  for (int i = tid; i < n; i += NT) sar::cp_async4(vsc + i, vsb + lo + i, true);
  for (int j = 0; j < NS; ++j) {  // NS groups, some empty
    if (j < v_stages) load_v(j);
    sar::cp_async_commit();
  }

  float qf[K][EPT];
#pragma unroll
  for (int k = 0; k < K; ++k)
    sar::load_bf16x8(q + ((size_t)b * K + k) * D + h * HD + part * EPT, qf[k]);
  constexpr int KP = pow2_at_least(K);
  for (int s0 = lo; s0 < hi; s0 += U * RG) {
    if (s0 != lo) load_k(s0);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = s0 + u * RG + rg;
      const int8_t* kv = reinterpret_cast<const int8_t*>(&raw[u]);
      float kf[EPT];
#pragma unroll
      for (int e = 0; e < EPT; ++e) kf[e] = (float)kv[e];
      float dots[KP];
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        dots[k] = 0.f;
        if (k < K) {
#pragma unroll
          for (int e = 0; e < EPT; ++e) dots[k] = fmaf(qf[k][e], kf[e], dots[k]);
        }
      }
      int beam;
      row_dots<KP>(dots, part, beam);  // every lane takes part
      if (s < hi && beam < K && part % (TPR / KP) == 0)
        sc[beam * slice + s - lo] = kscale[u] > 0.f ? dots[0] * kscale[u] : sar::kNeg;
    }
  }
  __syncthreads();

  // This block's max and sum of exp(s - max) per beam, pushed into every
  // block of the cluster; the cluster barrier publishes them.
  float m[K];
#pragma unroll
  for (int k = 0; k < K; ++k) m[k] = -INFINITY;
  for (int i = tid; i < n; i += NT) {
#pragma unroll
    for (int k = 0; k < K; ++k) m[k] = fmaxf(m[k], sc[k * slice + i]);
  }
  block_reduce_k<K, true>(m, scratch);
  float l[K];
#pragma unroll
  for (int k = 0; k < K; ++k) l[k] = 0.f;
  for (int i = tid; i < n; i += NT) {
#pragma unroll
    for (int k = 0; k < K; ++k) l[k] += expf(sc[k * slice + i] - m[k]);
  }
  block_reduce_k<K, false>(l, scratch);
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      own[k][0] = m[k];
      own[k][1] = l[k];
    }
  }
  __syncthreads();
  sar::cluster_wait();  // every block of the cluster has started
  if (tid < C * K) {
    const int r = tid / K, k = tid % K;
    float* dst = cluster.map_shared_rank(&stats[0][0][0], r);
    dst[(rank * K + k) * 2] = own[k][0];
    dst[(rank * K + k) * 2 + 1] = own[k][1];
  }
  cluster.sync();
  // The global max and sum per beam in rank order, the same in every
  // block; a block's rows have sum exp(s - M) = l_r * exp(m_r - M).
  float gmax[K], tot[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    gmax[k] = -INFINITY;
    for (int r = 0; r < C; ++r) gmax[k] = fmaxf(gmax[k], stats[r][k][0]);
    tot[k] = 0.f;
    for (int r = 0; r < C; ++r) tot[k] += stats[r][k][1] * expf(stats[r][k][0] - gmax[k]);
  }
  sar::cp_async_wait<NS - 1>();  // group 0 (the v scales) landed
  __syncthreads();
  for (int i = tid; i < n; i += NT) {
    const float vscale = vsc[i];
#pragma unroll
    for (int k = 0; k < K; ++k)
      sc[k * slice + i] = sar::bf16_round((expf(sc[k * slice + i] - gmax[k]) / tot[k]) * vscale);
  }

  float acc[K][EPT];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int e = 0; e < EPT; ++e) acc[k][e] = 0.f;
  for (int j = 0; j < v_stages; ++j) {
    sar::cp_async_wait<NS - 1>();  // stage j landed (this thread's copies)
    __syncthreads();               // ... every thread's; the weights are in sc
#pragma unroll
    for (int i = 0; i < STAGE_ROWS / RG; ++i) {
      const int r = j * STAGE_ROWS + i * RG + rg;
      if (r < n) {
        const RowChunk c = *reinterpret_cast<const RowChunk*>(
            ring + ((j % NS) * STAGE_ROWS + i * RG + rg) * HD + part * EPT);
        const int8_t* vv = reinterpret_cast<const int8_t*>(&c);
        float vf[EPT];
#pragma unroll
        for (int e = 0; e < EPT; ++e) vf[e] = (float)vv[e];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float pw = sc[k * slice + r];
#pragma unroll
          for (int e = 0; e < EPT; ++e) acc[k][e] = fmaf(pw, vf[e], acc[k][e]);
        }
      }
    }
    if (j + NS < v_stages) {
      __syncthreads();  // every thread has read stage j
      load_v(j + NS);
    }
    sar::cp_async_commit();
  }
  // Sum over the row groups of this warp (lanes that differ in the bits
  // above TPR), then over the warps, and push the partial into rank 0.
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int e = 0; e < EPT; ++e)
#pragma unroll
      for (int o = TPR; o < 32; o <<= 1) acc[k][e] += __shfl_xor_sync(0xffffffffu, acc[k][e], o);
  const int warp = tid >> 5;
  if ((tid & 31) < TPR) {
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int e = 0; e < EPT; ++e) red[warp][k][part * EPT + e] = acc[k][e];
  }
  __syncthreads();
  float* dst = cluster.map_shared_rank(&parts[0][0][0], 0);
  for (int i = tid; i < K * HD; i += NT) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) o += red[w][i / HD][i % HD];
    dst[rank * K * HD + i] = o;
  }
  cluster.sync();  // every partial is in rank 0; no block touches another after this
  if (rank == 0) {
    for (int i = tid; i < K * HD; i += NT) {
      float o = 0.f;
      for (int r = 0; r < C; ++r) o += parts[r][i / HD][i % HD];
      out[((size_t)b * K + i / HD) * D + h * HD + i % HD] = __float2bfloat16_rn(o);
    }
  }
}

// ---- The large-batch form (K3 only; see the header) ----
constexpr int SR = 64;                  // rows per ring tile
constexpr int STREAM_HEADS = 4;         // heads per item (G)
constexpr int STREAM_STAGES = 8;        // ring stages, 17 KB each at G = 4
constexpr int STREAM_WARPS = 8;         // consumer warps, beside the producer warp
constexpr int STREAM_PAIRS_PER_SM = 2;  // the crossover: B * H per SM
constexpr int kMaxStreamSmem = 232448;  // a block's shared memory (no static arrays)

// A ring stage: SR rows of an item's G = STREAM_HEADS heads (G * 64 int8
// each), then the G heads' fp32 scales of those rows ([G][SR]).
constexpr int STREAM_STAGE_BYTES = STREAM_HEADS * (SR * HD + SR * 4);
// The ring, the item's scores [G][S], the W = STREAM_WARPS warps' P.V
// partials [W][G * 64] and their softmax statistics (W, padded to 8
// bytes), then the mbarriers (full and empty per stage).
__host__ __device__ constexpr int stream_smem_bytes(int S) {
  return STREAM_STAGES * STREAM_STAGE_BYTES + 4 * STREAM_HEADS * S +
         4 * STREAM_WARPS * STREAM_HEADS * HD + 4 * (STREAM_WARPS + (STREAM_WARPS & 1)) +
         16 * STREAM_STAGES;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(sar::smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   sar::smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 state;\n mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
          sar::smem_addr(bar))
      : "memory");
}
// Until the phase of `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = sar::smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}
// The box of `map` at (x, y) global -> shared by the copy engine (TMA);
// its bytes count against `bar`'s expected transaction bytes.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int x, int y,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%2, %3}], [%4];\n" ::"r"(sar::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(sar::smem_addr(bar))
      : "memory");
}
// A barrier of the consumer warps alone (the producer warp never joins).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(STREAM_WARPS * 32) : "memory");
}

// The int8 x in byte e of a word whose bytes were biased (w ^ 0x80808080:
// x + 128 each), exactly and without an I2F: that byte under the exponent
// of 2^23 reads 2^23 + x + 128.
__device__ __forceinline__ float s8_byte(uint32_t biased, int e) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 | e)) - 8388736.f;
}

__global__ void __launch_bounds__((STREAM_WARPS + 1) * 32, 1)
cross_decode_exact_kernel_stream(const __nv_bfloat16* __restrict__ q,  // [B, D]
                                 const __grid_constant__ CUtensorMap kmap,  // kq as [L*B*S, D]
                                 const __grid_constant__ CUtensorMap ksmap, // ks as [L*B*H, S]
                                 const __grid_constant__ CUtensorMap vmap,
                                 const __grid_constant__ CUtensorMap vsmap,
                                 __nv_bfloat16* __restrict__ out,      // [B, D]
                                 int B, int S, int D, int H, int layer) {
  constexpr int G = STREAM_HEADS, NSTG = STREAM_STAGES, W = STREAM_WARPS;
  constexpr int ROW = G * HD;              // bytes of a tile row
  constexpr int LPR = ROW / 16;            // lanes of a row, 16 bytes each
  constexpr int RPP = W * 32 / LPR;        // rows a pass of the consumers covers
  constexpr int TPH = W * 32 / G;          // consumer threads per head in the softmax
  constexpr int WPH = TPH / 32;
  constexpr int STAGE = STREAM_STAGE_BYTES;
  static_assert(LPR <= 32 && 32 % LPR == 0 && SR % RPP == 0 && TPH % 32 == 0, "tiling");
  extern __shared__ __align__(128) unsigned char stream_smem[];
  unsigned char* ring = stream_smem;                          // TMA boxes: 128-byte aligned
  float* sc = reinterpret_cast<float*>(ring + NSTG * STAGE);  // [G][S]
  float* red = sc + G * S;                                    // [W][G * 64]
  float* stat = red + W * G * HD;                             // [W]
  uint64_t* full = reinterpret_cast<uint64_t*>(stat + W + (W & 1));
  uint64_t* empty = full + NSTG;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int groups = H / G, items = B * groups, tiles = S / SR;
  if (tid == 0) {
    for (int i = 0; i < NSTG; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, W);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == W) {
    // The producer (one lane): every item's k tiles, then its v tiles, in
    // the order the consumers take them, up to NSTG stages ahead of them;
    // a tile is two TMA boxes: SR rows x G heads of int8, and the G heads'
    // scales of those rows.
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int b = item / groups, h0 = (item % groups) * G;
        const int row0 = (layer * B + b) * S, head_row = (layer * B + b) * H + h0;
        for (int side = 0; side < 2; ++side) {
          for (int t = 0; t < tiles; ++t) {
            mbar_wait(empty + stage, phase ^ 1);
            mbar_arrive_expect_tx(full + stage, STAGE);
            unsigned char* dst = ring + stage * STAGE;
            tma_load_2d(dst, side ? &vmap : &kmap, h0 * HD, row0 + t * SR, full + stage);
            tma_load_2d(dst + SR * ROW, side ? &vsmap : &ksmap, t * SR, head_row, full + stage);
            if (++stage == NSTG) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
    return;
  }

  // The consumers: thread tid reads 16 bytes (columns 16 * part ..) of
  // head hl in rows ro, ro + RPP, ... of each tile.
  const int ci = tid % LPR, hl = ci / 4, part = ci % 4, ro = tid / LPR;
  const int sh = tid / TPH, si = tid % TPH;  // the softmax's head and lane
  int stage = 0;
  uint32_t phase = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int b = item / groups, h0 = (item % groups) * G;
    float qf[16];
    const __nv_bfloat16* qb = q + (size_t)b * D + (h0 + hl) * HD + part * 16;
    sar::load_bf16x8(qb, qf);
    sar::load_bf16x8(qb + 8, qf + 8);

    // Scores: (q . k_s) * ks_s, masked where ks_s <= 0.
    for (int t = 0; t < tiles; ++t) {
      mbar_wait(full + stage, phase);
      const unsigned char* st = ring + stage * STAGE;
      const float* kst = reinterpret_cast<const float*>(st + SR * ROW);
#pragma unroll
      for (int i = 0; i < SR / RPP; ++i) {
        const int r = i * RPP + ro;
        const uint4 c = *reinterpret_cast<const uint4*>(st + r * ROW + ci * 16);
        const uint32_t w[4] = {c.x ^ 0x80808080u, c.y ^ 0x80808080u, c.z ^ 0x80808080u,
                               c.w ^ 0x80808080u};
        float d0 = 0.f, d1 = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          d0 = fmaf(qf[4 * j], s8_byte(w[j], 0), d0);
          d1 = fmaf(qf[4 * j + 1], s8_byte(w[j], 1), d1);
          d0 = fmaf(qf[4 * j + 2], s8_byte(w[j], 2), d0);
          d1 = fmaf(qf[4 * j + 3], s8_byte(w[j], 3), d1);
        }
        float d = d0 + d1;
        d += __shfl_xor_sync(0xffffffffu, d, 1);
        d += __shfl_xor_sync(0xffffffffu, d, 2);
        if (part == 0) {
          const float scale = kst[hl * SR + r];
          sc[hl * S + t * SR + r] = scale > 0.f ? d * scale : sar::kNeg;
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + stage);
      if (++stage == NSTG) {
        stage = 0;
        phase ^= 1;
      }
    }
    consumers_sync();

    // The exact softmax over all S rows of each head, in place: the max,
    // the sum of exp(s - max), then p = exp(s - max) / sum.
    float m = -INFINITY;
    for (int s = si; s < S; s += TPH) m = fmaxf(m, sc[sh * S + s]);
    m = sar::group_max<32>(m);
    if (lane == 0) stat[warp] = m;
    consumers_sync();
    float gmax = stat[sh * WPH];
#pragma unroll
    for (int w = 1; w < WPH; ++w) gmax = fmaxf(gmax, stat[sh * WPH + w]);
    float l = 0.f;
    for (int s = si; s < S; s += TPH) l += expf(sc[sh * S + s] - gmax);
    l = sar::group_sum<32>(l);
    consumers_sync();  // every thread has read the maxima
    if (lane == 0) stat[warp] = l;
    consumers_sync();
    float tot = stat[sh * WPH];
#pragma unroll
    for (int w = 1; w < WPH; ++w) tot += stat[sh * WPH + w];
    for (int s = si; s < S; s += TPH) sc[sh * S + s] = expf(sc[sh * S + s] - gmax) / tot;
    consumers_sync();

    // P.V: pw_s = bf16(p_s * vs_s), summed with v_s in fp32.
    float acc[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e] = 0.f;
    for (int t = 0; t < tiles; ++t) {
      mbar_wait(full + stage, phase);
      const unsigned char* st = ring + stage * STAGE;
      const float* vst = reinterpret_cast<const float*>(st + SR * ROW);
#pragma unroll
      for (int i = 0; i < SR / RPP; ++i) {
        const int r = i * RPP + ro;
        const uint4 c = *reinterpret_cast<const uint4*>(st + r * ROW + ci * 16);
        const float pw = sar::bf16_round(sc[hl * S + t * SR + r] * vst[hl * SR + r]);
        const uint32_t w[4] = {c.x ^ 0x80808080u, c.y ^ 0x80808080u, c.z ^ 0x80808080u,
                               c.w ^ 0x80808080u};
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[4 * j + e] = fmaf(pw, s8_byte(w[j], e), acc[4 * j + e]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + stage);
      if (++stage == NSTG) {
        stage = 0;
        phase ^= 1;
      }
    }
    // Sum over the rows of this warp (lanes that differ in the bits above
    // LPR), then over the warps in order, and store bf16.
#pragma unroll
    for (int e = 0; e < 16; ++e)
#pragma unroll
      for (int o = LPR; o < 32; o <<= 1) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
    if (lane < LPR) {
      float4* dst = reinterpret_cast<float4*>(red + warp * G * HD + ci * 16);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dst[j] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
    }
    consumers_sync();  // also: every thread is done with this item's sc
    for (int c = tid; c < G * HD; c += W * 32) {
      float o = red[c];
#pragma unroll
      for (int w = 1; w < W; ++w) o += red[w * G * HD + c];
      out[(size_t)b * D + h0 * HD + c] = __float2bfloat16_rn(o);
    }
  }
}

// The form K3 takes at [B, H, S]: the large-batch form's heads per item
// (STREAM_HEADS) where the (head, sample) pairs fill the card's `sms`
// SMs STREAM_PAIRS_PER_SM times over and the item's scores fit beside the
// ring; else 0, the cluster form (mirrored by
// ops/decode_cross.py::stream_heads).
__host__ __device__ constexpr int stream_heads(int B, int H, int S, int sms) {
  return H % STREAM_HEADS == 0 && B * H >= STREAM_PAIRS_PER_SM * sms &&
                 stream_smem_bytes(S) <= kMaxStreamSmem
             ? STREAM_HEADS
             : 0;
}

int sm_count(int device) {
  static int sms[sar::kMaxDevices] = {};
  const bool tracked = device >= 0 && device < sar::kMaxDevices;
  if (tracked && sms[device] > 0) return sms[device];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) return 0;
  if (tracked) sms[device] = n;
  return n;
}

// cuTensorMapEncodeTiled from libcuda, found once through the runtime
// (the library links the runtime alone).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major [rows, cols] array of `type` read in boxes of
// [box_rows, box_cols].
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes, const void* base,
                size_t rows, int cols, int box_rows, int box_cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool stream_smem_done[sar::kMaxDevices] = {};

int launch_stream(const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
                  void* out, int L, int B, int S, int D, int H, int layer, int device,
                  cudaStream_t stream) {
  constexpr int G = STREAM_HEADS;
  const auto kernel = cross_decode_exact_kernel_stream;
  const int smem = stream_smem_bytes(S);
  if (H % G != 0 || smem > kMaxStreamSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = sar::allow_smem_once(stream_smem_done, device, kernel, kMaxStreamSmem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap maps[4];
  const size_t planes = (size_t)L * B;
  if (!tensor_map(&maps[0], CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, kq, planes * S, D, SR, G * HD) ||
      !tensor_map(&maps[1], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ks, planes * H, S, G, SR) ||
      !tensor_map(&maps[2], CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, vq, planes * S, D, SR, G * HD) ||
      !tensor_map(&maps[3], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, vs, planes * H, S, G, SR))
    return (int)cudaErrorInvalidValue;
  const int sms = sm_count(device), items = B * (H / G);
  kernel<<<items < sms ? items : sms, (STREAM_WARPS + 1) * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), maps[0], maps[1], maps[2], maps[3],
      static_cast<__nv_bfloat16*>(out), B, S, D, H, layer);
  return (int)cudaGetLastError();
}

bool smem_done[MAX_BEAMS + 1][sar::kMaxDevices] = {};

template <int K>
int launch(const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
           void* out, int B, int S, int D, int H, int layer, int device,
           cudaStream_t stream) {
  const auto kernel = cross_decode_exact_kernel<K>;
  // The limit is raised once; each launch asks for what its S needs.
  cudaError_t err = sar::allow_smem_once(smem_done[K], device, kernel, kMaxDynamicSmem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cluster_size(S), H, B);
  config.blockDim = dim3(NT);
  config.dynamicSmemBytes = dynamic_smem_bytes(K, S);
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster_size(S);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, static_cast<const __nv_bfloat16*>(q),
                           static_cast<const int8_t*>(kq), static_cast<const float*>(ks),
                           static_cast<const int8_t*>(vq), static_cast<const float*>(vs),
                           static_cast<__nv_bfloat16*>(out), B, S, D, H, layer);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int launch_any(const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
               void* out, int L, int B, int K, int S, int D, int H, int layer, int device,
               void* stream) {
  if (D != H * HD || S % HD != 0 || S < HD || layer < 0 || layer >= L || B < 1 ||
      B > 65535 || H > 65535 || K < 1 || K > MAX_BEAMS ||
      dynamic_smem_bytes(K, S) > kMaxDynamicSmem)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K == 1 && stream_heads(B, H, S, sm_count(device)) != 0)
    return launch_stream(q, kq, ks, vq, vs, out, L, B, S, D, H, layer, device, st);
  switch (K) {
#define SAR_CROSS_CASE(N) \
  case N:                 \
    return launch<N>(q, kq, ks, vq, vs, out, B, S, D, H, layer, device, st);
    SAR_CROSS_CASE(1)
    SAR_CROSS_CASE(2)
    SAR_CROSS_CASE(3)
    SAR_CROSS_CASE(4)
    SAR_CROSS_CASE(5)
    SAR_CROSS_CASE(6)
    SAR_CROSS_CASE(7)
    SAR_CROSS_CASE(8)
#undef SAR_CROSS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K5: q [B, K, D], K = 2..8 beams of each sample over its one slab.
extern "C" int sar_cross_decode_exact_beam(const void* q, const void* kq, const void* ks,
                                           const void* vq, const void* vs, void* out,
                                           int L, int B, int K, int S_pad, int D,
                                           int n_heads, int layer, int device,
                                           void* stream) {
  if (K < 2) return (int)cudaErrorInvalidValue;
  return launch_any(q, kq, ks, vq, vs, out, L, B, K, S_pad, D, n_heads, layer, device,
                    stream);
}

// K3: q [B, D], the kernel's K = 1 instance.
extern "C" int sar_cross_decode_exact(const void* q, const void* kq, const void* ks,
                                      const void* vq, const void* vs, void* out,
                                      int L, int B, int S_pad, int D, int n_heads,
                                      int layer, int device, void* stream) {
  return launch_any(q, kq, ks, vq, vs, out, L, B, 1, S_pad, D, n_heads, layer, device,
                    stream);
}

// The form K3 launches at [B, n_heads, S_pad] on `device`: the large-batch
// form's heads per item, or 0 for the cluster form.
extern "C" int sar_cross_decode_form(int B, int n_heads, int S_pad, int device) {
  return stream_heads(B, n_heads, S_pad, sm_count(device));
}

// K3 in the form asked for, whatever the shape (0: the cluster form; 1:
// the large-batch form), for timing and tests; no path calls it.
extern "C" int sar_cross_decode_exact_form(const void* q, const void* kq, const void* ks,
                                           const void* vq, const void* vs, void* out, int L,
                                           int B, int S_pad, int D, int n_heads, int layer,
                                           int form, int device, void* stream) {
  if (D != n_heads * HD || S_pad % HD != 0 || S_pad < HD || layer < 0 || layer >= L || B < 1 ||
      B > 65535 || n_heads > 65535 || dynamic_smem_bytes(1, S_pad) > kMaxDynamicSmem)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (form) {
    case 0:
      return launch<1>(q, kq, ks, vq, vs, out, B, S_pad, D, n_heads, layer, device, st);
    case 1:
      return launch_stream(q, kq, ks, vq, vs, out, L, B, S_pad, D, n_heads, layer, device, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
