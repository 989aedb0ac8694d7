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
#include <cooperative_groups.h>

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
