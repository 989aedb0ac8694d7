// K10: flash-decode attention of one query row per (sample, head), with S
// split over a thread-block cluster.
//
// Replaces sar_tpu/ops/attic/attention.py::decode_attention (Pallas
// `_kernel_full` and `_kernel_masked`, both `_attend`), a parked experiment
// with no caller in either package. Per sample b and head h: q [B, H, 64]
// (pre-scaled) and k/v [B, H, S, 64] bf16,
//   score_s = q . k_s in fp32, masked to -1e30 for s >= n (n = S for the
//   full variant; the masked variant's n is read from device memory when
//   given, so one build serves every length), softmax in fp32 NORMALISED
//   by the global sum, w_s = bf16(p_s / sum), out = sum_s w_s v_s
//   accumulated in fp32, stored bf16 [B, H, 64]. n = 0 masks every score:
//   the softmax is uniform over all S rows, as in the TPU kernel.
//
// Bound on the H100: bytes. At whisper-small's cross shape (B=8, H=12,
// S=1500) one call reads 2*B*H*S*64*2 = 36.9 MB of k/v (11.0 us at
// 3.35 TB/s) for 4*B*H*S*64 = 37 MFLOP; the masked variant needs only its
// first n rows. One block per (head, sample), as before, gave 96 blocks
// with ~4 KB in flight each: about 1 TB/s. Design:
//   - a cluster of C <= 8 blocks per (head, sample), C = ceil(S / 128)
//     capped at 8 (the portable cluster size), each block owning a slice
//     of ceil(S / C) rows: 768 blocks of 188 rows at the cross shape;
//   - bytes in flight: each block first issues its k rows, eight 16-byte
//     loads per thread (eight threads per 128-byte row), then its v slice
//     into shared memory with 16-byte cp.async copies (a ring of NS stages
//     of 32 rows; a slice of up to NS * 32 rows is issued whole, a longer
//     one streams through the ring), so v lands while the scores are
//     computed; rows at or past n are not read;
//   - the exact softmax of the TPU kernel across the cluster: each block
//     pushes its local max m_r and sum l_r = sum exp(s - m_r) into every
//     block's shared memory (remote stores through distributed shared
//     memory, no round trip), one cluster barrier, and every block forms
//     the global max M and the global sum sum_r l_r exp(m_r - M) in rank
//     order: the same in every block. Each block then rounds
//     w_s = bf16(exp(s - M) / sum) where the TPU kernel does, sums its
//     rows' w_s v_s into an fp32 [64] partial and pushes it into rank 0,
//     which after a second barrier adds the C partials in rank order and
//     stores bf16. One launch, no atomics: the same output on every run.
// The split, k before v and the pushed exchange were the fastest of the
// variants timed on an H100 at the cross shape (C = 6, v before k, and
// pulling the statistics with four barriers were slower).
#include <cooperative_groups.h>

#include "cluster.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int HD = 64;
constexpr int NT = 256;
constexpr int TPR = HD / 8;   // threads per row: 8 bf16 (16 bytes) each
constexpr int RG = NT / TPR;  // row groups: rows per pass
constexpr int NS = 8;         // v ring stages of RG rows (32 KB)
constexpr int U = 8;          // k rows a thread has in flight
constexpr int MAX_CLUSTER = 8;
constexpr int MIN_SLICE = 128;
// Dynamic shared memory a block may ask for: the card's 232,448 bytes less
// 8 KB for the static arrays below (4,288 bytes).
constexpr int kMaxDynamicSmem = 232448 - 8192;

// The split of S (mirrored by ops/attic/attention.py::cluster_split).
__host__ __device__ constexpr int cluster_size(int S) {
  return (S + MIN_SLICE - 1) / MIN_SLICE < MAX_CLUSTER ? (S + MIN_SLICE - 1) / MIN_SLICE
                                                       : MAX_CLUSTER;
}
__host__ __device__ constexpr int slice_rows(int S) {
  return (S + cluster_size(S) - 1) / cluster_size(S);
}
__host__ __device__ constexpr int ring_stages(int S) {
  return (slice_rows(S) + RG - 1) / RG < NS ? (slice_rows(S) + RG - 1) / RG : NS;
}
// Dynamic shared memory: the v ring, then the slice's scores (fp32).
__host__ __device__ constexpr int dynamic_smem_bytes(int S) {
  return ring_stages(S) * RG * HD * 2 + (slice_rows(S) + 3) / 4 * 16;
}

__global__ void __launch_bounds__(NT)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q,  // [B, H, 64]
                        const __nv_bfloat16* __restrict__ k,  // [B, H, S, 64]
                        const __nv_bfloat16* __restrict__ v,
                        const int* __restrict__ n_dev, int n_host,
                        __nv_bfloat16* __restrict__ out,      // [B, H, 64]
                        int H, int S, int slice) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [stages][RG][64]
  float* sc = reinterpret_cast<float*>(smem_raw + ring_stages(S) * RG * HD * 2);  // [slice]
  __shared__ float scratch[32];
  __shared__ float red[NT / 32][HD];
  __shared__ float stats[MAX_CLUSTER][2];  // every block's max and sum
  __shared__ float parts[MAX_CLUSTER][HD];  // every block's P.V (rank 0's)

  cg::cluster_group cluster = cg::this_cluster();
  sar::cluster_arrive();  // paired with cluster_wait() before the first remote store
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int part8 = tid % TPR;  // columns 8*part8 .. 8*part8+7
  const int rg = tid / TPR;
  const int h = blockIdx.y, b = blockIdx.z;
  int n = n_dev != nullptr ? *n_dev : n_host;
  n = n < 0 ? 0 : (n > S ? S : n);
  const int lo = min(S, rank * slice), hi = min(S, lo + slice);
  const int k_hi = max(lo, min(hi, n));
  // Rows at or past n have p = 0 exactly; with n = 0 every row has p = 1/S.
  const int v_hi = max(lo, min(hi, n > 0 ? n : S));
  const int v_passes = (v_hi - lo + RG - 1) / RG;
  const size_t bh = (size_t)b * H + h;
  const __nv_bfloat16* kb = k + bh * S * HD + part8 * 8;
  const __nv_bfloat16* vb = v + bh * S * HD + part8 * 8;

  // Thread (rg, part8) copies, and later reads, chunk part8 of row rg of
  // each pass: no other thread touches it, so waiting on its own copies is
  // enough.
  auto load_v = [&](int j) {
    const int s = lo + j * RG + rg;
    sar::cp_async16(vs + ((j % NS) * RG + rg) * HD + part8 * 8,
                    vb + (size_t)(s < v_hi ? s : lo) * HD, s < v_hi);
  };
  uint4 raw[U];
  auto load_k = [&](int s0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = s0 + u * RG + rg;
      raw[u] = s < k_hi ? *reinterpret_cast<const uint4*>(kb + (size_t)s * HD)
                        : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  load_k(lo);  // k first: the score pass needs it before v
  for (int j = 0; j < NS; ++j) {  // NS groups, some empty
    if (j < v_passes) load_v(j);
    sar::cp_async_commit();
  }

  float qf[8];
  sar::load_bf16x8(q + bh * HD + part8 * 8, qf);
  float m = -INFINITY;
  for (int s0 = lo; s0 < hi; s0 += U * RG) {
    if (s0 != lo) load_k(s0);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = s0 + u * RG + rg;
      const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw[u]);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(k2[i]);
        dot = fmaf(qf[2 * i], f.x, dot);
        dot = fmaf(qf[2 * i + 1], f.y, dot);
      }
      dot = sar::group_sum<TPR>(dot);  // every lane of the warp takes part
      if (s < hi) {
        const float score = s < n ? dot : sar::kNeg;
        if (part8 == 0) sc[s - lo] = score;
        m = fmaxf(m, score);
      }
    }
  }

  // This block's max and sum of exp(s - max), pushed into every block of
  // the cluster (remote stores, no round trip); the cluster barrier's
  // arrive (release) and wait (acquire) publish them.
  m = sar::block_reduce<true>(m, scratch);
  float lsum = 0.f;
  for (int i = tid; i < hi - lo; i += NT) lsum += expf(sc[i] - m);
  lsum = sar::block_reduce<false>(lsum, scratch);
  sar::cluster_wait();  // every block of the cluster has started
  if (tid < C) {
    float* dst = cluster.map_shared_rank(&stats[0][0], tid);
    dst[2 * rank] = m;
    dst[2 * rank + 1] = lsum;
  }
  cluster.sync();
  // The global max and the global sum, in rank order: the same in every
  // block. Rows of a block have sum(exp(s - M)) = lsum * exp(m - M); an
  // empty block posts (-inf, 0) and adds 0.
  float gmax = -INFINITY;
  for (int r = 0; r < C; ++r) gmax = fmaxf(gmax, stats[r][0]);
  float tot = 0.f;
  for (int r = 0; r < C; ++r) tot += stats[r][1] * expf(stats[r][0] - gmax);
  for (int i = tid; i < hi - lo; i += NT) sc[i] = sar::bf16_round(expf(sc[i] - gmax) / tot);
  __syncthreads();

  float acc[8] = {};
  for (int j = 0; j < v_passes; ++j) {
    sar::cp_async_wait<NS - 1>();  // pass j landed (this thread's chunk)
    const int s = lo + j * RG + rg;
    if (s < v_hi) {
      const float w = sc[s - lo];
      float vf[8];
      sar::load_bf16x8(vs + ((j % NS) * RG + rg) * HD + part8 * 8, vf);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = fmaf(w, vf[i], acc[i]);
    }
    if (j + NS < v_passes) load_v(j + NS);  // into the stage just read
    sar::cp_async_commit();
  }
  // Sum over the 4 row groups of this warp (lanes that differ in bits 3-4),
  // then over the 8 warps, and push the partial into rank 0.
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int o = TPR; o < 32; o <<= 1) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
  const int warp = tid >> 5;
  if ((tid & 31) < TPR) {
#pragma unroll
    for (int i = 0; i < 8; ++i) red[warp][part8 * 8 + i] = acc[i];
  }
  __syncthreads();
  if (tid < HD) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) o += red[w][tid];
    cluster.map_shared_rank(&parts[0][0], 0)[rank * HD + tid] = o;
  }
  cluster.sync();  // every partial is in rank 0; no block touches another after this
  if (rank == 0 && tid < HD) {
    float o = 0.f;
    for (int r = 0; r < C; ++r) o += parts[r][tid];
    out[bh * HD + tid] = __float2bfloat16_rn(o);
  }
}

bool smem_done[sar::kMaxDevices] = {};

}  // namespace

extern "C" int sar_decode_attention(const void* q, const void* k, const void* v,
                                    const void* n_dev, int n_host, void* out, int B, int H,
                                    int S, int device, void* stream) {
  if (S < 1 || B < 1 || B > 65535 || H < 1 || H > 65535 ||
      dynamic_smem_bytes(S) > kMaxDynamicSmem)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // The limit is raised once; each launch asks for what its S needs.
  err = sar::allow_smem_once(smem_done, device, decode_attention_kernel, kMaxDynamicSmem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cluster_size(S), H, B);
  config.blockDim = dim3(NT);
  config.dynamicSmemBytes = dynamic_smem_bytes(S);
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster_size(S);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, decode_attention_kernel,
                           static_cast<const __nv_bfloat16*>(q),
                           static_cast<const __nv_bfloat16*>(k),
                           static_cast<const __nv_bfloat16*>(v),
                           static_cast<const int*>(n_dev), n_host,
                           static_cast<__nv_bfloat16*>(out), H, S, slice_rows(S));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
