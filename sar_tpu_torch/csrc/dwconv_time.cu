// K12: depthwise convolution over time of a [B, T, C] bf16 activation,
// with the zero padding of the valid frames, the bias and the block's next
// elementwise step fused (E-Branchformer's two time convolutions, OWSM's
// encoder: sar_tpu_torch/models/ebranchformer.py).
//
// Replaces no TPU kernel: the JAX package has no E-Branchformer. The plain
// PyTorch path (sar_tpu_torch/ops/dwconv.py::depthwise_conv_time_reference,
// kept as this kernel's plain version) zeroed the pad rows, transposed
// [B, T, C] to F.conv1d's [B, C, T] and back, and took PyTorch's generic
// depthwise kernel (cuDNN takes no 31-tap depthwise filter), then gated or
// added in further passes: on the H100 at OWSM v4 medium B=128, some
// 0.14 s of the generic kernel and as much again of copies and elementwise
// passes per batch, about a third of the encoder.
//
// Per sample b, frame t and channel c (P = K / 2, K odd):
//   acc = bias_c + sum_j w_{c,j} * x_{b, t + j - P, c}   (x read as 0 outside
//         [0, t_valid): the zero padding of the unpadded convolution, so
//         the pad rows of a padded batch are never read),
//   y = bf16(gate_{b,t,c} * acc)   (the cgMLP's gate: r * conv(g)), or
//   y = bf16(x_{b,t,c} + acc)      (the merge: m + conv(m)), or bf16(acc);
// products of bf16 values summed in fp32, one rounding at the end.
//
// Bound on the H100: bytes. A call reads x (and the gate) and writes y,
// 2 bytes a value each: at OWSM B=128, T 749 (valid), C 2048 the gated
// call moves 1.18 GB (0.35 ms at 3.35 TB/s) for 2 * 31 FLOPs a value on
// the CUDA cores (~10 FLOP a byte, below the line of their fp32 rate).
// Design:
//   - a block of 128 threads covers 256 channels (two a thread, bf16x2:
//     a warp reads 128 contiguous bytes of a row) and 32 output frames;
//   - each thread stages its two channels of the 32 + K - 1 input frames
//     in its own column of shared memory (zeros outside [0, t_valid)); a
//     thread reads back only its own column, so no barrier is needed, and
//     a warp's 32 consecutive words hit 32 banks;
//   - the sum runs tap by tap (the two taps in registers) over 32 fp32
//     bf16x2 accumulators, then the epilogue adds the bias, gates or adds
//     the residual read from x (pad rows included, as the plain version)
//     and stores bf16x2. No atomics: the same bits on every run.
#include "common.cuh"

namespace {

constexpr int NT = 128;        // threads per block, two channels each
constexpr int CT = 2 * NT;     // channels per block
constexpr int TT = 32;         // output frames per block
constexpr int MAX_K = 63;      // taps; the staged column fits 48 KB

__host__ __device__ constexpr int dynamic_smem_bytes(int k) {
  return (TT + k - 1) * NT * 4;
}
static_assert(dynamic_smem_bytes(MAX_K) <= 48 * 1024, "no opt-in needed");

__global__ void __launch_bounds__(NT)
dwconv_time_kernel(const __nv_bfloat16* __restrict__ x,     // [B, T, C]
                   const __nv_bfloat16* __restrict__ w,     // [C, K]
                   const __nv_bfloat16* __restrict__ bias,  // [C]
                   const __nv_bfloat16* __restrict__ gate,  // [B, T, gate_stride] or null
                   __nv_bfloat16* __restrict__ y,           // [B, T, C]
                   int T, int C, int K, int t_valid, int gate_stride, int residual) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat162* col = reinterpret_cast<__nv_bfloat162*>(smem_raw);   // [TT + K - 1][NT]
  const int tid = threadIdx.x;
  const int c = blockIdx.x * CT + 2 * tid;
  const int t0 = blockIdx.y * TT;
  const int b = blockIdx.z;
  if (c >= C) return;                        // C is even: both channels or neither
  const int P = K / 2;
  const size_t row0 = (size_t)b * T;
  const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
  for (int r = 0; r < TT + K - 1; ++r) {
    const int t = t0 - P + r;
    col[r * NT + tid] = (t >= 0 && t < t_valid)
        ? *reinterpret_cast<const __nv_bfloat162*>(x + (row0 + t) * C + c)
        : zero;
  }
  float2 acc[TT];
#pragma unroll
  for (int r = 0; r < TT; ++r) acc[r] = make_float2(0.f, 0.f);
  const __nv_bfloat16* w0 = w + (size_t)c * K;
  const __nv_bfloat16* w1 = w0 + K;
  for (int j = 0; j < K; ++j) {
    const float a0 = __bfloat162float(w0[j]), a1 = __bfloat162float(w1[j]);
#pragma unroll
    for (int r = 0; r < TT; ++r) {
      const float2 v = __bfloat1622float2(col[(r + j) * NT + tid]);
      acc[r].x = fmaf(a0, v.x, acc[r].x);
      acc[r].y = fmaf(a1, v.y, acc[r].y);
    }
  }
  const float b0 = __bfloat162float(bias[c]), b1 = __bfloat162float(bias[c + 1]);
#pragma unroll
  for (int r = 0; r < TT; ++r) {
    const int t = t0 + r;
    if (t >= T) continue;
    float v0 = acc[r].x + b0, v1 = acc[r].y + b1;
    if (gate != nullptr) {
      const float2 g = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(gate + (row0 + t) * gate_stride + c));
      v0 *= g.x;
      v1 *= g.y;
    }
    if (residual) {
      const float2 xv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(x + (row0 + t) * C + c));
      v0 += xv.x;
      v1 += xv.y;
    }
    *reinterpret_cast<__nv_bfloat162*>(y + (row0 + t) * C + c) = __floats2bfloat162_rn(v0, v1);
  }
}

}  // namespace

extern "C" int sar_dwconv_time(const void* x, const void* w, const void* bias, const void* gate,
                               void* y, int B, int T, int C, int K, int t_valid,
                               int gate_stride, int residual, int device, void* stream) {
  if (B < 1 || B > 65535 || T < 1 || C < 2 || C % 2 || K < 1 || K % 2 == 0 || K > MAX_K ||
      t_valid < 0 || t_valid > T || (gate != nullptr && (gate_stride < C || gate_stride % 2)))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((C + CT - 1) / CT, (T + TT - 1) / TT, B);
  dwconv_time_kernel<<<grid, NT, dynamic_smem_bytes(K), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(bias), static_cast<const __nv_bfloat16*>(gate),
      static_cast<__nv_bfloat16*>(y), T, C, K, t_valid, gate_stride, residual);
  return (int)cudaGetLastError();
}
