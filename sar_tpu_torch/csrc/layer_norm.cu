// K13: LayerNorm of bf16 rows with fp32 parameters, in fp32, one rounding
// to bf16 at the end (the E-Branchformer blocks' LayerNorms, OWSM's
// encoder: sar_tpu_torch/models/ebranchformer.py).
//
// Replaces no TPU kernel: the JAX package's LayerNorm is XLA's fusion of
// jnp ops. The port's plain version is ops/layer_norm.py::
// layer_norm_reference (x.float(), mean, population variance, (x - mean) *
// rsqrt(var + eps), * scale + bias, cast back), which PyTorch runs as some
// seven elementwise and reduction passes over fp32 copies of the rows: on
// the H100 at OWSM v4 medium B=128 (90 LayerNorms over [128, 768,
// 1024-2048] a batch) about 0.25 s, a fifth of a batch. That plain version
// stays the kernel's reference. The decoder step (models/whisper.py::
// decode_step) launches K13 for its first LayerNorm and K14 (below) for the
// others; Whisper's encoder and teacher-forced decoder keep the plain
// version.
//
// Per row of D values (x_i bf16, read through the row strides of a [B, T, D]
// view: a slice of a wider activation or of the padded frames is read in
// place): mean = sum x_i / D, var = sum (x_i - mean)^2 / D (two passes over
// the row held in registers), y_i = bf16((x_i - mean) * rsqrt(var + eps) *
// scale_i + bias_i), fp32 throughout.
//
// Bound on the H100: bytes, 2 a value read and 2 written (the fp32
// parameters stay in L1/L2): 0.40 GB, 0.12 ms for [128, 768, 1024]. Design:
// one warp per row, four rows a block; each lane holds D / 32 values in
// registers (16-byte loads of 8 bf16, lanes on neighbouring chunks), the
// sums by butterfly shuffles, so the row is read once and written once.
// D is a multiple of 256 up to 4096 (a template over D / 256).
#include "common.cuh"

namespace {

constexpr int WARPS = 4;

template <int NCH>   // 8-value chunks per lane: D = 256 * NCH
__global__ void __launch_bounds__(WARPS * 32)
layer_norm_rows_kernel(const __nv_bfloat16* __restrict__ x,   // [B, T, D] via strides
                       const float* __restrict__ scale, const float* __restrict__ bias,
                       __nv_bfloat16* __restrict__ y,         // [B * T, D] contiguous
                       int N, int T, long long sb, long long st, float eps) {
  constexpr int D = 256 * NCH;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= N) return;
  const __nv_bfloat16* xr = x + (row / T) * sb + (row % T) * st;
  float v[NCH][8];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    sar::load_bf16x8(xr + (i * 32 + lane) * 8, v[i]);
#pragma unroll
    for (int k = 0; k < 8; ++k) sum += v[i][k];
  }
  const float mean = sar::group_sum<32>(sum) / D;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < NCH; ++i)
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float d = v[i][k] - mean;
      sq = fmaf(d, d, sq);
    }
  const float rstd = rsqrtf(sar::group_sum<32>(sq) / D + eps);
  __nv_bfloat16* yr = y + (size_t)row * D;
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int c0 = (i * 32 + lane) * 8;
    float o[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) o[k] = (v[i][k] - mean) * rstd * scale[c0 + k] + bias[c0 + k];
    sar::store_bf16x8(yr + c0, o);
  }
}

template <int NCH>
cudaError_t launch(const void* x, const void* scale, const void* bias, void* y, int N, int T,
                   long long sb, long long st, float eps, cudaStream_t stream) {
  layer_norm_rows_kernel<NCH><<<(N + WARPS - 1) / WARPS, WARPS * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), N, T, sb, st, eps);
  return cudaGetLastError();
}

// K14: the residual add and LayerNorm at a sublayer boundary of the
// decoder step (models/whisper.py::decode_step): after the self and cross
// attentions' output projections and after fc2, the residual x takes the
// projection's output y (and its bias b, where no LoRA term follows the
// bias), and the next sublayer's LayerNorm reads the sum.
//
// Replaces no TPU kernel: XLA fuses the jnp adds and LayerNorm. The plain
// version, ops/layer_norm.py::add_layer_norm_reference, is `linear`'s bias
// add, the residual add and layer_norm_reference: some twelve launches over
// [B, 1, D] rows at decode shapes (196 KB at B=128, D 768), each a few
// microseconds of launch and tail. So K14 is bound by launch latency, not
// bytes (0.4 us of bytes against ~2 us of launch at B=128), and its design
// is to be one launch: x, y and b read once, both outputs written once.
//
// Per row, in the plain version's rounding order (x_new bit-equal to it):
// yb_i = bf16(y_i + b_i) (yb_i = y_i without b), x_new_i = bf16(x_i + yb_i),
// then K13's LayerNorm of the bf16 row x_new in fp32 (two passes over the
// row in registers), h_i rounded once to bf16. K13's shape: a warp a row,
// four rows a block, D / 32 values a lane in 16-byte loads.
template <int NCH>   // 8-value chunks per lane: D = 256 * NCH
__global__ void __launch_bounds__(WARPS * 32)
add_ln_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ y,
              const __nv_bfloat16* __restrict__ b,     // [D] or nullptr
              const float* __restrict__ scale, const float* __restrict__ bias,
              __nv_bfloat16* __restrict__ x_new, __nv_bfloat16* __restrict__ h,
              int N, float eps) {
  constexpr int D = 256 * NCH;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= N) return;
  const size_t off = (size_t)row * D;
  float v[NCH][8];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int c0 = (i * 32 + lane) * 8;
    float yv[8];
    sar::load_bf16x8(x + off + c0, v[i]);
    sar::load_bf16x8(y + off + c0, yv);
    if (b != nullptr) {
      float bv[8];
      sar::load_bf16x8(b + c0, bv);
#pragma unroll
      for (int k = 0; k < 8; ++k) yv[k] = __bfloat162float(__float2bfloat16_rn(yv[k] + bv[k]));
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      v[i][k] = __bfloat162float(__float2bfloat16_rn(v[i][k] + yv[k]));
      sum += v[i][k];
    }
    sar::store_bf16x8(x_new + off + c0, v[i]);   // exact: v holds bf16 values
  }
  const float mean = sar::group_sum<32>(sum) / D;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < NCH; ++i)
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float d = v[i][k] - mean;
      sq = fmaf(d, d, sq);
    }
  const float rstd = rsqrtf(sar::group_sum<32>(sq) / D + eps);
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int c0 = (i * 32 + lane) * 8;
    float o[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) o[k] = (v[i][k] - mean) * rstd * scale[c0 + k] + bias[c0 + k];
    sar::store_bf16x8(h + off + c0, o);
  }
}

template <int NCH>
cudaError_t launch_add(const void* x, const void* y, const void* b, const void* scale,
                       const void* bias, void* x_new, void* h, int N, float eps,
                       cudaStream_t stream) {
  add_ln_kernel<NCH><<<(N + WARPS - 1) / WARPS, WARPS * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(y),
      static_cast<const __nv_bfloat16*>(b), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(x_new),
      static_cast<__nv_bfloat16*>(h), N, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sar_layer_norm_rows(const void* x, const void* scale, const void* bias, void* y,
                                   int B, int T, int D, long long sb, long long st, float eps,
                                   int device, void* stream) {
  if (B < 1 || T < 1 || D < 256 || D % 256 || D > 4096 || st % 8 || sb % 8 ||
      (long long)B * T > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int N = B * T;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D / 256) {
    case 1: return (int)launch<1>(x, scale, bias, y, N, T, sb, st, eps, s);
    case 2: return (int)launch<2>(x, scale, bias, y, N, T, sb, st, eps, s);
    case 3: return (int)launch<3>(x, scale, bias, y, N, T, sb, st, eps, s);
    case 4: return (int)launch<4>(x, scale, bias, y, N, T, sb, st, eps, s);
    case 5: return (int)launch<5>(x, scale, bias, y, N, T, sb, st, eps, s);
    case 6: return (int)launch<6>(x, scale, bias, y, N, T, sb, st, eps, s);
    case 7: return (int)launch<7>(x, scale, bias, y, N, T, sb, st, eps, s);
    case 8: return (int)launch<8>(x, scale, bias, y, N, T, sb, st, eps, s);
    case 10: return (int)launch<10>(x, scale, bias, y, N, T, sb, st, eps, s);
    case 12: return (int)launch<12>(x, scale, bias, y, N, T, sb, st, eps, s);
    case 16: return (int)launch<16>(x, scale, bias, y, N, T, sb, st, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int sar_add_layer_norm_rows(const void* x, const void* y, const void* b,
                                       const void* scale, const void* bias, void* x_new,
                                       void* h, int N, int D, float eps, int device,
                                       void* stream) {
  if (N < 1 || D < 256 || D % 256 || D > 4096) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D / 256) {
    case 1: return (int)launch_add<1>(x, y, b, scale, bias, x_new, h, N, eps, s);
    case 2: return (int)launch_add<2>(x, y, b, scale, bias, x_new, h, N, eps, s);
    case 3: return (int)launch_add<3>(x, y, b, scale, bias, x_new, h, N, eps, s);
    case 4: return (int)launch_add<4>(x, y, b, scale, bias, x_new, h, N, eps, s);
    case 5: return (int)launch_add<5>(x, y, b, scale, bias, x_new, h, N, eps, s);
    case 6: return (int)launch_add<6>(x, y, b, scale, bias, x_new, h, N, eps, s);
    case 7: return (int)launch_add<7>(x, y, b, scale, bias, x_new, h, N, eps, s);
    case 8: return (int)launch_add<8>(x, y, b, scale, bias, x_new, h, N, eps, s);
    case 10: return (int)launch_add<10>(x, y, b, scale, bias, x_new, h, N, eps, s);
    case 12: return (int)launch_add<12>(x, y, b, scale, bias, x_new, h, N, eps, s);
    case 16: return (int)launch_add<16>(x, y, b, scale, bias, x_new, h, N, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
