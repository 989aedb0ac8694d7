// The tensor-core attention forward of flash_attn.cu, shared by K6's
// forward (flash_attn.cu) and K1 / K8's attention half (flash_enc.cu).
#pragma once

#include "common.cuh"

namespace sar {

// Element strides of one [B, H, T, 64] view.
struct Layout {
  long long b, h, t;
};

struct FwdParams {
  const __nv_bfloat16 *q, *k, *v;
  __nv_bfloat16* o;
  float* lse;  // [B, H, Tq] fp32, or null (K1 writes none)
  Layout lq, lk, lv, lo;
  int H, Tq, Tk, causal;
};

// Launches the forward kernel over p.H heads of B samples on `stream`; the
// caller has checked the shape and set `device` current. Returns
// cudaGetLastError() after the launch.
cudaError_t flash_fwd_launch(const FwdParams& p, int B, int device,
                             cudaStream_t stream);

}  // namespace sar
