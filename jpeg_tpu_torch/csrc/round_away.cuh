// round_away: C's roundf (half away from zero) as an int, the quantizer's
// rounding, shared by the encode kernels (encode_dense.cu, dense_fast.cu).

#pragma once

#include <cuda_runtime.h>

namespace {

// roundf(v) as an int (half away from zero), by float adds: adding
// 1.5 * 2^23 rounds |v| < 2^22 to an integer, ties to even, and a tie
// that went toward zero moves one away; the integer's bits then sit in
// the mantissa of r + 1.5 * 2^23.  rintf / __float2int_rn round ties to
// even and would be wrong.
__device__ __forceinline__ int round_away(float v) {
  if (!(fabsf(v) < 4194304.f)) return static_cast<int>(roundf(v));
  float r = __fsub_rn(__fadd_rn(v, 12582912.f), 12582912.f);
  const float d = __fsub_rn(v, r);
  if (d == 0.5f && v > 0.f) r = __fadd_rn(r, 1.f);
  if (d == -0.5f && v < 0.f) r = __fsub_rn(r, 1.f);
  return __float_as_int(__fadd_rn(r, 12582912.f)) - 0x4B400000;
}

}  // namespace
