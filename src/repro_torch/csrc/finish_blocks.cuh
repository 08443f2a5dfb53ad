// The block-normalize tail (eq. 5) shared by the dense block-norm and
// fused kernels: v * rsqrt(sum(v^2) + eps^2) over one 36-value block,
// then, in the fixed flavor, the per-block int8 quantize-dequantize.
// Mirrors repro/core/numerics.py:104 finish_blocks and
// repro/core/quant.py:quantize_dequantize.
#pragma once

#include <math.h>

namespace hog {

enum NormMode { kRsqrt = 0, kNr = 1, kFixedNorm = 2 };

// 1/127 rounded to f32 (quant.py: jnp.float32(1.0 / Q_MAX))
constexpr float kInvQ = 0.007874015718698502f;

// Newton-Raphson rsqrt of the hardware unit (numerics.py:78): the
// 0x5F3759DF exponent-halving seed, then two steps with the reference's
// multiply order y * (1.5 - ((0.5 * x) * y) * y). The _rn intrinsics
// keep nvcc from contracting any of it into an FMA, which would change
// the result's last bits.
__device__ __forceinline__ float nr_rsqrt(float x) {
  const int i = __float_as_int(x);
  float y = __int_as_float(0x5F3759DF - (i >> 1));
#pragma unroll
  for (int it = 0; it < 2; ++it)
    y = __fmul_rn(y, __fsub_rn(1.5f, __fmul_rn(__fmul_rn(__fmul_rn(0.5f, x),
                                                         y), y)));
  return y;
}

// One value of a block onto the block's int8 grid, given scale = max|v| *
// f32(1/127) (a multiply, never a divide): q = rint(v / safe) with an
// IEEE divide and rint's half to even (rintf, not roundf), then q * scale.
__device__ __forceinline__ float quantize_value(float v, float scale) {
  const float safe = scale > 0.0f ? scale : 1.0f;
  return __fmul_rn(rintf(__fdiv_rn(v, safe)), scale);
}

// Put v[36] on its int8 grid.
__device__ __forceinline__ void quantize_dequantize(float v[36]) {
  float m = 0.0f;
#pragma unroll
  for (int k = 0; k < 36; ++k) m = fmaxf(m, fabsf(v[k]));
  const float scale = __fmul_rn(m, kInvQ);
#pragma unroll
  for (int k = 0; k < 36; ++k) v[k] = quantize_value(v[k], scale);
}

// 1 / sqrt(ss) of one block's sum of squares (eps^2 added) in the
// flavor's arithmetic. rsqrt flavor: correctly rounded sqrt and divide
// (rsqrtf's ~2 ulp approximation would be further from the reference).
template <int NORM>
__device__ __forceinline__ float inv_norm(float ss) {
  return NORM == kRsqrt ? __fdiv_rn(1.0f, sqrtf(ss)) : nr_rsqrt(ss);
}

// Normalize v[36] in place. eps2 is eps^2 rounded once from f64 to f32
// by the caller (numerics.py:126-128); for the fixed flavor the caller
// passes (eps * MAG_SCALE)^2.
template <int NORM>
__device__ __forceinline__ void finish_block(float v[36], float eps2) {
  float ss = 0.0f;
#pragma unroll
  for (int k = 0; k < 36; ++k) ss = __fadd_rn(ss, __fmul_rn(v[k], v[k]));
  const float rs = inv_norm<NORM>(__fadd_rn(ss, eps2));
#pragma unroll
  for (int k = 0; k < 36; ++k) v[k] = __fmul_rn(v[k], rs);
  if constexpr (NORM == kFixedNorm) quantize_dequantize(v);
}

}  // namespace hog
