// The block-normalize tail (eq. 5) shared by the dense block-norm and
// fused kernels: v * rsqrt(sum(v^2) + eps^2) over one 36-value block.
// Mirrors repro/core/numerics.py:104 finish_blocks for the float
// flavors; the fixed flavor (int8 quantize) is slice 2.
#pragma once

#include <math.h>

namespace hog {

enum NormMode { kRsqrt = 0, kNr = 1 };

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

// Normalize v[36] in place. eps2 is eps^2 rounded once from f64 to f32
// by the caller (numerics.py:126-128).
template <int NORM>
__device__ __forceinline__ void finish_block(float v[36], float eps2) {
  float ss = 0.0f;
#pragma unroll
  for (int k = 0; k < 36; ++k) ss = __fadd_rn(ss, __fmul_rn(v[k], v[k]));
  ss = __fadd_rn(ss, eps2);
  // rsqrt flavor: correctly rounded sqrt and divide (rsqrtf's ~2 ulp
  // approximation would be further from the reference)
  const float rs = NORM == kNr ? nr_rsqrt(ss) : __fdiv_rn(1.0f, sqrtf(ss));
#pragma unroll
  for (int k = 0; k < 36; ++k) v[k] = __fmul_rn(v[k], rs);
}

}  // namespace hog
