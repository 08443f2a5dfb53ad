// Batched linear-SVM window scoring (eq. 6): feats (B, F) f32 or bf16,
// w (F,) f32, b () f32 -> scores (B,) f32 = feats . w + b, accumulated in
// f32. A bf16 feature is upcast exactly (its 16 bits become the high half
// of an f32) before its product with the f32 weight, which is what the
// reference kernel path computes.
//
// Replaces the TPU kernel repro/kernels/svm_matmul.py:38 (svm_scores),
// a (TB, TF) x (TF, 1) MXU matmul with F padded to 3840 and the K grid
// dimension accumulating into the output block. A one-column product
// has nothing for a matrix unit to reuse, so here one warp owns one
// window row: each lane walks the row in vector loads -- 16 bytes (4
// f32) for f32 rows (15,120 B, 16-byte aligned on every row), 8 bytes
// (4 bf16) for bf16 rows (7,560 B: 16-byte loads would be misaligned on
// odd rows) -- with the matching 16 bytes of weights, sums its products
// in order, then a 5-step xor shuffle adds the 32 lane sums and lane 0
// adds the bias. Rows whose length or address does not allow the vector
// loads take scalar loads.
//
// Bound on the H100: bytes. One row is 15.1 KB in f32 (7.6 KB in bf16),
// so B = 5,949 rows read 90 MB (45 MB), 27 us (13 us) at 3.35 TB/s; the
// 15 KB weight vector stays in L1/L2. 2*F operations per row are far
// below the f32 rate.
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int THREADS = 256;          // 8 warps: 8 rows per thread block

__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// one lane's share of the row: 4 features per vector step
__device__ __forceinline__ float dot4(const float4 x, const float4 w,
                                      float acc) {
  acc = __fadd_rn(acc, __fmul_rn(x.x, w.x));
  acc = __fadd_rn(acc, __fmul_rn(x.y, w.y));
  acc = __fadd_rn(acc, __fmul_rn(x.z, w.z));
  return __fadd_rn(acc, __fmul_rn(x.w, w.w));
}

__device__ __forceinline__ float lane_sum(const float* __restrict__ x,
                                          const float* __restrict__ w, int F,
                                          bool vec, int lane) {
  float acc = 0.0f;
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* w4 = reinterpret_cast<const float4*>(w);
    for (int i = lane; i < F / 4; i += 32) acc = dot4(x4[i], w4[i], acc);
  } else {
    for (int i = lane; i < F; i += 32)
      acc = __fadd_rn(acc, __fmul_rn(x[i], w[i]));
  }
  return acc;
}

__device__ __forceinline__ float lane_sum(const uint16_t* __restrict__ x,
                                          const float* __restrict__ w, int F,
                                          bool vec, int lane) {
  float acc = 0.0f;
  if (vec) {
    const uint2* x2 = reinterpret_cast<const uint2*>(x);
    const float4* w4 = reinterpret_cast<const float4*>(w);
    for (int i = lane; i < F / 4; i += 32) {
      const uint2 u = x2[i];
      const float4 f = make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y),
                                   bf16_hi(u.y));
      acc = dot4(f, w4[i], acc);
    }
  } else {
    for (int i = lane; i < F; i += 32)
      acc = __fadd_rn(acc, __fmul_rn(__uint_as_float(
                                         static_cast<uint32_t>(x[i]) << 16),
                                     w[i]));
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
svm_scores_kernel(const T* __restrict__ feats, const float* __restrict__ w,
                  const float* __restrict__ bias, float* __restrict__ out,
                  int B, int F, bool vec) {
  const long long row = (static_cast<long long>(blockIdx.x) * THREADS +
                         threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (row >= B) return;                 // whole warps leave together
  float acc = lane_sum(feats + row * F, w, F, vec, lane);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (lane == 0) out[row] = __fadd_rn(acc, bias[0]);
}

bool aligned(const void* p, unsigned bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// feats is f32 when bf16 == 0, bf16 (as raw 16-bit words) otherwise.
extern "C" int svm_scores_launch(const void* feats, const float* w,
                                 const float* bias, float* out, int B, int F,
                                 int bf16, void* stream) {
  if (B <= 0) return 0;
  const unsigned grid =
      static_cast<unsigned>((static_cast<long long>(B) * 32 + THREADS - 1) /
                            THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // vector loads need whole 4-feature steps and aligned bases; with F a
  // multiple of 4 every row then starts 16-byte (f32) or 8-byte (bf16)
  // aligned
  const bool vec = F % 4 == 0 && aligned(w, 16) &&
                   aligned(feats, bf16 ? 8 : 16);
  if (bf16)
    svm_scores_kernel<uint16_t><<<grid, THREADS, 0, s>>>(
        static_cast<const uint16_t*>(feats), w, bias, out, B, F, vec);
  else
    svm_scores_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(feats), w, bias, out, B, F, vec);
  return static_cast<int>(cudaGetLastError());
}
