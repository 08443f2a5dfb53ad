// Dense 2x2-block L2 normalization (eq. 5) over a scene's cell grid:
// (B, ch, cw, 9) f32 histograms -> (B, ch-1, cw-1, 36) f32 blocks, or, in
// the fixed flavor, int16 histograms -> f32 blocks on their per-block
// int8 grid.
//
// Replaces the TPU kernel repro/kernels/dense_block_norm.py:41
// (dense_block_norm), which tiles row slabs of the block grid and reads
// two row-shifted views of the histograms for the block halo. Here one
// thread owns one block: it gathers the four cells in the reference's
// order (0,0), (0,1), (1,0), (1,1) -- 36 values in registers -- and
// applies the shared tail (finish_blocks.cuh) in the rsqrt,
// Newton-Raphson or fixed flavor; the fixed flavor converts the int16
// counts to f32 (exact) and ends in the int8 quantize-dequantize.
//
// Bound on the H100: at 640x480 it reads 0.17 MB and writes 0.65 MB,
// a quarter of a microsecond at 3.35 TB/s, so a launch (a few us)
// dominates. Each thread's 36 output floats are contiguous, so a warp's
// stores cover 32 * 144 contiguous bytes.
#include <cuda_runtime.h>

#include <stdint.h>

#include "finish_blocks.cuh"

namespace {

template <int NORM, typename In>
__global__ void dense_block_norm_kernel(const In* __restrict__ hist,
                                        float* __restrict__ out, int B,
                                        int ch, int cw, float eps2) {
  const int bh = ch - 1, bw = cw - 1;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= static_cast<long long>(B) * bh * bw) return;
  const int bj = static_cast<int>(t % bw);
  const int bi = static_cast<int>((t / bw) % bh);
  const long long b = t / (static_cast<long long>(bh) * bw);
  float v[36];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const In* src = hist + ((b * ch + bi + i) * cw + bj + j) * 9;
#pragma unroll
      for (int k = 0; k < 9; ++k)
        v[(i * 2 + j) * 9 + k] = static_cast<float>(src[k]);
    }
  }
  hog::finish_block<NORM>(v, eps2);
  float* dst = out + t * 36;
#pragma unroll
  for (int k = 0; k < 36; ++k) dst[k] = v[k];
}

}  // namespace

// hist is f32 for the rsqrt and nr flavors, int16 for fixed.
extern "C" int dense_block_norm_launch(const void* hist, float* out, int B,
                                       int ch, int cw, float eps2, int norm,
                                       void* stream) {
  const long long n = static_cast<long long>(B) * (ch - 1) * (cw - 1);
  if (n <= 0) return 0;
  const int block = 128;
  const unsigned grid = static_cast<unsigned>((n + block - 1) / block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fh = static_cast<const float*>(hist);
  if (norm == hog::kNr)
    dense_block_norm_kernel<hog::kNr>
        <<<grid, block, 0, s>>>(fh, out, B, ch, cw, eps2);
  else if (norm == hog::kRsqrt)
    dense_block_norm_kernel<hog::kRsqrt>
        <<<grid, block, 0, s>>>(fh, out, B, ch, cw, eps2);
  else
    dense_block_norm_kernel<hog::kFixedNorm><<<grid, block, 0, s>>>(
        static_cast<const int16_t*>(hist), out, B, ch, cw, eps2);
  return static_cast<int>(cudaGetLastError());
}
