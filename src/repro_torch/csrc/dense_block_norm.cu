// Dense 2x2-block L2 normalization (eq. 5) over a scene's cell grid:
// (B, ch, cw, 9) f32 histograms -> (B, ch-1, cw-1, 36) f32 blocks.
//
// Replaces the TPU kernel repro/kernels/dense_block_norm.py:41
// (dense_block_norm), which tiles row slabs of the block grid and reads
// two row-shifted views of the histograms for the block halo. Here one
// thread owns one block: it gathers the four cells in the reference's
// order (0,0), (0,1), (1,0), (1,1) -- 36 values in registers -- and
// applies the shared tail (finish_blocks.cuh) in the rsqrt or
// Newton-Raphson flavor.
//
// Bound on the H100: at 640x480 it reads 0.17 MB and writes 0.65 MB,
// a quarter of a microsecond at 3.35 TB/s, so a launch (a few us)
// dominates. Each thread's 36 output floats are contiguous, so a warp's
// stores cover 32 * 144 contiguous bytes.
#include <cuda_runtime.h>

#include "finish_blocks.cuh"

namespace {

template <int NORM>
__global__ void dense_block_norm_kernel(const float* __restrict__ hist,
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
      const float* src = hist + ((b * ch + bi + i) * cw + bj + j) * 9;
#pragma unroll
      for (int k = 0; k < 9; ++k) v[(i * 2 + j) * 9 + k] = src[k];
    }
  }
  hog::finish_block<NORM>(v, eps2);
  float* dst = out + t * 36;
#pragma unroll
  for (int k = 0; k < 36; ++k) dst[k] = v[k];
}

}  // namespace

extern "C" int dense_block_norm_launch(const float* hist, float* out, int B,
                                       int ch, int cw, float eps2, int norm,
                                       void* stream) {
  const long long n = static_cast<long long>(B) * (ch - 1) * (cw - 1);
  if (n <= 0) return 0;
  const int block = 128;
  const unsigned grid = static_cast<unsigned>((n + block - 1) / block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (norm == hog::kNr)
    dense_block_norm_kernel<hog::kNr>
        <<<grid, block, 0, s>>>(hist, out, B, ch, cw, eps2);
  else
    dense_block_norm_kernel<hog::kRsqrt>
        <<<grid, block, 0, s>>>(hist, out, B, ch, cw, eps2);
  return static_cast<int>(cudaGetLastError());
}
