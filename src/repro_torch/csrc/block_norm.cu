// Window block L2 normalization (HOG stages 4-5, eq. 5): (B, ch, cw, 9)
// cell histograms, f32 or the fixed chain's int16 -> (B, ch-1, cw-1, 36)
// f32 blocks in every flavor (the fixed flavor's on their per-block int8
// grid).
//
// Replaces the TPU kernel repro/kernels/block_norm.py:41 (block_norm),
// which concatenates four shifted views of an 8-window slab's
// histograms. Here one thread block owns one window: its threads copy
// the window's ch*cw*9 histogram values into shared memory as f32 (exact
// for int16) with consecutive threads on consecutive addresses, then one
// thread per block gathers the four cells in the reference's order
// (0,0), (0,1), (1,0), (1,1), bins within each, and applies the shared
// tail (finish_blocks.cuh: rsqrt, Newton-Raphson or fixed). The
// normalized blocks go back to shared memory (a 37-float row stride, so
// the 36-float rows do not fall on the same banks) and leave in one
// coalesced copy of the window's contiguous (ch-1)*(cw-1)*36 floats.
//
// Bound on the H100: bytes. A window reads 4.6 KB of f32 histograms
// (2.3 KB int16) and writes 15.1 KB of blocks, so B = 5,949 windows move
// 0.12 GB, 35 us at 3.35 TB/s; ~110 operations per block (230 fixed)
// are far below the f32 rate. Shared memory per thread block: 20 KB at
// the paper's 16x8 cells, under the 48 KB default (the wrapper checks).
#include <cuda_runtime.h>

#include <stdint.h>

#include "finish_blocks.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int STRIDE = 37;            // staged row of one block's 36 floats

template <int NORM, typename In>
__global__ void __launch_bounds__(THREADS)
block_norm_kernel(const In* __restrict__ hist, float* __restrict__ out,
                  int ch, int cw, float eps2) {
  extern __shared__ float smem[];
  const int bh = ch - 1, bw = cw - 1;
  const int nin = ch * cw * 9, nblk = bh * bw;
  float* cells = smem;                          // (ch, cw, 9)
  float* staged = smem + nin;                   // (nblk, STRIDE)
  const long long b = blockIdx.x;
  const In* src = hist + b * nin;
  for (int i = threadIdx.x; i < nin; i += THREADS)
    cells[i] = static_cast<float>(src[i]);
  __syncthreads();

  for (int q = threadIdx.x; q < nblk; q += THREADS) {
    const int bi = q / bw, bj = q % bw;
    float v[36];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float* c = cells + ((bi + i) * cw + bj + j) * 9;
#pragma unroll
        for (int k = 0; k < 9; ++k) v[(i * 2 + j) * 9 + k] = c[k];
      }
    }
    hog::finish_block<NORM>(v, eps2);
#pragma unroll
    for (int k = 0; k < 36; ++k) staged[q * STRIDE + k] = v[k];
  }
  __syncthreads();

  float* dst = out + b * nblk * 36;
  for (int i = threadIdx.x; i < nblk * 36; i += THREADS)
    dst[i] = staged[(i / 36) * STRIDE + i % 36];
}

template <int NORM, typename In>
void launch(const void* hist, float* out, int B, int ch, int cw, float eps2,
            size_t smem, cudaStream_t s) {
  block_norm_kernel<NORM, In><<<B, THREADS, smem, s>>>(
      static_cast<const In*>(hist), out, ch, cw, eps2);
}

}  // namespace

// hist is f32 for the rsqrt and nr flavors, int16 for fixed.
extern "C" int block_norm_launch(const void* hist, float* out, int B,
                                 int ch, int cw, float eps2, int norm,
                                 void* stream) {
  if (B <= 0 || ch < 2 || cw < 2) return 0;
  // shared memory per window; the wrapper keeps it <= 48 KB
  const size_t smem = 4u * (ch * cw * 9 + (ch - 1) * (cw - 1) * STRIDE);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (norm == hog::kNr)
    launch<hog::kNr, float>(hist, out, B, ch, cw, eps2, smem, s);
  else if (norm == hog::kRsqrt)
    launch<hog::kRsqrt, float>(hist, out, B, ch, cw, eps2, smem, s);
  else
    launch<hog::kFixedNorm, int16_t>(hist, out, B, ch, cw, eps2, smem, s);
  return static_cast<int>(cudaGetLastError());
}
