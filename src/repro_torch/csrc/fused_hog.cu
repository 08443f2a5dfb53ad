// Fused window HOG: gradient -> magnitude/bin -> cell histograms -> 2x2
// block normalization in one kernel, (B, H, W) f32 gray windows ->
// (B, (ch-1)*(cw-1)*36) f32 descriptors in window_descriptor's collate
// order (blocks row-major, then the 36 values), so no reshape or
// transpose follows. Only the gray and the descriptors touch global
// memory.
//
// Replaces the TPU kernel repro/kernels/fused_hog.py:75 (fused_hog),
// which runs the whole chain for an 8-window slab in VMEM. Here one
// thread block owns one window:
//   1. its threads copy the window's gray (130x66 f32, 34.3 KB) into
//      shared memory, consecutive threads on consecutive addresses;
//   2. 8 lanes per cell, one pixel row each, compute the gradient and
//      mag/bin from shared memory (mag_bin.cuh) and sum the cell's
//      histogram with warp shuffles into shared memory (16x8x9: 4.6 KB
//      f32, 2.3 KB as the fixed chain's int16);
//   3. one thread per block gathers its four cells in the reference's
//      order and applies the normalize tail (finish_blocks.cuh), staging
//      the 36 values in the gray's space (free after step 2, 37-float
//      row stride against bank conflicts);
//   4. the window's 3,780 floats leave in one coalesced copy.
// Shared memory per thread block: 38.9 KB at the paper's window, under
// the 48 KB default (the wrapper checks).
//
// Bound on the H100: bytes. A window reads 34.3 KB and writes 15.1 KB,
// so B = 5,949 windows move 0.29 GB, 88 us at 3.35 TB/s, against the
// staged kernels' 0.36 ms of bound: the mag/bin and histogram round
// trips never reach device memory.
#include <cuda_runtime.h>

#include "finish_blocks.cuh"
#include "mag_bin.cuh"

namespace {

constexpr int THREADS = 256;          // a multiple of 8 lanes per cell
constexpr int STRIDE = 37;            // staged row of one block's 36 floats

template <int MODE, int NORM>
__global__ void __launch_bounds__(THREADS)
fused_hog_kernel(const float* __restrict__ gray, float* __restrict__ out,
                 int H, int W, int region, float eps2) {
  using Acc = typename hog::HistTypes<MODE>::Acc;
  using Store = typename hog::HistTypes<MODE>::Store;
  extern __shared__ float smem[];
  const int ch = (H - 2) / 8, cw = (W - 2) / 8;
  const int ncell = ch * cw;
  const int bh = ch - 1, bw = cw - 1, nblk = bh * bw;
  float* g = smem;                              // (H, W), then staged
  Store* cells = reinterpret_cast<Store*>(smem + region);   // (ch, cw, 9)
  const long long b = blockIdx.x;

  const float* src = gray + b * H * W;
  for (int i = threadIdx.x; i < H * W; i += THREADS) g[i] = src[i];
  __syncthreads();

  // uniform trip count: every lane reaches the shuffles
  for (int base = 0; base < ncell * 8; base += THREADS) {
    const int task = base + threadIdx.x;
    const int lc = task >> 3, r = task & 7;
    Acc h[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) h[k] = Acc(0);
    if (lc < ncell)
      hog::row_hist<MODE>(g, W, (lc / cw) * 8 + r, (lc % cw) * 8, h);
    hog::reduce_cell_lanes(h);
    if (lc < ncell && r == 0) {
#pragma unroll
      for (int k = 0; k < 9; ++k) cells[lc * 9 + k] = static_cast<Store>(h[k]);
    }
  }
  __syncthreads();                              // the gray is free now

  float* staged = g;
  for (int q = threadIdx.x; q < nblk; q += THREADS) {
    const int bi = q / bw, bj = q % bw;
    float v[36];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const Store* c = cells + ((bi + i) * cw + bj + j) * 9;
#pragma unroll
        for (int k = 0; k < 9; ++k)
          v[(i * 2 + j) * 9 + k] = static_cast<float>(c[k]);
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

template <int MODE, int NORM>
void launch(const float* gray, float* out, int B, int H, int W, float eps2,
            cudaStream_t s) {
  using Store = typename hog::HistTypes<MODE>::Store;
  const int ch = (H - 2) / 8, cw = (W - 2) / 8;
  // floats of the gray / staged-block region, then the cell histograms;
  // the wrapper keeps the total <= 48 KB
  const int staged = (ch - 1) * (cw - 1) * STRIDE;
  const int region = H * W > staged ? H * W : staged;
  const size_t smem = 4u * region + sizeof(Store) * ch * cw * 9;
  fused_hog_kernel<MODE, NORM>
      <<<B, THREADS, smem, s>>>(gray, out, H, W, region, eps2);
}

}  // namespace

extern "C" int fused_hog_launch(const float* gray, float* out, int B, int H,
                                int W, float eps2, int mode, int norm,
                                void* stream) {
  if (B <= 0 || (H - 2) / 8 < 2 || (W - 2) / 8 < 2) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == hog::kFixed)          // the fixed chain has one tail
    launch<hog::kFixed, hog::kFixedNorm>(gray, out, B, H, W, eps2, s);
  else if (mode == hog::kSector && norm == hog::kRsqrt)
    launch<hog::kSector, hog::kRsqrt>(gray, out, B, H, W, eps2, s);
  else if (mode == hog::kSector)
    launch<hog::kSector, hog::kNr>(gray, out, B, H, W, eps2, s);
  else if (norm == hog::kRsqrt)
    launch<hog::kCordic, hog::kRsqrt>(gray, out, B, H, W, eps2, s);
  else
    launch<hog::kCordic, hog::kNr>(gray, out, B, H, W, eps2, s);
  return static_cast<int>(cudaGetLastError());
}
