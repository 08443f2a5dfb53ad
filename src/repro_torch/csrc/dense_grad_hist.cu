// Dense gradient -> magnitude/bin -> 8x8 cell histograms over a whole
// scene: (B, H, W) f32 gray -> (B, ch, cw, 9) f32 (sector, cordic) or
// int16 (fixed: integer magnitudes summed in int32, stored as int16).
//
// Replaces the TPU kernel repro/kernels/dense_grad_hist.py:62
// (dense_grad_hist). The TPU version tiles row slabs through VMEM with
// three row-shifted views for the one-row halo; here every cell reads
// its own 10x10 gray patch straight from global memory (neighbouring
// cells share rows through L1/L2), so there is no halo to stage.
//
// Mapping: 8 consecutive lanes own one cell, lane r computing pixel row
// r of it (8 pixels), and a 3-step xor shuffle sums the 8 partial
// histograms. A warp covers 4 horizontally adjacent cells.
//
// Bound on the H100: at 640x480 the gray is 1.2 MB and the histograms
// 0.17 MB (half that in int16), under a microsecond at 3.35 TB/s; the
// per-pixel work is ~40 operations (sector) or ~150 (cordic, fixed),
// also about a microsecond at the f32 / int32 rate. At these sizes the
// launch itself dominates, so the design aims only at enough threads (8
// per cell) to cover the card. The fixed mode shuffles int32 partial
// sums, which are exact in any order.
#include <cuda_runtime.h>

#include "mag_bin.cuh"

namespace {

template <int MODE>
__global__ void dense_grad_hist_kernel(
    const float* __restrict__ gray,
    typename hog::HistTypes<MODE>::Store* __restrict__ hist, int B, int H,
    int W, int ch, int cw) {
  using Acc = typename hog::HistTypes<MODE>::Acc;
  using Store = typename hog::HistTypes<MODE>::Store;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int r = static_cast<int>(t & 7);
  const long long cell = t >> 3;
  const long long ncell = static_cast<long long>(B) * ch * cw;
  Acc h[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) h[k] = Acc(0);
  if (cell < ncell) {
    const int cj = static_cast<int>(cell % cw);
    const int ci = static_cast<int>((cell / cw) % ch);
    const long long b = cell / (static_cast<long long>(ch) * cw);
    hog::row_hist<MODE>(gray + b * H * W, W, ci * 8 + r, cj * 8, h);
  }
  // every lane reaches the shuffle, active or not
  hog::reduce_cell_lanes(h);
  if (cell < ncell && r == 0) {
    Store* out = hist + cell * 9;
#pragma unroll
    for (int k = 0; k < 9; ++k) out[k] = static_cast<Store>(h[k]);
  }
}

template <int MODE>
void launch(const float* gray, void* hist, int B, int H, int W, int ch,
            int cw, unsigned grid, int block, cudaStream_t s) {
  dense_grad_hist_kernel<MODE><<<grid, block, 0, s>>>(
      gray, static_cast<typename hog::HistTypes<MODE>::Store*>(hist), B, H,
      W, ch, cw);
}

}  // namespace

// hist is f32 for sector and cordic, int16 for fixed.
extern "C" int dense_grad_hist_launch(const float* gray, void* hist, int B,
                                      int H, int W, int mode,
                                      void* stream) {
  const int ch = (H - 2) / 8;
  const int cw = (W - 2) / 8;
  const long long threads = static_cast<long long>(B) * ch * cw * 8;
  if (threads <= 0) return 0;
  const int block = 256;                     // a multiple of 8 lanes
  const unsigned grid = static_cast<unsigned>((threads + block - 1) / block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == hog::kSector)
    launch<hog::kSector>(gray, hist, B, H, W, ch, cw, grid, block, s);
  else if (mode == hog::kCordic)
    launch<hog::kCordic>(gray, hist, B, H, W, ch, cw, grid, block, s);
  else
    launch<hog::kFixed>(gray, hist, B, H, W, ch, cw, grid, block, s);
  return static_cast<int>(cudaGetLastError());
}
