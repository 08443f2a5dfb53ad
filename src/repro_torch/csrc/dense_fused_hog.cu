// Fused dense HOG: gradient -> magnitude/bin -> cell histograms -> 2x2
// block normalization in one kernel, (B, H, W) f32 gray ->
// (B, ch-1, cw-1, 36) f32 blocks. Only the blocks reach global memory.
//
// Replaces the TPU kernel repro/kernels/fused_hog.py:137
// (dense_fused_hog), which runs one program per slab of row_blocks
// block rows over a clamped gather of overlapping gray rows and
// recomputes one cell row per slab boundary.
//
// Here one thread block owns a tile of TR x TC blocks. It computes the
// (TR+1) x (TC+1) cell histograms the tile needs into shared memory
// (1.6 KB; the extra cell row and column are recomputed by the
// neighbouring tiles, as the TPU kernel recomputes one cell row), then
// normalizes its blocks from shared memory. Tiles at the bottom and right
// edges are partial and mask their missing cells and blocks, so ragged
// grids need no padding or clamped gather.
//
// Bound on the H100: at 640x480 it reads 1.2 MB of gray and writes
// 0.65 MB of blocks, about half a microsecond at 3.35 TB/s, so a launch
// dominates; fusing saves the histogram round trip and one launch.
//
// Fixed mode: the lanes sum integer magnitudes in int32, the tile keeps
// the cell histograms as int16 (the int16 store of the reference's
// numerics.store_hist; 0.8 KB), and the tail is the fixed flavor (NR
// rsqrt, then the per-block int8 quantize-dequantize).
#include <cuda_runtime.h>

#include "finish_blocks.cuh"
#include "mag_bin.cuh"

namespace {

constexpr int TR = 4;                 // block rows per tile
constexpr int TC = 8;                 // block columns per tile
constexpr int CR = TR + 1;            // cell rows the tile needs
constexpr int CC = TC + 1;            // cell columns the tile needs
constexpr int NCELL = CR * CC;
constexpr int THREADS = 128;          // a multiple of 8 lanes per cell

template <int MODE, int NORM>
__global__ void __launch_bounds__(THREADS)
dense_fused_hog_kernel(const float* __restrict__ gray,
                       float* __restrict__ out, int H, int W, int ch, int cw,
                       float eps2) {
  using Acc = typename hog::HistTypes<MODE>::Acc;
  using Store = typename hog::HistTypes<MODE>::Store;
  __shared__ Store cells[NCELL * 9];
  const int bi0 = blockIdx.y * TR;
  const int bj0 = blockIdx.x * TC;
  const long long b = blockIdx.z;
  const float* g = gray + b * H * W;
  const int bh = ch - 1, bw = cw - 1;

  // phase 1: cell histograms, 8 lanes per cell (one pixel row each)
  for (int base = 0; base < NCELL * 8; base += THREADS) {
    const int task = base + threadIdx.x;
    const int lc = task >> 3, r = task & 7;
    const int ci = bi0 + lc / CC, cj = bj0 + lc % CC;
    Acc h[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) h[k] = Acc(0);
    if (lc < NCELL && ci < ch && cj < cw)
      hog::row_hist<MODE>(g, W, ci * 8 + r, cj * 8, h);
    hog::reduce_cell_lanes(h);          // uniform trip count: all lanes
    if (lc < NCELL && r == 0) {
#pragma unroll
      for (int k = 0; k < 9; ++k)
        cells[lc * 9 + k] = static_cast<Store>(h[k]);
    }
  }
  __syncthreads();

  // phase 2: one thread per block of the tile
  for (int q = threadIdx.x; q < TR * TC; q += THREADS) {
    const int bi = bi0 + q / TC, bj = bj0 + q % TC;
    if (bi >= bh || bj >= bw) continue;
    float v[36];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const Store* src = cells + ((q / TC + i) * CC + q % TC + j) * 9;
#pragma unroll
        for (int k = 0; k < 9; ++k)
          v[(i * 2 + j) * 9 + k] = static_cast<float>(src[k]);
      }
    }
    hog::finish_block<NORM>(v, eps2);
    float* dst = out + ((b * bh + bi) * bw + bj) * 36;
#pragma unroll
    for (int k = 0; k < 36; ++k) dst[k] = v[k];
  }
}

template <int MODE, int NORM>
void launch(const float* gray, float* out, int B, int H, int W, int ch,
            int cw, float eps2, cudaStream_t s) {
  const dim3 grid((cw - 1 + TC - 1) / TC, (ch - 1 + TR - 1) / TR, B);
  dense_fused_hog_kernel<MODE, NORM>
      <<<grid, THREADS, 0, s>>>(gray, out, H, W, ch, cw, eps2);
}

}  // namespace

extern "C" int dense_fused_hog_launch(const float* gray, float* out, int B,
                                      int H, int W, float eps2, int mode,
                                      int norm, void* stream) {
  const int ch = (H - 2) / 8;
  const int cw = (W - 2) / 8;
  if (B <= 0 || ch < 2 || cw < 2) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == hog::kFixed)          // the fixed chain has one tail
    launch<hog::kFixed, hog::kFixedNorm>(gray, out, B, H, W, ch, cw, eps2,
                                         s);
  else if (mode == hog::kSector && norm == hog::kRsqrt)
    launch<hog::kSector, hog::kRsqrt>(gray, out, B, H, W, ch, cw, eps2, s);
  else if (mode == hog::kSector)
    launch<hog::kSector, hog::kNr>(gray, out, B, H, W, ch, cw, eps2, s);
  else if (norm == hog::kRsqrt)
    launch<hog::kCordic, hog::kRsqrt>(gray, out, B, H, W, ch, cw, eps2, s);
  else
    launch<hog::kCordic, hog::kNr>(gray, out, B, H, W, ch, cw, eps2, s);
  return static_cast<int>(cudaGetLastError());
}
