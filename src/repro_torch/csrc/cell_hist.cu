// Per-cell orientation histograms (HOG stage 3b) over a batch of windows:
// mag (B, Ha, Wa) f32 + bin (B, Ha, Wa) int32 -> (B, ch, cw, 9) f32, or
// int32 magnitudes (the fixed chain) summed in int32 and stored int16
// (64 px * 361 half-gray units = 23104 < 2^15 per cell).
//
// Replaces the TPU kernel repro/kernels/cell_hist.py:46 (cell_hist),
// which re-expresses the scatter "hist[bin] += mag" as a one-hot
// contraction over the 8x8 pixels of each cell for the VPU. On the card
// the select-and-add stays, without the contraction: 8 consecutive lanes
// own one cell, lane r sums pixel row r of it (8 pixels, left to right)
// into 9 register bins with a select per bin, and a 3-step xor shuffle
// adds the 8 partial histograms in a fixed order. Integer sums are exact
// in any order; f32 sums differ from the reference's by summation order
// only.
//
// Bound on the H100: bytes. A 128x64 window reads 65.5 KB (mag and bin)
// and writes 4.6 KB (2.3 KB int16), so B = 5,949 windows move 0.42 GB,
// 125 us at 3.35 TB/s; 18 operations per pixel are far below the f32
// rate. A warp's four cells lie side by side, so its 32 row reads of
// 32 bytes cover one 128-byte run per row of the window.
#include <cuda_runtime.h>

#include <stdint.h>

#include "mag_bin.cuh"

namespace {

constexpr int THREADS = 256;          // a multiple of 8 lanes per cell

template <typename Acc, typename Store>
__global__ void __launch_bounds__(THREADS)
cell_hist_kernel(const Acc* __restrict__ mag, const int* __restrict__ bin,
                 Store* __restrict__ hist, long long ncell, int ha, int wa) {
  const int ch = ha / 8, cw = wa / 8;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int r = static_cast<int>(t & 7);
  const long long cell = t >> 3;
  Acc h[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) h[k] = Acc(0);
  if (cell < ncell) {
    const int cj = static_cast<int>(cell % cw);
    const int ci = static_cast<int>((cell / cw) % ch);
    const long long b = cell / (static_cast<long long>(ch) * cw);
    const long long row = (b * ha + ci * 8 + r) * wa + cj * 8;
    const Acc* m = mag + row;
    const int* bi = bin + row;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const Acc v = m[c];
      const int k0 = bi[c];
#pragma unroll
      for (int k = 0; k < 9; ++k)
        h[k] = hog::acc_add(h[k], k0 == k ? v : Acc(0));
    }
  }
  // every lane reaches the shuffle, active or not
  hog::reduce_cell_lanes(h);
  if (cell < ncell && r == 0) {
    Store* out = hist + cell * 9;
#pragma unroll
    for (int k = 0; k < 9; ++k) out[k] = static_cast<Store>(h[k]);
  }
}

}  // namespace

// mag is f32 (hist f32) when integer == 0, int32 (hist int16) otherwise.
extern "C" int cell_hist_launch(const void* mag, const int* bin, void* hist,
                                int B, int ha, int wa, int integer,
                                void* stream) {
  const long long ncell = static_cast<long long>(B) * (ha / 8) * (wa / 8);
  if (ncell <= 0) return 0;
  const unsigned grid =
      static_cast<unsigned>((ncell * 8 + THREADS - 1) / THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (integer)
    cell_hist_kernel<int, int16_t><<<grid, THREADS, 0, s>>>(
        static_cast<const int*>(mag), bin, static_cast<int16_t*>(hist),
        ncell, ha, wa);
  else
    cell_hist_kernel<float, float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(mag), bin, static_cast<float*>(hist),
        ncell, ha, wa);
  return static_cast<int>(cudaGetLastError());
}
