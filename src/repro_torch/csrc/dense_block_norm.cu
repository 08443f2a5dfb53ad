// Dense 2x2-block L2 normalization (eq. 5) over a scene's cell grid:
// (B, ch, cw, 9) f32 histograms -> (B, ch-1, cw-1, 36) f32 blocks, or, in
// the fixed flavor, int16 histograms -> f32 blocks on their per-block
// int8 grid.
//
// Replaces the TPU kernel repro/kernels/dense_block_norm.py:41
// (dense_block_norm), which tiles row slabs of the block grid and reads
// two row-shifted views of the histograms for the block halo.
//
// Bound on the H100: bytes; a 640x480 frame's three levels read 0.34 MB
// of histograms (0.17 MB in int16) and write 1.3 MB of blocks, 0.5 us at
// 3.35 TB/s, and each level is one launch, so the design keeps every
// access coalesced, every SM busy and the phases few.
//
// Design (the plan -- tile, thread count, grid, shared memory -- comes
// from kernels/dense_block_norm.py:dense_block_norm_plan, which the tests
// check; the launcher refuses any other): a thread block (CTA) owns a
// tile of TR x TC blocks, 2x8 (the one Tile<> instantiation: of the
// tiles tried on the H100, 2x4, 2x8, 4x4 and 4x8, it was the fastest or
// within the run-to-run spread at every level of 640x480 and 1280x720,
// where the smaller 2x4 lost to its per-CTA phases; 290 / 184 / 133 CTAs
// of 160 threads at 640x480), stages the (TR+1) x (TC+1) cells its blocks
// need, sums each block's squares in finish_block order and stores 4
// values a thread as one float4: block_tile.cuh, whose body the window
// kernel (csrc/block_norm.cu) shares, so the two give the same blocks bit
// for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_tile.cuh"

namespace {

using hog::Smem;
using hog::Tile;

template <int NORM, typename In, class T>
__global__ void __launch_bounds__(T::THREADS)
dense_block_norm_kernel(const void* __restrict__ hist_in,
                        float* __restrict__ out, int ch, int cw,
                        float eps2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  hog::block_tile<NORM, In, T>(static_cast<const In*>(hist_in), out, ch, cw,
                               eps2, blockIdx.z, blockIdx.y, blockIdx.x,
                               *reinterpret_cast<Smem<T>*>(smem_raw));
}

using Kernel = void (*)(const void*, float*, int, int, float);

// The instantiation for a norm flavor at tile T, its thread count and
// shared memory; the fixed flavor reads int16 histograms.
template <class T>
Kernel pick_norm(int norm, int* threads, int* smem) {
  *threads = T::THREADS;
  *smem = sizeof(Smem<T>);
  if (norm == hog::kRsqrt)
    return dense_block_norm_kernel<hog::kRsqrt, float, T>;
  if (norm == hog::kNr) return dense_block_norm_kernel<hog::kNr, float, T>;
  if (norm == hog::kFixedNorm)
    return dense_block_norm_kernel<hog::kFixedNorm, int16_t, T>;
  return nullptr;
}

// The tiles compiled here (kernels/dense_block_norm.py:BLOCK_NORM_TILES).
Kernel pick(int norm, int tr, int tc, int* threads, int* smem) {
  if (tr == 2 && tc == 8) return pick_norm<Tile<2, 8>>(norm, threads, smem);
  return nullptr;
}

}  // namespace

// Launch one level with the plan of
// kernels/dense_block_norm.py:dense_block_norm_plan: grid (grid_x,
// grid_y, B). hist is f32 for the rsqrt and nr flavors, int16 for fixed.
// A plan whose tile or thread count is not the one compiled here, whose
// grid is not the blocks' tiles, or whose shared memory is short of the
// kernel's layout is refused with cudaErrorInvalidValue.
extern "C" int dense_block_norm_launch(const void* hist, float* out, int B,
                                       int ch, int cw, float eps2, int norm,
                                       int grid_x, int grid_y, int tile_rows,
                                       int tile_cols, int threads,
                                       int smem_bytes, void* stream) {
  if (B <= 0 || ch < 2 || cw < 2) return 0;
  int need = 0, compiled = 0;
  const Kernel k = pick(norm, tile_rows, tile_cols, &compiled, &need);
  if (k == nullptr || threads != compiled || smem_bytes < need ||
      grid_x * tile_cols < cw - 1 || grid_y * tile_rows < ch - 1 ||
      (grid_x - 1) * tile_cols >= cw - 1 ||
      (grid_y - 1) * tile_rows >= ch - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  k<<<dim3(grid_x, grid_y, B), threads, smem_bytes,
      static_cast<cudaStream_t>(stream)>>>(hist, out, ch, cw, eps2);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of the flavor's kernel at a tile that one SM can hold at this
// thread count and shared memory
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), written to *blocks;
// returns the CUDA error code.
extern "C" int dense_block_norm_occupancy(int norm, int tile_rows,
                                          int tile_cols, int threads,
                                          int smem_bytes, int* blocks) {
  int need = 0, compiled = 0;
  const Kernel k = pick(norm, tile_rows, tile_cols, &compiled, &need);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, k, threads, smem_bytes));
}
