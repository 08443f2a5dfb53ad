// Dense gradient -> magnitude/bin -> 8x8 cell histograms over a whole
// scene: (B, H, W) f32 gray -> (B, ch, cw, 9) f32 (sector, cordic) or
// int16 (fixed: integer magnitudes summed in int32, stored as int16).
//
// Replaces the TPU kernel repro/kernels/dense_grad_hist.py:62
// (dense_grad_hist), which tiles row slabs through VMEM with three
// row-shifted views for the one-row halo.
//
// Bound on the H100: a 640x480 frame's three levels read 2.4 MB of gray
// and write 0.35 MB of histograms (0.17 MB in int16), 0.8 us at 3.35
// TB/s; the sector mode's ~40 f32 operations a pixel take about 1 us at
// 128 FP32 lanes per SM per clock, the fixed mode's ~110 int32
// operations about 4.3 us at 64 INT32 lanes. Each level is one launch, so
// the launch and the few dependent phases of a thread block weigh as
// much as the work; the design keeps every phase short, every access
// coalesced and every SM busy.
//
// Design (the plan -- tile, thread count, grid, shared memory -- comes
// from kernels/dense_grad_hist.py:dense_grad_hist_plan, which the tests
// check; the launcher refuses any other):
//  * A thread block (CTA) owns a tile of TR x TC cells, 16 threads a
//    cell: 2x4 or 2x8 (the Tile<> instantiations), whichever gives every
//    SM a CTA and the fewest cells to the busiest SM; at 640x480 that is
//    2x4 at every level (600 / 384 / 247 CTAs of 128 threads). Of the
//    tiles tried on the H100 (2x4, 2x8, 4x4, 4x8), the plan's pick was the
//    fastest or within the run-to-run spread at every level of 640x480
//    and 1280x720. Cells do not overlap, so nothing is computed twice;
//    only the gradient's 1-px halo is read twice.
//  * The tile's (8 TR + 2) x (8 TC + 2) gray is staged in shared memory
//    with coalesced 4-byte cp.async copies, consecutive threads on
//    consecutive columns (a level's row pitch is 8k + 2 floats, never
//    16-byte aligned, so wider copies cannot describe it); the staged
//    pitch is odd against bank conflicts.
//  * Gradients are pixel-parallel: thread (cell, r, half) computes pixels
//    4 half .. 4 half + 3 of the cell's pixel row r as 4 independent
//    chains (the fixed mode's 15-step int32 CORDIC is a long dependent
//    chain; four at once hide its latency).
//  * Cell histograms in the order of mag_bin.cuh:row_hist +
//    reduce_cell_lanes, so the output is bit for bit theirs (and
//    dense_fused_hog's steps 1-3). Fixed: shared-memory
//    int32 atomics (exact in any order). Float: each pixel row's 9 bins
//    in shared memory, the left half's 4 pixels added before the right
//    half's, each pixel to its own bin only (row_hist's adds of 0 to the
//    other bins change nothing); then the 8 rows in reduce_cell_lanes'
//    xor-tree order.
//  * Stores: a tile row of cells is TC x 9 contiguous values of the
//    output; consecutive threads store consecutive values (f32, or int16
//    in the fixed mode).
#include <cuda_runtime.h>
#include <stdint.h>

#include "mag_bin.cuh"

namespace {

// A tile of TR x TC cells and what follows from it: 16 threads a cell,
// the staged gray (rows and columns with the 1-px halo, pitch odd), and
// the CTAs an SM must hold (registers capped at 64).
template <int TR_, int TC_>
struct Tile {
  static constexpr int TR = TR_, TC = TC_;
  static constexpr int NCELL = TR * TC;
  static constexpr int THREADS = NCELL * 16;
  static constexpr int GR = TR * 8 + 2;
  static constexpr int GC = TC * 8 + 2;
  static constexpr int GP = GC | 1;
  static constexpr int MIN_CTAS = 1024 / THREADS;
  static_assert(THREADS % 32 == 0 && THREADS <= 1024, "whole warps");
};

// The CTA's shared memory (dynamic; its size comes with the plan). part:
// per cell, the float modes' 8 row sums of 9 bins, the fixed mode's 9
// int32 sums, rounded up to whole int4 for the zeroing.
template <int MODE, class T>
struct Smem {
  static constexpr int NPART =
      (T::NCELL * 9 * (MODE == hog::kFixed ? 1 : 8) + 3) / 4 * 4;
  typename hog::HistTypes<MODE>::Acc part[NPART];
  float gray[T::GR * T::GP];
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

template <int MODE, class T>
__global__ void __launch_bounds__(T::THREADS, T::MIN_CTAS)
dense_grad_hist_kernel(const float* __restrict__ gray,
                       void* __restrict__ hist_out, int H, int W, int ch,
                       int cw) {
  using Acc = typename hog::HistTypes<MODE>::Acc;
  using Store = typename hog::HistTypes<MODE>::Store;
  constexpr int TC = T::TC, NCELL = T::NCELL, THREADS = T::THREADS;
  constexpr int GR = T::GR, GC = T::GC, GP = T::GP;
  constexpr int NPART = Smem<MODE, T>::NPART;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<MODE, T>& s = *reinterpret_cast<Smem<MODE, T>*>(smem_raw);
  Store* __restrict__ hist = static_cast<Store*>(hist_out);
  const int t = threadIdx.x;
  const int ci0 = blockIdx.y * T::TR, cj0 = blockIdx.x * TC;
  const long long b = blockIdx.z;
  const int nr = min(T::TR, ch - ci0);               // the tile's cells
  const int nc = min(TC, cw - cj0);

  // 1. the gray of those cells with the gradient's 1-px halo, rows
  // ci0*8 .. ci0*8 + nr*8 + 1 and columns cj0*8 .. cj0*8 + nc*8 + 1
  // (inside the image: ch*8 + 2 <= H, cw*8 + 2 <= W); meanwhile the
  // partial sums are zeroed
  {
    const float* src = gray + (b * H + ci0 * 8) * W + cj0 * 8;
#pragma unroll
    for (int u = 0; u < (GR * GC + THREADS - 1) / THREADS; ++u) {
      const int i = t + u * THREADS;
      const int r = i / GC, c = i - r * GC;
      if (i < GR * GC && r < nr * 8 + 2 && c < nc * 8 + 2)
        cp_async4(&s.gray[r * GP + c], src + static_cast<long long>(r) * W
                                           + c);
    }
  }
  for (int i = t; i < NPART / 4; i += THREADS)
    reinterpret_cast<int4*>(s.part)[i] = make_int4(0, 0, 0, 0);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // 2. gradients, magnitude and bin: thread (cell, r, hf) takes pixels
  // 4hf .. 4hf + 3 of the cell's pixel row r, four independent chains;
  // then its pixels enter the cell's sums
  const int cell = t >> 4, r = (t >> 1) & 7, hf = t & 1;
  const bool on = cell / TC < nr && cell % TC < nc;
  Acc m[4];
  int bn[4];
  if (on) {
    const float* up = s.gray + ((cell / TC) * 8 + r) * GP + (cell % TC) * 8
                      + 4 * hf;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float fx = __fsub_rn(up[GP + j + 2], up[GP + j]);    // eq. (1)
      const float fy = __fsub_rn(up[2 * GP + j + 1], up[j + 1]); // eq. (2)
      hog::mag_bin<MODE>(fx, fy, m[j], bn[j]);
    }
  }
  if constexpr (MODE == hog::kFixed) {
    // int32 sums are exact in any order
    if (on) {
#pragma unroll
      for (int j = 0; j < 4; ++j) atomicAdd(&s.part[cell * 9 + bn[j]], m[j]);
    }
  } else {
    // row r's sums in column order: the left half's 4 pixels, then the
    // right half's (the two threads of a row are neighbouring lanes)
    Acc* row = s.part + (cell * 8 + r) * 9;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (on && hf == half) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          row[bn[j]] = hog::acc_add(row[bn[j]], m[j]);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // 3. value t of the tile: tile row i, cell j, bin k, at offset
  // j*9 + k of the tile row's nc*9 contiguous output values. Fixed: the
  // int16 store of the int32 sum; float: the 8 row sums in
  // reduce_cell_lanes' xor-tree order
  if (t < NCELL * 9) {
    const int i = t / (TC * 9), off = t - i * (TC * 9);
    const int j = off / 9, k = off - j * 9;
    if (i < nr && off < nc * 9) {
      const int q = i * TC + j;
      Acc v;
      if constexpr (MODE == hog::kFixed) {
        v = s.part[q * 9 + k];
      } else {
        const Acc* p = s.part + q * 72 + k;
        v = hog::acc_add(
            hog::acc_add(hog::acc_add(p[0], p[9]), hog::acc_add(p[18], p[27])),
            hog::acc_add(hog::acc_add(p[36], p[45]),
                         hog::acc_add(p[54], p[63])));
      }
      hist[((b * ch + ci0 + i) * cw + cj0) * 9 + off] = static_cast<Store>(v);
    }
  }
}

using Kernel = void (*)(const float*, void*, int, int, int, int);

// The instantiation for a mode at tile T, its thread count and shared
// memory.
template <class T>
Kernel pick_mode(int mode, int* threads, int* smem) {
  *threads = T::THREADS;
  if (mode == hog::kSector) {
    *smem = sizeof(Smem<hog::kSector, T>);
    return dense_grad_hist_kernel<hog::kSector, T>;
  }
  if (mode == hog::kCordic) {
    *smem = sizeof(Smem<hog::kCordic, T>);
    return dense_grad_hist_kernel<hog::kCordic, T>;
  }
  if (mode != hog::kFixed) return nullptr;
  *smem = sizeof(Smem<hog::kFixed, T>);
  return dense_grad_hist_kernel<hog::kFixed, T>;
}

// The tiles compiled here (kernels/dense_grad_hist.py:GRAD_HIST_TILES).
Kernel pick(int mode, int tr, int tc, int* threads, int* smem) {
  if (tr == 2 && tc == 4) return pick_mode<Tile<2, 4>>(mode, threads, smem);
  if (tr == 2 && tc == 8) return pick_mode<Tile<2, 8>>(mode, threads, smem);
  return nullptr;
}

}  // namespace

// Launch one level with the plan of
// kernels/dense_grad_hist.py:dense_grad_hist_plan: grid (grid_x, grid_y,
// B). hist is f32 for sector and cordic, int16 for fixed. A plan whose
// tile or thread count is not the one compiled here, whose grid is not
// the cells' tiles, or whose shared memory is short of the kernel's
// layout is refused with cudaErrorInvalidValue.
extern "C" int dense_grad_hist_launch(const float* gray, void* hist, int B,
                                      int H, int W, int mode, int grid_x,
                                      int grid_y, int tile_rows,
                                      int tile_cols, int threads,
                                      int smem_bytes, void* stream) {
  const int ch = (H - 2) / 8;
  const int cw = (W - 2) / 8;
  if (B <= 0 || ch < 1 || cw < 1) return 0;
  int need = 0, compiled = 0;
  const Kernel k = pick(mode, tile_rows, tile_cols, &compiled, &need);
  if (k == nullptr || threads != compiled || smem_bytes < need ||
      grid_x * tile_cols < cw || grid_y * tile_rows < ch ||
      (grid_x - 1) * tile_cols >= cw || (grid_y - 1) * tile_rows >= ch)
    return static_cast<int>(cudaErrorInvalidValue);
  k<<<dim3(grid_x, grid_y, B), threads, smem_bytes,
      static_cast<cudaStream_t>(stream)>>>(gray, hist, H, W, ch, cw);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of the mode's kernel at a tile that one SM can hold at this thread
// count and shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// written to *blocks; returns the CUDA error code.
extern "C" int dense_grad_hist_occupancy(int mode, int tile_rows,
                                         int tile_cols, int threads,
                                         int smem_bytes, int* blocks) {
  int need = 0, compiled = 0;
  const Kernel k = pick(mode, tile_rows, tile_cols, &compiled, &need);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, k, threads, smem_bytes));
}
