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
// check; the launcher refuses any other):
//  * A thread block (CTA) owns a tile of TR x TC blocks, 2x8 (the one
//    Tile<> instantiation: of the tiles tried on the H100, 2x4, 2x8, 4x4
//    and 4x8, it was the fastest or within the run-to-run spread at every
//    level of 640x480 and 1280x720, where the smaller 2x4 lost to its
//    per-CTA phases; 290 / 184 / 133 CTAs of 160 threads at 640x480),
//    and stages the (TR+1) x (TC+1) cells its blocks need in
//    shared memory: each staged cell row is (TC+1) x 9 contiguous values
//    of the input, read by consecutive threads (f32, or int16 converted
//    to f32, which is exact).
//  * The thread that stages a value writes its square into the row of
//    each tile block it belongs to, at that block's position (finish_block
//    order: cells (0,0), (0,1), (1,0), (1,1)); one thread a block then
//    sums its 36 squares in k = 0..35 order (9 float4 reads) and takes
//    1 / norm in the flavor's arithmetic (finish_blocks.cuh:inv_norm).
//  * Each thread makes 4 values of a block and stores them as one float4,
//    so a tile row of blocks (TC x 36 contiguous floats) is written in
//    coalesced 16-byte stores.
//  * Fixed: the block's int8 step is max |v| * (1/127). Rounding is
//    monotone, so max |v| = fl(max |c| * (1 / norm)) over the block's 36
//    cell values c: the thread that sums the squares takes it from the
//    staged cells, and no atomic or extra barrier is needed; each value
//    then goes through quantize_value.
// Every step is finish_blocks.cuh:finish_block's arithmetic in its order,
// so the blocks are bit for bit those of dense_fused_hog's steps 4-5.
#include <cuda_runtime.h>
#include <stdint.h>

#include "finish_blocks.cuh"

namespace {

// A tile of TR x TC blocks and what follows from it: the (TR+1) x (TC+1)
// cells it stages, and one thread for each 4 output values, in whole
// warps.
template <int TR_, int TC_>
struct Tile {
  static constexpr int TR = TR_, TC = TC_;
  static constexpr int SR = TR + 1, SC = TC + 1;
  static constexpr int NBLK = TR * TC;
  static constexpr int NVAL = SR * SC * 9;          // staged cell values
  static constexpr int THREADS = (NBLK * 9 + 31) / 32 * 32;
};

// The CTA's shared memory (dynamic; its size comes with the plan). sq
// comes first and is a multiple of 144 bytes, so its block rows are
// 16-byte aligned for float4 reads.
template <class T>
struct Smem {
  float sq[T::NBLK * 36];                // each block's 36 squares
  float cells[T::NVAL];                  // the staged cells, in f32
  float rs[T::NBLK];                     // per block: 1 / norm
  float scale[T::NBLK];                  // per block: int8 step (fixed)
};

template <int NORM, typename In, class T>
__global__ void __launch_bounds__(T::THREADS)
dense_block_norm_kernel(const void* __restrict__ hist_in,
                        float* __restrict__ out, int ch, int cw,
                        float eps2) {
  constexpr int TR = T::TR, TC = T::TC, SC = T::SC, NVAL = T::NVAL;
  constexpr int THREADS = T::THREADS;
  constexpr int U = (NVAL + THREADS - 1) / THREADS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T>& s = *reinterpret_cast<Smem<T>*>(smem_raw);
  const In* __restrict__ hist = static_cast<const In*>(hist_in);
  const int t = threadIdx.x;
  const int bh = ch - 1, bw = cw - 1;
  const int bi0 = blockIdx.y * TR, bj0 = blockIdx.x * TC;
  const long long b = blockIdx.z;
  const int nbh = min(TR, bh - bi0);             // the tile's blocks
  const int nbw = min(TC, bw - bj0);

  // 1. cells bi0 .. bi0 + nbh, bj0 .. bj0 + nbw: staged row r holds
  // (nbw + 1) * 9 contiguous input values; all loads first, then the
  // shared stores and the squares
  {
    const In* src = hist + ((b * ch + bi0) * cw + bj0) * 9;
    float x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = t + u * THREADS;
      const int r = i / (SC * 9), c = i - r * (SC * 9);
      x[u] = i < NVAL && r <= nbh && c < (nbw + 1) * 9
                 ? static_cast<float>(src[static_cast<long long>(r) * cw * 9
                                          + c])
                 : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = t + u * THREADS;
      if (i < NVAL) {
        const int r = i / (SC * 9), c = i - r * (SC * 9);
        const int j = c / 9, k = c - j * 9;
        s.cells[i] = x[u];
        const float q = __fmul_rn(x[u], x[u]);
        // value (r-di)*18 + (j-dj)*9 + k of tile block (r-di, j-dj)
#pragma unroll
        for (int di = 0; di < 2; ++di)
#pragma unroll
          for (int dj = 0; dj < 2; ++dj)
            if (r - di >= 0 && r - di < TR && j - dj >= 0 && j - dj < TC)
              s.sq[((r - di) * TC + j - dj) * 36 + di * 18 + dj * 9 + k] = q;
      }
    }
  }
  __syncthreads();

  // 2. per block, one thread sums its 36 squares in k = 0..35 order
  // (finish_block's) and takes 1 / norm. Fixed: also the block's int8
  // step, max |v| * (1/127). Rounding is monotone, so the largest |c * rs|
  // of the block is fl(max |c| * rs): the max of its 36 staged values
  // times 1 / norm, the same bits as the max over the normalized values
  if (t < TR * TC && t / TC < nbh && t % TC < nbw) {
    const float4* q = reinterpret_cast<const float4*>(s.sq + t * 36);
    float ss = 0.0f;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      const float4 x = q[i];
      ss = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(ss, x.x), x.y), x.z),
                     x.w);
    }
    const float rs = hog::inv_norm<NORM>(__fadd_rn(ss, eps2));
    s.rs[t] = rs;
    if constexpr (NORM == hog::kFixedNorm) {
      const int i = t / TC, j = t - i * TC;
      float mc = 0.0f;
#pragma unroll
      for (int di = 0; di < 2; ++di)
#pragma unroll
        for (int k = 0; k < 18; ++k)
          mc = fmaxf(mc, fabsf(s.cells[((i + di) * SC + j) * 9 + k]));
      s.scale[t] = __fmul_rn(__fmul_rn(mc, rs), hog::kInvQ);
    }
  }
  __syncthreads();

  // 3. four values of a block a thread, stored as one float4: tile row i
  // of blocks is out[b, bi0 + i, bj0 .. bj0 + nbw - 1, :], nbw * 36
  // contiguous floats (16-byte aligned: 36 floats are 144 bytes). Fixed:
  // each value onto the block's int8 grid
  const int n = t / 9, k0 = (t - n * 9) * 4;     // block n, values k0..+3
  const int i = n / TC, j = n - i * TC;
  if (n < TR * TC && i < nbh && j < nbw) {
    const float rs = s.rs[n];
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k0 + u;
      v[u] = __fmul_rn(s.cells[((i + k / 18) * SC + j + (k / 9) % 2) * 9
                               + k % 9], rs);
      if constexpr (NORM == hog::kFixedNorm)
        v[u] = hog::quantize_value(v[u], s.scale[n]);
    }
    *reinterpret_cast<float4*>(out + ((b * bh + bi0 + i) * bw + bj0 + j) * 36
                               + k0) = make_float4(v[0], v[1], v[2], v[3]);
  }
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
