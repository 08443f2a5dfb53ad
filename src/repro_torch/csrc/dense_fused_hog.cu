// Fused dense HOG: gradient -> magnitude/bin -> cell histograms -> 2x2
// block normalization in one kernel, (B, H, W) f32 gray ->
// (B, ch-1, cw-1, 36) f32 blocks. Only the gray and the blocks touch
// device memory.
//
// Replaces the TPU kernel repro/kernels/fused_hog.py:137
// (dense_fused_hog), which runs one program per slab of row_blocks
// block rows over a clamped gather of overlapping gray rows and
// recomputes one cell row per slab boundary.
//
// Bound on the H100: a 640x480 frame's three levels read 2.4 MB of gray
// and write 1.3 MB of blocks (1.1 us at 3.35 TB/s), and do about 77 M
// integer operations in the fixed mode (4.6 us at 64 INT32 lanes per SM
// per clock) or 39-90 M float operations in the float modes (1.2-2.7 us
// at 128 FP32 lanes; --fmad=false leaves no FMA to count twice). Each
// level is one launch, so the launch and the few dependent phases of a
// thread block weigh as much as the work; the design keeps every phase
// short and every SM busy.
//
// Design (the plan -- tile, thread count, grid, shared memory -- comes
// from kernels/fused_hog.py:dense_plan, which the tests check):
//  * A thread block (CTA) owns a tile of TR x TC blocks, 3x6, 3x4 or 2x4
//    (the Tile<> instantiations), with 16 threads for each of the
//    (TR+1) x (TC+1) cells it may compute: 448, 320 or 256 threads, and
//    __launch_bounds__ keeps 3-5 CTAs on an SM. The plan takes, per
//    level, the tile that gives every SM a CTA and the fewest cells to
//    the busiest SM; at 640x480 that is 3x6 / 3x4 / 2x4 (260 / 256 / 247
//    CTAs, each level one wave).
//  * A block (bi, bj) needs cells (bi..bi+1, bj..bj+1), so a CTA
//    computes the (TR+1) x (TC+1) cells of its blocks, its own and the
//    seam row and column below and to the right (1.5-1.8x the cells of
//    the level). Thread-block clusters that read a neighbour's seam cells
//    through distributed shared memory would cut that to about 1.2x, but
//    on the H100 their two cluster barriers cost more than the cells they
//    save (PERF.md), so CTAs are lone tiles with no barrier beyond their
//    own.
//  * The gray tile and its 1-px halo are staged in shared memory once,
//    with coalesced 4-byte cp.async copies (a level's row pitch is
//    8k + 2 floats, never 16-byte aligned, so neither 16-byte copies nor
//    a TMA tensor map can describe it).
//  * Gradients are pixel-parallel: 16 threads a cell, each computing 4
//    pixels of one pixel row as 4 independent chains (the fixed mode's
//    15-step int32 CORDIC is a long dependent chain; four at once and
//    30-40 warps per SM hide its latency).
//  * Cell histograms without a long serial sum. Fixed: shared-memory
//    int32 atomics (exact in any order). Float: each pixel row's 9 bins
//    in shared memory, the left half's 4 pixels added before the right
//    half's, each pixel to its own bin only; then the 8 rows in
//    reduce_cell_lanes' xor-tree order. That is the order of
//    mag_bin.cuh:row_hist + reduce_cell_lanes (whose adds of 0 to the
//    other bins change nothing), so the float histograms are bit for
//    bit those of dense_grad_hist, and deterministic.
//  * Normalize: the thread that makes a cell also writes its squares
//    into the rows of the blocks it belongs to; one thread a block sums
//    its 36 squares in finish_block's k = 0..35 order (9 float4 reads);
//    then each thread makes 4 values of a block and stores them as one
//    float4, so a tile row of blocks (TC x 36 contiguous floats) is
//    written in coalesced 16-byte stores. Fixed: the block's int8 step
//    comes from max|v|, an atomicMax on the bits of non-negative floats.
//
// Fixed mode: integer magnitudes summed in int32, the cell histograms
// kept as int16 (the reference's numerics.store_hist), then the fixed
// flavor's tail (NR rsqrt, the per-block int8 quantize-dequantize).
#include <cuda_runtime.h>
#include <stdint.h>

#include "finish_blocks.cuh"
#include "mag_bin.cuh"

namespace {

// A tile of TR x TC blocks and what follows from it: the (TR+1) x (TC+1)
// cell slots a CTA computes, 16 threads a slot (rounded up to whole
// rows of 64 for the staging), the staged gray (pitch odd against bank
// conflicts), and the CTAs an SM must hold (registers capped at 48).
template <int TR_, int TC_>
struct Tile {
  static constexpr int TR = TR_, TC = TC_;
  static constexpr int SR = TR + 1, SC = TC + 1;   // own + seam row/column
  static constexpr int NSLOT = SR * SC;
  static constexpr int THREADS = (NSLOT * 16 + 63) / 64 * 64;
  static constexpr int GR = SR * 8 + 2;
  static constexpr int GP = (SC * 8 + 2) | 1;
  static constexpr int MIN_CTAS = THREADS <= 256 ? 5 : THREADS <= 320 ? 4 : 3;
  static_assert(THREADS >= 9 * TR * TC, "one thread per 4 values");
};

// The CTA's shared memory (dynamic; its size comes with the plan). sq
// comes first and is a multiple of 144 bytes, so sq's block rows and
// part are 16-byte aligned for float4 reads and int4 zeroing. part: per
// cell, the float modes' 8 row sums of 9 bins (summed in the row order of
// mag_bin.cuh:row_hist), the fixed mode's 9 int32 sums, rounded up to
// whole int4.
template <int MODE, class T>
struct Smem {
  static constexpr int NPART =
      (T::NSLOT * 9 * (MODE == hog::kFixed ? 1 : 8) + 3) / 4 * 4;
  float sq[T::TR * T::TC * 36];          // each block's 36 squares
  typename hog::HistTypes<MODE>::Acc part[NPART];
  float gray[T::GR * T::GP];
  float rs[T::TR * T::TC];               // per block: 1 / norm
  int mx[T::TR * T::TC];                 // per block: max |v| (fixed)
  typename hog::HistTypes<MODE>::Store cells[T::NSLOT * 9];
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

template <int MODE, int NORM, class T>
__global__ void __launch_bounds__(T::THREADS, T::MIN_CTAS)
dense_fused_hog_kernel(const float* __restrict__ gray,
                       float* __restrict__ out, int H, int W, int ch, int cw,
                       float eps2) {
  using Acc = typename hog::HistTypes<MODE>::Acc;
  using Store = typename hog::HistTypes<MODE>::Store;
  constexpr int TR = T::TR, TC = T::TC, SC = T::SC, NSLOT = T::NSLOT;
  constexpr int THREADS = T::THREADS, GR = T::GR, GP = T::GP;
  constexpr int NPART = Smem<MODE, T>::NPART;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<MODE, T>& s = *reinterpret_cast<Smem<MODE, T>*>(smem_raw);
  const int t = threadIdx.x;
  const int bh = ch - 1, bw = cw - 1;
  const int bi0 = blockIdx.y * TR, bj0 = blockIdx.x * TC;
  const long long b = blockIdx.z;
  const int nr = min(TR + 1, ch - bi0);              // cells it computes
  const int nc = min(TC + 1, cw - bj0);

  // 1. the gray of those cells with the gradient's 1-px halo, rows
  // bi0*8 .. bi0*8 + nr*8 + 1 (inside the image: ch*8 + 2 <= H), as rows
  // of 64 threads; meanwhile the partial sums are zeroed
  {
    const float* src = gray + (b * H + bi0 * 8) * W + bj0 * 8;
    const int c = t & 63;
#pragma unroll
    for (int u = 0; u < (GR + THREADS / 64 - 1) / (THREADS / 64); ++u) {
      const int r = (t >> 6) + u * (THREADS / 64);
      if (c < nc * 8 + 2 && r < nr * 8 + 2)
        cp_async4(&s.gray[r * GP + c], src + static_cast<long long>(r) * W
                                           + c);
    }
  }
  for (int i = t; i < NPART / 4; i += THREADS)
    reinterpret_cast<int4*>(s.part)[i] = make_int4(0, 0, 0, 0);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // 2. gradients, magnitude and bin: 16 threads a cell slot, thread (r,
  // hf) taking pixels 4hf .. 4hf + 3 of the cell's pixel row r, four
  // independent chains; then its pixels enter the cell's sums
  const int slot = t >> 4, r = (t >> 1) & 7, hf = t & 1;
  const bool on = slot < NSLOT && slot / SC < nr && slot % SC < nc;
  Acc m[4];
  int bn[4];
  if (on) {
    const float* up = s.gray + ((slot / SC) * 8 + r) * GP + (slot % SC) * 8
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
      for (int j = 0; j < 4; ++j) atomicAdd(&s.part[slot * 9 + bn[j]], m[j]);
    }
  } else {
    // row r's sums in column order: the left half's 4 pixels, then the
    // right half's (adding only to a pixel's own bin, which equals
    // row_hist's add of 0 to every other)
    Acc* row = s.part + (slot * 8 + r) * 9;
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

  // Cell slot (r, c) of the tile holds bin k's value; it is value
  // (r-i)*18 + (c-j)*9 + k of each tile block (i, j) it belongs to
  // (finish_block's order: cells (0,0), (0,1), (1,0), (1,1)), whose
  // square goes to that block's row of sq
  auto put = [&](int r, int c, int k, Store x) {
    s.cells[(r * SC + c) * 9 + k] = x;
    const float f = static_cast<float>(x);
    const float q = __fmul_rn(f, f);
#pragma unroll
    for (int di = 0; di < 2; ++di)
#pragma unroll
      for (int dj = 0; dj < 2; ++dj)
        if (r - di >= 0 && r - di < TR && c - dj >= 0 && c - dj < TC)
          s.sq[((r - di) * TC + c - dj) * 36 + di * 18 + dj * 9 + k] = q;
  };

  // 3. the cell histograms: fixed, the int16 store of the int32 sums;
  // float, the 8 row sums in reduce_cell_lanes' xor-tree order
  if (t < NSLOT * 9 && t / 9 / SC < nr && t / 9 % SC < nc) {
    const int q = t / 9, k = t - q * 9;
    const int r = q / SC, c = q - r * SC;
    if constexpr (MODE == hog::kFixed) {
      put(r, c, k, static_cast<Store>(s.part[(r * SC + c) * 9 + k]));
    } else {
      const Acc* v = s.part + (r * SC + c) * 72 + k;
      put(r, c, k, static_cast<Store>(hog::acc_add(
          hog::acc_add(hog::acc_add(v[0], v[9]), hog::acc_add(v[18], v[27])),
          hog::acc_add(hog::acc_add(v[36], v[45]),
                       hog::acc_add(v[54], v[63])))));
    }
  }

  __syncthreads();

  // 4. per block, one thread sums its 36 squares in k = 0..35 order
  // (finish_block's) and takes 1 / norm
  const int nbh = min(TR, bh - bi0);            // the tile's real blocks
  const int nbw = min(TC, bw - bj0);
  if (t < TR * TC && t / TC < nbh && t % TC < nbw) {
    const float4* q = reinterpret_cast<const float4*>(s.sq + t * 36);
    float ss = 0.0f;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      const float4 x = q[i];
      ss = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(ss, x.x), x.y), x.z),
                     x.w);
    }
    s.rs[t] = hog::inv_norm<NORM>(__fadd_rn(ss, eps2));
    s.mx[t] = 0;
  }
  __syncthreads();

  // 5. four values of a block a thread, stored as one float4: tile row i
  // of blocks is out[b, bi0 + i, bj0 .. bj0 + nbw - 1, :], nbw * 36
  // contiguous floats (16-byte aligned: 36 floats are 144 bytes). Fixed:
  // then the block's int8 step, from the max |v| its threads add with an
  // integer atomicMax on the bits of a non-negative float (exact in any
  // order)
  const int n = t / 9, k0 = (t - n * 9) * 4;     // block n, values k0..+3
  const int i = n / TC, j = n - i * TC;
  const bool real = n < TR * TC && i < nbh && j < nbw;
  float v[4];
  if (real) {
    const float rs = s.rs[n];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k0 + u;
      v[u] = __fmul_rn(static_cast<float>(s.cells[((i + k / 18) * SC + j
                                                   + (k / 9) % 2) * 9
                                                  + k % 9]), rs);
    }
    if constexpr (NORM == hog::kFixedNorm)
      atomicMax(&s.mx[n], __float_as_int(fmaxf(fmaxf(fabsf(v[0]),
                                                     fabsf(v[1])),
                                               fmaxf(fabsf(v[2]),
                                                     fabsf(v[3])))));
  }
  if constexpr (NORM == hog::kFixedNorm) __syncthreads();
  if (real) {
    if constexpr (NORM == hog::kFixedNorm) {
      const float scale = __fmul_rn(__int_as_float(s.mx[n]), hog::kInvQ);
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = hog::quantize_value(v[u], scale);
    }
    *reinterpret_cast<float4*>(out + ((b * bh + bi0 + i) * bw + bj0 + j) * 36
                               + k0) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

using Kernel = void (*)(const float*, float*, int, int, int, int, float);

// The instantiation for (mode, norm) at tile T, its thread count and
// shared memory; null for a pair the port never runs.
template <class T>
Kernel pick_mode(int mode, int norm, int* threads, int* smem) {
  *threads = T::THREADS;
  if (mode == hog::kFixed) {           // the fixed chain has one tail
    *smem = sizeof(Smem<hog::kFixed, T>);
    return dense_fused_hog_kernel<hog::kFixed, hog::kFixedNorm, T>;
  }
  if (norm != hog::kRsqrt && norm != hog::kNr) return nullptr;
  if (mode == hog::kSector) {
    *smem = sizeof(Smem<hog::kSector, T>);
    return norm == hog::kRsqrt
               ? dense_fused_hog_kernel<hog::kSector, hog::kRsqrt, T>
               : dense_fused_hog_kernel<hog::kSector, hog::kNr, T>;
  }
  if (mode != hog::kCordic) return nullptr;
  *smem = sizeof(Smem<hog::kCordic, T>);
  return norm == hog::kRsqrt
             ? dense_fused_hog_kernel<hog::kCordic, hog::kRsqrt, T>
             : dense_fused_hog_kernel<hog::kCordic, hog::kNr, T>;
}

// The tiles compiled here (kernels/fused_hog.py:DENSE_TILES).
Kernel pick(int mode, int norm, int tr, int tc, int* threads, int* smem) {
  if (tr == 3 && tc == 6) return pick_mode<Tile<3, 6>>(mode, norm, threads,
                                                       smem);
  if (tr == 3 && tc == 4) return pick_mode<Tile<3, 4>>(mode, norm, threads,
                                                       smem);
  if (tr == 2 && tc == 4) return pick_mode<Tile<2, 4>>(mode, norm, threads,
                                                       smem);
  return nullptr;
}

}  // namespace

// Launch one level with the plan of kernels/fused_hog.py:dense_plan: grid
// (grid_x, grid_y, B). A plan whose tile or thread count is not the one
// compiled here, whose grid is not the blocks' tiles, or whose shared
// memory is short of the kernel's layout is refused with
// cudaErrorInvalidValue.
extern "C" int dense_fused_hog_launch(const float* gray, float* out, int B,
                                      int H, int W, float eps2, int mode,
                                      int norm, int grid_x, int grid_y,
                                      int tile_rows, int tile_cols,
                                      int threads, int smem_bytes,
                                      void* stream) {
  const int ch = (H - 2) / 8;
  const int cw = (W - 2) / 8;
  if (B <= 0 || ch < 2 || cw < 2) return 0;
  int need = 0, compiled = 0;
  const Kernel k = pick(mode, norm, tile_rows, tile_cols, &compiled, &need);
  if (k == nullptr || threads != compiled || smem_bytes < need ||
      grid_x * tile_cols < cw - 1 || grid_y * tile_rows < ch - 1 ||
      (grid_x - 1) * tile_cols >= cw - 1 ||
      (grid_y - 1) * tile_rows >= ch - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  k<<<dim3(grid_x, grid_y, B), threads, smem_bytes,
      static_cast<cudaStream_t>(stream)>>>(gray, out, H, W, ch, cw, eps2);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of the (mode, norm) kernel at a tile that one SM can hold at this
// thread count and shared memory
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), written to *blocks;
// returns the CUDA error code.
extern "C" int dense_fused_hog_occupancy(int mode, int norm, int tile_rows,
                                         int tile_cols, int threads,
                                         int smem_bytes, int* blocks) {
  int need = 0, compiled = 0;
  const Kernel k = pick(mode, norm, tile_rows, tile_cols, &compiled, &need);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, k, threads, smem_bytes));
}
