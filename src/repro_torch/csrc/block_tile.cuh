// One CTA's tile of 2x2-block L2 normalization (eq. 5), shared by the
// dense kernel (csrc/dense_block_norm.cu: a scene's cell grid, tiles of
// 2x8 blocks) and the window kernel (csrc/block_norm.cu: bands of block
// rows that span a window's full width): (B, ch, cw, 9) f32 histograms
// -> (B, ch-1, cw-1, 36) f32 blocks, or, in the fixed flavor, int16
// histograms -> f32 blocks on their per-block int8 grid.
//
// A CTA owns a tile of TR x TC blocks and:
//  1. stages the (TR+1) x (TC+1) cells its blocks need in shared memory:
//     each staged cell row is (TC+1) x 9 contiguous values of the input,
//     read by consecutive threads (f32, or int16 converted to f32, which
//     is exact); a tile as wide as the grid stages one contiguous span;
//  2. the thread that stages a value writes its square into the row of
//     each tile block it belongs to, at that block's position
//     (finish_block order: cells (0,0), (0,1), (1,0), (1,1)); one thread a
//     block then sums its 36 squares in k = 0..35 order (9 float4 reads)
//     and takes 1 / norm in the flavor's arithmetic
//     (finish_blocks.cuh:inv_norm);
//  3. each thread makes 4 values of a block and stores them as one
//     float4, so a tile row of blocks (TC x 36 contiguous floats; a full
//     width tile's TR x TC x 36 floats) is written in coalesced 16-byte
//     stores straight from registers.
// Fixed: the block's int8 step is max |v| * (1/127). Rounding is monotone,
// so max |v| = fl(max |c| * (1 / norm)) over the block's 36 cell values c:
// the thread that sums the squares takes it from the staged cells, and no
// atomic or extra barrier is needed; each value then goes through
// quantize_value.
// Every step is finish_blocks.cuh:finish_block's arithmetic in its order,
// so both kernels give the blocks of dense_fused_hog's steps 4-5 bit for
// bit.
#pragma once

#include <stdint.h>

#include "finish_blocks.cuh"

namespace hog {

// A tile of TR x TC blocks and what follows from it: the (TR+1) x (TC+1)
// cells it stages, and its threads, by default one for each 4 output
// values, in whole warps; with fewer, each thread takes every THREADS-th
// value, block and 4 outputs in turn.
template <int TR_, int TC_, int THREADS_ = (TR_ * TC_ * 9 + 31) / 32 * 32>
struct Tile {
  static constexpr int TR = TR_, TC = TC_;
  static constexpr int SR = TR + 1, SC = TC + 1;
  static constexpr int NBLK = TR * TC;
  static constexpr int NVAL = SR * SC * 9;          // staged cell values
  static constexpr int THREADS = THREADS_;
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

// Tile (ty, tx) of scene b: blocks [ty*TR, ty*TR + TR) x [tx*TC, tx*TC +
// TC), clipped to the (ch-1) x (cw-1) grid. Called by all T::THREADS
// threads of the CTA.
template <int NORM, typename In, class T>
__device__ __forceinline__ void block_tile(const In* __restrict__ hist,
                                           float* __restrict__ out, int ch,
                                           int cw, float eps2, long long b,
                                           int ty, int tx, Smem<T>& s) {
  constexpr int TR = T::TR, TC = T::TC, SC = T::SC, NVAL = T::NVAL;
  constexpr int THREADS = T::THREADS;
  constexpr int U = (NVAL + THREADS - 1) / THREADS;
  const int t = threadIdx.x;
  const int bh = ch - 1, bw = cw - 1;
  const int bi0 = ty * TR, bj0 = tx * TC;
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
  auto norm_block = [&](int q) {
    const float4* sq = reinterpret_cast<const float4*>(s.sq + q * 36);
    float ss = 0.0f;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      const float4 x = sq[i];
      ss = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(ss, x.x), x.y), x.z),
                     x.w);
    }
    const float rs = inv_norm<NORM>(__fadd_rn(ss, eps2));
    s.rs[q] = rs;
    if constexpr (NORM == kFixedNorm) {
      const int i = q / TC, j = q - i * TC;
      float mc = 0.0f;
#pragma unroll
      for (int di = 0; di < 2; ++di)
#pragma unroll
        for (int k = 0; k < 18; ++k)
          mc = fmaxf(mc, fabsf(s.cells[((i + di) * SC + j) * 9 + k]));
      s.scale[q] = __fmul_rn(__fmul_rn(mc, rs), kInvQ);
    }
  };
  if constexpr (THREADS >= TR * TC) {
    if (t < TR * TC && t / TC < nbh && t % TC < nbw) norm_block(t);
  } else {
    for (int q = t; q < TR * TC; q += THREADS)
      if (q / TC < nbh && q % TC < nbw) norm_block(q);
  }
  __syncthreads();

  // 3. four values of a block a thread, stored as one float4: tile row i
  // of blocks is out[b, bi0 + i, bj0 .. bj0 + nbw - 1, :], nbw * 36
  // contiguous floats (16-byte aligned: 36 floats are 144 bytes). Fixed:
  // each value onto the block's int8 grid
  auto quad = [&](int n, int k0) {               // block n, values k0..+3
    const int i = n / TC, j = n - i * TC;
    const float rs = s.rs[n];
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k0 + u;
      v[u] = __fmul_rn(s.cells[((i + k / 18) * SC + j + (k / 9) % 2) * 9
                               + k % 9], rs);
      if constexpr (NORM == kFixedNorm)
        v[u] = quantize_value(v[u], s.scale[n]);
    }
    *reinterpret_cast<float4*>(out + ((b * bh + bi0 + i) * bw + bj0 + j) * 36
                               + k0) = make_float4(v[0], v[1], v[2], v[3]);
  };
  if constexpr (THREADS >= TR * TC * 9) {
    const int n = t / 9, k0 = (t - n * 9) * 4;
    if (n < TR * TC && n / TC < nbh && n % TC < nbw) quad(n, k0);
  } else {
    for (int m = t; m < TR * TC * 9; m += THREADS) {
      const int n = m / 9;
      if (n / TC < nbh && n % TC < nbw) quad(n, (m - n * 9) * 4);
    }
  }
}

}  // namespace hog
