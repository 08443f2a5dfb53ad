// Window block L2 normalization (HOG stages 4-5, eq. 5): (B, ch, 8, 9)
// cell histograms, f32 or the fixed chain's int16 -> (B, ch-1, 7, 36)
// f32 blocks in every flavor (the fixed flavor's on their per-block int8
// grid).
//
// Replaces the TPU kernel repro/kernels/block_norm.py:41 (block_norm),
// which concatenates four shifted views of an 8-window slab's
// histograms.
//
// Bound on the H100: bytes. A window reads 4.6 KB of f32 histograms
// (2.3 KB int16) and writes 15.1 KB of blocks, so B = 5,949 windows move
// 0.12 GB, 35 us at 3.35 TB/s; ~110 operations per block (230 fixed)
// are far below the f32 rate.
//
// Design (the plan -- band, body, threads, grid, shared memory -- comes
// from kernels/block_norm.py:block_norm_plan, which the tests check; the
// launcher refuses any other). CTA b * bands + band owns a band of TR
// block rows of window b across its full width of 7 blocks; its TR + 1
// cell rows are one contiguous span of the input and its TR x 252 output
// floats one contiguous span, written in float4 stores. Two bodies, both
// finish_block's arithmetic in its order, so block_norm(h) equals
// dense_block_norm(h) bit for bit:
//  * body 0, below one window a SM (B < 132 on the H100): the dense
//    kernel's tile body (block_tile.cuh), 4 outputs a thread, so a small
//    batch spreads over many threads (bands of 1 or 3 rows: 165 CTAs at
//    B 11);
//  * body 1, from one window a SM up: a whole window a CTA (TR = 15), one
//    thread a block with its 36 values in registers. On the H100 the tile
//    body moved twice the shared-memory wavefronts of this one (each
//    value's square written to up to 4 blocks, quads gathered across
//    cells) and held 2 windows a SM at its 945 threads a window; this
//    body holds 7-10 and stages its blocks once, conflict-free.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_tile.cuh"

namespace {

constexpr int CW = 8;                 // cells across the paper's window
constexpr int BW = CW - 1;            // blocks across
constexpr int PITCH = 12;             // a staged cell: 9 values, 3 float4

// Body 0, quads: TR block rows across the width, TH threads, the dense
// kernel's tile body (4 outputs a thread, in turn).
template <int TR, int TH>
struct Quads {
  using T = hog::Tile<TR, BW, TH>;
  static constexpr int THREADS = TH;
  static constexpr int SMEM = sizeof(hog::Smem<T>);
  template <int NORM, typename In>
  static __device__ __forceinline__ void run(const In* hist, float* out,
                                             int ch, float eps2, long long b,
                                             int band, unsigned char* smem) {
    hog::block_tile<NORM, In, T>(hist, out, ch, CW, eps2, b, band, 0,
                                 *reinterpret_cast<hog::Smem<T>*>(smem));
  }
};

// Body 1, one thread a block: TR block rows across the width, one thread
// for each of the TR x 7 blocks, in whole warps. The TR + 1 cell rows are
// staged at a pitch of 12 (conflict-free float4 reads); each thread sums
// its block's 36 squares in finish_block's order (and takes max |c|),
// reads the cells again to make its 36 values 4 at a time (so few are
// live across the fixed flavor's IEEE divides), stages them as 9 float4
// (conflict-free: 144-byte rows), and the CTA copies the band's span out
// in coalesced float4 stores.
template <int TR>
struct OnePerBlock {
  static constexpr int NBLK = TR * BW;
  static constexpr int THREADS = (NBLK + 31) / 32 * 32;
  static constexpr int NVAL = (TR + 1) * CW * 9;
  struct Smem {
    float cells[(TR + 1) * CW * PITCH];
    float out[NBLK * 36];
  };
  static constexpr int SMEM = sizeof(Smem);
  template <int NORM, typename In>
  static __device__ __forceinline__ void run(const In* hist, float* out,
                                             int ch, float eps2, long long b,
                                             int band, unsigned char* smem) {
    constexpr int U = (NVAL + THREADS - 1) / THREADS;
    Smem& s = *reinterpret_cast<Smem*>(smem);
    const int t = threadIdx.x;
    const int bi0 = band * TR, nbh = min(TR, ch - 1 - bi0);
    const int nval = (nbh + 1) * CW * 9;
    const In* src = hist + (b * ch + bi0) * CW * 9;
    float x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = t + u * THREADS;
      x[u] = i < nval ? static_cast<float>(src[i]) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = t + u * THREADS;
      if (i < nval) s.cells[i / 9 * PITCH + i % 9] = x[u];
    }
    __syncthreads();
    if (t < nbh * BW) {
      const int i = t / BW, j = t - i * BW;
      // cell q of the block: (0,0), (0,1), (1,0), (1,1), 3 float4 each
      auto cell = [&](int q) {
        return reinterpret_cast<const float4*>(
            s.cells + ((i + q / 2) * CW + j + q % 2) * PITCH);
      };
      // the 36 squares in finish_block's order, and max |c| (fixed)
      float ss = 0.0f, mc = 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4* c = cell(q);
        const float4 c0 = c[0], c1 = c[1], c2 = c[2];
        const float x[9] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w,
                            c2.x};
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          ss = __fadd_rn(ss, __fmul_rn(x[k], x[k]));
          mc = fmaxf(mc, fabsf(x[k]));
        }
      }
      const float rs = hog::inv_norm<NORM>(__fadd_rn(ss, eps2));
      // fixed: the int8 step max|c * rs| * (1/127) = fl(max|c| * rs) *
      // (1/127), rounding being monotone (block_tile.cuh's argument)
      const float scale = __fmul_rn(__fmul_rn(mc, rs), hog::kInvQ);
      // the block's 36 values, c * rs (on the int8 grid, fixed), staged
      // 4 at a time as the cells are read again
      float o[36];
      float4* dst = reinterpret_cast<float4*>(s.out + t * 36);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4* c = cell(q);
        const float4 c0 = c[0], c1 = c[1], c2 = c[2];
        const float x[9] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w,
                            c2.x};
#pragma unroll
        for (int b9 = 0; b9 < 9; ++b9) {
          const int k = q * 9 + b9;
          o[k] = __fmul_rn(x[b9], rs);
          if constexpr (NORM == hog::kFixedNorm)
            o[k] = hog::quantize_value(o[k], scale);
          if (k % 4 == 3)
            dst[k / 4] = make_float4(o[k - 3], o[k - 2], o[k - 1], o[k]);
        }
      }
    }
    __syncthreads();
    const float4* o = reinterpret_cast<const float4*>(s.out);
    float4* d = reinterpret_cast<float4*>(out + (b * (ch - 1) + bi0) * BW
                                          * 36);
    for (int m = t; m < nbh * BW * 9; m += THREADS) d[m] = o[m];
  }
};

// CTA b * bands + band: band ``band`` of window b.
template <int NORM, typename In, class Body>
__global__ void __launch_bounds__(Body::THREADS)
block_norm_kernel(const void* __restrict__ hist_in, float* __restrict__ out,
                  int ch, float eps2, int bands) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Body::template run<NORM, In>(static_cast<const In*>(hist_in), out, ch,
                               eps2, blockIdx.x / bands, blockIdx.x % bands,
                               smem_raw);
}

using Kernel = void (*)(const void*, float*, int, float, int);

// The instantiation for a norm flavor at a body, its threads and shared
// memory; the fixed flavor reads int16 histograms.
template <class Body>
Kernel instance(int norm, int* threads, int* smem) {
  *threads = Body::THREADS;
  *smem = Body::SMEM;
  if (norm == hog::kRsqrt) return block_norm_kernel<hog::kRsqrt, float, Body>;
  if (norm == hog::kNr) return block_norm_kernel<hog::kNr, float, Body>;
  if (norm == hog::kFixedNorm)
    return block_norm_kernel<hog::kFixedNorm, int16_t, Body>;
  return nullptr;
}

// The bands compiled here, (rows, threads, body)
// (kernels/block_norm.py:BLOCK_NORM_BANDS).
Kernel pick(int norm, int tr, int th, int body, int* smem) {
  int want = 0;
  Kernel k = nullptr;
  if (body == 0 && tr == 1) k = instance<Quads<1, 64>>(norm, &want, smem);
  if (body == 0 && tr == 3) k = instance<Quads<3, 128>>(norm, &want, smem);
  if (body == 1 && tr == 15) k = instance<OnePerBlock<15>>(norm, &want, smem);
  return th == want ? k : nullptr;
}

}  // namespace

// Launch B windows with the plan of kernels/block_norm.py:block_norm_plan:
// grid B x bands, CTA b * bands + band. hist is f32 for the rsqrt and nr
// flavors, int16 for fixed. A plan for another window width, whose band,
// thread count or body is not one compiled here, whose bands are not the
// block rows' cover, whose grid overflows, or whose shared memory is short
// of the kernel's layout is refused with cudaErrorInvalidValue.
extern "C" int block_norm_launch(const void* hist, float* out, int B, int ch,
                                 int cw, float eps2, int norm, int bands,
                                 int tile_rows, int body, int threads,
                                 int smem_bytes, void* stream) {
  if (B <= 0 || ch < 2) return 0;
  int need = 0;
  const Kernel k = pick(norm, tile_rows, threads, body, &need);
  if (k == nullptr || cw != CW || smem_bytes < need ||
      bands * tile_rows < ch - 1 || (bands - 1) * tile_rows >= ch - 1 ||
      static_cast<long long>(B) * bands >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  k<<<B * bands, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      hist, out, ch, eps2, bands);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of the flavor's kernel at a band that one SM can hold at this
// thread count and shared memory
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), written to *blocks;
// returns the CUDA error code.
extern "C" int block_norm_occupancy(int norm, int tile_rows, int body,
                                    int threads, int smem_bytes,
                                    int* blocks) {
  int need = 0;
  const Kernel k = pick(norm, tile_rows, threads, body, &need);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, k, threads, smem_bytes));
}
