// Fused window HOG: gradient -> magnitude/bin -> cell histograms -> 2x2
// block normalization in one kernel, (B, H, 66) f32 gray windows ->
// (B, (ch-1)*7*36) f32 descriptors in window_descriptor's collate order
// (blocks row-major, then the 36 values), so no reshape or transpose
// follows. Only the gray and the descriptors touch device memory.
//
// Replaces the TPU kernel repro/kernels/fused_hog.py:75 (fused_hog), which
// runs the whole chain for an 8-window slab in VMEM.
//
// Bound on the H100: bytes in the float modes. A window reads 34.3 KB and
// writes 15.1 KB, 25.3 MB at B = 512 (7.6 us at 3.35 TB/s); the fixed
// mode's int32 CORDIC bounds it by the INT32 lanes (30 us at B = 512).
//
// Design (the plan -- band, threads, grid, shared memory -- comes from
// kernels/fused_hog.py:window_plan, which the tests check):
//  * A CTA owns a band of K block rows of one window, K one of the Band<>
//    instantiations (15: the whole window; 8, 5, 3, 1), chosen per batch
//    so every SM gets a CTA, and computes the K+1 cell rows they need
//    (one band a window at B = 512 and 5,949; recompute (15 + bands) / 16
//    of the cells where a window is cut). The grid is flat, CTA x = window
//    x bands + band: one 32-bit divide per CTA.
//  * The band's gray rows [8 j0, 8 (j0 + K + 1) + 2) are one contiguous,
//    16-byte aligned span, staged by bulk copies (window_stage.cuh), one
//    per trip of two cell rows, each on its own mbarrier: a trip waits for
//    its own rows only, so compute starts after the first 18 rows land.
//  * Cell phase as in dense_fused_hog: 16 threads a cell, each taking 4
//    pixels of one pixel row as 4 independent chains; 16 cells a trip of
//    256 threads. Each warp owns its two cells' sums in shared memory, so
//    a trip needs no barrier but __syncwarp. Float: each pixel row's 9
//    bins, the left half's 4 pixels added before the right half's, each
//    pixel to its own bin only, then the 8 rows in reduce_cell_lanes'
//    xor-tree order -- the order of mag_bin.cuh:row_hist +
//    reduce_cell_lanes, so the cells, and every value after them, are bit
//    for bit dense_fused_hog's. Fixed: int32 shared atomics, exact in any
//    order.
//  * Block phase: one thread a block sums its 36 squares in finish_block's
//    k = 0..35 order straight from the staged cells (fixed: also max |c|,
//    which times 1/norm is max |v|, rounding being monotone), then every
//    thread makes 4 values of a block -- scaled and, fixed, quantized --
//    and stores them as one float4: a band's blocks are K x 7 x 36
//    contiguous floats of the output, written coalesced, with no
//    restaging pass and no divide per element.
// Shared memory: 44.1 KB at K = 15, under the 48 KB default; registers
// capped at 64 (at 48 the four interleaved chains spill), so 4 CTAs (32
// warps) an SM.
#include <cuda_runtime.h>
#include <stdint.h>

#include "finish_blocks.cuh"
#include "mag_bin.cuh"
#include "window_stage.cuh"

namespace {

constexpr int W = 66;                  // the window's columns (64 + halo)
constexpr int CW = 8, BW = 7;          // its cell and block columns
constexpr int THREADS = 256;           // 16 cells of 16 threads a trip
constexpr int CP = 12;                 // a staged cell: 9 bins, 3 float4
// each warp's sums of its 2 cells: float, 8 rows of 9 bins (whole float4);
// fixed, 9 int32 a cell
constexpr int WPART = 2 * 8 * 9;
static_assert(WPART % 4 == 0 && WPART / 4 <= 64, "two int4 stores a lane");

// A band of K block rows: the K+1 cell rows it computes, the gray rows it
// stages, its blocks, its trips of 16 cells (two cell rows, one staging
// chunk each), and its shared memory: the mbarriers, the gray, the cells,
// and each warp's partial sums, whose space then holds 1/norm and the int8
// step of each block.
template <int K_>
struct Band {
  static constexpr int K = K_;
  static constexpr int SR = K + 1;
  static constexpr int GR = SR * 8 + 2;
  static constexpr int NBLK = K * BW;
  static constexpr int TRIPS = (SR * CW * 16 + THREADS - 1) / THREADS;
  static constexpr int SMEM = hog::kBarBytes
      + 4 * (GR * W + SR * CW * CP + THREADS / 32 * WPART);
  static_assert(NBLK <= THREADS, "one thread a block sums its squares");
  static_assert(2 * NBLK <= THREADS / 32 * WPART, "1/norm and step fit");
  static_assert(TRIPS <= hog::kMaxChunks, "a chunk per trip");
};

template <int MODE, int NORM, class T>
__global__ void __launch_bounds__(THREADS, 4)
fused_hog_kernel(const float* __restrict__ gray, float* __restrict__ out,
                 int H, int bands, float eps2) {
  using Acc = typename hog::HistTypes<MODE>::Acc;
  using Store = typename hog::HistTypes<MODE>::Store;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  float* g = reinterpret_cast<float*>(smem_raw + hog::kBarBytes);  // (GR, W)
  float* cells = g + T::GR * W;                            // (SR*CW, CP)
  float* rs = cells + T::SR * CW * CP;          // per block, after phase 2
  float* scale = rs + T::NBLK;
  Acc* part = reinterpret_cast<Acc*>(rs) + (threadIdx.x >> 5) * WPART;
  const int t = threadIdx.x;
  const int bh = (H - 2) / 8 - 1;
  const int b = blockIdx.x / bands;
  const int j0 = (blockIdx.x - b * bands) * T::K;          // first block row
  const int kb = min(T::K, bh - j0);                       // its block rows
  const int nr = kb + 1;                                   // its cell rows

  // 1. the band's gray, rows 8 j0 .. 8 (j0 + nr) + 1, a chunk a trip
  hog::stage_rows(g, gray + static_cast<size_t>(b) * H * W
                         + static_cast<size_t>(8 * j0) * W,
                  8 * nr + 2, 16, W, bar);

  // 2. cells: thread (r, hf) of a cell's 16 takes pixels 4hf .. 4hf + 3
  // of the cell's pixel row r; cell c (0, 1) of the warp
  const int r = (t >> 1) & 7, hf = t & 1, c = (t >> 4) & 1;
  const int lane16 = t & 15;
  // two cell rows and one staged chunk a trip (a band cut short by the
  // window's end has fewer trips than T::TRIPS)
  const int trips = (nr + 1) / 2;
#pragma unroll 1
  for (int trip = 0; trip < trips; ++trip) {
    const int slot = trip * (THREADS / 16) + (t >> 4);
    const bool on = slot < nr * CW;
    // zero the warp's sums, 36 int4 (the last trip's reads are done:
    // __syncwarp)
    reinterpret_cast<int4*>(part)[t & 31] = make_int4(0, 0, 0, 0);
    if ((t & 31) < WPART / 4 - 32)
      reinterpret_cast<int4*>(part)[32 + (t & 31)] = make_int4(0, 0, 0, 0);
    hog::wait_chunk(bar, trip);
    __syncwarp();
    Acc m[4];
    int bn[4];
    if (on) {
      const float* up = g + ((slot / CW) * 8 + r) * W + (slot % CW) * 8
                        + 4 * hf;
      float u[6], cc[6], d[6];
#pragma unroll
      for (int i = 0; i < 3; ++i) {   // 8-byte loads: W and 4 hf are even
        const float2 x = *reinterpret_cast<const float2*>(up + 2 * i);
        const float2 y = *reinterpret_cast<const float2*>(up + W + 2 * i);
        const float2 z = *reinterpret_cast<const float2*>(up + 2 * W + 2 * i);
        u[2 * i] = x.x; u[2 * i + 1] = x.y;
        cc[2 * i] = y.x; cc[2 * i + 1] = y.y;
        d[2 * i] = z.x; d[2 * i + 1] = z.y;
      }
      float fx[4], fy[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        fx[j] = __fsub_rn(cc[j + 2], cc[j]);                 // eq. (1)
        fy[j] = __fsub_rn(d[j + 1], u[j + 1]);               // eq. (2)
      }
      hog::mag_bin4<MODE>(fx, fy, m, bn);
    }
    Acc v = Acc(0);
    if constexpr (MODE == hog::kFixed) {
      // int32 sums are exact in any order
      if (on) {
#pragma unroll
        for (int j = 0; j < 4; ++j) atomicAdd(&part[c * 9 + bn[j]], m[j]);
      }
      __syncwarp();
      if (lane16 < 9) v = part[c * 9 + lane16];
    } else {
      // row r's sums in column order: the left half's 4 pixels, then the
      // right half's (adding only to a pixel's own bin, which equals
      // row_hist's add of 0 to every other)
      Acc* row = part + (c * 8 + r) * 9;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (on && hf == half) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            row[bn[j]] = hog::acc_add(row[bn[j]], m[j]);
        }
        __syncwarp();
      }
      // the 8 row sums of bin lane16 in reduce_cell_lanes' xor-tree order
      if (lane16 < 9) {
        const Acc* p = part + c * 72 + lane16;
        v = hog::acc_add(
            hog::acc_add(hog::acc_add(p[0], p[9]), hog::acc_add(p[18], p[27])),
            hog::acc_add(hog::acc_add(p[36], p[45]),
                         hog::acc_add(p[54], p[63])));
      }
    }
    if (on && lane16 < 9)
      cells[slot * CP + lane16] = static_cast<float>(static_cast<Store>(v));
    __syncwarp();
  }
  __syncthreads();

  // 3. per block, one thread: the sum of its 36 squares in finish_block's
  // order (cells (0,0), (0,1), (1,0), (1,1), bins 0..8 each), 1 / norm,
  // and (fixed) the int8 step from max |c| x 1/norm
  const int nblk = kb * BW;
  if (t < nblk) {
    const int i = t / BW, j = t - i * BW;
    float ss = 0.0f, mx = 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4* x = reinterpret_cast<const float4*>(
          cells + ((i + q / 2) * CW + j + q % 2) * CP);
      const float4 a = x[0], e = x[1], f = x[2];
      const float v[9] = {a.x, a.y, a.z, a.w, e.x, e.y, e.z, e.w, f.x};
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        ss = __fadd_rn(ss, __fmul_rn(v[k], v[k]));
        if constexpr (NORM == hog::kFixedNorm) mx = fmaxf(mx, fabsf(v[k]));
      }
    }
    const float inv = hog::inv_norm<NORM>(__fadd_rn(ss, eps2));
    rs[t] = inv;
    if constexpr (NORM == hog::kFixedNorm)
      scale[t] = __fmul_rn(__fmul_rn(mx, inv), hog::kInvQ);
  }
  __syncthreads();

  // 4. four values of a block a thread, one float4 store each: the band's
  // blocks are out[b, j0*7 .. (j0 + kb)*7 - 1, :], nblk * 36 contiguous
  // floats (16-byte aligned: 36 floats are 144 bytes)
  float4* dst = reinterpret_cast<float4*>(
      out + (static_cast<size_t>(b) * bh + j0) * BW * 36);
  for (int q = t; q < nblk * 9; q += THREADS) {
    const int n = q / 9, k0 = (q - n * 9) * 4;
    const int i = n / BW, j = n - i * BW;
    const float inv = rs[n];
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k0 + u;
      v[u] = __fmul_rn(cells[((i + k / 18) * CW + j + (k / 9) % 2) * CP
                             + k % 9], inv);
    }
    if constexpr (NORM == hog::kFixedNorm) {
      const float sc = scale[n];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = hog::quantize_value(v[u], sc);
    }
    dst[q] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <int MODE, int NORM, class T>
void launch_as(const float* gray, float* out, int H, int bands, float eps2,
               unsigned grid, cudaStream_t s) {
  fused_hog_kernel<MODE, NORM, T><<<grid, THREADS, T::SMEM, s>>>(
      gray, out, H, bands, eps2);
}

using Launch = void (*)(const float*, float*, int, int, float, unsigned,
                        cudaStream_t);

// The instantiation of the mode (with the one normalize tail each mode
// runs, core/numerics.py SPECS) at band T, its shared memory, and the
// kernel itself for the occupancy query; null for another pair.
template <class T>
Launch pick_mode(int mode, int norm, int* smem, const void** kernel) {
  *smem = T::SMEM;
#define FUSED_HOG_PICK(M, N)                                              \
  if (mode == M && norm == N) {                                           \
    *kernel = reinterpret_cast<const void*>(fused_hog_kernel<M, N, T>);   \
    return launch_as<M, N, T>;                                            \
  }
  FUSED_HOG_PICK(hog::kSector, hog::kRsqrt)
  FUSED_HOG_PICK(hog::kCordic, hog::kNr)
  FUSED_HOG_PICK(hog::kFixed, hog::kFixedNorm)
#undef FUSED_HOG_PICK
  return nullptr;
}

// The bands compiled here (kernels/fused_hog.py:WINDOW_BANDS).
Launch pick(int mode, int norm, int band, int* smem, const void** kernel) {
  if (band == 15) return pick_mode<Band<15>>(mode, norm, smem, kernel);
  if (band == 8) return pick_mode<Band<8>>(mode, norm, smem, kernel);
  if (band == 5) return pick_mode<Band<5>>(mode, norm, smem, kernel);
  if (band == 3) return pick_mode<Band<3>>(mode, norm, smem, kernel);
  if (band == 1) return pick_mode<Band<1>>(mode, norm, smem, kernel);
  return nullptr;
}

}  // namespace

// Launch with the plan of kernels/fused_hog.py:window_plan: B windows of
// H x 66 (H even, at least 2 x 2 cells) in bands of `band` block rows,
// grid B x bands CTAs of 256 threads. A plan whose band, threads or
// (mode, norm) is not compiled here, whose shared memory is short of
// the band's, or whose grid is not the bands' is refused with
// cudaErrorInvalidValue.
extern "C" int fused_hog_launch(const float* gray, float* out, int B, int H,
                                int Wd, float eps2, int mode, int norm,
                                int band, int grid, int threads,
                                int smem_bytes, void* stream) {
  if (B <= 0) return 0;
  int need = 0;
  const void* kernel = nullptr;
  const Launch fn = pick(mode, norm, band, &need, &kernel);
  const int bh = (H - 2) / 8 - 1;
  const int bands = band > 0 ? (bh + band - 1) / band : 0;
  if (fn == nullptr || Wd != W || H % 2 != 0 || bh < 1 ||
      threads != THREADS || smem_bytes < need ||
      static_cast<long long>(grid) != static_cast<long long>(B) * bands)
    return static_cast<int>(cudaErrorInvalidValue);
  fn(gray, out, H, bands, eps2, static_cast<unsigned>(grid),
     static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// CTAs of the mode's kernel at a band that one SM holds at
// these threads and shared memory, written to *blocks; the CUDA error.
extern "C" int fused_hog_occupancy(int mode, int band, int threads,
                                   int smem_bytes, int* blocks) {
  const int norm = mode == hog::kFixed    ? hog::kFixedNorm
                   : mode == hog::kCordic ? hog::kNr
                                          : hog::kRsqrt;
  int need = 0;
  const void* kernel = nullptr;
  if (pick(mode, norm, band, &need, &kernel) == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, threads, smem_bytes));
}
