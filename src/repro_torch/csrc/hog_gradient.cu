// Window gradient -> magnitude and orientation bin (HOG stage 3, eqs. 1-4)
// over a batch of independent 130x66 windows: (B, H, 66) f32 gray ->
// mag (B, H-2, 64) f32 (int32 half-gray units in the fixed mode) and
// bin (B, H-2, 64) int32.
//
// Replaces the TPU kernel repro/kernels/hog_gradient.py:139
// (hog_gradient), which runs one program per 8-window slab with the
// 66-px rows padded to 128 lanes.
//
// Bound on the H100: bytes in the float modes. A 130x66 window reads
// 34.3 KB and writes 65.5 KB (mag and bin, 4 bytes each per pixel), 51 MB
// at B = 512, 15.3 us at 3.35 TB/s; the fixed mode's 15-step int32 CORDIC
// bounds it by the INT32 lanes instead (25 us at B = 512).
//
// Design (the plan -- band, threads, grid, shared memory -- comes from
// kernels/hog_gradient.py:hog_gradient_plan, which the tests check):
//  * A CTA owns a band of R output rows of one window, R one of the
//    Band<> instantiations (128, 64, 32, 16, 8), chosen per batch so
//    every SM gets a CTA: one band a window at B = 512 and 5,949, bands of
//    32 rows at B = 64, of 8 at B = 11. The grid is flat, CTA x = window
//    x bands + band, so all index arithmetic is one 32-bit divide per CTA
//    and nothing divides per pixel.
//  * The band's gray rows [r0, r0 + R + 2) are one contiguous, 16-byte
//    aligned span, staged into shared memory by bulk copies
//    (window_stage.cuh), one per trip of 16 rows, each on its own
//    mbarrier: a trip waits for its own rows only, so the first trips
//    compute while the rest of the band lands. A band of one trip (R =
//    16, 8) reads its rows straight from device memory instead.
//  * Each thread computes 4 consecutive columns of one output row (16
//    threads a row of 64) as 4 independent chains of its mode
//    (mag_bin.cuh:mag_bin4), reading its three gray rows with 8-byte
//    loads, and stores one float4 of mag and one int4 of bin: an output row is
//    256 contiguous bytes and a band's output is contiguous. No
//    evict-first hint on the stores: at B = 512 the 33.5 MB of output
//    stay in the 50 MB L2 for cell_hist, which reads them next.
//  * Numerics: the central differences are __fsub_rn and the build passes
//    --fmad=false, so the bins are exactly the plain version's.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mag_bin.cuh"
#include "window_stage.cuh"

namespace {

constexpr int W = 66;                  // the window's columns (64 + halo)
constexpr int WA = W - 2;              // output columns: 16 threads x 4

// A band of R output rows: 16 threads a row, at most 256 a CTA, so STEP
// rows a trip; the CTAs an SM must hold (registers capped at 80: at 64
// the four interleaved sector chains spill), and the shared memory: the
// mbarriers, then the staged span.
template <int R_>
struct Band {
  static constexpr int R = R_;
  static constexpr int THREADS = R * 16 < 256 ? R * 16 : 256;
  static constexpr int STEP = THREADS / 16;
  static constexpr int TRIPS = R / STEP;
  static constexpr int MIN_CTAS = 768 / THREADS;      // 80 registers
  // a band of one trip reads its rows straight from device memory: its
  // one copy's round trip would only add to its latency
  static constexpr bool STAGED = TRIPS > 1;
  static constexpr int SMEM = STAGED ? hog::kBarBytes + 4 * (R + 2) * W : 0;
  static_assert(TRIPS <= hog::kMaxChunks, "a chunk per trip");
  static_assert(R % 2 == 0, "an even band keeps the span 16-byte aligned");
};

// 8 bytes of a gray row: from shared memory, or read-only from device
// memory
template <bool SHARED>
__device__ __forceinline__ float2 load2(const float* p) {
  if constexpr (SHARED) return *reinterpret_cast<const float2*>(p);
  else return __ldg(reinterpret_cast<const float2*>(p));
}

template <int MODE, class T>
__global__ void __launch_bounds__(T::THREADS, T::MIN_CTAS)
hog_gradient_kernel(const float* __restrict__ gray,
                    typename hog::HistTypes<MODE>::Acc* __restrict__ mag,
                    int* __restrict__ bin, int H, int bands) {
  using Acc = typename hog::HistTypes<MODE>::Acc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  float* g = reinterpret_cast<float*>(smem_raw + hog::kBarBytes);
  const int ha = H - 2;
  const int b = blockIdx.x / bands;
  const int r0 = (blockIdx.x - b * bands) * T::R;
  const int nr = min(T::R, ha - r0);            // even: H is even
  const size_t win = static_cast<size_t>(b) * H * W;

  const float* src = gray + win + static_cast<size_t>(r0) * W;
  if constexpr (T::STAGED) hog::stage_rows(g, src, nr + 2, T::STEP, W, bar);

  const int c0 = 4 * (threadIdx.x & 15);
  const size_t out0 = (static_cast<size_t>(b) * ha + r0) * WA + c0;
#pragma unroll 1
  for (int trip = 0; trip < T::TRIPS; ++trip) {
    const int r = trip * T::STEP + (threadIdx.x >> 4);
    if (r >= nr) break;
    if constexpr (T::STAGED) hog::wait_chunk(bar, trip);
    const float* rows = T::STAGED ? g : src;
    // rows r, r+1, r+2 of the band's gray, columns c0 .. c0+5 (8-byte
    // loads: a row is 66 floats and c0 is a multiple of 4)
    float up[6], mid[6], dn[6];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float2 u = load2<T::STAGED>(rows + r * W + c0 + 2 * i);
      const float2 m = load2<T::STAGED>(rows + (r + 1) * W + c0 + 2 * i);
      const float2 d = load2<T::STAGED>(rows + (r + 2) * W + c0 + 2 * i);
      up[2 * i] = u.x; up[2 * i + 1] = u.y;
      mid[2 * i] = m.x; mid[2 * i + 1] = m.y;
      dn[2 * i] = d.x; dn[2 * i + 1] = d.y;
    }
    float fx[4], fy[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      fx[j] = __fsub_rn(mid[j + 2], mid[j]);                // eq. (1)
      fy[j] = __fsub_rn(dn[j + 1], up[j + 1]);              // eq. (2)
    }
    Acc m[4];
    int k[4];
    hog::mag_bin4<MODE>(fx, fy, m, k);
    const size_t o = out0 + static_cast<size_t>(r) * WA;
    if constexpr (MODE == hog::kFixed)
      *reinterpret_cast<int4*>(mag + o) = make_int4(m[0], m[1], m[2], m[3]);
    else
      *reinterpret_cast<float4*>(mag + o) = make_float4(m[0], m[1], m[2],
                                                        m[3]);
    *reinterpret_cast<int4*>(bin + o) = make_int4(k[0], k[1], k[2], k[3]);
  }
}

template <int MODE, class T>
void launch_as(const float* gray, void* mag, int* bin, int H, int bands,
               unsigned grid, cudaStream_t s) {
  hog_gradient_kernel<MODE, T><<<grid, T::THREADS, T::SMEM, s>>>(
      gray, static_cast<typename hog::HistTypes<MODE>::Acc*>(mag), bin, H,
      bands);
}

using Launch = void (*)(const float*, void*, int*, int, int, unsigned,
                        cudaStream_t);

// The instantiation of the mode at band T, its threads and shared
// memory; the kernel itself for the occupancy query.
template <class T>
Launch pick_mode(int mode, int* threads, int* smem, const void** kernel) {
  *threads = T::THREADS;
  *smem = T::SMEM;
#define HOG_GRADIENT_PICK(M)                                              \
  if (mode == M) {                                                        \
    *kernel = reinterpret_cast<const void*>(hog_gradient_kernel<M, T>);   \
    return launch_as<M, T>;                                               \
  }
  HOG_GRADIENT_PICK(hog::kSector)
  HOG_GRADIENT_PICK(hog::kCordic)
  HOG_GRADIENT_PICK(hog::kFixed)
#undef HOG_GRADIENT_PICK
  return nullptr;
}

// The bands compiled here (kernels/hog_gradient.py:GRADIENT_BANDS).
Launch pick(int mode, int band, int* threads, int* smem,
            const void** kernel) {
  if (band == 128) return pick_mode<Band<128>>(mode, threads, smem, kernel);
  if (band == 64) return pick_mode<Band<64>>(mode, threads, smem, kernel);
  if (band == 32) return pick_mode<Band<32>>(mode, threads, smem, kernel);
  if (band == 16) return pick_mode<Band<16>>(mode, threads, smem, kernel);
  if (band == 8) return pick_mode<Band<8>>(mode, threads, smem, kernel);
  return nullptr;
}

}  // namespace

// Launch with the plan of kernels/hog_gradient.py:hog_gradient_plan: B
// windows of H x 66 (H even) in bands of `band` output rows, grid B x
// bands CTAs. A plan whose band or threads are not compiled here,
// whose shared memory is short of the band's, or whose grid is not the
// bands' is refused with cudaErrorInvalidValue. mag is f32 for sector and
// cordic, int32 for fixed.
extern "C" int hog_gradient_launch(const float* gray, void* mag, int* bin,
                                   int B, int H, int Wd, int mode, int band,
                                   int grid, int threads, int smem_bytes,
                                   void* stream) {
  if (B <= 0) return 0;
  int need = 0, compiled = 0;
  const void* kernel = nullptr;
  const Launch fn = pick(mode, band, &compiled, &need, &kernel);
  const int bands = band > 0 ? (H - 2 + band - 1) / band : 0;
  if (fn == nullptr || Wd != W || H < 4 || H % 2 != 0 ||
      threads != compiled || smem_bytes < need ||
      static_cast<long long>(grid) != static_cast<long long>(B) * bands)
    return static_cast<int>(cudaErrorInvalidValue);
  fn(gray, mag, bin, H, bands, static_cast<unsigned>(grid),
     static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// CTAs of the mode's kernel at a band that one SM holds at
// these threads and shared memory, written to *blocks; the CUDA error.
extern "C" int hog_gradient_occupancy(int mode, int band, int threads,
                                      int smem_bytes, int* blocks) {
  int need = 0, compiled = 0;
  const void* kernel = nullptr;
  if (pick(mode, band, &compiled, &need, &kernel) == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, threads, smem_bytes));
}
