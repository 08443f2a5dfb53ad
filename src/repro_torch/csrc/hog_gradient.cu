// Window gradient -> magnitude and orientation bin (HOG stage 3, eqs. 1-4)
// over a batch of independent windows: (B, H, W) f32 gray ->
// mag (B, H-2, W-2) f32 (int32 half-gray units in the fixed mode) and
// bin (B, H-2, W-2) int32.
//
// Replaces the TPU kernel repro/kernels/hog_gradient.py:139
// (hog_gradient), which runs one program per 8-window slab with the
// 66-px rows padded to 128 lanes. Here one thread owns one output pixel:
// the flat index runs over (window, row, column), column fastest, so a
// warp reads and writes consecutive addresses of one row (the last warp
// of a row runs into the next; nothing is padded). It calls the shared
// device function of its mode (mag_bin.cuh: sector, cordic or the int32
// fixed CORDIC) on the two central differences, spelled with __fsub_rn.
//
// Bound on the H100: bytes. A 130x66 window reads 34.3 KB and writes
// 65.5 KB (mag and bin, 4 bytes each per pixel), so B = 5,949 windows
// move 0.59 GB, 177 us at 3.35 TB/s; the per-pixel work (~40 operations
// sector, ~150 cordic and fixed) stays under the f32 rate's share. Each
// gray value is read by four neighbouring threads, through L1.
#include <cuda_runtime.h>

#include "mag_bin.cuh"

namespace {

constexpr int THREADS = 256;

template <int MODE>
__global__ void __launch_bounds__(THREADS)
hog_gradient_kernel(const float* __restrict__ gray,
                    typename hog::HistTypes<MODE>::Acc* __restrict__ mag,
                    int* __restrict__ bin, long long n, int H, int W) {
  using Acc = typename hog::HistTypes<MODE>::Acc;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= n) return;
  const int wa = W - 2, ha = H - 2;
  const int c = static_cast<int>(t % wa);
  const int r = static_cast<int>((t / wa) % ha);
  const long long b = t / (static_cast<long long>(ha) * wa);
  const float* up = gray + (b * H + r) * W;
  const float* mid = up + W;
  const float* dn = mid + W;
  const float fx = __fsub_rn(mid[c + 2], mid[c]);        // eq. (1)
  const float fy = __fsub_rn(dn[c + 1], up[c + 1]);      // eq. (2)
  Acc m;
  int k;
  hog::mag_bin<MODE>(fx, fy, m, k);
  mag[t] = m;
  bin[t] = k;
}

template <int MODE>
void launch(const float* gray, void* mag, int* bin, long long n, int H,
            int W, cudaStream_t s) {
  const unsigned grid = static_cast<unsigned>((n + THREADS - 1) / THREADS);
  hog_gradient_kernel<MODE><<<grid, THREADS, 0, s>>>(
      gray, static_cast<typename hog::HistTypes<MODE>::Acc*>(mag), bin, n,
      H, W);
}

}  // namespace

// mag is f32 for sector and cordic, int32 for fixed.
extern "C" int hog_gradient_launch(const float* gray, void* mag, int* bin,
                                   int B, int H, int W, int mode,
                                   void* stream) {
  const long long n = static_cast<long long>(B) * (H - 2) * (W - 2);
  if (B <= 0 || H < 3 || W < 3) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == hog::kSector)
    launch<hog::kSector>(gray, mag, bin, n, H, W, s);
  else if (mode == hog::kCordic)
    launch<hog::kCordic>(gray, mag, bin, n, H, W, s);
  else
    launch<hog::kFixed>(gray, mag, bin, n, H, W, s);
  return static_cast<int>(cudaGetLastError());
}
