// Staging of a window band's gray rows into shared memory, shared by the
// window kernels (hog_gradient.cu, fused_hog.cu).
//
// A band's gray rows of one 66-column window are one contiguous span of
// device memory. A window is 130 x 66 f32 = 34,320 bytes = 16 x 2,145, a
// row 264 bytes, and every band starts on an even row and spans an even
// number of rows, so with a 16-byte aligned tensor (the wrappers check)
// every even row starts on a 16-byte boundary. One thread hands the span
// to the Tensor Memory Accelerator as 1-D bulk copies (cp.async.bulk), one
// per trip of the compute loop, each signalling its own mbarrier as its
// bytes land. A trip waits for its own chunk only, so the first trips
// compute while the rest of the band is still in flight; the other
// threads spend no instructions on the copies.
#pragma once

#include <stdint.h>

namespace hog {

// the mbarriers a CTA reserves at the start of its shared memory: one per
// chunk, at most 8 chunks (a 130-row window in trips of 16 rows)
constexpr int kMaxChunks = 8;
constexpr int kBarBytes = 8 * kMaxChunks;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Chunks of `rows` gray rows consumed `step` gradient rows a trip: chunk i
// holds rows [lo, hi) with lo = 0 for i = 0, step * i + 2 after, and hi =
// step * (i + 1) + 2 (clipped), so trip i reads nothing past chunk i.
__host__ __device__ constexpr int chunks(int rows, int step) {
  return (rows - 2 + step - 1) / step;
}

// Issue the copies of `rows` gray rows of W floats from src (16-byte
// aligned, rows even) into dst, in chunks of `step` rows (even), chunk i
// on bars[i]. Every thread of the CTA calls it; thread 0 issues.
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int rows, int step, int W,
                                           uint64_t* bars) {
  if (threadIdx.x == 0) {
    const int n = chunks(rows, step);
    for (int i = 0; i < n; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   ::"r"(smem_u32(bars + i)) : "memory");
    // the barriers' initialisation, visible to the async proxy
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < n; ++i) {
      const int lo = i == 0 ? 0 : step * i + 2;
      const int hi = min(step * (i + 1) + 2, rows);
      const uint32_t bytes = 4u * (hi - lo) * W;
      const uint32_t b = smem_u32(bars + i);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   ::"r"(b), "r"(bytes) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n"
          ::"r"(smem_u32(dst + lo * W)), "l"(src + lo * W), "r"(bytes),
            "r"(b) : "memory");
    }
  }
  __syncthreads();                     // the barriers are initialised
}

// Wait until chunk i has landed (phase 0 of bars[i]: once per CTA).
__device__ __forceinline__ void wait_chunk(uint64_t* bars, int i) {
  const uint32_t b = smem_u32(bars + i);
  uint32_t done = 0;
  for (uint32_t n = 0; !done; ++n) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(b) : "memory");
    if (n == (1u << 24)) __trap();     // a copy that never lands: fail
  }
}

}  // namespace hog
