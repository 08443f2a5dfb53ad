// Dense int8 SVM scoring matmul of the fixed-point chain: (M, K) int8
// block codes @ (K, N) int8 weight codes -> (M, N) int32, exact.
//
// Replaces the TPU kernel repro/kernels/svm_matmul.py:118
// (score_matmul_int8): an MXU int8 dot with int32 accumulation over M
// tiles, the whole (K, N) weight tile resident. In the detector K = 36
// and N = 105; M is the scene's block count (4524 / 2852 / 1813 at
// 640x480). Codes lie in [-127, 127], so a sum of 36 products is at most
// 36 * 127^2 < 2^20: int32 accumulation is exact in any order.
//
// Bound on the H100: bytes. A 640x480 frame reads 0.33 MB of codes and
// writes 3.86 MB of int32 (1.25 us at 3.35 TB/s); its 69 M int8
// operations are 0.03 us at the 1,979 TOPS tensor-core rate.
//
// Design: score_matmul.cu's, from the same body (score_tile.cuh) and
// plan (kernels/svm_matmul.py:score_plan) -- one CTA per SM over a
// balanced span of 4-row units (not 142 / 90 / 57 CTAs of 32 rows), the
// weights staged once per CTA by 16-byte cp.async (the 3,780-byte tile's
// 4-byte tail by a 4-byte one) and read in place, outputs as one
// contiguous span of 16-byte stores. The product runs on the tensor
// cores, mma.sync m16n8k32 with s32 accumulation, instead of one serial
// __dp4a chain per output: each warp takes a run of 8-column tiles of
// every 16-row block, gathers their B fragments (4 codes of one column a
// register, K padded to 64 with zeros) from the raw weights once, and
// reads the A fragments straight from the staged rows.
//
// Stacked heads (N = 105 x H): score_matmul.cu's head axis, each head's
// int8 codes and int32 sums those of its one-head launch.
//
// ptxas (sm_90a): 96 registers, no spills.
#include "score_tile.cuh"

namespace {

__global__ void __launch_bounds__(score::MAX_THREADS, 1)
score_matmul_int8_kernel(const int8_t* __restrict__ x,
                         const int8_t* __restrict__ w,
                         int32_t* __restrict__ out, int M, int K, int N,
                         int heads, int pass_units, int vec) {
  score::run<int8_t>(x, w, out, M, K, N, heads, pass_units, vec);
}

}  // namespace

// grid, heads, pass_units, threads and smem_bytes are
// kernels/svm_matmul.py:score_plan's; vec as in score_matmul.cu.
extern "C" int score_matmul_int8_launch(const int8_t* x, const int8_t* w,
                                        int32_t* out, int M, int K, int N,
                                        int grid, int heads, int pass_units,
                                        int threads, int smem_bytes, int vec,
                                        void* stream) {
  return score::launch(score_matmul_int8_kernel, x, w, out, M, K, N, grid,
                       heads, pass_units, threads, smem_bytes, vec,
                       static_cast<cudaStream_t>(stream));
}
