// Dense SVM scoring matmul: (M, K) block rows @ (K, N) per-offset
// weights -> (M, N) f32, f32 or bf16 inputs, f32 accumulation.
//
// Replaces the TPU kernel repro/kernels/svm_matmul.py:80 (score_matmul):
// an MXU dot over M tiles with the whole (K, N) weight tile resident.
// In the detector K = 36 (one block descriptor) and N = 105 (window
// offsets); M is the scene's block count, 4524 / 2852 / 1813 at the
// three 640x480 pyramid levels, 14220 / 9072 / 5757 at 1280x720.
//
// Bound on the H100: bytes. A 640x480 frame's 9,189 rows read 1.32 MB
// and write 3.86 MB of f32 (1.56 us at 3.35 TB/s; bf16 reads half);
// 2*M*K*N = 34 MFLOP at the largest level is 0.5 us on the FP32 lanes.
// Each level is one launch, and one launch's floor is about 1.1 us, so
// what a CTA does before and around its arithmetic -- staging, barriers,
// shared-memory traffic -- weighs as much as the arithmetic.
//
// Design (score_tile.cuh holds the body; the plan is
// kernels/svm_matmul.py:score_plan), against what held the 32-row kernel
// back:
//  * Too few CTAs: every SM gets one CTA at every level (G = min(132,
//    ceil(M/4))), each over a contiguous span of 4-row units balanced to
//    within one unit, so the busiest SM has the fewest rows possible (36
//    / 24 / 16 at 640x480; the 32-row tiles gave 142 / 90 / 57 CTAs, two
//    on some SMs at level 1.0 and idle SMs at the others).
//  * Weights restaged per CTA with 4-byte loads and converted on the way:
//    staged once per CTA (one per SM) by 16-byte cp.async, as they are,
//    and read in place (no conversion pass, no barrier for one).
//  * A serial inner loop: f32 runs a 4 x 4 register micro-tile per
//    thread, 16 independent fmaf accumulators, k = 0..35 in order (the
//    build has --fmad=false); one 16-byte load of a row feeds 4 columns,
//    one weight load 4 rows, consecutive threads read consecutive
//    columns; no division per output. bf16 runs on the tensor cores
//    (mma.sync m16n8k16, products exact in f32, f32 accumulation), each
//    warp over a run of 8-column tiles of every 16-row block, its B
//    fragments gathered once.
//  * Outputs go through shared memory row-major and leave as 16-byte
//    stores over the one contiguous span they occupy in the output (a 2-D
//    TMA store cannot take the 420-byte row pitch); the next pass's rows
//    are prefetched by cp.async meanwhile.
//  * Misaligned inputs (a view at an odd offset) take the element-wise
//    copies the wrapper selects from data_ptr() % 16.
//
//  * Stacked heads (N = 105 x H, head-major columns): a second grid axis
//    over heads, each CTA running the one-head body on its head's
//    staged (36, 105) weights, so shared memory stays the one-head size
//    and head h's columns equal its one-head launch's bit for bit; the
//    SMs split between the heads (132 / H CTAs each). A head's columns
//    start at h * 420 bytes, off the 16-byte grid, so its weights stage
//    and its outputs leave element by element.
//
// ptxas (sm_90a): 96 registers (f32) and 96 (bf16), no spills.
#include "score_tile.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(score::MAX_THREADS, 1)
score_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    float* __restrict__ out, int M, int K, int N,
                    int heads, int pass_units, int vec) {
  score::run<T>(x, w, out, M, K, N, heads, pass_units, vec);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (x and w share it). grid, heads, pass_units,
// threads and smem_bytes are kernels/svm_matmul.py:score_plan's (N =
// heads x the columns of a head); vec holds score::VEC_X / VEC_W /
// VEC_OUT for the 16-byte-aligned operands.
extern "C" int score_matmul_launch(const void* x, const void* w, float* out,
                                   int M, int K, int N, int dtype, int grid,
                                   int heads, int pass_units, int threads,
                                   int smem_bytes, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return score::launch(score_matmul_kernel<__nv_bfloat16>,
                         static_cast<const __nv_bfloat16*>(x),
                         static_cast<const __nv_bfloat16*>(w), out, M, K, N,
                         grid, heads, pass_units, threads, smem_bytes, vec,
                         s);
  if (dtype == 0)
    return score::launch(score_matmul_kernel<float>,
                         static_cast<const float*>(x),
                         static_cast<const float*>(w), out, M, K, N, grid,
                         heads, pass_units, threads, smem_bytes, vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
